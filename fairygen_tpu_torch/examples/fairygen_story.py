"""FairyGen's whole story flow on the port: mask -> style -> stylize ->
animate, one workspace.  The twin of examples/fairygen_story.py, with its
flags, plus ``--device`` (default cuda), which every stage gets:

    workspace/
      character.png          the single child-drawn character image
      prompts/NN.txt         one background / scene prompt per shot
      motion/NN.txt          one motion prompt per shot (animate stage)
      # generated:
      mask.png               stage "mask"    (tools/create_mask.py's twin)
      dora/                  stage "style"   (examples/dora_train.py's twin)
      shots/NN.png           stage "stylize" (examples/brushnet_stylize.py's twin)
      clips/NN.mp4           stage "animate" (examples/wan_batch_inference.py's twin)

  python -m fairygen_tpu_torch.examples.fairygen_story --workspace ws \\
      --stages mask,style,stylize,animate --isnet isnet.safetensors ...

Each stage runs the port's twin of the CLI the JAX flow shells into, so
flags behave alike run alone or orchestrated; stages can be re-run one at a
time (their outputs are plain files).
"""
import argparse
import os
import sys


def _run_stage(module_main, argv, name):
    print(f"== stage {name}: {' '.join(argv)}", flush=True)
    module_main(argv)


def stage_motion_prompts(shots_dir: str, motion_dir: str, prompts_dir: str) -> int:
    """Give every stylized still a sibling .txt the animate stage reads:
    motion/NN.txt where it exists, else the scene prompt prompts/NN.txt."""
    n = 0
    if not os.path.isdir(shots_dir):
        return 0
    for f in sorted(os.listdir(shots_dir)):
        stem, ext = os.path.splitext(f)
        if ext.lower() != ".png":
            continue
        dst = os.path.join(shots_dir, stem + ".txt")
        if os.path.exists(dst):
            n += 1
            continue
        for src_dir in (motion_dir, prompts_dir):
            src = os.path.join(src_dir, stem + ".txt")
            if os.path.exists(src):
                with open(src) as fh:
                    text = fh.read()
                with open(dst, "w") as fh:
                    fh.write(text)
                n += 1
                break
    return n


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--workspace", type=str, required=True)
    p.add_argument("--stages", type=str, default="mask,style,stylize,animate",
                   help="comma-separated subset of mask,style,stylize,animate")
    # stylization side
    p.add_argument("--sdxl_unet", type=str, default=None)
    p.add_argument("--sdxl_vae", type=str, default=None)
    p.add_argument("--sdxl_te1", type=str, default=None)
    p.add_argument("--sdxl_te2", type=str, default=None)
    p.add_argument("--tokenizer1", type=str, default=None)
    p.add_argument("--tokenizer2", type=str, default=None)
    p.add_argument("--brushnet", type=str, default=None)
    p.add_argument("--isnet", type=str, default=None, help="ISNet-DIS weights for the mask stage")
    p.add_argument("--caption", type=str, default="a drawing",
                   help="caption for the Style-DoRA training image")
    p.add_argument("--dora_steps", type=int, default=400)
    p.add_argument("--dora_rank", type=int, default=32)
    p.add_argument("--lora_scale", type=float, default=0.66)
    p.add_argument("--brushnet_conditioning_scale", type=float, default=0.7)
    p.add_argument("--resolution", type=int, default=1024,
                   help="stylization-side image size (dora --resolution, brushnet --size)")
    p.add_argument("--stylize_steps", type=int, default=50)
    p.add_argument("--mask_infer_size", type=int, default=0,
                   help="create_mask --infer_size (0 = preset 1024)")
    # animation side
    p.add_argument("--wan_model_paths", type=str, default=None,
                   help="JSON list for WanVideoPipeline.from_pretrained")
    p.add_argument("--wan_tokenizer", type=str, default=None)
    p.add_argument("--wan_lora", type=str, default=None,
                   help="merged two-stage motion adapter (B = B1 + B2)")
    p.add_argument("--height", type=int, default=480)
    p.add_argument("--width", type=int, default=832)
    p.add_argument("--num_frames", type=int, default=81)
    p.add_argument("--steps", type=int, default=50)
    p.add_argument("--cfg_scale", type=float, default=5.0)
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--fps", type=int, default=15)
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device of every stage; cpu runs the plain PyTorch path")
    args = p.parse_args(argv)
    from fairygen_tpu_torch.device import resolve_device

    resolve_device(args.device)
    ws = args.workspace
    stages = [s.strip() for s in args.stages.split(",") if s.strip()]
    character = os.path.join(ws, "character.png")
    mask = os.path.join(ws, "mask.png")
    prompts = os.path.join(ws, "prompts")
    shots = os.path.join(ws, "shots")
    clips = os.path.join(ws, "clips")
    device = ["--device", args.device]

    if "mask" in stages:
        from fairygen_tpu_torch.tools.create_mask import main as mask_main

        if not args.isnet:
            p.error("--isnet weights are required for the mask stage")
        stage_argv = ["--input", character, "--output", mask, "--weights", args.isnet]
        if args.mask_infer_size:
            stage_argv += ["--infer_size", str(args.mask_infer_size)]
        _run_stage(mask_main, stage_argv + device, "mask")

    if "style" in stages:
        from fairygen_tpu_torch.examples.dora_train import main as dora_main

        if not (args.sdxl_unet and args.sdxl_vae):
            p.error("--sdxl_unet and --sdxl_vae are required for the style stage")
        _run_stage(dora_main, [
            "--unet", args.sdxl_unet, "--vae", args.sdxl_vae,
            "--te1", args.sdxl_te1, "--te2", args.sdxl_te2,
            "--tokenizer1", args.tokenizer1, "--tokenizer2", args.tokenizer2,
            "--image", character, "--mask", mask, "--caption", args.caption,
            "--rank", str(args.dora_rank), "--max_train_steps", str(args.dora_steps),
            "--resolution", str(args.resolution), "--output_path", os.path.join(ws, "dora"),
        ] + device, "style")

    if "stylize" in stages:
        from fairygen_tpu_torch.examples.brushnet_stylize import main as stylize_main

        if not args.brushnet:
            p.error("--brushnet is required for the stylize stage")
        _run_stage(stylize_main, [
            "--unet", args.sdxl_unet, "--vae", args.sdxl_vae,
            "--te1", args.sdxl_te1, "--te2", args.sdxl_te2,
            "--tokenizer1", args.tokenizer1, "--tokenizer2", args.tokenizer2,
            "--brushnet", args.brushnet,
            "--dora", os.path.join(ws, "dora", "pytorch_lora_weights.safetensors"),
            "--lora_scale", str(args.lora_scale),
            "--brushnet_conditioning_scale", str(args.brushnet_conditioning_scale),
            "--image", character, "--mask", mask,
            "--prompt_dir", prompts, "--output_dir", shots,
            "--size", str(args.resolution), "--steps", str(args.stylize_steps),
            "--seed", "333",
        ] + device, "stylize")

    if "animate" in stages:
        from fairygen_tpu_torch.examples.wan_batch_inference import main as animate_main

        if not args.wan_model_paths:
            p.error("--wan_model_paths is required for the animate stage")
        n = stage_motion_prompts(shots, os.path.join(ws, "motion"), prompts)
        print(f"== staged motion prompts for {n} shots")
        stage_argv = [
            "--model_paths", args.wan_model_paths, "--shot_dir", shots, "--output_dir", clips,
            "--height", str(args.height), "--width", str(args.width),
            "--num_frames", str(args.num_frames), "--num_inference_steps", str(args.steps),
            "--cfg_scale", str(args.cfg_scale), "--seed", str(args.seed), "--fps", str(args.fps),
        ]
        if args.wan_tokenizer:
            stage_argv += ["--tokenizer_path", args.wan_tokenizer]
        if args.wan_lora:
            stage_argv += ["--lora", args.wan_lora]
        _run_stage(animate_main, stage_argv + device, "animate")

    print("story complete:", ws)
    return 0


if __name__ == "__main__":
    sys.exit(main())
