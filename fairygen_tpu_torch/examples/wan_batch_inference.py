"""Multi-shot story animation on the port: each ``NN.png`` still of
``--shot_dir`` with its sibling ``NN.txt`` prompt through one pipeline, one
clip per shot.  The twin of examples/wan_batch_inference.py, plus
``--device`` (default cuda).

  python -m fairygen_tpu_torch.examples.wan_batch_inference \\
      --model_paths '[...]' --tokenizer_path ckpts/umt5-tokenizer --shot_dir shots
"""
import argparse
import json
import os
import sys

from fairygen_tpu_torch.examples.wan_inference import NEGATIVE_PROMPT


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--model_paths", type=str, required=True)
    p.add_argument("--tokenizer_path", type=str, default=None)
    p.add_argument("--lora", type=str, default=None)
    p.add_argument("--shot_dir", type=str, required=True,
                   help="Directory of NN.png stills with NN.txt prompts.")
    p.add_argument("--output_dir", type=str, default="outputs")
    p.add_argument("--height", type=int, default=480)
    p.add_argument("--width", type=int, default=832)
    p.add_argument("--num_frames", type=int, default=81)
    p.add_argument("--num_inference_steps", type=int, default=50)
    p.add_argument("--cfg_scale", type=float, default=5.0)
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--fps", type=int, default=15)
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device; cpu runs the plain PyTorch versions of the kernels")
    args = p.parse_args(argv)

    from PIL import Image

    from fairygen_tpu_torch.pipelines.wan_video import WanVideoPipeline
    from fairygen_tpu_torch.utils.video import save_video

    pipe = WanVideoPipeline.from_pretrained(json.loads(args.model_paths),
                                            tokenizer_path=args.tokenizer_path,
                                            device=args.device)
    if args.lora:
        pipe.load_lora(args.lora)
    os.makedirs(args.output_dir, exist_ok=True)
    for shot in sorted(f for f in os.listdir(args.shot_dir) if f.endswith(".png")):
        stem = os.path.splitext(shot)[0]
        prompt_path = os.path.join(args.shot_dir, stem + ".txt")
        if not os.path.exists(prompt_path):
            print(f"skip {shot}: no prompt file")
            continue
        with open(prompt_path) as f:
            prompt = f.read().strip()
        image = Image.open(os.path.join(args.shot_dir, shot)).convert("RGB")
        frames = pipe(prompt=prompt, negative_prompt=NEGATIVE_PROMPT,
                      input_image=image.resize((args.width, args.height)), height=args.height,
                      width=args.width, num_frames=args.num_frames,
                      num_inference_steps=args.num_inference_steps, cfg_scale=args.cfg_scale,
                      seed=args.seed, streaming_vae=True)
        out = save_video(frames, os.path.join(args.output_dir, stem + ".mp4"), fps=args.fps)
        print(f"shot {stem} -> {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
