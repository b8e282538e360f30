"""Stylized backgrounds on the port: the SDXL UNet with the Style-DoRA
adapter and BrushNet masked inpainting, one image per prompt ``.txt`` of
``--prompt_dir``.  The twin of examples/brushnet_stylize.py, with its flags
and dtypes (bf16 UNet, BrushNet and text encoders, the fp32 VAE), plus
``--device`` (default cuda).  ``--mesh_data`` above 0 exits with status 2
(ROADMAP.md Queue 1 item 9); ``--scheduler lcm`` takes the few-step LCM
rollout.

  python -m fairygen_tpu_torch.examples.brushnet_stylize --unet unet.safetensors \\
      --brushnet brushnet.safetensors --vae vae.safetensors --te1 te1.safetensors \\
      --te2 te2.safetensors --tokenizer1 tokenizer --tokenizer2 tokenizer_2 \\
      --dora dora_out/pytorch_lora_weights.safetensors --image character.png \\
      --mask mask.png --prompt_dir prompts --output_dir shots
"""
import argparse
import os
import sys


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--unet", type=str, required=True, help="SDXL UNet safetensors")
    p.add_argument("--brushnet", type=str, required=True)
    p.add_argument("--vae", type=str, required=True, help="sdxl-vae-fp16-fix")
    p.add_argument("--te1", type=str, required=True)
    p.add_argument("--te2", type=str, required=True)
    p.add_argument("--tokenizer1", type=str, required=True)
    p.add_argument("--tokenizer2", type=str, required=True)
    p.add_argument("--dora", type=str, default=None, help="style adapter safetensors")
    p.add_argument("--lora_scale", type=float, default=0.66)
    p.add_argument("--image", type=str, required=True, help="character image")
    p.add_argument("--mask", type=str, required=True, help="character mask (white=char)")
    p.add_argument("--prompt_dir", type=str, required=True)
    p.add_argument("--output_dir", type=str, default="outputs")
    p.add_argument("--steps", type=int, default=50)
    p.add_argument("--guidance_scale", type=float, default=7.5)
    p.add_argument("--brushnet_conditioning_scale", type=float, default=0.7)
    p.add_argument("--scheduler", type=str, default="dpm", choices=["dpm", "lcm"],
                   help="lcm = few-step sampling for LCM-LoRA/distilled UNets")
    p.add_argument("--seed", type=int, default=333)
    p.add_argument("--size", type=int, default=1024)
    p.add_argument("--batch_size", type=int, default=1, help="prompts per pipeline call")
    p.add_argument("--mesh_data", type=int, default=0,
                   help="data-parallel mesh size (0 = no mesh)")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device; cpu runs the plain PyTorch versions of the kernels")
    args = p.parse_args(argv)
    if args.mesh_data > 0:
        p.exit(2, f"--mesh_data {args.mesh_data}: data-parallel generation is not ported to "
                  "fairygen_tpu_torch (ROADMAP.md Queue 1 item 9, parallel/)\n")

    import numpy as np
    import torch
    from PIL import Image

    from fairygen_tpu_torch.core.io import load_state_dict
    from fairygen_tpu_torch.core.model_config import override_config
    from fairygen_tpu_torch.device import resolve_device
    from fairygen_tpu_torch.models.sdxl.clip import CLIPTextConfig, convert_clip_text_state_dict
    from fairygen_tpu_torch.models.sdxl.unet2d import UNet2DConfig, convert_unet2d_state_dict
    from fairygen_tpu_torch.models.sdxl.vae import (AutoencoderKLConfig,
                                                    convert_autoencoder_kl_state_dict)
    from fairygen_tpu_torch.pipelines.sdxl_brushnet import SDXLBrushNetPipeline
    from fairygen_tpu_torch.training.dora_trainer import load_sdxl_dora_state_dict
    from fairygen_tpu_torch.utils.tokenizer import CLIPTokenizerWrapper

    dev = resolve_device(args.device)
    dtype = torch.bfloat16
    unet_cfg = override_config("sdxl_unet", UNet2DConfig.sdxl_base())
    vae_cfg = override_config("sdxl_vae", AutoencoderKLConfig.sdxl())
    bn_cfg = override_config("brushnet", UNet2DConfig.brushnet_sdxl())
    te1_cfg = override_config("sdxl_te1", CLIPTextConfig.sdxl_te1())
    te2_cfg = override_config("sdxl_te2", CLIPTextConfig.sdxl_te2())
    unet_params = convert_unet2d_state_dict(load_state_dict(args.unet), unet_cfg, dtype,
                                            device=dev)
    if args.dora:
        # runtime DoRA adapters at the inference-time scale
        unet_params, n = load_sdxl_dora_state_dict(unet_params, load_state_dict(args.dora),
                                                   scale=args.lora_scale)
        print(f"{n} style-adapter modules loaded (scale {args.lora_scale})")

    pipe = SDXLBrushNetPipeline(
        unet_params, unet_cfg,
        convert_autoencoder_kl_state_dict(load_state_dict(args.vae), vae_cfg, torch.float32,
                                          device=dev), vae_cfg,
        convert_unet2d_state_dict(load_state_dict(args.brushnet), bn_cfg, dtype, device=dev),
        bn_cfg,
        convert_clip_text_state_dict(load_state_dict(args.te1), te1_cfg, dtype, device=dev),
        te1_cfg,
        convert_clip_text_state_dict(load_state_dict(args.te2), te2_cfg, dtype, device=dev),
        te2_cfg, dtype=dtype, device=dev, tokenizer1=CLIPTokenizerWrapper(args.tokenizer1),
        tokenizer2=CLIPTokenizerWrapper(args.tokenizer2))

    size = (args.size, args.size)
    init = np.asarray(Image.open(args.image).convert("RGB").resize(size), np.float32) / 255.0
    mask = (np.asarray(Image.open(args.mask).convert("L").resize(size), np.float32)
            > 250 / 255.0 * 255)[..., None].astype(np.float32)
    masked = init * (1.0 - mask)  # character blanked; background to paint

    os.makedirs(args.output_dir, exist_ok=True)
    names, prompts = [], []
    for fname in sorted(os.listdir(args.prompt_dir)):
        if fname.endswith(".txt"):
            with open(os.path.join(args.prompt_dir, fname)) as f:
                prompts.append(f.read().strip())
            names.append(os.path.splitext(fname)[0])

    bs = max(args.batch_size, 1)
    for i in range(0, len(prompts), bs):
        chunk = prompts[i:i + bs]
        frames = pipe(prompt=chunk if len(chunk) > 1 else chunk[0], image=masked, mask=mask,
                      height=args.size, width=args.size, num_inference_steps=args.steps,
                      guidance_scale=args.guidance_scale, scheduler=args.scheduler,
                      brushnet_conditioning_scale=args.brushnet_conditioning_scale,
                      seed=args.seed + i)
        for j, frame in enumerate(frames):
            out_path = os.path.join(args.output_dir, names[i + j] + ".png")
            Image.fromarray(frame).save(out_path)
            print(f"{names[i + j]} -> {out_path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
