"""Plain SDXL text-to-image on the port, with an optional style DoRA/LoRA
(no BrushNet, no inpainting).  The twin of examples/sdxl_t2i.py, with its
flags and dtypes (bf16 UNet and text encoders, the fp32 VAE), plus
``--device`` (default cuda).  ``--scheduler lcm`` takes the few-step LCM
rollout for LCM-LoRA or distilled UNets.

  python -m fairygen_tpu_torch.examples.sdxl_t2i --unet unet.safetensors \\
      --vae vae.safetensors --te1 te1.safetensors --te2 te2.safetensors \\
      --tokenizer1 tokenizer --tokenizer2 tokenizer_2 [--dora adapter.safetensors] \\
      --prompt "A bustling city street" --output city_street.png
"""
import argparse
import sys


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--unet", type=str, required=True)
    p.add_argument("--vae", type=str, required=True)
    p.add_argument("--te1", type=str, required=True)
    p.add_argument("--te2", type=str, required=True)
    p.add_argument("--tokenizer1", type=str, required=True)
    p.add_argument("--tokenizer2", type=str, required=True)
    p.add_argument("--dora", type=str, default=None,
                   help="style adapter safetensors (loaded at --lora_scale)")
    p.add_argument("--lora_scale", type=float, default=1.0)
    p.add_argument("--prompt", type=str, required=True)
    p.add_argument("--negative_prompt", type=str, default="")
    p.add_argument("--height", type=int, default=480)
    p.add_argument("--width", type=int, default=720)
    p.add_argument("--steps", type=int, default=30)
    p.add_argument("--guidance_scale", type=float, default=7.5)
    p.add_argument("--scheduler", type=str, default="dpm", choices=["dpm", "lcm"],
                   help="lcm = few-step sampling for LCM-LoRA/distilled UNets")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--output", type=str, default="output.png")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device; cpu runs the plain PyTorch versions of the kernels")
    args = p.parse_args(argv)

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
    te1_cfg = override_config("sdxl_te1", CLIPTextConfig.sdxl_te1())
    te2_cfg = override_config("sdxl_te2", CLIPTextConfig.sdxl_te2())
    unet_params = convert_unet2d_state_dict(load_state_dict(args.unet), unet_cfg, dtype,
                                            device=dev)
    if args.dora:
        unet_params, n = load_sdxl_dora_state_dict(unet_params, load_state_dict(args.dora),
                                                   scale=args.lora_scale)
        print(f"{n} style-adapter modules loaded (scale {args.lora_scale})")

    pipe = SDXLBrushNetPipeline(
        unet_params, unet_cfg,
        convert_autoencoder_kl_state_dict(load_state_dict(args.vae), vae_cfg, torch.float32,
                                          device=dev), vae_cfg,
        te1_params=convert_clip_text_state_dict(load_state_dict(args.te1), te1_cfg, dtype,
                                                device=dev),
        te1_cfg=te1_cfg,
        te2_params=convert_clip_text_state_dict(load_state_dict(args.te2), te2_cfg, dtype,
                                                device=dev),
        te2_cfg=te2_cfg, dtype=dtype, device=dev,
        tokenizer1=CLIPTokenizerWrapper(args.tokenizer1),
        tokenizer2=CLIPTokenizerWrapper(args.tokenizer2))
    frames = pipe(prompt=args.prompt, negative_prompt=args.negative_prompt, height=args.height,
                  width=args.width, num_inference_steps=args.steps,
                  guidance_scale=args.guidance_scale, scheduler=args.scheduler, seed=args.seed)
    Image.fromarray(frames[0]).save(args.output)
    print(f"saved {args.output}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
