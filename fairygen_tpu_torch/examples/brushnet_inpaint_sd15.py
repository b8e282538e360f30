"""SD1.5 + BrushNet inpainting on the port: mask a region of the source image,
inpaint it with BrushNet guidance under the UniPC sampler, and optionally
paste the original pixels back outside a blurred mask (``--blended``).  The
twin of examples/brushnet_inpaint_sd15.py, with its flags, defaults and
dtypes (bf16 UNet, BrushNet and text encoder, the fp32 VAE at scaling factor
0.18215), plus ``--device`` (default cuda).  ``FAIRYGEN_CONFIG_OVERRIDES``
may resize the models (keys ``sd15_unet``, ``sd15_brushnet``, ``sd15_vae``,
``sd15_te``) for tiny checkpoints.

  python -m fairygen_tpu_torch.examples.brushnet_inpaint_sd15 \\
      --unet ckpts/sd15_unet.safetensors --brushnet ckpts/brushnet.safetensors \\
      --vae ckpts/sd15_vae.safetensors --te ckpts/clip_l.safetensors \\
      --tokenizer ckpts/tokenizer --image src/test_image.jpg --mask src/test_mask.jpg \\
      --prompt "A cake on the table." --output output.png
"""
import argparse
import sys


def load_pipeline(args):
    """The SD1.5 + BrushNet pipeline from --unet/--brushnet/--vae/--te/
    --tokenizer on ``args.device`` (this CLI's and app_brushnet's)."""
    import torch

    from fairygen_tpu_torch.core.io import load_state_dict
    from fairygen_tpu_torch.core.model_config import override_config
    from fairygen_tpu_torch.device import resolve_device
    from fairygen_tpu_torch.models.sdxl.clip import CLIPTextConfig, convert_clip_text_state_dict
    from fairygen_tpu_torch.models.sdxl.unet2d import UNet2DConfig, convert_unet2d_state_dict
    from fairygen_tpu_torch.models.sdxl.vae import (AutoencoderKLConfig,
                                                    convert_autoencoder_kl_state_dict)
    from fairygen_tpu_torch.pipelines.sd15_brushnet import SD15BrushNetPipeline
    from fairygen_tpu_torch.utils.tokenizer import CLIPTokenizerWrapper

    dev = resolve_device(getattr(args, "device", "cuda"))
    dtype = torch.bfloat16
    unet_cfg = override_config("sd15_unet", UNet2DConfig.sd15_base())
    bn_cfg = override_config("sd15_brushnet", UNet2DConfig.brushnet_sd15())
    vae_cfg = override_config("sd15_vae", AutoencoderKLConfig(scaling_factor=0.18215))
    te_cfg = override_config("sd15_te", CLIPTextConfig())
    return SD15BrushNetPipeline(
        convert_unet2d_state_dict(load_state_dict(args.unet), unet_cfg, dtype, device=dev),
        unet_cfg,
        convert_autoencoder_kl_state_dict(load_state_dict(args.vae), vae_cfg, torch.float32,
                                          device=dev), vae_cfg,
        brushnet_params=convert_unet2d_state_dict(load_state_dict(args.brushnet), bn_cfg, dtype,
                                                  device=dev),
        brushnet_cfg=bn_cfg,
        te_params=convert_clip_text_state_dict(load_state_dict(args.te), te_cfg, dtype,
                                               device=dev),
        te_cfg=te_cfg, tokenizer=CLIPTokenizerWrapper(args.tokenizer), dtype=dtype, device=dev)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--unet", type=str, required=True, help="SD1.5 UNet safetensors")
    p.add_argument("--brushnet", type=str, required=True)
    p.add_argument("--vae", type=str, required=True)
    p.add_argument("--te", type=str, required=True, help="CLIP ViT-L text encoder")
    p.add_argument("--tokenizer", type=str, required=True)
    p.add_argument("--image", type=str, required=True)
    p.add_argument("--mask", type=str, required=True,
                   help="white = region to inpaint (reference test_brushnet.py:38)")
    p.add_argument("--prompt", type=str, required=True)
    p.add_argument("--negative_prompt", type=str, default="")
    p.add_argument("--steps", type=int, default=50)
    p.add_argument("--guidance_scale", type=float, default=7.5)
    p.add_argument("--brushnet_conditioning_scale", type=float, default=1.0)
    p.add_argument("--seed", type=int, default=1234)
    p.add_argument("--size", type=int, default=512)
    p.add_argument("--blended", action="store_true",
                   help="Gaussian-blurred paste of the original pixels "
                        "outside the mask (test_brushnet.py:55-67)")
    p.add_argument("--output", type=str, default="output.png")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device; cpu runs the plain PyTorch versions of the kernels")
    args = p.parse_args(argv)

    import numpy as np
    from PIL import Image

    pipe = load_pipeline(args)
    size = (args.size, args.size)
    init = np.asarray(Image.open(args.image).convert("RGB").resize(size), np.float32) / 255.0
    mask = (np.asarray(Image.open(args.mask).convert("RGB").resize(size),
                       np.float32).sum(-1) > 255)[..., None].astype(np.float32)
    masked = init * (1.0 - mask)  # reference test_brushnet.py:39
    frames = pipe(prompt=args.prompt, negative_prompt=args.negative_prompt, image=masked,
                  mask=mask, height=args.size, width=args.size, num_inference_steps=args.steps,
                  guidance_scale=args.guidance_scale,
                  brushnet_conditioning_scale=args.brushnet_conditioning_scale, seed=args.seed,
                  blended=args.blended, original_image=init)
    Image.fromarray(frames[0]).save(args.output)
    print(f"saved {args.output}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
