"""Single-image Style-DoRA training on the port: learn the drawing's art
style from ONE image + mask pair by masked DoRA on the SDXL UNet's
attention projections.  The twin of examples/dora_train.py, with its flags
and defaults, plus ``--device`` (default cuda): the UNet, both text
encoders and the VAE in fp32, the image encoded to scaled latents, its mask
put on the latent grid by nearest index, the caption through both CLIP
tokenizers and text encoders, ``--max_train_steps`` masked DoRA steps (a
loss line every 20), and ``pytorch_lora_weights.safetensors`` in the
diffusers layout under ``--output_path``.  Resized checkpoints load through
``FAIRYGEN_CONFIG_OVERRIDES`` (``core/model_config.py``).

  python -m fairygen_tpu_torch.examples.dora_train --unet unet.safetensors \\
      --vae vae.safetensors --te1 te1.safetensors --te2 te2.safetensors \\
      --tokenizer1 tokenizer --tokenizer2 tokenizer_2 --image texture.png \\
      --mask mask.png --caption "a drawing" --output_path ./dora_out
"""
import argparse
import os
import sys


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--unet", type=str, required=True)
    p.add_argument("--vae", type=str, required=True)
    p.add_argument("--te1", type=str, required=True)
    p.add_argument("--te2", type=str, required=True)
    p.add_argument("--tokenizer1", type=str, required=True)
    p.add_argument("--tokenizer2", type=str, required=True)
    p.add_argument("--image", type=str, required=True)
    p.add_argument("--mask", type=str, required=True)
    p.add_argument("--caption", type=str, required=True)
    p.add_argument("--resolution", type=int, default=1024)
    p.add_argument("--rank", type=int, default=32)
    p.add_argument("--learning_rate", type=float, default=1e-4)
    p.add_argument("--max_train_steps", type=int, default=400)
    p.add_argument("--snr_gamma", type=float, default=None)
    p.add_argument("--optimizer", type=str, default="adamw",
                   choices=["adamw", "adafactor", "sgd"])
    p.add_argument("--output_path", type=str, default="./dora_out")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device; cpu runs the plain PyTorch versions of the kernels")
    args = p.parse_args(argv)

    import numpy as np
    import torch
    from PIL import Image

    from fairygen_tpu_torch.core.io import load_state_dict, save_safetensors
    from fairygen_tpu_torch.core.model_config import override_config
    from fairygen_tpu_torch.device import resolve_device
    from fairygen_tpu_torch.models.sdxl.clip import (CLIPTextConfig,
                                                     convert_clip_text_state_dict,
                                                     sdxl_encode_prompt)
    from fairygen_tpu_torch.models.sdxl.unet2d import UNet2DConfig, convert_unet2d_state_dict
    from fairygen_tpu_torch.models.sdxl.vae import (AutoencoderKLConfig,
                                                    convert_autoencoder_kl_state_dict,
                                                    vae_encode)
    from fairygen_tpu_torch.training.dora_trainer import (add_dora_to_sdxl_unet,
                                                          make_sdxl_dora_train_step,
                                                          sdxl_dora_state_dict)
    from fairygen_tpu_torch.training.optimizers import make_optimizer
    from fairygen_tpu_torch.utils.tokenizer import CLIPTokenizerWrapper

    dev = resolve_device(args.device)
    f32 = torch.float32
    unet_cfg = override_config("sdxl_unet", UNet2DConfig.sdxl_base())
    params = convert_unet2d_state_dict(load_state_dict(args.unet), unet_cfg, f32, device=dev)
    params = add_dora_to_sdxl_unet(params, torch.Generator(dev).manual_seed(args.seed),
                                   rank=args.rank)
    vae_cfg = override_config("sdxl_vae", AutoencoderKLConfig.sdxl())
    vae_params = convert_autoencoder_kl_state_dict(load_state_dict(args.vae), vae_cfg, f32,
                                                   device=dev)
    te1_cfg = override_config("sdxl_te1", CLIPTextConfig.sdxl_te1())
    te2_cfg = override_config("sdxl_te2", CLIPTextConfig.sdxl_te2())
    te1 = convert_clip_text_state_dict(load_state_dict(args.te1), te1_cfg, f32, device=dev)
    te2 = convert_clip_text_state_dict(load_state_dict(args.te2), te2_cfg, f32, device=dev)
    tok1 = CLIPTokenizerWrapper(args.tokenizer1)
    tok2 = CLIPTokenizerWrapper(args.tokenizer2)

    size = (args.resolution, args.resolution)
    img = np.asarray(Image.open(args.image).convert("RGB").resize(size), np.float32)
    mask = np.asarray(Image.open(args.mask).convert("L").resize(size), np.float32)
    pixel = torch.from_numpy(img / 127.5 - 1.0).permute(2, 0, 1)[None].to(dev)
    with torch.no_grad():
        latents = vae_encode(vae_params, vae_cfg, pixel) * vae_cfg.scaling_factor
        h, w = latents.shape[-2:]
        # nearest index of the mask on the latent grid
        ih = np.arange(h) * mask.shape[0] // h
        iw = np.arange(w) * mask.shape[1] // w
        mask_latents = torch.from_numpy((mask[ih][:, iw] > 127).astype(np.float32))
        pe, pooled = sdxl_encode_prompt(te1, te1_cfg, te2, te2_cfg,
                                        torch.as_tensor(tok1(args.caption), device=dev),
                                        torch.as_tensor(tok2(args.caption), device=dev))
    batch = {"latents": latents, "mask_latents": mask_latents[None, None].to(dev),
             "prompt_embeds": pe, "pooled": pooled,
             "original_size": torch.tensor([[args.resolution, args.resolution]], device=dev),
             "crop_top_left": torch.tensor([[0, 0]], device=dev)}

    init_state, train_step = make_sdxl_dora_train_step(
        unet_cfg, make_optimizer(args.optimizer, args.learning_rate, weight_decay=1e-2),
        snr_gamma=args.snr_gamma, resolution=args.resolution, device=dev)
    state = init_state(params)
    generator = torch.Generator(dev).manual_seed(args.seed)
    for step in range(1, args.max_train_steps + 1):
        state, loss = train_step(state, batch, generator)
        if step % 20 == 0:
            print(f"step {step} loss {float(loss):.5f}", flush=True)

    os.makedirs(args.output_path, exist_ok=True)
    out = os.path.join(args.output_path, "pytorch_lora_weights.safetensors")
    save_safetensors(out, sdxl_dora_state_dict(state.params))
    print(f"saved {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
