"""Foreground mask of a training image on the port: ISNet (the network
inside rembg's isnet-anime session) from a DIS-format checkpoint, a
binarized ({0, 255}) mask saved as an image.  The twin of
tools/create_mask.py, with its flags, plus ``--device`` (default cuda).

  python -m fairygen_tpu_torch.tools.create_mask --weights isnet-anime.safetensors \\
      --input texture.png --output mask.png [--preset isnet-anime]
"""
import argparse
import sys


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--weights", required=True,
                   help="DIS / isnet state dict (.safetensors or torch .pth)")
    p.add_argument("--input", required=True)
    p.add_argument("--output", required=True)
    p.add_argument("--preset", default="isnet-anime",
                   choices=["isnet-anime", "isnet-general-use"])
    p.add_argument("--threshold", type=int, default=127, help="binarize at > threshold")
    p.add_argument("--infer_size", type=int, default=0,
                   help="inference resolution in place of the preset's (0 = its 1024)")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device; cpu runs the plain PyTorch path")
    args = p.parse_args(argv)

    import numpy as np
    from PIL import Image

    from fairygen_tpu_torch.core.io import load_state_dict
    from fairygen_tpu_torch.core.model_config import override_config
    from fairygen_tpu_torch.device import resolve_device
    from fairygen_tpu_torch.models.isnet import ISNetConfig, convert_isnet_state_dict, extract_mask

    dev = resolve_device(args.device)
    image = np.asarray(Image.open(args.input).convert("RGB"))
    cfg = override_config("isnet", ISNetConfig.dis())
    params, cfg = convert_isnet_state_dict(load_state_dict(args.weights), cfg, device=dev)
    mask = extract_mask(params, cfg, image, preset=args.preset, threshold=args.threshold,
                        size=(args.infer_size,) * 2 if args.infer_size else None)
    Image.fromarray(mask, mode="L").save(args.output)
    print(f"mask saved to {args.output}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
