"""Calibrate per-channel activation statistics for outlier-robust W8A8 on a
Wan checkpoint, and report the quantization health check.  The twin of
tools/calibrate_quant.py, with its flags, plus ``--device`` (default cuda).

    python -m fairygen_tpu_torch.tools.calibrate_quant \\
        --model_paths '["dit.safetensors"]' --height 480 --width 832 \\
        --num_frames 81 --steps 50 --out act_amax.npz

    # then
    amax = load_act_amax("act_amax.npz")
    pipe.quantize("int8", act_amax=amax, outlier_k={"ffn": {"fc2": 8}})

Noise and a stand-in context are drawn from ``--seed`` on the host.  Per
calibrated layer the report gives the largest amax over the layer's median
channel (what plain per-row scaling sees) and the same after the
SmoothQuant migration at ``--alpha``, then advice: plain W8A8, smoothing, or
smoothing with the bf16 fallback at the worst layer.
"""
import argparse
import json
import sys


def load_act_amax(path):
    """act_amax.npz (keys "group/name") -> the {group: {name: (L, K)}} dict
    ``pipe.quantize(act_amax=)`` takes."""
    import numpy as np

    data = np.load(path)
    out = {}
    for k in data.files:
        g, name = k.split("/", 1)
        out.setdefault(g, {})[name] = data[k]
    return out


def save_act_amax(path, amax):
    """The {group: {name: (L, K)}} dict -> an npz of "group/name" arrays."""
    import numpy as np

    np.savez(path, **{f"{g}/{name}": np.asarray(a, np.float32)
                      for g, layers in amax.items() for name, a in layers.items()})


def parser():
    p = argparse.ArgumentParser()
    p.add_argument("--model_paths", type=str, required=True,
                   help="JSON list of checkpoint paths (DiT required)")
    p.add_argument("--height", type=int, default=480)
    p.add_argument("--width", type=int, default=832)
    p.add_argument("--num_frames", type=int, default=81)
    p.add_argument("--steps", type=int, default=50)
    p.add_argument("--rollouts", type=int, default=2)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--alpha", type=float, default=0.5)
    p.add_argument("--out", type=str, default=None,
                   help="save the stats as an npz (group/name arrays)")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device; cpu runs the plain PyTorch versions of the kernels")
    return p


def main(argv=None):
    args = parser().parse_args(argv)

    import numpy as np
    import torch

    from fairygen_tpu_torch.pipelines.wan_video import WanVideoPipeline
    from fairygen_tpu_torch.training.quant_experiment import (
        calibrate_wan_dit_act_amax,
        rollout_calibration_samples,
    )

    pipe = WanVideoPipeline.from_pretrained(json.loads(args.model_paths), device=args.device)
    cfg = pipe.dit_cfg
    f = pipe.vae_cfg.upsampling_factor if pipe.vae_cfg else 16
    lat_shape = (1, cfg.in_dim, (args.num_frames - 1) // 4 + 1, args.height // f,
                 args.width // f)
    gen = torch.Generator("cpu").manual_seed(args.seed)
    amax = None
    for _ in range(args.rollouts):
        noise = torch.randn(lat_shape, generator=gen).to(pipe.device, pipe.dtype)
        ctx = torch.randn((1, 512, cfg.text_dim), generator=gen).to(pipe.device, pipe.dtype)
        samples = rollout_calibration_samples(pipe.dit_params, cfg, noise, ctx,
                                              rollout_steps=args.steps)
        got = calibrate_wan_dit_act_amax(pipe.dit_params, cfg, samples)
        if amax is None:
            amax = got
        else:
            for g in got:
                for name in got[g]:
                    amax[g][name] = np.maximum(amax[g][name], got[g][name])

    report = {}
    for g, layers in amax.items():
        for name, am in layers.items():
            wmax = np.stack([blk[g][name]["w"].float().abs().amax(-1).cpu().numpy()
                             for blk in pipe.dit_params["blocks"]])
            typ = np.median(am, axis=-1, keepdims=True) + 1e-12
            s = np.power(np.maximum(am, 1e-12), args.alpha) / \
                np.power(np.maximum(wmax, 1e-12), 1 - args.alpha)
            sm = am / s
            report[f"{g}.{name}"] = {
                "amax_over_typical_max": float((am / typ).max()),
                "smoothed_over_typical_max": float(
                    (sm / np.median(sm, axis=-1, keepdims=True)).max()),
            }
    worst = max(report.items(), key=lambda kv: kv[1]["amax_over_typical_max"])
    print(json.dumps({
        "per_layer": report,
        "worst_layer": worst[0],
        "advice": (
            "plain W8A8 fine" if worst[1]["amax_over_typical_max"] < 8 else
            "enable smoothing (act_amax=)" if worst[1]["smoothed_over_typical_max"] < 8 else
            f"enable smoothing + bf16 fallback at {worst[0]} (outlier_k={{...}})"),
    }))
    if args.out:
        save_act_amax(args.out, amax)
        print(f"saved {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
