"""Calibrate TeaCache polynomial coefficients for a Wan checkpoint.  The
twin of tools/calibrate_tea_cache.py, with its flags, plus ``--device``
(default cuda).

    python -m fairygen_tpu_torch.tools.calibrate_tea_cache \\
        --model_paths '["dit.safetensors"]' --height 480 --width 832 \\
        --num_frames 81 --steps 50 --rollouts 3 \\
        --model_id Wan2.2-TI2V-5B --out coefficients.json

The printed and saved entry plugs into
``fairygen_tpu_torch.utils.tea_cache_calibration.register_tea_cache_coefficients``,
after which ``pipe(tea_cache_l1_thresh=..., tea_cache_model_id=<model_id>)``
thresholds mean accumulated predicted relative output error.  With
``--target_calc_frac`` it also picks the threshold whose replayed schedule
computes that fraction of the steps (``training.tea_cache_experiment``).
Noise and stand-in contexts are drawn from ``--seed`` on the host.
"""
import argparse
import json
import sys


def parser():
    p = argparse.ArgumentParser()
    p.add_argument("--model_paths", type=str, required=True,
                   help="JSON list of checkpoint paths (DiT required)")
    p.add_argument("--height", type=int, default=480)
    p.add_argument("--width", type=int, default=832)
    p.add_argument("--num_frames", type=int, default=81)
    p.add_argument("--steps", type=int, default=50)
    p.add_argument("--rollouts", type=int, default=3)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--model_id", type=str, default="calibrated")
    p.add_argument("--out", type=str, default=None)
    p.add_argument("--target_calc_frac", type=float, default=None,
                   help="also pick the threshold whose replayed schedule computes this "
                        "fraction of steps (e.g. 0.7)")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device; cpu runs the plain PyTorch versions of the kernels")
    return p


def main(argv=None):
    args = parser().parse_args(argv)

    import torch

    from fairygen_tpu_torch.pipelines.wan_video import WanVideoPipeline
    from fairygen_tpu_torch.utils.tea_cache_calibration import calibrate_wan_tea_cache

    pipe = WanVideoPipeline.from_pretrained(json.loads(args.model_paths), device=args.device)
    cfg = pipe.dit_cfg
    f = pipe.vae_cfg.upsampling_factor if pipe.vae_cfg else 16
    lat_shape = (1, cfg.in_dim, (args.num_frames - 1) // 4 + 1, args.height // f,
                 args.width // f)
    gen = torch.Generator("cpu").manual_seed(args.seed)
    lats, ctxs = [], []
    for _ in range(args.rollouts):
        lats.append(torch.randn(lat_shape, generator=gen).to(pipe.device, pipe.dtype))
        ctxs.append(torch.randn((1, 512, cfg.text_dim), generator=gen)
                    .to(pipe.device, pipe.dtype))
    coeffs, (xs, ys) = calibrate_wan_tea_cache(pipe.dit_params, cfg, lats, ctxs,
                                               num_inference_steps=args.steps)
    entry = {args.model_id: coeffs}
    report = {"coefficients": entry, "pairs": len(xs),
              "x_range": [float(xs.min()), float(xs.max())],
              "y_range": [float(ys.min()), float(ys.max())]}
    if args.target_calc_frac is not None:
        from fairygen_tpu_torch.training.tea_cache_experiment import (
            pick_threshold,
            simulate_calc_schedule,
        )

        xs_one = xs[: args.steps - 1]  # t_mod depends only on the timestep
        thresh = pick_threshold(coeffs, xs_one, args.steps, args.target_calc_frac)
        mask = simulate_calc_schedule(coeffs, xs_one, thresh, args.steps)
        report["threshold"] = float(thresh)
        report["predicted_calc_steps"] = int(mask.sum())
        report["predicted_skip_steps"] = int(args.steps - mask.sum())
    print(json.dumps(report))
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(entry, fh, indent=1)
        print(f"saved {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
