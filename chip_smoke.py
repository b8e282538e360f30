#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (fairygen_tpu_torch) once on one NVIDIA card.

    python3 chip_smoke.py                 # the whole run, one card
    python3 chip_smoke.py --kernels-only  # device, build and kernel checks only

Phases, each printing its wall seconds:
  1. device   — card name/count, nvidia-smi name and power limit, TF32 off.
  2. build    — the single nvcc command (ptxas -v output printed once).
  3. kernels  — K1-K4 against their plain PyTorch versions on the card in
                bf16 at the main path's shapes (480x832, 17 frames: S=1950)
                and the flagship's (81 frames: S=8190); error, kernel ms,
                plain ms, the bound, and scaled_dot_product_attention as a
                yardstick for K3/K4 (timed here only; the port never calls it).
  4. weights  — full-width Wan2.2-TI2V-5B DiT, UMT5-XXL and VAE38, made on
                the card in bf16 from a seeded CUDA generator.
  5. requests — WanVideoPipeline answers two 480x832x17-frame, 4-step,
                CFG 5 text+image-to-video requests; launch counts of K1-K4
                are checked exactly (per DiT sweep: 90, 90, 30, 30).
  6. breakdown — each stage of a request alone, and one DiT sweep under
                torch.profiler (device time by kernel, busy share).
  7. reference — a tiny-width pipeline on the card (kernels, bf16) against
                the same pipeline on the CPU (plain versions, fp32).
Then the card line, one JSON line of kernel numbers and the result line.
Any failure exits non-zero; past BUDGET_S seconds the run stops, naming
the phase it was in.
"""
import json
import os
import subprocess
import sys
import threading
import time

BUDGET_S = 600
HERE = os.path.dirname(os.path.abspath(__file__))
PHASE = ["start"]

H100_BYTES_PER_S = 3.35e12    # HBM3, NVIDIA H100 SXM data sheet
H100_BF16_FLOP_PER_S = 989e12  # dense bf16 tensor cores, same source


def _watchdog():
    sys.stderr.write(f"chip_smoke: over the {BUDGET_S} s budget in phase '{PHASE[0]}'\n")
    sys.stderr.flush()
    os._exit(3)


def phase(name):
    PHASE[0] = name
    print(f"== phase {name}", flush=True)
    return time.perf_counter()


def done(name, t0):
    print(f"[{name}] {time.perf_counter() - t0:.3f} s", flush=True)


def time_ms(fn, inner=20, rounds=5):
    """ms per call: CUDA events around ``inner`` back-to-back calls (so the
    host's launch gaps overlap the device's work), median of ``rounds``,
    after one warm-up.  Inputs stay warm in the 50 MB L2 where they fit."""
    import torch

    fn()
    times = []
    for _ in range(rounds):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(inner):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / inner)
    times.sort()
    return times[len(times) // 2]


def bound_ms(nbytes, flops):
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = flops / H100_BF16_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_close(name, out, ref, rtol, atol):
    import torch

    err = (out.float() - ref.float()).abs()
    max_abs = err.max().item()
    max_rel = (err / ref.float().abs().clamp_min(1e-6)).max().item()
    print(f"  {name}: max_abs_err {max_abs:.3e} max_rel_err {max_rel:.3e} "
          f"(tolerance |d| <= {atol} + {rtol}*|ref|)", flush=True)
    torch.testing.assert_close(out.float(), ref.float(), rtol=rtol, atol=atol)
    return max_abs


def kernel_checks(S, grid, tag):
    """K1-K4 at one shape set; returns {kernel: numbers}."""
    import torch
    import torch.nn.functional as F

    from fairygen_tpu_torch.ops import fused_qk as fq
    from fairygen_tpu_torch.ops.flash_attention import (
        flash_attention_heads_major, flash_attention_heads_major_plain)
    from fairygen_tpu_torch.ops.fused_norms import (
        layer_norm_modulate, layer_norm_modulate_plain)
    from fairygen_tpu_torch.ops.rope import build_freqs_grid, precompute_freqs_3d

    dev, bf = "cuda", torch.bfloat16
    g = torch.Generator(dev).manual_seed(1234 + S)
    N, hd, D, seg, lk = 24, 128, 3072, 390, 512
    res = {}

    def randn(*shape, scale=1.0, dtype=bf):
        return (torch.randn(shape, generator=g, device=dev) * scale).to(dtype)

    # K1 (bf16 output; 1 bf16 ulp is <= 2^-7 relative)
    x = randn(1, S, D)
    sh, sc = randn(1, 2, D, scale=0.1), randn(1, 2, D, scale=0.1)
    out = layer_norm_modulate(x, sh, sc, seg, 1e-6)
    ref = layer_norm_modulate_plain(x, sh, sc, seg, 1e-6)
    err = check_close(f"K1 ln_modulate S={S}", out, ref, rtol=2 ** -7, atol=1e-5)
    nbytes = 2 * S * D * 2 + 2 * 2 * D * 2
    res["ln_modulate"] = dict(
        max_abs_err=err, ms=time_ms(lambda: layer_norm_modulate(x, sh, sc, seg, 1e-6)),
        plain_ms=time_ms(lambda: layer_norm_modulate_plain(x, sh, sc, seg, 1e-6)),
        bound=bound_ms(nbytes, 8 * S * D), library_ms=None)

    # K2 (the kernel rounds where the plain version does: expect 0)
    s_pad, bq, bk = fq._pad_for_flash(S)
    ff = fq.build_freqs_full(build_freqs_grid(precompute_freqs_3d(hd), *grid, device=dev))
    xq, xk = randn(1, S, D), randn(1, S, D)
    gq = randn(D, scale=hd ** -0.5 * 1.4427)
    gk = randn(D)
    rsq, rsk = fq._rowscale(xq, 1e-6), fq._rowscale(xk, 1e-6)
    qh = fq.rms_rope_heads_major(xq, gq, rsq, ff, N, s_pad)
    ref = fq.rms_rope_heads_major_plain(xq, gq, rsq, ff, N, s_pad)
    err = check_close(f"K2 rms_rope S={S}", qh, ref, rtol=2 ** -7, atol=1e-5)
    qc = fq.rms_rope_heads_major(xq, gq, rsq, None, N, s_pad, rope=False)
    err = max(err, check_close(f"K2 rms_rope rope=False S={S}", qc,
                               fq.rms_rope_heads_major_plain(xq, gq, rsq, None, N, s_pad,
                                                             rope=False),
                               rtol=2 ** -7, atol=1e-5))
    kh = fq.rms_rope_heads_major(xk, gk, rsk, ff, N, s_pad)
    nbytes = S * D * 2 + S * 4 + D * 2 + 2 * S * hd * 4 + N * s_pad * hd * 2
    res["rms_rope_heads_major"] = dict(
        max_abs_err=err, ms=time_ms(lambda: fq.rms_rope_heads_major(xq, gq, rsq, ff, N, s_pad)),
        plain_ms=time_ms(lambda: fq.rms_rope_heads_major_plain(xq, gq, rsq, ff, N, s_pad), 5, 3),
        bound=bound_ms(nbytes, 6 * S * D), library_ms=None)

    def sdpa(q_h, k_h, v_nat, sq, sk):
        # same function: q carries hd^-1/2*log2(e), so scale ln(2) gives exp2
        q4 = q_h.view(1, N, -1, hd)[:, :, :sq]
        k4 = k_h.view(1, N, -1, hd)[:, :, :sk]
        return lambda: F.scaled_dot_product_attention(
            q4, k4, v_nat.transpose(1, 2), scale=0.6931471805599453)

    # K3: self-attention, several k tiles
    v = randn(1, S, N, hd)
    out = flash_attention_heads_major(qh, kh, v, b=1, n=N, sq=S, sk_actual=S, bq=bq, bk=bk)
    ref = flash_attention_heads_major_plain(qh, kh, v, b=1, n=N, sq=S, sk_actual=S)
    err = check_close(f"K3 flash_bounded S={S}", out, ref, rtol=2 ** -7, atol=1e-3)
    res["flash_bounded"] = dict(
        max_abs_err=err,
        ms=time_ms(lambda: flash_attention_heads_major(qh, kh, v, b=1, n=N, sq=S, sk_actual=S,
                                                       bq=bq, bk=bk)),
        plain_ms=time_ms(lambda: flash_attention_heads_major_plain(qh, kh, v, b=1, n=N, sq=S,
                                                                   sk_actual=S), 2, 3),
        bound=bound_ms(4 * S * hd * N * 2, 4 * S * S * hd * N),
        library_ms=time_ms(sdpa(qh, kh, v, S, S)))

    # K4: text cross-attention, one k tile of Lk = 512
    kc = randn(1, lk, N, hd)
    kc = (kc.float() * torch.rsqrt(kc.float().pow(2).mean(-1, keepdim=True) + 1e-6)).to(bf)
    vc = randn(1, lk, N, hd)
    khc = kc.permute(0, 2, 1, 3).reshape(N, lk, hd).contiguous()
    out = flash_attention_heads_major(qc, khc, vc, b=1, n=N, sq=S, sk_actual=lk, bq=bq, bk=lk)
    ref = flash_attention_heads_major_plain(qc, khc, vc, b=1, n=N, sq=S, sk_actual=lk)
    err = check_close(f"K4 flash_small_kv S={S}", out, ref, rtol=2 ** -7, atol=1e-3)
    res["flash_small_kv"] = dict(
        max_abs_err=err,
        ms=time_ms(lambda: flash_attention_heads_major(qc, khc, vc, b=1, n=N, sq=S,
                                                       sk_actual=lk, bq=bq, bk=lk)),
        plain_ms=time_ms(lambda: flash_attention_heads_major_plain(qc, khc, vc, b=1, n=N, sq=S,
                                                                   sk_actual=lk), 2, 3),
        bound=bound_ms((2 * S + 2 * lk) * hd * N * 2, 4 * S * lk * hd * N),
        library_ms=time_ms(sdpa(qc, khc, vc, S, lk)))
    for k, r in res.items():
        lib = "null" if r["library_ms"] is None else f"{r['library_ms']:.4f}"
        print(f"  {tag} {k}: ms {r['ms']:.4f} plain_ms {r['plain_ms']:.4f} "
              f"bound_ms {r['bound'][0]:.4f} ({r['bound'][1]}) library_ms {lib}", flush=True)
    return res


def seeded_prompt(seed, vocab, length=512):
    """Token ids of a seeded prompt padded to ``length`` (pad id 0), and the
    empty prompt (EOS id 1 only), with their masks."""
    import torch

    g = torch.Generator("cpu").manual_seed(seed)
    n = int(torch.randint(32, 200, (1,), generator=g))
    ids = torch.zeros((1, length), dtype=torch.long)
    ids[0, :n] = torch.randint(2, vocab, (n,), generator=g)
    mask = (torch.arange(length) < n).long()[None]
    neg_ids = torch.zeros((1, length), dtype=torch.long)
    neg_ids[0, 0] = 1
    neg_mask = (torch.arange(length) < 1).long()[None]
    return ids, mask, neg_ids, neg_mask


def seeded_image(seed, height, width):
    import numpy as np

    return np.random.default_rng(seed).integers(0, 256, (height, width, 3), dtype=np.uint8)


def main(argv):
    if not os.path.isdir(os.path.join(HERE, "fairygen_tpu_torch")):
        sys.stderr.write("chip_smoke: the fairygen_tpu_torch package is not next to this script\n")
        return 2
    sys.path.insert(0, HERE)
    import torch

    if not torch.cuda.is_available():
        sys.stderr.write("chip_smoke: torch.cuda.is_available() is False; this run needs a card\n")
        return 2
    timer = threading.Timer(BUDGET_S, _watchdog)
    timer.daemon = True
    timer.start()
    kernels_only = "--kernels-only" in argv

    from fairygen_tpu_torch.ops import _kernels

    t0 = phase("device")
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"  device {name} count {count}; nvidia-smi: {smi}")
    print(f"  torch {torch.__version__} cuda {torch.version.cuda}; "
          f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")
    done("device", t0)

    t0 = phase("build")
    print("  " + " ".join(_kernels.build_command(verbose=True)))
    print(_kernels.build(verbose=True, force=True, timeout=300))
    _kernels.lib()
    done("build", t0)

    t0 = phase("kernels")
    smoke = kernel_checks(1950, (5, 15, 26), "S=1950")
    flagship = kernel_checks(8190, (21, 15, 26), "S=8190")
    torch.cuda.synchronize()
    done("kernels", t0)

    expected = None
    if not kernels_only:
        from fairygen_tpu_torch import convert
        from fairygen_tpu_torch.models.wan.dit import WanDiTConfig
        from fairygen_tpu_torch.models.wan.text_encoder import UMT5Config
        from fairygen_tpu_torch.models.wan.vae import WanVAEConfig
        from fairygen_tpu_torch.pipelines.wan_video import WanVideoPipeline

        t0 = phase("weights")
        torch.cuda.reset_peak_memory_stats()
        dit_cfg, te_cfg = WanDiTConfig.ti2v_5b(), UMT5Config.umt5_xxl()
        vae_cfg = WanVAEConfig.wan22_38()
        dit = convert.init_dit_params(dit_cfg, "cuda", torch.bfloat16, seed=0)
        te = convert.init_umt5_params(te_cfg, "cuda", torch.bfloat16, seed=1)
        vae = convert.init_vae_params(vae_cfg, "cuda", torch.bfloat16, seed=2)
        torch.cuda.synchronize()
        print(f"  params: DiT {convert.count_params(dit):,} UMT5 {convert.count_params(te):,} "
              f"VAE38 {convert.count_params(vae):,}; max_memory_allocated "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        done("weights", t0)

        t0 = phase("requests")
        pipe = WanVideoPipeline(dit, dit_cfg, vae, vae_cfg, te, te_cfg, torch.bfloat16, "cuda")
        steps, sweeps = 4, 2
        per_sweep = {"ln_modulate": 90, "rms_rope_heads_major": 90,
                     "flash_bounded": 30, "flash_small_kv": 30}
        per_request = {k: v * steps * sweeps for k, v in per_sweep.items()}
        expected = {k: 2 * v for k, v in per_request.items()}
        torch.cuda.reset_peak_memory_stats()
        _kernels.reset_launches()
        for seed in (11, 12):
            ids, mask, nids, nmask = seeded_prompt(seed, te_cfg.vocab)
            before = dict(_kernels.launches)
            tr = time.perf_counter()
            video = pipe(context=pipe.encode_ids(ids, mask),
                         negative_context=pipe.encode_ids(nids, nmask),
                         input_image=seeded_image(seed, 480, 832), seed=seed, height=480,
                         width=832, num_frames=17, cfg_scale=5.0, num_inference_steps=steps,
                         output_type="floatpoint")
            torch.cuda.synchronize()
            dt = time.perf_counter() - tr
            got = {k: _kernels.launches[k] - before[k] for k in per_request}
            finite = bool(torch.isfinite(video).all())
            print(f"  request seed={seed}: {dt:.3f} s, output {tuple(video.shape)} "
                  f"{video.dtype}, all finite: {finite}, launches {got}", flush=True)
            if tuple(video.shape) != (1, 3, 17, 480, 832) or not finite:
                raise RuntimeError("request output has the wrong shape or non-finite values")
            if got != per_request:
                raise RuntimeError(f"launch counts {got} != expected {per_request}")
        launches = dict(_kernels.launches)
        print(f"  launches over both requests: {launches}; max_memory_allocated "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        if launches != expected:
            raise RuntimeError(f"launch counts {launches} != expected {expected}")
        done("requests", t0)

        t0 = phase("breakdown")
        breakdown(pipe, te_cfg)
        del pipe, dit, te, vae, video
        torch.cuda.empty_cache()
        done("breakdown", t0)

        t0 = phase("reference")
        reference_check()
        done("reference", t0)

    sources = {"ln_modulate": ("csrc/ln_modulate.cu", "fairygen_tpu/ops/fused_norms.py:42"),
               "rms_rope_heads_major": ("csrc/rms_rope.cu", "fairygen_tpu/ops/fused_qk.py:91"),
               "flash_bounded": ("csrc/flash_attention.cu",
                                 "fairygen_tpu/ops/flash_attention.py:84"),
               "flash_small_kv": ("csrc/flash_attention.cu",
                                  "fairygen_tpu/ops/flash_attention.py:133")}
    rows = []
    for k, (src, replaces) in sources.items():
        r, f = smoke[k], flagship[k]
        rows.append({
            "name": k, "route": "cuda", "source": "fairygen_tpu_torch/" + src,
            "replaces": replaces, "launches": None if expected is None else launches[k],
            "max_abs_err": max(r["max_abs_err"], f["max_abs_err"]), "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound"][0], "bound_by": r["bound"][1],
            "library_ms": r["library_ms"], "flagship_ms": f["ms"],
            "flagship_plain_ms": f["plain_ms"], "flagship_bound_ms": f["bound"][0],
            "flagship_library_ms": f["library_ms"]})
    timer.cancel()
    print(smi)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": count}}))
    return 0


def breakdown(pipe, te_cfg):
    """Where a request's time goes: each stage alone (host clock around
    synchronised work, median of 3), then one DiT sweep under
    torch.profiler — device time by kernel and the device's busy share."""
    import torch

    from fairygen_tpu_torch.models.wan.dit import precompute_cross_kv, wan_dit_forward
    from fairygen_tpu_torch.models.wan.vae import vae38_decode
    from fairygen_tpu_torch.pipelines.wan_video import _as_pil

    ids, mask, nids, nmask = seeded_prompt(13, te_cfg.vocab)
    g = torch.Generator("cuda").manual_seed(13)
    lat = torch.randn((1, 48, 5, 30, 52), generator=g, device="cuda").to(torch.bfloat16)
    ctx = pipe.encode_ids(ids, mask)
    kv = precompute_cross_kv(pipe.dit_params, pipe.dit_cfg, ctx)
    t = torch.tensor([500.0], device="cuda")

    def sweep():
        return wan_dit_forward(pipe.dit_params, pipe.dit_cfg, lat, t, cross_kv=kv,
                               fuse_vae_embedding_in_latents=True)

    stages = {
        "umt5 encode (prompt + empty prompt)": lambda: (pipe.encode_ids(ids, mask),
                                                        pipe.encode_ids(nids, nmask)),
        "cross k/v hoist (one prompt)": lambda: precompute_cross_kv(pipe.dit_params,
                                                                    pipe.dit_cfg, ctx),
        "vae38 encode first frame": lambda: pipe.encode_first_frame(
            _as_pil(seeded_image(13, 480, 832), 832, 480)),
        "one DiT sweep (S=1950)": sweep,
        "vae38 decode 17 frames": lambda: vae38_decode(pipe.vae_params, pipe.vae_cfg, lat),
    }
    with torch.no_grad():
        for name, fn in stages.items():
            times = []
            for _ in range(3):
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t1)
            print(f"  {name}: {sorted(times)[1] * 1e3:.2f} ms", flush=True)

        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            t1 = time.perf_counter()
            sweep()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t1
    rows = []  # device-side events only: the kernels themselves
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            rows.append((e.self_device_time_total, e.count, e.key))
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows) / 1e6
    print(f"  profiled DiT sweep: wall {wall * 1e3:.2f} ms, device busy {busy * 1e3:.2f} ms "
          f"({100 * busy / wall:.1f}% busy)")
    for dev_us, count, key in rows[:14]:
        print(f"    {dev_us / 1e3:9.3f} ms  x{count:<5d} {key[:100]}")


def to(tree, dev, dt):
    if isinstance(tree, dict):
        return {k: to(v, dev, dt) for k, v in tree.items()}
    if isinstance(tree, list):
        return [to(v, dev, dt) for v in tree]
    return tree.to(dev, dt)


def reference_check():
    """A tiny-width pipeline (head_dim 128, so every kernel runs) on the card
    in bf16 against the same weights on the CPU in fp32 (plain versions).
    bf16 alone moves the final latents by several percent through 4 steps
    of CFG 5, so the bound is relative to that: the card's relative L2
    error to the fp32 run must be at most twice the CPU's own bf16 run's
    (same weights, plain versions) plus 1e-3."""
    import torch

    from fairygen_tpu_torch import convert
    from fairygen_tpu_torch.models.wan.dit import WanDiTConfig
    from fairygen_tpu_torch.models.wan.vae import WanVAEConfig
    from fairygen_tpu_torch.ops import _kernels
    from fairygen_tpu_torch.pipelines.wan_video import WanVideoPipeline

    dit_cfg = WanDiTConfig(dim=256, in_dim=4, ffn_dim=512, out_dim=4, text_dim=64, freq_dim=64,
                           num_heads=2, num_layers=2, seperated_timestep=True,
                           require_vae_embedding=False, require_clip_embedding=False,
                           fuse_vae_embedding_in_latents=True)
    vae_cfg = WanVAEConfig.tiny()
    dit = convert.init_dit_params(dit_cfg, "cpu", torch.float32, seed=3)
    vae = convert.init_vae_params(vae_cfg, "cpu", torch.float32, seed=4)
    g = torch.Generator("cpu").manual_seed(5)
    ctx, nctx = torch.randn(1, 40, 64, generator=g), torch.randn(1, 40, 64, generator=g)
    # 512x512x17 -> 5 x 16 x 16 = 1280 tokens: s_pad 2048, so K3 runs too
    kw = dict(input_image=seeded_image(6, 512, 512), seed=7, height=512, width=512, num_frames=17,
              cfg_scale=5.0, num_inference_steps=4, output_type="latents",
              torch_compat_noise=True)  # the same CPU-drawn noise on both sides

    cpu = WanVideoPipeline(dit, dit_cfg, vae, vae_cfg, dtype=torch.float32, device="cpu")
    ref = cpu(context=ctx, negative_context=nctx, **kw)
    cpu16 = WanVideoPipeline(to(dit, "cpu", torch.bfloat16), dit_cfg,
                             to(vae, "cpu", torch.bfloat16), vae_cfg, dtype=torch.bfloat16,
                             device="cpu")
    rel16 = ((cpu16(context=ctx, negative_context=nctx, **kw).float() - ref).norm()
             / ref.norm()).item()
    before = dict(_kernels.launches)
    gpu = WanVideoPipeline(to(dit, "cuda", torch.bfloat16), dit_cfg,
                           to(vae, "cuda", torch.bfloat16), vae_cfg, dtype=torch.bfloat16,
                           device="cuda")
    out = gpu(context=ctx, negative_context=nctx, **kw).float().cpu()
    ran = {k: _kernels.launches[k] - before[k] for k in before}
    rel = ((out - ref).norm() / ref.norm()).item()
    tol = 2 * rel16 + 1e-3
    print(f"  tiny pipeline latents {tuple(out.shape)}: relative L2 error to CPU fp32 "
          f"{rel:.4e} (card bf16), {rel16:.4e} (CPU bf16); tolerance {tol:.4e}; "
          f"kernel launches {ran}", flush=True)
    if not all(ran.values()):
        raise RuntimeError(f"a kernel did not run in the tiny pipeline: {ran}")
    if not rel <= tol:
        raise RuntimeError(f"tiny pipeline disagrees with the CPU reference: {rel:.4e}")


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
