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
                Then K5 and K6a-c at the training shapes (self S=8190,
                cross q 8190 x k 512), PyTorch's flash attention forward and
                backward as their yardstick, and a flash_attention gradient
                check against autograd of the plain attention.
  4. weights  — full-width Wan2.2-TI2V-5B DiT, UMT5-XXL and VAE38, made on
                the card in bf16 from a seeded CUDA generator.
  5. requests — WanVideoPipeline answers two 480x832x17-frame, 4-step,
                CFG 5 text+image-to-video requests; launch counts of K1-K4
                are checked exactly (per DiT sweep: 90, 90, 30, 30).
  6. train    — two-stage LoRA training of the full-width DiT at
                480x832x81 frames (S=8190): three stage-1 steps, the adapter
                through safetensors, one stage-2 step, merge + fuse, one
                request; launch counts checked exactly per step (per step:
                K1 180, K2 180, K3 60, K4 60, K6a/b/c 60 each, K5 0).
  7. breakdown — each stage of a request alone, and one DiT sweep under
                torch.profiler (device time by kernel, busy share).
  8. reference — a tiny-width pipeline on the card (kernels, bf16) against
                the same pipeline on the CPU (plain versions, fp32), and one
                tiny LoRA training step likewise.
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


def train_kernel_checks():
    """K5, K6a, K6b, K6c against their plain versions on the card in bf16 at
    the training path's two shapes: self-attention (B*N = 24, S = 8190
    padded to 8192, the last two keys masked) and text cross-attention
    (q 8190, k/v 512, no mask).  Bounds count 4 (K5, K6a), 6 (K6b) and 8
    (K6c) x BN x Sq x Sk x 128 flops on the unpadded lengths, and each input
    read and output written once.  The library yardstick is PyTorch's flash
    attention: its forward (which also returns the LSE) for K5/K6a, its
    backward for K6b and K6c together.  Then a small gradient check of
    flash_attention against fp32 autograd of the plain attention."""
    import torch

    from fairygen_tpu_torch.ops import flash_attention as fa
    from fairygen_tpu_torch.ops.attention import xla_attention

    dev, bf = "cuda", torch.bfloat16
    g = torch.Generator(dev).manual_seed(4321)
    N, hd, S, lk = 24, 128, 8190, 512
    ln2 = 0.6931471805599453
    res = {}

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=g, device=dev) * scale).to(bf)

    def normed(x):
        xf = x.float()
        return (xf * torch.rsqrt(xf.pow(2).mean(-1, keepdim=True) + 1e-6)).to(bf)

    for tag, sk, kv_len in (("self", S, None), ("cross", lk, None)):
        q = (normed(randn(1, S, N, hd)).float() * (hd ** -0.5 * 1.4426950408889634)).to(bf)
        k, v = normed(randn(1, sk, N, hd)), randn(1, sk, N, hd)
        do = randn(1, S, N, hd, scale=0.05)
        bq, bk = fa._tiles(S, sk)
        qh = fa._heads_major(q, fa._pad_len(S, bq, True))
        kh, vh = (fa._heads_major(t, fa._pad_len(sk, bk, True)) for t in (k, v))
        doh = fa._heads_major(do, qh.shape[1])
        ska = sk if kv_len is None else kv_len
        print(f"  {tag}: q {tuple(qh.shape)} k/v {tuple(kh.shape)} sk_actual {ska}", flush=True)
        o, lse = fa.flash_fwd(qh, kh, vh, sk_actual=ska)
        o_ref, lse_ref = fa.flash_fwd_plain(qh, kh, vh, sk_actual=ska)
        # p is rounded to bf16 against its key tile's running max (see
        # tests/test_torch_cuda.py): 2^-7 relative + 2^-8 absolute
        e_fwd = check_close(f"K6a flash_fwd_lse o {tag}", o, o_ref, rtol=2 ** -7, atol=2 ** -8)
        check_close(f"K6a flash_fwd_lse lse {tag}", lse, lse_ref, rtol=1e-5, atol=1e-4)
        o5 = fa.flash_fwd(qh, kh, vh, sk_actual=ska, with_lse=False)
        e5 = check_close(f"K5 flash_fwd {tag}", o5, o_ref, rtol=2 ** -7, atol=2 ** -8)
        delta = (doh.float() * o_ref.float()).sum(-1)
        f = 1 / 1.4426950408889634
        dq = fa.flash_bwd_dq(qh, kh, vh, doh, lse_ref, delta, sk_actual=ska, dq_factor=f)
        dq_ref = fa.flash_bwd_dq_plain(qh, kh, vh, doh, lse_ref, delta, sk_actual=ska,
                                       dq_factor=f)
        # P and dS are rounded to bf16 on both sides at values that differ
        # in the last fp32 bits: 2^-7 relative + 1e-2 of the largest |grad|
        e_dq = check_close(f"K6b flash_bwd_dq {tag}", dq, dq_ref, rtol=2 ** -7,
                           atol=1e-2 * dq_ref.float().abs().max().item())
        dk, dv = fa.flash_bwd_dkv(qh, kh, vh, doh, lse_ref, delta, sq=S, sk_actual=ska)
        dk_ref, dv_ref = fa.flash_bwd_dkv_plain(qh, kh, vh, doh, lse_ref, delta, sq=S,
                                                sk_actual=ska)
        e_dkv = max(check_close(f"K6c flash_bwd_dkv dk {tag}", dk, dk_ref, rtol=2 ** -7,
                                atol=1e-2 * dk_ref.float().abs().max().item()),
                    check_close(f"K6c flash_bwd_dkv dv {tag}", dv, dv_ref, rtol=2 ** -7,
                                atol=1e-2 * dv_ref.float().abs().max().item()))
        del o_ref, dq_ref, dk_ref, dv_ref

        qs, ks, vs = (t.permute(0, 2, 1, 3).contiguous() for t in (q, k, v))
        sdpa = torch.ops.aten._scaled_dot_product_flash_attention
        fw = sdpa(qs, ks, vs, 0.0, False, False, scale=ln2)
        dos = do.permute(0, 2, 1, 3).contiguous()

        def sdpa_bwd():
            return torch.ops.aten._scaled_dot_product_flash_attention_backward(
                dos, qs, ks, vs, fw[0], fw[1], fw[2], fw[3], fw[4], fw[5], 0.0, False,
                fw[6], fw[7], scale=ln2)

        lib_fwd = time_ms(lambda: sdpa(qs, ks, vs, 0.0, False, False, scale=ln2))
        lib_bwd = time_ms(sdpa_bwd, 10, 5)
        work = N * S * ska * hd
        rows = N * S
        nb = {"flash_fwd": (2 * rows + 2 * N * ska) * hd * 2,
              "flash_fwd_lse": (2 * rows + 2 * N * ska) * hd * 2 + rows * 4,
              "flash_bwd_dq": (3 * rows + 2 * N * ska) * hd * 2 + 2 * rows * 4,
              "flash_bwd_dkv": (2 * rows + 4 * N * ska) * hd * 2 + 2 * rows * 4}
        calls = {
            "flash_fwd": (e5, 4, lambda: fa.flash_fwd(qh, kh, vh, sk_actual=ska, with_lse=False),
                          lambda: fa.flash_fwd_plain(qh, kh, vh, sk_actual=ska, with_lse=False),
                          lib_fwd),
            "flash_fwd_lse": (e_fwd, 4, lambda: fa.flash_fwd(qh, kh, vh, sk_actual=ska),
                              lambda: fa.flash_fwd_plain(qh, kh, vh, sk_actual=ska), lib_fwd),
            "flash_bwd_dq": (e_dq, 6, lambda: fa.flash_bwd_dq(qh, kh, vh, doh, lse, delta,
                                                              sk_actual=ska, dq_factor=f),
                             lambda: fa.flash_bwd_dq_plain(qh, kh, vh, doh, lse, delta,
                                                           sk_actual=ska, dq_factor=f),
                             lib_bwd),
            "flash_bwd_dkv": (e_dkv, 8, lambda: fa.flash_bwd_dkv(qh, kh, vh, doh, lse, delta,
                                                                 sq=S, sk_actual=ska),
                              lambda: fa.flash_bwd_dkv_plain(qh, kh, vh, doh, lse, delta,
                                                             sq=S, sk_actual=ska),
                              lib_bwd),
        }
        for name, (err, flop_mult, kern, plain, lib) in calls.items():
            r = dict(max_abs_err=err, ms=time_ms(kern, 10, 5), plain_ms=time_ms(plain, 1, 3),
                     bound=bound_ms(nb[name], flop_mult * work), library_ms=lib)
            res.setdefault(name, {})[tag] = r
            print(f"  {tag} {name}: ms {r['ms']:.4f} plain_ms {r['plain_ms']:.4f} "
                  f"bound_ms {r['bound'][0]:.4f} ({r['bound'][1]}) library_ms {lib:.4f}"
                  f"{' (dq+dkv together)' if name.startswith('flash_bwd') else ''}", flush=True)
        del qh, kh, vh, doh, o, lse, dq, dk, dv, fw
        torch.cuda.empty_cache()

    # flash_attention's gradient (K6a, K6b, K6c) against fp32 autograd of
    # the plain attention on the same bf16 values: relative L2 below 1e-2
    q = randn(1, 1000, 2, hd, scale=hd ** -0.5 * 1.4427).requires_grad_(True)
    k, v = randn(1, 1000, 2, hd).requires_grad_(True), randn(1, 1000, 2, hd).requires_grad_(True)
    w = randn(1, 1000, 2, hd).float()
    out = fa.flash_attention(q, k, v, prescaled=True, kv_len=900)
    grads = torch.autograd.grad((out.float() * w).sum(), (q, k, v))
    ref_in = [t.detach().float().requires_grad_(True) for t in (q, k, v)]
    ref = xla_attention(*ref_in, prescaled=True, kv_len=900)
    ref_grads = torch.autograd.grad((ref * w).sum(), ref_in)
    rels = [((a.float() - b).norm() / b.norm()).item() for a, b in zip(grads, ref_grads)]
    print(f"  flash_attention gradient vs fp32 autograd of the plain attention "
          f"(S=1000, kv_len 900): relative L2 dq {rels[0]:.3e} dk {rels[1]:.3e} "
          f"dv {rels[2]:.3e} (bound 1e-2)", flush=True)
    if not max(rels) < 1e-2:
        raise RuntimeError(f"flash_attention gradient disagrees: {rels}")
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
    train_k = train_kernel_checks()
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
        expected = {k: 2 * per_request.get(k, 0) for k in _kernels.launches}
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

        t0 = phase("train")
        trained = train_phase(pipe, per_request)
        launches = {k: launches[k] + trained[k] for k in launches}
        print(f"  launches, serving and training: {launches}", flush=True)
        done("train", t0)

        t0 = phase("breakdown")
        breakdown(pipe, te_cfg)
        del pipe, dit, te, vae, video
        torch.cuda.empty_cache()
        done("breakdown", t0)

        t0 = phase("reference")
        reference_check()
        reference_train_check()
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
    train_sources = {"flash_fwd": "fairygen_tpu/ops/flash_attention.py:35",
                     "flash_fwd_lse": "fairygen_tpu/ops/flash_attention.py:253",
                     "flash_bwd_dq": "fairygen_tpu/ops/flash_attention.py:295",
                     "flash_bwd_dkv": "fairygen_tpu/ops/flash_attention.py:329"}
    for k, replaces in train_sources.items():
        r, c = train_k[k]["self"], train_k[k]["cross"]
        rows.append({
            "name": k, "route": "cuda",
            "source": "fairygen_tpu_torch/csrc/flash_attention_train.cu", "replaces": replaces,
            "launches": None if expected is None else launches[k],
            "max_abs_err": max(r["max_abs_err"], c["max_abs_err"]), "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound"][0], "bound_by": r["bound"][1],
            "library_ms": r["library_ms"], "cross_ms": c["ms"], "cross_plain_ms": c["plain_ms"],
            "cross_bound_ms": c["bound"][0], "cross_library_ms": c["library_ms"]})
    timer.cancel()
    print(smi)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": count}}))
    return 0


TRAIN_PER_STEP = {"ln_modulate": 180, "rms_rope_heads_major": 180, "flash_bounded": 60,
                  "flash_small_kv": 60, "flash_fwd": 0, "flash_fwd_lse": 60,
                  "flash_bwd_dq": 60, "flash_bwd_dkv": 60}


def train_phase(pipe, serving_per_request):
    """Two-stage LoRA training of the full-width DiT on the card, as
    stage1_id.sh: r = alpha = 32 on q, k, v, o (self and cross) and ffn.0,
    ffn.2, AdamW lr 1e-4 wd 0.01, remat, batch 1, 480x832x81 frames
    (latents (1, 48, 21, 30, 52), S = 8190) from a seeded generator, the
    context from the port's UMT5 on a seeded 512-token prompt, the first
    latent frame clean.  Three stage-1 steps (dropout 0.8 on B), the
    adapter through safetensors into a stage-2 model, one stage-2 step (B2
    only, dropout 0.5), then merge, fuse and one 4-step request.  Launch
    counts are checked exactly per step; the third stage-1 step runs under
    torch.profiler.  Returns the phase's launches."""
    import contextlib
    import tempfile

    import torch

    from fairygen_tpu_torch.core.io import load_safetensors, save_safetensors
    from fairygen_tpu_torch.models.adapters import (
        add_lora_to_wan_dit, fuse_lora_into_wan_dit, leaves_with_path, lora_trainable_filter,
        merge_stage_weights, set_lora_weights)
    from fairygen_tpu_torch.ops import _kernels
    from fairygen_tpu_torch.pipelines.wan_video import WanVideoPipeline
    from fairygen_tpu_torch.training.optimizers import make_optimizer
    from fairygen_tpu_torch.training.runner import wan_lora_state_dict
    from fairygen_tpu_torch.training.train_step import make_wan_sft_train_step

    dit, cfg = pipe.dit_params, pipe.dit_cfg
    total = {k: 0 for k in _kernels.launches}
    g = torch.Generator("cuda").manual_seed(2024)
    ids, mask, _, _ = seeded_prompt(21, pipe.te_cfg.vocab)
    context = pipe.encode_ids(ids, mask)
    latents = torch.randn((1, 48, 21, 30, 52), generator=g, device="cuda").to(torch.bfloat16)
    batch = {"latents": latents, "context": context}

    def lora_of(params, leaf):
        return {p: t for p, t in leaves_with_path(params) if "lora" in p and p[-1] == leaf}

    def run_step(step, state, label, profile=False):
        _kernels.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) if profile else contextlib.nullcontext() \
                as prof:
            t1 = time.perf_counter()
            state, loss = step(state, batch, g)
            loss = float(loss)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t1
        if profile:
            device_table(prof, dt, f"{label} under torch.profiler", 16)
        got = dict(_kernels.launches)
        print(f"  {label}: {dt:.3f} s, loss {loss:.6f}, max_memory_allocated "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, launches {got}", flush=True)
        if not torch.isfinite(torch.tensor(loss)):
            raise RuntimeError(f"{label}: loss is not finite")
        if got != TRAIN_PER_STEP:
            raise RuntimeError(f"{label}: launch counts {got} != expected {TRAIN_PER_STEP}")
        for k, v in got.items():
            total[k] += v
        return state

    # stage 1
    stage1 = add_lora_to_wan_dit(dit, g, rank=32, alpha=32)
    # the copies the checks compare with wait on the host, so that the
    # steps' max_memory_allocated holds the model and the step alone
    base = {p: t.cpu() for p, t in leaves_with_path(dit)}
    init, step = make_wan_sft_train_step(
        cfg, make_optimizer("adamw", 1e-4, 0.01), remat=True, first_frame_clean=True,
        trainable_filter=lora_trainable_filter(("A", "B")), lora_b_dropout=("B", 0.8))
    state = init(stage1)
    n_lora = sum(t.numel() for t in state.trainable)
    print(f"  stage-1 adapters: {len(state.trainable)} tensors, {n_lora:,} fp32 parameters",
          flush=True)
    if n_lora != 80_609_280:
        raise RuntimeError(f"stage-1 LoRA has {n_lora} parameters, expected 80,609,280")
    a0 = {p: t.cpu() for p, t in lora_of(stage1, "A").items()}
    state = run_step(step, state, "stage-1 step 1")
    # B = 0, so A's gradient is exactly 0 and A moves by the weight decay alone
    def decayed(a):
        a = a.cuda()
        return a - 1e-4 * (0.01 * a)

    a1 = {p: t.cpu() for p, t in lora_of(stage1, "A").items()}
    if not all(torch.equal(t, decayed(a0[p])) for p, t in lora_of(stage1, "A").items()):
        raise RuntimeError("an A moved by more than the weight decay in step 1")
    if not any(t.abs().sum().item() > 0 for t in lora_of(stage1, "B").values()):
        raise RuntimeError("no B moved in stage-1 step 1")
    state = run_step(step, state, "stage-1 step 2")
    if all(torch.equal(t, decayed(a1[p])) for p, t in lora_of(stage1, "A").items()):
        raise RuntimeError("no A moved by its gradient in stage-1 step 2")
    state = run_step(step, state, "stage-1 step 3", profile=True)
    changed = [p for p, t in leaves_with_path(dit) if not torch.equal(t.cpu(), base[p])]
    if changed:
        raise RuntimeError(f"base weights changed in stage 1: {changed[:5]}")
    print("  stage 1: base weights bit for bit unchanged; B moved in step 1, A in step 2",
          flush=True)
    del base, a0, a1

    # the stage-1 adapter through safetensors into a stage-2 model
    with tempfile.TemporaryDirectory(dir=os.path.join(HERE, "build")) as tmp:
        path = os.path.join(tmp, "stage1.safetensors")
        save_safetensors(path, wan_lora_state_dict(stage1))
        del state, stage1, step
        torch.cuda.empty_cache()
        sd1 = load_safetensors(path)
        print(f"  stage-1 adapter: {os.path.getsize(path) / 2**20:.1f} MiB, "
              f"{len(sd1)} tensors", flush=True)
    stage2 = add_lora_to_wan_dit(dit, g, rank=32, alpha=32, with_b2=True)
    if set_lora_weights(stage2, sd1) != 300:
        raise RuntimeError("stage-1 adapter did not fill the 300 stage-2 slots")
    init, step = make_wan_sft_train_step(
        cfg, make_optimizer("adamw", 1e-4, 0.01), remat=True, first_frame_clean=True,
        trainable_filter=lora_trainable_filter(("B2",)), lora_b_dropout=("B2", 0.5))
    state = init(stage2)
    ab = {p: t.cpu() for p, t in leaves_with_path(stage2)
          if "lora" in p and p[-1] in ("A", "B")}
    state = run_step(step, state, "stage-2 step 1")
    if not all(torch.equal(t.cpu(), ab[p]) for p, t in leaves_with_path(stage2) if p in ab):
        raise RuntimeError("stage 2 moved A or B")
    if not any(t.abs().sum().item() > 0 for t in lora_of(stage2, "B2").values()):
        raise RuntimeError("no B2 moved in stage 2")
    print("  stage 2: A and B unchanged, B2 moved", flush=True)
    sd2 = wan_lora_state_dict(stage2)
    del state, stage2, step, ab
    torch.cuda.empty_cache()

    # merge B = B1 + B2, fuse into the base weights, one request
    merged = merge_stage_weights(sd1, sd2)
    fused, n = fuse_lora_into_wan_dit(dit, merged, cfg)
    if n != 300:
        raise RuntimeError(f"fused {n} layers, expected 300")
    pipe2 = WanVideoPipeline(fused, cfg, pipe.vae_params, pipe.vae_cfg, pipe.te_params,
                             pipe.te_cfg, torch.bfloat16, "cuda")
    ids, mask, nids, nmask = seeded_prompt(22, pipe.te_cfg.vocab)
    _kernels.reset_launches()
    t1 = time.perf_counter()
    video = pipe2(context=pipe2.encode_ids(ids, mask),
                  negative_context=pipe2.encode_ids(nids, nmask),
                  input_image=seeded_image(22, 480, 832), seed=22, height=480, width=832,
                  num_frames=17, cfg_scale=5.0, num_inference_steps=4,
                  output_type="floatpoint")
    torch.cuda.synchronize()
    dt = time.perf_counter() - t1
    got = dict(_kernels.launches)
    want = {k: serving_per_request.get(k, 0) for k in got}
    finite = bool(torch.isfinite(video).all())
    print(f"  merged+fused adapter request: {dt:.3f} s, output {tuple(video.shape)}, all "
          f"finite: {finite}, launches {got}", flush=True)
    if tuple(video.shape) != (1, 3, 17, 480, 832) or not finite:
        raise RuntimeError("merged request output has the wrong shape or non-finite values")
    if got != want:
        raise RuntimeError(f"merged request launch counts {got} != expected {want}")
    for k, v in got.items():
        total[k] += v
    del pipe2, fused, video
    torch.cuda.empty_cache()
    return total


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
    device_table(prof, wall, "profiled DiT sweep", 14)


def device_table(prof, wall, label, top):
    """Device time by kernel name from a torch.profiler run, the device's
    busy share of ``wall`` seconds, and the ``top`` busiest kernels."""
    import torch

    rows = []  # device-side events only: the kernels themselves
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            rows.append((e.self_device_time_total, e.count, e.key))
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows) / 1e6
    print(f"  {label}: wall {wall * 1e3:.2f} ms, device busy {busy * 1e3:.2f} ms "
          f"({100 * busy / wall:.1f}% busy)")
    for dev_us, count, key in rows[:top]:
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
    serving = ("ln_modulate", "rms_rope_heads_major", "flash_bounded", "flash_small_kv")
    if not all(ran[k] for k in serving):
        raise RuntimeError(f"a kernel did not run in the tiny pipeline: {ran}")
    if not rel <= tol:
        raise RuntimeError(f"tiny pipeline disagrees with the CPU reference: {rel:.4e}")


def reference_train_check():
    """One LoRA training step of a tiny head-dim-128 DiT on the card
    (kernels, bf16 base weights, fp32 adapters) against the same step on
    the CPU (plain versions), from the same weights, inputs and draws
    (timestep index and noise given; dropout off).  Three CPU runs:

    * fp32 through the train step;
    * bf16 through the train step, which rounds where the card rounds;
    * fp32 of the function the bf16 steps compute: a bf16 step rounds the
      timestep (and sigma) to bf16 before the time embedding, as
      ``timestep.to(latents.dtype)`` does in the JAX package too, and
      759.42 -> 760 moves every sinusoid of that embedding and with it the
      LoRA gradients by ~20% (the loss by ~0.3%); this run gets the rounded
      timestep, so that its distance to the bf16 run is the bf16
      arithmetic alone.

    Checks: the loss and all LoRA gradients against the fp32 step, at most
    twice the CPU bf16 step's error + 1e-3; and, layer by layer (the A and
    B gradients of self q/k/v/o, cross q/k/v/o, ffn.0, ffn.2 apart), the
    card's gradients against the rounded-timestep fp32 run and against the
    CPU bf16 run, each at most twice the CPU bf16 run's own error to the
    rounded-timestep fp32 run + 1e-3.  A wrong dq, dk or dv of K6b/K6c moves
    its layers' gradients by far more than that."""
    import numpy as np
    import torch

    from fairygen_tpu_torch import convert
    from fairygen_tpu_torch.diffusion.flow_match import FlowMatchScheduler
    from fairygen_tpu_torch.models.adapters import (add_lora_to_wan_dit, leaves_with_path,
                                                    lora_trainable_filter, map_with_path)
    from fairygen_tpu_torch.models.wan.dit import WanDiTConfig, wan_dit_forward
    from fairygen_tpu_torch.ops import _kernels
    from fairygen_tpu_torch.training.losses import flow_match_sft_loss
    from fairygen_tpu_torch.training.optimizers import make_optimizer
    from fairygen_tpu_torch.training.train_step import make_wan_sft_train_step

    cfg = WanDiTConfig(dim=256, in_dim=4, ffn_dim=512, out_dim=4, text_dim=64, freq_dim=64,
                       num_heads=2, num_layers=2, seperated_timestep=True,
                       require_vae_embedding=False, require_clip_embedding=False,
                       fuse_vae_embedding_in_latents=True)
    g = torch.Generator("cpu").manual_seed(8)
    params = add_lora_to_wan_dit(convert.init_dit_params(cfg, "cpu", torch.float32, seed=9), g,
                                 rank=8)
    for blk in params["blocks"]:
        for sub in ("self_attn", "cross_attn", "ffn"):
            for layer in blk[sub].values():
                if isinstance(layer, dict) and "lora" in layer:
                    layer["lora"]["B"].normal_(generator=g).mul_(0.05)
    # 5 x 16 x 16 = 1280 tokens: s_pad 2048, so K3 runs and K6 masks a tile
    lat = torch.randn(1, 4, 5, 32, 32, generator=g)
    ctx = torch.randn(1, 40, 64, generator=g)
    noise = torch.randn(lat.shape, generator=g)
    index = 613

    def place(dev, dt):
        def leaf(path, t):
            if not isinstance(t, torch.Tensor):
                return t
            return t.to(dev, torch.float32 if "lora" in path else dt).detach().clone()
        return map_with_path(leaf, params)

    def run(dev, dt):
        init, step = make_wan_sft_train_step(cfg, make_optimizer("adamw", 1e-4, 0.01),
                                             remat=True,
                                             trainable_filter=lora_trainable_filter(("A", "B")),
                                             device=dev)
        batch = {"latents": lat.to(dev, dt), "context": ctx.to(dev, dt)}
        loss, grads = step.loss_and_grads(init(place(dev, dt)), batch, index=index,
                                          noise=noise.to(dev, dt))
        return float(loss), {k: v.float().cpu() for k, v in grads.items()}

    def run_fp32_rounded_t():
        sched = FlowMatchScheduler("Wan").set_timesteps(1000, training=True, shift=5.0)
        r16 = lambda a: torch.from_numpy(np.asarray(a, np.float32)).bfloat16().float().numpy()  # noqa: E731
        p = place("cpu", torch.float32)
        leaves = [(q, t.requires_grad_()) for q, t in leaves_with_path(p)
                  if "lora" in q and q[-1] in ("A", "B")]
        loss = flow_match_sft_loss(
            lambda pp, x, t, c: wan_dit_forward(pp, cfg, x, t, c, remat=True,
                                                fuse_vae_embedding_in_latents=True),
            p, lat, ctx, sigmas=r16(sched.sigmas), timesteps=r16(sched.timesteps),
            weights=sched.linear_timesteps_weights, first_frame_clean=True, index=index,
            noise=noise)
        grads = torch.autograd.grad(loss, [t for _, t in leaves])
        return float(loss), {q: v for (q, _), v in zip(leaves, grads)}

    loss32, g32 = run("cpu", torch.float32)
    loss16, g16 = run("cpu", torch.bfloat16)
    loss32t, g32t = run_fp32_rounded_t()
    _kernels.reset_launches()
    loss_c, g_c = run("cuda", torch.bfloat16)
    ran = dict(_kernels.launches)

    def rel(a, b, keys=None):
        keys = sorted(b, key=str) if keys is None else keys
        a = torch.cat([a[k].double().ravel() for k in keys])
        b = torch.cat([b[k].double().ravel() for k in keys])
        return float((a - b).norm() / b.norm())

    e_loss, e_loss16 = abs(loss_c - loss32) / abs(loss32), abs(loss16 - loss32) / abs(loss32)
    e_g, e_g16 = rel(g_c, g32), rel(g16, g32)
    print(f"  tiny LoRA step (S=1280): loss relative error to CPU fp32 {e_loss:.4e} (card "
          f"bf16), {e_loss16:.4e} (CPU bf16); all LoRA gradients relative L2 {e_g:.4e} "
          f"(card), {e_g16:.4e} (CPU bf16); kernel launches {ran}", flush=True)
    print(f"  losses: CPU fp32 {loss32:.6f}, CPU fp32 at the bf16-rounded timestep "
          f"{loss32t:.6f}, CPU bf16 {loss16:.6f}, card bf16 {loss_c:.6f}; all LoRA gradients "
          f"relative L2 to the rounded-timestep fp32 run {rel(g_c, g32t):.4e} (card), "
          f"{rel(g16, g32t):.4e} (CPU bf16), {rel(g32, g32t):.4e} (CPU fp32)", flush=True)
    for k in ("flash_fwd_lse", "flash_bwd_dq", "flash_bwd_dkv"):
        if ran[k] != 2 * cfg.num_layers:
            raise RuntimeError(f"{k} ran {ran[k]} times in the tiny step")
    bad = []
    if not (e_loss <= 2 * e_loss16 + 1e-3 and e_g <= 2 * e_g16 + 1e-3):
        bad.append("loss or gradients against the CPU fp32 step")
    layers = {}
    for k in g32t:
        layers.setdefault(f"{k[2]}.{k[3]}", []).append(k)
    print("  LoRA gradients by layer, relative L2: card to rounded-t fp32 | card to CPU bf16 "
          "| CPU bf16 to rounded-t fp32 | limit", flush=True)
    for name, keys in sorted(layers.items()):
        ref16 = rel(g16, g32t, keys)
        tol = 2 * ref16 + 1e-3
        e_t, e_16 = rel(g_c, g32t, keys), rel(g_c, g16, keys)
        print(f"    {name:16s} {e_t:.4e} | {e_16:.4e} | {ref16:.4e} | {tol:.4e}", flush=True)
        if not (e_t <= tol and e_16 <= tol):
            bad.append(name)
    if bad:
        raise RuntimeError(f"tiny LoRA step disagrees with the CPU reference: {bad}")


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
