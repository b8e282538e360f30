#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (fairygen_tpu_torch) once on one NVIDIA card.

    python3 chip_smoke.py                 # the whole run, one card
    python3 chip_smoke.py --kernels-only  # device, build and kernel checks only
    python3 chip_smoke.py --ab-lib PATH   # also K4 against another build's library

Phases, each printing its wall seconds:
  1. device   — card name/count, nvidia-smi name and power limit, TF32 off.
  2. build    — one nvcc -c per source, all at once, and one link
                (ptxas -v output printed once); the registers, shared
                memory and spills of the TMA + wgmma kernels (K3, K4
                bounded, K4 max/masked and K5 at head dims 64 and 128,
                K6a, K10, K6b, K6c, each form), and
                their HGMMA (wgmma) and UTMALDG (TMA load) counts from
                cuobjdump's SASS of their own object files (a spill, a
                count of 0 or wgmma that ptxas serialized, C7511 / C7512
                / C7520, fails the run); beside them nvcc builds a copy of
                csrc/flash_attention_online.cu in which no kernel has the
                consumers take turns.
  3. kernels  — K1-K4 against their plain PyTorch versions on the card in
                bf16 at the main path's shapes (480x832, 17 frames: S=1950)
                and the flagship's (81 frames: S=8190); error, kernel ms,
                plain ms, the bound (K1, K2 also by device time), and
                scaled_dot_product_attention as a yardstick for K3/K4 (timed
                here only; the port never calls it);
                K3 also at the FLUX.1-dev joint shape (24 heads, 4608 tokens in
                5120 rows) and the Z-Image unified one (30 heads, 4416 in
                5120), K4 at Z-Image's caption refiner (30 heads, 320 tokens
                in 1024), SDPA at the real lengths beside them.
                Then K5 and K6a-c at the training shapes (self S=8190,
                cross q 8190 x k 512), PyTorch's flash attention forward
                (and cuDNN's, with its log-sum-exp) and backward as their
                yardstick, K5's output bit for bit K6a's, K6a's relative
                L2 error within 2^-8, K6a, K6b and K6c run twice at the
                self shape (bit for bit the same), and a flash_attention
                gradient check against autograd of the plain attention;
                then K5, K6a and K4 with and without the turns, timed in
                alternation (the same bits required).
                Then K7, K8 and K10 at the FLUX.1-dev 1024x1024 shapes
                (4608 tokens; 5632 with two EliGen entities).  Then K9 at
                the Z-Image-Turbo 1024x1024 shapes (4416, 4096 and 320 rows
                of 3840, with and without scale) and K11 at two VAE38
                shapes (399,360 x 256 and 7800 x 1024, with and without
                SiLU), F.rms_norm as their yardstick, and K7, K8 and K9's
                device time (torch.profiler) beside their event times.
                Then K4's max and
                masked forms and K5 at head dim 64 at the SDXL 1024x1024
                CFG shapes (cross-attention to 77 text keys, 1024- and
                4096-token self-attention), K4 at head dim 128, with a
                kv_len over non-zero keys and at 192 keys, K4's o within a
                relative L2 error of 2^-10, SDPA as their yardstick, device
                times beside the CUDA-event times; with --ab-lib, K4 of
                another build of the library beside this one's.
  4. weights  — full-width Wan2.2-TI2V-5B DiT, UMT5-XXL and VAE38, made on
                the card in bf16 from a seeded CUDA generator.
  5. requests — WanVideoPipeline answers two 480x832x17-frame, 4-step,
                CFG 5 text+image-to-video requests; launch counts of K1-K4
                are checked exactly (per DiT sweep: 90, 90, 30, 30), and of
                K11 (the VAE38's norm + SiLU: 21 in the first-frame encode,
                29 in the decode).
  5b. flagship — the flagship request as examples/wan_inference.py makes
                it: 480x832, 81 frames, 50 steps, CFG 5, the streamed
                VAE38 decode (S = 8190): its wall time, the wall of the
                100 DiT sweeps, peak device memory, exact launch counts
                (K1 9000, K2 9000, K3 3000, K4 3000, K11 21 + 21 x 29,
                every other kernel 0)
                and finite output of 81 480x832 frames; then K11 against
                its plain version at every (rows, C) the request gave it
                (recorded during the request), with its device time at
                each and the sum over the 630 calls; then on its latents
                the streamed decode alone (wall, peak memory, device busy
                share of one profiled chunk), the one-tile tiled decode
                (bit for bit the streamed one), the decode with its
                channel RMS norm + SiLU through K11 (channels-last out)
                beside the plain chain and K11 transposed back (in turns,
                twice; each within a relative L2 error of 2^-5 of the
                port's decode),
                one profiled DiT sweep at S = 8190, and the requests
                phase's 17-frame latents decoded streamed against
                full-sequence (max abs error, and relative L2 error over
                the clip and in its worst frame).
  6. train    — two-stage LoRA training of the full-width DiT at
                480x832x81 frames (S=8190): three stage-1 steps, the adapter
                through safetensors, one stage-2 step, merge + fuse, one
                request; launch counts checked exactly per step (per step:
                K1 180, K2 180, K3 60, K4 60, K6a/b/c 60 each, K5 0).
  6b. train_surface — the training surface as the wan_train CLI twin runs
                it, at the same width: data_process of a seeded 81-frame
                clip (frames in memory; the streamed VAE38 encode, K11 21
                x 21 launches; UMT5), two stage-1 and two stage-2 steps
                from the .npz cache through UnifiedDataset and
                launch_training_task, the merge_weights twin and a
                request with the merged adapter, a resumed run bit for
                bit the straight one, one direct-distill step (4 sweeps
                with gradients) and one trajectory step (50 teacher
                sweeps at 17 frames), one step each with AdamW, Adafactor
                and remat="offload" (which must lower the peak by at
                least half its carries); walls, peaks, exact launches.
  7. breakdown — each stage of a request alone, and one DiT sweep under
                torch.profiler (device time by kernel, busy share).
  8. flux     — FLUX.1-dev at full width and depth (DiT 19 + 38 blocks,
                T5 v1.1 XXL, CLIP-L, the FLUX VAE) from seeded bf16 weights:
                two 1024x1024 4-step requests and one EliGen request with
                exact launch counts of K1, K7, K8, K3 and K10, and one
                profiled sweep without regions and one with them.
  9. zimage   — Z-Image-Turbo at full width and depth (DiT 2 + 2 + 30
                blocks, dim 3840; Qwen3-4B; the FLUX VAE) from seeded bf16
                weights: a 300-id prompt through encode_ids, two 1024x1024
                8-step requests and one image-to-image CFG request with
                exact launch counts of K9, K7, K3 and K4, and one profiled
                sweep.
 10. sdxl     — SDXL + BrushNet stylization at full width and depth (UNet,
                BrushNet-SDXL, CLIP-L, OpenCLIP bigG, the SDXL VAE in fp32)
                from seeded bf16 weights with a rank-32 Style DoRA loaded at
                lora_scale 0.66: two 1024x1024, 50-step, CFG 7.5, BrushNet
                0.7 requests on a seeded masked image with exact launch
                counts (per step: K5 at head dim 64 10, K4 max form 61, K4
                masked form 70), and one BrushNet + UNet step profiled.
 11. reference — a tiny-width pipeline on the card (kernels, bf16) against
                the same pipeline on the CPU (plain versions, fp32), a tiny
                pipeline loaded by from_pretrained(hints=...) from
                safetensors written in a temporary directory, with a hot
                LoRA loaded and then cleared, likewise, one
                tiny LoRA training step likewise, a tiny head-dim-128
                FLUX.1 DiT with and without EliGen likewise, a tiny
                head-dim-128 Z-Image DiT and a tiny Qwen3 encoder likewise,
                and a tiny head-dim-64 SDXL + BrushNet + DoRA pipeline
                likewise.
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
H100_FP32_FLOP_PER_S = 67e12   # fp32 outside the tensor cores, same source


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


def device_ms(fn, calls=50):
    """ms of device time per call: the kernels of ``calls`` calls summed by
    torch.profiler, after one warm-up.  Unlike time_ms it leaves out the
    host's time between launches, which outlasts a kernel of a few
    microseconds called through its Python wrapper."""
    import torch

    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    for _ in range(3):  # a trace that lost its device events is taken again
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        us = sum(e.self_device_time_total for e in prof.key_averages()
                 if e.device_type == torch.autograd.DeviceType.CUDA)
        if us > 0:
            return us / calls / 1e3
    raise RuntimeError("torch.profiler recorded no device time in three traces")


def bound_ms(nbytes, flops, flop_per_s=H100_BF16_FLOP_PER_S):
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = flops / flop_per_s * 1e3
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


def check_rotated(name, out, ref, normed):
    """K7/K8 sum the per-head statistic in another order than their plain
    versions, so a bf16 rounding of a normed value may flip; the rotation
    then moves both outputs of its pair by up to about one bf16 ulp of the
    pair's magnitude.  Holds |out - ref| to 2 bf16 ulps (2 x 2^-7) of
    max(|y_2i|, |y_2i+1|) of the normed values, the CPU tests' bound."""
    import torch

    n = normed.float()
    pair = torch.maximum(n[..., 0::2].abs(), n[..., 1::2].abs()).repeat_interleave(2, -1)
    err = (out.float() - ref.float()).abs()
    worst = (err / pair.clamp_min(1e-30)).max().item()
    print(f"  {name}: max_abs_err {err.max().item():.3e}; largest error over its pair's "
          f"magnitude {worst:.3e} (tolerance 2 x 2^-7 = 1.5625e-02)", flush=True)
    if not bool((err <= 2 * 2 ** -7 * pair).all()):
        raise RuntimeError(f"{name} disagrees with its plain version")
    return err.max().item()


def bounded_sdpa(qh, kh, v, n, sq, sk):
    """One scaled_dot_product_attention call computing K3/K4's function on
    the real lengths of head-major qh/kh (B*N, S_pad, hd) and natural v
    (B, Lv, N, hd): q carries hd^-1/2*log2(e), so scale ln(2) gives exp2."""
    import torch.nn.functional as F

    q4 = qh.view(-1, n, *qh.shape[1:])[:, :, :sq]
    k4 = kh.view(-1, n, *kh.shape[1:])[:, :, :sk]
    v4 = v.transpose(1, 2)
    return lambda: F.scaled_dot_product_attention(q4, k4, v4, scale=0.6931471805599453)


def kernel_checks(S, grid, tag):
    """K1-K4 at one shape set; returns {kernel: numbers}."""
    import torch

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
        device_ms=device_ms(lambda: layer_norm_modulate(x, sh, sc, seg, 1e-6)),
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
        device_ms=device_ms(lambda: fq.rms_rope_heads_major(xq, gq, rsq, ff, N, s_pad)),
        plain_ms=time_ms(lambda: fq.rms_rope_heads_major_plain(xq, gq, rsq, ff, N, s_pad), 5, 3),
        bound=bound_ms(nbytes, 6 * S * D), library_ms=None)

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
        library_ms=time_ms(bounded_sdpa(qh, kh, v, N, S, S)))

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
        library_ms=time_ms(bounded_sdpa(qc, khc, vc, N, S, lk)))
    for k, r in res.items():
        lib = "null" if r["library_ms"] is None else f"{r['library_ms']:.4f}"
        dev = f" device_ms {r['device_ms']:.4f}" if "device_ms" in r else ""
        print(f"  {tag} {k}: ms {r['ms']:.4f}{dev} plain_ms {r['plain_ms']:.4f} "
              f"bound_ms {r['bound'][0]:.4f} ({r['bound'][1]}) library_ms {lib}", flush=True)
    return res


DIT_ATTENTION_SHAPES = (
    # (kernel, shape, heads, tokens, rows padded to): the image DiTs' self
    # attention as their call sites pad it, q and k to a multiple of 1024
    ("flash_bounded", "FLUX.1 joint 24x4608 in 5120", 24, 4608, 5120),
    ("flash_bounded", "Z-Image 30x4416 in 5120", 30, 4416, 5120),
    # Z-Image's caption refiner: one 1024-key tile, so K4, whose key loop
    # stops at 3 of 8 key tiles and whose last q tile is partial
    ("flash_small_kv", "Z-Image caption 30x320 in 1024", 30, 320, 1024),
)


def dit_attention_checks():
    """K3 and K4's bounded form at DIT_ATTENTION_SHAPES: q and k rms-normed
    with zero rows past the sequence, q prescaled; against the plain
    version, with scaled_dot_product_attention at the real lengths as the
    yardstick.  Returns {kernel: {shape: numbers}}."""
    import torch

    from fairygen_tpu_torch.ops.flash_attention import (
        flash_attention_heads_major, flash_attention_heads_major_plain)

    dev, bf = "cuda", torch.bfloat16
    g = torch.Generator(dev).manual_seed(4608)
    hd = 128
    res = {}

    def normed(*shape, scale=1.0):
        x = torch.randn(shape, generator=g, device=dev)
        return (x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + 1e-6) * scale).to(bf)

    for kernel, tag, N, S, s_pad in DIT_ATTENTION_SHAPES:
        qh = torch.zeros((N, s_pad, hd), dtype=bf, device=dev)
        kh = torch.zeros((N, s_pad, hd), dtype=bf, device=dev)
        qh[:, :S] = normed(N, S, hd, scale=hd ** -0.5 * 1.4426950408889634)
        kh[:, :S] = normed(N, S, hd)
        v = torch.randn((1, S, N, hd), generator=g, device=dev).to(bf)

        def kern():
            return flash_attention_heads_major(qh, kh, v, b=1, n=N, sq=S, sk_actual=S,
                                               bq=1024, bk=1024)

        def plain():
            return flash_attention_heads_major_plain(qh, kh, v, b=1, n=N, sq=S, sk_actual=S)

        err = check_close(f"{kernel} {tag}", kern(), plain(), rtol=2 ** -7, atol=1e-3)
        r = res.setdefault(kernel, {})[tag] = dict(
            max_abs_err=err, ms=time_ms(kern), plain_ms=time_ms(plain, 2, 3),
            bound=bound_ms(4 * S * hd * N * 2, 4 * S * S * hd * N),
            library_ms=time_ms(bounded_sdpa(qh, kh, v, N, S, S)))
        print(f"  {tag} {kernel}: ms {r['ms']:.4f} plain_ms {r['plain_ms']:.4f} "
              f"bound_ms {r['bound'][0]:.4f} ({r['bound'][1]}) library_ms "
              f"{r['library_ms']:.4f}", flush=True)
    return res


# the TMA + wgmma kernel functions: (counter and form, kernel function, the
# object file that holds it, its dynamic shared memory from the library).
# K4's max and masked forms over one key tile run K5's kernel functions (at
# d 64 and at most 80 keys, its 80-column form).
HOPPER_KERNELS = (
    ("flash_bounded", "fa_bounded_kernel", "flash_attention.cu.o",
     lambda lib: lib.fg_flash_bounded_smem_bytes()),
    ("flash_small_kv", "fa_small_kv_kernel", "flash_attention.cu.o",
     lambda lib: lib.fg_flash_bounded_smem_bytes()),
    ("flash_fwd_d64", "fa_online_d64_kernel", "flash_attention_online.cu.o",
     lambda lib: lib.fg_flash_online_smem_bytes(0)),
    ("flash_fwd_d64 ragged", "fa_online_d64_ragged_kernel", "flash_attention_online.cu.o",
     lambda lib: lib.fg_flash_online_smem_bytes(0)),
    ("flash_fwd", "fa_online_d128_kernel", "flash_attention_online.cu.o",
     lambda lib: lib.fg_flash_online_smem_bytes(1)),
    ("flash_fwd ragged", "fa_online_d128_ragged_kernel", "flash_attention_online.cu.o",
     lambda lib: lib.fg_flash_online_smem_bytes(1)),
    ("flash_fwd_lse", "fa_online_lse_kernel", "flash_attention_online.cu.o",
     lambda lib: lib.fg_flash_online_smem_bytes(1)),
    ("flash_fwd_lse ragged", "fa_online_lse_ragged_kernel", "flash_attention_online.cu.o",
     lambda lib: lib.fg_flash_online_smem_bytes(1)),
    ("flash_small_kv_masked d64 (one tile of <= 80 keys)", "fa_online_d64_k80_kernel",
     "flash_attention_online.cu.o", lambda lib: lib.fg_flash_online_smem_bytes(0)),
    ("flash_small_kv_max/masked d64 (2+ key tiles)", "fa_row_max_d64_kernel",
     "flash_attention_online.cu.o", lambda lib: lib.fg_flash_online_smem_bytes(0)),
    ("flash_small_kv_max/masked d64 ragged (2+ key tiles)", "fa_row_max_d64_ragged_kernel",
     "flash_attention_online.cu.o", lambda lib: lib.fg_flash_online_smem_bytes(0)),
    ("flash_small_kv_max/masked d128 (2+ key tiles)", "fa_row_max_d128_kernel",
     "flash_attention_online.cu.o", lambda lib: lib.fg_flash_online_smem_bytes(1)),
    ("flash_small_kv_max/masked d128 ragged (2+ key tiles)", "fa_row_max_d128_ragged_kernel",
     "flash_attention_online.cu.o", lambda lib: lib.fg_flash_online_smem_bytes(1)),
    ("flash_bias", "fa_online_bias_kernel", "flash_attention_online.cu.o",
     lambda lib: lib.fg_flash_online_smem_bytes(2)),
    ("flash_bias ragged", "fa_online_bias_ragged_kernel", "flash_attention_online.cu.o",
     lambda lib: lib.fg_flash_online_smem_bytes(1)),
    ("flash_bwd_dq", "fa_dq_wgmma_kernel", "flash_attention_bwd.cu.o",
     lambda lib: lib.fg_flash_bwd_smem_bytes(0)),
    ("flash_bwd_dq ragged", "fa_dq_wgmma_ragged_kernel", "flash_attention_bwd.cu.o",
     lambda lib: lib.fg_flash_bwd_smem_bytes(0)),
    ("flash_bwd_dkv", "fa_dkv_wgmma_kernel", "flash_attention_bwd.cu.o",
     lambda lib: lib.fg_flash_bwd_smem_bytes(1)),
)


def hopper_build_report(log):
    """Each TMA + wgmma kernel's registers and spills from the build's ptxas
    -v, its dynamic shared memory and, where cuobjdump is present, its
    counts of HGMMA (wgmma) and UTMALDG (TMA load) instructions from its own
    object file.  Raises on a spill, on a missing kernel, on a count of 0,
    or where ptxas says it serialized the kernel's wgmma (C7511, C7512,
    C7520).
    A function is matched by its name followed by 'E' (the end of the name
    in the mangled symbol), so no name matches another it begins."""
    import re
    import shutil

    from fairygen_tpu_torch.ops import _kernels

    def which(symbol):
        return next((k for k, f, _, _ in HOPPER_KERNELS if f + "E" in symbol), None)

    props, current = {}, None
    for line in log.splitlines():
        m = re.search(r"\((C751[12]|C7520)\).*'(\S+)'", line)
        if m and which(m.group(2)):
            raise RuntimeError(f"{which(m.group(2))}: ptxas serialized its wgmma: {line}")
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            current = which(m.group(1))
            continue
        if current is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            props.setdefault(current, {})["spill_bytes"] = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            props.setdefault(current, {})["registers"] = int(m.group(1))
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    tool = os.path.join(home, "bin", "cuobjdump")
    tool = tool if os.path.exists(tool) else shutil.which("cuobjdump")
    if tool:
        for obj in sorted({o for _, _, o, _ in HOPPER_KERNELS}):
            sass = subprocess.run([tool, "-sass", str(_kernels.BUILD_DIR / obj)],
                                  capture_output=True, text=True, timeout=120).stdout
            current = None
            for line in sass.splitlines():
                m = re.search(r"Function : (\S+)", line)
                if m:
                    current = which(m.group(1))
                    if current:
                        props.setdefault(current, {}).update(HGMMA=0, UTMALDG=0)
                elif current:
                    props[current]["HGMMA"] += len(re.findall(r"\bHGMMA\.", line))
                    props[current]["UTMALDG"] += len(re.findall(r"\bUTMALDG\b", line))
    for k, fn, obj, smem in HOPPER_KERNELS:
        p = props.get(k, {})
        print(f"  {k} ({fn}, {obj}): registers {p.get('registers')}, dynamic shared memory "
              f"{smem(_kernels.lib())} bytes, spill bytes {p.get('spill_bytes')}; SASS: HGMMA "
              f"{p.get('HGMMA', 'no cuobjdump')}, UTMALDG {p.get('UTMALDG', 'no cuobjdump')}",
              flush=True)
        if p.get("registers") is None or p.get("spill_bytes") != 0:
            raise RuntimeError(f"{k}: ptxas -v shows spills or no such kernel: {p}")
        if tool and not (p["HGMMA"] and p["UTMALDG"]):
            raise RuntimeError(f"{k}: no HGMMA or UTMALDG instruction in its SASS: {p}")


def train_kernel_checks():
    """K5, K6a, K6b, K6c against their plain versions on the card in bf16 at
    the training path's two shapes: self-attention (B*N = 24, S = 8190
    padded to 8192, the last two keys masked) and text cross-attention
    (q 8190, k/v 512, no mask).  Bounds count 4 (K5, K6a), 6 (K6b) and 8
    (K6c) x BN x Sq x Sk x 128 flops on the unpadded lengths, and each input
    read and output written once.  The library yardstick is PyTorch's flash
    attention: its forward (which also returns the LSE) for K5/K6a, its
    backward for K6b and K6c together; beside the forward also cuDNN's with
    its log-sum-exp, and K5/K6a's library_ms is the faster of the two
    (a cuDNN call that raises is printed and leaves the flash figure).
    K5's output must equal K6a's bit for bit (one kernel template but for
    the lse store).  At the self shape K6a, K6b and K6c run a second time
    and must give the same bits (no atomics).  Then a small gradient check
    of flash_attention against fp32 autograd of the plain attention."""
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
        # tighter than the elementwise bound, which allows about a fifth of
        # |o|'s rms here; the emulated tile rounding of
        # tests/test_torch_online_tiles.py stays near half of it
        rel_l2 = ((o.float() - o_ref.float()).norm() / o_ref.float().norm()).item()
        print(f"  K6a o {tag}: relative L2 error {rel_l2:.3e} (bound 2^-8)", flush=True)
        if not rel_l2 < 2 ** -8:
            raise RuntimeError(f"K6a's o at the {tag} shape: relative L2 error {rel_l2:.3e}")
        print(f"  K5 o bit for bit K6a's ({tag}): {torch.equal(o5, o)}", flush=True)
        if not torch.equal(o5, o):
            raise RuntimeError(f"K5's output differs from K6a's at the {tag} shape")
        if tag == "self":
            o2, lse2 = fa.flash_fwd(qh, kh, vh, sk_actual=ska)
            same = [torch.equal(o, o2), torch.equal(lse, lse2)]
            print(f"  K6a run twice at the self shape: o, lse bit for bit equal {same}",
                  flush=True)
            if not all(same):
                raise RuntimeError(f"K6a is not deterministic: {same}")
            del o2, lse2
        del o5
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
        if tag == "self":
            dq2 = fa.flash_bwd_dq(qh, kh, vh, doh, lse_ref, delta, sk_actual=ska, dq_factor=f)
            dk2, dv2 = fa.flash_bwd_dkv(qh, kh, vh, doh, lse_ref, delta, sq=S, sk_actual=ska)
            same = [torch.equal(a, b) for a, b in ((dq, dq2), (dk, dk2), (dv, dv2))]
            print(f"  K6b / K6c run twice at the self shape: dq, dk, dv bit for bit equal "
                  f"{same}", flush=True)
            if not all(same):
                raise RuntimeError(f"K6b / K6c are not deterministic: {same}")
            del dq2, dk2, dv2

        qs, ks, vs = (t.permute(0, 2, 1, 3).contiguous() for t in (q, k, v))
        sdpa = torch.ops.aten._scaled_dot_product_flash_attention
        fw = sdpa(qs, ks, vs, 0.0, False, False, scale=ln2)
        dos = do.permute(0, 2, 1, 3).contiguous()

        def sdpa_bwd():
            return torch.ops.aten._scaled_dot_product_flash_attention_backward(
                dos, qs, ks, vs, fw[0], fw[1], fw[2], fw[3], fw[4], fw[5], 0.0, False,
                fw[6], fw[7], scale=ln2)

        lib_flash = time_ms(lambda: sdpa(qs, ks, vs, 0.0, False, False, scale=ln2))
        lib_cudnn = cudnn_fwd_ms(qs, ks, vs, ln2, tag)
        lib_fwd = lib_flash if lib_cudnn is None else min(lib_flash, lib_cudnn)
        cudnn_txt = "raised" if lib_cudnn is None else f"{lib_cudnn:.4f}"
        print(f"  {tag} forward yardsticks: SDPA flash {lib_flash:.4f} ms, cuDNN (with its "
              f"log-sum-exp) {cudnn_txt} ms", flush=True)
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
            if name.startswith("flash_fwd"):
                r.update(library_flash_ms=lib_flash, library_cudnn_ms=lib_cudnn)
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


TURNS_LINE = "constexpr bool kTurns = !kBias;"
TURNS_OFF_LINE = "constexpr bool kTurns = false;"


def start_turns_off_build():
    """Start nvcc on a copy of csrc/flash_attention_online.cu in which no
    kernel has the consumers take turns (FA3's ping-pong), for turns_ab.
    Returns the process and the library it makes."""
    from fairygen_tpu_torch.ops import _kernels

    src = (_kernels.CSRC / "flash_attention_online.cu").read_text()
    if src.count(TURNS_LINE) != 1:
        raise RuntimeError(f"flash_attention_online.cu holds '{TURNS_LINE}' "
                           f"{src.count(TURNS_LINE)} times, not once")
    out = _kernels.BUILD_DIR.parent / "turns_off"
    out.mkdir(parents=True, exist_ok=True)
    copy = out / "flash_attention_online.cu"
    copy.write_text(src.replace(TURNS_LINE, TURNS_OFF_LINE))
    lib = out / "libturns_off.so"
    cmd = [_kernels._nvcc()] + _kernels._flags() + [
        "-Xcompiler", "-fPIC", "-shared", "-I", str(_kernels.CSRC), "-o", str(lib), str(copy)]
    print("  " + " ".join(cmd), flush=True)
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True), lib


# K4's shapes for the turns A/B: (tag, BN, Sq, Sk_pad, sk_actual, d)
K4_TURNS_SHAPES = (("K4 cross 20x4096x77", 20, 4096, 128, 77, 64),
                   ("K4 cross 40x1024x77", 40, 1024, 128, 77, 64),
                   ("K4 self 40x1024", 40, 1024, 1024, 1024, 64),
                   ("K4 d128 24x2048x512", 24, 2048, 512, 512, 128))


def turns_ab(lib_path):
    """With the consumers taking turns (the library) and without
    (start_turns_off_build's copy): K6a and K5 at head dim 128 at the
    training shapes (24 heads, q 8190 in 8192 rows; self: 8190 keys in 8192
    rows, the ragged form; cross: 512 keys, the aligned form), and K4 at
    K4_TURNS_SHAPES.  Both must give the same bits.  Each is timed six
    times, on, off, off, on, on, off, through the C functions (no launch
    counted): K5 and K6a by CUDA events, K4, whose calls last a few
    microseconds, by its device time (device_ms).  Returns {shape:
    {kernel: {"on": median ms, "off": median ms}}}."""
    import ctypes
    import statistics

    import torch

    from fairygen_tpu_torch.ops import _kernels

    off = ctypes.CDLL(str(lib_path))
    for fn in ("fg_flash_fwd", "fg_flash_fwd_lse", "fg_flash_small_kv_max"):
        getattr(off, fn).argtypes = _kernels._SIGNATURES[fn]
        getattr(off, fn).restype = ctypes.c_int
    libs = {"on": _kernels.lib(), "off": off}
    g = torch.Generator("cuda").manual_seed(7)

    def rows(bn, s_pad, s, d, scale=1.0):
        x = torch.zeros((bn, s_pad, d), dtype=torch.bfloat16, device="cuda")
        x[:, :s] = (torch.randn((bn, s, d), generator=g, device="cuda") * scale).to(x.dtype)
        return x

    def call(lib, fn, *args):
        rc = getattr(lib, fn)(*args, torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"{fn}: cudaError {rc}")

    res = {}

    def ab(tag, outs, calls, timer=lambda f: time_ms(f, 20, 7)):
        same = [torch.equal(a, b) for a, b in zip(outs["on"], outs["off"])]
        print(f"  turns {tag}: on and off give the same bits {same}", flush=True)
        if not all(same):
            raise RuntimeError(f"turns on and off disagree at the {tag} shape: {same}")
        for kern in calls["on"]:
            ms = {"on": [], "off": []}
            for t in ("on", "off", "off", "on", "on", "off"):
                ms[t].append(timer(calls[t][kern]))
            res.setdefault(tag, {})[kern] = {t: statistics.median(v) for t, v in ms.items()}
            print(f"  turns {tag} {kern} ms, on: " + " / ".join(f"{m:.4f}" for m in ms["on"]) +
                  "; off: " + " / ".join(f"{m:.4f}" for m in ms["off"]), flush=True)

    bn, d, sq, sq_pad = 24, 128, 8190, 8192
    qh = rows(bn, sq_pad, sq, d, d ** -0.5 * 1.4426950408889634)
    for tag, sk, sk_pad in (("self", sq, sq_pad), ("cross", 512, 512)):
        kh, vh = rows(bn, sk_pad, sk, d), rows(bn, sk_pad, sk, d)
        outs, calls = {}, {}
        for t, lib in libs.items():
            o, o5 = torch.empty_like(qh), torch.empty_like(qh)
            lse = torch.empty((bn, sq_pad), dtype=torch.float32, device="cuda")
            calls[t] = {
                "K6a": lambda lib=lib, o=o, lse=lse, kh=kh, vh=vh: call(
                    lib, "fg_flash_fwd_lse", qh.data_ptr(), kh.data_ptr(), vh.data_ptr(),
                    o.data_ptr(), lse.data_ptr(), bn, sq_pad, sk, sk_pad),
                "K5": lambda lib=lib, o5=o5, kh=kh, vh=vh: call(
                    lib, "fg_flash_fwd", qh.data_ptr(), kh.data_ptr(), vh.data_ptr(),
                    o5.data_ptr(), bn, sq_pad, sk, sk_pad)}
            for f in calls[t].values():
                f()
            outs[t] = (o, lse, o5)
        torch.cuda.synchronize()
        ab(tag, outs, calls)
        del kh, vh, outs, calls
    del qh
    for tag, bn, sq, sk_pad, sk, d in K4_TURNS_SHAPES:
        qh = rows(bn, sq, sq, d, d ** -0.5 * 1.4426950408889634)
        kh, vh = rows(bn, sk_pad, sk_pad, d), rows(bn, sk_pad, sk_pad, d)
        outs, calls = {}, {}
        for t, lib in libs.items():
            o = torch.empty_like(qh)
            calls[t] = {"K4": lambda lib=lib, o=o: call(
                lib, "fg_flash_small_kv_max", qh.data_ptr(), kh.data_ptr(), vh.data_ptr(),
                o.data_ptr(), bn, sq, sk, sk_pad, d)}
            calls[t]["K4"]()
            outs[t] = (o,)
        torch.cuda.synchronize()
        ab(tag, outs, calls, device_ms)
        del qh, kh, vh, outs, calls
    torch.cuda.empty_cache()
    return res


def cudnn_fwd_ms(qs, ks, vs, scale, tag):
    """ms of cuDNN's attention forward with its log-sum-exp on (B, N, S, d)
    q/k/v, a yardstick beside K5/K6a; None, with the error printed on a
    line of its own, where the torch build's call raises."""
    import torch

    cudnn = torch.ops.aten._scaled_dot_product_cudnn_attention

    def call():
        return cudnn(qs, ks, vs, None, True, 0.0, False, False, scale=scale)

    try:
        call()
        torch.cuda.synchronize()
    except RuntimeError as e:  # the yardstick only: the port never calls it
        msg = " ".join(str(e).split())[:300]
        print(f"  cuDNN attention forward ({tag}) raised {type(e).__name__}: {msg}", flush=True)
        return None
    return time_ms(call)


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
    ab_lib = argv[argv.index("--ab-lib") + 1] if "--ab-lib" in argv else None

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
    for cmd in _kernels.compile_commands(verbose=True) + [_kernels.link_command()]:
        print("  " + " ".join(cmd))
    turns_proc, turns_lib = start_turns_off_build()
    try:
        build_log = _kernels.build(verbose=True, force=True, timeout=300)
        print(build_log)
        _kernels.lib()
        hopper_build_report(build_log)
        turns_log, _ = turns_proc.communicate(timeout=300)
    finally:
        if turns_proc.poll() is None:
            turns_proc.kill()
            turns_proc.wait()
    if turns_proc.returncode:
        raise RuntimeError(f"nvcc of the copy without turns failed ({turns_proc.returncode}):\n"
                           f"{turns_log}")
    done("build", t0)

    t0 = phase("kernels")
    smoke = kernel_checks(1950, (5, 15, 26), "S=1950")
    flagship = kernel_checks(8190, (21, 15, 26), "S=8190")
    dit_attn = dit_attention_checks()
    train_k = train_kernel_checks()
    turns = turns_ab(turns_lib)
    flux_k = flux_kernel_checks()
    norm_k = norm_kernel_checks()
    sdxl_k = sdxl_kernel_checks()
    k4_other = k4_ab(ab_lib) if ab_lib else None
    torch.cuda.synchronize()
    done("kernels", t0)

    expected, k11_main = None, {}
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
        enc_norms, dec_norms = vae_norm_silu_calls(vae_cfg)
        per_request["vae_rms_silu"] = enc_norms + dec_norms  # one frame in, one decode
        expected = {k: 2 * per_request.get(k, 0) for k in _kernels.launches}
        torch.cuda.reset_peak_memory_stats()
        _kernels.reset_launches()
        req_latents = capture_latents(pipe)
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
        del pipe._decode_output  # the class's again
        done("requests", t0)

        t0 = phase("flagship")
        flagship_launches, k11_main = flagship_phase(pipe, te_cfg, req_latents[-1], flagship)
        done("flagship", t0)

        t0 = phase("train")
        trained = train_phase(pipe, per_request)
        launches = {k: launches[k] + trained[k] + flagship_launches[k] for k in launches}
        print(f"  launches, serving, the flagship request and training: {launches}", flush=True)
        done("train", t0)

        t0 = phase("train_surface")
        surface = train_surface_phase(pipe, per_request, vae_cfg)
        launches = {k: launches[k] + surface[k] for k in launches}
        print(f"  launches, serving, the flagship request, training and its surface: "
              f"{launches}", flush=True)
        done("train_surface", t0)

        t0 = phase("breakdown")
        breakdown(pipe, te_cfg)
        del pipe, dit, te, vae, video
        torch.cuda.empty_cache()
        done("breakdown", t0)

        t0 = phase("flux")
        flux_launches = flux_phase()
        launches = {k: launches[k] + flux_launches[k] for k in launches}
        print(f"  launches, serving, training and FLUX.1: {launches}", flush=True)
        done("flux", t0)

        t0 = phase("zimage")
        zimage_launches = zimage_phase()
        launches = {k: launches[k] + zimage_launches[k] for k in launches}
        print(f"  launches, serving, training, FLUX.1 and Z-Image: {launches}", flush=True)
        done("zimage", t0)

        t0 = phase("sdxl")
        sdxl_launches = sdxl_phase()
        launches = {k: launches[k] + sdxl_launches[k] for k in launches}
        print(f"  launches, serving, training, FLUX.1, Z-Image and SDXL: {launches}", flush=True)
        done("sdxl", t0)

        t0 = phase("reference")
        reference_check()
        reference_from_pretrained_check()
        reference_train_check()
        reference_flux_check()
        reference_zimage_check()
        reference_sdxl_check()
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
        if "device_ms" in r:
            rows[-1].update(device_ms=r["device_ms"], flagship_device_ms=f["device_ms"])
        if k in dit_attn:
            rows[-1]["max_abs_err"] = max([rows[-1]["max_abs_err"]] +
                                          [v["max_abs_err"] for v in dit_attn[k].values()])
            rows[-1]["by_shape"] = {tag: {"ms": v["ms"], "plain_ms": v["plain_ms"],
                                          "bound_ms": v["bound"][0], "library_ms": v["library_ms"],
                                          "max_abs_err": v["max_abs_err"]}
                                    for tag, v in dit_attn[k].items()}
    train_sources = {"flash_fwd": "fairygen_tpu/ops/flash_attention.py:35",
                     "flash_fwd_lse": "fairygen_tpu/ops/flash_attention.py:253",
                     "flash_bwd_dq": "fairygen_tpu/ops/flash_attention.py:295",
                     "flash_bwd_dkv": "fairygen_tpu/ops/flash_attention.py:329"}
    for k, replaces in train_sources.items():
        r, c = train_k[k]["self"], train_k[k]["cross"]
        src = "flash_attention_bwd.cu" if k.startswith("flash_bwd") else "flash_attention_online.cu"
        rows.append({
            "name": k, "route": "cuda",
            "source": "fairygen_tpu_torch/csrc/" + src, "replaces": replaces,
            "launches": None if expected is None else launches[k],
            "max_abs_err": max(r["max_abs_err"], c["max_abs_err"]), "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound"][0], "bound_by": r["bound"][1],
            "library_ms": r["library_ms"], "cross_ms": c["ms"], "cross_plain_ms": c["plain_ms"],
            "cross_bound_ms": c["bound"][0], "cross_library_ms": c["library_ms"]})
        if k.startswith("flash_fwd"):
            kern = "K6a" if k == "flash_fwd_lse" else "K5"
            rows[-1].update(library_flash_ms=r["library_flash_ms"],
                            library_cudnn_ms=r["library_cudnn_ms"],
                            cross_library_flash_ms=c["library_flash_ms"],
                            cross_library_cudnn_ms=c["library_cudnn_ms"],
                            turns_ab_ms={tag: turns[tag][kern] for tag in ("self", "cross")})
    flux_sources = {
        "rms_rope_per_head": ("csrc/rms_rope.cu", "fairygen_tpu/ops/fused_qk.py:133"),
        "rms_rope_joint": ("csrc/rms_rope.cu", "fairygen_tpu/ops/fused_qk.py:232"),
        "flash_bias": ("csrc/flash_attention_online.cu",
                       "fairygen_tpu/ops/flash_attention.py:167")}
    for k, (src, replaces) in flux_sources.items():
        r = flux_k[k]
        rows.append({
            "name": k, "route": "cuda", "source": "fairygen_tpu_torch/" + src,
            "replaces": replaces, "launches": None if expected is None else launches[k],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound"][0], "bound_by": r["bound"][1],
            "library_ms": r["library_ms"]})
        if "device_ms" in r:
            rows[-1]["device_ms"] = r["device_ms"]
    norm_sources = {"rms_modulate": ("fairygen_tpu/ops/fused_norms.py:141", (4416, "no-scale")),
                    "vae_rms_silu": ("fairygen_tpu/ops/fused_norms.py:224",
                                     (399360, "no-silu"))}
    for k, (replaces, main_shape) in norm_sources.items():
        r = norm_k[k][main_shape]
        rows.append({
            "name": k, "route": "cuda", "source": "fairygen_tpu_torch/csrc/rms_modulate.cu",
            "replaces": replaces, "launches": None if expected is None else launches[k],
            "max_abs_err": max(v["max_abs_err"] for v in norm_k[k].values()), "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound"][0], "bound_by": r["bound"][1],
            "library_ms": r["library_ms"], "device_ms": r["device_ms"],
            "by_shape": {f"{n} {tag}": {"ms": v["ms"], "device_ms": v["device_ms"],
                                        "plain_ms": v["plain_ms"],
                                        "bound_ms": v["bound"][0], "library_ms": v["library_ms"],
                                        "differ": v["differ"]}
                         for (n, tag), v in norm_k[k].items()}})
        if k == "vae_rms_silu" and k11_main:
            rows[-1]["max_abs_err"] = max([rows[-1]["max_abs_err"]] +
                                          [v["max_abs_err"] for v in k11_main.values()])
            rows[-1]["main_path_shapes"] = {
                tag: {"calls": v["calls"], "ms": v["ms"], "device_ms": v["device_ms"],
                      "plain_ms": v["plain_ms"], "bound_ms": v["bound"][0],
                      "max_abs_err": v["max_abs_err"], "differ": v["differ"]}
                for tag, v in k11_main.items()}
            rows[-1]["main_path_device_ms_total"] = sum(v["calls"] * v["device_ms"]
                                                        for v in k11_main.values())
            rows[-1]["main_path_bound_ms_total"] = sum(v["calls"] * v["bound"][0]
                                                       for v in k11_main.values())
    sdxl_sources = {
        "flash_small_kv_max": ("csrc/flash_attention_online.cu",
                               "fairygen_tpu/ops/flash_attention.py:133", "self 40x1024"),
        "flash_small_kv_masked": ("csrc/flash_attention_online.cu",
                                  "fairygen_tpu/ops/flash_attention.py:133",
                                  "cross 20x4096 q, 77 keys"),
        "flash_fwd_d64": ("csrc/flash_attention_online.cu",
                          "fairygen_tpu/ops/flash_attention.py:35", "self 20x4096")}
    for k, (src, replaces, main_shape) in sdxl_sources.items():
        r = sdxl_k[k][main_shape]
        rows.append({
            "name": k, "route": "cuda", "source": "fairygen_tpu_torch/" + src,
            "replaces": replaces, "launches": None if expected is None else launches[k],
            "max_abs_err": max(v["max_abs_err"] for v in sdxl_k[k].values()), "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound"][0], "bound_by": r["bound"][1],
            "library_ms": r["library_ms"], "shape": main_shape,
            "device_ms": r["device_ms"], "library_device_ms": r["library_device_ms"],
            "by_shape": {tag: {"ms": v["ms"], "device_ms": v["device_ms"],
                               "plain_ms": v["plain_ms"], "bound_ms": v["bound"][0],
                               "library_ms": v["library_ms"],
                               "library_device_ms": v["library_device_ms"],
                               "max_abs_err": v["max_abs_err"], "rel_l2": v["rel_l2"]}
                         for tag, v in sdxl_k[k].items()}})
        if k != "flash_fwd_d64":
            rows[-1]["turns_ab_ms"] = {tag: turns[tag]["K4"] for tag, *_ in K4_TURNS_SHAPES}
            if k4_other:
                rows[-1]["ab_lib_ms"] = k4_other
    timer.cancel()
    print(smi)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": count}}))
    return 0



def flux_kernel_checks():
    """K7, K8 and K10 against their plain versions on the card in bf16 at the
    FLUX.1-dev 1024x1024 shapes: 4096 image and 512 text tokens, 24 heads of
    128.  K7 gets the single blocks' q (S = 4608, a column slice of the
    fused (4608, 7 x 3072) projection) -> (24, 5120, 128); K8 the double
    blocks' two streams (slices of their (., 3 x 3072) projections) into one
    (24, 5120, 128) buffer; K10 the EliGen attention over 2 x 512 entity +
    512 prompt + 4096 image = 5632 tokens with its (1, 5632, 5632) fp32 bias
    from two seeded rectangular regions plus a continuous 0.3 x randn term
    on the allowed entries.  Bounds: bytes for K7/K8 (each input read and
    each output written once, the fp32 tables as the (S, hd/2) cos and sin
    pairs the rotation needs);
    for K10 the larger of 4 x Sq x Sk x 128 x 24 flops and the bytes of
    q, k, v, o and the bias read once.  K10's yardstick is
    scaled_dot_product_attention with the same bias as a bf16 attn_mask."""
    import torch
    import torch.nn.functional as F

    from fairygen_tpu_torch.models.flux.dit import eligen_attention_bias
    from fairygen_tpu_torch.ops import flash_attention as fa
    from fairygen_tpu_torch.ops import fused_qk as fq

    dev, bf = "cuda", torch.bfloat16
    g = torch.Generator(dev).manual_seed(777)
    N, hd, D, s_i, s_t = 24, 128, 3072, 4096, 512
    res = {}

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=g, device=dev) * scale).to(bf)

    def tables(rows):
        ang = torch.rand((rows, hd // 2), generator=g, device=dev) * 6.283
        return torch.cos(ang), torch.sin(ang)

    # K7: the single blocks' q
    s = s_t + s_i
    s_pad = fq._pad_for_flash(s)[0]
    x = randn(1, s, 7 * D)[..., :D]
    gamma = randn(hd, scale=hd ** -0.5 * 1.4427)
    ff = fq.build_freqs_full_pairs(*tables(s))
    out = fq.rms_rope_heads_major_per_head(x, gamma, ff, N, s_pad, eps=1e-6)
    ref = fq.rms_rope_heads_major_per_head_plain(x, gamma, ff, N, s_pad, eps=1e-6)
    ident = fq.build_freqs_full_pairs(torch.ones((s, hd // 2), device=dev),
                                      torch.zeros((s, hd // 2), device=dev))
    normed = fq.rms_rope_heads_major_per_head_plain(x, gamma, ident, N, s_pad, eps=1e-6)
    err = check_rotated(f"K7 rms_rope_per_head S={s}", out, ref, normed)
    if not torch.all(out[:, s:] == 0):
        raise RuntimeError("K7 left a nonzero pad row")
    nbytes = s * D * 2 + hd * 2 + s * hd * 4 + N * s_pad * hd * 2
    res["rms_rope_per_head"] = dict(
        max_abs_err=err,
        ms=time_ms(lambda: fq.rms_rope_heads_major_per_head(x, gamma, ff, N, s_pad, eps=1e-6)),
        device_ms=device_ms(lambda: fq.rms_rope_heads_major_per_head(x, gamma, ff, N, s_pad,
                                                                     eps=1e-6)),
        plain_ms=time_ms(lambda: fq.rms_rope_heads_major_per_head_plain(x, gamma, ff, N, s_pad,
                                                                        eps=1e-6), 5, 3),
        bound=bound_ms(nbytes, 8 * s * D), library_ms=None)

    # K8: the double blocks' two streams
    i_pad = -(-s_i // 1024) * 1024
    j_pad = i_pad + -(-s_t // 1024) * 1024
    xi, xt = randn(1, s_i, 3 * D)[..., :D], randn(1, s_t, 3 * D)[..., :D]
    gi, gt = randn(hd, scale=0.13), randn(hd, scale=0.13)
    ffj = fq.build_freqs_full_joint(*tables(s_i), *tables(s_t), i_pad, j_pad)
    out = fq.rms_rope_heads_major_joint(xi, xt, gi, gt, ffj, N, i_pad, j_pad, eps=1e-6)
    ref = fq.rms_rope_heads_major_joint_plain(xi, xt, gi, gt, ffj, N, i_pad, j_pad, eps=1e-6)
    ones = [torch.ones((n, hd // 2), device=dev) for n in (s_i, s_t)]
    ident = fq.build_freqs_full_joint(ones[0], 0 * ones[0], ones[1], 0 * ones[1], i_pad, j_pad)
    normed = fq.rms_rope_heads_major_joint_plain(xi, xt, gi, gt, ident, N, i_pad, j_pad,
                                                 eps=1e-6)
    err = check_rotated(f"K8 rms_rope_joint {s_i}+{s_t}", out, ref, normed)
    if not (torch.all(out[:, s_i:i_pad] == 0) and torch.all(out[:, i_pad + s_t:] == 0)):
        raise RuntimeError("K8 left a nonzero gap row")
    nbytes = s * D * 2 + 2 * hd * 2 + (s_i + s_t) * hd * 4 + N * j_pad * hd * 2
    res["rms_rope_joint"] = dict(
        max_abs_err=err,
        ms=time_ms(lambda: fq.rms_rope_heads_major_joint(xi, xt, gi, gt, ffj, N, i_pad, j_pad,
                                                         eps=1e-6)),
        device_ms=device_ms(lambda: fq.rms_rope_heads_major_joint(xi, xt, gi, gt, ffj, N, i_pad,
                                                                  j_pad, eps=1e-6)),
        plain_ms=time_ms(lambda: fq.rms_rope_heads_major_joint_plain(
            xi, xt, gi, gt, ffj, N, i_pad, j_pad, eps=1e-6), 5, 3),
        bound=bound_ms(nbytes, 8 * s * D), library_ms=None)
    del x, xi, xt, out, ref, normed

    # K10: EliGen attention, 2 entities
    L = 3 * s_t + s_i
    masks = torch.zeros((1, 2, 1, 128, 128), device=dev)
    masks[:, 0, :, 10:70, 5:60] = 1
    masks[:, 1, :, 50:120, 64:125] = 1
    bias = eligen_attention_bias(masks, s_t, s_i)[:, 0].contiguous()
    # a continuous term on the allowed entries, so the check sees the bias
    # scaled by log2(e) and not only as a mask
    allowed = bias > -1e29
    bias = torch.where(allowed, bias + 0.3 * torch.randn(bias.shape, generator=g, device=dev),
                       bias)
    del allowed
    q = randn(1, L, N, hd, scale=hd ** -0.5 * 1.4427)
    k, v = randn(1, L, N, hd), randn(1, L, N, hd)
    qh, kh, vh = (fa._heads_major(t, fa._pad_len(L, 64, False)) for t in (q, k, v))
    out = fa.flash_attention_bias_heads_major(qh, kh, vh, bias, n=N, sq=L, sk=L)
    ref = fa.flash_attention_bias_plain(qh, kh, vh, bias, n=N, sq=L, sk=L)
    # p is rounded to bf16 against its key tile's running max, as in K5
    err = check_close(f"K10 flash_bias L={L}", out[:, :L], ref[:, :L], rtol=2 ** -7,
                      atol=2 ** -8)
    del ref
    mask16 = bias[None].to(bf)
    qs, ks, vs = (t.permute(0, 2, 1, 3) for t in (q, k, v))
    lib = time_ms(lambda: F.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask16,
                                                         scale=0.6931471805599453), 5, 3)
    nbytes = 4 * L * N * hd * 2 + L * L * 4
    res["flash_bias"] = dict(
        max_abs_err=err,
        ms=time_ms(lambda: fa.flash_attention_bias_heads_major(qh, kh, vh, bias, n=N, sq=L, sk=L),
                   5, 5),
        plain_ms=time_ms(lambda: fa.flash_attention_bias_plain(qh, kh, vh, bias, n=N, sq=L,
                                                               sk=L), 1, 3),
        bound=bound_ms(nbytes, 4 * L * L * hd * N), library_ms=lib)
    for name, r in res.items():
        lib_s = "null" if r["library_ms"] is None else f"{r['library_ms']:.4f}"
        dev_s = f" device_ms {r['device_ms']:.4f}" if "device_ms" in r else ""
        print(f"  FLUX {name}: ms {r['ms']:.4f}{dev_s} plain_ms {r['plain_ms']:.4f} bound_ms "
              f"{r['bound'][0]:.4f} ({r['bound'][1]}) library_ms {lib_s}", flush=True)
    del q, k, v, qh, kh, vh, out, bias, mask16
    torch.cuda.empty_cache()
    return res


FLUX_STEPS = 4
FLUX_PER_SWEEP = {"ln_modulate": 4 * 19 + 38 + 1, "rms_rope_joint": 2 * 19,
                  "rms_rope_per_head": 2 * 38, "flash_bounded": 19 + 38}
FLUX_ELIGEN_PER_SWEEP = {"ln_modulate": 4 * 19 + 38 + 1, "flash_bias": 19 + 38}


def flux_phase():
    """FLUX.1-dev at full width and depth on the card: the DiT (19 + 38
    blocks, dim 3072), T5 v1.1 XXL, CLIP-L and the FLUX AutoencoderKL from
    seeded bf16 weights; two 1024x1024 text-to-image requests (512 T5
    tokens, embedded guidance 3.5, cfg_scale 1, 4 steps) and one EliGen
    request (2 entity prompts, seeded rectangles at latent resolution), each
    with exact launch counts; then one sweep without regions and one with
    the EliGen request's under torch.profiler.  Returns the launches of the
    three requests."""
    import torch

    from fairygen_tpu_torch import convert
    from fairygen_tpu_torch.models.flux.dit import FluxDiTConfig, flux_dit_forward
    from fairygen_tpu_torch.models.flux.text_encoders import UMT5Config, flux_clip_l_config
    from fairygen_tpu_torch.models.sdxl.vae import AutoencoderKLConfig
    from fairygen_tpu_torch.ops import _kernels
    from fairygen_tpu_torch.pipelines.flux_image import FluxImagePipeline

    bf = torch.bfloat16
    torch.cuda.reset_peak_memory_stats()
    t1 = time.perf_counter()
    dit_cfg, t5_cfg = FluxDiTConfig.flux1_dev(), UMT5Config.t5_v1_1_xxl()
    clip_cfg, vae_cfg = flux_clip_l_config(), AutoencoderKLConfig.flux()
    dit = convert.init_flux_dit_params(dit_cfg, "cuda", bf, seed=30)
    t5 = convert.init_t5_params(t5_cfg, "cuda", bf, seed=31)
    clip = convert.init_clip_text_params(clip_cfg, "cuda", bf, seed=32)
    vae = convert.init_autoencoder_kl_params(vae_cfg, "cuda", bf, seed=33)
    torch.cuda.synchronize()
    print(f"  FLUX.1-dev weights in {time.perf_counter() - t1:.3f} s: DiT "
          f"{convert.count_params(dit):,} T5 {convert.count_params(t5):,} CLIP-L "
          f"{convert.count_params(clip):,} VAE {convert.count_params(vae):,}; "
          f"max_memory_allocated {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    pipe = FluxImagePipeline(dit, dit_cfg, vae, vae_cfg, clip, clip_cfg, t5, t5_cfg, bf, "cuda")

    def prompt(seed):
        gen = torch.Generator("cpu").manual_seed(seed)
        t5_ids = torch.zeros((1, 512), dtype=torch.long)
        n = int(torch.randint(32, 200, (1,), generator=gen))
        t5_ids[0, :n] = torch.randint(2, t5_cfg.vocab, (n,), generator=gen)
        t5_ids[0, n] = 1  # EOS, then pad id 0
        clip_ids = torch.full((1, 77), clip_cfg.eos_token_id, dtype=torch.long)
        clip_ids[0, 0] = 49406
        clip_ids[0, 1:min(n, 75) + 1] = torch.randint(0, 49406, (min(n, 75),), generator=gen)
        return pipe.encode_ids(t5_ids, clip_ids)

    total = {k: 0 for k in _kernels.launches}

    def request(label, want_per_sweep, **kw):
        want = {k: want_per_sweep.get(k, 0) * FLUX_STEPS for k in _kernels.launches}
        _kernels.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        img = pipe(height=1024, width=1024, num_inference_steps=FLUX_STEPS,
                   embedded_guidance=3.5, output_type="floatpoint", **kw)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t1
        got = dict(_kernels.launches)
        finite = bool(torch.isfinite(img).all())
        print(f"  {label}: {dt:.3f} s, output {tuple(img.shape)} {img.dtype}, all finite: "
              f"{finite}, std {img.float().std().item():.4f}, max_memory_allocated "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, launches "
              f"{ {k: v for k, v in got.items() if v} }", flush=True)
        if tuple(img.shape) != (1, 3, 1024, 1024) or not finite:
            raise RuntimeError(f"{label}: output has the wrong shape or non-finite values")
        if got != want:
            raise RuntimeError(f"{label}: launch counts {got} != expected {want}")
        for k, v in got.items():
            total[k] += v

    for seed in (41, 42):
        emb, pooled = prompt(seed)
        request(f"FLUX.1-dev request seed={seed}", FLUX_PER_SWEEP, prompt_emb=emb,
                pooled_prompt_emb=pooled, seed=seed)
    emb, pooled = prompt(43)
    ent = torch.stack([prompt(44)[0], prompt(45)[0]], dim=1)  # (1, 2, 512, 4096)
    masks = torch.zeros((1, 2, 1, 128, 128), device="cuda", dtype=bf)
    gen = torch.Generator("cpu").manual_seed(46)
    for i in range(2):
        y0, x0 = (int(v) for v in torch.randint(0, 64, (2,), generator=gen))
        h, w = (int(v) for v in torch.randint(24, 64, (2,), generator=gen))
        masks[0, i, 0, y0:y0 + h, x0:x0 + w] = 1
    request("FLUX.1-dev EliGen request (2 entities)", FLUX_ELIGEN_PER_SWEEP, prompt_emb=emb,
            pooled_prompt_emb=pooled, seed=43, eligen_entity_prompts=ent,
            eligen_entity_masks=masks)

    # where a sweep's time goes, without regions and with the EliGen request's
    # two (5632 tokens: K10 in place of K7, K8 and K3)
    g = torch.Generator("cuda").manual_seed(47)
    lat = torch.randn((1, 16, 128, 128), generator=g, device="cuda").to(bf)
    t = torch.tensor([500.0], device="cuda")
    guid = torch.tensor([3.5], device="cuda")
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    for label, kw in (("FLUX.1-dev sweep (4608 tokens)", {}),
                      ("FLUX.1-dev EliGen sweep (5632 tokens, 2 regions)",
                       dict(entity_prompt_emb=ent, entity_masks=masks))):
        with torch.no_grad():
            def sweep():
                return flux_dit_forward(dit, dit_cfg, lat, t, emb, pooled, guid, **kw)

            sweep()
            torch.cuda.synchronize()
            with torch.profiler.profile(activities=acts) as prof:
                t1 = time.perf_counter()
                sweep()
                torch.cuda.synchronize()
                wall = time.perf_counter() - t1
        device_table(prof, wall, "profiled " + label, 14)
    del pipe, dit, t5, clip, vae
    torch.cuda.empty_cache()
    return total


TRAIN_PER_STEP = {"ln_modulate": 180, "rms_rope_heads_major": 180, "flash_bounded": 60,
                  "flash_small_kv": 60, "flash_fwd": 0, "flash_fwd_lse": 60,
                  "flash_bwd_dq": 60, "flash_bwd_dkv": 60, "rms_rope_per_head": 0,
                  "rms_rope_joint": 0, "flash_bias": 0, "rms_modulate": 0, "vae_rms_silu": 0,
                  "flash_small_kv_max": 0, "flash_small_kv_masked": 0, "flash_fwd_d64": 0}


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
            device_table(prof, dt, f"{label} under torch.profiler", 24)
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


class SeededTokenizer:
    """Stands in for the UMT5 tokenizer, whose files the card lacks: every
    prompt gives the same seeded ids and mask."""

    def __init__(self, ids, mask):
        self.ids, self.mask = ids, mask

    def __call__(self, prompt, return_mask=False):
        return (self.ids, self.mask) if return_mask else self.ids


def times(per, n):
    """A launch-count dict ``per`` times ``n``."""
    return {k: v * n for k, v in per.items()}


def train_surface_phase(pipe, serving_per_request, vae_cfg):
    """The training surface as ``python -m fairygen_tpu_torch.examples.
    wan_train`` runs it, at full width (480x832x81 frames, S = 8190, LoRA r
    32), each part with its wall, peak device memory and exact launches:

    1. data_process: a seeded 81-frame clip (HWC uint8 frames in memory,
       no PIL) through ``launch_data_process_task`` with the CLI twin's
       collate: the streamed VAE38 encode (K11 in each of its 21 chunks)
       and UMT5 on the flagship's seeded ids, cached as one ``.npz``;
    2. two-phase training from that cache: ``UnifiedDataset(metadata_path=
       None)`` -> ``launch_training_task`` (``PrefetchLoader``, one worker,
       shuffled): two stage-1 steps saved by ``ModelLogger(remove_prefix_
       in_ckpt="pipe.dit.")``, two stage-2 steps from that file (only B2
       moves), the ``merge_weights`` twin, and one 17-frame 4-step request
       with the merged adapter fused (the serving launch counts);
    3. resume: two steps, ``save_train_state``, a fresh state restored, one
       step, against three straight steps: the adapters bit for bit;
    4. one direct_distill step: a 4-step student rollout at S = 8190 with
       gradients through all four sweeps;
    5. one trajectory step at 17 frames (S = 1950): a 50-step teacher
       rollout and 4 student sweeps;
    6. one stage-1 step each with AdamW and remat=True, with Adafactor, and
       with AdamW and remat="offload" (the peaks side by side).
    Returns the phase's launches."""
    import functools
    import tempfile

    import numpy as np
    import torch

    from fairygen_tpu_torch.core.io import load_state_dict
    from fairygen_tpu_torch.data import UnifiedDataset
    from fairygen_tpu_torch.examples import merge_weights
    from fairygen_tpu_torch.examples.wan_train import cached_collate, video_collate
    from fairygen_tpu_torch.models.adapters import (
        add_lora_to_wan_dit, leaves_with_path, lora_trainable_filter, set_lora_weights)
    from fairygen_tpu_torch.ops import _kernels
    from fairygen_tpu_torch.pipelines.wan_video import WanVideoPipeline
    from fairygen_tpu_torch.training import runner
    from fairygen_tpu_torch.training.data_process import launch_data_process_task
    from fairygen_tpu_torch.training.optimizers import make_optimizer
    from fairygen_tpu_torch.training.train_step import (make_wan_distill_train_step,
                                                        make_wan_sft_train_step)

    dit, cfg = pipe.dit_params, pipe.dit_cfg
    total = {k: 0 for k in _kernels.launches}

    def measured(label, fn, want):
        """Run ``fn`` with the counts at 0 and the peak reset; print its
        wall, peak and launches; fail unless the launches are ``want``."""
        _kernels.reset_launches()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t1 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t1
        got = dict(_kernels.launches)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        print(f"  {label}: {dt:.3f} s, max_memory_allocated {peak:.2f} GiB, launches "
              f"{ {k: v for k, v in got.items() if v} }", flush=True)
        want = {k: want.get(k, 0) for k in got}
        if got != want:
            raise RuntimeError(f"{label}: launch counts {got} != expected {want}")
        for k, v in got.items():
            total[k] += v
        return out, dt, peak

    def lora_of(params, leaf):
        return {p: t for p, t in leaves_with_path(params) if "lora" in p and p[-1] == leaf}

    def finite(label, loss):
        if not np.isfinite(float(loss)):
            raise RuntimeError(f"{label}: loss {float(loss)} is not finite")

    tmp = tempfile.TemporaryDirectory(dir=os.path.join(HERE, "build"))
    try:
        # 1. data_process
        cache = os.path.join(tmp.name, "cache")
        ids, mask, _, _ = seeded_prompt(31, pipe.te_cfg.vocab)
        rng = np.random.default_rng(41)
        frames = list(rng.integers(0, 256, (81, 480, 832, 3), dtype=np.uint8))
        tokenizer, pipe.tokenizer = pipe.tokenizer, SeededTokenizer(ids, mask)
        chunks = 1 + (81 - 1) // 4
        try:
            n, dt, _ = measured(
                "data_process (81 frames: streamed VAE38 encode, UMT5, .npz)",
                lambda: launch_data_process_task([{"video": frames, "prompt": "seeded"}],
                                                 video_collate(pipe), cache),
                {"vae_rms_silu": chunks * vae_norm_silu_calls(vae_cfg)[0]})
        finally:
            pipe.tokenizer = tokenizer
        del frames
        path = os.path.join(cache, "0-0.npz")
        with np.load(path) as z:
            shapes = {k: (z[k].shape, str(z[k].dtype)) for k in z.files}
            ok = all(np.isfinite(z[k]).all() for k in z.files)
        print(f"  data_process: {n} file, {os.path.getsize(path) / 2**20:.2f} MiB, {shapes}, "
              f"all finite: {ok}", flush=True)
        if n != 1 or not ok or shapes != {"latents": ((1, 48, 21, 30, 52), "float32"),
                                          "context": ((1, 512, 4096), "float32")}:
            raise RuntimeError("data_process wrote the wrong cache")
        batch = {k: v.cuda() for k, v in
                 cached_collate(UnifiedDataset(base_path=cache, metadata_path=None)[0]).items()}

        # 2. two-phase training from the cache: stages 1 and 2, merge, request
        dataset = UnifiedDataset(base_path=cache, metadata_path=None, repeat=2)
        g = torch.Generator("cuda").manual_seed(2025)
        stage1 = add_lora_to_wan_dit(dit, g, rank=32, alpha=32)
        init, step = make_wan_sft_train_step(
            cfg, make_optimizer("adamw", 1e-4, 0.01), remat=True, first_frame_clean=True,
            trainable_filter=lora_trainable_filter(("A", "B")), lora_b_dropout=("B", 0.8))
        logger1 = runner.ModelLogger(
            os.path.join(tmp.name, "stage1"), remove_prefix_in_ckpt="pipe.dit.",
            state_dict_fn=functools.partial(runner.wan_lora_state_dict, prefix="pipe.dit."))
        saves = {}
        wrap_timed(logger1, "save", saves)
        state, _, _ = measured(
            "stage 1 from the cache (2 steps, PrefetchLoader, ModelLogger)",
            lambda: runner.launch_training_task(init(stage1), step, dataset, cached_collate,
                                                logger=logger1, generator=g, shuffle=True,
                                                num_workers=1, log_every=1),
            times(TRAIN_PER_STEP, 2))
        s1 = os.path.join(tmp.name, "stage1", "epoch-0.safetensors")
        print(f"  stage 1: the checkpoint save {saves['save']:.3f} s, "
              f"{os.path.getsize(s1) / 2**20:.1f} MiB", flush=True)
        sd1 = load_state_dict(s1)
        if state.step != 2 or len(sd1) != 600 or not all(k.startswith("blocks.") for k in sd1):
            raise RuntimeError("stage 1 wrote the wrong checkpoint")
        del state, stage1, step
        torch.cuda.empty_cache()
        stage2 = add_lora_to_wan_dit(dit, g, rank=32, alpha=32, with_b2=True)
        if set_lora_weights(stage2, sd1) != 300:
            raise RuntimeError("the stage-1 file did not fill the 300 stage-2 slots")
        ab = {p: t.clone() for p, t in leaves_with_path(stage2)
              if "lora" in p and p[-1] in ("A", "B")}
        init, step = make_wan_sft_train_step(
            cfg, make_optimizer("adamw", 1e-4, 0.01), remat=True, first_frame_clean=True,
            trainable_filter=lora_trainable_filter(("B2",)), lora_b_dropout=("B2", 0.5))
        logger2 = runner.ModelLogger(os.path.join(tmp.name, "stage2"), async_save=True)
        saves = {}
        wrap_timed(logger2, "save", saves)
        wrap_timed(logger2, "flush", saves)
        state, _, _ = measured(
            "stage 2 from the cache (2 steps, async ModelLogger)",
            lambda: runner.launch_training_task(init(stage2), step, dataset, cached_collate,
                                                logger=logger2, generator=g, shuffle=True,
                                                num_workers=1, log_every=1),
            times(TRAIN_PER_STEP, 2))
        if not all(torch.equal(t, ab[p]) for p, t in leaves_with_path(stage2) if p in ab):
            raise RuntimeError("stage 2 moved A or B")
        if not any(t.abs().sum().item() > 0 for t in lora_of(stage2, "B2").values()):
            raise RuntimeError("no B2 moved in stage 2")
        print(f"  stage 2: A and B unchanged, B2 moved; the async save returned in "
              f"{saves['save']:.3f} s, the write joined in {saves['flush']:.3f} s", flush=True)
        del state, stage2, step, ab
        torch.cuda.empty_cache()
        merged = os.path.join(tmp.name, "merged.safetensors")
        if merge_weights.main(["--stage1", s1, "--stage2",
                               os.path.join(tmp.name, "stage2", "epoch-0.safetensors"),
                               "--output", merged]):
            raise RuntimeError("the merge_weights twin failed")
        pipe2 = WanVideoPipeline(dit, cfg, pipe.vae_params, pipe.vae_cfg, pipe.te_params,
                                 pipe.te_cfg, torch.bfloat16, "cuda").load_lora(merged)
        rids, rmask, nids, nmask = seeded_prompt(23, pipe.te_cfg.vocab)
        video, _, _ = measured(
            "merged-adapter request (17 frames, 4 steps, CFG 5)",
            lambda: pipe2(context=pipe2.encode_ids(rids, rmask),
                          negative_context=pipe2.encode_ids(nids, nmask),
                          input_image=seeded_image(23, 480, 832), seed=23, height=480,
                          width=832, num_frames=17, cfg_scale=5.0, num_inference_steps=4,
                          output_type="floatpoint"),
            serving_per_request)
        if tuple(video.shape) != (1, 3, 17, 480, 832) or not bool(torch.isfinite(video).all()):
            raise RuntimeError("merged-adapter request output has the wrong shape or values")
        del pipe2, video
        torch.cuda.empty_cache()

        # 3. resume against straight through
        def fresh(gen_seed=7):
            """A new stage-1 state (the same adapter init) and generator."""
            params = add_lora_to_wan_dit(dit, torch.Generator("cuda").manual_seed(5), rank=32,
                                         alpha=32)
            return init(params), torch.Generator("cuda").manual_seed(gen_seed)

        init, step = make_wan_sft_train_step(
            cfg, make_optimizer("adamw", 1e-4, 0.01), remat=True, first_frame_clean=True,
            trainable_filter=lora_trainable_filter(("A", "B")), lora_b_dropout=("B", 0.8))

        def run(state, gen, n_steps):
            for _ in range(n_steps):
                state, loss = step(state, batch, gen)
                finite("resume", loss)
            return state

        state, gen = fresh()
        state, _, _ = measured("3 straight stage-1 steps", lambda: run(state, gen, 3),
                               times(TRAIN_PER_STEP, 3))
        straight = [t.detach().clone() for t in state.trainable]
        del state
        torch.cuda.empty_cache()
        ckpt = os.path.join(tmp.name, "state.pt")
        state, gen = fresh()
        state, _, _ = measured("2 stage-1 steps", lambda: run(state, gen, 2),
                               times(TRAIN_PER_STEP, 2))
        t1 = time.perf_counter()
        runner.save_train_state(ckpt, state, gen)
        del state
        torch.cuda.empty_cache()
        state, gen = fresh(gen_seed=99)  # both restored from the file
        state = runner.restore_train_state(ckpt, state, gen)
        print(f"  train state: {os.path.getsize(ckpt) / 2**20:.1f} MiB, saved and restored in "
              f"{time.perf_counter() - t1:.3f} s", flush=True)
        state, _, _ = measured("1 stage-1 step after restore", lambda: run(state, gen, 1),
                               times(TRAIN_PER_STEP, 1))
        diff = max((a - b).abs().max().item() for a, b in zip(state.trainable, straight))
        same = all(torch.equal(a, b) for a, b in zip(state.trainable, straight))
        print(f"  resumed against straight: bit for bit {same}, max abs difference {diff:.3e}",
              flush=True)
        if not same:
            raise RuntimeError("the resumed run differs from the straight run")
        del state, straight
        torch.cuda.empty_cache()

        # 4. direct_distill at S = 8190
        student = add_lora_to_wan_dit(dit, torch.Generator("cuda").manual_seed(6), rank=32,
                                      alpha=32)
        for b in lora_of(student, "B").values():  # a student that is not the base
            b.normal_(generator=g).mul_(1e-3)
        dinit, dstep = make_wan_distill_train_step(
            cfg, make_optimizer("adamw", 1e-4, 0.01), method="direct", num_inference_steps=4,
            remat=True, first_frame_clean=True,
            trainable_filter=lora_trainable_filter(("A", "B")))
        (state, loss), _, _ = measured(
            "direct_distill step (4-step rollout, S = 8190, gradients through all 4)",
            lambda: dstep(dinit(student), batch, g), times(TRAIN_PER_STEP, 4))
        finite("direct_distill", loss)
        print(f"  direct_distill loss {float(loss):.6f}", flush=True)
        del state, loss

        # 5. trajectory at 17 frames (S = 1950), 50 teacher steps
        tinit, tstep = make_wan_distill_train_step(
            cfg, make_optimizer("adamw", 1e-4, 0.01), method="trajectory",
            num_inference_steps=4, num_teacher_steps=50, remat=True, first_frame_clean=True,
            trainable_filter=lora_trainable_filter(("A", "B")))
        small = {"latents": torch.randn((1, 48, 5, 30, 52), generator=g,
                                        device="cuda").to(torch.bfloat16),
                 "context": batch["context"]}
        want = times(TRAIN_PER_STEP, 4)
        for k, v in FLAGSHIP_PER_SWEEP.items():  # a no-grad sweep's, at any S
            want[k] += 50 * v
        (state, loss), _, _ = measured(
            "trajectory step (50 teacher sweeps, 4 student sweeps, S = 1950)",
            lambda: tstep(tinit(student), small, g, teacher_params=dit), want)
        finite("trajectory", loss)
        print(f"  trajectory loss {float(loss):.6f}", flush=True)
        del state, loss, student, small
        torch.cuda.empty_cache()

        # 6. AdamW with remat, Adafactor, offload: one stage-1 step each
        peaks = {}
        for label, opt, remat in (("AdamW, remat=True", "adamw", True),
                                  ("Adafactor, remat=True", "adafactor", True),
                                  ("AdamW, remat='offload'", "adamw", "offload")):
            init, step = make_wan_sft_train_step(
                cfg, make_optimizer(opt, 1e-4, 0.01), remat=remat, first_frame_clean=True,
                trainable_filter=lora_trainable_filter(("A", "B")), lora_b_dropout=("B", 0.8))
            state = init(add_lora_to_wan_dit(dit, torch.Generator("cuda").manual_seed(5),
                                             rank=32, alpha=32))
            (state, loss), _, peaks[label] = measured(f"stage-1 step, {label}",
                                                      lambda: step(state, batch, g),
                                                      times(TRAIN_PER_STEP, 1))
            finite(label, loss)
            del state, loss
            torch.cuda.empty_cache()
        carries = cfg.num_layers * batch["latents"][0, 0].numel() // 4 * cfg.dim * 2 / 2 ** 30
        saved = peaks["AdamW, remat=True"] - peaks["AdamW, remat='offload'"]
        print(f"  offload: the peak {saved:.2f} GiB below remat=True's; the {cfg.num_layers} "
              f"carries are {carries:.2f} GiB", flush=True)
        if saved < carries / 2:
            raise RuntimeError("remat='offload' did not lower the peak by half its carries")
    finally:
        tmp.cleanup()
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


def device_table(prof, wall, label, top, also=()):
    """Device time by kernel name from a torch.profiler run, the device's
    busy share of ``wall`` seconds, the number of kernels the device ran,
    the ``top`` busiest kernels with their shares of the busy time, then
    the other kernels whose names hold a string of ``also``."""
    import torch

    rows = []  # device-side events only: the kernels themselves
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            rows.append((e.self_device_time_total, e.count, e.key))
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows) / 1e6
    print(f"  {label}: wall {wall * 1e3:.2f} ms, device busy {busy * 1e3:.2f} ms "
          f"({100 * busy / wall:.1f}% busy), {sum(r[1] for r in rows)} kernels")
    for i, (dev_us, count, key) in enumerate(rows):
        if i < top or any(a in key for a in also):
            print(f"    {dev_us / 1e3:9.3f} ms {100 * dev_us / 1e6 / busy:5.1f}%  x{count:<5d} "
                  f"{key[:100]}")


FLAGSHIP_PER_SWEEP = {"ln_modulate": 90, "rms_rope_heads_major": 90, "flash_bounded": 30,
                      "flash_small_kv": 30}
# streamed against full-sequence decode, bf16 on the card: the JAX package
# holds the two to 1e-5 in fp32 (tests/test_wan_vae.py, test_streaming_
# matches_full); scaled by bf16's unit roundoff over fp32's, 2^-8 / 2^-24
STREAM_VS_FULL_ATOL = 1e-5 * 2 ** 16
# that max-abs bound is near the size of a pixel in [-1, 1], so the two are
# also held to a relative L2 error over the 17 frames and in the worst
# frame: bf16 rounding through the decoder's 30-odd convolutions, whose
# cuDNN algorithms differ between 1-frame chunks and the whole clip, stays
# near 1e-2; a broken cache hand-off at a chunk seam moves whole frames, a
# relative error near 1 (tests/test_torch_wan_streaming.py,
# test_a_broken_cache_hand_off_breaks_the_card_bounds)
STREAM_VS_FULL_REL_L2 = 2 ** -5
STREAM_VS_FULL_FRAME_REL_L2 = 2 ** -4
# the decode with the plain norm + SiLU chain (or K11 transposed back)
# against the port's: the same bf16 decoder, each norm output within one
# rounding of the other, so the same bound as streamed against full
K11_DECODE_REL_L2 = 2 ** -5


def vae_norm_silu_calls(cfg):
    """K11 launches of one VAE38 encoder pass and one decoder pass: the
    channel norm + SiLU of each residual block (two), of the two middle
    blocks and of the head."""
    stages = len(cfg.dim_mult)
    return stages * cfg.num_res_blocks * 2 + 5, stages * (cfg.num_res_blocks + 1) * 2 + 5


def capture_latents(pipe):
    """Keep the latents of each of the pipeline's decodes: an instance
    attribute over the class's ``_decode_output`` (``del`` it to undo).
    Returns the list they go to."""
    kept = []
    decode = pipe._decode_output

    def keep(latents, **kw):
        kept.append(latents)
        return decode(latents, **kw)

    pipe._decode_output = keep
    return kept


def wrap_timed(pipe, name, walls):
    """Time each call of the pipeline's method ``name`` (host clock around
    synchronised work) into ``walls[name]``; ``del pipe.<name>`` undoes it."""
    import torch

    fn = getattr(pipe, name)

    def run(*args, **kw):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn(*args, **kw)
        torch.cuda.synchronize()
        walls[name] = time.perf_counter() - t
        return out

    setattr(pipe, name, run)


def rel_l2(a, b, dims=None):
    """Relative L2 error of ``a`` against ``b``; with ``dims``, the largest
    over the slices left after summing over ``dims``."""
    d, r = a.float() - b.float(), b.float()
    if dims is None:
        return (d.norm() / r.norm()).item()
    return (d.pow(2).sum(dims).sqrt() / r.pow(2).sum(dims).sqrt()).max().item()


def record_k11_shapes(wvae):
    """Count the shapes the VAE38 hands K11 (through the name its module
    calls); returns (the {shape: calls} dict, a function that undoes it)."""
    shapes, k11 = {}, wvae.fused_vae_rms_silu

    def recorded(x, gamma, silu=True):
        shapes[tuple(x.shape)] = shapes.get(tuple(x.shape), 0) + 1
        return k11(x, gamma, silu)

    wvae.fused_vae_rms_silu = recorded

    def undo():
        wvae.fused_vae_rms_silu = k11

    return shapes, undo


def k11_main_path_checks(shapes):
    """K11 against its plain version at each channel-last shape of the
    main path (bf16, SiLU on, gamma in bf16 as the VAE38's weights), held
    by ``check_bracketed``; with K11's time, its plain version's and its
    bound at each."""
    import torch

    from fairygen_tpu_torch.ops import fused_norms as fn

    g = torch.Generator("cuda").manual_seed(919)
    res = {}
    for shape, calls in sorted(shapes.items()):
        c = shape[-1]
        x = torch.randn(shape, generator=g, device="cuda").to(torch.bfloat16)
        gamma = (1 + 0.3 * torch.randn(c, generator=g, device="cuda")).to(torch.bfloat16)
        rows = x.numel() // c
        out = fn.fused_vae_rms_silu(x, gamma)
        ref = fn.vae_rms_silu_plain(x, gamma)
        tag = "x".join(map(str, shape))
        err, ndiff = check_bracketed(f"K11 at the main path's {tag} ({rows} rows, {calls} calls)",
                                     out, ref, *_k11_bracket(x, gamma, True))
        res[tag] = dict(
            calls=calls, max_abs_err=err, differ=ndiff,
            ms=time_ms(lambda: fn.fused_vae_rms_silu(x, gamma)),
            device_ms=device_ms(lambda: fn.fused_vae_rms_silu(x, gamma), 20),
            plain_ms=time_ms(lambda: fn.vae_rms_silu_plain(x, gamma), 5, 3),
            bound=bound_ms(2 * x.numel() * 2 + c * 2, 10 * x.numel(), H100_FP32_FLOP_PER_S))
        del x, out, ref
    torch.cuda.empty_cache()
    for tag, r in res.items():
        print(f"  K11 main path {tag} x{r['calls']}: ms {r['ms']:.4f} device_ms "
              f"{r['device_ms']:.4f} plain_ms {r['plain_ms']:.4f} bound_ms {r['bound'][0]:.4f} "
              f"({r['bound'][1]})", flush=True)
    total = {key: sum(r["calls"] * (r[key][0] if key == "bound" else r[key])
                      for r in res.values()) for key in ("device_ms", "ms", "bound", "plain_ms")}
    print(f"  K11 over the request's {sum(r['calls'] for r in res.values())} calls: device "
          f"{total['device_ms']:.2f} ms, events {total['ms']:.2f} ms, bound "
          f"{total['bound']:.2f} ms ({total['device_ms'] / total['bound']:.2f}x by device "
          f"time), plain {total['plain_ms']:.2f} ms", flush=True)
    return res


def flagship_phase(pipe, te_cfg, latents17, k8190):
    """The flagship request, 480x832x81 frames, 50 steps, CFG 5, streamed
    decode, as examples/wan_inference.py calls the pipeline (prompt
    embeddings made before, as in the requests phase: the card has no
    tokenizer files).  Then the decode alone and its variants on the
    request's latents, one profiled DiT sweep at S = 8190, and the 17-frame
    latents of the requests phase decoded streamed and full-sequence.
    Returns the request's launches and K11's checks at the shapes it ran."""
    import torch
    import torch.nn.functional as F

    from fairygen_tpu_torch.core.imaging import postprocess_video
    from fairygen_tpu_torch.models.wan import vae as wvae
    from fairygen_tpu_torch.models.wan.dit import precompute_cross_kv, wan_dit_forward
    from fairygen_tpu_torch.models.wan.vae_tiling import vae38_tiled_decode
    from fairygen_tpu_torch.ops import _kernels

    steps, gib = 50, 2 ** 30
    want = {k: FLAGSHIP_PER_SWEEP.get(k, 0) * 2 * steps for k in _kernels.launches}
    enc_norms, dec_norms = vae_norm_silu_calls(pipe.vae_cfg)
    want["vae_rms_silu"] = enc_norms + 21 * dec_norms  # the first frame; 21 decode chunks
    ids, mask, nids, nmask = seeded_prompt(31, te_cfg.vocab)
    ctx, nctx = pipe.encode_ids(ids, mask), pipe.encode_ids(nids, nmask)
    walls = {}
    kept = capture_latents(pipe)
    wrap_timed(pipe, "_denoise", walls)
    k11_shapes, unrecord = record_k11_shapes(wvae)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _kernels.reset_launches()
    try:
        t = time.perf_counter()
        video = pipe(context=ctx, negative_context=nctx, input_image=seeded_image(31, 480, 832),
                     seed=31, height=480, width=832, num_frames=81, cfg_scale=5.0,
                     num_inference_steps=steps, streaming_vae=True, output_type="floatpoint")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    finally:
        unrecord()
    peak = torch.cuda.max_memory_allocated() / gib
    got = dict(_kernels.launches)
    del pipe._denoise, pipe._decode_output
    frames = postprocess_video(video.float().cpu().numpy())
    finite = bool(torch.isfinite(video).all())
    sweeps = walls["_denoise"]
    print(f"  flagship request (480x832x81, {steps} steps, CFG 5, streamed decode): "
          f"{wall:.3f} s; the {2 * steps} DiT sweeps and steps {sweeps:.3f} s "
          f"({sweeps / (2 * steps) * 1e3:.2f} ms a sweep); the rest (first-frame encode, "
          f"cross k/v, decode) {wall - sweeps:.3f} s; max_memory_allocated {peak:.2f} GiB; "
          f"output {tuple(video.shape)} {video.dtype}, all finite: {finite}, "
          f"{len(frames)} frames of {frames[0].shape}; launches {got}", flush=True)
    if (tuple(video.shape) != (1, 3, 81, 480, 832) or not finite or len(frames) != 81
            or frames[0].shape != (480, 832, 3)):
        raise RuntimeError("the flagship request's output has the wrong shape or non-finite "
                           "values")
    if got != want:
        raise RuntimeError(f"flagship launch counts {got} != expected {want}")
    if sum(k11_shapes.values()) != want["vae_rms_silu"]:
        raise RuntimeError(f"K11 calls recorded by shape {k11_shapes} do not add up to "
                           f"{want['vae_rms_silu']}")
    print(f"  K11 shapes of the request (channels-last, calls): {k11_shapes}", flush=True)
    k11_main = k11_main_path_checks(k11_shapes)
    kernel_s = sum(want[k] * (k8190[k].get("device_ms", k8190[k]["ms"])) for k in
                   FLAGSHIP_PER_SWEEP) / 1e3
    print(f"  K1-K4 at their S = 8190 times x launches: {kernel_s:.3f} s, "
          f"{100 * kernel_s / wall:.1f}% of the request, {100 * kernel_s / sweeps:.1f}% "
          "of the sweeps", flush=True)

    lat = kept[0]
    params, cfg = pipe.vae_params, pipe.vae_cfg

    def decode_alone(label, **kw):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t = time.perf_counter()
        out = wvae.vae38_decode(params, cfg, lat, streaming=True, **kw)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t
        top = torch.cuda.max_memory_allocated()
        print(f"  {label}: {dt:.3f} s; max_memory_allocated {top / gib:.2f} GiB, "
              f"{(top - base) / gib:.2f} GiB above the {base / gib:.2f} GiB held before",
              flush=True)
        return out, dt

    with torch.no_grad():
        streamed, dec_s = decode_alone("streamed decode alone, 21 latent frames")
        if not torch.equal(streamed, video):
            print("  (the decode alone differs from the request's in "
                  f"{int((streamed != video).sum())} values)", flush=True)
        t = time.perf_counter()
        tiled = vae38_tiled_decode(params, cfg, lat)
        torch.cuda.synchronize()
        same = torch.equal(tiled, streamed.float())
        print(f"  tiled decode, tile (30, 52) stride (15, 26): one tile, "
              f"{time.perf_counter() - t:.3f} s, bit for bit the streamed decode: {same}",
              flush=True)
        if not same:
            raise RuntimeError("the one-tile tiled decode differs from the streamed decode")

        # the decoder's channel RMS norm + SiLU: the port's (K11, output left
        # channels-last) against the plain chain and K11 transposed back
        ported_norm_silu = wvae._norm_silu

        def plain_chain(gamma, x):
            return F.silu(wvae.vae_rms_norm(x, gamma).float()).to(x.dtype)

        def k11_transposed(gamma, x):
            return ported_norm_silu(gamma, x).contiguous()

        k11 = {}
        try:
            for rep in (1, 2):  # in turns, twice
                for label, fn in (("K11, channels-last (the port's)", ported_norm_silu),
                                  ("plain chain", plain_chain),
                                  ("K11, transposed back", k11_transposed)):
                    wvae._norm_silu = fn
                    out, dt = decode_alone(f"streamed decode, norm + SiLU: {label} (run {rep})")
                    r = k11.setdefault(label, dict(s=[]))
                    r["s"].append(dt)
                    r.update(max_abs_diff=(out.float() - streamed.float()).abs().max().item(),
                             rel_l2=rel_l2(out, streamed))
                    print(f"    against the port's decode: max abs diff {r['max_abs_diff']:.3e}, "
                          f"relative L2 {r['rel_l2']:.3e} (tolerance {K11_DECODE_REL_L2:.4f})",
                          flush=True)
                    if not r["rel_l2"] <= K11_DECODE_REL_L2:
                        raise RuntimeError(f"the decode with {label} disagrees with the port's: "
                                           f"relative L2 {r['rel_l2']:.3e}")
        finally:
            wvae._norm_silu = ported_norm_silu

        # one profiled chunk of the streamed decode (a steady chunk, 1 frame)
        p = params
        shape = (1, -1, 1, 1, 1)
        z = (lat[:, :, :2] * p["latent_std"].to(lat.dtype).reshape(shape)
             + p["latent_mean"].to(lat.dtype).reshape(shape))
        x = wvae.causal_conv3d(p["conv2"], z, wvae.CacheBank("full"), t_pad=0)
        first_fn, step_fn = wvae._chunk_fns("dec")
        _, entries = first_fn(p, cfg, x[:, :, :1])
        step_fn(p, cfg, x[:, :, 1:2], entries)
        torch.cuda.synchronize()
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            t = time.perf_counter()
            step_fn(p, cfg, x[:, :, 1:2], entries)
            torch.cuda.synchronize()
            chunk_wall = time.perf_counter() - t
        device_table(prof, chunk_wall, "profiled decode chunk (1 latent frame -> 4 frames)", 10)

        # one profiled DiT sweep at the flagship's S = 8190
        g = torch.Generator("cuda").manual_seed(31)
        lat_s = torch.randn((1, 48, 21, 30, 52), generator=g, device="cuda").to(torch.bfloat16)
        kv = precompute_cross_kv(pipe.dit_params, pipe.dit_cfg, ctx)
        tt = torch.tensor([500.0], device="cuda")

        def sweep():
            return wan_dit_forward(pipe.dit_params, pipe.dit_cfg, lat_s, tt, cross_kv=kv,
                                   fuse_vae_embedding_in_latents=True)

        sweep()
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=acts) as prof:
            t = time.perf_counter()
            sweep()
            torch.cuda.synchronize()
            sweep_wall = time.perf_counter() - t
        device_table(prof, sweep_wall, "profiled DiT sweep (S=8190)", 12,
                     also=("ln_mod", "rms_rope", "fa_"))

        # the requests phase's 17-frame latents, streamed against full-sequence
        full = wvae.vae38_decode(params, cfg, latents17, clamp=False)
        stream17 = wvae.vae38_decode(params, cfg, latents17, streaming=True, clamp=False)
        err = (stream17.float() - full.float()).abs().max().item()
        rel, rel_frame = rel_l2(stream17, full), rel_l2(stream17, full, (0, 1, 3, 4))
        print(f"  17 frames, streamed against full-sequence decode: max abs diff {err:.3e} "
              f"(tolerance {STREAM_VS_FULL_ATOL:.4f}), relative L2 {rel:.3e} (tolerance "
              f"{STREAM_VS_FULL_REL_L2:.4f}), in the worst frame {rel_frame:.3e} (tolerance "
              f"{STREAM_VS_FULL_FRAME_REL_L2:.4f})", flush=True)
        if not (err <= STREAM_VS_FULL_ATOL and rel <= STREAM_VS_FULL_REL_L2
                and rel_frame <= STREAM_VS_FULL_FRAME_REL_L2):
            raise RuntimeError(f"streamed and full-sequence decode disagree: max abs {err:.3e}, "
                               f"relative L2 {rel:.3e}, worst frame {rel_frame:.3e}")
    print("flagship: " + json.dumps({
        "request_s": wall, "sweeps_s": sweeps, "sweep_ms": sweeps / (2 * steps) * 1e3,
        "peak_gib": peak, "decode_s": dec_s, "k1_k4_s": kernel_s, "k11_ab": k11,
        "decode_chunk_wall_ms": chunk_wall * 1e3, "sweep_wall_ms": sweep_wall * 1e3,
        "stream_vs_full_max_abs": err, "stream_vs_full_rel_l2": rel,
        "stream_vs_full_worst_frame_rel_l2": rel_frame}), flush=True)
    return got, k11_main


def upstream_wan_state_dicts(dit, dit_cfg, vae, vae_cfg, te, te_cfg):
    """Upstream-layout numpy state dicts (what ``from_pretrained`` reads) of
    port param trees, so that the port's converters give the trees back:
    the DiT's and UMT5's dense (in, out) weights transposed to (out, in);
    the VAE38's keys found by running its converter over key indices."""
    import numpy as np
    import torch

    from fairygen_tpu_torch.models.adapters import leaves_with_path
    from fairygen_tpu_torch.models.wan.vae import convert_vae38_state_dict

    def a(t):
        return t.detach().float().cpu().numpy()

    def dense(sd, name, p):
        sd[name + ".weight"] = a(p["w"]).T
        if "b" in p:
            sd[name + ".bias"] = a(p["b"])

    D = dit_cfg.dim
    dsd = {"patch_embedding.weight": a(dit["patch_embed"]["w"]).reshape(
               dit_cfg.in_dim, *dit_cfg.patch_size, D).transpose(4, 0, 1, 2, 3),
           "patch_embedding.bias": a(dit["patch_embed"]["b"]),
           "head.modulation": a(dit["head"]["modulation"]).reshape(1, 2, D)}
    for name, p in (("text_embedding.0", dit["text_embed"]["fc1"]),
                    ("text_embedding.2", dit["text_embed"]["fc2"]),
                    ("time_embedding.0", dit["time_embed"]["fc1"]),
                    ("time_embedding.2", dit["time_embed"]["fc2"]),
                    ("time_projection.1", dit["time_proj"]), ("head.head", dit["head"])):
        dense(dsd, name, p)
    for i, blk in enumerate(dit["blocks"]):
        pre = f"blocks.{i}"
        for sub in ("self_attn", "cross_attn"):
            for k in ("q", "k", "v", "o"):
                dense(dsd, f"{pre}.{sub}.{k}", blk[sub][k])
            for k in ("norm_q", "norm_k"):
                dsd[f"{pre}.{sub}.{k}.weight"] = a(blk[sub][k])
        dsd[f"{pre}.norm3.weight"] = a(blk["norm3"]["w"])
        dsd[f"{pre}.norm3.bias"] = a(blk["norm3"]["b"])
        dense(dsd, f"{pre}.ffn.0", blk["ffn"]["fc1"])
        dense(dsd, f"{pre}.ffn.2", blk["ffn"]["fc2"])
        dsd[f"{pre}.modulation"] = a(blk["modulation"]).reshape(1, 6, D)

    tsd = {"token_embedding.weight": a(te["token_embedding"]), "norm.weight": a(te["norm"])}
    for i, blk in enumerate(te["blocks"]):
        pre = f"blocks.{i}"
        tsd[pre + ".norm1.weight"], tsd[pre + ".norm2.weight"] = a(blk["norm1"]), a(blk["norm2"])
        tsd[pre + ".pos_embedding.embedding.weight"] = a(blk["pos_emb"])
        for k in ("q", "k", "v", "o"):
            tsd[f"{pre}.attn.{k}.weight"] = a(blk["attn"][k]["w"]).T
        for k, name in (("gate", "gate.0"), ("fc1", "fc1"), ("fc2", "fc2")):
            tsd[f"{pre}.ffn.{name}.weight"] = a(blk["ffn"][k]["w"]).T

    class KeyIndex(dict):
        """Hands the converter each key's index as a 0-d array."""

        def __init__(self):
            super().__init__()
            self.names = []

        def __getitem__(self, key):
            self.names.append(key)
            return np.array(float(len(self.names) - 1))

    index = KeyIndex()
    tree = convert_vae38_state_dict(index, vae_cfg, device="cpu")
    ports = dict(leaves_with_path(vae))
    vsd = {}
    for path, leaf in leaves_with_path(tree):
        if path[0] in ("latent_mean", "latent_std"):
            continue
        vsd[index.names[int(leaf.reshape(-1)[0])]] = a(ports[path])
    return dsd, vsd, tsd


def reference_from_pretrained_check():
    """A tiny TI2V pipeline (head dim 128, so every serving kernel runs)
    loaded by ``from_pretrained(hints=...)`` from upstream-layout
    safetensors written in a temporary directory, on the card in bf16 and
    on the CPU in fp32 and bf16, with a seeded rank-4 LoRA hot-loaded, then
    cleared.  Each state's 2-step CFG request (latents) is held to the
    reference phase's bound: the card's relative L2 error to the CPU fp32
    run at most twice the CPU bf16 run's plus 1e-3."""
    import dataclasses
    import tempfile

    import numpy as np
    import torch

    from fairygen_tpu_torch import convert
    from fairygen_tpu_torch.core.io import save_safetensors
    from fairygen_tpu_torch.models.wan.dit import WanDiTConfig
    from fairygen_tpu_torch.models.wan.text_encoder import UMT5Config
    from fairygen_tpu_torch.models.wan.vae import WanVAEConfig
    from fairygen_tpu_torch.ops import _kernels
    from fairygen_tpu_torch.pipelines.wan_video import WanVideoPipeline

    dit_cfg = WanDiTConfig(dim=256, in_dim=4, ffn_dim=512, out_dim=4, text_dim=64, freq_dim=64,
                           num_heads=2, num_layers=2, seperated_timestep=True,
                           require_vae_embedding=False, require_clip_embedding=False,
                           fuse_vae_embedding_in_latents=True)
    vae_cfg, te_cfg = WanVAEConfig.tiny(), UMT5Config.tiny(dim=64, dim_attn=64)
    f32 = torch.float32
    sds = upstream_wan_state_dicts(
        convert.init_dit_params(dit_cfg, "cpu", f32, seed=8), dit_cfg,
        convert.init_vae_params(vae_cfg, "cpu", f32, seed=9), vae_cfg,
        convert.init_umt5_params(te_cfg, "cpu", f32, seed=10), te_cfg)
    rng = np.random.default_rng(11)
    lora = {}
    for i in range(2):
        for layer, (d_in, d_out) in (("self_attn.q", (256, 256)), ("cross_attn.o", (256, 256)),
                                     ("ffn.0", (256, 512))):
            pre = f"blocks.{i}.{layer}"
            lora[pre + ".lora_A.default.weight"] = (0.05 * rng.standard_normal((4, d_in))
                                                    ).astype(np.float32)
            lora[pre + ".lora_B.default.weight"] = (0.05 * rng.standard_normal((d_out, 4))
                                                    ).astype(np.float32)
    g = torch.Generator("cpu").manual_seed(12)
    ids = torch.randint(2, te_cfg.vocab, (1, 24), generator=g)
    mask = torch.ones((1, 24), dtype=torch.long)
    nids, nmask = torch.zeros_like(ids), torch.zeros_like(mask)
    nids[0, 0], nmask[0, 0] = 1, 1
    kw = dict(input_image=seeded_image(13, 512, 512), seed=14, height=512, width=512,
              num_frames=17, cfg_scale=5.0, num_inference_steps=2, output_type="latents",
              torch_compat_noise=True)
    with tempfile.TemporaryDirectory() as tmp:
        hints = {}
        for (name, cfg), sd in zip((("wan_video_dit", dit_cfg), ("wan_video_vae", vae_cfg),
                                    ("wan_video_text_encoder", te_cfg)), sds):
            path = os.path.join(tmp, name + ".safetensors")
            save_safetensors(path, sd)
            hints[path] = (name, dataclasses.asdict(cfg))
        pipes = {(dev, dt): WanVideoPipeline.from_pretrained(list(hints), dtype=dt, hints=hints,
                                                             device=dev)
                 for dev, dt in (("cpu", f32), ("cpu", torch.bfloat16),
                                 ("cuda", torch.bfloat16))}
    outs = {}
    for stage in ("hot LoRA", "cleared"):
        for pipe in pipes.values():
            if stage == "hot LoRA":
                pipe.load_lora(lora, alpha=0.8, hotload=True)
            else:
                pipe.clear_lora()
        res = {}
        for (dev, dt), pipe in pipes.items():
            before = dict(_kernels.launches)
            res[dev, dt] = pipe(context=pipe.encode_ids(ids, mask),
                                negative_context=pipe.encode_ids(nids, nmask), **kw).float().cpu()
            if dev == "cuda":
                ran = {k: _kernels.launches[k] - before[k] for k in before}
        ref = res["cpu", f32]
        rel = rel_l2(res["cuda", torch.bfloat16], ref)
        rel16 = rel_l2(res["cpu", torch.bfloat16], ref)
        tol = 2 * rel16 + 1e-3
        print(f"  from_pretrained tiny pipeline, {stage}: relative L2 error to CPU fp32 "
              f"{rel:.4e} (card bf16), {rel16:.4e} (CPU bf16); tolerance {tol:.4e}; kernel "
              f"launches {ran}", flush=True)
        if not all(ran[k] for k in FLAGSHIP_PER_SWEEP):
            raise RuntimeError(f"a kernel did not run in the from_pretrained pipeline: {ran}")
        if not rel <= tol:
            raise RuntimeError(f"the from_pretrained pipeline ({stage}) disagrees with the CPU "
                               f"reference: {rel:.4e}")
        outs[stage] = ref
    moved = rel_l2(outs["hot LoRA"], outs["cleared"])
    print(f"  the hot LoRA moved the CPU fp32 latents by a relative L2 of {moved:.4e}", flush=True)
    if not moved > 1e-3:
        raise RuntimeError("the hot LoRA did not change the request")


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


def reference_flux_check():
    """A tiny head-dim-128 FLUX.1 DiT (dim 256, 2 heads, 2 + 2 blocks), with
    and without EliGen regions, on the card in bf16 (K1, K8, K7, K3/K4, or
    K10) against the same weights and inputs on the CPU in fp32 and in bf16
    (plain versions).  As the Wan check: the card's relative L2 error to
    the CPU fp32 output must be at most twice the CPU bf16 run's + 1e-3."""
    import torch

    from fairygen_tpu_torch import convert
    from fairygen_tpu_torch.models.flux.dit import FluxDiTConfig, flux_dit_forward
    from fairygen_tpu_torch.ops import _kernels

    cfg = FluxDiTConfig(dim=256, num_heads=2, context_dim=64, pooled_dim=32,
                        num_double_blocks=2, num_single_blocks=2)
    params = convert.init_flux_dit_params(cfg, "cpu", torch.float32, seed=50)
    g = torch.Generator("cpu").manual_seed(51)
    # 48 x 48 latents: 576 image tokens; 64 text tokens (K8 buffer 1024 +
    # 1024 rows with an image gap, so K3; the single blocks' 640 tokens fit
    # one k tile, so K4)
    inputs = (torch.randn(1, 16, 48, 48, generator=g), torch.tensor([700.0]),
              torch.randn(1, 64, 64, generator=g), torch.randn(1, 32, generator=g),
              torch.tensor([3.5]))
    masks = torch.zeros((1, 2, 1, 48, 48))
    masks[:, 0, :, 4:30, 2:20] = 1
    masks[:, 1, :, 20:46, 16:44] = 1
    eligen = dict(entity_prompt_emb=torch.randn(1, 2, 64, 64, generator=g), entity_masks=masks)
    for label, kw, kernels in (("plain", {}, ("ln_modulate", "rms_rope_joint",
                                               "rms_rope_per_head", "flash_bounded",
                                               "flash_small_kv")),
                               ("EliGen", eligen, ("ln_modulate", "flash_bias"))):
        def run(dev, dt):
            lat, t, emb, pooled, guid = inputs
            # the timestep and guidance stay fp32, as the pipeline passes them
            with torch.no_grad():
                out = flux_dit_forward(to(params, dev, dt), cfg, lat.to(dev, dt), t.to(dev),
                                       emb.to(dev, dt), pooled.to(dev, dt), guid.to(dev),
                                       **{k: v.to(dev, dt) for k, v in kw.items()})
            return out.float().cpu()

        ref = run("cpu", torch.float32)
        rel16 = ((run("cpu", torch.bfloat16) - ref).norm() / ref.norm()).item()
        _kernels.reset_launches()
        out = run("cuda", torch.bfloat16)
        ran = {k: v for k, v in _kernels.launches.items() if v}
        rel = ((out - ref).norm() / ref.norm()).item()
        tol = 2 * rel16 + 1e-3
        print(f"  tiny FLUX.1 DiT {label} {tuple(out.shape)}: relative L2 error to CPU fp32 "
              f"{rel:.4e} (card bf16), {rel16:.4e} (CPU bf16); tolerance {tol:.4e}; kernel "
              f"launches {ran}", flush=True)
        if set(ran) != set(kernels):
            raise RuntimeError(f"tiny FLUX.1 DiT {label}: kernels {sorted(ran)} != {kernels}")
        if not rel <= tol:
            raise RuntimeError(f"tiny FLUX.1 DiT {label} disagrees with the CPU reference")


def _k9_bracket(x, w, sc, eps):
    """The plain K9 formula with its fp32 row statistic moved by -2^-14 and
    +2^-14 (relative): (low, high) elementwise."""
    xf = x.float()
    r = xf.pow(2).mean(-1, keepdim=True).add(eps).rsqrt()
    outs = []
    for f in (1 - 2 ** -14, 1 + 2 ** -14):
        y = (xf * (r * f)).to(x.dtype) * w.to(x.dtype)
        if sc is not None:
            y = y * sc.reshape(sc.shape[0], 1, -1).to(x.dtype)
        outs.append(y.float())
    return outs[0].minimum(outs[1]), outs[0].maximum(outs[1])


def _k11_bracket(x, gamma, silu):
    """The plain K11 formula with the fp32 row norm moved by -2^-14 and
    +2^-14 (relative): (low, high) elementwise, widened by a few fp32 ulps
    for fp32 SiLU outputs."""
    import torch
    import torch.nn.functional as F

    xf = x.float()
    n = (xf * xf).sum(-1, keepdim=True).sqrt()
    outs = []
    for f in (1 - 2 ** -14, 1 + 2 ** -14):
        y = (xf / (n * f).clamp_min(1e-12) * (x.shape[-1] ** 0.5) * gamma.float()).to(x.dtype)
        if silu:
            y = F.silu(y.float()).to(x.dtype)
        outs.append(y.float())
    lo, hi = outs[0].minimum(outs[1]), outs[0].maximum(outs[1])
    if silu and x.dtype == torch.float32:
        # where SiLU's slope vanishes its fp32 rounding is not monotone: 2^-21
        # (a few fp32 ulps) of slack
        lo, hi = lo - 2 ** -21 * lo.abs(), hi + 2 ** -21 * hi.abs()
    return lo, hi


def check_bracketed(name, out, ref, lo, hi):
    """K9/K11 sum a row's squares in another order than PyTorch's reduction
    and otherwise round where the plain version rounds; each output is
    monotone in the row statistic, so it must lie between the plain formula
    with that statistic moved by -2^-14 and +2^-14 (relative), far more than
    a summation order moves it and far less than one bf16 ulp.  Prints how
    many outputs differ from the plain version at all."""
    o, r = out.float(), ref.float()
    inside = bool(((lo <= o) & (o <= hi)).all()) and bool(((lo <= r) & (r <= hi)).all())
    err = (o - r).abs()
    ndiff = int((o != r).sum())
    print(f"  {name}: {ndiff} of {o.numel()} outputs differ from the plain version, "
          f"max_abs_err {err.max().item():.3e}; all inside the plain formula at the "
          f"statistic x (1 -/+ 2^-14): {inside}", flush=True)
    if not inside:
        raise RuntimeError(f"{name} disagrees with its plain version")
    return err.max().item(), ndiff


def norm_kernel_checks():
    """K9 and K11 against their plain versions on the card.  K9 at the
    Z-Image-Turbo 1024x1024 shapes (dim 3840): the unified stream (4416
    tokens), the noise refiner (4096) and the caption refiner (320), each
    with and without the (1, 1, 3840) scale.  K11 at two VAE38 shapes: one
    4-frame chunk of the decoder's last stage at 480x832 (399,360 rows of
    256 channels) and the mid block of a 17-frame 480x832 decode (7800 rows
    of 1024), with and without SiLU.  Bounds: bytes (x read and out written
    once, plus the weight and scale rows); the operations, a few fp32 flops
    per element, take far less at the card's 67 TFLOP/s fp32 rate.  The
    yardstick is torch.nn.functional.rms_norm at the same shape for the
    forms it computes: K9 without scale, and K11 without SiLU (with eps
    1e-12, as close as one call comes to F.normalize's max(|x|, 1e-12)):
    their eps and rounding differ from the kernels'.  The forms with scale
    or SiLU have no one-call counterpart."""
    import torch
    import torch.nn.functional as F

    from fairygen_tpu_torch.ops import fused_norms as fn

    dev, bf = "cuda", torch.bfloat16
    g = torch.Generator(dev).manual_seed(909)
    res = {"rms_modulate": {}, "vae_rms_silu": {}}

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=g, device=dev) * scale).to(bf)

    D = 3840
    w = (1 + randn(D, scale=0.3))
    sc = (1 + randn(1, 1, D, scale=0.3))
    for s in (4416, 4096, 320):
        x = randn(1, s, D)
        for tag, scale in (("no-scale", None), ("scale", sc)):
            out = fn.fused_rms_modulate(x, w, scale, 1e-5)
            ref = fn.rms_modulate_plain(x, w, scale, 1e-5)
            err, ndiff = check_bracketed(f"K9 rms_modulate S={s} {tag}", out, ref,
                                         *_k9_bracket(x, w, scale, 1e-5))
            nbytes = 2 * s * D * 2 + D * 2 + (0 if scale is None else D * 2)
            res["rms_modulate"][(s, tag)] = dict(
                max_abs_err=err, differ=ndiff,
                ms=time_ms(lambda: fn.fused_rms_modulate(x, w, scale, 1e-5)),
                device_ms=device_ms(lambda: fn.fused_rms_modulate(x, w, scale, 1e-5)),
                plain_ms=time_ms(lambda: fn.rms_modulate_plain(x, w, scale, 1e-5), 5, 3),
                bound=bound_ms(nbytes, 5 * s * D, H100_FP32_FLOP_PER_S),
                library_ms=None if scale is not None else time_ms(
                    lambda: F.rms_norm(x, (D,), w, 1e-5)))
        del x, out, ref
    for rows, c in ((399360, 256), (7800, 1024)):
        x = randn(rows, c)
        gamma = 1 + randn(c, scale=0.3)
        for silu in (False, True):
            tag = "silu" if silu else "no-silu"
            out = fn.fused_vae_rms_silu(x, gamma, silu)
            ref = fn.vae_rms_silu_plain(x, gamma, silu)
            err, ndiff = check_bracketed(f"K11 vae_rms_silu {rows}x{c} {tag}", out, ref,
                                         *_k11_bracket(x, gamma, silu))
            res["vae_rms_silu"][(rows, tag)] = dict(
                max_abs_err=err, differ=ndiff,
                ms=time_ms(lambda: fn.fused_vae_rms_silu(x, gamma, silu)),
                device_ms=device_ms(lambda: fn.fused_vae_rms_silu(x, gamma, silu)),
                plain_ms=time_ms(lambda: fn.vae_rms_silu_plain(x, gamma, silu), 5, 3),
                bound=bound_ms(2 * rows * c * 2 + c * 2, (10 if silu else 6) * rows * c,
                               H100_FP32_FLOP_PER_S),
                library_ms=None if silu else time_ms(
                    lambda: F.rms_norm(x, (c,), gamma, 1e-12)))
        del x, out, ref
    for k, shapes in res.items():
        for (n, tag), r in shapes.items():
            lib = "none" if r["library_ms"] is None else f"{r['library_ms']:.4f}"
            print(f"  {k} rows={n} {tag}: ms {r['ms']:.4f} device_ms {r['device_ms']:.4f} "
                  f"plain_ms {r['plain_ms']:.4f} "
                  f"bound_ms {r['bound'][0]:.4f} ({r['bound'][1]}) library_ms {lib}", flush=True)
    torch.cuda.empty_cache()
    return res


ZIMAGE_STEPS = 8
ZIMAGE_PROMPT_IDS = 300
ZIMAGE_NEG_IDS = 64


def zimage_per_sweep(cap_ids, img_tokens=4096, refiner=2, layers=30):
    """Launches of one Z-Image DiT sweep at head dim 128 and dim 3840 (a
    multiple of 128), from the gates of the code: the caption pads to a
    multiple of 32; every block runs K7 twice (q, k), one attention and
    four sandwich norms, which go to K9 when the stream has >= 256 rows;
    the attention pads its stream to a multiple of 1024 and takes K4 when
    that is one k tile of 1024, K3 otherwise.  Streams: the noise refiner
    over the image, the caption refiner over the caption, the unified
    blocks over both."""
    cap = -(-cap_ids // 32) * 32
    counts = {"rms_modulate": 0, "rms_rope_per_head": 0, "flash_bounded": 0,
              "flash_small_kv": 0}
    for rows, blocks in ((img_tokens, refiner), (cap, refiner), (img_tokens + cap, layers)):
        counts["rms_modulate"] += 4 * blocks if rows >= 256 else 0
        counts["rms_rope_per_head"] += 2 * blocks
        one_tile = max(-(-rows // 1024) * 1024, 512) == 1024
        counts["flash_small_kv" if one_tile else "flash_bounded"] += blocks
    return counts


def zimage_phase():
    """Z-Image-Turbo at full width and depth on the card: the DiT (dim 3840,
    30 heads, 2 + 2 refiner and 30 unified blocks), Qwen3-4B (36 layers, of
    which the pipeline runs 35) and the FLUX AutoencoderKL from seeded bf16
    weights; a seeded 300-id prompt through ``encode_ids``; two 1024x1024
    requests at the Turbo defaults (8 steps, cfg_scale 1) and one
    image-to-image request (a seeded 1024x1024 image, strength 0.6,
    cfg_scale 2 with a seeded 64-id negative prompt), each with exact
    launch counts of K9, K7, K3 and K4; then one sweep under torch.profiler.
    Returns the launches of the three requests."""
    import torch

    from fairygen_tpu_torch import convert
    from fairygen_tpu_torch.models.qwen.text_encoder import QwenVLTextConfig
    from fairygen_tpu_torch.models.sdxl.vae import AutoencoderKLConfig
    from fairygen_tpu_torch.models.z_image.dit import ZImageDiTConfig, z_image_dit_forward
    from fairygen_tpu_torch.ops import _kernels
    from fairygen_tpu_torch.pipelines.z_image import ZImagePipeline

    bf = torch.bfloat16
    torch.cuda.reset_peak_memory_stats()
    t1 = time.perf_counter()
    dit_cfg, te_cfg = ZImageDiTConfig.z_image(), QwenVLTextConfig.qwen3_4b()
    vae_cfg = AutoencoderKLConfig.flux()
    dit = convert.init_z_image_dit_params(dit_cfg, "cuda", bf, seed=60)
    te = convert.init_qwen_text_params(te_cfg, "cuda", bf, seed=61)
    vae = convert.init_autoencoder_kl_params(vae_cfg, "cuda", bf, seed=62)
    torch.cuda.synchronize()
    print(f"  Z-Image-Turbo weights in {time.perf_counter() - t1:.3f} s: DiT "
          f"{convert.count_params(dit):,} Qwen3-4B {convert.count_params(te):,} VAE "
          f"{convert.count_params(vae):,}; max_memory_allocated "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    pipe = ZImagePipeline(dit, dit_cfg, vae, vae_cfg, te, te_cfg, bf, "cuda")

    def ids(seed, n):
        gen = torch.Generator("cpu").manual_seed(seed)
        return torch.randint(0, te_cfg.vocab, (1, n), generator=gen)

    prompt_ids, neg_ids = ids(70, ZIMAGE_PROMPT_IDS), ids(71, ZIMAGE_NEG_IDS)
    for label in ("first", "warm"):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        emb = pipe.encode_ids(prompt_ids)
        torch.cuda.synchronize()
        print(f"  Qwen3-4B encode of {ZIMAGE_PROMPT_IDS} ids ({label}): "
              f"{(time.perf_counter() - t1) * 1e3:.2f} ms, output {tuple(emb.shape)} "
              f"{emb.dtype}, all finite: {bool(torch.isfinite(emb).all())}", flush=True)
    if tuple(emb.shape) != (1, ZIMAGE_PROMPT_IDS, 2560) or not torch.isfinite(emb).all():
        raise RuntimeError("the prompt embedding has the wrong shape or non-finite values")
    neg = pipe.encode_ids(neg_ids)

    total = {k: 0 for k in _kernels.launches}

    def request(label, want, **kw):
        want = {k: want.get(k, 0) for k in _kernels.launches}
        _kernels.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        img = pipe(height=1024, width=1024, num_inference_steps=ZIMAGE_STEPS,
                   output_type="floatpoint", **kw)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t1
        got = dict(_kernels.launches)
        finite = bool(torch.isfinite(img).all())
        print(f"  {label}: {dt:.3f} s, output {tuple(img.shape)} {img.dtype}, all finite: "
              f"{finite}, std {img.float().std().item():.4f}, max_memory_allocated "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, launches "
              f"{ {k: v for k, v in got.items() if v} }", flush=True)
        if tuple(img.shape) != (1, 3, 1024, 1024) or not finite:
            raise RuntimeError(f"{label}: output has the wrong shape or non-finite values")
        if got != want:
            raise RuntimeError(f"{label}: launch counts {got} != expected {want}")
        for k, v in got.items():
            total[k] += v

    pos = zimage_per_sweep(ZIMAGE_PROMPT_IDS)
    negs = zimage_per_sweep(ZIMAGE_NEG_IDS)
    print(f"  expected launches per sweep: prompt {pos}, negative prompt {negs}", flush=True)
    t2i = {k: v * ZIMAGE_STEPS for k, v in pos.items()}
    for seed in (21, 22):
        request(f"Z-Image-Turbo request seed={seed}", t2i, prompt_emb=emb, seed=seed)
    request("Z-Image-Turbo img2img request (strength 0.6, cfg 2)",
            {k: (pos[k] + negs[k]) * ZIMAGE_STEPS for k in pos}, prompt_emb=emb,
            negative_prompt_emb=neg, cfg_scale=2.0, input_image=seeded_image(23, 1024, 1024),
            denoising_strength=0.6, seed=23)

    # where a sweep's time goes
    g = torch.Generator("cuda").manual_seed(72)
    lat = torch.randn((1, 16, 128, 128), generator=g, device="cuda").to(bf)
    t = torch.tensor([0.5], device="cuda")
    with torch.no_grad():
        def sweep():
            return z_image_dit_forward(dit, dit_cfg, lat, t, emb)

        sweep()
        torch.cuda.synchronize()
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            t1 = time.perf_counter()
            sweep()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t1
    device_table(prof, wall, "profiled Z-Image-Turbo sweep (4096 image + 320 caption tokens)",
                 14)
    del pipe, dit, te, vae, emb, neg, lat
    torch.cuda.empty_cache()
    return total


def reference_zimage_check():
    """A tiny head-dim-128 Z-Image DiT (dim 256, 2 heads, 1 + 1 refiner and
    2 unified blocks) and a tiny Qwen3 encoder (head dim 128, GQA 4/2, q/k
    norms) on the card in bf16 against the same weights and inputs on the
    CPU in fp32 and in bf16 (plain versions).  A 64x64 latent gives 1024
    image tokens (K9; K7; K4 at s_pad 1024), 40 caption tokens pad to 64
    (the plain norm formula; K7; K4), the unified 1088 tokens K9, K7 and K3
    (s_pad 2048).  As the FLUX check: the card's relative L2 error to the
    CPU fp32 output must be at most twice the CPU bf16 run's + 1e-3."""
    import torch

    from fairygen_tpu_torch import convert
    from fairygen_tpu_torch.models.qwen.text_encoder import (QwenVLTextConfig,
                                                             qwen_vl_text_encode)
    from fairygen_tpu_torch.models.z_image.dit import ZImageDiTConfig, z_image_dit_forward
    from fairygen_tpu_torch.ops import _kernels

    cfg = ZImageDiTConfig(dim=256, num_heads=2, cap_feat_dim=64, num_layers=2,
                          num_refiner_layers=1)
    params = convert.init_z_image_dit_params(cfg, "cpu", torch.float32, seed=80)
    g = torch.Generator("cpu").manual_seed(81)
    lat, cap = torch.randn(1, 16, 64, 64, generator=g), torch.randn(1, 40, 64, generator=g)
    t = torch.tensor([0.37])

    def run(dev, dt):
        # the timestep stays fp32, as the pipeline passes it
        with torch.no_grad():
            out = z_image_dit_forward(to(params, dev, dt), cfg, lat.to(dev, dt), t.to(dev),
                                      cap.to(dev, dt))
        return out.float().cpu()

    ref = run("cpu", torch.float32)
    rel16 = ((run("cpu", torch.bfloat16) - ref).norm() / ref.norm()).item()
    _kernels.reset_launches()
    out = run("cuda", torch.bfloat16)
    ran = {k: v for k, v in _kernels.launches.items() if v}
    rel = ((out - ref).norm() / ref.norm()).item()
    tol = 2 * rel16 + 1e-3
    print(f"  tiny Z-Image DiT {tuple(out.shape)}: relative L2 error to CPU fp32 {rel:.4e} "
          f"(card bf16), {rel16:.4e} (CPU bf16); tolerance {tol:.4e}; kernel launches {ran}",
          flush=True)
    want = {"rms_modulate": 4 * 3, "rms_rope_per_head": 2 * 4, "flash_small_kv": 2,
            "flash_bounded": 2}
    if ran != want:
        raise RuntimeError(f"tiny Z-Image DiT: kernel launches {ran} != {want}")
    if not rel <= tol:
        raise RuntimeError("tiny Z-Image DiT disagrees with the CPU reference")

    qcfg = QwenVLTextConfig.tiny(vocab=1000, dim=256, num_layers=3, num_heads=4, num_kv_heads=2,
                                 ffn_dim=512, head_dim_override=128, qk_norm=True,
                                 attn_bias=False)
    qparams = convert.init_qwen_text_params(qcfg, "cpu", torch.float32, seed=82)
    ids = torch.randint(0, qcfg.vocab, (1, 50), generator=g)

    def encode(dev, dt):
        with torch.no_grad():
            return qwen_vl_text_encode(to(qparams, dev, dt), qcfg, ids.to(dev),
                                       hidden_state_index=-2).float().cpu()

    ref = encode("cpu", torch.float32)
    rel16 = ((encode("cpu", torch.bfloat16) - ref).norm() / ref.norm()).item()
    rel = ((encode("cuda", torch.bfloat16) - ref).norm() / ref.norm()).item()
    tol = 2 * rel16 + 1e-3
    print(f"  tiny Qwen3 encoder (50 ids, penultimate state): relative L2 error to CPU fp32 "
          f"{rel:.4e} (card bf16), {rel16:.4e} (CPU bf16); tolerance {tol:.4e}", flush=True)
    if not rel <= tol:
        raise RuntimeError("tiny Qwen3 encoder disagrees with the CPU reference")



SDXL_STEPS = 50
# per BrushNet + UNet step at 1024x1024, CFG batch 2 (checked on the CPU by
# tests/test_torch_sdxl_kernels.py with the real block structure): the 10
# transformer blocks at 64 x 64 latents (4096 tokens) self-attend through
# K5; the 60 at 32 x 32 (1024 tokens, one k tile) and BrushNet's mid
# attention through K4's max form; all 70 cross-attend to 77 text tokens
# (one k tile of 128) through K4's masked form
SDXL_PER_STEP = {"flash_fwd_d64": 10, "flash_small_kv_max": 61, "flash_small_kv_masked": 70}


def sdxl_kernel_checks():
    """K4's max and masked forms and K5 at head dim 64 against their plain
    versions on the card in bf16 at the SDXL 1024x1024 CFG shapes (BN = 2 x
    heads): cross-attention of 2 x 10 heads x 4096 queries and 2 x 20 x 1024
    queries to 77 text keys (padded to 128: the masked form), self-attention
    of 2 x 20 x 1024 (the max form), K5 over 2 x 10 x 4096; then K4 at head
    dim 128 (24 x 2048 queries, 512 keys), the masked form with a kv_len of
    250 of 320 keys whose cut rows are non-zero, and the max form at 192
    keys (its second 128-key box reads 64 zero rows, which must not count).
    Tolerances: K4 rounds p against the same row max as its plain version,
    so 2^-7 relative + 1e-3 absolute (K3/K4's), and its o is held to a
    relative L2 error below 2^-10, which a kernel rounding p against a
    running max exceeds (tests/test_torch_small_kv_tiles.py); K5 rounds p
    against its key tile's running max, so 2^-7 relative + 2^-8 absolute
    (as at head dim 128).
    Bounds count 4 x BN x Sq x Sk x d flops on the unpadded lengths (989
    TFLOP/s) and q, k, v read and o written once (3.35 TB/s).  The library
    yardstick is F.scaled_dot_product_attention on the unpadded heads
    (scale ln 2: q carries hd^-1/2 x log2 e), timed here only."""
    import torch
    import torch.nn.functional as F

    from fairygen_tpu_torch.ops import _kernels
    from fairygen_tpu_torch.ops import flash_attention as fa

    g = torch.Generator("cuda").manual_seed(777)
    ln2 = 0.6931471805599453
    res = {}

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=g, device="cuda") * scale).to(torch.bfloat16)

    cases = [  # (counter, tag, BN, Sq, Sk_pad, sk_actual, d)
        ("flash_small_kv_masked", "cross 20x4096 q, 77 keys", 20, 4096, 128, 77, 64),
        ("flash_small_kv_masked", "cross 40x1024 q, 77 keys", 40, 1024, 128, 77, 64),
        ("flash_small_kv_max", "self 40x1024", 40, 1024, 1024, 1024, 64),
        ("flash_fwd_d64", "self 20x4096", 20, 4096, 4096, 4096, 64),
        ("flash_small_kv_max", "d128 24x2048 q, 512 keys", 24, 2048, 512, 512, 128),
        ("flash_small_kv_masked", "kv_len 250 of 320 non-zero keys", 20, 4096, 320, 250, 64),
        ("flash_small_kv_max", "max form, 192 keys", 40, 1024, 192, 192, 64),
    ]
    for name, tag, bn, sq, skp, ska, d in cases:
        qh = randn(bn, sq, d, scale=d ** -0.5 * 1.4426950408889634)
        kh, vh = randn(bn, skp, d), randn(bn, skp, d)
        if name == "flash_fwd_d64":
            def kern():
                return fa.flash_fwd(qh, kh, vh, sk_actual=ska, with_lse=False)

            def plain():
                return fa.flash_fwd_plain(qh, kh, vh, sk_actual=ska, with_lse=False)
            rtol, atol = 2 ** -7, 2 ** -8
        else:
            def kern():
                return fa.flash_small_kv_max(qh, kh, vh, sk_actual=ska)

            def plain():
                return fa.flash_small_kv_max_plain(qh, kh, vh, sk_actual=ska)
            rtol, atol = 2 ** -7, 1e-3
        before = _kernels.launches[name]
        out = kern()
        if _kernels.launches[name] != before + 1:
            raise RuntimeError(f"{tag}: the {name} counter did not count the launch")
        ref = plain()
        err = check_close(f"{name} {tag} (d {d})", out, ref, rtol=rtol, atol=atol)
        rel_l2 = ((out.float() - ref.float()).norm() / ref.float().norm()).item()
        print(f"  {name} {tag}: relative L2 error of o {rel_l2:.3e}"
              + ("" if name == "flash_fwd_d64" else f" (bound 2^-10 = {2 ** -10:.3e})"),
              flush=True)
        if name != "flash_fwd_d64" and not rel_l2 < 2 ** -10:
            raise RuntimeError(f"{name} {tag}: relative L2 error {rel_l2:.3e} >= 2^-10")
        q4, k4, v4 = (t.view(1, bn, -1, d)[:, :, :n].contiguous()
                      for t, n in ((qh, sq), (kh, ska), (vh, ska)))
        def sdpa():
            return F.scaled_dot_product_attention(q4, k4, v4, scale=ln2)
        r = dict(max_abs_err=err, rel_l2=rel_l2, ms=time_ms(kern), device_ms=device_ms(kern),
                 plain_ms=time_ms(plain, 1, 3),
                 bound=bound_ms((2 * sq + 2 * ska) * bn * d * 2, 4 * bn * sq * ska * d),
                 library_ms=time_ms(sdpa), library_device_ms=device_ms(sdpa))
        res.setdefault(name, {})[tag] = r
        print(f"  {name} {tag}: ms {r['ms']:.4f} (device {r['device_ms']:.4f}) plain_ms "
              f"{r['plain_ms']:.4f} bound_ms {r['bound'][0]:.4f} ({r['bound'][1]}) library_ms "
              f"{r['library_ms']:.4f} (device {r['library_device_ms']:.4f})", flush=True)
        del qh, kh, vh, out, ref, q4, k4, v4
    torch.cuda.empty_cache()
    return res


def k4_ab(other_path):
    """K4's C entry fg_flash_small_kv_max (the same arguments in every
    build) of this build's library against another build's (``--ab-lib``:
    an older tree's library, built from its checkout) on the same inputs
    at the SDXL shapes and K4's head-dim-128 shape.  Each output is held
    to the plain version at K4's tolerance; device times (torch.profiler)
    and CUDA-event times of direct calls are taken in the order other,
    this, this, other.  Returns {shape: {"this"|"other": {"device_ms",
    "ms"}}} with the medians."""
    import ctypes
    import statistics

    import torch

    from fairygen_tpu_torch.ops import _kernels
    from fairygen_tpu_torch.ops import flash_attention as fa

    other = ctypes.CDLL(os.path.abspath(other_path))
    other.fg_flash_small_kv_max.argtypes = _kernels._SIGNATURES["fg_flash_small_kv_max"]
    other.fg_flash_small_kv_max.restype = ctypes.c_int
    libs = {"other": other, "this": _kernels.lib()}
    g = torch.Generator("cuda").manual_seed(778)
    res = {}
    for tag, bn, sq, skp, ska, d in (("cross 20x4096 q, 77 keys", 20, 4096, 128, 77, 64),
                                     ("cross 40x1024 q, 77 keys", 40, 1024, 128, 77, 64),
                                     ("self 40x1024", 40, 1024, 1024, 1024, 64),
                                     ("d128 24x2048 q, 512 keys", 24, 2048, 512, 512, 128)):
        qh = (torch.randn((bn, sq, d), generator=g, device="cuda")
              * (d ** -0.5 * 1.4426950408889634)).to(torch.bfloat16)
        kh, vh = (torch.randn((bn, skp, d), generator=g, device="cuda").to(torch.bfloat16)
                  for _ in range(2))
        ref = fa.flash_small_kv_max_plain(qh, kh, vh, sk_actual=ska)
        calls = {}
        for name, lib in libs.items():
            out = torch.empty_like(qh)

            def call(lib=lib, out=out):
                rc = lib.fg_flash_small_kv_max(qh.data_ptr(), kh.data_ptr(), vh.data_ptr(),
                                               out.data_ptr(), bn, sq, ska, skp, d,
                                               torch.cuda.current_stream().cuda_stream)
                if rc:
                    raise RuntimeError(f"fg_flash_small_kv_max: cudaError {rc}")
            call()
            torch.cuda.synchronize()
            check_close(f"K4 A/B {tag}, {name} build", out, ref, rtol=2 ** -7, atol=1e-3)
            calls[name] = call
        runs = {"this": {"device_ms": [], "ms": []}, "other": {"device_ms": [], "ms": []}}
        for name in ("other", "this", "this", "other"):
            runs[name]["device_ms"].append(device_ms(calls[name]))
            runs[name]["ms"].append(time_ms(calls[name]))
        res[tag] = {n: {k: statistics.median(v) for k, v in r.items()} for n, r in runs.items()}
        print(f"  K4 A/B {tag}: device ms this " +
              " / ".join(f"{m:.4f}" for m in runs["this"]["device_ms"]) + ", other " +
              " / ".join(f"{m:.4f}" for m in runs["other"]["device_ms"]) + "; event ms this " +
              " / ".join(f"{m:.4f}" for m in runs["this"]["ms"]) + ", other " +
              " / ".join(f"{m:.4f}" for m in runs["other"]["ms"]), flush=True)
        del qh, kh, vh, ref, calls
    torch.cuda.empty_cache()
    return res


def sdxl_inputs(size):
    """A seeded (size, size, 3) image in [0, 1] with a centred elliptic
    'character' blanked out, and its mask (1 = the character to keep)."""
    import numpy as np

    img = seeded_image(31, size, size).astype(np.float32) / 255.0
    yy, xx = np.mgrid[0:size, 0:size] / size
    mask = ((((yy - 0.55) / 0.35) ** 2 + ((xx - 0.5) / 0.22) ** 2) < 1).astype(np.float32)
    mask = mask[..., None]
    return img * (1.0 - mask), mask


def sdxl_ids(seed, n_words):
    """Token ids of both SDXL tokenizers' layout, (1, 77) each: BOS 49406,
    ``n_words`` seeded ids, EOS 49407, then padding (CLIP-L pads with EOS,
    OpenCLIP bigG with 0)."""
    import torch

    gen = torch.Generator("cpu").manual_seed(seed)
    words = torch.randint(1, 49406, (n_words,), generator=gen)
    out = []
    for pad in (49407, 0):
        ids = torch.full((1, 77), pad, dtype=torch.long)
        ids[0, 0], ids[0, n_words + 1] = 49406, 49407
        ids[0, 1:n_words + 1] = words
        out.append(ids)
    return out


def sdxl_phase():
    """SDXL + BrushNet stylization at full width and depth on the card, as
    examples/brushnet_stylize.py: the SDXL UNet, BrushNet-SDXL, CLIP-L,
    OpenCLIP bigG and the SDXL VAE (fp32) from seeded weights (bf16), a
    rank-32 Style DoRA on to_q/k/v/out of every transformer block (seeded
    non-zero B and magnitudes off the column norms, through
    sdxl_dora_state_dict and load_sdxl_dora_state_dict at lora_scale
    0.66); seeded prompt ids through encode_ids; two 1024x1024 requests
    (50 DPM-Solver++ steps, CFG 7.5, BrushNet scale 0.7) on a seeded
    masked image, each with exact launch counts of K4's max and masked
    forms and K5 at head dim 64 and none of the other kernels; then one
    BrushNet + UNet step under torch.profiler.  Returns the launches."""
    import numpy as np
    import torch

    from fairygen_tpu_torch import convert
    from fairygen_tpu_torch.core.imaging import postprocess_image
    from fairygen_tpu_torch.models.sdxl.clip import CLIPTextConfig
    from fairygen_tpu_torch.models.sdxl.unet2d import (UNet2DConfig, brushnet_forward,
                                                       unet2d_forward)
    from fairygen_tpu_torch.models.sdxl.vae import AutoencoderKLConfig
    from fairygen_tpu_torch.ops import _kernels
    from fairygen_tpu_torch.pipelines.sdxl_brushnet import SDXLBrushNetPipeline
    from fairygen_tpu_torch.training.dora_trainer import (add_dora_to_sdxl_unet,
                                                          load_sdxl_dora_state_dict,
                                                          sdxl_dora_state_dict)

    bf = torch.bfloat16
    torch.cuda.reset_peak_memory_stats()
    t1 = time.perf_counter()
    ucfg, bcfg = UNet2DConfig.sdxl_base(), UNet2DConfig.brushnet_sdxl()
    te1_cfg, te2_cfg = CLIPTextConfig.sdxl_te1(), CLIPTextConfig.sdxl_te2()
    vcfg = AutoencoderKLConfig.sdxl()
    unet = convert.init_unet2d_params(ucfg, "cuda", bf, seed=90)
    bn = convert.init_unet2d_params(bcfg, "cuda", bf, seed=91, brushnet=True)
    te1 = convert.init_clip_text_params(te1_cfg, "cuda", bf, seed=92)
    te2 = convert.init_clip_text_params(te2_cfg, "cuda", bf, seed=93)
    vae = convert.init_autoencoder_kl_params(vcfg, "cuda", torch.float32, seed=94)
    torch.cuda.synchronize()
    print(f"  SDXL weights in {time.perf_counter() - t1:.3f} s: UNet "
          f"{convert.count_params(unet):,} BrushNet {convert.count_params(bn):,} CLIP-L "
          f"{convert.count_params(te1):,} OpenCLIP bigG {convert.count_params(te2):,} VAE "
          f"{convert.count_params(vae):,} (fp32); max_memory_allocated "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)

    # a trained-looking style adapter, saved and loaded as the example does
    t1 = time.perf_counter()
    g = torch.Generator("cuda").manual_seed(95)
    dora = sdxl_dora_state_dict(add_dora_to_sdxl_unet(unet, g, rank=32))
    rng = np.random.default_rng(96)
    for k, v in dora.items():
        if k.endswith(".lora_B.weight"):
            dora[k] = (0.02 * rng.standard_normal(v.shape)).astype(np.float32)
        elif k.endswith(".lora_magnitude_vector.weight"):
            dora[k] = (v * rng.uniform(0.9, 1.1, v.shape)).astype(np.float32)
    unet, n = load_sdxl_dora_state_dict(unet, dora, scale=0.66)
    torch.cuda.synchronize()
    n_dora = sum(v.size for v in dora.values())
    print(f"  Style DoRA: {n} adapters, {n_dora:,} fp32 parameters, made, saved and loaded "
          f"at lora_scale 0.66 in {time.perf_counter() - t1:.3f} s", flush=True)
    if n != 70 * 2 * 4:
        raise RuntimeError(f"{n} DoRA adapters loaded, expected 560")
    del dora

    pipe = SDXLBrushNetPipeline(unet, ucfg, vae, vcfg, bn, bcfg, te1, te1_cfg, te2, te2_cfg,
                                dtype=bf, device="cuda")
    ids, neg_ids = sdxl_ids(97, 40), sdxl_ids(98, 0)
    for label in ("first", "warm"):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        pe, ppe = pipe.encode_ids(*ids)
        torch.cuda.synchronize()
        print(f"  CLIP-L + OpenCLIP bigG encode ({label}): "
              f"{(time.perf_counter() - t1) * 1e3:.2f} ms, prompt {tuple(pe.shape)} pooled "
              f"{tuple(ppe.shape)}", flush=True)
    if tuple(pe.shape) != (1, 77, 2048) or tuple(ppe.shape) != (1, 1280) \
            or not (torch.isfinite(pe).all() and torch.isfinite(ppe).all()):
        raise RuntimeError("the prompt embedding has the wrong shape or non-finite values")
    npe, nppe = pipe.encode_ids(*neg_ids)
    masked, mask = sdxl_inputs(1024)

    want = {k: SDXL_PER_STEP.get(k, 0) * SDXL_STEPS for k in _kernels.launches}
    total = {k: 0 for k in _kernels.launches}
    for seed in (333, 334):
        _kernels.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        img = pipe(prompt_embeds=pe, pooled_embeds=ppe, negative_prompt_embeds=npe,
                   negative_pooled_embeds=nppe, image=masked, mask=mask, height=1024,
                   width=1024, num_inference_steps=SDXL_STEPS, guidance_scale=7.5,
                   brushnet_conditioning_scale=0.7, seed=seed, output_type="np_pm1")
        torch.cuda.synchronize()
        dt = time.perf_counter() - t1
        got = dict(_kernels.launches)
        finite = bool(torch.isfinite(img).all())
        arr = postprocess_image(img[0].cpu().numpy())
        print(f"  SDXL + BrushNet + DoRA request seed={seed}: {dt:.3f} s, output "
              f"{tuple(img.shape)} {img.dtype} -> {arr.shape} {arr.dtype}, all finite: "
              f"{finite}, std {img.std().item():.4f}, max_memory_allocated "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, launches "
              f"{ {k: v for k, v in got.items() if v} }", flush=True)
        if tuple(img.shape) != (1, 3, 1024, 1024) or arr.shape != (1024, 1024, 3) or not finite:
            raise RuntimeError("SDXL request output has the wrong shape or non-finite values")
        if got != want:
            raise RuntimeError(f"SDXL request launch counts {got} != expected {want}")
        for k, v in got.items():
            total[k] += v

    # where a step's time goes: one BrushNet sweep and one UNet sweep at CFG
    # batch 2, as the pipeline runs them at its first step
    gen = torch.Generator("cuda").manual_seed(99)
    x = torch.randn((2, 4, 128, 128), generator=gen, device="cuda").to(bf)
    cond = torch.randn((2, 5, 128, 128), generator=gen, device="cuda").to(bf)
    ehs = torch.cat([npe, pe]).to(bf)
    kw = dict(text_embeds=torch.cat([nppe, ppe]).float(),
              time_ids=torch.tensor([[1024.0, 1024, 0, 0, 1024, 1024]] * 2, device="cuda"))
    t = torch.tensor(981.0, device="cuda")
    with torch.no_grad():
        def step():
            down, mid, up = brushnet_forward(bn, bcfg, x, t, ehs, cond, conditioning_scale=0.7,
                                             **kw)
            return unet2d_forward(unet, ucfg, x, t, ehs, down_block_add_samples=down,
                                  mid_block_add_sample=mid, up_block_add_samples=up, **kw)

        step()
        torch.cuda.synchronize()
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            t1 = time.perf_counter()
            step()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t1
    device_table(prof, wall, "profiled BrushNet + UNet step (1024x1024, CFG batch 2)", 18,
                 also=("fa_",))
    del pipe, unet, bn, te1, te2, vae, img, x, cond
    torch.cuda.empty_cache()
    return total


def reference_sdxl_check():
    """A tiny SDXL + BrushNet pipeline with a DoRA on the card (bf16,
    kernels) against the same weights on the CPU in fp32 and in bf16 (plain
    versions): channels (64, 128) at 1 and 2 heads (head dim 64; the
    kernels take no smaller), one transformer block per attention, a
    BrushNet mid attention of head dim 64, the 4-level VAE at width 32;
    512x512 (64 x 64 latents: K5 over 4096 tokens, K4's max form over
    1024, its masked form over 77 text keys), 4 steps at CFG 7.5, the same
    CPU-drawn noise.  The card's relative L2 error of the final latents to
    the CPU fp32 run must be at most twice the CPU bf16 run's + 1e-3."""
    import torch

    from fairygen_tpu_torch import convert
    from fairygen_tpu_torch.models.sdxl.unet2d import UNet2DConfig
    from fairygen_tpu_torch.models.sdxl.vae import AutoencoderKLConfig
    from fairygen_tpu_torch.ops import _kernels
    from fairygen_tpu_torch.pipelines.sdxl_brushnet import SDXLBrushNetPipeline
    from fairygen_tpu_torch.training.dora_trainer import (add_dora_to_sdxl_unet,
                                                          load_sdxl_dora_state_dict,
                                                          sdxl_dora_state_dict)

    kw = dict(block_out_channels=(64, 128), num_attention_heads=(1, 2),
              down_block_types=("CrossAttnDownBlock2D", "CrossAttnDownBlock2D"),
              up_block_types=("CrossAttnUpBlock2D", "CrossAttnUpBlock2D"),
              transformer_layers_per_block=(1, 1), cross_attention_dim=64,
              addition_time_embed_dim=8, projection_class_embeddings_input_dim=80)
    ucfg = UNet2DConfig(**kw)
    bcfg = UNet2DConfig(**{**kw, "down_block_types": ("DownBlock2D",) * 2,
                           "up_block_types": ("UpBlock2D",) * 2,
                           "mid_block_type": "UNetMidBlock2D", "attention_head_dim": 64,
                           "conditioning_channels": 5})
    vcfg = AutoencoderKLConfig(block_out_channels=(32, 32, 32, 32), norm_num_groups=8)
    f32 = torch.float32
    base = (convert.init_unet2d_params(ucfg, "cpu", f32, seed=100),
            convert.init_unet2d_params(bcfg, "cpu", f32, seed=101, brushnet=True),
            convert.init_autoencoder_kl_params(vcfg, "cpu", f32, seed=102))
    dora = sdxl_dora_state_dict(add_dora_to_sdxl_unet(
        base[0], torch.Generator("cpu").manual_seed(103), rank=8))
    g = torch.Generator("cpu").manual_seed(104)
    for k, v in dora.items():
        if k.endswith(".lora_B.weight"):
            dora[k] = (0.05 * torch.randn(v.shape, generator=g)).numpy()
    masked, mask = sdxl_inputs(512)
    call = dict(prompt_embeds=torch.randn(1, 77, 64, generator=g),
                pooled_embeds=torch.randn(1, 32, generator=g),
                negative_prompt_embeds=torch.randn(1, 77, 64, generator=g),
                negative_pooled_embeds=torch.randn(1, 32, generator=g), image=masked, mask=mask,
                height=512, width=512, num_inference_steps=4, guidance_scale=7.5,
                brushnet_conditioning_scale=0.7, seed=105, torch_compat_noise=True,
                output_type="latent")

    def run(dev, dt):
        unet, _ = load_sdxl_dora_state_dict(to(base[0], dev, dt), dora, scale=0.66)
        pipe = SDXLBrushNetPipeline(unet, ucfg, to(base[2], dev, dt), vcfg,
                                    to(base[1], dev, dt), bcfg, dtype=dt, device=dev)
        return pipe(**call).float().cpu()

    ref = run("cpu", f32)
    rel16 = ((run("cpu", torch.bfloat16) - ref).norm() / ref.norm()).item()
    _kernels.reset_launches()
    out = run("cuda", torch.bfloat16)
    ran = {k: v for k, v in _kernels.launches.items() if v}
    rel = ((out - ref).norm() / ref.norm()).item()
    tol = 2 * rel16 + 1e-3
    print(f"  tiny SDXL + BrushNet + DoRA pipeline latents {tuple(out.shape)}: relative L2 "
          f"error to CPU fp32 {rel:.4e} (card bf16), {rel16:.4e} (CPU bf16); tolerance "
          f"{tol:.4e}; kernel launches {ran}", flush=True)
    steps = 4  # per step: 2 + 3 blocks at 64 x 64, 2 + 1 + 3 and BrushNet's mid at 32 x 32
    want = {"flash_fwd_d64": 5 * steps, "flash_small_kv_max": 7 * steps,
            "flash_small_kv_masked": 11 * steps}
    if ran != want:
        raise RuntimeError(f"tiny SDXL pipeline: kernel launches {ran} != {want}")
    if not rel <= tol:
        raise RuntimeError("tiny SDXL pipeline disagrees with the CPU reference")


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
