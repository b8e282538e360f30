#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (fairygen_tpu_torch) once on one NVIDIA card.

    python3 chip_smoke.py                 # the whole run, one card
    python3 chip_smoke.py --kernels-only  # device, build and kernel checks only
    python3 chip_smoke.py --ab-lib PATH   # also K4, the fp32 K6a-c and K11 against
                                          # another build's library
    python3 chip_smoke.py --dora-ab LIB   # only the dora phase, with DoRA steps in turns
                                          # through another build's fp32 K6a and this
                                          # one's, after the wrappers' host time a call
    python3 chip_smoke.py --speed-only    # device, build, then only the speed modes: the
                                          # speed, flux and zimage phases and their
                                          # reference check; no result line
    python3 chip_smoke.py --variants-only # device, build, then only the variants phase,
                                          # its A14B request at the flagship's 81 frames
                                          # (S = 32760); no result line
    python3 chip_smoke.py --conditioning-only  # device, build, then only the conditioning
                                          # phase and its tiny reference check; no result
                                          # line
    python3 chip_smoke.py --animate-vap-longcat-only  # device, build, then only the
                                          # animate_vap_longcat phase (its kernel shapes
                                          # first) and its tiny reference check; no
                                          # result line

Phases, each printing its wall seconds:
  1. device   — card name/count, nvidia-smi name and power limit, TF32 off.
  2. build    — one nvcc -c per source, all at once, and one link
                (ptxas -v output printed once); the registers, shared
                memory and spills of the TMA + wgmma kernels (K3, K4
                bounded, K4 max/masked and K5 at head dims 64, 128 and 160
                (SD1.5's 8, 40 and 80 run the 64 and 128 kernels), K6a,
                K10, K6b, K6c, each form), and
                their HGMMA (wgmma) and UTMALDG (TMA load) counts from
                cuobjdump's SASS of their own object files (a spill, a
                count of 0 or wgmma that ptxas serialized, C7511 / C7512
                / C7520, fails the run); beside them nvcc builds a copy of
                csrc/flash_attention_online.cu in which no kernel has the
                consumers take turns; the 3xTF32 K6a of
                csrc/flash_attention_fp32.cu, K6b and K6c of
                csrc/flash_attention_fp32_bwd.cu with their HGMMA and
                UTMALDG counts (the same failures as above), and the
                registers and spills of K6a's pre-pass and of the
                backward's pre-pass and reduce kernels; K11's instances'
                registers and spills (a spill fails), and for both Wan
                VAEs' widths the ring's shared memory and the instructions
                a lane issues per element on the consumer loop's
                branch-free path (cuobjdump), which give its issue bound.
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
                device time (torch.profiler) beside their event times;
                with --ab-lib, another build's K11 (its first design's C
                entry) beside this one's at the flagship's 17 shapes,
                399,360 x 256 and the Wan2.1 VAE's widest shapes: device
                time in turns, each build's count of outputs that differ
                from the plain version, the two builds bit for bit.
                Then K4's max and
                masked forms and K5 at head dim 64 at the SDXL 1024x1024
                CFG shapes (cross-attention to 77 text keys, 1024- and
                4096-token self-attention), K4 at head dim 128, with a
                kv_len over non-zero keys and at 192 keys, K4's o within a
                relative L2 error of 2^-10, SDPA as their yardstick, device
                times beside the CUDA-event times; with --ab-lib, K4 of
                another build of the library beside this one's.
                Then K6a, K6b and K6c in fp32 at head dim 64 at the
                Style-DoRA step's shapes (self 10 x 4096 and 20 x 1024,
                cross to 77 text keys in 128): o, dq, dk, dv within a
                relative L2 error of 1e-5 of the plain versions, lse within
                1e-5, two runs bit for bit, the pre-passes' workspaces and
                the reduce pass's sums bit for bit their plain versions',
                the fp32 flash_attention
                gradient against autograd, SDPA's fp32 forward and backward
                as the yardstick (events and device time), each kernel's
                device time against the FFMA (67 TFLOP/s) and 3xTF32
                (494.7 / 3 TFLOP/s) bounds, and their sums over a step's
                140 calls; with --ab-lib, the other build's fp32 K6a-c C
                entries beside this build's wrappers, with host time a call.
                Then K6a, K6b and K6c in bf16 at head dim 64 (the bf16 SDXL
                UNet under a gradient) at the same four shapes against their
                plain versions (the head-dim-128 tolerances), twice bit for
                bit, events and device time against their bounds and exp2
                counts, cuDNN's forward with its log-sum-exp and SDPA's
                flash backward beside them, and their sums over a step's
                140 calls.
                Then K5, K4's max form and K4's masked form at SD1.5's head
                dims 8, 40, 80 and 160 at the shapes of a 512x512 and a
                768x768 CFG request and, for the forms neither reaches, at
                shapes of their own: within 2^-8 of the plain versions (K4
                also a relative L2 error of 2^-10), twice bit for bit, the
                bound at the true d (bytes, products or exp2), SDPA as the
                yardstick, device time at each counter's row shape.
                Then K5, K4's max form and K4's masked form in fp32 (the
                SDXL and SD1.5 pipelines' default dtype) at head dims 8,
                16, 40, 64, 80 and 160 at the shapes of a 1024x1024 SDXL and
                a 512x512 and 768x768 SD1.5 CFG request and, for the forms
                no request reaches, at shapes of their own: within a
                relative L2 error of 1e-5 of the plain versions (the fp32
                K6a's bound), twice bit for bit, one launch of the form's
                counter and of the pre-pass, the 3xTF32 bound (bytes,
                products at 494.7 / 3 TFLOP/s or exp2) with the 67 TFLOP/s
                one beside it, fp32 SDPA as the yardstick, device time of
                the pre-pass and the kernel at each counter's row shape.
                Then the conditioned variants' new shapes: K2 on the S2V
                RoPE tables (S = 7800 and, with the frame packer, 10114),
                K3 at S = 9360 and K4's bounded form at the audio
                injector's (4 x 40 heads, 1560 queries, 5 keys: within
                2^-8 max|v| and a relative L2 error of 2^-10, twice bit
                for bit) against their plain versions.
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
                once; each within a relative L2 error of 2^-5 of the
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
                bit the straight one, one direct-distill step (2 sweeps
                with gradients) and one trajectory step (10 teacher
                sweeps at 17 frames), one step each with AdamW, Adafactor
                and remat="offload" (which must lower the peak by at
                least half its carries); walls, peaks, exact launches.
  7. breakdown — each stage of a request alone, and one DiT sweep under
                torch.profiler (device time by kernel, busy share).
  7b. speed   — the serving speed modes of the TI2V-5B DiT at full width,
                from seed-0 bf16 weights made anew for each mode:
                torch._int_mm at the FFN shapes (8190 x 3072 x 14336 and
                8190 x 14336 x 3072) by events and device time beside its
                1,979 TOPS bound, the bf16 product and a row-major weight,
                the whole W8A8 dense, and on 300 rows its products and
                output bit for bit the CPU's; a 480x832x17, 4-step, CFG 5
                bf16 request; act_amax from 3 samples of a 10-step
                rollout; TeaCache calibrated over one 20-step rollout
                (registered as "Wan2.2-TI2V-5B"), the threshold picked for
                half the steps and a 20-step CFG 5 request at it (its
                schedule the replay's within a boundary step, launches
                exact for the sweeps it computed); the 4-step request again
                in "int8_ffn", "int8" and "int8" with act_amax and a bf16
                fallback for 8 fc2 channels.  Each: wall, the DiT's bytes,
                peak memory, exact launches and _int_mm calls, the final
                latents' relative L2 to the bf16 request's, a profiled
                S = 8190 sweep with the W8A8 passes' device time by name.
                The requests and rollouts run at 17 frames to keep the
                smoke inside its budget on a slow host (--speed-only: 81).
  8. flux     — FLUX.1-dev at full width and depth (DiT 19 + 38 blocks,
                T5 v1.1 XXL, CLIP-L, the FLUX VAE) from seeded bf16 weights:
                two 1024x1024 4-step requests and one EliGen request with
                exact launch counts of K1, K7, K8, K3 and K10, and one
                profiled sweep without regions and one with them; then the
                DiT quantized to W8A8 and the first request again (the
                speed phase's report).
  9. zimage   — Z-Image-Turbo at full width and depth (DiT 2 + 2 + 30
                blocks, dim 3840; Qwen3-4B; the FLUX VAE) from seeded bf16
                weights: a 300-id prompt through encode_ids, two 1024x1024
                8-step requests and one image-to-image CFG request with
                exact launch counts of K9, K7, K3 and K4, and one profiled
                sweep; then the DiT quantized to W8A8 and the first request
                again (the speed phase's report).
 10. sdxl     — SDXL + BrushNet stylization at full width and depth (UNet,
                BrushNet-SDXL, CLIP-L, OpenCLIP bigG, the SDXL VAE in fp32)
                from seeded bf16 weights with a rank-32 Style DoRA loaded at
                lora_scale 0.66: two 1024x1024, CFG 7.5, BrushNet 0.7
                requests on a seeded masked image, one with 5 DPM-Solver++
                steps (cut from the CLI's 50 to keep the smoke in its
                budget) and one with 4 LCM steps (scheduler="lcm"), with exact
                launch counts (per step: K5 at head dim 64 10, K4 max form
                61, K4 masked form 70), and one BrushNet + UNet step
                profiled.
 10a. sdxl_train — on the sdxl phase's UNet, BrushNet and VAE: two
                1024x1024 BrushNet training steps (bf16 UNet frozen, fp32
                BrushNet weights, AdamW; K6a-c bf16 at head dim 64 141 each
                a step; the UNet bit for bit, every BrushNet tensor moved;
                the second step profiled), one consistency-distillation step
                at 1024x1024 and one direct step at 512x512 (2 student, 2
                teacher steps), the student a bf16 copy of the UNet; walls,
                peaks, exact launches.
 10b. sd15    — SD1.5 + BrushNet inpainting at full width and depth as the
                brushnet_inpaint_sd15 twin answers a request: the SD1.5
                UNet and BrushNet (its mid attention of head dim 8) from
                seeded bf16 weights, the sdxl phase's CLIP-L and VAE (fp32,
                scaling factor 0.18215); one 512x512, 20-step UniPC, CFG
                7.5, BrushNet 1.0 request on a seeded masked image with the
                blended paste: wall, peak memory, a finite image, exact
                launches (per step K5 at d 40 5, K4 max at d 80 and 160 5
                each, K4 masked at d 40 5, d 80 5, d 160 7, d 8 1); one
                profiled BrushNet + UNet step.
 10c. sd_fp32 — the SDXL + BrushNet + rank-32 Style DoRA and the SD1.5 +
                BrushNet pipelines built without a dtype (their default
                fp32), at full width and depth from seeded fp32 weights:
                one 1024x1024 DPM-Solver++ request (SD_F32_SDXL_STEPS, CFG
                7.5, BrushNet 0.7) and one 512x512 UniPC request
                (SD_F32_SD15_STEPS, CFG 7.5, BrushNet 1.0, blended), each
                with wall, peak memory, a finite fp32 image, exact launches
                of the fp32 K4 / K5 counters and the pre-pass, and one
                profiled BrushNet + UNet step (busy share, kernel count).
 10d. dora    — FairyGen's stylization front end at full width as the CLI
                twins run it (tools/create_mask.py, examples/dora_train.py,
                examples/brushnet_stylize.py): the full-width ISNet's mask
                of a seeded 1024x1024 drawing; the fp32 SDXL UNet, CLIP-L,
                OpenCLIP bigG and VAE with a rank-32 DoRA, two masked DoRA
                steps (AdamW 1e-4, wd 1e-2; the last with min-SNR-5), each
                with wall, peak memory, exact launches (K6a-c fp32 140
                each, K6a's pre-pass 140, the backward's 280, the reduce
                140), a finite loss,
                base weights bit for bit and every
                A, B, mag moved; one profiled step; the adapter through
                safetensors into the bf16 serving pipeline at 0.66 and one
                4-step 1024x1024 request with the sdxl phase's launches.
 10e. variants — the two-expert Wan2.2-I2V-A14B, video-to-video and the
                CLIP-conditioned Wan2.1-I2V-14B at full width (dim 5120, 40
                heads, 40 blocks) with the Wan2.1 VAE, from seeded bf16
                weights: K1-K4 at the 14B shapes (S = 7800, D = 5120), K1 at
                S = 32760, K4 over the 257 CLIP keys, each against its
                plain version; the expert pair (peak memory printed) answers
                one 480x832x17, 4-step, CFG 5 request with first and end
                image at boundary 0.9 (sweeps per expert 4 and 4, exact
                launches of K1-K4 and of K11 in the VAE's 384-channel
                stages; denoise and decode walls) and a 17-frame
                video-to-video request (strength 0.7, 2 steps); one
                profiled sweep of each expert; the latents decoded streamed
                against full-sequence; then Wan2.1-I2V-14B with a full-width
                ViT-H answers a 2-step request; a tiny two-expert CLIP
                pipeline on the card against the CPU.
 10f. conditioning — the Wan variants' second slice at full width from
                seeded bf16 weights, 480x832 x 17 frames through the Wan2.1 VAE,
                CFG 5, 2 steps: Wan2.1-VACE-14B (a control video, a mask,
                a reference image: S = 9360), a
                Wan2.2-Fun-A14B-Control-Camera expert,
                a Fun-Reference 14B DiT (in_dim 36), Wan2.1-T2V-1.3B with
                the motion controller and Wan2.2-S2V-14B with wav2vec
                XLSR-53 large from a seeded waveform, then with a 73-frame
                motion video (1 step, S = 10114); the 14B DiTs share one
                set of 40 seeded blocks; walls, peaks, exact launches (a
                14B sweep K1-K4 120 / 120 / 40 / 40, with VACE 144 / 120 /
                48 / 48, S2V 0 / 80 / 40 / 52; K11 by latent frames
                encoded and decoded), K11 at each Wan2.1 VAE shape, and
                profiled VACE, camera and S2V sweeps and wav2vec encode.
 10g. animate_vap_longcat — the last Wan variants at full width from
                seeded bf16 weights through the Wan2.1 VAE (streamed), CFG
                5: Wan2.2-Animate-14B (the conditioning phase's 40 blocks,
                a ViT-H, the adapter; 21 frames with 17-frame pose, 512x512
                face, inpaint and mask videos: S = 9360), Wan2.1-I2V-14B
                with the 10-layer VAP / MoT branch (a 17-frame VAP video:
                K5 at head dim 128 over 15600 joint tokens), then, those
                freed, LongCat-Video (48 blocks of 4096) as T2V and as a
                continuation of a 5-frame clip (2 conditioning latent
                frames, pinned after each step); walls, peaks, exact
                launches, a profiled sweep of each DiT.
 11. reference — a tiny-width pipeline on the card (kernels, bf16) against
                the same pipeline on the CPU (plain versions, fp32), a tiny
                pipeline loaded by from_pretrained(hints=...) from
                safetensors written in a temporary directory, with a hot
                LoRA loaded and then cleared, likewise, one
                tiny LoRA training step likewise, a tiny head-dim-128
                FLUX.1 DiT with and without EliGen likewise, a tiny
                head-dim-128 Z-Image DiT and a tiny Qwen3 encoder likewise,
                and a tiny head-dim-64 SDXL + BrushNet + DoRA pipeline
                likewise, a tiny bf16 BrushNet step and a tiny LCM request
                likewise, a tiny SD1.5 + BrushNet pipeline at head dims 40,
                80 and 8 likewise, and a tiny head-dim-64 fp32 DoRA step (with and
                without min-SNR-5) likewise, the tiny fp32 SDXL and SD1.5
                BrushNet goldens on the card at their default fp32 against
                the goldens' images, and the tiny pipeline quantized
                to "int8" and with TeaCache likewise (the TeaCache schedule
                the same on the card as on the CPU in bf16 and fp32), and tiny
                VACE, camera, Fun-Reference, motion-controller and S2V
                (wav2vec from a waveform) pipelines likewise, and tiny
                head-dim-128 Animate, VAP (K5 over the joint tokens) and
                LongCat (T2V and continuation) pipelines likewise.
Then the card line, one JSON line of kernel numbers and the result line.
Any failure exits non-zero; past BUDGET_S seconds the run stops, naming
the phase it was in.
"""
import json
import math
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
H100_TF32_FLOP_PER_S = 494.7e12  # dense TF32 tensor cores, same source; 3xTF32 takes a third


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


def _window_rows(fn, calls, acts):
    """torch.profiler's key_averages (activities ``acts``) over ``calls``
    calls of ``fn`` and a synchronisation, the window opened by a spin
    kernel of a few microseconds (torch.cuda._sleep) whose row is left
    out: on an H100 the tracer often left out a window's first kernel."""
    import torch

    with torch.profiler.profile(activities=acts) as prof:
        torch.cuda._sleep(20000)
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return [e for e in prof.key_averages() if "spin_kernel" not in e.key]


def _device_rows(fn, calls):
    """{name: row} of the device-side rows (kernels, copies, memsets) that
    hold records, over ``calls`` calls of ``fn`` (_window_rows)."""
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    return {e.key: e for e in _window_rows(fn, calls, acts)
            if e.device_type == torch.autograd.DeviceType.CUDA and e.count}


def device_trace(fn, calls):
    """{kernel name: ms of device time per call} over a trace of ``calls``
    calls of ``fn``, after a warm-up call.

    Each attempt profiles one call, then ``calls`` calls.  A kernel's
    records a call are the most that the evidence so far shows: its count
    in any one-call window, or its count in any trace over ``calls``,
    rounded up (records are lost, never added).  A trace is whole when it
    holds ``calls`` times each kernel's records a call, and those add up to
    at least the launches the port's wrappers counted in a call; it is
    then summed.  Otherwise the attempt is made again, up to three times.
    After three, the fullest trace that held every kernel gives each
    kernel its mean time over the records it holds times its records a
    call, with a line saying so; where no trace held every kernel, or the
    records a call add up to fewer than the wrappers' launches, this
    raises."""
    import torch

    from fairygen_tpu_torch.ops import _kernels

    fn()
    torch.cuda.synchronize()
    per_call, counted, best, got = {}, 0, None, []
    for _ in range(3):
        before = sum(_kernels.launches.values())
        one = _device_rows(fn, 1)
        counted = max(counted, sum(_kernels.launches.values()) - before)
        rows = _device_rows(fn, calls)
        for k, e in one.items():
            per_call[k] = max(per_call.get(k, 0), e.count)
        for k, e in rows.items():
            per_call[k] = max(per_call.get(k, 0), -(-e.count // calls))
        lacking = sum(calls * n - (rows[k].count if k in rows else 0)
                      for k, n in per_call.items())
        held_all = all(k in rows and rows[k].self_device_time_total for k in per_call)
        if held_all and not lacking and sum(per_call.values()) >= counted:
            return {k: rows[k].self_device_time_total / calls / 1e3 for k in per_call}
        if held_all and (best is None or sum(e.count for e in rows.values())
                         > sum(e.count for e in best.values())):
            best = rows
        got.append(lacking)
        print(f"  device_trace: a trace of {calls} calls lacked {lacking} of {calls} x "
              f"{sum(per_call.values())} kernel records ({counted} launches counted a call), "
              f"every kernel held: {held_all}; taken again", flush=True)
    if best is None or set(best) != set(per_call) or sum(per_call.values()) < counted:
        raise RuntimeError(f"three torch.profiler traces of {calls} calls lost a kernel of the "
                           f"call: lacked {got} records; records a call {per_call}, "
                           f"{counted} launches counted")
    print(f"  device_trace: three traces of {calls} calls came short; each kernel's mean over "
          f"the records the fullest held, times its records a call {per_call}", flush=True)
    return {k: best[k].self_device_time_total / best[k].count * n / 1e3
            for k, n in per_call.items()}


def device_ms(fn, calls=50):
    """ms of device time per call (device_trace, summed over kernels).
    Unlike time_ms it leaves out the host's time between launches, which
    outlasts a kernel of a few microseconds called through its Python
    wrapper."""
    return sum(device_trace(fn, calls).values())


def device_ms_twice(fn, calls=50):
    """device_ms, and where its three traces all lost a kernel of the call
    (device_trace raises) one more round of three, with a line saying so:
    late in a long process the card's profiler has lost a whole kernel
    from every window of one round (K4 over 257 CLIP keys in the variants
    phase, PR 23 call 9 and PR 24 call 5) and held it in the next.  Taken
    by the checks that run late in the variants phase (K1, K2 and K4 at the
    14B shapes)."""
    try:
        return device_ms(fn, calls)
    except RuntimeError as e:
        print(f"  device_ms: {e}; a second round of traces", flush=True)
        return device_ms(fn, calls)


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


def k1_check(S, D, seg, g):
    """K1 against its plain version on (1, S, D) rows with the segment
    boundary ``seg`` (bf16 output; 1 bf16 ulp is <= 2^-7 relative): error,
    event and device ms, the plain version's ms and the bound (bytes: x read
    and the output written once)."""
    import torch

    from fairygen_tpu_torch.ops.fused_norms import layer_norm_modulate, layer_norm_modulate_plain

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=g, device="cuda") * scale).to(torch.bfloat16)

    x = randn(1, S, D)
    sh, sc = randn(1, 2, D, scale=0.1), randn(1, 2, D, scale=0.1)
    out = layer_norm_modulate(x, sh, sc, seg, 1e-6)
    ref = layer_norm_modulate_plain(x, sh, sc, seg, 1e-6)
    err = check_close(f"K1 ln_modulate S={S} D={D}", out, ref, rtol=2 ** -7, atol=1e-5)
    nbytes = 2 * S * D * 2 + 2 * 2 * D * 2
    return dict(
        max_abs_err=err, ms=time_ms(lambda: layer_norm_modulate(x, sh, sc, seg, 1e-6)),
        device_ms=device_ms_twice(lambda: layer_norm_modulate(x, sh, sc, seg, 1e-6)),
        plain_ms=time_ms(lambda: layer_norm_modulate_plain(x, sh, sc, seg, 1e-6)),
        bound=bound_ms(nbytes, 8 * S * D), library_ms=None)


def kernel_checks(S, grid, tag, N=24, D=3072, seg=390):
    """K1-K4 at one shape set (the 5B DiT's 24 heads of 128 by default, the
    14B's 40 with D = 5120 and seg 0); returns {kernel: numbers}."""
    import torch

    from fairygen_tpu_torch.ops import fused_qk as fq
    from fairygen_tpu_torch.ops.flash_attention import (
        flash_attention_heads_major, flash_attention_heads_major_plain)
    from fairygen_tpu_torch.ops.rope import build_freqs_grid, precompute_freqs_3d

    dev, bf = "cuda", torch.bfloat16
    g = torch.Generator(dev).manual_seed(1234 + S)
    hd, lk = 128, 512
    res = {}

    def randn(*shape, scale=1.0, dtype=bf):
        return (torch.randn(shape, generator=g, device=dev) * scale).to(dtype)

    res["ln_modulate"] = k1_check(S, D, seg, g)

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
        device_ms=device_ms_twice(lambda: fq.rms_rope_heads_major(xq, gq, rsq, ff, N, s_pad)),
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
    ("flash_fwd_lse_d64", "fa_online_lse_d64_kernel", "flash_attention_online.cu.o",
     lambda lib: lib.fg_flash_online_smem_bytes(0)),
    ("flash_fwd_lse_d64 ragged", "fa_online_lse_d64_ragged_kernel",
     "flash_attention_online.cu.o", lambda lib: lib.fg_flash_online_smem_bytes(0)),
    ("flash_bwd_dq_d64", "fa_dq_d64_wgmma_kernel", "flash_attention_bwd.cu.o",
     lambda lib: lib.fg_flash_bwd_smem_bytes(2)),
    ("flash_bwd_dq_d64 ragged", "fa_dq_d64_wgmma_ragged_kernel", "flash_attention_bwd.cu.o",
     lambda lib: lib.fg_flash_bwd_smem_bytes(2)),
    ("flash_bwd_dkv_d64", "fa_dkv_d64_wgmma_kernel", "flash_attention_bwd.cu.o",
     lambda lib: lib.fg_flash_bwd_smem_bytes(3)),
    # head dim 160 (SD1.5's 1280-channel levels): three 64-column boxes, one
    # K / V stage; d 8 and 40 run the d-64 kernels above, d 80 the d-128 ones
    ("flash_fwd_d160 / K4 d160 (one key tile)", "fa_online_d160_kernel",
     "flash_attention_online.cu.o", lambda lib: lib.fg_flash_online_smem_bytes(3)),
    ("flash_fwd_d160 / K4 d160 ragged (one key tile)", "fa_online_d160_ragged_kernel",
     "flash_attention_online.cu.o", lambda lib: lib.fg_flash_online_smem_bytes(3)),
    ("flash_small_kv_max/masked d160 (2+ key tiles)", "fa_row_max_d160_kernel",
     "flash_attention_online.cu.o", lambda lib: lib.fg_flash_online_smem_bytes(3)),
    ("flash_small_kv_max/masked d160 ragged (2+ key tiles)", "fa_row_max_d160_ragged_kernel",
     "flash_attention_online.cu.o", lambda lib: lib.fg_flash_online_smem_bytes(3)),
)


# the fp32 kernels on the tensor cores: K6a and the K5 / K4 instances of 32,
# 64, 96 and 160 columns (csrc/flash_attention_fp32.cu), K6b and K6c
# (csrc/flash_attention_fp32_bwd.cu)
F32_TC_KERNELS = (
    ("flash_fwd_lse_f32 / K5 / K4 fp32 d 40, 64", "fa_f32_fwd_tc_kernel",
     "flash_attention_fp32.cu.o", lambda lib: lib.fg_flash_f32_smem_bytes(0)),
    ("K5 / K4 fp32 d 8, 16", "fa_f32_fwd_d32_kernel", "flash_attention_fp32.cu.o",
     lambda lib: lib.fg_flash_f32_smem_bytes(1)),
    ("K5 / K4 fp32 d 80", "fa_f32_fwd_d96_kernel", "flash_attention_fp32.cu.o",
     lambda lib: lib.fg_flash_f32_smem_bytes(2)),
    ("K5 / K4 fp32 d 160", "fa_f32_fwd_d160_kernel", "flash_attention_fp32.cu.o",
     lambda lib: lib.fg_flash_f32_smem_bytes(3)),
    ("flash_bwd_dq_f32", "fa_f32_dq_tc_kernel", "flash_attention_fp32_bwd.cu.o",
     lambda lib: lib.fg_flash_f32_tc_smem_bytes(0)),
    ("flash_bwd_dkv_f32", "fa_f32_dkv_tc_kernel", "flash_attention_fp32_bwd.cu.o",
     lambda lib: lib.fg_flash_f32_tc_smem_bytes(1)),
)


def hopper_build_report(log, table=HOPPER_KERNELS):
    """Each TMA + wgmma kernel's (of ``table``) registers and spills from
    the build's ptxas -v, its dynamic shared memory and, where cuobjdump is
    present, its counts of HGMMA (wgmma) and UTMALDG (TMA load)
    instructions from its own object file.  Raises on a spill, on a missing
    kernel, on a count of 0, or where ptxas says it serialized the kernel's
    wgmma (C7511, C7512, C7520).
    A function is matched by its name followed by 'E' (the end of the name
    in the mangled symbol), so no name matches another it begins."""
    import re
    import shutil

    from fairygen_tpu_torch.ops import _kernels

    def which(symbol):
        return next((k for k, f, _, _ in table if f + "E" in symbol), None)

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
        for obj in sorted({o for _, _, o, _ in table}):
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
    for k, fn, obj, smem in table:
        p = props.get(k, {})
        print(f"  {k} ({fn}, {obj}): registers {p.get('registers')}, dynamic shared memory "
              f"{smem(_kernels.lib())} bytes, spill bytes {p.get('spill_bytes')}; SASS: HGMMA "
              f"{p.get('HGMMA', 'no cuobjdump')}, UTMALDG {p.get('UTMALDG', 'no cuobjdump')}",
              flush=True)
        if p.get("registers") is None or p.get("spill_bytes") != 0:
            raise RuntimeError(f"{k}: ptxas -v shows spills or no such kernel: {p}")
        if tool and not (p["HGMMA"] and p["UTMALDG"]):
            raise RuntimeError(f"{k}: no HGMMA or UTMALDG instruction in its SASS: {p}")


def f32_build_report(log):
    """The fp32 kernels: K6a, K6b and K6c on the tensor cores as
    hopper_build_report reports and checks them (HGMMA and UTMALDG
    counts; a spill, a count of 0 or C7511 / C7512 / C7520 fails), then the
    registers and spills (ptxas -v, ``ptxas_report``) of K6a's pre-pass
    (csrc/flash_attention_fp32.cu), the backward's pre-pass and the reduce
    pass (csrc/flash_attention_fp32_bwd.cu)."""
    hopper_build_report(log, F32_TC_KERNELS)
    ptxas_report(log, ("fa_f32_fwd_prep_kernel", "fa_f32_bwd_prep_kernel",
                       "fa_f32_dkv_reduce_kernel"),
                 ("flash_fwd_prep_f32", "flash_bwd_prep_f32", "flash_bwd_dkv_reduce_f32"))


def ptxas_report(log, names, labels):
    """The registers and spills (ptxas -v) of the kernels ``names`` (a
    function is matched by its name followed by 'E', the end of the name or
    of its template arguments in the mangled symbol), printed with their
    ``labels``; raises on a spill or a kernel ptxas did not report."""
    import re

    props, current = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            current = next((n for n in names if n + "E" in m.group(1)), None)
            continue
        if current is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            props.setdefault(current, {})["spill_bytes"] = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            props.setdefault(current, {})["registers"] = int(m.group(1))
    for label, n in zip(labels, names):
        p = props.get(n, {})
        print(f"  {label} ({n}): registers {p.get('registers')}, spill bytes "
              f"{p.get('spill_bytes')}", flush=True)
        if p.get("registers") is None or p.get("spill_bytes") != 0:
            raise RuntimeError(f"{n}: ptxas -v shows spills or no such kernel: {p}")


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
                    o.data_ptr(), lse.data_ptr(), bn, sq_pad, sk, sk_pad, d),
                "K5": lambda lib=lib, o5=o5, kh=kh, vh=vh: call(
                    lib, "fg_flash_fwd", qh.data_ptr(), kh.data_ptr(), vh.data_ptr(),
                    o5.data_ptr(), bn, sq_pad, sk, sk_pad, d)}
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


def f32_host_ms(label="this build's"):
    """The host time a call of the fp32 K6a, K6b and K6c wrappers
    (flash_fwd, flash_bwd_dq, flash_bwd_dkv, as the module holds them when
    called) at the DoRA step's shapes: the wall of 20 calls enqueued on an
    idle card, before they are waited for, over 20; the median of three
    such runs after a warm-up.  Returns {kernel: {shape: ms}}."""
    import statistics

    import torch

    from fairygen_tpu_torch.ops import flash_attention as fa

    g = torch.Generator("cuda").manual_seed(780)
    f = 1 / 1.4426950408889634
    res = {}
    for tag, bn, sq, skp, ska, _ in DORA_ATTENTION_SHAPES:
        qh = torch.randn((bn, sq, 64), generator=g, device="cuda") * (64 ** -0.5 * fa.LOG2E)
        kh, vh = (torch.randn((bn, skp, 64), generator=g, device="cuda") for _ in range(2))
        kh[:, ska:], vh[:, ska:] = 0, 0
        doh = torch.randn((bn, sq, 64), generator=g, device="cuda") * 0.05
        o, lse = fa.flash_fwd(qh, kh, vh, sk_actual=ska)
        delta = (doh * o).sum(-1)
        calls = {"flash_fwd_lse_f32": lambda: fa.flash_fwd(qh, kh, vh, sk_actual=ska),
                 "flash_bwd_dq_f32": lambda: fa.flash_bwd_dq(qh, kh, vh, doh, lse, delta,
                                                             sk_actual=ska, dq_factor=f),
                 "flash_bwd_dkv_f32": lambda: fa.flash_bwd_dkv(qh, kh, vh, doh, lse, delta,
                                                               sq=sq, sk_actual=ska)}
        for name, fn in calls.items():
            fn()
            torch.cuda.synchronize()
            walls = []
            for _ in range(3):
                t0 = time.perf_counter()
                for _ in range(20):
                    fn()
                walls.append((time.perf_counter() - t0) / 20 * 1e3)
                torch.cuda.synchronize()
            res.setdefault(name, {})[tag] = statistics.median(walls)
        del qh, kh, vh, doh, o, lse, delta, calls
    torch.cuda.empty_cache()
    for name, by in res.items():
        print(f"  host ms a call of {label} {name} wrapper: " +
              ", ".join(f"{tag} {ms:.4f}" for tag, ms in by.items()), flush=True)
    return res


def other_f32_fwd(lib_path):
    """flash_fwd with its fp32 form through another build's C entry
    fg_flash_fwd_lse_f32 (``--dora-ab``: an older tree's library, whose
    K6a is the FFMA kernel), with the host steps of that tree's wrapper:
    the same checks, o and lse allocated, one launch counted under
    ``flash_fwd_lse_f32``.  Every other form goes to this build's
    flash_fwd."""
    import ctypes

    import torch

    from fairygen_tpu_torch.ops import _kernels
    from fairygen_tpu_torch.ops import flash_attention as fa

    entry = ctypes.CDLL(os.path.abspath(lib_path)).fg_flash_fwd_lse_f32
    entry.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    entry.restype = ctypes.c_int
    this = fa.flash_fwd

    def flash_fwd(qh, kh, vh, *, sk_actual, with_lse=True):
        if not (qh.is_cuda and qh.dtype == torch.float32):
            return this(qh, kh, vh, sk_actual=sk_actual, with_lse=with_lse)
        fa._refuse_unported(qh, grad=with_lse)
        bn, sq_p, _ = qh.shape
        out = torch.empty_like(qh)
        fa._check_heads_major(qh, kh, vh, sk_actual, dims=fa._F32_TRAIN_DIMS,
                              dtype=torch.float32)
        lse = torch.empty((bn, sq_p), dtype=torch.float32, device=qh.device)
        rc = entry(qh.data_ptr(), kh.data_ptr(), vh.data_ptr(), out.data_ptr(), lse.data_ptr(),
                   bn, sq_p, int(sk_actual), kh.shape[1], torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"fg_flash_fwd_lse_f32 of {lib_path}: cudaError {rc}")
        _kernels.launches["flash_fwd_lse_f32"] += 1
        return out, lse

    return flash_fwd


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
    if "--dora-ab" in argv:
        from fairygen_tpu_torch.ops import flash_attention as fa

        other = other_f32_fwd(argv[argv.index("--dora-ab") + 1])
        this = fa.flash_fwd
        _kernels.lib()
        for _ in range(2):
            f32_host_ms()
            fa.flash_fwd = other
            f32_host_ms("the other build's K6a and this build's")
            fa.flash_fwd = this
        t0 = phase("dora")
        dora_phase(other)
        done("dora", t0)
        timer.cancel()
        return 0

    t0 = phase("build")
    for cmd in _kernels.compile_commands(verbose=True) + [_kernels.link_command()]:
        print("  " + " ".join(cmd))
    turns_proc, turns_lib = start_turns_off_build()
    try:
        build_log = _kernels.build(verbose=True, force=True, timeout=300)
        print(build_log)
        _kernels.lib()
        hopper_build_report(build_log)
        f32_build_report(build_log)
        k11_build_report(build_log)
        # K1's two forms: 16 vectors a lane (D <= 4096) and 32 (D <= 8192)
        ptxas_report(build_log, ("ln_modulate_kernelILi16E", "ln_modulate_kernelILi32E"),
                     ("ln_modulate D <= 4096", "ln_modulate D <= 8192"))
        turns_log, _ = turns_proc.communicate(timeout=300)
    finally:
        if turns_proc.poll() is None:
            turns_proc.kill()
            turns_proc.wait()
    if turns_proc.returncode:
        raise RuntimeError(f"nvcc of the copy without turns failed ({turns_proc.returncode}):\n"
                           f"{turns_log}")
    done("build", t0)

    if "--speed-only" in argv:
        speed_only()
        timer.cancel()
        return 0
    if "--variants-only" in argv:
        t0 = phase("variants")
        variants_phase(frames=81)
        done("variants", t0)
        timer.cancel()
        return 0
    if "--conditioning-only" in argv:
        t0 = phase("conditioning")
        conditioning_kernel_checks()
        conditioning_phase()
        done("conditioning", t0)
        t0 = phase("reference")
        reference_conditioning_check()
        done("reference", t0)
        timer.cancel()
        return 0
    if "--animate-vap-longcat-only" in argv:
        t0 = phase("animate_vap_longcat")
        avl_kernel_checks()
        animate_vap_longcat_phase()
        done("animate_vap_longcat", t0)
        t0 = phase("reference")
        reference_avl_check()
        done("reference", t0)
        timer.cancel()
        return 0

    t0 = phase("kernels")
    smoke = kernel_checks(1950, (5, 15, 26), "S=1950")
    flagship = kernel_checks(8190, (21, 15, 26), "S=8190")
    dit_attn = dit_attention_checks()
    train_k = train_kernel_checks()
    turns = turns_ab(turns_lib)
    flux_k = flux_kernel_checks()
    norm_k = norm_kernel_checks()
    sdxl_k = sdxl_kernel_checks()
    sd15_k = sd15_kernel_checks()
    f32_k = f32_train_kernel_checks()
    f32_fwd_k = f32_fwd_kernel_checks()
    d64_k = bf16_d64_kernel_checks()
    kc = conditioning_kernel_checks()
    avl = avl_kernel_checks()
    k4_other = k4_ab(ab_lib) if ab_lib else None
    f32_other = f32_ab(ab_lib) if ab_lib else None
    k11_other = k11_ab(ab_lib) if ab_lib else None
    torch.cuda.synchronize()
    done("kernels", t0)

    expected, k11_main, k14 = None, {}, None
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
        del pipe, dit, video
        torch.cuda.empty_cache()
        done("breakdown", t0)

        t0 = phase("speed")
        speed = speed_phase(te, te_cfg, vae, vae_cfg)
        launches = {k: launches[k] + speed[k] for k in launches}
        print(f"  launches, serving, the flagship request, training, its surface and the speed "
              f"modes: {launches}", flush=True)
        del te, vae
        torch.cuda.empty_cache()
        done("speed", t0)

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
        sdxl_launches, sdxl_models, sd15_shared = sdxl_phase()
        launches = {k: launches[k] + sdxl_launches[k] for k in launches}
        print(f"  launches, serving, training, FLUX.1, Z-Image and SDXL: {launches}", flush=True)
        done("sdxl", t0)

        t0 = phase("sdxl_train")
        sdxl_train_launches = sdxl_train_phase(**sdxl_models)
        launches = {k: launches[k] + sdxl_train_launches[k] for k in launches}
        print(f"  launches, serving, training, FLUX.1, Z-Image, SDXL and its training: "
              f"{launches}", flush=True)
        del sdxl_models
        torch.cuda.empty_cache()
        done("sdxl_train", t0)

        t0 = phase("sd15")
        sd15_launches = sd15_phase(**sd15_shared)
        launches = {k: launches[k] + sd15_launches[k] for k in launches}
        print(f"  launches, serving, training, FLUX.1, Z-Image, SDXL, its training and SD1.5: "
              f"{launches}", flush=True)
        del sd15_shared
        torch.cuda.empty_cache()
        done("sd15", t0)

        t0 = phase("sd_fp32")
        sd_f32_launches, sd_f32 = sd_fp32_phase()
        launches = {k: launches[k] + sd_f32_launches[k] for k in launches}
        print(f"  launches, serving, training, FLUX.1, Z-Image, SDXL, its training, SD1.5 and "
              f"the fp32 SDXL and SD1.5 requests: {launches}", flush=True)
        print("sd_fp32: " + json.dumps(sd_f32), flush=True)
        done("sd_fp32", t0)

        t0 = phase("dora")
        dora_launches = dora_phase()
        launches = {k: launches[k] + dora_launches[k] for k in launches}
        print(f"  launches, serving, training, FLUX.1, Z-Image, SDXL and its DoRA front end: "
              f"{launches}", flush=True)
        done("dora", t0)

        t0 = phase("variants")
        k14, variant_launches = variants_phase()
        launches = {k: launches[k] + variant_launches[k] for k in launches}
        print(f"  launches, serving, training, FLUX.1, Z-Image, SDXL, its DoRA front end and "
              f"the Wan variants: {launches}", flush=True)
        done("variants", t0)

        t0 = phase("conditioning")
        kc["vae_rms_silu"], cond_launches, shared = conditioning_phase()
        launches = {k: launches[k] + cond_launches[k] for k in launches}
        print(f"  launches, with the conditioned Wan variants: {launches}", flush=True)
        done("conditioning", t0)

        t0 = phase("animate_vap_longcat")
        avl_launches = animate_vap_longcat_phase(shared)
        del shared
        launches = {k: launches[k] + avl_launches[k] for k in launches}
        print(f"  launches, with Animate, VAP and LongCat: {launches}", flush=True)
        done("animate_vap_longcat", t0)

        t0 = phase("reference")
        reference_check()
        reference_from_pretrained_check()
        reference_train_check()
        reference_flux_check()
        reference_zimage_check()
        reference_sdxl_check()
        reference_sdxl_train_check()
        reference_sd15_check()
        reference_fp32_goldens_check()
        reference_dora_check()
        reference_speed_check()
        reference_conditioning_check()
        reference_avl_check()
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
        if k14:  # the 14B DiTs' shapes (variants phase): 40 heads, D = 5120, S = 7800
            shapes = {"S=7800": k14[k]}
            shapes.update({tag.split(" ", 1)[1]: v for tag, v in k14.items()
                           if tag.startswith(k + " ")})
            rows[-1]["wan14b"] = {tag: {"ms": v["ms"], "device_ms": v.get("device_ms"),
                                        "plain_ms": v["plain_ms"], "bound_ms": v["bound"][0],
                                        "bound_by": v["bound"][1], "library_ms": v["library_ms"],
                                        "max_abs_err": v["max_abs_err"]}
                                  for tag, v in shapes.items()}
            rows[-1]["max_abs_err"] = max([rows[-1]["max_abs_err"]] +
                                          [v["max_abs_err"] for v in shapes.values()])
        shapes = {tag.split(" ", 1)[1]: v for tag, v in kc.items() if tag.startswith(k + " ")}
        if shapes:  # the conditioned variants' new shapes: S2V's tables, S = 9360, the injector
            rows[-1]["conditioning"] = {
                tag: {"ms": v["ms"], "device_ms": v["device_ms"], "plain_ms": v["plain_ms"],
                      "bound_ms": v["bound"][0], "bound_by": v["bound"][1],
                      "library_ms": v["library_ms"], "max_abs_err": v["max_abs_err"]}
                for tag, v in shapes.items()}
            rows[-1]["max_abs_err"] = max([rows[-1]["max_abs_err"]] +
                                          [v["max_abs_err"] for v in shapes.values()])
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
                                        "differ": v["differ"],
                                        "issue_bound_ms": v.get("issue_ms")}
                         for (n, tag), v in norm_k[k].items()}})
        if k == "vae_rms_silu" and k11_other:
            rows[-1]["ab_lib_device_ms"] = k11_other
        if k == "vae_rms_silu" and k11_main:
            rows[-1]["max_abs_err"] = max([rows[-1]["max_abs_err"]] +
                                          [v["max_abs_err"] for v in k11_main.values()])
            rows[-1]["main_path_shapes"] = {
                tag: {"calls": v["calls"], "ms": v["ms"], "device_ms": v["device_ms"],
                      "plain_ms": v["plain_ms"], "bound_ms": v["bound"][0],
                      "issue_bound_ms": v["issue_ms"], "max_abs_err": v["max_abs_err"],
                      "differ": v["differ"]}
                for tag, v in k11_main.items()}
            rows[-1]["main_path_device_ms_total"] = sum(v["calls"] * v["device_ms"]
                                                        for v in k11_main.values())
            rows[-1]["main_path_bound_ms_total"] = sum(v["calls"] * v["bound"][0]
                                                       for v in k11_main.values())
        if k == "vae_rms_silu" and "vae_rms_silu" in kc:  # the conditioning phase's shapes
            rows[-1]["wan21_vae_conditioning"] = kc["vae_rms_silu"]
            rows[-1]["max_abs_err"] = max([rows[-1]["max_abs_err"]] +
                                          [v["max_abs_err"] for v in kc["vae_rms_silu"].values()])
        if k == "vae_rms_silu" and k14:  # the Wan2.1 VAE's widest shapes (variants phase)
            rows[-1]["wan21_vae"] = k14["vae_rms_silu wan21"]
            rows[-1]["max_abs_err"] = max([rows[-1]["max_abs_err"]] +
                                          [v["max_abs_err"] for v in k14["vae_rms_silu wan21"]
                                           .values()])
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
    for k, main_shape in SD15_MAIN_SHAPE.items():
        by = sd15_k[k]
        r = by[main_shape]
        rows.append({
            "name": k, "route": "cuda",
            "source": "fairygen_tpu_torch/csrc/flash_attention_online.cu",
            "replaces": "fairygen_tpu/ops/flash_attention.py:" + ("35" if k.startswith(
                "flash_fwd") else "133"),
            "launches": None if expected is None else launches[k],
            "max_abs_err": max(v["max_abs_err"] for v in by.values()), "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound"][0], "bound_by": r["bound"][1],
            "library_ms": r["library_ms"], "shape": main_shape, "device_ms": r["device_ms"],
            "ops_by": r["ops_by"], "rel_l2": max(v["rel_l2"] for v in by.values()),
            "by_shape": {tag: {"ms": v["ms"], "device_ms": v["device_ms"],
                               "plain_ms": v["plain_ms"], "bound_ms": v["bound"][0],
                               "bound_by": v["bound"][1], "ops_by": v["ops_by"],
                               "exp2_ms": v["exp2_ms"], "library_ms": v["library_ms"],
                               "max_abs_err": v["max_abs_err"], "rel_l2": v["rel_l2"]}
                         for tag, v in by.items()}})
    f32_sources = {"flash_fwd_lse_f32": "fairygen_tpu/ops/flash_attention.py:253",
                   "flash_bwd_dq_f32": "fairygen_tpu/ops/flash_attention.py:295",
                   "flash_bwd_dkv_f32": "fairygen_tpu/ops/flash_attention.py:329"}
    f32_files = {"flash_fwd_lse_f32": "flash_attention_fp32.cu",
                 "flash_bwd_dq_f32": "flash_attention_fp32_bwd.cu",
                 "flash_bwd_dkv_f32": "flash_attention_fp32_bwd.cu"}
    for k, replaces in f32_sources.items():
        by = f32_k[k]
        r = by["self 10x4096"]
        # on the tensor cores in three TF32 passes: the 3xTF32 bound, the
        # 67 TFLOP/s fp32 one beside it
        rows.append({
            "name": k, "route": "cuda", "source": "fairygen_tpu_torch/csrc/" + f32_files[k],
            "replaces": replaces, "launches": None if expected is None else launches[k],
            "max_abs_err": max(v["max_abs_err"] for v in by.values()), "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["tc_bound"][0],
            "bound_by": r["tc_bound"][1], "library_ms": r["library_ms"],
            "shape": "self 10x4096", "device_ms": r["device_ms"],
            "rel_l2": max(v["rel_l2"] for v in by.values()),
            "step_device_ms": sum(v["calls"] * v["device_ms"] for v in by.values()),
            "step_bound_ms": sum(v["calls"] * v["tc_bound"][0] for v in by.values()),
            "bound_ms_fp32_ffma": r["bound"][0],
            "step_bound_ms_fp32_ffma": sum(v["calls"] * v["bound"][0] for v in by.values()),
            "by_shape": {tag: {"calls": v["calls"], "ms": v["ms"], "device_ms": v["device_ms"],
                               "device_parts": v["device_parts"], "plain_ms": v["plain_ms"],
                               "bound_ms": v["tc_bound"][0], "bound_ms_fp32_ffma": v["bound"][0],
                               "library_ms": v["library_ms"],
                               "library_device_ms": v["library_device_ms"],
                               "max_abs_err": v["max_abs_err"], "rel_l2": v["rel_l2"]}
                         for tag, v in by.items()}})
        for tag, v in by.items():
            if "split_device_ms" in v:
                rows[-1]["by_shape"][tag]["split_device_ms"] = v["split_device_ms"]
        if f32_other and k in f32_other:
            rows[-1]["ab_lib_device_ms"] = f32_other[k]
    # the helpers on the fp32 tensor-core path: K6a's pre-pass, K6b and
    # K6c's (its K6b form at the self 10 x 4096 shape) and K6c's reduce pass
    # (the 10 x 4096 queries to 77 keys); none replaces a TPU kernel of its own
    helpers = {"flash_fwd_prep_f32": ("fairygen_tpu/ops/flash_attention.py:253",
                                      "self 10x4096", "flash_attention_fp32.cu",
                                      "K6a, K5 and K4's max and masked forms in fp32"),
               "flash_bwd_prep_f32": ("fairygen_tpu/ops/flash_attention.py:295",
                                      "self 10x4096, K6b form", "flash_attention_fp32_bwd.cu",
                                      "K6b and K6c in fp32"),
               "flash_bwd_dkv_reduce_f32": ("fairygen_tpu/ops/flash_attention.py:329",
                                            "cross 10x4096 q, 77 keys",
                                            "flash_attention_fp32_bwd.cu", "K6c in fp32")}
    for k, (replaces, main_shape, src, part) in helpers.items():
        by = f32_k[k]
        r = by[main_shape]
        rows.append({
            "name": k, "route": "cuda", "source": "fairygen_tpu_torch/csrc/" + src,
            "replaces": replaces, "part_of": part + " (bit for bit its plain version)",
            "launches": None if expected is None else launches[k], "max_abs_err": 0.0,
            "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound"][0],
            "bound_by": r["bound"][1], "library_ms": None, "shape": main_shape,
            "device_ms": r["device_ms"],
            "by_shape": {tag: {"ms": v["ms"], "device_ms": v["device_ms"],
                               "plain_ms": v["plain_ms"], "bound_ms": v["bound"][0]}
                         for tag, v in by.items()}})
    # K5 and K4's max and masked forms in fp32: device time of the wrapper
    # (the pre-pass and the kernel) at each row's shape, against the 3xTF32
    # bound, the 67 TFLOP/s one beside it
    for k, main_shape in F32_FWD_MAIN_SHAPE.items():
        by = f32_fwd_k[k]
        r = by[main_shape]
        rows.append({
            "name": k, "route": "cuda", "source": "fairygen_tpu_torch/csrc/flash_attention_fp32.cu",
            "replaces": "fairygen_tpu/ops/flash_attention.py:" + ("35" if k.startswith(
                "flash_fwd") else "133"),
            "launches": None if expected is None else launches[k],
            "max_abs_err": max(v["max_abs_err"] for v in by.values()), "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound"][0], "bound_by": r["bound"][1],
            "library_ms": r["library_ms"], "shape": main_shape, "device_ms": r["device_ms"],
            "device_parts": r["device_parts"], "ops_by": r["ops_by"],
            "bound_ms_fp32_ffma": r["bound_fp32_ffma"],
            "rel_l2": max(v["rel_l2"] for v in by.values()),
            "by_shape": {tag: {"ms": v["ms"], "device_ms": v["device_ms"],
                               "plain_ms": v["plain_ms"], "bound_ms": v["bound"][0],
                               "bound_by": v["bound"][1], "ops_by": v["ops_by"],
                               "bound_ms_fp32_ffma": v["bound_fp32_ffma"],
                               "library_ms": v["library_ms"], "max_abs_err": v["max_abs_err"],
                               "rel_l2": v["rel_l2"]}
                         for tag, v in by.items()}})
    d64_sources = {"flash_fwd_lse_d64": ("flash_attention_online.cu",
                                         "fairygen_tpu/ops/flash_attention.py:253"),
                   "flash_bwd_dq_d64": ("flash_attention_bwd.cu",
                                        "fairygen_tpu/ops/flash_attention.py:295"),
                   "flash_bwd_dkv_d64": ("flash_attention_bwd.cu",
                                         "fairygen_tpu/ops/flash_attention.py:329")}
    for k, (src, replaces) in d64_sources.items():
        by = d64_k[k]
        r = by["self 10x4096"]
        rows.append({
            "name": k, "route": "cuda", "source": "fairygen_tpu_torch/csrc/" + src,
            "replaces": replaces, "launches": None if expected is None else launches[k],
            "max_abs_err": max(v["max_abs_err"] for v in by.values()), "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound"][0], "bound_by": r["bound"][1],
            "library_ms": r["library_ms"], "shape": "self 10x4096", "device_ms": r["device_ms"],
            "exp2_ms": r["exp_ms"],
            "step_device_ms": sum(v["calls"] * v["device_ms"] for v in by.values()),
            "step_bound_ms": sum(v["calls"] * v["bound"][0] for v in by.values()),
            "by_shape": {tag: {key: v.get(key) for key in (
                "calls", "ms", "device_ms", "plain_ms", "exp_ms", "library_ms",
                "library_flash_ms", "library_cudnn_ms", "library_device_ms", "max_abs_err",
                "rel_l2")} | {"bound_ms": v["bound"][0], "bound_by": v["bound"][1]}
                for tag, v in by.items()}})
    for r in rows:  # the last Wan variants' new shapes (avl_kernel_checks)
        shapes = {tag.split(" ", 1)[1]: v for tag, v in avl.items()
                  if tag.split(" ", 1)[0] == r["name"]}
        if shapes:
            r["animate_vap_longcat"] = {
                tag: {key: v.get(key) for key in ("ms", "device_ms", "plain_ms", "library_ms",
                                                  "library_flash_ms", "library_cudnn_ms",
                                                  "max_abs_err", "rel_l2")}
                | {"bound_ms": v["bound"][0], "bound_by": v["bound"][1]}
                for tag, v in shapes.items()}
            r["max_abs_err"] = max([r["max_abs_err"]] + [v["max_abs_err"]
                                                         for v in shapes.values()])
    timer.cancel()
    print(smi)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": count}}))
    return 0



def speed_only():
    """The speed modes alone (``--speed-only``): UMT5-XXL and the VAE38,
    the speed phase with its requests at the flagship's 81 frames, the
    FLUX.1 and Z-Image phases with their W8A8 requests, and
    reference_speed_check."""
    import torch

    from fairygen_tpu_torch import convert
    from fairygen_tpu_torch.models.wan.text_encoder import UMT5Config
    from fairygen_tpu_torch.models.wan.vae import WanVAEConfig

    t0 = phase("weights")
    te_cfg, vae_cfg = UMT5Config.umt5_xxl(), WanVAEConfig.wan22_38()
    te = convert.init_umt5_params(te_cfg, "cuda", torch.bfloat16, seed=1)
    vae = convert.init_vae_params(vae_cfg, "cuda", torch.bfloat16, seed=2)
    done("weights", t0)
    for name, fn in (("speed", lambda: speed_phase(te, te_cfg, vae, vae_cfg, frames=81)),
                     ("flux", flux_phase), ("zimage", zimage_phase),
                     ("reference", reference_speed_check)):
        if name == "flux":
            del te, vae
            torch.cuda.empty_cache()
        t0 = phase(name)
        fn()
        done(name, t0)


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
    the EliGen request's under torch.profiler; then the DiT quantized to
    W8A8 (``pipe.quantize()``) and the seed-41 request again (image_w8a8).
    Returns the launches of the four requests."""
    import torch

    from fairygen_tpu_torch import convert
    from fairygen_tpu_torch.models.flux.dit import FluxDiTConfig, flux_dit_forward
    from fairygen_tpu_torch.models.flux.text_encoders import UMT5Config, flux_clip_l_config
    from fairygen_tpu_torch.models.sdxl.vae import AutoencoderKLConfig
    from fairygen_tpu_torch.ops import _kernels
    from fairygen_tpu_torch.pipelines import flux_image
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

    decoded, undo_decoded = capture_decoded(flux_image)
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

    # W8A8: the blocks' projections quantized (8 a double block, 2 a single
    # one), the seed-41 request again
    emb, pooled = prompt(41)
    del dit
    try:
        image_w8a8("FLUX.1-dev", pipe, request, FLUX_PER_SWEEP, FLUX_STEPS, 19 * 8 + 38 * 2,
                   decoded[0], decoded,
                   lambda: flux_dit_forward(pipe.dit_params, dit_cfg, lat, t, emb, pooled, guid),
                   prompt_emb=emb, pooled_prompt_emb=pooled, seed=41)
    finally:
        undo_decoded()
    del pipe, t5, clip, vae
    torch.cuda.empty_cache()
    return total


TRAJECTORY_TEACHER_STEPS = 10  # cut from the default 50 to keep the smoke in its budget
DIRECT_DISTILL_STEPS = 2  # the direct step's rollout, cut from 4 likewise
TRAIN_PER_STEP = {"ln_modulate": 180, "rms_rope_heads_major": 180, "flash_bounded": 60,
                  "flash_small_kv": 60, "flash_fwd": 0, "flash_fwd_lse": 60,
                  "flash_bwd_dq": 60, "flash_bwd_dkv": 60, "rms_rope_per_head": 0,
                  "rms_rope_joint": 0, "flash_bias": 0, "rms_modulate": 0, "vae_rms_silu": 0,
                  "flash_small_kv_max": 0, "flash_small_kv_masked": 0, "flash_fwd_d64": 0,
                  "flash_fwd_lse_f32": 0, "flash_bwd_dq_f32": 0, "flash_bwd_dkv_f32": 0,
                  "flash_bwd_prep_f32": 0, "flash_bwd_dkv_reduce_f32": 0,
                  "flash_fwd_prep_f32": 0, "flash_fwd_lse_d64": 0, "flash_bwd_dq_d64": 0,
                  "flash_bwd_dkv_d64": 0, **{f"{form}_d{d}": 0 for form in (
                      "flash_fwd", "flash_small_kv_max", "flash_small_kv_masked")
                                             for d in (8, 40, 80, 160)},
                  **{f"{form}_f32_d{d}": 0 for form in (
                      "flash_fwd", "flash_small_kv_max", "flash_small_kv_masked")
                     for d in (8, 16, 40, 64, 80, 160)}}


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
        # the device's activity only: a step runs ~36,000 kernels, and the
        # tracer sorts the host ops' records for seconds (sdxl_train_phase)
        acts = [torch.profiler.ProfilerActivity.CUDA]
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
    3. resume: one step, ``save_train_state``, a fresh state restored, one
       step, against two straight steps (cut from two and one against three
       to keep the smoke in its budget): the adapters bit for bit;
    4. one direct_distill step: a DIRECT_DISTILL_STEPS-step student rollout
       (2, cut from 4) at S = 8190 with gradients through every sweep;
    5. one trajectory step at 17 frames (S = 1950): a
       TRAJECTORY_TEACHER_STEPS-step teacher rollout (10, cut from the
       default 50) and 4 student sweeps;
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
        state, _, _ = measured("2 straight stage-1 steps", lambda: run(state, gen, 2),
                               times(TRAIN_PER_STEP, 2))
        straight = [t.detach().clone() for t in state.trainable]
        del state
        torch.cuda.empty_cache()
        ckpt = os.path.join(tmp.name, "state.pt")
        state, gen = fresh()
        state, _, _ = measured("1 stage-1 step", lambda: run(state, gen, 1),
                               times(TRAIN_PER_STEP, 1))
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
            cfg, make_optimizer("adamw", 1e-4, 0.01), method="direct",
            num_inference_steps=DIRECT_DISTILL_STEPS, remat=True, first_frame_clean=True,
            trainable_filter=lora_trainable_filter(("A", "B")))
        (state, loss), _, _ = measured(
            f"direct_distill step ({DIRECT_DISTILL_STEPS}-step rollout, S = 8190, gradients "
            f"through all)", lambda: dstep(dinit(student), batch, g),
            times(TRAIN_PER_STEP, DIRECT_DISTILL_STEPS))
        finite("direct_distill", loss)
        print(f"  direct_distill loss {float(loss):.6f}", flush=True)
        del state, loss

        # 5. trajectory at 17 frames (S = 1950), TRAJECTORY_TEACHER_STEPS
        # teacher steps
        tinit, tstep = make_wan_distill_train_step(
            cfg, make_optimizer("adamw", 1e-4, 0.01), method="trajectory",
            num_inference_steps=4, num_teacher_steps=TRAJECTORY_TEACHER_STEPS, remat=True,
            first_frame_clean=True,
            trainable_filter=lora_trainable_filter(("A", "B")))
        small = {"latents": torch.randn((1, 48, 5, 30, 52), generator=g,
                                        device="cuda").to(torch.bfloat16),
                 "context": batch["context"]}
        want = times(TRAIN_PER_STEP, 4)
        for k, v in FLAGSHIP_PER_SWEEP.items():  # a no-grad sweep's, at any S
            want[k] += TRAJECTORY_TEACHER_STEPS * v
        (state, loss), _, _ = measured(
            f"trajectory step ({TRAJECTORY_TEACHER_STEPS} teacher sweeps, 4 student sweeps, "
            f"S = 1950)",
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
    """Device time by kernel name from a torch.profiler run (or from its
    key_averages, a list, where the caller reads them too: each
    key_averages of a trace of tens of thousands of kernels takes seconds),
    the device's busy share of ``wall`` seconds, the number of kernels the
    device ran, the ``top`` busiest kernels with their shares of the busy
    time, then the other kernels whose names hold a string of ``also``."""
    import torch

    rows = []  # device-side events only: the kernels themselves (not the
    # spans of record_function ranges, which the tracer also puts there)
    for e in (prof if isinstance(prof, list) else prof.key_averages()):
        if e.device_type == torch.autograd.DeviceType.CUDA and e.key not in W8A8_RANGES:
            rows.append((e.self_device_time_total, e.count, e.key))
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows) / 1e6
    print(f"  {label}: wall {wall * 1e3:.2f} ms, device busy {busy * 1e3:.2f} ms "
          f"({100 * busy / wall:.1f}% busy), {sum(r[1] for r in rows)} kernels")
    for i, (dev_us, count, key) in enumerate(rows):
        if i < top or any(a in key for a in also):
            print(f"    {dev_us / 1e3:9.3f} ms {100 * dev_us / 1e6 / busy:5.1f}%  x{count:<5d} "
                  f"{key[:100]}")
    return busy


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
    """K11 launches of one encoder pass and one decoder pass of the VAE38
    or the Wan2.1 VAE: the channel norm + SiLU of each residual block
    (two), of the two middle blocks and of the head."""
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
    """Count the shapes the VAE hands K11 (through the name its module
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
            bound=bound_ms(2 * x.numel() * 2 + c * 2, 10 * x.numel(), H100_FP32_FLOP_PER_S),
            issue_ms=k11_issue_ms(x.view(-1, c)))
        del x, out, ref
    torch.cuda.empty_cache()
    for tag, r in res.items():
        print(f"  K11 main path {tag} x{r['calls']}: ms {r['ms']:.4f} device_ms "
              f"{r['device_ms']:.4f} plain_ms {r['plain_ms']:.4f} bound_ms {r['bound'][0]:.4f} "
              f"({r['bound'][1]}) issue bound {r['issue_ms']}", flush=True)
    total = {key: sum(r["calls"] * (r[key][0] if key == "bound" else r[key])
                      for r in res.values()) for key in ("device_ms", "ms", "bound", "plain_ms")}
    issue = (None if any(r["issue_ms"] is None for r in res.values()) else
             sum(r["calls"] * r["issue_ms"] for r in res.values()))
    print(f"  K11 over the request's {sum(r['calls'] for r in res.values())} calls: device "
          f"{total['device_ms']:.2f} ms, events {total['ms']:.2f} ms, bound "
          f"{total['bound']:.2f} ms ({total['device_ms'] / total['bound']:.2f}x by device "
          f"time), issue bound {issue} ms, plain {total['plain_ms']:.2f} ms", flush=True)
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
    if k11_shapes != K11_FLAGSHIP_SHAPES:
        raise RuntimeError(f"K11's shapes in the flagship request {k11_shapes} are not "
                           f"K11_FLAGSHIP_SHAPES, which the A/B (k11_ab) times")
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
            for rep in (1,):  # in turns, once (twice before the conditioning phase came)
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


# ----------------------------------------------------------- speed modes
H100_INT8_OP_PER_S = 1979e12  # dense int8 tensor cores, NVIDIA H100 SXM data sheet
SPEED_STEPS = 4
SPEED_FRAMES = 17  # the whole smoke's; --speed-only runs the flagship's 81
TEA_STEPS = 20
TEA_MODEL_ID = "Wan2.2-TI2V-5B"
TEA_TARGET_CALC_FRAC = 0.5
# (label, rows, in, out): the flagship sweep's FFN products at S = 8190
INT_MM_SHAPES = (("fc1 8190x3072x14336", 8190, 3072, 14336),
                 ("fc2 8190x14336x3072", 8190, 14336, 3072))
W8A8_RANGES = ("w8a8.quantize", "w8a8.int_mm", "w8a8.rescale", "w8a8.outliers")
# _int_mm calls of one Wan DiT sweep per block: the FFN (2), or every block
# projection (self q, k, v, o, cross q, o, FFN 2) with the cross k and v
# projected once per context per block
WAN_INT_MM = {"int8_ffn": (2, 0), "int8": (8, 2)}


def tree_bytes(tree):
    """Bytes of every tensor in a nested dict / list."""
    if isinstance(tree, dict):
        return sum(tree_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(tree_bytes(v) for v in tree)
    return tree.numel() * tree.element_size() if hasattr(tree, "numel") else 0


def profiled(label, fn, top=12, warm=True):
    """One warm call of ``fn`` (with ``warm``), then one under torch.profiler: device_table
    (the int8 GEMM's kernels named too) and the device time of the W8A8
    passes' record_function ranges (ops/quant.py) and of aten::_int_mm.
    Returns (busy ms, {range: (device ms, calls)}): a range's device ms is
    the time of the kernels launched inside it."""
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.no_grad():
        if warm:
            fn()
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=acts) as prof:
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
    averages = list(prof.key_averages())
    busy = device_table(averages, wall, label, top, also=("s8", "i8", "imma", "int8"))
    ranges = {e.key: (e.device_time_total / 1e3, e.count) for e in averages
              if e.device_type == torch.autograd.DeviceType.CPU
              and (e.key in W8A8_RANGES or e.key == "aten::_int_mm")}
    for k, (ms, n) in sorted(ranges.items()):
        print(f"    {k}: {ms:.3f} ms of device time, {n} calls ({100 * ms / 1e3 / busy:.1f}% "
              f"of the busy time)", flush=True)
    return busy * 1e3, ranges


def int_mm_checks():
    """torch._int_mm at the flagship FFN shapes: the port's layout (weight
    column-major) against a row-major weight (the same int32 products
    required), by CUDA events and device time, beside the int8 bound
    (2·M·K·N at 1,979 TOPS, or the bytes: int8 operands in, int32 out) and
    the bf16 product of the same shape; then the whole plain W8A8 dense
    (ops.quant.quantized_dense: quantizer, _int_mm, rescale) against the
    bf16 product, and on 300 rows its int32 products and its output bit for
    bit the CPU's."""
    import torch

    from fairygen_tpu_torch.ops import quant

    g = torch.Generator("cuda").manual_seed(80)
    out = {}
    for label, m, k, n in INT_MM_SHAPES:
        a = torch.randint(-127, 128, (m, k), generator=g, device="cuda", dtype=torch.int8)
        w = torch.randint(-127, 128, (k, n), generator=g, device="cuda", dtype=torch.int8)
        wc = quant.int_mm_layout(w)
        same = torch.equal(torch._int_mm(a, w), torch._int_mm(a, wc))
        xb = (torch.randn((m, k), generator=g, device="cuda") * 0.5).to(torch.bfloat16)
        wb = (torch.randn((k, n), generator=g, device="cuda") * k ** -0.5).to(torch.bfloat16)
        qp = quant.quantize_dense_params({"w": wb})
        ops = 2 * m * k * n
        r = {"ms": time_ms(lambda: torch._int_mm(a, wc)),
             "device_ms": sum(device_trace(lambda: torch._int_mm(a, wc), 20).values()),
             "row_major_b_ms": time_ms(lambda: torch._int_mm(a, w), 5, 3),
             "bf16_mm_ms": time_ms(lambda: xb @ wb),
             "quantized_dense_ms": time_ms(lambda: quant.quantized_dense(qp, xb), 5, 5),
             "bound": bound_ms(m * k + k * n + 4 * m * n, ops, H100_INT8_OP_PER_S),
             "bf16_bound_ms": ops / H100_BF16_FLOP_PER_S * 1e3}
        r["tops"] = ops / r["device_ms"] / 1e9
        qc = {kk: v.cpu() for kk, v in qp.items()}
        acc_same = torch.equal(quant.int8_matmul(a[:300], wc).cpu(),
                               quant.int8_matmul(a[:300].cpu(), wc.cpu()))
        dense_same = torch.equal(quant.quantized_dense(qp, xb[:300]).cpu(),
                                 quant.quantized_dense(qc, xb[:300].cpu()))
        print(f"  torch._int_mm {label}: {r['ms']:.3f} ms (events), {r['device_ms']:.3f} ms "
              f"device ({r['tops']:.0f} TOPS), bound {r['bound'][0]:.3f} ms ({r['bound'][1]}; "
              f"{100 * r['bound'][0] / r['device_ms']:.0f}% of it); with a row-major weight "
              f"{r['row_major_b_ms']:.3f} ms (the same products: {same}); the bf16 product "
              f"{r['bf16_mm_ms']:.3f} ms (bf16 bound {r['bf16_bound_ms']:.3f} ms); the whole "
              f"plain W8A8 dense {r['quantized_dense_ms']:.3f} ms; on 300 rows the card's "
              f"int32 products equal the CPU's: {acc_same}, its W8A8 output the CPU's: "
              f"{dense_same}", flush=True)
        if not (same and acc_same and dense_same):
            raise RuntimeError(f"torch._int_mm {label}: the layouts, or the card and the CPU, "
                               f"disagree ({same}, {acc_same}, {dense_same})")
        out[label] = r
        del a, w, wc, xb, wb, qp
    torch.cuda.empty_cache()
    return out


def tea_replay(coeffs, xs, thresh, n):
    """The replayed schedule, and at each step the rule decides (not the
    first or the last) the replayed accumulator and its distance from
    ``thresh``, relative."""
    import numpy as np

    from fairygen_tpu_torch.training.tea_cache_experiment import simulate_calc_schedule

    mask = simulate_calc_schedule(coeffs, xs, thresh, n)
    acc, rows, c32 = np.float32(0), [], np.asarray(coeffs, np.float32)
    for i in range(1, n):
        acc = np.float32(acc + np.polyval(c32, np.float32(xs[i - 1])))
        if i < n - 1:
            rows.append((i, float(acc), abs(float(acc) - thresh) / abs(thresh)))
        if mask[i]:
            acc = np.float32(0)
    return mask, rows


def spy_tea_decisions():
    """Wrap utils.tea_cache.tea_cache_blocks to record, per gated sweep,
    whether the block stack ran.  Returns (the list, a function that
    undoes it)."""
    from fairygen_tpu_torch.utils import tea_cache

    real, decided = tea_cache.tea_cache_blocks, []

    def spy(state, x, t_mod, blocks_fn, **opts):
        ran = []
        out = real(state, x, t_mod, lambda v: ran.append(1) or blocks_fn(v), **opts)
        decided.append(bool(ran))
        return out

    tea_cache.tea_cache_blocks = spy

    def undo():
        tea_cache.tea_cache_blocks = real

    return decided, undo


def speed_phase(te, te_cfg, vae, vae_cfg, frames=SPEED_FRAMES):
    """The serving speed modes of the Wan2.2-TI2V-5B DiT at full width
    (dim 3072, 30 layers) from seeded bf16 weights (seed 0, made anew for
    each W8A8 mode, since quantizing consumes them): torch._int_mm at the
    FFN shapes (int_mm_checks); a 480x832, ``frames``-frame, 4-step, CFG 5
    bf16 request with the first image and the streamed decode; a 10-step
    dense rollout's samples (rollout_calibration_samples) through
    calibrate_wan_dit_act_amax; TeaCache: calibrate_wan_tea_cache over one
    20-step rollout, its coefficients registered as "Wan2.2-TI2V-5B",
    pick_threshold for half the steps and a 20-step CFG 5 request at that
    threshold (the steps it computed equal the replayed schedule's within
    one boundary step, its launches exact for the sweeps it computed);
    then the bf16 request again with the DiT quantized to "int8_ffn", to
    "int8" and to "int8" with the calibrated act_amax and
    outlier_k={"ffn": {"fc2": 8}}.  Each request: wall, the DiT's weight
    bytes, peak memory, exact launches (and _int_mm calls), and the final
    latents' relative L2 to the bf16 request's (a number to record: the
    weights are random); each mode one profiled sweep at the flagship's
    S = 8190 (busy time, kernels, the W8A8 passes by name).  The whole
    smoke runs the requests and rollouts at 17 frames (S = 1950), to stay
    in its budget on a slow host; ``--speed-only`` at the flagship's 81.
    Returns the phase's launches."""
    import numpy as np
    import torch

    from fairygen_tpu_torch import convert
    from fairygen_tpu_torch.models.wan.dit import WanDiTConfig, precompute_cross_kv, wan_dit_forward
    from fairygen_tpu_torch.ops import _kernels, quant
    from fairygen_tpu_torch.pipelines.wan_video import WanVideoPipeline
    from fairygen_tpu_torch.training.quant_experiment import (calibrate_wan_dit_act_amax,
                                                              rollout_calibration_samples)
    from fairygen_tpu_torch.training.tea_cache_experiment import (pick_threshold,
                                                                   simulate_calc_schedule)
    from fairygen_tpu_torch.utils.tea_cache_calibration import (calibrate_wan_tea_cache,
                                                                register_tea_cache_coefficients)

    bf, gib = torch.bfloat16, 2 ** 30
    cfg = WanDiTConfig.ti2v_5b()
    start = time.perf_counter()

    def mark(what):
        print(f"  ({what}: {time.perf_counter() - start:.1f} s into the phase)", flush=True)

    report = {"int_mm": int_mm_checks()}
    mark("_int_mm checked")
    total = {k: 0 for k in _kernels.launches}
    enc_norms, dec_norms = vae_norm_silu_calls(vae_cfg)

    def fresh():
        torch.cuda.empty_cache()
        dit = convert.init_dit_params(cfg, "cuda", bf, seed=0)
        return WanVideoPipeline(dit, cfg, vae, vae_cfg, te, te_cfg, bf, "cuda")

    pipe = fresh()
    ids, mask, nids, nmask = seeded_prompt(51, te_cfg.vocab)
    ctx, nctx = pipe.encode_ids(ids, mask), pipe.encode_ids(nids, nmask)
    image = seeded_image(51, 480, 832)
    g = torch.Generator("cuda").manual_seed(51)
    lat_s = torch.randn((1, 48, 21, 30, 52), generator=g, device="cuda").to(bf)
    lat_f, size = (frames - 1) // 4 + 1, f"480x832x{frames}"
    t_s = torch.tensor([500.0], device="cuda")

    def request(pipe, label, steps, sweeps=None, int_mm=0, **kw):
        """One request with the streamed decode.  Its launches must be
        K1-K4's for ``sweeps`` DiT sweeps (None: the sweeps the TeaCache
        gate computed), K11's for the first frame and a decode chunk a
        latent frame, and ``int_mm`` _int_mm calls.  Returns (final
        latents, report, gate decisions)."""
        kept, walls = capture_latents(pipe), {}
        wrap_timed(pipe, "_denoise", walls)
        decided, undo = spy_tea_decisions()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _kernels.reset_launches()
        quant.reset_launches()
        try:
            t = time.perf_counter()
            video = pipe(context=ctx, negative_context=nctx, input_image=image, seed=51,
                         height=480, width=832, num_frames=frames, cfg_scale=5.0,
                         num_inference_steps=steps, streaming_vae=True,
                         output_type="floatpoint", **kw)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
        finally:
            undo()
            del pipe._decode_output, pipe._denoise
        if sweeps is None:
            sweeps = sum(decided)
        want = {k: FLAGSHIP_PER_SWEEP.get(k, 0) * sweeps for k in _kernels.launches}
        want["vae_rms_silu"] = enc_norms + lat_f * dec_norms
        got, n_int_mm = dict(_kernels.launches), quant.launches["int_mm"]
        finite = bool(torch.isfinite(video).all())
        r = {"request_s": wall, "denoise_s": walls["_denoise"], "sweeps": sweeps,
             "peak_gib": torch.cuda.max_memory_allocated() / gib,
             "dit_gib": tree_bytes(pipe.dit_params) / gib, "int_mm_calls": n_int_mm}
        print(f"  {label}: {wall:.3f} s (denoise {r['denoise_s']:.3f} s, {sweeps} DiT sweeps), "
              f"DiT weights {r['dit_gib']:.3f} GiB, max_memory_allocated {r['peak_gib']:.2f} "
              f"GiB, output {tuple(video.shape)}, all finite: {finite}, launches "
              f"{ {k: v for k, v in got.items() if v} }, _int_mm {n_int_mm}", flush=True)
        if tuple(video.shape) != (1, 3, frames, 480, 832) or not finite:
            raise RuntimeError(f"{label}: output has the wrong shape or non-finite values")
        if got != want or n_int_mm != int_mm:
            raise RuntimeError(f"{label}: launches {got}, _int_mm {n_int_mm} != expected "
                               f"{want}, {int_mm}")
        for k, v in got.items():
            total[k] += v
        return kept[0], r, decided

    def sweep_of(pipe):
        kv = precompute_cross_kv(pipe.dit_params, cfg, ctx)
        return lambda: wan_dit_forward(pipe.dit_params, cfg, lat_s, t_s, cross_kv=kv,
                                       fuse_vae_embedding_in_latents=True)

    report["frames"] = frames
    ref_lat, report["bf16"], _ = request(pipe, f"bf16 request ({size}, 4 steps, CFG 5)",
                                         SPEED_STEPS, 2 * SPEED_STEPS)
    report["bf16"]["sweep_busy_ms"], _ = profiled("profiled bf16 DiT sweep (S=8190)",
                                                  sweep_of(pipe))
    mark("bf16 request and sweep")

    # W8A8 calibration: three points of a 10-step dense rollout, each through
    # the blocks under the channel-amax tap
    noise = torch.randn((1, 48, lat_f, 30, 52), generator=torch.Generator("cuda").manual_seed(52),
                        device="cuda").to(bf)
    torch.cuda.synchronize()
    t = time.perf_counter()
    samples = rollout_calibration_samples(pipe.dit_params, cfg, noise, ctx, rollout_steps=10)
    act_amax = calibrate_wan_dit_act_amax(pipe.dit_params, cfg, samples)
    torch.cuda.synchronize()
    report["act_amax_s"] = time.perf_counter() - t
    fc2 = act_amax["ffn"]["fc2"]
    report["fc2_amax_over_median"] = float((fc2.max(-1) / np.median(fc2, -1)).max())
    print(f"  act_amax from {len(samples)} samples of a 10-step rollout in "
          f"{report['act_amax_s']:.3f} s: {sum(len(v) for v in act_amax.values())} denses a "
          f"block, ffn.fc2 {fc2.shape}, its largest channel over the median "
          f"{report['fc2_amax_over_median']:.2f}", flush=True)
    del samples
    mark("act_amax")

    # TeaCache: calibrate, pick the threshold, then the gated request
    torch.cuda.synchronize()
    t = time.perf_counter()
    coeffs, (xs, ys) = calibrate_wan_tea_cache(pipe.dit_params, cfg, [noise], [ctx],
                                               num_inference_steps=TEA_STEPS)
    report["tea_calibration_s"] = time.perf_counter() - t
    del noise
    register_tea_cache_coefficients(TEA_MODEL_ID, coeffs)
    thresh = pick_threshold(coeffs, xs, TEA_STEPS, TEA_TARGET_CALC_FRAC)
    replay, margins = tea_replay(coeffs, xs, thresh, TEA_STEPS)
    print(f"  TeaCache calibration over one {TEA_STEPS}-step rollout: "
          f"{report['tea_calibration_s']:.3f} s; coefficients {coeffs}; t_mod drift "
          f"{xs.min():.4e}..{xs.max():.4e}, output drift {ys.min():.4e}..{ys.max():.4e}; "
          f"threshold {thresh!r} for {TEA_TARGET_CALC_FRAC} of the steps; replayed schedule "
          f"{replay.astype(int).tolist()}; the replayed accumulator (step, value, distance "
          f"from the threshold, relative) {[(i, a, d) for i, a, d in margins]}", flush=True)
    _, r, decided = request(pipe, f"TeaCache request ({size}, {TEA_STEPS} steps, CFG 5)",
                            TEA_STEPS, tea_cache_l1_thresh=thresh,
                            tea_cache_model_id=TEA_MODEL_ID)
    pos, neg = decided[0::2], decided[1::2]
    # the gate sums the drift on the card in fp32, the replay on the host:
    # pick_threshold leaves the threshold at a replayed accumulator, so that
    # step may go either way; the schedule must be the replay's at a
    # threshold within 1e-5 of the picked one
    near = {tuple(simulate_calc_schedule(coeffs, xs, thresh * f, TEA_STEPS).tolist())
            for f in (1 - 1e-5, 1.0, 1 + 1e-5)}
    flips = [i for i in range(TEA_STEPS) if pos[i] != replay[i]]
    r.update(threshold=thresh, coefficients=coeffs, computed_steps=sum(pos),
             skipped_sweeps=2 * TEA_STEPS - sum(decided), replay_steps=int(replay.sum()),
             flips=flips)
    print(f"  TeaCache request: computed {sum(pos)} of {TEA_STEPS} steps (the replay "
          f"{int(replay.sum())}), skipped {r['skipped_sweeps']} of {2 * TEA_STEPS} sweeps; "
          f"schedule {[int(d) for d in pos]}; steps where it differs from the replay "
          f"{flips}", flush=True)
    if len(decided) != 2 * TEA_STEPS or pos != neg or tuple(pos) not in near:
        raise RuntimeError(f"TeaCache request: the CFG branches' schedules {pos} / {neg} "
                           f"differ from each other or from the replay's at the threshold "
                           f"within 1e-5 ({sorted(near)})")
    report["tea_cache"] = r
    mark("TeaCache")

    # W8A8: the request again with the DiT quantized
    n = cfg.num_layers
    modes = (("int8_ffn", "int8_ffn", {}),
             ("int8", "int8", {}),
             ("int8 + act_amax", "int8", dict(act_amax=act_amax,
                                              outlier_k={"ffn": {"fc2": 8}})))
    for i, (label, mode, kw) in enumerate(modes):
        if i:
            del pipe
            pipe = fresh()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = tree_bytes(pipe.dit_params)
        t = time.perf_counter()
        pipe.quantize(mode, **kw)
        torch.cuda.synchronize()
        q = {"quantize_s": time.perf_counter() - t,
             "quantize_peak_gib": torch.cuda.max_memory_allocated() / gib,
             "dit_gib_before": before / gib}
        per_sweep, per_ctx = WAN_INT_MM[mode]
        lat, r, _ = request(pipe, f"W8A8 {label} request ({size}, 4 steps, CFG 5)",
                            SPEED_STEPS, 2 * SPEED_STEPS,
                            int_mm=n * (per_sweep * 2 * SPEED_STEPS + per_ctx * 2))
        r.update(q, rel_l2_to_bf16=rel_l2(lat, ref_lat))
        r["sweep_busy_ms"], r["ranges"] = profiled(f"profiled W8A8 {label} DiT sweep (S=8190)",
                                                   sweep_of(pipe))
        print(f"    quantized in {q['quantize_s']:.3f} s, peak {q['quantize_peak_gib']:.2f} GiB "
              f"while quantizing ({q['dit_gib_before']:.3f} GiB of bf16 DiT weights before); "
              f"the final latents' relative L2 to the bf16 request's "
              f"{r['rel_l2_to_bf16']:.4e}", flush=True)
        report[label] = r
        mark(label)
    del pipe
    torch.cuda.empty_cache()
    print("speed: " + json.dumps(report, default=float), flush=True)
    return total


def capture_decoded(module):
    """Keep the latents each call of ``module.vae_decode`` gets (the FLUX.1
    and Z-Image pipelines decode x / scaling + shift in fp32).  Returns
    (the list, a function that undoes it)."""
    kept, real = [], module.vae_decode

    def keep(params, cfg, z, *args, **kw):
        kept.append(z.detach().clone())
        return real(params, cfg, z, *args, **kw)

    module.vae_decode = keep
    return kept, lambda: setattr(module, "vae_decode", real)


def latents_of(z, vae_cfg):
    """The final latents x of a decode input z = x / scaling + shift."""
    return (z - vae_cfg.shift_factor) * vae_cfg.scaling_factor


def image_w8a8(label, pipe, request, want_per_sweep, steps, int_mm_per_sweep, ref_z, kept,
               sweep, **kw):
    """The image pipelines' W8A8 request: ``pipe.quantize()`` (timed, with
    its peak), ``request`` (the phase's own, exact kernel launches), its
    _int_mm calls, the final latents' relative L2 to the bf16 request's
    (both from what the decode got, ``ref_z`` and the last of ``kept``; a
    number to record: the weights are random) and one profiled sweep.
    Returns the report."""
    import torch

    from fairygen_tpu_torch.ops import quant

    gib = 2 ** 30
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = tree_bytes(pipe.dit_params)
    t = time.perf_counter()
    pipe.quantize()
    torch.cuda.synchronize()
    r = {"quantize_s": time.perf_counter() - t,
         "quantize_peak_gib": torch.cuda.max_memory_allocated() / gib,
         "dit_gib_before": before / gib, "dit_gib": tree_bytes(pipe.dit_params) / gib}
    quant.reset_launches()
    t = time.perf_counter()
    request(f"{label} W8A8 request", want_per_sweep, **kw)
    r.update(request_s=time.perf_counter() - t, int_mm_calls=quant.launches["int_mm"],
             peak_gib=torch.cuda.max_memory_allocated() / gib,
             rel_l2_to_bf16=rel_l2(latents_of(kept[-1], pipe.vae_cfg),
                                   latents_of(ref_z, pipe.vae_cfg)))
    if r["int_mm_calls"] != int_mm_per_sweep * steps:
        raise RuntimeError(f"{label} W8A8 request: {r['int_mm_calls']} _int_mm calls != "
                           f"{int_mm_per_sweep} x {steps}")
    r["sweep_busy_ms"], r["ranges"] = profiled(f"profiled {label} W8A8 sweep", sweep, 14)
    print(f"    {label} quantized in {r['quantize_s']:.3f} s (peak {r['quantize_peak_gib']:.2f} "
          f"GiB; DiT weights {r['dit_gib_before']:.3f} -> {r['dit_gib']:.3f} GiB); the request "
          f"{r['request_s']:.3f} s with {r['int_mm_calls']} _int_mm calls, peak "
          f"{r['peak_gib']:.2f} GiB; the final latents' relative L2 to the bf16 request's "
          f"{r['rel_l2_to_bf16']:.4e}", flush=True)
    print(f"{label} w8a8: " + json.dumps(r, default=float), flush=True)
    return r


def _middle_threshold(coeffs, xs, n):
    """A threshold in the middle (geometrically) of the widest run of a log
    grid over which the replayed schedule stays one that skips and
    computes a step the rule decides."""
    import numpy as np

    from fairygen_tpu_torch.training.tea_cache_experiment import simulate_calc_schedule

    grid = np.geomspace(1e-4, 1e2, 400)
    sched = [tuple(simulate_calc_schedule(coeffs, xs, v, n).tolist()) for v in grid]
    best, start = (0, 0, 0), 0
    for i in range(1, len(grid) + 1):
        if i == len(grid) or sched[i] != sched[start]:
            if 2 < sum(sched[start]) < n and i - start > best[0]:
                best = (i - start, start, i - 1)
            start = i
    if not best[0]:
        raise RuntimeError(f"no threshold skips and computes over the drifts {xs}")
    return float(np.sqrt(grid[best[1]] * grid[best[2]]))


def reference_speed_check():
    """The speed modes on a tiny head-dim-128 pipeline (reference_check's
    DiT and VAE) on the card in bf16 against the CPU, with reference_check's
    bar (relative L2 error to the CPU fp32 run at most twice the CPU bf16
    run's + 1e-3): quantized to "int8", 4 steps of CFG 5 (the card's
    _int_mm calls exact); and an 8-step TeaCache request over linear
    coefficients (the gate accumulates the drift itself) at a threshold in
    the middle of a run of one schedule over the fp32 drift trace, which
    the card, the CPU in bf16 and the CPU in fp32 must all compute."""
    import numpy as np
    import torch

    from fairygen_tpu_torch import convert
    from fairygen_tpu_torch.diffusion.flow_match import FlowMatchScheduler
    from fairygen_tpu_torch.models.wan.dit import WanDiTConfig, time_embedding
    from fairygen_tpu_torch.models.wan.vae import WanVAEConfig
    from fairygen_tpu_torch.ops import _kernels, quant
    from fairygen_tpu_torch.pipelines.wan_video import WanVideoPipeline
    from fairygen_tpu_torch.utils.tea_cache import TEACACHE_COEFFICIENTS

    cfg = WanDiTConfig(dim=256, in_dim=4, ffn_dim=512, out_dim=4, text_dim=64, freq_dim=64,
                       num_heads=2, num_layers=2, seperated_timestep=True,
                       require_vae_embedding=False, require_clip_embedding=False,
                       fuse_vae_embedding_in_latents=True)
    vae_cfg = WanVAEConfig.tiny()
    dit = convert.init_dit_params(cfg, "cpu", torch.float32, seed=3)
    vae = convert.init_vae_params(vae_cfg, "cpu", torch.float32, seed=4)
    g = torch.Generator("cpu").manual_seed(5)
    ctx, nctx = torch.randn(1, 40, 64, generator=g), torch.randn(1, 40, 64, generator=g)
    kw = dict(context=ctx, negative_context=nctx, input_image=seeded_image(6, 512, 512), seed=7,
              height=512, width=512, num_frames=17, cfg_scale=5.0, output_type="latents",
              torch_compat_noise=True)

    def run(dev, dt, mode=None, **extra):
        pipe = WanVideoPipeline(to(dit, dev, dt), cfg, to(vae, dev, dt), vae_cfg, dtype=dt,
                                device=dev)
        if mode:
            pipe.quantize(mode)
        _kernels.reset_launches()
        quant.reset_launches()
        out = pipe(**kw, **extra).float().cpu()
        return out, dict(_kernels.launches), quant.launches["int_mm"]

    def rel(a, b):
        return ((a - b).norm() / b.norm()).item()

    ref, _, _ = run("cpu", torch.float32, "int8", num_inference_steps=4)
    rel16 = rel(run("cpu", torch.bfloat16, "int8", num_inference_steps=4)[0], ref)
    out, ran, n_int_mm = run("cuda", torch.bfloat16, "int8", num_inference_steps=4)
    r, tol = rel(out, ref), 2 * rel16 + 1e-3
    print(f"  tiny W8A8 int8 pipeline: relative L2 error to CPU fp32 {r:.4e} (card bf16), "
          f"{rel16:.4e} (CPU bf16); tolerance {tol:.4e}; _int_mm {n_int_mm}, kernel launches "
          f"{ {k: v for k, v in ran.items() if v} }", flush=True)
    if n_int_mm != 2 * (8 * 8 + 2 * 2) or not ran["flash_bounded"] or not r <= tol:
        raise RuntimeError(f"tiny W8A8 pipeline: {r:.4e} > {tol:.4e}, or _int_mm {n_int_mm} "
                           f"!= 136, or the kernels did not run ({ran})")

    steps = 8
    ts = FlowMatchScheduler("Wan").set_timesteps(steps, shift=5.0).timesteps.astype(np.float32)
    tm = [time_embedding(dit, cfg, torch.tensor([[0.0, float(t)]]))[1] for t in ts]
    xs = [float((tm[i] - tm[i - 1]).abs().mean() / tm[i - 1].abs().mean())
          for i in range(1, steps)]
    linear = [0.0, 0.0, 0.0, 1.0, 0.0]
    thresh = _middle_threshold(linear, xs, steps)
    replay, margins = tea_replay(linear, xs, thresh, steps)
    TEACACHE_COEFFICIENTS["chip-smoke-linear"] = linear
    schedules, outs = {}, {}
    try:
        for dev, dt in (("cpu", torch.float32), ("cpu", torch.bfloat16),
                        ("cuda", torch.bfloat16)):
            decided, undo = spy_tea_decisions()
            try:
                outs[dev, dt] = run(dev, dt, num_inference_steps=steps,
                                    tea_cache_l1_thresh=thresh,
                                    tea_cache_model_id="chip-smoke-linear")[0]
            finally:
                undo()
            schedules[dev, dt] = [int(d) for d in decided[0::2]]
    finally:
        del TEACACHE_COEFFICIENTS["chip-smoke-linear"]
    ref = outs["cpu", torch.float32]
    rel16, r = rel(outs["cpu", torch.bfloat16], ref), rel(outs["cuda", torch.bfloat16], ref)
    tol = 2 * rel16 + 1e-3
    print(f"  tiny TeaCache request ({steps} steps, threshold {thresh:.4f}, the replayed "
          f"accumulator at least {min(d for _, _, d in margins):.3f} from it, relative): "
          f"schedules {schedules} (replay {replay.astype(int).tolist()}); relative L2 error "
          f"to CPU fp32 {r:.4e} (card bf16), {rel16:.4e} (CPU bf16); tolerance {tol:.4e}",
          flush=True)
    if len({tuple(v) for v in schedules.values()}) != 1 or \
            schedules["cuda", torch.bfloat16] != replay.astype(int).tolist() or not r <= tol:
        raise RuntimeError(f"tiny TeaCache request: schedules {schedules} differ from each "
                           f"other or the replay, or {r:.4e} > {tol:.4e}")


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


# the flagship request's K11 shapes (channels-last) and calls: the VAE38's
# first-frame encode and its 21 streamed decode chunks at 480x832x81
# (flagship_phase holds the request to them; k11_ab times both builds there)
K11_FLAGSHIP_SHAPES = {
    (1, 1, 240, 416, 160): 4, (1, 1, 120, 208, 160): 1, (1, 1, 120, 208, 320): 3,
    (1, 1, 60, 104, 320): 1, (1, 1, 60, 104, 640): 3, (1, 1, 30, 52, 640): 9,
    (1, 1, 30, 52, 1024): 210, (1, 1, 60, 104, 1024): 6, (1, 1, 120, 208, 1024): 1,
    (1, 1, 120, 208, 512): 5, (1, 1, 240, 416, 512): 1, (1, 1, 240, 416, 256): 6,
    (1, 2, 60, 104, 1024): 120, (1, 4, 120, 208, 1024): 20, (1, 4, 120, 208, 512): 100,
    (1, 4, 240, 416, 512): 20, (1, 4, 240, 416, 256): 120}
# the Wan2.1 VAE's shape with the most rows at each of its widths (the
# variants phase's 480x832x17 request)
K11_WAN21_WIDEST = ((1, 4, 480, 832, 96), (1, 4, 240, 416, 192), (1, 2, 120, 208, 384))
# warp instructions the H100 issues: four schedulers an SM, one a clock each,
# at the 1.98 GHz boost clock (NVIDIA H100 SXM data sheet), 132 SMs
H100_WARP_ISSUE_PER_S = 132 * 4 * 1.98e9
# K11's fast-path instructions an element, by (dtype, G, V, predicated), from
# the build's SASS (k11_build_report)
K11_ISSUE = {}


def sass_functions(obj, keep=lambda name: True):
    """{function: [(address, instruction), ...]} of an object file's SASS
    (cuobjdump -sass), for the functions whose names ``keep`` takes; {}
    where cuobjdump is missing."""
    import re
    import shutil

    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    tool = os.path.join(home, "bin", "cuobjdump")
    tool = tool if os.path.exists(tool) else shutil.which("cuobjdump")
    if not tool:
        return {}
    text = subprocess.run([tool, "-sass", str(obj)], capture_output=True, text=True,
                          timeout=120).stdout
    funcs = {}
    for part in re.split(r"\n\s*Function : ", text)[1:]:
        name, _, body = part.partition("\n")
        if not keep(name.strip()):
            continue
        funcs[name.strip()] = [(int(a, 16), i.strip())
                               for a, i in re.findall(r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", body)]
    return funcs


def k11_fast_path(ins, exps):
    """The instructions a lane issues in one pass of K11's consumer loop
    along its branch-free path: the loop is the shortest backward branch
    around ``exps`` MUFU.EX2 (the SiLU's exp, one an element of the pass);
    of its basic blocks, those that hold a CALL (the out-of-line __fdiv_rn,
    sqrt and reciprocal slow paths and the reference vector) are left out.
    Returns (instructions, the MUFU.EX2 among them), or None where no loop
    holds the exps."""
    import re

    ex2 = [i for i, (_, s) in enumerate(ins) if "MUFU.EX2" in s]
    at = {a: i for i, (a, _) in enumerate(ins)}
    leaders, loop = {0}, None
    for i, (a, s) in enumerate(ins):
        for target in re.findall(r"\b(?:BRA|BSSY|CALL\S*)\b[^;]*?(0x[0-9a-f]+)", s):
            t = at.get(int(target, 16))
            if t is None:
                continue
            leaders.add(t)
            if ("BRA" in s and t <= i and sum(t <= e <= i for e in ex2) >= exps
                    and (loop is None or i - t < loop[1] - loop[0])):
                loop = (t, i)
        if re.search(r"\b(BRA|CALL|EXIT|RET|BREAK)\b", s):
            leaders.add(i + 1)
    if loop is None:
        return None
    starts = sorted(x for x in leaders if loop[0] <= x <= loop[1]) + [loop[1] + 1]
    count = mufu = 0
    for a, b in zip(starts, starts[1:]):
        block = [s for _, s in ins[a:b]]
        if any("CALL" in s for s in block):
            continue
        count += len(block)
        mufu += sum("MUFU.EX2" in s for s in block)
    return count, mufu


def k11_build_report(log):
    """K11's instances (csrc/rms_modulate.cu): the registers and spills
    (ptxas -v) of each, and for the instances of both Wan VAEs' widths (in
    bf16) the dynamic shared memory of the ring and the instructions a lane
    issues per element along the pass loop's branch-free path (cuobjdump;
    the row's sum, norm, SiLU and store included; k11_fast_path), which
    gives the issue bound (k11_issue_ms).  Fills K11_ISSUE; fails on a
    spill or an instance ptxas did not report."""
    import re

    from fairygen_tpu_torch.ops import _kernels
    from fairygen_tpu_torch.ops import fused_norms as fn

    def key(name):  # (dtype, G, V, predicated, SiLU)
        m = re.search(r"vae_rms_silu_kernelI(13__nv_bfloat16|f)Li(\d+)ELi(\d+)ELb([01])ELb([01])E",
                      name)
        return m and ("bf16" if m.group(1) == "13__nv_bfloat16" else "fp32", int(m.group(2)),
                      int(m.group(3)), m.group(4) == "1", m.group(5) == "1")

    props, current = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            current = key(m.group(1))
            continue
        if current is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            props.setdefault(current, {})["spill_bytes"] = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            props.setdefault(current, {})["registers"] = int(m.group(1))
    want = {("bf16",) + fn.k11_instance(c, 2) + (True,)
            for c in (96, 160, 192, 256, 320, 384, 512, 640, 1024)}
    for k in sorted(props):
        print(f"  K11 {k[0]} G={k[1]} V={k[2]}{' predicated' if k[3] else ''}"
              f"{' SiLU' if k[4] else ''}: registers {props[k].get('registers')}, spill bytes "
              f"{props[k].get('spill_bytes')}", flush=True)
    bad = [k for k in want if props.get(k, {}).get("registers") is None]
    bad += [k for k, p in props.items() if p.get("spill_bytes") != 0]
    if bad:
        raise RuntimeError(f"K11: ptxas -v shows spills or no such instance: {bad}")
    lib = _kernels.lib()
    for name, ins in sass_functions(_kernels.BUILD_DIR / "rms_modulate.cu.o",
                                    lambda name: key(name) in want).items():
        k = key(name)
        if k in want:
            got = k11_fast_path(ins, k[2] * 8)
            if got is None or got[1] != k[2] * 8:
                raise RuntimeError(f"K11 {k}: no pass loop holding its {k[2] * 8} exps in its "
                                   f"SASS: {got}")
            K11_ISSUE[k[:4]] = got[0] / (k[2] * 8)
    for c in (96, 160, 192, 256, 320, 384, 512, 640, 1024):
        k = ("bf16",) + fn.k11_instance(c, 2)
        print(f"  K11 bf16 C={c} (G={k[1]}, V={k[2]}): dynamic shared memory "
              f"{lib.fg_vae_rms_silu_smem_bytes(c, 0, k[1])} bytes a block, "
              f"{2 if k[2] <= 5 else 1} blocks an SM; fast path "
              f"{K11_ISSUE.get(k, 'no cuobjdump')} instructions an element", flush=True)


def k11_issue_ms(x):
    """K11's issue bound on x (rows x C, bf16 or fp32): its elements x the
    fast path's instructions an element (K11_ISSUE) / 32 lanes over the
    card's warp-instruction rate; None where the build report has no count."""
    from fairygen_tpu_torch.ops import fused_norms as fn

    k = ({2: "bf16", 4: "fp32"}[x.element_size()],) + fn.k11_instance(x.shape[-1],
                                                                    x.element_size())
    if k not in K11_ISSUE:
        return None
    return x.numel() * K11_ISSUE[k] / 32 / H100_WARP_ISSUE_PER_S * 1e3


def k11_ab(other_path):
    """K11 of another build of the library (``--ab-lib``: an older tree's,
    through its C entry fg_vae_rms_silu with the first design's arguments
    (x, gamma, out, rows, C, silu, is_fp32, stream)) beside this build's
    wrapper on the same inputs: the flagship's 17 shapes, 399,360 x 256 and
    the Wan2.1 VAE's widest shape at 96, 192 and 384 channels (bf16, SiLU
    on, seeded as k11_main_path_checks' inputs).  Each build's output is
    held to the plain version by check_bracketed (its count of outputs that
    differ from it printed), the two builds' outputs are compared bit for
    bit, and device times (torch.profiler) taken in the order other, this,
    this, other; with the sum over the flagship's 630 calls of each build.
    Returns {shape: {"this"|"other": [device ms, ...], "differ_this",
    "differ_other", "same_bits"}, "flagship": {"this"|"other": ms}}."""
    import ctypes
    import statistics

    import torch

    from fairygen_tpu_torch.ops import fused_norms as fn

    p_, i_ = ctypes.c_void_p, ctypes.c_int
    other = ctypes.CDLL(os.path.abspath(other_path)).fg_vae_rms_silu
    other.argtypes, other.restype = [p_, p_, p_, i_, i_, i_, i_, p_], i_
    g = torch.Generator("cuda").manual_seed(925)
    res = {}
    shapes = list(K11_FLAGSHIP_SHAPES) + [(399360, 256)] + list(K11_WAN21_WIDEST)
    for shape in shapes:
        c = shape[-1]
        x = torch.randn(shape, generator=g, device="cuda").to(torch.bfloat16)
        gamma = (1 + 0.3 * torch.randn(c, generator=g, device="cuda")).to(torch.bfloat16)
        o_other = torch.empty_like(x)

        def call_other():
            rc = other(x.data_ptr(), gamma.data_ptr(), o_other.data_ptr(), x.numel() // c, c, 1,
                       0, torch.cuda.current_stream().cuda_stream)
            if rc:
                raise RuntimeError(f"the other build's fg_vae_rms_silu: cudaError {rc}")
            return o_other

        def call_this():
            return fn.fused_vae_rms_silu(x, gamma)

        tag = "x".join(map(str, shape))
        ref = fn.vae_rms_silu_plain(x, gamma)
        lo, hi = _k11_bracket(x, gamma, True)
        outs = {}
        for who, call in (("other", call_other), ("this", call_this)):
            outs[who] = call().clone()
            torch.cuda.synchronize()
            _, outs[who + "_differ"] = check_bracketed(f"K11 A/B {tag}, {who} build", outs[who],
                                                       ref, lo, hi)
        same = bool(torch.equal(outs["this"].view(torch.int16), outs["other"].view(torch.int16)))
        times = {"this": [], "other": []}
        for who in ("other", "this", "this", "other"):
            times[who].append(device_ms(call_other if who == "other" else call_this, 20))
        res[tag] = dict(times, differ_this=outs["this_differ"], differ_other=outs["other_differ"],
                        same_bits=same)
        print(f"  K11 A/B {tag}: device ms this " + " / ".join(f"{m:.4f}" for m in times["this"])
              + ", other " + " / ".join(f"{m:.4f}" for m in times["other"]) +
              f"; differ this {outs['this_differ']}, other {outs['other_differ']}; the two "
              f"builds' outputs bit for bit the same: {same}", flush=True)
        del x, gamma, o_other, ref, lo, hi, outs
        torch.cuda.empty_cache()
    res["flagship"] = {who: sum(n * statistics.median(res["x".join(map(str, shape))][who])
                                for shape, n in K11_FLAGSHIP_SHAPES.items())
                       for who in ("this", "other")}
    print(f"  K11 A/B over the flagship's {sum(K11_FLAGSHIP_SHAPES.values())} calls (each "
          f"shape's median device ms x its calls): this {res['flagship']['this']:.2f} ms, other "
          f"{res['flagship']['other']:.2f} ms", flush=True)
    return res


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
                issue_ms=k11_issue_ms(x),
                library_ms=None if silu else time_ms(
                    lambda: F.rms_norm(x, (c,), gamma, 1e-12)))
        del x, out, ref
    for k, shapes in res.items():
        for (n, tag), r in shapes.items():
            lib = "none" if r["library_ms"] is None else f"{r['library_ms']:.4f}"
            print(f"  {k} rows={n} {tag}: ms {r['ms']:.4f} device_ms {r['device_ms']:.4f} "
                  f"plain_ms {r['plain_ms']:.4f} bound_ms {r['bound'][0]:.4f} ({r['bound'][1]})"
                  f"{'' if 'issue_ms' not in r else ' issue bound ' + str(r['issue_ms'])} "
                  f"library_ms {lib}", flush=True)
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
    launch counts of K9, K7, K3 and K4; then one sweep under torch.profiler;
    then the DiT quantized to W8A8 (``pipe.quantize()``) and the seed-21
    request again (image_w8a8).  Returns the launches of the four
    requests."""
    import torch

    from fairygen_tpu_torch import convert
    from fairygen_tpu_torch.models.qwen.text_encoder import QwenVLTextConfig
    from fairygen_tpu_torch.models.sdxl.vae import AutoencoderKLConfig
    from fairygen_tpu_torch.models.z_image.dit import ZImageDiTConfig, z_image_dit_forward
    from fairygen_tpu_torch.ops import _kernels
    from fairygen_tpu_torch.pipelines import z_image
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
    decoded, undo_decoded = capture_decoded(z_image)
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

    # W8A8: every block's 7 projections quantized (2 + 2 refiner and 30
    # unified blocks), the seed-21 request again
    del dit
    try:
        image_w8a8("Z-Image-Turbo", pipe, request, t2i, ZIMAGE_STEPS, 34 * 7, decoded[0],
                   decoded, lambda: z_image_dit_forward(pipe.dit_params, dit_cfg, lat, t, emb),
                   prompt_emb=emb, seed=21)
    finally:
        undo_decoded()
    del pipe, te, vae, emb, neg, lat
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



SDXL_STEPS = 5  # cut from the CLI's 50 (to 10 in PR 23, to 5 in PR 24) to keep the smoke in its budget
SDXL_LCM_STEPS = 4  # the second request: the few-step LCM rollout
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


# K5, K4's max form and K4's masked form at SD1.5's head dims: (counter,
# tag, BN, Sq, Sk_pad, sk_actual, d).  First the calls of a 512x512 CFG
# request (B = 2 x 8 heads; BrushNet's mid attention 2 x 160 heads of d 8),
# each of its shapes once (SD15_PER_STEP counts them), then those of the
# 768x768 request the app allows, then the forms neither request reaches.
# Query rows are padded to a multiple of 64 with zeros, as the entry pads
# them (144 -> 192)
SD15_SHAPES = (
    ("flash_fwd_d40", "512: self 16x4096", 16, 4096, 4096, 4096, 40),
    ("flash_small_kv_max_d80", "512: self 16x1024", 16, 1024, 1024, 1024, 80),
    ("flash_small_kv_max_d160", "512: self 16x256", 16, 256, 256, 256, 160),
    ("flash_small_kv_masked_d40", "512: cross 16x4096 q, 77 keys", 16, 4096, 128, 77, 40),
    ("flash_small_kv_masked_d80", "512: cross 16x1024 q, 77 keys", 16, 1024, 128, 77, 80),
    ("flash_small_kv_masked_d160", "512: cross 16x256 q, 77 keys", 16, 256, 128, 77, 160),
    ("flash_small_kv_masked_d160", "512: mid self 16x64", 16, 64, 128, 64, 160),
    ("flash_small_kv_masked_d160", "512: mid cross 16x64 q, 77 keys", 16, 64, 128, 77, 160),
    ("flash_small_kv_masked_d8", "512: BrushNet mid 320x64", 320, 64, 128, 64, 8),
    ("flash_fwd_d40", "768: self 16x9216", 16, 9216, 9216, 9216, 40),
    ("flash_fwd_d80", "768: self 16x2304", 16, 2304, 2304, 2304, 80),
    ("flash_small_kv_max_d160", "768: self 16x576", 16, 576, 576, 576, 160),
    ("flash_small_kv_masked_d40", "768: cross 16x9216 q, 77 keys", 16, 9216, 128, 77, 40),
    ("flash_small_kv_masked_d80", "768: cross 16x2304 q, 77 keys", 16, 2304, 128, 77, 80),
    ("flash_small_kv_masked_d160", "768: mid self 16x144 (q in 192)", 16, 144, 192, 144, 160),
    ("flash_small_kv_masked_d8", "768: BrushNet mid 320x144 (q in 192)", 320, 144, 192, 144,
     8),
    ("flash_fwd_d8", "off path: 320x1024 q, 1100 keys", 320, 1024, 1152, 1100, 8),
    ("flash_fwd_d160", "off path: 16x1024 q, 2304 keys", 16, 1024, 2304, 2304, 160),
    ("flash_small_kv_max_d8", "off path: 320x256", 320, 256, 256, 256, 8),
    ("flash_small_kv_max_d40", "off path: 16x1024", 16, 1024, 1024, 1024, 40),
)
SD15_MAIN_SHAPE = {  # the shape of each counter's row (its largest on the path)
    "flash_fwd_d40": "512: self 16x4096", "flash_fwd_d80": "768: self 16x2304",
    "flash_fwd_d8": "off path: 320x1024 q, 1100 keys",
    "flash_fwd_d160": "off path: 16x1024 q, 2304 keys",
    "flash_small_kv_max_d80": "512: self 16x1024", "flash_small_kv_max_d160": "512: self 16x256",
    "flash_small_kv_max_d8": "off path: 320x256", "flash_small_kv_max_d40": "off path: 16x1024",
    "flash_small_kv_masked_d40": "512: cross 16x4096 q, 77 keys",
    "flash_small_kv_masked_d80": "512: cross 16x1024 q, 77 keys",
    "flash_small_kv_masked_d160": "512: cross 16x256 q, 77 keys",
    "flash_small_kv_masked_d8": "512: BrushNet mid 320x64"}
# the kernel function each counter's row shape runs (d 8 and 40 on the d-64
# kernels, 80 on the d-128 ones; at most 80 keys the 80-column form), in two
# groups whose functions differ, so that one profiled window a group gives
# each row its device time
SD15_ROW_KERNELS = (
    {"flash_fwd_d40": "fa_online_d64_kernel", "flash_fwd_d80": "fa_online_d128_kernel",
     "flash_fwd_d8": "fa_online_d64_ragged_kernel", "flash_fwd_d160": "fa_online_d160_kernel",
     "flash_small_kv_max_d80": "fa_row_max_d128_kernel",
     "flash_small_kv_max_d160": "fa_row_max_d160_kernel",
     "flash_small_kv_max_d8": "fa_row_max_d64_kernel",
     "flash_small_kv_masked_d40": "fa_online_d64_k80_kernel",
     "flash_small_kv_masked_d80": "fa_online_d128_ragged_kernel",
     "flash_small_kv_masked_d160": "fa_online_d160_ragged_kernel"},
    {"flash_small_kv_max_d40": "fa_row_max_d64_kernel",
     "flash_small_kv_masked_d8": "fa_online_d64_k80_kernel"},
)


def sd15_kernel_checks():
    """K5, K4's max form and K4's masked form at SD1.5's head dims 8, 40, 80
    and 160 against their plain versions on the card in bf16, at
    SD15_SHAPES: within 2^-7 relative + 2^-8 absolute, K4 also within a
    relative L2 error of o below 2^-10 (p rounded against the row's max,
    which a running max exceeds); two launches give the same bits; one
    launch under the form's own counter.  (A logit that sums in another
    order may flip one p's bf16 rounding, 2^-8 of p, which moves o by up
    to 2^-8 / l: over the 77 text keys at d 160 that passed the 1e-3 of
    K4's d-64 check.)  The masked key rows hold
    non-zero values.  Bounds at the true head dim d (the kernels compute 64,
    128 or 192 columns, the ones past d zeros): q, k, v read and o written
    once (3.35 TB/s), 4 x BN x Sq x Sk x d flops (989 TFLOP/s) and BN x Sq x
    Sk exp2 (16 a clock on 132 SMs at 1.98 GHz), the largest of the three
    ("operations" where the products or exp2 set it).  Device time from
    torch.profiler beside the CUDA-event time at each row's shape
    (SD15_MAIN_SHAPE), the rows' kernels traced together in the two windows
    of SD15_ROW_KERNELS (each trace opens the profiler anew, and the card's
    profiler drops more records the more often a process has opened it);
    the yardstick is F.scaled_dot_product_attention on the unpadded heads,
    timed here only.  Returns {counter: {tag: numbers}}."""
    import torch
    import torch.nn.functional as F

    from fairygen_tpu_torch.ops import _kernels
    from fairygen_tpu_torch.ops import flash_attention as fa

    g = torch.Generator("cuda").manual_seed(1515)
    ln2 = 0.6931471805599453
    res = {}

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=g, device="cuda") * scale).to(torch.bfloat16)

    rows = {}  # counter: its row shape's kernel call
    for name, tag, bn, sq, skp, ska, d in SD15_SHAPES:
        qh = torch.zeros((bn, fa._pad_len(sq, 64, True), d), dtype=torch.bfloat16,
                         device="cuda")
        qh[:, :sq] = randn(bn, sq, d, scale=d ** -0.5 * 1.4426950408889634)
        kh, vh = randn(bn, skp, d), randn(bn, skp, d)
        k5 = name.startswith("flash_fwd")
        # the inputs bound now: a row's call runs again after the loop
        if k5:
            def kern(qh=qh, kh=kh, vh=vh, ska=ska):
                return fa.flash_fwd(qh, kh, vh, sk_actual=ska, with_lse=False)

            def plain():
                return fa.flash_fwd_plain(qh, kh, vh, sk_actual=ska, with_lse=False)
        else:
            def kern(qh=qh, kh=kh, vh=vh, ska=ska):
                return fa.flash_small_kv_max(qh, kh, vh, sk_actual=ska)

            def plain():
                return fa.flash_small_kv_max_plain(qh, kh, vh, sk_actual=ska)
        before = dict(_kernels.launches)
        out = kern()
        counted = {k: v - before[k] for k, v in _kernels.launches.items() if v != before[k]}
        if counted != {name: 1}:
            raise RuntimeError(f"{tag}: counted {counted}, expected one launch of {name}")
        ref = plain()
        err = check_close(f"{name} {tag}", out, ref, rtol=2 ** -7, atol=2 ** -8)
        rel_l2 = ((out.float() - ref.float()).norm() / ref.float().norm()).item()
        same = torch.equal(out, kern())
        print(f"  {name} {tag}: relative L2 error of o {rel_l2:.3e}"
              + ("" if k5 else f" (bound 2^-10 = {2 ** -10:.3e})")
              + f"; two launches bit for bit: {same}", flush=True)
        if not same or (not k5 and not rel_l2 < 2 ** -10):
            raise RuntimeError(f"{name} {tag} disagrees with its plain version or itself")
        q4, k4, v4 = (t.view(1, bn, -1, d)[:, :, :n].contiguous()
                      for t, n in ((qh, sq), (kh, ska), (vh, ska)))

        def sdpa():
            return F.scaled_dot_product_attention(q4, k4, v4, scale=ln2)
        t_ops = bound_ms(0, 4 * bn * sq * ska * d)[0]
        t_exp = bn * sq * ska / H100_MUFU_EXP2_PER_S * 1e3
        t_bytes = bound_ms((2 * sq + 2 * ska) * bn * d * 2, 0)[0]
        bound = max((t_bytes, "bytes"), (t_ops, "operations"), (t_exp, "operations"))
        r = dict(max_abs_err=err, rel_l2=rel_l2, ms=time_ms(kern, 10, 3), device_ms=None,
                 plain_ms=time_ms(plain, 1, 1), bound=bound,
                 ops_by="exp2" if t_exp >= t_ops else "products", exp2_ms=t_exp,
                 library_ms=time_ms(sdpa, 10, 3))
        res.setdefault(name, {})[tag] = r
        print(f"  {name} {tag} (d {d}): ms {r['ms']:.4f} plain_ms {r['plain_ms']:.4f} "
              f"bound_ms {bound[0]:.4f} ({bound[1]}; bytes {t_bytes:.4f}, products "
              f"{t_ops:.4f}, exp2 {t_exp:.4f}) library_ms (SDPA) {r['library_ms']:.4f}",
              flush=True)
        if SD15_MAIN_SHAPE[name] == tag:
            rows[name] = kern
        del out, ref, q4, k4, v4
    for group in SD15_ROW_KERNELS:
        def together(group=group):
            for name in group:
                rows[name]()
        trace = device_trace(together, 10)
        for name, fn in group.items():
            hits = [ms for key, ms in trace.items() if f"::{fn}(" in key]
            if len(hits) != 1:
                raise RuntimeError(f"{name}: the trace holds {len(hits)} rows of {fn}: "
                                   f"{sorted(trace)}")
            res[name][SD15_MAIN_SHAPE[name]]["device_ms"] = hits[0]
            print(f"  {name} {SD15_MAIN_SHAPE[name]}: device {hits[0]:.4f} ms ({fn})",
                  flush=True)
    del rows
    torch.cuda.empty_cache()
    return res


# the fp32 DoRA train step's attention calls (batch 1, head dim 64, 1024x1024:
# 128 x 128 latents): (tag, BN, Sq, Sk_pad, sk_actual, calls a step).  The
# 10 transformer blocks at 64 x 64 latents (640 channels, 10 heads)
# self-attend over 4096 tokens, the 60 at 32 x 32 (1280, 20 heads) over
# 1024; all 70 cross-attend to the 77 text tokens, padded to 128
DORA_ATTENTION_SHAPES = (
    ("self 10x4096", 10, 4096, 4096, 4096, 10),
    ("self 20x1024", 20, 1024, 1024, 1024, 60),
    ("cross 10x4096 q, 77 keys", 10, 4096, 128, 77, 10),
    ("cross 20x1024 q, 77 keys", 20, 1024, 128, 77, 60),
)
F32_KERNELS = ("flash_fwd_lse_f32", "flash_bwd_dq_f32", "flash_bwd_dkv_f32")
# the launches of one fp32 flash_attention call with a gradient: K6a and its
# pre-pass, K6b, K6c, and the backward's pre-pass once for K6b and once for
# K6c (plus one reduce where K6c's query loop is split)
F32_ONE_CALL = {"flash_fwd_lse_f32": 1, "flash_bwd_dq_f32": 1, "flash_bwd_dkv_f32": 1,
                "flash_fwd_prep_f32": 1, "flash_bwd_prep_f32": 2}


def f32_train_kernel_checks():
    """K6a, K6b and K6c in fp32 at head dim 64 against their plain versions
    on the card at the DoRA step's shapes (DORA_ATTENTION_SHAPES): o, dq, dk
    and dv each within a relative L2 error of 1e-5 of the plain version, lse
    within 1e-5 absolute (both sides fp32; the kernels sum in another order,
    multiply in three TF32 passes, and exp2 is the hardware ex2, about 2
    ulp), dk and dv rows >= sk_actual exactly 0, and each kernel run twice
    giving the same bits.  K6a's pre-pass and K6b and K6c's
    (both forms) are held bit for bit to their plain versions, K6c's reduce
    pass likewise on the plain split partials, whose sum is also held to
    the one-split plain dK / dV within a relative L2 of 1e-6; each call
    counts one launch of K6a-c and of K6a's pre-pass, two of the backward's
    pre-pass and one of the reduce where K6c's query loop is split.  Bounds
    count 4 (K6a), 6 (K6b) and 8 (K6c) x BN x Sq x Sk x 64 flops on the
    unpadded lengths, each input read and output written once at 3.35
    TB/s: against 67 TFLOP/s (fp32 outside the tensor cores) and against
    494.7 / 3 TFLOP/s (three TF32 passes on the tensor cores), which a
    device time may not beat.  The library yardstick is
    scaled_dot_product_attention in fp32 on the unpadded heads: its forward
    for K6a, its backward (dq, dk and dv together) for K6b and K6c, timed
    here only, by CUDA events and by device time.  Each kernel's time is its
    wrapper's (the pre-pass, the kernel and the reduce), device time also
    by kernel; K6c's kernel and reduce also at other split counts of its
    query loop.  Then flash_attention's fp32
    gradient against fp32 autograd of the plain attention (relative L2
    below 1e-5).  Returns {kernel: {tag: numbers}}."""
    import torch
    import torch.nn.functional as F

    from fairygen_tpu_torch.ops import _kernels
    from fairygen_tpu_torch.ops import flash_attention as fa
    from fairygen_tpu_torch.ops.attention import xla_attention

    g = torch.Generator("cuda").manual_seed(4242)
    ln2, d, f32 = 0.6931471805599453, 64, torch.float32
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    res = {}

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=g, device="cuda") * scale

    def rel_l2_of(out, ref):
        return ((out.double() - ref.double()).norm() / ref.double().norm()).item()

    def part_of(name):  # a kernel's part of a K6a-c call, by its function name
        return ("prep" if "fa_f32_bwd_prep" in name or "fa_f32_fwd_prep" in name
                else "reduce" if "fa_f32_dkv_reduce" in name else "kernel")

    for tag, bn, sq, skp, ska, calls in DORA_ATTENTION_SHAPES:
        qh = randn(bn, sq, d, scale=d ** -0.5 * 1.4426950408889634)
        kh, vh = randn(bn, skp, d), randn(bn, skp, d)
        kh[:, ska:], vh[:, ska:] = 0, 0
        doh = randn(bn, sq, d, scale=0.05)
        n_split, tps = fa.dkv_splits(bn, sq, skp, sms)
        want = dict(F32_ONE_CALL, flash_bwd_dkv_reduce_f32=int(n_split > 1))
        before = dict(_kernels.launches)
        o, lse = fa.flash_fwd(qh, kh, vh, sk_actual=ska)
        o_ref, lse_ref = fa.flash_fwd_plain(qh, kh, vh, sk_actual=ska)
        delta = (doh * o_ref).sum(-1)
        dq = fa.flash_bwd_dq(qh, kh, vh, doh, lse_ref, delta, sk_actual=ska,
                             dq_factor=1 / 1.4426950408889634)
        dk, dv = fa.flash_bwd_dkv(qh, kh, vh, doh, lse_ref, delta, sq=sq, sk_actual=ska)
        counted = {k: _kernels.launches[k] - before[k] for k in want}
        if counted != want:
            raise RuntimeError(f"{tag}: the fp32 counters counted {counted}, expected {want}")
        dq_ref = fa.flash_bwd_dq_plain(qh, kh, vh, doh, lse_ref, delta, sk_actual=ska,
                                       dq_factor=1 / 1.4426950408889634)
        dk_ref, dv_ref = fa.flash_bwd_dkv_plain(qh, kh, vh, doh, lse_ref, delta, sq=sq,
                                                sk_actual=ska)
        errs = {"o": rel_l2_of(o, o_ref), "dq": rel_l2_of(dq, dq_ref),
                "dk": rel_l2_of(dk, dk_ref), "dv": rel_l2_of(dv, dv_ref)}
        lse_err = (lse - lse_ref).abs().max().item()
        zero_rows = bool((dk[:, ska:] == 0).all() and (dv[:, ska:] == 0).all())
        o2, lse2 = fa.flash_fwd(qh, kh, vh, sk_actual=ska)
        dq2 = fa.flash_bwd_dq(qh, kh, vh, doh, lse_ref, delta, sk_actual=ska,
                              dq_factor=1 / 1.4426950408889634)
        dk2, dv2 = fa.flash_bwd_dkv(qh, kh, vh, doh, lse_ref, delta, sq=sq, sk_actual=ska)
        same = [torch.equal(a, b) for a, b in ((o, o2), (lse, lse2), (dq, dq2), (dk, dk2),
                                               (dv, dv2))]
        prep_same = [torch.equal(fa._fwd_prep_f32(kh, vh), fa.fwd_prep_f32_plain(kh, vh))] + [
            torch.equal(fa._bwd_prep_f32(qh, kh, vh, doh, w),
                        fa.bwd_prep_f32_plain(qh, kh, vh, doh, w)) for w in (0, 1)]
        print(f"  fp32 K6a-c {tag}: relative L2 error o {errs['o']:.3e} dq {errs['dq']:.3e} "
              f"dk {errs['dk']:.3e} dv {errs['dv']:.3e} (bound 1e-5); lse max abs error "
              f"{lse_err:.3e} (bound 1e-5); dk/dv rows >= {ska} exactly 0: {zero_rows}; run "
              f"twice, o lse dq dk dv bit for bit {same}; K6c's query loop in {n_split} "
              f"split(s) of {tps} 32-query tiles; the pre-passes (K6a; K6b, K6c forms) bit for "
              f"bit their plain versions {prep_same}; launches {counted}", flush=True)
        if not (max(errs.values()) < 1e-5 and lse_err < 1e-5 and zero_rows and all(same)
                and all(prep_same)):
            raise RuntimeError(f"fp32 K6a-c disagree with their plain versions at {tag}")
        del o2, lse2, dq2, dk2, dv2
        reduce_r = None
        if n_split > 1:
            part = fa.flash_bwd_dkv_partials_plain(qh, kh, vh, doh, lse_ref, delta, sq=sq,
                                                   sk_actual=ska, n_split=n_split,
                                                   tiles_per_split=tps)
            rk, rv = torch.empty_like(kh), torch.empty_like(vh)

            def reduce_call():
                _kernels.launch("flash_bwd_dkv_reduce_f32", "fg_flash_bwd_dkv_reduce_f32",
                                part.data_ptr(), rk.data_ptr(), rv.data_ptr(), n_split,
                                rk.numel())
            reduce_call()
            pk, pv = fa.dkv_reduce_plain(part)
            red_same = torch.equal(rk, pk) and torch.equal(rv, pv)
            split_rel = max(rel_l2_of(pk, dk_ref), rel_l2_of(pv, dv_ref))
            print(f"  fp32 K6c reduce {tag}: {n_split} plain split partials summed by the "
                  f"kernel bit for bit the plain sum: {red_same}; that sum against the "
                  f"one-split plain dK / dV, relative L2 {split_rel:.3e} (bound 1e-6)",
                  flush=True)
            if not (red_same and split_rel < 1e-6):
                raise RuntimeError(f"the fp32 K6c reduce pass disagrees at {tag}")
            reduce_r = dict(ms=time_ms(reduce_call, 10, 5), device_ms=device_ms(reduce_call, 10),
                            plain_ms=time_ms(lambda: fa.dkv_reduce_plain(part), 1, 3),
                            bound=bound_ms((2 * n_split + 2) * rk.numel() * 4, 0),
                            n_split=n_split, calls=calls)
            del part, rk, rv, pk, pv

        q4, k4, v4, do4 = (t.view(1, bn, -1, d)[:, :, :n].contiguous() for t, n in
                           ((qh, sq), (kh, ska), (vh, ska), (doh, sq)))
        lq, lk, lv = (t.clone().requires_grad_(True) for t in (q4, k4, v4))
        lib_out = F.scaled_dot_product_attention(lq, lk, lv, scale=ln2)

        def sdpa_fwd():
            with torch.no_grad():
                return F.scaled_dot_product_attention(q4, k4, v4, scale=ln2)

        def sdpa_bwd():
            return torch.autograd.grad(lib_out, (lq, lk, lv), do4, retain_graph=True)

        lib_fwd, lib_bwd = time_ms(sdpa_fwd, 10, 5), time_ms(sdpa_bwd, 10, 5)
        lib_fwd_dev, lib_bwd_dev = device_ms(sdpa_fwd, 10), device_ms(sdpa_bwd, 10)
        rows, keys, work = bn * sq, bn * ska, bn * sq * ska * d
        nb = {"flash_fwd_lse_f32": (2 * rows + 2 * keys) * d * 4 + rows * 4,
              "flash_bwd_dq_f32": (3 * rows + 2 * keys) * d * 4 + 2 * rows * 4,
              "flash_bwd_dkv_f32": (2 * rows + 4 * keys) * d * 4 + 2 * rows * 4}
        f = 1 / 1.4426950408889634
        runs = {
            "flash_fwd_lse_f32": (errs["o"], 4,
                                  lambda: fa.flash_fwd(qh, kh, vh, sk_actual=ska),
                                  lambda: fa.flash_fwd_plain(qh, kh, vh, sk_actual=ska),
                                  lib_fwd, (o - o_ref).abs().max().item()),
            "flash_bwd_dq_f32": (errs["dq"], 6,
                                 lambda: fa.flash_bwd_dq(qh, kh, vh, doh, lse, delta,
                                                         sk_actual=ska, dq_factor=f),
                                 lambda: fa.flash_bwd_dq_plain(qh, kh, vh, doh, lse, delta,
                                                               sk_actual=ska, dq_factor=f),
                                 lib_bwd, (dq - dq_ref).abs().max().item()),
            "flash_bwd_dkv_f32": (max(errs["dk"], errs["dv"]), 8,
                                  lambda: fa.flash_bwd_dkv(qh, kh, vh, doh, lse, delta, sq=sq,
                                                           sk_actual=ska),
                                  lambda: fa.flash_bwd_dkv_plain(qh, kh, vh, doh, lse, delta,
                                                                 sq=sq, sk_actual=ska),
                                  lib_bwd, max((dk - dk_ref).abs().max().item(),
                                               (dv - dv_ref).abs().max().item())),
        }
        for name, (rel, mult, kern, plain, lib, max_abs) in runs.items():
            what = "backward, dq+dk+dv" if "bwd" in name else "forward"
            lib_dev = lib_bwd_dev if "bwd" in name else lib_fwd_dev
            by = {}
            for k_, v_ in device_trace(kern, 10).items():
                by[part_of(k_)] = by.get(part_of(k_), 0.0) + v_
            r = dict(max_abs_err=max_abs, rel_l2=rel, ms=time_ms(kern, 10, 5),
                     plain_ms=time_ms(plain, 1, 3),
                     bound=bound_ms(nb[name], mult * work, H100_FP32_FLOP_PER_S),
                     tc_bound=bound_ms(nb[name], mult * work, H100_TF32_FLOP_PER_S / 3),
                     library_ms=lib, library_device_ms=lib_dev, calls=calls,
                     device_ms=sum(by.values()), device_parts=by)
            if r["device_ms"] < r["tc_bound"][0]:
                raise RuntimeError(f"{tag} {name}: device time {r['device_ms']} ms reads "
                                   f"below the tensor-core bound {r['tc_bound'][0]} ms")
            res.setdefault(name, {})[tag] = r
            print(f"  {tag} {name}: ms {r['ms']:.4f} (device {r['device_ms']:.4f} = "
                  f"{' + '.join(f'{k_} {v_:.4f}' for k_, v_ in by.items())}) plain_ms "
                  f"{r['plain_ms']:.4f} bound_ms 3xTF32 {r['tc_bound'][0]:.4f} "
                  f"({r['tc_bound'][1]}), 67 TFLOP/s fp32 {r['bound'][0]:.4f} ({r['bound'][1]}) "
                  f"library_ms {lib:.4f} (SDPA fp32 {what}; device {lib_dev:.4f})", flush=True)
        # K6a's pre-pass alone: k, v read, the workspace (4 BN Sk_pad 64) written
        res.setdefault("flash_fwd_prep_f32", {})[tag] = dict(
            ms=time_ms(lambda: fa._fwd_prep_f32(kh, vh), 10, 5),
            device_ms=device_ms(lambda: fa._fwd_prep_f32(kh, vh), 10),
            plain_ms=time_ms(lambda: fa.fwd_prep_f32_plain(kh, vh), 1, 3),
            bound=bound_ms(6 * bn * skp * d * 4, 0), calls=calls)
        # K6c's kernel and reduce at other split counts of its query loop
        # (device time), beside dkv_splits' choice
        ws = fa._bwd_prep_f32(qh, kh, vh, doh, 1)
        n_qt, split_ms = -(-sq // 32), {}
        counts = {-(-n_qt // -(-n_qt // min(c, n_qt))) for c in (1, 2, 3, 4, 6, 8, 13, 26)}
        for ns in sorted(counts | {n_split}):
            tps_ = -(-n_qt // ns)
            sk_, sv_ = torch.empty_like(kh), torch.empty_like(vh)
            part_ = torch.empty((ns, 2) + tuple(kh.shape), device="cuda") if ns > 1 else sk_

            def split_run(ns=ns, tps_=tps_, sk_=sk_, sv_=sv_, part_=part_):
                _kernels.launch("flash_bwd_dkv_f32", "fg_flash_bwd_dkv_f32_tc", ws.data_ptr(),
                                lse.data_ptr(), delta.data_ptr(), sk_.data_ptr(), sv_.data_ptr(),
                                part_.data_ptr(), ns, tps_, bn, sq, sq, ska, skp)
                if ns > 1:
                    _kernels.launch("flash_bwd_dkv_reduce_f32", "fg_flash_bwd_dkv_reduce_f32",
                                    part_.data_ptr(), sk_.data_ptr(), sv_.data_ptr(), ns,
                                    sk_.numel())
            split_ms[ns] = device_ms(split_run, 10)
        res["flash_bwd_dkv_f32"][tag]["split_device_ms"] = split_ms
        print(f"  {tag} K6c kernel + reduce by split count (device ms): " +
              ", ".join(f"{ns}: {m:.4f}{' (dkv_splits)' if ns == n_split else ''}"
                        for ns, m in split_ms.items()), flush=True)
        del ws
        # the pre-pass alone: its two forms, and its bytes (4 inputs read, the
        # workspace written)
        for which, name in ((0, "K6b"), (1, "K6c")):
            ws_floats = (4 * rows + 4 * bn * skp) * d + (2 * bn * skp if which == 0
                                                         else 4 * rows) * d
            res.setdefault("flash_bwd_prep_f32", {})[f"{tag}, {name} form"] = dict(
                ms=time_ms(lambda: fa._bwd_prep_f32(qh, kh, vh, doh, which), 10, 5),
                device_ms=device_ms(lambda: fa._bwd_prep_f32(qh, kh, vh, doh, which), 10),
                plain_ms=time_ms(lambda: fa.bwd_prep_f32_plain(qh, kh, vh, doh, which), 1, 3),
                bound=bound_ms((2 * rows + 2 * bn * skp) * d * 4 + ws_floats * 4, 0),
                calls=calls)
        if reduce_r:
            res.setdefault("flash_bwd_dkv_reduce_f32", {})[tag] = reduce_r
        del qh, kh, vh, doh, o, lse, o_ref, lse_ref, dq, dk, dv, dq_ref, dk_ref, dv_ref
        del q4, k4, v4, do4, lq, lk, lv, lib_out
        torch.cuda.empty_cache()
    for name in F32_KERNELS:
        by = res[name]
        step_ms = sum(r["device_ms"] * r["calls"] for r in by.values())
        step_bound = sum(r["bound"][0] * r["calls"] for r in by.values())
        step_tc = sum(r["tc_bound"][0] * r["calls"] for r in by.values())
        sums = {}
        for r in by.values():
            for k_, v_ in r["device_parts"].items():
                sums[k_] = sums.get(k_, 0.0) + v_ * r["calls"]
        print(f"  {name} over one DoRA step's 140 calls: device {step_ms:.3f} ms (" +
              ", ".join(f"{k_} {v_:.3f}" for k_, v_ in sums.items()) + f"), bound 67 TFLOP/s "
              f"{step_bound:.3f} ms, bound 3xTF32 {step_tc:.3f} ms", flush=True)

    # flash_attention's fp32 gradient (K6a, K6b, K6c) against fp32 autograd
    # of the plain attention on the same values
    q = randn(1, 1000, 2, d, scale=d ** -0.5).requires_grad_(True)
    k, v = randn(1, 1000, 2, d).requires_grad_(True), randn(1, 1000, 2, d).requires_grad_(True)
    w = randn(1, 1000, 2, d)
    # 2 heads of 1000 keys, padded to 1024: 16 items of 128 keys, so K6c's
    # query loop splits
    want = dict(F32_ONE_CALL, flash_bwd_dkv_reduce_f32=int(fa.dkv_splits(2, 1000, 1024,
                                                                          sms)[0] > 1))
    before = dict(_kernels.launches)
    out = fa.flash_attention(q, k, v, kv_len=900)
    grads = torch.autograd.grad((out * w).sum(), (q, k, v))
    counted = {k_: _kernels.launches[k_] - before[k_] for k_ in want}
    ref_in = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
    ref = xla_attention(*ref_in, kv_len=900)
    ref_grads = torch.autograd.grad((ref * w).sum(), ref_in)
    rels = [rel_l2_of(a, b) for a, b in zip((out,) + grads, (ref,) + ref_grads)]
    print(f"  fp32 flash_attention vs fp32 autograd of the plain attention (S=1000, "
          f"kv_len 900, d 64): relative L2 o {rels[0]:.3e} dq {rels[1]:.3e} dk {rels[2]:.3e} "
          f"dv {rels[3]:.3e} (bound 1e-5); launches {counted}", flush=True)
    if not max(rels) < 1e-5 or counted != want:
        raise RuntimeError(f"fp32 flash_attention gradient disagrees: {rels} {counted}")
    return res


# K5, K4's max form and K4's masked form in fp32 (the SDXL and SD1.5
# pipelines' default dtype): (counter, tag, BN, Sq, Sk_pad, sk_actual, d).
# First the calls of a 1024x1024 SDXL CFG request (BN = 2 x heads), then
# those of a 512x512 and a 768x768 SD1.5 request (SD15_SHAPES' shapes),
# then the forms no request reaches, at shapes of their own (d 16: the
# SDXL golden's tiny UNet)
F32_FWD_SHAPES = (
    ("flash_fwd_f32_d64", "SDXL: self 20x4096", 20, 4096, 4096, 4096, 64),
    ("flash_small_kv_max_f32_d64", "SDXL: self 40x1024", 40, 1024, 1024, 1024, 64),
    ("flash_small_kv_masked_f32_d64", "SDXL: cross 20x4096 q, 77 keys", 20, 4096, 128, 77, 64),
    ("flash_small_kv_masked_f32_d64", "SDXL: cross 40x1024 q, 77 keys", 40, 1024, 128, 77, 64),
) + tuple((name.replace("_d", "_f32_d"), tag, bn, sq, skp, ska, d)
          for name, tag, bn, sq, skp, ska, d in SD15_SHAPES if not tag.startswith("off path")) + (
    ("flash_fwd_f32_d8", "off path: 320x1024 q, 1100 keys", 320, 1024, 1152, 1100, 8),
    ("flash_fwd_f32_d16", "off path: 40x1024 q, 1100 keys", 40, 1024, 1152, 1100, 16),
    ("flash_fwd_f32_d160", "off path: 16x1024 q, 2304 keys", 16, 1024, 2304, 2304, 160),
    ("flash_small_kv_max_f32_d8", "off path: 320x256", 320, 256, 256, 256, 8),
    ("flash_small_kv_max_f32_d16", "off path: 40x256", 40, 256, 256, 256, 16),
    ("flash_small_kv_max_f32_d40", "off path: 16x1024", 16, 1024, 1024, 1024, 40),
    ("flash_small_kv_masked_f32_d16", "off path: 40x1024 q, 77 keys", 40, 1024, 128, 77, 16),
)
F32_FWD_MAIN_SHAPE = {  # the shape of each counter's row (its largest on a path)
    "flash_fwd_f32_d64": "SDXL: self 20x4096",
    "flash_small_kv_max_f32_d64": "SDXL: self 40x1024",
    "flash_small_kv_masked_f32_d64": "SDXL: cross 20x4096 q, 77 keys",
    "flash_fwd_f32_d40": "512: self 16x4096", "flash_fwd_f32_d80": "768: self 16x2304",
    "flash_fwd_f32_d8": "off path: 320x1024 q, 1100 keys",
    "flash_fwd_f32_d16": "off path: 40x1024 q, 1100 keys",
    "flash_fwd_f32_d160": "off path: 16x1024 q, 2304 keys",
    "flash_small_kv_max_f32_d80": "512: self 16x1024",
    "flash_small_kv_max_f32_d160": "512: self 16x256",
    "flash_small_kv_max_f32_d8": "off path: 320x256",
    "flash_small_kv_max_f32_d16": "off path: 40x256",
    "flash_small_kv_max_f32_d40": "off path: 16x1024",
    "flash_small_kv_masked_f32_d40": "512: cross 16x4096 q, 77 keys",
    "flash_small_kv_masked_f32_d80": "512: cross 16x1024 q, 77 keys",
    "flash_small_kv_masked_f32_d160": "512: cross 16x256 q, 77 keys",
    "flash_small_kv_masked_f32_d8": "512: BrushNet mid 320x64",
    "flash_small_kv_masked_f32_d16": "off path: 40x1024 q, 77 keys"}
F32_FWD_REL_L2 = 1e-5  # the fp32 K6a's bound (f32_train_kernel_checks)


def f32_fwd_kernel_checks():
    """K5, K4's max form and K4's masked form in fp32 at head dims 8, 16, 40,
    64, 80 and 160 against their plain versions on the card, at
    F32_FWD_SHAPES: o within a relative L2 error of 1e-5 (the fp32 K6a's
    bound: both sides fp32, the kernel multiplies in three TF32 passes and
    sums in another order; in fp32 K4 rounds nothing, so its plain version
    is K5's), two launches bit for bit, one launch under the form's own
    counter and one of the pre-pass.  The masked key rows hold non-zero
    values.  Bounds at the true head dim d: q, k, v read and o written once
    (3.35 TB/s), 4 x BN x Sq x Sk x d flops at 494.7 / 3 TFLOP/s (three
    TF32 passes) and BN x Sq x Sk exp2 (16 a clock on 132 SMs), the largest
    of the three, with the 67 TFLOP/s fp32 bound beside it.  Times through
    the wrapper (the pre-pass and the kernel): CUDA events at every shape,
    device time (torch.profiler, pre-pass and kernel apart) at each
    counter's row shape (F32_FWD_MAIN_SHAPE); the yardstick is
    F.scaled_dot_product_attention in fp32 on the unpadded heads, timed
    here only.  Returns {counter: {tag: numbers}}."""
    import torch
    import torch.nn.functional as F

    from fairygen_tpu_torch.ops import _kernels
    from fairygen_tpu_torch.ops import flash_attention as fa

    g = torch.Generator("cuda").manual_seed(2424)
    ln2 = 0.6931471805599453
    res = {}
    for name, tag, bn, sq, skp, ska, d in F32_FWD_SHAPES:
        qh = torch.zeros((bn, fa._pad_len(sq, 64, True), d), device="cuda")
        qh[:, :sq] = torch.randn((bn, sq, d), generator=g, device="cuda") * (
            d ** -0.5 * 1.4426950408889634)
        kh, vh = (torch.randn((bn, skp, d), generator=g, device="cuda") for _ in range(2))
        k5 = name.startswith("flash_fwd")

        def kern(qh=qh, kh=kh, vh=vh, ska=ska, k5=k5):
            if k5:
                return fa.flash_fwd(qh, kh, vh, sk_actual=ska, with_lse=False)
            return fa.flash_small_kv_max(qh, kh, vh, sk_actual=ska)

        def plain():
            return fa.flash_fwd_plain(qh, kh, vh, sk_actual=ska, with_lse=False)
        before = dict(_kernels.launches)
        out = kern()
        counted = {k: v - before[k] for k, v in _kernels.launches.items() if v != before[k]}
        if counted != {name: 1, "flash_fwd_prep_f32": 1}:
            raise RuntimeError(f"{tag}: counted {counted}, expected one launch of {name} and "
                               f"of the pre-pass")
        ref = plain()
        rel_l2 = ((out.double() - ref.double()).norm() / ref.double().norm()).item()
        err = (out - ref).abs().max().item()
        same = torch.equal(out, kern())
        print(f"  {name} {tag} (d {d}): relative L2 error of o {rel_l2:.3e} (bound "
              f"{F32_FWD_REL_L2:.0e}), max abs error {err:.3e}; two launches bit for bit: "
              f"{same}", flush=True)
        if not (same and rel_l2 < F32_FWD_REL_L2):
            raise RuntimeError(f"{name} {tag} disagrees with its plain version or itself")
        q4, k4, v4 = (t.view(1, bn, -1, d)[:, :, :n].contiguous()
                      for t, n in ((qh, sq), (kh, ska), (vh, ska)))

        def sdpa():
            return F.scaled_dot_product_attention(q4, k4, v4, scale=ln2)
        flops = 4 * bn * sq * ska * d
        t_tc = flops / (H100_TF32_FLOP_PER_S / 3) * 1e3
        t_exp = bn * sq * ska / H100_MUFU_EXP2_PER_S * 1e3
        t_bytes = (2 * sq + 2 * ska) * bn * d * 4 / H100_BYTES_PER_S * 1e3
        bound = max((t_bytes, "bytes"), (t_tc, "operations"), (t_exp, "operations"))
        r = dict(max_abs_err=err, rel_l2=rel_l2, ms=time_ms(kern, 10, 3), device_ms=None,
                 device_parts=None, plain_ms=time_ms(plain, 1, 1), bound=bound,
                 ops_by="exp2" if t_exp >= t_tc else "products", exp2_ms=t_exp,
                 bound_fp32_ffma=max(t_bytes, flops / H100_FP32_FLOP_PER_S * 1e3),
                 library_ms=time_ms(sdpa, 10, 3))
        if F32_FWD_MAIN_SHAPE[name] == tag:
            parts = {}
            for k_, v_ in device_trace(kern, 10).items():
                part = "prep" if "fa_f32_fwd_prep" in k_ else "kernel"
                parts[part] = parts.get(part, 0.0) + v_
            r.update(device_ms=sum(parts.values()), device_parts=parts)
            if r["device_ms"] < bound[0]:
                raise RuntimeError(f"{name} {tag}: device time {r['device_ms']} ms reads below "
                                   f"its bound {bound[0]} ms")
        res.setdefault(name, {})[tag] = r
        dev = "" if r["device_ms"] is None else (
            f" (device {r['device_ms']:.4f} = " +
            " + ".join(f"{k_} {v_:.4f}" for k_, v_ in r["device_parts"].items()) + ")")
        print(f"  {name} {tag}: ms {r['ms']:.4f}{dev} plain_ms {r['plain_ms']:.4f} bound_ms "
              f"{bound[0]:.4f} ({bound[1]}; bytes {t_bytes:.4f}, 3xTF32 products {t_tc:.4f}, "
              f"exp2 {t_exp:.4f}; 67 TFLOP/s fp32 {r['bound_fp32_ffma']:.4f}) library_ms (SDPA "
              f"fp32) {r['library_ms']:.4f}", flush=True)
        del qh, kh, vh, out, ref, q4, k4, v4
    torch.cuda.empty_cache()
    return res


# the bf16 K6a-c at head dim 64, one launch each a flash_attention call with
# a gradient (the bf16 SDXL UNet's: BrushNet training, SDXL distillation)
BF16_D64_KERNELS = ("flash_fwd_lse_d64", "flash_bwd_dq_d64", "flash_bwd_dkv_d64")
H100_MUFU_EXP2_PER_S = 132 * 16 * 1.98e9  # 16 exp2 a clock an SM at the 1.98 GHz boost clock


def bf16_d64_kernel_checks():
    """K6a, K6b and K6c in bf16 at head dim 64 against their plain versions
    on the card at the shapes of the bf16 SDXL UNet's 1024x1024 step under a
    gradient (DORA_ATTENTION_SHAPES, batch 1; a BrushNet step adds one 20 x
    1024^2 call for BrushNet's mid attention).  Tolerances as at head dim
    128 (train_kernel_checks): o within 2^-7 relative + 2^-8 absolute and a
    relative L2 error below 2^-8 (p rounded to bf16 against its 128-key
    tile's running max), lse within 1e-5 relative + 1e-4, dq, dk and dv
    within 2^-7 relative + 1e-2 of the largest |gradient|; each kernel run
    twice gives the same bits; dk and dv rows >= sk_actual exactly 0; one
    launch of each d-64 counter a call.  Bounds: 4 (K6a), 6 (K6b) and 8
    (K6c) x BN x Sq x Sk x 64 flops on the unpadded lengths at 989 TFLOP/s,
    each input read and output written once at 3.35 TB/s; beside them the
    exp2 count (BN Sq Sk: each kernel computes P anew) at 16 a clock on 132
    SMs at 1.98 GHz.  Library yardsticks, timed here only: cuDNN's attention
    forward with its log-sum-exp (K6a; SDPA's flash forward beside it) and
    SDPA's flash backward (dq, dk and dv together; K6b and K6c), on the
    unpadded heads.  Returns {kernel: {tag: numbers}}."""
    import torch

    from fairygen_tpu_torch.ops import _kernels
    from fairygen_tpu_torch.ops import flash_attention as fa

    g = torch.Generator("cuda").manual_seed(6464)
    ln2, d, bf = 0.6931471805599453, 64, torch.bfloat16
    f = 1 / 1.4426950408889634
    res = {}

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=g, device="cuda") * scale).to(bf)

    for tag, bn, sq, skp, ska, calls in DORA_ATTENTION_SHAPES:
        qh = randn(bn, sq, d, scale=d ** -0.5 * 1.4426950408889634)
        kh, vh = randn(bn, skp, d), randn(bn, skp, d)
        kh[:, ska:], vh[:, ska:] = 0, 0
        doh = randn(bn, sq, d, scale=0.05)
        before = dict(_kernels.launches)
        o, lse = fa.flash_fwd(qh, kh, vh, sk_actual=ska)
        o_ref, lse_ref = fa.flash_fwd_plain(qh, kh, vh, sk_actual=ska)
        delta = (doh.float() * o_ref.float()).sum(-1)
        dq = fa.flash_bwd_dq(qh, kh, vh, doh, lse_ref, delta, sk_actual=ska, dq_factor=f)
        dk, dv = fa.flash_bwd_dkv(qh, kh, vh, doh, lse_ref, delta, sq=sq, sk_actual=ska)
        counted = {k: _kernels.launches[k] - before[k] for k in _kernels.launches
                   if _kernels.launches[k] != before[k]}
        if counted != {k: 1 for k in BF16_D64_KERNELS}:
            raise RuntimeError(f"{tag}: the bf16 d-64 calls counted {counted}")
        dq_ref = fa.flash_bwd_dq_plain(qh, kh, vh, doh, lse_ref, delta, sk_actual=ska,
                                       dq_factor=f)
        dk_ref, dv_ref = fa.flash_bwd_dkv_plain(qh, kh, vh, doh, lse_ref, delta, sq=sq,
                                                sk_actual=ska)
        e_o = check_close(f"K6a d64 o {tag}", o, o_ref, rtol=2 ** -7, atol=2 ** -8)
        check_close(f"K6a d64 lse {tag}", lse, lse_ref, rtol=1e-5, atol=1e-4)
        rel_l2 = ((o.float() - o_ref.float()).norm() / o_ref.float().norm()).item()
        e_dq = check_close(f"K6b d64 dq {tag}", dq, dq_ref, rtol=2 ** -7,
                           atol=1e-2 * dq_ref.float().abs().max().item())
        e_dkv = max(check_close(f"K6c d64 dk {tag}", dk, dk_ref, rtol=2 ** -7,
                                atol=1e-2 * dk_ref.float().abs().max().item()),
                    check_close(f"K6c d64 dv {tag}", dv, dv_ref, rtol=2 ** -7,
                                atol=1e-2 * dv_ref.float().abs().max().item()))
        zero_rows = bool((dk[:, ska:] == 0).all() and (dv[:, ska:] == 0).all())
        o2, lse2 = fa.flash_fwd(qh, kh, vh, sk_actual=ska)
        dq2 = fa.flash_bwd_dq(qh, kh, vh, doh, lse_ref, delta, sk_actual=ska, dq_factor=f)
        dk2, dv2 = fa.flash_bwd_dkv(qh, kh, vh, doh, lse_ref, delta, sq=sq, sk_actual=ska)
        same = [torch.equal(a, b) for a, b in ((o, o2), (lse, lse2), (dq, dq2), (dk, dk2),
                                               (dv, dv2))]
        print(f"  bf16 K6a-c d64 {tag}: relative L2 error of o {rel_l2:.3e} (bound 2^-8); "
              f"dk/dv rows >= {ska} exactly 0: {zero_rows}; run twice, o lse dq dk dv bit for "
              f"bit {same}", flush=True)
        if not (rel_l2 < 2 ** -8 and zero_rows and all(same)):
            raise RuntimeError(f"bf16 K6a-c at head dim 64 disagree at {tag}")
        del o2, lse2, dq2, dk2, dv2, dq_ref, dk_ref, dv_ref

        q4, k4, v4, do4 = (t.view(1, bn, -1, d)[:, :, :n].contiguous() for t, n in
                           ((qh, sq), (kh, ska), (vh, ska), (doh, sq)))
        sdpa = torch.ops.aten._scaled_dot_product_flash_attention
        fw = sdpa(q4, k4, v4, 0.0, False, False, scale=ln2)

        def sdpa_bwd():
            return torch.ops.aten._scaled_dot_product_flash_attention_backward(
                do4, q4, k4, v4, fw[0], fw[1], fw[2], fw[3], fw[4], fw[5], 0.0, False, fw[6],
                fw[7], scale=ln2)

        def flash_fwd_lib():
            return sdpa(q4, k4, v4, 0.0, False, False, scale=ln2)

        lib_flash = time_ms(flash_fwd_lib, 10, 5)
        lib_cudnn = cudnn_fwd_ms(q4, k4, v4, ln2, tag)
        lib_bwd, lib_bwd_dev = time_ms(sdpa_bwd, 10, 5), device_ms(sdpa_bwd, 10)
        rows, keys, work = bn * sq, bn * ska, bn * sq * ska * d
        nb = {"flash_fwd_lse_d64": (2 * rows + 2 * keys) * d * 2 + rows * 4,
              "flash_bwd_dq_d64": (3 * rows + 2 * keys) * d * 2 + 2 * rows * 4,
              "flash_bwd_dkv_d64": (2 * rows + 4 * keys) * d * 2 + 2 * rows * 4}
        exp_ms = bn * sq * ska / H100_MUFU_EXP2_PER_S * 1e3
        runs = {
            "flash_fwd_lse_d64": (e_o, 4, lambda: fa.flash_fwd(qh, kh, vh, sk_actual=ska),
                                  lambda: fa.flash_fwd_plain(qh, kh, vh, sk_actual=ska),
                                  lib_cudnn if lib_cudnn is not None else lib_flash),
            "flash_bwd_dq_d64": (e_dq, 6, lambda: fa.flash_bwd_dq(qh, kh, vh, doh, lse, delta,
                                                                  sk_actual=ska, dq_factor=f),
                                 lambda: fa.flash_bwd_dq_plain(qh, kh, vh, doh, lse, delta,
                                                               sk_actual=ska, dq_factor=f),
                                 lib_bwd),
            "flash_bwd_dkv_d64": (e_dkv, 8, lambda: fa.flash_bwd_dkv(qh, kh, vh, doh, lse, delta,
                                                                     sq=sq, sk_actual=ska),
                                  lambda: fa.flash_bwd_dkv_plain(qh, kh, vh, doh, lse, delta,
                                                                 sq=sq, sk_actual=ska),
                                  lib_bwd),
        }
        for name, (err, mult, kern, plain, lib) in runs.items():
            r = dict(max_abs_err=err, ms=time_ms(kern, 10, 5), device_ms=device_ms(kern, 10),
                     plain_ms=time_ms(plain, 1, 3), bound=bound_ms(nb[name], mult * work),
                     exp_ms=exp_ms, library_ms=lib, calls=calls)
            if name == "flash_fwd_lse_d64":
                r.update(library_flash_ms=lib_flash, library_cudnn_ms=lib_cudnn, rel_l2=rel_l2)
            else:
                r["library_device_ms"] = lib_bwd_dev
            res.setdefault(name, {})[tag] = r
            print(f"  {tag} {name}: ms {r['ms']:.4f} (device {r['device_ms']:.4f}) plain_ms "
                  f"{r['plain_ms']:.4f} bound_ms {r['bound'][0]:.4f} ({r['bound'][1]}), exp2 "
                  f"{exp_ms:.4f} library_ms {lib:.4f} ("
                  + ("cuDNN forward with lse; SDPA flash forward " + f"{lib_flash:.4f}"
                     if name == "flash_fwd_lse_d64" else
                     f"SDPA flash backward, dq+dk+dv; device {lib_bwd_dev:.4f}") + ")",
                  flush=True)
        del qh, kh, vh, doh, o, lse, o_ref, lse_ref, dq, dk, dv, q4, k4, v4, do4, fw
        torch.cuda.empty_cache()
    for name in BF16_D64_KERNELS:
        by = res[name]
        print(f"  {name} over a 1024x1024 UNet step's 140 calls: device "
              f"{sum(r['device_ms'] * r['calls'] for r in by.values()):.3f} ms, bound "
              f"{sum(r['bound'][0] * r['calls'] for r in by.values()):.3f} ms, exp2 "
              f"{sum(r['exp_ms'] * r['calls'] for r in by.values()):.3f} ms", flush=True)
    return res


def f32_ab(other_path):
    """The fp32 K6a, K6b and K6c of another build of the library
    (``--ab-lib``: an older tree's, through its C entries
    fg_flash_fwd_lse_f32, fg_flash_bwd_dq_f32 and fg_flash_bwd_dkv_f32 (the
    first, FFMA designs) with those entries' own arguments; an entry the
    other build lacks is left out) beside this build's wrappers (the
    pre-pass, the kernel and, where split, the reduce) on the same inputs at
    the DoRA step's shapes.  Each output is held to the plain version within
    a relative L2 of 1e-5 (lse within 1e-5); device times (torch.profiler)
    are taken in the order other, this, this, other, and beside them each
    call's host time (the wall of 20 calls enqueued on an idle card, before
    they are waited for, over 20; this build's wrapper with its checks and
    allocations, the other's bare C entry).
    Returns {kernel: {shape: {"this"|"other"|"host_this"|"host_other": [ms, ...]}}}."""
    import ctypes

    import torch

    from fairygen_tpu_torch.ops import flash_attention as fa

    p_, i_, f_ = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    other = ctypes.CDLL(os.path.abspath(other_path))
    entries = {"flash_fwd_lse_f32": ("fg_flash_fwd_lse_f32", [p_] * 5 + [i_] * 4 + [p_]),
               "flash_bwd_dq_f32": ("fg_flash_bwd_dq_f32", [p_] * 7 + [f_, i_, i_, i_, i_, p_]),
               "flash_bwd_dkv_f32": ("fg_flash_bwd_dkv_f32", [p_] * 8 + [i_] * 5 + [p_])}
    found = {}
    for name, (entry, argtypes) in entries.items():
        fn = getattr(other, entry, None)
        if fn is None:
            print(f"  fp32 A/B: the other build has no {entry}; {name} left out", flush=True)
            continue
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
        found[name] = fn
    g = torch.Generator("cuda").manual_seed(779)
    f = 1 / 1.4426950408889634
    res = {name: {} for name in found}
    for tag, bn, sq, skp, ska, _ in DORA_ATTENTION_SHAPES:
        qh = torch.randn((bn, sq, 64), generator=g, device="cuda") * (64 ** -0.5 * 1.4426950408889634)
        kh, vh = (torch.randn((bn, skp, 64), generator=g, device="cuda") for _ in range(2))
        kh[:, ska:], vh[:, ska:] = 0, 0
        doh = torch.randn((bn, sq, 64), generator=g, device="cuda") * 0.05
        o, lse = fa.flash_fwd_plain(qh, kh, vh, sk_actual=ska)
        delta = (doh * o).sum(-1)
        refs = {"flash_fwd_lse_f32": (o, lse),
                "flash_bwd_dq_f32": (fa.flash_bwd_dq_plain(qh, kh, vh, doh, lse, delta,
                                                           sk_actual=ska, dq_factor=f),),
                "flash_bwd_dkv_f32": fa.flash_bwd_dkv_plain(qh, kh, vh, doh, lse, delta, sq=sq,
                                                            sk_actual=ska)}
        outs = {"flash_fwd_lse_f32": (torch.empty_like(qh), torch.empty_like(lse)),
                "flash_bwd_dq_f32": (torch.empty_like(qh),),
                "flash_bwd_dkv_f32": (torch.empty_like(kh), torch.empty_like(vh))}
        stream = torch.cuda.current_stream().cuda_stream
        args = {"flash_fwd_lse_f32": lambda: (qh.data_ptr(), kh.data_ptr(), vh.data_ptr(),
                                              outs["flash_fwd_lse_f32"][0].data_ptr(),
                                              outs["flash_fwd_lse_f32"][1].data_ptr(), bn, sq,
                                              ska, skp, stream),
                "flash_bwd_dq_f32": lambda: (qh.data_ptr(), kh.data_ptr(), vh.data_ptr(),
                                             doh.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                                             outs["flash_bwd_dq_f32"][0].data_ptr(), f, bn, sq,
                                             ska, skp, stream),
                "flash_bwd_dkv_f32": lambda: (qh.data_ptr(), kh.data_ptr(), vh.data_ptr(),
                                              doh.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                                              outs["flash_bwd_dkv_f32"][0].data_ptr(),
                                              outs["flash_bwd_dkv_f32"][1].data_ptr(), bn, sq,
                                              sq, ska, skp, stream)}
        this = {"flash_fwd_lse_f32": lambda: fa.flash_fwd(qh, kh, vh, sk_actual=ska),
                "flash_bwd_dq_f32": lambda: (fa.flash_bwd_dq(qh, kh, vh, doh, lse, delta,
                                                             sk_actual=ska, dq_factor=f),),
                "flash_bwd_dkv_f32": lambda: fa.flash_bwd_dkv(qh, kh, vh, doh, lse, delta,
                                                              sq=sq, sk_actual=ska)}
        for name, entry in found.items():
            def other_call(name=name, entry=entry):
                rc = entry(*args[name]())
                if rc:
                    raise RuntimeError(f"{entries[name][0]}: cudaError {rc}")
                return outs[name]
            by = {"other": other_call, "this": this[name]}
            for who, fn in by.items():
                got = fn()
                torch.cuda.synchronize()
                rel = max(((a.double() - b.double()).norm() / b.double().norm()).item()
                          for a, b in zip(got[:1] if name == "flash_fwd_lse_f32" else got,
                                          refs[name]))
                lse_err = ((got[1] - refs[name][1]).abs().max().item()
                           if name == "flash_fwd_lse_f32" else 0.0)
                if not (rel < 1e-5 and lse_err < 1e-5):
                    raise RuntimeError(f"{name} A/B {tag}, {who} build: relative L2 {rel}, "
                                       f"lse error {lse_err}")
            times = {"this": [], "other": [], "host_this": [], "host_other": []}
            for who in ("other", "this", "this", "other"):
                times[who].append(device_ms(by[who], 10))
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(20):
                    by[who]()
                times["host_" + who].append((time.perf_counter() - t0) / 20 * 1e3)
                torch.cuda.synchronize()
            res[name][tag] = times
            print(f"  fp32 A/B {tag} {name}: device ms this " +
                  " / ".join(f"{m:.4f}" for m in times["this"]) + ", other (the other build's "
                  "C entry) " + " / ".join(f"{m:.4f}" for m in times["other"]) +
                  "; host ms a call this " + " / ".join(f"{m:.4f}" for m in times["host_this"]) +
                  ", other " + " / ".join(f"{m:.4f}" for m in times["host_other"]), flush=True)
        del qh, kh, vh, doh, o, lse, delta, refs, outs, args, this
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
    (CFG 7.5, BrushNet scale 0.7) on a seeded masked image, the first with
    SDXL_STEPS (5, cut from the CLI's 50) DPM-Solver++ steps, the second
    with 4 LCM steps (scheduler="lcm",
    examples/brushnet_stylize.py --scheduler lcm --steps 4), each with
    exact launch counts of K4's max and masked forms and K5 at head dim 64
    and none of the other kernels; then one BrushNet + UNet step under
    torch.profiler.  Returns the launches, the models, the prompt
    embeddings and the configs (sdxl_train_phase trains on them), and
    CLIP-L and the VAE with their configs (sd15_phase reuses them)."""
    import numpy as np
    import torch

    from fairygen_tpu_torch import convert
    from fairygen_tpu_torch.core.imaging import postprocess_image
    from fairygen_tpu_torch.models.sdxl.clip import CLIPTextConfig
    from fairygen_tpu_torch.models.sdxl.unet2d import (UNet2DConfig, brushnet_forward,
                                                       unet2d_forward)
    from fairygen_tpu_torch.models.sdxl.vae import AutoencoderKLConfig
    from fairygen_tpu_torch.ops import _kernels
    from fairygen_tpu_torch.ops import flash_attention as fa
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

    total = {k: 0 for k in _kernels.launches}
    for seed, steps, scheduler in ((333, SDXL_STEPS, "dpm"), (334, SDXL_LCM_STEPS, "lcm")):
        want = {k: SDXL_PER_STEP.get(k, 0) * steps for k in _kernels.launches}
        _kernels.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        img = pipe(prompt_embeds=pe, pooled_embeds=ppe, negative_prompt_embeds=npe,
                   negative_pooled_embeds=nppe, image=masked, mask=mask, height=1024,
                   width=1024, num_inference_steps=steps, guidance_scale=7.5,
                   brushnet_conditioning_scale=0.7, seed=seed, scheduler=scheduler,
                   output_type="np_pm1")
        torch.cuda.synchronize()
        dt = time.perf_counter() - t1
        got = dict(_kernels.launches)
        finite = bool(torch.isfinite(img).all())
        arr = postprocess_image(img[0].cpu().numpy())
        print(f"  SDXL + BrushNet + DoRA request seed={seed}, {steps} {scheduler} steps: "
              f"{dt:.3f} s, output "
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
    del pipe, te2, img, x, cond
    torch.cuda.empty_cache()
    return total, dict(unet=unet, bn=bn, vae=vae, ucfg=ucfg, bcfg=bcfg, vcfg=vcfg, pe=pe,
                       ppe=ppe), dict(te=te1, te_cfg=te1_cfg, vae=vae, vae_cfg=vcfg)


BRUSHNET_TRAIN_STEPS = 2
DISTILL_DIRECT_SIZE = 512  # a cut: see sdxl_train_phase
DISTILL_DIRECT_STEPS = (2, 2)  # student, teacher (the default teacher takes 50; 4 and 4 until PR 24)
# attention launches of one UNet sweep at batch 1 (the sdxl phase's per-step
# counts at CFG batch 2, BrushNet's mid attention left out): under a
# gradient every attention is K6a + K6b + K6c at head dim 64; without, the
# 10 self-attentions over 4096 tokens are K5, the 60 over 1024 K4's max
# form and the 70 cross-attentions K4's masked form; at 512x512 (1024 and
# 256 tokens, each one k tile) all 70 self-attentions are K4's max form
SDXL_SWEEP_GRAD = {k: 140 for k in BF16_D64_KERNELS}
SDXL_SWEEP_NO_GRAD = {1024: {"flash_fwd_d64": 10, "flash_small_kv_max": 60,
                             "flash_small_kv_masked": 70},
                      512: {"flash_small_kv_max": 70, "flash_small_kv_masked": 70}}


def strip_lora(tree):
    """A copy of a param tree without its adapters (the converted base
    weights)."""
    if isinstance(tree, dict):
        return {k: strip_lora(v) for k, v in tree.items() if k != "lora"}
    if isinstance(tree, list):
        return [strip_lora(v) for v in tree]
    return tree.detach().clone()


def sdxl_train_phase(unet, bn, vae, ucfg, bcfg, vcfg, pe, ppe):
    """SDXL's bf16 training at full width on the card, on the sdxl phase's
    seeded UNet (with its Style DoRA at 0.66), BrushNet-SDXL and fp32 VAE:
      brushnet    — two make_brushnet_train_step steps
                    (training/brushnet_trainer.py, upstream's
                    train_brushnet_sdxl.py: AdamW at lr 1e-5, the BrushNet
                    branch's fp32 weights computing in bf16 beside the frozen
                    bf16 UNet) at 1024x1024 on a seeded image with a
                    random_mask_gen mask, the masked image VAE-encoded as
                    the conditioning latents: each step's wall, peak GiB, a
                    finite loss, exact launches (K6a, K6b and K6c bf16 at
                    head dim 64 141 each: the 70 transformer blocks' self-
                    and cross-attention, all downstream of BrushNet's first
                    residual, and BrushNet's mid attention; no other
                    kernel), every BrushNet tensor moved and the UNet bit
                    for bit against a copy on the card; the second step
                    under torch.profiler (busy share, kernel times);
      consistency — one make_sdxl_distill_train_step(method="consistency")
                    step at 1024x1024 (training/distill.py), the student a
                    bf16 copy of the UNet's base weights (no DoRA), the
                    teacher the phase's UNet, AdamW at lr 1e-6: the
                    student's sweep under a gradient (K6a-c 140 each), the
                    teacher's and the target's without;
      direct      — one method="direct" step at 512x512 with
                    DISTILL_DIRECT_STEPS (2 student and 2 teacher steps,
                    4 and 4 until PR 24), a cut: the default 50 teacher
                    steps at 1024x1024, with 4 student backwards held at
                    once, fit neither the phase's budget nor the card's
                    memory.
    Returns the launches."""
    import contextlib

    import numpy as np
    import torch

    from fairygen_tpu_torch.models.adapters import leaves_with_path
    from fairygen_tpu_torch.models.sdxl.unet2d import unet2d_forward
    from fairygen_tpu_torch.models.sdxl.vae import vae_encode
    from fairygen_tpu_torch.ops import _kernels
    from fairygen_tpu_torch.pipelines.sdxl_brushnet import _nearest_resize
    from fairygen_tpu_torch.training.brushnet_trainer import (make_brushnet_train_step,
                                                              random_mask_gen)
    from fairygen_tpu_torch.training.distill import make_sdxl_distill_train_step
    from fairygen_tpu_torch.training.optimizers import make_optimizer

    bf, gib = torch.bfloat16, 2 ** 30
    total = {k: 0 for k in _kernels.launches}
    t_phase = time.perf_counter()

    def count(got, want, label):
        print(f"  {label}: launches { {k: v for k, v in got.items() if v} }", flush=True)
        if got != {k: want.get(k, 0) for k in got}:
            raise RuntimeError(f"{label}: launches {got} != {want}")
        for k, v in got.items():
            total[k] += v

    # the batch: a seeded 1024x1024 image, its random brush mask (1 =
    # reserved, 0 = hole), the image and the masked image through the VAE
    t1 = time.perf_counter()
    image = seeded_image(71, 1024, 1024).astype(np.float32) / 127.5 - 1.0
    reserved = random_mask_gen(np.random.RandomState(72), 1024, 1024)
    with torch.no_grad():
        pixel = torch.from_numpy(image).permute(2, 0, 1)[None].cuda()
        hole = torch.from_numpy(1.0 - reserved)[None, None].cuda()
        latents = vae_encode(vae, vcfg, pixel) * vcfg.scaling_factor
        cond = vae_encode(vae, vcfg, pixel * (1.0 - hole)) * vcfg.scaling_factor
        mask_lat = _nearest_resize(hole, *latents.shape[-2:])
    time_ids = torch.tensor([[1024.0, 1024, 0, 0, 1024, 1024]], device="cuda")
    batch = {"latents": latents.to(bf), "cond_latents": cond.to(bf),
             "mask_latents": mask_lat.to(bf), "prompt_embeds": pe.to(bf), "pooled": ppe.float(),
             "time_ids": time_ids}
    torch.cuda.synchronize()
    print(f"  BrushNet batch in {time.perf_counter() - t1:.3f} s: latents "
          f"{tuple(latents.shape)}, hole share of the mask {float(hole.mean()):.4f} "
          f"({float(mask_lat.mean()):.4f} on the latent grid)", flush=True)

    # brushnet: fp32 weights of the branch, the frozen bf16 UNet
    bn32 = to(bn, "cuda", torch.float32)
    init, step = make_brushnet_train_step(ucfg, bcfg, unet, make_optimizer("adamw", 1e-5),
                                          device="cuda")
    state = init(bn32)
    ref_unet = [t.detach().clone() for _, t in leaves_with_path(unet) if torch.is_tensor(t)]
    ref_gib = sum(t.numel() * t.element_size() for t in ref_unet) / gib
    print(f"  {len(state.trainable)} BrushNet tensors ({sum(t.numel() for t in state.trainable):,}"
          f" fp32 values) train; a {ref_gib:.2f} GiB copy of the UNet's {len(ref_unet)} tensors "
          f"holds it", flush=True)
    want = {k: v + 1 for k, v in SDXL_SWEEP_GRAD.items()}  # + BrushNet's mid attention
    gen = torch.Generator("cuda").manual_seed(73)
    # the device's activity only: a step runs ~36,000 kernels from ~10^5
    # host ops, whose records took the tracer longer to sort than the step
    acts = [torch.profiler.ProfilerActivity.CUDA]
    for i in range(BRUSHNET_TRAIN_STEPS):
        before = [t.detach().clone() for t in state.trainable]
        _kernels.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        profiler = (torch.profiler.profile(activities=acts) if i == BRUSHNET_TRAIN_STEPS - 1
                    else contextlib.nullcontext())
        with profiler as prof:
            t1 = time.perf_counter()
            state, loss = step(state, batch, gen)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t1
        moved = sum(not torch.equal(t, b) for t, b in zip(state.trainable, before))
        same = all(torch.equal(t, r) for t, r in zip(
            (t for _, t in leaves_with_path(unet) if torch.is_tensor(t)), ref_unet))
        peak = torch.cuda.max_memory_allocated() / gib - ref_gib
        print(f"  BrushNet step {i + 1}{' (profiled)' if prof else ''}: {wall:.3f} s, loss "
              f"{float(loss):.6f}, max_memory_allocated {peak:.2f} GiB (without the UNet's "
              f"copy), BrushNet tensors moved {moved} of {len(before)}, UNet bit for bit as "
              f"before: {same}", flush=True)
        count(dict(_kernels.launches), want, f"BrushNet step {i + 1}")
        if not (torch.isfinite(loss) and same and moved == len(before)):
            raise RuntimeError(f"BrushNet step {i + 1} failed its checks")
        if prof:
            t1 = time.perf_counter()
            device_table(prof, wall, "profiled BrushNet step (1024x1024, bf16 UNet, fp32 "
                         "BrushNet weights)", 16, also=("fa_",))
            print(f"  (the trace's table took {time.perf_counter() - t1:.3f} s)", flush=True)
        del before
    del state, step, init, bn32, ref_unet
    torch.cuda.empty_cache()
    print(f"  BrushNet part of the phase: {time.perf_counter() - t_phase:.3f} s", flush=True)

    # distillation: the student a bf16 copy of the UNet's base weights
    def unet_fn(params, x, t, ctx):
        return unet2d_forward(params, ucfg, x, t, ctx["pe"], text_embeds=ctx["pooled"],
                              time_ids=ctx["time_ids"])

    student = strip_lora(unet)
    ctx = {"pe": pe.to(bf), "pooled": ppe.float(), "time_ids": time_ids}
    for method, size in (("consistency", 1024), ("direct", DISTILL_DIRECT_SIZE)):
        n_s, n_t = DISTILL_DIRECT_STEPS if method == "direct" else (1, 0)
        init, step = make_sdxl_distill_train_step(
            unet_fn, make_optimizer("adamw", 1e-6), unet, method=method, num_student_steps=n_s,
            num_teacher_steps=n_t or 50, device="cuda")
        state = init(student)
        c = {**ctx, "time_ids": torch.tensor([[float(size), size, 0, 0, size, size]],
                                             device="cuda")}
        x = latents if size == 1024 else torch.randn(
            (1, 4, size // 8, size // 8), generator=gen, device="cuda")
        b = {"ctx": c, ("latents" if method == "consistency" else "noise"): x.to(bf)}
        # consistency: the student under a gradient once, the teacher and the
        # target without; direct: the teacher's n_t sweeps without, the
        # student's n_s under a gradient
        sweeps = (2 if method == "consistency" else n_t)
        want = {k: v * n_s for k, v in SDXL_SWEEP_GRAD.items()}
        for k, v in SDXL_SWEEP_NO_GRAD[size].items():
            want[k] = v * sweeps
        _kernels.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        state, loss = step(state, b, gen)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t1
        print(f"  distill step, method={method} at {size}x{size}"
              + (f" ({n_s} student, {n_t} teacher steps)" if method == "direct" else "")
              + f": {wall:.3f} s, loss {float(loss):.6f}, max_memory_allocated "
              f"{torch.cuda.max_memory_allocated() / gib:.2f} GiB", flush=True)
        count(dict(_kernels.launches), want, f"distill step ({method})")
        if not torch.isfinite(loss):
            raise RuntimeError(f"the {method} distill step's loss is not finite")
        del state, step, init
        torch.cuda.empty_cache()
    del student
    torch.cuda.empty_cache()
    return total


SD15_STEPS = 20  # cut from the CLI twin's default 50 to keep the smoke in its budget
# per BrushNet + UNet step at 512x512, CFG batch 2 (checked on the CPU by
# tests/test_torch_sd15_kernels.py with the real block structure): the 5
# transformer blocks at 64 x 64 latents (4096 tokens, d 40) self-attend
# through K5; the 5 at 32 x 32 (1024 tokens, d 80) and the 5 at 16 x 16
# (256, d 160) through K4's max form; the 16 cross-attentions to the 77
# text keys (padded to 128), the mid block's self-attention over 64 tokens
# (d 160) and BrushNet's mid attention (64 tokens, 160 heads of d 8)
# through K4's masked form
SD15_PER_STEP = {"flash_fwd_d40": 5, "flash_small_kv_max_d80": 5, "flash_small_kv_max_d160": 5,
                 "flash_small_kv_masked_d40": 5, "flash_small_kv_masked_d80": 5,
                 "flash_small_kv_masked_d160": 7, "flash_small_kv_masked_d8": 1}


def sd15_inputs(size):
    """sdxl_inputs' seeded image and ellipse, the ellipse as the region to
    inpaint: (the image in [0, 1], the mask HW1, the masked image)."""
    masked, mask = sdxl_inputs(size)
    return (seeded_image(31, size, size) / 255.0).astype("float32"), mask, masked


def sd15_phase(te, te_cfg, vae, vae_cfg):
    """SD1.5 + BrushNet inpainting at full width and depth on the card, as
    fairygen_tpu_torch/examples/brushnet_inpaint_sd15.py answers a request:
    the SD1.5 UNet (sd15_base) and BrushNet (brushnet_sd15, with its plain
    mid attention of head dim 8) from seeded bf16 weights, the sdxl phase's
    CLIP-L and VAE (the same architectures; the VAE fp32, at SD1.5's
    scaling factor 0.18215); seeded prompt ids through encode_ids (the final
    layer-norm states, 77 x 768); one 512x512 request on a seeded masked
    image, SD15_STEPS UniPC steps, CFG 7.5, BrushNet scale 1.0, the blended
    paste: wall time, peak memory, a finite image and exact launch counts
    (SD15_PER_STEP a step, every other kernel 0); then one BrushNet + UNet
    step under torch.profiler.  Returns the launches."""
    import dataclasses

    import torch

    from fairygen_tpu_torch import convert
    from fairygen_tpu_torch.models.sdxl.unet2d import (UNet2DConfig, brushnet_forward,
                                                       unet2d_forward)
    from fairygen_tpu_torch.ops import _kernels
    from fairygen_tpu_torch.pipelines.sd15_brushnet import SD15BrushNetPipeline

    bf = torch.bfloat16
    torch.cuda.reset_peak_memory_stats()
    t1 = time.perf_counter()
    ucfg, bcfg = UNet2DConfig.sd15_base(), UNet2DConfig.brushnet_sd15()
    vcfg = dataclasses.replace(vae_cfg, scaling_factor=0.18215)
    unet = convert.init_unet2d_params(ucfg, "cuda", bf, seed=150)
    bn = convert.init_unet2d_params(bcfg, "cuda", bf, seed=151, brushnet=True)
    torch.cuda.synchronize()
    print(f"  SD1.5 weights in {time.perf_counter() - t1:.3f} s: UNet "
          f"{convert.count_params(unet):,} BrushNet {convert.count_params(bn):,} (its mid "
          f"attention: {len(bn['mid_block']['attentions'])}), CLIP-L "
          f"{convert.count_params(te):,} and VAE {convert.count_params(vae):,} of the sdxl "
          f"phase; max_memory_allocated {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB",
          flush=True)
    pipe = SD15BrushNetPipeline(unet, ucfg, vae, vcfg, bn, bcfg, te, te_cfg, dtype=bf)
    pe = pipe.encode_ids(sdxl_ids(152, 12)[0])
    npe = pipe.encode_ids(sdxl_ids(153, 0)[0])
    if tuple(pe.shape) != (1, 77, 768) or not torch.isfinite(pe).all():
        raise RuntimeError(f"the SD1.5 prompt embedding is {tuple(pe.shape)} or not finite")
    init, mask, masked = sd15_inputs(512)

    want = {k: SD15_PER_STEP.get(k, 0) * SD15_STEPS for k in _kernels.launches}
    _kernels.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    img = pipe(prompt_embeds=pe, negative_prompt_embeds=npe, image=masked, mask=mask,
               height=512, width=512, num_inference_steps=SD15_STEPS, guidance_scale=7.5,
               brushnet_conditioning_scale=1.0, seed=1234, blended=True, original_image=init,
               output_type="np_pm1")
    torch.cuda.synchronize()
    dt = time.perf_counter() - t1
    got = dict(_kernels.launches)
    finite = bool(torch.isfinite(img).all())
    print(f"  SD1.5 + BrushNet request (512x512, {SD15_STEPS} UniPC steps, CFG 7.5, BrushNet 1.0, "
          f"blended): {dt:.3f} s ({dt / SD15_STEPS * 1e3:.2f} ms a step with the encode and the "
          f"decode), output {tuple(img.shape)} {img.dtype}, all finite: {finite}, std "
          f"{img.std().item():.4f}, max_memory_allocated "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, launches "
          f"{ {k: v for k, v in got.items() if v} }", flush=True)
    if tuple(img.shape) != (1, 3, 512, 512) or not finite:
        raise RuntimeError("SD1.5 request output has the wrong shape or non-finite values")
    if got != want:
        raise RuntimeError(f"SD1.5 request launch counts {got} != expected {want}")

    # where a step's time goes: one BrushNet sweep and one UNet sweep at CFG
    # batch 2, as the pipeline runs them
    gen = torch.Generator("cuda").manual_seed(154)
    x = torch.randn((2, 4, 64, 64), generator=gen, device="cuda").to(bf)
    cond = torch.randn((2, 5, 64, 64), generator=gen, device="cuda").to(bf)
    ehs = torch.cat([npe, pe]).to(bf)
    t = torch.tensor(981.0, device="cuda")
    with torch.no_grad():
        def step():
            down, mid, up = brushnet_forward(bn, bcfg, x, t, ehs, cond)
            return unet2d_forward(unet, ucfg, x, t, ehs, down_block_add_samples=down,
                                  mid_block_add_sample=mid, up_block_add_samples=up)

        step()
        torch.cuda.synchronize()
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            t1 = time.perf_counter()
            step()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t1
    device_table(prof, wall, "profiled SD1.5 BrushNet + UNet step (512x512, CFG batch 2)", 18,
                 also=("fa_",))
    del pipe, unet, bn, img, x, cond
    torch.cuda.empty_cache()
    return got


SD_F32_SDXL_STEPS = 3  # each DPM step is the same work; the CLI's 50 would not fit the budget
SD_F32_SD15_STEPS = 20  # cut from the twin's 50 likewise
# per BrushNet + UNet step at CFG batch 2 in fp32 (tests/test_torch_fp32_forward.py
# holds the dispatch): SDXL_PER_STEP's and SD15_PER_STEP's calls under the
# fp32 counters, each with one launch of the forward's pre-pass
SDXL_F32_PER_STEP = {"flash_fwd_f32_d64": 10, "flash_small_kv_max_f32_d64": 61,
                     "flash_small_kv_masked_f32_d64": 70, "flash_fwd_prep_f32": 141}
SD15_F32_PER_STEP = {k.replace("_d", "_f32_d"): v for k, v in SD15_PER_STEP.items()}
SD15_F32_PER_STEP["flash_fwd_prep_f32"] = sum(SD15_PER_STEP.values())


def sd_fp32_request(label, pipe, steps, per_step, call, shape, profile_step):
    """One request of ``pipe`` at its default fp32 (``call``'s arguments):
    wall, peak memory, a finite image of ``shape``, exact launches
    (``per_step`` a step, every other counter 0); then ``profile_step``
    (one BrushNet + UNet step at CFG batch 2) under torch.profiler: its busy
    share, kernel count and the fp32 attention kernels' device time.
    Returns the launches and the numbers."""
    import torch

    from fairygen_tpu_torch.ops import _kernels

    want = {k: per_step.get(k, 0) * steps for k in _kernels.launches}
    _kernels.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    img = pipe(num_inference_steps=steps, output_type="np_pm1", **call)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t1
    got = dict(_kernels.launches)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    finite = bool(torch.isfinite(img).all())
    print(f"  {label}, {steps} steps: {dt:.3f} s ({dt / steps * 1e3:.2f} ms a step with the "
          f"encode and the decode), output {tuple(img.shape)} {img.dtype}, all finite: "
          f"{finite}, std {img.std().item():.4f}, max_memory_allocated {peak:.2f} GiB, launches "
          f"{ {k: v for k, v in got.items() if v} }", flush=True)
    if tuple(img.shape) != shape or img.dtype != torch.float32 or not finite:
        raise RuntimeError(f"{label}: the output has the wrong shape or type or non-finite values")
    if got != want:
        raise RuntimeError(f"{label}: launch counts {got} != expected {want}")
    with torch.no_grad():
        profile_step()
        torch.cuda.synchronize()
        # the device's activity only, read once: the table of a trace of
        # ~16,000 kernels takes seconds
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            t1 = time.perf_counter()
            profile_step()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t1
    averages = list(prof.key_averages())
    busy = device_table(averages, wall, f"profiled {label} step (CFG batch 2, fp32)", 14,
                        also=("fa_f32",))
    rows = [e for e in averages if e.device_type == torch.autograd.DeviceType.CUDA]
    attn = sum(e.self_device_time_total for e in rows if "fa_f32" in e.key) / 1e3
    print(f"  the fp32 attention kernels (pre-pass and forward) in that step: {attn:.3f} ms of "
          f"device time", flush=True)
    return got, dict(request_s=dt, peak_gib=peak, step_wall_ms=wall * 1e3,
                     step_busy_ms=busy * 1e3, step_kernels=sum(e.count for e in rows),
                     step_attention_ms=attn)


def sd_fp32_phase():
    """The SDXL and SD1.5 BrushNet pipelines at their default dtype (fp32)
    on the card, at full width and depth, from seeded fp32 weights:
      sdxl — the SDXL UNet with a rank-32 Style DoRA loaded at 0.66 (seeded
             non-zero B and magnitudes, as the sdxl phase makes it),
             BrushNet-SDXL, CLIP-L, OpenCLIP bigG and the SDXL VAE;
             SDXLBrushNetPipeline built without a dtype; one 1024x1024
             DPM-Solver++ request of SD_F32_SDXL_STEPS steps at CFG 7.5,
             BrushNet 0.7, on sdxl_inputs' seeded masked image;
      sd15 — the SD1.5 UNet and BrushNet with the CLIP-L and VAE above (the
             same architectures; scaling factor 0.18215); SD15BrushNetPipeline
             built without a dtype; one 512x512 UniPC request of
             SD_F32_SD15_STEPS steps at CFG 7.5, BrushNet 1.0, blended.
    Each request through K5 and K4's max and masked forms in fp32 (the
    3xTF32 kernels of csrc/flash_attention_fp32.cu): wall, peak memory, a
    finite fp32 image, exact launches (SDXL_F32_PER_STEP /
    SD15_F32_PER_STEP a step, every other counter 0) and one profiled
    BrushNet + UNet step.  Returns the launches and the numbers."""
    import dataclasses

    import numpy as np
    import torch

    from fairygen_tpu_torch import convert
    from fairygen_tpu_torch.models.sdxl.clip import CLIPTextConfig
    from fairygen_tpu_torch.models.sdxl.unet2d import (UNet2DConfig, brushnet_forward,
                                                       unet2d_forward)
    from fairygen_tpu_torch.models.sdxl.vae import AutoencoderKLConfig
    from fairygen_tpu_torch.ops import _kernels
    from fairygen_tpu_torch.pipelines.sd15_brushnet import SD15BrushNetPipeline
    from fairygen_tpu_torch.pipelines.sdxl_brushnet import SDXLBrushNetPipeline
    from fairygen_tpu_torch.training.dora_trainer import (add_dora_to_sdxl_unet,
                                                          load_sdxl_dora_state_dict,
                                                          sdxl_dora_state_dict)

    f32 = torch.float32
    total, numbers = {k: 0 for k in _kernels.launches}, {}
    torch.cuda.reset_peak_memory_stats()
    t1 = time.perf_counter()
    ucfg, bcfg = UNet2DConfig.sdxl_base(), UNet2DConfig.brushnet_sdxl()
    te1_cfg, te2_cfg = CLIPTextConfig.sdxl_te1(), CLIPTextConfig.sdxl_te2()
    vcfg = AutoencoderKLConfig.sdxl()
    unet = convert.init_unet2d_params(ucfg, "cuda", f32, seed=170)
    bn = convert.init_unet2d_params(bcfg, "cuda", f32, seed=171, brushnet=True)
    te1 = convert.init_clip_text_params(te1_cfg, "cuda", f32, seed=172)
    te2 = convert.init_clip_text_params(te2_cfg, "cuda", f32, seed=173)
    vae = convert.init_autoencoder_kl_params(vcfg, "cuda", f32, seed=174)
    counts = [convert.count_params(t) for t in (unet, bn, te1, te2, vae)]
    dora = sdxl_dora_state_dict(add_dora_to_sdxl_unet(
        unet, torch.Generator("cuda").manual_seed(175), rank=32))
    rng = np.random.default_rng(176)
    for k, v in dora.items():
        if k.endswith(".lora_B.weight"):
            dora[k] = (0.02 * rng.standard_normal(v.shape)).astype(np.float32)
        elif k.endswith(".lora_magnitude_vector.weight"):
            dora[k] = (v * rng.uniform(0.9, 1.1, v.shape)).astype(np.float32)
    unet, n = load_sdxl_dora_state_dict(unet, dora, scale=0.66)
    del dora
    torch.cuda.synchronize()
    print(f"  fp32 SDXL weights and a rank-32 DoRA ({n} adapters) in "
          f"{time.perf_counter() - t1:.3f} s: UNet {counts[0]:,} BrushNet {counts[1]:,} CLIP-L "
          f"{counts[2]:,} OpenCLIP bigG {counts[3]:,} VAE {counts[4]:,}; "
          f"max_memory_allocated {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB",
          flush=True)
    if n != 560:
        raise RuntimeError(f"{n} DoRA adapters loaded, expected 560")
    pipe = SDXLBrushNetPipeline(unet, ucfg, vae, vcfg, bn, bcfg, te1, te1_cfg, te2, te2_cfg)
    if pipe.dtype != f32 or pipe.device.type != "cuda":
        raise RuntimeError(f"SDXLBrushNetPipeline defaults to {pipe.dtype} on {pipe.device}")
    pe, ppe = pipe.encode_ids(*sdxl_ids(177, 40))
    npe, nppe = pipe.encode_ids(*sdxl_ids(178, 0))
    masked, mask = sdxl_inputs(1024)
    gen = torch.Generator("cuda").manual_seed(179)
    x = torch.randn((2, 4, 128, 128), generator=gen, device="cuda")
    cond = torch.randn((2, 5, 128, 128), generator=gen, device="cuda")
    ehs = torch.cat([npe, pe])
    kw = dict(text_embeds=torch.cat([nppe, ppe]),
              time_ids=torch.tensor([[1024.0, 1024, 0, 0, 1024, 1024]] * 2, device="cuda"))
    t = torch.tensor(981.0, device="cuda")

    def sdxl_step():
        down, mid, up = brushnet_forward(bn, bcfg, x, t, ehs, cond, conditioning_scale=0.7, **kw)
        return unet2d_forward(unet, ucfg, x, t, ehs, down_block_add_samples=down,
                              mid_block_add_sample=mid, up_block_add_samples=up, **kw)
    got, numbers["sdxl"] = sd_fp32_request(
        "SDXL + BrushNet + DoRA fp32 request (1024x1024, DPM-Solver++, CFG 7.5, BrushNet 0.7)",
        pipe, SD_F32_SDXL_STEPS, SDXL_F32_PER_STEP,
        dict(prompt_embeds=pe, pooled_embeds=ppe, negative_prompt_embeds=npe,
             negative_pooled_embeds=nppe, image=masked, mask=mask, height=1024, width=1024,
             guidance_scale=7.5, brushnet_conditioning_scale=0.7, seed=335),
        (1, 3, 1024, 1024), sdxl_step)
    for k, v in got.items():
        total[k] += v
    del pipe, unet, bn, te2, x, cond, ehs, kw, pe, ppe, npe, nppe
    torch.cuda.empty_cache()

    t1 = time.perf_counter()
    ucfg, bcfg = UNet2DConfig.sd15_base(), UNet2DConfig.brushnet_sd15()
    vcfg = dataclasses.replace(vcfg, scaling_factor=0.18215)
    unet = convert.init_unet2d_params(ucfg, "cuda", f32, seed=180)
    bn = convert.init_unet2d_params(bcfg, "cuda", f32, seed=181, brushnet=True)
    torch.cuda.synchronize()
    print(f"  fp32 SD1.5 weights in {time.perf_counter() - t1:.3f} s: UNet "
          f"{convert.count_params(unet):,} BrushNet {convert.count_params(bn):,}, CLIP-L and VAE "
          f"above", flush=True)
    pipe = SD15BrushNetPipeline(unet, ucfg, vae, vcfg, bn, bcfg, te1, te1_cfg)
    if pipe.dtype != f32 or pipe.device.type != "cuda":
        raise RuntimeError(f"SD15BrushNetPipeline defaults to {pipe.dtype} on {pipe.device}")
    pe = pipe.encode_ids(sdxl_ids(182, 12)[0])
    npe = pipe.encode_ids(sdxl_ids(183, 0)[0])
    init, mask, masked = sd15_inputs(512)
    x = torch.randn((2, 4, 64, 64), generator=gen, device="cuda")
    cond = torch.randn((2, 5, 64, 64), generator=gen, device="cuda")
    ehs = torch.cat([npe, pe])

    def sd15_step():
        down, mid, up = brushnet_forward(bn, bcfg, x, t, ehs, cond)
        return unet2d_forward(unet, ucfg, x, t, ehs, down_block_add_samples=down,
                              mid_block_add_sample=mid, up_block_add_samples=up)
    got, numbers["sd15"] = sd_fp32_request(
        "SD1.5 + BrushNet fp32 request (512x512, UniPC, CFG 7.5, BrushNet 1.0, blended)", pipe,
        SD_F32_SD15_STEPS, SD15_F32_PER_STEP,
        dict(prompt_embeds=pe, negative_prompt_embeds=npe, image=masked, mask=mask, height=512,
             width=512, guidance_scale=7.5, brushnet_conditioning_scale=1.0, seed=1235,
             blended=True, original_image=init),
        (1, 3, 512, 512), sd15_step)
    for k, v in got.items():
        total[k] += v
    del pipe, unet, bn, te1, vae, x, cond, ehs
    torch.cuda.empty_cache()
    return total, numbers


def reference_fp32_goldens_check(only=None):
    """The tiny fp32 golden pipelines on the card: the upstream goldens'
    weights and inputs (tests/goldens/brushnet_pipeline.npz: SDXL + BrushNet
    at 64x64, 6 DPM-Solver++ steps, CFG 7.5, BrushNet 0.7, seed 77, head
    dim 16; sd15_pipeline.npz: SD1.5 + BrushNet at 64x64, 6 UniPC steps, CFG
    7.5, BrushNet 1.0, seed 88, head dim 8; both with torch-compatible
    noise) through the pipelines at their default fp32, so through K4's max
    and masked forms in fp32; the image held to the goldens at the
    JAX suite's bar (every pixel within 3 levels, PSNR above 45 dB, as
    tests/test_torch_sdxl_pipeline.py and tests/test_torch_sd15_pipeline.py
    hold the CPU), the launches exact: per step each transformer block's
    self-attention over 256 tokens (16 x 16 latents) through K4's max form
    and its cross-attention to the 7 prompt tokens through the masked form,
    12 blocks at d 16 (SDXL), 6 at d 8 (SD1.5; the goldens' BrushNets have
    no mid attention), each call with one launch of the pre-pass.  ``only``:
    "SDXL" or "SD1.5" alone (the card tests run them apart)."""
    import numpy as np
    import torch

    from fairygen_tpu_torch.models.sdxl import unet2d as tunet
    from fairygen_tpu_torch.models.sdxl import vae as tvae
    from fairygen_tpu_torch.ops import _kernels
    from fairygen_tpu_torch.pipelines.sd15_brushnet import SD15BrushNetPipeline
    from fairygen_tpu_torch.pipelines.sdxl_brushnet import SDXLBrushNetPipeline

    def sd(g, prefix):
        n = len(prefix) + 2
        return {k[n:]: g[k] for k in g.files if k.startswith(prefix + "::")}

    sdxl_kw = dict(block_out_channels=(32, 64), down_block_types=("DownBlock2D",
                                                                 "CrossAttnDownBlock2D"),
                   up_block_types=("CrossAttnUpBlock2D", "UpBlock2D"),
                   transformer_layers_per_block=(1, 2), num_attention_heads=(2, 4),
                   cross_attention_dim=32, norm_num_groups=16, addition_time_embed_dim=8,
                   projection_class_embeddings_input_dim=80)
    sd15_kw = dict(block_out_channels=(32, 64), down_block_types=("DownBlock2D",
                                                                 "CrossAttnDownBlock2D"),
                   up_block_types=("CrossAttnUpBlock2D", "UpBlock2D"),
                   transformer_layers_per_block=(1, 1), num_attention_heads=(4, 8),
                   cross_attention_dim=32, norm_num_groups=16, addition_embed_type=None)
    bn_over = dict(down_block_types=("DownBlock2D",) * 2, up_block_types=("UpBlock2D",) * 2,
                   mid_block_type="UNetMidBlock2D", transformer_layers_per_block=(0, 0),
                   attention_head_dim=8, conditioning_channels=5)
    goldens = os.path.join(HERE, "tests", "goldens")
    cases = (("SDXL", "brushnet_pipeline.npz", sdxl_kw, {}, 77,
              {"flash_small_kv_max_f32_d16": 12, "flash_small_kv_masked_f32_d16": 12}),
             ("SD1.5", "sd15_pipeline.npz", sd15_kw, dict(scaling_factor=0.18215), 88,
              {"flash_small_kv_max_f32_d8": 6, "flash_small_kv_masked_f32_d8": 6}))
    for label, fname, kw, vae_over, seed, per_step in cases:
        if only not in (None, label):
            continue
        g = np.load(os.path.join(goldens, fname))
        ucfg, bcfg = tunet.UNet2DConfig(**kw), tunet.UNet2DConfig(**{**kw, **bn_over})
        vcfg = tvae.AutoencoderKLConfig.tiny(**vae_over)
        parts = (tunet.convert_unet2d_state_dict(sd(g, "unet"), ucfg, device="cuda"), ucfg,
                 tvae.convert_autoencoder_kl_state_dict(sd(g, "vae"), vcfg, device="cuda"), vcfg,
                 tunet.convert_unet2d_state_dict(sd(g, "bn"), bcfg, device="cuda"), bcfg)
        call = dict(prompt_embeds=g["pe"], negative_prompt_embeds=g["npe"],
                    image=g["masked_u8"].astype(np.float32) / 255.0,
                    mask=g["mask_u8"].astype(np.float32) / 255.0, height=64, width=64,
                    num_inference_steps=6, guidance_scale=7.5, seed=seed,
                    torch_compat_noise=True)
        if label == "SDXL":
            pipe = SDXLBrushNetPipeline(*parts)
            call.update(pooled_embeds=g["ppe"], negative_pooled_embeds=g["nppe"],
                        brushnet_conditioning_scale=0.7)
        else:
            pipe = SD15BrushNetPipeline(*parts)
            call.update(brushnet_conditioning_scale=1.0)
        _kernels.reset_launches()
        frames = pipe(**call)
        ran = {k: v for k, v in _kernels.launches.items() if v}
        want = {k: 6 * v for k, v in per_step.items()}
        want["flash_fwd_prep_f32"] = 6 * sum(per_step.values())
        ours = frames[0].astype(np.float32)
        ref = g["img_out"].astype(np.float32) * 255.0
        diff = np.abs(ours - ref)
        psnr = 10 * np.log10(255.0 ** 2 / max(float(np.mean(diff ** 2)), 1e-9))
        print(f"  {label} fp32 golden ({fname}) on the card: max pixel difference "
              f"{diff.max():.0f} (bound 3), PSNR {psnr:.1f} dB (bound 45), launches {ran}",
              flush=True)
        if ours.shape != (64, 64, 3) or ran != want or diff.max() > 3 or not psnr > 45:
            raise RuntimeError(f"the {label} fp32 golden failed on the card: {ran} != {want} or "
                               f"the image is off")


def reference_sd15_check():
    """A tiny SD1.5 + BrushNet pipeline on the card (bf16, kernels) against
    the same weights on the CPU in fp32 and in bf16 (plain versions): a
    two-level UNet with channels 40 and 80 at one head a level (head dims 40
    and 80), a BrushNet whose mid attention has head dim 8 (10 heads), the
    4-level VAE at width 32; 256x256 (32 x 32 latents: K4's max form at d
    40 over 1024 tokens, at d 80 over 256 and at d 8 for BrushNet's mid
    attention, its masked form over the 77 text keys), 3 UniPC steps at CFG
    7.5, BrushNet 1.0, torch-compatible noise.  The card's relative L2
    error of the final latents to the CPU fp32 run must be at most twice
    the CPU bf16 run's + 1e-3, and the launches exact."""
    import torch

    from fairygen_tpu_torch import convert
    from fairygen_tpu_torch.models.sdxl.unet2d import UNet2DConfig
    from fairygen_tpu_torch.models.sdxl.vae import AutoencoderKLConfig
    from fairygen_tpu_torch.ops import _kernels
    from fairygen_tpu_torch.pipelines.sd15_brushnet import SD15BrushNetPipeline

    kw = dict(block_out_channels=(40, 80), num_attention_heads=(1, 1),
              down_block_types=("CrossAttnDownBlock2D",) * 2,
              up_block_types=("CrossAttnUpBlock2D",) * 2, transformer_layers_per_block=(1, 1),
              cross_attention_dim=32, norm_num_groups=8, addition_embed_type=None)
    ucfg = UNet2DConfig(**kw)
    bcfg = UNet2DConfig(**{**kw, "down_block_types": ("DownBlock2D",) * 2,
                           "up_block_types": ("UpBlock2D",) * 2, "mid_block_type": "UNetMidBlock2D",
                           "attention_head_dim": 8, "conditioning_channels": 5})
    vcfg = AutoencoderKLConfig(block_out_channels=(32, 32, 32, 32), norm_num_groups=8,
                               scaling_factor=0.18215)
    f32 = torch.float32
    base = (convert.init_unet2d_params(ucfg, "cpu", f32, seed=160),
            convert.init_unet2d_params(bcfg, "cpu", f32, seed=161, brushnet=True),
            convert.init_autoencoder_kl_params(vcfg, "cpu", f32, seed=162))
    g = torch.Generator("cpu").manual_seed(163)
    init, mask, masked = sd15_inputs(256)
    steps = 3
    call = dict(prompt_embeds=torch.randn(1, 77, 32, generator=g),
                negative_prompt_embeds=torch.randn(1, 77, 32, generator=g), image=masked,
                mask=mask, height=256, width=256, num_inference_steps=steps, guidance_scale=7.5,
                brushnet_conditioning_scale=1.0, seed=164, torch_compat_noise=True,
                output_type="latent")

    def run(dev, dt):
        pipe = SD15BrushNetPipeline(to(base[0], dev, dt), ucfg, to(base[2], dev, f32), vcfg,
                                    to(base[1], dev, dt), bcfg, dtype=dt, device=dev)
        return pipe(**call).float().cpu()

    ref = run("cpu", f32)
    rel16 = ((run("cpu", torch.bfloat16) - ref).norm() / ref.norm()).item()
    _kernels.reset_launches()
    out = run("cuda", torch.bfloat16)
    ran = {k: v for k, v in _kernels.launches.items() if v}
    rel = ((out - ref).norm() / ref.norm()).item()
    tol = 2 * rel16 + 1e-3
    print(f"  tiny SD1.5 + BrushNet pipeline latents {tuple(out.shape)}: relative L2 error to "
          f"CPU fp32 {rel:.4e} (card bf16), {rel16:.4e} (CPU bf16); tolerance {tol:.4e}; "
          f"kernel launches {ran}", flush=True)
    # per step: 2 + 3 blocks at 32 x 32 (d 40), 2 + 1 (mid) + 3 at 16 x 16
    # (d 80), BrushNet's mid attention at 16 x 16 (d 8)
    want = {"flash_small_kv_max_d40": 5 * steps, "flash_small_kv_max_d80": 6 * steps,
            "flash_small_kv_max_d8": steps, "flash_small_kv_masked_d40": 5 * steps,
            "flash_small_kv_masked_d80": 6 * steps}
    if ran != want:
        raise RuntimeError(f"tiny SD1.5 pipeline: kernel launches {ran} != {want}")
    if not rel <= tol:
        raise RuntimeError("tiny SD1.5 pipeline disagrees with the CPU reference")


def tiny_sdxl_cfgs():
    """The tiny head-dim-64 SDXL UNet, BrushNet and VAE of the reference
    checks: channels (64, 128) at 1 and 2 heads, one transformer block per
    attention, a BrushNet mid attention of head dim 64, the 4-level VAE at
    width 32."""
    from fairygen_tpu_torch.models.sdxl.unet2d import UNet2DConfig
    from fairygen_tpu_torch.models.sdxl.vae import AutoencoderKLConfig

    kw = dict(block_out_channels=(64, 128), num_attention_heads=(1, 2),
              down_block_types=("CrossAttnDownBlock2D", "CrossAttnDownBlock2D"),
              up_block_types=("CrossAttnUpBlock2D", "CrossAttnUpBlock2D"),
              transformer_layers_per_block=(1, 1), cross_attention_dim=64,
              addition_time_embed_dim=8, projection_class_embeddings_input_dim=80)
    bcfg = UNet2DConfig(**{**kw, "down_block_types": ("DownBlock2D",) * 2,
                           "up_block_types": ("UpBlock2D",) * 2,
                           "mid_block_type": "UNetMidBlock2D", "attention_head_dim": 64,
                           "conditioning_channels": 5})
    return UNet2DConfig(**kw), bcfg, AutoencoderKLConfig(block_out_channels=(32, 32, 32, 32),
                                                         norm_num_groups=8)


def reference_sdxl_train_check():
    """A tiny bf16 BrushNet step and a tiny LCM request on the card against
    the CPU: the tiny head-dim-64 UNet and BrushNet (tiny_sdxl_cfgs) at
    256x256 (32 x 32 latents: 1024 and 256 tokens), the same CPU-drawn
    timestep and noise.  The step's loss and its BrushNet gradients, and
    the request's final latents (2 LCM steps at CFG 7.5, BrushNet 0.7,
    torch-compatible noise), on the card in bf16 must lie within twice the
    CPU bf16 run's relative L2 error to the CPU fp32 run + 1e-3.  The step
    launches K6a, K6b and K6c in bf16 at head dim 64 23 times each (11
    transformer blocks' two attentions and BrushNet's mid attention), the
    request K4's max form for every self-attention and its masked form for
    the cross-attention."""
    import torch

    from fairygen_tpu_torch import convert
    from fairygen_tpu_torch.ops import _kernels
    from fairygen_tpu_torch.pipelines.sdxl_brushnet import SDXLBrushNetPipeline
    from fairygen_tpu_torch.training.brushnet_trainer import make_brushnet_train_step
    from fairygen_tpu_torch.training.optimizers import make_optimizer

    ucfg, bcfg, vcfg = tiny_sdxl_cfgs()
    f32 = torch.float32
    base = (convert.init_unet2d_params(ucfg, "cpu", f32, seed=110),
            convert.init_unet2d_params(bcfg, "cpu", f32, seed=111, brushnet=True),
            convert.init_autoencoder_kl_params(vcfg, "cpu", f32, seed=112))
    g = torch.Generator("cpu").manual_seed(113)
    batch = {"latents": torch.randn(1, 4, 32, 32, generator=g),
             "cond_latents": torch.randn(1, 4, 32, 32, generator=g),
             "mask_latents": (torch.rand(1, 1, 32, 32, generator=g) > 0.5).float(),
             "prompt_embeds": torch.randn(1, 77, 64, generator=g),
             "pooled": torch.randn(1, 32, generator=g),
             "time_ids": torch.tensor([[256.0, 256, 0, 0, 256, 256]])}
    draws = {"timesteps": torch.tensor([601]), "noise": torch.randn(1, 4, 32, 32, generator=g)}

    def fresh(tree, dev, dt):  # a copy: the step sets requires_grad on its tensors
        return strip_lora(to(tree, dev, dt))

    def step_run(dev, dt):
        init, step = make_brushnet_train_step(ucfg, bcfg, fresh(base[0], dev, dt),
                                              make_optimizer(), conditioning_scale=0.7,
                                              device=dev)
        b = {k: v.to(dev, dt if k not in ("time_ids", "pooled") else f32)
             for k, v in batch.items()}
        loss, grads = step.loss_and_grads(init(fresh(base[1], dev, dt)), b, **draws)
        return float(loss), torch.cat([grads[k].float().cpu().reshape(-1) for k in sorted(grads)])

    def rel(a, b):
        return ((a - b).norm() / b.norm()).item()

    ref = step_run("cpu", f32)
    cpu16 = step_run("cpu", torch.bfloat16)
    _kernels.reset_launches()
    card = step_run("cuda", torch.bfloat16)
    ran = {k: v for k, v in _kernels.launches.items() if v}
    tol = 2 * rel(cpu16[1], ref[1]) + 1e-3
    loss_tol = 2 * abs(cpu16[0] - ref[0]) + 1e-3 * abs(ref[0])
    print(f"  tiny bf16 BrushNet step: loss {card[0]:.6f} (card bf16), {cpu16[0]:.6f} (CPU "
          f"bf16), {ref[0]:.6f} (CPU fp32; tolerance {loss_tol:.3e}); gradients' relative L2 "
          f"error to CPU fp32 {rel(card[1], ref[1]):.4e} (card bf16), {rel(cpu16[1], ref[1]):.4e}"
          f" (CPU bf16), tolerance {tol:.4e}; launches {ran}", flush=True)
    if ran != {k: 23 for k in BF16_D64_KERNELS}:
        raise RuntimeError(f"tiny BrushNet step: launches {ran}, expected 23 of each bf16 K6")
    if not (rel(card[1], ref[1]) <= tol and abs(card[0] - ref[0]) <= loss_tol):
        raise RuntimeError("tiny bf16 BrushNet step disagrees with the CPU reference")

    masked, mask = sdxl_inputs(256)
    call = dict(prompt_embeds=batch["prompt_embeds"], pooled_embeds=batch["pooled"],
                negative_prompt_embeds=torch.randn(1, 77, 64, generator=g),
                negative_pooled_embeds=torch.randn(1, 32, generator=g), image=masked,
                mask=mask, height=256, width=256, num_inference_steps=2, guidance_scale=7.5,
                brushnet_conditioning_scale=0.7, seed=114, scheduler="lcm",
                torch_compat_noise=True, output_type="latent")

    def request(dev, dt):
        pipe = SDXLBrushNetPipeline(to(base[0], dev, dt), ucfg, to(base[2], dev, dt), vcfg,
                                    to(base[1], dev, dt), bcfg, dtype=dt, device=dev)
        return pipe(**call).float().cpu()

    lat = request("cpu", f32)
    rel16 = rel(request("cpu", torch.bfloat16), lat)
    _kernels.reset_launches()
    out = request("cuda", torch.bfloat16)
    ran = {k: v for k, v in _kernels.launches.items() if v}
    tol = 2 * rel16 + 1e-3
    print(f"  tiny LCM request latents {tuple(out.shape)}: relative L2 error to CPU fp32 "
          f"{rel(out, lat):.4e} (card bf16), {rel16:.4e} (CPU bf16); tolerance {tol:.4e}; "
          f"launches {ran}", flush=True)
    want = {"flash_small_kv_max": 12 * 2, "flash_small_kv_masked": 11 * 2}
    if ran != want or not rel(out, lat) <= tol:
        raise RuntimeError(f"tiny LCM request disagrees with the CPU reference: {ran}")


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
    from fairygen_tpu_torch.ops import _kernels
    from fairygen_tpu_torch.ops import flash_attention as fa
    from fairygen_tpu_torch.pipelines.sdxl_brushnet import SDXLBrushNetPipeline
    from fairygen_tpu_torch.training.dora_trainer import (add_dora_to_sdxl_unet,
                                                          load_sdxl_dora_state_dict,
                                                          sdxl_dora_state_dict)

    ucfg, bcfg, vcfg = tiny_sdxl_cfgs()
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


DORA_STEPS = 2  # the second with min-SNR-5 weighting; cut from 4 to keep the smoke in its budget


def dora_per_step():
    """The fp32 kernels' launches in one DoRA step: 140 each of K6a-c (70
    transformer blocks x 2 attentions) and of K6a's pre-pass, the
    backward's pre-pass twice a backward, and K6c's reduce pass at the
    shapes whose query loop it splits (on an H100's 132 SMs all four:
    140)."""
    import torch

    from fairygen_tpu_torch.ops import flash_attention as fa

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    split = sum(calls for _, bn, sq, skp, _, calls in DORA_ATTENTION_SHAPES
                if fa.dkv_splits(bn, sq, skp, sms)[0] > 1)
    return dict({k: 140 for k in F32_KERNELS}, flash_fwd_prep_f32=140, flash_bwd_prep_f32=280,
                flash_bwd_dkv_reduce_f32=split)
DORA_STYLIZE_STEPS = 4


def dora_inputs(size):
    """A seeded (size, size, 3) uint8 drawing: seeded noise with a centred
    ellipse of a flat seeded colour, the 'character'."""
    import numpy as np

    rng = np.random.default_rng(41)
    img = rng.integers(0, 256, (size, size, 3), dtype=np.uint8)
    yy, xx = np.mgrid[0:size, 0:size] / size
    inside = (((yy - 0.55) / 0.35) ** 2 + ((xx - 0.5) / 0.22) ** 2) < 1
    img[inside] = rng.integers(0, 256, 3, dtype=np.uint8)
    return img


DORA_AB_PAIRS = 10


def dora_ab_steps(state, batch, gen, step, other, want, count):
    """DORA_AB_PAIRS pairs of DoRA steps on one card, one step with
    flash_fwd as this build has it and one with ``other`` (the other
    build's fp32 K6a), in the order other, this, this, other, ...: each
    step's wall, launches (the other's: those of this build without K6a's
    pre-pass) and finite loss; then each side's median wall, and in how
    many pairs this build's step was the faster.  Returns the state."""
    import statistics

    import torch

    from fairygen_tpu_torch.ops import _kernels
    from fairygen_tpu_torch.ops import flash_attention as fa

    this = fa.flash_fwd
    walls = {"this": [], "other": []}
    order = [w for i in range(DORA_AB_PAIRS)
             for w in (("other", "this") if i % 2 == 0 else ("this", "other"))]
    for who in order:
        fa.flash_fwd = other if who == "other" else this
        _kernels.reset_launches()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        state, loss = step(state, batch, gen)
        torch.cuda.synchronize()
        walls[who].append(time.perf_counter() - t1)
        fa.flash_fwd = this
        got = dict(_kernels.launches)
        count(got)
        expect = dict(want, flash_fwd_prep_f32=0) if who == "other" else want
        print(f"  DoRA A/B step, {who} build's K6a: {walls[who][-1]:.4f} s, loss "
              f"{float(loss):.6f}", flush=True)
        if got != expect or not torch.isfinite(loss):
            raise RuntimeError(f"DoRA A/B step ({who}): launches {got} != {expect} or a "
                               f"non-finite loss")
    faster = sum(t < o for t, o in zip(walls["this"], walls["other"]))
    print(f"  DoRA A/B over {DORA_AB_PAIRS} pairs: median wall this "
          f"{statistics.median(walls['this']):.4f} s, other "
          f"{statistics.median(walls['other']):.4f} s; this build's step the faster in "
          f"{faster} of {DORA_AB_PAIRS} pairs; walls this " +
          " / ".join(f"{w:.4f}" for w in walls["this"]) + ", other " +
          " / ".join(f"{w:.4f}" for w in walls["other"]), flush=True)
    return state


def dora_phase(other=None):
    """FairyGen's stylization front end at full width on the card, as the
    CLI twins run its first three stages (tools/create_mask.py,
    examples/dora_train.py, examples/brushnet_stylize.py), from seeded
    weights:
      mask    — the full-width ISNet (ISNetConfig.dis(), fp32) runs
                extract_mask on a seeded 1024x1024 drawing; the mask must be
                neither empty nor full;
      style   — the SDXL UNet, CLIP-L, OpenCLIP bigG and the VAE in fp32
                with a rank-32 DoRA, AdamW at lr 1e-4 and weight decay
                1e-2: the drawing encoded to scaled latents, the mask on
                the latent grid by nearest index, seeded 77-token prompt
                ids through sdxl_encode_prompt, then DORA_STEPS masked DoRA
                steps (the last with snr_gamma 5), each with its wall time,
                peak memory, exact launch counts (K6a, K6b, K6c in fp32 140
                each, every other kernel 0), a finite loss, the base weights
                bit for bit as before (against a copy) and every A, B
                and mag moved; then one step under torch.profiler;
      stylize — the adapter through sdxl_dora_state_dict -> safetensors ->
                load_sdxl_dora_state_dict at 0.66 into the bf16 serving
                pipeline (bf16 UNet, BrushNet and text encoders, fp32 VAE):
                one 1024x1024 request of DORA_STYLIZE_STEPS steps, CFG 7.5,
                with the sdxl phase's launch counts per step.
    With ``other`` (``--dora-ab``: flash_fwd through another build's fp32
    K6a, other_f32_fwd), after the checked steps DORA_AB_PAIRS pairs of
    steps, one through each K6a, in the order other, this, this, other,
    ...: each step's wall, launches and loss; then the profiled step also
    through the other K6a.  Returns the launches."""
    import tempfile

    import numpy as np
    import torch

    from fairygen_tpu_torch import convert
    from fairygen_tpu_torch.core.io import load_state_dict, save_safetensors
    from fairygen_tpu_torch.models.adapters import leaves_with_path
    from fairygen_tpu_torch.models.isnet import ISNetConfig, extract_mask, init_isnet_params
    from fairygen_tpu_torch.models.sdxl.clip import CLIPTextConfig, sdxl_encode_prompt
    from fairygen_tpu_torch.models.sdxl.unet2d import UNet2DConfig
    from fairygen_tpu_torch.models.sdxl.vae import AutoencoderKLConfig, vae_encode
    from fairygen_tpu_torch.ops import _kernels
    from fairygen_tpu_torch.ops import flash_attention as fa
    from fairygen_tpu_torch.pipelines.sdxl_brushnet import SDXLBrushNetPipeline
    from fairygen_tpu_torch.training.dora_trainer import (add_dora_to_sdxl_unet,
                                                          load_sdxl_dora_state_dict,
                                                          make_sdxl_dora_train_step,
                                                          sdxl_dora_state_dict)
    from fairygen_tpu_torch.training.optimizers import make_optimizer

    f32, bf = torch.float32, torch.bfloat16
    gib = 2 ** 30
    total = {k: 0 for k in _kernels.launches}
    this_fwd = fa.flash_fwd

    def count(got):
        for k, v in got.items():
            total[k] += v

    # --- mask
    image = dora_inputs(1024)
    torch.cuda.reset_peak_memory_stats()
    t1 = time.perf_counter()
    icfg = ISNetConfig.dis()
    isnet = init_isnet_params(icfg, "cuda", f32, seed=60)
    torch.cuda.synchronize()
    n_isnet = sum(t.numel() for _, t in leaves_with_path(isnet))
    print(f"  ISNet-DIS {n_isnet:,} fp32 parameters in {time.perf_counter() - t1:.3f} s",
          flush=True)
    _kernels.reset_launches()
    for label in ("first", "warm"):
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        mask = extract_mask(isnet, icfg, image)
        torch.cuda.synchronize()
        fg = float((mask == 255).mean())
        print(f"  mask ({label}): extract_mask 1024x1024 in {time.perf_counter() - t1:.3f} s, "
              f"{tuple(mask.shape)} {mask.dtype}, values {sorted(np.unique(mask).tolist())}, "
              f"foreground share {fg:.4f}, max_memory_allocated "
              f"{torch.cuda.max_memory_allocated() / gib:.2f} GiB", flush=True)
    if mask.shape != (1024, 1024) or not 0 < fg < 1:
        raise RuntimeError("the ISNet mask is empty, full or of the wrong shape")
    if any(_kernels.launches.values()):
        raise RuntimeError(f"the mask stage launched kernels: {_kernels.launches}")
    del isnet

    # --- style
    torch.cuda.reset_peak_memory_stats()
    t1 = time.perf_counter()
    ucfg = UNet2DConfig.sdxl_base()
    te1_cfg, te2_cfg = CLIPTextConfig.sdxl_te1(), CLIPTextConfig.sdxl_te2()
    vcfg = AutoencoderKLConfig.sdxl()
    base = convert.init_unet2d_params(ucfg, "cuda", f32, seed=61)
    te1 = convert.init_clip_text_params(te1_cfg, "cuda", f32, seed=62)
    te2 = convert.init_clip_text_params(te2_cfg, "cuda", f32, seed=63)
    vae = convert.init_autoencoder_kl_params(vcfg, "cuda", f32, seed=64)
    params = add_dora_to_sdxl_unet(base, torch.Generator("cuda").manual_seed(65), rank=32)
    torch.cuda.synchronize()
    print(f"  fp32 weights in {time.perf_counter() - t1:.3f} s: UNet "
          f"{convert.count_params(base):,} CLIP-L {convert.count_params(te1):,} OpenCLIP bigG "
          f"{convert.count_params(te2):,} VAE {convert.count_params(vae):,}; max_memory_allocated "
          f"{torch.cuda.max_memory_allocated() / gib:.2f} GiB", flush=True)
    t1 = time.perf_counter()
    with torch.no_grad():
        pixel = torch.from_numpy(image.astype(np.float32) / 127.5 - 1.0).permute(2, 0, 1)
        latents = vae_encode(vae, vcfg, pixel[None].cuda()) * vcfg.scaling_factor
        h, w = latents.shape[-2:]
        ih, iw = np.arange(h) * 1024 // h, np.arange(w) * 1024 // w
        mask_latents = torch.from_numpy((mask[ih][:, iw] > 127).astype(np.float32))
        ids1, ids2 = sdxl_ids(66, 12)
        pe, pooled = sdxl_encode_prompt(te1, te1_cfg, te2, te2_cfg, ids1.cuda(), ids2.cuda())
    torch.cuda.synchronize()
    print(f"  encode: latents {tuple(latents.shape)}, latent mask foreground "
          f"{float(mask_latents.mean()):.4f}, prompt {tuple(pe.shape)} pooled "
          f"{tuple(pooled.shape)} in {time.perf_counter() - t1:.3f} s", flush=True)
    if not (torch.isfinite(latents).all() and torch.isfinite(pe).all()):
        raise RuntimeError("the DoRA batch holds non-finite values")
    del te1, te2
    torch.cuda.empty_cache()
    batch = {"latents": latents, "mask_latents": mask_latents[None, None].cuda(),
             "prompt_embeds": pe, "pooled": pooled,
             "original_size": torch.tensor([[1024, 1024]], device="cuda"),
             "crop_top_left": torch.tensor([[0, 0]], device="cuda")}
    opt = make_optimizer("adamw", 1e-4, weight_decay=1e-2)
    init_state, step_plain = make_sdxl_dora_train_step(ucfg, opt, resolution=1024,
                                                       device="cuda")
    _, step_snr = make_sdxl_dora_train_step(ucfg, opt, snr_gamma=5.0, resolution=1024,
                                            device="cuda")
    state = init_state(params)
    # a copy of the base weights on the card to hold them bit for bit after
    # each step; its bytes are counted out of each step's peak below
    ref_base = [t.detach().clone() for _, t in leaves_with_path(base)]
    ref_gib = sum(t.numel() * t.element_size() for t in ref_base) / gib
    print(f"  {len(state.trainable)} trainable tensors "
          f"({sum(t.numel() for t in state.trainable):,} values: A, B, mag); a {ref_gib:.2f} GiB "
          f"reference copy of the {len(ref_base)} base tensors", flush=True)
    kinds = {k: sum(p[-1] == k for p in state.paths) for k in ("A", "B", "mag")}
    if kinds != {"A": 560, "B": 560, "mag": 560} or len(state.paths) != 1680:
        raise RuntimeError(f"trainable tensors {kinds}, expected 560 each of A, B, mag")
    per_step = dora_per_step()
    want = {k: per_step.get(k, 0) for k in _kernels.launches}
    gen = torch.Generator("cuda").manual_seed(67)
    walls = []
    for i in range(DORA_STEPS):
        snr = i == DORA_STEPS - 1
        before = [t.detach().clone() for t in state.trainable]
        _kernels.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        state, loss = (step_snr if snr else step_plain)(state, batch, gen)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t1)
        got = dict(_kernels.launches)
        count(got)
        peak = torch.cuda.max_memory_allocated() / gib - ref_gib
        moved = {k: 0 for k in kinds}
        for p, t, b in zip(state.paths, state.trainable, before):
            moved[p[-1]] += int(not torch.equal(t, b))
        same = all(torch.equal(t, r) for (_, t), r in zip(leaves_with_path(base), ref_base))
        print(f"  DoRA step {i + 1}{' (snr_gamma 5)' if snr else ''}: {walls[-1]:.3f} s, loss "
              f"{float(loss):.6f}, max_memory_allocated {peak:.2f} GiB (without the reference "
              f"copy), launches { {k: v for k, v in got.items() if v} }, tensors moved {moved}, "
              f"base weights bit for bit as before: {same}", flush=True)
        if not torch.isfinite(loss) or got != want or not same or moved != kinds:
            raise RuntimeError(f"DoRA step {i + 1} failed its checks")
        del before
    del ref_base
    if other is not None:
        state = dora_ab_steps(state, batch, gen, step_plain, other, want, count)

    # where a step's time goes
    for who in ("other", "this") if other is not None else ("this",):
        fa.flash_fwd = other if who == "other" else this_fwd
        _kernels.reset_launches()
        torch.cuda.synchronize()
        # the device's activity only: ~58,000 kernels, whose host ops' records
        # took the tracer longer to sort than the step (sdxl_train_phase)
        acts = [torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            t1 = time.perf_counter()
            state, loss = step_plain(state, batch, gen)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t1
        fa.flash_fwd = this_fwd
        count(dict(_kernels.launches))
        side = ", the other build's K6a" if who == "other" else ""
        averages = list(prof.key_averages())
        device_table(averages, wall, f"profiled DoRA step (1024x1024, fp32, rank 32{side})", 18,
                     also=("fa_f32",))
        f32_us = sum(e.self_device_time_total for e in averages
                     if e.device_type == torch.autograd.DeviceType.CUDA and "fa_f32" in e.key)
        print(f"  fp32 K6a-c in the profiled step{side}: {f32_us / 1e3:.3f} ms of device time",
              flush=True)

    # --- stylize: the adapter saved and loaded as the CLI twins do
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "pytorch_lora_weights.safetensors")
        t1 = time.perf_counter()
        save_safetensors(path, sdxl_dora_state_dict(state.params))
        sd = load_state_dict(path)
        print(f"  adapter: {len(sd)} tensors through {os.path.getsize(path) / 2**20:.1f} MiB "
              f"of safetensors in {time.perf_counter() - t1:.3f} s", flush=True)
    unet = to(base, "cuda", bf)
    del state, params, base, latents, batch, opt, step_plain, step_snr, init_state, prof
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    unet, n = load_sdxl_dora_state_dict(unet, sd, scale=0.66)
    if n != 560:
        raise RuntimeError(f"{n} DoRA adapters loaded, expected 560")
    bcfg = UNet2DConfig.brushnet_sdxl()
    bn = convert.init_unet2d_params(bcfg, "cuda", bf, seed=68, brushnet=True)
    te1 = convert.init_clip_text_params(te1_cfg, "cuda", bf, seed=62)
    te2 = convert.init_clip_text_params(te2_cfg, "cuda", bf, seed=63)
    pipe = SDXLBrushNetPipeline(unet, ucfg, vae, vcfg, bn, bcfg, te1, te1_cfg, te2, te2_cfg,
                                dtype=bf, device="cuda")
    ppe, pppe = pipe.encode_ids(*sdxl_ids(69, 20))
    npe, nppe = pipe.encode_ids(*sdxl_ids(70, 0))
    keep = (mask[..., None] > 250).astype(np.float32)
    masked = image.astype(np.float32) / 255.0 * (1.0 - keep)
    _kernels.reset_launches()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    img = pipe(prompt_embeds=ppe, pooled_embeds=pppe, negative_prompt_embeds=npe,
               negative_pooled_embeds=nppe, image=masked, mask=keep, height=1024, width=1024,
               num_inference_steps=DORA_STYLIZE_STEPS, guidance_scale=7.5,
               brushnet_conditioning_scale=0.7, seed=333, output_type="np_pm1")
    torch.cuda.synchronize()
    dt = time.perf_counter() - t1
    got = dict(_kernels.launches)
    count(got)
    want = {k: SDXL_PER_STEP.get(k, 0) * DORA_STYLIZE_STEPS for k in _kernels.launches}
    finite = bool(torch.isfinite(img).all())
    print(f"  stylize request with the trained adapter at 0.66 ({DORA_STYLIZE_STEPS} steps, "
          f"CFG 7.5): {dt:.3f} s, output {tuple(img.shape)}, all finite {finite}, std "
          f"{img.std().item():.4f}, max_memory_allocated "
          f"{torch.cuda.max_memory_allocated() / gib:.2f} GiB, launches "
          f"{ {k: v for k, v in got.items() if v} }", flush=True)
    if tuple(img.shape) != (1, 3, 1024, 1024) or not finite or got != want:
        raise RuntimeError(f"the stylize request failed its checks: {got} != {want}")
    del pipe, unet, bn, te1, te2, vae, img
    torch.cuda.empty_cache()
    return total


def reference_dora_check():
    """One masked DoRA step of a tiny head-dim-64 SDXL UNet on the card
    (fp32, so K6a, K6b and K6c in fp32) against the same step on the CPU
    (plain versions), from the same weights, batch, timesteps and noise,
    without and with min-SNR-5: the loss within 1e-4 relative and the A, B
    and mag gradients within 1e-3 relative L2, the CPU tests' bounds
    against the JAX step (both sides fp32; sums in other orders; TF32 is
    off for matmuls and cuDNN since the device phase)."""
    import torch

    from fairygen_tpu_torch import convert
    from fairygen_tpu_torch.models.sdxl.unet2d import UNet2DConfig
    from fairygen_tpu_torch.ops import _kernels
    from fairygen_tpu_torch.training.dora_trainer import (add_dora_to_sdxl_unet,
                                                          make_sdxl_dora_train_step)
    from fairygen_tpu_torch.training.optimizers import make_optimizer

    cfg = UNet2DConfig(block_out_channels=(64, 128), num_attention_heads=(1, 2),
                       down_block_types=("CrossAttnDownBlock2D", "CrossAttnDownBlock2D"),
                       up_block_types=("CrossAttnUpBlock2D", "CrossAttnUpBlock2D"),
                       transformer_layers_per_block=(1, 1), cross_attention_dim=64,
                       addition_time_embed_dim=8, projection_class_embeddings_input_dim=80)
    g = torch.Generator("cpu").manual_seed(110)
    params = add_dora_to_sdxl_unet(convert.init_unet2d_params(cfg, "cpu", torch.float32,
                                                              seed=111), g, rank=8)

    def perturb(tree):
        if isinstance(tree, dict):
            if "lora" in tree:
                tree["lora"]["B"].normal_(generator=g).mul_(0.05)
            for v in tree.values():
                perturb(v)
        elif isinstance(tree, list):
            for v in tree:
                perturb(v)

    perturb(params)
    batch = {"latents": torch.randn(1, 4, 32, 32, generator=g),
             "mask_latents": (torch.rand(1, 1, 32, 32, generator=g) > 0.4).float(),
             "prompt_embeds": torch.randn(1, 77, 64, generator=g),
             "pooled": torch.randn(1, 32, generator=g),
             "original_size": torch.tensor([[256, 256]]),
             "crop_top_left": torch.tensor([[0, 0]])}
    noise = torch.randn(1, 4, 32, 32, generator=g)
    timesteps = torch.tensor([60])  # SNR 15.9: min-SNR-5 weights the loss by 5 / 15.9

    def placed(tree, dev):
        if isinstance(tree, dict):
            return {k: placed(v, dev) for k, v in tree.items()}
        if isinstance(tree, list):
            return [placed(v, dev) for v in tree]
        return tree.detach().to(dev).clone() if torch.is_tensor(tree) else tree

    def run(dev, snr):
        init, step = make_sdxl_dora_train_step(cfg, make_optimizer("adamw", 1e-4, 1e-2),
                                               snr_gamma=snr, resolution=256, device=dev)
        loss, grads = step.loss_and_grads(init(placed(params, dev)),
                                          {k: v.to(dev) for k, v in batch.items()},
                                          timesteps=timesteps.to(dev), noise=noise.to(dev))
        return float(loss), {k: v.cpu() for k, v in grads.items()}

    for snr in (None, 5.0):
        ref_loss, ref = run("cpu", snr)
        _kernels.reset_launches()
        loss, grads = run("cuda", snr)
        ran = {k: v for k, v in _kernels.launches.items() if v}
        e_loss = abs(loss - ref_loss) / abs(ref_loss)
        worst = {}
        for kind in ("A", "B", "mag"):
            keys = [k for k in ref if k[-1] == kind]
            a = torch.cat([grads[k].double().ravel() for k in keys])
            b = torch.cat([ref[k].double().ravel() for k in keys])
            worst[kind] = float((a - b).norm() / b.norm())
        print(f"  tiny DoRA step (d 64, 32x32 latents, snr_gamma {snr}): loss {loss:.6f} card, "
              f"{ref_loss:.6f} CPU, relative error {e_loss:.3e} (bound 1e-4); relative L2 of "
              f"the gradients {worst} (bound 1e-3); kernel launches {ran}", flush=True)
        # 11 transformer blocks x 2 attentions; every K6c call of these few
        # heads and keys splits its query loop (at most 8 items of 128 keys)
        want = dict({k: 22 for k in F32_KERNELS}, flash_fwd_prep_f32=22, flash_bwd_prep_f32=44,
                    flash_bwd_dkv_reduce_f32=22)
        if ran != want:
            raise RuntimeError(f"tiny DoRA step: kernel launches {ran}, expected {want}")
        if not (e_loss <= 1e-4 and max(worst.values()) <= 1e-3):
            raise RuntimeError("tiny DoRA step disagrees with the CPU reference")


# ------------------------------------------------------------------ variants
VARIANT_FRAMES = 17  # the whole smoke's; --variants-only runs the A14B request at 81
VARIANT_STEPS = 4
A14B_BOUNDARY = 0.9  # 4 steps at shift 5 (t = 1000, 937.5, 833.3, 625): 2 steps an expert
V2V_STEPS, V2V_STRENGTH = 2, 0.7
CLIP_STEPS = 1  # CFG 5: two sweeps, each through the CLIP branch
# a 14B DiT sweep's launches: 40 blocks of K1 x 3, K2 for q, k and the text
# cross-attention's q, K3 and K4 once; the CLIP branch adds K2 (its own pass
# over q) and K4 (the 257 image keys) once a block
WAN14B_PER_SWEEP = {"ln_modulate": 120, "rms_rope_heads_major": 120, "flash_bounded": 40,
                    "flash_small_kv": 40}
WAN14B_CLIP_PER_SWEEP = dict(WAN14B_PER_SWEEP, rms_rope_heads_major=160, flash_small_kv=80)


def wan14b_cfg(clip=False):
    """A Wan2.2-I2V-A14B expert (configs/model_registry.json:572, hash
    5b013604280dd715f8457c6ed6d6a626) or, with ``clip``, Wan2.1-I2V-14B
    (:272, 6bfcfb3b342cb286ce886889d519a77e, the CLIP branch)."""
    from fairygen_tpu_torch.models.wan.dit import WanDiTConfig

    return WanDiTConfig(dim=5120, in_dim=36, ffn_dim=13824, out_dim=16, text_dim=4096,
                        freq_dim=256, num_heads=40, num_layers=40, has_image_input=clip,
                        require_clip_embedding=clip)


def seeded_context(seed, n, length=512, dim=4096):
    """A UMT5-shaped prompt embedding on the card: ``n`` seeded rows, zeros
    past them (as mask_pad_tokens leaves an encoded prompt)."""
    import torch

    g = torch.Generator("cuda").manual_seed(seed)
    ctx = 0.2 * torch.randn((1, length, dim), generator=g, device="cuda")
    ctx[:, n:] = 0
    return ctx.to(torch.bfloat16)


def count_expert_sweeps(pipe):
    """Count the pipeline's DiT sweeps per expert (0: ``dit``, 1: ``dit2``)
    through the name its module calls; returns (counts, undo)."""
    from fairygen_tpu_torch.pipelines import wan_video

    counts, real = [0, 0], wan_video.wan_dit_forward

    def counted(params, *a, **k):
        counts[0 if params is pipe.dit_params else 1] += 1
        return real(params, *a, **k)

    wan_video.wan_dit_forward = counted

    def undo():
        wan_video.wan_dit_forward = real

    return counts, undo


def k4_clip_check(S=7800, N=40):
    """K4's bounded form over the 257 CLIP keys of the 14B I2V DiT's image
    branch (padded to a 384-key tile, ``l -= pad``) at 40 heads of 128 and
    one 17-frame request's S = 7800 queries, against its plain version."""
    import torch

    from fairygen_tpu_torch.ops import fused_qk as fq
    from fairygen_tpu_torch.ops.flash_attention import (flash_attention_heads_major,
                                                         flash_attention_heads_major_plain)

    g = torch.Generator("cuda").manual_seed(4257)
    bf, hd, lk, pad = torch.bfloat16, 128, 257, 384
    x = torch.randn((1, S, N * hd), generator=g, device="cuda").to(bf)
    gq = (torch.randn(N * hd, generator=g, device="cuda") * hd ** -0.5 * 1.4427).to(bf)
    s_pad, bq, _ = fq._pad_for_flash(S)
    qh = fq.rms_rope_heads_major(x, gq, fq._rowscale(x, 1e-6), None, N, s_pad, rope=False)
    k = torch.randn((1, lk, N, hd), generator=g, device="cuda")
    k = (k * torch.rsqrt(k.pow(2).mean(-1, keepdim=True) + 1e-6)).to(bf)
    kh = torch.zeros((N, pad, hd), dtype=bf, device="cuda")
    kh[:, :lk] = k[0].permute(1, 0, 2)
    v = torch.randn((1, lk, N, hd), generator=g, device="cuda").to(bf)

    def run():
        return flash_attention_heads_major(qh, kh, v, b=1, n=N, sq=S, sk_actual=lk, bq=bq,
                                           bk=pad)

    err = check_close(f"K4 flash_small_kv over {lk} CLIP keys, {N} x {S} queries", run(),
                      flash_attention_heads_major_plain(qh, kh, v, b=1, n=N, sq=S,
                                                        sk_actual=lk),
                      rtol=2 ** -7, atol=1e-3)
    r = dict(max_abs_err=err, ms=time_ms(run), device_ms=device_ms_twice(run, 20),
             plain_ms=time_ms(lambda: flash_attention_heads_major_plain(
                 qh, kh, v, b=1, n=N, sq=S, sk_actual=lk), 2, 3),
             bound=bound_ms((2 * S + 2 * lk) * hd * N * 2, 4 * S * lk * hd * N),
             library_ms=time_ms(bounded_sdpa(qh, kh, v, N, S, lk)))
    print(f"  K4 over {lk} keys: ms {r['ms']:.4f} device_ms {r['device_ms']:.4f} plain_ms "
          f"{r['plain_ms']:.4f} bound_ms {r['bound'][0]:.4f} ({r['bound'][1]}) library_ms "
          f"{r['library_ms']:.4f}", flush=True)
    return r


def k11_v1_checks(shapes):
    """K11 against its plain version at each channel-last shape a Wan2.1
    VAE request handed it (``record_k11_shapes``), held by
    ``check_bracketed``; at the shape with the most rows of each width (96,
    192, 384), its time, its plain version's and its bound.  Returns
    {width tag: numbers}."""
    import torch
    import torch.nn.functional as F

    from fairygen_tpu_torch.ops import fused_norms as fn

    g = torch.Generator("cuda").manual_seed(921)
    widest = {}
    for shape in shapes:
        c, rows = shape[-1], math.prod(shape[:-1])
        if rows > widest.get(c, (0, None))[0]:
            widest[c] = (rows, shape)
    res, worst = {}, 0.0
    for shape, calls in sorted(shapes.items()):
        c = shape[-1]
        x = torch.randn(shape, generator=g, device="cuda").to(torch.bfloat16)
        gamma = (1 + 0.3 * torch.randn(c, generator=g, device="cuda")).to(torch.bfloat16)
        tag = "x".join(map(str, shape))
        err, ndiff = check_bracketed(f"K11 at the Wan2.1 VAE's {tag} ({calls} calls)",
                                     fn.fused_vae_rms_silu(x, gamma),
                                     fn.vae_rms_silu_plain(x, gamma), *_k11_bracket(x, gamma, True))
        worst = max(worst, err)
        if widest[c][1] == shape:
            b = bound_ms(2 * x.numel() * 2 + c * 2, 10 * x.numel(), H100_FP32_FLOP_PER_S)
            res[f"C={c} {tag}"] = dict(
                calls=calls, differ=ndiff, ms=time_ms(lambda: fn.fused_vae_rms_silu(x, gamma)),
                plain_ms=time_ms(lambda: fn.vae_rms_silu_plain(x, gamma), 5, 3),
                bound_ms=b[0], bound_by=b[1], issue_ms=k11_issue_ms(x.view(-1, c)),
                library_ms=time_ms(lambda: F.rms_norm(x, (c,), gamma, 1e-12)))
        del x, gamma
    torch.cuda.empty_cache()
    for tag, r in res.items():
        print(f"  K11 Wan2.1 VAE {tag}: ms {r['ms']:.4f} plain_ms {r['plain_ms']:.4f} bound_ms "
              f"{r['bound_ms']:.4f} ({r['bound_by']}) issue bound {r['issue_ms']} library_ms "
              f"{r['library_ms']:.4f} (F.rms_norm, eps 1e-12, no SiLU)", flush=True)
    for r in res.values():
        r["max_abs_err"] = worst
    return res


def stream_vs_full(label, streamed, full):
    """Hold a streamed encode or decode against the full-sequence one under
    the flagship's bars (STREAM_VS_FULL_*); frames on axis 2."""
    streamed, full = streamed.float(), full.float()
    err = (streamed - full).abs().max().item()
    rel, rel_frame = rel_l2(streamed, full), rel_l2(streamed, full, dims=(0, 1, 3, 4))
    print(f"  {label}, streamed against full-sequence: max abs error {err:.3e} (tolerance "
          f"{STREAM_VS_FULL_ATOL:.4f}), relative L2 {rel:.3e} (tolerance "
          f"{STREAM_VS_FULL_REL_L2:.4f}), in the worst frame {rel_frame:.3e} (tolerance "
          f"{STREAM_VS_FULL_FRAME_REL_L2:.4f})", flush=True)
    if not (err <= STREAM_VS_FULL_ATOL and rel <= STREAM_VS_FULL_REL_L2
            and rel_frame <= STREAM_VS_FULL_FRAME_REL_L2):
        raise RuntimeError(f"{label}: the streamed form disagrees with the full-sequence one")


def sweep_profile(label, params, cfg, frames, ctx):
    """One profiled DiT sweep of ``params`` at 480x832 x ``frames`` with the
    I2V y channels and the hoisted text (k, v): its device busy ms.  No
    warm call: the request before it ran the same shapes."""
    import torch

    from fairygen_tpu_torch.models.wan.dit import precompute_cross_kv, wan_dit_forward

    g = torch.Generator("cuda").manual_seed(77)
    t = (frames - 1) // 4 + 1
    lat = torch.randn((1, 16, t, 60, 104), generator=g, device="cuda").to(torch.bfloat16)
    y = torch.randn((1, 20, t, 60, 104), generator=g, device="cuda").to(torch.bfloat16)
    with torch.no_grad():
        ckv = precompute_cross_kv(params, cfg, ctx)
    busy, _ = profiled(label, lambda: wan_dit_forward(
        params, cfg, lat, torch.tensor([900.0], device="cuda"), None, y=y, cross_kv=ckv),
        warm=False)
    return busy


def variants_phase(frames=VARIANT_FRAMES):
    """The first slice of the other Wan variants at full width, from seeded
    bf16 weights: K1-K4 at the 14B DiTs' shapes (40 heads, D = 5120, S =
    7800: 17 frames at 480x832 through the Wan2.1 VAE's x8), K1 also at S =
    32760 (81 frames), K4 over the 257 CLIP keys; the Wan2.2-I2V-A14B
    expert pair (2 x 40 blocks) with the Wan2.1 VAE answering one 480x832 x
    ``frames`` request (first and end image, 4 steps, CFG 5, boundary 0.9,
    the streamed decode and encodes) with its sweeps counted per expert
    (4 and 4), exact launches, the denoise and decode walls, the pair's
    peak memory, K11 at each shape the Wan2.1 VAE gave it, one profiled
    sweep of each expert, and (17 frames) the streamed I2V ``y``, input
    video latents and decode of the request's latents against the
    full-sequence forms; a 17-frame video-to-video request on the same
    pair (strength 0.7, 2 steps); then, the pair freed, Wan2.1-I2V-14B with a full-width CLIP ViT-H
    answering one 17-frame 1-step CFG 5 request; and the tiny two-expert
    CLIP reference against the CPU.  Returns (the kernel numbers, the
    phase's launches)."""
    import torch

    from fairygen_tpu_torch import convert
    from fairygen_tpu_torch.diffusion.flow_match import FlowMatchScheduler
    from fairygen_tpu_torch.models.wan.image_encoder import ViTConfig
    from fairygen_tpu_torch.models.wan import vae as wvae
    from fairygen_tpu_torch.models.wan.vae import WanVAEConfig, vae38_decode
    from fairygen_tpu_torch.ops import _kernels
    from fairygen_tpu_torch.pipelines.wan_video import WanVideoPipeline

    bf, gib = torch.bfloat16, 2 ** 30
    start = time.perf_counter()

    def mark(what):
        print(f"  [{time.perf_counter() - start:.1f} s] {what}", flush=True)

    torch.cuda.empty_cache()
    k14 = kernel_checks(7800, (5, 30, 52), "14B S=7800", N=40, D=5120, seg=0)
    k14["ln_modulate S=32760"] = k1_check(32760, 5120, 0, torch.Generator("cuda").manual_seed(5))
    r = k14["ln_modulate S=32760"]
    print(f"  14B S=32760 ln_modulate: ms {r['ms']:.4f} device_ms {r['device_ms']:.4f} plain_ms "
          f"{r['plain_ms']:.4f} bound_ms {r['bound'][0]:.4f} ({r['bound'][1]})", flush=True)
    k14["flash_small_kv clip 257"] = k4_clip_check()
    torch.cuda.empty_cache()
    mark("kernel checks")

    vae_cfg = WanVAEConfig.wan21_16()
    enc_k11, dec_k11 = vae_norm_silu_calls(vae_cfg)
    vae = convert.init_vae_params(vae_cfg, "cuda", bf, seed=31)
    cfg = wan14b_cfg()
    torch.cuda.reset_peak_memory_stats()
    try:
        dit = convert.init_dit_params(cfg, "cuda", bf, seed=32)
        dit2 = convert.init_dit_params(cfg, "cuda", bf, seed=33)
    except torch.cuda.OutOfMemoryError as e:
        raise RuntimeError(f"the two 14B experts do not fit on the card: {e}") from e
    torch.cuda.synchronize()
    print(f"  A14B pair: 2 x {convert.count_params(dit):,} params ({tree_bytes(dit) / gib:.2f} "
          f"GiB each), Wan2.1 VAE {convert.count_params(vae):,}; max_memory_allocated "
          f"{torch.cuda.max_memory_allocated() / gib:.2f} GiB", flush=True)
    mark("the pair seeded")
    pipe = WanVideoPipeline(dit, cfg, vae, vae_cfg, dtype=bf, device="cuda", dit2_params=dit2)
    ctx, nctx = seeded_context(41, 120), seeded_context(42, 1)
    img, end = seeded_image(43, 480, 832), seeded_image(44, 480, 832)
    total = {k: 0 for k in _kernels.launches}

    def request(label, per_sweep, steps, boundary_at, sweeps_want, nframes, k11_shapes=None,
                **kw):
        counts, undo = count_expert_sweeps(pipe)
        if k11_shapes is not None:
            shapes, unrecord = record_k11_shapes(wvae)
        walls, peaks = {}, {}
        wrap_timed(pipe, "_denoise", walls)
        wrap_timed(pipe, "_decode_output", walls)
        decode = pipe._decode_output

        def peak_then_decode(latents, **kw):  # the peak of the encodes and the denoise
            peaks["before_decode"] = torch.cuda.max_memory_allocated() / gib
            return decode(latents, **kw)

        pipe._decode_output = peak_then_decode
        kept = capture_latents(pipe)
        before = dict(_kernels.launches)
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        try:
            video = pipe(context=ctx, negative_context=nctx, input_image=img, seed=45,
                         height=480, width=832, num_frames=nframes, cfg_scale=5.0,
                         num_inference_steps=steps, streaming_vae=True,
                         output_type="floatpoint", **kw)
            torch.cuda.synchronize()
        finally:
            undo()
            if k11_shapes is not None:
                unrecord()
                k11_shapes.update(shapes)
            for name in ("_denoise", "_decode_output"):
                delattr(pipe, name)
        wall = time.perf_counter() - t
        got = {k: _kernels.launches[k] - before[k] for k in before}
        lat_t = (nframes - 1) // 4 + 1
        encodes = 1 + (1 if kw.get("input_video") is not None else 0)
        sweeps = sum(counts)
        want = {k: per_sweep.get(k, 0) * sweeps for k in got}
        want["vae_rms_silu"] = encodes * lat_t * enc_k11 + lat_t * dec_k11
        finite = bool(torch.isfinite(video).all())
        print(f"  {label}: {wall:.3f} s (denoise {walls['_denoise']:.3f} s, decode "
              f"{walls['_decode_output']:.3f} s), boundary step {boundary_at}, sweeps per expert "
              f"{counts}, output {tuple(video.shape)} finite {finite}; max_memory_allocated "
              f"{torch.cuda.max_memory_allocated() / gib:.2f} GiB ({peaks['before_decode']:.2f} "
              f"before the decode); launches "
              f"{ {k: v for k, v in got.items() if v} }", flush=True)
        if tuple(video.shape) != (1, 3, nframes, 480, 832) or not finite:
            raise RuntimeError(f"{label}: wrong shape or non-finite output")
        if counts != sweeps_want:
            raise RuntimeError(f"{label}: sweeps per expert {counts} != {sweeps_want}")
        if got != want:
            raise RuntimeError(f"{label}: launches {got} != expected {want}")
        for k in total:
            total[k] += got[k]
        return kept[-1]

    def sched(steps, strength=1.0):
        s = FlowMatchScheduler("Wan").set_timesteps(steps, denoising_strength=strength,
                                                     shift=5.0)
        b = pipe._boundary_index(s, A14B_BOUNDARY)
        return b, [2 * b, 2 * (steps - b)]

    b, want = sched(VARIANT_STEPS)
    if want != [4, 4]:
        raise RuntimeError(f"boundary {A14B_BOUNDARY} at 4 steps gives sweeps {want}, not [4, 4]")
    k11_shapes = {}
    latents = request(f"A14B request 480x832x{frames}, 4 steps, CFG 5, end image",
                      WAN14B_PER_SWEEP, VARIANT_STEPS, b, want, frames, end_image=end,
                      switch_dit_boundary=A14B_BOUNDARY, k11_shapes=k11_shapes)
    pair_peak = torch.cuda.max_memory_allocated() / gib
    mark("A14B request")
    k14["vae_rms_silu wan21"] = k11_v1_checks(k11_shapes)
    mark("K11 at the Wan2.1 VAE's shapes")
    s = 1560 * ((frames - 1) // 4 + 1)
    busy = [sweep_profile(f"A14B {name} sweep, S = {s}", p, cfg, frames, ctx)
            for name, p in (("dit", dit), ("dit2", dit2))]
    mark("profiled sweeps")
    clip17 = [seeded_image(50 + i, 480, 832) for i in range(VARIANT_FRAMES)]
    if frames == VARIANT_FRAMES:  # the full-sequence forms fit at 17 frames
        stream_vs_full("Wan2.1 VAE, the 17-frame I2V y (first and end image)", *(
            pipe.encode_i2v_conditioning(img, 480, 832, frames, end_image=end, streaming=st)
            for st in (True, False)))
        stream_vs_full("Wan2.1 VAE, the 17-frame input video's latents", *(
            pipe.encode_input_video(clip17, streaming=st) for st in (True, False)))
        with torch.no_grad():
            stream_vs_full("Wan2.1 VAE, the 17-frame decode",
                           vae38_decode(vae, vae_cfg, latents.to(bf), streaming=True),
                           vae38_decode(vae, vae_cfg, latents.to(bf)))
        mark("streamed against full-sequence")
    b, want = sched(V2V_STEPS, V2V_STRENGTH)
    request(f"A14B video-to-video 480x832x17, strength {V2V_STRENGTH}, {V2V_STEPS} steps",
            WAN14B_PER_SWEEP, V2V_STEPS, b, want, VARIANT_FRAMES, input_video=clip17,
            denoising_strength=V2V_STRENGTH, switch_dit_boundary=A14B_BOUNDARY)
    mark("video-to-video")
    del pipe, dit, dit2, latents
    torch.cuda.empty_cache()

    cfg = wan14b_cfg(clip=True)
    vit_cfg = ViTConfig.vit_h_14()
    torch.cuda.reset_peak_memory_stats()
    dit = convert.init_dit_params(cfg, "cuda", bf, seed=34)
    vit = convert.init_vit_params(vit_cfg, "cuda", bf, seed=35)
    pipe = WanVideoPipeline(dit, cfg, vae, vae_cfg, dtype=bf, device="cuda",
                            image_encoder_params=vit, image_encoder_cfg=vit_cfg)
    print(f"  Wan2.1-I2V-14B: {convert.count_params(dit):,} params, ViT-H "
          f"{convert.count_params(vit):,}", flush=True)
    request(f"Wan2.1-I2V-14B with CLIP, 480x832x17, {CLIP_STEPS} step, CFG 5",
            WAN14B_CLIP_PER_SWEEP, CLIP_STEPS, CLIP_STEPS, [2 * CLIP_STEPS, 0], VARIANT_FRAMES)
    mark("CLIP request")
    del pipe, dit, vit, vae
    torch.cuda.empty_cache()
    reference_variants_check()
    mark("tiny reference")
    print(f"  variants: A14B pair peak {pair_peak:.2f} GiB, profiled sweeps busy "
          f"{busy[0]:.1f} / {busy[1]:.1f} ms (dit / dit2) at S = {s}; launches {total}",
          flush=True)
    return k14, total


def reference_variants_check():
    """A tiny two-expert I2V pipeline with the CLIP branch (head dim 128, so
    the serving kernels run; a 1280-wide one-block ViT at 224 pixels for
    the 257 CLIP tokens), the tiny Wan2.1 VAE, first and end image, 2 steps
    (t = 1000, 833.3: one an expert at boundary 0.9), CFG 5, on the card in
    bf16 against the same weights on the CPU in fp32 (plain versions); the
    bound as reference_check's: at most twice the CPU bf16 run's relative
    L2 error plus 1e-3."""
    import torch

    from fairygen_tpu_torch import convert
    from fairygen_tpu_torch.models.wan.dit import WanDiTConfig
    from fairygen_tpu_torch.models.wan.image_encoder import ViTConfig
    from fairygen_tpu_torch.models.wan.vae import WanVAEConfig
    from fairygen_tpu_torch.ops import _kernels
    from fairygen_tpu_torch.pipelines.wan_video import WanVideoPipeline

    cfg = WanDiTConfig(dim=256, in_dim=12, ffn_dim=512, out_dim=4, text_dim=64, freq_dim=64,
                       num_heads=2, num_layers=2, has_image_input=True)
    vae_cfg = WanVAEConfig.tiny_v1()
    vit_cfg = ViTConfig(image_size=224, patch_size=14, dim=1280, num_heads=16, num_layers=2)
    dit = convert.init_dit_params(cfg, "cpu", torch.float32, seed=61)
    dit2 = convert.init_dit_params(cfg, "cpu", torch.float32, seed=62)
    vae = convert.init_vae_params(vae_cfg, "cpu", torch.float32, seed=63)
    vit = convert.init_vit_params(vit_cfg, "cpu", torch.float32, seed=64)
    g = torch.Generator("cpu").manual_seed(65)
    ctx, nctx = torch.randn(1, 40, 64, generator=g), torch.randn(1, 40, 64, generator=g)
    # 256x512x9 -> 3 x 16 x 32 = 1536 tokens: two 1024-key tiles, so K3 runs
    kw = dict(context=ctx, negative_context=nctx, input_image=seeded_image(66, 256, 512),
              end_image=seeded_image(67, 256, 512), seed=68, height=256, width=512,
              num_frames=9, cfg_scale=5.0, num_inference_steps=2, output_type="latents",
              switch_dit_boundary=A14B_BOUNDARY, torch_compat_noise=True)

    def pipe(dev, dt):
        return WanVideoPipeline(to(dit, dev, dt), cfg, to(vae, dev, dt), vae_cfg, dtype=dt,
                                device=dev, dit2_params=to(dit2, dev, dt),
                                image_encoder_params=to(vit, dev, dt), image_encoder_cfg=vit_cfg)

    ref = pipe("cpu", torch.float32)(**kw)
    rel16 = rel_l2(pipe("cpu", torch.bfloat16)(**kw), ref)
    before = dict(_kernels.launches)
    out = pipe("cuda", torch.bfloat16)(**kw).float().cpu()
    ran = {k: _kernels.launches[k] - before[k] for k in before}
    rel, tol = rel_l2(out, ref), 2 * rel16 + 1e-3
    print(f"  tiny two-expert CLIP pipeline latents {tuple(out.shape)}: relative L2 error to "
          f"CPU fp32 {rel:.4e} (card bf16), {rel16:.4e} (CPU bf16); tolerance {tol:.4e}; "
          f"kernel launches { {k: v for k, v in ran.items() if v} }", flush=True)
    if not all(ran[k] for k in WAN14B_PER_SWEEP):
        raise RuntimeError(f"a serving kernel did not run in the tiny two-expert pipeline: {ran}")
    if not rel <= tol:
        raise RuntimeError(f"tiny two-expert pipeline disagrees with the CPU reference: {rel:.4e}")


COND_FRAMES = 17
COND_STEPS = 2
S2V_MOTION_STEPS = 1  # the request with a 73-frame motion video: two sweeps
# per sweep of the 14B T2V DiT with the VACE branch's 8 blocks: each VACE
# block adds K1 three times, K3 once (q / k through the plain rms -> RoPE)
# and K4 once (q's rms into the text cross-attention)
WAN14B_VACE_PER_SWEEP = dict(WAN14B_PER_SWEEP, ln_modulate=144, flash_bounded=48,
                             flash_small_kv=48)
# the S2V blocks: plain LayerNorm + modulation (no K1), K2 on q and k, K3,
# K4 for the text and, after its 12 mapped blocks, the audio injector
S2V_PER_SWEEP = {"rms_rope_heads_major": 80, "flash_bounded": 40, "flash_small_kv": 52}
WAN13B_PER_SWEEP = {"ln_modulate": 90, "rms_rope_heads_major": 90, "flash_bounded": 30,
                    "flash_small_kv": 30}


def conditioning_configs():
    """The conditioning phase's models, as configs/model_registry.json gives
    them (by hash): Wan2.1-VACE-14B, the T2V-14B DiT and its VACE branch
    (7a513e1f257a861512b1afd387a8ecd9, both entries); a
    Wan2.2-Fun-A14B-Control-Camera expert (47dbeab5e560db3180adf51dc0232fb1;
    its adapter's in_dim_control_adapter 24); the Fun-Reference DiT at the
    Wan2.2-Fun-A14B-Control width (2267d489f0ceb9f21836532952852ee5; in_dim
    cut from 52 to the 36 the I2V conditioning fills); Wan2.1-T2V-1.3B
    (a61453409b67cd3246cf0c3bebad47ba) with the motion controller at its
    width; Wan2.2-S2V-14B (966cffdcc52f9c46c391768b27637614) and wav2vec
    XLSR-53 large (06be60f3a4526586d8431cd038a71486)."""
    import dataclasses

    from fairygen_tpu_torch.models.wan.aux_models import MotionControllerConfig, VaceConfig
    from fairygen_tpu_torch.models.wan.camera import SimpleAdapterConfig
    from fairygen_tpu_torch.models.wan.dit import WanDiTConfig
    from fairygen_tpu_torch.models.wan.s2v import S2VConfig
    from fairygen_tpu_torch.models.wan.wav2vec import Wav2Vec2Config

    base = wan14b_cfg()
    return {
        "vace_dit": dataclasses.replace(base, in_dim=16),
        "vace": VaceConfig(vace_layers=tuple(range(0, 40, 5)), vace_in_dim=96, dim=5120,
                           num_heads=40, ffn_dim=13824),
        "camera_dit": base,
        "camera": SimpleAdapterConfig(in_dim=24, out_dim=5120),
        "funref_dit": dataclasses.replace(base, has_ref_conv=True),
        "t2v_1_3b": WanDiTConfig(dim=1536, in_dim=16, ffn_dim=8960, out_dim=16, text_dim=4096,
                                 freq_dim=256, num_heads=12, num_layers=30,
                                 require_clip_embedding=False),
        "motion": MotionControllerConfig(freq_dim=256, dim=1536),
        "s2v": S2VConfig(),
        "wav2vec": Wav2Vec2Config(),
    }


def s2v_angles(motion):
    """The S2V DiT's RoPE angles at 480x832 x 17 frames: 4 latent frames of
    30 x 52 tokens, the reference frame at t = 30 and, with a motion video,
    the frame packer's three grids over the 60 x 104 latent."""
    from fairygen_tpu_torch.models.wan import s2v

    grids = [((0, 0, 0), (4, 30, 52), (4, 30, 52)), ((30, 0, 0), (31, 30, 52), (1, 30, 52))]
    if motion:
        grids += s2v.frame_packer_grids(s2v.S2VConfig(), 60, 104)
    return s2v.rope_grid_angles(grids, 128)


def conditioning_kernel_checks(N=40, D=5120, hd=128):
    """The conditioning slice's new kernel shapes against their plain
    versions: K2 on the S2V tables (S = 7800, and 10114 with the frame
    packer's tokens), K3 at S = 9360 (the Fun-Reference frame, or VACE's
    reference frame, before 5 latent frames) and K4's bounded form as the
    audio injector calls it (batch 4 latent frames x 40 heads, 1560
    queries, 5 keys padded to a 128-key tile).  Each: error, event and
    device ms, the plain version's ms, the bound, and SDPA where one call
    computes the function."""
    import torch

    from fairygen_tpu_torch.models.wan.s2v import angles_to_freqs
    from fairygen_tpu_torch.ops import flash_attention as fa
    from fairygen_tpu_torch.ops import fused_qk as fq
    from fairygen_tpu_torch.ops.rope import build_freqs_grid, precompute_freqs_3d

    g = torch.Generator("cuda").manual_seed(2601)
    bf = torch.bfloat16

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=g, device="cuda") * scale).to(bf)

    def normed(*shape, scale=1.0):
        x = torch.randn(shape, generator=g, device="cuda")
        return (x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + 1e-6) * scale).to(bf)

    res = {}
    for tag, motion in (("S2V S=7800", False), ("S2V S=10114 with the frame packer", True)):
        ff = fq.build_freqs_full(angles_to_freqs(s2v_angles(motion), "cuda"))
        S = ff.shape[1]
        s_pad = fq._pad_for_flash(S)[0]
        x, gq = randn(1, S, D), randn(D, scale=hd ** -0.5 * 1.4427)
        rs = fq._rowscale(x, 1e-6)

        def run():
            return fq.rms_rope_heads_major(x, gq, rs, ff, N, s_pad)

        err = check_close(f"K2 rms_rope on the {tag} tables", run(),
                          fq.rms_rope_heads_major_plain(x, gq, rs, ff, N, s_pad),
                          rtol=2 ** -7, atol=1e-5)
        nbytes = S * D * 2 + S * 4 + D * 2 + 2 * S * hd * 4 + N * s_pad * hd * 2
        res[f"rms_rope_heads_major {tag}"] = dict(
            max_abs_err=err, ms=time_ms(run), device_ms=device_ms_twice(run, 20),
            plain_ms=time_ms(lambda: fq.rms_rope_heads_major_plain(x, gq, rs, ff, N, s_pad), 2, 3),
            bound=bound_ms(nbytes, 6 * S * D), library_ms=None)
        del x, ff

    S = 9360
    s_pad, bq, bk = fq._pad_for_flash(S)
    ff = fq.build_freqs_full(build_freqs_grid(precompute_freqs_3d(hd), 6, 30, 52, device="cuda"))
    xq, xk = randn(1, S, D), randn(1, S, D)
    gq, gk = randn(D, scale=hd ** -0.5 * 1.4427), randn(D)
    qh = fq.rms_rope_heads_major(xq, gq, fq._rowscale(xq, 1e-6), ff, N, s_pad)
    kh = fq.rms_rope_heads_major(xk, gk, fq._rowscale(xk, 1e-6), ff, N, s_pad)
    v = randn(1, S, N, hd)

    def run():
        return fa.flash_attention_heads_major(qh, kh, v, b=1, n=N, sq=S, sk_actual=S, bq=bq,
                                              bk=bk)

    def plain():
        return fa.flash_attention_heads_major_plain(qh, kh, v, b=1, n=N, sq=S, sk_actual=S)

    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    ref = plain()  # one call, timed: each takes about a second (40 heads of 9360^2 logits)
    b.record()
    b.synchronize()
    err = check_close(f"K3 flash_bounded S={S}", run(), ref, rtol=2 ** -7, atol=1e-3)
    res[f"flash_bounded S={S}"] = dict(
        max_abs_err=err, ms=time_ms(run), device_ms=device_ms_twice(run, 10),
        plain_ms=a.elapsed_time(b), bound=bound_ms(4 * S * hd * N * 2, 4 * S * S * hd * N),
        library_ms=time_ms(bounded_sdpa(qh, kh, v, N, S, S)))
    del ref
    del xq, xk, qh, kh, v, ff

    B, sq, lk = 4, 1560, 5
    q = normed(B, sq, N, hd, scale=hd ** -0.5 * 1.4427)
    k, v = normed(B, lk, N, hd), randn(B, lk, N, hd)
    qh, kh = fa._layout(q, k, None, True, 2048)  # as the audio injector's call lays them out

    def run():
        return fa.flash_attention_heads_major(qh, kh, v, b=B, n=N, sq=sq, sk_actual=lk,
                                              bq=qh.shape[1], bk=kh.shape[1])

    def plain():
        return fa.flash_attention_heads_major_plain(qh, kh, v, b=B, n=N, sq=sq, sk_actual=lk)

    # over 5 keys each p is a large share of its row's sum, so a logit summed
    # in another order that flips one p's bf16 rounding moves o by up to
    # 2^-8 (p / l) |v| <= 2^-8 max |v| (with many keys the share is small and
    # 1e-3 holds); a relative L2 of 2^-10 as K4's other forms
    out, ref = run(), plain()
    tag = f"audio injector {B} x {N} x {sq} queries, {lk} keys in {kh.shape[1]}"
    err = check_close(f"K4 flash_small_kv, {tag}", out, ref, rtol=2 ** -7,
                      atol=2 ** -8 * v.abs().max().item())
    rel = rel_l2(out, ref)
    print(f"  K4 flash_small_kv, {tag}: relative L2 error {rel:.3e} (bound 2^-10)", flush=True)
    if not rel < 2 ** -10 or not torch.equal(out, run()):
        raise RuntimeError(f"K4 at the injector's shape: relative L2 {rel:.3e}, or two runs differ")
    res["flash_small_kv injector"] = dict(
        max_abs_err=err, rel_l2=rel, ms=time_ms(run), device_ms=device_ms_twice(run, 20),
        plain_ms=time_ms(plain, 2, 3),
        bound=bound_ms((2 * B * sq + 2 * B * lk) * N * hd * 2, 4 * B * sq * lk * hd * N),
        library_ms=time_ms(bounded_sdpa(qh, kh, v, N, sq, lk)))
    for tag, r in res.items():
        lib = "null" if r["library_ms"] is None else f"{r['library_ms']:.4f}"
        print(f"  {tag}: ms {r['ms']:.4f} device_ms {r['device_ms']:.4f} plain_ms "
              f"{r['plain_ms']:.4f} bound_ms {r['bound'][0]:.4f} ({r['bound'][1]}) library_ms "
              f"{lib}", flush=True)
    torch.cuda.empty_cache()
    return res


def conditioning_phase():
    """The Wan variants' second slice at full width from seeded bf16 weights,
    each 480x832 x 17 frames through the Wan2.1 VAE (streamed), CFG 5:
    Wan2.1-VACE-14B (the T2V-14B DiT and its 8-block VACE branch, a control
    video, a mask and one reference image: S = 9360), a
    Wan2.2-Fun-A14B-Control-Camera expert ("Left", an input image), a 14B
    DiT with the Fun-Reference conv (the I2V conditioning's in_dim 36, an
    input image and a reference image: S = 9360), Wan2.1-T2V-1.3B with the
    motion controller, and Wan2.2-S2V-14B with the wav2vec XLSR-53 large
    encoder from a seeded 16 kHz waveform and an input image, then again
    with a 73-frame motion video (the frame packer: S = 10114).  The 14B
    DiTs share one set of 40 seeded blocks (the same shapes; each its own
    embeddings, head and extras).  Each request: wall, decode wall, peak
    memory, output shape, finite, exact launches; then K11 at every shape
    the VAE gave it, and profiled sweeps of the VACE, camera and S2V DiTs
    and of the wav2vec encode (the new kernel shapes are held in the kernels
    phase, ``conditioning_kernel_checks``, early in the process where the
    card's profiler keeps its records).  Returns (K11's numbers at the Wan2.1
    VAE's shapes, the phase's launches, and the models the next phase
    shares: the 40 blocks, the Wan2.1 VAE and the shapes K11 was held
    at)."""
    import dataclasses

    import numpy as np
    import torch

    from fairygen_tpu_torch import convert
    from fairygen_tpu_torch.models.wan import vae as wvae
    from fairygen_tpu_torch.models.wan.dit import precompute_cross_kv, wan_dit_forward
    from fairygen_tpu_torch.models.wan.s2v import wan_s2v_forward
    from fairygen_tpu_torch.models.wan.vae import WanVAEConfig
    from fairygen_tpu_torch.models.wan.wav2vec import audio_embeds_from_waveform
    from fairygen_tpu_torch.ops import _kernels
    from fairygen_tpu_torch.pipelines.wan_video import WanVideoPipeline

    bf, gib = torch.bfloat16, 2 ** 30
    start = time.perf_counter()

    def mark(what):
        print(f"  [{time.perf_counter() - start:.1f} s] {what}", flush=True)

    torch.cuda.empty_cache()
    vae_cfg = WanVAEConfig.wan21_16()
    enc_k11, dec_k11 = vae_norm_silu_calls(vae_cfg)
    vae = convert.init_vae_params(vae_cfg, "cuda", bf, seed=71)
    cfgs = conditioning_configs()
    torch.cuda.reset_peak_memory_stats()
    blocks = convert.init_dit_params(cfgs["vace_dit"], "cuda", bf, seed=72)["blocks"]
    torch.cuda.synchronize()
    print(f"  40 shared 14B blocks: {convert.count_params(blocks):,} params "
          f"({tree_bytes(blocks) / gib:.2f} GiB)", flush=True)
    mark("shared blocks seeded")

    def dit14(seed, name):
        cfg = cfgs[name]
        params = convert.init_dit_params(dataclasses.replace(cfg, num_layers=0), "cuda", bf,
                                         seed=seed)
        params["blocks"] = blocks
        return params, cfg

    ctx, nctx = seeded_context(81, 120), seeded_context(82, 1)
    img = seeded_image(83, 480, 832)
    t900 = torch.tensor([900.0], device="cuda")
    total = {k: 0 for k in _kernels.launches}
    k11_shapes, walls_all, busy = {}, {}, {}

    def request(label, pipe, per_sweep, sweeps, enc, dec, frames_out, **kw):
        shapes, unrecord = record_k11_shapes(wvae)
        walls = {}
        wrap_timed(pipe, "_decode_output", walls)
        before = dict(_kernels.launches)
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        try:
            video = pipe(context=ctx, negative_context=nctx, seed=84, height=480, width=832,
                         num_frames=COND_FRAMES, cfg_scale=5.0, streaming_vae=True,
                         output_type="floatpoint", **kw)
            torch.cuda.synchronize()
        finally:
            unrecord()
            delattr(pipe, "_decode_output")
        wall = time.perf_counter() - t
        for shape, n in shapes.items():
            k11_shapes[shape] = k11_shapes.get(shape, 0) + n
        got = {k: _kernels.launches[k] - before[k] for k in before}
        want = {k: per_sweep.get(k, 0) * sweeps for k in got}
        want["vae_rms_silu"] = enc * enc_k11 + dec * dec_k11
        finite = bool(torch.isfinite(video).all())
        walls_all[label] = wall
        print(f"  {label}: {wall:.3f} s (decode {walls['_decode_output']:.3f} s), {sweeps} "
              f"sweeps, output {tuple(video.shape)} finite {finite}; max_memory_allocated "
              f"{torch.cuda.max_memory_allocated() / gib:.2f} GiB; launches "
              f"{ {k: v for k, v in got.items() if v} }", flush=True)
        if tuple(video.shape) != (1, 3, frames_out, 480, 832) or not finite:
            raise RuntimeError(f"{label}: wrong shape or non-finite output")
        if got != want:
            raise RuntimeError(f"{label}: launches {got} != expected {want}")
        for k in total:
            total[k] += got[k]

    def randn(*shape, seed):
        gen = torch.Generator("cuda").manual_seed(seed)
        return torch.randn(shape, generator=gen, device="cuda").to(bf)

    # VACE: the T2V-14B DiT (in_dim 16) and its branch at layers 0, 5, ..., 35
    params, cfg = dit14(73, "vace_dit")
    vcfg = cfgs["vace"]
    vace = convert.init_vace_params(vcfg, "cuda", bf, seed=74)
    pipe = WanVideoPipeline(params, cfg, vae, vae_cfg, dtype=bf, device="cuda",
                            vace_params=vace, vace_cfg=vcfg)
    half = np.zeros((480, 832, 3), np.uint8)
    half[:, 416:] = 255
    request("Wan2.1-VACE-14B, control video + mask + 1 reference image", pipe,
            WAN14B_VACE_PER_SWEEP, 2 * COND_STEPS, 5 + 5 + 1, 5, COND_FRAMES,
            num_inference_steps=COND_STEPS,
            vace_video=[seeded_image(90 + i, 480, 832) for i in range(COND_FRAMES)],
            vace_video_mask=[half] * COND_FRAMES, vace_reference_image=seeded_image(89, 480, 832))
    with torch.no_grad():
        ckv = precompute_cross_kv(params, cfg, ctx)
    lat, vctx = randn(1, 16, 6, 60, 104, seed=85), randn(1, 96, 6, 60, 104, seed=86)
    busy["vace"], _ = profiled("VACE sweep (40 + 8 blocks), S = 9360", lambda: wan_dit_forward(
        params, cfg, lat, t900, ctx, cross_kv=ckv, vace_params=vace, vace_cfg=vcfg,
        vace_context=vctx), warm=False)
    del pipe, vace, params, ckv, lat, vctx
    torch.cuda.empty_cache()
    mark("VACE")

    # camera control: a Fun-A14B-Control-Camera expert (in_dim 36) and its adapter
    params, cfg = dit14(75, "camera_dit")
    ccfg = cfgs["camera"]
    cam = convert.init_simple_adapter_params(ccfg, "cuda", bf, seed=76)
    pipe = WanVideoPipeline(params, cfg, vae, vae_cfg, dtype=bf, device="cuda",
                            camera_params=cam, camera_cfg=ccfg)
    request("Wan2.2-Fun-A14B-Control-Camera, Left", pipe, WAN14B_PER_SWEEP, 2 * COND_STEPS,
            5, 5, COND_FRAMES, num_inference_steps=COND_STEPS, camera_control_direction="Left",
            input_image=img)
    with torch.no_grad():
        ckv = precompute_cross_kv(params, cfg, ctx)
    lat, y = randn(1, 16, 5, 60, 104, seed=87), randn(1, 20, 5, 60, 104, seed=88)
    tokens = randn(1, 7800, 5120, seed=89)
    busy["camera"], _ = profiled("camera sweep, S = 7800", lambda: wan_dit_forward(
        params, cfg, lat, t900, None, y=y, cross_kv=ckv, control_camera_tokens=tokens),
        warm=False)
    del pipe, cam, params, ckv, lat, y, tokens
    torch.cuda.empty_cache()
    mark("camera")

    # Fun-Reference: the Control model's width with ref_conv, in_dim 36 (16
    # noise + 20 I2V mask and y channels; the published 52 adds control
    # video channels the pipeline never fills)
    params, cfg = dit14(77, "funref_dit")
    pipe = WanVideoPipeline(params, cfg, vae, vae_cfg, dtype=bf, device="cuda")
    request("Fun-Reference 14B (in_dim 36), input image + reference image", pipe,
            WAN14B_PER_SWEEP, 2 * COND_STEPS, 5 + 1, 5, COND_FRAMES,
            num_inference_steps=COND_STEPS, input_image=img,
            reference_image=seeded_image(78, 480, 832))
    del pipe, params
    torch.cuda.empty_cache()
    mark("Fun-Reference")

    # the motion controller on Wan2.1-T2V-1.3B
    cfg13, mcfg = cfgs["t2v_1_3b"], cfgs["motion"]
    pipe = WanVideoPipeline(convert.init_dit_params(cfg13, "cuda", bf, seed=79), cfg13, vae,
                            vae_cfg, dtype=bf, device="cuda",
                            motion_controller_params=convert.init_motion_controller_params(
                                mcfg, "cuda", bf, seed=80), motion_controller_cfg=mcfg)
    request("Wan2.1-T2V-1.3B, motion_bucket_id 20", pipe, WAN13B_PER_SWEEP, 2 * COND_STEPS, 0,
            5, COND_FRAMES, num_inference_steps=COND_STEPS, motion_bucket_id=20)
    del pipe
    torch.cuda.empty_cache()
    mark("motion controller")

    # S2V-14B with wav2vec XLSR-53 large
    s2v_cfg, w2v_cfg = cfgs["s2v"], cfgs["wav2vec"]
    s2v = convert.init_s2v_params(s2v_cfg, "cuda", bf, seed=81, blocks=blocks)
    w2v = convert.init_wav2vec2_params(w2v_cfg, "cuda", seed=82)
    print(f"  S2V extras {convert.count_params(s2v) - convert.count_params(blocks):,} params, "
          f"wav2vec {convert.count_params(w2v):,} (fp32)", flush=True)
    pipe = WanVideoPipeline(None, None, vae, vae_cfg, dtype=bf, device="cuda", s2v_params=s2v,
                            s2v_cfg=s2v_cfg, wav2vec_params=w2v, wav2vec_cfg=w2v_cfg)
    rng = np.random.default_rng(83)
    wave = (0.3 * np.sin(np.linspace(0, 2 * np.pi * 220, 16000))
            + 0.05 * rng.standard_normal(16000)).astype(np.float32)
    request("Wan2.2-S2V-14B from a 16 kHz waveform, input image", pipe, S2V_PER_SWEEP,
            2 * COND_STEPS, 1, 5, COND_FRAMES, num_inference_steps=COND_STEPS,
            input_audio=wave, input_image=img)
    mark("S2V")
    request(f"Wan2.2-S2V-14B with a 73-frame motion video, {S2V_MOTION_STEPS} step", pipe,
            S2V_PER_SWEEP, 2 * S2V_MOTION_STEPS, 19 + 1, 19 + 4, 89,
            num_inference_steps=S2V_MOTION_STEPS, input_audio=wave, input_image=img,
            motion_video=[seeded_image(200 + i, 480, 832) for i in range(73)])
    mark("S2V with a motion video")
    audio = torch.from_numpy(audio_embeds_from_waveform(w2v, w2v_cfg, wave, num_frames=17)[0])
    audio = audio.to("cuda", bf)
    lat = randn(1, 16, 5, 60, 104, seed=90)
    busy["s2v"], _ = profiled("S2V sweep, S = 7800", lambda: wan_s2v_forward(
        s2v, s2v_cfg, lat, t900, ctx, audio), warm=False)
    busy["wav2vec"], _ = profiled("wav2vec XLSR-53 encode of 1 s (16000 samples)",
                                  lambda: audio_embeds_from_waveform(w2v, w2v_cfg, wave,
                                                                     num_frames=17))
    del pipe, s2v, w2v, lat, audio
    torch.cuda.empty_cache()
    mark("profiles")
    k11 = k11_v1_checks(k11_shapes)
    mark("K11 at the Wan2.1 VAE's shapes")
    print(f"  conditioning: walls {json.dumps(walls_all)}; profiled busy ms "
          f"{json.dumps(busy)}; launches {total}", flush=True)
    return k11, total, dict(blocks=blocks, vae=vae, vae_cfg=vae_cfg, k11_shapes=set(k11_shapes))


def reference_conditioning_check():
    """Tiny VACE, camera, Fun-Reference, motion-controller and S2V (from a
    waveform through a tiny wav2vec) pipelines, head dim 128 so the
    serving kernels run, each a 128x256x9, 2-step, CFG 5 request with the
    tiny Wan2.1 VAE, on the card in bf16 against the same weights on the
    CPU in fp32 (plain versions); the bound as reference_check's: at most
    twice the CPU bf16 run's relative L2 error plus 1e-3.  At 384 tokens
    (512 with a reference frame) the self-attention is K4's bounded form;
    the conditioning phase and the card tests hold K3 at these paths'
    lengths."""
    import numpy as np
    import torch

    from fairygen_tpu_torch import convert
    from fairygen_tpu_torch.models.wan.aux_models import MotionControllerConfig, VaceConfig
    from fairygen_tpu_torch.models.wan.camera import SimpleAdapterConfig
    from fairygen_tpu_torch.models.wan.dit import WanDiTConfig
    from fairygen_tpu_torch.models.wan.s2v import S2VConfig
    from fairygen_tpu_torch.models.wan.vae import WanVAEConfig
    from fairygen_tpu_torch.models.wan.wav2vec import Wav2Vec2Config
    from fairygen_tpu_torch.ops import _kernels
    from fairygen_tpu_torch.pipelines.wan_video import WanVideoPipeline

    f32 = torch.float32
    tiny = dict(dim=256, in_dim=4, ffn_dim=512, out_dim=4, text_dim=64, freq_dim=64,
                num_heads=2, num_layers=2, require_clip_embedding=False)
    vae_cfg = WanVAEConfig.tiny_v1()
    vae = convert.init_vae_params(vae_cfg, "cpu", f32, seed=91)
    g = torch.Generator("cpu").manual_seed(92)
    ctx, nctx = torch.randn(1, 40, 64, generator=g), torch.randn(1, 40, 64, generator=g)
    img, ref_img = seeded_image(93, 128, 256), seeded_image(94, 128, 256)
    kw = dict(context=ctx, negative_context=nctx, seed=95, height=128, width=256, num_frames=9,
              cfg_scale=5.0, num_inference_steps=2, output_type="latents",
              torch_compat_noise=True)
    cases = []
    vcfg = VaceConfig(vace_layers=(0, 1), vace_in_dim=72, dim=256, num_heads=2, ffn_dim=512)
    cases.append(("VACE", WanDiTConfig(**tiny), {}, dict(
        vace_params=convert.init_vace_params(vcfg, "cpu", f32, seed=96), vace_cfg=vcfg), dict(
        vace_video=[seeded_image(100 + i, 128, 256) for i in range(9)],
        vace_reference_image=ref_img, vace_scale=0.8)))
    ccfg = SimpleAdapterConfig(in_dim=24, out_dim=256)
    cases.append(("camera", WanDiTConfig(**dict(tiny, in_dim=8)), {}, dict(
        camera_params=convert.init_simple_adapter_params(ccfg, "cpu", f32, seed=97),
        camera_cfg=ccfg), dict(camera_control_direction="LeftUp", input_image=img)))
    ref_conv = {"w": torch.randn(16, 256, generator=g) / 4, "b": torch.zeros(256)}
    cases.append(("Fun-Reference", WanDiTConfig(**dict(tiny, has_ref_conv=True)),
                  {"ref_conv": ref_conv}, {}, dict(reference_image=ref_img)))
    mcfg = MotionControllerConfig(freq_dim=64, dim=256)
    cases.append(("motion controller", WanDiTConfig(**tiny), {}, dict(
        motion_controller_params=convert.init_motion_controller_params(mcfg, "cpu", f32, 98),
        motion_controller_cfg=mcfg), dict(motion_bucket_id=7)))
    s2v_cfg = S2VConfig(dim=256, in_dim=4, ffn_dim=512, out_dim=4, text_dim=64, freq_dim=64,
                        num_heads=2, num_layers=2, cond_dim=4, audio_dim=32,
                        audio_inject_layers=(0, 1), motion_channels=4)
    w2v_cfg = Wav2Vec2Config(conv_dim=(32, 32, 32), conv_kernel=(10, 8, 8),
                             conv_stride=(5, 8, 8), hidden_size=32, num_attention_heads=2,
                             intermediate_size=64, num_conv_pos_embeddings=16,
                             num_conv_pos_embedding_groups=2)
    wave = np.sin(np.linspace(0, 2 * np.pi * 300, 16000)).astype(np.float32)
    cases.append(("S2V", None, None, dict(
        s2v_params=convert.init_s2v_params(s2v_cfg, "cpu", f32, seed=99), s2v_cfg=s2v_cfg,
        wav2vec_params=convert.init_wav2vec2_params(w2v_cfg, "cpu", seed=100),
        wav2vec_cfg=w2v_cfg), dict(input_audio=wave, input_image=img)))
    for label, cfg, extra, models, req in cases:
        dit = None
        if cfg is not None:
            dit = dict(convert.init_dit_params(cfg, "cpu", f32, seed=101), **extra)

        def pipe(dev, dt):
            m = {k: v if k.endswith("_cfg") or k.startswith("wav2vec") else to(v, dev, dt)
                 for k, v in models.items()}
            if "wav2vec_params" in m:
                m["wav2vec_params"] = to(models["wav2vec_params"], dev, f32)
            return WanVideoPipeline(None if dit is None else to(dit, dev, dt), cfg,
                                    to(vae, dev, dt), vae_cfg, dtype=dt, device=dev, **m)

        ref = pipe("cpu", f32)(**kw, **req)
        rel16 = rel_l2(pipe("cpu", torch.bfloat16)(**kw, **req), ref)
        before = dict(_kernels.launches)
        out = pipe("cuda", torch.bfloat16)(**kw, **req).float().cpu()
        ran = {k: _kernels.launches[k] - before[k] for k in before}
        rel, tol = rel_l2(out, ref), 2 * rel16 + 1e-3
        print(f"  tiny {label} pipeline latents {tuple(out.shape)}: relative L2 error to CPU "
              f"fp32 {rel:.4e} (card bf16), {rel16:.4e} (CPU bf16); tolerance {tol:.4e}; "
              f"kernel launches { {k: v for k, v in ran.items() if v} }", flush=True)
        want = ("rms_rope_heads_major", "flash_small_kv") + (() if cfg is None else
                                                             ("ln_modulate",))
        if not all(ran[k] for k in want):
            raise RuntimeError(f"a kernel did not run in the tiny {label} pipeline: {ran}")
        if not rel <= tol:
            raise RuntimeError(f"tiny {label} pipeline disagrees with the CPU reference: "
                               f"{rel:.4e}")


# --------------------------------------------------- animate_vap_longcat
AVL_STEPS = 1  # CFG 5: two sweeps a request (cut from the default 50)
AVL_CONT_STEPS = 2  # the LongCat continuation: its latents pinned after each of two steps
# an Animate-14B sweep: the 14B blocks with the CLIP branch (the text (k, v)
# projected in every block, as the JAX package does while Animate is on);
# the pose embedding, the face encoder and the face blocks launch no kernel
ANIMATE_PER_SWEEP = WAN14B_CLIP_PER_SWEEP
# a VAP sweep: 30 blocks of K1 x 3, the plain rms -> RoPE chain into K3 and
# q's rms into K4 over the text and CLIP keys; the 10 MoT layers K5 over the
# joint tokens and K4 over each side's text and CLIP keys
VAP_PER_SWEEP = {"ln_modulate": 90, "flash_bounded": 30, "flash_small_kv": 100, "flash_fwd": 10}
# a LongCat sweep: 48 blocks of K3 (two in cond mode: the conditioning
# frames among themselves, the noise frames over all) and K4's max form
# over the 512 text keys
LONGCAT_PER_SWEEP = {"flash_bounded": 48, "flash_small_kv_max": 48}
LONGCAT_COND_PER_SWEEP = dict(LONGCAT_PER_SWEEP, flash_bounded=96)


def avl_configs():
    """The phase's models, as configs/model_registry.json gives them (by
    hash): Wan2.2-Animate-14B, its DiT and its adapter
    (31fa352acb8a1b1d33cd8764273d80a2, both entries); Wan2.1-I2V-14B and the
    VAP / MoT branch (5f90e66a0672219f12d9a626c8c21f61, both entries, the
    branch at MotConfig's defaults); LongCat-Video
    (8b27900f680d7251ce44e2dc8ae1ffef, LongCatDiTConfig.longcat())."""
    from fairygen_tpu_torch.models.wan.animate import AnimateConfig
    from fairygen_tpu_torch.models.wan.longcat import LongCatDiTConfig
    from fairygen_tpu_torch.models.wan.mot import MotConfig

    return {"animate_dit": wan14b_cfg(clip=True), "animate": AnimateConfig(),
            "vap_dit": wan14b_cfg(clip=True), "vap": MotConfig(),
            "longcat": LongCatDiTConfig.longcat()}


def avl_kernel_checks(hd=128):
    """The phase's new kernel shapes against their plain versions, on
    rms-normed q / k laid out as ``flash_attention`` lays them out (its
    padding and prescale): K5 at head dim 128 over MoT's 40 x 15600 joint
    tokens (keys padded to 16384, masked past 15600; 2^-7 relative + 2^-8
    absolute and a relative L2 of o below 2^-8, as K6a at the training
    shapes), K4's max form as LongCat's cross-attention calls it (32 heads
    of 7800 queries, 4680 in cond mode, over 512 text keys; 2^-7 + 1e-3, a
    relative L2 below 2^-10) and K3 at LongCat's self-attention shapes (32 x
    7800^2, the conditioning frames' 32 x 3120^2 and the noise frames' 32 x
    4680 queries over all 7800 keys, Sq != Sk; 2^-7 + 1e-3).  Each: error,
    event and device ms, the plain version's ms (one call, events), the
    bound, and the library call that computes the function (K5: the faster
    of cuDNN's forward and SDPA's flash; K3, K4: SDPA)."""
    import torch
    import torch.nn.functional as F

    from fairygen_tpu_torch.ops import flash_attention as fa

    g = torch.Generator("cuda").manual_seed(2701)
    bf, ln2 = torch.bfloat16, 0.6931471805599453

    def normed(*shape):
        x = torch.randn(shape, generator=g, device="cuda")
        return (x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + 1e-6)).to(bf)

    def randn(*shape):
        return torch.randn(shape, generator=g, device="cuda").to(bf)

    def one_call(fn):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        out = fn()
        b.record()
        b.synchronize()
        return out, a.elapsed_time(b)

    def heads(xh, n, s):  # (B*N, S_pad, d) -> (1, N, s, d), contiguous
        return xh.view(1, n, -1, hd)[:, :, :s].contiguous()

    res = {}
    N, S = 40, 15600
    qh, kh = fa._layout(normed(1, S, N, hd), normed(1, S, N, hd), None, False)
    vh = fa._heads_major(randn(1, S, N, hd), kh.shape[1])

    def run():
        return fa.flash_fwd(qh, kh, vh, sk_actual=S, with_lse=False)

    ref, plain_ms = one_call(lambda: fa.flash_fwd_plain(qh, kh, vh, sk_actual=S, with_lse=False))
    tag = f"MoT joint {N}x{S}^2 (keys in {kh.shape[1]})"
    out = run()
    err = check_close(f"K5 flash_fwd d {hd}, {tag}", out, ref, rtol=2 ** -7, atol=2 ** -8)
    rel = rel_l2(out, ref)
    print(f"  K5 {tag}: relative L2 error of o {rel:.3e} (bound 2^-8)", flush=True)
    if not rel < 2 ** -8:
        raise RuntimeError(f"K5 at the MoT shape: relative L2 error {rel:.3e}")
    del ref, out
    qs, ks, vs = heads(qh, N, S), heads(kh, N, S), heads(vh, N, S)
    sdpa = torch.ops.aten._scaled_dot_product_flash_attention
    lib_flash = time_ms(lambda: sdpa(qs, ks, vs, 0.0, False, False, scale=ln2), 5, 3)
    lib_cudnn = cudnn_fwd_ms(qs, ks, vs, ln2, tag)
    res[f"flash_fwd {tag}"] = dict(
        max_abs_err=err, rel_l2=rel, ms=time_ms(run, 5, 3), device_ms=device_ms_twice(run, 5),
        plain_ms=plain_ms, bound=bound_ms(4 * N * S * hd * 2, 4 * N * S * S * hd),
        library_ms=lib_flash if lib_cudnn is None else min(lib_flash, lib_cudnn),
        library_flash_ms=lib_flash, library_cudnn_ms=lib_cudnn)
    del qh, kh, vh, qs, ks, vs

    N, lk = 32, 512
    for sq, mode in ((7800, "T2V"), (4680, "cond")):
        qh, kh = fa._layout(normed(1, sq, N, hd), normed(1, lk, N, hd), None, False)
        vh = fa._heads_major(randn(1, lk, N, hd), kh.shape[1])

        def run():
            return fa.flash_small_kv_max(qh, kh, vh, sk_actual=lk)

        ref, plain_ms = one_call(lambda: fa.flash_small_kv_max_plain(qh, kh, vh, sk_actual=lk))
        tag = f"LongCat cross {mode} {N}x{sq} q, {lk} keys"
        out = run()
        err = check_close(f"K4 flash_small_kv_max d {hd}, {tag}", out, ref, rtol=2 ** -7,
                          atol=1e-3)
        rel = rel_l2(out, ref)
        print(f"  K4 {tag}: relative L2 error of o {rel:.3e} (bound 2^-10)", flush=True)
        if not rel < 2 ** -10:
            raise RuntimeError(f"K4 max at LongCat's cross shape: relative L2 error {rel:.3e}")
        q4, k4, v4 = heads(qh, N, sq), heads(kh, N, lk), heads(vh, N, lk)
        res[f"flash_small_kv_max {tag}"] = dict(
            max_abs_err=err, rel_l2=rel, ms=time_ms(run), device_ms=device_ms_twice(run, 20),
            plain_ms=plain_ms, bound=bound_ms((2 * sq + 2 * lk) * N * hd * 2,
                                              4 * N * sq * lk * hd),
            library_ms=time_ms(lambda: F.scaled_dot_product_attention(q4, k4, v4, scale=ln2)))
        del qh, kh, vh, ref, out, q4, k4, v4

    for sq, sk, tag in ((7800, 7800, f"LongCat T2V {N}x7800^2"),
                        (3120, 3120, f"LongCat cond frames {N}x3120^2"),
                        (4680, 7800, f"LongCat noise frames {N}x4680 q over 7800 keys")):
        qh, kh = fa._layout(normed(1, sq, N, hd), normed(1, sk, N, hd), None, False, 2048)
        v = randn(1, sk, N, hd)

        def run():
            return fa.flash_attention_heads_major(qh, kh, v, b=1, n=N, sq=sq, sk_actual=sk,
                                                  bq=qh.shape[1], bk=fa.DEFAULT_BK)

        ref, plain_ms = one_call(lambda: fa.flash_attention_heads_major_plain(
            qh, kh, v, b=1, n=N, sq=sq, sk_actual=sk))
        err = check_close(f"K3 flash_bounded, {tag}", run(), ref, rtol=2 ** -7, atol=1e-3)
        res[f"flash_bounded {tag}"] = dict(
            max_abs_err=err, ms=time_ms(run, 10, 3), device_ms=device_ms_twice(run, 10),
            plain_ms=plain_ms, bound=bound_ms((2 * sq + 2 * sk) * N * hd * 2,
                                              4 * sq * sk * hd * N),
            library_ms=time_ms(bounded_sdpa(qh, kh, v, N, sq, sk), 10, 3))
        del qh, kh, v, ref
    for tag, r in res.items():
        lib = "null" if r["library_ms"] is None else f"{r['library_ms']:.4f}"
        print(f"  {tag}: ms {r['ms']:.4f} device_ms {r['device_ms']:.4f} plain_ms "
              f"{r['plain_ms']:.4f} bound_ms {r['bound'][0]:.4f} ({r['bound'][1]}) library_ms "
              f"{lib}", flush=True)
    torch.cuda.empty_cache()
    return res


def device_profiled(label, fn):
    """One call of ``fn`` under torch.profiler with the device's activity
    only (device_table; no warm call: the request before it ran the same
    shapes): its device busy ms."""
    import torch

    with torch.no_grad():
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
    return device_table(list(prof.key_averages()), wall, label, 12) * 1e3


def animate_vap_longcat_phase(shared=None):
    """The last Wan variants at full width from seeded bf16 weights, 480x832
    through the Wan2.1 VAE (streamed), CFG 5: Wan2.2-Animate-14B (21 frames;
    17-frame pose, 512x512 face, inpaint and mask videos and an input image:
    the CLIP branch of a full-width ViT-H, the inpaint ``y`` of a reference
    frame before 5 latent frames: S = 9360), Wan2.1-I2V-14B with the VAP /
    MoT branch at MotConfig's defaults (10 layers at 5120; a 17-frame VAP
    video and an input image: the joint attention over 15600 tokens), both
    on the conditioning phase's 40 shared blocks (``shared``; seeded here
    when it is None) with the CLIP branch added; then, those freed, LongCat-Video (48 blocks of 4096)
    as T2V at 17 frames and as a continuation of a 5-frame clip (2
    conditioning latent frames, pinned after each of 2 steps: checked
    against the clip's encode).  Each request: wall, decode wall, peak
    memory, output shape, finite, exact launches (K11 by latent frames
    encoded and decoded); one sweep of each DiT profiled with the device's
    activity only; K11 at any Wan2.1 VAE shape the conditioning phase did
    not hold.  The new kernel shapes are held in the kernels phase
    (``avl_kernel_checks``).  Returns the phase's launches."""
    import dataclasses

    import numpy as np
    import torch

    from fairygen_tpu_torch import convert
    from fairygen_tpu_torch.core.params import Init, generator
    from fairygen_tpu_torch.models.wan import vae as wvae
    from fairygen_tpu_torch.models.wan.dit import wan_dit_forward
    from fairygen_tpu_torch.models.wan.image_encoder import ViTConfig
    from fairygen_tpu_torch.models.wan.longcat import longcat_dit_forward
    from fairygen_tpu_torch.models.wan.mot import wan_dit_forward_vap
    from fairygen_tpu_torch.models.wan.vae import WanVAEConfig
    from fairygen_tpu_torch.ops import _kernels
    from fairygen_tpu_torch.pipelines import wan_video
    from fairygen_tpu_torch.pipelines.wan_video import WanVideoPipeline

    bf, gib = torch.bfloat16, 2 ** 30
    start = time.perf_counter()

    def mark(what):
        print(f"  [{time.perf_counter() - start:.1f} s] {what}", flush=True)

    cfgs = avl_configs()
    torch.cuda.empty_cache()
    if shared is None:  # as the conditioning phase seeds them
        vae_cfg = WanVAEConfig.wan21_16()
        shared = dict(blocks=convert.init_dit_params(wan14b_cfg(), "cuda", bf, seed=72)["blocks"],
                      vae=convert.init_vae_params(vae_cfg, "cuda", bf, seed=71), vae_cfg=vae_cfg,
                      k11_shapes=set())
    vae, vae_cfg = shared["vae"], shared["vae_cfg"]
    # the shared blocks with the CLIP branch both I2V DiTs add to each
    # block's cross-attention (k_img, v_img, norm_k_img), seeded here
    r = Init("cuda", bf, generator("cuda", 119))
    D = cfgs["animate_dit"].dim
    blocks = [dict(b, cross_attn=dict(b["cross_attn"], k_img=r.dense(D, D), v_img=r.dense(D, D),
                                      norm_k_img=r.ones((D,))))
              for b in shared.pop("blocks")]
    torch.cuda.synchronize()
    print(f"  40 shared 14B blocks with the CLIP branch: {convert.count_params(blocks):,} params "
          f"({tree_bytes(blocks) / gib:.2f} GiB)", flush=True)
    enc_k11, dec_k11 = vae_norm_silu_calls(vae_cfg)
    ctx, nctx = seeded_context(111, 120), seeded_context(112, 1)
    img = seeded_image(113, 480, 832)
    t900 = torch.tensor([900.0], device="cuda")
    total = {k: 0 for k in _kernels.launches}
    k11_shapes, walls_all, busy = {}, {}, {}

    def request(label, pipe, per_sweep, sweeps, enc, dec, frames, frames_out, **kw):
        shapes, unrecord = record_k11_shapes(wvae)
        walls = {}
        wrap_timed(pipe, "_decode_output", walls)
        before = dict(_kernels.launches)
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        try:
            video = pipe(context=ctx, negative_context=nctx, seed=114, height=480, width=832,
                         num_frames=frames, cfg_scale=5.0, streaming_vae=True,
                         output_type="floatpoint", **kw)
            torch.cuda.synchronize()
        finally:
            unrecord()
            delattr(pipe, "_decode_output")
        wall = time.perf_counter() - t
        for shape, n in shapes.items():
            k11_shapes[shape] = k11_shapes.get(shape, 0) + n
        got = {k: _kernels.launches[k] - before[k] for k in before}
        want = {k: per_sweep.get(k, 0) * sweeps for k in got}
        want["vae_rms_silu"] = enc * enc_k11 + dec * dec_k11
        finite = bool(torch.isfinite(video).all())
        walls_all[label] = wall
        print(f"  {label}: {wall:.3f} s (decode {walls['_decode_output']:.3f} s), {sweeps} "
              f"sweeps, output {tuple(video.shape)} finite {finite}; max_memory_allocated "
              f"{torch.cuda.max_memory_allocated() / gib:.2f} GiB; launches "
              f"{ {k: v for k, v in got.items() if v} }", flush=True)
        if tuple(video.shape) != (1, 3, frames_out, 480, 832) or not finite:
            raise RuntimeError(f"{label}: wrong shape or non-finite output")
        if got != want:
            raise RuntimeError(f"{label}: launches {got} != expected {want}")
        for k in total:
            total[k] += got[k]

    def randn(*shape, seed):
        gen = torch.Generator("cuda").manual_seed(seed)
        return torch.randn(shape, generator=gen, device="cuda").to(bf)

    def dit14(seed, name):
        cfg = cfgs[name]
        params = convert.init_dit_params(dataclasses.replace(cfg, num_layers=0), "cuda", bf,
                                         seed=seed)
        params["blocks"] = blocks
        return params, cfg

    vit_cfg = ViTConfig.vit_h_14()
    vit = convert.init_vit_params(vit_cfg, "cuda", bf, seed=115)
    clip = randn(1, 257, 1280, seed=116)

    # Wan2.2-Animate-14B
    acfg = cfgs["animate"]
    adapter = convert.init_animate_params(acfg, "cuda", bf, seed=117)
    print(f"  Animate adapter: {convert.count_params(adapter):,} params "
          f"({tree_bytes(adapter) / gib:.2f} GiB)", flush=True)
    params, cfg = dit14(118, "animate_dit")
    pipe = WanVideoPipeline(params, cfg, vae, vae_cfg, dtype=bf, device="cuda",
                            image_encoder_params=vit, image_encoder_cfg=vit_cfg,
                            animate_params=adapter, animate_cfg=acfg)
    half = np.zeros((480, 832, 3), np.uint8)
    half[:, 416:] = 255
    # the input image's 21-frame I2V y (6 latent frames, as the JAX package
    # makes it before the inpaint y replaces it), the pose and background
    # videos (5 each) and the reference frame; the decode drops frame 0
    request("Wan2.2-Animate-14B, 17-frame pose / face / inpaint / mask videos", pipe,
            ANIMATE_PER_SWEEP, 2 * AVL_STEPS, 6 + 5 + 5 + 1, 5, 21, 17,
            num_inference_steps=AVL_STEPS, input_image=img,
            animate_pose_video=[seeded_image(120 + i, 480, 832) for i in range(17)],
            animate_face_video=[seeded_image(140 + i, 512, 512) for i in range(17)],
            animate_inpaint_video=[seeded_image(160 + i, 480, 832) for i in range(17)],
            animate_mask_video=[half] * 17)
    mark("Animate")
    lat, y = randn(1, 16, 6, 60, 104, seed=121), randn(1, 20, 6, 60, 104, seed=122)
    pose, face = randn(1, 16, 5, 60, 104, seed=123), randn(1, 3, 17, 512, 512, seed=124)
    busy["animate"] = device_profiled("Animate-14B sweep, S = 9360, 17 faces", lambda: (
        wan_dit_forward(params, cfg, lat, t900, ctx, y=y, clip_feature=clip,
                        animate_params=adapter, animate_cfg=acfg, pose_latents=pose,
                        face_pixel_values=face)))
    del pipe, adapter, params, lat, y, pose, face
    torch.cuda.empty_cache()
    mark("Animate profile")

    # Wan2.1-I2V-14B with the VAP / MoT branch
    mcfg = cfgs["vap"]
    mot = convert.init_mot_params(mcfg, "cuda", bf, seed=125)
    print(f"  VAP / MoT branch: {convert.count_params(mot):,} params "
          f"({tree_bytes(mot) / gib:.2f} GiB)", flush=True)
    params, cfg = dit14(126, "vap_dit")
    pipe = WanVideoPipeline(params, cfg, vae, vae_cfg, dtype=bf, device="cuda",
                            image_encoder_params=vit, image_encoder_cfg=vit_cfg, vap_params=mot,
                            vap_cfg=mcfg)
    ctx_vap, nctx_vap = seeded_context(127, 60), seeded_context(128, 1)
    # the VAP video (5 latent frames), its first frame's I2V y and the input
    # image's (5 each)
    request("Wan2.1-I2V-14B + VAP (10 MoT layers), a 17-frame VAP video", pipe, VAP_PER_SWEEP,
            2 * AVL_STEPS, 5 + 5 + 5, 5, 17, 17, num_inference_steps=AVL_STEPS, input_image=img,
            vap_video=[seeded_image(180 + i, 480, 832) for i in range(17)], context_vap=ctx_vap,
            negative_context_vap=nctx_vap)
    mark("VAP")
    lat, y = randn(1, 16, 5, 60, 104, seed=129), randn(1, 20, 5, 60, 104, seed=130)
    hidden = randn(1, 36, 5, 60, 104, seed=131)
    busy["vap"] = device_profiled("VAP sweep, S = 7800 + 7800 (10 joint layers)", lambda: (
        wan_dit_forward_vap(params, cfg, mot, mcfg, lat, t900, ctx, clip_feature=clip, y=y,
                            vap_hidden_state=hidden, context_vap=ctx_vap,
                            vap_clip_feature=clip)))
    del pipe, mot, params, lat, y, hidden, vit, blocks
    torch.cuda.empty_cache()
    mark("VAP profile; the 14B models freed")

    # LongCat-Video
    lcfg = cfgs["longcat"]
    lc = convert.init_longcat_params(lcfg, "cuda", bf, seed=132)
    torch.cuda.synchronize()
    print(f"  LongCat-Video DiT: {convert.count_params(lc):,} params "
          f"({tree_bytes(lc) / gib:.2f} GiB)", flush=True)
    pipe = WanVideoPipeline(None, None, vae, vae_cfg, dtype=bf, device="cuda",
                            longcat_params=lc, longcat_cfg=lcfg)
    request("LongCat-Video T2V", pipe, LONGCAT_PER_SWEEP, 2 * AVL_STEPS, 0, 5, 17, 17,
            num_inference_steps=AVL_STEPS)
    mark("LongCat T2V")
    kept, encoded, encode = capture_latents(pipe), [], wan_video.vae38_encode

    def keep_encode(*a, **k):
        encoded.append(encode(*a, **k))
        return encoded[-1]

    wan_video.vae38_encode = keep_encode
    try:
        clip5 = [seeded_image(190 + i, 480, 832) for i in range(5)]
        request(f"LongCat-Video continuation of a 5-frame clip, {AVL_CONT_STEPS} steps", pipe,
                LONGCAT_COND_PER_SWEEP, 2 * AVL_CONT_STEPS, 2, 5, 17, 17,
                num_inference_steps=AVL_CONT_STEPS, longcat_video=clip5)
    finally:
        wan_video.vae38_encode = encode
    pinned = torch.equal(kept[-1][:, :, :2], encoded[-1].to(bf))
    print(f"  the 2 conditioning latent frames pinned through the steps: {pinned}", flush=True)
    if not pinned or len(encoded) != 1:
        raise RuntimeError("LongCat continuation: the conditioning latents were not pinned")
    mark("LongCat continuation")
    lat = randn(1, 16, 5, 60, 104, seed=133)
    busy["longcat"] = device_profiled("LongCat-Video sweep, S = 7800", lambda: (
        longcat_dit_forward(lc, lcfg, lat, t900, ctx)))
    del pipe, lc, lat, kept, encoded
    torch.cuda.empty_cache()
    mark("LongCat profile")
    new = {sh: n for sh, n in k11_shapes.items() if sh not in shared["k11_shapes"]}
    if new:
        k11_v1_checks(new)
    print(f"  K11: {len(k11_shapes)} Wan2.1 VAE shapes in this phase, {len(new)} not held "
          f"before (now held)", flush=True)
    print(f"  animate_vap_longcat: walls {json.dumps(walls_all)}; profiled busy ms "
          f"{json.dumps(busy)}; launches {total}", flush=True)
    return total


def reference_avl_check():
    """Tiny Animate, VAP and LongCat pipelines (T2V and a continuation),
    head dim 128 so the serving kernels run, each a 2-step, CFG 5 request
    with the tiny Wan2.1 VAE, on the card in bf16 against the same weights
    on the CPU in fp32 (plain versions); the bound as reference_check's: at
    most twice the CPU bf16 run's relative L2 error plus 1e-3.  The VAP
    request runs at 256x256 so that its joint attention passes 1024 keys
    (K5); the others at 128x256 (K4's bounded form for the self-attention).
    The Animate adapter's motion directions on the card against the CPU's
    (the QR of cuSOLVER against LAPACK's: sign and order)."""
    import numpy as np
    import torch

    from fairygen_tpu_torch import convert
    from fairygen_tpu_torch.models.wan.animate import AnimateConfig, get_motion
    from fairygen_tpu_torch.models.wan.dit import WanDiTConfig
    from fairygen_tpu_torch.models.wan.longcat import LongCatDiTConfig
    from fairygen_tpu_torch.models.wan.mot import MotConfig
    from fairygen_tpu_torch.models.wan.vae import WanVAEConfig
    from fairygen_tpu_torch.ops import _kernels
    from fairygen_tpu_torch.pipelines.wan_video import WanVideoPipeline

    f32 = torch.float32
    tiny = dict(dim=256, in_dim=12, ffn_dim=512, out_dim=4, text_dim=64, freq_dim=64,
                num_heads=2, num_layers=2, require_clip_embedding=False)
    vae_cfg = WanVAEConfig.tiny_v1()
    vae = convert.init_vae_params(vae_cfg, "cpu", f32, seed=141)
    g = torch.Generator("cpu").manual_seed(142)
    ctx, nctx = torch.randn(1, 40, 64, generator=g), torch.randn(1, 40, 64, generator=g)
    kw = dict(context=ctx, negative_context=nctx, seed=143, num_frames=9, cfg_scale=5.0,
              num_inference_steps=2, output_type="latents", torch_compat_noise=True)
    acfg = AnimateConfig(hidden_dim=256, heads_num=2, num_adapter_layers=1, adapter_stride=2,
                         face_heads=2, face_inner=64, motion_size=8, style_dim=64, motion_dim=8,
                         pose_in_dim=4)
    adapter = convert.init_animate_params(acfg, "cpu", f32, seed=144)
    faces = torch.rand(5, 3, 8, 8, generator=g) * 2 - 1
    m_cpu = get_motion(adapter["motion_encoder"], faces)
    m_card = get_motion(to(adapter["motion_encoder"], "cuda", f32), faces.cuda()).cpu()
    err = (m_card - m_cpu).abs().max().item()
    print(f"  the motion directions (QR on the card vs the CPU): max abs error {err:.3e} of "
          f"max |m| {m_cpu.abs().max().item():.3e}", flush=True)
    if not err <= 1e-4 * m_cpu.abs().max().item():
        raise RuntimeError("the card's QR basis differs from the CPU's")
    mcfg = MotConfig(mot_layers=(0,), has_image_input=False, dim=256, num_heads=2, ffn_dim=512,
                     freq_dim=64, text_dim=64, in_dim=12)
    lcfg = LongCatDiTConfig(in_channels=4, out_channels=4, hidden_size=256, depth=2,
                            num_heads=2, caption_channels=64, adaln_tembed_dim=64, freq_dim=64)
    size = dict(height=128, width=256)
    vids = [[seeded_image(150 + 10 * j + i, 128, 256) for i in range(5)] for j in range(3)]
    half = [np.where(np.arange(256)[None, :, None] < 128, 255, 0).repeat(128, 0).repeat(3, 2)
            .astype(np.uint8)] * 5
    cases = [
        ("Animate", WanDiTConfig(**tiny), dict(animate_params=adapter, animate_cfg=acfg),
         dict(size, input_image=seeded_image(145, 128, 256), animate_pose_video=vids[0],
              animate_face_video=[seeded_image(170 + i, 8, 8) for i in range(5)],
              animate_inpaint_video=vids[1], animate_mask_video=half),
         ("ln_modulate", "rms_rope_heads_major", "flash_small_kv")),
        ("VAP", WanDiTConfig(**tiny), dict(
            vap_params=convert.init_mot_params(mcfg, "cpu", f32, seed=146), vap_cfg=mcfg),
         dict(height=256, width=256, input_image=seeded_image(147, 256, 256),
              vap_video=[seeded_image(180 + i, 256, 256) for i in range(9)],
              context_vap=torch.randn(1, 20, 64, generator=g),
              negative_context_vap=torch.randn(1, 20, 64, generator=g)),
         ("ln_modulate", "flash_small_kv", "flash_fwd")),
        ("LongCat T2V", None, dict(
            longcat_params=convert.init_longcat_params(lcfg, "cpu", f32, seed=148),
            longcat_cfg=lcfg), dict(size), ("flash_small_kv", "flash_small_kv_masked")),
    ]
    cases.append(("LongCat continuation", None, cases[-1][2],
                  dict(size, longcat_video=vids[2]), cases[-1][4]))
    for label, cfg, models, req, want in cases:
        dit = None if cfg is None else convert.init_dit_params(cfg, "cpu", f32, seed=149)

        def pipe(dev, dt):
            m = {k: v if k.endswith("_cfg") else to(v, dev, dt) for k, v in models.items()}
            return WanVideoPipeline(None if dit is None else to(dit, dev, dt), cfg,
                                    to(vae, dev, dt), vae_cfg, dtype=dt, device=dev, **m)

        ref = pipe("cpu", f32)(**kw, **req)
        rel16 = rel_l2(pipe("cpu", torch.bfloat16)(**kw, **req), ref)
        before = dict(_kernels.launches)
        out = pipe("cuda", torch.bfloat16)(**kw, **req).float().cpu()
        ran = {k: _kernels.launches[k] - before[k] for k in before}
        rel, tol = rel_l2(out, ref), 2 * rel16 + 1e-3
        print(f"  tiny {label} pipeline latents {tuple(out.shape)}: relative L2 error to CPU "
              f"fp32 {rel:.4e} (card bf16), {rel16:.4e} (CPU bf16); tolerance {tol:.4e}; "
              f"kernel launches { {k: v for k, v in ran.items() if v} }", flush=True)
        if not all(ran[k] for k in want):
            raise RuntimeError(f"a kernel did not run in the tiny {label} pipeline: {ran}")
        if not rel <= tol:
            raise RuntimeError(f"tiny {label} pipeline disagrees with the CPU reference: "
                               f"{rel:.4e}")

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
