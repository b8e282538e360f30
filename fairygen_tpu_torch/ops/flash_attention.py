"""K3 / K4: bounded-logits attention on head-major q/k (port of
fairygen_tpu/ops/flash_attention.py ``flash_attention_heads_major`` with
``natural_out=True``; kernels ``_fa_kernel_bounded`` and
``_fa_small_kv_kernel``).

Contract: qh (B*N, Sq_pad, d) carries the hd^-1/2·log2e prescale; q and k
are rms-normed, so softmax == exp2(s) / Σ exp2(s) without a running max.
v is (B, Lv, N, d) in its natural layout, sk_actual <= Lv <= Sk_pad, and
every row of kh (B*N, Sk_pad, d) at or past Lv is an exact zero: self and
per-head attention (Lv = S), cross attention (Lv = Lk), FLUX.1's joint
layout (Lv = i_pad + s_t) and the generic entry (Lv = Sk) all pad so.  A
zero key row adds exactly exp2(0) = 1 to the row sum and, where its v row
is zero, nothing to the output, so the count correction ``l -= keys
computed - sk_actual`` removes every zero key: the plain version computes
all Sk_pad keys, the CUDA kernels only Lv rounded up to their 128-key tile
(zero gap rows inside [0, Lv), the joint layout's, are computed and counted
by both).  The output is (B, sq, N, d).

CUDA tensors go through ``csrc/flash_attention.cu`` (bf16, d = 128; TMA,
mbarriers and wgmma): K4 when the keys are one TPU k tile (Sk_pad == bk),
K3 otherwise.  CPU tensors take :func:`flash_attention_heads_major_plain`.

The later sections hold the generic entry (K4's max and masked forms, K5,
and K6a-c for its gradient) and K10, the attention with a bias.
"""
from __future__ import annotations

import functools

import torch

from . import _kernels


def flash_attention_heads_major_plain(qh, kh, v, *, b, n, sq, sk_actual):
    """Plain version of K3/K4: fp32 logits, exp2, fp32 sum with the pad
    correction, bf16-rounded p times v accumulated in fp32 — one head at a
    time so the (Sq, Sk) logits of a single head are the largest buffer."""
    d = qh.shape[-1]
    sk_p = kh.shape[1]
    lv = v.shape[1]
    out = qh.new_empty((b, sq, n, d))
    for bn in range(b * n):
        bi, ni = divmod(bn, n)
        s = qh[bn, :sq].float() @ kh[bn].float().T
        p = torch.exp2(s)
        l = p.sum(-1, keepdim=True) - float(sk_p - sk_actual)
        vh = v.new_zeros((sk_p, d))
        vh[:lv] = v[bi, :, ni]
        pv = p.to(v.dtype).float() @ vh.float()
        out[bi, :, ni] = (pv / l).to(qh.dtype)
    return out


def flash_attention_heads_major(qh, kh, v, *, b, n, sq, sk_actual, bq=2048,
                                bk=1024):
    """Bounded attention on pre-formatted head-major q/k (see module doc).
    bq/bk are the TPU tiles: Sq_pad % bq == 0 and Sk_pad % bk == 0; a single
    k tile (Sk_pad == bk) selects K4, several select K3."""
    d = qh.shape[-1]
    sq_p, sk_p = qh.shape[1], kh.shape[1]
    if sq_p % bq or sk_p % bk:
        raise ValueError(f"padded lengths {(sq_p, sk_p)} are not multiples of {(bq, bk)}")
    if not qh.is_cuda:
        return flash_attention_heads_major_plain(qh, kh, v, b=b, n=n, sq=sq,
                                                 sk_actual=sk_actual)
    _refuse_unported(qh, grad=False, kernel="bounded")
    _kernels.check_cuda(qh, "qh", torch.bfloat16, 3)
    _kernels.check_cuda(kh, "kh", torch.bfloat16, 3)
    _kernels.check_cuda(v, "v", torch.bfloat16, 4)
    lv = v.shape[1]
    if d != 128 or qh.shape[0] != b * n or kh.shape[0] != b * n or kh.shape[2] != d:
        raise ValueError(f"attention kernels need (B*N, S_pad, 128) q/k, got "
                         f"{tuple(qh.shape)} / {tuple(kh.shape)}")
    if v.shape != (b, lv, n, d) or not 1 <= sk_actual <= lv <= sk_p or sq > sq_p:
        raise ValueError(f"v {tuple(v.shape)} does not match b={b} n={n} sk_pad={sk_p} "
                         f"sk_actual={sk_actual}")
    if sq_p % 64 or sk_p % 64:
        raise ValueError("padded lengths must be multiples of 64")
    out = torch.empty((b, sq, n, d), dtype=qh.dtype, device=qh.device)
    if sk_p == bk:
        kernel, fn = "flash_small_kv", "fg_flash_small_kv"
    else:
        kernel, fn = "flash_bounded", "fg_flash_bounded"
    _kernels.launch(kernel, fn, qh.data_ptr(), kh.data_ptr(), v.data_ptr(),
                    out.data_ptr(), b, n, sq, sq_p, int(sk_actual), sk_p, lv)
    return out


# --------------------------------------------------------------------------
# K4 (max and masked forms) / K5 / K6a / K6b / K6c: the generic entry and its
# gradient (port of ``flash_attention`` with its custom VJP,
# ``_flash_fwd_impl``, ``_flash_fwd`` and ``_flash_bwd``).  The kernels take
# head-major (B*N, S_pad, d) q/k/v, zero rows past the sequence, S_pad a
# multiple of 64: bf16 at d 64 or 128 for K4, K5 and K6a-c (d 64: the bf16
# SDXL UNet under a gradient, BrushNet training and SDXL distillation), bf16
# at d 8, 40, 80 and 160 for K4 and K5 (the SD1.5 UNet and BrushNet; on the
# card the kernels of the next width up, 64, 128 or 160, on TMA maps of the
# true width, whose columns past d read zeros), and fp32 at d 64 for K6a-c
# (the fp32 SDXL UNet of the Style-DoRA train step), and fp32 at d 8, 16,
# 40, 64, 80 and 160 for K4 and K5.  Other forms raise a ValueError that
# names ROADMAP.md Queue 2.  lse
# and delta are one fp32 value per row.  CPU tensors take the ``*_plain``
# versions, which compute what the Pallas kernels compute on one tile: fp32
# logits, keys >= sk_actual masked, p rounded to the value dtype before each
# product, fp32 accumulation.  On the card K4's max and masked forms, K5 (d
# 64 and 128) and K6a are the TMA + wgmma kernels of
# ``csrc/flash_attention_online.cu`` on 128-key tiles: K5 and K6a round p
# against its tile's running max, K4 against the row's max over every key
# (a pre-pass over the key tiles after the first finds it), as the Pallas
# kernel does; K6b and K6c are those of ``csrc/flash_attention_bwd.cu``.
# K4 and K5 at d 8, 40, 80 and 160 count apart from d 64 and 128
# (``flash_fwd_d40``, ``flash_small_kv_max_d80``, ``flash_small_kv_masked_d8``
# ...; :func:`_dim_counter`).
# The fp32 K6a-c are TMA + wgmma kernels on the tensor cores (K6a in
# ``csrc/flash_attention_fp32.cu``, K6b and K6c in
# ``csrc/flash_attention_fp32_bwd.cu``), each product taken in three TF32
# passes (hi·hi + hi·lo + lo·hi, fp32 accumulation), after a pre-pass that
# writes the operands' TF32 hi / lo and transposed copies to a workspace.
# K5 and K4's max and masked forms take fp32 without a gradient at head dims
# 8, 16, 40, 64, 80 and 160 (the SDXL and SD1.5 pipelines' default dtype)
# on K6a's kernel (its lse store skipped) in instances of 32, 64, 96 and 160
# columns on TMA maps of the true width; in fp32 the Pallas K4 rounds
# nothing, so its max and masked forms run the online softmax as K5 does.
# They count per form and head dim (``flash_fwd_f32_d40``,
# ``flash_small_kv_masked_f32_d8`` ...; :func:`_f32_counter`).  The fp32
# K6c splits its query loop over CTAs where rounds of its 128-key
# items would leave SMs idle (:func:`dkv_splits`) and sums the splits'
# partials in a second pass, in split order.

DEFAULT_BQ = 1024
DEFAULT_BK = 1024
LOG2E = 1.4426950408889634
_ROW_TILE = 64  # the CUDA kernels take padded lengths that are multiples of this
_FWD_DIMS = (8, 40, 64, 80, 128, 160)  # head dims of the K4 max/masked and K5 kernels
_SD15_DIMS = (8, 40, 80, 160)  # of them, those with counters of their own
_TRAIN_DIMS = (64, 128)  # head dims of K6a-c in bf16
_BIAS_DIMS = (128,)      # head dims of K10
_F32_TRAIN_DIMS = (64,)  # head dims of K6a-c in fp32
_F32_FWD_DIMS = (8, 16, 40, 64, 80, 160)  # head dims of the K4 max/masked and K5 kernels in fp32
_DKV_Q_TILE = 32   # queries a tile of the fp32 K6c
_DKV_KEYS = 128    # keys an item of the fp32 K6c (two consumers of 64)


def _refuse_unported(qh, grad, bounded_kv_len=False, kernel="online"):
    """Raise for an attention form whose kernel is not ported yet (ROADMAP.md
    Queue 2): bf16 with a gradient at a head dim other than 64 and 128 (B:
    K6a-c at SD1.5's 8, 40, 80, 160, wanted only if SD1.5 training is
    ported), bf16 without one at a head dim K4 / K5 do not take (B), the
    bounded K3 / K4 with a caller's ``kv_len`` (C), fp32 without a gradient
    in K3 / K4's bounded form (``kernel`` "bounded") or K10 ("bias") or at a
    head dim K4 / K5 do not take in fp32, and fp32 with a gradient at a head
    dim other than 64 (A)."""
    d = qh.shape[-1]
    f32 = qh.dtype == torch.float32
    if bounded_kv_len:
        form, item = "bounded attention (K3 / K4 bounded) with a caller's kv_len", "C"
    elif f32 and not grad and kernel != "online":
        form = {"bounded": "K3 / K4 bounded", "bias": "K10"}[kernel]
        form, item = f"fp32 attention without a gradient in {form}", "A"
    elif f32 and not grad and d not in _F32_FWD_DIMS:
        form, item = f"fp32 attention without a gradient (K4 / K5) at head dim {d}", "A"
    elif f32 and grad and d not in _F32_TRAIN_DIMS:
        form, item = f"fp32 attention with a gradient at head dim {d}", "A"
    elif qh.dtype == torch.bfloat16 and grad and d not in _TRAIN_DIMS:
        form, item = f"bf16 attention with a gradient (K6a-c) at head dim {d}", "B"
    elif qh.dtype == torch.bfloat16 and d not in _FWD_DIMS:
        form, item = f"bf16 attention at head dim {d}", "B"
    else:
        return
    raise ValueError(f"{form} has no kernel on the card yet: K4/K5 take bf16 at head dims 8, 40, "
                     f"64, 80, 128 and 160 and fp32 at 8, 16, 40, 64, 80 and 160, K6a-c bf16 "
                     f"at 64 and 128 and fp32 at 64, K3/K4 bounded and K10 bf16 and no kv_len "
                     f"(ROADMAP.md Queue 2 {item})")


def _dim_counter(name, d):
    """The launch counter of K4's form or K5 ``name`` at head dim d: its own
    name at d 64 and 128 (K5 at 64: ``flash_fwd_d64``), else name_d{d}."""
    if d in _SD15_DIMS:
        return f"{name}_d{d}"
    return "flash_fwd_d64" if (name, d) == ("flash_fwd", 64) else name


def _f32_counter(name, d):
    """The launch counter of K4's form or K5 ``name`` in fp32 at head dim
    d: name_f32_d{d}."""
    return f"{name}_f32_d{d}"


def _masked_logits(qh, kh, bn, sk_actual):
    s = qh[bn].float() @ kh[bn].float().T
    s[:, sk_actual:] = float("-inf")
    return s


def flash_fwd_plain(qh, kh, vh, *, sk_actual, with_lse=True):
    """Plain version of K5 (``with_lse=False``) and K6a: softmax in base 2
    with the row max, one head at a time.  Returns o (BN, Sq_pad, d) in
    q's dtype and, with ``with_lse``, lse = m + log2(l) (BN, Sq_pad) fp32.
    Any dtype: on fp32 inputs (K6a's fp32 form) ``p.to(v.dtype)`` is a
    no-op and everything stays fp32."""
    out = torch.empty_like(qh)
    lse = qh.new_empty(qh.shape[:2], dtype=torch.float32)
    for bn in range(qh.shape[0]):
        s = _masked_logits(qh, kh, bn, sk_actual)
        m = s.max(-1, keepdim=True).values
        p = torch.exp2(s - m)
        l = p.sum(-1, keepdim=True)
        out[bn] = ((p.to(vh.dtype).float() @ vh[bn].float()) / l).to(qh.dtype)
        lse[bn] = (m + torch.log2(l))[:, 0]
    return (out, lse) if with_lse else out


def flash_bwd_dq_plain(qh, kh, vh, doh, lse, delta, *, sk_actual, dq_factor):
    """Plain version of K6b: dQ = f * [P o (dP - delta)] K.  In fp32 the
    rounding of dS to k's dtype is a no-op."""
    dq = torch.empty_like(qh)
    for bn in range(qh.shape[0]):
        p = torch.exp2(_masked_logits(qh, kh, bn, sk_actual) - lse[bn, :, None])
        dp = doh[bn].float() @ vh[bn].float().T
        ds = p * (dp - delta[bn, :, None])
        dq[bn] = ((ds.to(kh.dtype).float() @ kh[bn].float()) * dq_factor).to(qh.dtype)
    return dq


def flash_bwd_dkv_plain(qh, kh, vh, doh, lse, delta, *, sq, sk_actual):
    """Plain version of K6c: dV = P^T dO, dK = [P o (dP - delta)]^T Q /
    log2(e); queries >= sq contribute nothing.  In fp32 the roundings of P
    and dS to the operands' dtype are no-ops."""
    return _dkv_rows_plain(qh, kh, vh, doh, lse, delta, 0, sq, sk_actual)


def _dkv_rows_plain(qh, kh, vh, doh, lse, delta, q_lo, q_hi, sk_actual):
    """K6c's plain version over the queries [q_lo, q_hi) alone."""
    dk, dv = torch.empty_like(kh), torch.empty_like(vh)
    for bn in range(qh.shape[0]):
        p = torch.exp2(_masked_logits(qh, kh, bn, sk_actual) - lse[bn, :, None])
        p[:q_lo] = 0.0
        p[q_hi:] = 0.0
        dv[bn] = (p.to(doh.dtype).float().T @ doh[bn].float()).to(vh.dtype)
        dp = doh[bn].float() @ vh[bn].float().T
        ds = p * (dp - delta[bn, :, None])
        dk[bn] = ((ds.to(qh.dtype).float().T @ qh[bn].float()) * (1.0 / LOG2E)).to(kh.dtype)
    return dk, dv


@functools.lru_cache(maxsize=None)
def dkv_splits(bn, sq, sk_pad, sms):
    """(n_split, tiles_per_split): how the fp32 K6c splits its query loop of
    ceil(sq / 32) tiles over CTAs.  Its items are 128 keys of one head and
    one split; split j takes the tiles [j tps, min((j + 1) tps, n_tiles)).
    The count is the least of rounds x (tps + 2) (a round: one item on every
    SM; the 2: an item's K / V load and its partials' store, in tiles),
    fewer splits on a tie, among the counts that give at least ``sms`` items
    where the 128-key blocks alone give fewer and splits can make so many.
    On an H100 this picks 2 / 4 / 26 / 11 splits at a DoRA step's 10 x
    4096^2, 20 x 1024^2, 10 x 4096 x 77 and 20 x 1024 x 77 shapes; PERF.md
    §6 (PR 18) has the times of the other counts."""
    n_qt = -(-sq // _DKV_Q_TILE)
    base = bn * -(-sk_pad // _DKV_KEYS)
    best = None
    for tps in range(1, n_qt + 1):
        n_split = -(-n_qt // tps)
        items = base * n_split
        if items < sms <= base * n_qt:
            continue
        key = (-(-items // sms) * (tps + 2), n_split)
        if best is None or key < best[0]:
            best = (key, (n_split, tps))
    return best[1]


def split_ranges(n_tiles, n_split, tiles_per_split):
    """The query tiles [start, end) of each split, in split order."""
    return [(j * tiles_per_split, min((j + 1) * tiles_per_split, n_tiles))
            for j in range(n_split)]


def flash_bwd_dkv_partials_plain(qh, kh, vh, doh, lse, delta, *, sq, sk_actual, n_split,
                                 tiles_per_split):
    """Plain version of the split fp32 K6c: each split's dK and dV over its
    queries alone, (n_split, 2, BN, Sk_pad, d)."""
    n_qt = -(-sq // _DKV_Q_TILE)
    parts = []
    for j0, j1 in split_ranges(n_qt, n_split, tiles_per_split):
        parts.append(torch.stack(_dkv_rows_plain(qh, kh, vh, doh, lse, delta,
                                                 j0 * _DKV_Q_TILE, min(j1 * _DKV_Q_TILE, sq),
                                                 sk_actual)))
    return torch.stack(parts)


def dkv_reduce_plain(part):
    """Plain version of the fp32 K6c's reduce pass: the partials (n_split,
    2, ...) summed in split order, one fp32 add at a time; (dK, dV)."""
    acc = part[0].clone()
    for p in part[1:]:
        acc += p
    return acc[0], acc[1]


def tf32_round_plain(x):
    """x (fp32) rounded to TF32, 10 mantissa bits, to nearest with ties away
    from zero (the kernels' rounding): + 2^12 and the low 13 bits cleared."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _tf32_split_plain(x):
    hi = tf32_round_plain(x)
    return hi, tf32_round_plain(x - hi)


def _permuted_rows(n):
    """Row index of each position of a transposed operand: each 8 rows as
    0, 2, 4, 6, 1, 3, 5, 7 (the order of a wgmma accumulator's columns)."""
    p = torch.arange(n)
    e = p % 8
    return p - e + torch.where(e < 4, 2 * e, 2 * (e - 4) + 1)


def bwd_prep_f32_plain(qh, kh, vh, doh, which):
    """Plain version of the fp32 K6b (``which`` 0) / K6c (1) pre-pass: the
    workspace, flat: the TF32 hi and lo of q, dO, k, v, then those of the
    transposed (BN, d, S_pad), row-permuted K (K6b) or Q and dO (K6c)."""
    parts = []
    for x in (qh, doh, kh, vh):
        parts += _tf32_split_plain(x)
    for x in (kh,) if which == 0 else (qh, doh):
        parts += _tf32_split_plain(x[:, _permuted_rows(x.shape[1]).to(x.device)]
                                   .transpose(1, 2).contiguous())
    return torch.cat([p.reshape(-1) for p in parts])


def fwd_prep_f32_plain(kh, vh):
    """Plain version of the fp32 K6a pre-pass: the workspace, flat: the TF32
    hi and lo of k, then those of the transposed (BN, d, Sk_pad),
    row-permuted v (the B operand of P V)."""
    vt = vh[:, _permuted_rows(vh.shape[1]).to(vh.device)].transpose(1, 2).contiguous()
    return torch.cat([p.reshape(-1) for p in _tf32_split_plain(kh) + _tf32_split_plain(vt)])


def _fwd_prep_f32(kh, vh):
    """The fp32 forward's pre-pass into a new workspace (the layout of
    ``fwd_prep_f32_plain``)."""
    ws = torch.empty(4 * kh.numel(), dtype=torch.float32, device=kh.device)
    _kernels.launch("flash_fwd_prep_f32", "fg_flash_fwd_prep_f32", kh.data_ptr(), vh.data_ptr(),
                    ws.data_ptr(), kh.shape[0], kh.shape[1], kh.shape[2])
    return ws


def _fwd_f32(qh, kh, vh, sk_actual, counter, with_lse):
    """The fp32 forward on the card (inputs checked): the pre-pass and the
    3xTF32 kernel, counted as ``counter``; returns o, and lse with
    ``with_lse`` (K6a, d 64)."""
    bn, sq_p, d = qh.shape
    out = torch.empty_like(qh)
    lse = torch.empty((bn, sq_p), dtype=torch.float32, device=qh.device) if with_lse else None
    ws = _fwd_prep_f32(kh, vh)
    _kernels.launch(counter, "fg_flash_fwd_f32_tc", qh.data_ptr(), ws.data_ptr(), out.data_ptr(),
                    lse.data_ptr() if with_lse else None, bn, sq_p, int(sk_actual), kh.shape[1], d)
    return (out, lse) if with_lse else out


def _sm_count(device):
    return torch.cuda.get_device_properties(device).multi_processor_count


def _bwd_prep_f32(qh, kh, vh, doh, which):
    """The fp32 K6b / K6c pre-pass into a new workspace (the layout of
    ``bwd_prep_f32_plain``)."""
    bn, sq_p, d = qh.shape
    nq, nk = bn * sq_p * d, bn * kh.shape[1] * d
    ws = torch.empty(4 * nq + 4 * nk + (2 * nk if which == 0 else 4 * nq), dtype=torch.float32,
                     device=qh.device)
    _kernels.launch("flash_bwd_prep_f32", "fg_flash_bwd_prep_f32", qh.data_ptr(), kh.data_ptr(),
                    vh.data_ptr(), doh.data_ptr(), ws.data_ptr(), which, bn, sq_p, kh.shape[1])
    return ws


def _check_heads_major(qh, kh, vh, sk_actual, extra=(), dims=_TRAIN_DIMS,
                       dtype=torch.bfloat16):
    for name, t in (("qh", qh), ("kh", kh), ("vh", vh)) + tuple(extra):
        _kernels.check_cuda(t, name, dtype, 3)
    if qh.shape[2] not in dims or kh.shape != vh.shape or kh.shape[0] != qh.shape[0] \
            or kh.shape[2] != qh.shape[2]:
        raise ValueError(f"this flash kernel needs (BN, S_pad, d) q/k/v with d in {dims}, got "
                         f"{tuple(qh.shape)} / {tuple(kh.shape)} / {tuple(vh.shape)}")
    if qh.shape[1] % _ROW_TILE or kh.shape[1] % _ROW_TILE:
        raise ValueError("padded lengths must be multiples of 64")
    if not 1 <= sk_actual <= kh.shape[1]:
        raise ValueError(f"sk_actual {sk_actual} outside [1, {kh.shape[1]}]")


def _check_rows(t, name, shape):
    _kernels.check_cuda(t, name, torch.float32, 2)
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must be {tuple(shape)}, got {tuple(t.shape)}")


def flash_fwd(qh, kh, vh, *, sk_actual, with_lse=True):
    """K6a (``with_lse``: bf16 at d 64 or 128, fp32 at d 64) or K5 (bf16, d
    = 8, 40, 64, 80, 128 or 160; fp32, d = 8, 16, 40, 64, 80 or 160) on
    head-major q/k/v (see the section note).  Returns o, and lse with
    ``with_lse``.  On the card the bf16 forms are the TMA + wgmma kernels of
    ``csrc/flash_attention_online.cu`` (K5's o equals K6a's bit for bit at
    the same head dim; K6a counts as ``flash_fwd_lse`` at d 128,
    ``flash_fwd_lse_d64`` at 64; K5 as :func:`_dim_counter` says), the fp32
    forms the pre-pass and the 3xTF32 TMA + wgmma kernels of
    ``csrc/flash_attention_fp32.cu`` (K6a counted as ``flash_fwd_lse_f32``,
    K5 as :func:`_f32_counter` says)."""
    if not qh.is_cuda:
        return flash_fwd_plain(qh, kh, vh, sk_actual=sk_actual, with_lse=with_lse)
    _refuse_unported(qh, grad=with_lse)
    if qh.dtype == torch.float32:
        _check_heads_major(qh, kh, vh, sk_actual, dtype=torch.float32,
                           dims=_F32_TRAIN_DIMS if with_lse else _F32_FWD_DIMS)
        counter = "flash_fwd_lse_f32" if with_lse else _f32_counter("flash_fwd", qh.shape[2])
        return _fwd_f32(qh, kh, vh, sk_actual, counter, with_lse)
    _check_heads_major(qh, kh, vh, sk_actual, dims=_TRAIN_DIMS if with_lse else _FWD_DIMS)
    bn, sq_p, d = qh.shape
    out = torch.empty_like(qh)
    if with_lse:
        lse = torch.empty((bn, sq_p), dtype=torch.float32, device=qh.device)
        _kernels.launch("flash_fwd_lse" if d == 128 else "flash_fwd_lse_d64", "fg_flash_fwd_lse",
                        qh.data_ptr(), kh.data_ptr(), vh.data_ptr(), out.data_ptr(),
                        lse.data_ptr(), bn, sq_p, int(sk_actual), kh.shape[1], d)
        return out, lse
    _kernels.launch(_dim_counter("flash_fwd", d), "fg_flash_fwd", qh.data_ptr(), kh.data_ptr(),
                    vh.data_ptr(), out.data_ptr(), bn, sq_p, int(sk_actual), kh.shape[1], d)
    return out


def flash_small_kv_max_plain(qh, kh, vh, *, sk_actual):
    """Plain version of K4's max and masked forms: K5's plain version
    already takes each row's max over every key at once, then exp2(s - m),
    the fp32 sum and p rounded to v's dtype before p·v."""
    return flash_fwd_plain(qh, kh, vh, sk_actual=sk_actual, with_lse=False)


def flash_small_kv_max(qh, kh, vh, *, sk_actual):
    """K4's max form (sk_actual == Sk_pad) or masked form (keys >=
    sk_actual masked) on head-major q/k/v (BN, S_pad, d), d = 8, 40, 64, 80,
    128 or 160 in bf16 and 8, 16, 40, 64, 80 or 160 in fp32, whose keys are
    one TPU k tile (Sk_pad <= 1024).  Returns head-major o.  On the card in
    bf16: the TMA + wgmma kernels of ``csrc/flash_attention_online.cu`` with
    each row's max taken before its first p (see the section note), counted
    as :func:`_dim_counter` says; in fp32 the 3xTF32 kernels of
    ``csrc/flash_attention_fp32.cu`` (p is not rounded, so the online
    softmax computes the same function), counted as :func:`_f32_counter`
    says."""
    if not qh.is_cuda:
        return flash_small_kv_max_plain(qh, kh, vh, sk_actual=sk_actual)
    _refuse_unported(qh, grad=False)
    f32 = qh.dtype == torch.float32
    _check_heads_major(qh, kh, vh, sk_actual, dims=_F32_FWD_DIMS if f32 else _FWD_DIMS,
                       dtype=qh.dtype if f32 else torch.bfloat16)
    bn, sq_p, d = qh.shape
    sk_p = kh.shape[1]
    if sk_p > DEFAULT_BK:
        raise ValueError(f"K4 takes one k tile of at most {DEFAULT_BK} keys, got {sk_p}")
    form = "flash_small_kv_masked" if sk_actual < sk_p else "flash_small_kv_max"
    if f32:
        return _fwd_f32(qh, kh, vh, sk_actual, _f32_counter(form, d), False)
    out = torch.empty_like(qh)
    _kernels.launch(_dim_counter(form, d), "fg_flash_small_kv_max", qh.data_ptr(), kh.data_ptr(),
                    vh.data_ptr(), out.data_ptr(), bn, sq_p, int(sk_actual), sk_p, d)
    return out


def _check_bwd(qh, kh, vh, doh, lse, delta, sk_actual):
    """The backward kernels' checks; True for the fp32 form."""
    _refuse_unported(qh, grad=True)
    f32 = qh.dtype == torch.float32
    _check_heads_major(qh, kh, vh, sk_actual, (("doh", doh),),
                       dims=_F32_TRAIN_DIMS if f32 else _TRAIN_DIMS,
                       dtype=torch.float32 if f32 else torch.bfloat16)
    if doh.shape != qh.shape:
        raise ValueError("doh must have q's shape")
    _check_rows(lse, "lse", qh.shape[:2])
    _check_rows(delta, "delta", qh.shape[:2])
    return f32


def flash_bwd_dq(qh, kh, vh, doh, lse, delta, *, sk_actual, dq_factor):
    """K6b: dQ (BN, Sq_pad, d) from the forward's lse and delta (bf16 at d
    64 or 128, fp32 at d 64); every row below Sq_pad is written.  On the
    card the bf16 form is the TMA + wgmma kernel of
    ``csrc/flash_attention_bwd.cu`` (counted as ``flash_bwd_dq`` at d 128,
    ``flash_bwd_dq_d64`` at 64), the fp32 form the pre-pass and the 3xTF32
    TMA + wgmma kernel of ``csrc/flash_attention_fp32_bwd.cu``."""
    if not qh.is_cuda:
        return flash_bwd_dq_plain(qh, kh, vh, doh, lse, delta, sk_actual=sk_actual,
                                  dq_factor=dq_factor)
    f32 = _check_bwd(qh, kh, vh, doh, lse, delta, sk_actual)
    bn, sq_p, d = qh.shape
    dq = torch.empty_like(qh)
    if f32:
        ws = _bwd_prep_f32(qh, kh, vh, doh, 0)
        _kernels.launch("flash_bwd_dq_f32", "fg_flash_bwd_dq_f32_tc", ws.data_ptr(),
                        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), float(dq_factor), bn,
                        sq_p, int(sk_actual), kh.shape[1])
        return dq
    _kernels.launch("flash_bwd_dq" if d == 128 else "flash_bwd_dq_d64", "fg_flash_bwd_dq",
                    qh.data_ptr(), kh.data_ptr(), vh.data_ptr(), doh.data_ptr(), lse.data_ptr(),
                    delta.data_ptr(), dq.data_ptr(), float(dq_factor), bn, sq_p, int(sk_actual),
                    kh.shape[1], d)
    return dq


def flash_bwd_dkv(qh, kh, vh, doh, lse, delta, *, sq, sk_actual):
    """K6c: (dK, dV), each (BN, Sk_pad, d) (bf16 at d 64 or 128, fp32 at d
    64); queries >= sq are skipped and key rows >= sk_actual come out
    exactly 0.  On the card the bf16 form is the TMA + wgmma kernel of
    ``csrc/flash_attention_bwd.cu`` (counted as ``flash_bwd_dkv`` at d 128,
    ``flash_bwd_dkv_d64`` at 64), the fp32 form the pre-pass and the
    3xTF32 TMA + wgmma kernel of ``csrc/flash_attention_fp32_bwd.cu``, its
    query loop split as :func:`dkv_splits` says and, when split, the reduce
    pass."""
    if not qh.is_cuda:
        return flash_bwd_dkv_plain(qh, kh, vh, doh, lse, delta, sq=sq, sk_actual=sk_actual)
    f32 = _check_bwd(qh, kh, vh, doh, lse, delta, sk_actual)
    if not 1 <= sq <= qh.shape[1]:
        raise ValueError(f"sq {sq} outside [1, {qh.shape[1]}]")
    bn, sq_p, d = qh.shape
    sk_p = kh.shape[1]
    dk, dv = torch.empty_like(kh), torch.empty_like(vh)
    if f32:
        ws = _bwd_prep_f32(qh, kh, vh, doh, 1)
        n_split, tps = dkv_splits(bn, int(sq), sk_p, _sm_count(qh.device))
        part = torch.empty((n_split, 2) + tuple(kh.shape), dtype=torch.float32,
                           device=qh.device) if n_split > 1 else dk
        _kernels.launch("flash_bwd_dkv_f32", "fg_flash_bwd_dkv_f32_tc", ws.data_ptr(),
                        lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                        part.data_ptr(), n_split, tps, bn, int(sq), sq_p, int(sk_actual), sk_p)
        if n_split > 1:
            _kernels.launch("flash_bwd_dkv_reduce_f32", "fg_flash_bwd_dkv_reduce_f32",
                            part.data_ptr(), dk.data_ptr(), dv.data_ptr(), n_split, dk.numel())
        return dk, dv
    _kernels.launch("flash_bwd_dkv" if d == 128 else "flash_bwd_dkv_d64", "fg_flash_bwd_dkv",
                    qh.data_ptr(), kh.data_ptr(), vh.data_ptr(), doh.data_ptr(), lse.data_ptr(),
                    delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), bn, int(sq), sq_p,
                    int(sk_actual), sk_p, d)
    return dk, dv


def _tiles(sq, sk, bq_default=DEFAULT_BQ):
    """The JAX package's tiles: bq = min(default, max(128, sq)), bk likewise."""
    return min(bq_default, max(128, sq)), min(DEFAULT_BK, max(128, sk))


def _pad_len(s, tile, cuda):
    """s rounded up to the tile; on the card also to the kernels' 64 rows."""
    n = -(-s // tile) * tile
    return -(-n // _ROW_TILE) * _ROW_TILE if cuda else n


def _heads_major(x, s_pad):
    """(B, S, N, d) -> zero-padded (B*N, s_pad, d), contiguous."""
    b, s, n, d = x.shape
    out = x.new_zeros((b * n, s_pad, d))
    out[:, :s] = x.permute(0, 2, 1, 3).reshape(b * n, s, d)
    return out


def _natural(xh, b, n, s):
    """(B*N, S_pad, d) -> (B, s, N, d)."""
    return xh[:, :s].reshape(b, n, s, xh.shape[-1]).permute(0, 2, 1, 3)


def _prescale(q, scale, prescaled):
    if prescaled:
        return q
    scale_val = q.shape[-1] ** -0.5 if scale is None else float(scale)
    return (q.float() * (scale_val * LOG2E)).to(q.dtype)


def _layout(q, k, scale, prescaled, bq_default=DEFAULT_BQ):
    """Prescaled head-major q and head-major k, zero-padded to the tiles."""
    sq, sk = q.shape[1], k.shape[1]
    bq, bk = _tiles(sq, sk, bq_default)
    qh = _heads_major(_prescale(q, scale, prescaled), _pad_len(sq, bq, q.is_cuda))
    return qh, _heads_major(k, _pad_len(sk, bk, q.is_cuda))


def _flash_fwd_impl(q, k, v, scale=None, prescaled=False, kv_len=None, bounded_logits=False):
    """The no-gradient forward, dispatched as the JAX package's: with
    ``bounded_logits`` and no ``kv_len``, K4's bounded form when the keys
    fit one TPU k tile and K3 otherwise (pad-correction form, on
    zero-padded head-major q/k and natural v); every other call K4's max
    form (masked when keys are padded or cut by ``kv_len``) when the padded
    keys fit one k tile (Sk_pad == bk, i.e. Sk <= 1024), K5 otherwise.

    With ``bounded_logits`` and a ``kv_len`` the JAX package runs the
    bounded kernels with an explicit mask and no max; that form is not
    ported, and on the card such a call raises (ROADMAP.md Queue 2 C).  No
    ported model makes one."""
    if bounded_logits and kv_len is not None and q.is_cuda:
        _refuse_unported(q, grad=False, bounded_kv_len=True)
    b, sq, n, _ = q.shape
    sk = k.shape[1]
    qh, kh = _layout(q, k, scale, prescaled, 2048 if bounded_logits else DEFAULT_BQ)
    sk_p = kh.shape[1]
    if bounded_logits and kv_len is None:
        # keys in one TPU k tile -> K4 (the wrapper picks it by sk_p == bk)
        k_tile = sk_p if sk <= DEFAULT_BK else DEFAULT_BK
        return flash_attention_heads_major(qh, kh, v.contiguous(), b=b, n=n, sq=sq,
                                           sk_actual=sk, bq=qh.shape[1], bk=k_tile)
    sk_act = sk if kv_len is None else int(kv_len)
    vh = _heads_major(v, sk_p)
    if sk <= DEFAULT_BK:  # the JAX package's sk_p == bk: one k tile
        out = flash_small_kv_max(qh, kh, vh, sk_actual=sk_act)
    else:
        out = flash_fwd(qh, kh, vh, sk_actual=sk_act, with_lse=False)
    return _natural(out, b, n, sq)


class _FlashAttention(torch.autograd.Function):
    """``flash_attention`` with a gradient: forward K6a (saves o and the
    per-row lse), backward K6b then K6c, δ = Σ dO·O in PyTorch.  On the
    card bf16 q/k/v at head dims 64 (the bf16 SDXL UNet's) and 128 take the
    TMA + wgmma kernels, fp32 at head dim 64 (the fp32 SDXL UNet's) the
    3xTF32 TMA + wgmma K6a of
    ``csrc/flash_attention_fp32.cu`` and K6b and K6c of
    ``csrc/flash_attention_fp32_bwd.cu``; other forms raise (ROADMAP.md
    Queue 2)."""

    @staticmethod
    def forward(ctx, q, k, v, scale, prescaled, kv_len):
        b, sq, n, d = q.shape
        sk = k.shape[1]
        qh, kh = _layout(q, k, scale, prescaled)
        vh = _heads_major(v, kh.shape[1])
        sk_act = sk if kv_len is None else int(kv_len)
        oh, lse = flash_fwd(qh, kh, vh, sk_actual=sk_act, with_lse=True)
        ctx.save_for_backward(qh, kh, vh, oh, lse)
        scale_val = d ** -0.5 if scale is None else float(scale)
        ctx.meta = (b, sq, n, sk, sk_act, (1.0 / LOG2E) if prescaled else scale_val)
        return _natural(oh, b, n, sq)

    @staticmethod
    def backward(ctx, g):
        qh, kh, vh, oh, lse = ctx.saved_tensors
        b, sq, n, sk, sk_act, dq_factor = ctx.meta
        doh = _heads_major(g.to(qh.dtype), qh.shape[1])
        delta = (doh.float() * oh.float()).sum(-1)
        dq = flash_bwd_dq(qh, kh, vh, doh, lse, delta, sk_actual=sk_act, dq_factor=dq_factor)
        dk, dv = flash_bwd_dkv(qh, kh, vh, doh, lse, delta, sq=sq, sk_actual=sk_act)
        return (_natural(dq, b, n, sq), _natural(dk, b, n, sk), _natural(dv, b, n, sk),
                None, None, None)


def flash_attention(q, k, v, scale=None, prescaled=False, kv_len=None, bounded_logits=False):
    """Flash attention, (B, S, N, d) in and out (port of the JAX package's
    ``flash_attention``).  ``prescaled``: q already carries scale·log2(e)
    (gradients are then w.r.t. that q).  ``kv_len``: only the first
    ``kv_len`` keys attend.  ``bounded_logits``: q/k are rms-normed, so the
    no-gradient forward may use the max-free K3/K4.  When a gradient is
    needed the forward is K6a and the backward K6b + K6c."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _FlashAttention.apply(q, k, v, scale, prescaled, kv_len)
    return _flash_fwd_impl(q, k, v, scale, prescaled, kv_len, bounded_logits)


# --------------------------------------------------------------------------
# K10: attention with a head-shared additive bias (port of
# ``flash_attention_bias`` and ``_fa_bias_kernel``), the EliGen path.  The
# bias is fp32 (B|1, Sq, Sk) in the natural-log domain; padded query rows and
# key columns take -1e30, as the JAX package pads it.  CUDA tensors go
# through ``csrc/flash_attention_online.cu`` (TMA, mbarriers and wgmma).
# Where sq = Sq_pad and sk = Sk_pad are multiples of 128 (the aligned form)
# the bias comes into shared memory by TMA too; at other lengths (a TMA map
# needs Sk % 4 == 0) each thread reads its entries into its score registers,
# so any Sk works.

_NEG_BIAS = -1e30


def flash_attention_bias_plain(qh, kh, vh, bias, *, n, sq, sk):
    """Plain version of K10, one head at a time: fp32 logits plus
    bias·log2(e) (pads at -1e30), base-2 softmax with the row max, p
    rounded to v's dtype before the p·v product, fp32 accumulation."""
    sq_p, sk_p = qh.shape[1], kh.shape[1]
    padded = bias.new_full((bias.shape[0], sq_p, sk_p), _NEG_BIAS)
    padded[:, :sq, :sk] = bias
    out = torch.empty_like(qh)
    for bn in range(qh.shape[0]):
        s = qh[bn].float() @ kh[bn].float().T + padded[0 if bias.shape[0] == 1 else bn // n] * LOG2E
        p = torch.exp2(s - s.max(-1, keepdim=True).values)
        l = p.sum(-1, keepdim=True)
        out[bn] = ((p.to(vh.dtype).float() @ vh[bn].float()) / l).to(qh.dtype)
    return out


def flash_attention_bias_heads_major(qh, kh, vh, bias, *, n, sq, sk):
    """K10 on head-major q/k/v (BN, S_pad, 128) (q prescaled, zero pad
    rows) and an unpadded fp32 bias (B|1, sq, sk).  Returns head-major o."""
    if not qh.is_cuda:
        return flash_attention_bias_plain(qh, kh, vh, bias, n=n, sq=sq, sk=sk)
    _refuse_unported(qh, grad=False, kernel="bias")
    _check_heads_major(qh, kh, vh, sk, dims=_BIAS_DIMS)
    _kernels.check_cuda(bias, "bias", torch.float32, 3)
    bn = qh.shape[0]
    if bn % n or bias.shape[0] not in (1, bn // n) or tuple(bias.shape[1:]) != (sq, sk) \
            or not 1 <= sq <= qh.shape[1]:
        raise ValueError(f"bias {tuple(bias.shape)} does not match BN {bn}, N {n}, sq {sq}, "
                         f"sk {sk}")
    out = torch.empty_like(qh)
    _kernels.launch("flash_bias", "fg_flash_bias", qh.data_ptr(), kh.data_ptr(), vh.data_ptr(),
                    bias.data_ptr(), out.data_ptr(), bn, n, bias.shape[0], sq, qh.shape[1], sk,
                    kh.shape[1])
    return out


def flash_attention_bias(q, k, v, bias, scale=None, prescaled=False):
    """Forward attention, (B, S, N, d) in and out, with a head-shared
    additive bias (B|1, Sq, Sk) in the natural-log domain (the attn_mask of
    scaled_dot_product_attention).  ``prescaled``: q already carries
    scale·log2(e).  Lengths are padded to the kernel's 64 rows.  Forward
    only, as the JAX kernel: raises NotImplementedError when a gradient
    is asked for."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v, bias)):
        raise NotImplementedError("flash_attention_bias has no backward (K10 is forward-only)")
    b, sq, n, _ = q.shape
    sk = k.shape[1]
    qh = _heads_major(_prescale(q, scale, prescaled), _pad_len(sq, _ROW_TILE, False))
    sk_p = _pad_len(sk, _ROW_TILE, False)
    out = flash_attention_bias_heads_major(qh, _heads_major(k, sk_p), _heads_major(v, sk_p),
                                           bias.float().contiguous(), n=n, sq=sq, sk=sk)
    return _natural(out, b, n, sq)
