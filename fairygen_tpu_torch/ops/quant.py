"""W8A8 int8 projections (port of fairygen_tpu/ops/quant.py).

Weights are quantized per output column (symmetric, static), activations
per row (symmetric, dynamic), the product accumulates in int32 and is
rescaled in fp32: ``y = (x_q @ w_q) * row_scale * w_scale``, cast to the
activation's dtype, then the bias in that dtype.

On a CUDA tensor the int8 product is ``torch._int_mm`` (cuBLASLt's int8
tensor-core GEMM); it needs more than 16 rows (fewer are padded with zero
rows) and an inner and an output width that are multiples of 8 (others
raise: nothing falls back to a float product).  ``w_int8`` is stored
(in, out) as the JAX package stores it, laid out column-major — a
transposed view of a contiguous (out, in) buffer — which is the operand
order cuBLASLt's int8 kernels take.  On a CPU tensor the product is the
exact int32 one (plain PyTorch).  The activation quantizer and the rescale
are plain PyTorch passes on either device, each under a
``torch.profiler.record_function`` range (``w8a8.quantize``,
``w8a8.int_mm``, ``w8a8.rescale``, ``w8a8.outliers``) so a trace can name
them.  ``launches["int_mm"]`` counts the ``torch._int_mm`` calls.

The outlier-robust form (``quantize_weight_int8_robust``): SmoothQuant
scales folded into the weight and undone on the activation in the same
multiply that zeroes the ``outlier_k`` worst calibrated channels, which
instead pass through two thin bf16 products (x @ outlier_sel @ w_outlier).

``quantize_wan_dit_linears`` / ``quantize_image_dit_params`` swap the
dense layers of a DiT's per-block lists; ``consume=True`` drops each float
weight from the input tree as soon as its int8 copy exists, so the two
copies of a full-width DiT are never held together.
"""
from __future__ import annotations

import contextlib
from typing import Any, Dict, List, Optional

import numpy as np
import torch

launches: Dict[str, int] = {"int_mm": 0}


def reset_launches() -> None:
    launches["int_mm"] = 0


# ------------------------------------------------------- activation stats
_ACT_TAP: Optional[List] = None
_ACT_TAP_MODE: str = "stats"


@contextlib.contextmanager
def activation_stats_tap(tap: List, mode: str = "stats"):
    """While active, every dense that calls :func:`record_activation_stats`
    appends a (label, stats) entry to ``tap``, in call order.
    mode="channel_amax" records the per-input-channel absolute maximum (a
    (K,) fp32 tensor) instead of the row crest statistics: the calibration
    signal of the SmoothQuant migration
    (``training/quant_experiment.calibrate_wan_dit_act_amax``)."""
    global _ACT_TAP, _ACT_TAP_MODE
    prev, prev_mode = _ACT_TAP, _ACT_TAP_MODE
    _ACT_TAP, _ACT_TAP_MODE = tap, mode
    try:
        yield tap
    finally:
        _ACT_TAP, _ACT_TAP_MODE = prev, prev_mode


def activation_row_stats(x) -> Dict[str, torch.Tensor]:
    """Crest-factor statistics of the (N, K) rows that per-row activation
    scaling would quantize (per-op SNR ~ 127·sqrt(12) / crest)."""
    xf = x.float().reshape(-1, x.shape[-1])
    amax = xf.abs().amax(-1)
    rms = torch.sqrt((xf * xf).mean(-1) + 1e-30)
    crest = amax / rms
    return {"amax_max": amax.max(), "rms_mean": rms.mean(), "crest_mean": crest.mean(),
            "crest_p99": torch.quantile(crest, 0.99), "crest_max": crest.max()}


def record_activation_stats(label: str, x) -> None:
    """Hook point of the dense helpers (a no-op unless a tap is active)."""
    if _ACT_TAP is None:
        return
    if _ACT_TAP_MODE == "channel_amax":
        _ACT_TAP.append((label, x.reshape(-1, x.shape[-1]).abs().amax(0).float()))
    else:
        _ACT_TAP.append((label, activation_row_stats(x)))


def weight_quant_report(w) -> Dict[str, float]:
    """Per-column int8 error of one (in, out) matrix: relative rms
    reconstruction error and the columns' crest factors."""
    q = quantize_weight_int8(w)
    wf = w.float()
    rec = q["w_int8"].float() * q["w_scale"][None, :]
    rel = torch.sqrt(((rec - wf) ** 2).sum() / torch.clamp((wf ** 2).sum(), min=1e-30))
    amax = wf.abs().amax(0)
    crest = amax / torch.sqrt((wf * wf).mean(0) + 1e-30)
    return {"rel_rms_err": float(rel), "crest_mean": float(crest.mean()),
            "crest_max": float(crest.max())}


# ------------------------------------------------------------ weights
def int_mm_layout(q: torch.Tensor) -> torch.Tensor:
    """An (in, out) int8 weight, laid out column-major: the transposed view
    of its contiguous (out, in) copy."""
    return q.t().contiguous().t()


def _div127(t):
    """t / 127 as the JAX package computes it under ``jax.jit``: XLA turns
    the division by the constant into a product with fp32(1/127), so this is
    that product, with the reciprocal in an fp32 tensor (one rounding on
    every device, where a host scalar would be taken in double)."""
    return t * torch.full((), 1.0 / 127.0, dtype=torch.float32, device=t.device)


def quantize_weight_int8(w) -> Dict[str, torch.Tensor]:
    """(in, out) float weight -> {"w_int8" (in, out), "w_scale" (out,) fp32}."""
    wf = w.float()
    scale = torch.clamp(_div127(wf.abs().amax(0)), min=1e-12)
    q = torch.clamp(torch.round(wf / scale), -127, 127).to(torch.int8)
    return {"w_int8": int_mm_layout(q), "w_scale": scale}


def smooth_scales(act_amax, w, alpha: float = 0.5):
    """SmoothQuant migration scales s (K,): the activation is divided by s,
    the weight rows multiplied by it.  s_j = amax_j^a / wmax_j^(1-a) with
    wmax_j = max_out |w[j, :]|, normalised to a geometric mean of 1 over the
    live channels; channels with degenerate statistics keep s = 1."""
    wf = w.float()
    amax = torch.as_tensor(act_amax, dtype=torch.float32, device=wf.device)
    wmax = wf.abs().amax(-1)
    ok = (amax > 1e-12) & (wmax > 1e-12)
    s = torch.pow(torch.clamp(amax, min=1e-12), alpha) / \
        torch.pow(torch.clamp(wmax, min=1e-12), 1.0 - alpha)
    log_s = torch.where(ok, torch.log(s), torch.zeros((), device=wf.device))
    denom = torch.clamp(ok.sum(), min=1).float()
    s = torch.exp(log_s - log_s.sum() / denom)
    return torch.where(ok, s, torch.ones((), device=wf.device))


def quantize_weight_int8_robust(w, act_amax, alpha: Optional[float] = 0.5,
                                outlier_k: int = 0,
                                out_dtype=torch.bfloat16) -> Dict[str, torch.Tensor]:
    """(in, out) weight + calibrated per-channel activation amax (K,) ->
    {"act_smooth", ["outlier_sel", "w_outlier",] "w_int8", "w_scale"}.

    ``act_smooth`` is 1/s, times a mask that zeroes the ``outlier_k``
    channels of largest smoothed amax; those channels pass through
    ``outlier_sel`` (K, k), a one-hot selection with 1/s folded in, and
    ``w_outlier`` (k, out), their smoothed weight rows, both ``out_dtype``."""
    wf = w.float()
    s = smooth_scales(act_amax, wf, alpha) if alpha is not None \
        else torch.ones((wf.shape[0],), dtype=torch.float32, device=wf.device)
    inv_s = torch.ones_like(s) / s
    w2 = wf * s[:, None]
    out: Dict[str, torch.Tensor] = {"act_smooth": inv_s}
    if outlier_k:
        amax = torch.as_tensor(act_amax, dtype=torch.float32, device=wf.device)
        idx = torch.topk(amax / s, outlier_k).indices
        mask = torch.ones((wf.shape[0],), dtype=torch.float32, device=wf.device)
        mask[idx] = 0.0
        out["act_smooth"] = inv_s * mask
        sel = torch.zeros((wf.shape[0], outlier_k), dtype=torch.float32, device=wf.device)
        sel[idx, torch.arange(outlier_k, device=wf.device)] = inv_s[idx]
        out["outlier_sel"] = sel.to(out_dtype)
        out["w_outlier"] = w2[idx, :].to(out_dtype)
        w2 = w2 * mask[:, None]
    out.update(quantize_weight_int8(w2))
    return out


def quantize_dense_params(p: Dict[str, Any]) -> Dict[str, Any]:
    out = dict(quantize_weight_int8(p["w"]))
    if "b" in p:
        out["b"] = p["b"]
    return out


# ------------------------------------------------------------ the product
_INT_MM_MIN_ROWS = 17  # torch._int_mm on CUDA takes more than 16 rows


def int8_matmul(xq: torch.Tensor, w_int8: torch.Tensor) -> torch.Tensor:
    """(N, K) int8 @ (K, M) int8 -> (N, M) int32, exact.  CUDA:
    ``torch._int_mm``, rows padded with zeros up to 17; a K or M that is
    not a multiple of 8 raises.  CPU: the product in fp64, exact (every
    partial sum is an integer below 2^53), as int32.  The weight must be
    column-major (:func:`int_mm_layout`): cuBLASLt refuses a row-major one
    at most row counts."""
    if not xq.is_cuda:
        return torch.mm(xq.double(), w_int8.double()).to(torch.int32)
    k, m = w_int8.shape
    if k % 8 or m % 8:
        raise ValueError(f"torch._int_mm needs the inner and output widths to be multiples "
                         f"of 8, got ({k}, {m})")
    if w_int8.stride(0) != 1:
        raise ValueError("the int8 weight must be column-major (ops.quant.int_mm_layout)")
    n = xq.shape[0]
    if n < _INT_MM_MIN_ROWS:
        xq = torch.cat([xq, xq.new_zeros((_INT_MM_MIN_ROWS - n, k))])
    launches["int_mm"] += 1
    return torch._int_mm(xq, w_int8)[:n]


def quantized_dense(p: Dict[str, Any], x):
    """y = (x_q @ w_q) · (row_scale ⊗ col_scale) [+ outliers], cast to
    x.dtype, + b.  The JAX package's order of operations, as it runs jitted:
    the row scale amax·fp32(1/127) clamped at 1e-12, then round(x·(sm/row_scale))
    or round(x/row_scale), clipped to ±127; the int32 product as fp32 times
    the row scale; times the column scale and plus the outlier channels'
    fp32 product in one fused multiply-add; the cast; the bias in x.dtype
    (for an fp32 x without outliers, the bias is that fused add's addend).
    A row's max |x| is exact in x's dtype, so it is taken there in one pass
    (the infinity norm), without an fp32 copy of x; with ``act_smooth``
    (>= 0) max |x·sm| is the same."""
    orig_shape = x.shape
    x2d = x.reshape(-1, orig_shape[-1])
    with torch.profiler.record_function("w8a8.quantize"):
        if "act_smooth" in p:
            sm = p["act_smooth"][None, :]
            amax = torch.linalg.vector_norm(x2d * sm, float("inf"), dim=-1, keepdim=True)
            row_scale = torch.clamp(_div127(amax), min=1e-12)
            xq = (x2d * (sm / row_scale)).round_()
        else:
            amax = torch.linalg.vector_norm(x2d, float("inf"), dim=-1, keepdim=True)
            row_scale = torch.clamp(_div127(amax.float()), min=1e-12)
            xq = (x2d / row_scale).round_()
        xq = xq.clamp_(-127, 127).to(torch.int8)
    with torch.profiler.record_function("w8a8.int_mm"):
        acc = int8_matmul(xq, p["w_int8"])
    # XLA contracts the column-scale product and the add after it into one
    # fused multiply-add: the outlier term's, or an fp32 result's bias
    bias_in_fma = "b" in p and "outlier_sel" not in p and x.dtype == torch.float32
    if "outlier_sel" in p:
        with torch.profiler.record_function("w8a8.outliers"):
            x_out = torch.matmul(x2d.to(p["outlier_sel"].dtype), p["outlier_sel"])
            addend = torch.matmul(x_out.to(p["w_outlier"].dtype).float(), p["w_outlier"].float())
    elif bias_in_fma:
        addend = p["b"].float()[None, :]
    with torch.profiler.record_function("w8a8.rescale"):
        y = acc * row_scale
        if "outlier_sel" in p or bias_in_fma:
            y = torch.addcmul(addend, y, p["w_scale"][None, :])
        else:
            y.mul_(p["w_scale"][None, :])
    y = y.to(x.dtype)
    if "b" in p and not bias_in_fma:
        y = y + p["b"].to(x.dtype)
    return y.reshape(orig_shape[:-1] + (p["w_int8"].shape[1],))


# ------------------------------------------------------------ model trees
def _amax_row(amax, i=None):
    """A calibration array (numpy or tensor) as an fp32 tensor: row ``i`` of
    a (L, K) one, a (K,) one as it is."""
    a = amax if torch.is_tensor(amax) else torch.from_numpy(np.asarray(amax))
    a = a.float()
    return a[i] if a.dim() == 2 else a


def _quantize_node(layer: Dict[str, Any], amax, alpha, k, consume: bool):
    """One dense {"w", ...} -> {"w_int8", "w_scale", ..., the other keys};
    with ``consume`` the float weight leaves ``layer`` too."""
    out = dict(layer)
    w = out.pop("w")
    if consume:
        layer.pop("w")
    if amax is not None:
        q = quantize_weight_int8_robust(w, amax.to(w.device), alpha=alpha, outlier_k=k)
    else:
        q = quantize_weight_int8(w)
    del w
    out.update(q)
    return out


def quantize_wan_dit_linears(params, groups=("ffn",), consume: bool = False,
                             act_amax: Optional[Dict[str, Any]] = None,
                             alpha: float = 0.5, outlier_k=0) -> Any:
    """Swap the block projections in ``groups`` (of "ffn", "self_attn",
    "cross_attn") of a Wan DiT to W8A8, block by block.  ``act_amax``:
    {group: {name: (L, K)}} calibration statistics
    (``training.quant_experiment.calibrate_wan_dit_act_amax``); a layer
    with statistics takes the outlier-robust form at ``alpha`` with
    ``outlier_k`` fallback channels (an int, or a dict such as
    {"ffn": {"fc2": 8}}), the others plain W8A8.  ``consume=True`` drops
    each float weight from ``params`` as its int8 copy is made."""
    def k_for(g, name):
        if isinstance(outlier_k, dict):
            gk = outlier_k.get(g, 0)
            return gk.get(name, 0) if isinstance(gk, dict) else gk
        return outlier_k

    params = dict(params)
    blocks = []
    for i, blk in enumerate(params["blocks"]):
        blk = dict(blk)
        for g in groups:
            grp = dict(blk[g])
            for name, layer in list(grp.items()):
                if not (isinstance(layer, dict) and "w" in layer):
                    continue
                amax = None if act_amax is None else act_amax.get(g, {}).get(name)
                grp[name] = _quantize_node(layer, None if amax is None else _amax_row(amax, i),
                                           alpha, k_for(g, name), consume)
            blk[g] = grp
        blocks.append(blk)
    params["blocks"] = blocks
    return params


def quantize_wan_dit_ffn(params) -> Any:
    """Swap the DiT FFN projections to W8A8."""
    return quantize_wan_dit_linears(params, groups=("ffn",))


_SKIP_SUBSTRINGS = ("mod", "norm", "adaln", "emb")


def _cal_at(cal, i):
    """Layer ``i`` of a stacked calibration tree (the JAX package's layout:
    (L, K) ``amax`` arrays at the dense nodes)."""
    if isinstance(cal, dict):
        return {k: (_amax_row(v, i) if k == "amax" else _cal_at(v, i)) for k, v in cal.items()}
    return cal


def quantize_blocks_tree(tree, skip_substrings=_SKIP_SUBSTRINGS, min_dim: int = 512,
                         consume: bool = False, act_amax: Any = None, alpha: float = 0.5,
                         outlier_k: int = 0) -> Any:
    """Swap every dense ({"w": 2-D}) of a block tree to W8A8, skipping keys
    that hold one of ``skip_substrings`` and layers under ``min_dim`` on
    either axis.  ``act_amax`` mirrors ``tree``: at a dense node an
    {"amax": (K,) [, "outlier_k": int]} dict; a list of blocks takes a
    list of such trees, or one stacked tree with (L, K) amax arrays."""
    def rec(node, cal=None):
        if isinstance(node, (list, tuple)):
            if isinstance(cal, (list, tuple)):
                cals = list(cal)
            elif isinstance(cal, dict):
                cals = [_cal_at(cal, i) for i in range(len(node))]
            else:
                cals = [None] * len(node)
            out = [rec(v, c) for v, c in zip(node, cals)]
            return type(node)(out) if isinstance(node, tuple) else out
        if not isinstance(node, dict):
            return node
        w = node.get("w")
        if torch.is_tensor(w) and w.dim() == 2 and min(w.shape) >= min_dim:
            amax = cal.get("amax") if isinstance(cal, dict) else None
            k = cal.get("outlier_k", outlier_k) if isinstance(cal, dict) else outlier_k
            return _quantize_node(node, None if amax is None else _amax_row(amax),
                                  alpha, k, consume)
        return {k: (v if any(s in k for s in skip_substrings)
                    else rec(v, cal.get(k) if isinstance(cal, dict) else None))
                for k, v in node.items()}

    return rec(tree, act_amax)


# image-DiT block sub-trees eligible for W8A8 (embedders and heads stay float)
_IMAGE_DIT_BLOCK_KEYS = ("double_blocks", "single_blocks", "blocks", "layers",
                         "noise_refiner", "context_refiner")

# the fit-driven skip list: the modulation linears are quantized too
_FIT_SKIP = ("norm", "emb")


def quantize_image_dit_params(params, block_keys=_IMAGE_DIT_BLOCK_KEYS, min_dim: int = 512,
                              consume: bool = False, skip_substrings=_SKIP_SUBSTRINGS,
                              act_amax: Any = None, alpha: float = 0.5,
                              outlier_k: int = 0) -> Any:
    """Swap the transformer-block projections of an image DiT (FLUX.1,
    Z-Image) to W8A8; embedders, modulation linears and the output head
    stay in their float dtype.  The models' ``_dense`` dispatch on
    "w_int8"."""
    params = dict(params)
    for k in block_keys:
        if k in params:
            params[k] = quantize_blocks_tree(
                params[k], min_dim=min_dim, consume=consume, skip_substrings=skip_substrings,
                act_amax=None if act_amax is None else act_amax.get(k), alpha=alpha,
                outlier_k=outlier_k)
    return params
