"""Wan video DiT (port of fairygen_tpu/models/wan/dit.py).

Params are a nested dict of tensors mirroring the JAX pytree; per-block
params are a list of dicts; dense weights are (d_in, d_out), applied as
``x @ w + b``, plus the layer's LoRA update when it carries a ``"lora"``
entry (``models/adapters.py``).  Each block runs the fused-norm form of the JAX package
(models/wan/dit.py:386-426): K1 ``layer_norm_modulate`` three times, the
self-attention through K2 (q and k) + K3/K4, the text cross-attention
through K2 (``rope=False``) + K4 with the per-prompt (k, v) hoisted by
:func:`precompute_cross_kv`; the I2V configs' CLIP image branch adds its own
(k_img, v_img) over the first 257 context tokens, through K2 + K4 beside
the text's.  The conditioning hooks of the Wan variants sit in
:func:`wan_dit_forward`: the motion controller's ``t_mod_bias``, the
camera adapter's ``control_camera_tokens`` added after the patch embed,
the Fun-Reference tokens (``has_ref_conv``) prepended as an extra leading
frame, the VACE hints added after their mapped blocks
(``models/wan/aux_models.py``) and the Wan-Animate adapter's pose tokens
and face-block residuals (``models/wan/animate.py``).  Those ops take
their hand-written kernels on CUDA tensors and their plain versions on
CPU tensors.  A head_dim other
than 128 (the tiny golden configs) runs the plain rms-norm -> RoPE ->
attention chain, as in the JAX package; on CUDA that is refused.

Training differentiates the same forward: K1 and the fused attention
entries carry their own gradients (``ops/``), and ``remat=True`` wraps each
block in ``torch.utils.checkpoint`` (the JAX package's ``jax.checkpoint``
per block).  ``remat="offload"`` is the same full remat with each block's
saved carry (its input) parked in pinned host memory until its recompute
(the JAX package's ``save_and_offload_only_these_names(["wan_block_carry"])``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..adapters import apply_adapter
from ...core.params import linear, to_tensors
from ...ops import quant
from ...ops.attention import LOG2E, attention
from ...ops.fused_norms import affine_rows, layer_norm_modulate
from ...ops.fused_qk import build_freqs_full, fused_q_attention, fused_qk_attention
from ...ops.norms import layer_norm, rms_norm
from ...ops.rope import build_freqs_grid, precompute_freqs_3d, rope_apply


@dataclasses.dataclass(frozen=True)
class WanDiTConfig:
    dim: int = 3072
    in_dim: int = 48
    ffn_dim: int = 14336
    out_dim: int = 48
    text_dim: int = 4096
    freq_dim: int = 256
    eps: float = 1e-6
    patch_size: Tuple[int, int, int] = (1, 2, 2)
    num_heads: int = 24
    num_layers: int = 30
    has_image_input: bool = False
    has_image_pos_emb: bool = False
    has_ref_conv: bool = False
    seperated_timestep: bool = False
    require_vae_embedding: bool = True
    require_clip_embedding: bool = True
    fuse_vae_embedding_in_latents: bool = False

    @property
    def head_dim(self):
        return self.dim // self.num_heads

    @staticmethod
    def ti2v_5b() -> "WanDiTConfig":
        """Wan2.2-TI2V-5B (upstream configs/model_configs.py, hash
        1f5ab7703c6fc803fdded85ff040c316)."""
        return WanDiTConfig(
            dim=3072, in_dim=48, ffn_dim=14336, out_dim=48, text_dim=4096,
            freq_dim=256, patch_size=(1, 2, 2), num_heads=24, num_layers=30,
            has_image_input=False, seperated_timestep=True,
            require_vae_embedding=False, require_clip_embedding=False,
            fuse_vae_embedding_in_latents=True,
        )


def _dense(p, x):
    """x @ w + b, or the W8A8 product of a quantized layer ("w_int8",
    ``ops/quant.py``); then the layer's hot LoRA.  Records x's statistics
    while a calibration tap is active."""
    if quant._ACT_TAP is not None:
        w = p.get("w", p.get("w_int8"))
        quant.record_activation_stats(f"dense_{x.shape[-1]}x{w.shape[-1]}", x)
    if "w_int8" in p:
        y = quant.quantized_dense(p, x)
    else:
        y = torch.matmul(x, p["w"])
        if "b" in p:
            y = y + p["b"]
    if "lora" in p:
        y = apply_adapter(y, x, p)
    return y


def sinusoidal_embedding_1d(dim: int, position: torch.Tensor) -> torch.Tensor:
    """cat([cos, sin]) sinusoid in fp32."""
    half = dim // 2
    pos = position.float()
    freqs = torch.pow(10000.0, -torch.arange(half, dtype=torch.float32,
                                              device=pos.device) / half)
    sinusoid = torch.outer(pos, freqs)
    return torch.cat([torch.cos(sinusoid), torch.sin(sinusoid)], dim=-1)


def _gelu_tanh(x):
    xf = x.float()
    y = 0.5 * xf * (1.0 + torch.tanh(0.7978845608028654 * (xf + 0.044715 * xf.pow(3))))
    return y.to(x.dtype)


def _q_gamma(p, hd):
    """The q norm gamma with the softmax scale and log2(e) folded in."""
    c = torch.tensor(hd ** -0.5 * LOG2E, dtype=torch.float32)
    return (p["norm_q"].float() * c.to(p["norm_q"].device)).to(p["norm_q"].dtype)


def _self_attention(p, x, freqs, freqs_full, num_heads, eps):
    b, s, d = x.shape
    hd = d // num_heads
    gamma_q = _q_gamma(p, hd)
    xq = _dense(p["q"], x)
    xk = _dense(p["k"], x)
    v = _dense(p["v"], x).reshape(b, s, num_heads, hd)
    if freqs_full is not None:
        o = fused_qk_attention(xq, xk, v, gamma_q, p["norm_k"], freqs_full, num_heads, eps)
    else:
        q = rope_apply(rms_norm(xq, gamma_q, eps).reshape(b, s, num_heads, hd), freqs)
        k = rope_apply(rms_norm(xk, p["norm_k"], eps).reshape(b, s, num_heads, hd), freqs)
        o = attention(q, k, v, prescaled=True, bounded_logits=True)
    return _dense(p["o"], o.reshape(b, s, d))


def _cross_attention(p, x, kv, num_heads, eps, fused, img_kv=None, ctx=None):
    """Text cross-attention on precomputed (k, v) (B, Lk, N, hd), or with
    ``kv`` None on (k, v) projected here from the embedded text ``ctx``
    (after q, the JAX package's order of the projections); ``img_kv`` adds
    the CLIP-image branch of the I2V configs."""
    b, s, d = x.shape
    hd = d // num_heads
    gamma_q = _q_gamma(p, hd)
    xq = _dense(p["q"], x)
    if kv is None:
        kv = _cross_kv(p, ctx, num_heads, eps)
    branches = [kv] + ([img_kv] if img_kv is not None else [])
    o = 0
    for k, v in branches:
        if fused:
            o = o + fused_q_attention(xq, k, v, gamma_q, num_heads, eps)
        else:
            q = rms_norm(xq, gamma_q, eps).reshape(b, s, num_heads, hd)
            o = o + attention(q, k, v, prescaled=True, bounded_logits=True)
    return _dense(p["o"], o.reshape(b, s, d))


def _expand_segments(m, seg: int, s: int):
    """(B, 2, D) rows -> (B, S, D): first ``seg`` tokens row 0, rest row 1."""
    b, _, d = m.shape
    return torch.cat([m[:, 0:1].expand(b, seg, d), m[:, 1:2].expand(b, s - seg, d)], dim=1)


def dit_block(p, x, t_mod, freqs, freqs_full, cfg: WanDiTConfig, cross_kv,
              seg: Optional[int] = None, img_kv=None, ctx=None):
    """One DiT block (upstream wan_video_dit.py:213-229) in the fused-norm
    form.  t_mod: (B, 1, 6, D) uniform or (B, 2, 6, D) two-segment rows with
    boundary ``seg``.  ``cross_kv`` None: the block projects its (k, v) from
    the embedded text ``ctx`` itself."""
    mod = (p["modulation"][None, None].float() + t_mod.float()).to(x.dtype)
    rows = mod if mod.shape[1] == 2 else torch.cat([mod, mod], dim=1)
    if seg is not None:
        g_msa = _expand_segments(mod[:, :, 2], seg, x.shape[1])
        g_mlp = _expand_segments(mod[:, :, 5], seg, x.shape[1])
    else:
        g_msa, g_mlp = mod[:, 0, 2][:, None], mod[:, 0, 5][:, None]
    seg_val = 0 if seg is None else int(seg)
    fused = freqs_full is not None

    y = layer_norm_modulate(x, rows[:, :, 0].contiguous(), rows[:, :, 1].contiguous(),
                            seg_val, cfg.eps)
    x = x + g_msa * _self_attention(p["self_attn"], y, freqs, freqs_full,
                                    cfg.num_heads, cfg.eps)
    sh3, sc3 = affine_rows(p["norm3"]["w"], p["norm3"]["b"], x.shape[0])
    y = layer_norm_modulate(x, sh3, sc3, 0, cfg.eps)
    x = x + _cross_attention(p["cross_attn"], y, cross_kv, cfg.num_heads, cfg.eps,
                             fused, img_kv, ctx)
    y = layer_norm_modulate(x, rows[:, :, 3].contiguous(), rows[:, :, 4].contiguous(),
                            seg_val, cfg.eps)
    ff = _dense(p["ffn"]["fc2"], _gelu_tanh(_dense(p["ffn"]["fc1"], y)))
    return x + g_mlp * ff


def text_embedding(params, ctx):
    h = _dense(params["text_embed"]["fc1"], ctx)
    return _dense(params["text_embed"]["fc2"], _gelu_tanh(h))


def _cross_kv(ca, ctx, num_heads, eps):
    """One block's text (k, v), each (B, Lk, N, hd), from the embedded text."""
    b, lk, d = ctx.shape
    k = rms_norm(_dense(ca["k"], ctx), ca["norm_k"], eps)
    v = _dense(ca["v"], ctx)
    return (k.reshape(b, lk, num_heads, d // num_heads),
            v.reshape(b, lk, num_heads, d // num_heads))


def precompute_cross_kv(params, cfg: WanDiTConfig, context):
    """Per-block cross-attention (k, v), each (B, Lk, N, hd), over a fixed
    prompt context — step-independent, so the pipeline computes them once
    per prompt (same ops, same order as in the block)."""
    ctx = text_embedding(params, context)
    return [_cross_kv(blk["cross_attn"], ctx, cfg.num_heads, cfg.eps)
            for blk in params["blocks"]]


def img_embedding(params, clip_feature):
    """The CLIP feature MLP (upstream wan_video_dit.py:232-249), with the
    FLF2V position embedding ``pos`` added first where the model has one."""
    pe = params["img_emb"]
    x = clip_feature
    if "pos" in pe:
        x = x + pe["pos"]
    x = layer_norm(x, 1e-5, pe["norm1"]["w"], pe["norm1"]["b"])
    x = _dense(pe["fc1"], x)
    x = F.gelu(x.float()).to(x.dtype)
    x = _dense(pe["fc2"], x)
    return layer_norm(x, 1e-5, pe["norm2"]["w"], pe["norm2"]["b"])


IMAGE_TOKENS = 257  # the cross-attention's image share of [image, text] context


def split_image_context(params, ctx, clip_feature=None):
    """The I2V configs' cross-attention context as the JAX package (and
    upstream) splits it: [embedded CLIP tokens, embedded text ``ctx``], its
    first 257 rows the image branch's and the rest the text branch's.
    Returns (image tokens, text tokens); with 257 CLIP tokens the text
    tokens are ``ctx`` itself."""
    if clip_feature is not None:
        ctx = torch.cat([img_embedding(params, clip_feature), ctx], dim=1)
    return ctx[:, :IMAGE_TOKENS], ctx[:, IMAGE_TOKENS:]


def text_kv_hoistable(cfg: WanDiTConfig, clip_feature) -> bool:
    """Whether :func:`precompute_cross_kv` of the text alone gives the
    blocks' text (k, v): always, but for an image-input config, whose text
    branch starts after the 257th context row, unless 257 CLIP tokens are
    given to fill the image branch."""
    return not cfg.has_image_input or (clip_feature is not None and cfg.require_clip_embedding
                                       and clip_feature.shape[1] == IMAGE_TOKENS)


def _image_cross_kv(params, cfg: WanDiTConfig, img):
    """Per-block (k_img, v_img) of the image branch (I2V configs) over the
    embedded image tokens."""
    b, li, _ = img.shape
    out = []
    for blk in params["blocks"]:
        ca = blk["cross_attn"]
        k = rms_norm(_dense(ca["k_img"], img), ca["norm_k_img"], cfg.eps)
        v = _dense(ca["v_img"], img)
        out.append((k.reshape(b, li, cfg.num_heads, cfg.head_dim),
                    v.reshape(b, li, cfg.num_heads, cfg.head_dim)))
    return out


def head_forward(p, x, t, cfg: WanDiTConfig, seg=None):
    """Modulated output head.  t: (B, D) or (B, 2, D) two-segment rows."""
    if t.dim() == 2:
        t = t[:, None]
    mod = (p["modulation"][None, None].float() + t[:, :, None].float()).to(x.dtype)
    shift, scale = mod[:, :, 0], mod[:, :, 1]
    if seg is not None:
        shift = _expand_segments(shift, seg, x.shape[1])
        scale = _expand_segments(scale, seg, x.shape[1])
    y = layer_norm(x, cfg.eps) * (1 + scale) + shift
    return _dense(p, y)


def patchify(params, cfg: WanDiTConfig, x):
    """(B, C, F, H, W) -> tokens (B, f·h·w, D), grid (f, h, w); patch
    pixels ordered (c, kt, kh, kw)."""
    b, c, F_, H, W = x.shape
    pt, ph, pw = cfg.patch_size
    f, h, w = F_ // pt, H // ph, W // pw
    x = x.reshape(b, c, f, pt, h, ph, w, pw)
    x = x.permute(0, 2, 4, 6, 1, 3, 5, 7).reshape(b, f * h * w, c * pt * ph * pw)
    return _dense(params["patch_embed"], x), (f, h, w)


def unpatchify(x, grid, cfg: WanDiTConfig):
    """(B, f·h·w, out·pt·ph·pw) -> (B, C_out, F, H, W); channel packing
    (pt, ph, pw, c)."""
    f, h, w = grid
    pt, ph, pw = cfg.patch_size
    b = x.shape[0]
    x = x.reshape(b, f, h, w, pt, ph, pw, cfg.out_dim)
    x = x.permute(0, 7, 1, 4, 2, 5, 3, 6)
    return x.reshape(b, cfg.out_dim, f * pt, h * ph, w * pw)


def time_embedding(params, cfg: WanDiTConfig, timestep):
    """timestep (B,) or (B, 2) -> t (..., D), t_mod (..., 6, D)."""
    emb = sinusoidal_embedding_1d(cfg.freq_dim, timestep.reshape(-1))
    emb = emb.reshape(timestep.shape + (cfg.freq_dim,)).to(params["time_embed"]["fc1"]["w"].dtype)
    h = _dense(params["time_embed"]["fc1"], emb)
    h = F.silu(h.float()).to(h.dtype)
    t = _dense(params["time_embed"]["fc2"], h)
    tp = F.silu(t.float()).to(t.dtype)
    t_mod = _dense(params["time_proj"], tp)
    return t, t_mod.reshape(t_mod.shape[:-1] + (6, cfg.dim))


class _Parked:
    """A saved carry in host memory and what brings it back."""

    def __init__(self, host, done, device):
        self.host, self.done, self.device = host, done, device


class offload_saved_carry:
    """``saved_tensors_hooks`` around one block's checkpoint that park the
    tensor the checkpoint saves for ``carry`` (the block input it recomputes
    from) in host memory and bring it back when the recompute unpacks it;
    every other saved tensor passes.  A CUDA carry is copied into pinned
    memory on ``stream`` (a side stream, so the block runs while it copies;
    ``record_stream`` keeps its memory from reuse until the copy ends) and
    returns on the current stream after the copy's event; a CPU carry is
    copied (it is in host memory already).  ``parked`` counts the carries
    parked.

    The carry is known by its address, shape, dtype and device, not held:
    a saved tensor keeps its pack hook (and so this object) alive until the
    backward pass, and a held carry would stay on the card with it."""

    def __init__(self, carry, stream=None):
        self.key, self.stream, self.parked = self._key(carry), stream, 0
        self._hooks = torch.autograd.graph.saved_tensors_hooks(self._pack, self._unpack)

    @staticmethod
    def _key(t):
        return t.data_ptr(), tuple(t.shape), t.dtype, t.device

    def _pack(self, t):
        if self._key(t) != self.key:
            return t
        self.parked += 1
        if not t.is_cuda:
            return _Parked(t.detach().clone(), None, t.device)
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        self.stream.wait_stream(torch.cuda.current_stream(t.device))
        with torch.cuda.stream(self.stream):
            host.copy_(t.detach(), non_blocking=True)
            done = torch.cuda.Event()
            done.record(self.stream)
        t.record_stream(self.stream)
        return _Parked(host, done, t.device)

    @staticmethod
    def _unpack(h):
        if not isinstance(h, _Parked):
            return h
        if h.done is None:
            return h.host
        torch.cuda.current_stream(h.device).wait_event(h.done)
        return h.host.to(h.device, non_blocking=True)

    def __enter__(self):
        self._hooks.__enter__()
        return self

    def __exit__(self, *exc):
        return self._hooks.__exit__(*exc)


def reference_tokens(params, reference_latents):
    """The Fun-Reference image latent (B, C, h, w) or (B, C, 1, h, w) ->
    tokens (B, h/2·w/2, D) through ``ref_conv`` (a 2x2 stride-2 conv as a
    dense over (c, kh, kw) patches)."""
    r = reference_latents[:, :, 0] if reference_latents.dim() == 5 else reference_latents
    rb, rc, rh, rw = r.shape
    r = r.reshape(rb, rc, rh // 2, 2, rw // 2, 2).permute(0, 2, 4, 1, 3, 5)
    return _dense(params["ref_conv"], r.reshape(rb, (rh // 2) * (rw // 2), rc * 4))


def wan_dit_forward(params, cfg: WanDiTConfig, latents, timestep, context=None, *,
                    y=None, clip_feature=None, fuse_vae_embedding_in_latents: bool = False,
                    cross_kv=None, remat=False, tea_cache_state=None, tea_cache_opts=None,
                    t_mod_bias=None, control_camera_tokens=None, reference_latents=None,
                    vace_hints=None, vace_scale: float = 1.0, vace_params=None, vace_cfg=None,
                    vace_context=None, animate_params=None, animate_cfg=None, pose_latents=None,
                    face_pixel_values=None):
    """Denoiser forward (upstream model_fn_wan_video, wan_video.py:1122-1388,
    text / first-frame / I2V-y conditioning).  latents (B, C, F, H, W);
    timestep (B,); context (B, L, text_dim) or ``cross_kv`` from
    :func:`precompute_cross_kv`.  ``remat=True`` recomputes each block in
    the backward pass from its input; ``remat="offload"`` also keeps that
    input in pinned host memory in between (:class:`offload_saved_carry`).
    Returns (B, out_dim, F, H, W); with ``tea_cache_state``
    (``utils.tea_cache``; ``tea_cache_opts``: model_id, rel_l1_thresh,
    num_inference_steps) the block stack runs or is skipped by the TeaCache
    gate, and the call returns (output, new state).

    Conditioning: ``t_mod_bias`` (B, 6, D) is added to the block
    modulation (the motion controller); ``control_camera_tokens`` (B, S, D)
    to the patch tokens (the camera adapter); with ``has_ref_conv``,
    ``reference_latents`` become a leading frame of tokens, stripped again
    before the output; ``vace_hints`` ({block index: (B, S, D)}) are added
    after their blocks times ``vace_scale``, or computed here from
    ``vace_context`` (B, vace_in_dim, F, H, W) by the VACE branch
    ``vace_params`` / ``vace_cfg`` over the embedded ``context``; with the
    Wan-Animate adapter ``animate_params`` / ``animate_cfg``, the
    ``pose_latents`` (B, C, F - 1, H, W) go into the patch tokens of frames
    1.. and the face video ``face_pixel_values`` (B, 3, T, S, S) into
    motion tokens that a face block reads after every ``adapter_stride``-th
    block (``models/wan/animate.py``; not with TeaCache, as in the JAX
    package)."""
    if remat not in (False, True, "offload"):
        raise ValueError(f"remat must be False, True or 'offload', got {remat!r}")
    b, _, _, H, W = latents.shape
    _, ph, pw = cfg.patch_size
    if latents.is_cuda and cfg.head_dim != 128:
        raise ValueError(f"the CUDA kernels need head_dim 128, got {cfg.head_dim}")

    seg = None
    if cfg.seperated_timestep and fuse_vae_embedding_in_latents:
        # first-frame tokens get t = 0, the rest t: embed the two values
        # and select per segment inside the blocks
        seg = (H // ph) * (W // pw)
        uniq_t = torch.stack([torch.zeros_like(timestep, dtype=latents.dtype),
                              timestep.to(latents.dtype)], dim=1)
        t, t_mod = time_embedding(params, cfg, uniq_t)
    else:
        t, t_mod = time_embedding(params, cfg, timestep)
        t_mod = t_mod[:, None]
        if t_mod_bias is not None:
            t_mod = t_mod + t_mod_bias[:, None]

    ctx = None
    if cross_kv is None or vace_context is not None:
        ctx = text_embedding(params, context)
    if cross_kv is not None and not text_kv_hoistable(cfg, clip_feature):
        raise ValueError("precomputed cross_kv are the text branch's only where 257 CLIP "
                         "tokens fill the image branch")
    vace_ctx = ctx  # the VACE blocks' context: [image tokens, text] for an image DiT
    img_kv = [None] * cfg.num_layers
    if cfg.has_image_input:
        clip = clip_feature if cfg.require_clip_embedding else None
        if cross_kv is None:
            img, ctx = split_image_context(params, ctx, clip)
        else:  # the text branch is the hoisted (k, v)'s
            img = img_embedding(params, clip)
        img_kv = _image_cross_kv(params, cfg, img)
        if vace_context is not None:
            vace_ctx = torch.cat([img, ctx], dim=1)
    if cross_kv is None:
        cross_kv = [None] * cfg.num_layers

    x = latents
    if y is not None and cfg.require_vae_embedding:
        x = torch.cat([x, y], dim=1)
    x, grid = patchify(params, cfg, x)
    if control_camera_tokens is not None:
        x = x + control_camera_tokens.to(x.dtype)
    motion_vec = None
    if animate_params is not None and pose_latents is not None and face_pixel_values is not None:
        from .animate import animate_after_patch_embedding, animate_after_transformer_block

        if tea_cache_state is not None:
            raise ValueError("TeaCache does not run with the Animate adapter")
        x, motion_vec = animate_after_patch_embedding(animate_params, animate_cfg, x, grid,
                                                      pose_latents, face_pixel_values)
    n_ref = 0
    if reference_latents is not None and cfg.has_ref_conv:
        ref = reference_tokens(params, reference_latents)
        n_ref = ref.shape[1]
        x = torch.cat([ref, x], dim=1)
        grid = (grid[0] + 1, grid[1], grid[2])
    freqs = build_freqs_grid(precompute_freqs_3d(cfg.head_dim), *grid, device=x.device)
    freqs_full = build_freqs_full(freqs) if cfg.head_dim == 128 else None
    side = torch.cuda.Stream(x.device) if remat == "offload" and x.is_cuda else None
    if vace_context is not None:
        from .aux_models import vace_forward

        vace_hints = vace_forward(vace_params, vace_cfg, x, vace_context, vace_ctx, t_mod,
                                  freqs, seg=seg)
    hints = vace_hints or {}

    def blocks(x):
        for i, blk in enumerate(params["blocks"]):
            args = (blk, x, t_mod, freqs, freqs_full, cfg, cross_kv[i], seg, img_kv[i], ctx)
            if remat == "offload":
                with offload_saved_carry(x, side):
                    x = checkpoint(dit_block, *args, use_reentrant=False)
            elif remat:
                x = checkpoint(dit_block, *args, use_reentrant=False)
            else:
                x = dit_block(*args)
            if i in hints:
                x = x + hints[i] * vace_scale
            if motion_vec is not None:
                x = animate_after_transformer_block(animate_params, animate_cfg, i, x,
                                                    motion_vec)
        return x

    if tea_cache_state is not None:
        from ...utils.tea_cache import tea_cache_blocks

        x, new_state = tea_cache_blocks(tea_cache_state, x, t_mod, blocks, **tea_cache_opts)
    else:
        x = blocks(x)
    x = head_forward(params["head"], x, t, cfg, seg=seg)
    if n_ref:  # the reference frame's tokens go before the output
        x = x[:, n_ref:]
        grid = (grid[0] - 1, grid[1], grid[2])
    out = unpatchify(x, grid, cfg)
    return (out, new_state) if tea_cache_state is not None else out


# ------------------------------------------------------------------ converter
def convert_dit_state_dict(sd: Dict[str, Any], cfg: WanDiTConfig, dtype=None, device="cuda"):
    """Upstream (civitai layout) DiT state dict of numpy arrays -> port
    params on ``device``: patch_embedding / text_embedding.{0,2} /
    time_embedding.{0,2} / time_projection.1 / blocks.N.* / head.head, and
    img_emb.proj.* (and img_emb.emb_pos) for the image-input configs, and
    ref_conv for the Fun-Reference configs."""
    def g(name):
        return np.asarray(sd[name])

    D = cfg.dim
    pe_w = g("patch_embedding.weight")  # (D, C, pt, ph, pw)
    params: Dict[str, Any] = {
        "patch_embed": {"w": pe_w.transpose(1, 2, 3, 4, 0).reshape(-1, D),
                        "b": g("patch_embedding.bias")},
        "text_embed": {"fc1": linear(sd, "text_embedding.0"),
                       "fc2": linear(sd, "text_embedding.2")},
        "time_embed": {"fc1": linear(sd, "time_embedding.0"),
                       "fc2": linear(sd, "time_embedding.2")},
        "time_proj": linear(sd, "time_projection.1"),
        "head": {**linear(sd, "head.head"), "modulation": g("head.modulation").reshape(2, D)},
    }

    def attn(prefix, img=False):
        p = {k: linear(sd, f"{prefix}.{k}") for k in ("q", "k", "v", "o")}
        p["norm_q"] = g(prefix + ".norm_q.weight")
        p["norm_k"] = g(prefix + ".norm_k.weight")
        if img:
            p["k_img"] = linear(sd, prefix + ".k_img")
            p["v_img"] = linear(sd, prefix + ".v_img")
            p["norm_k_img"] = g(prefix + ".norm_k_img.weight")
        return p

    params["blocks"] = [
        {"self_attn": attn(f"blocks.{i}.self_attn"),
         "cross_attn": attn(f"blocks.{i}.cross_attn", img=cfg.has_image_input),
         "norm3": {"w": g(f"blocks.{i}.norm3.weight"), "b": g(f"blocks.{i}.norm3.bias")},
         "ffn": {"fc1": linear(sd, f"blocks.{i}.ffn.0"), "fc2": linear(sd, f"blocks.{i}.ffn.2")},
         "modulation": g(f"blocks.{i}.modulation").reshape(6, D)}
        for i in range(cfg.num_layers)
    ]
    if cfg.has_image_input:
        params["img_emb"] = {
            "norm1": {"w": g("img_emb.proj.0.weight"), "b": g("img_emb.proj.0.bias")},
            "fc1": linear(sd, "img_emb.proj.1"),
            "fc2": linear(sd, "img_emb.proj.3"),
            "norm2": {"w": g("img_emb.proj.4.weight"), "b": g("img_emb.proj.4.bias")},
        }
        if cfg.has_image_pos_emb:
            params["img_emb"]["pos"] = g("img_emb.emb_pos")
    if cfg.has_ref_conv:
        rc = g("ref_conv.weight")  # (D, 16, 2, 2)
        params["ref_conv"] = {"w": rc.transpose(1, 2, 3, 0).reshape(-1, D),
                              "b": g("ref_conv.bias")}
    return to_tensors(params, device, dtype)
