"""The SDXL and SD1.5 UNets and their BrushNets in one functional module
(port of fairygen_tpu/models/sdxl/unet2d.py).

* SDXL's and SD1.5's ``UNet2DConditionModel`` (SD1.5: four levels, a
  trailing ``DownBlock2D`` and a leading ``UpBlock2D``, 8 heads at every
  level, so head dims 40 / 80 / 160, no ``text_time`` embedding, 1x1-conv
  projections in its checkpoints), with the BrushNet fork's per-sub-block
  residual consumption (``down_block_add_samples`` / ``mid_block_add_sample``
  / ``up_block_add_samples``, taken in the fork's pop(0) order) and the
  mask-gated LoRA / DoRA adapters inside the attention projections.
* ``BrushNetModel``: the dual-branch inpainting clone without cross
  attention, a 9-channel ``conv_in_condition`` and one zero conv per
  sub-block.

Channels-first (B, C, H, W) throughout, conv weights (C_out, C_in, kh, kw),
dense weights (d_in, d_out); the add samples that :func:`brushnet_forward`
returns and :func:`unet2d_forward` takes are channels-first too (the JAX
package's are NHWC).  Convolutions, GroupNorm, LayerNorm and GEGLU are
plain PyTorch, as they are plain XLA in the JAX package; attention goes
through ``ops.attention`` (on the card, K4's max and masked forms and K5 at
head dim 64, and at SD1.5's 8 (BrushNet's mid attention), 40, 80 and 160;
with a gradient in fp32, the Style-DoRA train step's, K6a-c's fp32 forms).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ...core.params import Init, generator, linear, to_tensors
from ...device import resolve_device
from ...ops.attention import attention
from ..adapters import apply_adapter
from .clip import _ln
from .vae import group_norm, weight_bias


@dataclasses.dataclass(frozen=True)
class UNet2DConfig:
    in_channels: int = 4
    out_channels: int = 4
    block_out_channels: Tuple[int, ...] = (320, 640, 1280)
    down_block_types: Tuple[str, ...] = ("DownBlock2D", "CrossAttnDownBlock2D",
                                         "CrossAttnDownBlock2D")
    up_block_types: Tuple[str, ...] = ("CrossAttnUpBlock2D", "CrossAttnUpBlock2D", "UpBlock2D")
    mid_block_type: Optional[str] = "UNetMidBlock2DCrossAttn"
    layers_per_block: int = 2
    transformer_layers_per_block: Tuple[int, ...] = (1, 2, 10)
    num_attention_heads: Tuple[int, ...] = (5, 10, 20)
    attention_head_dim: Optional[int] = None  # the plain UNetMidBlock2D attention
    cross_attention_dim: int = 2048
    norm_num_groups: int = 32
    norm_eps: float = 1e-5
    addition_embed_type: Optional[str] = "text_time"  # None | "text_time"
    addition_time_embed_dim: int = 256
    projection_class_embeddings_input_dim: int = 2816
    flip_sin_to_cos: bool = True
    freq_shift: int = 0
    conditioning_channels: int = 0  # BrushNet: > 0, conv_in_condition takes the concat

    @staticmethod
    def sdxl_base() -> "UNet2DConfig":
        return UNet2DConfig()

    @staticmethod
    def sd15_base() -> "UNet2DConfig":
        """The SD1.5 UNet2DConditionModel (pipeline_brushnet.py's)."""
        return UNet2DConfig(block_out_channels=(320, 640, 1280, 1280),
                            down_block_types=("CrossAttnDownBlock2D",) * 3 + ("DownBlock2D",),
                            up_block_types=("UpBlock2D",) + ("CrossAttnUpBlock2D",) * 3,
                            transformer_layers_per_block=(1, 1, 1, 1),
                            num_attention_heads=(8, 8, 8, 8), cross_attention_dim=768,
                            addition_embed_type=None)

    @staticmethod
    def brushnet_sd15() -> "UNet2DConfig":
        """BrushNet for SD1.5: plain blocks, no cross attention, a plain mid
        attention of head dim 8 where the params carry one."""
        return UNet2DConfig(block_out_channels=(320, 640, 1280, 1280),
                            down_block_types=("DownBlock2D",) * 4,
                            up_block_types=("UpBlock2D",) * 4, mid_block_type="UNetMidBlock2D",
                            transformer_layers_per_block=(0, 0, 0, 0),
                            num_attention_heads=(8, 8, 8, 8), attention_head_dim=8,
                            cross_attention_dim=768, addition_embed_type=None,
                            conditioning_channels=5)

    @staticmethod
    def brushnet_sdxl() -> "UNet2DConfig":
        """BrushNet-SDXL: plain blocks, no cross attention, one plain mid
        attention of head dim 64."""
        return UNet2DConfig(down_block_types=("DownBlock2D",) * 3,
                            up_block_types=("UpBlock2D",) * 3, mid_block_type="UNetMidBlock2D",
                            transformer_layers_per_block=(0, 0, 0), attention_head_dim=64,
                            conditioning_channels=5)


# ----------------------------------------------------------------- primitives
def _conv2d(p, x, stride=1, padding=1):
    return F.conv2d(x, p["w"].to(x.dtype), p["b"].to(x.dtype), stride=stride, padding=padding)


def _dense(p, x, mask=None):
    y = torch.matmul(x, p["w"].to(x.dtype))
    if "b" in p:
        y = y + p["b"].to(x.dtype)
    if "lora" in p:
        y = apply_adapter(y, x, p, mask=mask)
    return y


def _silu(x):
    return F.silu(x.float()).to(x.dtype)


def timestep_embedding(timesteps, dim, flip_sin_to_cos=True, freq_shift=0, max_period=10000.0):
    """diffusers' ``get_timestep_embedding`` in fp32."""
    half = dim // 2
    exponent = -math.log(max_period) * torch.arange(half, dtype=torch.float32,
                                                    device=timesteps.device)
    exponent = exponent / (half - freq_shift)
    emb = timesteps.float()[:, None] * torch.exp(exponent)[None]
    sin, cos = torch.sin(emb), torch.cos(emb)
    return torch.cat([cos, sin] if flip_sin_to_cos else [sin, cos], -1)


def resnet_block(p, x, emb, cfg: UNet2DConfig):
    h = _conv2d(p["conv1"], _silu(group_norm(x, p["norm1"], cfg.norm_num_groups, cfg.norm_eps)))
    h = h + _dense(p["time_emb_proj"], _silu(emb))[:, :, None, None]
    h = _conv2d(p["conv2"], _silu(group_norm(h, p["norm2"], cfg.norm_num_groups, cfg.norm_eps)))
    if "conv_shortcut" in p:
        x = _conv2d(p["conv_shortcut"], x, padding=0)
    return x + h


# ------------------------------------------------------------------ attention
def _mha(q_p, k_p, v_p, o_p, x, ctx, heads, mask_q=None, mask_kv=None):
    b, n, _ = x.shape
    q = _dense(q_p, x, mask=mask_q)
    k = _dense(k_p, ctx, mask=mask_kv)
    v = _dense(v_p, ctx, mask=mask_kv)
    hd = q.shape[-1] // heads
    o = attention(q.reshape(b, n, heads, hd), k.reshape(b, ctx.shape[1], heads, hd),
                  v.reshape(b, ctx.shape[1], heads, hd))
    return _dense(o_p, o.reshape(b, n, heads * hd), mask=mask_q)


def transformer_block(p, x, ctx, heads, mask=None):
    """BasicTransformerBlock: LN → self-attention, LN → cross-attention,
    LN → GEGLU feed-forward (exact-erf GELU).  ``mask`` (B, N, 1) gates the
    adapters of q/out and of the self-attention's k/v; the cross-attention's
    k/v (text tokens) are not gated."""
    a1 = p["attn1"]
    h = _ln(p["norm1"], x)
    x = x + _mha(a1["to_q"], a1["to_k"], a1["to_v"], a1["to_out"], h, h, heads, mask_q=mask,
                 mask_kv=mask)
    a2 = p["attn2"]
    h = _ln(p["norm2"], x)
    x = x + _mha(a2["to_q"], a2["to_k"], a2["to_v"], a2["to_out"], h, ctx, heads, mask_q=mask)
    a, gate = _dense(p["ff_proj"], _ln(p["norm3"], x)).chunk(2, -1)
    return x + _dense(p["ff_out"], a * F.gelu(gate.float()).to(x.dtype))


def _resize_mask(mask, h, w):
    """(B, 1, Hm, Wm), (B, Hm, Wm, 1) or (B, Hm, Wm) -> (B, h·w, 1), nearest."""
    if mask.dim() == 4:
        mask = mask[:, 0] if mask.shape[1] == 1 else mask[..., 0]
    b, hm, wm = mask.shape
    ih = torch.arange(h, device=mask.device) * hm // h
    iw = torch.arange(w, device=mask.device) * wm // w
    return mask[:, ih][:, :, iw].reshape(b, h * w, 1)


def transformer2d(p, x, ctx, heads, cfg: UNet2DConfig, mask_latents=None):
    """Transformer2DModel with ``use_linear_projection`` (SDXL)."""
    b, c, h, w = x.shape
    y = group_norm(x, p["norm"], cfg.norm_num_groups, 1e-6)
    y = _dense(p["proj_in"], y.permute(0, 2, 3, 1).reshape(b, h * w, c))
    mask = None if mask_latents is None else _resize_mask(mask_latents, h, w)
    for blk in p["blocks"]:
        y = transformer_block(blk, y, ctx, heads, mask=mask)
    y = _dense(p["proj_out"], y)
    return y.reshape(b, h, w, c).permute(0, 3, 1, 2) + x


def attention_block_plain(p, x, head_dim, cfg: UNet2DConfig):
    """The plain UNetMidBlock2D attention: GroupNorm, q/k/v, residual."""
    b, c, h, w = x.shape
    y = group_norm(x, p["group_norm"], cfg.norm_num_groups, cfg.norm_eps)
    y = y.permute(0, 2, 3, 1).reshape(b, h * w, c)
    o = _mha(p["to_q"], p["to_k"], p["to_v"], p["to_out"], y, y, c // head_dim)
    return x + o.reshape(b, h, w, c).permute(0, 3, 1, 2)


# --------------------------------------------------------------------- blocks
class _Popper:
    """Adds the add samples in the fork's pop(0) order; None: nothing."""

    def __init__(self, items: Optional[List]):
        self.items = list(items) if items is not None else None

    def __call__(self, x):
        if self.items is None:
            return x
        return x + self.items.pop(0).to(x.dtype)


def _upsample(p, x):
    return _conv2d(p["conv"], F.interpolate(x, scale_factor=2.0, mode="nearest"))


# ------------------------------------------------------------------- the UNet
def unet2d_forward(params, cfg: UNet2DConfig, sample, timestep, encoder_hidden_states=None, *,
                   text_embeds=None, time_ids=None, down_block_add_samples=None,
                   mid_block_add_sample=None, up_block_add_samples=None, mask_latents=None,
                   return_res_samples=False, brushnet_cond=None):
    """sample (B, C, H, W), timestep (B,) or scalar, encoder_hidden_states
    (B, L, cross_dim); ``text_embeds`` (B, 1280) and ``time_ids`` (B, 6) for
    the text_time embedding.  The add samples (channels-first, from
    :func:`brushnet_forward`) are added after each sub-block.
    ``return_res_samples``: return the per-sub-block features (down list,
    mid, up list) instead of the output (the BrushNet body);
    ``brushnet_cond`` (B, cond_ch, H, W) feeds ``conv_in_condition``."""
    x = sample
    timestep = torch.as_tensor(timestep, device=x.device)
    if timestep.dim() == 0:
        timestep = timestep.expand(x.shape[0])

    # 1. time and added embeddings
    t_emb = timestep_embedding(timestep, cfg.block_out_channels[0], cfg.flip_sin_to_cos,
                               cfg.freq_shift).to(x.dtype)
    te = params["time_embedding"]
    emb = _dense(te["linear_2"], _silu(_dense(te["linear_1"], t_emb)))
    if cfg.addition_embed_type == "text_time":
        tid = timestep_embedding(time_ids.reshape(-1), cfg.addition_time_embed_dim,
                                 cfg.flip_sin_to_cos, cfg.freq_shift)
        tid = tid.reshape(text_embeds.shape[0], -1).to(x.dtype)
        add = torch.cat([text_embeds.to(x.dtype), tid], -1)
        ae = params["add_embedding"]
        emb = emb + _dense(ae["linear_2"], _silu(_dense(ae["linear_1"], add)))

    # 2. conv in
    if brushnet_cond is not None:
        x = _conv2d(params["conv_in_condition"], torch.cat([x, brushnet_cond.to(x.dtype)], 1))
    else:
        x = _conv2d(params["conv_in"], x)

    add_down, add_up = _Popper(down_block_add_samples), _Popper(up_block_add_samples)
    # the fork stores the conv_in skip BEFORE its add sample is added; inside
    # the blocks the add comes before the skip is collected
    res_stack = [x]
    x = add_down(x)

    # 3. down
    for i in range(len(cfg.down_block_types)):
        bp = params["down_blocks"][i]
        for j in range(len(bp["resnets"])):
            x = resnet_block(bp["resnets"][j], x, emb, cfg)
            if "attentions" in bp:
                x = transformer2d(bp["attentions"][j], x, encoder_hidden_states,
                                  cfg.num_attention_heads[i], cfg, mask_latents)
            x = add_down(x)
            res_stack.append(x)
        if "downsamplers" in bp:
            x = add_down(_conv2d(bp["downsamplers"]["conv"], x, stride=2))
            res_stack.append(x)
    emitted = list(res_stack) if return_res_samples else None

    # 4. mid
    if cfg.mid_block_type is not None:
        mp = params["mid_block"]
        x = resnet_block(mp["resnets"][0], x, emb, cfg)
        for j, ap in enumerate(mp.get("attentions", [])):
            if cfg.mid_block_type == "UNetMidBlock2DCrossAttn":
                x = transformer2d(ap, x, encoder_hidden_states, cfg.num_attention_heads[-1], cfg,
                                  mask_latents)
            else:
                x = attention_block_plain(ap, x, cfg.attention_head_dim, cfg)
            x = resnet_block(mp["resnets"][j + 1], x, emb, cfg)
    if mid_block_add_sample is not None:
        x = x + mid_block_add_sample.to(x.dtype)
    mid_emitted = x

    # 5. up
    up_emitted = []
    for i in range(len(cfg.up_block_types)):
        bp = params["up_blocks"][i]
        heads = cfg.num_attention_heads[len(cfg.block_out_channels) - 1 - i]
        n_res = len(bp["resnets"])
        skips = res_stack[-n_res:]
        del res_stack[-n_res:]
        for j in range(n_res):
            x = resnet_block(bp["resnets"][j], torch.cat([x, skips[-(j + 1)]], 1), emb, cfg)
            if "attentions" in bp:
                x = transformer2d(bp["attentions"][j], x, encoder_hidden_states, heads, cfg,
                                  mask_latents)
            x = add_up(x)
            if return_res_samples:
                up_emitted.append(x)
        if "upsamplers" in bp:
            x = add_up(_upsample(bp["upsamplers"], x))
            if return_res_samples:
                up_emitted.append(x)

    if return_res_samples:
        return emitted, mid_emitted, up_emitted

    # 6. out
    x = group_norm(x, params["conv_norm_out"], cfg.norm_num_groups, cfg.norm_eps)
    return _conv2d(params["conv_out"], _silu(x))


def brushnet_forward(params, cfg: UNet2DConfig, sample, timestep, encoder_hidden_states,
                     brushnet_cond, *, text_embeds=None, time_ids=None,
                     conditioning_scale: float = 1.0, guess_mode: bool = False):
    """BrushNetModel.forward: sample (B, 4, H, W) noisy latents,
    ``brushnet_cond`` (B, 5, H, W) the masked-image latents and the mask.
    Returns (down_samples, mid_sample, up_samples), the zero-conv'd
    sub-block features scaled by ``conditioning_scale`` (on a log scale
    from 0.1 in ``guess_mode``), channels-first, ready for
    :func:`unet2d_forward`."""
    down, mid, up = unet2d_forward(params, cfg, sample, timestep, encoder_hidden_states,
                                   text_embeds=text_embeds, time_ids=time_ids,
                                   return_res_samples=True, brushnet_cond=brushnet_cond)
    down = [_conv2d(z, f, padding=0) for z, f in zip(params["brushnet_down_blocks"], down)]
    mid = _conv2d(params["brushnet_mid_block"], mid, padding=0)
    up = [_conv2d(z, f, padding=0) for z, f in zip(params["brushnet_up_blocks"], up)]
    if guess_mode:
        n = len(down) + 1 + len(up)
        scales = torch.logspace(-1, 0, n, dtype=torch.float32, device=mid.device)
        scales = scales * conditioning_scale
        down = [d * scales[i] for i, d in enumerate(down)]
        mid = mid * scales[len(down)]
        up = [u * scales[len(down) + 1 + i] for i, u in enumerate(up)]
    else:
        down = [d * conditioning_scale for d in down]
        mid = mid * conditioning_scale
        up = [u * conditioning_scale for u in up]
    return down, mid, up


# ------------------------------------------------------------------ converter
def convert_unet2d_state_dict(sd: Dict[str, np.ndarray], cfg: UNet2DConfig, dtype=None,
                              device="cuda"):
    """diffusers UNet2DConditionModel / BrushNetModel state dict (numpy) ->
    port params on ``device`` (the JAX converter's tree, conv weights kept
    (C_out, C_in, kh, kw))."""
    def resnet(pre):
        p = {"norm1": weight_bias(sd, pre + ".norm1"), "conv1": weight_bias(sd, pre + ".conv1"),
             "time_emb_proj": linear(sd, pre + ".time_emb_proj"),
             "norm2": weight_bias(sd, pre + ".norm2"), "conv2": weight_bias(sd, pre + ".conv2")}
        if pre + ".conv_shortcut.weight" in sd:
            p["conv_shortcut"] = weight_bias(sd, pre + ".conv_shortcut")
        return p

    def attn(pre, out="to_out.0"):
        return {"to_q": linear(sd, pre + ".to_q"), "to_k": linear(sd, pre + ".to_k"),
                "to_v": linear(sd, pre + ".to_v"), "to_out": linear(sd, f"{pre}.{out}")}

    def tblock(pre):
        return {"norm1": weight_bias(sd, pre + ".norm1"), "attn1": attn(pre + ".attn1"),
                "norm2": weight_bias(sd, pre + ".norm2"), "attn2": attn(pre + ".attn2"),
                "norm3": weight_bias(sd, pre + ".norm3"),
                "ff_proj": linear(sd, pre + ".ff.net.0.proj"), "ff_out": linear(sd, pre + ".ff.net.2")}

    def transformer(pre):
        blocks, i = [], 0
        while f"{pre}.transformer_blocks.{i}.norm1.weight" in sd:
            blocks.append(tblock(f"{pre}.transformer_blocks.{i}"))
            i += 1
        return {"norm": weight_bias(sd, pre + ".norm"), "proj_in": linear(sd, pre + ".proj_in"),
                "blocks": blocks, "proj_out": linear(sd, pre + ".proj_out")}

    def indexed(pre, probe, fn):
        """fn(pre.i) for i = 0, 1, ... while pre.i + probe is in sd."""
        out = []
        while f"{pre}.{len(out)}{probe}" in sd:
            out.append(fn(f"{pre}.{len(out)}"))
        return out

    params: Dict[str, Any] = {"time_embedding": {
        "linear_1": linear(sd, "time_embedding.linear_1"),
        "linear_2": linear(sd, "time_embedding.linear_2")}}
    for name in ("conv_in", "conv_in_condition"):
        if name + ".weight" in sd:
            params[name] = weight_bias(sd, name)
    if cfg.addition_embed_type == "text_time":
        params["add_embedding"] = {"linear_1": linear(sd, "add_embedding.linear_1"),
                                   "linear_2": linear(sd, "add_embedding.linear_2")}

    down = []
    for i, bt in enumerate(cfg.down_block_types):
        pre = f"down_blocks.{i}"
        bp: Dict[str, Any] = {"resnets": [resnet(f"{pre}.resnets.{j}")
                                          for j in range(cfg.layers_per_block)]}
        if bt.startswith("CrossAttn"):
            bp["attentions"] = [transformer(f"{pre}.attentions.{j}")
                                for j in range(cfg.layers_per_block)]
        if f"{pre}.downsamplers.0.conv.weight" in sd:
            bp["downsamplers"] = {"conv": weight_bias(sd, f"{pre}.downsamplers.0.conv")}
        down.append(bp)
    params["down_blocks"] = down

    if cfg.mid_block_type is not None:
        mp = {"resnets": indexed("mid_block.resnets", ".norm1.weight", resnet)}
        if cfg.mid_block_type == "UNetMidBlock2DCrossAttn":
            mp["attentions"] = indexed("mid_block.attentions", ".norm.weight", transformer)
        else:
            mp["attentions"] = indexed(
                "mid_block.attentions", ".group_norm.weight",
                lambda pre: {"group_norm": weight_bias(sd, pre + ".group_norm"), **attn(pre)})
        params["mid_block"] = mp

    ups = []
    for i, bt in enumerate(cfg.up_block_types):
        pre = f"up_blocks.{i}"
        bp = {"resnets": [resnet(f"{pre}.resnets.{j}") for j in range(cfg.layers_per_block + 1)]}
        if bt.startswith("CrossAttn"):
            bp["attentions"] = [transformer(f"{pre}.attentions.{j}")
                                for j in range(cfg.layers_per_block + 1)]
        if f"{pre}.upsamplers.0.conv.weight" in sd:
            bp["upsamplers"] = {"conv": weight_bias(sd, f"{pre}.upsamplers.0.conv")}
        ups.append(bp)
    params["up_blocks"] = ups

    if "conv_norm_out.weight" in sd:
        params["conv_norm_out"] = weight_bias(sd, "conv_norm_out")
        params["conv_out"] = weight_bias(sd, "conv_out")
    if "brushnet_mid_block.weight" in sd:  # the BrushNet zero convs
        def zero_convs(pre):
            return indexed(pre, ".weight", lambda n: weight_bias(sd, n))

        params["brushnet_down_blocks"] = zero_convs("brushnet_down_blocks")
        params["brushnet_mid_block"] = weight_bias(sd, "brushnet_mid_block")
        params["brushnet_up_blocks"] = zero_convs("brushnet_up_blocks")
    return to_tensors(params, device, dtype)


# ----------------------------------------------------------------------- init
def init_unet2d_params(cfg: UNet2DConfig, device="cuda", dtype=torch.bfloat16, seed=0,
                       brushnet=False):
    """Random params in the tree of the JAX package's ``init_unet2d_params``
    (``brushnet``: ``conv_in_condition`` and the zero convs in place of
    ``conv_in`` and the output head), made on ``device``: unit norm scales
    and zero biases as there, but dense and conv weights N(0, 1/fan_in)
    instead of zeros, the zero convs included, so that every layer carries
    signal."""
    device = resolve_device(device)
    r = Init(device, dtype, generator(device, seed))

    def conv(i, o, k=3):
        return {"w": r.normal((o, i, k, k), (i * k * k) ** -0.5), "b": r.zeros((o,))}

    def norm(c):
        return {"w": r.ones((c,)), "b": r.zeros((c,))}

    def resnet(i, o, temb):
        p = {"norm1": norm(i), "conv1": conv(i, o), "time_emb_proj": r.dense(temb, o),
             "norm2": norm(o), "conv2": conv(o, o)}
        if i != o:
            p["conv_shortcut"] = conv(i, o, 1)
        return p

    def att(c, kv_in):
        return {"to_q": r.dense(c, c), "to_k": r.dense(kv_in, c), "to_v": r.dense(kv_in, c),
                "to_out": r.dense(c, c)}

    def transformer(c, depth, ctx):
        return {"norm": norm(c), "proj_in": r.dense(c, c),
                "blocks": [{"norm1": norm(c), "attn1": att(c, c), "norm2": norm(c),
                            "attn2": att(c, ctx), "norm3": norm(c),
                            "ff_proj": r.dense(c, 8 * c), "ff_out": r.dense(4 * c, c)}
                           for _ in range(depth)],
                "proj_out": r.dense(c, c)}

    bo, lpb = cfg.block_out_channels, cfg.layers_per_block
    temb = bo[0] * 4
    params: Dict[str, Any] = {"time_embedding": {"linear_1": r.dense(bo[0], temb),
                                                 "linear_2": r.dense(temb, temb)}}
    if cfg.addition_embed_type == "text_time":
        params["add_embedding"] = {
            "linear_1": r.dense(cfg.projection_class_embeddings_input_dim, temb),
            "linear_2": r.dense(temb, temb)}
    cin = cfg.in_channels + (cfg.conditioning_channels if brushnet else 0)
    params["conv_in_condition" if brushnet else "conv_in"] = conv(cin, bo[0])

    down, ch = [], bo[0]
    for i, bt in enumerate(cfg.down_block_types):
        st = {"resnets": [resnet(ch if j == 0 else bo[i], bo[i], temb) for j in range(lpb)]}
        if bt.startswith("CrossAttn"):
            st["attentions"] = [transformer(bo[i], cfg.transformer_layers_per_block[i],
                                            cfg.cross_attention_dim) for _ in range(lpb)]
        if i != len(cfg.down_block_types) - 1:
            st["downsamplers"] = {"conv": conv(bo[i], bo[i])}
        down.append(st)
        ch = bo[i]
    params["down_blocks"] = down

    mid_c = bo[-1]
    if cfg.mid_block_type == "UNetMidBlock2DCrossAttn":
        mid_att = transformer(mid_c, cfg.transformer_layers_per_block[-1],
                              cfg.cross_attention_dim)
    else:
        mid_att = {"group_norm": norm(mid_c), **att(mid_c, mid_c)}
    params["mid_block"] = {"resnets": [resnet(mid_c, mid_c, temb), resnet(mid_c, mid_c, temb)],
                           "attentions": [mid_att]}

    ups, rev = [], list(reversed(bo))
    prev = rev[0]
    for i, bt in enumerate(cfg.up_block_types):
        out, inp = rev[i], rev[min(i + 1, len(rev) - 1)]
        st = {"resnets": [resnet((prev if j == 0 else out) + (inp if j == lpb else out), out, temb)
                          for j in range(lpb + 1)]}
        if bt.startswith("CrossAttn"):
            depth = cfg.transformer_layers_per_block[len(bo) - 1 - i]
            st["attentions"] = [transformer(out, depth, cfg.cross_attention_dim)
                                for _ in range(lpb + 1)]
        if i != len(cfg.up_block_types) - 1:
            st["upsamplers"] = {"conv": conv(out, out)}
        ups.append(st)
        prev = out
    params["up_blocks"] = ups

    if not brushnet:
        params["conv_norm_out"] = norm(bo[0])
        params["conv_out"] = conv(bo[0], cfg.out_channels)
        return params
    chs_down = [bo[0]]
    for i in range(len(cfg.down_block_types)):
        chs_down += [bo[i]] * lpb + ([bo[i]] if i != len(cfg.down_block_types) - 1 else [])
    chs_up = []
    for i in range(len(cfg.up_block_types)):
        chs_up += [rev[i]] * (lpb + 1) + ([rev[i]] if i != len(cfg.up_block_types) - 1 else [])
    params["brushnet_down_blocks"] = [conv(c, c, 1) for c in chs_down]
    params["brushnet_mid_block"] = conv(mid_c, mid_c, 1)
    params["brushnet_up_blocks"] = [conv(c, c, 1) for c in chs_up]
    return params
