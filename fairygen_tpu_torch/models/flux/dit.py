"""FLUX.1 MMDiT (port of fairygen_tpu/models/flux/dit.py).

19 double-stream (joint text/image) blocks, then 38 single-stream blocks
over the concatenated [text, image] tokens; 2x2-packed 16-channel latents;
3-axis RoPE over (image index, row, col) ids with fp64 host tables; AdaLN
from timestep + pooled CLIP + embedded guidance.  Params are a nested dict
of tensors, the blocks two lists of dicts; dense weights are (d_in, d_out).

With head_dim 128 and no attention bias each block runs the JAX package's
fused form: K1 through the uniform ``ln_modulate``, K8 (double blocks) or
K7 (single blocks) for q and k, then the bounded attention K3/K4.  EliGen
entity regions add a head-shared bias: the blocks then take the plain
rms-norm -> RoPE chain and the attention goes to K10.  On CPU tensors every
op takes its plain version.  ``prescaled``: the converter folded
hd^-1/2·log2e into the q-norm gammas (``convert_flux_dit_state_dict(...,
prescale=True)``).  Kontext, ControlNet, IP-Adapter, hot LoRA and TeaCache
are not ported and raise.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ...core.params import Init, generator, linear, to_tensors
from ...device import resolve_device
from ...ops import quant
from ...ops.attention import attention
from ...ops.flash_attention import LOG2E
from ...ops.fused_norms import ln_modulate
from ...ops.fused_qk import fused_qk_attention_joint, fused_qk_attention_per_head
from ...ops.norms import rms_norm
from ...ops.rope import apply_interleaved_rope


@dataclasses.dataclass(frozen=True)
class FluxDiTConfig:
    dim: int = 3072
    num_heads: int = 24
    in_dim: int = 64  # 16-channel latents packed 2x2
    context_dim: int = 4096  # T5-XXL hidden size
    pooled_dim: int = 768  # CLIP-L pooled embedding
    time_freq_dim: int = 256
    num_double_blocks: int = 19
    num_single_blocks: int = 38
    axes_dim: Tuple[int, ...] = (16, 56, 56)  # RoPE dims per id axis
    theta: int = 10000
    guidance_embed: bool = True  # FLUX.1-dev
    eps: float = 1e-6

    @property
    def head_dim(self) -> int:
        return self.dim // self.num_heads

    @staticmethod
    def flux1_dev() -> "FluxDiTConfig":
        return FluxDiTConfig()

    @staticmethod
    def tiny(**over) -> "FluxDiTConfig":
        base = dict(dim=96, num_heads=4, in_dim=16, context_dim=48, pooled_dim=32,
                    time_freq_dim=32, num_double_blocks=2, num_single_blocks=2,
                    axes_dim=(4, 10, 10))
        base.update(over)
        return FluxDiTConfig(**base)


# ------------------------------------------------------------------ helpers
def _dense(p, x):
    if quant._ACT_TAP is not None:  # a calibration tap (a no-op when none is active)
        w = p.get("w", p.get("w_int8"))
        quant.record_activation_stats(f"dense_{x.shape[-1]}x{w.shape[-1]}", x)
    if "w_int8" in p:  # W8A8 (ops/quant.quantize_image_dit_params)
        return quant.quantized_dense(p, x)
    y = torch.matmul(x, p["w"].to(x.dtype))
    return y + p["b"].to(x.dtype) if "b" in p else y


def _timestep_sinusoid(t, dim: int):
    """diffusers' timestep embedding, flip_sin_to_cos: [cos, sin], fp32."""
    half = dim // 2
    freqs = torch.exp(-math.log(10000.0) * torch.arange(half, dtype=torch.float32,
                                                        device=t.device) / half)
    ang = t.float()[:, None] * freqs[None, :]
    return torch.cat([torch.cos(ang), torch.sin(ang)], dim=-1)


def _mlp_embed(p, x, dtype):
    h = _dense(p["fc1"], x.to(dtype))
    return _dense(p["fc2"], F.silu(h))


def prepare_image_ids(height: int, width: int) -> np.ndarray:
    """(h/2·w/2, 3) latent position ids: (image index 0, row, col)."""
    ids = np.zeros((height // 2, width // 2, 3), np.float64)
    ids[..., 1] += np.arange(height // 2)[:, None]
    ids[..., 2] += np.arange(width // 2)[None, :]
    return ids.reshape(-1, 3)


def rope_table(ids: np.ndarray, axes_dim, theta: int):
    """cos/sin (L, head_dim/2) fp32 from (L, 3) ids; angles in fp64."""
    cos_parts, sin_parts = [], []
    for i, d in enumerate(axes_dim):
        omega = 1.0 / (theta ** (np.arange(0, d, 2, dtype=np.float64) / d))
        ang = np.einsum("n,d->nd", ids[:, i].astype(np.float64), omega)
        cos_parts.append(np.cos(ang))
        sin_parts.append(np.sin(ang))
    return (np.concatenate(cos_parts, -1).astype(np.float32),
            np.concatenate(sin_parts, -1).astype(np.float32))


def _split_heads(x, n):
    b, l, d = x.shape
    return x.reshape(b, l, n, d // n)


def _merge_heads(x):
    b, l, n, hd = x.shape
    return x.reshape(b, l, n * hd)


def _adaln(p, cond, n_chunks: int):
    """SiLU + linear modulation rows, each (B, 1, dim)."""
    return _dense(p, F.silu(cond))[:, None, :].chunk(n_chunks, dim=-1)


def _gelu(x):
    return F.gelu(x, approximate="tanh")


def _fused(cfg: "FluxDiTConfig", attn_bias) -> bool:
    """The JAX package's gate for the fused prep entries."""
    return attn_bias is None and cfg.head_dim == 128


# ------------------------------------------------------------------ blocks
def _joint_attention(p, xa, xb, cos, sin, cfg: FluxDiTConfig, prescaled, attn_bias):
    n, d = cfg.num_heads, cfg.dim
    qkv_a, qkv_b = _dense(p["a_qkv"], xa), _dense(p["b_qkv"], xb)
    lb = xb.shape[1]
    if _fused(cfg, attn_bias):
        o_b, o_a = fused_qk_attention_joint(
            qkv_b[..., :d], qkv_b[..., d:2 * d], _split_heads(qkv_b[..., 2 * d:], n),
            qkv_a[..., :d], qkv_a[..., d:2 * d], _split_heads(qkv_a[..., 2 * d:], n),
            p["norm_q_b"], p["norm_k_b"], p["norm_q_a"], p["norm_k_a"],
            cos[:lb], sin[:lb], cos[lb:], sin[lb:], n, cfg.eps, not prescaled)
        return _dense(p["a_out"], _merge_heads(o_a)), _dense(p["b_out"], _merge_heads(o_b))
    q_a, k_a, v_a = _split_heads(qkv_a, 3 * n).chunk(3, dim=2)
    q_b, k_b, v_b = _split_heads(qkv_b, 3 * n).chunk(3, dim=2)
    # text (b) tokens first, the reference's order
    q = torch.cat([rms_norm(q_b, p["norm_q_b"], cfg.eps), rms_norm(q_a, p["norm_q_a"], cfg.eps)], 1)
    k = torch.cat([rms_norm(k_b, p["norm_k_b"], cfg.eps), rms_norm(k_a, p["norm_k_a"], cfg.eps)], 1)
    v = torch.cat([v_b, v_a], 1)
    q, k = apply_interleaved_rope(q, cos, sin), apply_interleaved_rope(k, cos, sin)
    o = _merge_heads(attention(q, k, v, prescaled=prescaled, bias=attn_bias,
                               bounded_logits=True))
    return _dense(p["a_out"], o[:, lb:]), _dense(p["b_out"], o[:, :lb])


def flux_double_block(p, xa, xb, cond, cos, sin, cfg: FluxDiTConfig, prescaled: bool = False,
                      attn_bias=None):
    """FluxJointTransformerBlock: image stream a, text stream b."""
    sh_a, sc_a, g_a, sh_ma, sc_ma, g_ma = _adaln(p["norm1_a"], cond, 6)
    sh_b, sc_b, g_b, sh_mb, sc_mb, g_mb = _adaln(p["norm1_b"], cond, 6)
    att_a, att_b = _joint_attention(p["attn"], ln_modulate(xa, sh_a, sc_a, cfg.eps),
                                    ln_modulate(xb, sh_b, sc_b, cfg.eps), cos, sin, cfg,
                                    prescaled, attn_bias)
    xa = xa + g_a * att_a
    ya = ln_modulate(xa, sh_ma, sc_ma, cfg.eps)
    xa = xa + g_ma * _dense(p["ff_a"]["fc2"], _gelu(_dense(p["ff_a"]["fc1"], ya)))
    xb = xb + g_b * att_b
    yb = ln_modulate(xb, sh_mb, sc_mb, cfg.eps)
    xb = xb + g_mb * _dense(p["ff_b"]["fc2"], _gelu(_dense(p["ff_b"]["fc1"], yb)))
    return xa, xb


def flux_single_block(p, x, cond, cos, sin, cfg: FluxDiTConfig, prescaled: bool = False,
                      attn_bias=None):
    """FluxSingleTransformerBlock: fused qkv + MLP projection, attention
    and GELU side by side, one output projection."""
    n, d = cfg.num_heads, cfg.dim
    shift, scale, gate = _adaln(p["norm"], cond, 3)
    h = _dense(p["to_qkv_mlp"], ln_modulate(x, shift, scale, cfg.eps))
    qkv, mlp = h[..., :3 * d], h[..., 3 * d:]
    if _fused(cfg, attn_bias):
        att = fused_qk_attention_per_head(
            qkv[..., :d], qkv[..., d:2 * d], _split_heads(qkv[..., 2 * d:], n), p["norm_q"],
            p["norm_k"], cos, sin, n, cfg.eps, not prescaled)
    else:
        q, k, v = _split_heads(qkv, 3 * n).chunk(3, dim=2)
        q = apply_interleaved_rope(rms_norm(q, p["norm_q"], cfg.eps), cos, sin)
        k = apply_interleaved_rope(rms_norm(k, p["norm_k"], cfg.eps), cos, sin)
        att = attention(q, k, v, prescaled=prescaled, bias=attn_bias, bounded_logits=True)
    h = torch.cat([_merge_heads(att), _gelu(mlp)], dim=-1)
    return x + gate * _dense(p["proj_out"], h)


def eligen_attention_bias(entity_masks, lt: int, n_img: int):
    """EliGen regional masks -> additive attention bias (B, 1, L, L), fp32
    0 / -1e30: entity prompt i and its masked image tokens attend each
    other, prompts never attend each other, the all-ones global prompt rides
    last, image-image stays dense.  entity_masks (B, N, 1, H, W) binary at
    latent resolution."""
    b, n_ent = entity_masks.shape[:2]
    dev = entity_masks.device
    pi = torch.stack([patchify(entity_masks[:, i].float()).sum(-1) > 0 for i in range(n_ent)]
                     + [torch.ones((b, n_img), dtype=torch.bool, device=dev)], 1)
    nt = n_ent + 1
    n_txt = nt * lt
    allow = torch.ones((b, n_txt + n_img, n_txt + n_img), dtype=torch.bool, device=dev)
    rows = pi.repeat_interleave(lt, dim=1)  # (B, n_txt, n_img)
    allow[:, :n_txt, n_txt:] = rows
    allow[:, n_txt:, :n_txt] = rows.transpose(1, 2)
    allow[:, :n_txt, :n_txt] = torch.block_diag(
        *[torch.ones((lt, lt), dtype=torch.bool, device=dev)] * nt)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    return torch.where(allow, zero, torch.full((), -1e30, device=dev))[:, None]


# ------------------------------------------------------------------ forward
def patchify(latents):
    """(B, C, H, W) -> (B, H/2·W/2, C·4), layout (C P Q)."""
    b, c, h, w = latents.shape
    x = latents.reshape(b, c, h // 2, 2, w // 2, 2).permute(0, 2, 4, 1, 3, 5)
    return x.reshape(b, (h // 2) * (w // 2), c * 4)


def unpatchify(x, height: int, width: int):
    b, _, cd = x.shape
    x = x.reshape(b, height // 2, width // 2, cd // 4, 2, 2).permute(0, 3, 1, 4, 2, 5)
    return x.reshape(b, cd // 4, height, width)


def flux_dit_forward(params, cfg: FluxDiTConfig, latents, timestep, prompt_emb,
                     pooled_prompt_emb, guidance=None, *, image_ids=None, txt_ids=None,
                     prescaled: bool = False, entity_prompt_emb=None, entity_masks=None,
                     kontext_latents=None, controlnet_res=None, controlnet_single_res=None,
                     ipadapter=None, hot_lora=None, tea_cache_state=None):
    """The FLUX.1 denoiser: latents (B, 16, H, W), timestep (B,) in [0,
    1000], prompt_emb (B, Lt, context_dim), pooled_prompt_emb (B,
    pooled_dim), guidance (B,) (FLUX.1-dev; x1000 inside).  EliGen:
    entity_prompt_emb (B, N, Lt, context_dim) and entity_masks (B, N, 1, H,
    W).  Returns (B, 16, H, W).  Kontext, ControlNet, IP-Adapter, hot LoRA
    and TeaCache inputs raise."""
    unported = dict(kontext_latents=kontext_latents, controlnet_res=controlnet_res,
                    controlnet_single_res=controlnet_single_res, ipadapter=ipadapter,
                    hot_lora=hot_lora, tea_cache_state=tea_cache_state)
    given = sorted(k for k, v in unported.items() if v is not None)
    if given:
        raise NotImplementedError(f"FLUX.1 inputs not ported yet: {given}")
    b, _, h, w = latents.shape
    dtype = latents.dtype
    cond = _mlp_embed(params["time_embedder"], _timestep_sinusoid(timestep, cfg.time_freq_dim),
                      dtype)
    cond = cond + _mlp_embed(params["pooled_text_embedder"], pooled_prompt_emb, dtype)
    if cfg.guidance_embed:
        if guidance is None:
            raise ValueError("FLUX.1-dev needs embedded guidance")
        cond = cond + _mlp_embed(params["guidance_embedder"],
                                 _timestep_sinusoid(guidance * 1000.0, cfg.time_freq_dim), dtype)

    n_img = (h // 2) * (w // 2)
    lt1 = prompt_emb.shape[1]
    lt_rows = lt1 if entity_prompt_emb is None else (entity_prompt_emb.shape[1] + 1) * lt1
    if image_ids is None:
        image_ids = prepare_image_ids(h, w)
    if txt_ids is None:
        txt_ids = np.zeros((lt_rows, 3), np.float64)
    cos, sin = rope_table(np.concatenate([np.asarray(txt_ids, np.float64), image_ids]),
                          cfg.axes_dim, cfg.theta)
    cos, sin = (torch.from_numpy(a).to(latents.device) for a in (cos, sin))

    x = _dense(params["x_embedder"], patchify(latents))
    attn_bias = None
    if entity_prompt_emb is not None:
        # entity prompts first, the global prompt last
        embs = [entity_prompt_emb[:, i] for i in range(entity_prompt_emb.shape[1])] + [prompt_emb]
        ctx = torch.cat([_dense(params["context_embedder"], e.to(dtype)) for e in embs], 1)
        attn_bias = eligen_attention_bias(entity_masks, lt1, n_img)
    else:
        ctx = _dense(params["context_embedder"], prompt_emb.to(dtype))

    xb = ctx
    for p in params["double_blocks"]:
        x, xb = flux_double_block(p, x, xb, cond, cos, sin, cfg, prescaled, attn_bias)
    hh = torch.cat([xb, x], 1)
    for p in params["single_blocks"]:
        hh = flux_single_block(p, hh, cond, cos, sin, cfg, prescaled, attn_bias)
    x = hh[:, ctx.shape[1]:]
    shift, scale = _adaln(params["final_norm_out"], cond, 2)
    x = _dense(params["final_proj_out"], ln_modulate(x, shift, scale, cfg.eps))
    return unpatchify(x, h, w)


# ------------------------------------------------------------------ params
def init_flux_dit_params(cfg: FluxDiTConfig, device="cuda", dtype=torch.bfloat16, seed=0):
    """Seeded random params made on ``device``: dense N(0, 1/d_in) with zero
    biases, unit q/k norm gammas."""
    device = resolve_device(device)
    r = Init(device, dtype, generator(device, seed))
    d, hd = cfg.dim, cfg.head_dim

    def mlp(din):
        return {"fc1": r.dense(din, d), "fc2": r.dense(d, d)}

    def dbl():
        return {"norm1_a": r.dense(d, 6 * d), "norm1_b": r.dense(d, 6 * d),
                "attn": {"a_qkv": r.dense(d, 3 * d), "b_qkv": r.dense(d, 3 * d),
                         "norm_q_a": r.ones((hd,)), "norm_k_a": r.ones((hd,)),
                         "norm_q_b": r.ones((hd,)), "norm_k_b": r.ones((hd,)),
                         "a_out": r.dense(d, d), "b_out": r.dense(d, d)},
                "ff_a": {"fc1": r.dense(d, 4 * d), "fc2": r.dense(4 * d, d)},
                "ff_b": {"fc1": r.dense(d, 4 * d), "fc2": r.dense(4 * d, d)}}

    def sgl():
        return {"norm": r.dense(d, 3 * d), "to_qkv_mlp": r.dense(d, 7 * d),
                "norm_q": r.ones((hd,)), "norm_k": r.ones((hd,)), "proj_out": r.dense(5 * d, d)}

    params = {
        "time_embedder": mlp(cfg.time_freq_dim),
        "pooled_text_embedder": mlp(cfg.pooled_dim),
        "context_embedder": r.dense(cfg.context_dim, d),
        "x_embedder": r.dense(cfg.in_dim, d),
        "double_blocks": [dbl() for _ in range(cfg.num_double_blocks)],
        "single_blocks": [sgl() for _ in range(cfg.num_single_blocks)],
        "final_norm_out": r.dense(d, 2 * d),
        "final_proj_out": r.dense(d, cfg.in_dim),
    }
    if cfg.guidance_embed:
        params["guidance_embedder"] = mlp(cfg.time_freq_dim)
    return params


# ------------------------------------------------------------------ convert
def convert_flux_dit_state_dict(sd: Dict[str, Any], cfg: FluxDiTConfig, dtype=None,
                                prescale: bool = False, device="cuda"):
    """Upstream FluxDiT module naming (numpy) -> port params on ``device``.
    ``prescale``: fold hd^-1/2·log2e into every q-norm gamma, for
    ``flux_dit_forward(..., prescaled=True)``."""
    s = (cfg.head_dim ** -0.5) * LOG2E if prescale else 1.0

    def vec(name):
        return np.asarray(sd[name + ".weight"])

    def mlp(pre):
        return {"fc1": linear(sd, pre + ".0"), "fc2": linear(sd, pre + ".2")}

    def dbl(pre):
        return {
            "norm1_a": linear(sd, pre + ".norm1_a.linear"),
            "norm1_b": linear(sd, pre + ".norm1_b.linear"),
            "attn": {"a_qkv": linear(sd, pre + ".attn.a_to_qkv"),
                     "b_qkv": linear(sd, pre + ".attn.b_to_qkv"),
                     "norm_q_a": vec(pre + ".attn.norm_q_a") * s,
                     "norm_k_a": vec(pre + ".attn.norm_k_a"),
                     "norm_q_b": vec(pre + ".attn.norm_q_b") * s,
                     "norm_k_b": vec(pre + ".attn.norm_k_b"),
                     "a_out": linear(sd, pre + ".attn.a_to_out"),
                     "b_out": linear(sd, pre + ".attn.b_to_out")},
            "ff_a": mlp(pre + ".ff_a"),
            "ff_b": mlp(pre + ".ff_b"),
        }

    def sgl(pre):
        return {"norm": linear(sd, pre + ".norm.linear"),
                "to_qkv_mlp": linear(sd, pre + ".to_qkv_mlp"),
                "norm_q": vec(pre + ".norm_q_a") * s, "norm_k": vec(pre + ".norm_k_a"),
                "proj_out": linear(sd, pre + ".proj_out")}

    params = {
        "time_embedder": mlp("time_embedder.timestep_embedder"),
        "pooled_text_embedder": mlp("pooled_text_embedder"),
        "context_embedder": linear(sd, "context_embedder"),
        "x_embedder": linear(sd, "x_embedder"),
        "double_blocks": [dbl(f"blocks.{i}") for i in range(cfg.num_double_blocks)],
        "single_blocks": [sgl(f"single_blocks.{i}") for i in range(cfg.num_single_blocks)],
        "final_norm_out": linear(sd, "final_norm_out.linear"),
        "final_proj_out": linear(sd, "final_proj_out"),
    }
    if cfg.guidance_embed:
        params["guidance_embedder"] = mlp("guidance_embedder.timestep_embedder")
    return to_tensors(params, device, dtype)


# BFL checkpoint naming -> upstream module naming (key-mapping data of the
# upstream FluxDiTStateDictConverter)
_BFL_TOP = {
    "time_in.in_layer": "time_embedder.timestep_embedder.0",
    "time_in.out_layer": "time_embedder.timestep_embedder.2",
    "txt_in": "context_embedder",
    "vector_in.in_layer": "pooled_text_embedder.0",
    "vector_in.out_layer": "pooled_text_embedder.2",
    "final_layer.linear": "final_proj_out",
    "guidance_in.in_layer": "guidance_embedder.timestep_embedder.0",
    "guidance_in.out_layer": "guidance_embedder.timestep_embedder.2",
    "img_in": "x_embedder",
    "final_layer.adaLN_modulation.1": "final_norm_out.linear",
}
_BFL_DOUBLE = {
    "img_attn.norm.key_norm.scale": "attn.norm_k_a.weight",
    "img_attn.norm.query_norm.scale": "attn.norm_q_a.weight",
    "img_attn.proj": "attn.a_to_out",
    "img_attn.qkv": "attn.a_to_qkv",
    "img_mlp.0": "ff_a.0",
    "img_mlp.2": "ff_a.2",
    "img_mod.lin": "norm1_a.linear",
    "txt_attn.norm.key_norm.scale": "attn.norm_k_b.weight",
    "txt_attn.norm.query_norm.scale": "attn.norm_q_b.weight",
    "txt_attn.proj": "attn.b_to_out",
    "txt_attn.qkv": "attn.b_to_qkv",
    "txt_mlp.0": "ff_b.0",
    "txt_mlp.2": "ff_b.2",
    "txt_mod.lin": "norm1_b.linear",
}
_BFL_SINGLE = {
    "linear1": "to_qkv_mlp",
    "linear2": "proj_out",
    "modulation.lin": "norm.linear",
    "norm.key_norm.scale": "norm_k_a.weight",
    "norm.query_norm.scale": "norm_q_a.weight",
}


def normalize_flux_dit_source(sd: Dict[str, Any]) -> Dict[str, Any]:
    """BFL-format FLUX checkpoints (flux1-dev.safetensors) -> the upstream
    module naming :func:`convert_flux_dit_state_dict` reads.  A dict already
    in that naming passes through untouched."""
    if not any(k.startswith(("double_blocks.", "model.diffusion_model.")) for k in sd):
        return sd
    out = {}
    for name, v in sd.items():
        if name.startswith("model.diffusion_model."):
            name = name[len("model.diffusion_model."):]
        parts = name.split(".")
        stem, leaf = ".".join(parts[:-1]), parts[-1]
        if stem in _BFL_TOP:
            out[f"{_BFL_TOP[stem]}.{leaf}"] = v
        elif parts[0] in ("double_blocks", "single_blocks"):
            table = _BFL_DOUBLE if parts[0] == "double_blocks" else _BFL_SINGLE
            dst = "blocks" if parts[0] == "double_blocks" else "single_blocks"
            suf, sufstem = ".".join(parts[2:]), ".".join(parts[2:-1])
            if suf in table:  # norm scales map whole-key
                out[f"{dst}.{parts[1]}.{table[suf]}"] = v
            elif sufstem in table:
                out[f"{dst}.{parts[1]}.{table[sufstem]}.{leaf}"] = v
    return out
