"""UMT5-XXL text encoder (port of fairygen_tpu/models/wan/text_encoder.py).

24 encoder layers, dim 4096, gated GELU-tanh FFN 10240, 64 heads,
per-layer bidirectional relative-position buckets (one table shared by
every layer for T5 v1.1, ``shared_pos_bias``), unscaled attention
with an additive per-head bias, T5 layer norm, final norm.  Params are a
nested dict of tensors; dense weights are (d_in, d_out), applied as x @ w.
The attention with a per-head bias is plain PyTorch, as it is plain XLA in
the JAX package.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ...core.params import to_tensors
from ...ops.norms import t5_layer_norm


@dataclasses.dataclass(frozen=True)
class UMT5Config:
    vocab: int = 256384
    dim: int = 4096
    dim_attn: int = 4096
    dim_ffn: int = 10240
    num_heads: int = 64
    num_layers: int = 24
    num_buckets: int = 32
    max_dist: int = 128
    # T5 v1.1 (FLUX's second text encoder): one relative-position table,
    # on layer 0, shared by every layer; UMT5 has one per layer
    shared_pos_bias: bool = False

    @property
    def head_dim(self):
        return self.dim_attn // self.num_heads

    @staticmethod
    def umt5_xxl() -> "UMT5Config":
        return UMT5Config()

    @staticmethod
    def t5_v1_1_xxl() -> "UMT5Config":
        """google/t5-v1_1-xxl encoder (FLUX.1's second text encoder): d_ff
        10240, d_model 4096, 64 heads, 24 layers, gated GELU, vocab 32128."""
        return UMT5Config(vocab=32128, shared_pos_bias=True)

    @staticmethod
    def tiny(**over) -> "UMT5Config":
        base = dict(vocab=128, dim=32, dim_attn=32, dim_ffn=48, num_heads=4, num_layers=2)
        base.update(over)
        return UMT5Config(**base)


def relative_position_buckets(lq: int, lk: int, num_buckets: int = 32,
                              max_dist: int = 128) -> np.ndarray:
    """Bidirectional T5 bucket ids (lq, lk)."""
    rel = np.arange(lk)[None, :] - np.arange(lq)[:, None]
    nb = num_buckets // 2
    buckets = (rel > 0).astype(np.int64) * nb
    rel = np.abs(rel)
    max_exact = nb // 2
    large = max_exact + (
        np.log(np.maximum(rel, 1) / max_exact) / math.log(max_dist / max_exact) * (nb - max_exact)
    ).astype(np.int64)
    large = np.minimum(large, nb - 1)
    buckets += np.where(rel < max_exact, rel, large)
    return buckets


def _gelu_tanh(x):
    xf = x.float()
    y = 0.5 * xf * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi) * (xf + 0.044715 * xf.pow(3))))
    return y.to(x.dtype)


def _dense(p, x):
    return torch.matmul(x, p["w"])


def t5_attention(p, x, cfg: UMT5Config, pos_bias, mask=None):
    """Unscaled attention + additive per-head bias (B, H, L, L)."""
    b, l, _ = x.shape
    n, c = cfg.num_heads, cfg.head_dim
    q = _dense(p["q"], x).reshape(b, l, n, c)
    k = _dense(p["k"], x).reshape(b, l, n, c)
    v = _dense(p["v"], x).reshape(b, l, n, c)
    logits = torch.einsum("binc,bjnc->bnij", q, k).float()
    logits = logits + pos_bias.float()
    if mask is not None:
        logits = logits.masked_fill((mask == 0)[:, None, None, :],
                                    torch.finfo(torch.float32).min)
    probs = torch.softmax(logits, dim=-1).to(x.dtype)
    o = torch.einsum("bnij,bjnc->binc", probs, v).reshape(b, l, n * c)
    return _dense(p["o"], o)


def t5_block(p, x, cfg: UMT5Config, pos_bias, mask=None):
    h = t5_layer_norm(x, p["norm1"])
    x = x + t5_attention(p["attn"], h, cfg, pos_bias, mask)
    h = t5_layer_norm(x, p["norm2"])
    ff = _dense(p["ffn"]["fc1"], h) * _gelu_tanh(_dense(p["ffn"]["gate"], h))
    return x + _dense(p["ffn"]["fc2"], ff)


def umt5_encode(params, cfg: UMT5Config, ids, mask=None):
    """ids (B, L) int -> embeddings (B, L, dim)."""
    x = params["token_embedding"][ids]
    L = ids.shape[1]
    buckets = torch.from_numpy(
        relative_position_buckets(L, L, cfg.num_buckets, cfg.max_dist)).to(ids.device)
    shared = params["pos_emb"][buckets].permute(2, 0, 1)[None] if cfg.shared_pos_bias else None
    for p in params["blocks"]:
        # (1, H, L, L) from the (buckets, heads) table
        bias = shared if shared is not None else p["pos_emb"][buckets].permute(2, 0, 1)[None]
        x = t5_block(p, x, cfg, bias, mask)
    return t5_layer_norm(x, params["norm"])


def mask_pad_tokens(emb, mask):
    """Zero embeddings past each sequence's length."""
    return emb * (mask > 0)[..., None].to(emb.dtype)


# ------------------------------------------------------------------ converters
def _t5_block(sd, norm1, norm2, attn, ffn, ffn_names):
    """One encoder layer from state-dict names; ``ffn_names`` maps the port's
    gate/fc1/fc2 onto the checkpoint's layer names."""
    def w(name):  # (out, in) -> (in, out)
        return np.asarray(sd[name + ".weight"]).T

    return {"norm1": np.asarray(sd[norm1]), "norm2": np.asarray(sd[norm2]),
            "attn": {k: {"w": w(f"{attn}.{k}")} for k in ("q", "k", "v", "o")},
            "ffn": {k: {"w": w(f"{ffn}.{name}")} for k, name in zip(("gate", "fc1", "fc2"),
                                                                  ffn_names)}}


def convert_umt5_state_dict(sd, cfg: UMT5Config, dtype=None, device="cuda"):
    """Upstream UMT5 state dict (numpy) -> port params on ``device``."""
    blocks = []
    for i in range(cfg.num_layers):
        pre = f"blocks.{i}"
        blk = _t5_block(sd, pre + ".norm1.weight", pre + ".norm2.weight", pre + ".attn",
                        pre + ".ffn", ("gate.0", "fc1", "fc2"))
        blk["pos_emb"] = np.asarray(sd[pre + ".pos_embedding.embedding.weight"])
        blocks.append(blk)
    params = {"token_embedding": np.asarray(sd["token_embedding.weight"]), "blocks": blocks,
              "norm": np.asarray(sd["norm.weight"])}
    return to_tensors(params, device, dtype)


def convert_t5_encoder_state_dict(sd, cfg: UMT5Config, dtype=None, device="cuda"):
    """transformers ``T5EncoderModel.state_dict()`` naming (numpy) -> port
    params on ``device``, with the one shared relative-position table."""
    blocks = []
    for i in range(cfg.num_layers):
        pre = f"encoder.block.{i}"
        blocks.append(_t5_block(sd, pre + ".layer.0.layer_norm.weight",
                                pre + ".layer.1.layer_norm.weight",
                                pre + ".layer.0.SelfAttention", pre + ".layer.1.DenseReluDense",
                                # v1.1 gated act: act(wi_0) * wi_1, then wo
                                ("wi_0", "wi_1", "wo")))
    emb_key = "shared.weight" if "shared.weight" in sd else "encoder.embed_tokens.weight"
    params = {
        "token_embedding": np.asarray(sd[emb_key]),
        "pos_emb": np.asarray(sd["encoder.block.0.layer.0.SelfAttention"
                                 ".relative_attention_bias.weight"]),
        "blocks": blocks,
        "norm": np.asarray(sd["encoder.final_layer_norm.weight"]),
    }
    return to_tensors(params, device, dtype)
