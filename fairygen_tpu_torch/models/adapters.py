"""LoRA adapters and the FairyGen two-stage motion-adapter scheme (port of
fairygen_tpu/models/adapters.py, the LoRA part).

  * plain LoRA:  y = Wx + s·(x A) B
  * stage-1:     element dropout p=0.8 on B with 1/(1−p) rescale, as a
                 parameter transform before the forward pass
  * stage-2:     frozen A/B + zero-init B2 with dropout 0.5:
                 y = Wx + s·(xA)B + s·(xA)B2
  * merge tools: B = B1 + B2; fuse-at-load W += α·(B@A)ᵀ.

Adapter params live inside the dense layer's dict under ``"lora"``:
``{"w", "b", "lora": {"A": (in, r), "B": (r, out), "B2": optional,
"scale": float}}``, one per block (the port keeps blocks as a list).  LoRA
leaves are fp32, as in the JAX package.  DoRA (``"mag"``) is not ported:
an adapter that carries it is refused.

Paths: a parameter's path is the tuple of dict keys and list indices from
the root, e.g. ``("blocks", 3, "self_attn", "q", "lora", "A")``.
"""
from __future__ import annotations

import re
from typing import Any, Dict, Iterable, Optional, Sequence

import numpy as np
import torch


# ------------------------------------------------------------------- tree
def map_with_path(fn, tree, path=()):
    """Rebuild a tree of dicts and lists with ``fn(path, leaf)`` at each leaf."""
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [map_with_path(fn, v, path + (i,)) for i, v in enumerate(tree)]
    return fn(path, tree)


def leaves_with_path(tree, path=()):
    """(path, leaf) pairs in the order of :func:`map_with_path`."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from leaves_with_path(v, path + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from leaves_with_path(v, path + (i,))
    else:
        yield path, tree


# ------------------------------------------------------------------ forward
def apply_adapter(base_out, x, p, mask=None):
    """The adapter update added to a dense layer's output ``base_out``.
    A, B and B2 are cast to x.dtype; each product accumulates in fp32 and is
    rounded to x.dtype; ``scale`` (default 1) multiplies in x.dtype.
    ``mask``: (B, N, 1) 0/1 token gate.  A per-sample A of shape (B, in, r)
    against x (B, N, in) applies one adapter per batch row (the products
    batch over the leading axis)."""
    ap = p["lora"]
    if "mag" in ap:
        raise NotImplementedError("DoRA adapters ('mag') are not ported yet")
    scale = torch.as_tensor(ap.get("scale", 1.0), device=x.device).to(x.dtype)
    xa = torch.matmul(x, ap["A"].to(x.dtype))
    upd = torch.matmul(xa, ap["B"].to(x.dtype)) * scale
    if "B2" in ap:
        upd = upd + torch.matmul(xa, ap["B2"].to(x.dtype)) * scale
    if mask is not None:
        upd = upd * mask.to(upd.dtype)
    return base_out + upd


# --------------------------------------------------------------------- init
def init_lora(generator, d_in: int, d_out: int, rank: int, *, alpha: Optional[float] = None,
              with_b2: bool = False, dtype=torch.float32) -> Dict[str, Any]:
    """Normal A scaled by d_in^-1/2, zero B (and B2); scale = alpha/rank
    (alpha defaults to rank, so scale 1 for the stage scripts' r=alpha=32).
    Made on the generator's device."""
    dev = generator.device
    a = torch.randn((d_in, rank), generator=generator, device=dev, dtype=dtype)
    p = {"A": a.mul_((1.0 / d_in) ** 0.5), "B": torch.zeros((rank, d_out), device=dev, dtype=dtype),
         "scale": float((alpha if alpha is not None else rank) / rank)}
    if with_b2:
        p["B2"] = torch.zeros((rank, d_out), device=dev, dtype=dtype)
    return p


WAN_LORA_TARGETS = ("q", "k", "v", "o", "ffn.0", "ffn.2")  # stage1_id.sh
_FFN = {"ffn.0": "fc1", "ffn.2": "fc2"}


def _target_layers(targets):
    """Reference target names -> (sub, proj) layer keys of a block."""
    for t in targets:
        if t in ("q", "k", "v", "o"):
            yield from (("self_attn", t), ("cross_attn", t))
        elif t in _FFN:
            yield "ffn", _FFN[t]
        else:
            raise ValueError(f"unknown target {t}")


def _with_layer(block, sub, proj, layer):
    block = dict(block)
    block[sub] = dict(block[sub])
    block[sub][proj] = layer
    return block


def add_lora_to_wan_dit(params, generator, rank: int = 32, alpha: Optional[float] = None,
                        targets: Sequence[str] = WAN_LORA_TARGETS, with_b2: bool = False,
                        dtype=torch.float32):
    """A new param tree whose Wan DiT blocks carry LoRA adapters on
    ``targets`` (q, k, v, o in self- and cross-attention; ffn.0/ffn.2 the
    two FFN projections).  Base tensors are shared, not copied."""
    layers = list(_target_layers(targets))
    blocks = []
    for blk in params["blocks"]:
        for sub, proj in layers:
            w = blk[sub][proj]["w"]
            layer = dict(blk[sub][proj])
            layer["lora"] = init_lora(generator, w.shape[0], w.shape[1], rank, alpha=alpha,
                                      with_b2=with_b2, dtype=dtype)
            blk = _with_layer(blk, sub, proj, layer)
        blocks.append(blk)
    return {**params, "blocks": blocks}


# ------------------------------------------------------- stage-wise dropout
def dropout_lora_b(params, generator, p_drop: float, which: str = "B", masks=None):
    """Element dropout on B (stage-1 p=0.8) or B2 (stage-2 p=0.5) with
    1/(1−p) rescale, as a parameter transform (differentiable in the
    dropped leaf).  Masks keep an element where a uniform draw from
    ``generator`` exceeds ``p_drop``; ``masks`` (path -> 0/1 tensor) gives
    them instead, leaf for leaf."""

    def drop(path, leaf):
        if "lora" not in path or path[-1] != which:
            return leaf
        if masks is not None:
            keep = masks[path]
        else:
            keep = torch.rand(leaf.shape, generator=generator, device=leaf.device) > p_drop
        return leaf * keep.to(leaf.dtype) / (1.0 - p_drop)

    return map_with_path(drop, params)


def lora_trainable_filter(which: Iterable[str] = ("A", "B", "B2")):
    """Predicate on a parameter path: train only adapter leaves in ``which``."""
    which = set(which)

    def fit(path):
        return "lora" in path and path[-1] in which
    return fit


# ------------------------------------------------------------------ merging
def normalize_lora_keys(state_dict: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Foreign key layouts -> '<target>.lora_{A,B}.weight' pairs
    (lora_up/lora_down naming, the 'default' adapter infix and the
    'diffusion_model.' prefix)."""
    out = {}
    for key in state_dict:
        b_name = "lora_up" if ".lora_up." in key else "lora_B"
        a_name = "lora_down" if ".lora_up." in key else "lora_A"
        if b_name not in key:
            continue
        parts = key.split(".")
        bi = parts.index(b_name)
        if len(parts) > bi + 2:
            parts.pop(bi + 1)  # drop the adapter name ('default')
        parts.pop(bi)
        if parts[0] == "diffusion_model":
            parts.pop(0)
        parts.pop(-1)  # drop 'weight'
        target = ".".join(parts)
        out[target + ".lora_B.weight"] = np.asarray(state_dict[key])
        out[target + ".lora_A.weight"] = np.asarray(state_dict[key.replace(b_name, a_name)])
    return out


def merge_stage_weights(stage1: Dict[str, np.ndarray], stage2: Dict[str, np.ndarray]):
    """Propagated motion adapter merge: keep A1, B = B1 + B2."""
    merged = {}
    for k in stage1:
        if "lora_A" in k:
            merged[k] = np.asarray(stage1[k])
        elif "lora_B" in k:
            if k.endswith(".lora_B.default.weight"):
                b2 = k.replace(".lora_B.default.weight", ".lora_B2.weight")
            else:
                b2 = k.replace("lora_B", "lora_B2").replace(".default", "")
            merged[k] = np.asarray(stage1[k]) + (np.asarray(stage2[b2]) if b2 in stage2 else 0.0)
    return merged


def wan_lora_layer_key(target: str):
    """'blocks.N.self_attn.q' / 'blocks.N.ffn.0' -> (N, sub, proj), or None."""
    m = re.match(r"blocks\.(\d+)\.(self_attn|cross_attn)\.(q|k|v|o)$", target)
    if m:
        return int(m.group(1)), m.group(2), m.group(3)
    m = re.match(r"blocks\.(\d+)\.ffn\.(0|2)$", target)
    if m:
        return int(m.group(1)), "ffn", "fc1" if m.group(2) == "0" else "fc2"
    return None


def _lora_pairs(lora_state_dict):
    """{(N, sub, proj): (down (r, in), up (out, r))} of a Wan-DiT LoRA;
    raises when targets exist but none matches the block layout."""
    sd = normalize_lora_keys(lora_state_dict)
    targets = sorted({k[: -len(".lora_B.weight")] for k in sd if k.endswith(".lora_B.weight")})
    pairs = {}
    for t in targets:
        loc = wan_lora_layer_key(t)
        if loc is not None:
            pairs[loc] = (sd[t + ".lora_A.weight"], sd[t + ".lora_B.weight"])
    if targets and not pairs:
        raise ValueError(f"no LoRA target matched the Wan block layout (of {len(targets)}; "
                         f"e.g. {targets[0]!r}) — is this a Wan-DiT adapter?")
    return pairs


def fuse_lora_into_wan_dit(params, lora_state_dict, cfg=None, alpha: float = 1.0):
    """Merge a (torch-layout) Wan-DiT LoRA into the base weights:
    W += α·(B@A)ᵀ in the (in, out) convention, in fp32 on W's device, then
    rounded to W's dtype.  Returns (new params, number of layers fused);
    the input tree is not modified.  ``cfg`` is accepted for signature
    parity with the JAX package."""
    del cfg
    blocks = list(params["blocks"])
    pairs = _lora_pairs(lora_state_dict)
    for (i, sub, proj), (down, up) in pairs.items():
        layer = dict(blocks[i][sub][proj])
        w = layer["w"]
        up_t = torch.as_tensor(np.asarray(up, np.float32), device=w.device)
        down_t = torch.as_tensor(np.asarray(down, np.float32), device=w.device)
        layer["w"] = (w.float() + alpha * (up_t @ down_t).T).to(w.dtype)
        blocks[i] = _with_layer(blocks[i], sub, proj, layer)
    return {**params, "blocks": blocks}, len(pairs)


def set_lora_weights(params, lora_state_dict):
    """Load a (torch-layout) LoRA's A and B into the adapter slots a tree
    already carries (stage-2 starts from the stage-1 adapter), in place;
    the slots keep their dtype.  Returns the number of layers set."""
    pairs = _lora_pairs(lora_state_dict)
    with torch.no_grad():
        for (i, sub, proj), (down, up) in pairs.items():
            ap = params["blocks"][i][sub][proj]["lora"]
            ap["A"].copy_(torch.as_tensor(np.asarray(down).T))
            ap["B"].copy_(torch.as_tensor(np.asarray(up).T))
    return len(pairs)
