"""The Style-DoRA adapter of the SDXL stylization path, serving side (port of
fairygen_tpu/training/dora_trainer.py ``DORA_TARGETS``,
``add_dora_to_sdxl_unet``, ``sdxl_dora_state_dict`` and
``load_sdxl_dora_state_dict``).

DoRA adapters (r = 32, α = r) sit on every transformer attention
projection to_q / to_k / to_v / to_out of the SDXL UNet; the dense layers
apply them where a ``"lora"`` entry exists (``models/adapters.py``).  The
masked DoRA train step is not ported yet (ROADMAP Queue 1 item 7).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..models.adapters import init_lora

DORA_TARGETS = ("to_q", "to_k", "to_v", "to_out")


def add_dora_to_sdxl_unet(params, generator, rank: int = 32, alpha: Optional[float] = None,
                          targets=DORA_TARGETS, dtype=torch.float32):
    """A new UNet tree whose transformer blocks carry a DoRA adapter on each
    of ``targets`` in attn1 and attn2 (identity at init: zero B, magnitude
    = the column norm of W).  Base tensors are shared, not copied; adapters
    are made on the generator's device."""

    def inject_attn(attn):
        out = dict(attn)
        for t in targets:
            if t in out:
                w = out[t]["w"]
                out[t] = {**out[t], "lora": init_lora(generator, w.shape[0], w.shape[1], rank,
                                                      alpha=alpha, dora=True, base_w=w,
                                                      dtype=dtype)}
        return out

    def inject_transformer(tr):
        if "blocks" not in tr:
            return tr
        blocks = [{**b, **{a: inject_attn(b[a]) for a in ("attn1", "attn2") if a in b}}
                  for b in tr["blocks"]]
        return {**tr, "blocks": blocks}

    params = dict(params)
    for section in ("down_blocks", "up_blocks"):
        params[section] = [
            {**st, "attentions": [inject_transformer(t) for t in st["attentions"]]}
            if "attentions" in st else st for st in params.get(section, [])]
    if params.get("mid_block", {}).get("attentions"):
        mb = params["mid_block"]
        params["mid_block"] = {**mb, "attentions": [inject_transformer(t)
                                                    for t in mb["attentions"]]}
    return params


def sdxl_dora_state_dict(params) -> dict:
    """Adapter weights in the diffusers ``save_lora_weights`` layout, numpy
    fp32: 'unet.<path>.lora_{A,B}.weight' and
    '.lora_magnitude_vector.weight'."""
    out = {}

    def host(t):
        return t.detach().float().cpu().numpy()

    def walk(tree, path):
        if isinstance(tree, dict):
            if "lora" in tree:
                ap = tree["lora"]
                base = "unet." + ".".join(path)
                out[base + ".lora_A.weight"] = host(ap["A"]).T
                out[base + ".lora_B.weight"] = host(ap["B"]).T
                if "mag" in ap:
                    out[base + ".lora_magnitude_vector.weight"] = host(ap["mag"])
            for k, v in tree.items():
                if k != "lora":
                    walk(v, path + [str(k)])
        elif isinstance(tree, (list, tuple)):
            for i, v in enumerate(tree):
                walk(v, path + [str(i)])

    walk(params, [])
    return out


def load_sdxl_dora_state_dict(params, sd: dict, scale: float = 1.0):
    """Inverse of :func:`sdxl_dora_state_dict`: put saved adapters into a
    UNet tree, in place, as runtime DoRA / LoRA modules (fp32, on each base
    weight's device).  ``scale`` is the inference-time adapter weight (the
    stylization example's ``lora_scale``, 0.66).  Returns (params,
    number of adapters loaded); an adapter with no target layer is
    skipped with a message, as in the JAX package."""
    groups = {}
    for k, v in sd.items():
        for suffix, slot in ((".lora_A.weight", "A"), (".lora_B.weight", "B"),
                             (".lora_magnitude_vector.weight", "mag")):
            if k.endswith(suffix):
                groups.setdefault(k[: -len(suffix)], {})[slot] = v

    n = 0
    for base, g in groups.items():
        path = base.split(".")
        if path[0] == "unet":
            path = path[1:]
        node = params
        for tok in path:
            if isinstance(node, (list, tuple)) and tok.isdigit() and int(tok) < len(node):
                node = node[int(tok)]
            elif isinstance(node, dict) and tok in node:
                node = node[tok]
            else:
                node = None
                break
        if not isinstance(node, dict) or "w" not in node:
            print(f"[dora] no target layer for {base!r}; skipped")
            continue
        dev = node["w"].device

        def f32(a):
            return torch.as_tensor(np.array(a, np.float32), device=dev)

        lora = {"A": f32(g["A"]).T.contiguous(), "B": f32(g["B"]).T.contiguous(),
                "scale": float(scale)}
        if "mag" in g:
            lora["mag"] = f32(g["mag"])
        node["lora"] = lora
        n += 1
    return params, n
