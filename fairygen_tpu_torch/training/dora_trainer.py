"""The Style-DoRA adapter of the SDXL stylization path and its masked train
step (port of fairygen_tpu/training/dora_trainer.py ``DORA_TARGETS``,
``add_dora_to_sdxl_unet``, ``masked_mse_loss``,
``make_sdxl_dora_train_step``, ``sdxl_dora_state_dict`` and
``load_sdxl_dora_state_dict``).

DoRA adapters (r = 32, α = r) sit on every transformer attention
projection to_q / to_k / to_v / to_out of the SDXL UNet; the dense layers
apply them where a ``"lora"`` entry exists (``models/adapters.py``), gated
per token by the training image's mask.  The train step is the
single-image masked finetune: ε-prediction on DDPM-noised latents, the
masked MSE ``sum(se·mask) / max(sum(mask), 1)``, optionally weighted per
sample by min-SNR-γ, SDXL's time ids original + crop + target; only the
adapters' A, B and magnitude train.  In the fp32 UNet of the example on
the card every attention of the step runs K6a, K6b and K6c in fp32 at
head dim 64 (``ops/flash_attention.py``).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..device import resolve_device
from ..diffusion.ddpm import DDPMScheduler
from ..models.adapters import init_lora, lora_trainable_filter
from ..models.sdxl.unet2d import UNet2DConfig, unet2d_forward
from .train_step import _trainer

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


def masked_mse_loss(pred, target, mask_latents):
    """sum(se·mask) / max(sum(mask), 1) in fp32; ``mask_latents`` (B, 1, h,
    w) on the latent grid, broadcast over the channels."""
    mask = mask_latents.float().expand(pred.shape)
    se = (pred.float() - target.float()) ** 2
    return (se * mask).sum() / mask.sum().clamp_min(1.0)


def make_sdxl_dora_train_step(unet_cfg: UNet2DConfig, optimizer, *,
                              scheduler: Optional[DDPMScheduler] = None,
                              snr_gamma: Optional[float] = None, resolution: int = 1024,
                              device="cuda"):
    """Build (init_state, train_step) for the masked style-DoRA finetune.

    ``train_step(state, batch, generator, *, timesteps=None, noise=None) ->
    (state, loss)``; the batch holds ``latents`` (B, 4, h, w), scaled,
    ``mask_latents`` (B, 1, h, w), ``prompt_embeds`` (B, 77, 2048),
    ``pooled`` (B, 1280), ``original_size`` and ``crop_top_left`` (B, 2).
    The generator draws, in order, the timesteps (uniform integers below
    ``num_train_timesteps``) and the noise, as the JAX loss draws them from
    its two keys; ``timesteps`` / ``noise`` replace the two draws.  Only the
    adapters' A, B and ``mag`` get gradients and go to the optimizer; the
    base weights stay as they are, bit for bit.
    ``train_step.loss_and_grads(state, batch, generator, ...)`` gives the
    loss and the trainable gradients (path -> tensor) without an update."""
    resolve_device(device)
    sched = scheduler or DDPMScheduler()

    def loss_fn(params, batch, generator, timesteps=None, noise=None):
        latents = batch["latents"]
        b, dev = latents.shape[0], latents.device
        if timesteps is None:
            timesteps = torch.randint(0, sched.num_train_timesteps, (b,), generator=generator,
                                      device=dev)
        if noise is None:
            noise = torch.randn(latents.shape, generator=generator, device=dev,
                                dtype=latents.dtype)
        timesteps = torch.as_tensor(timesteps, device=dev).long()
        noise = torch.as_tensor(noise).to(dev, latents.dtype)
        noisy = sched.add_noise(latents, noise, timesteps)

        def f32(key):
            return torch.as_tensor(batch[key]).to(dev, torch.float32)

        time_ids = torch.cat([f32("original_size"), f32("crop_top_left"),
                              torch.full((b, 2), float(resolution), device=dev)], -1)
        pred = unet2d_forward(params, unet_cfg, noisy, timesteps.float(),
                              batch["prompt_embeds"], text_embeds=batch["pooled"],
                              time_ids=time_ids, mask_latents=batch["mask_latents"])
        target = noise  # ε-prediction
        if snr_gamma is None:
            return masked_mse_loss(pred, target, batch["mask_latents"])
        # min-SNR-γ weights each sample's masked loss by its own timestep's
        # weight before the mean, as the JAX package does
        mask = batch["mask_latents"].float().expand(pred.shape)
        se = (pred.float() - target.float()) ** 2
        dims = tuple(range(1, pred.dim()))
        per_sample = (se * mask).sum(dims) / mask.sum(dims).clamp_min(1.0)
        snr = sched.snr(timesteps, dev)
        w = torch.minimum(snr, torch.tensor(float(snr_gamma), device=dev)) / snr.clamp_min(1e-8)
        return (per_sample * w).mean()

    return _trainer(loss_fn, optimizer, lora_trainable_filter(("A", "B", "mag")))


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
