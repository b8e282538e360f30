"""FLUX.1 VAE converters onto the shared AutoencoderKL (port of
fairygen_tpu/models/flux/vae.py).

The upstream FluxVAEEncoder/Decoder are the SD AutoencoderKL graph with 16
latent channels, no quant convs and a (shift, scale) latent normalization
that callers apply:
  encode:  z = (mean - shift_factor) * scaling_factor
  decode:  x = decode(z / scaling_factor + shift_factor)
"""
from __future__ import annotations

from ...core.params import to_tensors
from ..sdxl.vae import (AutoencoderKLConfig, attn_linear, resnet_weights, vae_decode,  # noqa: F401
                        vae_encode, weight_bias)


def convert_flux_vae_state_dict(sd, cfg: AutoencoderKLConfig, dtype=None, device="cuda"):
    """Upstream ``FluxVAEEncoder`` + ``FluxVAEDecoder`` state dicts (numpy,
    keys prefixed ``encoder.`` / ``decoder.``; each a flat ``blocks.{i}``
    list of resnets, samplers and attention) -> port params on ``device``."""
    def attn(pre):
        t = pre + ".transformer_blocks.0"
        return {"group_norm": weight_bias(sd, pre + ".norm"),
                **{k: attn_linear(sd, f"{t}.{k}") for k in ("to_q", "to_k", "to_v", "to_out")}}

    def mid(root, idx):
        return {"res1": resnet_weights(sd, f"{root}.blocks.{idx}"),
                "attn": attn(f"{root}.blocks.{idx + 1}"),
                "res2": resnet_weights(sd, f"{root}.blocks.{idx + 2}")}

    def stages(root, idx, n_res, sampler):
        out = []
        for i in range(len(cfg.block_out_channels)):
            st = {"resnets": []}
            for _ in range(n_res):
                st["resnets"].append(resnet_weights(sd, f"{root}.blocks.{idx}"))
                idx += 1
            if i != len(cfg.block_out_channels) - 1:
                st[sampler] = weight_bias(sd, f"{root}.blocks.{idx}.conv")
                idx += 1
            out.append(st)
        return out, idx

    # encoder: [res x L, down] x (n-1), res x L, then mid; decoder: mid,
    # then [res x (L+1), up] x (n-1), res x (L+1)
    down, idx = stages("encoder", 0, cfg.layers_per_block, "downsamplers")
    up, _ = stages("decoder", 3, cfg.layers_per_block + 1, "upsamplers")
    params = {
        "encoder": {"conv_in": weight_bias(sd, "encoder.conv_in"), "down_blocks": down,
                    "mid": mid("encoder", idx),
                    "conv_norm_out": weight_bias(sd, "encoder.conv_norm_out"),
                    "conv_out": weight_bias(sd, "encoder.conv_out")},
        "decoder": {"conv_in": weight_bias(sd, "decoder.conv_in"), "mid": mid("decoder", 0),
                    "up_blocks": up, "conv_norm_out": weight_bias(sd, "decoder.conv_norm_out"),
                    "conv_out": weight_bias(sd, "decoder.conv_out")},
    }
    return to_tensors(params, device, dtype)


def convert_flux_vae_bfl_state_dict(sd, cfg: AutoencoderKLConfig, dtype=None, device="cuda"):
    """BFL ``ae.safetensors`` naming (encoder.down.{i}.block.{j}, decoder.up.{i}
    stored in REVERSED order, mid.block_1 / attn_1 / block_2, norm_out),
    numpy -> port params on ``device``."""
    def attn(pre):
        names = (("to_q", "q"), ("to_k", "k"), ("to_v", "v"), ("to_out", "proj_out"))
        return {"group_norm": weight_bias(sd, pre + ".norm"),
                **{k: attn_linear(sd, f"{pre}.{n}") for k, n in names}}

    def res(pre):
        return resnet_weights(sd, pre, shortcut="nin_shortcut")

    def mid(root):
        return {"res1": res(root + ".mid.block_1"), "attn": attn(root + ".mid.attn_1"),
                "res2": res(root + ".mid.block_2")}

    n = len(cfg.block_out_channels)
    down = []
    for i in range(n):
        st = {"resnets": [res(f"encoder.down.{i}.block.{j}") for j in range(cfg.layers_per_block)]}
        if i != n - 1:
            st["downsamplers"] = weight_bias(sd, f"encoder.down.{i}.downsample.conv")
        down.append(st)
    up = []
    for k in range(n):  # execution order; BFL stores it reversed
        i = n - 1 - k
        st = {"resnets": [res(f"decoder.up.{i}.block.{j}")
                          for j in range(cfg.layers_per_block + 1)]}
        if k != n - 1:
            st["upsamplers"] = weight_bias(sd, f"decoder.up.{i}.upsample.conv")
        up.append(st)
    params = {
        "encoder": {"conv_in": weight_bias(sd, "encoder.conv_in"), "down_blocks": down,
                    "mid": mid("encoder"), "conv_norm_out": weight_bias(sd, "encoder.norm_out"),
                    "conv_out": weight_bias(sd, "encoder.conv_out")},
        "decoder": {"conv_in": weight_bias(sd, "decoder.conv_in"), "mid": mid("decoder"),
                    "up_blocks": up, "conv_norm_out": weight_bias(sd, "decoder.norm_out"),
                    "conv_out": weight_bias(sd, "decoder.conv_out")},
    }
    return to_tensors(params, device, dtype)
