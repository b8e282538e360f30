"""ISNet (DIS) foreground segmentation, the mask stage of FairyGen (port of
fairygen_tpu/models/isnet.py: ``ISNetConfig``, the RSU stages,
``isnet_forward``, ``_fold_bn`` + ``convert_isnet_state_dict``,
``init_isnet_params``, ``PRESETS`` and ``extract_mask``).

ISNetDIS ("Highly Accurate Dichotomous Image Segmentation", Qin et al.,
ECCV 2022; the network inside rembg's isnet-anime session): conv_in (3 ->
64, stride 2) -> encoder RSU7/6/5/4/4F/4F with 2x2 ceil-mode max pools ->
a mirrored decoder with skip concatenations -> six 1-channel side heads,
each resized to the input and passed through a sigmoid; the first (d1) is
the mask.  Inference BatchNorm is folded into a per-channel scale and bias
when a checkpoint is converted.

Layouts: ``isnet_forward`` takes and returns channels-last tensors (B, H,
W, C), as the JAX function does; inside, the convolutions run
channels-first on torch's conv2d, and the conv weights are kept in torch's
(O, I, kh, kw) layout (the JAX package keeps HWIO).  Every resize is the
JAX package's ``jax.image.resize(..., "linear")``: half-pixel bilinear,
antialiased (a widened triangle filter) along an axis that shrinks, which
is ``F.interpolate(mode="bilinear", antialias=True)``; the network itself
only enlarges.  Plain PyTorch throughout, as the JAX module is plain XLA.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..core.params import generator, to_tensors
from ..device import resolve_device


@dataclasses.dataclass(frozen=True)
class ISNetConfig:
    in_ch: int = 3
    out_ch: int = 1
    # (rsu_height_or_0_for_F, in, mid, out) per encoder stage; the decoder
    # mirrors them (isnet.py ISNetDIS.__init__)
    stages: Tuple[Tuple[int, int, int, int], ...] = (
        (7, 64, 32, 64),
        (6, 64, 32, 128),
        (5, 128, 64, 256),
        (4, 256, 128, 512),
        (0, 512, 256, 512),   # RSU4F
        (0, 512, 256, 512),   # RSU4F
    )
    conv_in_ch: int = 64

    @staticmethod
    def dis() -> "ISNetConfig":
        return ISNetConfig()

    @staticmethod
    def tiny() -> "ISNetConfig":
        """Scaled-down config for tests."""
        return ISNetConfig(stages=((7, 8, 4, 8), (6, 8, 4, 16), (5, 16, 8, 32),
                                   (4, 32, 16, 64), (0, 64, 32, 64), (0, 64, 32, 64)),
                           conv_in_ch=8)

    def decoder_stages(self) -> List[Tuple[int, int, int, int]]:
        """stage5d..stage1d, deepest first: stage{i}d has the height of
        encoder stage i, takes its output concatenated with the stage below,
        has its mid width (halved for stage1d) and gives its input width."""
        out: List[Tuple[int, int, int, int]] = []
        prev_out = self.stages[-1][3]
        for i in range(len(self.stages) - 1, 0, -1):
            height, enc_in, enc_mid, enc_out = self.stages[i - 1]
            mid = enc_mid if i > 1 else max(enc_mid // 2, 1)
            out.append((height, enc_out + prev_out, mid, enc_in))
            prev_out = enc_in
        return out


# -- primitives (channels-first inside) ---------------------------------------

def _conv(p: Dict[str, Any], x, *, stride: int = 1, dirate: int = 1, relu: bool = True):
    """3x3 conv + folded BN affine + ReLU (REBNCONV)."""
    y = F.conv2d(x, p["w"].to(x.dtype), stride=stride, padding=dirate, dilation=dirate)
    y = y * p["scale"].to(y.dtype)[:, None, None] + p["bias"].to(y.dtype)[:, None, None]
    return torch.relu(y) if relu else y


def _side(p: Dict[str, Any], x):
    """Plain 3x3 conv head (side1..side6)."""
    return F.conv2d(x, p["w"].to(x.dtype), p["b"].to(x.dtype), padding=1)


def _maxpool2(x):
    """2x2/2 max pool, ceil_mode=True."""
    return F.max_pool2d(x, 2, 2, ceil_mode=True)


def resize_linear(x, hw):
    """``jax.image.resize(..., "linear")`` of (B, C, H, W) to ``hw``:
    half-pixel bilinear, antialiased along an axis that shrinks."""
    shrink = hw[0] < x.shape[-2] or hw[1] < x.shape[-1]
    return F.interpolate(x, size=tuple(hw), mode="bilinear", align_corners=False,
                         antialias=shrink)


# -- RSU blocks ---------------------------------------------------------------

def _rsu_forward(p: Dict[str, Any], x, height: int):
    """RSU-L (RSU7..RSU4): a U-net inside a residual."""
    hxin = _conv(p["rebnconvin"], x)
    enc = [hxin]
    h = _conv(p["rebnconv1"], hxin)
    enc.append(h)
    for i in range(2, height):
        h = _conv(p[f"rebnconv{i}"], _maxpool2(h))
        enc.append(h)
    h = _conv(p[f"rebnconv{height}"], h, dirate=2)
    for i in range(height - 1, 0, -1):
        skip = enc[i]
        if h.shape[-2:] != skip.shape[-2:]:
            h = resize_linear(h, skip.shape[-2:])
        h = _conv(p[f"rebnconv{i}d"], torch.cat([h, skip], 1))
    return h + hxin


def _rsu4f_forward(p: Dict[str, Any], x):
    """RSU4F: all dilated, no pooling."""
    hxin = _conv(p["rebnconvin"], x)
    h1 = _conv(p["rebnconv1"], hxin, dirate=1)
    h2 = _conv(p["rebnconv2"], h1, dirate=2)
    h3 = _conv(p["rebnconv3"], h2, dirate=4)
    h4 = _conv(p["rebnconv4"], h3, dirate=8)
    h3d = _conv(p["rebnconv3d"], torch.cat([h4, h3], 1), dirate=4)
    h2d = _conv(p["rebnconv2d"], torch.cat([h3d, h2], 1), dirate=2)
    h1d = _conv(p["rebnconv1d"], torch.cat([h2d, h1], 1), dirate=1)
    return h1d + hxin


def _stage(p, x, height):
    return _rsu4f_forward(p, x) if height == 0 else _rsu_forward(p, x, height)


# -- the network -----------------------------------------------------------------

def isnet_forward(params: Dict[str, Any], cfg: ISNetConfig, x):
    """x: (B, H, W, 3) normalized input -> the 6 sigmoid side maps (B, H, W,
    1) in fp32, d1 (the mask) first."""
    in_hw = x.shape[1:3]
    h = _conv(params["conv_in"], x.permute(0, 3, 1, 2), stride=2)
    feats = []
    n = len(cfg.stages)
    for i, (height, *_rest) in enumerate(cfg.stages):
        h = _stage(params[f"stage{i + 1}"], h, height)
        feats.append(h)
        if i < n - 1:
            h = _maxpool2(h)
    dec_feats = [feats[-1]]
    h = feats[-1]
    for j, (height, *_rest) in enumerate(cfg.decoder_stages()):
        skip = feats[n - 2 - j]
        h = resize_linear(h, skip.shape[-2:])
        h = _stage(params[f"stage{n - 1 - j}d"], torch.cat([h, skip], 1), height)
        dec_feats.insert(0, h)
    sides = []
    for k in range(n):
        d = resize_linear(_side(params[f"side{k + 1}"], dec_feats[k]), in_hw)
        sides.append(torch.sigmoid(d.float()).permute(0, 2, 3, 1))
    return sides


# -- init and conversion ------------------------------------------------------------

def _rsu_layers(height, in_ch, mid_ch, out_ch):
    """(name, in, out) of an RSU's REBNCONVs."""
    layers = [("rebnconvin", in_ch, out_ch), ("rebnconv1", out_ch, mid_ch)]
    top = 4 if height == 0 else height
    layers += [(f"rebnconv{i}", mid_ch, mid_ch) for i in range(2, top + 1)]
    layers += [(f"rebnconv{i}d", mid_ch * 2, mid_ch) for i in range(top - 1, 1, -1)]
    return layers + [("rebnconv1d", mid_ch * 2, out_ch)]


def _side_channels(cfg: ISNetConfig):
    """side1..side6 read hx1d..hx5d and hx6."""
    return [d[3] for d in cfg.decoder_stages()[::-1]] + [cfg.stages[-1][3]]


def init_isnet_params(cfg: ISNetConfig, device="cuda", dtype=torch.float32, seed=0):
    """Random params at the JAX init's scales: conv weights N(0, 1/(9 in)),
    unit scale, zero bias and side bias; made on ``device``."""
    dev = resolve_device(device)
    g = generator(dev, seed)

    def conv(i, o):
        return torch.randn((o, i, 3, 3), generator=g, device=dev, dtype=dtype) * (9 * i) ** -0.5

    def rebn(i, o):
        return {"w": conv(i, o), "scale": torch.ones(o, device=dev, dtype=dtype),
                "bias": torch.zeros(o, device=dev, dtype=dtype)}

    params: Dict[str, Any] = {"conv_in": rebn(cfg.in_ch, cfg.conv_in_ch)}
    for i, (height, in_ch, mid, out) in enumerate(cfg.stages):
        params[f"stage{i + 1}"] = {k: rebn(a, b) for k, a, b in _rsu_layers(height, in_ch, mid,
                                                                             out)}
    for j, (height, in_ch, mid, out) in enumerate(cfg.decoder_stages()):
        params[f"stage{len(cfg.stages) - 1 - j}d"] = {
            k: rebn(a, b) for k, a, b in _rsu_layers(height, in_ch, mid, out)}
    for k, ch in enumerate(_side_channels(cfg)):
        params[f"side{k + 1}"] = {"w": conv(ch, cfg.out_ch),
                                  "b": torch.zeros(cfg.out_ch, device=dev, dtype=dtype)}
    return params


def _fold_bn(sd: Dict[str, np.ndarray], conv: str, bn: str, eps=1e-5):
    """torch Conv2d + BatchNorm2d (inference) -> OIHW w + scale / bias."""
    w = np.asarray(sd[f"{conv}.weight"], np.float32)  # (O, I, kh, kw)
    b = np.asarray(sd.get(f"{conv}.bias", np.zeros(w.shape[0])), np.float32)
    gamma = np.asarray(sd[f"{bn}.weight"], np.float32)
    beta = np.asarray(sd[f"{bn}.bias"], np.float32)
    mean = np.asarray(sd[f"{bn}.running_mean"], np.float32)
    var = np.asarray(sd[f"{bn}.running_var"], np.float32)
    scale = gamma / np.sqrt(var + eps)
    return {"w": w, "scale": scale, "bias": beta + (b - mean) * scale}


def convert_isnet_state_dict(sd: Dict[str, np.ndarray], cfg: ISNetConfig = None,
                             dtype=torch.float32, device="cuda"):
    """A DIS ``isnet.py`` torch state dict (the tensors of rembg's
    isnet-anime / isnet-general-use too, which share the naming:
    ``conv_in.conv/bn``, ``stage{N}[d].rebnconv{K}[d].conv_s1/bn_s1``,
    ``side{N}.weight/bias``) -> (params on ``device``, cfg)."""
    dev = resolve_device(device)
    cfg = cfg or ISNetConfig.dis()

    def rsu(prefix, height):
        return {k: _fold_bn(sd, f"{prefix}.{k}.conv_s1", f"{prefix}.{k}.bn_s1")
                for k, _, _ in _rsu_layers(height, 1, 1, 1)}

    params: Dict[str, Any] = {"conv_in": _fold_bn(sd, "conv_in.conv", "conv_in.bn")}
    for i, (height, *_r) in enumerate(cfg.stages):
        params[f"stage{i + 1}"] = rsu(f"stage{i + 1}", height)
    for j, (height, *_r) in enumerate(cfg.decoder_stages()):
        idx = len(cfg.stages) - 1 - j
        params[f"stage{idx}d"] = rsu(f"stage{idx}d", height)
    for k in range(len(cfg.stages)):
        params[f"side{k + 1}"] = {"w": np.asarray(sd[f"side{k + 1}.weight"], np.float32),
                                  "b": np.asarray(sd[f"side{k + 1}.bias"], np.float32)}
    return to_tensors(params, dev, dtype), cfg


# -- rembg-compatible mask extraction ------------------------------------------------

# rembg session presets: (input size, mean, std) per model family
PRESETS = {
    # rembg/sessions/dis_anime.py: 1024px, mean .485/.456/.406, std 1
    "isnet-anime": ((1024, 1024), (0.485, 0.456, 0.406), (1.0, 1.0, 1.0)),
    # rembg/sessions/dis_general_use.py: 1024px, mean .5, std 1
    "isnet-general-use": ((1024, 1024), (0.5, 0.5, 0.5), (1.0, 1.0, 1.0)),
}


@torch.no_grad()
def extract_mask(params, cfg: ISNetConfig, image_u8: np.ndarray, preset: str = "isnet-anime",
                 threshold: int = 127, size=None) -> np.ndarray:
    """uint8 HWC image -> uint8 {0, 255} HW mask: rembg's DIS predict and
    the reference's binarization (the d1 side output min-max normalized,
    resized back, scaled to [0, 255], rounded, > ``threshold``).  Runs on
    the params' device.  ``size``: (h, w) inference resolution in place of
    the preset's (whose mean / std still apply)."""
    psize, mean, std = PRESETS[preset]
    size = size or psize
    h, w = image_u8.shape[:2]
    dev = params["conv_in"]["w"].device
    img = torch.as_tensor(np.asarray(image_u8, np.float32), device=dev) / 255.0
    x = resize_linear(img.permute(2, 0, 1)[None], size)[0].permute(1, 2, 0)
    x = (x - torch.tensor(mean, device=dev)) / torch.tensor(std, device=dev)
    d1 = isnet_forward(params, cfg, x[None])[0][0, :, :, 0]
    mi, ma = d1.min(), d1.max()
    pred = (d1 - mi) / torch.clamp(ma - mi, min=1e-8)
    pred = resize_linear(pred[None, None], (h, w))[0, 0]
    arr = torch.round(pred * 255.0).to(torch.uint8).cpu().numpy()
    return (arr > threshold).astype(np.uint8) * 255
