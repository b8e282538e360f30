"""Checkpoint IO (port of fairygen_tpu/core/io.py): safetensors files
without the safetensors package, torch pickles, and the architecture hash.

A safetensors file is an 8-byte little-endian header length, a JSON header
of ``name -> {dtype, shape, data_offsets}``, then the raw little-endian
tensor bytes.  Values are written from numpy arrays or tensors (a bf16
tensor keeps its bits, tag ``BF16``) and read back as numpy arrays; numpy
has no bfloat16, so ``BF16`` entries are widened to float32, which is
exact.

Architectures are detected from the md5 of the sorted ``key:shape``
strings of a checkpoint (:func:`hash_state_dict_keys`), the same strings
and so the same hashes as the JAX package and the upstream loader.
"""
from __future__ import annotations

import hashlib
import json
import os
import struct
from typing import Dict, Iterable, Optional

import numpy as np
import torch

__all__ = ["load_safetensors", "save_safetensors", "load_torch_pickle", "load_state_dict",
           "load_shapes", "hash_state_dict_keys", "hash_model_file"]

_ST_DTYPES = {
    "F64": np.float64,
    "F32": np.float32,
    "F16": np.float16,
    "I64": np.int64,
    "I32": np.int32,
    "I16": np.int16,
    "I8": np.int8,
    "U8": np.uint8,
    "BOOL": np.bool_,
}


def _tag(a: np.ndarray) -> str:
    for t, d in _ST_DTYPES.items():
        if a.dtype == np.dtype(d):
            return t
    raise ValueError(f"unsupported dtype {a.dtype}")


def _bytes_and_tag(v):
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu().contiguous()
        if v.dtype == torch.bfloat16:
            return v.view(torch.int16).numpy(), "BF16"
        v = v.numpy()
    a = np.ascontiguousarray(v)
    return a, _tag(a)


def save_safetensors(path: str, state_dict: Dict[str, object], metadata=None):
    """Write a flat dict of numpy arrays or tensors as .safetensors."""
    header = {}
    if metadata:
        header["__metadata__"] = {str(k): str(v) for k, v in metadata.items()}
    offset = 0
    bufs = []
    for name, v in state_dict.items():
        a, tag = _bytes_and_tag(v)
        header[name] = {"dtype": tag, "shape": list(a.shape),
                        "data_offsets": [offset, offset + a.nbytes]}
        bufs.append(a)
        offset += a.nbytes
    hj = json.dumps(header).encode()
    hj += b" " * ((8 - len(hj) % 8) % 8)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(hj)))
        f.write(hj)
        for a in bufs:
            f.write(a.tobytes())


def _read_header(path):
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        return json.loads(f.read(n)), 8 + n


def load_safetensors(path: str, dtype=None,
                     keys: Optional[Iterable[str]] = None) -> Dict[str, np.ndarray]:
    """Read a .safetensors file into numpy arrays (optionally only ``keys``,
    optionally cast to ``dtype``)."""
    header, data_start = _read_header(path)
    want = set(keys) if keys is not None else None
    mm = np.memmap(path, dtype=np.uint8, mode="r")
    out = {}
    for name, info in header.items():
        if name == "__metadata__" or (want is not None and name not in want):
            continue
        start, end = info["data_offsets"]
        raw = mm[data_start + start: data_start + end]
        if info["dtype"] == "BF16":
            arr = (raw.view(np.uint16).astype(np.uint32) << 16).view(np.float32)
        elif info["dtype"] in _ST_DTYPES:
            arr = raw.view(_ST_DTYPES[info["dtype"]])
        else:
            raise ValueError(f"unsupported safetensors dtype {info['dtype']}")
        arr = np.array(arr.reshape(info["shape"]))
        out[name] = arr if dtype is None else arr.astype(dtype)
    return out


def load_torch_pickle(path: str, dtype=None) -> Dict[str, np.ndarray]:
    """A torch .pth/.bin checkpoint (``torch.load(weights_only=True)``) as
    numpy arrays; a one-entry ``state_dict``/``module``/``model_state``
    wrapper is unwrapped, bf16 widens to float32, non-tensors are dropped."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if len(sd) == 1:
        for wrap in ("state_dict", "module", "model_state"):
            if wrap in sd:
                sd = sd[wrap]
                break
    out = {}
    for k, v in sd.items():
        if not isinstance(v, torch.Tensor):
            continue
        a = v.float().numpy() if v.dtype == torch.bfloat16 else v.numpy()
        out[k] = a if dtype is None else a.astype(dtype)
    return out


def load_state_dict(path, dtype=None) -> Dict[str, np.ndarray]:
    """One file (safetensors by its suffix, else a torch pickle) or a list
    of files merged into one state dict."""
    if isinstance(path, (list, tuple)):
        out = {}
        for p in path:
            out.update(load_state_dict(p, dtype))
        return out
    if path.endswith(".safetensors"):
        return load_safetensors(path, dtype=dtype)
    return load_torch_pickle(path, dtype=dtype)


def load_shapes(path) -> Dict[str, list]:
    """Key -> shape without reading tensor data (a safetensors header; a
    torch pickle is loaded)."""
    if isinstance(path, (list, tuple)):
        out = {}
        for p in path:
            out.update(load_shapes(p))
        return out
    if path.endswith(".safetensors"):
        header, _ = _read_header(path)
        return {k: v["shape"] for k, v in header.items() if k != "__metadata__"}
    return {k: list(v.shape) for k, v in load_torch_pickle(path).items()}


def _keys_to_str(shapes: Dict, with_shape=True) -> str:
    """The upstream loader's string: for each tensor both "key:shape" and
    the bare "key" enter the sorted, comma-joined list; a nested dict
    enters as "key|<its string>"."""
    keys = []
    for key, value in shapes.items():
        if not isinstance(key, str):
            continue
        if isinstance(value, dict):
            keys.append(key + "|" + _keys_to_str(value, with_shape))
        else:
            if with_shape:
                keys.append(key + ":" + "_".join(map(str, list(value))))
            keys.append(key)
    keys.sort()
    return ",".join(keys)


def hash_state_dict_keys(state_dict, with_shape=True) -> str:
    shapes = {k: (v if isinstance(v, dict) else list(np.shape(v))) for k, v in state_dict.items()}
    return hashlib.md5(_keys_to_str(shapes, with_shape).encode()).hexdigest()


def hash_model_file(path, with_shape=True) -> str:
    return hashlib.md5(_keys_to_str(load_shapes(path), with_shape).encode()).hexdigest()
