"""safetensors files without the safetensors package (port of the reading
and writing part of fairygen_tpu/core/io.py): an 8-byte little-endian
header length, a JSON header of ``name -> {dtype, shape, data_offsets}``,
then the raw little-endian tensor bytes.

Values are written from numpy arrays or tensors (a bf16 tensor keeps its
bits, tag ``BF16``) and read back as numpy arrays; numpy has no bfloat16,
so ``BF16`` entries are widened to float32, which is exact.
"""
from __future__ import annotations

import json
import os
import struct
from typing import Dict, Iterable, Optional

import numpy as np
import torch

__all__ = ["load_safetensors", "save_safetensors"]

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


def load_safetensors(path: str, dtype=None,
                     keys: Optional[Iterable[str]] = None) -> Dict[str, np.ndarray]:
    """Read a .safetensors file into numpy arrays (optionally only ``keys``,
    optionally cast to ``dtype``)."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
    data_start = 8 + n
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
