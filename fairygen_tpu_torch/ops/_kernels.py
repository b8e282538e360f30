"""Build, load and count the hand-written CUDA kernels of the port.

All sources under ``fairygen_tpu_torch/csrc/`` have a plain ``extern "C"``
interface (device pointers, ints, the stream as ``void*``; each launcher
returns ``cudaGetLastError()``).  One ``nvcc`` command compiles them for
``sm_90a`` into ``build/fairygen_tpu_torch/libfairygen_kernels.so`` at the
repository root, at first use; the library is loaded with ``ctypes``.  No
source includes PyTorch's headers, so the build takes seconds.

``launches`` counts, per kernel, the launches made through the wrappers in
``ops/`` since the last :func:`reset_launches`.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
from typing import Dict, Optional

import torch

CSRC = pathlib.Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[2] / "build" / "fairygen_tpu_torch"
LIB_NAME = "libfairygen_kernels.so"
SOURCES = ("ln_modulate.cu", "rms_rope.cu", "flash_attention.cu", "flash_attention_train.cu")
KERNELS = ("ln_modulate", "rms_rope_heads_major", "flash_bounded", "flash_small_kv",
           "flash_fwd", "flash_fwd_lse", "flash_bwd_dq", "flash_bwd_dkv")

launches: Dict[str, int] = {k: 0 for k in KERNELS}

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    "fg_ln_modulate": [_P, _P, _P, _P, _I, _I, _I, _I, ctypes.c_float, _P],
    "fg_rms_rope_heads_major": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    "fg_flash_bounded": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    "fg_flash_small_kv": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    "fg_flash_fwd": [_P, _P, _P, _P, _I, _I, _I, _I, _P],
    "fg_flash_fwd_lse": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    "fg_flash_bwd_dq": [_P, _P, _P, _P, _P, _P, _P, _F, _I, _I, _I, _I, _P],
    "fg_flash_bwd_dkv": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
}

_lib: Optional[ctypes.CDLL] = None


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = pathlib.Path(home) / "bin" / "nvcc"
    found = str(cand) if cand.exists() else shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")
    return found


def _digest() -> str:
    h = hashlib.sha256()
    for name in SOURCES:
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()


def build_command(verbose: bool = False):
    cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
           "-shared", "-Xcompiler", "-fPIC"]
    if verbose:
        cmd += ["-Xptxas", "-v"]
    return cmd + ["-o", str(BUILD_DIR / LIB_NAME)] + [str(CSRC / s) for s in SOURCES]


def build(verbose: bool = False, force: bool = False, timeout: Optional[float] = None) -> str:
    """Compile every source into the shared library unless an up-to-date
    build exists (or ``force``).  Returns the compiler's output ('' when
    nothing ran)."""
    lib_path = BUILD_DIR / LIB_NAME
    stamp = BUILD_DIR / (LIB_NAME + ".sha256")
    digest = _digest()
    if not force and lib_path.exists() and stamp.exists() and stamp.read_text() == digest:
        return ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    r = subprocess.run(build_command(verbose), capture_output=True, text=True, timeout=timeout)
    if r.returncode != 0:
        raise RuntimeError(f"nvcc failed ({r.returncode}):\n{r.stdout}\n{r.stderr}")
    stamp.write_text(digest)
    return r.stdout + r.stderr


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built first if needed)."""
    global _lib
    if _lib is None:
        build()
        handle = ctypes.CDLL(str(BUILD_DIR / LIB_NAME))
        for fn, argtypes in _SIGNATURES.items():
            f = getattr(handle, fn)
            f.argtypes = argtypes
            f.restype = ctypes.c_int
        _lib = handle
    return _lib


def check_cuda(t: torch.Tensor, name: str, dtype: torch.dtype, ndim: int) -> None:
    """Raise unless ``t`` is a contiguous, 16-byte aligned CUDA tensor of the
    given dtype and rank."""
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name}: expected {ndim} dims, got shape {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
    if t.data_ptr() % 16:
        raise ValueError(f"{name}: must be 16-byte aligned")


def launch(kernel: str, fn: str, *args) -> None:
    """Call launcher ``fn`` on the current stream; raise on a launch error;
    count the launch under ``kernel``."""
    stream = torch.cuda.current_stream().cuda_stream
    rc = getattr(lib(), fn)(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{fn} launch failed: cudaError {rc}")
    launches[kernel] += 1
