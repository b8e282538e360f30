"""Build, load and count the hand-written CUDA kernels of the port.

All sources under ``fairygen_tpu_torch/csrc/`` have a plain ``extern "C"``
interface (device pointers, ints, the stream as ``void*``; each launcher
returns ``cudaGetLastError()``).  At first use one ``nvcc -c`` per source
runs for ``sm_90a``, all at once, and one link makes
``build/fairygen_tpu_torch/libfairygen_kernels.so`` at the repository root;
the library is loaded with ``ctypes``.  No source includes PyTorch's
headers, so the build takes seconds.

``launches`` counts, per kernel, the launches made through the wrappers in
``ops/`` since the last :func:`reset_launches`.  K4's three forms count
apart (``flash_small_kv`` bounded, ``flash_small_kv_max``,
``flash_small_kv_masked``), K5 counts per head dim (``flash_fwd`` at
128, ``flash_fwd_d64`` at 64: two instantiations of one template), K4's
max and masked forms and K5 at SD1.5's head dims 8, 40, 80 and 160 count
apart from those at 64 and 128 (``flash_small_kv_max_d80``,
``flash_small_kv_masked_d8``, ``flash_fwd_d40`` ...), so do K6a-c in bf16
(``flash_fwd_lse``, ``flash_bwd_dq``, ``flash_bwd_dkv`` at 128;
``flash_fwd_lse_d64``, ``flash_bwd_dq_d64``, ``flash_bwd_dkv_d64`` at 64), and
K6a-c's fp32 forms at head dim 64 count apart from their bf16 ones
(``flash_fwd_lse_f32``, ``flash_bwd_dq_f32``, ``flash_bwd_dkv_f32``), and
K5 and K4's max and masked forms in fp32 count per head dim, apart from
their bf16 forms (``flash_fwd_f32_d40``, ``flash_small_kv_max_f32_d64``,
``flash_small_kv_masked_f32_d8`` ..., at d 8, 16, 40, 64, 80 and 160).
The fp32 kernels on the tensor cores have three helper kernels with
counters of their own: ``flash_fwd_prep_f32``, the pre-pass that writes a
forward call's TF32 hi / lo K and V^T (one launch a K6a, K5 or K4 call in
fp32); ``flash_bwd_prep_f32``, the
pre-pass that writes a backward call's TF32 hi / lo operands (one launch a
K6b call and one a K6c call); and ``flash_bwd_dkv_reduce_f32``, which sums
the fp32 K6c's split partials (one launch a K6c call whose query loop is
split).  One fp32 ``flash_attention`` call with a gradient thus launches
K6a-c once each, ``flash_fwd_prep_f32`` once, ``flash_bwd_prep_f32`` twice
and, where K6c splits, the reduce once.
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
SOURCES = ("ln_modulate.cu", "rms_rope.cu", "flash_attention.cu", "flash_attention_online.cu",
           "rms_modulate.cu", "flash_attention_bwd.cu", "flash_attention_fp32.cu",
           "flash_attention_fp32_bwd.cu")
HEADERS = ("hopper_common.cuh", "hopper_tf32.cuh")
KERNELS = ("ln_modulate", "rms_rope_heads_major", "flash_bounded", "flash_small_kv",
           "flash_fwd", "flash_fwd_lse", "flash_bwd_dq", "flash_bwd_dkv",
           "rms_rope_per_head", "rms_rope_joint", "flash_bias", "rms_modulate", "vae_rms_silu",
           "flash_small_kv_max", "flash_small_kv_masked", "flash_fwd_d64",
           "flash_fwd_lse_f32", "flash_bwd_dq_f32", "flash_bwd_dkv_f32",
           "flash_bwd_prep_f32", "flash_bwd_dkv_reduce_f32", "flash_fwd_prep_f32",
           "flash_fwd_lse_d64", "flash_bwd_dq_d64", "flash_bwd_dkv_d64") + tuple(
               f"{form}_d{d}" for form in ("flash_fwd", "flash_small_kv_max",
                                           "flash_small_kv_masked") for d in (8, 40, 80, 160)) + tuple(
               f"{form}_f32_d{d}" for form in ("flash_fwd", "flash_small_kv_max",
                                               "flash_small_kv_masked")
               for d in (8, 16, 40, 64, 80, 160))

launches: Dict[str, int] = {k: 0 for k in KERNELS}

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong
_SIGNATURES = {
    "fg_ln_modulate": [_P, _P, _P, _P, _I, _I, _I, _I, ctypes.c_float, _P],
    "fg_rms_rope_heads_major": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    "fg_flash_bounded": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    "fg_flash_small_kv": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    "fg_flash_fwd": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    "fg_flash_fwd_lse": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    "fg_flash_bwd_dq": [_P, _P, _P, _P, _P, _P, _P, _F, _I, _I, _I, _I, _I, _P],
    "fg_flash_bwd_dkv": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    "fg_rms_rope_per_head": [_P, _L, _P, _P, _P, _P, _I, _I, _I, _I, _F, _P],
    "fg_rms_rope_joint": [_P, _L, _P, _L, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _P],
    "fg_flash_bias": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    "fg_rms_modulate": [_P, _P, _P, _P, _I, _I, _I, _I, _F, _P],
    "fg_vae_rms_silu": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    "fg_vae_rms_silu_smem_bytes": [_I, _I, _I],
    "fg_flash_small_kv_max": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    "fg_flash_fwd_prep_f32": [_P, _P, _P, _I, _I, _I, _P],
    "fg_flash_fwd_f32_tc": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    "fg_flash_bwd_prep_f32": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    "fg_flash_bwd_dq_f32_tc": [_P, _P, _P, _P, _F, _I, _I, _I, _I, _P],
    "fg_flash_bwd_dkv_f32_tc": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    "fg_flash_bwd_dkv_reduce_f32": [_P, _P, _P, _I, _I, _P],
    "fg_flash_bounded_smem_bytes": [],
    "fg_flash_online_smem_bytes": [_I],
    "fg_flash_bwd_smem_bytes": [_I],
    "fg_flash_f32_smem_bytes": [_I],
    "fg_flash_f32_tc_smem_bytes": [_I],
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
    for name in SOURCES + HEADERS:
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()


def _flags():
    return ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3"]


def compile_commands(verbose: bool = False):
    """One ``nvcc -c`` per source, each into its object under BUILD_DIR."""
    extra = ["-Xptxas", "-v"] if verbose else []
    return [[_nvcc()] + _flags() + ["-Xcompiler", "-fPIC"] + extra +
            ["-c", str(CSRC / s), "-o", str(BUILD_DIR / (s + ".o"))] for s in SOURCES]


def link_command():
    return [_nvcc()] + _flags() + ["-shared", "-o", str(BUILD_DIR / LIB_NAME)] + \
        [str(BUILD_DIR / (s + ".o")) for s in SOURCES]


def build(verbose: bool = False, force: bool = False, timeout: Optional[float] = None) -> str:
    """Compile every source into the shared library unless an up-to-date
    build exists (or ``force``): all the ``nvcc -c`` at once, then one link.
    Returns the compilers' output ('' when nothing ran)."""
    lib_path = BUILD_DIR / LIB_NAME
    stamp = BUILD_DIR / (LIB_NAME + ".sha256")
    digest = _digest()
    if not force and lib_path.exists() and stamp.exists() and stamp.read_text() == digest:
        return ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cmds = compile_commands(verbose)
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    logs, failed = [], []
    for cmd, p in zip(cmds, procs):
        try:
            out, _ = p.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
                q.wait()
            raise
        logs.append(out)
        if p.returncode != 0:
            failed.append(f"{cmd[cmd.index('-c') + 1]} ({p.returncode}):\n{out}")
    if failed:
        raise RuntimeError("nvcc failed: " + "\n".join(failed))
    r = subprocess.run(link_command(), capture_output=True, text=True, timeout=timeout)
    if r.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({r.returncode}):\n{r.stdout}\n{r.stderr}")
    stamp.write_text(digest)
    return "".join(logs) + r.stdout + r.stderr


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
