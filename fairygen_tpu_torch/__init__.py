"""fairygen_tpu_torch: the PyTorch/CUDA port of fairygen_tpu for NVIDIA Hopper.

The JAX package ``fairygen_tpu`` is the reference; this package mirrors its
module paths and public layouts.  Every Pallas kernel on a ported path has
a hand-written CUDA kernel here (``csrc/``, bound in ``ops/_kernels.py``)
and a plain PyTorch version beside it, which runs only for CPU tensors.
Entry points take ``device=`` (default ``"cuda"``) and raise when no card
is present unless the CPU is asked for.
"""
from .device import resolve_device

__all__ = ["resolve_device"]
