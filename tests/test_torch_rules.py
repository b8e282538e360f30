"""Rules of the PyTorch/CUDA port that the code itself must keep.

* No file of fairygen_tpu_torch/ and not chip_smoke.py imports jax or
  fairygen_tpu (AST scan).
* An entry point called without ``device=`` on a machine with no card
  raises instead of running on the CPU.
* A kernel wrapper given a CUDA tensor launches its kernel or raises: its
  only branch to the plain version is on the tensor lying on the CPU, and
  it has no try/except around the launch.
"""
import ast
import inspect
import pathlib

import numpy as np
import pytest
import torch

from fairygen_tpu_torch import convert
from fairygen_tpu_torch.models.wan.dit import WanDiTConfig
from fairygen_tpu_torch.models.wan.text_encoder import UMT5Config
from fairygen_tpu_torch.models.wan.vae import WanVAEConfig
from fairygen_tpu_torch.ops import _kernels
from fairygen_tpu_torch.ops import flash_attention, fused_norms, fused_qk
from fairygen_tpu_torch.pipelines.wan_video import WanVideoPipeline

REPO = pathlib.Path(__file__).resolve().parent.parent
PORT_FILES = sorted((REPO / "fairygen_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(REPO)))
def test_port_imports_neither_jax_nor_the_jax_package(path):
    bad = [m for m in _imported_modules(path)
           if m.split(".")[0] in ("jax", "jaxlib", "fairygen_tpu")]
    assert not bad, f"{path} imports {bad}"


def test_the_scan_sees_the_whole_package():
    names = {p.name for p in PORT_FILES}
    assert {"dit.py", "vae.py", "wan_video.py", "_kernels.py", "chip_smoke.py"} <= names


@pytest.mark.parametrize("entry", ["pipeline", "from_jax_params", "init_dit", "init_umt5",
                                   "init_vae"])
def test_entry_points_raise_without_a_card(monkeypatch, entry):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    calls = {
        "pipeline": lambda: WanVideoPipeline({}, WanDiTConfig()),
        "from_jax_params": lambda: convert.from_jax_params({"w": np.zeros((2, 2))}),
        "init_dit": lambda: convert.init_dit_params(WanDiTConfig(num_layers=1)),
        "init_umt5": lambda: convert.init_umt5_params(UMT5Config.tiny()),
        "init_vae": lambda: convert.init_vae_params(WanVAEConfig.tiny()),
    }
    with pytest.raises(RuntimeError, match="no CUDA device"):
        calls[entry]()


WRAPPERS = [fused_norms.layer_norm_modulate, fused_qk.rms_rope_heads_major,
            flash_attention.flash_attention_heads_major]


@pytest.mark.parametrize("fn", WRAPPERS, ids=lambda f: f.__name__)
def test_wrappers_take_the_plain_path_only_for_cpu_tensors(fn):
    tree = ast.parse(inspect.getsource(fn))
    assert not any(isinstance(n, ast.Try) for n in ast.walk(tree)), "no fallback around a launch"
    branches = [n for n in ast.walk(tree) if isinstance(n, ast.If)
                and any(isinstance(c, ast.Call) and getattr(c.func, "id", "").endswith("_plain")
                        for s in n.body for c in ast.walk(s))]
    assert len(branches) == 1
    test = ast.unparse(branches[0].test)
    assert test.startswith("not ") and test.endswith(".is_cuda"), test
    assert "_kernels.launch" in inspect.getsource(fn)


def test_launch_raises_on_a_kernel_error_and_does_not_count(monkeypatch):
    class FakeLib:
        @staticmethod
        def fg_ln_modulate(*args):
            return 700  # cudaErrorIllegalAddress

    class FakeStream:
        cuda_stream = 0

    monkeypatch.setattr(_kernels, "lib", lambda: FakeLib)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda: FakeStream)
    _kernels.reset_launches()
    with pytest.raises(RuntimeError, match="cudaError 700"):
        _kernels.launch("ln_modulate", "fg_ln_modulate", 0, 0, 0, 0, 1, 1, 8, 0, 1e-6)
    assert _kernels.launches["ln_modulate"] == 0


def test_check_cuda_refuses_cpu_and_wrong_dtype():
    with pytest.raises(ValueError, match="CUDA"):
        _kernels.check_cuda(torch.zeros(4, dtype=torch.bfloat16), "x", torch.bfloat16, 1)


def test_build_command_is_one_plain_nvcc_for_sm90a(monkeypatch):
    monkeypatch.setattr(_kernels, "_nvcc", lambda: "nvcc")
    cmd = _kernels.build_command()
    assert cmd[:3] == ["nvcc", "-gencode", "arch=compute_90a,code=sm_90a"]
    assert [c for c in cmd if c.endswith(".cu")] == [
        str(_kernels.CSRC / s) for s in _kernels.SOURCES]
    assert cmd[cmd.index("-o") + 1].endswith("build/fairygen_tpu_torch/libfairygen_kernels.so")
    for src in _kernels.CSRC.glob("*.cu"):
        text = src.read_text()
        assert "torch/extension.h" not in text and 'extern "C"' in text
