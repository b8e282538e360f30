"""Rules of the PyTorch/CUDA port that the code itself must keep.

* No file of fairygen_tpu_torch/ and not chip_smoke.py imports jax or
  fairygen_tpu (AST scan).
* An entry point (pipelines, initialisers, converters) called without
  ``device=`` on a machine with no card raises instead of running on the
  CPU.
* A kernel wrapper given a CUDA tensor launches its kernel or raises: its
  only branch to the plain version is on the tensor lying on the CPU, and
  it has no try/except around the launch.
"""
import ast
import inspect
import os
import pathlib

import numpy as np
import pytest
import torch

from fairygen_tpu_torch import convert
from fairygen_tpu_torch.core.model_pool import ModelPool
from fairygen_tpu_torch.examples import wan_batch_inference, wan_inference, wan_train
from fairygen_tpu_torch.models.flux.dit import FluxDiTConfig, convert_flux_dit_state_dict
from fairygen_tpu_torch.models.qwen.text_encoder import QwenVLTextConfig
from fairygen_tpu_torch.models.sdxl.clip import CLIPTextConfig
from fairygen_tpu_torch.models.sdxl.unet2d import UNet2DConfig, convert_unet2d_state_dict
from fairygen_tpu_torch.models.sdxl.vae import AutoencoderKLConfig
from fairygen_tpu_torch.models.wan.dit import WanDiTConfig
from fairygen_tpu_torch.models.wan.text_encoder import UMT5Config, convert_umt5_state_dict
from fairygen_tpu_torch.models.wan.vae import WanVAEConfig
from fairygen_tpu_torch.models.z_image.dit import ZImageDiTConfig
from fairygen_tpu_torch.ops import _kernels
from fairygen_tpu_torch.ops import flash_attention, fused_norms, fused_qk
from fairygen_tpu_torch.pipelines.flux_image import FluxImagePipeline
from fairygen_tpu_torch.pipelines.sdxl_brushnet import SDXLBrushNetPipeline
from fairygen_tpu_torch.pipelines.wan_video import WanVideoPipeline
from fairygen_tpu_torch.pipelines.z_image import ZImagePipeline
from fairygen_tpu_torch.training.runner import launch_training_task
from fairygen_tpu_torch.training.train_step import (make_wan_distill_train_step,
                                                    make_wan_sft_train_step)

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
    assert {"dit.py", "vae.py", "wan_video.py", "_kernels.py", "chip_smoke.py",
            "flux_image.py", "clip.py", "text_encoders.py", "params.py", "z_image.py",
            "text_encoder.py", "unet2d.py", "sdxl_brushnet.py", "dpm_solver.py",
            "dora_trainer.py", "vae_tiling.py", "temporal_tiler.py", "tokenizer.py",
            "video.py", "model_pool.py", "registry.py", "model_config.py", "dtypes.py",
            "wan_inference.py", "wan_batch_inference.py", "operators.py", "unified_dataset.py",
            "loader.py", "parsers.py", "data_process.py", "train_logging.py", "runner.py",
            "optimizers.py", "losses.py", "train_step.py", "wan_train.py",
            "merge_weights.py"} <= names
    assert REPO / "fairygen_tpu_torch" / "data" / "__init__.py" in PORT_FILES
    assert REPO / "fairygen_tpu_torch" / "models" / "z_image" / "dit.py" in PORT_FILES
    assert REPO / "fairygen_tpu_torch" / "models" / "qwen" / "text_encoder.py" in PORT_FILES


def _flux_sd(cfg):
    """The smallest state dict convert_flux_dit_state_dict reads (no blocks)."""
    dense = {"time_embedder.timestep_embedder.0": (cfg.dim, cfg.time_freq_dim),
             "time_embedder.timestep_embedder.2": (cfg.dim, cfg.dim),
             "pooled_text_embedder.0": (cfg.dim, cfg.pooled_dim),
             "pooled_text_embedder.2": (cfg.dim, cfg.dim),
             "context_embedder": (cfg.dim, cfg.context_dim), "x_embedder": (cfg.dim, cfg.in_dim),
             "final_norm_out.linear": (2 * cfg.dim, cfg.dim),
             "final_proj_out": (cfg.in_dim, cfg.dim),
             "guidance_embedder.timestep_embedder.0": (cfg.dim, cfg.time_freq_dim),
             "guidance_embedder.timestep_embedder.2": (cfg.dim, cfg.dim)}
    return {k + ".weight": np.zeros(s, np.float32) for k, s in dense.items()}


FLUX0 = FluxDiTConfig.tiny(num_double_blocks=0, num_single_blocks=0)
UNET0 = UNet2DConfig(down_block_types=(), up_block_types=(), mid_block_type=None,
                     addition_embed_type=None)
UNET0_SD = {f"time_embedding.linear_{i}.{k}": np.zeros((2, 2) if k == "weight" else 2)
            for i in (1, 2) for k in ("weight", "bias")}


@pytest.mark.parametrize("entry", ["pipeline", "from_jax_params", "init_dit", "init_umt5",
                                   "init_vae", "train_step", "flux_pipeline", "init_flux_dit",
                                   "init_t5", "init_clip_text", "init_autoencoder_kl",
                                   "convert_umt5", "convert_flux_dit", "zimage_pipeline",
                                   "init_z_image_dit", "init_qwen_text", "sdxl_pipeline",
                                   "init_unet2d", "convert_unet2d", "from_pretrained",
                                   "model_pool", "cli_twin", "batch_cli_twin",
                                   "train_cli_twin", "launch_training_task", "distill_step"])
def test_entry_points_raise_without_a_card(monkeypatch, entry):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    calls = {
        "pipeline": lambda: WanVideoPipeline({}, WanDiTConfig()),
        "from_jax_params": lambda: convert.from_jax_params({"w": np.zeros((2, 2))}),
        "init_dit": lambda: convert.init_dit_params(WanDiTConfig(num_layers=1)),
        "init_umt5": lambda: convert.init_umt5_params(UMT5Config.tiny()),
        "init_vae": lambda: convert.init_vae_params(WanVAEConfig.tiny()),
        "train_step": lambda: make_wan_sft_train_step(WanDiTConfig(num_layers=1), None),
        "flux_pipeline": lambda: FluxImagePipeline({}, FluxDiTConfig()),
        "init_flux_dit": lambda: convert.init_flux_dit_params(FLUX0),
        "init_t5": lambda: convert.init_t5_params(UMT5Config.tiny(shared_pos_bias=True)),
        "init_clip_text": lambda: convert.init_clip_text_params(CLIPTextConfig.tiny()),
        "init_autoencoder_kl": lambda: convert.init_autoencoder_kl_params(
            AutoencoderKLConfig.tiny()),
        "convert_umt5": lambda: convert_umt5_state_dict(
            {"token_embedding.weight": np.zeros((4, 2)), "norm.weight": np.zeros(2)},
            UMT5Config.tiny(num_layers=0)),
        "convert_flux_dit": lambda: convert_flux_dit_state_dict(_flux_sd(FLUX0), FLUX0),
        "zimage_pipeline": lambda: ZImagePipeline({}, ZImageDiTConfig()),
        "init_z_image_dit": lambda: convert.init_z_image_dit_params(
            ZImageDiTConfig.tiny(num_layers=0, num_refiner_layers=0)),
        "init_qwen_text": lambda: convert.init_qwen_text_params(QwenVLTextConfig.tiny()),
        "sdxl_pipeline": lambda: SDXLBrushNetPipeline({}, UNet2DConfig(), {},
                                                      AutoencoderKLConfig.sdxl()),
        "init_unet2d": lambda: convert.init_unet2d_params(UNET0),
        "convert_unet2d": lambda: convert_unet2d_state_dict(UNET0_SD, UNET0),
        "from_pretrained": lambda: WanVideoPipeline.from_pretrained([]),
        "model_pool": lambda: ModelPool().load([]),
        "cli_twin": lambda: wan_inference.main(["--model_paths", "[]", "--prompt", "x"]),
        "batch_cli_twin": lambda: wan_batch_inference.main(["--model_paths", "[]",
                                                            "--shot_dir", "."]),
        "train_cli_twin": lambda: wan_train.main(["--model_paths", "[]",
                                                  "--dataset_base_path", "."]),
        "launch_training_task": lambda: launch_training_task(None, None, [], None),
        "distill_step": lambda: make_wan_distill_train_step(WanDiTConfig(num_layers=1), None),
    }
    with pytest.raises(RuntimeError, match="no CUDA device"):
        calls[entry]()


def test_an_installed_port_carries_its_data_files():
    """The sdist's file list (MANIFEST.in, as setuptools reads it) and the
    wheel's package data (pyproject.toml) hold the model registry and every
    CUDA source the kernels are built from."""
    import tomllib

    from setuptools.command.egg_info import FileList

    want = {"fairygen_tpu_torch/configs/model_registry.json"} | {
        f"fairygen_tpu_torch/csrc/{name}" for name in _kernels.SOURCES + _kernels.HEADERS}
    assert len(want) == 8
    files = FileList()
    cwd = os.getcwd()
    os.chdir(REPO)
    try:
        for line in (REPO / "MANIFEST.in").read_text().splitlines():
            if line.strip():
                files.process_template_line(line)
    finally:
        os.chdir(cwd)
    assert want <= {f.replace(os.sep, "/") for f in files.files}
    data = tomllib.loads((REPO / "pyproject.toml").read_text())["tool"]["setuptools"]
    assert "fairygen_tpu_torch*" in data["packages"]["find"]["include"]
    shipped = set()
    for pkg, globs in data["package-data"].items():
        root = REPO.joinpath(*pkg.split("."))
        shipped |= {str(f.relative_to(REPO)).replace(os.sep, "/") for g in globs
                    for f in root.glob(g)}
    assert want <= shipped


WRAPPERS = [fused_norms.layer_norm_modulate, fused_qk.rms_rope_heads_major,
            flash_attention.flash_attention_heads_major, flash_attention.flash_fwd,
            flash_attention.flash_bwd_dq, flash_attention.flash_bwd_dkv,
            fused_qk.rms_rope_heads_major_per_head, fused_qk.rms_rope_heads_major_joint,
            flash_attention.flash_attention_bias_heads_major, fused_norms.fused_rms_modulate,
            fused_norms.fused_vae_rms_silu, flash_attention.flash_small_kv_max]


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


@pytest.mark.parametrize("grad_of", ["q", "k", "v", "bias"])
def test_bias_attention_refuses_a_gradient(grad_of):
    """K10 is forward-only: asking it for a gradient raises instead of
    silently dropping one; without a gradient it runs."""
    g = torch.Generator().manual_seed(0)
    ts = {name: torch.randn((1, 8, 2, 128) if name != "bias" else (1, 8, 8), generator=g)
          for name in ("q", "k", "v", "bias")}
    ts[grad_of].requires_grad_(True)
    with pytest.raises(NotImplementedError, match="no backward"):
        flash_attention.flash_attention_bias(ts["q"], ts["k"], ts["v"], ts["bias"])
    with torch.no_grad():
        out = flash_attention.flash_attention_bias(ts["q"], ts["k"], ts["v"], ts["bias"])
    assert out.shape == (1, 8, 2, 128) and torch.isfinite(out).all()


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
    """One plain nvcc -c for sm_90a per source (they run at once), one link
    of their objects into the library; no source includes PyTorch."""
    monkeypatch.setattr(_kernels, "_nvcc", lambda: "nvcc")
    cmds = _kernels.compile_commands()
    assert [c[c.index("-c") + 1] for c in cmds] == [str(_kernels.CSRC / s)
                                                   for s in _kernels.SOURCES]
    link = _kernels.link_command()
    for cmd in cmds + [link]:
        assert cmd[:3] == ["nvcc", "-gencode", "arch=compute_90a,code=sm_90a"]
    assert [c for c in link if c.endswith(".o")] == [c[c.index("-o") + 1] for c in cmds]
    assert link[link.index("-o") + 1].endswith("build/fairygen_tpu_torch/libfairygen_kernels.so")
    assert sorted(p.name for p in _kernels.CSRC.glob("*.cu")) == sorted(_kernels.SOURCES)
    for src in _kernels.CSRC.glob("*.cu"):
        text = src.read_text()
        assert "torch/extension.h" not in text and 'extern "C"' in text


def test_every_header_is_in_the_build_digest(tmp_path, monkeypatch):
    """Each csrc/*.cuh is listed in HEADERS, so an edit to any header changes
    the digest that decides whether the library is rebuilt."""
    assert sorted(p.name for p in _kernels.CSRC.glob("*.cuh")) == sorted(_kernels.HEADERS)
    for src in _kernels.CSRC.glob("*.cu"):
        for inc in src.read_text().split("#include")[1:]:
            name = inc.split()[0].strip('"<>')
            if name.endswith(".cuh"):
                assert name in _kernels.HEADERS, f"{src.name} includes {name}"
    fake = tmp_path / "csrc"
    fake.mkdir()
    for name in _kernels.SOURCES + _kernels.HEADERS:
        (fake / name).write_bytes((_kernels.CSRC / name).read_bytes())
    monkeypatch.setattr(_kernels, "CSRC", fake)
    for name in _kernels.HEADERS:
        before = _kernels._digest()
        (fake / name).write_text((fake / name).read_text() + "\n// edited\n")
        assert _kernels._digest() != before, name
