"""The port's Z-Image DiT and Qwen3 text encoder against the JAX package on
shared weights and against the committed upstream goldens, loaded through
the port's own converters; and those converters against the JAX converters
followed by ``convert.from_jax_params``.  fp32 on the CPU.

* the tiny DiT (head dim 24: the plain rms -> RoPE -> attention chain) and
  a tiny head-dim-128 DiT (K9, K7 and K3/K4 through their plain versions)
  against the JAX forward on its default CPU path and, for head dim 128,
  with its Pallas kernels in interpret mode (TPU gates opened): atol 2e-4,
  rtol 1e-3, the golden test's tolerance (sums in other orders through
  four blocks);
* Qwen3 on shared weights and against ``z_image_text.npz``: atol 2e-5,
  rtol 1e-4 on the unmasked rows, as tests/test_z_image_text.py;
* the DiT golden ``z_image_dit.npz``: atol 2e-4, rtol 1e-3, as
  tests/test_z_image_dit.py;
* the converters: the same tree, every leaf bit-equal.
"""
import importlib
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import fairygen_tpu.ops.fused_norms as j_fused_norms
import fairygen_tpu.ops.fused_qk as j_fused_qk
from fairygen_tpu.models.qwen import text_encoder as jqwen
from fairygen_tpu.models.z_image import dit as jdit
from fairygen_tpu_torch import convert
from fairygen_tpu_torch.models.adapters import leaves_with_path
from fairygen_tpu_torch.models.qwen import text_encoder as tqwen
from fairygen_tpu_torch.models.z_image import dit as tdit
from fairygen_tpu_torch.ops import _kernels

# the module, not the function fairygen_tpu.ops re-exports under its name
j_attention = importlib.import_module("fairygen_tpu.ops.attention")

QWEN_GOLDEN_CFG = dict(head_dim_override=8, qk_norm=True, attn_bias=False, num_layers=3)
# head dim 128 (dim 256, 2 heads); RoPE axes sum to 128
TINY128 = dict(dim=256, num_heads=2, in_channels=4, cap_feat_dim=48, num_layers=2,
               num_refiner_layers=1, axes_dims=(32, 48, 48))


def _t(a):
    return torch.from_numpy(np.array(a))


def _sd(path):
    g = np.load(path)
    return g, {k[3:]: g[k] for k in g.files if k.startswith("sd.")}


def _jtree(tree):
    if isinstance(tree, dict):
        return {k: _jtree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_jtree(v) for v in tree]
    return jnp.asarray(tree.numpy())


def _same_cfg(cls, cfg):
    """``cls`` built from the fields it shares with ``cfg``."""
    return cls(**{f: getattr(cfg, f) for f in cls.__dataclass_fields__
                  if f in cfg.__dataclass_fields__})


# ------------------------------------------------------------------ Qwen3
@pytest.mark.parametrize("form", ["qwen3", "qwen2.5"])
def test_qwen_text_matches_jax(form):
    """Shared random weights (perturbed norms), a padded batch of two: the
    penultimate state, the final-norm state and two raw layer outputs."""
    kw = dict(head_dim_override=16, qk_norm=True, attn_bias=False) if form == "qwen3" else {}
    cfg = tqwen.QwenVLTextConfig.tiny(num_layers=3, **kw)
    params = tqwen.init_qwen_text_params(cfg, "cpu", torch.float32, seed=4)
    g = torch.Generator().manual_seed(5)
    for _, t in leaves_with_path(params):
        t.add_(0.05 * torch.randn(t.shape, generator=g))
    jcfg, jparams = _same_cfg(jqwen.QwenVLTextConfig, cfg), _jtree(params)
    rng = np.random.default_rng(6)
    ids = rng.integers(0, cfg.vocab, (2, 11))
    mask = np.ones((2, 11), np.int64)
    mask[1, 7:] = 0
    m = mask[..., None].astype(bool)
    for kw in (dict(hidden_state_index=-2), {}, dict(hidden_state_indices=(1, 2))):
        out = tqwen.qwen_vl_text_encode(params, cfg, _t(ids), attention_mask=_t(mask), **kw)
        ref = jqwen.qwen_vl_text_encode(jparams, jcfg, jnp.asarray(ids),
                                        attention_mask=jnp.asarray(mask), **kw)
        outs, refs = (out, ref) if isinstance(out, list) else ([out], [ref])
        assert len(outs) == len(refs)
        for o, r in zip(outs, refs):
            assert tuple(o.shape) == (2, 11, cfg.dim)
            np.testing.assert_allclose(o.numpy() * m, np.asarray(r) * m, atol=2e-5, rtol=1e-4)


def test_qwen3_penultimate_matches_golden():
    g, sd = _sd("tests/goldens/z_image_text.npz")
    cfg = tqwen.QwenVLTextConfig.tiny(**QWEN_GOLDEN_CFG)
    params = tqwen.convert_qwen_vl_text_state_dict(sd, cfg, device="cpu")
    out = tqwen.qwen_vl_text_encode(params, cfg, _t(g["ids"]), attention_mask=_t(g["mask"]),
                                    hidden_state_index=-2)
    mask = g["mask"][..., None].astype(bool)
    np.testing.assert_allclose(out.numpy() * mask, g["out"] * mask, atol=2e-5, rtol=1e-4)


@pytest.mark.parametrize("arg", ["image_embeds", "position_ids", "inputs_embeds"])
def test_qwen_multimodal_inputs_raise(arg):
    cfg = tqwen.QwenVLTextConfig.tiny()
    params = tqwen.init_qwen_text_params(cfg, "cpu", torch.float32)
    with pytest.raises(NotImplementedError, match="Qwen-Image"):
        tqwen.qwen_vl_text_encode(params, cfg, torch.zeros((1, 3), dtype=torch.long),
                                  **{arg: torch.zeros(1)})


def test_qwen3_4b_preset():
    c = tqwen.QwenVLTextConfig.qwen3_4b()
    assert c == _same_cfg(tqwen.QwenVLTextConfig, jqwen.QwenVLTextConfig.qwen3_4b())
    assert c.head_dim == 128 and c.num_heads * c.head_dim == 4096 != c.dim


# ------------------------------------------------------------------ DiT
def _dit_inputs(cfg_kw, lat_hw, lc):
    jcfg = jdit.ZImageDiTConfig.tiny(**cfg_kw)
    rng = np.random.default_rng(sum(lat_hw) + lc)
    jp = jdit.init_z_image_dit_params(jax.random.key(0), jcfg)
    # perturbed norms and pad tokens, so every parameter matters
    jp = jax.tree.map(lambda a: (np.asarray(a) + 0.05 * rng.standard_normal(a.shape))
                      .astype(np.float32), jp)
    inputs = (rng.standard_normal((1, jcfg.in_channels) + lat_hw).astype(np.float32),
              np.array([0.37], np.float32),
              rng.standard_normal((1, lc, jcfg.cap_feat_dim)).astype(np.float32))
    return jcfg, jp, inputs


@pytest.mark.parametrize("case", ["tiny", "head-dim-128"])
def test_dit_matches_jax(case):
    """head dim 24 (plain chain) on 16x24 latents; head dim 128 on 32x32
    latents: 256 image tokens, so K9's gate (S >= 256) opens on the image
    stream and the unified stream, and 20 caption tokens (padded to 32)
    take the plain formula and K4's plain version."""
    cfg_kw, hw, lc = ({}, (16, 24), 7) if case == "tiny" else (TINY128, (32, 32), 20)
    jcfg, jp, inp = _dit_inputs(cfg_kw, hw, lc)
    tcfg = _same_cfg(tdit.ZImageDiTConfig, jcfg)
    params = convert.from_jax_params(jp, device="cpu")
    out = tdit.z_image_dit_forward(params, tcfg, *(_t(a) for a in inp)).numpy()
    jargs = (jax.tree.map(jnp.asarray, jp),) + tuple(jnp.asarray(a) for a in inp)

    def jax_forward():  # traced anew each call, so the gates read the patches
        return np.asarray(jax.jit(lambda p, *a: jdit.z_image_dit_forward(p, jcfg, *a))(*jargs))

    assert out.shape == (1, jcfg.in_channels) + hw
    np.testing.assert_allclose(out, jax_forward(), atol=2e-4, rtol=1e-3)
    if case == "tiny":
        return
    with pltpu.force_tpu_interpret_mode(), \
            mock.patch.object(j_fused_qk, "_on_tpu", lambda: True), \
            mock.patch.object(j_fused_norms, "_on_tpu", lambda: True), \
            mock.patch.object(j_attention, "_on_tpu", lambda: True):
        kern = jax_forward()
    np.testing.assert_allclose(out, kern, atol=2e-4, rtol=1e-3)


def test_dit_matches_golden():
    """model_fn_z_image: t -> (1000 - t)/1000, the output negated."""
    g, sd = _sd("tests/goldens/z_image_dit.npz")
    cfg = tdit.ZImageDiTConfig.tiny()
    params = tdit.convert_z_image_dit_state_dict(sd, cfg, device="cpu")
    t = (1000.0 - _t(g["timestep"])) / 1000.0
    out = -tdit.z_image_dit_forward(params, cfg, _t(g["latents"]), t, _t(g["cap"]))
    np.testing.assert_allclose(out.numpy(), g["out"], atol=2e-4, rtol=1e-3)


def test_dit_remat_keeps_output_and_gradients():
    jcfg, jp, inp = _dit_inputs({}, (8, 8), 5)
    cfg = _same_cfg(tdit.ZImageDiTConfig, jcfg)
    results = []
    for remat in (False, True):
        params = convert.from_jax_params(jp, device="cpu")
        leaves = [t.requires_grad_(True) for _, t in leaves_with_path(params["layers"])]
        out = tdit.z_image_dit_forward(params, cfg, *(_t(a) for a in inp), remat=remat)
        results.append((out.detach(), torch.autograd.grad(out.square().sum(), leaves)))
    (o0, g0), (o1, g1) = results
    torch.testing.assert_close(o1, o0, rtol=0, atol=0)
    for a, b in zip(g1, g0):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-5)


def test_dit_cpu_forward_launches_no_kernel():
    jcfg, jp, inp = _dit_inputs(TINY128, (32, 32), 20)
    _kernels.reset_launches()
    tdit.z_image_dit_forward(convert.from_jax_params(jp, device="cpu"),
                             _same_cfg(tdit.ZImageDiTConfig, jcfg), *(_t(a) for a in inp))
    assert not any(_kernels.launches.values())


def test_z_image_preset_has_the_published_widths():
    c = tdit.ZImageDiTConfig.z_image()
    assert c == _same_cfg(tdit.ZImageDiTConfig, jdit.ZImageDiTConfig.z_image())
    assert (c.dim, c.num_heads, c.head_dim, c.num_layers, c.num_refiner_layers) == \
        (3840, 30, 128, 30, 2)
    assert sum(c.axes_dims) == c.head_dim and int(c.dim / 3 * 8) == 10240


# ------------------------------------------------------------------ converters
def _assert_same_tree(port, jax_tree):
    ref = dict(leaves_with_path(convert.from_jax_params(jax.tree.map(np.asarray, jax_tree),
                                                        device="cpu")))
    got = dict(leaves_with_path(port))
    assert set(got) == set(ref)
    for path, t in got.items():
        r = ref[path]
        assert t.dtype == r.dtype and t.shape == r.shape and t.is_contiguous(), path
        assert torch.equal(t, r), path


def test_z_image_dit_converter():
    _, sd = _sd("tests/goldens/z_image_dit.npz")
    _assert_same_tree(
        tdit.convert_z_image_dit_state_dict(sd, tdit.ZImageDiTConfig.tiny(), device="cpu"),
        jdit.convert_z_image_dit_state_dict(sd, jdit.ZImageDiTConfig.tiny()))


@pytest.mark.parametrize("prefix", ["", "model."])
def test_qwen_text_converter(prefix):
    _, sd = _sd("tests/goldens/z_image_text.npz")
    sd = {prefix + k: v for k, v in sd.items()}
    _assert_same_tree(
        tqwen.convert_qwen_vl_text_state_dict(sd, tqwen.QwenVLTextConfig.tiny(**QWEN_GOLDEN_CFG),
                                              device="cpu"),
        jqwen.convert_qwen_vl_text_state_dict(sd, jqwen.QwenVLTextConfig.tiny(**QWEN_GOLDEN_CFG)))


def test_init_trees_match_the_converters():
    """The seeded inits make the converters' trees (paths and shapes)."""
    dcfg = tdit.ZImageDiTConfig.tiny()
    _, sd = _sd("tests/goldens/z_image_dit.npz")
    conv = tdit.convert_z_image_dit_state_dict(sd, dcfg, device="cpu")
    init = convert.init_z_image_dit_params(dcfg, "cpu", torch.float32)
    qcfg = tqwen.QwenVLTextConfig.tiny(**QWEN_GOLDEN_CFG)
    _, qsd = _sd("tests/goldens/z_image_text.npz")
    qconv = tqwen.convert_qwen_vl_text_state_dict(qsd, qcfg, device="cpu")
    qinit = convert.init_qwen_text_params(qcfg, "cpu", torch.float32)
    for a, b in ((init, conv), (qinit, qconv)):
        shapes = {p: tuple(t.shape) for p, t in leaves_with_path(a)}
        assert shapes == {p: tuple(t.shape) for p, t in leaves_with_path(b)}
