"""The port's K9 (``rms_modulate``) and K11 (``vae_rms_silu``) plain versions
(what a CPU tensor runs) against the JAX package's Pallas kernels in
interpret mode (``_rms_mod_pallas`` / ``_vae_rms_silu_pallas``, as
tests/test_fused_norms.py runs them), the JAX package's gates, and the
``autograd.Function`` gradients against autograd of the plain formulas.

Inputs are made with numpy from a seed and handed to both packages.
Tolerances:
  * fp32: 2e-5 absolute, 1e-4 relative, the JAX package's own tests';
  * bf16 K9: the inputs lie on a 2^-6 grid in [-2, 2], where every sum of
    squares is exact in fp32 whatever the order.  Where the fp32 rsqrt
    statistic of XLA and PyTorch agree (neither rounds rsqrt correctly, and
    they differ by an ulp on some rows), within 1 bf16 ulp: XLA on the CPU
    may keep excess precision across the two bf16 products.  Everywhere,
    within one flipped bf16 rounding of the normed value carried through
    both products: 3 x 2^-7 of |y·w·scale|;
  * bf16 K11: the same grid makes the norm exact on both sides; without
    SiLU bit-equal, with SiLU within 1 bf16 ulp (XLA's sigmoid and
    PyTorch's x / (1 + exp(-x)) may round the fp32 value apart);
  * gradients: the Function differentiates the plain formula, so its
    gradients equal plain autograd's exactly; against JAX's gradient of its
    reference, 1e-5 absolute and 1e-4 relative, the JAX test's tolerance.
"""
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import fairygen_tpu.ops.fused_norms as jfn
from fairygen_tpu_torch.ops import fused_norms as tfn


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _bf16_ulp(x):
    e = np.floor(np.log2(np.maximum(np.abs(x), np.float32(2.0 ** -126))))
    return np.float32(2.0) ** (e - 7)


def _as(dtype, *arrays):
    """numpy -> (jax arrays, torch tensors) holding the same values."""
    j = [jnp.asarray(a, dtype) for a in arrays]
    t = [_t(np.asarray(a.astype(jnp.float32))).to(torch.bfloat16 if dtype == jnp.bfloat16
                                                  else torch.float32) for a in j]
    return j, t


def _grid(rng, shape):
    """Values k/64, |k| <= 128: exact in bf16, squares summed exactly in fp32."""
    return rng.integers(-128, 129, shape) / 64.0


def _k9_inputs(rng, dtype, b, s, d, with_scale):
    x = _grid(rng, (b, s, d)) if dtype == jnp.bfloat16 else rng.standard_normal((b, s, d))
    arrays = [x, rng.standard_normal(d)]
    if with_scale:
        arrays.append(1.0 + 0.5 * rng.standard_normal((b, 1, d)))
    j, t = _as(dtype, *arrays)
    return (j + [None])[:3], (t + [None])[:3]


@pytest.mark.parametrize("with_scale", [True, False], ids=["scale", "no-scale"])
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16], ids=["fp32", "bf16"])
def test_k9_plain_matches_pallas(dtype, with_scale):
    rng = np.random.default_rng(9)
    b, s, d = 2, 300, 256
    (xj, wj, scj), (xt, wt, sct) = _k9_inputs(rng, dtype, b, s, d, with_scale)
    with pltpu.force_tpu_interpret_mode():
        ref = _np(jfn._rms_mod_pallas(xj, wj, scj, 1e-5))
    out = tfn.rms_modulate_plain(xt, wt, sct, 1e-5)
    assert out.dtype == xt.dtype and tuple(out.shape) == (b, s, d)
    out = out.float().numpy()
    if dtype == jnp.float32:
        np.testing.assert_allclose(out, ref, atol=2e-5, rtol=1e-4)
        return
    xf = np.asarray(xj.astype(jnp.float32))
    rj = np.asarray(jax.jit(lambda a: jax.lax.rsqrt(jnp.mean(a * a, -1) + 1e-5))(xf))
    rt = torch.rsqrt(torch.from_numpy(np.array(xf)).pow(2).mean(-1) + 1e-5).numpy()
    same = (rj == rt)[..., None]
    assert same.mean() > 0.25  # the check below sees many rows
    err = np.abs(out - ref)
    assert np.all(np.where(same, err <= _bf16_ulp(ref), True))
    normed = tfn.rms_modulate_plain(xt, torch.ones_like(wt), None, 1e-5).float().numpy()
    mag = np.abs(normed * wt.float().numpy() * (1.0 if sct is None else sct.float().numpy()))
    assert np.all(err <= 3 * 2.0 ** -7 * mag)


@pytest.mark.parametrize("silu", [True, False], ids=["silu", "no-silu"])
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16], ids=["fp32", "bf16"])
def test_k11_plain_matches_pallas(dtype, silu):
    rng = np.random.default_rng(11)
    rows, c = 640, 256
    x = _grid(rng, (rows, c)) if dtype == jnp.bfloat16 else rng.standard_normal((rows, c))
    (xj, gj), (xt, gt) = _as(dtype, x, rng.standard_normal(c))
    with pltpu.force_tpu_interpret_mode():
        ref = _np(jfn._vae_rms_silu_pallas(xj, gj, silu))
    out = tfn.vae_rms_silu_plain(xt, gt, silu)
    assert out.dtype == xt.dtype and tuple(out.shape) == (rows, c)
    out = out.float().numpy()
    if dtype == jnp.float32:
        np.testing.assert_allclose(out, ref, atol=2e-5, rtol=1e-4)
    elif silu:
        assert np.all(np.abs(out - ref) <= _bf16_ulp(ref))
    else:
        np.testing.assert_array_equal(out, ref)


def test_plain_versions_match_the_jax_references_on_the_cpu():
    """The non-kernel formulas of both packages (fp32, 5-D VAE layout)."""
    rng = np.random.default_rng(3)
    (xj, wj, scj), (xt, wt, sct) = _k9_inputs(rng, jnp.float32, 1, 40, 96, True)
    np.testing.assert_allclose(tfn.rms_modulate_plain(xt, wt, sct).numpy(),
                               _np(jfn._rms_mod_reference(xj, wj, scj, 1e-5)),
                               atol=2e-5, rtol=1e-4)
    (xj, gj), (xt, gt) = _as(jnp.float32, rng.standard_normal((1, 2, 3, 4, 64)),
                             rng.standard_normal(64))
    for silu in (True, False):
        np.testing.assert_allclose(tfn.vae_rms_silu_plain(xt, gt, silu).numpy(),
                                   _np(jfn._vae_rms_silu_reference(xj, gj, silu)),
                                   atol=2e-5, rtol=1e-4)


@pytest.mark.parametrize("s,d,fused", [(256, 128, True), (300, 256, True), (255, 128, False),
                                       (300, 96, False)])
def test_rms_modulate_gate(s, d, fused):
    """D % 128 == 0 and S >= 256 go to K9's wrapper, anything else to the
    plain formula: the same values either way on the CPU."""
    rng = np.random.default_rng(s + d)
    x, w, sc = (torch.from_numpy(rng.standard_normal(sh).astype(np.float32))
                for sh in ((1, s, d), (d,), (1, 1, d)))
    with mock.patch.object(tfn, "fused_rms_modulate", wraps=tfn.fused_rms_modulate) as k:
        out = tfn.rms_modulate(x, w, sc)
    assert k.called == fused
    torch.testing.assert_close(out, tfn.rms_modulate_plain(x, w, sc), rtol=0, atol=0)


@pytest.mark.parametrize("shape,fused", [((512, 128), True), ((2, 4, 8, 8, 256), True),
                                         ((511, 128), False), ((600, 96), False)])
def test_vae_rms_silu_gate(shape, fused):
    """C % 128 == 0 and at least 512 rows go to K11's wrapper, anything else
    to the plain formula."""
    rng = np.random.default_rng(len(shape))
    x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    g = torch.from_numpy(rng.standard_normal(shape[-1]).astype(np.float32))
    with mock.patch.object(tfn, "fused_vae_rms_silu", wraps=tfn.fused_vae_rms_silu) as k:
        out = tfn.vae_rms_silu(x, g)
    assert k.called == fused
    torch.testing.assert_close(out, tfn.vae_rms_silu_plain(x, g), rtol=0, atol=0)


def _grads(fn, inputs, weight):
    leaves = [t.clone().requires_grad_(True) for t in inputs]
    out = fn(*leaves)
    return out, torch.autograd.grad((out * weight).sum(), leaves)


@pytest.mark.parametrize("with_scale", [True, False], ids=["scale", "no-scale"])
def test_rms_modulate_gradient(with_scale):
    rng = np.random.default_rng(6)
    arrays = [rng.standard_normal(sh).astype(np.float32)
              for sh in ((1, 256, 128), (128,), (1, 1, 128))][:3 if with_scale else 2]
    inputs = [torch.from_numpy(a) for a in arrays]
    weight = torch.from_numpy(rng.standard_normal((1, 256, 128)).astype(np.float32))
    sc = (lambda a: a[2]) if with_scale else (lambda a: None)  # noqa: E731
    out, g = _grads(lambda *a: tfn.rms_modulate(a[0], a[1], sc(a)), inputs, weight)
    assert type(out.grad_fn).__name__ == "_RmsModulateBackward"
    _, g_plain = _grads(lambda *a: tfn.rms_modulate_plain(a[0], a[1], sc(a)), inputs, weight)
    for a, b in zip(g, g_plain):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    g_jax = jax.grad(lambda *a: jnp.sum(jfn._rms_mod_reference(a[0], a[1], sc(a), 1e-5)
                                        * weight.numpy()), argnums=tuple(range(len(arrays))))(
        *(jnp.asarray(a) for a in arrays))
    for a, b in zip(g, g_jax):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5, rtol=1e-4)


@pytest.mark.parametrize("silu", [True, False], ids=["silu", "no-silu"])
def test_vae_rms_silu_gradient(silu):
    rng = np.random.default_rng(8)
    arrays = [rng.standard_normal((512, 128)).astype(np.float32),
              rng.standard_normal(128).astype(np.float32)]
    inputs = [torch.from_numpy(a) for a in arrays]
    weight = torch.from_numpy(rng.standard_normal((512, 128)).astype(np.float32))
    out, g = _grads(lambda x, gm: tfn.vae_rms_silu(x, gm, silu), inputs, weight)
    assert type(out.grad_fn).__name__ == "_VaeRmsSiluBackward"
    _, g_plain = _grads(lambda x, gm: tfn.vae_rms_silu_plain(x, gm, silu), inputs, weight)
    for a, b in zip(g, g_plain):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    g_jax = jax.grad(lambda x, gm: jnp.sum(jfn._vae_rms_silu_reference(x, gm, silu)
                                           * weight.numpy()), argnums=(0, 1))(
        *(jnp.asarray(a) for a in arrays))
    for a, b in zip(g, g_jax):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5, rtol=1e-4)
