"""K11's Hopper design (``csrc/rms_modulate.cu``) on the CPU: the table that
picks its instance (a group of G lanes a row, V 16-byte vectors a lane) and
a numpy emulation of the arithmetic it runs on the card.

* The table: every width of the norm + SiLU sites of both Wan VAEs and of
  the tiny test VAEs gets an instance without predicates, in bf16 and
  fp32; the compiled list in the CUDA source is the wrapper's; other widths
  run the predicated instance or raise naming the width.
* The emulation: each lane's fp32 sums over the vectors of the first design's
  lanes it stands for, the butterfly within the lane, then the shuffles over
  the group; the row's norm divided by one correctly rounded reciprocal and
  a Markstein correction.  The sum must be the first design's (a warp a
  row) bit for bit at every width, the quotient the correctly rounded one,
  and each output must lie inside ``chip_smoke._k11_bracket`` (the plain
  formula with the row norm moved by -/+2^-14, the card's check), while the
  JAX package's ``_vae_rms_silu_pallas`` in interpret mode lies inside the
  same bracket taken with the JAX formula.  Emulation and Pallas agree
  within 1 bf16 ulp (bf16; XLA's sigmoid and PyTorch's x / (1 + exp(-x))
  may round the fp32 value apart, as tests/test_torch_z_image_kernels.py
  states) or the JAX package's fp32 tolerance (2e-5 absolute, 1e-4
  relative).
"""
import importlib.util
import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from jax.experimental.pallas import tpu as pltpu

import fairygen_tpu.ops.fused_norms as jfn
from fairygen_tpu_torch import convert
from fairygen_tpu_torch.models.wan.vae import WanVAEConfig
from fairygen_tpu_torch.ops import fused_norms as tfn

REPO = pathlib.Path(__file__).resolve().parents[1]


def _smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke_k11", REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _norm_widths(cfg):
    """Channel widths of the VAE's norm + SiLU sites: each stage's blocks
    (norm1 at the stage's input, norm2 at its output), the middle blocks and
    the heads; the Wan2.1 decoder's later stages take dims[i] // 2 in."""
    widths = set(cfg.enc_dims) | set(cfg.dec_dims)
    if cfg.arch == "v1":
        widths |= {cfg.dec_dims[i] // 2 for i in range(1, len(cfg.dim_mult))}
    return widths


def _tree_widths(tree, path=""):
    if isinstance(tree, dict):
        out = set()
        for k, v in tree.items():
            out |= _tree_widths(v, f"{path}/{k}")
        return out
    if isinstance(tree, (list, tuple)):
        return set().union(*[_tree_widths(v, f"{path}/{i}") for i, v in enumerate(tree)])
    name = path.rsplit("/", 2)
    if name[-1] in ("norm1", "norm2") or path.endswith("head/norm"):
        return {tree.shape[0]}
    return set()


@pytest.mark.parametrize("name,widths", [
    ("wan22_38", {160, 320, 640, 1024, 512, 256}), ("wan21_16", {96, 192, 384}),
    ("tiny", {8, 16, 32}), ("tiny_v1", {8, 16, 32})])
def test_k11_table_covers_every_vae_width(name, widths):
    cfg = getattr(WanVAEConfig, name)()
    assert _norm_widths(cfg) == widths
    if name.startswith("tiny"):  # the formula against the param tree's gammas
        params = convert.init_vae_params(cfg, "cpu", torch.float32, seed=0)
        assert _tree_widths(params) == widths
    for c in widths:
        for size in (2, 4):
            g, v, pred = tfn.k11_instance(c, size)
            assert not pred and (g, v) in tfn.K11_EXACT
            assert g * v == c * size // 16 and g in (1, 2, 4, 8, 16, 32) and v <= tfn.K11_MAX_V


def test_k11_bf16_instances_of_the_path_widths():
    want = {96: (4, 3), 160: (4, 5), 192: (8, 3), 256: (8, 4), 320: (8, 5), 384: (16, 3),
            512: (16, 4), 640: (16, 5), 1024: (32, 4), 8: (1, 1), 16: (2, 1), 32: (4, 1),
            2048: (32, 8)}
    assert {c: tfn.k11_instance(c, 2)[:2] for c in want} == want


def test_k11_instances_are_the_cuda_sources():
    src = (REPO / "fairygen_tpu_torch/csrc/rms_modulate.cu").read_text()
    body = src[src.index("#define K11_EXACT(X)"):src.index("template <typename T>\nint dispatch")]
    got = tuple((int(g), int(v)) for g, v in re.findall(r"X\((\d+), (\d+)\)", body))
    assert got == tfn.K11_EXACT


@pytest.mark.parametrize("c,size,want", [(72, 2, (32, 8, True)), (200, 2, (32, 8, True)),
                                         (1032, 2, (32, 8, True)), (1000, 4, (32, 8, True)),
                                         (200, 4, (32, 8, True))])
def test_k11_widths_that_do_not_factor_run_the_predicated_instance(c, size, want):
    assert tfn.k11_instance(c, size) == want


@pytest.mark.parametrize("c,size", [(4096, 2), (2056, 2), (100, 2), (1028, 4), (6, 4), (0, 2)])
def test_k11_refuses_widths_it_cannot_take(c, size):
    with pytest.raises(ValueError, match=f"got {c}$"):
        tfn.k11_instance(c, size)
    if c == 4096:  # the message the card test holds the wrapper to
        with pytest.raises(ValueError, match="C <= 2048"):
            tfn.k11_instance(c, size)


def _sq_vectors(x32, vec):
    """Each element squared and rounded to fp32, as (rows, vectors, vec)."""
    rows, c = x32.shape
    return (x32 * x32).reshape(rows, c // vec, vec)


def _first_design_sum(sq):
    """The first K11 (a warp a row): lane L summed the vectors L, L + 32, ...
    element by element, then a butterfly over offsets 16 ... 1."""
    rows, n, vec = sq.shape
    lanes = []
    for lane in range(32):
        s = np.zeros(rows, np.float32)
        for v in range(lane, n, 32):
            for e in range(vec):
                s = s + sq[:, v, e]
        lanes.append(s)
    for o in (16, 8, 4, 2, 1):
        lanes = [lanes[lane] + lanes[lane ^ o] for lane in range(32)]
    return lanes[0]


def _lane_group_sum(sq, g, v):
    """The Hopper K11: lane l of a group of g holds the vectors l, l + g, ...
    (V of them), and sums those of each first-design lane l + j g it stands
    for apart (vector i to partial i mod 32/g), then the butterfly offsets
    of g and more within the lane, the smaller ones over the group."""
    rows, n, vec = sq.shape
    virt = 32 // g
    lanes = []
    for lane in range(g):
        p = [np.zeros(rows, np.float32) for _ in range(min(v, virt))]
        for i in range(v):
            if lane + i * g >= n:
                continue
            for e in range(vec):
                p[i % virt] = p[i % virt] + sq[:, lane + i * g, e]
        m = virt // 2
        while m:
            for j in range(min(m, len(p) - m)):
                p[j] = p[j] + p[j + m]
            m //= 2
        lanes.append(p[0])
    o = g // 2
    while o:
        lanes = [lanes[lane] + lanes[lane ^ o] for lane in range(g)]
        o //= 2
    return lanes[0]


def _fma32(a, b, c):
    """fp32 fma(a, b, c), rounded once: a*b is exact in float64; the float64
    sum's remainder (TwoSum) settles the one case its rounding can change,
    a sum that lands exactly between two fp32 values."""
    p = a.astype(np.float64) * b.astype(np.float64)
    c64 = c.astype(np.float64)
    s = p + c64
    bb = s - p
    err = (p - (s - bb)) + (c64 - bb)
    r = s.astype(np.float32)
    other = np.nextafter(r, np.where(r.astype(np.float64) < s, np.inf, -np.inf).astype(
        np.float32))
    mid = (r.astype(np.float64) + other.astype(np.float64)) / 2
    tie = (mid == s) & (err != 0)
    up = np.maximum(r, other)
    down = np.minimum(r, other)
    return np.where(tie, np.where(err > 0, up, down), r).astype(np.float32)


def _emulate(x, gamma, silu):
    """K11's arithmetic on the card for x (rows, C) bf16 or fp32: returns
    (output of x's dtype, the row's fp32 sum of squares)."""
    size = x.element_size()
    g, v, _ = tfn.k11_instance(x.shape[-1], size)
    x32 = x.float().numpy()
    ss = _lane_group_sum(_sq_vectors(x32, 16 // size), g, v)
    denom = np.maximum(np.sqrt(ss), np.float32(1e-12))[:, None]
    inv = np.float32(1) / denom
    q0 = x32 * inv
    q = _fma32(_fma32(-q0, np.broadcast_to(denom, q0.shape), x32), np.broadcast_to(
        inv, q0.shape), q0)
    assert np.all(np.abs(x32) >= 2.0 ** -100)  # the branch-free quotient's range
    np.testing.assert_array_equal(q, x32 / denom)  # Markstein: the correctly rounded quotient
    y = (q * np.float32(np.sqrt(np.float64(x.shape[-1])))) * gamma.float().numpy()
    out = torch.from_numpy(y).to(x.dtype)
    if silu:
        out = F.silu(out.float()).to(x.dtype)
    return out, ss


def _jax_bracket(xj, gj, silu):
    """_k11_bracket with the JAX reference's ops (XLA's division and
    jax.nn.silu)."""
    xf = xj.astype(jnp.float32)
    n = jnp.sqrt(jnp.sum(xf * xf, axis=-1, keepdims=True))
    outs = []
    for f in (1 - 2 ** -14, 1 + 2 ** -14):
        y = (xf / jnp.maximum(n * f, 1e-12) * (xj.shape[-1] ** 0.5)
             * gj.astype(jnp.float32)).astype(xj.dtype)
        if silu:
            y = jax.nn.silu(y.astype(jnp.float32)).astype(xj.dtype)
        outs.append(np.asarray(y.astype(jnp.float32)))
    lo, hi = np.minimum(*outs), np.maximum(*outs)
    if silu and xj.dtype == jnp.float32:
        lo, hi = lo - 2.0 ** -21 * np.abs(lo), hi + 2.0 ** -21 * np.abs(hi)
    return lo, hi


@pytest.mark.parametrize("c,size", [(c, 2) for c in (8, 16, 32, 64, 72, 96, 128, 160, 192, 200,
                                                     256, 320, 384, 512, 640, 1024, 1032, 2048)]
                         + [(c, 4) for c in (8, 16, 32, 64, 96, 160, 192, 384, 512, 1000, 1024)])
def test_k11_lane_groups_sum_as_the_first_design(c, size):
    rng = np.random.default_rng(c + size)
    x32 = rng.standard_normal((64, c)).astype(np.float32)
    if size == 2:
        x32 = torch.from_numpy(x32).to(torch.bfloat16).float().numpy()
    g, v, _ = tfn.k11_instance(c, size)
    sq = _sq_vectors(x32, 16 // size)
    if size == 2:  # the square is exact, so the card's one fma a bf16 element rounds as these
        np.testing.assert_array_equal(sq.astype(np.float64),
                                      (x32.astype(np.float64) ** 2).reshape(sq.shape))
    np.testing.assert_array_equal(_lane_group_sum(sq, g, v), _first_design_sum(sq))


@pytest.mark.parametrize("silu", [True, False], ids=["silu", "no-silu"])
@pytest.mark.parametrize("dtype", [jnp.bfloat16, jnp.float32], ids=["bf16", "fp32"])
@pytest.mark.parametrize("c", [96, 160, 384])
def test_k11_emulation_inside_the_bracket_of_the_pallas_kernel(c, dtype, silu):
    rng = np.random.default_rng(c)
    xj = jnp.asarray(rng.standard_normal((300, c)), dtype)
    gj = jnp.asarray(1 + 0.3 * rng.standard_normal(c), dtype)
    tdt = torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32
    x = torch.from_numpy(np.array(xj.astype(jnp.float32))).to(tdt)
    gamma = torch.from_numpy(np.array(gj.astype(jnp.float32))).to(tdt)
    out, ss = _emulate(x, gamma, silu)
    lo, hi = _smoke()._k11_bracket(x, gamma, silu)
    o = out.float()
    assert bool(((lo <= o) & (o <= hi)).all())
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(jfn._vae_rms_silu_pallas(xj, gj, silu).astype(jnp.float32))
    jlo, jhi = _jax_bracket(xj, gj, silu)
    assert np.all((jlo <= ref) & (ref <= jhi))
    o = o.numpy()
    if dtype == jnp.float32:
        np.testing.assert_allclose(o, ref, atol=2e-5, rtol=1e-4)
    else:
        ulp = np.float32(2.0) ** (np.floor(np.log2(np.maximum(np.abs(ref), 2.0 ** -126))) - 7)
        assert np.all(np.abs(o - ref) <= ulp)
    # the sum in the kernel's order is the first design's, row for row
    np.testing.assert_array_equal(ss, _first_design_sum(_sq_vectors(x.float().numpy(),
                                                                      16 // x.element_size())))
