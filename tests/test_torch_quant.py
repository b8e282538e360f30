"""The port's W8A8 (fairygen_tpu_torch/ops/quant.py and its users) against
the JAX package's on the CPU: the quantizers, the product on one shared
quantized tree, ``from_jax_params`` on quantized trees, the quantized Wan,
Z-Image and FLUX.1 DiTs, the calibration, the pipelines' ``quantize`` and
the CLI twin with ``--quantize`` and ``tools/calibrate_quant``.

Inputs and weights are made with numpy from a seed; tolerances are stated
per test.  The int8 product itself is exact on both sides; where two
floating-point results differ, it is by summation order, and a rounding
tie of the activation quantizer can then land one count apart.
"""
import json
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fairygen_tpu.models.flux import dit as jflux
from fairygen_tpu.models.wan import dit as jdit
from fairygen_tpu.models.z_image import dit as jzimage
from fairygen_tpu.ops import quant as jq
from fairygen_tpu.training import quant_experiment as jqe
from fairygen_tpu_torch import convert
from fairygen_tpu_torch.models.flux import dit as tflux
from fairygen_tpu_torch.models.wan import dit as tdit
from fairygen_tpu_torch.models.z_image import dit as tzimage
from fairygen_tpu_torch.ops import quant as tq
from fairygen_tpu_torch.pipelines.flux_image import FluxImagePipeline
from fairygen_tpu_torch.pipelines.z_image import ZImagePipeline
from fairygen_tpu_torch.tools import calibrate_quant
from fairygen_tpu_torch.training import quant_experiment as tqe

REPO = pathlib.Path(__file__).resolve().parent.parent
WAN = dict(dim=96, in_dim=8, ffn_dim=128, out_dim=8, text_dim=32, freq_dim=32,
           patch_size=(1, 2, 2), num_heads=4, num_layers=2)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this file's tests, restored after: its
    models are tiny, and under the suite's six workers on one machine
    torch's thread pools contend with each other and slow the file down
    many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.array(a))


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _dense_inputs(seed=0, k=256, n=512, rows=300):
    rng = np.random.default_rng(seed)
    w = (0.05 * rng.standard_normal((k, n))).astype(np.float32)
    b = (0.01 * rng.standard_normal(n)).astype(np.float32)
    x = rng.standard_normal((rows, k)).astype(np.float32)
    amax = (3 * np.abs(rng.standard_normal(k))).astype(np.float32)
    amax[[5, 77]] = (40.0, 25.0)  # two outlier channels
    return w, b, x, amax


# ------------------------------------------------------------ quantizers
@pytest.mark.parametrize("shape", [(256, 512), (96, 128), (3072, 64)])
def test_quantize_weight_int8_is_bit_equal(shape):
    """Against the JAX quantizer as the JAX package runs it, jitted (XLA
    multiplies by fp32(1/127) where the function divides by 127)."""
    w = (0.05 * np.random.default_rng(1).standard_normal(shape)).astype(np.float32)
    ref = jax.jit(jq.quantize_weight_int8)(jnp.asarray(w))
    out = tq.quantize_weight_int8(_t(w))
    np.testing.assert_array_equal(out["w_int8"].numpy(), np.asarray(ref["w_int8"]))
    np.testing.assert_array_equal(out["w_scale"].numpy(), np.asarray(ref["w_scale"]))
    assert out["w_int8"].dtype == torch.int8 and out["w_int8"].stride() == (1, shape[0])


@pytest.mark.parametrize("alpha", [0.5, 0.8])
def test_smooth_scales_within_1e6(alpha):
    """log, exp and pow in fp32 round differently from XLA's: 1e-6 relative."""
    w, _, _, amax = _dense_inputs()
    amax[9] = 0.0  # a dead channel keeps s = 1
    ref = np.asarray(jq.smooth_scales(jnp.asarray(amax), jnp.asarray(w), alpha))
    out = tq.smooth_scales(amax, _t(w), alpha).numpy()
    assert out[9] == ref[9] == 1.0
    np.testing.assert_allclose(out, ref, rtol=1e-6, atol=0)


@pytest.mark.parametrize("k", [0, 4])
def test_robust_quantizer_matches_jax(k):
    """The same outlier channels and selection; act_smooth within 1e-6
    relative; w_int8 from the port's own scales may land one count apart
    at a rounding tie (this draw: none), never more."""
    w, _, _, amax = _dense_inputs()
    ref = _np_tree(jq.quantize_weight_int8_robust(jnp.asarray(w), jnp.asarray(amax),
                                                  outlier_k=k))
    out = tq.quantize_weight_int8_robust(_t(w), amax, outlier_k=k)
    assert sorted(out) == sorted(ref)
    np.testing.assert_allclose(out["act_smooth"].numpy(), ref["act_smooth"], rtol=1e-6, atol=0)
    np.testing.assert_allclose(out["w_scale"].numpy(), ref["w_scale"], rtol=1e-6, atol=0)
    diff = np.abs(out["w_int8"].numpy().astype(np.int32) - ref["w_int8"].astype(np.int32))
    assert diff.max() <= 1 and int((diff > 0).sum()) == 0
    if k:
        np.testing.assert_array_equal(
            np.flatnonzero(out["act_smooth"].numpy() == 0), np.flatnonzero(ref["act_smooth"] == 0))
        assert {5, 77} <= set(np.flatnonzero(ref["act_smooth"] == 0))
        for key in ("outlier_sel", "w_outlier"):
            assert out[key].dtype == torch.bfloat16
            np.testing.assert_allclose(out[key].float().numpy(), ref[key].astype(np.float32),
                                       rtol=2 ** -8, atol=0)


# ---------------------------------------------------------- the product
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("robust", [False, True])
def test_quantized_dense_on_a_jax_tree(dtype, robust):
    """One JAX-quantized layer carried by from_jax_params: the port's product
    equals the JAX package's, jitted as the JAX package runs it, bit for
    bit, but for the fp32 result of the robust form's outlier product,
    whose k = 4 terms XLA's CPU dot sums in another order: there, a few of
    the 153600 entries (this draw: 114) differ, each by at most an fp32 ulp
    of the largest output."""
    w, b, x, amax = _dense_inputs()
    jp = (jq.quantize_weight_int8_robust(jnp.asarray(w), jnp.asarray(amax), outlier_k=4)
          if robust else jq.quantize_weight_int8(jnp.asarray(w)))
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jp = dict(jp, b=jnp.asarray(b).astype(jdt))
    tp = convert.from_jax_params(_np_tree(jp), device="cpu", dtype=tdt)
    ref = np.asarray(jax.jit(jq.quantized_dense)(jp, jnp.asarray(x).astype(jdt))
                     .astype(jnp.float32))
    out = tq.quantized_dense(tp, _t(x).to(tdt))
    assert out.dtype == tdt and out.shape == (300, 512)
    out = out.float().numpy()
    if robust and dtype == "float32":
        # one ulp of the outlier term, at most one of the largest output
        np.testing.assert_allclose(out, ref, rtol=0, atol=np.spacing(np.abs(ref).max()))
        assert 0 < int((out != ref).sum()) <= 200
    else:
        np.testing.assert_array_equal(out, ref)


def test_int8_matmul_is_exact_and_counts_no_cpu_launch():
    rng = np.random.default_rng(2)
    a = rng.integers(-127, 128, (33, 14336)).astype(np.int8)
    b = rng.integers(-127, 128, (14336, 24)).astype(np.int8)
    tq.reset_launches()
    out = tq.int8_matmul(_t(a), tq.int_mm_layout(_t(b)))
    assert out.dtype == torch.int32 and tq.launches["int_mm"] == 0
    np.testing.assert_array_equal(out.numpy(), a.astype(np.int64) @ b.astype(np.int64))


def test_from_jax_params_keeps_the_quantized_leaves_dtypes():
    """Under dtype=bf16 the float weights and biases cast, but w_scale and
    act_smooth stay fp32, the bf16 outlier operands stay bf16 and w_int8
    int8 (before this repair every floating leaf was cast)."""
    w, b, _, amax = _dense_inputs()
    robust = dict(jq.quantize_weight_int8_robust(jnp.asarray(w), jnp.asarray(amax),
                                                 outlier_k=4), b=jnp.asarray(b))
    tree = _np_tree({"blocks": {"ffn": {"fc2": jax.tree.map(lambda a: jnp.stack([a, a]), robust),
                                        "fc1": {"w": jnp.stack([jnp.asarray(w)] * 2)}}}})
    out = convert.from_jax_params(tree, device="cpu", dtype=torch.bfloat16)
    assert len(out["blocks"]) == 2
    fc2, fc1 = out["blocks"][1]["ffn"]["fc2"], out["blocks"][1]["ffn"]["fc1"]
    assert fc1["w"].dtype == fc2["b"].dtype == torch.bfloat16
    assert fc2["w_scale"].dtype == fc2["act_smooth"].dtype == torch.float32
    assert fc2["outlier_sel"].dtype == fc2["w_outlier"].dtype == torch.bfloat16
    assert fc2["w_int8"].dtype == torch.int8 and fc2["w_int8"].stride() == (1, 256)
    np.testing.assert_array_equal(fc2["w_scale"].numpy(), np.asarray(robust["w_scale"]))
    np.testing.assert_array_equal(fc2["w_int8"].numpy(), np.asarray(robust["w_int8"]))
    np.testing.assert_array_equal(fc2["w_outlier"].float().numpy(),
                                  np.asarray(robust["w_outlier"].astype(jnp.float32)))


# ------------------------------------------------------------- the Wan DiT
def _wan(seed=0, **over):
    jcfg = jdit.WanDiTConfig(**dict(WAN, **over))
    tcfg = tdit.WanDiTConfig(**dict(WAN, **over))
    jp = _np_tree(jdit.init_dit_params(jax.random.key(seed), jcfg))
    rng = np.random.default_rng(seed + 10)
    lat = (0.5 * rng.standard_normal((1, jcfg.in_dim, 3, 8, 8))).astype(np.float32)
    ctx = rng.standard_normal((1, 6, 32)).astype(np.float32)
    return jcfg, tcfg, jp, lat, ctx


def _calibration(jcfg, tcfg, jp, lat, ctx):
    """act_amax of both packages from 6-step rollouts' samples."""
    jsamples = jqe.rollout_calibration_samples(jax.tree.map(jnp.asarray, jp), jcfg,
                                               jnp.asarray(lat), jnp.asarray(ctx),
                                               rollout_steps=6)
    ref = jqe.calibrate_wan_dit_act_amax(jax.tree.map(jnp.asarray, jp), jcfg, jsamples)
    params = convert.from_jax_params(jp, device="cpu")
    samples = tqe.rollout_calibration_samples(params, tcfg, _t(lat), _t(ctx), rollout_steps=6)
    return ref, tqe.calibrate_wan_dit_act_amax(params, tcfg, samples), jsamples, samples


def test_calibrate_wan_dit_act_amax_matches_jax():
    """The rollout's three samples (steps 1, 3 and 4 of 6) within 1e-5, and
    every block dense's (L, K) amax within 1e-4 relative, in the tap order
    of wan_block_dense_order."""
    jcfg, tcfg, jp, lat, ctx = _wan()
    ref, out, jsamples, samples = _calibration(jcfg, tcfg, jp, lat, ctx)
    assert len(samples) == len(jsamples) == 3
    for (jl, jt, _), (tl, tt, _) in zip(jsamples, samples):
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-5, rtol=1e-5)
    assert tqe.wan_block_dense_order(tcfg) == jqe.wan_block_dense_order(jcfg)
    assert {g: sorted(v) for g, v in out.items()} == {g: sorted(v) for g, v in ref.items()}
    for g in ref:
        for name in ref[g]:
            assert out[g][name].shape == ref[g][name].shape == (2, 96 if name != "fc2" else 128)
            np.testing.assert_allclose(out[g][name], ref[g][name], rtol=1e-4, atol=1e-6)


def _rel_l2(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.mark.parametrize("mode", ["int8_ffn", "int8", "int8+act_amax"])
def test_quantized_wan_dit_matches_jax(mode):
    """The 2-layer DiT quantized by the JAX package, carried over, against
    the JAX quantized forward; then the port's own quantization of the
    float tree (the same int8 weights; the robust form within one count).
    The activations of the two packages differ by summation order (~2e-7),
    and where one lands within that of a rounding tie the two quantize it
    to neighbouring int8 codes: one such flip moves its row of the layer's
    output by a quantization step (in fc1 of this draw: 1 of 4608 codes,
    3.7e-4 relative L2 of fc2's input).  So the bound is relative to what
    quantizing does at all: the relative L2 error to the JAX quantized
    forward at most 0.3 of the JAX quantized forward's own relative L2
    error to the float forward (this draw: 0.074, 0.23 and 3e-5 of it)."""
    jcfg, tcfg, jp, lat, ctx = _wan()
    groups = ("ffn",) if mode == "int8_ffn" else ("ffn", "self_attn", "cross_attn")
    kw = {}
    if mode.endswith("act_amax"):
        ref_amax, amax, _, _ = _calibration(jcfg, tcfg, jp, lat, ctx)
        kw = dict(outlier_k={"ffn": {"fc2": 8}})
    jq_tree = jq.quantize_wan_dit_linears(jax.tree.map(jnp.asarray, jp), groups,
                                          act_amax=ref_amax if kw else None, **kw)
    args = (jnp.asarray(lat), jnp.asarray([500.0]), jnp.asarray(ctx))
    ref = np.asarray(jdit.wan_dit_forward(jq_tree, jcfg, *args))
    bound = 0.3 * _rel_l2(ref, np.asarray(jdit.wan_dit_forward(jax.tree.map(jnp.asarray, jp),
                                                               jcfg, *args)))
    assert bound > 1e-4  # the quantization shows
    targs = (_t(lat), torch.tensor([500.0]), _t(ctx))
    carried = convert.from_jax_params(_np_tree(jq_tree), device="cpu")
    assert _rel_l2(tdit.wan_dit_forward(carried, tcfg, *targs).numpy(), ref) <= bound

    own = tq.quantize_wan_dit_linears(convert.from_jax_params(jp, device="cpu"), groups,
                                      act_amax=amax if kw else None, **kw)
    for blk, jblk in zip(own["blocks"], carried["blocks"]):
        for g in groups:
            for name, layer in blk[g].items():
                if isinstance(layer, dict) and "w_int8" in jblk[g][name]:
                    assert "w" not in layer and sorted(layer) == sorted(jblk[g][name])
                    d = (layer["w_int8"].int() - jblk[g][name]["w_int8"].int()).abs().max()
                    assert int(d) <= (1 if kw else 0), (g, name)
                    ws, ref_ws = layer["w_scale"].numpy(), jblk[g][name]["w_scale"].numpy()
                    if kw:
                        # the robust form's scales carry smooth_scales' log /
                        # pow / exp, which round as XLA's do within 1e-6
                        np.testing.assert_allclose(ws, ref_ws, rtol=1e-6, atol=0)
                    else:
                        np.testing.assert_array_equal(ws, ref_ws)
    assert _rel_l2(tdit.wan_dit_forward(own, tcfg, *targs).numpy(), ref) <= bound


def test_quantize_consumes_the_float_weights():
    _, tcfg, jp, lat, ctx = _wan()
    params = convert.from_jax_params(jp, device="cpu")
    fc1 = params["blocks"][0]["ffn"]["fc1"]
    q = tq.quantize_wan_dit_linears(params, ("ffn",), consume=True)
    assert "w" not in fc1 and "w_int8" in q["blocks"][0]["ffn"]["fc1"]
    assert "w" in q["blocks"][0]["self_attn"]["q"]  # not in the groups


def test_activation_tap_records_the_block_order():
    """With the context given, one block's denses reach the tap in
    wan_block_dense_order's order, with (K,) channel maxima."""
    _, tcfg, jp, lat, ctx = _wan()
    params = convert.from_jax_params(jp, device="cpu")
    tap = []
    with tq.activation_stats_tap(tap, mode="channel_amax"):
        tdit.wan_dit_forward(params, tcfg, _t(lat), torch.tensor([500.0]), _t(ctx))
    # text embed (2), time embed (2) + time_proj, patch embed, then 2 x 11, head
    labels = [lab for lab, _ in tap]
    per_block = [f"dense_{k}x{n}" for k, n in ((96, 96),) * 7 + ((96, 96), (96, 128), (128, 96))]
    assert labels[6:6 + 10] == per_block and labels[16:26] == per_block
    stats = []
    with tq.activation_stats_tap(stats):
        tdit.wan_dit_forward(params, tcfg, _t(lat), torch.tensor([500.0]), _t(ctx))
    assert set(stats[0][1]) == {"amax_max", "rms_mean", "crest_mean", "crest_p99", "crest_max"}
    jstats = jq.activation_row_stats(jnp.asarray(lat[0, 0]))
    for k, v in tq.activation_row_stats(_t(lat[0, 0])).items():
        np.testing.assert_allclose(float(v), float(jstats[k]), rtol=1e-5)
    w = (0.05 * np.random.default_rng(3).standard_normal((96, 128))).astype(np.float32)
    ref = jq.weight_quant_report(jnp.asarray(w))
    for k, v in tq.weight_quant_report(_t(w)).items():
        np.testing.assert_allclose(v, ref[k], rtol=1e-5)


# ------------------------------------------------------- the image DiTs
def _swapped(tree, path=""):
    """{path: (w_int8, w_scale)} of every quantized dense of a tree (lists
    and stacked dicts indexed alike)."""
    out = {}
    if isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_swapped(v, f"{path}[{i}]"))
    elif isinstance(tree, dict):
        if "w_int8" in tree:
            out[path] = (np.asarray(tree["w_int8"]), np.asarray(tree["w_scale"]))
        for k, v in tree.items():
            out.update(_swapped(v, f"{path}.{k}"))
    return out


def _unstack(tree, keys):
    """A JAX tree's stacked block dicts as per-block lists (the port's layout)."""
    tree = dict(tree)
    for k in keys:
        if isinstance(tree.get(k), dict):
            n = len(jax.tree.leaves(tree[k])[0])
            tree[k] = [jax.tree.map(lambda a: a[i], tree[k]) for i in range(n)]
    return tree


@pytest.mark.parametrize("family", ["flux", "z_image"])
def test_quantize_image_dit_params_matches_jax(family):
    """The tiny FLUX.1 and Z-Image trees (min_dim 8): the same denses
    quantized as in the JAX package, the same int8 values and scales bit
    for bit, and the quantized forward's relative L2 error to the JAX
    quantized forward at most 0.5 of the JAX quantized forward's to the
    float one, for the reason test_quantized_wan_dit_matches_jax gives: these stacks are
    deeper (Z-Image: 1 + 1 refiner and 2 unified blocks of 7 denses) and
    their float forwards already differ by 3.9e-6 relative L2, so more
    activations round to a neighbouring code (this draw: 0.10 of it for
    FLUX.1, 0.40 for Z-Image)."""
    rng = np.random.default_rng(4)
    if family == "flux":
        jcfg, tcfg = jflux.FluxDiTConfig.tiny(), tflux.FluxDiTConfig.tiny()
        jp = _np_tree(jflux.init_flux_dit_params(jax.random.key(0), jcfg))
        inputs = (0.3 * rng.standard_normal((1, 4, 8, 12)), np.array([500.0]),
                  rng.standard_normal((1, 5, jcfg.context_dim)),
                  rng.standard_normal((1, jcfg.pooled_dim)), np.array([4.0]))
        jfwd, tfwd = jflux.flux_dit_forward, tflux.flux_dit_forward
    else:
        jcfg, tcfg = jzimage.ZImageDiTConfig.tiny(), tzimage.ZImageDiTConfig.tiny()
        jp = _np_tree(jzimage.init_z_image_dit_params(jax.random.key(0), jcfg))
        jp = jax.tree.map(lambda a: (a + 0.05 * rng.standard_normal(a.shape)).astype(np.float32),
                          jp)
        inputs = (rng.standard_normal((1, jcfg.in_channels, 16, 24)), np.array([0.37]),
                  rng.standard_normal((1, 7, jcfg.cap_feat_dim)))
        jfwd, tfwd = jzimage.z_image_dit_forward, tzimage.z_image_dit_forward
    inputs = [np.asarray(a, np.float32) for a in inputs]
    jqp = _np_tree(jq.quantize_image_dit_params(jax.tree.map(jnp.asarray, jp), min_dim=8))
    tqp = tq.quantize_image_dit_params(convert.from_jax_params(jp, device="cpu"), min_dim=8)
    ref_sw = _swapped(_unstack(jqp, tq._IMAGE_DIT_BLOCK_KEYS))
    out_sw = _swapped(tqp)
    assert sorted(out_sw) == sorted(ref_sw) and len(out_sw) > 10
    # the JAX package's tree quantizers run jitted, where XLA turns the
    # division by 127 into a product with fp32(1/127), as the port computes
    # it: the same int8 values and scales, bit for bit
    for path, (w8, ws) in out_sw.items():
        np.testing.assert_array_equal(w8, ref_sw[path][0], err_msg=path)
        np.testing.assert_array_equal(ws, ref_sw[path][1], err_msg=path)
    assert "w" in tqp["x_embedder"]  # the embedders stay float
    jargs = [jnp.asarray(a) for a in inputs]
    ref = np.asarray(jfwd(jax.tree.map(jnp.asarray, jqp), jcfg, *jargs))
    full = np.asarray(jfwd(jax.tree.map(jnp.asarray, jp), jcfg, *jargs))
    out = tfwd(tqp, tcfg, *(_t(a) for a in inputs)).numpy()
    assert _rel_l2(out, ref) <= 0.5 * _rel_l2(ref, full)


def test_quantize_blocks_tree_takes_a_stacked_calibration_tree():
    """A JAX-layout calibration tree ((L, K) amax at a stacked dense) feeds
    the port's per-block lists: the same robust layers as the JAX
    package's, within one int8 count."""
    rng = np.random.default_rng(5)
    w = (0.05 * rng.standard_normal((2, 64, 96))).astype(np.float32)
    amax = (1 + np.abs(rng.standard_normal((2, 64)))).astype(np.float32)
    jtree = {"attn": {"proj": {"w": jnp.asarray(w)}}, "mod": {"w": jnp.asarray(w)}}
    cal = {"attn": {"proj": {"amax": amax, "outlier_k": 2}}}
    ref = _np_tree(jq.quantize_blocks_tree(jtree, min_dim=8, act_amax=cal))
    ttree = [{"attn": {"proj": {"w": _t(w[i])}}, "mod": {"w": _t(w[i])}} for i in range(2)]
    out = tq.quantize_blocks_tree(ttree, min_dim=8, act_amax=cal)
    for i in range(2):
        p = out[i]["attn"]["proj"]
        assert sorted(p) == sorted(ref["attn"]["proj"]) and "w" in out[i]["mod"]
        d = np.abs(p["w_int8"].numpy().astype(int) - ref["attn"]["proj"]["w_int8"][i]).max()
        assert d <= 1
        np.testing.assert_array_equal(np.flatnonzero(p["act_smooth"].numpy() == 0),
                                      np.flatnonzero(ref["attn"]["proj"]["act_smooth"][i] == 0))


def test_image_pipelines_quantize_in_place():
    zcfg, fcfg = tzimage.ZImageDiTConfig.tiny(), tflux.FluxDiTConfig.tiny()
    zp = ZImagePipeline(tzimage.init_z_image_dit_params(zcfg, "cpu", torch.float32), zcfg,
                        device="cpu")
    fp = FluxImagePipeline(tflux.init_flux_dit_params(fcfg, "cpu", torch.float32), fcfg,
                           device="cpu")
    for pipe in (zp, fp):
        assert pipe.quantize() is pipe
        # the tiny widths are under min_dim 512: nothing is swapped
        assert not _swapped(pipe.dit_params)


# ------------------------------------------------------------ tools
def test_load_act_amax_round_trip(tmp_path):
    rng = np.random.default_rng(6)
    amax = {"ffn": {"fc1": rng.random((3, 16), dtype=np.float32),
                    "fc2": rng.random((3, 32), dtype=np.float32)},
            "self_attn": {"q": rng.random((3, 16), dtype=np.float32)}}
    path = str(tmp_path / "act_amax.npz")
    calibrate_quant.save_act_amax(path, amax)
    assert sorted(np.load(path).files) == ["ffn/fc1", "ffn/fc2", "self_attn/q"]
    back = calibrate_quant.load_act_amax(path)
    assert {g: sorted(v) for g, v in back.items()} == {g: sorted(v) for g, v in amax.items()}
    for g in amax:
        for name in amax[g]:
            np.testing.assert_array_equal(back[g][name], amax[g][name])


# ------------------------------------------- the Wan pipeline and its CLI
from test_torch_wan_entry import REQUEST, _jax_pipe, _port_pipe, ckpts  # noqa: E402,F401


def test_wan_pipeline_quantize_matches_jax(ckpts):
    """pipe.quantize("int8") on both from_pretrained pipelines (the tiny
    TI2V checkpoints), then a 2-step CFG 5 request: the port's latents
    within 0.3 of the quantization's own relative L2 effect of the JAX
    quantized ones (test_quantized_wan_dit_matches_jax's bound)."""
    kw = dict(REQUEST, input_image=ckpts["img"], output_type="latents")
    jpipe, pipe = _jax_pipe(ckpts), _port_pipe(ckpts)
    full = np.asarray(jpipe(**kw))
    jpipe.quantize("int8")
    ref = np.asarray(jpipe(**kw))
    fc1 = pipe.dit_params["blocks"][0]["ffn"]["fc1"]
    assert pipe.quantize("int8") is pipe and "w" not in fc1  # consumed
    for g in ("ffn", "self_attn", "cross_attn"):
        assert all("w_int8" in v for k, v in pipe.dit_params["blocks"][1][g].items()
                   if isinstance(v, dict) and k[:4] != "norm")
    assert _rel_l2(pipe(**kw).numpy(), ref) <= 0.3 * _rel_l2(ref, full)
    with pytest.raises(ValueError, match="int8_ffn"):
        pipe.quantize("fp8")


def test_cli_twin_quantizes(ckpts, tmp_path):
    """``python -m fairygen_tpu_torch.examples.wan_inference --quantize
    int8_ffn`` on the tiny checkpoints writes the clip."""
    from fairygen_tpu_torch.utils import video as tvideo

    env = dict(os.environ, FAIRYGEN_MODEL_HINTS=ckpts["hints_file"],
               PYTHONPATH=str(REPO) + os.pathsep + os.environ.get("PYTHONPATH", ""))
    r = subprocess.run(
        [sys.executable, "-m", "fairygen_tpu_torch.examples.wan_inference", "--device", "cpu",
         "--model_paths", json.dumps(list(ckpts["paths"].values())),
         "--tokenizer_path", ckpts["tokenizer"], "--prompt", "a pig walks", "--quantize",
         "int8_ffn", "--height", "32", "--width", "32", "--num_frames", "5",
         "--num_inference_steps", "2", "--output", str(tmp_path / "out.mp4")],
        capture_output=True, text=True, timeout=300, cwd=str(tmp_path), env=env)
    assert r.returncode == 0, r.stderr[-3000:]
    assert len(tvideo.load_video_frames(str(tmp_path / "out.gif"))) == 5


def test_calibrate_quant_tool_feeds_quantize(ckpts, tmp_path, monkeypatch, capsys):
    """``tools/calibrate_quant`` on the tiny checkpoints: the report, an npz
    of every block dense's (L, K) amax, which ``load_act_amax`` hands to
    ``quantize("int8", act_amax=, outlier_k=)``."""
    monkeypatch.setenv("FAIRYGEN_MODEL_HINTS", ckpts["hints_file"])
    out = str(tmp_path / "act_amax.npz")
    assert calibrate_quant.main([
        "--device", "cpu", "--model_paths", json.dumps(list(ckpts["paths"].values())),
        "--height", "32", "--width", "32", "--num_frames", "5", "--steps", "5",
        "--rollouts", "2", "--out", out]) == 0
    report = json.loads(capsys.readouterr().out.splitlines()[0])
    assert len(report["per_layer"]) == 10 and report["worst_layer"] in report["per_layer"]
    amax = calibrate_quant.load_act_amax(out)
    assert amax["ffn"]["fc2"].shape == (2, 128) and amax["self_attn"]["q"].shape == (2, 96)
    pipe = _port_pipe(ckpts)
    pipe.quantize("int8", act_amax=amax, outlier_k={"ffn": {"fc2": 8}})
    fc2 = pipe.dit_params["blocks"][0]["ffn"]["fc2"]
    assert fc2["outlier_sel"].shape == (128, 8) and "act_smooth" in pipe.dit_params[
        "blocks"][0]["self_attn"]["q"]
    lat = pipe(**dict(REQUEST, input_image=ckpts["img"], output_type="latents"))
    assert torch.isfinite(lat).all()
