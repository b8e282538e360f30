"""The port's TeaCache (fairygen_tpu_torch/utils/tea_cache.py, the Wan DiT's
and pipeline's gate, the calibration and the schedule replay) against the
JAX package's on the CPU, and the CLI twin's ``--tea_cache_l1_thresh`` and
``tools/calibrate_tea_cache`` on the tiny checkpoints.

The gate compares an fp32 accumulator with a threshold, and the two
packages sum the drift in different orders, so a decision whose
accumulator lies within rounding of the threshold could go either way.
Each test states the smallest distance of a decision's accumulator from
the threshold (its margin), so that an agreement is not luck.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fairygen_tpu.models.wan import dit as jdit
from fairygen_tpu.training import tea_cache_experiment as jexp
from fairygen_tpu.utils import tea_cache as jtc
from fairygen_tpu.utils import tea_cache_calibration as jcal
from fairygen_tpu_torch import convert
from fairygen_tpu_torch.examples import wan_inference
from fairygen_tpu_torch.models.wan import dit as tdit
from fairygen_tpu_torch.tools import calibrate_tea_cache
from fairygen_tpu_torch.training import tea_cache_experiment as texp
from fairygen_tpu_torch.utils import tea_cache as ttc
from fairygen_tpu_torch.utils import tea_cache_calibration as tcal
from fairygen_tpu_torch.utils import video as tvideo
from test_torch_wan_entry import REQUEST, _jax_pipe, _port_pipe, ckpts  # noqa: F401

LINEAR = [0.0, 0.0, 0.0, 1.0, 0.0]  # the gate then accumulates the drift itself
CUBIC = [3.0, -2.0, 0.5, 1.5, 0.01]


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture
def registered(monkeypatch):
    """Test entries in both packages' coefficient tables, removed after."""
    for table in (jtc.TEACACHE_COEFFICIENTS, ttc.TEACACHE_COEFFICIENTS):
        monkeypatch.setitem(table, "test-linear", LINEAR)
        monkeypatch.setitem(table, "test-cubic", CUBIC)


def _margin(coeffs, xs, thresh, mask):
    """The replayed accumulator's smallest relative distance from the
    threshold over the steps the rule decides (not the first or last)."""
    acc, dist = np.float32(0), []
    for i in range(1, len(mask)):
        acc = np.float32(acc + np.polyval(np.asarray(coeffs, np.float32), np.float32(xs[i - 1])))
        if i < len(mask) - 1:
            dist.append(abs(float(acc) - thresh) / thresh)
        if mask[i]:
            acc = np.float32(0)
    return min(dist)


def _middle_threshold(coeffs, xs, n):
    """A threshold in the middle (geometrically) of the widest run of a
    log grid over which the replayed schedule stays the same, skips and
    computes a step the rule decides."""
    grid = np.geomspace(1e-4, 1e2, 400)
    sched = [tuple(texp.simulate_calc_schedule(coeffs, xs, g, n)) for g in grid]
    best, start = (0, 0, 0), 0
    for i in range(1, len(grid) + 1):
        if i == len(grid) or sched[i] != sched[start]:
            if 2 < sum(sched[start]) < n and i - start > best[0]:
                best = (i - start, start, i - 1)
            start = i
    _, a, b = best
    return float(np.sqrt(grid[a] * grid[b]))


# ----------------------------------------------------------- the gate
@pytest.mark.parametrize("model_id,thresh", [("test-linear", 0.25), ("test-cubic", 0.6)])
def test_tea_cache_blocks_matches_jax(registered, model_id, thresh):
    """Eight sweeps of a stand-in block stack through both gates on the
    same (B, 2, 6, D) t_mod rows: the same decisions, outputs within
    1e-6, states (step, accumulator within 1e-6, residual) alike, and
    the schedule the replay predicts.  This draw's margins: 3.5% (linear,
    steps 0, 3, 6, 7 compute) and 9.9% (cubic, steps 0, 4, 7); asserted:
    1%."""
    rng = np.random.default_rng(0)
    n = 8
    base = rng.standard_normal((2, 2, 6, 32)).astype(np.float32)
    tmods = [(base * (1 + 0.1 * i) + 0.05 * rng.standard_normal(base.shape)).astype(np.float32)
             for i in range(n)]
    xs = [rng.standard_normal((2, 10, 32)).astype(np.float32) for _ in range(n)]
    js = jtc.init_tea_cache_state((2, 2, 6, 32), (2, 10, 32))
    ts = ttc.init_tea_cache_state((2, 2, 6, 32), (2, 10, 32))
    opts = dict(model_id=model_id, rel_l1_thresh=thresh, num_inference_steps=n)
    calls, dec = [], []
    for tm, x in zip(tmods, xs):
        jy, js = jtc.tea_cache_blocks(js, jnp.asarray(x), jnp.asarray(tm),
                                      lambda v: v * 1.5 + 0.25, **opts)
        before = len(calls)
        ty, ts = ttc.tea_cache_blocks(ts, _t(x), _t(tm),
                                      lambda v: calls.append(1) or v * 1.5 + 0.25, **opts)
        dec.append(len(calls) > before)
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=1e-6, rtol=1e-6)
        assert int(ts.step) == int(js.step)
        np.testing.assert_allclose(float(ts.accumulated), float(js.accumulated), rtol=1e-6,
                                   atol=1e-7)
        np.testing.assert_allclose(ts.prev_residual.numpy(), np.asarray(js.prev_residual),
                                   atol=1e-6)
        np.testing.assert_array_equal(ts.prev_modulated.numpy(), tm)
    assert int(ts.step) == 0  # wrapped at num_inference_steps
    # the replay over the drift trace predicts the same schedule
    trace = [np.abs(tmods[i] - tmods[i - 1]).mean() / np.abs(tmods[i - 1]).mean()
             for i in range(1, n)]
    mask = texp.simulate_calc_schedule(ttc.TEACACHE_COEFFICIENTS[model_id], trace, thresh, n)
    assert dec == list(mask) and 0 < sum(dec) < n
    assert _margin(ttc.TEACACHE_COEFFICIENTS[model_id], trace, thresh, mask) > 1e-2


def test_forced_calc_mask_and_unknown_model_id():
    rng = np.random.default_rng(1)
    mask = np.array([True, False, False, True, False, True])
    state = ttc.init_tea_cache_state((1, 1, 6, 8), (1, 4, 8))
    jstate = jtc.init_tea_cache_state((1, 1, 6, 8), (1, 4, 8))
    for i in range(6):
        x, tm = (rng.standard_normal(s).astype(np.float32) for s in ((1, 4, 8), (1, 1, 6, 8)))
        y, state = ttc.tea_cache_blocks(state, _t(x), _t(tm), lambda v: v + 1.0,
                                        num_inference_steps=6, forced_calc_mask=mask)
        jy, jstate = jtc.tea_cache_blocks(jstate, jnp.asarray(x), jnp.asarray(tm),
                                          lambda v: v + 1.0, num_inference_steps=6,
                                          forced_calc_mask=jnp.asarray(mask))
        np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=1e-6)
        assert float(state.accumulated) == 0.0
    with pytest.raises(KeyError, match="unknown TeaCache model_id"):
        ttc.tea_cache_blocks(state, _t(x), _t(tm), lambda v: v, model_id="no-such-model")


def test_schedule_replay_and_threshold_equal_jax():
    rng = np.random.default_rng(2)
    for coeffs, n in ((LINEAR, 20), (CUBIC, 50), (jtc.TEACACHE_COEFFICIENTS["Wan2.1-T2V-14B"], 30)):
        xs = (0.02 + 0.1 * rng.random(n - 1)).astype(np.float32)
        for thresh in (0.05, 0.2, 0.7):
            np.testing.assert_array_equal(texp.simulate_calc_schedule(coeffs, xs, thresh, n),
                                          jexp.simulate_calc_schedule(coeffs, xs, thresh, n))
        for frac in (0.3, 0.5, 0.8):
            assert texp.pick_threshold(coeffs, xs, n, frac) == \
                jexp.pick_threshold(coeffs, xs, n, frac)


# ---------------------------------------------------------- calibration
WAN = dict(dim=96, in_dim=4, ffn_dim=128, out_dim=4, text_dim=32, freq_dim=32,
           patch_size=(1, 2, 2), num_heads=4, num_layers=2, seperated_timestep=True,
           require_clip_embedding=False, require_vae_embedding=False)


@pytest.mark.parametrize("fuse", [False, True])
def test_capture_and_fit_match_jax(fuse):
    """One 8-step rollout of a tiny DiT in both packages (fuse: the
    two-segment t_mod of the TI2V first frame): the t_mod drifts within
    1e-5 relative, the output drifts within 1e-4; the degree-4 fit of the
    same pairs is the same numpy fit; calibrate_wan_tea_cache over two
    trajectories pools 14 pairs."""
    jcfg = jdit.WanDiTConfig(**WAN, fuse_vae_embedding_in_latents=fuse)
    tcfg = tdit.WanDiTConfig(**WAN, fuse_vae_embedding_in_latents=fuse)
    jp = jax.tree.map(np.asarray, jdit.init_dit_params(jax.random.key(0), jcfg))
    params = convert.from_jax_params(jp, device="cpu")
    rng = np.random.default_rng(3)
    lat = rng.standard_normal((1, 4, 3, 8, 8)).astype(np.float32)
    ctx = rng.standard_normal((1, 7, 32)).astype(np.float32)
    jx, jy = jcal.capture_wan_drift_pairs(jax.tree.map(jnp.asarray, jp), jcfg, jnp.asarray(lat),
                                          jnp.asarray(ctx), num_inference_steps=8)
    tx, ty = tcal.capture_wan_drift_pairs(params, tcfg, _t(lat), _t(ctx), num_inference_steps=8)
    assert tx.shape == jx.shape == (7,)
    np.testing.assert_allclose(tx, jx, rtol=1e-5)
    np.testing.assert_allclose(ty, jy, rtol=1e-4)
    assert tcal.fit_tea_cache_coefficients(jx, jy) == jcal.fit_tea_cache_coefficients(jx, jy)
    coeffs, (xs, ys) = tcal.calibrate_wan_tea_cache(params, tcfg, [_t(lat), _t(lat * 0.5)],
                                                    [_t(ctx), _t(ctx)], num_inference_steps=8)
    assert len(coeffs) == 5 and xs.shape == ys.shape == (14,)
    with pytest.raises(ValueError, match="more than 4"):
        tcal.fit_tea_cache_coefficients(xs[:4], ys[:4])
    tcal.register_tea_cache_coefficients("test-fitted", coeffs)
    try:
        assert ttc.TEACACHE_COEFFICIENTS["test-fitted"] == [float(c) for c in coeffs]
    finally:
        del ttc.TEACACHE_COEFFICIENTS["test-fitted"]


# ------------------------------------------------------- the pipeline
STEPS = 8


def _pipeline_threshold(pipe, kw):
    """t_mod depends only on the timestep: the drift trace of the
    request's two-segment t_mod, from the port's DiT, and a threshold in
    the middle of a run of the log grid with one schedule."""
    from fairygen_tpu_torch.diffusion.flow_match import FlowMatchScheduler

    sched = FlowMatchScheduler("Wan").set_timesteps(STEPS, shift=5.0)
    tmods = []
    for t in sched.timesteps.astype(np.float32):
        uniq = torch.tensor([[0.0, float(t)]])
        tmods.append(tdit.time_embedding(pipe.dit_params, pipe.dit_cfg, uniq)[1].numpy())
    xs = [float(np.abs(tmods[i] - tmods[i - 1]).mean() / np.abs(tmods[i - 1]).mean())
          for i in range(1, STEPS)]
    return xs, _middle_threshold(LINEAR, xs, STEPS)


@pytest.mark.parametrize("cfg_merge", [False, True])
def test_tea_cache_request_matches_jax(ckpts, registered, cfg_merge):
    """An 8-step CFG 5 request with the first image through both
    from_pretrained pipelines with TeaCache: the port computes the steps
    the replay predicts (in each CFG branch's state, or the one batch-2
    state), the JAX gate decides the same on its own t_mod, and the
    latents agree within 1e-4 (fp32, as the request without TeaCache).
    This draw: steps 0, 2, 4, 6 and 7 of 8 compute at threshold 0.36,
    each accumulator at least 23% away from it (asserted: 4%)."""
    jpipe, pipe = _jax_pipe(ckpts), _port_pipe(ckpts)
    kw = dict(REQUEST, input_image=ckpts["img"], output_type="latents",
              num_inference_steps=STEPS, cfg_merge=cfg_merge)
    xs, thresh = _pipeline_threshold(pipe, kw)
    mask = texp.simulate_calc_schedule(LINEAR, xs, thresh, STEPS)
    assert 2 < mask.sum() < STEPS and _margin(LINEAR, xs, thresh, mask) > 0.04
    tea = dict(tea_cache_l1_thresh=thresh, tea_cache_model_id="test-linear")

    decided = []
    real = ttc.tea_cache_blocks

    def spy(state, x, t_mod, blocks_fn, **opts):
        calls = []
        out = real(state, x, t_mod, lambda v: calls.append(1) or blocks_fn(v), **opts)
        decided.append(bool(calls))
        return out

    ttc.tea_cache_blocks = spy
    try:
        out = pipe(**kw, **tea)
    finally:
        ttc.tea_cache_blocks = real
    per_step = 1 if cfg_merge else 2
    assert decided == [m for m in mask for _ in range(per_step)]
    # the JAX gate on the JAX DiT's t_mod rows
    jstate = jtc.init_tea_cache_state((1, 2, 6, 96), (1, 8, 96))
    jdec = []
    from fairygen_tpu.diffusion.flow_match import FlowMatchScheduler as JScheduler

    for i, t in enumerate(JScheduler("Wan").set_timesteps(STEPS, shift=5.0).timesteps):
        t_mod = jdit.time_embedding(jpipe.dit_params, jpipe.dit_cfg,
                                    jnp.asarray([[0.0, float(np.float32(t))]]))[1]
        # a computed step leaves the residual i + 1 of its input i
        _, jstate = jtc.tea_cache_blocks(jstate, jnp.full((1, 8, 96), float(i)), t_mod,
                                         lambda v: 2 * v + 1, model_id="test-linear",
                                         rel_l1_thresh=thresh, num_inference_steps=STEPS)
        jdec.append(float(jstate.prev_residual[0, 0, 0]) == i + 1)
    assert jdec == list(mask)
    ref = np.asarray(jpipe(**kw, **tea))
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-4, rtol=1e-4)
    plain = pipe(**kw).numpy()
    assert np.abs(plain - out.numpy()).max() > 1e-3  # the skips show


def test_tea_cache_refuses_the_sliding_window(ckpts):
    pipe = _port_pipe(ckpts)
    with pytest.raises(ValueError, match="mutually exclusive"):
        pipe(**dict(REQUEST, num_frames=9), input_image=ckpts["img"], tea_cache_l1_thresh=0.1,
             sliding_window_size=2, sliding_window_stride=1)


def test_cli_twin_and_calibration_tool(ckpts, tmp_path, monkeypatch, capsys):
    """``tools/calibrate_tea_cache --target_calc_frac 0.5`` on the tiny
    checkpoints, its entry registered, then the CLI twin with
    ``--tea_cache_l1_thresh`` at the picked threshold writes the clip."""
    monkeypatch.setenv("FAIRYGEN_MODEL_HINTS", ckpts["hints_file"])
    monkeypatch.setitem(ttc.TEACACHE_COEFFICIENTS, "placeholder", LINEAR)
    paths = json.dumps(list(ckpts["paths"].values()))
    out = str(tmp_path / "coefficients.json")
    assert calibrate_tea_cache.main([
        "--device", "cpu", "--model_paths", paths, "--height", "32", "--width", "32",
        "--num_frames", "5", "--steps", "8", "--rollouts", "2", "--model_id", "tiny-ti2v",
        "--target_calc_frac", "0.5", "--out", out]) == 0
    report = json.loads(capsys.readouterr().out.splitlines()[0])
    assert report["pairs"] == 14 and report["predicted_calc_steps"] <= 4
    entry = json.load(open(out))
    assert list(entry) == ["tiny-ti2v"] and len(entry["tiny-ti2v"]) == 5
    monkeypatch.setitem(ttc.TEACACHE_COEFFICIENTS, "tiny-ti2v", entry["tiny-ti2v"])
    assert wan_inference.main([
        "--device", "cpu", "--model_paths", paths, "--tokenizer_path", ckpts["tokenizer"],
        "--prompt", "a pig walks", "--height", "32", "--width", "32", "--num_frames", "5",
        "--num_inference_steps", "8", "--tea_cache_l1_thresh", str(report["threshold"]),
        "--tea_cache_model_id", "tiny-ti2v", "--output", str(tmp_path / "out.mp4")]) == 0
    assert len(tvideo.load_video_frames(str(tmp_path / "out.gif"))) == 5
