"""The port's Wan conditioning variants against the JAX package, in fp32 on
the CPU: the camera plücker geometry and SimpleAdapter, the motion
controller and the VACE branch (each against its golden at the JAX
suite's own tolerances, tests/test_wan_camera.py and test_wan_aux.py, and
against the JAX module on the same weights), the DiT's Fun-Reference
conv, the converters bit for bit the JAX converters + ``from_jax_params``,
and tiny pipelines of both packages on the same weights and draws: VACE
with a reference frame, camera control, Fun-Reference (also windowed) and
the motion bucket.

Weights: the committed upstream goldens (wan_camera.npz, wan_aux.npz,
wan_vae_v1.npz) through each package's converter, and the JAX package's
``init_dit_params`` from a seed carried by ``from_jax_params``.  Module
outputs agree to ~1e-6 and are held to 1e-5; 2-step requests to 1e-4, as
the port's other pipeline tests.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fairygen_tpu.models.wan import aux_models as jaux
from fairygen_tpu.models.wan import camera as jcam
from fairygen_tpu.models.wan import dit as jdit
from fairygen_tpu.models.wan import vae as jvae
from fairygen_tpu.pipelines.wan_video import WanVideoPipeline as JPipeline
from fairygen_tpu_torch import convert
from fairygen_tpu_torch.core.model_pool import ModelPool
from fairygen_tpu_torch.models.adapters import leaves_with_path
from fairygen_tpu_torch.models.wan import aux_models as taux
from fairygen_tpu_torch.models.wan import camera as tcam
from fairygen_tpu_torch.models.wan import dit as tdit
from fairygen_tpu_torch.models.wan import vae as tvae
from fairygen_tpu_torch.pipelines.wan_video import WanVideoPipeline
from test_torch_wan_variants import _upstream_dit_sd

ATOL = 1e-5
REQ_ATOL = 1e-4
TINY = dict(dim=96, in_dim=4, ffn_dim=128, out_dim=4, text_dim=32, freq_dim=32,
            patch_size=(1, 2, 2), num_heads=4, num_layers=2, require_clip_embedding=False)
H = W = 32
FRAMES = 9


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this file's tests, restored after (tiny
    shapes; under the suite's six workers torch's thread pools contend)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


_jax_forward = jax.jit(jdit.wan_dit_forward, static_argnames=("cfg", "vace_cfg"))


def _sd(g, prefix):
    n = len(prefix) + 2
    return {k[n:]: g[k] for k in g.files if k.startswith(prefix + "::")}


def _assert_same_tree(got, ref):
    got, ref = dict(leaves_with_path(got)), dict(leaves_with_path(ref))
    assert sorted(got) == sorted(ref)
    for k in ref:
        assert got[k].dtype == ref[k].dtype, k
        np.testing.assert_array_equal(got[k].numpy(), ref[k].numpy(), err_msg=str(k))


# --------------------------------------------------------------- camera
def test_plucker_matches_jax_and_golden(goldens):
    """The pose trajectory and plücker rays are the JAX package's numpy,
    bit for bit, and the golden's within its 1e-5."""
    g = goldens("wan_camera")
    coords = tcam.generate_camera_coordinates("LeftUp", 5, 1 / 54)
    assert coords == jcam.generate_camera_coordinates("LeftUp", 5, 1 / 54)
    np.testing.assert_allclose(np.array(coords), g["coords"], atol=1e-12)
    pl = tcam.process_pose_file(coords, width=32, height=16)
    np.testing.assert_array_equal(pl, jcam.process_pose_file(coords, width=32, height=16))
    np.testing.assert_allclose(pl, g["plucker"], atol=1e-5, rtol=1e-5)


def test_simple_adapter_matches_jax_and_golden(goldens):
    g = goldens("wan_camera")
    sd = _sd(g, "sd")
    jcfg, tcfg = jcam.SimpleAdapterConfig(in_dim=6, out_dim=32), \
        tcam.SimpleAdapterConfig(in_dim=6, out_dim=32)
    ref = np.asarray(jcam.simple_adapter_forward(
        jcam.convert_simple_adapter_state_dict(sd, jcfg), jcfg, jnp.asarray(g["x"])))
    out = tcam.simple_adapter_forward(
        tcam.convert_simple_adapter_state_dict(sd, tcfg, device="cpu"), tcfg, _t(g["x"])).numpy()
    assert out.shape == g["o"].shape == (1, 32, 3, 2, 2)
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=0)
    np.testing.assert_allclose(out, g["o"], atol=2e-5, rtol=1e-4)


# ------------------------------------------------- motion controller, VACE
def test_motion_controller_matches_jax_and_golden(goldens):
    g = goldens("wan_aux")
    jcfg, tcfg = jaux.MotionControllerConfig(32, 96), taux.MotionControllerConfig(32, 96)
    ref = np.asarray(jaux.motion_controller_forward(
        jaux.convert_motion_controller_state_dict(_sd(g, "mc"), jcfg), jcfg,
        jnp.asarray(g["mc_in"])))
    out = taux.motion_controller_forward(
        taux.convert_motion_controller_state_dict(_sd(g, "mc"), tcfg, device="cpu"), tcfg,
        _t(g["mc_in"])).numpy()
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=0)
    np.testing.assert_allclose(out, g["mc_out"], atol=1e-5, rtol=1e-4)


VACE = dict(vace_layers=(0, 2), vace_in_dim=16, dim=96, num_heads=4, ffn_dim=128)


@pytest.mark.parametrize("hints", ["internal", "external"])
def test_vace_forward_matches_jax_and_golden(goldens, hints):
    """The DiT with the VACE branch (hints after blocks 0 and 2 of 4, scale
    0.8): computed inside ``wan_dit_forward`` from ``vace_context``, or by
    ``vace_forward`` outside it and passed as {block: hint} (the JAX
    package's golden wiring, with the stack's zero rows left out)."""
    g = goldens("wan_aux")
    kw = dict(TINY, in_dim=8, out_dim=8, num_layers=4)
    jcfg, tcfg = jdit.WanDiTConfig(**kw), tdit.WanDiTConfig(**kw)
    jvcfg, tvcfg = jaux.VaceConfig(**VACE), taux.VaceConfig(**VACE)
    jp = jdit.convert_dit_state_dict(_sd(g, "dit"), jcfg)
    jv = jaux.convert_vace_state_dict(_sd(g, "vace"), jvcfg)
    tp = tdit.convert_dit_state_dict(_sd(g, "dit"), tcfg, device="cpu")
    tv = taux.convert_vace_state_dict(_sd(g, "vace"), tvcfg, device="cpu")
    ref = np.asarray(_jax_forward(jp, jcfg, jnp.asarray(g["lat"]), jnp.asarray(g["ts"]),
                                  jnp.asarray(g["ctx"]), vace_params=jv, vace_cfg=jvcfg,
                                  vace_context=jnp.asarray(g["vctx"]), vace_scale=0.8))
    lat, ts, ctx = _t(g["lat"]), _t(g["ts"]), _t(g["ctx"])
    if hints == "internal":
        out = tdit.wan_dit_forward(tp, tcfg, lat, ts, ctx, vace_params=tv, vace_cfg=tvcfg,
                                   vace_context=_t(g["vctx"]), vace_scale=0.8)
    else:
        _, t_mod = tdit.time_embedding(tp, tcfg, ts)
        x, grid = tdit.patchify(tp, tcfg, lat)
        from fairygen_tpu_torch.ops.rope import build_freqs_grid, precompute_freqs_3d

        freqs = build_freqs_grid(precompute_freqs_3d(tcfg.head_dim), *grid)
        got = taux.vace_forward(tv, tvcfg, x, _t(g["vctx"]), tdit.text_embedding(tp, ctx),
                                t_mod[:, None], freqs)
        assert sorted(got) == [0, 2]
        out = tdit.wan_dit_forward(tp, tcfg, lat, ts, ctx, vace_hints=got, vace_scale=0.8)
    np.testing.assert_allclose(out.numpy(), ref, atol=ATOL, rtol=0)
    np.testing.assert_allclose(out.numpy(), g["vace_out"], atol=5e-4, rtol=1e-3)


# ---------------------------------------------------------- Fun-Reference
def _jax_dit(kw, seed, ref_in=16):
    cfg = jdit.WanDiTConfig(**kw)
    jp = _np(jdit.init_dit_params(jax.random.key(seed), cfg))
    if kw.get("has_ref_conv"):
        rng = np.random.default_rng(seed + 100)
        w = 0.05 * rng.standard_normal((ref_in * 4, cfg.dim))
        jp["ref_conv"] = {"w": w.astype(np.float32),
                          "b": (0.01 * rng.standard_normal(cfg.dim)).astype(np.float32)}
    return cfg, jp


def test_fun_reference_dit_matches_jax():
    """``has_ref_conv``: the reference latent's 2x2 patches through
    ref_conv as a leading frame of tokens (the RoPE grid one frame longer),
    stripped before the output."""
    kw = dict(TINY, has_ref_conv=True)
    jcfg, jp = _jax_dit(kw, 0, ref_in=4)
    rng = np.random.default_rng(1)
    lat = rng.standard_normal((1, 4, 3, 4, 4)).astype(np.float32)
    ref_lat = rng.standard_normal((1, 4, 1, 4, 4)).astype(np.float32)
    ctx = rng.standard_normal((1, 6, 32)).astype(np.float32)
    t = np.asarray([600.0], np.float32)
    ref = np.asarray(_jax_forward(jax.tree.map(jnp.asarray, jp), jcfg, jnp.asarray(lat),
                                  jnp.asarray(t), jnp.asarray(ctx),
                                  reference_latents=jnp.asarray(ref_lat)))
    tcfg = tdit.WanDiTConfig(**kw)
    tp = convert.from_jax_params(jp, device="cpu")
    out = tdit.wan_dit_forward(tp, tcfg, _t(lat), _t(t), _t(ctx), reference_latents=_t(ref_lat))
    assert out.shape == (1, 4, 3, 4, 4)
    np.testing.assert_allclose(out.numpy(), ref, atol=ATOL, rtol=0)
    plain = tdit.wan_dit_forward(tp, tcfg, _t(lat), _t(t), _t(ctx))
    assert not np.allclose(plain.numpy(), out.numpy(), atol=1e-3)


# -------------------------------------------------------------- converters
def _dit_ref_sd():
    kw = dict(TINY, has_ref_conv=True)
    cfg, jp = _jax_dit(kw, 2)
    sd = _upstream_dit_sd(jp, cfg)
    w = jp["ref_conv"]["w"].reshape(16, 2, 2, cfg.dim).transpose(3, 0, 1, 2)
    sd.update({"ref_conv.weight": np.ascontiguousarray(w), "ref_conv.bias": jp["ref_conv"]["b"]})
    return sd, kw


@pytest.mark.parametrize("name", ["dit_ref_conv", "simple_adapter", "motion_controller",
                                  "vace"])
def test_converters_match_jax_and_from_jax_params(goldens, name):
    """Each port converter gives the JAX converter's arrays through
    ``from_jax_params``, bit for bit; and the seeded ``init_*`` makes the
    same tree (paths and shapes)."""
    if name == "dit_ref_conv":
        sd, kw = _dit_ref_sd()
        jcfg, tcfg = jdit.WanDiTConfig(**kw), tdit.WanDiTConfig(**kw)
        ref, got = jdit.convert_dit_state_dict(sd, jcfg), tdit.convert_dit_state_dict(
            sd, tcfg, device="cpu")
        made = convert.init_dit_params(tcfg, "cpu", torch.float32)
    elif name == "simple_adapter":
        sd = _sd(goldens("wan_camera"), "sd")
        jcfg, tcfg = jcam.SimpleAdapterConfig(6, 32), tcam.SimpleAdapterConfig(6, 32)
        ref = jcam.convert_simple_adapter_state_dict(sd, jcfg)
        got = tcam.convert_simple_adapter_state_dict(sd, tcfg, device="cpu")
        made = convert.init_simple_adapter_params(tcfg, "cpu", torch.float32)
    elif name == "motion_controller":
        sd = _sd(goldens("wan_aux"), "mc")
        jcfg, tcfg = jaux.MotionControllerConfig(32, 96), taux.MotionControllerConfig(32, 96)
        ref = jaux.convert_motion_controller_state_dict(sd, jcfg)
        got = taux.convert_motion_controller_state_dict(sd, tcfg, device="cpu")
        made = convert.init_motion_controller_params(tcfg, "cpu", torch.float32)
    else:
        sd = _sd(goldens("wan_aux"), "vace")
        jcfg, tcfg = jaux.VaceConfig(**VACE), taux.VaceConfig(**VACE)
        ref = jaux.convert_vace_state_dict(sd, jcfg)
        got = taux.convert_vace_state_dict(sd, tcfg, device="cpu")
        made = convert.init_vace_params(tcfg, "cpu", torch.float32)
    ref = convert.from_jax_params(_np(ref), device="cpu")
    _assert_same_tree(got, ref)
    made, ref = dict(leaves_with_path(made)), dict(leaves_with_path(ref))
    assert sorted(made) == sorted(ref)
    assert all(made[k].shape == ref[k].shape for k in ref)


def test_dit_builder_builds_the_fun_reference_conv():
    """``has_ref_conv`` through the model pool's DiT builder: ref_conv read."""
    sd, kw = _dit_ref_sd()
    hint = dict(kw, patch_size=list(kw["patch_size"]))
    params, cfg = ModelPool().registry.builder("wan_video_dit")(sd, hint, torch.float32, "cpu")
    assert cfg.has_ref_conv and params["ref_conv"]["w"].shape == (64, 96)
    np.testing.assert_array_equal(params["ref_conv"]["b"].numpy(), sd["ref_conv.bias"])


# --------------------------------------------------------------- pipelines
@pytest.fixture(scope="module")
def v1(goldens):
    g = goldens("wan_vae_v1")
    sd = _sd(g, "sd")
    jcfg, tcfg = jvae.WanVAEConfig.tiny_v1(), tvae.WanVAEConfig.tiny_v1()
    return dict(jcfg=jcfg, tcfg=tcfg, jp=jvae.convert_vae_v1_state_dict(sd, jcfg),
                tp=tvae.convert_vae_v1_state_dict(sd, tcfg, device="cpu"))


def _pipes(v1, kw, seed=0, **models):
    """A JAX and a port pipeline on the same tiny DiT, the v1 VAE golden and
    ``models`` ({name: (jax params, jax cfg, port params, port cfg)})."""
    jcfg, jp = _jax_dit(kw, seed, ref_in=4)
    jkw, tkw = {}, {}
    for name, (mjp, mjc, mtp, mtc) in models.items():
        jkw.update({f"{name}_params": mjp, f"{name}_cfg": mjc})
        tkw.update({f"{name}_params": mtp, f"{name}_cfg": mtc})
    jpipe = JPipeline(dit_params=jax.tree.map(jnp.asarray, jp), dit_cfg=jcfg,
                      vae_params=v1["jp"], vae_cfg=v1["jcfg"], dtype=jnp.float32, **jkw)
    pipe = WanVideoPipeline(convert.from_jax_params(jp, device="cpu"), tdit.WanDiTConfig(**kw),
                            v1["tp"], v1["tcfg"], dtype=torch.float32, device="cpu", **tkw)
    return jpipe, pipe


def _both(jpipe, pipe, **kw):
    """The same request through both pipelines; ``negative=True`` adds a
    seeded negative context (CFG as two sweeps); ``jpipe`` None runs the
    port's alone."""
    rng = np.random.default_rng(9)
    ctx = rng.standard_normal((1, 6, 32)).astype(np.float32)
    neg = rng.standard_normal((1, 6, 32)).astype(np.float32) if kw.pop("negative", False) else None
    req = dict(cfg_scale=1.0, seed=3, height=H, width=W, num_frames=FRAMES,
               num_inference_steps=2, output_type="latents", torch_compat_noise=True)
    req.update(kw)
    jneg = None if neg is None else jnp.asarray(neg)
    ref = None if jpipe is None else np.asarray(jpipe(context=jnp.asarray(ctx), **req,
                                                      negative_context=jneg))
    out = pipe(context=_t(ctx), **req, negative_context=None if neg is None else _t(neg))
    return out.numpy(), ref


def _images(n, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (H, W, 3), dtype=np.uint8) for _ in range(n)]


def _vace_models(goldens):
    """A one-layer VACE branch of the tiny width (vace_in_dim 72 = 2 x 4
    latent + 64 mask channels): block 0 of the golden's branch, the patch
    embedding from a seed."""
    kw = dict(VACE, vace_layers=(0,), vace_in_dim=72)
    jcfg, tcfg = jaux.VaceConfig(**kw), taux.VaceConfig(**kw)
    jv = _np(jaux.convert_vace_state_dict(_sd(goldens("wan_aux"), "vace"),
                                          jaux.VaceConfig(**VACE)))
    rng = np.random.default_rng(11)
    jv = {"patch_embedding": {"w": (0.02 * rng.standard_normal((72 * 4, 96))).astype(np.float32),
                              "b": np.zeros(96, np.float32)}, "blocks": jv["blocks"][:1]}
    return (jax.tree.map(jnp.asarray, jv), jcfg, convert.from_jax_params(jv, device="cpu"), tcfg)


def test_vace_request_with_a_reference_frame_matches_jax(v1, goldens):
    """VACE (a control video, its mask, a reference image, scale 0.7): the
    reference frame's noise rolled to the front and dropped after."""
    jpipe, pipe = _pipes(v1, TINY, vace=_vace_models(goldens))
    vid, ref_img = _images(FRAMES, 1), _images(1, 2)[0]
    msk = [np.where(np.arange(W)[None, :, None] < 16, 255, 0).repeat(H, 0).repeat(3, 2)
           .astype(np.uint8)] * FRAMES
    out, ref = _both(jpipe, pipe, vace_video=vid, vace_video_mask=msk,
                     vace_reference_image=ref_img, vace_scale=0.7)
    assert out.shape == (1, 4, 3, 4, 4)
    np.testing.assert_allclose(out, ref, atol=REQ_ATOL, rtol=0)
    plain, _ = _both(None, pipe, vace_video=vid, vace_video_mask=msk, vace_scale=0.0)
    assert not np.allclose(out, plain, atol=1e-3)


def test_camera_request_matches_jax(v1):
    """Camera control ("Left"): the plücker video through the SimpleAdapter
    added to the patch tokens, and the first-frame ``y`` (in_dim 8 = 4
    noise + 4 y channels) from ``input_image``."""
    rng = np.random.default_rng(7)
    ccfg = dict(in_dim=24, out_dim=96)
    cam = {"conv": {"w": (0.01 * rng.standard_normal((2, 2, 24 * 64, 96))).astype(np.float32),
                    "b": np.zeros(96, np.float32)},
           "blocks": [{c: {"w": (0.01 * rng.standard_normal((3, 3, 96, 96))).astype(np.float32),
                           "b": (0.01 * rng.standard_normal(96)).astype(np.float32)}
                       for c in ("conv1", "conv2")}]}
    kw = dict(TINY, in_dim=8, require_vae_embedding=True)
    jpipe, pipe = _pipes(v1, kw, camera=(jax.tree.map(jnp.asarray, cam),
                                         jcam.SimpleAdapterConfig(**ccfg),
                                         convert.from_jax_params(cam, device="cpu"),
                                         tcam.SimpleAdapterConfig(**ccfg)))
    img = _images(1, 3)[0]
    out, ref = _both(jpipe, pipe, camera_control_direction="Left", input_image=img)
    np.testing.assert_allclose(out, ref, atol=REQ_ATOL, rtol=0)
    up, _ = _both(None, pipe, camera_control_direction="Up", input_image=img)
    assert not np.allclose(out, up, atol=1e-5)
    with pytest.raises(ValueError, match="not in"):
        pipe(context=torch.zeros(1, 6, 32), cfg_scale=1.0, height=H, width=W,
             num_frames=FRAMES, camera_control_direction="Sideways", input_image=img)


@pytest.mark.parametrize("windowed", [False, True])
def test_fun_reference_request_matches_jax(v1, windowed):
    """Fun-Reference, and in the sliding window (windows of 2 latent frames
    at stride 1) the reference latent in every window, as the JAX test
    tests/test_wan_pipeline.py checks; CFG 4 in two sweeps."""
    jpipe, pipe = _pipes(v1, dict(TINY, has_ref_conv=True))
    a, b = _images(2, 4)
    kw = dict(reference_image=a, cfg_scale=4.0, negative=True)
    if windowed:
        kw.update(sliding_window_size=2, sliding_window_stride=1)
    out, ref = _both(jpipe, pipe, **kw)
    np.testing.assert_allclose(out, ref, atol=REQ_ATOL, rtol=0)
    other, _ = _both(None, pipe, **dict(kw, reference_image=b))
    assert not np.allclose(out, other, atol=1e-6)


def test_motion_bucket_request_matches_jax(v1, goldens):
    """motion_bucket_id: the motion controller's bias on every block's
    modulation (the golden controller at the tiny width 96)."""
    g = goldens("wan_aux")
    jcfg, tcfg = jaux.MotionControllerConfig(32, 96), taux.MotionControllerConfig(32, 96)
    jpipe, pipe = _pipes(v1, TINY, motion_controller=(
        jaux.convert_motion_controller_state_dict(_sd(g, "mc"), jcfg), jcfg,
        taux.convert_motion_controller_state_dict(_sd(g, "mc"), tcfg, device="cpu"), tcfg))
    out, ref = _both(jpipe, pipe, motion_bucket_id=3)
    np.testing.assert_allclose(out, ref, atol=REQ_ATOL, rtol=0)
    other, _ = _both(None, pipe, motion_bucket_id=60)
    assert not np.allclose(out, other, atol=1e-5)


@pytest.mark.parametrize("kind", ["vace", "camera"])
def test_sliding_window_refuses_vace_and_camera(v1, goldens, kind):
    """As the JAX package: no per-window meaning, so the request raises."""
    if kind == "vace":
        _, pipe = _pipes(v1, TINY, vace=_vace_models(goldens))
        kw = dict(vace_video=_images(FRAMES, 5))
    else:
        cam = convert.init_simple_adapter_params(tcam.SimpleAdapterConfig(24, 96), "cpu",
                                                 torch.float32)
        _, pipe = _pipes(v1, dict(TINY, in_dim=8, require_vae_embedding=True))
        pipe.camera_params, pipe.camera_cfg = cam, tcam.SimpleAdapterConfig(24, 96)
        kw = dict(camera_control_direction="Left", input_image=_images(1, 6)[0])
    with pytest.raises(ValueError, match="sliding-window"):
        pipe(context=torch.zeros(1, 6, 32), cfg_scale=1.0, height=H, width=W,
             num_frames=FRAMES, num_inference_steps=1, sliding_window_size=3,
             sliding_window_stride=2, output_type="latents", **kw)
