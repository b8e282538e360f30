"""The port's Wan-Animate adapter against the JAX package, in fp32 on the
CPU: the converter bit for bit the JAX converter + ``from_jax_params``; the
motion encoder (with its QR direction basis), the face encoder and the face
block against the golden (tests/goldens/wan_animate.npz) at the JAX suite's
tolerances (tests/test_wan_animate.py) and against the JAX functions on the
same weights; the DiT with the pose and face hooks against the JAX
forward; and a tiny Animate request (pose, face, inpaint and mask videos,
trimmed 4 frames short of an input video, CFG with the blank face video)
through both pipelines on the same weights and draws.  Module outputs
agree to ~1e-6 and are held to 1e-5; 2-step requests to 1e-4.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fairygen_tpu.models.wan import animate as ja
from fairygen_tpu.models.wan import dit as jdit
from fairygen_tpu.models.wan import vae as jvae
from fairygen_tpu.pipelines.wan_video import WanVideoPipeline as JPipeline
from fairygen_tpu_torch import convert
from fairygen_tpu_torch.models.adapters import leaves_with_path
from fairygen_tpu_torch.models.wan import animate as ta
from fairygen_tpu_torch.models.wan import dit as tdit
from fairygen_tpu_torch.models.wan import vae as tvae
from fairygen_tpu_torch.pipelines.wan_video import WanVideoPipeline

ATOL = 1e-5
REQ_ATOL = 1e-4
# the golden's adapter (tests/test_wan_animate.py), with two face blocks
# after blocks 0 and 2 of 3
CFG = dict(hidden_dim=96, heads_num=4, num_adapter_layers=2, adapter_stride=2, face_in_dim=512,
           face_heads=2, face_inner=1024, motion_size=8, style_dim=64, motion_dim=8,
           pose_in_dim=4)
DIT = dict(dim=96, in_dim=12, ffn_dim=128, out_dim=4, text_dim=32, freq_dim=32,
           patch_size=(1, 2, 2), num_heads=4, num_layers=3, require_clip_embedding=False)
H = W = 32
FRAMES = 5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def adapter(goldens):
    """The golden's upstream state dict (fp32) with a second, seeded face
    block and a 4-channel pose patch embedding; both packages' params."""
    g = goldens("wan_animate")
    sd = {}
    for k in g.files:
        for tag, prefix in (("gen::", "motion_encoder."), ("fe::", "face_encoder."),
                            ("fb::", "face_adapter.fuser_blocks.0.")):
            if k.startswith(tag):
                sd[prefix + k[len(tag):]] = g[k].astype(np.float32)
    rng = np.random.default_rng(5)
    for k in [k for k in sd if k.startswith("face_adapter.fuser_blocks.0.")]:
        sd[k.replace(".0.", ".1.", 1)] = (sd[k] + 0.05 * rng.standard_normal(sd[k].shape)
                                          ).astype(np.float32)
    sd["pose_patch_embedding.weight"] = (0.05 * rng.standard_normal((96, 4, 1, 2, 2))
                                         ).astype(np.float32)
    sd["pose_patch_embedding.bias"] = (0.01 * rng.standard_normal(96)).astype(np.float32)
    jcfg, tcfg = ja.AnimateConfig(**CFG), ta.AnimateConfig(**CFG)
    return dict(sd=sd, g=g, jcfg=jcfg, tcfg=tcfg, jp=ja.convert_animate_state_dict(sd, jcfg),
                tp=ta.convert_animate_state_dict(sd, tcfg, device="cpu"))


def test_converter_matches_jax_and_from_jax_params(adapter):
    """Bit for bit the JAX converter through ``from_jax_params`` (conv2d
    weights channels-first, conv1d (k, in, out)); the seeded
    ``init_animate_params`` makes the same tree."""
    ref = convert.from_jax_params(jax.tree.map(np.asarray, adapter["jp"]), device="cpu")
    got, ref = dict(leaves_with_path(adapter["tp"])), dict(leaves_with_path(ref))
    assert sorted(got) == sorted(ref)
    for k in ref:
        assert got[k].dtype == ref[k].dtype, k
        np.testing.assert_array_equal(got[k].numpy(), ref[k].numpy(), err_msg=str(k))
    made = dict(leaves_with_path(convert.init_animate_params(adapter["tcfg"], "cpu",
                                                             torch.float32)))
    assert sorted(made) == sorted(ref)
    assert all(made[k].shape == ref[k].shape for k in ref)


def test_motion_encoder_matches_jax_and_golden(adapter):
    """The appearance encoder, the motion MLP and the projection on the QR
    basis of the fp32 direction weight."""
    g = adapter["g"]
    out = ta.get_motion(adapter["tp"]["motion_encoder"], _t(g["gen_img"])).numpy()
    ref = np.asarray(ja.get_motion(adapter["jp"]["motion_encoder"], jnp.asarray(g["gen_img"])))
    assert out.shape == (3, 512)
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=0)
    np.testing.assert_allclose(out, g["gen_motion"], atol=2e-3, rtol=1e-2)


def test_face_encoder_matches_jax_and_golden(adapter):
    g = adapter["g"]
    out = ta.face_encoder_forward(adapter["tp"]["face_encoder"], adapter["tcfg"],
                                  _t(g["fe_in"])).numpy()
    ref = np.asarray(ja.face_encoder_forward(adapter["jp"]["face_encoder"], adapter["jcfg"],
                                             jnp.asarray(g["fe_in"])))
    assert out.shape == (1, 4, 3, 96)
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=0)
    np.testing.assert_allclose(out, g["fe_out"], atol=2e-4, rtol=1e-3)


def test_face_block_and_injection_match_golden(adapter):
    """The face block's residual, added after mapped blocks only."""
    g, tp, tcfg = adapter["g"], adapter["tp"], adapter["tcfg"]
    x, mvec = _t(g["fb_x"]), _t(g["fb_mvec"])
    res = ta.face_block_forward(tp["face_adapter"][0], tcfg, x, mvec).numpy()
    ref = np.asarray(ja.face_block_forward(adapter["jp"]["face_adapter"][0], adapter["jcfg"],
                                           jnp.asarray(g["fb_x"]), jnp.asarray(g["fb_mvec"])))
    np.testing.assert_allclose(res, ref, atol=ATOL, rtol=0)
    np.testing.assert_allclose(res, g["fb_out"], atol=2e-4, rtol=1e-3)
    out = ta.animate_after_transformer_block(tp, tcfg, 0, x, mvec).numpy()
    np.testing.assert_allclose(out, g["fb_x"] + g["fb_out"], atol=2e-4)
    np.testing.assert_array_equal(ta.animate_after_transformer_block(tp, tcfg, 3, x, mvec), x)


def _jax_dit(seed):
    cfg = jdit.WanDiTConfig(**DIT)
    return cfg, jax.tree.map(np.asarray, jdit.init_dit_params(jax.random.key(seed), cfg))


def test_dit_forward_with_the_animate_hooks_matches_jax(adapter):
    """Pose tokens on frames 1.. and face-block residuals after blocks 0
    and 2 of 3 (stride 2): the port's forward against the JAX forward."""
    jcfg, jp = _jax_dit(0)
    rng = np.random.default_rng(2)
    lat = rng.standard_normal((1, 4, 3, 4, 4)).astype(np.float32)
    y = rng.standard_normal((1, 8, 3, 4, 4)).astype(np.float32)
    pose = rng.standard_normal((1, 4, 2, 4, 4)).astype(np.float32)
    face = rng.uniform(-1, 1, (1, 3, 5, 8, 8)).astype(np.float32)
    ctx = rng.standard_normal((1, 6, 32)).astype(np.float32)
    t = np.asarray([700.0], np.float32)
    kw = dict(y=jnp.asarray(y), animate_params=adapter["jp"], animate_cfg=adapter["jcfg"],
              pose_latents=jnp.asarray(pose), face_pixel_values=jnp.asarray(face))
    ref = np.asarray(jax.jit(jdit.wan_dit_forward, static_argnames=("cfg", "animate_cfg"))(
        jax.tree.map(jnp.asarray, jp), jcfg, jnp.asarray(lat), jnp.asarray(t), jnp.asarray(ctx),
        **kw))
    tcfg, tp = tdit.WanDiTConfig(**DIT), convert.from_jax_params(jp, device="cpu")
    out = tdit.wan_dit_forward(tp, tcfg, _t(lat), _t(t), _t(ctx), y=_t(y),
                               animate_params=adapter["tp"], animate_cfg=adapter["tcfg"],
                               pose_latents=_t(pose), face_pixel_values=_t(face))
    assert out.shape == (1, 4, 3, 4, 4)
    np.testing.assert_allclose(out.numpy(), ref, atol=ATOL, rtol=0)
    plain = tdit.wan_dit_forward(tp, tcfg, _t(lat), _t(t), _t(ctx), y=_t(y))
    assert not np.allclose(plain.numpy(), out.numpy(), atol=1e-3)


# --------------------------------------------------------------- request
@pytest.fixture(scope="module")
def pipes(goldens, adapter):
    """A JAX and a port pipeline on the same tiny DiT (in_dim 12: 4 noise +
    4 mask + 4 y channels), the v1 VAE golden and the adapter."""
    g = goldens("wan_vae_v1")
    sd = {k[4:]: g[k] for k in g.files if k.startswith("sd::")}
    jv, tv = jvae.WanVAEConfig.tiny_v1(), tvae.WanVAEConfig.tiny_v1()
    jcfg, jp = _jax_dit(1)
    jpipe = JPipeline(dit_params=jax.tree.map(jnp.asarray, jp), dit_cfg=jcfg,
                      vae_params=jvae.convert_vae_v1_state_dict(sd, jv), vae_cfg=jv,
                      animate_params=adapter["jp"], animate_cfg=adapter["jcfg"],
                      dtype=jnp.float32)
    pipe = WanVideoPipeline(convert.from_jax_params(jp, device="cpu"), tdit.WanDiTConfig(**DIT),
                            tvae.convert_vae_v1_state_dict(sd, tv, device="cpu"), tv,
                            dtype=torch.float32, device="cpu", animate_params=adapter["tp"],
                            animate_cfg=adapter["tcfg"])
    return jpipe, pipe


def _videos(seed, n):
    rng = np.random.default_rng(seed)
    frames = [rng.integers(0, 256, (H, W, 3), dtype=np.uint8) for _ in range(n)]
    faces = [rng.integers(0, 256, (8, 8, 3), dtype=np.uint8) for _ in range(n)]
    masks = [np.where(np.arange(W)[None, :, None] < 16 + i, 255, 0).repeat(H, 0).repeat(3, 2)
             .astype(np.uint8) for i in range(n)]
    return frames, faces, masks


def _request(seed=3):
    rng = np.random.default_rng(9)
    ctx = rng.standard_normal((1, 6, 32)).astype(np.float32)
    neg = rng.standard_normal((1, 6, 32)).astype(np.float32)
    pose, face, mask = _videos(seed, 3)
    inpaint, _, _ = _videos(seed + 1, 3)
    img = _videos(seed + 2, 1)[0][0]
    return ctx, neg, dict(input_image=img, input_video=_videos(seed + 3, FRAMES)[0],
                          animate_pose_video=pose, animate_face_video=face,
                          animate_inpaint_video=inpaint, animate_mask_video=mask, cfg_scale=4.0,
                          seed=4, height=H, width=W, num_frames=FRAMES, num_inference_steps=2,
                          output_type="latents", torch_compat_noise=True)


def test_animate_request_matches_jax(pipes):
    """Control videos of 3 frames trimmed to 1 (the input video's 5 less 4;
    untrimmed, the face tokens' and the mask's frames would not fit), the
    pose latents, the face video's motion tokens and the blank face video in
    the CFG branch, the inpaint ``y`` of the reference frame and the masked
    background; frame 0 dropped before the output."""
    jpipe, pipe = pipes
    ctx, neg, req = _request()
    ref = np.asarray(jpipe(context=jnp.asarray(ctx), negative_context=jnp.asarray(neg), **req))
    out = pipe(context=_t(ctx), negative_context=_t(neg), **req).numpy()
    assert out.shape == (1, 4, 1, 4, 4)
    np.testing.assert_allclose(out, ref, atol=REQ_ATOL, rtol=0)
    other = dict(req, animate_face_video=_videos(11, 3)[1])
    moved = pipe(context=_t(ctx), negative_context=_t(neg), **other).numpy()
    assert not np.allclose(out, moved, atol=1e-6)  # the face video conditions


def test_animate_refuses_the_sliding_window_and_a_missing_adapter(pipes):
    """As the JAX package: no per-window meaning, so a windowed request
    raises; without the adapter the request names ``animate_params``."""
    _, pipe = pipes
    ctx, _, req = _request()
    req.update(cfg_scale=1.0, num_inference_steps=1, sliding_window_size=2,
               sliding_window_stride=1)
    with pytest.raises(ValueError, match="sliding-window"):
        pipe(context=_t(ctx), **req)
    bare = WanVideoPipeline(pipe.dit_params, pipe.dit_cfg, pipe.vae_params, pipe.vae_cfg,
                            dtype=torch.float32, device="cpu")
    with pytest.raises(ValueError, match="animate_params"):
        bare(context=_t(ctx), **req)
