"""The port's LongCat-Video DiT against the JAX package, in fp32 on the CPU:
the converter bit for bit the JAX converter + ``from_jax_params``; the RoPE
tables bit for bit (44 / 42 / 42 at head dim 128); one block in T2V and in
cond mode and the whole forward (the golden tests/goldens/longcat.npz,
T2V and with 2 conditioning frames, at the JAX suite's 2e-4 / 1e-3,
tests/test_longcat.py) against the JAX functions on the same weights; and
tiny requests, T2V and a continuation from a 5-frame ``longcat_video``
with CFG, through both pipelines on the same weights and draws.  Module
outputs agree to ~1e-6 and are held to 1e-5; 2-step requests to 1e-4.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fairygen_tpu.models.wan import longcat as jlc
from fairygen_tpu.models.wan import vae as jvae
from fairygen_tpu.pipelines.wan_video import WanVideoPipeline as JPipeline
from fairygen_tpu_torch import convert
from fairygen_tpu_torch.core.imaging import preprocess_video
from fairygen_tpu_torch.models.adapters import leaves_with_path
from fairygen_tpu_torch.models.wan import longcat as tlc
from fairygen_tpu_torch.models.wan import vae as tvae
from fairygen_tpu_torch.pipelines.wan_video import WanVideoPipeline

ATOL = 1e-5
REQ_ATOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def golden(goldens):
    g = goldens("longcat")
    sd = {k[3:]: g[k] for k in g.files if k.startswith("sd.")}
    jc, tc = jlc.LongCatDiTConfig.tiny(), tlc.LongCatDiTConfig.tiny()
    return dict(g=g, sd=sd, jc=jc, tc=tc, jp=jlc.convert_longcat_dit_state_dict(sd, jc),
                tp=tlc.convert_longcat_dit_state_dict(sd, tc, device="cpu"))


_jax_forward = jax.jit(jlc.longcat_dit_forward, static_argnames=("cfg", "num_cond_latents"))


def test_converter_matches_jax_and_from_jax_params(golden):
    """Bit for bit the JAX converter through ``from_jax_params`` (its
    stacked blocks a list); the seeded ``init_longcat_params`` makes the
    same tree."""
    ref = convert.from_jax_params(jax.tree.map(np.asarray, golden["jp"]), device="cpu")
    got, ref = dict(leaves_with_path(golden["tp"])), dict(leaves_with_path(ref))
    assert sorted(got) == sorted(ref)
    for k in ref:
        assert got[k].dtype == ref[k].dtype, k
        np.testing.assert_array_equal(got[k].numpy(), ref[k].numpy(), err_msg=str(k))
    made = dict(leaves_with_path(convert.init_longcat_params(golden["tc"], "cpu",
                                                             torch.float32)))
    assert sorted(made) == sorted(ref)
    assert all(made[k].shape == ref[k].shape for k in ref)


@pytest.mark.parametrize("grid,hd", [((5, 30, 52), 128), ((2, 4, 4), 24)])
def test_rope_tables_are_the_jax_tables_bit_for_bit(grid, hd):
    """At head dim 128 the pairs split 22 / 21 / 21 (dims 44 / 42 / 42)."""
    out = tlc.longcat_rope_tables(grid, hd)
    ref = jlc.longcat_rope_tables(grid, hd)
    for a, b in zip(out, ref):
        np.testing.assert_array_equal(a, b)
        assert a.shape == (int(np.prod(grid)), hd // 2) and a.dtype == np.float32
    if hd == 128:  # the time pairs turn with frame t only: 22 of 64 pairs
        cos = out[0].reshape(grid + (64,))
        assert np.all(cos[:, :1, :1, :22] == cos[:, 1:2, 1:2, :22])
        assert not np.all(cos[:, :1, :1, 22:23] == cos[:, 1:2, :1, 22:23])


@pytest.mark.parametrize("num_cond", [0, 1])
def test_block_matches_jax(golden, num_cond):
    """One block on seeded tokens (2 frames of 16) with per-frame
    modulations; in cond mode the first frame's queries see its keys only,
    its cross-attention rows stay zero (no projection bias)."""
    rng = np.random.default_rng(num_cond)
    x = rng.standard_normal((1, 32, 96)).astype(np.float32)
    ctx = rng.standard_normal((1, 6, 96)).astype(np.float32)
    mods = [0.1 * rng.standard_normal((1, 2, 1, 96)).astype(np.float32) for _ in range(6)]
    cos, sin = tlc.longcat_rope_tables((2, 4, 4), 24)
    jblk = jax.tree.map(lambda a: a[0], golden["jp"]["blocks"])
    ref = jax.jit(jlc.longcat_block, static_argnames=("cfg", "grid", "num_cond"))(
        jblk, jnp.asarray(x), jnp.asarray(ctx), [jnp.asarray(m) for m in mods],
        jnp.asarray(cos), jnp.asarray(sin), cfg=golden["jc"], grid=(2, 4, 4), num_cond=num_cond)
    out = tlc.longcat_block(golden["tp"]["blocks"][0], _t(x), _t(ctx), [_t(m) for m in mods],
                            _t(cos), _t(sin), golden["tc"], (2, 4, 4), num_cond)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL, rtol=0)


@pytest.mark.parametrize("cond", [False, True])
def test_forward_matches_jax_and_golden(golden, cond):
    """T2V, and with the golden's 2 conditioning frames written into the
    latents (their timesteps zeroed); the pipeline's negation applied."""
    g = golden["g"]
    lat = g["latents"].copy()
    n = 0
    if cond:
        n = g["cond"].shape[2]
        lat[:, :, :n] = g["cond"]
    ref = -np.asarray(_jax_forward(golden["jp"], golden["jc"], jnp.asarray(lat),
                                   jnp.asarray(g["timestep"]), jnp.asarray(g["ctx"]),
                                   num_cond_latents=n))
    out = -tlc.longcat_dit_forward(golden["tp"], golden["tc"], _t(lat), _t(g["timestep"]),
                                   _t(g["ctx"]), num_cond_latents=n)
    assert out.dtype == torch.float32 and out.shape == (1, 4, 4, 8, 8)
    np.testing.assert_allclose(out.numpy(), ref, atol=ATOL, rtol=0)
    np.testing.assert_allclose(out.numpy(), g["out_cond" if cond else "out"], atol=2e-4,
                               rtol=1e-3)


# --------------------------------------------------------------- requests
@pytest.fixture(scope="module")
def pipes(goldens, golden):
    """A JAX and a port pipeline with the golden's tiny LongCat DiT (no
    other DiT) and the v1 VAE golden."""
    g = goldens("wan_vae_v1")
    sd = {k[4:]: g[k] for k in g.files if k.startswith("sd::")}
    jv, tv = jvae.WanVAEConfig.tiny_v1(), tvae.WanVAEConfig.tiny_v1()
    jpipe = JPipeline(dit_params=None, dit_cfg=None,
                      vae_params=jvae.convert_vae_v1_state_dict(sd, jv), vae_cfg=jv,
                      longcat_params=golden["jp"], longcat_cfg=golden["jc"], dtype=jnp.float32)
    pipe = WanVideoPipeline(None, None, tvae.convert_vae_v1_state_dict(sd, tv, device="cpu"), tv,
                            dtype=torch.float32, device="cpu", longcat_params=golden["tp"],
                            longcat_cfg=golden["tc"])
    return jpipe, pipe


@pytest.mark.parametrize("continuation", [False, True])
def test_request_matches_jax(pipes, golden, continuation):
    """A 13-frame (4 latent frames) request, 2 steps: T2V without CFG, and
    a continuation from a 5-frame video (2 conditioning latent frames,
    pinned after each step) with CFG 4 in fp32."""
    jpipe, pipe = pipes
    rng = np.random.default_rng(4)
    ctx, neg = (rng.standard_normal((1, 6, 48)).astype(np.float32) for _ in range(2))
    req = dict(cfg_scale=1.0, seed=0, height=64, width=64, num_frames=13,
               num_inference_steps=2, output_type="latents", torch_compat_noise=True)
    tkw, jkw = {}, {}
    if continuation:
        video = [rng.integers(0, 256, (64, 64, 3), dtype=np.uint8) for _ in range(5)]
        req.update(cfg_scale=4.0, longcat_video=video)
        tkw, jkw = dict(negative_context=_t(neg)), dict(negative_context=jnp.asarray(neg))
    ref = np.asarray(jpipe(context=jnp.asarray(ctx), **req, **jkw))
    out = pipe(context=_t(ctx), **req, **tkw).numpy()
    assert out.shape == (1, 4, 4, 8, 8) and np.isfinite(out).all()
    np.testing.assert_allclose(out, ref, atol=REQ_ATOL, rtol=0)
    if continuation:  # the conditioning latents stay pinned
        cond = tvae.vae38_encode(pipe.vae_params, pipe.vae_cfg,
                                 torch.from_numpy(preprocess_video(req["longcat_video"])))
        np.testing.assert_array_equal(out[:, :, :2], cond.numpy())
