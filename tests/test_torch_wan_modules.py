"""The port's Wan modules (fairygen_tpu_torch) against the JAX package on
shared weights, and against the committed upstream goldens.

Inputs and weights are made with numpy from a seed (or taken from the
goldens).  Golden checkpoints load through the port's own converters; trees
shared with the JAX package go through its converters and, for the port,
``convert.from_jax_params``.  Everything runs in fp32 on the CPU.
Tolerances are stated per test; the usual reason for a nonzero one is that
the two frameworks sum in different orders.
"""
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import fairygen_tpu.ops.fused_norms as j_fused_norms
import fairygen_tpu.ops.fused_qk as j_fused_qk
from fairygen_tpu.diffusion.flow_match import FlowMatchScheduler as JScheduler
from fairygen_tpu.models.wan import dit as jdit
from fairygen_tpu.models.wan import text_encoder as jte
from fairygen_tpu.models.wan import vae as jvae
from fairygen_tpu.ops import norms as jnorms
from fairygen_tpu.ops import rope as jrope
from fairygen_tpu_torch import convert
from fairygen_tpu_torch.diffusion.flow_match import FlowMatchScheduler
from fairygen_tpu_torch.models.wan import dit as tdit
from fairygen_tpu_torch.models.wan import text_encoder as tte
from fairygen_tpu_torch.models.wan import vae as tvae
from fairygen_tpu_torch.ops import norms as tnorms
from fairygen_tpu_torch.ops import rope as trope


def _t(a):
    return torch.from_numpy(np.array(a))


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


# ------------------------------------------------------------------ ops
def test_norms_match():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 7, 64)).astype(np.float32)
    w = rng.standard_normal(64).astype(np.float32)
    b = rng.standard_normal(64).astype(np.float32)
    sh, sc = (rng.standard_normal((2, 1, 64)).astype(np.float32) for _ in range(2))
    pairs = [
        (jnorms.rms_norm(jnp.asarray(x), jnp.asarray(w)), tnorms.rms_norm(_t(x), _t(w))),
        (jnorms.t5_layer_norm(jnp.asarray(x), jnp.asarray(w)),
         tnorms.t5_layer_norm(_t(x), _t(w))),
        (jnorms.layer_norm(jnp.asarray(x), 1e-6, jnp.asarray(w), jnp.asarray(b)),
         tnorms.layer_norm(_t(x), 1e-6, _t(w), _t(b))),
        (jnorms.modulate(jnp.asarray(x), jnp.asarray(sh), jnp.asarray(sc)),
         tnorms.modulate(_t(x), _t(sh), _t(sc))),
    ]
    for ref, out in pairs:  # fp32, different reduction order
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5, rtol=1e-5)


def test_rope_tables_and_apply_match():
    for a, b in zip(jrope.precompute_freqs_3d(128), trope.precompute_freqs_3d(128)):
        np.testing.assert_array_equal(a, b)
    jf = jrope.build_freqs_grid(jrope.precompute_freqs_3d(128), 3, 4, 5)
    tf = trope.build_freqs_grid(trope.precompute_freqs_3d(128), 3, 4, 5)
    np.testing.assert_array_equal(np.asarray(jf), tf.numpy())  # same fp32 tables
    x = np.random.default_rng(1).standard_normal((1, 60, 2, 128)).astype(np.float32)
    np.testing.assert_allclose(trope.rope_apply(_t(x), tf).numpy(),
                               np.asarray(jrope.rope_apply(jnp.asarray(x), jf)),
                               atol=1e-6)


@pytest.mark.parametrize("steps,strength,shift", [(4, 1.0, 5.0), (50, 1.0, 5.0),
                                                  (10, 0.7, 3.0)])
def test_flow_match_wan_schedule_matches(steps, strength, shift):
    js = JScheduler("Wan").set_timesteps(steps, denoising_strength=strength, shift=shift)
    ts = FlowMatchScheduler("Wan").set_timesteps(steps, denoising_strength=strength,
                                                 shift=shift)
    np.testing.assert_array_equal(js.sigmas, ts.sigmas)
    np.testing.assert_array_equal(js.timesteps, ts.timesteps)
    rng = np.random.default_rng(2)
    v, x = (rng.standard_normal((1, 4, 3, 2, 2)).astype(np.float32) for _ in range(2))
    for i in (0, steps - 1):
        np.testing.assert_array_equal(ts.step(_t(v), i, _t(x)).numpy(),
                                      np.asarray(js.step(jnp.asarray(v), i, jnp.asarray(x))))


def test_schedule_matches_golden(goldens):
    g = goldens("schedulers")
    ts = FlowMatchScheduler("Wan").set_timesteps(int(g["fm_Wan_sigmas"].shape[0]))
    np.testing.assert_allclose(ts.sigmas, g["fm_Wan_sigmas"], rtol=1e-6)
    np.testing.assert_allclose(ts.timesteps, g["fm_Wan_timesteps"], rtol=1e-6)


# ------------------------------------------------------------------ UMT5
def _umt5_golden(g):
    cfg = jte.UMT5Config.tiny()
    sd = {k[4:]: g[k] for k in g.files if k.startswith("sd::")}
    return jte.convert_umt5_state_dict(sd, cfg)


def test_umt5_matches_golden(goldens):
    g = goldens("umt5")
    params = tte.convert_umt5_state_dict({k[4:]: g[k] for k in g.files if k.startswith("sd::")},
                                         tte.UMT5Config.tiny(), device="cpu")
    emb = tte.umt5_encode(params, tte.UMT5Config.tiny(), _t(g["ids"]), _t(g["mask"]))
    np.testing.assert_allclose(emb.numpy(), g["emb"], atol=2e-5, rtol=1e-4)
    masked = tte.mask_pad_tokens(emb, _t(g["mask"]))
    assert float(masked[0, 17:].abs().sum()) == 0 and float(masked[0, 16].abs().sum()) > 0


def test_umt5_matches_jax_on_random_weights(goldens):
    """Fresh seeded weights in the golden's tree, longer ids with padding."""
    jtree = _np_tree(_umt5_golden(goldens("umt5")))
    rng = np.random.default_rng(3)
    jtree = jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(np.float32) * 0.3, jtree)
    cfg = jte.UMT5Config.tiny()
    ids = rng.integers(0, cfg.vocab, (2, 40))
    mask = (np.arange(40)[None] < np.array([[33], [12]])).astype(np.int64)
    ref = jte.mask_pad_tokens(jte.umt5_encode(jax.tree.map(jnp.asarray, jtree), cfg,
                                              jnp.asarray(ids), jnp.asarray(mask)),
                              jnp.asarray(mask))
    params = convert.from_jax_params(jtree, device="cpu")
    out = tte.mask_pad_tokens(tte.umt5_encode(params, cfg, _t(ids), _t(mask)), _t(mask))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-5, rtol=1e-4)


# ------------------------------------------------------------------ VAE38
VAE_CFG = jvae.WanVAEConfig.tiny()
TVAE_CFG = tvae.WanVAEConfig.tiny()


def _vae_golden_sd(g):
    return {k[4:]: g[k] for k in g.files if k.startswith("sd::")}


def _vae_golden_tree(g):
    return jvae.convert_vae38_state_dict(_vae_golden_sd(g), VAE_CFG)


def _vae_golden_port(g):
    return tvae.convert_vae38_state_dict(_vae_golden_sd(g), TVAE_CFG, device="cpu")


@pytest.mark.parametrize("which", ["encode", "decode", "roundtrip"])
def test_vae38_matches_golden(goldens, which):
    """Upstream streamed encode/decode goldens; the JAX package's own
    tolerances (tests/test_wan_vae.py)."""
    g = goldens("wan_vae")
    params = _vae_golden_port(g)
    if which == "encode":
        out, ref, atol = tvae.vae38_encode(params, TVAE_CFG, _t(g["x"])), g["z"], 2e-4
    elif which == "decode":
        out, ref, atol = tvae.vae38_decode(params, TVAE_CFG, _t(g["z2"]), clamp=False), g["dec2"], 5e-4
    else:
        out, ref, atol = tvae.vae38_decode(params, TVAE_CFG, _t(g["z"]), clamp=False), g["dec"], 5e-4
    assert tuple(out.shape) == ref.shape
    np.testing.assert_allclose(out.numpy(), ref, atol=atol, rtol=1e-3)


def test_vae38_matches_jax_on_random_weights(goldens):
    """Fresh seeded weights (scaled by 1/sqrt(fan_in)) in the golden's tree,
    a 13-frame video; encode and clamp-free decode against the JAX package.
    fp32; 1e-4 absolute for summation order through ~20 conv layers."""
    jtree = _np_tree(_vae_golden_tree(goldens("wan_vae")))
    rng = np.random.default_rng(4)

    def rand(path, a):
        name = jax.tree_util.keystr(path)
        if "latent" in name:
            return a
        if a.ndim >= 4:
            return (rng.standard_normal(a.shape) / np.sqrt(np.prod(a.shape[:-1]))).astype(np.float32)
        return (1.0 + 0.1 * rng.standard_normal(a.shape)).astype(np.float32)

    jtree = jax.tree_util.tree_map_with_path(rand, jtree)
    video = np.clip(rng.standard_normal((1, 3, 13, 32, 48)), -1, 1).astype(np.float32)
    jp = jax.tree.map(jnp.asarray, jtree)
    z_ref = np.asarray(jvae.vae38_encode(jp, VAE_CFG, jnp.asarray(video)))
    d_ref = np.asarray(jvae.vae38_decode(jp, VAE_CFG, jnp.asarray(z_ref), clamp=False))
    params = convert.from_jax_params(jtree, device="cpu")
    z = tvae.vae38_encode(params, TVAE_CFG, _t(video))
    np.testing.assert_allclose(z.numpy(), z_ref, atol=1e-4, rtol=1e-4)
    d = tvae.vae38_decode(params, TVAE_CFG, _t(z_ref), clamp=False)
    np.testing.assert_allclose(d.numpy(), d_ref, atol=1e-4, rtol=1e-4)


def test_subpixel_upsample_matches_repeat_conv():
    """The transposed-conv form == nearest 2x upsample + 3x3 conv (fp32,
    1e-5: the tap sums move into the weights)."""
    rng = np.random.default_rng(5)
    x = _t(rng.standard_normal((2, 6, 5, 7)).astype(np.float32))
    p = {"w": _t(rng.standard_normal((4, 6, 3, 3)).astype(np.float32)),
         "b": _t(rng.standard_normal(4).astype(np.float32))}
    ref = torch.nn.functional.conv2d(x.repeat_interleave(2, 2).repeat_interleave(2, 3),
                                     p["w"], p["b"], padding=1)
    out = tvae._upsample2x_conv3x3_subpixel(x, p)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), atol=1e-5)


def test_vae38_chunked_cache_matches_full_sequence(goldens):
    """CacheBank "init"/"step" chunks ([1, 4, 4] frames on encode, one
    latent frame per step on decode) == the full-sequence program (fp32,
    1e-5)."""
    g = goldens("wan_vae")
    params = _vae_golden_port(g)
    x = tvae.pixel_patchify(_t(g["x"]), TVAE_CFG.patch_size)
    full = tvae.encoder38_forward(params["encoder"], TVAE_CFG, x, tvae.CacheBank("full"))
    bank = tvae.CacheBank("init")
    outs = [tvae.encoder38_forward(params["encoder"], TVAE_CFG, x[:, :, :1], bank)]
    for i in range(1, x.shape[2], 4):
        bank = tvae.CacheBank("step", bank.out)
        outs.append(tvae.encoder38_forward(params["encoder"], TVAE_CFG, x[:, :, i:i + 4], bank))
    np.testing.assert_allclose(torch.cat(outs, 2).numpy(), full.numpy(), atol=1e-5)

    z = _t(g["z"])
    full = tvae.decoder38_forward(params["decoder"], TVAE_CFG, z, tvae.CacheBank("full"))
    bank = tvae.CacheBank("init")
    outs = [tvae.decoder38_forward(params["decoder"], TVAE_CFG, z[:, :, :1], bank, True)]
    for i in range(1, z.shape[2]):
        bank = tvae.CacheBank("step", bank.out)
        outs.append(tvae.decoder38_forward(params["decoder"], TVAE_CFG, z[:, :, i:i + 1],
                                           bank, False))
    np.testing.assert_allclose(torch.cat(outs, 2).numpy(), full.numpy(), atol=1e-5)


# ------------------------------------------------------------------ DiT
def _golden_sd(g, prefix):
    plen = len(prefix) + 2
    return {k[plen:]: g[k] for k in g.files if k.startswith(prefix + "::")}


_GOLDEN_KW = dict(dim=96, ffn_dim=128, out_dim=8, text_dim=32, freq_dim=32,
                  patch_size=(1, 2, 2), num_heads=4, num_layers=2)


@pytest.mark.parametrize("which", ["std", "ti"])
def test_dit_matches_golden(goldens, which):
    """Upstream model_fn_wan_video goldens: the standard I2V path with the
    CLIP image branch and y, and the TI2V separated-timestep path.  head
    dim 24, so the plain chain runs (as in the JAX package).  The JAX
    package's tolerance (tests/test_wan_dit.py)."""
    g = goldens("wan_dit")
    if which == "std":
        kw = dict(in_dim=16, has_image_input=True)
    else:
        kw = dict(in_dim=8, seperated_timestep=True, require_clip_embedding=False,
                  require_vae_embedding=False, fuse_vae_embedding_in_latents=True)
    tcfg = tdit.WanDiTConfig(**_GOLDEN_KW, **kw)
    params = tdit.convert_dit_state_dict(_golden_sd(g, which), tcfg, device="cpu")
    extra = {}
    if which == "std":
        extra = dict(clip_feature=_t(g["std_clip"]), y=_t(g["std_y"]))
    out = tdit.wan_dit_forward(params, tcfg, _t(g[f"{which}_latents"]),
                               _t(g[f"{which}_timestep"]), _t(g[f"{which}_context"]),
                               fuse_vae_embedding_in_latents=which == "ti", **extra)
    np.testing.assert_allclose(out.numpy(), g[f"{which}_out"], atol=2e-4, rtol=1e-3)


TINY128 = dict(dim=256, in_dim=8, ffn_dim=512, out_dim=8, text_dim=32, freq_dim=32,
               patch_size=(1, 2, 2), num_heads=2, num_layers=2, seperated_timestep=True,
               require_clip_embedding=False, require_vae_embedding=False,
               fuse_vae_embedding_in_latents=True)


def _tiny_dit_inputs(f, h, w):
    jcfg = jdit.WanDiTConfig(**TINY128)
    jp = jdit.init_dit_params(jax.random.key(0), jcfg)
    rng = np.random.default_rng(6)
    # nonzero biases and non-unit norms so every parameter matters
    jp = jax.tree_util.tree_map_with_path(
        lambda path, a: (np.asarray(a) + 0.05 * rng.standard_normal(a.shape)).astype(np.float32),
        jp)
    lat = rng.standard_normal((1, 8, f, h, w)).astype(np.float32)
    t = np.array([700.0], np.float32)
    ctx = rng.standard_normal((1, 40, 32)).astype(np.float32)
    return jcfg, jp, lat, t, ctx


@pytest.mark.parametrize("grid", [(3, 8, 10), (5, 32, 32)])
def test_dit_head_dim_128_matches_jax_kernel_and_eager_paths(grid):
    """head dim 128 routes the port through K1-K4 (plain versions on the
    CPU).  Against the JAX forward with its Pallas kernels in interpret mode
    (TPU gates opened) and against its default CPU path (the eager chain).
    grid (3, 8, 10) -> 60 tokens (self-attention one k tile: K4); (5, 32,
    32) -> 1280 tokens (two k tiles: K3).  fp32; 1e-4 for summation order
    over two blocks."""
    jcfg, jp, lat, t, ctx = _tiny_dit_inputs(*grid)
    tcfg = tdit.WanDiTConfig(**TINY128)
    params = convert.from_jax_params(jp, device="cpu")
    out = tdit.wan_dit_forward(params, tcfg, _t(lat), _t(t), _t(ctx),
                               fuse_vae_embedding_in_latents=True).numpy()
    jargs = (jax.tree.map(jnp.asarray, jp), jcfg, jnp.asarray(lat), jnp.asarray(t),
             jnp.asarray(ctx))
    eager = np.asarray(jdit.wan_dit_forward(*jargs, fuse_vae_embedding_in_latents=True))
    with pltpu.force_tpu_interpret_mode(), \
            mock.patch.object(j_fused_qk, "_on_tpu", lambda: True), \
            mock.patch.object(j_fused_norms, "_on_tpu", lambda: True):
        kern = np.asarray(jdit.wan_dit_forward(*jargs, fuse_vae_embedding_in_latents=True))
    np.testing.assert_allclose(out, kern, atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(out, eager, atol=1e-4, rtol=1e-4)


def test_dit_hoisted_cross_kv_is_exact():
    """precompute_cross_kv + cross_kv= gives the same output as the context
    path (same ops, same order)."""
    jcfg, jp, lat, t, ctx = _tiny_dit_inputs(2, 4, 6)
    tcfg = tdit.WanDiTConfig(**TINY128)
    params = convert.from_jax_params(jp, device="cpu")
    a = tdit.wan_dit_forward(params, tcfg, _t(lat), _t(t), _t(ctx),
                             fuse_vae_embedding_in_latents=True)
    kv = tdit.precompute_cross_kv(params, tcfg, _t(ctx))
    b = tdit.wan_dit_forward(params, tcfg, _t(lat), _t(t), cross_kv=kv,
                             fuse_vae_embedding_in_latents=True)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
