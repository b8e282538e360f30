"""The port's streamed and tiled VAE38, its temporal tiler and the
sliding-window pipeline against the JAX package, in fp32 on the CPU.

Weights come from the committed upstream VAE golden (tests/goldens/
wan_vae.npz) through each package's own converter; other inputs are drawn
with numpy from a seed.  Tolerances are stated per test: the two
frameworks sum convolutions in different orders, so fp32 outputs agree to
~1e-6 and are held to 1e-5 (the JAX package's own bound between its
streamed and full-sequence decode, tests/test_wan_vae.py).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fairygen_tpu.models.wan import dit as jdit
from fairygen_tpu.models.wan import vae as jvae
from fairygen_tpu.models.wan import vae_tiling as jtiling
from fairygen_tpu.pipelines.wan_video import WanVideoPipeline as JPipeline
from fairygen_tpu.utils import temporal_tiler as jtemporal
from fairygen_tpu_torch import convert
from fairygen_tpu_torch.models.wan import vae as tvae
from fairygen_tpu_torch.models.wan import vae_tiling as ttiling
from fairygen_tpu_torch.models.wan.dit import WanDiTConfig
from fairygen_tpu_torch.pipelines.wan_video import WanVideoPipeline
from fairygen_tpu_torch.utils import temporal_tiler as ttemporal

JCFG, TCFG = jvae.WanVAEConfig.tiny(), tvae.WanVAEConfig.tiny()
ATOL = 1e-5


@pytest.fixture(scope="module")
def vae(goldens):
    g = goldens("wan_vae")
    sd = {k[4:]: g[k] for k in g.files if k.startswith("sd::")}
    return dict(g=g, jp=jvae.convert_vae38_state_dict(sd, JCFG),
                tp=tvae.convert_vae38_state_dict(sd, TCFG, device="cpu"))


def _t(a):
    return torch.from_numpy(np.array(a))


def test_streamed_encode_matches_jax_and_full_sequence(vae):
    x = vae["g"]["x"]  # (1, 3, 9, 32, 32): a 1-frame chunk and two of 4
    ref = np.asarray(jvae.vae38_encode(vae["jp"], JCFG, jnp.asarray(x), streaming=True))
    z = tvae.vae38_encode(vae["tp"], TCFG, _t(x), streaming=True)
    np.testing.assert_allclose(z.numpy(), ref, atol=ATOL, rtol=0)
    full = tvae.vae38_encode(vae["tp"], TCFG, _t(x))
    np.testing.assert_allclose(z.numpy(), full.numpy(), atol=ATOL, rtol=0)


def test_streamed_encode_keeps_the_jax_handling_of_a_partial_chunk(vae):
    """T - 1 = 6 frames: one chunk of 4, and the 2 frames after it are not
    encoded, in both packages (2 latent frames, not 3)."""
    x = vae["g"]["x"][:, :, :7]
    ref = np.asarray(jvae.vae38_encode(vae["jp"], JCFG, jnp.asarray(x), streaming=True))
    z = tvae.vae38_encode(vae["tp"], TCFG, _t(x), streaming=True)
    assert z.shape == ref.shape == (1, 4, 2, 2, 2)
    np.testing.assert_allclose(z.numpy(), ref, atol=ATOL, rtol=0)


@pytest.mark.parametrize("frames_per_chunk", [1, 2, 3])
def test_streamed_decode_matches_jax(vae, frames_per_chunk):
    z = vae["g"]["z2"]  # 3 latent frames: chunks of 1 + 1 + 1, 1 + 2, 1 + 2
    ref = np.asarray(jvae.vae38_decode(vae["jp"], JCFG, jnp.asarray(z), streaming=True,
                                       clamp=False, frames_per_chunk=frames_per_chunk))
    out = tvae.vae38_decode(vae["tp"], TCFG, _t(z), streaming=True, clamp=False,
                            frames_per_chunk=frames_per_chunk)
    np.testing.assert_allclose(out.numpy(), ref, atol=ATOL, rtol=0)
    full = tvae.vae38_decode(vae["tp"], TCFG, _t(z), clamp=False)
    np.testing.assert_allclose(out.numpy(), full.numpy(), atol=ATOL, rtol=0)


def _rel_l2(a, b, dims=None):
    d, r = (a - b).double(), b.double()
    if dims is None:
        return (d.norm() / r.norm()).item()
    return (d.pow(2).sum(dims).sqrt() / r.pow(2).sum(dims).sqrt()).max().item()


@pytest.mark.parametrize("fault", ["zeroed", "stale"])
def test_a_broken_cache_hand_off_breaks_the_card_bounds(vae, fault, monkeypatch):
    """chip_smoke.py holds the card's bf16 streamed decode to the
    full-sequence one within a relative L2 error of 2^-5 over the clip and
    2^-4 in its worst frame.  A steady chunk handed zeroed cache entries,
    or the first chunk's entries again (a stale cache), misses the
    full-sequence decode by far more than either bound here."""
    z = _t(vae["g"]["z2"])
    full = tvae.vae38_decode(vae["tp"], TCFG, z, clamp=False)
    good = tvae.vae38_decode(vae["tp"], TCFG, z, streaming=True, clamp=False)
    assert _rel_l2(good, full) < 2 ** -16
    chunk_fns, first = tvae._chunk_fns, {}

    def broken(which):
        first_fn, step_fn = chunk_fns(which)

        def first_kept(params, cfg, xc):
            y, first["entries"] = first_fn(params, cfg, xc)
            return y, first["entries"]

        def step(params, cfg, xc, entries):
            if fault == "zeroed":
                entries = [None if e is None else torch.zeros_like(e) for e in entries]
            else:
                entries = first["entries"]
            return step_fn(params, cfg, xc, entries)

        return first_kept, step

    monkeypatch.setattr(tvae, "_chunk_fns", broken)
    bad = tvae.vae38_decode(vae["tp"], TCFG, z, streaming=True, clamp=False)
    assert _rel_l2(bad, full) > 4 * 2 ** -5
    assert _rel_l2(bad, full, (0, 1, 3, 4)) > 4 * 2 ** -4


def test_streamed_path_matches_the_golden(vae):
    """The upstream streamed encode / decode (tests/goldens/wan_vae.npz)
    through the port's streamed path, at the JAX package's golden
    tolerances (tests/test_wan_vae.py)."""
    g = vae["g"]
    z = tvae.vae38_encode(vae["tp"], TCFG, _t(g["x"]), streaming=True)
    np.testing.assert_allclose(z.numpy(), g["z"], atol=2e-4, rtol=1e-3)
    for lat, ref in (("z2", "dec2"), ("z", "dec")):
        dec = tvae.vae38_decode(vae["tp"], TCFG, _t(g[lat]), streaming=True, clamp=False)
        np.testing.assert_allclose(dec.numpy(), g[ref], atol=5e-4, rtol=1e-3)


def test_tiled_decode_matches_jax_over_four_tiles(vae):
    """6 x 6 latents in 4 x 4 tiles at stride 2: four tiles, blended."""
    z = np.random.default_rng(0).standard_normal((1, 4, 3, 6, 6)).astype(np.float32)
    kw = dict(tile_size=(4, 4), tile_stride=(2, 2))
    assert len(ttiling._tile_tasks(6, 6, (4, 4), (2, 2))) == 4
    ref = np.asarray(jtiling.vae38_tiled_decode(vae["jp"], JCFG, jnp.asarray(z), **kw))
    out = ttiling.vae38_tiled_decode(vae["tp"], TCFG, _t(z), **kw)
    assert out.dtype == torch.float32 and out.shape == (1, 3, 9, 96, 96)
    np.testing.assert_allclose(out.numpy(), ref, atol=ATOL, rtol=0)


def test_tiled_encode_matches_jax_over_four_tiles(vae):
    """96 x 96 pixels in 64-pixel tiles (4 latent) at a 32-pixel stride."""
    x = np.random.default_rng(1).uniform(-1, 1, (1, 3, 5, 96, 96)).astype(np.float32)
    kw = dict(tile_size=(4, 4), tile_stride=(2, 2))
    assert len(ttiling._tile_tasks(96, 96, (64, 64), (32, 32))) == 4
    ref = np.asarray(jtiling.vae38_tiled_encode(vae["jp"], JCFG, jnp.asarray(x), **kw))
    out = ttiling.vae38_tiled_encode(vae["tp"], TCFG, _t(x), **kw)
    assert out.shape == (1, 4, 2, 6, 6)
    np.testing.assert_allclose(out.numpy(), ref, atol=ATOL, rtol=0)


def test_one_tile_decode_is_the_streamed_decode(vae):
    """A tile as large as the latents blends with weight 1: bit for bit the
    streamed decode, clamped."""
    z = _t(vae["g"]["z2"])
    out = ttiling.vae38_tiled_decode(vae["tp"], TCFG, z, tile_size=(30, 52),
                                     tile_stride=(15, 26))
    ref = tvae.vae38_decode(vae["tp"], TCFG, z, streaming=True).float()
    assert torch.equal(out, ref)


def test_tiled_decode_refuses_a_mesh(vae):
    with pytest.raises(NotImplementedError, match="Queue 1 item 9"):
        ttiling.vae38_tiled_decode(vae["tp"], TCFG, _t(vae["g"]["z2"]), mesh=object())


@pytest.mark.parametrize("size,stride", [(3, 2), (4, 4), (7, 3)])
def test_temporal_tiler_matches_jax(size, stride):
    """A fixed linear model (a channel mix plus the sliced ``y``) over
    trapezoid-blended windows; fp32, the same sums in both: 1e-6."""
    rng = np.random.default_rng(size * 10 + stride)
    lat = rng.standard_normal((1, 4, 9, 3, 5)).astype(np.float32)
    y = rng.standard_normal((1, 4, 9, 3, 5)).astype(np.float32)
    w = rng.standard_normal((4, 4)).astype(np.float32)

    def jfn(window, y=None):
        return jnp.einsum("bcthw,dc->bdthw", window, w) + 0.5 * y

    def tfn(window, y=None):
        return torch.einsum("bcthw,dc->bdthw", window, torch.from_numpy(w)) + 0.5 * y

    ref = np.asarray(jtemporal.temporal_tiled_model_fn(jfn, jnp.asarray(lat), size, stride,
                                                       sliced_kwargs={"y": jnp.asarray(y)}))
    out = ttemporal.temporal_tiled_model_fn(tfn, _t(lat), size, stride,
                                            sliced_kwargs={"y": _t(y)})
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-6, rtol=0)


DIT = dict(dim=96, in_dim=4, ffn_dim=128, out_dim=4, text_dim=32, freq_dim=32,
           patch_size=(1, 2, 2), num_heads=4, num_layers=2, seperated_timestep=True,
           require_clip_embedding=False, require_vae_embedding=False,
           fuse_vae_embedding_in_latents=True)


def test_sliding_window_pipeline_matches_jax(vae):
    """17 frames (5 latent) in windows of 3 at stride 2, CFG 5, 2 steps,
    the first image pinned; a seeded tiny DiT; the final latents (the
    decode is held above).  fp32: 1e-4 for the sums of two steps' sweeps."""
    jcfg = jdit.WanDiTConfig(**DIT)
    dit = jax.tree.map(np.asarray, jdit.init_dit_params(jax.random.key(3), jcfg))
    rng = np.random.default_rng(4)
    ctx, nctx = (rng.standard_normal((1, 7, 32)).astype(np.float32) for _ in range(2))
    img = rng.integers(0, 256, (32, 32, 3), dtype=np.uint8)
    kw = dict(input_image=img, seed=5, height=32, width=32, num_frames=17, cfg_scale=5.0,
              num_inference_steps=2, torch_compat_noise=True, sliding_window_size=3,
              sliding_window_stride=2, output_type="latents")
    jpipe = JPipeline(dit_params=jax.tree.map(jnp.asarray, dit), dit_cfg=jcfg,
                      vae_params=vae["jp"], vae_cfg=JCFG, dtype=jnp.float32)
    ref = np.asarray(jpipe(context=jnp.asarray(ctx), negative_context=jnp.asarray(nctx), **kw))
    pipe = WanVideoPipeline(convert.from_jax_params(dit, device="cpu"), WanDiTConfig(**DIT),
                            vae["tp"], TCFG, dtype=torch.float32, device="cpu")
    out = pipe(context=_t(ctx), negative_context=_t(nctx), **kw)
    assert out.shape == (1, 4, 5, 2, 2)
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-4, rtol=1e-4)
