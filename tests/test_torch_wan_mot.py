"""The port's VAP / MoT branch against the JAX package, in fp32 on the CPU:
the converter bit for bit the JAX converter + ``from_jax_params``; the
negative-frame RoPE grid bit for bit; one joint layer and the whole VAP
forward (the golden tests/goldens/wan_mot.npz at the JAX suite's 5e-4 /
1e-3, tests/test_wan_mot.py, with its CLIP branches and the head modulated
by the branch's clean-timestep embedding) against the JAX functions on the
same weights; and a tiny VAP request with CFG (the VAP prompt's negative
zeros without a tokenizer) through both pipelines on the same weights and
draws.  Module outputs agree to ~1e-6 and are held to 1e-5; 2-step
requests to 1e-4.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fairygen_tpu.models.wan import dit as jdit
from fairygen_tpu.models.wan import mot as jmot
from fairygen_tpu.models.wan import vae as jvae
from fairygen_tpu.pipelines.wan_video import WanVideoPipeline as JPipeline
from fairygen_tpu_torch import convert
from fairygen_tpu_torch.models.adapters import leaves_with_path
from fairygen_tpu_torch.models.wan import dit as tdit
from fairygen_tpu_torch.models.wan import mot as tmot
from fairygen_tpu_torch.models.wan import vae as tvae
from fairygen_tpu_torch.pipelines.wan_video import WanVideoPipeline

ATOL = 1e-5
REQ_ATOL = 1e-4
# the golden's models (tests/test_wan_mot.py)
DIT = dict(dim=96, in_dim=16, ffn_dim=128, out_dim=8, text_dim=32, freq_dim=32,
           patch_size=(1, 2, 2), num_heads=4, num_layers=4, has_image_input=True)
MOT = dict(mot_layers=(0, 2), has_image_input=True, dim=96, num_heads=4, ffn_dim=128,
           freq_dim=32, text_dim=32, in_dim=8)


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
    g = goldens("wan_mot")
    dsd = {k[5:]: g[k].astype(np.float32) for k in g.files if k.startswith("dit::")}
    msd = {k[5:]: g[k].astype(np.float32) for k in g.files if k.startswith("mot::")}
    jdc, jmc = jdit.WanDiTConfig(**DIT), jmot.MotConfig(**MOT)
    tdc, tmc = tdit.WanDiTConfig(**DIT), tmot.MotConfig(**MOT)
    return dict(g=g, msd=msd, jdc=jdc, jmc=jmc, tdc=tdc, tmc=tmc,
                jd=jdit.convert_dit_state_dict(dsd, jdc), jm=jmot.convert_mot_state_dict(msd, jmc),
                td=tdit.convert_dit_state_dict(dsd, tdc, device="cpu"),
                tm=tmot.convert_mot_state_dict(msd, tmc, device="cpu"))


def test_converter_matches_jax_and_from_jax_params(golden):
    """Bit for bit the JAX converter through ``from_jax_params``; the seeded
    ``init_mot_params`` makes the same tree."""
    ref = convert.from_jax_params(jax.tree.map(np.asarray, golden["jm"]), device="cpu")
    got, ref = dict(leaves_with_path(golden["tm"])), dict(leaves_with_path(ref))
    assert sorted(got) == sorted(ref)
    for k in ref:
        assert got[k].dtype == ref[k].dtype, k
        np.testing.assert_array_equal(got[k].numpy(), ref[k].numpy(), err_msg=str(k))
    made = dict(leaves_with_path(convert.init_mot_params(golden["tmc"], "cpu", torch.float32)))
    assert sorted(made) == sorted(ref)
    assert all(made[k].shape == ref[k].shape for k in ref)


@pytest.mark.parametrize("hd,f,h,w", [(128, 5, 30, 52), (24, 3, 4, 6)])
def test_negative_frame_rope_grid_is_the_jax_grid_bit_for_bit(hd, f, h, w):
    """Frames −f..−1, angles in fp64, the tables fp32: the VAP shape at 14B
    width and the golden's."""
    out = tmot.build_freqs_grid_mot(hd, f, h, w).numpy()
    np.testing.assert_array_equal(out, np.asarray(jmot.build_freqs_grid_mot(hd, f, h, w)))
    assert out.shape == (2, f * h * w, hd // 2)


def test_joint_block_matches_jax(golden):
    """One mapped layer: the main block 0 and branch block 0 on seeded
    tokens, the joint self-attention over both, each side's CLIP + text
    cross-attention and FFN."""
    rng = np.random.default_rng(1)
    x, xm = rng.standard_normal((1, 24, 96)), rng.standard_normal((1, 18, 96))
    ctx, ctx_m = rng.standard_normal((1, 257 + 5, 96)), rng.standard_normal((1, 257 + 3, 96))
    t_mod, t_mod_m = 0.1 * rng.standard_normal((2, 1, 1, 6, 96))
    freqs = tmot.build_freqs_grid_mot(24, 2, 3, 4)  # any (2, S, hd/2) table
    freqs_m = tmot.build_freqs_grid_mot(24, 3, 2, 3)
    args = [a.astype(np.float32) for a in (x, ctx, t_mod, xm, ctx_m, t_mod_m)]
    jblk = jax.tree.map(lambda a: a[0], golden["jd"]["blocks"])
    ref = jax.jit(jmot.mot_joint_block, static_argnames=("cfg",))(
        jblk, golden["jm"]["blocks"][0], *map(jnp.asarray, args[:3]), jnp.asarray(freqs.numpy()),
        *map(jnp.asarray, args[3:]), jnp.asarray(freqs_m.numpy()), cfg=golden["jmc"])
    out = tmot.mot_joint_block(golden["td"]["blocks"][0], golden["tm"]["blocks"][0],
                               *map(_t, args[:3]), freqs, *map(_t, args[3:]), freqs_m,
                               golden["tmc"])
    for o, r in zip(out, ref):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), atol=ATOL, rtol=0)


def test_vap_forward_matches_jax_and_golden(golden):
    """The golden's VAP forward: 4 main blocks, the branch joint at 0 and 2,
    CLIP features on both sides."""
    g = golden["g"]
    names = ("lat", "ts", "ctx")
    kw = {k: g[n] for k, n in (("clip_feature", "clip"), ("y", "y"),
                                ("vap_hidden_state", "vap_hidden"), ("context_vap", "ctx_vap"),
                                ("vap_clip_feature", "vap_clip"))}
    ref = np.asarray(jax.jit(jmot.wan_dit_forward_vap, static_argnames=("dit_cfg", "cfg"))(
        golden["jd"], golden["jdc"], golden["jm"], golden["jmc"], *(jnp.asarray(g[n])
                                                                    for n in names),
        **{k: jnp.asarray(v) for k, v in kw.items()}))
    out = tmot.wan_dit_forward_vap(golden["td"], golden["tdc"], golden["tm"], golden["tmc"],
                                   *(_t(g[n]) for n in names),
                                   **{k: _t(v) for k, v in kw.items()}).numpy()
    assert out.shape == g["o"].shape == (1, 8, 3, 8, 12)
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=0)
    np.testing.assert_allclose(out, g["o"], atol=5e-4, rtol=1e-3)


# --------------------------------------------------------------- request
R_DIT = dict(dim=96, in_dim=12, ffn_dim=128, out_dim=4, text_dim=32, freq_dim=32,
             patch_size=(1, 2, 2), num_heads=4, num_layers=2, require_clip_embedding=False)
R_MOT = dict(mot_layers=(0,), has_image_input=False, dim=96, num_heads=4, ffn_dim=128,
             freq_dim=32, text_dim=32, in_dim=12)
H = W = 32
FRAMES = 9


@pytest.fixture(scope="module")
def pipes(goldens):
    """The JAX suite's VAP request models (tests/test_wan_pipeline.py): a
    2-block DiT taking the I2V ``y`` and a one-layer branch, from seeded
    JAX inits, with the v1 VAE golden, in both packages."""
    g = goldens("wan_vae_v1")
    sd = {k[4:]: g[k] for k in g.files if k.startswith("sd::")}
    jv, tv = jvae.WanVAEConfig.tiny_v1(), tvae.WanVAEConfig.tiny_v1()
    jdc, jmc = jdit.WanDiTConfig(**R_DIT), jmot.MotConfig(**R_MOT)
    jd = jax.tree.map(np.asarray, jdit.init_dit_params(jax.random.key(0), jdc))
    jm = jax.tree.map(np.asarray, jdit.init_dit_params(jax.random.key(1), jmc.dit_cfg()))
    jm["patch_embedding"] = jm.pop("patch_embed")
    del jm["head"]
    jm["blocks"] = [jax.tree.map(lambda a: a[i], jm["blocks"]) for i in range(1)]
    jpipe = JPipeline(dit_params=jax.tree.map(jnp.asarray, jd), dit_cfg=jdc,
                      vae_params=jvae.convert_vae_v1_state_dict(sd, jv), vae_cfg=jv,
                      vap_params=jax.tree.map(jnp.asarray, jm), vap_cfg=jmc, dtype=jnp.float32)
    pipe = WanVideoPipeline(convert.from_jax_params(jd, device="cpu"), tdit.WanDiTConfig(**R_DIT),
                            tvae.convert_vae_v1_state_dict(sd, tv, device="cpu"), tv,
                            dtype=torch.float32, device="cpu",
                            vap_params=convert.from_jax_params(jm, device="cpu"),
                            vap_cfg=tmot.MotConfig(**R_MOT))
    return jpipe, pipe


def _frames(seed, n):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (H, W, 3), dtype=np.uint8) for _ in range(n)]


def test_vap_request_matches_jax(pipes):
    """The VAP video's latents beside its first frame's I2V ``y`` through
    the branch, the input image's ``y`` on the main side, CFG 4 in two
    sweeps with a zero negative VAP context (no tokenizer)."""
    jpipe, pipe = pipes
    rng = np.random.default_rng(9)
    ctx, neg, ctx_vap = (rng.standard_normal((1, 6, 32)).astype(np.float32) for _ in range(3))
    req = dict(input_image=_frames(1, 1)[0], cfg_scale=4.0, seed=8, height=H, width=W,
               num_frames=FRAMES, num_inference_steps=2, output_type="latents",
               torch_compat_noise=True)
    vid = _frames(2, FRAMES)
    ref = np.asarray(jpipe(context=jnp.asarray(ctx), negative_context=jnp.asarray(neg),
                           context_vap=jnp.asarray(ctx_vap), vap_video=vid, **req))
    out = pipe(context=_t(ctx), negative_context=_t(neg), context_vap=_t(ctx_vap), vap_video=vid,
               **req).numpy()
    assert out.shape == (1, 4, 3, 4, 4)
    np.testing.assert_allclose(out, ref, atol=REQ_ATOL, rtol=0)
    other = pipe(context=_t(ctx), negative_context=_t(neg), context_vap=_t(ctx_vap),
                 vap_video=_frames(3, FRAMES), **req).numpy()
    assert not np.allclose(out, other, atol=1e-6)  # the VAP video conditions


def test_vap_without_its_branch_names_vap_params(pipes):
    _, pipe = pipes
    bare = WanVideoPipeline(pipe.dit_params, pipe.dit_cfg, pipe.vae_params, pipe.vae_cfg,
                            dtype=torch.float32, device="cpu")
    with pytest.raises(ValueError, match="vap_params"):
        bare(context=torch.zeros(1, 6, 32), cfg_scale=1.0, height=H, width=W, num_frames=FRAMES,
             vap_video=_frames(4, FRAMES), context_vap=torch.zeros(1, 6, 32))
