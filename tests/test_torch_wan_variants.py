"""The port's Wan variants of the first slice against the JAX package, in
fp32 on the CPU: the Wan2.1 VAE (full-sequence, streamed, tiled; its
golden), the CLIP ViT-H image encoder and its resize (its golden), the I2V
DiT's image branch with the FLF2V position embedding, the I2V mask layout,
two-expert requests (CFG as two sweeps and merged, a boundary equal to a
timestep, TeaCache across the switch, the sliding window),
video-to-video, the CLIP-conditioned I2V request, the builders through
``from_pretrained`` and the CLI twin's ``--end_image``.

Weights: the committed upstream goldens (tests/goldens/wan_vae_v1.npz,
wan_clip.npz) through each package's converter, and the JAX package's
``init_dit_params`` from a seed written as upstream-layout safetensors;
other inputs are drawn with numpy from a seed.  Both frameworks sum
convolutions and products in different orders, so fp32 module outputs
agree to ~1e-6 and are held to 1e-5 (the JAX package's own bound between
its streamed and full-sequence VAE, tests/test_wan_vae_v1.py), 4-step
requests to 1e-4 as the port's other pipeline tests.
"""
import importlib.util
import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fairygen_tpu.diffusion.flow_match import FlowMatchScheduler as JScheduler
from fairygen_tpu.models.wan import dit as jdit
from fairygen_tpu.models.wan import image_encoder as jclip
from fairygen_tpu.models.wan import vae as jvae
from fairygen_tpu.models.wan import vae_tiling as jtiling
from fairygen_tpu.pipelines.wan_video import WanVideoPipeline as JPipeline
from fairygen_tpu_torch import convert
from fairygen_tpu_torch.core import io as tio
from fairygen_tpu_torch.core.model_pool import ModelPool
from fairygen_tpu_torch.examples import wan_inference
from fairygen_tpu_torch.models.wan import dit as tdit
from fairygen_tpu_torch.models.wan import image_encoder as tclip
from fairygen_tpu_torch.models.wan import vae as tvae
from fairygen_tpu_torch.models.wan import vae_tiling as ttiling
from fairygen_tpu_torch.pipelines.wan_video import WanVideoPipeline
from fairygen_tpu_torch.training import tea_cache_experiment as texp
from fairygen_tpu_torch.utils import tea_cache as ttc
from fairygen_tpu_torch.utils import video as tvideo
from test_torch_tea_cache import LINEAR, _margin, _middle_threshold, registered  # noqa: F401
from test_torch_wan_entry import TE_EXTRA, _write_tokenizer

ATOL = 1e-5
JVCFG, TVCFG = jvae.WanVAEConfig.tiny_v1(), tvae.WanVAEConfig.tiny_v1()
# the Wan2.2-A14B experts' form at a tiny width: 4 noise + 4 mask + 4 y channels in
A14B = dict(dim=96, in_dim=12, ffn_dim=128, out_dim=4, text_dim=32, freq_dim=32,
            patch_size=(1, 2, 2), num_heads=4, num_layers=2, has_image_input=False,
            require_clip_embedding=False)
# the Wan2.1-I2V-14B form: the same channels and the CLIP branch
I2V_CLIP = dict(A14B, has_image_input=True, require_clip_embedding=True)
# a 1280-wide, one-block ViT at 224 pixels: 257 tokens, as the DiT's img_emb takes them
VIT = dict(image_size=224, patch_size=14, dim=1280, num_heads=16, num_layers=2)
H = W = 32
FRAMES = 9


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _rel_l2(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.fixture(scope="module")
def v1(goldens):
    g = goldens("wan_vae_v1")
    sd = {k[4:]: g[k] for k in g.files if k.startswith("sd::")}
    return dict(g=g, sd=sd, jp=jvae.convert_vae_v1_state_dict(sd, JVCFG),
                tp=tvae.convert_vae_v1_state_dict(sd, TVCFG, device="cpu"))


# ----------------------------------------------------------- the Wan2.1 VAE
@pytest.mark.parametrize("streaming", [False, True])
def test_v1_vae_matches_jax_and_golden(v1, streaming):
    """Encode (a 1-frame chunk and two of 4 when streamed) and decode
    against the JAX package's same mode, the golden, and the port's
    full-sequence form (streamed: the same math, convolutions over other
    frame counts summed in another order)."""
    g = v1["g"]
    z = tvae.vae38_encode(v1["tp"], TVCFG, _t(g["x"]), streaming=streaming).numpy()
    ref = np.asarray(jvae.vae38_encode(v1["jp"], JVCFG, jnp.asarray(g["x"]), streaming=streaming))
    assert z.shape == ref.shape == g["z"].shape == (1, 4, 3, 4, 4)
    np.testing.assert_allclose(z, ref, atol=ATOL, rtol=0)
    np.testing.assert_allclose(z, g["z"], atol=2e-4, rtol=1e-3)  # the JAX golden test's bound
    d = tvae.vae38_decode(v1["tp"], TVCFG, _t(g["z"]), streaming=streaming, clamp=False).numpy()
    ref = np.asarray(jvae.vae38_decode(v1["jp"], JVCFG, jnp.asarray(g["z"]),
                                       streaming=streaming, clamp=False))
    assert d.shape == g["dec"].shape == (1, 3, 9, 32, 32)
    np.testing.assert_allclose(d, ref, atol=ATOL, rtol=0)
    np.testing.assert_allclose(d, g["dec"], atol=5e-4, rtol=1e-3)
    if streaming:
        full = tvae.vae38_decode(v1["tp"], TVCFG, _t(g["z"]), clamp=False).numpy()
        np.testing.assert_allclose(d, full, atol=ATOL, rtol=0)
        full = tvae.vae38_encode(v1["tp"], TVCFG, _t(g["x"])).numpy()
        np.testing.assert_allclose(z, full, atol=ATOL, rtol=0)


def test_v1_tiled_decode_and_encode_match_jax(v1):
    """Four 4 x 4 latent tiles at stride 2, decoded (streamed) and encoded
    (32 x 32 pixels at the v1 VAE's factor 8), blended as in the JAX
    package."""
    kw = dict(tile_size=(4, 4), tile_stride=(2, 2))
    z = np.random.default_rng(0).standard_normal((1, 4, 2, 6, 6)).astype(np.float32)
    ref = np.asarray(jtiling.vae38_tiled_decode(v1["jp"], JVCFG, jnp.asarray(z), **kw))
    out = ttiling.vae38_tiled_decode(v1["tp"], TVCFG, _t(z), **kw)
    assert out.shape == (1, 3, 5, 48, 48)
    np.testing.assert_allclose(out.numpy(), ref, atol=ATOL, rtol=0)
    x = np.random.default_rng(1).uniform(-1, 1, (1, 3, 5, 48, 48)).astype(np.float32)
    ref = np.asarray(jtiling.vae38_tiled_encode(v1["jp"], JVCFG, jnp.asarray(x), **kw))
    out = ttiling.vae38_tiled_encode(v1["tp"], TVCFG, _t(x), **kw)
    assert out.shape == (1, 4, 2, 6, 6)
    np.testing.assert_allclose(out.numpy(), ref, atol=ATOL, rtol=0)


def test_v1_vae_init_has_the_converter_tree(v1):
    """``convert.init_vae_params`` of a v1 config makes the converter's
    tree: the same paths and shapes (the decoder's halved channels), the
    Wan2.1 latent statistics."""
    from fairygen_tpu_torch.models.adapters import leaves_with_path

    made = dict(leaves_with_path(convert.init_vae_params(TVCFG, "cpu", torch.float32)))
    ref = dict(leaves_with_path(v1["tp"]))
    assert sorted(made) == sorted(ref)
    assert all(made[k].shape == ref[k].shape for k in ref)
    np.testing.assert_array_equal(made[("latent_std",)].numpy(), tvae.VAE16_STD[:4])


def test_from_jax_params_carries_the_new_trees(v1, goldens):
    """The JAX package's v1 VAE and ViT trees through ``from_jax_params``
    equal the port's own converters' trees, leaf for leaf (the image
    branch and its ``pos``: test_image_dit_matches_jax)."""
    from fairygen_tpu_torch.models.adapters import leaves_with_path

    g = goldens("wan_clip")
    sd = {k[4:]: g[k] for k in g.files if k.startswith("sd::")}
    for jtree, ttree in ((v1["jp"], v1["tp"]),
                         (jclip.convert_vit_state_dict(sd, jclip.ViTConfig.tiny()),
                          tclip.convert_vit_state_dict(sd, tclip.ViTConfig.tiny(), device="cpu"))):
        carried = dict(leaves_with_path(convert.from_jax_params(_np(jtree), device="cpu")))
        own = dict(leaves_with_path(ttree))
        assert sorted(carried) == sorted(own)
        assert all(torch.equal(carried[k], own[k]) for k in own)


# --------------------------------------------------------------- CLIP ViT-H
@pytest.mark.parametrize("hw,size", [((480, 832), 224), ((32, 32), 28)])
def test_bicubic_resize_matches_jax_image_resize(hw, size):
    """Keys cubic with antialiasing when shrinking: the flagship frame to
    CLIP's 224 and a small shrink; separable products in another order
    than XLA's one einsum: 1e-5."""
    x = np.random.default_rng(2).uniform(-1, 1, (2, 3) + hw).astype(np.float32)
    ref = np.asarray(jclip._bicubic_resize(jnp.asarray(x), size))
    out = tclip.bicubic_resize(_t(x), size).numpy()
    assert out.shape == (2, 3, size, size)
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=0)
    # F.interpolate's bicubic (a = -0.75, no antialias) is not this resize
    other = torch.nn.functional.interpolate(_t(x), size=(size, size), mode="bicubic",
                                            align_corners=False).numpy()
    assert np.abs(other - ref).max() > 1e-2


def test_vit_and_encode_image_match_jax_and_golden(goldens):
    g = goldens("wan_clip")
    sd = {k[4:]: g[k] for k in g.files if k.startswith("sd::")}
    jcfg, tcfg = jclip.ViTConfig.tiny(), tclip.ViTConfig.tiny()
    jp, tp = jclip.convert_vit_state_dict(sd, jcfg), tclip.convert_vit_state_dict(sd, tcfg,
                                                                                  device="cpu")
    out = tclip.vit_forward(tp, tcfg, _t(g["x"])).numpy()
    np.testing.assert_allclose(out, g["o"], atol=2e-5, rtol=1e-4)  # the JAX golden test's
    np.testing.assert_allclose(out, np.asarray(jclip.vit_forward(jp, jcfg, jnp.asarray(g["x"]))),
                               atol=ATOL, rtol=0)
    x = np.random.default_rng(3).uniform(-1, 1, (1, 3, 40, 36)).astype(np.float32)
    ref = np.asarray(jclip.encode_image(jp, jcfg, jnp.asarray(x)))
    out = tclip.encode_image(tp, tcfg, _t(x)).numpy()
    assert out.shape == ref.shape == (1, 5, 32)
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=0)


# ------------------------------------------------------------ the I2V DiT
def _jax_dit(cfg_kw, seed):
    cfg = jdit.WanDiTConfig(**cfg_kw)
    return cfg, _np(jdit.init_dit_params(jax.random.key(seed), cfg))


@pytest.mark.parametrize("pos_emb,clip_tokens", [(True, 514), (False, 257)])
def test_image_dit_matches_jax(pos_emb, clip_tokens):
    """The I2V DiT (in_dim 36: 16 noise + 20 y channels) with its CLIP
    branch: the FLF2V form (``has_image_pos_emb``, 514 CLIP tokens: the
    first 257 are the image branch's, the rest lead the text, as the JAX
    package splits the context) and the 257-token form, whose text (k, v)
    the pipeline hoists (the same output)."""
    kw = dict(A14B, in_dim=36, out_dim=16, has_image_input=True, require_clip_embedding=True,
              has_image_pos_emb=pos_emb)
    jcfg, jp = _jax_dit(kw, 0)
    rng = np.random.default_rng(4)
    if pos_emb:
        jp["img_emb"]["pos"] = (0.1 * rng.standard_normal((1, 514, 1280))).astype(np.float32)
    lat = rng.standard_normal((1, 16, 2, 4, 4)).astype(np.float32)
    y = rng.standard_normal((1, 20, 2, 4, 4)).astype(np.float32)
    ctx = rng.standard_normal((1, 7, 32)).astype(np.float32)
    clip = rng.standard_normal((1, clip_tokens, 1280)).astype(np.float32)
    t = np.asarray([700.0], np.float32)
    ref = np.asarray(jdit.wan_dit_forward(jax.tree.map(jnp.asarray, jp), jcfg, jnp.asarray(lat),
                                          jnp.asarray(t), jnp.asarray(ctx), y=jnp.asarray(y),
                                          clip_feature=jnp.asarray(clip)))
    tcfg = tdit.WanDiTConfig(**kw)
    tp = convert.from_jax_params(jp, device="cpu")
    out = tdit.wan_dit_forward(tp, tcfg, _t(lat), _t(t), _t(ctx), y=_t(y), clip_feature=_t(clip))
    assert out.shape == ref.shape == (1, 16, 2, 4, 4)
    np.testing.assert_allclose(out.numpy(), ref, atol=ATOL, rtol=1e-5)
    if not pos_emb:
        hoisted = tdit.wan_dit_forward(tp, tcfg, _t(lat), _t(t), None, y=_t(y),
                                       clip_feature=_t(clip),
                                       cross_kv=tdit.precompute_cross_kv(tp, tcfg, _t(ctx)))
        np.testing.assert_allclose(hoisted.numpy(), out.numpy(), atol=1e-6, rtol=0)
    else:
        with pytest.raises(ValueError, match="257 CLIP"):
            tdit.wan_dit_forward(tp, tcfg, _t(lat), _t(t), None, y=_t(y), clip_feature=_t(clip),
                                 cross_kv=tdit.precompute_cross_kv(tp, tcfg, _t(ctx)))


def test_init_dit_params_seeds_the_image_branch():
    """``convert.init_dit_params`` with ``has_image_input`` (and the
    position embedding) makes the JAX package's tree: the same paths and
    shapes."""
    from fairygen_tpu_torch.models.adapters import leaves_with_path

    kw = dict(I2V_CLIP, has_image_pos_emb=True)
    _, jp = _jax_dit(kw, 0)
    ref = dict(leaves_with_path(convert.from_jax_params(jp, device="cpu")))
    made = dict(leaves_with_path(convert.init_dit_params(tdit.WanDiTConfig(**kw), "cpu",
                                                         torch.float32)))
    assert sorted(made) == sorted(ref)
    assert all(made[k].shape == ref[k].shape for k in ref)
    assert float(made[("img_emb", "pos")].abs().max()) == 0.0


# -------------------------------------------------- checkpoints and pipes
def _upstream_dit_sd(jp, cfg):
    """An upstream-layout (civitai) state dict of a JAX DiT tree (stacked
    blocks), what ``from_pretrained`` reads."""
    D = cfg.dim
    sd = {"patch_embedding.weight": jp["patch_embed"]["w"].reshape(
              cfg.in_dim, *cfg.patch_size, D).transpose(4, 0, 1, 2, 3),
          "patch_embedding.bias": jp["patch_embed"]["b"],
          "head.modulation": jp["head"]["modulation"].reshape(1, 2, D)}

    def dense(name, p):
        sd[name + ".weight"] = np.ascontiguousarray(p["w"].T)
        sd[name + ".bias"] = p["b"]

    for name, p in (("text_embedding.0", jp["text_embed"]["fc1"]),
                    ("text_embedding.2", jp["text_embed"]["fc2"]),
                    ("time_embedding.0", jp["time_embed"]["fc1"]),
                    ("time_embedding.2", jp["time_embed"]["fc2"]),
                    ("time_projection.1", jp["time_proj"]), ("head.head", jp["head"])):
        dense(name, p)
    for i in range(cfg.num_layers):
        blk = jax.tree.map(lambda a: a[i], jp["blocks"])
        pre = f"blocks.{i}"
        for sub in ("self_attn", "cross_attn"):
            for k in ("q", "k", "v", "o") + (("k_img", "v_img") if sub == "cross_attn"
                                             and cfg.has_image_input else ()):
                dense(f"{pre}.{sub}.{k}", blk[sub][k])
            for k in ("norm_q", "norm_k") + (("norm_k_img",) if sub == "cross_attn"
                                             and cfg.has_image_input else ()):
                sd[f"{pre}.{sub}.{k}.weight"] = blk[sub][k]
        sd[f"{pre}.norm3.weight"], sd[f"{pre}.norm3.bias"] = blk["norm3"]["w"], blk["norm3"]["b"]
        dense(f"{pre}.ffn.0", blk["ffn"]["fc1"])
        dense(f"{pre}.ffn.2", blk["ffn"]["fc2"])
        sd[f"{pre}.modulation"] = blk["modulation"].reshape(1, 6, D)
    if cfg.has_image_input:
        e = jp["img_emb"]
        sd["img_emb.proj.0.weight"], sd["img_emb.proj.0.bias"] = e["norm1"]["w"], e["norm1"]["b"]
        dense("img_emb.proj.1", e["fc1"])
        dense("img_emb.proj.3", e["fc2"])
        sd["img_emb.proj.4.weight"], sd["img_emb.proj.4.bias"] = e["norm2"]["w"], e["norm2"]["b"]
    return {k: np.ascontiguousarray(v, np.float32) for k, v in sd.items()}


def _dit_hint(cfg_kw):
    return dict(cfg_kw, patch_size=list(cfg_kw["patch_size"]))


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory, goldens):
    """Two A14B-form experts (seeds 0 and 1), a CLIP-conditioned I2V DiT
    (seed 2), the v1 VAE golden, UMT5 and a tokenizer, as safetensors with
    hints; seeded images and a 9-frame clip."""
    tmp = tmp_path_factory.mktemp("wan_variants")
    gv, gu = goldens("wan_vae_v1"), goldens("umt5")
    paths, hints = {}, {}
    for name, kw, seed in (("dit_hi", A14B, 0), ("dit_lo", A14B, 1), ("dit_clip", I2V_CLIP, 2)):
        cfg, jp = _jax_dit(kw, seed)
        paths[name] = str(tmp / f"{name}.safetensors")
        tio.save_safetensors(paths[name], _upstream_dit_sd(jp, cfg))
        hints[paths[name]] = ("wan_video_dit", _dit_hint(kw))
    for name, sd, role, extra in (
            ("vae", {k[4:]: gv[k] for k in gv.files if k.startswith("sd::")}, "wan_video_vae",
             dict(dim=8, z_dim=4, dec_dim=8, num_res_blocks=1, patch_size=1, arch="v1")),
            ("umt5", {k[4:]: gu[k] for k in gu.files if k.startswith("sd::")},
             "wan_video_text_encoder", TE_EXTRA)):
        paths[name] = str(tmp / f"{name}.safetensors")
        tio.save_safetensors(paths[name], sd)
        hints[paths[name]] = (role, extra)
    (tmp / "hints.json").write_text(json.dumps(hints))
    rng = np.random.default_rng(5)
    return dict(paths=paths, hints=hints, hints_file=str(tmp / "hints.json"), tmp=tmp,
                tokenizer=_write_tokenizer(tmp / "tokenizer"),
                img=rng.integers(0, 256, (H, W, 3), dtype=np.uint8),
                end=rng.integers(0, 256, (H, W, 3), dtype=np.uint8),
                video=[rng.integers(0, 256, (H, W, 3), dtype=np.uint8) for _ in range(FRAMES)],
                ctx=rng.standard_normal((1, 6, 32)).astype(np.float32),
                neg=rng.standard_normal((1, 6, 32)).astype(np.float32))


def _paths(ckpts, *names):
    return [ckpts["paths"][n] for n in names]


@pytest.fixture(scope="module")
def pair(ckpts):
    """The two-expert pipelines of both packages, by from_pretrained."""
    files = _paths(ckpts, "dit_hi", "dit_lo", "vae")
    jpipe = JPipeline.from_pretrained(files, dtype=jnp.float32, hints=ckpts["hints"])
    pipe = WanVideoPipeline.from_pretrained(files, dtype=torch.float32, hints=ckpts["hints"],
                                            device="cpu")
    return jpipe, pipe


def _request(ckpts, jax_side, **over):
    kw = dict(context=ckpts["ctx"], negative_context=ckpts["neg"], input_image=ckpts["img"],
              end_image=ckpts["end"], seed=3, height=H, width=W, num_frames=FRAMES,
              cfg_scale=5.0, num_inference_steps=4, sigma_shift=5.0, output_type="latents",
              torch_compat_noise=True, switch_dit_boundary=0.9)
    kw.update(over)
    conv = jnp.asarray if jax_side else _t
    for k in ("context", "negative_context"):
        kw[k] = conv(kw[k])
    return kw


def _count_sweeps(request, pipe):
    """Sweeps per expert (0: ``dit``, 1: ``dit2``) of the port's pipeline,
    by chip_smoke.py's ``count_expert_sweeps``, undone at the test's end."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_sweeps", pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    counts, undo = smoke.count_expert_sweeps(pipe)
    request.addfinalizer(undo)
    return counts


# ----------------------------------------------------------- the requests
def test_i2v_mask_layout_matches_jax(pair, ckpts):
    """encode_i2v_conditioning: 4 mask channels (frame 0's mask repeated
    4-fold, regrouped into latent frames; the last frame's with
    ``end_image``) before the VAE encode of [first, zeros, (end)]."""
    jpipe, pipe = pair
    for end in (None, ckpts["end"]):
        ref = np.asarray(jpipe.encode_i2v_conditioning(ckpts["img"], H, W, FRAMES, end_image=end))
        y = pipe.encode_i2v_conditioning(ckpts["img"], H, W, FRAMES, end_image=end).numpy()
        assert y.shape == ref.shape == (1, 8, 3, H // 8, W // 8)
        m = y[0, :4]
        np.testing.assert_array_equal(m, ref[0, :4])
        assert (m[:, 0] == 1).all() and (m[:, 1] == 0).all()
        # latent frame 2 holds pixel frames 5-8: only the last is the end frame
        assert (m[:3, 2] == 0).all() and (m[3, 2] == (0 if end is None else 1)).all()
        np.testing.assert_allclose(y[0, 4:], ref[0, 4:], atol=ATOL, rtol=0)
    streamed = pipe.encode_i2v_conditioning(ckpts["img"], H, W, FRAMES, end_image=end,
                                            streaming=True).numpy()
    np.testing.assert_allclose(streamed, y, atol=ATOL, rtol=0)


@pytest.mark.parametrize("case", ["cfg", "cfg_merge-boundary-at-a-timestep", "window"])
def test_two_expert_request_matches_jax(pair, ckpts, request, case):
    """Wan2.2-A14B's form: 4 steps at shift 5 (timesteps 1000, 937.5,
    833.3, 625), CFG 5, first and end image.  Boundary 0.9 and 0.9375
    (equal to step 1's timestep, which stays with ``dit``) both give 2
    steps to each expert: 4 sweeps each; the sliding window (2 latent
    frames, stride 1) switches per step too.  Against the JAX pipeline:
    1e-4."""
    jpipe, pipe = pair
    over = {"cfg": {}, "cfg_merge-boundary-at-a-timestep": dict(cfg_merge=True,
                                                                switch_dit_boundary=0.9375),
            "window": dict(sliding_window_size=2, sliding_window_stride=1)}[case]
    counts = _count_sweeps(request, pipe)
    out = pipe(**_request(ckpts, False, **over)).numpy()
    per_window = 2 if case == "window" else 1
    assert counts == [4 // (2 if over.get("cfg_merge") else 1) * per_window] * 2
    ref = np.asarray(jpipe(**_request(ckpts, True, **over)))
    assert out.shape == ref.shape == (1, 4, 3, 4, 4)
    np.testing.assert_allclose(out, ref, atol=1e-4, rtol=1e-4)
    sched = JScheduler("Wan").set_timesteps(4, shift=5.0)
    assert [pipe._boundary_index(sched, b) for b in (0.9, 0.9375, 0.94, 1.0, 0.5)] == \
        [2, 2, 1, 1, 4]


def test_tea_cache_carries_across_the_switch(pair, ckpts, registered, monkeypatch):  # noqa: F811
    """TeaCache over 8 steps with the switch after step 3 (boundary 0.9):
    the gate's drift at step 4 compares dit2's t_mod with dit's, the
    state is not reset.  The port computes the steps the replay of that
    drift predicts, with the accumulators at least 4% from the threshold,
    and the latents agree with the JAX pipeline's within 1e-4."""
    jpipe, pipe = pair
    steps = 8
    sched = JScheduler("Wan").set_timesteps(steps, shift=5.0)
    boundary = pipe._boundary_index(sched, 0.9)
    assert 0 < boundary < steps
    tmods = [tdit.time_embedding(pipe.dit_params if i < boundary else pipe.dit2_params,
                                 pipe.dit_cfg, torch.tensor([float(np.float32(t))]))[1].numpy()
             for i, t in enumerate(sched.timesteps)]
    xs = [float(np.abs(tmods[i] - tmods[i - 1]).mean() / np.abs(tmods[i - 1]).mean())
          for i in range(1, steps)]
    thresh = _middle_threshold(LINEAR, xs, steps)
    mask = texp.simulate_calc_schedule(LINEAR, xs, thresh, steps)
    assert 2 < mask.sum() < steps and _margin(LINEAR, xs, thresh, mask) > 0.04
    decided = []
    real = ttc.tea_cache_blocks

    def spy(state, x, t_mod, blocks_fn, **opts):
        calls = []
        out = real(state, x, t_mod, lambda v: calls.append(1) or blocks_fn(v), **opts)
        decided.append(bool(calls))
        return out

    monkeypatch.setattr(ttc, "tea_cache_blocks", spy)
    kw = dict(num_inference_steps=steps, tea_cache_l1_thresh=thresh,
              tea_cache_model_id="test-linear")
    out = pipe(**_request(ckpts, False, **kw)).numpy()
    assert decided == [m for m in mask for _ in range(2)]
    ref = np.asarray(jpipe(**_request(ckpts, True, **kw)))
    np.testing.assert_allclose(out, ref, atol=1e-4, rtol=1e-4)


def test_video_to_video_matches_jax(pair, ckpts):
    """A 9-frame input video encoded and noised to the first step's sigma
    at denoising_strength 0.7, 2 steps, with the first image's ``y``
    (the I2V DiT takes 12 channels: without an image it has no y)."""
    jpipe, pipe = pair
    kw = dict(input_video=ckpts["video"], denoising_strength=0.7, num_inference_steps=2,
              end_image=None)
    out = pipe(**_request(ckpts, False, **kw)).numpy()
    ref = np.asarray(jpipe(**_request(ckpts, True, **kw)))
    np.testing.assert_allclose(out, ref, atol=1e-4, rtol=1e-4)
    noise_only = pipe(**_request(ckpts, False, num_inference_steps=2, end_image=None)).numpy()
    assert np.abs(noise_only - out).max() > 1e-2  # the video shows


def test_clip_conditioned_request_matches_jax(ckpts):
    """Wan2.1-I2V-14B's form: one DiT with the CLIP branch and a 257-token
    ViT (1280 wide, one block) given to the constructor, 2 steps, CFG 5,
    both as two sweeps and merged.  Without an image encoder it raises as
    the JAX pipeline does."""
    files = _paths(ckpts, "dit_clip", "vae")
    vcfg = tclip.ViTConfig(**VIT)
    vit = convert.init_vit_params(vcfg, "cpu", torch.float32, seed=7)
    jvit = jax.tree.map(lambda a: jnp.asarray(a.numpy()), vit)
    jpipe = JPipeline.from_pretrained(files, dtype=jnp.float32, hints=ckpts["hints"])
    jpipe.image_encoder_params, jpipe.image_encoder_cfg = jvit, jclip.ViTConfig(**VIT)
    pipe = WanVideoPipeline.from_pretrained(files, dtype=torch.float32, hints=ckpts["hints"],
                                            device="cpu")
    with pytest.raises(ValueError, match="no image encoder"):
        pipe(**_request(ckpts, False, num_inference_steps=2))
    pipe.image_encoder_params, pipe.image_encoder_cfg = vit, vcfg
    feats = pipe.encode_clip_feature(ckpts["img"])
    assert feats.shape == (1, 257, 1280)
    np.testing.assert_allclose(feats.numpy(), np.asarray(jpipe.encode_clip_feature(ckpts["img"])),
                               atol=ATOL, rtol=1e-5)
    for merge in (False, True):
        kw = dict(num_inference_steps=2, cfg_merge=merge)
        out = pipe(**_request(ckpts, False, **kw)).numpy()
        ref = np.asarray(jpipe(**_request(ckpts, True, **kw)))
        np.testing.assert_allclose(out, ref, atol=1e-4, rtol=1e-4)


def test_image_without_an_image_path_raises(pair, ckpts):
    """A DiT config with neither the TI2V fused first frame nor the I2V y
    refuses input_image, as the JAX pipeline does."""
    import dataclasses

    _, pipe = pair
    cfg = pipe.dit_cfg
    pipe.dit_cfg = dataclasses.replace(cfg, require_vae_embedding=False)
    try:
        with pytest.raises(NotImplementedError, match="no image conditioning path"):
            pipe(**_request(ckpts, False, num_inference_steps=1))
    finally:
        pipe.dit_cfg = cfg


# ------------------------------------------------------------ the builders
def test_from_pretrained_pairs_two_dits_and_builds_the_v1_vae(pair, ckpts):
    """Two DiT files become (dit, dit2) in the pool's order, as in the JAX
    package; the v1 VAE by its hint; the experts' weights equal the JAX
    package's."""
    jpipe, pipe = pair
    assert pipe.dit2_params is not None and pipe.vae_cfg == TVCFG
    for params, ref in ((pipe.dit_params, jpipe.dit_params),
                        (pipe.dit2_params, jpipe.dit2_params)):
        np.testing.assert_array_equal(params["blocks"][1]["ffn"]["fc1"]["w"].numpy(),
                                      np.asarray(ref["blocks"]["ffn"]["fc1"]["w"][1]))
    files = _paths(ckpts, "dit_lo", "dit_hi", "vae")
    swapped = WanVideoPipeline.from_pretrained(files, dtype=torch.float32, hints=ckpts["hints"],
                                               device="cpu")
    assert torch.equal(swapped.dit_params["head"]["w"], pipe.dit2_params["head"]["w"])


def test_vae_builder_tells_the_two_vaes_apart(monkeypatch):
    """Without hints the builder reads the latent width (16: the Wan2.1
    VAE, 48: the VAE38), as the JAX builder does."""
    built = []
    monkeypatch.setattr(tvae, "convert_vae_v1_state_dict", lambda sd, cfg, **k: built.append(cfg))
    monkeypatch.setattr(tvae, "convert_vae38_state_dict", lambda sd, cfg, **k: built.append(cfg))
    build = ModelPool().registry.builder("wan_video_vae")
    for z in (16, 48):
        build({"model.conv2.weight": np.zeros((z, z, 1, 1, 1))}, {}, torch.float32, "cpu")
    assert built == [tvae.WanVAEConfig.wan21_16(), tvae.WanVAEConfig.wan22_38()]
    assert tvae.WanVAEConfig.wan21_16().upsampling_factor == 8


def test_dit_builder_takes_the_image_position_embedding():
    """``has_image_pos_emb`` builds (its ``img_emb.emb_pos``); so does the
    Fun-Reference conv (``ref_conv``) beside it."""
    kw = dict(I2V_CLIP, has_image_pos_emb=True)
    cfg, jp = _jax_dit(kw, 0)
    sd = _upstream_dit_sd(jp, cfg)
    sd["img_emb.emb_pos"] = np.full((1, 514, 1280), 0.5, np.float32)
    build = ModelPool().registry.builder("wan_video_dit")
    params, tcfg = build(sd, _dit_hint(kw), torch.float32, "cpu")
    assert tcfg.has_image_pos_emb and float(params["img_emb"]["pos"][0, 3, 7]) == 0.5
    sd["ref_conv.weight"] = np.full((cfg.dim, 16, 2, 2), 0.25, np.float32)
    sd["ref_conv.bias"] = np.zeros(cfg.dim, np.float32)
    params, tcfg = build(sd, dict(_dit_hint(kw), has_ref_conv=True), torch.float32, "cpu")
    assert tcfg.has_ref_conv and params["ref_conv"]["w"].shape == (64, cfg.dim)
    assert float(params["ref_conv"]["w"][5, 1]) == 0.25


def test_quantize_lora_and_clear_on_two_experts(ckpts, tmp_path):
    """quantize swaps both experts' projections; load_lora (hot) goes to
    ``dit`` only, as in the JAX package; clear_lora clears both."""
    files = _paths(ckpts, "dit_hi", "dit_lo", "vae")
    pipe = WanVideoPipeline.from_pretrained(files, dtype=torch.float32, hints=ckpts["hints"],
                                            device="cpu")
    rng = np.random.default_rng(8)
    sd = {"blocks.0.self_attn.q.lora_A.default.weight": rng.standard_normal((2, 96), np.float32),
          "blocks.0.self_attn.q.lora_B.default.weight": rng.standard_normal((96, 2), np.float32)}
    pipe.load_lora(sd, hotload=True)
    assert "lora" in pipe.dit_params["blocks"][0]["self_attn"]["q"]
    assert "lora" not in pipe.dit2_params["blocks"][0]["self_attn"]["q"]
    pipe.dit2_params["blocks"][0]["self_attn"]["q"]["lora"] = \
        pipe.dit_params["blocks"][0]["self_attn"]["q"]["lora"]
    pipe.clear_lora()
    assert all("lora" not in p["blocks"][0]["self_attn"]["q"]
               for p in (pipe.dit_params, pipe.dit2_params))
    pipe.quantize("int8_ffn")
    assert all("w_int8" in p["blocks"][1]["ffn"]["fc2"] and "w" not in p["blocks"][1]["ffn"]["fc2"]
               for p in (pipe.dit_params, pipe.dit2_params))


def test_cli_twin_runs_end_image(ckpts, tmp_path, monkeypatch):
    """``python -m fairygen_tpu_torch.examples.wan_inference --end_image``
    (in-process, ``--device cpu``) on the two experts, the v1 VAE and UMT5
    writes the clip of its 9 frames (a GIF: no ffmpeg here)."""
    from PIL import Image

    first, end = tmp_path / "first.png", tmp_path / "end.png"
    Image.fromarray(ckpts["img"]).save(first)
    Image.fromarray(ckpts["end"]).save(end)
    monkeypatch.setenv("FAIRYGEN_MODEL_HINTS", ckpts["hints_file"])
    files = _paths(ckpts, "dit_hi", "dit_lo", "vae", "umt5")
    rc = wan_inference.main([
        "--device", "cpu", "--model_paths", json.dumps(files),
        "--tokenizer_path", ckpts["tokenizer"], "--prompt", "a pig walks",
        "--input_image", str(first), "--end_image", str(end), "--height", str(H),
        "--width", str(W), "--num_frames", str(FRAMES), "--num_inference_steps", "2",
        "--output", str(tmp_path / "out.mp4")])
    assert rc == 0
    frames = tvideo.load_video_frames(str(tmp_path / "out.gif"))
    assert len(frames) == FRAMES and frames[0].size == (W, H)
