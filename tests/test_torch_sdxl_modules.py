"""The port's SDXL stylization modules against the JAX package and the
committed goldens: the UNet, BrushNet and the dual-branch injection
(tests/goldens/sdxl_unet.npz, the JAX suite's tolerances), the same forwards
with DoRA adapters and mask-gating against the JAX functions, DoRA's
``apply_adapter``, the DPM-Solver++(2M) scheduler (against JAX and
schedulers.npz), the dual CLIP prompt embedding (sdxl_aux.npz), the port's
UNet converter (bit-equal to the JAX converter + ``from_jax_params``), the
random init's tree (the JAX init's shapes) and the DoRA state dict both
ways.  fp32 on the CPU; port-vs-JAX forwards within 2e-5 absolute + 1e-4
relative (sums in other orders)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fairygen_tpu.diffusion import dpm_solver as jdpm
from fairygen_tpu.models import adapters as jad
from fairygen_tpu.models.sdxl import clip as jclip
from fairygen_tpu.models.sdxl import unet2d as junet
from fairygen_tpu.training import dora_trainer as jdora
from fairygen_tpu_torch import convert
from fairygen_tpu_torch.diffusion import dpm_solver as tdpm
from fairygen_tpu_torch.models import adapters as tad
from fairygen_tpu_torch.models.sdxl import clip as tclip
from fairygen_tpu_torch.models.sdxl import unet2d as tunet
from fairygen_tpu_torch.training import dora_trainer as tdora

UNET_KW = dict(block_out_channels=(32, 64), down_block_types=("DownBlock2D",
                                                              "CrossAttnDownBlock2D"),
               up_block_types=("CrossAttnUpBlock2D", "UpBlock2D"),
               transformer_layers_per_block=(1, 2), num_attention_heads=(2, 4),
               cross_attention_dim=32, norm_num_groups=16, addition_time_embed_dim=8,
               projection_class_embeddings_input_dim=80)
BN_KW = dict(UNET_KW, down_block_types=("DownBlock2D", "DownBlock2D"),
             up_block_types=("UpBlock2D", "UpBlock2D"), mid_block_type="UNetMidBlock2D",
             transformer_layers_per_block=(0, 0), attention_head_dim=8, conditioning_channels=5)
J_UNET, T_UNET = junet.UNet2DConfig(**UNET_KW), tunet.UNet2DConfig(**UNET_KW)
J_BN, T_BN = junet.UNet2DConfig(**BN_KW), tunet.UNet2DConfig(**BN_KW)
TOL = dict(atol=2e-5, rtol=1e-4)


def _t(a):
    return torch.from_numpy(np.array(a))


def _sd(g, prefix):
    n = len(prefix) + 2
    return {k[n:]: g[k] for k in g.files if k.startswith(prefix + "::")}


@pytest.fixture(scope="module")
def g():
    return np.load("tests/goldens/sdxl_unet.npz")


def _port(g, prefix, cfg):
    return tunet.convert_unet2d_state_dict(_sd(g, prefix), cfg, device="cpu")


def _inputs(g):
    return (_t(g["sample"]), _t(g["t"]), _t(g["ehs"])), dict(text_embeds=_t(g["text_embeds"]),
                                                            time_ids=_t(g["time_ids"]))


def test_unet_forward_matches_golden(g):
    args, kw = _inputs(g)
    out = tunet.unet2d_forward(_port(g, "unet", T_UNET), T_UNET, *args, **kw)
    np.testing.assert_allclose(out.numpy(), g["unet_out"], atol=2e-4, rtol=1e-3)


def test_brushnet_forward_matches_golden(g):
    args, kw = _inputs(g)
    down, mid, up = tunet.brushnet_forward(_port(g, "bn", T_BN), T_BN, *args, _t(g["cond"]),
                                           conditioning_scale=0.7, **kw)
    assert len(down) == 6 and len(up) == 7
    for i, d in enumerate(down):
        np.testing.assert_allclose(d.numpy(), g[f"bn_down_{i}"], atol=2e-4, rtol=1e-3)
    np.testing.assert_allclose(mid.numpy(), g["bn_mid"], atol=2e-4, rtol=1e-3)
    for i, u in enumerate(up):
        np.testing.assert_allclose(u.numpy(), g[f"bn_up_{i}"], atol=3e-4, rtol=1e-3)


def test_dual_branch_injection_matches_golden(g):
    args, kw = _inputs(g)
    down, mid, up = tunet.brushnet_forward(_port(g, "bn", T_BN), T_BN, *args, _t(g["cond"]),
                                           conditioning_scale=0.7, **kw)
    out = tunet.unet2d_forward(_port(g, "unet", T_UNET), T_UNET, *args, down_block_add_samples=down,
                               mid_block_add_sample=mid, up_block_add_samples=up, **kw)
    np.testing.assert_allclose(out.numpy(), g["unet_injected_out"], atol=5e-4, rtol=1e-3)


def _dora_sd(jparams, seed):
    """A DoRA state dict of the JAX UNet with non-zero B and magnitudes off
    the column norms, as a trained style adapter has."""
    params = jdora.add_dora_to_sdxl_unet(jparams, jax.random.key(seed), rank=4)
    sd = jdora.sdxl_dora_state_dict(params)
    rng = np.random.default_rng(seed)
    for k in sd:
        if k.endswith(".lora_B.weight"):
            sd[k] = (0.1 * rng.standard_normal(sd[k].shape)).astype(np.float32)
        elif k.endswith("magnitude_vector.weight"):
            sd[k] = (sd[k] * rng.uniform(0.8, 1.2, sd[k].shape)).astype(np.float32)
    return sd


@pytest.mark.parametrize("masked", [False, True])
def test_unet_with_dora_and_brushnet_matches_jax(g, masked):
    """The dual-branch forward with DoRA loaded at scale 0.66 (and the
    adapters mask-gated) against the JAX forward on the same weights."""
    ju = junet.convert_unet2d_state_dict(_sd(g, "unet"), J_UNET)
    jb = junet.convert_unet2d_state_dict(_sd(g, "bn"), J_BN)
    sd = _dora_sd(ju, 3)
    ju, n = jdora.load_sdxl_dora_state_dict(ju, sd, scale=0.66)
    tu, tn = tdora.load_sdxl_dora_state_dict(_port(g, "unet", T_UNET), sd, scale=0.66)
    assert n == tn == 12 * 2 * 4  # 12 transformer blocks x 2 attentions x 4 projections
    mask = (np.random.default_rng(4).random((2, 1, 16, 16)) > 0.5).astype(np.float32)
    jargs = (jnp.asarray(g["sample"]), jnp.asarray(g["t"]), jnp.asarray(g["ehs"]))
    jkw = dict(text_embeds=jnp.asarray(g["text_embeds"]), time_ids=jnp.asarray(g["time_ids"]))
    jd, jm, jup = junet.brushnet_forward(jb, J_BN, *jargs, jnp.asarray(g["cond"]),
                                         conditioning_scale=0.7, **jkw)
    ref = junet.unet2d_forward(ju, J_UNET, *jargs, down_block_add_samples=list(jd),
                               mid_block_add_sample=jm, up_block_add_samples=list(jup),
                               mask_latents=jnp.asarray(mask) if masked else None, **jkw)
    args, kw = _inputs(g)
    td, tm, tup = tunet.brushnet_forward(_port(g, "bn", T_BN), T_BN, *args, _t(g["cond"]),
                                         conditioning_scale=0.7, **kw)
    out = tunet.unet2d_forward(tu, T_UNET, *args, down_block_add_samples=td,
                               mid_block_add_sample=tm, up_block_add_samples=tup,
                               mask_latents=_t(mask) if masked else None, **kw)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("dtype", [np.float32, jnp.bfloat16])
def test_dora_apply_adapter_matches_jax(dtype):
    rng = np.random.default_rng(5)
    w = rng.standard_normal((16, 12)).astype(np.float32)
    lora = {"A": rng.standard_normal((16, 4)).astype(np.float32),
            "B": rng.standard_normal((4, 12)).astype(np.float32), "scale": 0.66,
            "mag": (np.linalg.norm(w, axis=0) * rng.uniform(0.5, 1.5, 12)).astype(np.float32)}
    x = rng.standard_normal((2, 5, 16)).astype(np.float32)
    mask = (rng.random((2, 5, 1)) > 0.5).astype(np.float32)
    jx, jw = jnp.asarray(x, dtype), jnp.asarray(w, dtype)
    base = jnp.dot(jx, jw, preferred_element_type=jnp.float32).astype(dtype)
    ref = jad.apply_adapter(base, jx, {"w": jw, "lora": {k: jnp.asarray(v) if isinstance(
        v, np.ndarray) else v for k, v in lora.items()}}, jnp.asarray(mask))
    tdt = torch.float32 if dtype == np.float32 else torch.bfloat16
    out = tad.apply_adapter(_t(np.asarray(base.astype(jnp.float32))).to(tdt), _t(x).to(tdt),
                            {"w": _t(w).to(tdt), "lora": {k: _t(v) if isinstance(v, np.ndarray)
                                                          else v for k, v in lora.items()}},
                            _t(mask))
    tol = TOL if dtype == np.float32 else dict(atol=2 ** -6, rtol=2 ** -7)
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref.astype(jnp.float32)), **tol)


def test_init_lora_dora_matches_jax():
    w = np.random.default_rng(6).standard_normal((16, 12)).astype(np.float32)
    ref = jad.init_lora(jax.random.key(0), 16, 12, 4, dora=True, base_w=jnp.asarray(w))
    out = tad.init_lora(torch.Generator().manual_seed(0), 16, 12, 4, dora=True, base_w=_t(w))
    np.testing.assert_allclose(out["mag"].numpy(), np.asarray(ref["mag"]), rtol=1e-6)
    assert out["B"].abs().sum() == 0 and out["scale"] == ref["scale"] == 1.0


def test_dpm_solver_matches_jax_and_golden():
    gs = np.load("tests/goldens/schedulers.npz")
    for n in (10, 50, 6):
        jd = jdpm.DPMSolverMultistepScheduler()
        jd.set_timesteps(n)
        td = tdpm.DPMSolverMultistepScheduler().set_timesteps(n)
        np.testing.assert_array_equal(td.timesteps, jd.timesteps)
        for k, v in jd.tables().items():
            np.testing.assert_array_equal(td.tables()[k].numpy(), np.asarray(v), err_msg=k)
    td = tdpm.DPMSolverMultistepScheduler().set_timesteps(10)
    np.testing.assert_array_equal(td.timesteps, gs["dpm_timesteps"])
    np.testing.assert_allclose(td.sigmas, gs["dpm_sigmas"], rtol=1e-5)
    tables = td.tables()
    step = tdpm.DPMSolverMultistepScheduler.step_from_tables
    x = _t(gs["dpm_x_init"])
    state = td.init_state(x.shape)
    jx = jnp.asarray(gs["dpm_x_init"])
    jstate = jd.init_state(jx.shape)
    jd.set_timesteps(10)
    for i in range(10):
        x, state = step(tables, state, 0.1 * x + 0.01 * i, i, x)
        jx, jstate = jd.step(jstate, 0.1 * jx + 0.01 * i, i, jx)
    np.testing.assert_allclose(x.numpy(), np.asarray(jx), atol=1e-6, rtol=1e-6)
    x = _t(gs["dpm_x_init"])
    state = td.init_state(x.shape)
    for i in range(10):
        x, state = step(tables, state, 0.1 * x, i, x)
    np.testing.assert_allclose(x.numpy(), gs["dpm_x_final"], atol=1e-4, rtol=1e-4)


def test_sdxl_encode_prompt_matches_jax_and_golden():
    ga = np.load("tests/goldens/sdxl_aux.npz")
    te1 = jclip.CLIPTextConfig.tiny(eos_token_id=99)
    te2 = jclip.CLIPTextConfig.tiny(hidden_size=48, intermediate_size=96, hidden_act="gelu",
                                    projection_dim=40, eos_token_id=99)
    tte1 = tclip.CLIPTextConfig(**{f: getattr(te1, f) for f in te1.__dataclass_fields__})
    tte2 = tclip.CLIPTextConfig(**{f: getattr(te2, f) for f in te2.__dataclass_fields__})
    sd1 = {k[5:]: ga[k] for k in ga.files if k.startswith("te1::")}
    sd2 = {k[5:]: ga[k] for k in ga.files if k.startswith("te2::")}
    ids = ga["ids"]
    emb, pooled = jclip.sdxl_encode_prompt(jclip.convert_clip_text_state_dict(sd1, te1), te1,
                                           jclip.convert_clip_text_state_dict(sd2, te2), te2,
                                           jnp.asarray(ids), jnp.asarray(ids))
    temb, tpooled = tclip.sdxl_encode_prompt(
        tclip.convert_clip_text_state_dict(sd1, tte1, device="cpu"), tte1,
        tclip.convert_clip_text_state_dict(sd2, tte2, device="cpu"), tte2, _t(ids), _t(ids))
    np.testing.assert_allclose(temb.numpy(), np.asarray(emb), **TOL)
    np.testing.assert_allclose(tpooled.numpy(), np.asarray(pooled), **TOL)
    np.testing.assert_allclose(tpooled.numpy(), ga["te2_text_embeds"], atol=2e-5, rtol=1e-4)
    np.testing.assert_allclose(temb[..., :32].numpy(), ga["te1_penult"], atol=2e-5, rtol=1e-4)
    for name in ("sdxl_te1", "sdxl_te2"):
        assert getattr(tclip.CLIPTextConfig, name)().__dict__ == \
            getattr(jclip.CLIPTextConfig, name)().__dict__


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (i,))
    else:
        yield path, tree


@pytest.mark.parametrize("prefix", ["unet", "bn"])
def test_unet_converter_is_bit_equal_to_jax_and_from_jax_params(g, prefix):
    jcfg, tcfg = (J_UNET, T_UNET) if prefix == "unet" else (J_BN, T_BN)
    ref = convert.from_jax_params(jax.tree.map(np.asarray, junet.convert_unet2d_state_dict(
        _sd(g, prefix), jcfg)), "cpu")
    out = _port(g, prefix, tcfg)
    a, b = list(_leaves(out)), list(_leaves(ref))
    assert [p for p, _ in a] == [p for p, _ in b]
    for (path, x), (_, y) in zip(a, b):
        assert x.dtype == y.dtype and torch.equal(x, y), path


@pytest.mark.parametrize("brushnet", [False, True])
def test_init_unet2d_params_has_the_jax_tree(brushnet):
    kw = BN_KW if brushnet else UNET_KW
    ref = convert.from_jax_params(jax.tree.map(np.asarray, junet.init_unet2d_params(
        junet.UNet2DConfig(**kw), brushnet=brushnet)), "cpu")
    out = convert.init_unet2d_params(tunet.UNet2DConfig(**kw), "cpu", torch.float32, seed=0,
                                     brushnet=brushnet)
    a, b = list(_leaves(out)), list(_leaves(ref))
    assert [(p, tuple(x.shape)) for p, x in a] == [(p, tuple(x.shape)) for p, x in b]
    for path, x in a:
        assert torch.isfinite(x).all(), path


def test_dora_state_dict_round_trip_matches_jax(g):
    ju = junet.convert_unet2d_state_dict(_sd(g, "unet"), J_UNET)
    tu = tdora.add_dora_to_sdxl_unet(_port(g, "unet", T_UNET), torch.Generator().manual_seed(0),
                                     rank=4)
    sd = tdora.sdxl_dora_state_dict(tu)
    jsd = jdora.sdxl_dora_state_dict(jdora.add_dora_to_sdxl_unet(ju, jax.random.key(0), rank=4))
    assert sorted(sd) == sorted(jsd)
    for k in sd:
        assert sd[k].shape == jsd[k].shape, k
        if k.endswith("magnitude_vector.weight"):
            np.testing.assert_allclose(sd[k], jsd[k], rtol=1e-6)
    back, n = tdora.load_sdxl_dora_state_dict(_port(g, "unet", T_UNET), sd, scale=0.5)
    assert n == len(sd) // 3
    again = tdora.sdxl_dora_state_dict(back)
    for k in sd:
        np.testing.assert_array_equal(again[k], sd[k])
    assert scale_leaves(back) == {0.5}


def scale_leaves(tree):
    return {v for p, v in _leaves(tree) if p[-1] == "scale"}
