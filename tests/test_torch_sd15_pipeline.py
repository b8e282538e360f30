"""SD1.5 + BrushNet inpainting on the port against the JAX package, on the
CPU in fp32 (the plain versions of the kernels): the UniPC scheduler, the
SD1.5 UNet and BrushNet (the JAX suite's sd15_unet golden at its own
atol=5e-4, rtol=1e-3; a four-level SD1.5-shaped pair with BrushNet's mid
attention against the JAX forwards), ``from_jax_params`` on their trees,
the pipeline (the sd15_pipeline golden at the JAX suite's bar, every pixel
within 3 levels and PSNR above 45 dB; a 2-step request with string
prompts, the tokenizer and the text encoder and the blended paste against
the JAX pipeline), ``blend_with_original``, and the twins of
examples/brushnet_inpaint_sd15.py and examples/app_brushnet.py (``--help``,
a tiny synthetic run, the app's helpers against the JAX app's, the gradio
gate).  Inputs come from numpy seeds.
"""
import dataclasses
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fairygen_tpu.core.io import save_safetensors
from fairygen_tpu.diffusion import unipc as junipc
from fairygen_tpu.models.sdxl import clip as jclip
from fairygen_tpu.models.sdxl import unet2d as junet
from fairygen_tpu.models.sdxl import vae as jvae
from fairygen_tpu.pipelines import sd15_brushnet as jpipe
from fairygen_tpu.utils.tokenizer import CLIPTokenizerWrapper as JTokenizer
from fairygen_tpu_torch import convert
from fairygen_tpu_torch.diffusion import unipc as tunipc
from fairygen_tpu_torch.examples import app_brushnet, brushnet_inpaint_sd15
from fairygen_tpu_torch.models.adapters import leaves_with_path
from fairygen_tpu_torch.models.sdxl import clip as tclip
from fairygen_tpu_torch.models.sdxl import unet2d as tunet
from fairygen_tpu_torch.models.sdxl import vae as tvae
from fairygen_tpu_torch.pipelines import sd15_brushnet as tpipe
from fairygen_tpu_torch.utils.tokenizer import CLIPTokenizerWrapper
from test_product_flow_cli import _tiny_clip_te_sd, _write_tiny_clip_tokenizer
from test_sd15_pipeline import BN_CFG as J_BN_CFG
from test_sd15_pipeline import UNET_CFG as J_UNET_CFG
from test_sd15_pipeline import VAE_CFG as J_VAE_CFG
from test_sd15_unet import BN_CFG as J_UNET_TEST_BN
from test_sd15_unet import UNET_CFG as J_UNET_TEST_UNET

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "examples"))
import app_brushnet as japp  # noqa: E402


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


def _port_cfg(cfg):
    """The port's UNet2DConfig with a JAX config's fields."""
    return tunet.UNet2DConfig(**dataclasses.asdict(cfg))


def _sd(g, prefix):
    n = len(prefix) + 2
    return {k[n:]: g[k] for k in g.files if k.startswith(prefix + "::")}


def _to_jax(tree):
    """A port param tree as the JAX package's: conv weights HWIO."""
    if isinstance(tree, dict):
        return {k: (jnp.asarray(v.numpy().transpose(2, 3, 1, 0)) if k == "w" and v.dim() == 4
                    else _to_jax(v)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_jax(v) for v in tree]
    return jnp.asarray(tree.numpy())


# ------------------------------------------------------------------- UniPC
@pytest.mark.parametrize("n", [50, 6, 2])
def test_unipc_tables_and_steps_match_jax(n):
    """The fp64 tables are equal; four fp32 steps on seeded samples and
    model outputs agree within 1e-6 relative."""
    ref = junipc.UniPCMultistepScheduler(steps_offset=1)
    ref.set_timesteps(n)
    got = tunipc.UniPCMultistepScheduler(steps_offset=1).set_timesteps(n)
    np.testing.assert_array_equal(got.timesteps, ref.timesteps)
    np.testing.assert_array_equal(got.sigmas, ref.sigmas)
    for a, b in zip(got._cp + got._cc, ref._cp + ref._cc):
        np.testing.assert_array_equal(a, b)
    rng = np.random.default_rng(n)
    x = rng.standard_normal((1, 4, 8, 8)).astype(np.float32)
    jt, tt = ref.tables(), got.tables()
    js, ts = ref.init_state(x.shape), got.init_state(x.shape)
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    for i in range(min(n, 4)):
        m = rng.standard_normal(x.shape).astype(np.float32)
        jx, js = junipc.UniPCMultistepScheduler.step_from_tables(jt, js, jnp.asarray(m), i, jx)
        tx, ts = tunipc.UniPCMultistepScheduler.step_from_tables(tt, ts, torch.from_numpy(m),
                                                                 i, tx)
        np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(ts.last_sample.numpy(), np.asarray(js.last_sample),
                                   rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------- UNet, BrushNet
def test_sd15_configs_are_the_jax_packages():
    assert tunet.UNet2DConfig.sd15_base().__dict__ == junet.UNet2DConfig.sd15_base().__dict__
    assert (tunet.UNet2DConfig.brushnet_sd15().__dict__
            == junet.UNet2DConfig.brushnet_sd15().__dict__)


def test_sd15_dual_branch_matches_golden(goldens):
    """The JAX suite's sd15_unet golden (conv projections, no text_time,
    BrushNet injection) at its own tolerance."""
    g = goldens("sd15_unet")
    ucfg, bcfg = _port_cfg(J_UNET_TEST_UNET), _port_cfg(J_UNET_TEST_BN)
    unet = tunet.convert_unet2d_state_dict(_sd(g, "unet"), ucfg, device="cpu")
    bn = tunet.convert_unet2d_state_dict(_sd(g, "bn"), bcfg, device="cpu")
    sample, t, ehs = (torch.from_numpy(g[k]) for k in ("sample", "t", "ehs"))
    down, mid, up = tunet.brushnet_forward(bn, bcfg, sample, t, ehs, torch.from_numpy(g["cond"]))
    out = tunet.unet2d_forward(unet, ucfg, sample, t, ehs, down_block_add_samples=down,
                               mid_block_add_sample=mid, up_block_add_samples=up)
    np.testing.assert_allclose(out.numpy(), g["o"], atol=5e-4, rtol=1e-3)


# four levels as SD1.5 (a trailing DownBlock2D, a leading UpBlock2D), at
# tiny width; BrushNet with its plain mid attention of head dim 8
TINY = dict(block_out_channels=(32, 32, 64, 64), num_attention_heads=(4, 4, 8, 8),
            cross_attention_dim=32, norm_num_groups=16, layers_per_block=1)


def _tiny_cfgs(module):
    return (module.UNet2DConfig(**{**module.UNet2DConfig.sd15_base().__dict__, **TINY}),
            module.UNet2DConfig(**{**module.UNet2DConfig.brushnet_sd15().__dict__, **TINY}))


def test_four_level_unet_and_brushnet_match_the_jax_forwards():
    """Seeded weights (the port's init, carried to the JAX tree), BrushNet's
    mid attention included: the BrushNet features and the UNet's output
    with them added, against the JAX forwards in fp32."""
    ucfg, bcfg = _tiny_cfgs(tunet)
    jucfg, jbcfg = _tiny_cfgs(junet)
    unet = convert.init_unet2d_params(ucfg, "cpu", torch.float32, seed=3)
    bn = convert.init_unet2d_params(bcfg, "cpu", torch.float32, seed=4, brushnet=True)
    assert len(bn["mid_block"]["attentions"]) == 1
    rng = np.random.default_rng(5)
    x, cond = (rng.standard_normal((2, c, 16, 16)).astype(np.float32) for c in (4, 5))
    ehs = rng.standard_normal((2, 7, 32)).astype(np.float32)
    t = np.array([981.0, 981.0], np.float32)
    with torch.no_grad():
        down, mid, up = tunet.brushnet_forward(bn, bcfg, *(torch.from_numpy(a)
                                                           for a in (x, t, ehs, cond)))
        out = tunet.unet2d_forward(unet, ucfg, torch.from_numpy(x), torch.from_numpy(t),
                                   torch.from_numpy(ehs), down_block_add_samples=down,
                                   mid_block_add_sample=mid, up_block_add_samples=up)
    @jax.jit
    def jax_step(unet_p, bn_p, x, t, ehs, cond):
        down, mid, up = junet.brushnet_forward(bn_p, jbcfg, x, t, ehs, cond)
        return down, mid, up, junet.unet2d_forward(
            unet_p, jucfg, x, t, ehs, down_block_add_samples=list(down),
            mid_block_add_sample=mid, up_block_add_samples=list(up))

    jdown, jmid, jup, jout = jax_step(_to_jax(unet), _to_jax(bn),
                                      *(jnp.asarray(a) for a in (x, t, ehs, cond)))
    for a, b in zip(down + [mid] + up, list(jdown) + [jmid] + list(jup)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b).transpose(0, 3, 1, 2),
                                   atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=1e-4, rtol=1e-4)


def _mid_attention_sd(c, rng):
    """A plain UNetMidBlock2D attention's keys (diffusers layout), seeded."""
    sd = {f"mid_block.attentions.0.group_norm.{k}": np.full(c, v, np.float32)
          for k, v in (("weight", 1.0), ("bias", 0.0))}
    for name in ("to_q", "to_k", "to_v", "to_out.0"):
        sd[f"mid_block.attentions.0.{name}.weight"] = rng.standard_normal((c, c)).astype(
            np.float32) * c ** -0.5
        sd[f"mid_block.attentions.0.{name}.bias"] = np.zeros(c, np.float32)
    return sd


@pytest.mark.parametrize("which", ["unet", "bn", "bn with mid attention"])
def test_from_jax_params_carries_the_sd15_trees(goldens, which):
    """The JAX converter's tree through ``from_jax_params`` equals the
    port's converter's leaf for leaf (values, dtype, shape): the SD1.5 UNet,
    its BrushNet and a BrushNet whose checkpoint has a mid attention."""
    g = goldens("sd15_unet")
    sd = _sd(g, which.split()[0])
    if which == "unet":
        jcfg = J_UNET_TEST_UNET
    else:
        jcfg = J_UNET_TEST_BN
        if "mid" in which:
            sd = {**sd, **_mid_attention_sd(64, np.random.default_rng(0))}
    ref = dict(leaves_with_path(convert.from_jax_params(
        jax.tree.map(np.asarray, junet.convert_unet2d_state_dict(sd, jcfg)), device="cpu")))
    got = dict(leaves_with_path(tunet.convert_unet2d_state_dict(sd, _port_cfg(jcfg),
                                                                device="cpu")))
    assert set(got) == set(ref) and len(got) > 100
    assert any("mid_block" in str(p) and "group_norm" in str(p) for p in got) == (
        "mid" in which)
    for path, t in got.items():
        assert t.dtype == ref[path].dtype and t.shape == ref[path].shape, path
        assert torch.equal(t, ref[path]), path


# --------------------------------------------------------------- pipeline
def _golden_pipe(g, dtype=torch.float32):
    ucfg, bcfg = _port_cfg(J_UNET_CFG), _port_cfg(J_BN_CFG)
    vcfg = tvae.AutoencoderKLConfig(**dataclasses.asdict(J_VAE_CFG))
    return tpipe.SD15BrushNetPipeline(
        tunet.convert_unet2d_state_dict(_sd(g, "unet"), ucfg, dtype, device="cpu"), ucfg,
        tvae.convert_autoencoder_kl_state_dict(_sd(g, "vae"), vcfg, device="cpu"), vcfg,
        tunet.convert_unet2d_state_dict(_sd(g, "bn"), bcfg, dtype, device="cpu"), bcfg,
        dtype=dtype, device="cpu")


def test_pipeline_matches_golden(goldens):
    """64x64, 6 UniPC steps, CFG 7.5, BrushNet 1.0, seed 88 with
    torch-compatible noise: the JAX suite's bar."""
    g = goldens("sd15_pipeline")
    frames = _golden_pipe(g)(prompt_embeds=g["pe"], negative_prompt_embeds=g["npe"],
                             image=g["masked_u8"].astype(np.float32) / 255.0,
                             mask=g["mask_u8"].astype(np.float32) / 255.0, height=64, width=64,
                             num_inference_steps=6, guidance_scale=7.5,
                             brushnet_conditioning_scale=1.0, seed=88, torch_compat_noise=True)
    ours = frames[0].astype(np.float32)
    ref = g["img_out"].astype(np.float32) * 255.0
    assert ours.shape == ref.shape == (64, 64, 3) and frames[0].dtype == np.uint8
    diff = np.abs(ours - ref)
    assert diff.max() <= 3, f"max pixel diff {diff.max()}"
    psnr = 10 * np.log10(255.0 ** 2 / max(np.mean(diff ** 2), 1e-9))
    assert psnr > 45, f"PSNR {psnr:.1f} dB"


@pytest.fixture(scope="module")
def tiny_ckpts(tmp_path_factory):
    """The sd15_pipeline golden's UNet, BrushNet and VAE, a tiny CLIP text
    encoder (hidden 32) and a char-level tokenizer as files, a
    FAIRYGEN_CONFIG_OVERRIDES table for the CLI twin, and a 64x64 image and
    mask (white = inpaint) as PNGs."""
    from PIL import Image

    d = tmp_path_factory.mktemp("sd15")
    g = np.load(os.path.join(os.path.dirname(__file__), "goldens", "sd15_pipeline.npz"))
    paths = {}
    for name, key in (("unet", "unet"), ("brushnet", "bn"), ("vae", "vae")):
        paths[name] = str(d / f"{name}.safetensors")
        save_safetensors(paths[name], _sd(g, key))
    paths["tokenizer"] = str(d / "tok")
    vocab = _write_tiny_clip_tokenizer(paths["tokenizer"])
    paths["te"] = str(d / "te.safetensors")
    save_safetensors(paths["te"], _tiny_clip_te_sd(np.random.RandomState(7), hidden=32,
                                                   inter=64, vocab=vocab))
    te_cfg = dict(vocab_size=vocab, hidden_size=32, intermediate_size=64, num_layers=2,
                  num_heads=2, max_position_embeddings=77, eos_token_id=1)
    table = {"sd15_unet": dataclasses.asdict(J_UNET_CFG),
             "sd15_brushnet": dataclasses.asdict(J_BN_CFG),
             "sd15_vae": dataclasses.asdict(J_VAE_CFG),
             "sd15_te": dataclasses.asdict(jclip.CLIPTextConfig(**te_cfg))}
    paths["overrides"] = str(d / "overrides.json")
    with open(paths["overrides"], "w") as f:
        json.dump(table, f)
    paths["image"], paths["mask"] = str(d / "image.png"), str(d / "mask.png")
    Image.fromarray(g["init_u8"]).save(paths["image"])
    Image.fromarray(np.repeat(g["mask_u8"], 3, -1)).save(paths["mask"])
    paths["te_cfg"] = te_cfg
    return paths


def _cli_inputs(ck, size=64):
    """The twins' image preparation (test_brushnet.py): init in [0, 1], the
    mask where the RGB sum passes 255, the masked init."""
    from PIL import Image

    init = np.asarray(Image.open(ck["image"]).convert("RGB").resize((size, size)),
                      np.float32) / 255.0
    mask = (np.asarray(Image.open(ck["mask"]).convert("RGB").resize((size, size)),
                       np.float32).sum(-1) > 255)[..., None].astype(np.float32)
    return init, mask, init * (1.0 - mask)


def test_pipeline_with_prompts_and_blend_matches_jax(goldens, tiny_ckpts):
    """String prompts through the tokenizer and the text encoder (final
    layer-norm states), 2 steps at CFG 7.5, BrushNet 1.0, the blended paste,
    the decoded image in [-1, 1], torch-compatible noise (the same draws on
    both sides): within 1e-4 of the JAX pipeline (fp32 on both sides, sums
    in other orders)."""
    from fairygen_tpu.core.io import load_state_dict

    ck, g = tiny_ckpts, goldens("sd15_pipeline")
    jte_cfg, tte_cfg = (m.CLIPTextConfig(**ck["te_cfg"]) for m in (jclip, tclip))
    te_sd = load_state_dict(ck["te"])
    init, mask, masked = _cli_inputs(ck)
    call = dict(prompt="a cake on the table", negative_prompt="blurry", image=masked, mask=mask,
                height=64, width=64, num_inference_steps=2, guidance_scale=7.5,
                brushnet_conditioning_scale=1.0, seed=1234, blended=True, original_image=init,
                output_type="np_pm1", torch_compat_noise=True)
    jp = jpipe.SD15BrushNetPipeline(
        unet_params=junet.convert_unet2d_state_dict(_sd(g, "unet"), J_UNET_CFG),
        unet_cfg=J_UNET_CFG,
        vae_params=jvae.convert_autoencoder_kl_state_dict(_sd(g, "vae"), J_VAE_CFG),
        vae_cfg=J_VAE_CFG,
        brushnet_params=junet.convert_unet2d_state_dict(_sd(g, "bn"), J_BN_CFG),
        brushnet_cfg=J_BN_CFG, te_params=jclip.convert_clip_text_state_dict(te_sd, jte_cfg),
        te_cfg=jte_cfg, tokenizer=JTokenizer(ck["tokenizer"]))
    ref = np.asarray(jp(**call))
    tp = _golden_pipe(g)
    tp.te_params = tclip.convert_clip_text_state_dict(te_sd, tte_cfg, device="cpu")
    tp.te_cfg, tp.tokenizer = tte_cfg, CLIPTokenizerWrapper(ck["tokenizer"])
    out = tp(**call)
    assert out.shape == (1, 3, 64, 64) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-4, rtol=0)
    np.testing.assert_allclose(tp.encode_prompt("a cake").numpy(),
                               np.asarray(jp.encode_prompt("a cake")), atol=1e-5)
    lat = tp(**{**call, "output_type": "latent"})
    f = tp.vae_cfg.downscale_factor
    assert lat.shape == (1, 4, 64 // f, 64 // f) and lat.dtype == torch.float32
    with pytest.raises(ValueError, match="output_type"):
        tp(**{**call, "output_type": "pil"})


def test_blend_with_original_matches_jax():
    rs = np.random.RandomState(0)
    gen = (rs.rand(1, 3, 32, 32) * 2 - 1).astype(np.float32)
    orig = rs.rand(32, 32, 3).astype(np.float32)
    mask = np.zeros((32, 32), np.float32)
    mask[8:16, 8:16] = 1.0
    ref = np.asarray(jpipe.blend_with_original(jnp.asarray(gen), orig, mask))
    out = tpipe.blend_with_original(torch.from_numpy(gen), orig, mask)
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-6, rtol=0)
    orig_pm1 = orig.transpose(2, 0, 1)[None] * 2 - 1
    np.testing.assert_allclose(out.numpy()[:, :, 28:, 28:], orig_pm1[:, :, 28:, 28:], atol=1e-5)


# ----------------------------------------------------------------- twins
@pytest.mark.parametrize("twin", [brushnet_inpaint_sd15, app_brushnet])
def test_twins_help(twin, capsys):
    with pytest.raises(SystemExit) as e:
        twin.main(["--help"])
    assert e.value.code == 0 and "--tokenizer" in capsys.readouterr().out


def test_cli_twin_tiny_run(tiny_ckpts, tmp_path, monkeypatch):
    """``--device cpu`` on the tiny checkpoints (FAIRYGEN_CONFIG_OVERRIDES),
    2 steps, ``--blended``: the saved image is what the pipeline that
    ``load_pipeline`` builds gives for the CLI's inputs, bit for bit (bf16
    UNet, BrushNet and text encoder, the fp32 VAE, as the JAX CLI)."""
    from PIL import Image

    ck = tiny_ckpts
    monkeypatch.setenv("FAIRYGEN_CONFIG_OVERRIDES", ck["overrides"])
    out = tmp_path / "out.png"
    argv = ["--unet", ck["unet"], "--brushnet", ck["brushnet"], "--vae", ck["vae"], "--te",
            ck["te"], "--tokenizer", ck["tokenizer"], "--image", ck["image"], "--mask",
            ck["mask"], "--prompt", "a cake on the table", "--steps", "2", "--size", "64",
            "--blended", "--output", str(out), "--device", "cpu"]
    assert brushnet_inpaint_sd15.main(argv) == 0
    saved = np.asarray(Image.open(out))
    args = type("Args", (), dict(unet=ck["unet"], brushnet=ck["brushnet"], vae=ck["vae"],
                                 te=ck["te"], tokenizer=ck["tokenizer"], device="cpu"))
    pipe = brushnet_inpaint_sd15.load_pipeline(args)
    assert pipe.dtype == torch.bfloat16 and pipe.vae_cfg.scaling_factor == 0.18215
    assert pipe.unet_params["conv_in"]["w"].dtype == torch.bfloat16
    assert pipe.vae_params["decoder"]["conv_in"]["w"].dtype == torch.float32
    init, mask, masked = _cli_inputs(ck)
    want = pipe(prompt="a cake on the table", negative_prompt="", image=masked, mask=mask,
                height=64, width=64, num_inference_steps=2, guidance_scale=7.5,
                brushnet_conditioning_scale=1.0, seed=1234, blended=True, original_image=init)
    assert saved.shape == (64, 64, 3)
    np.testing.assert_array_equal(saved, want[0])


def test_app_helpers_match_the_jax_app():
    """resize_image, prepare_mask_and_image (upload, invert and SAM paths)
    and run_inpaint's call against the JAX app's, on the same arrays."""
    rng = np.random.default_rng(2)
    img = rng.integers(0, 256, (300, 500, 3), dtype=np.uint8)
    np.testing.assert_array_equal(app_brushnet.resize_image(img, 256),
                                  japp.resize_image(img, 256))
    m = np.zeros((32, 32), np.uint8)
    m[8:24, 8:24] = 255
    small = img[:64, :64]
    keep = np.zeros((64, 64, 3), np.uint8)
    keep[:32] = 255
    for kw in (dict(input_mask=m), dict(input_mask=m, invert_mask=True),
               dict(original_mask=keep)):
        for a, b in zip(app_brushnet.prepare_mask_and_image(small, **kw),
                        japp.prepare_mask_and_image(small, **kw)):
            np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="upload the input image"):
        app_brushnet.prepare_mask_and_image(None, input_mask=m)
    _, mask = app_brushnet.prepare_mask_and_image(small, input_mask=m)
    calls = []

    def pipe(**kw):
        calls.append(kw)
        return ["image"]

    for app in (app_brushnet, japp):
        assert app.run_inpaint(pipe, small, mask, "a cake", blended=True, seed=7) == ["image"]
    for k in calls[0]:
        np.testing.assert_array_equal(np.asarray(calls[0][k]), np.asarray(calls[1][k]))
    with pytest.raises(ValueError, match="control strength below 1.0"):
        app_brushnet.run_inpaint(pipe, small, mask, "a cake", blended=True,
                                 control_strength=0.5)


def test_app_needs_gradio():
    """``gradio`` is not installed: building the demo raises with the JAX
    app's message."""
    try:
        import gradio  # noqa: F401
        pytest.fail("gradio is installed; the gate is not exercised")
    except ImportError:
        pass
    with pytest.raises(RuntimeError, match="needs gradio") as e:
        app_brushnet.build_demo(None)
    with pytest.raises(RuntimeError) as j:
        japp.build_demo(None)
    assert str(e.value) == str(j.value)


# ------------------------------------------------------------ entry points
@pytest.mark.parametrize("entry", ["pipeline", "cli_twin", "app_twin"])
def test_new_entry_points_raise_without_a_card(monkeypatch, entry):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    files = ["--unet", "x", "--brushnet", "x", "--vae", "x", "--te", "x", "--tokenizer", "x"]
    calls = {
        "pipeline": lambda: tpipe.SD15BrushNetPipeline({}, tunet.UNet2DConfig.sd15_base(), {},
                                                       tvae.AutoencoderKLConfig()),
        "cli_twin": lambda: brushnet_inpaint_sd15.main(
            files + ["--image", "x", "--mask", "x", "--prompt", "x"]),
        "app_twin": lambda: app_brushnet.main(files),
    }
    with pytest.raises(RuntimeError, match="no CUDA device"):
        calls[entry]()
