"""The port's own checkpoint converters against the JAX package's converter
followed by ``convert.from_jax_params``, on the committed golden state
dicts: the same tree, every leaf bit-equal (values, dtype and shape).  And
the per-sample adapter branch against the JAX package's."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fairygen_tpu.models.adapters import apply_adapter as j_apply_adapter
from fairygen_tpu.models.flux import dit as jfdit
from fairygen_tpu.models.flux import text_encoders as jfte
from fairygen_tpu.models.flux import vae as jfvae
from fairygen_tpu.models.sdxl import vae as jsvae
from fairygen_tpu.models.wan import dit as jdit
from fairygen_tpu.models.wan import text_encoder as jte
from fairygen_tpu.models.wan import vae as jvae
from fairygen_tpu_torch import convert
from fairygen_tpu_torch.models.adapters import apply_adapter, leaves_with_path
from fairygen_tpu_torch.models.flux import dit as tfdit
from fairygen_tpu_torch.models.flux import text_encoders as tfte
from fairygen_tpu_torch.models.flux import vae as tfvae
from fairygen_tpu_torch.models.sdxl import vae as tsvae
from fairygen_tpu_torch.models.wan import dit as tdit
from fairygen_tpu_torch.models.wan import text_encoder as tte
from fairygen_tpu_torch.models.wan import vae as tvae


def _sd(g, prefix, sep="::"):
    n = len(prefix) + len(sep)
    return {k[n:]: g[k] for k in g.files if k.startswith(prefix + sep)}


def _assert_same_tree(port, jax_tree):
    ref = dict(leaves_with_path(convert.from_jax_params(jax.tree.map(np.asarray, jax_tree),
                                                        device="cpu")))
    got = dict(leaves_with_path(port))
    assert set(got) == set(ref)
    for path, t in got.items():
        r = ref[path]
        assert t.dtype == r.dtype and t.shape == r.shape and t.is_contiguous(), path
        assert torch.equal(t, r), path


_WAN_DIT_KW = dict(dim=96, ffn_dim=128, out_dim=8, text_dim=32, freq_dim=32,
                   patch_size=(1, 2, 2), num_heads=4, num_layers=2)


@pytest.mark.parametrize("which", ["std", "ti"])
def test_wan_dit_converter(goldens, which):
    kw = dict(in_dim=16, has_image_input=True) if which == "std" else dict(
        in_dim=8, seperated_timestep=True, require_clip_embedding=False,
        require_vae_embedding=False, fuse_vae_embedding_in_latents=True)
    sd = _sd(goldens("wan_dit"), which)
    _assert_same_tree(
        tdit.convert_dit_state_dict(sd, tdit.WanDiTConfig(**_WAN_DIT_KW, **kw), device="cpu"),
        jdit.convert_dit_state_dict(sd, jdit.WanDiTConfig(**_WAN_DIT_KW, **kw)))


def test_umt5_converter(goldens):
    sd = _sd(goldens("umt5"), "sd")
    _assert_same_tree(tte.convert_umt5_state_dict(sd, tte.UMT5Config.tiny(), device="cpu"),
                      jte.convert_umt5_state_dict(sd, jte.UMT5Config.tiny()))


def test_vae38_converter(goldens):
    sd = _sd(goldens("wan_vae"), "sd")
    _assert_same_tree(tvae.convert_vae38_state_dict(sd, tvae.WanVAEConfig.tiny(), device="cpu"),
                      jvae.convert_vae38_state_dict(sd, jvae.WanVAEConfig.tiny()))


def test_vae38_converter_strips_the_model_prefix(goldens):
    sd = _sd(goldens("wan_vae"), "sd")
    a = tvae.convert_vae38_state_dict({"model." + k: v for k, v in sd.items()},
                                      tvae.WanVAEConfig.tiny(), device="cpu")
    _assert_same_tree(a, jvae.convert_vae38_state_dict(sd, jvae.WanVAEConfig.tiny()))


T5_CFG = dict(vocab=96, dim=32, dim_attn=32, dim_ffn=48, num_heads=4, num_layers=2,
              num_buckets=8, max_dist=32, shared_pos_bias=True)
CLIP_CFG = dict(vocab_size=100, hidden_size=32, intermediate_size=64, num_layers=2,
                num_heads=4, eos_token_id=99)


def test_t5_encoder_converter(goldens):
    sd = _sd(goldens("flux_text"), "t5", ".")
    _assert_same_tree(
        tte.convert_t5_encoder_state_dict(sd, tte.UMT5Config(**T5_CFG), device="cpu"),
        jte.convert_t5_encoder_state_dict(sd, jte.UMT5Config(**T5_CFG)))


def test_flux_clip_converter(goldens):
    sd = _sd(goldens("flux_text"), "clip", ".")
    _assert_same_tree(
        tfte.convert_flux_clip_state_dict(sd, tfte.CLIPTextConfig.tiny(**CLIP_CFG),
                                          device="cpu"),
        jfte.convert_flux_clip_state_dict(sd, jfte.CLIPTextConfig.tiny(**CLIP_CFG)))


def transformers_clip_sd(src):
    """The FLUX golden's CLIP tensors under transformers CLIPTextModel
    names, with a (16, 32) text projection."""
    names = {"attn.to_q": "self_attn.q_proj", "attn.to_k": "self_attn.k_proj",
             "attn.to_v": "self_attn.v_proj", "attn.to_out": "self_attn.out_proj",
             "fc1": "mlp.fc1", "fc2": "mlp.fc2"}
    sd = {"text_model.embeddings.token_embedding.weight": src["token_embedding.weight"],
          "text_model.embeddings.position_embedding.weight": src["position_embeds"][0],
          "text_projection.weight": np.arange(32 * 16, dtype=np.float32).reshape(16, 32)}
    for k, v in src.items():
        if k.startswith("encoders."):
            _, i, *rest = k.split(".")
            stem, leaf = ".".join(rest[:-1]), rest[-1]
            sd[f"text_model.encoder.layers.{i}.{names.get(stem, stem)}.{leaf}"] = v
        elif k.startswith("final_layer_norm"):
            sd["text_model." + k] = v
    return sd


def test_clip_text_converter_transformers_naming(goldens):
    """transformers CLIPTextModel names, made from the FLUX golden's
    tensors (with a text projection), through both converters."""
    from fairygen_tpu.models.sdxl.clip import convert_clip_text_state_dict as j_conv
    from fairygen_tpu_torch.models.sdxl.clip import convert_clip_text_state_dict as t_conv

    sd = transformers_clip_sd(_sd(goldens("flux_text"), "clip", "."))
    cfg = dict(CLIP_CFG, projection_dim=16)
    _assert_same_tree(t_conv(sd, tfte.CLIPTextConfig.tiny(**cfg), device="cpu"),
                      j_conv(sd, jfte.CLIPTextConfig.tiny(**cfg)))


@pytest.mark.parametrize("prescale", [False, True])
def test_flux_dit_converter(goldens, prescale):
    sd = _sd(goldens("flux_dit"), "sd", ".")
    _assert_same_tree(
        tfdit.convert_flux_dit_state_dict(sd, tfdit.FluxDiTConfig.tiny(), prescale=prescale,
                                          device="cpu"),
        jfdit.convert_flux_dit_state_dict(sd, jfdit.FluxDiTConfig.tiny(), prescale=prescale))


def test_normalize_flux_dit_source_matches(goldens):
    """BFL names made by inverting the rename tables -> the same reference
    names through both packages."""
    sd = _sd(goldens("flux_dit"), "sd", ".")
    inv = {"": {v: k for k, v in tfdit._BFL_TOP.items()},
           "blocks": {v: k for k, v in tfdit._BFL_DOUBLE.items()},
           "single_blocks": {v: k for k, v in tfdit._BFL_SINGLE.items()}}
    bfl = {}
    for name, v in sd.items():
        parts = name.split(".")
        stem, leaf = ".".join(parts[:-1]), parts[-1]
        if stem in inv[""]:
            bfl[f"{inv[''][stem]}.{leaf}"] = v
            continue
        table, dst = inv[parts[0]], "double_blocks" if parts[0] == "blocks" else parts[0]
        suf = ".".join(parts[2:])
        bfl[f"{dst}.{parts[1]}.{table[suf]}" if suf in table else
            f"{dst}.{parts[1]}.{table['.'.join(parts[2:-1])]}.{leaf}"] = v
    bfl = {"model.diffusion_model." + k: v for k, v in bfl.items()}
    ours, ref = tfdit.normalize_flux_dit_source(bfl), jfdit.normalize_flux_dit_source(bfl)
    assert set(ours) == set(ref) == set(sd)
    assert all(ours[k] is ref[k] for k in ref)
    assert tfdit.normalize_flux_dit_source(sd) is sd


def test_flux_vae_converter(goldens):
    sd = _sd(goldens("flux_vae"), "sd", ".")
    cfg = dict(latent_channels=4, block_out_channels=(8, 16, 32, 32), norm_num_groups=4,
               scaling_factor=0.3611, shift_factor=0.1159, use_quant_conv=False)
    _assert_same_tree(
        tfvae.convert_flux_vae_state_dict(sd, tsvae.AutoencoderKLConfig(**cfg), device="cpu"),
        jfvae.convert_flux_vae_state_dict(sd, jsvae.AutoencoderKLConfig(**cfg)))


def _diffusers_and_bfl_vae_names(tree):
    """The port tree of an AutoencoderKL -> a diffusers-named and a
    BFL-named numpy state dict holding its tensors."""
    dif, bfl = {}, {}

    def put(d, name, p, attn=False):
        w = p["w"].numpy()
        d[name + ".weight"] = w.T if attn else w
        d[name + ".bias"] = p["b"].numpy()

    def resnet(p, dname, bname):
        for k in ("norm1", "conv1", "norm2", "conv2"):
            put(dif, f"{dname}.{k}", p[k])
            put(bfl, f"{bname}.{k}", p[k])
        if "conv_shortcut" in p:
            put(dif, dname + ".conv_shortcut", p["conv_shortcut"])
            put(bfl, bname + ".nin_shortcut", p["conv_shortcut"])

    for side in ("encoder", "decoder"):
        t = tree[side]
        for k, bk in (("conv_in", "conv_in"), ("conv_norm_out", "norm_out"),
                      ("conv_out", "conv_out")):
            put(dif, f"{side}.{k}", t[k])
            put(bfl, f"{side}.{bk}", t[k])
        m = t["mid"]
        resnet(m["res1"], f"{side}.mid_block.resnets.0", f"{side}.mid.block_1")
        resnet(m["res2"], f"{side}.mid_block.resnets.1", f"{side}.mid.block_2")
        put(dif, f"{side}.mid_block.attentions.0.group_norm", m["attn"]["group_norm"])
        put(bfl, f"{side}.mid.attn_1.norm", m["attn"]["group_norm"])
        for k, dk, bk in (("to_q", "to_q", "q"), ("to_k", "to_k", "k"), ("to_v", "to_v", "v"),
                          ("to_out", "to_out.0", "proj_out")):
            put(dif, f"{side}.mid_block.attentions.0.{dk}", m["attn"][k], attn=True)
            put(bfl, f"{side}.mid.attn_1.{bk}", m["attn"][k], attn=True)
        stages = t["down_blocks" if side == "encoder" else "up_blocks"]
        n = len(stages)
        for i, st in enumerate(stages):
            bi = i if side == "encoder" else n - 1 - i
            broot = f"encoder.down.{bi}" if side == "encoder" else f"decoder.up.{bi}"
            droot = f"{side}.{'down' if side == 'encoder' else 'up'}_blocks.{i}"
            for j, r in enumerate(st["resnets"]):
                resnet(r, f"{droot}.resnets.{j}", f"{broot}.block.{j}")
            for key, bk in (("downsamplers", "downsample"), ("upsamplers", "upsample")):
                if key in st:
                    put(dif, f"{droot}.{key}.0.conv", st[key])
                    put(bfl, f"{broot}.{bk}.conv", st[key])
    return dif, bfl


def test_autoencoder_kl_converters_diffusers_and_bfl_naming(goldens):
    """convert_autoencoder_kl_state_dict (diffusers names, with quant convs)
    and convert_flux_vae_bfl_state_dict (BFL names) on the FLUX golden's
    tensors renamed, through both packages."""
    cfg = dict(latent_channels=4, block_out_channels=(8, 16, 32, 32), norm_num_groups=4)
    tree = tfvae.convert_flux_vae_state_dict(_sd(goldens("flux_vae"), "sd", "."),
                                             tsvae.AutoencoderKLConfig(**cfg), device="cpu")
    dif, bfl = _diffusers_and_bfl_vae_names(tree)
    rng = np.random.default_rng(0)
    for name, c in (("quant_conv", 8), ("post_quant_conv", 4)):
        dif[name + ".weight"] = rng.standard_normal((c, c, 1, 1)).astype(np.float32)
        dif[name + ".bias"] = rng.standard_normal(c).astype(np.float32)
    _assert_same_tree(
        tsvae.convert_autoencoder_kl_state_dict(dif, tsvae.AutoencoderKLConfig(**cfg),
                                                device="cpu"),
        jsvae.convert_autoencoder_kl_state_dict(dif, jsvae.AutoencoderKLConfig(**cfg)))
    cfg["use_quant_conv"] = False
    _assert_same_tree(
        tfvae.convert_flux_vae_bfl_state_dict(bfl, tsvae.AutoencoderKLConfig(**cfg),
                                              device="cpu"),
        jfvae.convert_flux_vae_bfl_state_dict(bfl, jsvae.AutoencoderKLConfig(**cfg)))


def test_converters_cast_and_place():
    sd = {"token_embedding.weight": np.ones((4, 2), np.float32), "norm.weight": np.ones(2)}
    p = tte.convert_umt5_state_dict(sd, tte.UMT5Config.tiny(num_layers=0), dtype=torch.bfloat16,
                                    device="cpu")
    assert p["token_embedding"].dtype == torch.bfloat16 and p["blocks"] == []


# ------------------------------------------------------------------ adapters
@pytest.mark.parametrize("masked", [False, True])
def test_per_sample_adapter_matches_jax(masked):
    """A 3-D A (B, in, r): (x·A)·B per row with the mask, and neither
    ``scale`` nor ``B2``, as the JAX package's per-sample branch (fp32,
    1e-6)."""
    rng = np.random.default_rng(1)
    b, n, i, r, o = 3, 5, 16, 4, 12
    x = rng.standard_normal((b, n, i)).astype(np.float32)
    base = rng.standard_normal((b, n, o)).astype(np.float32)
    # LoRA-like scales (A ~ 1/sqrt(in), B ~ 1/sqrt(r)): updates of order 1
    lora = {"A": (rng.standard_normal((b, i, r)) / np.sqrt(i)).astype(np.float32),
            "B": (rng.standard_normal((b, r, o)) / np.sqrt(r)).astype(np.float32),
            "B2": rng.standard_normal((b, r, o)).astype(np.float32), "scale": 0.5}
    mask = (rng.random((b, n, 1)) < 0.5).astype(np.float32) if masked else None
    ref = j_apply_adapter(jnp.asarray(base), jnp.asarray(x),
                          {"lora": jax.tree.map(jnp.asarray, lora)},
                          None if mask is None else jnp.asarray(mask))
    tl = {k: torch.as_tensor(v) for k, v in lora.items()}
    out = apply_adapter(torch.from_numpy(base), torch.from_numpy(x), {"lora": tl},
                        None if mask is None else torch.from_numpy(mask))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-6, rtol=1e-6)
