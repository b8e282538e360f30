"""The port's TI2V entry surface against the JAX package, on the CPU: the
UMT5 tokenizer wrapper, the architecture hash, the registry data, the
hash-detected ModelPool / ``from_pretrained`` on tiny checkpoints written
by the port's ``save_safetensors``, prompt strings, fused and hot LoRA,
``clear_lora``, ``cfg_merge``, ``save_video``'s chain and the CLI twins.

Tiny checkpoints come from the committed upstream goldens (the TI2V DiT
and VAE38 of tests/goldens/wan_pipeline.npz, UMT5 of umt5.npz); the
tokenizer is an offline WordLevel one.  fp32; tolerances per test.
"""
import dataclasses
import json
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fairygen_tpu.core import io as jio
from fairygen_tpu.core.dtypes import default_policy as j_default_policy
from fairygen_tpu.core.model_config import ModelConfig as JModelConfig
from fairygen_tpu.core.model_config import override_config as j_override_config
from fairygen_tpu.core.model_config import resolve_model_paths as j_resolve_model_paths
from fairygen_tpu.models import adapters as jadapters
from fairygen_tpu.models.wan import dit as jdit
from fairygen_tpu.pipelines.wan_video import WanVideoPipeline as JPipeline
from fairygen_tpu.utils.tokenizer import HuggingfaceTokenizer as JTokenizer
from fairygen_tpu_torch.core import io as tio
from fairygen_tpu_torch.core.dtypes import DTypePolicy, default_policy
from fairygen_tpu_torch.core.model_config import ModelConfig, override_config, resolve_model_paths
from fairygen_tpu_torch.core.model_pool import ModelPool
from fairygen_tpu_torch.core.registry import MODEL_REGISTRY
from fairygen_tpu_torch.examples import wan_batch_inference, wan_inference
from fairygen_tpu_torch.models import adapters as tadapters
from fairygen_tpu_torch.models.wan import dit as tdit
from fairygen_tpu_torch.pipelines.wan_video import WanVideoPipeline
from fairygen_tpu_torch.utils import video as tvideo
from fairygen_tpu_torch.utils.tokenizer import HuggingfaceTokenizer

REPO = pathlib.Path(__file__).resolve().parent.parent
DIT_EXTRA = dict(dim=96, in_dim=4, ffn_dim=128, out_dim=4, text_dim=32, freq_dim=32,
                 patch_size=[1, 2, 2], num_heads=4, num_layers=2, seperated_timestep=True,
                 require_clip_embedding=False, require_vae_embedding=False,
                 fuse_vae_embedding_in_latents=True)
VAE_EXTRA = dict(dim=8, z_dim=4, dec_dim=8, num_res_blocks=1)
TE_EXTRA = dict(vocab=128, dim=32, dim_attn=32, dim_ffn=48, num_heads=4, num_layers=2)
WORDS = ["a", "pig", "walks", "the", "runs", "drawing", "meadow", "child", "happy",
         "cartoon", "style", "in"]


def _write_tokenizer(dirpath):
    """An offline AutoTokenizer directory with ids below the tiny vocab."""
    from tokenizers import Tokenizer, models, pre_tokenizers
    from transformers import PreTrainedTokenizerFast

    vocab = {"<pad>": 0, "</s>": 1, "<unk>": 2}
    vocab.update({w: i + 3 for i, w in enumerate(WORDS)})
    tok = Tokenizer(models.WordLevel(vocab, unk_token="<unk>"))
    tok.pre_tokenizer = pre_tokenizers.Whitespace()
    PreTrainedTokenizerFast(tokenizer_object=tok, pad_token="<pad>", eos_token="</s>",
                            unk_token="<unk>").save_pretrained(str(dirpath))
    return str(dirpath)


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory, goldens):
    """dit / vae / umt5 safetensors written by the port, their hints and a
    tokenizer directory."""
    tmp = tmp_path_factory.mktemp("wan_ckpts")
    g, gu = goldens("wan_pipeline"), goldens("umt5")
    paths = {}
    for name, sd in (("dit", {k[5:]: g[k] for k in g.files if k.startswith("dit::")}),
                     ("vae", {k[5:]: g[k] for k in g.files if k.startswith("vae::")}),
                     ("umt5", {k[4:]: gu[k] for k in gu.files if k.startswith("sd::")})):
        paths[name] = str(tmp / f"{name}.safetensors")
        tio.save_safetensors(paths[name], sd)
    hints = {paths["dit"]: ("wan_video_dit", DIT_EXTRA),
             paths["vae"]: ("wan_video_vae", VAE_EXTRA),
             paths["umt5"]: ("wan_video_text_encoder", TE_EXTRA)}
    (tmp / "hints.json").write_text(json.dumps(hints))
    return dict(paths=paths, hints=hints, hints_file=str(tmp / "hints.json"),
                tokenizer=_write_tokenizer(tmp / "tokenizer"), tmp=tmp,
                img=np.asarray(g["img_uint8"]))


# ------------------------------------------------------------- tokenizer
@pytest.mark.parametrize("clean", [None, "whitespace", "lower", "canonicalize"])
def test_tokenizer_ids_and_masks_match_jax(ckpts, clean):
    text = ["  A pig\n walks in the  meadow ", "cartoon_style, happy child!", ""]
    ours = HuggingfaceTokenizer(ckpts["tokenizer"], seq_len=16, clean=clean)
    ref = JTokenizer(ckpts["tokenizer"], seq_len=16, clean=clean)
    for t in text:
        ids, mask = ours(t, return_mask=True)
        rids, rmask = ref(t, return_mask=True)
        np.testing.assert_array_equal(ids, rids)
        np.testing.assert_array_equal(mask, rmask)
    np.testing.assert_array_equal(ours(text), ref(text))


def test_tokenizer_needs_transformers(ckpts, monkeypatch):
    monkeypatch.setitem(sys.modules, "transformers", None)
    with pytest.raises(ImportError):
        HuggingfaceTokenizer(ckpts["tokenizer"], seq_len=16)


# ------------------------------------------------------------ io, hashing
@pytest.mark.parametrize("with_shape", [True, False])
def test_hashes_equal_the_jax_package(ckpts, goldens, with_shape):
    g = goldens("wan_pipeline")
    sd = {k[5:]: g[k] for k in g.files if k.startswith("dit::")}
    nested = {"a": np.zeros((2, 3)), "sub": {"b": np.zeros(4), "c": np.zeros((1, 2, 3))}}
    for tree in (sd, nested, {k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()}):
        assert (tio.hash_state_dict_keys(tree, with_shape)
                == jio.hash_state_dict_keys(jax.tree.map(np.asarray, tree), with_shape))
    for p in ckpts["paths"].values():
        assert tio.hash_model_file(p, with_shape) == jio.hash_model_file(p, with_shape)
        assert tio.load_shapes(p) == jio.load_shapes(p)


def test_load_state_dict_reads_safetensors_and_torch_pickles(tmp_path):
    rng = np.random.default_rng(0)
    sd = {"w": rng.standard_normal((3, 4)).astype(np.float32),
          "i": np.arange(5, dtype=np.int64)}
    st, pt = str(tmp_path / "a.safetensors"), str(tmp_path / "b.pt")
    tio.save_safetensors(st, sd)
    torch.save({"state_dict": {k: torch.from_numpy(v) for k, v in sd.items()}}, pt)
    both = tio.load_state_dict([st, pt])
    ref = jio.load_torch_pickle(pt)
    for k, v in sd.items():
        np.testing.assert_array_equal(both[k], v)
        np.testing.assert_array_equal(tio.load_torch_pickle(pt)[k], ref[k])
    assert tio.load_shapes(pt) == {"w": [3, 4], "i": [5]}


def test_registry_copy_is_byte_equal():
    ours = REPO / "fairygen_tpu_torch" / "configs" / "model_registry.json"
    ref = REPO / "fairygen_tpu" / "configs" / "model_registry.json"
    assert ours.read_bytes() == ref.read_bytes()
    assert len(MODEL_REGISTRY.lookup("1f5ab7703c6fc803fdded85ff040c316")) == 1


@pytest.mark.parametrize("name", ["flux2_dit", "qwen_image_dit"])
def test_unported_registry_names_raise_with_their_roadmap_item(name):
    with pytest.raises(NotImplementedError, match=f"{name} .*item 8"):
        ModelPool().registry.builder(name)


@pytest.mark.parametrize("name,attr", [("wan_video_vace", "vace_params"),
                                       ("wan_video_motion_controller",
                                        "motion_controller_params"),
                                       ("wan_video_vap", "vap_params"),
                                       ("wan_video_animate_adapter", "animate_params")])
def test_pipeline_given_models_have_no_builder_and_are_skipped(name, attr, ckpts, monkeypatch):
    """The JAX package's pool builds no VACE branch, motion controller, VAP
    branch or Animate adapter (the pipeline takes them); the port's refuses
    the name, names the pipeline's argument, and a file whose hash also
    maps to it loads the rest, as the JAX pool does."""
    with pytest.raises(NotImplementedError, match=f"{name} has no model-pool builder.*{attr}"):
        ModelPool().registry.builder(name)
    from fairygen_tpu_torch.core import registry

    path = ckpts["paths"]["dit"]
    spec = registry.ModelSpec("0" * 32, name, {})
    real = MODEL_REGISTRY.detect_file
    monkeypatch.setattr(MODEL_REGISTRY, "detect_file", lambda p: [spec] if p == path else real(p))
    assert MODEL_REGISTRY.load(path, dtype=torch.float32, device="cpu") == []


@pytest.mark.parametrize("sd,extra,match", [
    ({}, {"add_control_adapter": True, "in_dim_control_adapter": 24},
     "unsupported WanModel kwargs.*camera_params"),
])
def test_wan_dit_variants_raise(sd, extra, match):
    """A camera DiT's adapter is not built by the pool (in the JAX package
    either)."""
    with pytest.raises(NotImplementedError, match=match):
        ModelPool().registry.builder("wan_video_dit")(sd, extra, torch.float32, "cpu")


LONGCAT_EXTRA = dict(in_channels=4, out_channels=4, hidden_size=96, depth=2, num_heads=4,
                     caption_channels=32, adaln_tembed_dim=64, freq_dim=32)


@pytest.fixture(scope="module")
def longcat_ckpt(ckpts, goldens):
    """The LongCat golden's upstream state dict with its caption projection
    redrawn for the tiny UMT5's width (32), as safetensors, and a hints file
    that adds it to the tiny checkpoints' hints."""
    g = goldens("longcat")
    sd = {k[3:]: g[k] for k in g.files if k.startswith("sd.")}
    rng = np.random.default_rng(6)
    sd["y_embedder.y_proj.0.weight"] = (0.1 * rng.standard_normal((96, 32))).astype(np.float32)
    path = str(ckpts["tmp"] / "longcat.safetensors")
    tio.save_safetensors(path, sd)
    hints = dict(ckpts["hints"], **{path: ("wan_video_dit", LONGCAT_EXTRA)})
    hints_file = ckpts["tmp"] / "hints_longcat.json"
    hints_file.write_text(json.dumps(hints))
    return dict(path=path, sd=sd, hints=hints, hints_file=str(hints_file))


def test_the_pool_builds_a_tiny_longcat_and_from_pretrained_sorts_it_out(ckpts, longcat_ckpt):
    """LongCat-Video's DiT is found by its final layer (its hash maps to
    wan_video_dit): the pool builds it at the hints' config, the converter's
    params, and ``from_pretrained`` sorts it out of the DiTs beside a Wan
    DiT file, as the JAX package's type split does."""
    from fairygen_tpu_torch.models.wan import longcat as tlc

    params, cfg = ModelPool().registry.builder("wan_video_dit")(
        longcat_ckpt["sd"], dict(LONGCAT_EXTRA), torch.float32, "cpu")
    assert cfg == tlc.LongCatDiTConfig(**LONGCAT_EXTRA)
    ref = tlc.convert_longcat_dit_state_dict(longcat_ckpt["sd"], cfg, device="cpu")
    np.testing.assert_array_equal(params["blocks"][1]["w2"]["w"].numpy(),
                                  ref["blocks"][1]["w2"]["w"].numpy())
    pipe = WanVideoPipeline.from_pretrained(
        [longcat_ckpt["path"], ckpts["paths"]["dit"], ckpts["paths"]["vae"]],
        hints=longcat_ckpt["hints"], dtype=torch.float32, device="cpu")
    assert pipe.longcat_cfg == cfg and pipe.s2v_params is None
    assert isinstance(pipe.dit_cfg, tdit.WanDiTConfig) and pipe.dit2_params is None
    np.testing.assert_array_equal(pipe.longcat_params["x_embedder"]["w"].numpy(),
                                  ref["x_embedder"]["w"].numpy())


def test_model_config_resolves_local_paths(tmp_path, monkeypatch):
    (tmp_path / "org" / "m").mkdir(parents=True)
    for n in ("a.safetensors", "b.safetensors", "c.txt"):
        (tmp_path / "org" / "m" / n).write_bytes(b"")
    cfg = ModelConfig(model_id="org/m", origin_file_pattern="*.safetensors",
                      local_model_path=str(tmp_path), skip_download=True)
    assert resolve_model_paths(["x.pt", cfg]) == ["x.pt"] + sorted(
        str(tmp_path / "org" / "m" / n) for n in ("a.safetensors", "b.safetensors"))
    assert resolve_model_paths(["x.pt", cfg]) == j_resolve_model_paths(
        ["x.pt", JModelConfig(**dataclasses.asdict(cfg))])
    over = tmp_path / "over.json"
    over.write_text(json.dumps({"dit": {"num_layers": 3, "patch_size": [1, 4, 4]}}))
    monkeypatch.setenv("FAIRYGEN_CONFIG_OVERRIDES", str(over))
    cfg = override_config("dit", tdit.WanDiTConfig())
    assert cfg.num_layers == 3 and cfg.patch_size == (1, 4, 4)
    ref = j_override_config("dit", jdit.WanDiTConfig())
    assert all(getattr(cfg, f) == getattr(ref, f) for f in tdit.WanDiTConfig.__dataclass_fields__)


def test_dtype_policy_casts_floating_tensors_only():
    tree = {"w": torch.ones(2), "ids": torch.arange(3), "blocks": [{"b": torch.zeros(1)}]}
    out = default_policy().cast_params(tree)
    assert out["w"].dtype == out["blocks"][0]["b"].dtype == torch.bfloat16
    assert out["ids"].dtype == torch.int64
    assert DTypePolicy(torch.float32).cast_params(tree)["w"].dtype == torch.float32
    ref = j_default_policy()
    assert [str(d).split(".")[-1] for d in dataclasses.astuple(default_policy())] == [
        np.dtype(d).name for d in dataclasses.astuple(ref)]  # the JAX package's defaults


# ----------------------------------------------------------- the pipeline
def _jax_pipe(ckpts):
    return JPipeline.from_pretrained(list(ckpts["paths"].values()),
                                     tokenizer_path=ckpts["tokenizer"], dtype=jnp.float32,
                                     hints=ckpts["hints"])


def _port_pipe(ckpts):
    return WanVideoPipeline.from_pretrained(list(ckpts["paths"].values()),
                                            tokenizer_path=ckpts["tokenizer"],
                                            dtype=torch.float32, hints=ckpts["hints"],
                                            device="cpu")


REQUEST = dict(prompt="a pig walks in the meadow", negative_prompt="", seed=3, height=32,
               width=32, num_frames=5, cfg_scale=5.0, num_inference_steps=2,
               torch_compat_noise=True)


@pytest.fixture(scope="module")
def pipes(ckpts):
    return _jax_pipe(ckpts), _port_pipe(ckpts)


def test_model_pool_builds_the_three_wan_roles(ckpts):
    pool = ModelPool().load(list(ckpts["paths"].values()), dtype=torch.float32,
                            hints=ckpts["hints"], device="cpu")
    (dit, dcfg), (vae, vcfg), (te, tcfg) = (pool.fetch_model(n) for n in (
        "wan_video_dit", "wan_video_vae", "wan_video_text_encoder"))
    assert dcfg.patch_size == (1, 2, 2) and dcfg.num_layers == len(dit["blocks"]) == 2
    assert vcfg.z_dim == 4 and tcfg.vocab == 128
    leaves = [t for _, t in tadapters.leaves_with_path(dit)]
    assert leaves and all(t.device.type == "cpu" and t.dtype == torch.float32 for t in leaves)


def test_encode_prompt_matches_jax(pipes):
    jpipe, pipe = pipes
    for prompt in ("a pig walks in the meadow", ""):
        ref = np.asarray(jpipe.encode_prompt(prompt))
        out = pipe.encode_prompt(prompt)
        assert out.shape == ref.shape == (1, 512, 32)
        np.testing.assert_allclose(out.numpy(), ref, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("cfg_merge", [False, True])
def test_from_pretrained_request_matches_jax(ckpts, pipes, cfg_merge):
    """Prompt strings and the first image through both from_pretrained
    pipelines; CFG 5 as two sweeps or (``cfg_merge``) one batch-2 sweep.
    fp32, 2 steps: 1e-4, as the port's other pipeline tests."""
    jpipe, pipe = pipes
    kw = dict(REQUEST, input_image=ckpts["img"], output_type="latents", cfg_merge=cfg_merge)
    ref = np.asarray(jpipe(**kw))
    out = pipe(**kw)
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-4, rtol=1e-4)


def test_cfg_merge_equals_two_sweeps(ckpts, pipes):
    """The batch-2 sweep and the two batch-1 sweeps give the same latents
    up to fp32 summation order (1e-5)."""
    _, pipe = pipes
    kw = dict(REQUEST, input_image=ckpts["img"], output_type="latents")
    np.testing.assert_allclose(pipe(cfg_merge=True, **kw).numpy(),
                               pipe(cfg_merge=False, **kw).numpy(), atol=1e-5, rtol=1e-5)


def _lora_sd(seed, rank, blocks=(0, 1)):
    """A Wan-DiT LoRA in the trainer's 'default' naming over a few layers."""
    rng = np.random.default_rng(seed)
    sd = {}
    for i in blocks:
        for layer, (d_in, d_out) in (("self_attn.q", (96, 96)), ("cross_attn.v", (96, 96)),
                                     ("ffn.0", (96, 128))):
            pre = f"blocks.{i}.{layer}"
            sd[f"{pre}.lora_A.default.weight"] = (0.1 * rng.standard_normal((rank, d_in))
                                                  ).astype(np.float32)
            sd[f"{pre}.lora_B.default.weight"] = (0.1 * rng.standard_normal((d_out, rank))
                                                  ).astype(np.float32)
    return sd


def _dit_outputs(jpipe, pipe, seed=0):
    """One DiT sweep of each pipeline's current weights on shared inputs."""
    rng = np.random.default_rng(seed)
    lat = rng.standard_normal((1, 4, 2, 4, 4)).astype(np.float32)
    ctx = rng.standard_normal((1, 6, 32)).astype(np.float32)
    t = np.asarray([700.0], np.float32)
    ref = np.asarray(jdit.wan_dit_forward(jpipe.dit_params, jpipe.dit_cfg, jnp.asarray(lat),
                                          jnp.asarray(t), jnp.asarray(ctx),
                                          fuse_vae_embedding_in_latents=True))
    out = tdit.wan_dit_forward(pipe.dit_params, pipe.dit_cfg, torch.from_numpy(lat),
                               torch.from_numpy(t), torch.from_numpy(ctx),
                               fuse_vae_embedding_in_latents=True)
    return out.numpy(), ref


def test_lora_fused_hot_and_cleared_match_jax(ckpts, tmp_path):
    """Fused at 0.7 from a file; then a rank-2 hot LoRA on both blocks and a
    rank-3 one on block 1 only (rank concatenation: 5 columns in block 1,
    2 in block 0, which the JAX package's stacked layers pad with zeros);
    then cleared.  Each state's DiT sweep against the JAX package's at 1e-5
    (fp32)."""
    jpipe, pipe = _jax_pipe(ckpts), _port_pipe(ckpts)
    path = str(tmp_path / "lora.safetensors")
    tio.save_safetensors(path, _lora_sd(0, 4))
    base = _dit_outputs(jpipe, pipe)[0]
    for p in (jpipe, pipe):
        p.load_lora(path, alpha=0.7)
    out, ref = _dit_outputs(jpipe, pipe)
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=1e-5)
    fused = out
    for p in (jpipe, pipe):
        p.load_lora(_lora_sd(1, 2), alpha=0.5, hotload=True)
        p.load_lora(_lora_sd(2, 3, blocks=(1,)), alpha=1.5, hotload=True)
    jlay = jpipe.dit_params["blocks"]["self_attn"]["q"]["lora"]
    for i, r in ((0, 2), (1, 5)):
        blk = pipe.dit_params["blocks"][i]["self_attn"]["q"]["lora"]
        assert blk["A"].shape == (96, r) and blk["B"].shape == (r, 96) and set(blk) == {"A", "B"}
        ja, jb = np.asarray(jlay["A"][i]), np.asarray(jlay["B"][i])
        np.testing.assert_array_equal(blk["A"].numpy(), ja[:, :r])
        np.testing.assert_array_equal(blk["B"].numpy(), jb[:r])
        assert not ja[:, r:].any() and not jb[r:].any()
    out, ref = _dit_outputs(jpipe, pipe)
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=1e-5)
    assert np.abs(out - fused).max() > 1e-3
    for p in (jpipe, pipe):
        p.clear_lora()
    out, ref = _dit_outputs(jpipe, pipe)
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(out, fused, atol=1e-6, rtol=0)
    assert not np.allclose(out, base)


def test_hot_lora_refuses_a_training_adapter_and_takes_the_2d_branch():
    """A hot adapter over a layer with a training adapter raises, as in the
    JAX package; a concatenated hot adapter is 2-D, so apply_adapter takes
    its shared-adapter branch for a batch of 3-D activations (the
    per-sample branch needs a 3-D A)."""
    w = torch.randn(4, 6)
    params = {"blocks": [{"self_attn": {"q": {"w": w, "b": torch.zeros(6),
                                              "lora": {"A": torch.zeros(4, 2),
                                                       "B": torch.zeros(2, 6),
                                                       "scale": 1.0}}}}]}
    sd = {"blocks.0.self_attn.q.lora_A.weight": np.ones((1, 4), np.float32),
          "blocks.0.self_attn.q.lora_B.weight": np.ones((6, 1), np.float32)}
    with pytest.raises(ValueError, match="training adapter"):
        tadapters.hot_lora_into_wan_dit(params, sd)
    with pytest.raises(ValueError, match="training adapter"):
        jadapters.hot_lora_into_wan_dit(
            {"blocks": {"modulation": jnp.zeros((1, 6, 6)),
                        "self_attn": {"q": {"w": jnp.zeros((1, 4, 6)),
                                            "lora": {"A": jnp.zeros((1, 4, 2)),
                                                     "B": jnp.zeros((1, 2, 6)),
                                                     "scale": jnp.ones(1)}}}}}, sd)
    del params["blocks"][0]["self_attn"]["q"]["lora"]
    hot, n = tadapters.hot_lora_into_wan_dit(params, sd, alpha=2.0)
    hot, _ = tadapters.hot_lora_into_wan_dit(hot, sd, alpha=1.0)
    layer = hot["blocks"][0]["self_attn"]["q"]
    assert n == 1 and layer["lora"]["A"].shape == (4, 2)
    x = torch.randn(2, 3, 4)  # batch 2 = the concatenated rank
    out = tadapters.apply_adapter(x @ w, x, layer)
    np.testing.assert_allclose(out.numpy(), (x @ w + 3 * x.sum(-1, keepdim=True)).numpy(),
                               atol=1e-5)


def test_variant_inputs_without_their_models_name_the_missing_argument(pipes):
    """Every Wan variant runs (tests/test_torch_wan_conditioning.py,
    test_torch_wan_s2v.py, test_torch_wan_animate.py, test_torch_wan_mot.py,
    test_torch_longcat.py); without its model a request says which argument
    is missing."""
    _, pipe = pipes
    frames = [np.zeros((32, 32, 3), np.uint8)]
    for kw, match in (({"vace_video": frames}, "vace_params"),
                      ({"motion_bucket_id": 3}, "motion_controller_params"),
                      ({"audio_embeds": np.zeros((1, 25, 8, 4), np.float32)}, "s2v_params"),
                      ({"animate_pose_video": frames, "animate_face_video": frames},
                       "animate_params"),
                      ({"vap_video": frames, "context_vap": torch.zeros(1, 6, 32)},
                       "vap_params")):
        with pytest.raises(ValueError, match=match):
            pipe(**REQUEST, **kw)
    # the JAX defaults ask for nothing
    pipe(**REQUEST, output_type="latents", vap_prompt=" ", longcat_video=None, vace_scale=0.5)
    with pytest.raises(TypeError, match="unexpected keyword"):
        pipe(**REQUEST, no_such_keyword=1)


def test_from_pretrained_refuses_a_mesh(ckpts):
    with pytest.raises(NotImplementedError, match="item 9"):
        WanVideoPipeline.from_pretrained([], mesh=object(), device="cpu")


def test_progress_callback_and_seed_none(ckpts, pipes):
    _, pipe = pipes
    seen = []
    kw = dict(REQUEST, seed=None, output_type="latents")
    out = pipe(progress_callback=lambda i, n: seen.append((i, n)), **kw)
    assert seen == [(1, 2), (2, 2)]
    np.testing.assert_array_equal(out.numpy(), pipe(**dict(kw, seed=0)).numpy())


# ------------------------------------------------------------------ media
def test_save_video_falls_back_to_a_gif_then_to_png_frames(tmp_path, monkeypatch):
    frames = [np.full((8, 8, 3), i * 40, np.uint8) for i in range(4)]

    def no_backend(*args, **kwargs):
        raise ValueError("no backend")

    monkeypatch.setattr(tvideo, "_save_imageio", no_backend)
    out = tvideo.save_video(frames, str(tmp_path / "a.mp4"), fps=8)
    assert out == str(tmp_path / "a.gif") and os.path.getsize(out) > 0
    back = tvideo.load_video_frames(out)
    assert len(back) == 4 and back[0].size == (8, 8)

    def no_gif(*args, **kwargs):
        raise OSError("cannot write")

    monkeypatch.setattr(tvideo, "_save_gif", no_gif)
    out = tvideo.save_video(frames, str(tmp_path / "b.mp4"))
    assert out == str(tmp_path / "b")
    assert sorted(os.listdir(out)) == [f"{i:05d}.png" for i in range(4)]
    back = tvideo.load_video_frames(out, height=4, width=6)
    assert len(back) == 4 and back[1].size == (6, 4)
    np.testing.assert_array_equal(np.asarray(tvideo.load_video_frames(out)[2]), frames[2])


def test_save_video_writes_through_imageio_when_it_can(tmp_path):
    """Without an ffmpeg backend an .mp4 becomes a GIF; a .gif path is
    written by imageio's own GIF writer."""
    frames = [np.zeros((8, 8, 3), np.uint8)] * 3
    out = tvideo.save_video(frames, str(tmp_path / "c.gif"))
    assert out == str(tmp_path / "c.gif") and os.path.getsize(out) > 0


# -------------------------------------------------------------------- CLI
def test_cli_twins_keep_the_jax_examples_flags_and_prompt():
    src = (REPO / "examples" / "wan_inference.py").read_text()
    ns = {}
    start = src.index("NEGATIVE_PROMPT = (")
    exec(src[start:src.index(")", start) + 1], ns)
    assert wan_inference.NEGATIVE_PROMPT == ns["NEGATIVE_PROMPT"]
    flags = {a.dest for a in wan_inference.parser()._actions} - {"help", "device"}
    import re
    ref = set(re.findall(r'add_argument\("--(\w+)"', src))
    assert flags == ref


@pytest.mark.parametrize("flag", ["--usp 2", "--sp_strategy ring"])
def test_cli_refuses_unported_flags(flag, capsys):
    with pytest.raises(SystemExit) as e:
        wan_inference.main(["--model_paths", "[]", "--prompt", "x", *flag.split()])
    assert e.value.code == 2
    assert "ROADMAP.md Queue 1 item" in capsys.readouterr().err


@pytest.mark.parametrize("flag,key,want", [
    ("--vace_video {dir}", "vace_video", 2), ("--camera_control_direction Left",
                                              "camera_control_direction", "Left"),
    ("--audio {wav}", "input_audio", 800), ("--reference_image {img}", "reference_image",
                                            (32, 32)),
    ("--motion_bucket_id 3", "motion_bucket_id", 3)])
def test_cli_passes_the_variant_flags(flag, key, want, tmp_path, monkeypatch):
    """The variant flags reach the pipeline as the JAX example passes them:
    a frame directory as frames, the wav as a waveform (at its header's
    rate), an image resized to the request."""
    import wave

    from PIL import Image

    (tmp_path / "v").mkdir()
    for i in range(2):
        Image.fromarray(np.full((8, 8, 3), 40 * i, np.uint8)).save(tmp_path / "v" / f"{i}.png")
    Image.fromarray(np.zeros((8, 8, 3), np.uint8)).save(tmp_path / "r.png")
    with wave.open(str(tmp_path / "a.wav"), "wb") as f:
        f.setnchannels(1)
        f.setsampwidth(2)
        f.setframerate(8000)
        f.writeframes(np.zeros(800, np.int16).tobytes())
    seen = {}

    class Pipe:
        def __call__(self, **kw):
            seen.update(kw)
            return [np.zeros((8, 8, 3), np.uint8)]

    monkeypatch.setattr(WanVideoPipeline, "from_pretrained", classmethod(lambda *a, **k: Pipe()))
    args = flag.format(dir=tmp_path / "v", wav=tmp_path / "a.wav", img=tmp_path / "r.png")
    assert wan_inference.main(["--model_paths", "[]", "--prompt", "x", "--height", "32",
                               "--width", "32", "--output", str(tmp_path / "o.gif"),
                               *args.split()]) == 0
    got = seen[key]
    if key == "vace_video":
        got = len(got)
    elif key == "input_audio":
        assert seen["audio_sample_rate"] == 8000
        got = len(got)
    elif key == "reference_image":
        got = got.size
    assert got == want


def test_cli_twin_writes_a_video(ckpts, tmp_path):
    """``python -m fairygen_tpu_torch.examples.wan_inference`` on the tiny
    checkpoints (hints through FAIRYGEN_MODEL_HINTS), 2 steps with a LoRA
    and CFG; no ffmpeg here, so the clip is a GIF."""
    from PIL import Image

    first = tmp_path / "first.png"
    Image.fromarray(ckpts["img"]).save(first)
    lora = str(tmp_path / "lora.safetensors")
    tio.save_safetensors(lora, _lora_sd(0, 2))
    env = dict(os.environ, FAIRYGEN_MODEL_HINTS=ckpts["hints_file"],
               PYTHONPATH=str(REPO) + os.pathsep + os.environ.get("PYTHONPATH", ""))
    r = subprocess.run(
        [sys.executable, "-m", "fairygen_tpu_torch.examples.wan_inference", "--device", "cpu",
         "--model_paths", json.dumps(list(ckpts["paths"].values())),
         "--tokenizer_path", ckpts["tokenizer"], "--lora", lora, "--prompt", "a pig walks",
         "--input_image", str(first), "--height", "32", "--width", "32", "--num_frames", "5",
         "--num_inference_steps", "2", "--output", str(tmp_path / "out.mp4")],
        capture_output=True, text=True, timeout=300, cwd=str(tmp_path), env=env)
    assert r.returncode == 0, r.stderr[-3000:]
    gif = tmp_path / "out.gif"
    assert gif.exists() and len(tvideo.load_video_frames(str(gif))) == 5


def test_cli_twin_continues_a_clip_with_longcat(ckpts, longcat_ckpt, tmp_path, monkeypatch):
    """``--longcat_video`` reaches the LongCat request: the twin run
    in-process with ``--device cpu`` on the tiny LongCat DiT, VAE38 and UMT5
    (prompt strings, CFG), continuing a one-frame clip to 9 frames; the
    clip's latent stays pinned in frame 0."""
    from PIL import Image

    from fairygen_tpu_torch.pipelines import wan_video

    (tmp_path / "clip").mkdir()
    Image.fromarray(ckpts["img"]).resize((32, 32)).save(tmp_path / "clip" / "0.png")
    seen = {}
    real = wan_video.WanVideoPipeline._generate_longcat

    def spy(self, context, negative_context, longcat_video, **kw):
        seen.update(frames=len(longcat_video), cfg=negative_context is not None)
        return real(self, context, negative_context, longcat_video, **kw)

    monkeypatch.setattr(wan_video.WanVideoPipeline, "_generate_longcat", spy)
    monkeypatch.setenv("FAIRYGEN_MODEL_HINTS", longcat_ckpt["hints_file"])
    out = tmp_path / "out.mp4"
    rc = wan_inference.main([
        "--device", "cpu", "--model_paths", json.dumps(
            [longcat_ckpt["path"], ckpts["paths"]["vae"], ckpts["paths"]["umt5"]]),
        "--tokenizer_path", ckpts["tokenizer"], "--prompt", "a pig walks", "--height", "32",
        "--width", "32", "--num_frames", "9", "--num_inference_steps", "2",
        "--longcat_video", str(tmp_path / "clip"), "--output", str(out)])
    assert rc == 0 and seen == {"frames": 1, "cfg": True}
    assert len(tvideo.load_video_frames(str(tmp_path / "out.gif"))) == 9


def test_batch_cli_twin_animates_each_shot(ckpts, tmp_path, monkeypatch):
    from PIL import Image

    shots = tmp_path / "shots"
    shots.mkdir()
    for stem, prompt in (("01", "a pig walks"), ("02", "the child runs")):
        Image.fromarray(ckpts["img"]).save(shots / f"{stem}.png")
        (shots / f"{stem}.txt").write_text(prompt)
    Image.fromarray(ckpts["img"]).save(shots / "03.png")  # no prompt: skipped
    monkeypatch.setenv("FAIRYGEN_MODEL_HINTS", ckpts["hints_file"])
    rc = wan_batch_inference.main([
        "--device", "cpu", "--model_paths", json.dumps(list(ckpts["paths"].values())),
        "--tokenizer_path", ckpts["tokenizer"], "--shot_dir", str(shots),
        "--output_dir", str(tmp_path / "out"), "--height", "32", "--width", "32",
        "--num_frames", "5", "--num_inference_steps", "1"])
    assert rc == 0 and sorted(os.listdir(tmp_path / "out")) == ["01.gif", "02.gif"]
