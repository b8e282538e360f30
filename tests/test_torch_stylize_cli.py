"""FairyGen's stylization front end on the port, end to end on the CPU: the
CLIP tokenizer wrapper and the SDXL pipeline's string prompts against the
JAX package, then the CLI twins (``fairygen_tpu_torch.tools.create_mask``,
``.examples.dora_train``, ``.examples.brushnet_stylize`` and
``.examples.fairygen_story``) on tiny checkpoints written by the JAX
suite's fixtures (tests/test_product_flow_cli.py: a tiny ISNet, the
brushnet_pipeline goldens' UNet, BrushNet and VAE, tiny CLIP encoders and
char-level tokenizers, FAIRYGEN_CONFIG_OVERRIDES; tiny Wan checkpoints with
FAIRYGEN_MODEL_HINTS), with ``--device cpu``.

The story writes its mask, adapter, shots, staged prompts and clips; the
adapter has the keys and shapes the JAX dora_train CLI writes for the same
UNet and rank.  Prompt embeddings agree with the JAX pipeline's within
1e-5 (fp32, sums in other orders); token ids exactly.
"""
import json
import os

import jax
import numpy as np
import pytest

from fairygen_tpu.core.io import load_state_dict as j_load_state_dict
from fairygen_tpu.core.model_config import override_config as j_override_config
from fairygen_tpu.models.sdxl import clip as jclip
from fairygen_tpu.models.sdxl import unet2d as junet
from fairygen_tpu.pipelines import sdxl_brushnet as jpipe
from fairygen_tpu.training import dora_trainer as jdora
from fairygen_tpu.utils.tokenizer import CLIPTokenizerWrapper as JTokenizer
from fairygen_tpu_torch.core.io import load_state_dict
from fairygen_tpu_torch.examples import brushnet_stylize, dora_train, fairygen_story
from fairygen_tpu_torch.models.sdxl import clip as tclip
from fairygen_tpu_torch.pipelines import sdxl_brushnet as tpipe
from fairygen_tpu_torch.tools import create_mask
from fairygen_tpu_torch.utils.tokenizer import CLIPTokenizerWrapper
from test_product_flow_cli import tiny_story_ckpts, tiny_wan_ckpts  # noqa: F401


def _te_cfgs(ck, module):
    table = json.loads(open(ck["overrides"]).read())
    return (module.CLIPTextConfig(**table["sdxl_te1"]),
            module.CLIPTextConfig(**table["sdxl_te2"]))


@pytest.mark.parametrize("text", ["a drawing", ["a pig in the meadow", ""],
                                  "z" * 120])
def test_clip_tokenizer_matches_jax(tiny_story_ckpts, text):  # noqa: F811
    """77 ids, max-length padding, truncation of a long prompt."""
    ck = tiny_story_ckpts
    got = CLIPTokenizerWrapper(ck["tok1"])(text)
    ref = JTokenizer(ck["tok1"])(text)
    assert got.shape == ref.shape == (1 if isinstance(text, str) else 2, 77)
    np.testing.assert_array_equal(got, ref)


def test_string_prompts_match_the_jax_pipeline(tiny_story_ckpts):  # noqa: F811
    """encode_prompt through both tokenizers and text encoders, a string
    and a list, against the JAX pipeline's; without tokenizers a string
    raises."""
    ck = tiny_story_ckpts
    jc1, jc2 = _te_cfgs(ck, jclip)
    tc1, tc2 = _te_cfgs(ck, tclip)
    sd1, sd2 = j_load_state_dict(ck["te1"]), j_load_state_dict(ck["te2"])
    jp = jpipe.SDXLBrushNetPipeline(
        unet_params=None, unet_cfg=None, vae_params=None, vae_cfg=None,
        te1_params=jclip.convert_clip_text_state_dict(sd1, jc1), te1_cfg=jc1,
        te2_params=jclip.convert_clip_text_state_dict(sd2, jc2), te2_cfg=jc2,
        tokenizer1=JTokenizer(ck["tok1"]), tokenizer2=JTokenizer(ck["tok2"]))
    tp = tpipe.SDXLBrushNetPipeline(
        {}, None, {}, None, te1_params=tclip.convert_clip_text_state_dict(sd1, tc1,
                                                                          device="cpu"),
        te1_cfg=tc1, te2_params=tclip.convert_clip_text_state_dict(sd2, tc2, device="cpu"),
        te2_cfg=tc2, device="cpu", tokenizer1=CLIPTokenizerWrapper(ck["tok1"]),
        tokenizer2=CLIPTokenizerWrapper(ck["tok2"]))
    for prompt in ("a pig in the meadow", ["a drawing", ""]):
        ref_pe, ref_pooled = jp.encode_prompt(prompt)
        pe, pooled = tp.encode_prompt(prompt)
        np.testing.assert_allclose(pe.numpy(), np.asarray(ref_pe), atol=1e-5)
        np.testing.assert_allclose(pooled.numpy(), np.asarray(ref_pooled), atol=1e-5)
    bare = tpipe.SDXLBrushNetPipeline({}, None, {}, None, device="cpu")
    with pytest.raises(ValueError, match="tokenizer1"):
        bare.encode_prompt("a pig")


def _workspace(tmp_path):
    from PIL import Image

    ws = tmp_path / "ws"
    (ws / "prompts").mkdir(parents=True)
    (ws / "motion").mkdir()
    rng = np.random.RandomState(3)
    img = np.full((64, 64, 3), 255, np.uint8)
    img[16:48, 16:48] = rng.randint(0, 128, (32, 32, 3), np.uint8)
    Image.fromarray(img).save(str(ws / "character.png"))
    (ws / "prompts" / "01.txt").write_text("a pig in the meadow")
    (ws / "motion" / "01.txt").write_text("a pig walks")
    return ws


def test_fairygen_story_four_stages(tmp_path, monkeypatch, tiny_story_ckpts,  # noqa: F811
                                    tiny_wan_ckpts):  # noqa: F811
    """mask -> style -> stylize -> animate through the story twin, every
    file it hands from one stage to the next."""
    from PIL import Image

    sk, wk = tiny_story_ckpts, tiny_wan_ckpts
    ws = _workspace(tmp_path)
    monkeypatch.setenv("FAIRYGEN_CONFIG_OVERRIDES", sk["overrides"])
    monkeypatch.setenv("FAIRYGEN_MODEL_HINTS", wk["hints"])
    wan_paths = json.dumps([wk["paths"]["dit"], wk["paths"]["vae"], wk["paths"]["umt5"]])
    rc = fairygen_story.main([
        "--workspace", str(ws), "--stages", "mask,style,stylize,animate",
        "--isnet", sk["isnet"], "--mask_infer_size", "64",
        "--sdxl_unet", sk["unet"], "--sdxl_vae", sk["vae"],
        "--sdxl_te1", sk["te1"], "--sdxl_te2", sk["te2"],
        "--tokenizer1", sk["tok1"], "--tokenizer2", sk["tok2"], "--brushnet", sk["brushnet"],
        "--caption", "a drawing", "--dora_steps", "2", "--dora_rank", "2",
        "--resolution", "64", "--stylize_steps", "2",
        "--wan_model_paths", wan_paths, "--wan_tokenizer", wk["tokenizer"],
        "--height", "32", "--width", "32", "--num_frames", "5", "--steps", "2",
        "--cfg_scale", "1.0", "--device", "cpu"])
    assert rc == 0
    mask = np.asarray(Image.open(ws / "mask.png"))
    assert mask.shape == (64, 64) and set(np.unique(mask)) <= {0, 255}
    dora = load_state_dict(str(ws / "dora" / "pytorch_lora_weights.safetensors"))
    # the JAX dora_train CLI's keys and shapes for the same UNet and rank
    ucfg = j_override_config("sdxl_unet", junet.UNet2DConfig.sdxl_base())
    ref = jdora.sdxl_dora_state_dict(jdora.add_dora_to_sdxl_unet(
        junet.convert_unet2d_state_dict(j_load_state_dict(sk["unet"]), ucfg),
        jax.random.key(0), rank=2))
    assert {k: v.shape for k, v in dora.items()} == {k: v.shape for k, v in ref.items()}
    assert all(v.dtype == np.float32 and np.isfinite(v).all() for v in dora.values())
    assert any(np.abs(v).max() > 0 for k, v in dora.items() if k.endswith("lora_B.weight"))
    shot = Image.open(ws / "shots" / "01.png")
    assert shot.size == (64, 64)
    assert (ws / "shots" / "01.txt").read_text() == "a pig walks"
    clips = [f for f in os.listdir(ws / "clips") if f.startswith("01.")]
    assert clips and os.path.getsize(ws / "clips" / clips[0]) > 0


def test_twins_run_alone_and_refuse_what_is_not_ported(tmp_path, monkeypatch,
                                                       tiny_story_ckpts):  # noqa: F811
    """create_mask and dora_train run alone (SNR-weighted, Adafactor), the
    stylize twin refuses a mesh (exit 2, item 9) and takes the LCM
    scheduler (a 1-step shot), and the story refuses a stage without its
    weights."""
    sk = tiny_story_ckpts
    ws = _workspace(tmp_path)
    monkeypatch.setenv("FAIRYGEN_CONFIG_OVERRIDES", sk["overrides"])
    assert create_mask.main(["--weights", sk["isnet"], "--input", str(ws / "character.png"),
                             "--output", str(ws / "mask.png"), "--infer_size", "64",
                             "--preset", "isnet-general-use", "--device", "cpu"]) == 0
    assert dora_train.main([
        "--unet", sk["unet"], "--vae", sk["vae"], "--te1", sk["te1"], "--te2", sk["te2"],
        "--tokenizer1", sk["tok1"], "--tokenizer2", sk["tok2"],
        "--image", str(ws / "character.png"), "--mask", str(ws / "mask.png"),
        "--caption", "a drawing", "--resolution", "64", "--rank", "2",
        "--max_train_steps", "1", "--snr_gamma", "5.0", "--optimizer", "adafactor",
        "--output_path", str(ws / "dora"), "--device", "cpu"]) == 0
    assert (ws / "dora" / "pytorch_lora_weights.safetensors").exists()
    stylize = ["--unet", sk["unet"], "--vae", sk["vae"], "--te1", sk["te1"], "--te2", sk["te2"],
               "--tokenizer1", sk["tok1"], "--tokenizer2", sk["tok2"],
               "--brushnet", sk["brushnet"], "--image", str(ws / "character.png"),
               "--mask", str(ws / "mask.png"), "--prompt_dir", str(ws / "prompts"),
               "--output_dir", str(ws / "shots"), "--size", "64", "--steps", "1",
               "--device", "cpu"]
    with pytest.raises(SystemExit) as e:
        brushnet_stylize.main(stylize + ["--mesh_data", "2"])
    assert e.value.code == 2
    assert brushnet_stylize.main(stylize + ["--scheduler", "lcm"]) == 0
    from PIL import Image

    assert Image.open(ws / "shots" / "01.png").size == (64, 64)
    with pytest.raises(SystemExit):
        fairygen_story.main(["--workspace", str(ws), "--stages", "stylize", "--device", "cpu"])
