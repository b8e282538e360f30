"""The port's speech-to-video path against the JAX package, in fp32 on the
CPU: the S2V DiT and its frame packer against the wan_s2v golden at the
JAX suite's tolerances (tests/test_wan_s2v.py) and against the JAX
modules, the audio bucket helpers, wav2vec's 25 hidden states against the
JAX ``wav2vec2_all_hidden_states`` on the same tiny weights, the
converters bit for bit the JAX converters + ``from_jax_params``,
``load_wav``, and the S2V request from a waveform
with and without a 73-frame motion video against the JAX pipeline; then
``from_pretrained`` and the CLI twin on tiny safetensors and a wav file.

Weights: the golden's S2V state dict, a seeded transformers-layout wav2vec
state dict of hidden width 8 (the golden's audio_dim) with 24 layers, a
seeded tiny Wan2.1 VAE with 16 latent channels (the S2V DiT's), UMT5's
golden.
Module outputs are held to 1e-5 of the JAX package's (the S2V forward,
whose 2 blocks sum longer products, to 2e-5), requests to 1e-4.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fairygen_tpu.models.wan import s2v as js2v
from fairygen_tpu.models.wan import vae as jvae
from fairygen_tpu.models.wan import wav2vec as jw2v
from fairygen_tpu.pipelines.wan_video import WanVideoPipeline as JPipeline
from fairygen_tpu.utils import video as jvideo
from fairygen_tpu_torch import convert
from fairygen_tpu_torch.core import io as tio
from fairygen_tpu_torch.examples import wan_inference
from fairygen_tpu_torch.models.adapters import leaves_with_path
from fairygen_tpu_torch.models.wan import s2v as ts2v
from fairygen_tpu_torch.models.wan import vae as tvae
from fairygen_tpu_torch.models.wan import wav2vec as tw2v
from fairygen_tpu_torch.pipelines.wan_video import WanVideoPipeline
from fairygen_tpu_torch.utils import video as tvideo
from test_torch_wan_entry import TE_EXTRA, _write_tokenizer

ATOL = 1e-5
REQ_ATOL = 1e-4
S2V = dict(dim=96, in_dim=16, ffn_dim=128, out_dim=16, text_dim=32, freq_dim=32,
           patch_size=(1, 2, 2), num_heads=4, num_layers=2, cond_dim=16, audio_dim=8,
           num_audio_token=2, enable_adain=True, audio_inject_layers=(0, 1))
W2V = dict(conv_dim=(8, 8), conv_kernel=(3, 3), conv_stride=(2, 2), hidden_size=8,
           num_hidden_layers=24, num_attention_heads=2, intermediate_size=16,
           num_conv_pos_embeddings=6, num_conv_pos_embedding_groups=2)
VAE = dict(dim=8, z_dim=16, dec_dim=8, num_res_blocks=1, patch_size=1, arch="v1")
H = W = 64
FRAMES = 13


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this file's tests, restored after (tiny
    shapes; under the suite's six workers torch's thread pools contend)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _sd(g, prefix):
    n = len(prefix) + 2
    return {k[n:]: g[k] for k in g.files if k.startswith(prefix + "::")}


def _assert_same_tree(got, ref):
    got, ref = dict(leaves_with_path(got)), dict(leaves_with_path(ref))
    assert sorted(got) == sorted(ref)
    for k in ref:
        np.testing.assert_array_equal(got[k].numpy(), ref[k].numpy(), err_msg=str(k))


def _wav2vec_sd(seed=0):
    """A seeded transformers-layout (``Wav2Vec2ForCTC``) state dict of W2V's
    shape, its position conv weight-normed (``weight_g`` / ``weight_v``)."""
    rng = np.random.default_rng(seed)
    sd, cin = {}, 1

    def put(name, *shape, scale=0.1):
        sd["wav2vec2." + name] = (scale * rng.standard_normal(shape)).astype(np.float32)

    def dense(name, din, dout):
        put(name + ".weight", dout, din, scale=din ** -0.5)
        put(name + ".bias", dout, scale=0.02)

    def ln(name, d):
        sd[f"wav2vec2.{name}.weight"] = (1 + 0.1 * rng.standard_normal(d)).astype(np.float32)
        put(name + ".bias", d, scale=0.02)

    for i, (cout, k) in enumerate(zip(W2V["conv_dim"], W2V["conv_kernel"])):
        put(f"feature_extractor.conv_layers.{i}.conv.weight", cout, cin, k, scale=0.3)
        put(f"feature_extractor.conv_layers.{i}.conv.bias", cout, scale=0.02)
        ln(f"feature_extractor.conv_layers.{i}.layer_norm", cout)
        cin = cout
    h, f, k = W2V["hidden_size"], W2V["intermediate_size"], W2V["num_conv_pos_embeddings"]
    ln("feature_projection.layer_norm", cin)
    dense("feature_projection.projection", cin, h)
    put("encoder.pos_conv_embed.conv.weight_g", 1, 1, k, scale=1.0)
    put("encoder.pos_conv_embed.conv.weight_v", h, h // W2V["num_conv_pos_embedding_groups"], k)
    put("encoder.pos_conv_embed.conv.bias", h, scale=0.02)
    for i in range(W2V["num_hidden_layers"]):
        pre = f"encoder.layers.{i}"
        ln(pre + ".layer_norm", h)
        for p in ("q_proj", "k_proj", "v_proj", "out_proj"):
            dense(f"{pre}.attention.{p}", h, h)
        ln(pre + ".final_layer_norm", h)
        dense(pre + ".feed_forward.intermediate_dense", h, f)
        dense(pre + ".feed_forward.output_dense", f, h)
    ln("encoder.layer_norm", h)
    sd["lm_head.weight"] = np.zeros((33, h), np.float32)
    return sd


def _upstream_vae_sd(vae, cfg):
    """An upstream-layout state dict of a port Wan2.1 VAE tree: the keys
    found by running the port's converter over key indices."""
    class KeyIndex(dict):
        def __init__(self):
            super().__init__()
            self.names = []

        def __getitem__(self, key):
            self.names.append(key)
            return np.array(float(len(self.names) - 1))

    index = KeyIndex()
    tree = tvae.convert_vae_v1_state_dict(index, cfg, device="cpu")
    ports = dict(leaves_with_path(vae))
    return {index.names[int(leaf.reshape(-1)[0])]: ports[path].numpy()
            for path, leaf in leaves_with_path(tree)
            if path[0] not in ("latent_mean", "latent_std")}


@pytest.fixture(scope="module")
def models(goldens):
    """Both packages' S2V DiT (the golden), wav2vec (seeded transformers
    weights) and tiny 16-channel Wan2.1 VAE (seeded port init), each from
    one upstream state dict."""
    g = goldens("wan_s2v")
    sd = _sd(g, "sd")
    jcfg, tcfg = js2v.S2VConfig(**S2V), ts2v.S2VConfig(**S2V)
    wsd = _wav2vec_sd()
    jwcfg, twcfg = jw2v.Wav2Vec2Config(**W2V), tw2v.Wav2Vec2Config(**W2V)
    jvcfg, tvcfg = jvae.WanVAEConfig(**VAE), tvae.WanVAEConfig(**VAE)
    vsd = _upstream_vae_sd(convert.init_vae_params(tvcfg, "cpu", torch.float32, seed=3), tvcfg)
    return dict(
        g=g, sd=sd, wsd=wsd, vsd=vsd, jcfg=jcfg, tcfg=tcfg, jwcfg=jwcfg, twcfg=twcfg,
        jvcfg=jvcfg, tvcfg=tvcfg, jp=js2v.convert_s2v_state_dict(sd, jcfg),
        tp=ts2v.convert_s2v_state_dict(sd, tcfg, device="cpu"),
        jw=jw2v.convert_wav2vec2_state_dict(wsd, jwcfg),
        tw=tw2v.convert_wav2vec2_state_dict(wsd, twcfg, device="cpu"),
        jv=jvae.convert_vae_v1_state_dict(vsd, jvcfg),
        tv=tvae.convert_vae_v1_state_dict(vsd, tvcfg, device="cpu"))


# ------------------------------------------------------------------- S2V DiT
def test_s2v_forward_matches_jax_and_golden(models):
    """The golden's request (a motion latent through the frame packer is
    dropped, as upstream's forward leaves ``drop_motion_frames``), and the
    frame packer engaged (``drop_motion_frames=False``) against the JAX
    forward."""
    g, m = models["g"], models
    args = [g["latents"], g["ts"], g["ctx"], g["audio"]]
    kw = dict(motion_latents=g["motion"][None], pose_cond=g["pose"])
    forward = jax.jit(js2v.wan_s2v_forward, static_argnames=("cfg", "drop_motion_frames"))
    for drop in (True, False):
        ref = np.asarray(forward(m["jp"], m["jcfg"], *map(jnp.asarray, args),
                                 drop_motion_frames=drop,
                                 **{k: jnp.asarray(v) for k, v in kw.items()}))
        out = ts2v.wan_s2v_forward(m["tp"], m["tcfg"], *map(_t, args), drop_motion_frames=drop,
                                   **{k: _t(v) for k, v in kw.items()}).numpy()
        assert out.shape == (1, 16, 4, 8, 8)
        np.testing.assert_allclose(out, ref, atol=2 * ATOL, rtol=0)
        if drop:
            np.testing.assert_allclose(out, g["o"], atol=1e-3, rtol=1e-3)


def test_frame_packer_matches_jax_and_golden(goldens):
    g = goldens("wan_s2v")

    def cd(name):
        w = g[f"fp::{name}.weight"]
        return {"w": w.transpose(1, 2, 3, 4, 0).reshape(-1, w.shape[0]), "b": g[f"fp::{name}.bias"]}

    p = {n: cd(n) for n in ("proj", "proj_2x", "proj_4x")}
    jcfg, tcfg = js2v.S2VConfig(dim=96, num_heads=4), ts2v.S2VConfig(dim=96, num_heads=4)
    jmot, jang = js2v.frame_packer_forward(jax.tree.map(jnp.asarray, p), jcfg,
                                           jnp.asarray(g["fp_motion"])[None])
    mot, ang = ts2v.frame_packer_forward(convert.from_jax_params(p, device="cpu"), tcfg,
                                         _t(g["fp_motion"])[None])
    np.testing.assert_array_equal(ang, jang)
    np.testing.assert_allclose(mot.numpy(), np.asarray(jmot), atol=ATOL, rtol=0)
    np.testing.assert_allclose(mot[0].numpy(), g["fp_mot"][0], atol=2e-5, rtol=1e-4)
    freqs = ts2v.angles_to_freqs(ang).numpy()
    np.testing.assert_array_equal(freqs, np.asarray(js2v.angles_to_freqs(jang)))
    np.testing.assert_allclose(freqs, g["fp_remb"][:, 0, :, 0, :], atol=1e-6)


def test_frame_packer_floors_the_4x_patches_as_the_conv_does():
    """At a latent of 12 x 20 (480x832's 60 x 104 the same way) the 4x
    patches cover the first 8 x 16, as upstream's stride-8 Conv3d does; the
    JAX package's reshape takes only multiples of 8, so it is held to the
    JAX patchify of the cropped latents."""
    rng = np.random.default_rng(0)
    w = (0.05 * rng.standard_normal((16 * 4 * 8 * 8, 8))).astype(np.float32)
    x = rng.standard_normal((1, 16, 4, 12, 20)).astype(np.float32)
    p = {"w": w, "b": np.zeros(8, np.float32)}
    out, grid = ts2v._patchify3d(convert.from_jax_params(p, device="cpu"), _t(x), (4, 8, 8))
    ref, jgrid = js2v._patchify3d(jax.tree.map(jnp.asarray, p),
                                  jnp.asarray(x[:, :, :, :8, :16]), (4, 8, 8))
    assert grid == jgrid == (1, 1, 2)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL, rtol=0)


def test_audio_bucket_helpers_match_jax():
    emb = np.random.RandomState(0).randn(3, 100, 8)
    for m in (0, 1):
        a, n = ts2v.get_audio_embed_bucket_fps(emb, fps=16, batch_frames=20, m=m)
        b, jn = js2v.get_audio_embed_bucket_fps(emb, fps=16, batch_frames=20, m=m)
        assert n == jn and a.shape[0] == n * 20
        np.testing.assert_array_equal(a, b)
    feats = np.random.RandomState(1).randn(1, 50, 8)
    np.testing.assert_array_equal(ts2v.linear_interpolation_np(feats, 50, 30),
                                  js2v.linear_interpolation_np(feats, 50, 30))
    np.testing.assert_array_equal(ts2v.rope_grid_angles([((-3, 0, 0), (-1, 2, 3), (2, 4, 6))], 32),
                                  js2v.rope_grid_angles([((-3, 0, 0), (-1, 2, 3), (2, 4, 6))], 32))


# ------------------------------------------------------------------- wav2vec
def test_wav2vec_hidden_states_match_jax(models):
    """The 25 hidden states of a normalized waveform (the JAX package's
    are held to transformers' in tests/test_wav2vec.py), the resample and
    the 30 fps features."""
    x = tw2v.normalize_waveform(np.random.RandomState(7).normal(0, 1, 400).astype(np.float32))
    np.testing.assert_array_equal(x, jw2v.normalize_waveform(
        np.random.RandomState(7).normal(0, 1, 400).astype(np.float32)))
    out = tw2v.wav2vec2_all_hidden_states(models["tw"], models["twcfg"], _t(x)[None]).numpy()
    ref = np.asarray(jw2v.wav2vec2_all_hidden_states(models["jw"], models["jwcfg"],
                                                     jnp.asarray(x)[None]))
    assert out.shape == ref.shape == (25, 1, 99, 8)
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=0)
    wave = np.sin(np.linspace(0, 60, 1600)).astype(np.float32)
    np.testing.assert_array_equal(tw2v.resample_waveform(wave, 32000),
                                  jw2v.resample_waveform(wave, 32000))
    feat = tw2v.extract_audio_feat(models["tw"], models["twcfg"], wave)
    np.testing.assert_allclose(feat, jw2v.extract_audio_feat(models["jw"], models["jwcfg"], wave),
                               atol=ATOL, rtol=0)


@pytest.mark.parametrize("name", ["s2v", "wav2vec", "wav2vec_parametrize"])
def test_converters_match_jax_and_from_jax_params(models, name):
    """The port's S2V and wav2vec converters give the JAX converters'
    arrays through ``from_jax_params``, bit for bit (wav2vec also from the
    parametrize weight-norm keys), and the seeded ``init_*`` the same tree
    (paths and shapes)."""
    if name == "s2v":
        got, ref = models["tp"], models["jp"]
        made = convert.init_s2v_params(models["tcfg"], "cpu", torch.float32)
    else:
        sd = dict(models["wsd"])
        if name == "wav2vec_parametrize":
            pre = "wav2vec2.encoder.pos_conv_embed.conv."
            sd[pre + "parametrizations.weight.original0"] = sd.pop(pre + "weight_g")
            sd[pre + "parametrizations.weight.original1"] = sd.pop(pre + "weight_v")
            sd = {"model." + k: v for k, v in sd.items()}
        got = tw2v.convert_wav2vec2_state_dict(sd, models["twcfg"], device="cpu")
        ref = jw2v.convert_wav2vec2_state_dict(sd, models["jwcfg"])
        made = convert.init_wav2vec2_params(models["twcfg"], "cpu")
    ref = convert.from_jax_params(_np(ref), device="cpu")
    _assert_same_tree(got, ref)
    made, ref = dict(leaves_with_path(made)), dict(leaves_with_path(ref))
    assert sorted(made) == sorted(ref)
    assert all(made[k].shape == ref[k].shape for k in ref)


def test_load_wav_matches_jax(tmp_path):
    import wave

    tone = (np.sin(np.linspace(0, 440 * 2 * np.pi, 800)) * 3e4).astype(np.int16)
    for ch, width in ((1, 2), (2, 2)):
        path = str(tmp_path / f"t{ch}.wav")
        with wave.open(path, "wb") as f:
            f.setnchannels(ch)
            f.setsampwidth(width)
            f.setframerate(16000)
            f.writeframes(np.repeat(tone, ch).tobytes())
        got, ref = tvideo.load_wav(path), jvideo.load_wav(path)
        assert got[1] == ref[1] == 16000
        np.testing.assert_array_equal(got[0], ref[0])


# ------------------------------------------------------------------ requests
def _pipes(models):
    jpipe = JPipeline(dit_params=None, dit_cfg=None, vae_params=models["jv"],
                      vae_cfg=models["jvcfg"], s2v_params=models["jp"], s2v_cfg=models["jcfg"],
                      wav2vec_params=models["jw"], wav2vec_cfg=models["jwcfg"],
                      dtype=jnp.float32)
    pipe = WanVideoPipeline(None, None, models["tv"], models["tvcfg"], dtype=torch.float32,
                            device="cpu", s2v_params=models["tp"], s2v_cfg=models["tcfg"],
                            wav2vec_params=models["tw"], wav2vec_cfg=models["twcfg"])
    return jpipe, pipe


def _frames(n, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (H, W, 3), dtype=np.uint8) for _ in range(n)]


@pytest.mark.parametrize("motion", [False, True])
def test_s2v_request_from_a_waveform_matches_jax(models, motion):
    """input_audio through wav2vec, an input image re-pinned as frame 0,
    CFG 4.5 with zero audio, 2 steps; with a 73-frame motion video its
    latents through the frame packer and stitched in front."""
    jpipe, pipe = _pipes(models)
    rng = np.random.default_rng(1)
    ctx, neg = (rng.standard_normal((1, 7, 32)).astype(np.float32) for _ in range(2))
    wave = np.sin(np.linspace(0, 200 * np.pi, 1600)).astype(np.float32)
    req = dict(input_audio=wave, input_image=_frames(1, 2)[0], seed=5, height=H, width=W,
               num_frames=FRAMES, cfg_scale=4.5, num_inference_steps=2,
               output_type="latents", torch_compat_noise=True)
    if motion:
        req["motion_video"] = _frames(73, 3)
    ref = np.asarray(jpipe(context=jnp.asarray(ctx), negative_context=jnp.asarray(neg), **req))
    out = pipe(context=_t(ctx), negative_context=_t(neg), **req).numpy()
    assert out.shape == ((1, 16, 19 + 3, 8, 8) if motion else (1, 16, 4, 8, 8))
    np.testing.assert_allclose(out, ref, atol=REQ_ATOL, rtol=0)


@pytest.fixture(scope="module")
def ckpts(models, tmp_path_factory, goldens):
    """The S2V DiT, the wav2vec encoder, the VAE and UMT5 as safetensors
    with their hints, a tokenizer and a wav file."""
    import wave

    tmp = tmp_path_factory.mktemp("s2v_ckpts")
    gu = goldens("umt5")
    paths, hints = {}, {}
    s2v_hint = dict(S2V, patch_size=list(S2V["patch_size"]),
                    audio_inject_layers=list(S2V["audio_inject_layers"]))
    w2v_hint = {k: list(v) if isinstance(v, tuple) else v for k, v in W2V.items()}
    for name, sd, role, extra in (
            ("s2v", models["sd"], "wan_video_dit", s2v_hint),
            ("wav2vec", {"model." + k: v for k, v in models["wsd"].items()},
             "wans2v_audio_encoder", w2v_hint),
            ("vae", models["vsd"], "wan_video_vae", VAE),
            ("umt5", _sd(gu, "sd"), "wan_video_text_encoder", TE_EXTRA)):
        paths[name] = str(tmp / f"{name}.safetensors")
        tio.save_safetensors(paths[name], sd)
        hints[paths[name]] = (role, extra)
    (tmp / "hints.json").write_text(json.dumps(hints))
    wav = str(tmp / "voice.wav")
    with wave.open(wav, "wb") as f:
        f.setnchannels(1)
        f.setsampwidth(2)
        f.setframerate(16000)
        f.writeframes((np.sin(np.linspace(0, 200 * np.pi, 1600)) * 2e4).astype(np.int16)
                      .tobytes())
    return dict(paths=paths, hints=hints, hints_file=str(tmp / "hints.json"), wav=wav, tmp=tmp,
                tokenizer=_write_tokenizer(tmp / "tokenizer"))


def test_from_pretrained_builds_s2v_and_wav2vec(models, ckpts):
    """The pool tells the S2V DiT apart by its config and builds wav2vec at
    the hinted size; the pipeline's S2V request equals the directly built
    one's."""
    pipe = WanVideoPipeline.from_pretrained(list(ckpts["paths"].values()), dtype=torch.float32,
                                            hints=ckpts["hints"], device="cpu")
    assert pipe.dit_params is None and isinstance(pipe.s2v_cfg, ts2v.S2VConfig)
    assert isinstance(pipe.wav2vec_cfg, tw2v.Wav2Vec2Config) and pipe.wav2vec_cfg.hidden_size == 8
    _assert_same_tree(pipe.s2v_params, models["tp"])
    _assert_same_tree(pipe.wav2vec_params, models["tw"])
    rng = np.random.default_rng(4)
    ctx = _t(rng.standard_normal((1, 7, 32)).astype(np.float32))
    req = dict(context=ctx, audio_embeds=rng.standard_normal((1, 25, 8, FRAMES - 1)).astype(
        np.float32), seed=2, height=H, width=W, num_frames=FRAMES, cfg_scale=1.0,
        num_inference_steps=1, output_type="latents")
    _, direct = _pipes(models)
    np.testing.assert_array_equal(pipe(**req).numpy(), direct(**req).numpy())


def test_cli_twin_runs_s2v_from_a_wav(ckpts, tmp_path, monkeypatch):
    """The CLI twin with --audio on the tiny checkpoints (hints through
    FAIRYGEN_MODEL_HINTS): the wav through load_wav and wav2vec into the
    S2V request; without ffmpeg the mux fails and a silent clip is saved."""
    from PIL import Image

    first = tmp_path / "first.png"
    Image.fromarray(_frames(1, 8)[0]).save(first)
    monkeypatch.setenv("FAIRYGEN_MODEL_HINTS", ckpts["hints_file"])
    out = tmp_path / "out.mp4"
    rc = wan_inference.main([
        "--device", "cpu", "--model_paths", json.dumps(list(ckpts["paths"].values())),
        "--tokenizer_path", ckpts["tokenizer"], "--prompt", "a pig walks",
        "--input_image", str(first), "--audio", ckpts["wav"], "--height", str(H),
        "--width", str(W), "--num_frames", str(FRAMES), "--num_inference_steps", "1",
        "--cfg_scale", "1.0", "--output", str(out)])
    assert rc == 0
    written = [p for p in os.listdir(tmp_path) if p.startswith("out")]
    assert written, os.listdir(tmp_path)
