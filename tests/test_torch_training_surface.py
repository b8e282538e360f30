"""The port's training surface against the JAX package, on the CPU:
Adafactor against optax, the two distillation losses through one step of
``make_wan_distill_train_step`` each, ``remat="offload"``, train-state
save / restore (and the preemption checkpoint), ``ModelLogger``'s options,
and the ``wan_train`` / ``merge_weights`` CLI twins on tiny checkpoints.

Tolerances, fp32: Adafactor's update (after − before) within a relative L2
error of 1e-6 per tensor (both sides round the same fp32 formulas; what is
left is the order of two means and rsqrt against pow(−½)); a distill step's
loss and each LoRA tensor's update within 1e-4 relative (the SFT step's
tolerance, tests/test_torch_train_step.py, is 1e-3 for K3's plain version
against the JAX eager chain; these steps use a head dim other than 128, so
both sides run the same plain chain and differ by summation order only).
Offload, resume and the checkpoint files: equal, bit for bit.
"""
import json
import os
import pathlib
import runpy
import signal
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from fairygen_tpu.models import adapters as jad
from fairygen_tpu.models.wan import dit as jdit
from fairygen_tpu.training import runner as jrunner
from fairygen_tpu.training.optimizers import make_optimizer as j_make_optimizer
from fairygen_tpu.training.train_step import make_wan_distill_train_step as j_make_distill
from fairygen_tpu_torch import convert
from fairygen_tpu_torch.core import io as tio
from fairygen_tpu_torch.models import adapters as tad
from fairygen_tpu_torch.models.wan import dit as tdit
from fairygen_tpu_torch.training import runner
from fairygen_tpu_torch.training.optimizers import Adafactor, make_optimizer
from fairygen_tpu_torch.training.train_step import (make_wan_distill_train_step,
                                                    make_wan_sft_train_step)

REPO = pathlib.Path(__file__).resolve().parent.parent
# head dim 32: the plain attention chain on both sides
TINY = dict(dim=64, in_dim=8, ffn_dim=128, out_dim=8, text_dim=32, freq_dim=32,
            patch_size=(1, 2, 2), num_heads=2, num_layers=2, seperated_timestep=True,
            require_clip_embedding=False, require_vae_embedding=False,
            fuse_vae_embedding_in_latents=True)


def _t(a):
    return torch.from_numpy(np.array(a))


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


# ------------------------------------------------------------- Adafactor
@pytest.mark.parametrize("clip", [None, 0.05])
def test_adafactor_matches_optax(clip):
    """A factored leaf (256 x 384), a LoRA-shaped unfactored one (160 x 32:
    its smaller dim is under 128) and a vector, three updates, with and
    without the global-norm clip before it."""
    assert Adafactor(1e-2).factored_dims((256, 384)) == (0, 1)
    assert Adafactor(1e-2).factored_dims((3072, 32)) is None  # a rank-32 LoRA A
    rng = np.random.default_rng(0)
    ps = [rng.standard_normal(s).astype(np.float32) for s in ((256, 384), (160, 32), (7,))]
    gs = [[rng.standard_normal(p.shape).astype(np.float32) * 0.1 for p in ps] for _ in range(3)]
    jtx = j_make_optimizer("adafactor", 1e-2, 0.01, clip)
    jp = [jnp.asarray(p) for p in ps]
    jstate = jtx.init(jp)
    jupdate = jax.jit(jtx.update)
    opt = make_optimizer("adafactor", 1e-2, 0.01, clip)
    tp = [_t(p) for p in ps]
    state = opt.init(tp)
    assert [v is None for v in state["v"]] == [True, False, False]
    for g in gs:
        upd, jstate = jupdate([jnp.asarray(x) for x in g], jstate, jp)
        jp = optax.apply_updates(jp, upd)
        state = opt.update(tp, [_t(x) for x in g], state)
    for a, b, p0 in zip(tp, jp, ps):
        assert _rel(a.numpy() - p0, np.asarray(b) - p0) <= 1e-6


# ------------------------------------------------------------ distillation
def _tiny_problem(seed=0):
    """A tiny LoRA DiT's JAX tree with numpy leaves (dense and A weights
    N(0, 1/fan_in), norms 1 ± 0.05, biases and B N(0, 0.05²)), its base
    tree without adapters (the teacher), latents, context and noise."""
    jcfg = jdit.WanDiTConfig(**TINY)
    shapes = jax.eval_shape(lambda k: jad.add_lora_to_wan_dit(
        jdit.init_dit_params(k, jcfg), k, rank=4), jax.random.key(seed))
    rng = np.random.default_rng(seed)

    def fill(path, sd):
        names = [getattr(x, "key", None) for x in path]
        shape, last = sd.shape, names[-1]
        if last == "scale":
            return np.ones(shape, np.float32)
        if any("norm" in str(n) for n in names):
            a = 1.0 + 0.05 * rng.standard_normal(shape)
        elif last == "modulation":
            a = rng.standard_normal(shape) * jcfg.dim ** -0.5
        elif last in ("w", "A"):
            a = rng.standard_normal(shape) * shape[-2] ** -0.5
        else:
            a = 0.05 * rng.standard_normal(shape)
        return a.astype(np.float32)

    jp = jax.tree_util.tree_map_with_path(fill, shapes)

    def drop_lora(node):
        if not isinstance(node, dict):
            return node
        return {k: drop_lora(v) for k, v in node.items() if k != "lora"}

    teacher = drop_lora(jp)
    lat = rng.standard_normal((1, 8, 3, 4, 6)).astype(np.float32)
    ctx = rng.standard_normal((1, 9, 32)).astype(np.float32)
    noise = rng.standard_normal(lat.shape).astype(np.float32)
    return jcfg, jp, teacher, lat, ctx, noise


def _lora_leaves_jax(tree):
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        names = tuple(getattr(x, "key", None) for x in path)
        if "lora" in names and names[-1] in ("A", "B"):
            for i in range(leaf.shape[0]):
                out[(names[0], i) + names[1:]] = np.asarray(leaf[i], np.float64)
    return out


def _perceptual(a, b):
    return jnp.mean((a - b) ** 2) if isinstance(a, jax.Array) else torch.mean((a - b) ** 2)


@pytest.mark.parametrize("method", ["direct", "trajectory"])
def test_distill_step_matches_jax(method):
    """One ``make_wan_distill_train_step`` step (SGD, lr 1, so the update is
    the gradient) of the tiny LoRA DiT in both packages on the same noise:
    "direct" rolls the student out over 4 steps with gradients through all
    of them; "trajectory" matches 2 student steps to a 6-step teacher
    rollout, with a perceptual term (the decode is the identity) that adds
    its value and no gradient."""
    jcfg, jp, teacher, lat, ctx, noise = _tiny_problem(seed=1 if method == "direct" else 2)
    kw = dict(method=method, num_inference_steps=4 if method == "direct" else 2,
              num_teacher_steps=6, remat=True)
    if method == "trajectory":
        kw.update(perceptual_fn=_perceptual, decode_fn=lambda x: x)
    key = jax.random.key(7)
    jinit, jstep = j_make_distill(jcfg, j_make_optimizer("sgd", 1.0),
                                  trainable_filter=jad.lora_trainable_filter(), **kw)
    jbatch = {"latents": jnp.asarray(lat), "context": jnp.asarray(ctx)}
    if method == "trajectory":
        jbatch["noise"] = jnp.asarray(noise)
        jstate, jloss = jstep(jinit(jax.tree.map(jnp.asarray, jp)), jbatch, key,
                              teacher_params=jax.tree.map(jnp.asarray, teacher))
    else:
        jstate, jloss = jstep(jinit(jax.tree.map(jnp.asarray, jp)), jbatch, key)
        noise = np.asarray(jax.random.normal(key, lat.shape, jnp.float32))

    init, step = make_wan_distill_train_step(tdit.WanDiTConfig(**TINY), make_optimizer("sgd", 1.0),
                                             trainable_filter=tad.lora_trainable_filter(),
                                             device="cpu", **kw)
    state = init(convert.from_jax_params(jp, device="cpu"))
    before = {p: t.detach().clone().double().numpy() for p, t in zip(state.paths, state.trainable)}
    batch = {"latents": _t(lat), "context": _t(ctx)}
    extra = {}
    if method == "trajectory":
        extra["teacher_params"] = convert.from_jax_params(teacher, device="cpu")
    state, loss = step(state, batch, noise=_t(noise), **extra)
    assert abs(float(loss) - float(jloss)) <= 1e-4 * abs(float(jloss))
    jbefore, jafter = _lora_leaves_jax(jp), _lora_leaves_jax(jstate.params)
    assert set(before) == set(jbefore) and len(before) == 2 * 10 * 2
    for p, t in zip(state.paths, state.trainable):
        upd = t.detach().double().numpy() - before[p]
        assert _rel(upd, jafter[p] - jbefore[p]) <= 1e-4, p


def test_trajectory_perceptual_term_adds_value_not_gradient():
    _, jp, teacher, lat, ctx, noise = _tiny_problem(seed=3)
    cfg = tdit.WanDiTConfig(**TINY)
    batch = {"latents": _t(lat), "context": _t(ctx), "noise": _t(noise)}
    out = []
    for extra in ({}, dict(perceptual_fn=_perceptual, decode_fn=lambda x: 2 * x)):
        init, step = make_wan_distill_train_step(cfg, make_optimizer("sgd", 1.0),
                                                 method="trajectory", num_inference_steps=2,
                                                 num_teacher_steps=4, device="cpu",
                                                 trainable_filter=tad.lora_trainable_filter(),
                                                 **extra)
        out.append(step.loss_and_grads(init(convert.from_jax_params(jp, device="cpu")), batch,
                                       teacher_params=convert.from_jax_params(teacher,
                                                                              device="cpu")))
    assert float(out[1][0]) > float(out[0][0])
    for p in out[0][1]:
        assert torch.equal(out[0][1][p], out[1][1][p]), p


# ---------------------------------------------------------------- offload
def test_offload_gives_the_remat_gradients(monkeypatch):
    """remat="offload": the checkpoint's saved carry of each block goes
    through the hooks (one per block and forward), and the loss and every
    gradient equal remat=True's bit for bit."""
    _, jp, _, lat, ctx, _ = _tiny_problem(seed=4)
    cfg = tdit.WanDiTConfig(**TINY)
    parked = []

    class Counting(tdit.offload_saved_carry):
        def __exit__(self, *exc):
            parked.append(self.parked)
            return super().__exit__(*exc)

    monkeypatch.setattr(tdit, "offload_saved_carry", Counting)
    batch = {"latents": _t(lat), "context": _t(ctx)}
    noise = torch.randn(lat.shape, generator=torch.Generator().manual_seed(0))
    out = []
    for remat in (True, "offload"):
        init, step = make_wan_sft_train_step(cfg, make_optimizer(), remat=remat,
                                             trainable_filter=tad.lora_trainable_filter(),
                                             device="cpu")
        out.append(step.loss_and_grads(init(convert.from_jax_params(jp, device="cpu")), batch,
                                       index=321, noise=noise))
    assert parked == [1] * cfg.num_layers
    assert torch.equal(out[0][0], out[1][0])
    for k in out[0][1]:
        assert torch.equal(out[0][1][k], out[1][1][k]), k


def test_offload_leaves_no_carry_alive_between_forward_and_backward(monkeypatch):
    """After the forward pass, remat=True keeps every block's input alive
    for the backward; remat="offload" keeps none of them (their copies
    wait in host memory), and the backward still runs."""
    import weakref

    _, jp, _, lat, ctx, _ = _tiny_problem(seed=4)
    cfg = tdit.WanDiTConfig(**TINY)
    carries = []
    checkpoint = tdit.checkpoint

    def watched(fn, p, x, *args, **kw):
        carries.append(weakref.ref(x))
        return checkpoint(fn, p, x, *args, **kw)

    monkeypatch.setattr(tdit, "checkpoint", watched)
    params = convert.from_jax_params(jp, device="cpu")
    for _, leaf in tad.leaves_with_path(params):
        if isinstance(leaf, torch.Tensor):
            leaf.requires_grad_(True)
    alive = {}
    for remat in (True, "offload"):
        carries.clear()
        out = tdit.wan_dit_forward(params, cfg, _t(lat), torch.tensor([500.0]), _t(ctx),
                                   fuse_vae_embedding_in_latents=True, remat=remat)
        alive[remat] = sum(r() is not None for r in carries)
        out.float().square().mean().backward()
    assert alive == {True: cfg.num_layers, "offload": 0}


# ------------------------------------------------ train state and preemption
def _sft(optimizer_name, seed=5):
    cfg = tdit.WanDiTConfig(**TINY)
    base = convert.init_dit_params(cfg, "cpu", torch.float32, seed=seed)
    params = tad.add_lora_to_wan_dit(base, torch.Generator().manual_seed(seed), rank=4)
    init, step = make_wan_sft_train_step(cfg, make_optimizer(optimizer_name, 1e-3, 0.01),
                                         trainable_filter=tad.lora_trainable_filter(),
                                         lora_b_dropout=("B", 0.8), device="cpu")
    return init(params), step


def _data(n=3):
    g = torch.Generator().manual_seed(11)
    return [{"latents": torch.randn(1, 8, 2, 4, 4, generator=g),
             "context": torch.randn(1, 5, 32, generator=g)} for _ in range(n)]


@pytest.mark.parametrize("optimizer_name", ["adamw", "adafactor"])
def test_preempted_and_resumed_run_equals_the_straight_run(tmp_path, optimizer_name):
    """Three steps straight against: a run that gets SIGTERM while loading
    its second sample, saves its train state (and the generator's) at the
    step boundary and returns after two steps, then a fresh state restored
    from that file and one more step.  The adapters, bit for bit."""
    data = _data()
    state, step = _sft(optimizer_name)
    g = torch.Generator().manual_seed(3)
    state = runner.launch_training_task(state, step, data, lambda s: s, generator=g,
                                        num_workers=0, device="cpu")
    straight = [t.detach().clone() for t in state.trainable]

    calls = []

    def collate(s):  # SIGTERM arrives: the handler the guard installed runs
        calls.append(1)
        if len(calls) == 2:
            signal.getsignal(signal.SIGTERM)(signal.SIGTERM, None)
        return s

    ckpt = str(tmp_path / "preempt.pt")
    handler = signal.getsignal(signal.SIGTERM)
    state, step = _sft(optimizer_name)
    g = torch.Generator().manual_seed(3)
    state = runner.launch_training_task(state, step, data, collate, generator=g,
                                        num_workers=0, preemption_checkpoint=ckpt,
                                        device="cpu")
    assert state.step == 2 and os.path.exists(ckpt)
    assert signal.getsignal(signal.SIGTERM) is handler  # restored

    state, step = _sft(optimizer_name)
    g = torch.Generator().manual_seed(99)  # restored from the file
    state = runner.restore_train_state(ckpt, state, g)
    assert state.step == 2
    state = runner.launch_training_task(state, step, data[2:], lambda s: s, generator=g,
                                        num_workers=0, device="cpu")
    for a, b in zip(state.trainable, straight):
        assert torch.equal(a, b)


def test_restore_refuses_another_states_file(tmp_path):
    state, _ = _sft("adamw")
    runner.save_train_state(str(tmp_path / "s.pt"), state)
    cfg = tdit.WanDiTConfig(**TINY)
    other = tad.add_lora_to_wan_dit(convert.init_dit_params(cfg, "cpu", torch.float32),
                                    torch.Generator().manual_seed(0), rank=4,
                                    targets=("q", "k"))
    init, _ = make_wan_sft_train_step(cfg, make_optimizer(), device="cpu",
                                      trainable_filter=tad.lora_trainable_filter())
    with pytest.raises(ValueError, match="not this state's"):
        runner.restore_train_state(str(tmp_path / "s.pt"), init(other))


def test_global_batch_size_stacks_samples_on_the_leading_axis():
    seen = []

    def step(state, batch, generator):
        seen.append(batch["latents"].shape[0])
        state.step += 1
        return state, torch.zeros(())

    class State:
        step = 0
        params = None

    runner.launch_training_task(State(), step, _data(5), lambda s: s, global_batch_size=2,
                                num_workers=2, device="cpu")
    assert seen == [2, 2]  # the last, partial group is dropped


# ---------------------------------------------------------------- logger
@pytest.mark.parametrize("prefix,remove,include_b2,async_save", [
    ("", None, True, False), ("pipe.dit.", "pipe.dit.", True, True),
    ("pipe.dit.", None, False, True), ("x.", "pipe.dit.", True, False)])
def test_model_logger_writes_the_jax_loggers_file(tmp_path, prefix, remove, include_b2,
                                                  async_save):
    """The same safetensors file, byte for byte, as the JAX ModelLogger with
    the same prefix / remove_prefix_in_ckpt / include_b2; async or not."""
    jcfg = jdit.WanDiTConfig(**TINY)
    shapes = jax.eval_shape(lambda k: jad.add_lora_to_wan_dit(
        jdit.init_dit_params(k, jcfg), k, rank=4, with_b2=True), jax.random.key(0))
    rng = np.random.default_rng(0)
    jp = jax.tree.map(lambda x: rng.standard_normal(x.shape).astype(np.float32), shapes)

    def jfn(p):
        return jrunner.wan_lora_state_dict(p, prefix=prefix, include_b2=include_b2)

    def tfn(p):
        return runner.wan_lora_state_dict(p, prefix=prefix, include_b2=include_b2)

    jrunner.ModelLogger(str(tmp_path / "jax"), remove_prefix_in_ckpt=remove,
                        state_dict_fn=jfn).save(jp, "a.safetensors")
    logger = runner.ModelLogger(str(tmp_path / "port"), remove_prefix_in_ckpt=remove,
                                state_dict_fn=tfn, async_save=async_save)
    params = convert.from_jax_params(jp, device="cpu")
    logger.save(params, "a.safetensors")
    if async_save:  # the next step's in-place update must not reach the file
        for _, t in tad.leaves_with_path(params):
            if isinstance(t, torch.Tensor):
                t.add_(1.0)
    logger.flush()
    want = (tmp_path / "jax" / "a.safetensors").read_bytes()
    assert (tmp_path / "port" / "a.safetensors").read_bytes() == want
    keys = tio.load_safetensors(str(tmp_path / "port" / "a.safetensors")).keys()
    assert len(keys) == (3 if include_b2 else 2) * 10 * 2
    assert all(k.startswith("blocks.") for k in keys) == (remove == prefix or prefix == "")


def test_async_logger_reraises_a_failed_write(tmp_path):
    def bad(params):
        return {"x": object()}

    logger = runner.ModelLogger(str(tmp_path), state_dict_fn=bad, async_save=True)
    logger.save({}, "a.safetensors")
    with pytest.raises(ValueError):
        logger.flush()


# ------------------------------------------------------------- CLI twins
@pytest.fixture(scope="module")
def tiny_ckpts(tmp_path_factory, goldens):
    """The TI2V DiT and VAE38 of tests/goldens/wan_pipeline.npz and UMT5 of
    umt5.npz as upstream-layout safetensors, their hints file, an offline
    tokenizer, and a dataset of one 5-frame 32x32 GIF with a prompt."""
    from PIL import Image

    from tests.test_torch_wan_entry import DIT_EXTRA, TE_EXTRA, VAE_EXTRA, _write_tokenizer

    tmp = tmp_path_factory.mktemp("train_ckpts")
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
    data = tmp / "data"
    data.mkdir()
    rng = np.random.default_rng(0)
    frames = [Image.fromarray(rng.integers(0, 256, (32, 32, 3), dtype=np.uint8))
              for _ in range(5)]
    frames[0].save(data / "clip.gif", save_all=True, append_images=frames[1:])
    (data / "metadata.csv").write_text("video,prompt\nclip.gif,a pig walks in the meadow\n")
    return dict(paths=paths, hints_file=str(tmp / "hints.json"),
                tokenizer=_write_tokenizer(tmp / "tokenizer"), data=str(data))


def _train(ckpts, out, *extra):
    from fairygen_tpu_torch.examples import wan_train

    return wan_train.main([
        "--device", "cpu", "--model_paths", json.dumps(list(ckpts["paths"].values())),
        "--tokenizer_path", ckpts["tokenizer"], "--dataset_base_path", ckpts["data"],
        "--dataset_metadata_path", os.path.join(ckpts["data"], "metadata.csv"),
        "--height", "32", "--width", "32", "--num_frames", "5", "--lora_rank", "4",
        "--extra_inputs", "input_image", "--learning_rate", "1e-2",
        "--output_path", str(out)] + list(extra))


def _lora(path, which):
    return {k: v for k, v in tio.load_safetensors(str(path)).items()
            if k.split(".")[-2 if which == "B2" else -3] == f"lora_{which}"}


def test_wan_train_twin_two_stages_merge_and_two_phase(tiny_ckpts, tmp_path, monkeypatch):
    """Stage 1 (A, B), stage 2 through --lora_checkpoint (only B2 moves),
    the merge twin byte-equal to the JAX CLI, sft:data_process -> sft:train
    with Adafactor, offload, async checkpoints and a step checkpoint, and
    direct_distill, all with --device cpu."""
    monkeypatch.setenv("FAIRYGEN_MODEL_HINTS", tiny_ckpts["hints_file"])
    assert _train(tiny_ckpts, tmp_path / "s1", "--dataset_repeat", "2") == 0
    s1 = tmp_path / "s1" / "epoch-0.safetensors"
    a1, b1 = _lora(s1, "A"), _lora(s1, "B")
    assert len(a1) == len(b1) == 2 * 10 and all(np.abs(v).sum() > 0 for v in b1.values())
    assert not _lora(s1, "B2")

    assert _train(tiny_ckpts, tmp_path / "s2", "--lora_checkpoint", str(s1)) == 0
    s2 = tmp_path / "s2" / "epoch-0.safetensors"
    assert all(np.array_equal(v, a1[k]) for k, v in _lora(s2, "A").items())
    assert all(np.array_equal(v, b1[k]) for k, v in _lora(s2, "B").items())
    b2 = _lora(s2, "B2")
    assert len(b2) == 2 * 10 and any(np.abs(v).sum() > 0 for v in b2.values())

    from fairygen_tpu_torch.examples import merge_weights

    args = ["--stage1", str(s1), "--stage2", str(s2)]
    assert merge_weights.main(args + ["--output", str(tmp_path / "m.safetensors")]) == 0
    jax_cli = runpy.run_path(str(REPO / "examples" / "merge_weights.py"), run_name="merge")
    monkeypatch.setattr(sys, "argv", ["merge"] + args + ["--output",
                                                         str(tmp_path / "mj.safetensors")])
    jax_cli["main"]()
    assert (tmp_path / "m.safetensors").read_bytes() == (tmp_path / "mj.safetensors").read_bytes()

    cache = tmp_path / "cache"
    assert _train(tiny_ckpts, cache, "--task", "sft:data_process", "--dataset_repeat", "2") == 0
    assert sorted(os.listdir(cache)) == ["0-0.npz", "0-1.npz"]
    with np.load(cache / "0-0.npz") as z:
        assert sorted(z.files) == ["context", "latents"]
        assert z["latents"].dtype == np.float32 and z["latents"].shape == (1, 4, 2, 2, 2)
    common = ["--task", "sft:train", "--optimizer", "adafactor",
              "--use_gradient_checkpointing_offload", "--async_checkpoint", "--save_steps", "1"]
    assert _train({**tiny_ckpts, "data": str(cache)}, tmp_path / "t", *common) == 0
    assert sorted(os.listdir(tmp_path / "t")) == ["epoch-0.safetensors", "step-1.safetensors",
                                                 "step-2.safetensors"]
    assert any(np.abs(v).sum() > 0 for v in _lora(tmp_path / "t" / "epoch-0.safetensors",
                                                  "B").values())

    assert _train(tiny_ckpts, tmp_path / "d", "--task", "direct_distill",
                  "--distill_steps", "2") == 0
    assert any(np.abs(v).sum() > 0 for v in _lora(tmp_path / "d" / "epoch-0.safetensors",
                                                  "B").values())


@pytest.mark.parametrize("flag", [["--mesh_data", "2"], ["--mesh_seq", "2"],
                                  ["--mesh_pipe", "2"], ["--fsdp"],
                                  ["--pp_microbatches", "2"]])
def test_wan_train_twin_refuses_parallel_training(flag, capsys):
    from fairygen_tpu_torch.examples import wan_train

    with pytest.raises(SystemExit) as e:
        wan_train.main(["--dataset_base_path", ".", "--device", "cpu"] + flag)
    assert e.value.code == 2 and "item 9" in capsys.readouterr().err


def test_wan_train_twin_keeps_the_jax_flags():
    """The JAX CLI's flags (training/parsers.py), with their defaults and
    choices, plus --device."""
    import argparse

    from fairygen_tpu.training.parsers import add_general_config, add_video_size_config
    from fairygen_tpu_torch.examples import wan_train

    def flags(p):
        return {a.dest: (a.default, a.choices, a.option_strings) for a in p._actions}

    ours = flags(wan_train.parser())
    assert ours.pop("device")[0] == "cuda"
    assert ours == flags(add_video_size_config(add_general_config(argparse.ArgumentParser())))
