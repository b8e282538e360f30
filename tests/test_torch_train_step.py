"""The port's single-card training path (fairygen_tpu_torch.training) against
the JAX package's: the training schedule, the optimizers, and one full
``make_wan_sft_train_step`` step of a tiny head-dim-128 LoRA DiT (2 layers,
2 heads) on the same converted params and the same draws.

The JAX step's key is split as ``flow_match_sft_loss`` splits it, and the
timestep index and noise it draws are handed to the port.  Dropout is off
in that step (``lora_b_dropout=None``); tests/test_torch_adapters.py holds
the dropout transform against the JAX one mask for mask.

Tolerances (fp32): loss 1e-4 relative; LoRA gradients and the AdamW
update of each adapter (after minus before) 1e-3 relative L2.  Both sides run fp32, but the port's forward
takes the K1/K2/K3 plain versions (K3's max-free pad-corrected softmax)
where the JAX package on the CPU runs its eager chain, and the two
frameworks sum in other orders; through two blocks, the flow-matching
residual (prediction minus target) and its gradient keep those
differences at the 1e-5 level, and 1e-3 leaves room for reduction order on
another BLAS without hiding a wrong term.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fairygen_tpu.diffusion.flow_match import FlowMatchScheduler as JScheduler
from fairygen_tpu.models import adapters as jad
from fairygen_tpu.models.wan import dit as jdit
from fairygen_tpu.training import losses as jlosses
from fairygen_tpu.training.optimizers import make_optimizer as j_make_optimizer
from fairygen_tpu.training.train_step import make_wan_sft_train_step as j_make_step
from fairygen_tpu_torch import convert
from fairygen_tpu_torch.diffusion.flow_match import FlowMatchScheduler
from fairygen_tpu_torch.models import adapters as tad
from fairygen_tpu_torch.models.wan import dit as tdit
from fairygen_tpu_torch.training.optimizers import make_optimizer
from fairygen_tpu_torch.training.runner import ModelLogger, launch_training_task
from fairygen_tpu_torch.training.train_step import make_wan_sft_train_step

TINY128 = dict(dim=256, in_dim=8, ffn_dim=512, out_dim=8, text_dim=32, freq_dim=32,
               patch_size=(1, 2, 2), num_heads=2, num_layers=2, seperated_timestep=True,
               require_clip_embedding=False, require_vae_embedding=False,
               fuse_vae_embedding_in_latents=True)


def _t(a):
    return torch.from_numpy(np.array(a))


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def test_training_schedule_matches_goldens(goldens):
    g = goldens("schedulers")
    s = FlowMatchScheduler("Wan").set_timesteps(1000, training=True, shift=5.0)
    np.testing.assert_allclose(s.sigmas, g["fm_wan_train_sigmas"], atol=1e-6)
    np.testing.assert_allclose(s.linear_timesteps_weights, g["fm_wan_train_weights"],
                               atol=2e-6)
    s = FlowMatchScheduler("Wan").set_timesteps(37, training=True, shift=5.0)
    np.testing.assert_allclose(s.linear_timesteps_weights, g["fm_wan37_weights"], atol=2e-6)
    j = JScheduler("Wan").set_timesteps(1000, training=True, shift=5.0)
    np.testing.assert_array_equal(s.training, j.training)


@pytest.mark.parametrize("name,clip", [("adamw", None), ("adamw", 0.05), ("sgd", 0.05),
                                       ("adafactor", None), ("adafactor", 0.05)])
def test_optimizers_match_optax(name, clip):
    import optax

    rng = np.random.default_rng(0)
    ps = [rng.standard_normal(s).astype(np.float32) for s in ((5, 3), (7,))]
    gs = [[rng.standard_normal(p.shape).astype(np.float32) * 0.1 for p in ps] for _ in range(3)]
    jtx = j_make_optimizer(name, 1e-2, 0.01, clip)
    jp = [jnp.asarray(p) for p in ps]
    jstate = jtx.init(jp)
    opt = make_optimizer(name, 1e-2, 0.01, clip)
    tp = [_t(p) for p in ps]
    state = opt.init(tp)
    for g in gs:
        upd, jstate = jtx.update([jnp.asarray(x) for x in g], jstate, jp)
        jp = optax.apply_updates(jp, upd)
        state = opt.update(tp, [_t(x) for x in g], state)
    for a, b in zip(tp, jp):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6, rtol=1e-5)


def test_unported_options_are_refused():
    """Mesh and pipeline training (ROADMAP item 9) are refused by the steps
    and the runner; Adafactor and remat="offload" are ported
    (tests/test_torch_training_surface.py)."""
    cfg = tdit.WanDiTConfig(**TINY128)
    with pytest.raises(NotImplementedError, match="mesh.*item 9"):
        make_wan_sft_train_step(cfg, make_optimizer(), mesh=object(), device="cpu")
    with pytest.raises(NotImplementedError, match="pipeline.*item 9"):
        make_wan_sft_train_step(cfg, make_optimizer(), pp_microbatches=2, device="cpu")
    with pytest.raises(NotImplementedError, match="mesh.*item 9"):
        launch_training_task(None, None, [], None, mesh=object(), device="cpu")
    with pytest.raises(ValueError, match="remat"):
        tdit.wan_dit_forward({}, cfg, torch.zeros(1, 8, 1, 2, 2), torch.zeros(1), remat="host")


def _tiny_lora_problem(seed=0):
    """The JAX tree of a tiny DiT with rank-4 adapters, its leaves drawn
    with numpy (the tree's shapes from jax.eval_shape, which is fast):
    dense and A weights N(0, 1/fan_in), norms 1 ± 0.05, biases and B
    N(0, 0.05²), so every term matters."""
    jcfg = jdit.WanDiTConfig(**TINY128)
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
    lat = rng.standard_normal((1, 8, 3, 4, 6)).astype(np.float32)
    ctx = rng.standard_normal((1, 9, 32)).astype(np.float32)
    return jcfg, jp, lat, ctx


def _lora_leaves_jax(tree):
    """{port path: array} of the LoRA A/B leaves of a stacked JAX tree."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        names = tuple(getattr(x, "key", None) for x in path)
        if "lora" in names and names[-1] in ("A", "B"):
            for i in range(leaf.shape[0]):
                out[(names[0], i) + names[1:]] = np.asarray(leaf[i])
    return out


@pytest.mark.parametrize("part", ["loss_and_grads", "update"])
def test_train_step_matches_jax(part):
    """``loss_and_grads``: the loss and every LoRA gradient against
    jax.grad of the JAX step's loss; ``update``: the loss and the adapters
    after one step of the JAX ``make_wan_sft_train_step`` (AdamW)."""
    jcfg, jp, lat, ctx = _tiny_lora_problem()
    key = jax.random.key(42)
    batch = {"latents": jnp.asarray(lat), "context": jnp.asarray(ctx)}
    jparams = jax.tree.map(jnp.asarray, jp)
    sched = JScheduler("Wan").set_timesteps(1000, training=True, shift=5.0)

    def jloss_fn(p):
        return jlosses.flow_match_sft_loss(
            lambda pp, x, t, c: jdit.wan_dit_forward(pp, jcfg, x, t, c,
                                                     fuse_vae_embedding_in_latents=True,
                                                     remat=True),
            p, batch["latents"], batch["context"], key, sigmas=sched.sigmas,
            timesteps=sched.timesteps, weights=sched.linear_timesteps_weights,
            first_frame_clean=True)

    if part == "update":
        jinit, jstep = j_make_step(jcfg, j_make_optimizer("adamw", 1e-4, 0.01), remat=True,
                                   trainable_filter=jad.lora_trainable_filter())
        jstate, jloss = jstep(jinit(jparams), batch, key)
    else:
        jloss, jgrads = jax.jit(jax.value_and_grad(jloss_fn))(jparams)
        jgrads = _lora_leaves_jax(jgrads)
    # the draws flow_match_sft_loss makes from the step's key
    rng_t, rng_n = jax.random.split(key)
    index = int(jax.random.randint(rng_t, (), 0, 1000))
    noise = _t(jax.random.normal(rng_n, lat.shape, jnp.float32))

    cfg = tdit.WanDiTConfig(**TINY128)
    init, step = make_wan_sft_train_step(cfg, make_optimizer("adamw", 1e-4, 0.01), remat=True,
                                         trainable_filter=tad.lora_trainable_filter(),
                                         device="cpu")
    state = init(convert.from_jax_params(jp, device="cpu"))
    tbatch = {"latents": _t(lat), "context": _t(ctx)}
    if part == "loss_and_grads":
        loss, grads = step.loss_and_grads(state, tbatch, index=index, noise=noise)
        assert abs(float(loss) - float(jloss)) <= 1e-4 * abs(float(jloss))
        assert grads.keys() == jgrads.keys() and len(grads) == 2 * 10 * 2
        assert _rel(np.concatenate([grads[k].numpy().ravel() for k in grads]),
                    np.concatenate([jgrads[k].ravel() for k in grads])) < 1e-3
        for k in grads:
            assert _rel(grads[k].numpy(), jgrads[k]) < 1e-3, k
        return
    before = {p: t.detach().clone().numpy() for p, t in tad.leaves_with_path(state.params)
              if "lora" in p and p[-1] in ("A", "B")}
    state, loss = step(state, tbatch, index=index, noise=noise)
    assert abs(float(loss) - float(jloss)) <= 1e-4 * abs(float(jloss)) and state.step == 1
    # one step at lr 1e-4 moves an entry by ~1e-4, a few thousandths of its
    # size, so the update itself (after - before) is held, not the parameter
    jbefore, jafter = _lora_leaves_jax(jparams), _lora_leaves_jax(jstate.params)
    moved = 0
    for path, t in tad.leaves_with_path(state.params):
        if path in before:
            upd = t.detach().numpy().astype(np.float64) - before[path]
            jupd = jafter[path].astype(np.float64) - jbefore[path]
            assert _rel(upd, jupd) < 1e-3, path
            moved += 1
    assert moved == 2 * 10 * 2


def test_remat_gives_identical_gradients():
    _, jp, lat, ctx = _tiny_lora_problem(seed=3)
    cfg = tdit.WanDiTConfig(**TINY128)
    batch = {"latents": _t(lat), "context": _t(ctx)}
    noise = torch.randn(lat.shape, generator=torch.Generator().manual_seed(0))
    out = []
    for remat in (False, True):
        init, step = make_wan_sft_train_step(cfg, make_optimizer(), remat=remat,
                                             trainable_filter=tad.lora_trainable_filter(),
                                             device="cpu")
        out.append(step.loss_and_grads(init(convert.from_jax_params(jp, device="cpu")), batch,
                                       index=321, noise=noise))
    assert torch.equal(out[0][0], out[1][0])
    for k in out[0][1]:
        assert torch.equal(out[0][1][k], out[1][1][k]), k


def test_stage2_trains_b2_only_and_accumulates(tmp_path):
    """Stage-2 (B2 trainable, dropout 0.5): A and B stay, B2 moves after the
    second of two accumulated steps; base weights are frozen; the runner
    writes trainable-only checkpoints with the lora_B2 keys."""
    cfg = tdit.WanDiTConfig(**TINY128)
    g = torch.Generator().manual_seed(0)
    base = convert.init_dit_params(cfg, "cpu", torch.float32, seed=0)
    params = tad.add_lora_to_wan_dit(base, g, rank=4, with_b2=True)
    for _, t in tad.leaves_with_path(params):
        if isinstance(t, torch.Tensor) and t.dim() == 2 and t.shape[0] == 4:
            t.normal_(generator=g)  # non-zero B and B2
    before = {p: t.clone() for p, t in tad.leaves_with_path(params)
              if isinstance(t, torch.Tensor)}
    init, step = make_wan_sft_train_step(cfg, make_optimizer("adamw", 1e-3, 0.01),
                                         trainable_filter=tad.lora_trainable_filter(("B2",)),
                                         lora_b_dropout=("B2", 0.5),
                                         gradient_accumulation_steps=2, device="cpu")
    state = init(params)
    assert all(p[-1] == "B2" for p in state.paths) and len(state.paths) == 2 * 10
    data = [{"latents": torch.randn(1, 8, 2, 4, 4, generator=g),
             "context": torch.randn(1, 5, 32, generator=g)} for _ in range(2)]
    state = launch_training_task(state, step, data[:1], lambda x: x, generator=g, log_every=1,
                                 device="cpu")
    assert all(torch.equal(t, before[p]) for p, t in tad.leaves_with_path(state.params)
               if isinstance(t, torch.Tensor))  # first micro step: no update
    logger = ModelLogger(str(tmp_path))
    state = launch_training_task(state, step, data[1:], lambda x: x, generator=g,
                                 logger=logger, save_steps=1, device="cpu")
    assert state.step == 2
    for p, t in tad.leaves_with_path(state.params):
        if isinstance(t, torch.Tensor):
            assert torch.equal(t, before[p]) != (p[-1] == "B2"), p
    from fairygen_tpu_torch.core.io import load_safetensors

    sd = load_safetensors(str(tmp_path / "step-2.safetensors"))
    assert len(sd) == 3 * 10 * cfg.num_layers
    assert (tmp_path / "epoch-0.safetensors").exists()
