"""The port's Style-DoRA training path against the JAX package: the DDPM
scheduler (tables, add_noise, get_velocity, snr and the ancestral step,
against JAX and tests/goldens/schedulers.npz), ``masked_mse_loss``, one
``make_sdxl_dora_train_step`` step of the JAX suite's tiny UNet
(tests/test_dora_trainer.py's config on goldens("sdxl_unet")) with and
without min-SNR-γ, the adapter's state dict both ways, and the plain
versions of K6a, K6b and K6c in fp32 at head dim 64 against the Pallas
kernels in interpret mode.

The train step runs on the same converted params and on the draws of the
JAX key, split as the JAX loss splits it.  The JAX step runs once with
optax.sgd(LR): its update is -LR times the gradient, so one compiled step gives
the loss and the A / B / mag gradients; the AdamW update is held against
optax.adamw applied to the port's own gradients (the optimizer compared on
equal input: its first step divides g by |g| + 1e-8, which turns fp32
noise in tiny gradient entries into update noise).  Tolerances (fp32 on both sides,
sums in other orders): the loss 1e-4 relative; gradients and the AdamW
update 1e-3 relative L2 (the Wan step's bounds in test_torch_train_step.py);
the fp32 attention kernels' plain versions 1e-5 relative L2 (no rounding
to a narrower type on either side).
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from fairygen_tpu.diffusion.ddpm import DDPMScheduler as JDDPM
from fairygen_tpu.models.sdxl import unet2d as junet
from fairygen_tpu.ops import flash_attention as jfa
from fairygen_tpu.training import dora_trainer as jdora
from fairygen_tpu.training.optimizers import make_optimizer as j_make_optimizer
from fairygen_tpu_torch.diffusion.ddpm import DDPMScheduler
from fairygen_tpu_torch.models import adapters as tad
from fairygen_tpu_torch.models.sdxl import unet2d as tunet
from fairygen_tpu_torch.ops import flash_attention as tfa
from fairygen_tpu_torch.training import dora_trainer as tdora
from fairygen_tpu_torch.training.optimizers import make_optimizer

UNET_KW = dict(block_out_channels=(32, 64), down_block_types=("DownBlock2D",
                                                              "CrossAttnDownBlock2D"),
               up_block_types=("CrossAttnUpBlock2D", "UpBlock2D"),
               transformer_layers_per_block=(1, 2), num_attention_heads=(2, 4),
               cross_attention_dim=32, norm_num_groups=16, addition_time_embed_dim=8,
               projection_class_embeddings_input_dim=80)


def _t(a):
    return torch.from_numpy(np.array(a))


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


# ------------------------------------------------------------------- DDPM
@pytest.mark.parametrize("schedule", ["scaled_linear", "linear", "squaredcos_cap_v2"])
def test_ddpm_tables_match_jax(schedule):
    j, t = JDDPM(beta_schedule=schedule), DDPMScheduler(beta_schedule=schedule)
    np.testing.assert_array_equal(t.alphas_cumprod, j.alphas_cumprod)
    np.testing.assert_array_equal(t.timesteps, j.timesteps)
    for spacing in ("leading", "linspace", "trailing"):
        j.timestep_spacing = t.timestep_spacing = spacing
        np.testing.assert_array_equal(t.set_timesteps(37).timesteps, j.set_timesteps(37).timesteps)


def test_ddpm_add_noise_velocity_snr_match_goldens_and_jax(goldens):
    g = goldens("schedulers")
    d, j = DDPMScheduler(), JDDPM()
    np.testing.assert_allclose(d.alphas_cumprod, g["ddpm_alphas_cumprod"], rtol=1e-6)
    x0, eps, t = _t(g["ddpm_x0"]), _t(g["ddpm_eps"]), _t(g["ddpm_t"])
    np.testing.assert_allclose(d.add_noise(x0, eps, t).numpy(), g["ddpm_noisy"], atol=1e-5)
    np.testing.assert_allclose(d.get_velocity(x0, eps, t).numpy(), g["ddpm_velocity"],
                               atol=1e-5)
    jt = jnp.asarray(g["ddpm_t"])
    np.testing.assert_allclose(d.add_noise(x0, eps, t).numpy(),
                               np.asarray(j.add_noise(jnp.asarray(x0), jnp.asarray(eps), jt)),
                               atol=1e-6)
    ts = np.array([0, 1, 250, 613, 999])
    np.testing.assert_allclose(d.snr(_t(ts)).numpy(), np.asarray(j.snr(jnp.asarray(ts))),
                               rtol=1e-6)


@pytest.mark.parametrize("prediction_type", ["epsilon", "v_prediction", "sample"])
def test_ddpm_step_matches_jax(prediction_type):
    rng = np.random.default_rng(5)
    out, x, noise = (rng.standard_normal((1, 4, 8, 8)).astype(np.float32) for _ in range(3))
    d = DDPMScheduler(prediction_type=prediction_type).set_timesteps(20)
    j = JDDPM(prediction_type=prediction_type).set_timesteps(20)
    for t in (int(d.timesteps[0]), int(d.timesteps[-1])):  # the last step adds no noise
        ref = j.step(jnp.asarray(out), t, jnp.asarray(x), noise=jnp.asarray(noise))
        got = d.step(_t(out), t, _t(x), noise=_t(noise))
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5, rtol=1e-5)


def test_masked_mse_loss_matches_jax():
    rng = np.random.default_rng(0)
    pred, target = (rng.standard_normal((2, 4, 8, 8)).astype(np.float32) for _ in range(2))
    mask = (rng.random((2, 1, 8, 8)) > 0.5).astype(np.float32)
    ref = jdora.masked_mse_loss(jnp.asarray(pred), jnp.asarray(target), jnp.asarray(mask))
    got = tdora.masked_mse_loss(_t(pred), _t(target), _t(mask))
    np.testing.assert_allclose(float(got), float(ref), rtol=1e-6)
    empty = tdora.masked_mse_loss(_t(pred), _t(target), torch.zeros(2, 1, 8, 8))
    assert float(empty) == 0.0  # the denominator is clamped at 1


# ------------------------------------------------------------- the train step
@pytest.fixture(scope="module")
def problem():
    """JAX and port trees of the tiny UNet with the same rank-4 DoRA
    (non-zero B, magnitudes off the column norms) and a masked batch."""
    g = np.load("tests/goldens/sdxl_unet.npz")
    sd = {k[6:]: g[k] for k in g.files if k.startswith("unet::")}
    jcfg, tcfg = junet.UNet2DConfig(**UNET_KW), tunet.UNet2DConfig(**UNET_KW)
    dora = jdora.sdxl_dora_state_dict(jdora.add_dora_to_sdxl_unet(
        junet.convert_unet2d_state_dict(sd, jcfg), jax.random.key(0), rank=4))
    rng = np.random.default_rng(1)
    for k in dora:
        if k.endswith(".lora_B.weight"):
            dora[k] = (0.1 * rng.standard_normal(dora[k].shape)).astype(np.float32)
        elif k.endswith("magnitude_vector.weight"):
            dora[k] = (dora[k] * rng.uniform(0.8, 1.2, dora[k].shape)).astype(np.float32)
    batch = {"latents": rng.standard_normal((1, 4, 8, 8)).astype(np.float32),
             "mask_latents": (rng.random((1, 1, 8, 8)) > 0.5).astype(np.float32),
             "prompt_embeds": rng.standard_normal((1, 7, 32)).astype(np.float32),
             "pooled": rng.standard_normal((1, 32)).astype(np.float32),
             "original_size": np.array([[16, 16]]), "crop_top_left": np.array([[0, 0]])}

    def port_tree():
        return tdora.load_sdxl_dora_state_dict(
            tunet.convert_unet2d_state_dict(sd, tcfg, device="cpu"), dora)[0]

    jtree = jdora.load_sdxl_dora_state_dict(junet.convert_unet2d_state_dict(sd, jcfg), dora)[0]
    return jcfg, tcfg, jtree, port_tree, batch


# the JAX step's SGD rate: its update -LR * grad dwarfs the parameters' own
# rounding, so (before - after) / LR recovers the gradient to ~1e-7
LR = 1e4


def _adapter_leaves_jax(tree):
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        names = tuple(getattr(x, "key", getattr(x, "idx", None)) for x in path)
        if "lora" in names and names[-1] in ("A", "B", "mag"):
            out[names] = np.asarray(leaf)
    return out


@pytest.mark.parametrize("snr_gamma", [None, 5.0])
def test_dora_train_step_matches_jax(problem, snr_gamma):
    """Loss, the A / B / mag gradients (from the JAX step with SGD at rate LR)
    and the AdamW update of one port step (against the JAX AdamW on the
    port's gradients) against the JAX package; the base
    weights stay bit for bit and every adapter moves."""
    jcfg, tcfg, jtree, port_tree, batch = problem
    key = jax.random.key(7)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jinit, jstep = jdora.make_sdxl_dora_train_step(jcfg, optax.sgd(LR), snr_gamma=snr_gamma,
                                                   resolution=16)
    before = _adapter_leaves_jax(jtree)
    jstate, jloss = jstep(jinit(jtree), jbatch, key)
    after = _adapter_leaves_jax(jstate.params)
    jgrads = {k: (before[k].astype(np.float64) - after[k]) / LR for k in before}
    # the draws the JAX loss makes from the step's key
    rng_t, rng_n = jax.random.split(key)
    timesteps = _t(jax.random.randint(rng_t, (1,), 0, 1000))
    noise = _t(jax.random.normal(rng_n, batch["latents"].shape, jnp.float32))

    opt = make_optimizer("adamw", 1e-4, weight_decay=1e-2)
    init, step = tdora.make_sdxl_dora_train_step(tcfg, opt, snr_gamma=snr_gamma, resolution=16,
                                                 device="cpu")
    tbatch = {k: _t(v) for k, v in batch.items()}
    state = init(port_tree())
    loss, grads = step.loss_and_grads(state, tbatch, timesteps=timesteps, noise=noise)
    assert abs(float(loss) - float(jloss)) <= 1e-4 * abs(float(jloss))
    assert sorted(grads) == sorted(jgrads) and len(grads) == 3 * 12 * 2 * 4
    assert _rel(np.concatenate([grads[k].numpy().ravel() for k in jgrads]),
                np.concatenate([jgrads[k].ravel() for k in jgrads])) < 1e-3
    for kind in ("A", "B", "mag"):
        keys = [k for k in jgrads if k[-1] == kind]
        assert _rel(np.concatenate([grads[k].numpy().ravel() for k in keys]),
                    np.concatenate([jgrads[k].ravel() for k in keys])) < 1e-3, kind

    base = {p: t.clone() for p, t in tad.leaves_with_path(state.params)
            if torch.is_tensor(t) and not ("lora" in p and p[-1] in ("A", "B", "mag"))}
    adapters = {p: t.detach().clone() for p, t in zip(state.paths, state.trainable)}
    state, loss2 = step(state, tbatch, timesteps=timesteps, noise=noise)
    assert float(loss2) == float(loss) and state.step == 1
    jopt = j_make_optimizer("adamw", 1e-4, weight_decay=1e-2)
    paths = list(jgrads)
    jparams = [jnp.asarray(before[k]) for k in paths]
    # the JAX AdamW on the port's own gradients: its first step divides g by
    # |g| + 1e-8, so entries with |g| below that eps turn fp32 summation
    # noise between the two steps' gradients (held above) into update noise
    jupd, _ = jopt.update([jnp.asarray(grads[k].numpy(), jnp.float32) for k in paths],
                          jopt.init(jparams), jparams)
    jupd = dict(zip(paths, jupd))
    for p, t in zip(state.paths, state.trainable):
        upd = t.detach().numpy().astype(np.float64) - adapters[p].numpy()
        assert not np.all(upd == 0), p
        assert _rel(upd, np.asarray(jupd[p])) < 1e-3, p
    for p, t in tad.leaves_with_path(state.params):
        if p in base:
            assert torch.equal(t, base[p]), p


def test_dora_step_draws_from_the_generator(problem):
    """Without timesteps / noise the step draws both from its generator:
    the same seed gives the same loss, another seed another."""
    _, tcfg, _, port_tree, batch = problem
    init, step = tdora.make_sdxl_dora_train_step(tcfg, make_optimizer(), resolution=16,
                                                 device="cpu")
    tbatch = {k: _t(v) for k, v in batch.items()}
    state = init(port_tree())
    losses = [float(step.loss_and_grads(state, tbatch, torch.Generator().manual_seed(s))[0])
              for s in (3, 3, 4)]
    assert losses[0] == losses[1] != losses[2]


def test_dora_state_dict_loads_both_ways(problem):
    """The port's saved adapter loads into the JAX tree and the JAX one into
    the port's, key for key and value for value."""
    jcfg, tcfg, jtree, port_tree, _ = problem
    sd_t = tdora.sdxl_dora_state_dict(port_tree())
    sd_j = jdora.sdxl_dora_state_dict(jtree)
    assert sd_t.keys() == sd_j.keys()
    for k in sd_t:
        np.testing.assert_array_equal(sd_t[k], sd_j[k])
    g = np.load("tests/goldens/sdxl_unet.npz")
    sd = {k[6:]: g[k] for k in g.files if k.startswith("unet::")}
    jloaded, n = jdora.load_sdxl_dora_state_dict(junet.convert_unet2d_state_dict(sd, jcfg), sd_t)
    tloaded, tn = tdora.load_sdxl_dora_state_dict(
        tunet.convert_unet2d_state_dict(sd, tcfg, device="cpu"), sd_j)
    assert n == tn == 12 * 2 * 4
    assert jdora.sdxl_dora_state_dict(jloaded).keys() == sd_t.keys()
    for k, v in tdora.sdxl_dora_state_dict(tloaded).items():
        np.testing.assert_array_equal(v, sd_j[k])


# ---------------------------------------------- K6a-c in fp32 at head dim 64
@pytest.mark.parametrize("sq,sk", [(128, 128), (128, 77)])
def test_fp32_d64_plain_k6_match_pallas(sq, sk):
    """o and lse of K6a's plain version and the gradients through K6b / K6c's
    against the Pallas kernels (interpret mode) on fp32 inputs at head dim
    64, BN 2: the DoRA step's self-attention and its 77 text keys."""
    rng = np.random.default_rng(11)
    q, k, v, w = (rng.standard_normal(s).astype(np.float32)
                  for s in ((1, sq, 2, 64), (1, sk, 2, 64), (1, sk, 2, 64), (1, sq, 2, 64)))

    def jloss(q_, k_, v_):
        return jnp.sum(jfa.flash_attention(q_, k_, v_, None, False, None, False) * w)

    with pltpu.force_tpu_interpret_mode():
        ref_o, (_, _, _, _, ref_lse) = jfa._flash_fwd(jnp.asarray(q), jnp.asarray(k),
                                                      jnp.asarray(v), None, False, None)
        ref = jax.grad(jloss, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    bq, bk = tfa._tiles(sq, sk)
    qh = tfa._heads_major(tfa._prescale(_t(q), None, False), tfa._pad_len(sq, bq, False))
    kh, vh = (tfa._heads_major(_t(a), tfa._pad_len(sk, bk, False)) for a in (k, v))
    oh, lse = tfa.flash_fwd(qh, kh, vh, sk_actual=sk)
    assert oh.dtype == lse.dtype == torch.float32
    assert _rel(tfa._natural(oh, 1, 2, sq).numpy(), np.asarray(ref_o)) < 1e-5
    np.testing.assert_allclose(lse[:, :sq].numpy(), np.asarray(ref_lse)[:, :sq, 0], atol=1e-5)
    tq, tk, tv = (_t(a).requires_grad_(True) for a in (q, k, v))
    out = tfa.flash_attention(tq, tk, tv)
    grads = torch.autograd.grad((out * _t(w)).sum(), (tq, tk, tv))
    for got, r in zip(grads, ref):
        assert got.dtype == torch.float32
        assert _rel(got.numpy(), np.asarray(r)) < 1e-5
