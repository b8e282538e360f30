"""SDXL's bf16 training and few-step path on the port against the JAX package:
the plain K6a, K6b and K6c in bf16 at head dim 64 against the Pallas
kernels in interpret mode; ``LCMScheduler`` against JAX and
tests/goldens/lcm.npz; a tiny ``scheduler="lcm"`` pipeline request against
the JAX pipeline; the BrushNet mask generators bit for bit; one
``make_brushnet_train_step`` step in fp32 and in bf16; one step of each
SDXL distillation method; and the attention forms still refused on the
card (ROADMAP.md Queue 2 B, C and fp32 without a gradient).

The models are the JAX suite's tiny SDXL UNet and BrushNet of
tests/goldens/brushnet_pipeline.npz (tests/test_torch_sdxl_pipeline.py's
configs) and, for the distillation steps (whose JAX compile grows with
the rolled-out sweeps), a one-level UNet of four transformer blocks with
seeded weights, on the CPU.  A train step runs on the draws of the JAX key, split
as the JAX loss splits it.  The JAX step runs with optax.sgd(LR): its update
is -LR times the gradient, so one compiled step gives the loss and the
gradients.  Tolerances:
  * the plain bf16 K6a-c against Pallas (both bf16, p and dS rounded to
    bf16 against the same row max, sums in other orders): o atol 2^-8 +
    2^-7 relative (the card tests' bound), lse 1e-4, the gradients 2^-7
    relative + 1e-2 of the largest |gradient| (the card tests' bound for
    K6b / K6c against their plain versions);
  * LCM: 2e-6 absolute + 1e-5 relative against the golden (the JAX
    suite's bound), 1e-6 relative against JAX (fp32 on both sides);
  * the LCM request: 2e-4 absolute + 1e-3 relative on the decoded image
    (the DoRA request's bound in tests/test_torch_sdxl_pipeline.py);
  * fp32 steps: the loss 1e-4 relative, gradients 1e-3 relative L2 (the
    DoRA and Wan steps' bounds);
  * the bf16 BrushNet step against the JAX fp32 step on the same draws:
    the loss within 2^-6 relative, the gradients within 2^-4 relative L2.
    The JAX package's step cannot run in bf16 (its conv's transpose rule
    refuses the fp32 cotangent of ``preferred_element_type=jnp.float32``
    beside bf16 weights, in lax itself), so the reference is fp32; bf16
    keeps 8 significant bits, and the step rounds the weights, the noise
    and every layer's output forward and backward (2.4e-2 relative L2
    from the port's own fp32 step on these inputs).
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from fairygen_tpu.diffusion.lcm import LCMScheduler as JLCM
from fairygen_tpu.models.sdxl import unet2d as junet
from fairygen_tpu.models.sdxl import vae as jvae
from fairygen_tpu.ops import flash_attention as jfa
from fairygen_tpu.pipelines import sdxl_brushnet as jpipe
from fairygen_tpu.training import brushnet_trainer as jbt
from fairygen_tpu.training import distill as jdist
from fairygen_tpu_torch import convert
from fairygen_tpu_torch.diffusion.lcm import LCMScheduler
from fairygen_tpu_torch.models import adapters as tad
from fairygen_tpu_torch.models.sdxl import unet2d as tunet
from fairygen_tpu_torch.ops import flash_attention as tfa
from fairygen_tpu_torch.training import brushnet_trainer as tbt
from fairygen_tpu_torch.training import distill as tdist
from fairygen_tpu_torch.training.optimizers import make_optimizer

from test_torch_sdxl_pipeline import BN_KW, UNET_KW, _call_kw, _port_pipe, _sd


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


def _t(a):
    return torch.from_numpy(np.array(a))


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


@pytest.fixture(scope="module")
def g():
    return np.load("tests/goldens/brushnet_pipeline.npz")


# ------------------------------------------- K6a-c in bf16 at head dim 64
@pytest.mark.parametrize("sq,sk,kv_len", [(256, 256, None), (200, 77, None),
                                          (130, 1100, 1050)])
def test_bf16_d64_plain_k6_match_pallas(sq, sk, kv_len):
    """o and lse of K6a's plain version and the gradients through K6b and
    K6c's on bf16 inputs at head dim 64, BN 2, against the Pallas kernels
    (interpret mode): self-attention, the 77 text keys of SDXL's
    cross-attention, and a kv_len inside the ninth of two Pallas k tiles."""
    rng = np.random.default_rng(sq + sk)
    q, k, v, w = (rng.standard_normal(s).astype(np.float32)
                  for s in ((1, sq, 2, 64), (1, sk, 2, 64), (1, sk, 2, 64), (1, sq, 2, 64)))
    jq, jk, jv = (jnp.asarray(a).astype(jnp.bfloat16) for a in (q, k, v))

    def jloss(q_, k_, v_):
        o = jfa.flash_attention(q_, k_, v_, None, False, kv_len, False)
        return jnp.sum(o.astype(jnp.float32) * w)

    with pltpu.force_tpu_interpret_mode():
        ref_o, (_, _, _, _, ref_lse) = jfa._flash_fwd(jq, jk, jv, None, False, kv_len)
        ref = jax.grad(jloss, argnums=(0, 1, 2))(jq, jk, jv)
    tq, tk, tv = (torch.from_numpy(np.array(a.astype(jnp.float32))).to(torch.bfloat16)
                  for a in (jq, jk, jv))
    ska = sk if kv_len is None else kv_len
    bq, bk = tfa._tiles(sq, sk)
    qh = tfa._heads_major(tfa._prescale(tq, None, False), tfa._pad_len(sq, bq, False))
    kh, vh = (tfa._heads_major(a, tfa._pad_len(sk, bk, False)) for a in (tk, tv))
    oh, lse = tfa.flash_fwd(qh, kh, vh, sk_actual=ska)
    assert oh.dtype == torch.bfloat16 and lse.dtype == torch.float32
    torch.testing.assert_close(tfa._natural(oh, 1, 2, sq).float(),
                               torch.from_numpy(np.asarray(ref_o.astype(jnp.float32))),
                               rtol=2 ** -7, atol=2 ** -8)
    np.testing.assert_allclose(lse[:, :sq].numpy(), np.asarray(ref_lse)[:, :sq, 0], atol=1e-4)
    ins = [a.clone().requires_grad_(True) for a in (tq, tk, tv)]
    out = tfa.flash_attention(*ins, kv_len=kv_len)
    grads = torch.autograd.grad((out.float() * _t(w)).sum(), ins)
    for got, r in zip(grads, ref):
        assert got.dtype == torch.bfloat16
        r = torch.from_numpy(np.asarray(r.astype(jnp.float32)))
        torch.testing.assert_close(got.float(), r, rtol=2 ** -7, atol=1e-2 * r.abs().max().item())


def test_refuse_unported_names_what_queue_2_still_lists():
    """On the card bf16 at head dims 64 and 128 and fp32 at 64 with a
    gradient have kernels, and so has bf16 without one at SD1.5's head dims
    40 and 160 too, and fp32 without one (K4 / K5) at 8, 16, 40, 64, 80 and
    160; bf16 with a gradient at another head dim, or without one at a head
    dim K4 / K5 do not take (B), the bounded form with a kv_len (C), fp32
    without a gradient in K3 / K4's bounded form, in K10 or at head dim 128,
    and fp32 with one at another head dim raise, naming the queue."""
    def qh(d, dtype):
        return torch.zeros((2, 64, d), dtype=dtype)

    for d, dtype, grad in ((64, torch.bfloat16, True), (128, torch.bfloat16, True),
                           (64, torch.bfloat16, False), (64, torch.float32, True),
                           (40, torch.bfloat16, False), (160, torch.bfloat16, False),
                           (64, torch.float32, False), (8, torch.float32, False),
                           (16, torch.float32, False), (40, torch.float32, False),
                           (80, torch.float32, False), (160, torch.float32, False)):
        tfa._refuse_unported(qh(d, dtype), grad)
    for d, dtype, grad, item in ((80, torch.bfloat16, True, "B"), (40, torch.bfloat16, True, "B"),
                                 (160, torch.bfloat16, True, "B"),
                                 (96, torch.bfloat16, False, "B"),
                                 (128, torch.float32, False, "A"),
                                 (128, torch.float32, True, "A"),
                                 (40, torch.float32, True, "A")):
        with pytest.raises(ValueError, match=f"Queue 2 {item}"):
            tfa._refuse_unported(qh(d, dtype), grad)
    for kernel in ("bounded", "bias"):
        with pytest.raises(ValueError, match="Queue 2 A"):
            tfa._refuse_unported(qh(128, torch.float32), False, kernel=kernel)
        tfa._refuse_unported(qh(128, torch.bfloat16), False, kernel=kernel)
    with pytest.raises(ValueError, match="Queue 2 C"):
        tfa._refuse_unported(qh(128, torch.bfloat16), False, bounded_kv_len=True)


# -------------------------------------------------------------------- LCM
def test_lcm_scheduler_matches_golden_and_jax(goldens):
    gl = goldens("lcm")
    for n, origin in ((4, 50), (8, 50), (2, 25)):
        s = LCMScheduler().set_timesteps(n, original_inference_steps=origin)
        np.testing.assert_array_equal(s.timesteps, gl[f"ts_{n}_{origin}"])
        np.testing.assert_array_equal(
            s.timesteps, JLCM().set_timesteps(n, original_inference_steps=origin).timesteps)
    s, js = LCMScheduler().set_timesteps(4), JLCM().set_timesteps(4)
    tables, jtables = s.tables(), js.tables()
    assert tables.keys() == jtables.keys()
    for k in tables:
        np.testing.assert_array_equal(tables[k].numpy(), np.asarray(jtables[k]))
    x, jx = _t(gl["x_init"]), jnp.asarray(gl["x_init"])
    for i in range(4):
        noise = gl[f"noise_{i}"] if i < 3 else np.zeros_like(gl["x_init"])
        x, den = s.step_from_tables(tables, _t(gl[f"eps_{i}"]), i, x, _t(noise))
        jx, jden = js.step_from_tables(jtables, jnp.asarray(gl[f"eps_{i}"]), i, jx,
                                       jnp.asarray(noise))
        np.testing.assert_allclose(den.numpy(), gl[f"denoised_{i}"], atol=2e-6, rtol=1e-5)
        np.testing.assert_allclose(x.numpy(), gl[f"x_{i}"], atol=2e-6, rtol=1e-5)
        np.testing.assert_allclose(x.numpy(), np.asarray(jx), rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(den.numpy(), np.asarray(jden), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("prediction_type", ["v_prediction", "sample"])
def test_lcm_step_prediction_types_match_jax(prediction_type):
    rng = np.random.default_rng(3)
    x, m, noise = (rng.standard_normal((1, 4, 8, 8)).astype(np.float32) for _ in range(3))
    s = LCMScheduler(prediction_type=prediction_type).set_timesteps(4)
    js = JLCM(prediction_type=prediction_type).set_timesteps(4)
    for i in (0, 3):
        out = s.step_from_tables(s.tables(), _t(m), i, _t(x), _t(noise))
        ref = js.step_from_tables(js.tables(), jnp.asarray(m), i, jnp.asarray(x),
                                  jnp.asarray(noise))
        for a, b in zip(out, ref):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-6)


def test_lcm_pipeline_request_matches_jax(g):
    """scheduler="lcm": 2 steps, CFG 7.5, BrushNet 0.7, torch-compatible
    noise (the start latents and each step's injected noise), the decoded
    image in [-1, 1], against the JAX pipeline on the same weights."""
    ucfg, bcfg = junet.UNet2DConfig(**UNET_KW), junet.UNet2DConfig(**BN_KW)
    vcfg = jvae.AutoencoderKLConfig.tiny()
    jp = jpipe.SDXLBrushNetPipeline(
        unet_params=junet.convert_unet2d_state_dict(_sd(g, "unet"), ucfg), unet_cfg=ucfg,
        vae_params=jvae.convert_autoencoder_kl_state_dict(_sd(g, "vae"), vcfg), vae_cfg=vcfg,
        brushnet_params=junet.convert_unet2d_state_dict(_sd(g, "bn"), bcfg), brushnet_cfg=bcfg)
    kw = _call_kw(g, num_inference_steps=2, output_type="np_pm1", scheduler="lcm")
    ref = jp(**{k: jnp.asarray(v) if k.endswith("embeds") else v for k, v in kw.items()})
    out = _port_pipe(g)(**kw)
    assert tuple(out.shape) == (1, 3, 64, 64) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-4, rtol=1e-3)
    dpm = _port_pipe(g)(**dict(kw, scheduler="dpm"))
    assert not np.allclose(out.numpy(), dpm.numpy(), atol=1e-2)


# ------------------------------------------------------------ BrushNet masks
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_mask_generators_match_jax_bit_for_bit(seed):
    for h, w in ((64, 48), (128, 128)):
        a = tbt.random_brush_gen(np.random.RandomState(seed), 4, h, w)
        b = jbt.random_brush_gen(np.random.RandomState(seed), 4, h, w)
        assert a.dtype == b.dtype == np.uint8 and a.any()
        np.testing.assert_array_equal(a, b)
        a = tbt.random_mask_gen(np.random.RandomState(seed), h, w)
        b = jbt.random_mask_gen(np.random.RandomState(seed), h, w)
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b)
    rle = [3, 5, 40, 7, 100 + seed, 20]
    np.testing.assert_array_equal(tbt.rle2mask(rle, (16, 12)), jbt.rle2mask(rle, (16, 12)))


# ---------------------------------------------------------- train steps
def _jax_paths(tree):
    """path -> array, 4-D conv kernels from the JAX package's HWIO to the
    port's OIHW."""
    def port_layout(a):
        a = np.asarray(a)
        return a.transpose(3, 2, 0, 1) if a.ndim == 4 else a

    return {tuple(getattr(x, "key", getattr(x, "idx", None)) for x in path): port_layout(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _jax_sgd_step(make, params, batch, key, lr):
    """Loss and gradients (path -> float64 array) of one JAX step with
    optax.sgd(lr): (before - after) / lr."""
    jinit, jstep = make(optax.sgd(lr))
    before = {k: v.astype(np.float64) for k, v in _jax_paths(params).items()}
    state, loss = jstep(jinit(params), batch, key)
    after = _jax_paths(state.params)
    return float(loss), {k: (before[k] - after[k].astype(np.float64)) / lr for k in before}


def _flat(grads, keys):
    return np.concatenate([(grads[k].double().numpy() if torch.is_tensor(grads[k])
                            else np.asarray(grads[k], np.float64)).ravel() for k in keys])


def _brushnet_batch(g):
    rng = np.random.default_rng(5)
    mask = tbt.random_mask_gen(np.random.RandomState(5), 8, 8)
    return {"latents": rng.standard_normal((1, 4, 8, 8)).astype(np.float32),
            "cond_latents": rng.standard_normal((1, 4, 8, 8)).astype(np.float32),
            "mask_latents": mask[None, None],
            "prompt_embeds": g["pe"].astype(np.float32), "pooled": g["ppe"].astype(np.float32),
            "time_ids": np.array([[64, 64, 0, 0, 64, 64]], np.float32)}


def _jax_brushnet(g, batch, key):
    """The JAX package's fp32 BrushNet step (the sgd read-out)."""
    ucfg, bcfg = junet.UNet2DConfig(**UNET_KW), junet.UNet2DConfig(**BN_KW)
    unet = junet.convert_unet2d_state_dict(_sd(g, "unet"), ucfg)
    bn = junet.convert_unet2d_state_dict(_sd(g, "bn"), bcfg)
    return _jax_sgd_step(lambda opt: jbt.make_brushnet_train_step(ucfg, bcfg, unet, opt,
                                                                  conditioning_scale=0.7),
                         bn, jax.tree.map(jnp.asarray, batch), key, 1e4)


@pytest.fixture(scope="module")
def jax_brushnet(g):
    """The batch, the JAX key's draws, and the JAX fp32 step's loss and
    gradients, once for both dtypes."""
    key = jax.random.key(9)
    batch = _brushnet_batch(g)
    rng_t, rng_n = jax.random.split(key)
    draws = {"timesteps": _t(jax.random.randint(rng_t, (1,), 0, 1000)),
             "noise": _t(jax.random.normal(rng_n, (1, 4, 8, 8), jnp.float32))}
    return (batch, draws) + _jax_brushnet(g, batch, key)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_brushnet_train_step_matches_jax(g, jax_brushnet, dtype):
    """One BrushNet step of the tiny UNet + BrushNet on the JAX key's draws:
    its loss and every BrushNet gradient against the JAX fp32 step's (see
    the module note for the tolerances); the AdamW step then moves every
    BrushNet tensor and leaves the UNet bit for bit and frozen."""
    td = getattr(torch, dtype)
    batch, draws, jloss, jgrads = jax_brushnet

    ucfg, bcfg = tunet.UNet2DConfig(**UNET_KW), tunet.UNet2DConfig(**BN_KW)
    unet = tunet.convert_unet2d_state_dict(_sd(g, "unet"), ucfg, td, device="cpu")
    bn = tunet.convert_unet2d_state_dict(_sd(g, "bn"), bcfg, td, device="cpu")
    init, step = tbt.make_brushnet_train_step(ucfg, bcfg, unet, make_optimizer("adamw", 1e-2),
                                              conditioning_scale=0.7, device="cpu")
    tb = {k: _t(v).to(td) if k != "time_ids" else _t(v) for k, v in batch.items()}
    state = init(bn)
    loss, grads = step.loss_and_grads(state, tb, **draws)
    keys = sorted(jgrads)
    assert sorted(grads) == keys and all(grads[k].dtype == td for k in keys)
    loss_tol, grad_tol = (1e-4, 1e-3) if dtype == "float32" else (2 ** -6, 2 ** -4)
    assert abs(float(loss) - jloss) <= loss_tol * abs(jloss)
    assert _rel(_flat(grads, keys), _flat(jgrads, keys)) < grad_tol
    frozen = {p: t.clone() for p, t in tad.leaves_with_path(unet) if torch.is_tensor(t)}
    before = [t.detach().clone() for t in state.trainable]
    state, loss2 = step(state, tb, **draws)
    assert float(loss2) == float(loss) and state.step == 1
    assert all(not torch.equal(a, b) for a, b in zip(before, state.trainable))
    for p, t in tad.leaves_with_path(unet):
        if torch.is_tensor(t):
            assert torch.equal(t, frozen[p]) and not t.requires_grad, p


def test_brushnet_step_draws_from_the_generator(g):
    ucfg, bcfg = tunet.UNet2DConfig(**UNET_KW), tunet.UNet2DConfig(**BN_KW)
    unet = tunet.convert_unet2d_state_dict(_sd(g, "unet"), ucfg, device="cpu")
    init, step = tbt.make_brushnet_train_step(ucfg, bcfg, unet, make_optimizer(), device="cpu")
    state = init(tunet.convert_unet2d_state_dict(_sd(g, "bn"), bcfg, device="cpu"))
    tb = {k: _t(v) for k, v in _brushnet_batch(g).items()}
    losses = [float(step.loss_and_grads(state, tb, torch.Generator().manual_seed(s))[0])
              for s in (3, 3, 4)]
    assert losses[0] == losses[1] != losses[2]


SMALL_KW = dict(block_out_channels=(32,), down_block_types=("CrossAttnDownBlock2D",),
                up_block_types=("CrossAttnUpBlock2D",), layers_per_block=1,
                transformer_layers_per_block=(1,), num_attention_heads=(2,),
                cross_attention_dim=32, norm_num_groups=16, addition_time_embed_dim=8,
                projection_class_embeddings_input_dim=80)


def _small_unet(seed):
    """The one-level UNet's configs and seeded params: the JAX tree (numpy
    leaves; norm scales 1, every other leaf N(0, 0.2^2)) and the port's
    (``convert.from_jax_params``)."""
    cfg_j, cfg_t = junet.UNet2DConfig(**SMALL_KW), tunet.UNet2DConfig(**SMALL_KW)
    rng = np.random.default_rng(seed)

    def fill(path, a):
        names = [getattr(x, "key", None) for x in path]
        if names[-1] == "w" and any(str(n).startswith("norm") for n in names):
            return np.ones(a.shape, np.float32)
        return (0.2 * rng.standard_normal(a.shape)).astype(np.float32)

    tree = jax.tree_util.tree_map_with_path(fill, junet.init_unet2d_params(cfg_j))
    return cfg_j, cfg_t, tree, lambda: convert.from_jax_params(tree, device="cpu")


def _unet_fns(cfg_j, cfg_t):
    def jfn(p, x, t, ctx):
        return junet.unet2d_forward(p, cfg_j, x, t, ctx["pe"], text_embeds=ctx["pooled"],
                                    time_ids=ctx["time_ids"])

    def tfn(p, x, t, ctx):
        return tunet.unet2d_forward(p, cfg_t, x, t, ctx["pe"], text_embeds=ctx["pooled"],
                                    time_ids=ctx["time_ids"])
    return jfn, tfn


@pytest.mark.parametrize("method", ["direct", "consistency"])
def test_sdxl_distill_step_matches_jax(g, method):
    """One fp32 distillation step of the one-level UNet (the student a copy
    of the teacher's params, 2 student and 3 teacher steps for "direct") on
    the JAX key's draws: the loss within 1e-4 relative and
    every gradient within 1e-3 relative L2 of the JAX step; the teacher
    stays bit for bit."""
    ucfg_j, ucfg_t, jtree, port_tree = _small_unet(21)
    jfn, tfn = _unet_fns(ucfg_j, ucfg_t)
    rng = np.random.default_rng(8)
    ctx = {"pe": g["pe"].astype(np.float32), "pooled": g["ppe"].astype(np.float32),
           "time_ids": np.array([[64, 64, 0, 0, 64, 64]], np.float32)}
    x = rng.standard_normal((1, 4, 8, 8)).astype(np.float32)
    batch = {"ctx": ctx, ("noise" if method == "direct" else "latents"): x}
    kw = dict(method=method, num_student_steps=2, num_teacher_steps=3)
    key = jax.random.key(13)
    teacher_j = jax.tree.map(jnp.asarray, jtree)
    jloss, jgrads = _jax_sgd_step(
        lambda opt: jdist.make_sdxl_distill_train_step(jfn, opt, teacher_j, **kw),
        jax.tree.map(jnp.asarray, jtree), jax.tree.map(jnp.asarray, batch), key, 1e4)
    if method == "direct":
        draws = {"step_noise": _t(jax.random.normal(key, (2, 1, 4, 8, 8), jnp.float32))}
    else:
        rng_t, rng_n = jax.random.split(key)
        draws = {"index": int(jax.random.randint(rng_t, (), 1, 50)),
                 "noise": _t(jax.random.normal(rng_n, x.shape, jnp.float32))}

    teacher = port_tree()
    kept = {p: t.clone() for p, t in tad.leaves_with_path(teacher) if torch.is_tensor(t)}
    init, step = tdist.make_sdxl_distill_train_step(tfn, make_optimizer(), teacher, device="cpu",
                                                    **kw)
    state = init(port_tree())
    tb = {"ctx": {k: _t(v) for k, v in ctx.items()}, next(k for k in batch if k != "ctx"): _t(x)}
    loss, grads = step.loss_and_grads(state, tb, **draws)
    keys = sorted(jgrads)
    assert sorted(grads) == keys
    assert abs(float(loss) - jloss) <= 1e-4 * abs(jloss)
    assert _rel(_flat(grads, keys), _flat(jgrads, keys)) < 1e-3
    for p, t in tad.leaves_with_path(teacher):
        if torch.is_tensor(t):
            assert torch.equal(t, kept[p]), p


def test_distill_tables_rollouts_and_psnr_match_jax(g):
    """ddim_tables, the teacher's DDIM rollout and the student's LCM
    rollout (its injected noise given) and rollout_psnr against the JAX
    package."""
    for n in (3, 50):
        jt, tt = jdist.ddim_tables(n), tdist.ddim_tables(n)
        for k in jt:
            np.testing.assert_array_equal(tt[k].numpy(), np.asarray(jt[k]))
    ucfg_j, ucfg_t, jtree, port_tree = _small_unet(22)
    jfn, tfn = _unet_fns(ucfg_j, ucfg_t)
    jp, tp = jax.tree.map(jnp.asarray, jtree), port_tree()
    ctx = {"pe": g["pe"].astype(np.float32), "pooled": g["ppe"].astype(np.float32),
           "time_ids": np.array([[64, 64, 0, 0, 64, 64]], np.float32)}
    jctx, tctx = jax.tree.map(jnp.asarray, ctx), {k: _t(v) for k, v in ctx.items()}
    noise = np.random.default_rng(2).standard_normal((1, 4, 8, 8)).astype(np.float32)
    ref = jdist.sdxl_teacher_rollout(jfn, jp, jnp.asarray(noise), jctx, 3)
    out = tdist.sdxl_teacher_rollout(tfn, tp, _t(noise), tctx, 3)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-5)
    key = jax.random.key(4)
    ref = jdist.sdxl_student_rollout(jfn, jp, jnp.asarray(noise), jctx, key, 2)
    out = tdist.sdxl_student_rollout(
        tfn, tp, _t(noise), tctx, num_steps=2,
        step_noise=_t(jax.random.normal(key, (2, 1, 4, 8, 8), jnp.float32)))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), rtol=1e-4, atol=1e-5)
    a, b = out.detach().numpy(), np.asarray(ref) + 0.01
    assert tdist.rollout_psnr(a, b) == pytest.approx(jdist.rollout_psnr(a, b), rel=1e-12)
    assert tdist.rollout_psnr(a, a) == float("inf")
