"""The port's LoRA adapters (fairygen_tpu_torch.models.adapters, the DiT's
dense layers, convert, the checkpoint key layout and safetensors IO)
against the JAX package on shared numpy-made weights, fp32 on the CPU.

A DiT whose dense layers carry non-zero adapters must give the JAX
package's output: the port's first slice dropped the ``"lora"`` entry of a
layer without a word.  Tolerances: 1e-5 where both sides run the same
plain chain in fp32 (head dim 24 here, so neither takes a fused path);
1e-6 for single products and merges.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fairygen_tpu.core import io as jio
from fairygen_tpu.models import adapters as jad
from fairygen_tpu.models.wan import dit as jdit
from fairygen_tpu.training.runner import wan_lora_state_dict as j_wan_lora_state_dict
from fairygen_tpu_torch import convert
from fairygen_tpu_torch.core import io as tio
from fairygen_tpu_torch.models import adapters as tad
from fairygen_tpu_torch.models.wan import dit as tdit
from fairygen_tpu_torch.training.runner import wan_lora_state_dict

TINY = dict(dim=96, in_dim=8, ffn_dim=128, out_dim=8, text_dim=32, freq_dim=32,
            patch_size=(1, 2, 2), num_heads=4, num_layers=2, seperated_timestep=True,
            require_clip_embedding=False, require_vae_embedding=False,
            fuse_vae_embedding_in_latents=True)


def _t(a):
    return torch.from_numpy(np.array(a))


def _jax_lora_tree(with_b2, seed=0, rank=4):
    """A JAX DiT tree with stacked adapters whose B (and B2) are non-zero."""
    cfg = jdit.WanDiTConfig(**TINY)
    params = jdit.init_dit_params(jax.random.key(seed), cfg)
    params = jad.add_lora_to_wan_dit(params, jax.random.key(seed + 1), rank=rank,
                                     with_b2=with_b2)
    rng = np.random.default_rng(seed)

    def fill(path, a):
        names = [getattr(p, "key", None) for p in path]
        a = np.asarray(a)
        if "lora" in names and names[-1] in ("B", "B2"):
            return (0.1 * rng.standard_normal(a.shape)).astype(np.float32)
        return a
    return cfg, jax.tree_util.tree_map_with_path(fill, params)


def _inputs(seed=7):
    rng = np.random.default_rng(seed)
    lat = rng.standard_normal((1, 8, 3, 4, 6)).astype(np.float32)
    ctx = rng.standard_normal((1, 9, 32)).astype(np.float32)
    return lat, np.array([640.0], np.float32), ctx


@pytest.mark.parametrize("with_b2", [False, True])
def test_dit_with_lora_matches_jax(with_b2):
    jcfg, jp = _jax_lora_tree(with_b2)
    lat, t, ctx = _inputs()
    ref = jdit.wan_dit_forward(jax.tree.map(jnp.asarray, jp), jcfg, jnp.asarray(lat),
                               jnp.asarray(t), jnp.asarray(ctx),
                               fuse_vae_embedding_in_latents=True)
    params = convert.from_jax_params(jp, device="cpu")
    out = tdit.wan_dit_forward(params, tdit.WanDiTConfig(**TINY), _t(lat), _t(t), _t(ctx),
                               fuse_vae_embedding_in_latents=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5, rtol=1e-5)
    no_lora = tdit.wan_dit_forward(
        convert.from_jax_params(jax.tree.map(np.asarray, jdit.init_dit_params(
            jax.random.key(0), jcfg)), device="cpu"),
        tdit.WanDiTConfig(**TINY), _t(lat), _t(t), _t(ctx), fuse_vae_embedding_in_latents=True)
    assert not np.allclose(no_lora.numpy(), np.asarray(ref), atol=1e-3)  # the adapters matter


def test_convert_slices_lora_and_keeps_it_fp32():
    _, jp = _jax_lora_tree(True)
    params = convert.from_jax_params(jp, device="cpu", dtype=torch.bfloat16)
    blk = params["blocks"][1]
    ap = blk["self_attn"]["q"]["lora"]
    assert blk["self_attn"]["q"]["w"].dtype == torch.bfloat16
    assert {k: v.dtype for k, v in ap.items()} == {"A": torch.float32, "B": torch.float32,
                                                   "B2": torch.float32, "scale": torch.float32}
    assert ap["scale"].dim() == 0 and float(ap["scale"]) == 1.0
    np.testing.assert_array_equal(ap["B2"].numpy(),
                                  np.asarray(jp["blocks"]["self_attn"]["q"]["lora"]["B2"][1]))


@pytest.mark.parametrize("case", ["plain", "b2_mask", "per_sample"])
def test_apply_adapter_matches_jax(case):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 5, 16)).astype(np.float32)
    base = rng.standard_normal((2, 5, 12)).astype(np.float32)
    if case == "per_sample":
        lora = {"A": rng.standard_normal((2, 16, 3)), "B": rng.standard_normal((2, 3, 12))}
    else:
        lora = {"A": rng.standard_normal((16, 3)), "B": rng.standard_normal((3, 12)),
                "scale": 0.5}
    if case == "b2_mask":
        lora["B2"] = rng.standard_normal((3, 12))
    lora = {k: (v.astype(np.float32) if isinstance(v, np.ndarray) else v)
            for k, v in lora.items()}
    mask = (rng.random((2, 5, 1)) > 0.5).astype(np.float32) if case == "b2_mask" else None
    ref = jad.apply_adapter(jnp.asarray(base), jnp.asarray(x),
                            {"lora": {k: jnp.asarray(v) for k, v in lora.items()}},
                            None if mask is None else jnp.asarray(mask))
    out = tad.apply_adapter(_t(base), _t(x), {"lora": {k: (_t(v) if isinstance(v, np.ndarray)
                                                           else v) for k, v in lora.items()}},
                            None if mask is None else _t(mask))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5, rtol=1e-6)


def test_dora_is_refused():
    with pytest.raises(NotImplementedError, match="DoRA"):
        tad.apply_adapter(torch.zeros(1, 2), torch.zeros(1, 2),
                          {"lora": {"A": torch.zeros(2, 1), "B": torch.zeros(1, 2),
                                    "mag": torch.ones(2)}})


def _stage_dicts():
    rng = np.random.default_rng(2)
    s1, s2 = {}, {}
    for i in range(2):
        for m in ("self_attn.q", "ffn.2"):
            base = f"blocks.{i}.{m}"
            s1[f"{base}.lora_A.default.weight"] = rng.standard_normal((4, 96)).astype(np.float32)
            s1[f"{base}.lora_B.default.weight"] = rng.standard_normal((96, 4)).astype(np.float32)
            s2[f"{base}.lora_B2.weight"] = rng.standard_normal((96, 4)).astype(np.float32)
    return s1, s2


def test_merge_and_normalize_match_jax():
    s1, s2 = _stage_dicts()
    ref, out = jad.merge_stage_weights(s1, s2), tad.merge_stage_weights(s1, s2)
    assert ref.keys() == out.keys()
    for k in ref:
        np.testing.assert_array_equal(out[k], ref[k])
    foreign = {f"diffusion_model.{k.replace('lora_A', 'lora_down').replace('lora_B', 'lora_up')}"
               .replace(".default", ""): v for k, v in s1.items()}
    for sd in (s1, foreign):
        ref, out = jad.normalize_lora_keys(sd), tad.normalize_lora_keys(sd)
        assert ref.keys() == out.keys()
        for k in ref:
            np.testing.assert_array_equal(out[k], ref[k])


def test_fuse_lora_into_wan_dit_matches_jax():
    jcfg = jdit.WanDiTConfig(**TINY)
    jp = jax.tree.map(np.asarray, jdit.init_dit_params(jax.random.key(3), jcfg))
    s1, s2 = _stage_dicts()
    merged = jad.merge_stage_weights(s1, s2)
    # ffn.2 is (ffn_dim -> dim): give it A of width ffn_dim
    for k in [k for k in merged if "ffn.2.lora_A" in k]:
        merged[k] = np.resize(merged[k], (4, 128)).astype(np.float32)
    ref, n_ref = jad.fuse_lora_into_wan_dit(jax.tree.map(jnp.asarray, jp), merged, jcfg, 0.7)
    params = convert.from_jax_params(jp, device="cpu")
    out, n = tad.fuse_lora_into_wan_dit(params, merged, tdit.WanDiTConfig(**TINY), 0.7)
    assert n == n_ref == 4
    for i in range(2):
        for sub, proj in (("self_attn", "q"), ("ffn", "fc2"), ("cross_attn", "k")):
            np.testing.assert_allclose(out["blocks"][i][sub][proj]["w"].numpy(),
                                       np.asarray(ref["blocks"][sub][proj]["w"][i]),
                                       atol=1e-6, rtol=1e-6)
    # the input tree is left as it was
    np.testing.assert_array_equal(params["blocks"][0]["self_attn"]["q"]["w"].numpy(),
                                  jp["blocks"]["self_attn"]["q"]["w"][0])


@pytest.mark.parametrize("which,p_drop", [("B", 0.8), ("B2", 0.5)])
def test_dropout_lora_b_with_given_masks_matches_jax(which, p_drop):
    _, jp = _jax_lora_tree(True, seed=4)
    rng = jax.random.key(9)
    ref = jad.dropout_lora_b(jax.tree.map(jnp.asarray, jp), rng, p_drop, which=which)
    # the masks the JAX transform draws, leaf for leaf, as port paths
    flat, _ = jax.tree_util.tree_flatten_with_path(jp)
    keys = jax.random.split(rng, len(flat))
    masks = {}
    for (path, leaf), k in zip(flat, keys):
        names = tuple(getattr(x, "key", None) for x in path)
        if "lora" in names and names[-1] == which:
            m = np.asarray(jax.random.uniform(k, leaf.shape) > p_drop)
            for i in range(m.shape[0]):
                masks[(names[0], i) + names[1:]] = _t(m[i])
    params = convert.from_jax_params(jp, device="cpu")
    out = tad.dropout_lora_b(params, None, p_drop, which=which, masks=masks)
    for i in range(2):
        for sub, proj in (("self_attn", "v"), ("ffn", "fc1")):
            for leaf in ("A", "B", "B2"):
                np.testing.assert_allclose(
                    out["blocks"][i][sub][proj]["lora"][leaf].numpy(),
                    np.asarray(ref["blocks"][sub][proj]["lora"][leaf][i]), rtol=1e-6, atol=0)


def test_dropout_keep_rate_and_rescale():
    p = {"blocks": [{"q": {"lora": {"B": torch.ones(200, 500), "A": torch.ones(3, 3)}}}]}
    out = tad.dropout_lora_b(p, torch.Generator().manual_seed(0), 0.8)
    b = out["blocks"][0]["q"]["lora"]["B"]
    n = b.numel()
    kept = (b != 0).sum().item()
    assert abs(kept - 0.2 * n) <= 3 * (n * 0.2 * 0.8) ** 0.5
    torch.testing.assert_close(b[b != 0], torch.full((kept,), 5.0))
    assert out["blocks"][0]["q"]["lora"]["A"] is p["blocks"][0]["q"]["lora"]["A"]


def test_add_lora_and_trainable_filter():
    cfg = tdit.WanDiTConfig(**TINY)
    base = convert.init_dit_params(cfg, "cpu", torch.float32, seed=0)
    params = tad.add_lora_to_wan_dit(base, torch.Generator().manual_seed(0), rank=4)
    fit = tad.lora_trainable_filter(("A", "B"))
    chosen = [(p, t) for p, t in tad.leaves_with_path(params) if fit(p)]
    d, f, r = cfg.dim, cfg.ffn_dim, 4
    per_block = 8 * (d * r + r * d) + 2 * (d * r + r * f)
    assert sum(t.numel() for _, t in chosen) == cfg.num_layers * per_block
    assert all(t.dtype == torch.float32 for _, t in chosen)
    assert "lora" not in base["blocks"][0]["self_attn"]["q"]  # base tree untouched
    ap = params["blocks"][1]["cross_attn"]["o"]["lora"]
    assert ap["scale"] == 1.0 and torch.all(ap["B"] == 0)


def test_lora_state_dict_matches_jax_and_round_trips_both_ios(tmp_path):
    _, jp = _jax_lora_tree(True, seed=5)
    ref = j_wan_lora_state_dict(jax.tree.map(jnp.asarray, jp))
    sd = wan_lora_state_dict(convert.from_jax_params(jp, device="cpu"))
    assert list(sd) == list(ref)
    for k in ref:
        np.testing.assert_array_equal(sd[k], ref[k])
    tio.save_safetensors(str(tmp_path / "port.safetensors"), sd)
    back = jio.load_safetensors(str(tmp_path / "port.safetensors"))
    jio.save_safetensors(str(tmp_path / "jax.safetensors"), ref)
    back2 = tio.load_safetensors(str(tmp_path / "jax.safetensors"))
    for k in ref:
        np.testing.assert_array_equal(back[k], ref[k])
        np.testing.assert_array_equal(back2[k], ref[k])


def test_safetensors_bf16_tensor_round_trip(tmp_path):
    t = torch.randn(3, 5, generator=torch.Generator().manual_seed(0)).to(torch.bfloat16)
    tio.save_safetensors(str(tmp_path / "a.safetensors"), {"x": t, "y": np.arange(4)})
    back = tio.load_safetensors(str(tmp_path / "a.safetensors"))
    np.testing.assert_array_equal(back["x"], t.float().numpy())
    np.testing.assert_array_equal(back["y"], np.arange(4))
    np.testing.assert_array_equal(jio.load_safetensors(str(tmp_path / "a.safetensors"),
                                                       dtype=np.float32)["x"],
                                  t.float().numpy())


def test_set_lora_weights_loads_stage1_into_stage2_slots(tmp_path):
    _, jp = _jax_lora_tree(False, seed=6)
    stage1 = wan_lora_state_dict(convert.from_jax_params(jp, device="cpu"))
    tio.save_safetensors(str(tmp_path / "s1.safetensors"), stage1)
    base = convert.init_dit_params(tdit.WanDiTConfig(**TINY), "cpu", torch.float32, seed=1)
    stage2 = tad.add_lora_to_wan_dit(base, torch.Generator().manual_seed(1), rank=4,
                                     with_b2=True)
    n = tad.set_lora_weights(stage2, tio.load_safetensors(str(tmp_path / "s1.safetensors")))
    assert n == 2 * 10
    again = wan_lora_state_dict(stage2)
    for k in stage1:
        np.testing.assert_array_equal(again[k], stage1[k])
    assert torch.all(stage2["blocks"][0]["ffn"]["fc2"]["lora"]["B2"] == 0)
