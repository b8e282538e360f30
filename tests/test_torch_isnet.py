"""The port's ISNet (models/isnet.py) against the JAX package on a tiny
config: the converter on the JAX suite's torch double's state dict (BN
running statistics randomised, so the fold matters), ``isnet_forward``
within 1e-5, the 2x2 ceil-mode max pool at odd sizes, the
``jax.image.resize(..., "linear")`` twin at a downscale and an upscale,
``extract_mask`` bit for bit at both, and the random init's tree.

fp32 on the CPU; the forward's six side maps are sigmoids of sums taken in
other orders, 1e-5 absolute.  The mask is thresholded at 127 after a
rounding to 8 bits, so a one-level difference could flip a pixel: it is
held bit for bit, not to a tolerance.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fairygen_tpu.models import isnet as jisnet
from fairygen_tpu_torch.models import isnet as tisnet
from test_isnet import ISNetTorch, _randomize_bn_stats


@pytest.fixture(scope="module")
def nets():
    cfg_j, cfg_t = jisnet.ISNetConfig.tiny(), tisnet.ISNetConfig.tiny()
    gen = torch.Generator().manual_seed(0)
    model = ISNetTorch(cfg_j)
    with torch.no_grad():
        _randomize_bn_stats(model, gen)
    model.eval()
    sd = {k: v.numpy() for k, v in model.state_dict().items() if "num_batches_tracked" not in k}
    jparams, _ = jisnet.convert_isnet_state_dict(sd, cfg_j)
    tparams, _ = tisnet.convert_isnet_state_dict(sd, cfg_t, device="cpu")
    return cfg_j, cfg_t, jparams, tparams


def test_config_and_converter_match_jax(nets):
    cfg_j, cfg_t, jparams, tparams = nets
    assert tisnet.ISNetConfig.dis().decoder_stages() == jisnet.ISNetConfig.dis().decoder_stages()
    assert cfg_t.decoder_stages() == cfg_j.decoder_stages()
    flat_j = {tuple(getattr(k, "key", None) for k in p): np.asarray(v)
              for p, v in jax.tree_util.tree_flatten_with_path(jparams)[0]}
    flat_t = {}

    def walk(tree, path):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v, path + (k,))
            else:
                flat_t[path + (k,)] = v.numpy()

    walk(tparams, ())
    assert flat_t.keys() == flat_j.keys()
    for k, v in flat_t.items():
        ref = flat_j[k].transpose(3, 2, 0, 1) if v.ndim == 4 else flat_j[k]  # HWIO -> OIHW
        np.testing.assert_array_equal(v, ref)


def test_init_tree_has_the_jax_shapes():
    cfg = tisnet.ISNetConfig.tiny()
    tp = tisnet.init_isnet_params(cfg, "cpu", seed=0)
    jp = jax.eval_shape(lambda: jisnet.init_isnet_params(jax.random.key(0),
                                                         jisnet.ISNetConfig.tiny()))
    shapes_j = {tuple(getattr(k, "key", None) for k in p): v.shape
                for p, v in jax.tree_util.tree_flatten_with_path(jp)[0]}
    n = 0
    for stage, layers in tp.items():
        for name, leaf in layers.items():
            if isinstance(leaf, dict):
                for k, t in leaf.items():
                    ref = shapes_j[(stage, name, k)]
                    assert t.shape == ((ref[3], ref[2], ref[0], ref[1]) if t.dim() == 4 else ref)
                    n += 1
            else:
                ref = shapes_j[(stage, name)]
                assert leaf.shape == ((ref[3], ref[2], ref[0], ref[1]) if leaf.dim() == 4
                                      else ref)
                n += 1
    assert n == len(shapes_j)


@pytest.mark.parametrize("hw", [(96, 64), (45, 37)])
def test_forward_matches_jax(nets, hw):
    cfg_j, cfg_t, jparams, tparams = nets
    x = np.random.default_rng(1).standard_normal((1,) + hw + (3,)).astype(np.float32)
    ref = jax.jit(lambda p, v: jisnet.isnet_forward(p, cfg_j, v))(jparams, jnp.asarray(x))
    got = tisnet.isnet_forward(tparams, cfg_t, torch.from_numpy(x))
    assert len(got) == len(ref) == 6
    for g, r in zip(got, ref):
        assert g.shape == r.shape and g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=1e-5, rtol=0)


@pytest.mark.parametrize("hw", [(7, 9), (8, 5), (1, 3)])
def test_maxpool_ceil_mode_matches_jax(hw):
    x = np.random.default_rng(2).standard_normal((1,) + hw + (3,)).astype(np.float32)
    ref = np.asarray(jisnet._maxpool2(jnp.asarray(x)))
    got = tisnet._maxpool2(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("src,dst", [((64, 48), (37, 29)), ((20, 30), (64, 64)),
                                     ((33, 17), (64, 16))])
def test_resize_matches_jax_image_resize(src, dst):
    """Antialiased where an axis shrinks, plain bilinear where it grows."""
    x = np.random.default_rng(3).random((1, 2) + src).astype(np.float32)
    ref = jax.image.resize(jnp.asarray(x), (1, 2) + dst, method="linear")
    got = tisnet.resize_linear(torch.from_numpy(x), dst)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-6, rtol=0)


@pytest.mark.parametrize("image_hw,size", [((100, 80), (64, 64)), ((40, 50), (64, 64))])
def test_extract_mask_matches_jax_bit_for_bit(nets, image_hw, size):
    """A downscale (100x80 -> 64x64 -> back) and an upscale (40x50 -> 64x64
    -> back) of a seeded drawing: the same {0, 255} mask."""
    cfg_j, cfg_t, jparams, tparams = nets
    rng = np.random.default_rng(4)
    img = rng.integers(0, 256, image_hw + (3,), dtype=np.uint8)
    img[image_hw[0] // 4: 3 * image_hw[0] // 4, image_hw[1] // 3: 2 * image_hw[1] // 3] = 200
    ref = jisnet.extract_mask(jparams, cfg_j, img, size=size)
    got = tisnet.extract_mask(tparams, cfg_t, img, size=size)
    assert got.dtype == np.uint8 and got.shape == image_hw
    assert set(np.unique(got)) <= {0, 255} and 0 < (got == 255).mean() < 1
    np.testing.assert_array_equal(got, ref)
