"""The port's data pipeline (fairygen_tpu_torch/data, training/data_process.py,
utils/train_logging.py) against the JAX package's, on the CPU.

Both sides open the same PNG / GIF / frame-directory files with PIL, so the
arrays must be equal, and the loaders must walk the same sample order for
the same seed and epoch.  Every comparison here is exact.
"""
import json
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from fairygen_tpu import data as jdata
from fairygen_tpu.training.data_process import launch_data_process_task as j_data_process
from fairygen_tpu.utils.train_logging import MetricsLogger as JMetricsLogger
from fairygen_tpu_torch import data as tdata
from fairygen_tpu_torch.training.data_process import launch_data_process_task
from fairygen_tpu_torch.utils.train_logging import MetricsLogger


def _frames(rng, n, h=40, w=56):
    return [Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)) for _ in range(n)]


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """A PNG, a 7-frame GIF, a 6-frame directory, and csv / json / jsonl
    metadata naming them."""
    root = tmp_path_factory.mktemp("data")
    rng = np.random.default_rng(0)
    _frames(rng, 1, 50, 70)[0].save(root / "still.png")
    gif = _frames(rng, 7)
    gif[0].save(root / "clip.gif", save_all=True, append_images=gif[1:])
    (root / "shot").mkdir()
    for i, f in enumerate(_frames(rng, 6)):
        f.save(root / "shot" / f"{i:03d}.png")
    rows = [{"video": "clip.gif", "prompt": "a pig walks"},
            {"video": "shot", "prompt": "a pig runs"},
            {"video": "still.png", "prompt": "a still"}]
    with open(root / "meta.csv", "w") as f:
        f.write("video,prompt\n" + "".join(f"{r['video']},{r['prompt']}\n" for r in rows))
    (root / "meta.json").write_text(json.dumps(rows))
    (root / "meta.jsonl").write_text("".join(json.dumps(r) + "\n" for r in rows) + "\n")
    return root


def _arrays(x):
    """PIL images (or lists of them) -> numpy, anything else as it is."""
    if isinstance(x, list):
        return [_arrays(v) for v in x]
    if isinstance(x, dict):
        return {k: _arrays(v) for k, v in x.items()}
    return np.asarray(x) if isinstance(x, Image.Image) else x


def _equal(a, b):
    a, b = _arrays(a), _arrays(b)
    if isinstance(a, list):
        return len(a) == len(b) and all(_equal(x, y) for x, y in zip(a, b))
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_equal(a[k], b[k]) for k in a)
    if isinstance(a, np.ndarray):
        return a.dtype == b.dtype and np.array_equal(a, b)
    return a == b


@pytest.mark.parametrize("kw", [dict(), dict(height=32, width=48), dict(num_frames=3),
                                dict(max_pixels=32 * 32, height_division_factor=8,
                                     width_division_factor=8)])
@pytest.mark.parametrize("name", ["clip.gif", "shot", "still.png"])
def test_video_operator_matches_jax(files, name, kw):
    """default_video_operator: GIF, frame directory and image routes, the
    aspect-fill crop and the frame-count rule (7 -> 5 and 6 -> 5 frames of
    81 asked: 4k + 1)."""
    ours = tdata.UnifiedDataset.default_video_operator(base_path=str(files), **kw)(name)
    ref = jdata.UnifiedDataset.default_video_operator(base_path=str(files), **kw)(name)
    assert _equal(ours, ref)
    assert len(ours) == {"still.png": 1}.get(name, kw.get("num_frames", 5))


@pytest.mark.parametrize("kw", [dict(), dict(height=24, width=40)])
def test_image_operator_matches_jax(files, kw):
    for arg in ("still.png", ["still.png", "shot/001.png"]):
        ours = tdata.UnifiedDataset.default_image_operator(base_path=str(files), **kw)(arg)
        ref = jdata.UnifiedDataset.default_image_operator(base_path=str(files), **kw)(arg)
        assert _equal(ours, ref)


def test_small_operators_match_jax(files, tmp_path):
    for name in ("ToInt", "ToFloat", "ToStr", "ToList"):
        for v in ("3", 2.5, None) if name == "ToStr" else ("3",):
            assert getattr(tdata, name)()(v) == getattr(jdata, name)()(v)
    assert tdata.ToStr("-")(None) == jdata.ToStr("-")(None) == "-"
    pipe = tdata.ToInt() >> tdata.ToList() >> tdata.SequencialProcess(tdata.ToStr())
    assert pipe("7") == ["7"]
    for mod in (tdata, jdata):
        with pytest.raises(ValueError, match="Unsupported file"):
            mod.RouteByExtensionName([(("png",), mod.ToList())])("a.txt")
        with pytest.raises(ValueError, match="Unsupported data"):
            mod.RouteByType([(str, mod.ToList())])(3)
    np.savez(tmp_path / "c.npz", latents=np.arange(6.0).reshape(2, 3),
             meta=np.array({"k": 1}, dtype=object))
    ours, ref = tdata.LoadNpz()(str(tmp_path / "c.npz")), jdata.LoadNpz()(str(tmp_path / "c.npz"))
    assert _equal(ours, ref) and ours["meta"] == {"k": 1}


def test_load_video_needs_imageio(monkeypatch, files):
    monkeypatch.setitem(sys.modules, "imageio", None)
    for mod in (tdata, jdata):
        with pytest.raises(RuntimeError, match="imageio"):
            mod.LoadVideo()(str(files / "clip.mp4"))


@pytest.mark.parametrize("meta", ["meta.csv", "meta.json", "meta.jsonl"])
def test_unified_dataset_matches_jax(files, meta):
    kw = dict(base_path=str(files), metadata_path=str(files / meta), repeat=2,
              data_file_keys=("video",))
    ours = tdata.UnifiedDataset(main_data_operator=tdata.UnifiedDataset.default_video_operator(
        base_path=str(files), height=32, width=32), **kw)
    ref = jdata.UnifiedDataset(main_data_operator=jdata.UnifiedDataset.default_video_operator(
        base_path=str(files), height=32, width=32), **kw)
    assert len(ours) == len(ref) == 6
    for i in range(len(ours)):
        assert _equal(ours[i], ref[i])
    assert _equal(list(ours), list(ref))


def test_unified_dataset_cached_mode_walks_npz_files_in_sorted_order(tmp_path):
    for rel in ("b/1-0.npz", "a/0-3.npz", "0-1.npz", "a/sub/0-2.npz"):
        (tmp_path / rel).parent.mkdir(parents=True, exist_ok=True)
        np.savez(tmp_path / rel, x=np.array([len(rel)]))
    (tmp_path / "a" / "notes.txt").write_text("not a sample")
    ours = tdata.UnifiedDataset(base_path=str(tmp_path), metadata_path=None, repeat=2)
    ref = jdata.UnifiedDataset(base_path=str(tmp_path), metadata_path=None, repeat=2)
    assert ours.cached_data == ref.cached_data and len(ours) == 8
    assert [os.path.relpath(p, tmp_path) for p in ours.cached_data] == [
        "0-1.npz", "a/0-3.npz", "a/sub/0-2.npz", "b/1-0.npz"]
    assert all(_equal(ours[i], ref[i]) for i in range(8))


@pytest.mark.parametrize("workers", [0, 2])
@pytest.mark.parametrize("shard", [dict(), dict(num_shards=2, shard_index=1, shard_block=2)])
def test_prefetch_loader_walks_the_jax_order(workers, shard):
    """Shuffled with seed 5 over two epochs (each its own permutation), and
    position-sharded: the same items in the same order as the JAX loader."""
    data = list(range(23))
    ours = tdata.PrefetchLoader(data, lambda x: x * 10, shuffle=True, seed=5,
                                num_workers=workers, prefetch=3, **shard)
    ref = jdata.PrefetchLoader(data, lambda x: x * 10, shuffle=True, seed=5, num_workers=0,
                               **shard)
    epochs = [list(ours), list(ours)]
    assert epochs == [list(ref), list(ref)] and epochs[0] != epochs[1]
    assert len(ours) == len(ref) == len(epochs[0])


@pytest.mark.parametrize("workers", [0, 2])
def test_prefetch_loader_reraises_a_worker_error_in_order(workers):
    def collate(i):
        if i == 4:
            raise KeyError(f"sample {i}")
        return i

    for mod in (tdata, jdata):
        got = []
        with pytest.raises(KeyError, match="sample 4"):
            for x in mod.PrefetchLoader(list(range(9)), collate, num_workers=workers):
                got.append(x)
        assert got == [0, 1, 2, 3]


def test_prefetch_loader_stops_on_an_early_break():
    loader = tdata.PrefetchLoader(list(range(100)), lambda x: x, num_workers=2, prefetch=4)
    for x in loader:
        break
    assert x == 0 and list(loader)[:3] == [0, 1, 2]
    with pytest.raises(ValueError, match="prefetch"):
        tdata.PrefetchLoader([], prefetch=0)
    with pytest.raises(ValueError, match="shard_index"):
        tdata.PrefetchLoader([], num_shards=2, shard_index=2)


def test_data_process_writes_the_jax_files(tmp_path):
    """The same file names, keys, dtypes and values: floats cached as
    float32 (bf16 included), integer arrays keep their dtype, samples dealt
    out by process index."""
    rng = np.random.default_rng(0)
    samples = [dict(lat=rng.standard_normal((1, 4, 2, 2, 2)).astype(np.float32),
                    ids=rng.integers(0, 100, (1, 7)).astype(np.int32)) for _ in range(5)]

    def jfn(s):
        return {"latents": jnp.asarray(s["lat"], jnp.bfloat16), "ids": jnp.asarray(s["ids"]),
                "scale": np.float64(0.5)}

    def tfn(s):
        return {"latents": torch.from_numpy(s["lat"]).to(torch.bfloat16),
                "ids": torch.from_numpy(s["ids"]), "scale": np.float64(0.5)}

    for rank in (0, 1):
        n = launch_data_process_task(samples, tfn, str(tmp_path / "t"), process_index=rank,
                                     num_processes=2)
        assert n == j_data_process(samples, jfn, str(tmp_path / "j"), process_index=rank,
                                   num_processes=2)
    names = sorted(os.listdir(tmp_path / "t"))
    assert names == sorted(os.listdir(tmp_path / "j")) == [
        "0-0.npz", "0-2.npz", "0-4.npz", "1-1.npz", "1-3.npz"]
    for name in names:
        with np.load(tmp_path / "t" / name) as a, np.load(tmp_path / "j" / name) as b:
            assert sorted(a.files) == sorted(b.files) == ["ids", "latents", "scale"]
            for k in a.files:
                assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k
            assert a["latents"].dtype == np.float32 and a["ids"].dtype == np.int32


class _Writer:
    """A stand-in for torch.utils.tensorboard.SummaryWriter (importing the
    real one pulls in tensorboard's stack, seconds on this machine)."""

    scalars = []

    def __init__(self, log_dir):
        self.log_dir = log_dir

    def add_scalar(self, tag, value, step):
        self.scalars.append((tag, value, step))

    def close(self):
        self.scalars.append("closed")


def test_metrics_logger_writes_the_jax_records(tmp_path, monkeypatch):
    """metrics.jsonl as the JAX package writes it; TensorBoard scalars
    through torch.utils.tensorboard with report_to="tensorboard"."""
    import types

    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard",
                        types.SimpleNamespace(SummaryWriter=_Writer))
    _Writer.scalars = []
    for cls, sub, report_to in ((MetricsLogger, "t", "tensorboard"), (JMetricsLogger, "j", None)):
        logger = cls(str(tmp_path / sub), report_to=report_to)
        logger.log(3, loss=np.float32(0.25), epoch=0)
        logger.log(4, loss=0.5, epoch=1)
        logger.close()
    recs = [[json.loads(line) for line in open(tmp_path / sub / "metrics.jsonl")]
            for sub in ("t", "j")]
    for rec in recs:
        for r in rec:
            r.pop("time")
    assert recs[0] == recs[1] == [{"step": 3, "loss": 0.25, "epoch": 0.0},
                                  {"step": 4, "loss": 0.5, "epoch": 1.0}]
    assert _Writer.scalars == [("loss", 0.25, 3), ("epoch", 0.0, 3), ("loss", 0.5, 4),
                               ("epoch", 1.0, 4), "closed"]


def test_metrics_logger_raises_without_tensorboard(tmp_path, monkeypatch):
    """No fallback to JSONL alone: a missing tensorboard raises (the JAX
    package prints and goes on)."""
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    with pytest.raises(ImportError):
        MetricsLogger(str(tmp_path), report_to="tensorboard")
    assert not os.path.exists(tmp_path / "metrics.jsonl")
