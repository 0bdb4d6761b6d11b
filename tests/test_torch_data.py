"""The port's data loaders against the JAX package's, and the device feeder.

Each test writes its own small image folder with PIL from a seed (RGB and
RGBA PNGs and JPEGs of several sizes, so that resize, crop and mode
conversion all run). The Python loader's batches must equal the JAX
Python loader's bit for bit; the native binding (where ``g++`` and the
libjpeg/libpng headers exist) must equal the JAX binding of the same C++
source, with one worker, whose stream is reproducible.
"""

import logging
import threading
import time

import numpy as np
import pytest
import torch
from PIL import Image

from gan_control_tpu.data import datasets as jd
from gan_control_tpu.data import native_loader as j_native

from gan_control_torch.data import datasets as td
from gan_control_torch.data import native_loader as t_native
from gan_control_torch.data.prefetch import DeviceFeeder

SIZE = 16


def _write_images(root, n, seed, sizes=((24, 20), (16, 16), (31, 17)), start=0):
    root.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    for i in range(n):
        w, h = sizes[i % len(sizes)]
        arr = (rng.random((h, w, 3)) * 255).astype(np.uint8)
        if i % 3 == 0:
            Image.fromarray(arr).save(root / f"{start + i:03d}.jpg", quality=90)
        elif i % 3 == 1:
            Image.fromarray(arr).save(root / f"{start + i:03d}.png")
        else:
            alpha = (rng.random((h, w, 1)) * 255).astype(np.uint8)
            Image.fromarray(np.concatenate([arr, alpha], -1), "RGBA").save(root / f"{start + i:03d}.png")
    return root


@pytest.fixture(scope="module")
def folders(tmp_path_factory):
    root = tmp_path_factory.mktemp("data")
    ffhq = _write_images(root / "ffhq" / "sub", 10, 0).parent
    afhq = root / "afhq"
    _write_images(afhq / "train" / "dog", 6, 1)
    _write_images(afhq / "val" / "dog", 4, 2, start=50)
    _write_images(afhq / "train" / "cat", 5, 3)
    return ffhq, afhq


def _take(loader, n):
    try:
        return [next(loader) for _ in range(n)]
    finally:
        loader.close()


@pytest.mark.parametrize("name", ["ffhq", "afhq", "metfaces"])
def test_python_loader_matches_jax_bit_for_bit(folders, name):
    """Three batches (an epoch boundary crossed), AFHQ's dog-only listing
    and random-resized crop included."""
    ffhq, afhq = folders
    cfg = {"path": str(afhq if name == "afhq" else ffhq), "workers": 3}
    fn = {"ffhq": "get_ffhq_data_loader", "afhq": "get_afhq_data_loader",
          "metfaces": "get_metfaces_data_loader"}[name]
    got = _take(getattr(td, fn)(cfg, 4, SIZE, seed=5), 3)
    want = _take(getattr(jd, fn)(cfg, 4, SIZE, seed=5), 3)
    for g, w in zip(got, want):
        assert g.shape == (4, SIZE, SIZE, 3) and g.dtype == np.float32
        np.testing.assert_array_equal(g, w)
    assert not np.array_equal(got[0], got[1])


def test_afhq_lists_dogs_only(folders):
    _, afhq = folders
    paths = td._dog_paths(afhq)
    assert len(paths) == 10 and all(p.parent.name == "dog" for p in paths)


def test_sharded_rows_concatenate_to_the_unsharded_batch(folders):
    ffhq, _ = folders
    ds = td.ImageFolderDataset(td.list_images(ffhq), size=SIZE, random_resized_crop_p=0.5)
    full = _take(td.infinite_loader(ds, 4, workers=2, seed=3), 2)
    shards = [_take(td.infinite_loader(ds, 4, workers=2, seed=3, shard_index=k, num_shards=2), 2)
              for k in range(2)]
    for b in range(2):
        np.testing.assert_array_equal(np.concatenate([shards[0][b], shards[1][b]]), full[b])
    syn = [next(td.synthetic_data_loader(4, 8, seed=2, shard_index=k, num_shards=2)) for k in range(2)]
    np.testing.assert_array_equal(np.concatenate(syn), next(td.synthetic_data_loader(4, 8, seed=2)))
    np.testing.assert_array_equal(next(td.synthetic_data_loader(4, 8, seed=2, shard_index=1, num_shards=2)),
                                  next(jd.synthetic_data_loader(4, 8, seed=2, shard_index=1, num_shards=2)))
    with pytest.raises(ValueError):
        next(td.infinite_loader(ds, 3, num_shards=2))


def test_a_truncated_file_surfaces_at_next(tmp_path):
    root = _write_images(tmp_path / "imgs", 4, 7, sizes=((16, 16),))
    broken = root / "001.png"
    broken.write_bytes(broken.read_bytes()[:60])
    loader = td.get_ffhq_data_loader({"path": str(root), "workers": 2}, 4, SIZE)
    with pytest.raises(OSError):
        next(loader)
    loader.close()


def _loader_threads():
    return [t for t in threading.enumerate() if t.name == "image-loader"]


def test_close_unblocks_a_full_queue(folders):
    """With the queue full the producer waits in ``put``; closing the
    loader must end it."""
    ffhq, _ = folders
    before = len(_loader_threads())
    ds = td.ImageFolderDataset(td.list_images(ffhq), size=SIZE)
    loader = td.infinite_loader(ds, 2, workers=1, seed=0, prefetch=1)
    next(loader)
    time.sleep(0.5)  # the producer fills the queue and blocks on the next put
    assert len(_loader_threads()) == before + 1
    loader.close()
    deadline = time.time() + 10
    while len(_loader_threads()) > before and time.time() < deadline:
        time.sleep(0.05)
    assert len(_loader_threads()) == before


def test_get_data_loader_dispatch_and_missing_path(folders, monkeypatch):
    ffhq, _ = folders
    for cfg in ({"data_set_name": "ffhq", "path": str(ffhq / "nope")}, {"data_set_name": "ffhq"}):
        with pytest.raises(FileNotFoundError, match="data_config.path"):
            td.get_data_loader(cfg, 4, SIZE)
    with pytest.raises(ValueError, match="unknown"):
        td.get_data_loader({"data_set_name": "celeba", "path": str(ffhq)}, 4, SIZE)
    np.testing.assert_array_equal(next(td.get_data_loader({"data_set_name": "synthetic"}, 2, 8, seed=1)),
                                  next(td.synthetic_data_loader(2, 8, seed=1)))
    # without the native library: the Python loader, the JAX stream
    monkeypatch.setattr(t_native, "available", lambda: False)
    got = _take(td.get_data_loader({"data_set_name": "ffhq", "path": str(ffhq), "workers": 2}, 4, SIZE), 2)
    want = _take(jd.get_ffhq_data_loader({"path": str(ffhq), "workers": 2}, 4, SIZE), 2)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_native_build_failure_falls_back_and_says_why_once(tmp_path, monkeypatch):
    bad = tmp_path / "gcdata.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(t_native, "_SOURCE", bad)
    monkeypatch.setattr(t_native, "BUILD_DIR", tmp_path / "build")
    records = []
    handler = logging.Handler(logging.WARNING)
    handler.emit = records.append
    t_native._log.addHandler(handler)
    t_native.load_library.cache_clear()
    try:
        assert not t_native.available() and not t_native.available()
        with pytest.raises(RuntimeError):
            t_native.decode_one(bad, SIZE)
    finally:
        t_native._log.removeHandler(handler)
        t_native.load_library.cache_clear()
    assert len(records) == 1 and "Python loader" in records[0].getMessage()


@pytest.fixture(scope="module")
def native_pair():
    if not t_native.available():
        pytest.skip("the native loader cannot be built here (needs g++ and the libjpeg/libpng headers)")
    if not j_native.available():
        pytest.skip("the JAX package's native library is not built (make -C native)")


@pytest.mark.parametrize("rrc_p", [0.0, 0.5])
def test_native_binding_matches_the_jax_binding(folders, native_pair, rrc_p):
    ffhq, _ = folders
    paths = td.list_images(ffhq)
    for p in paths[:3]:
        np.testing.assert_array_equal(t_native.decode_one(p, SIZE), j_native.decode_one(p, SIZE))
    kw = dict(size=SIZE, batch_size=4, workers=1, seed=9, random_resized_crop_p=rrc_p)
    got = _take(t_native.native_loader(paths, **kw), 3)
    want = _take(j_native.native_loader(paths, **kw), 3)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_get_data_loader_prefers_the_native_pipeline(folders, native_pair):
    ffhq, _ = folders
    cfg = {"data_set_name": "ffhq", "path": str(ffhq), "workers": 1}
    got = _take(td.get_data_loader(cfg, 4, SIZE, seed=2), 2)
    want = _take(t_native.native_loader(td.list_images(ffhq), SIZE, 4, workers=1, seed=2), 2)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


# ---------------------------------------------------------------------------
# the device feeder (CPU here; the pinned copies are a gpu test)
# ---------------------------------------------------------------------------


def test_device_feeder_keeps_order_and_values_on_the_cpu():
    batches = [np.full((2, 4, 4, 3), i, np.float32) for i in range(7)]
    feeder = DeviceFeeder(iter(batches), "cpu", depth=2)
    try:
        for want in batches:
            got = feeder.next()
            assert isinstance(got, torch.Tensor) and got.device.type == "cpu"
            np.testing.assert_array_equal(got.numpy(), want)
        with pytest.raises(StopIteration):
            feeder.next()
    finally:
        feeder.close()


def test_device_feeder_relays_errors_and_closes():
    def failing():
        yield np.zeros((1, 2, 2, 3), np.float32)
        raise OSError("decode failed")

    feeder = DeviceFeeder(failing(), "cpu")
    feeder.next()
    with pytest.raises(OSError, match="decode failed"):
        feeder.next()
    feeder.close()

    endless = DeviceFeeder(td.synthetic_data_loader(2, 4), "cpu", depth=1)
    endless.next()
    assert endless.close()
    assert not endless._thread.is_alive()
