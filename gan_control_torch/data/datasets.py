"""Image-folder datasets and infinite prefetching loaders (port of
``gan_control_tpu/data/datasets.py``).

  - FFHQ: every image under the folder (recursive), resized to ``size``
    where it differs, randomly flipped, mapped to [-1, 1].
  - AFHQ: the dog images only (``train/dog`` and ``val/dog``, else the flat
    folder), with a random-resized crop at p = 0.5 before the resize.
  - MetFaces (``"metfaces"``, or ``"met-faces"`` as the shipped config
    names it): as FFHQ.

Loaders yield NHWC float32 numpy batches. Decoding runs on a pool of
threads behind a bounded queue (PIL's decode and resize release the GIL).
Each image's augmentation draws come from ``np.random.default_rng((batch
seed, image index))``, so the same folder and seed give the same batches,
bit for bit, as the JAX package's Python loader, and shards of a batch
concatenate to the unsharded batch. ``get_data_loader`` prefers the native
C++ pipeline (``data/native_loader.py``) for JPEG/PNG folders and takes the
Python path, saying why once, where that library cannot be built or loaded.
"""

from __future__ import annotations

import os
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Iterator, Sequence

import numpy as np

from gan_control_torch.utils.logging_utils import get_logger

try:
    from PIL import Image
except ImportError:  # pragma: no cover
    Image = None

_log = get_logger(__name__)

IMG_EXTENSIONS = {".jpg", ".jpeg", ".png", ".bmp", ".webp"}


def list_images(root: str | Path) -> list[Path]:
    """Every image file under ``root``, recursively, sorted."""
    root = Path(root)
    return sorted(p for p in root.rglob("*") if p.suffix.lower() in IMG_EXTENSIONS)


class ImageFolderDataset:
    """Decode -> (optional random-resized crop) -> resize -> flip -> [-1, 1]."""

    def __init__(self, paths: Sequence[Path], size: int, hflip: bool = True,
                 random_resized_crop_p: float = 0.0):
        if Image is None:
            raise RuntimeError("PIL is required for image datasets")
        if not paths:
            raise ValueError("empty dataset")
        self.paths = list(paths)
        self.size = size
        self.hflip = hflip
        self.rrc_p = random_resized_crop_p

    def __len__(self) -> int:
        return len(self.paths)

    def load(self, idx: int, rng: np.random.Generator) -> np.ndarray:
        """One image as [size, size, 3] float32 in [-1, 1]."""
        img = Image.open(self.paths[idx]).convert("RGB")
        if self.rrc_p > 0 and rng.random() < self.rrc_p:
            # torchvision's RandomResizedCrop(scale=(0.8, 1.0), ratio=(0.9,
            # 1.1)) sampling: area fraction uniform, aspect log-uniform, 10
            # attempts, then a centre crop
            w, h = img.size
            area = w * h
            for _ in range(10):
                target_area = area * rng.uniform(0.8, 1.0)
                aspect = np.exp(rng.uniform(np.log(0.9), np.log(1.1)))
                cw = int(round(np.sqrt(target_area * aspect)))
                ch = int(round(np.sqrt(target_area / aspect)))
                if 0 < cw <= w and 0 < ch <= h:
                    x0 = rng.integers(0, w - cw + 1)
                    y0 = rng.integers(0, h - ch + 1)
                    img = img.crop((x0, y0, x0 + cw, y0 + ch))
                    break
            else:
                side = min(w, h)
                x0, y0 = (w - side) // 2, (h - side) // 2
                img = img.crop((x0, y0, x0 + side, y0 + side))
        if img.size != (self.size, self.size):
            img = img.resize((self.size, self.size), Image.BILINEAR)
        arr = np.asarray(img, np.float32) / 127.5 - 1.0
        if self.hflip and rng.random() < 0.5:
            arr = arr[:, ::-1]
        return arr


def infinite_loader(dataset: ImageFolderDataset, batch_size: int, workers: int = 4,
                    seed: int = 0, prefetch: int = 2, shard_index: int = 0,
                    num_shards: int = 1) -> Iterator[np.ndarray]:
    """Infinite shuffled NHWC batches, decoded in the background.

    Every shard runs the same shuffle (same seed); each global batch of
    ``batch_size`` indices is cut into contiguous rows per shard, and a
    shard decodes only its ``batch_size // num_shards`` rows. A decode
    error surfaces at ``next()``; closing the generator stops the producer,
    a full queue included."""
    if batch_size % num_shards:
        raise ValueError(f"batch {batch_size} not divisible by {num_shards} shards")
    if not 0 <= shard_index < num_shards:
        raise ValueError(f"shard_index {shard_index} not in [0, {num_shards})")
    if len(dataset) < batch_size:
        raise ValueError(f"dataset has {len(dataset)} images < batch_size {batch_size}: "
                         "the epoch loop would never yield a batch")
    local = batch_size // num_shards
    order_rng = np.random.default_rng(seed)
    pool = ThreadPoolExecutor(max_workers=max(workers, 1))
    q: queue.Queue = queue.Queue(maxsize=prefetch)
    stop = threading.Event()

    def make_batch(indices, batch_seed):
        rngs = [np.random.default_rng((batch_seed, int(i))) for i in indices]
        return np.stack(list(pool.map(dataset.load, indices, rngs)), axis=0)

    def producer():
        epoch = 0
        try:
            while not stop.is_set():
                perm = order_rng.permutation(len(dataset))
                for s in range(0, len(perm) - batch_size + 1, batch_size):
                    if stop.is_set():
                        return
                    idx = perm[s : s + batch_size][shard_index * local : (shard_index + 1) * local]
                    # keyed by the global batch offset: shards match the
                    # unsharded stream
                    q.put(make_batch(idx, epoch * 1_000_003 + s))
                epoch += 1
        except BaseException as e:  # noqa: BLE001 — handed to the consumer
            if not stop.is_set():
                q.put(e)

    t = threading.Thread(target=producer, daemon=True, name="image-loader")
    t.start()
    try:
        while True:
            item = q.get()
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        stop.set()
        # unblock a producer waiting in q.put so that it sees ``stop``
        while True:
            try:
                q.get_nowait()
            except queue.Empty:
                break
        t.join(timeout=5)
        pool.shutdown(wait=False, cancel_futures=True)


def _dog_paths(root: Path) -> list[Path]:
    """AFHQ's dog images: ``train/dog`` and ``val/dog``, else the flat folder."""
    paths = [p for split in ("train", "val") if (root / split / "dog").is_dir()
             for p in list_images(root / split / "dog")]
    return paths or list_images(root)


def get_ffhq_data_loader(data_config: dict, batch_size: int, size: int, seed: int = 0,
                         shard_index: int = 0, num_shards: int = 1) -> Iterator[np.ndarray]:
    ds = ImageFolderDataset(list_images(data_config["path"]), size=size)
    return infinite_loader(ds, batch_size, workers=int(data_config.get("workers", 4)), seed=seed,
                           shard_index=shard_index, num_shards=num_shards)


def get_afhq_data_loader(data_config: dict, batch_size: int, size: int, seed: int = 0,
                         shard_index: int = 0, num_shards: int = 1) -> Iterator[np.ndarray]:
    ds = ImageFolderDataset(_dog_paths(Path(data_config["path"])), size=size,
                            random_resized_crop_p=0.5)
    return infinite_loader(ds, batch_size, workers=int(data_config.get("workers", 4)), seed=seed,
                           shard_index=shard_index, num_shards=num_shards)


def get_metfaces_data_loader(data_config: dict, batch_size: int, size: int, seed: int = 0,
                             shard_index: int = 0, num_shards: int = 1) -> Iterator[np.ndarray]:
    ds = ImageFolderDataset(list_images(data_config["path"]), size=size)
    return infinite_loader(ds, batch_size, workers=int(data_config.get("workers", 4)), seed=seed,
                           shard_index=shard_index, num_shards=num_shards)


def synthetic_data_loader(batch_size: int, size: int, seed: int = 0, shard_index: int = 0,
                          num_shards: int = 1) -> Iterator[np.ndarray]:
    """Deterministic fake-image stream (NHWC float32, N(0, 0.25)) for tests,
    dry runs and benches: the same arrays as the JAX package's from the
    same seed. A shard replays the stream and takes its contiguous rows."""
    if batch_size % num_shards:
        raise ValueError(f"batch {batch_size} not divisible by {num_shards} shards")
    local = batch_size // num_shards
    rng = np.random.default_rng(seed)
    while True:
        full = rng.standard_normal((batch_size, size, size, 3)).astype(np.float32) * 0.5
        yield full[shard_index * local : (shard_index + 1) * local]


# "met-faces" is the name in the shipped metfaces.json; the JAX package
# reaches its native loader before it checks the name, and without that
# library raises for it
_LOADERS = {"ffhq": get_ffhq_data_loader, "afhq": get_afhq_data_loader,
            "metfaces": get_metfaces_data_loader, "met-faces": get_metfaces_data_loader}


def get_data_loader(data_config: dict, batch_size: int, size: int, seed: int = 0,
                    shard_index: int = 0, num_shards: int = 1) -> Iterator[np.ndarray]:
    """The loader that ``data_config["data_set_name"]`` names. A missing
    ``path`` raises (``"synthetic"`` is the only dataset without one). The
    native pipeline serves JPEG/PNG folders where its library builds and
    loads; with ``num_shards`` > 1 it splits the file list round-robin
    (disjoint, but not the Python stream's rows)."""
    name = data_config.get("data_set_name", "ffhq")
    if batch_size % num_shards:
        raise ValueError(f"global batch {batch_size} not divisible by {num_shards} hosts")
    if name == "synthetic":
        return synthetic_data_loader(batch_size, size, seed, shard_index=shard_index,
                                     num_shards=num_shards)
    if name not in _LOADERS:
        raise ValueError(f"unknown data_set_name {name}")
    if not os.path.isdir(str(data_config.get("path", ""))):
        raise FileNotFoundError(
            f"data_config.path {data_config.get('path')!r} is not a directory; set "
            "data_set_name='synthetic' for smoke runs")

    if data_config.get("native", True):
        from gan_control_torch.data import native_loader as nl

        if nl.available():
            root = Path(data_config["path"])
            paths = _dog_paths(root) if name == "afhq" else list_images(root)
            if paths and all(p.suffix.lower() in (".jpg", ".jpeg", ".png") for p in paths):
                if num_shards > 1:
                    paths = paths[shard_index::num_shards]
                return nl.native_loader(paths, size, batch_size // num_shards,
                                        workers=int(data_config.get("workers", 4)), seed=seed,
                                        random_resized_crop_p=0.5 if name == "afhq" else 0.0)
    return _LOADERS[name](data_config, batch_size, size, seed, shard_index=shard_index,
                          num_shards=num_shards)
