"""Data-pipeline throughput: the native C++ loader against the Python/PIL
loader (counterpart of the JAX package's ``tools/loader_bench.py``).

    python -m gan_control_torch.tools.loader_bench [--images 256] [--src 640] [--size 512]
        [--batch 16] [--batches 20] [--workers 4]

Writes a JPEG corpus of ``--images`` low-frequency ``--src``-px images from
a seed into a temporary directory, then drives each backend through the
port's ``data/datasets.get_data_loader`` (``data_set_name`` "ffhq",
``native`` on or off): 3 warm batches (each checked for its batch size and
finite values), then ``--batches`` timed ones. One JSON line per backend:
images/s and ms per batch. The native backend
runs where ``data/native_loader.available()`` holds; elsewhere its line
says it was skipped and why (the library did not build or load: a machine
without libjpeg/libpng headers runs the PIL loader alone). Host numbers:
they scale with the host's cores.
"""

from __future__ import annotations

import argparse
import json
import tempfile
import time
from pathlib import Path

import numpy as np


def make_corpus(root: Path, n: int, src: int, seed: int = 0) -> None:
    """``n`` JPEGs (quality 92) of ``src`` px: seeded noise at 1/16 of the
    size, upsampled bilinearly, so they compress like photographs (pure
    noise decodes pathologically slowly)."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    for i in range(n):
        small = rng.integers(0, 256, (src // 16, src // 16, 3), np.uint8)
        Image.fromarray(small).resize((src, src), Image.BILINEAR).save(root / f"{i:05d}.jpg", quality=92)


def measure(loader, batch: int, n_batches: int, warmup: int = 3) -> dict:
    for _ in range(warmup):
        b = next(loader)
        if b.shape[0] != batch or not np.isfinite(b).all():
            raise RuntimeError(f"bad batch: shape {b.shape}, finite {np.isfinite(b).all()}")
    t0 = time.perf_counter()
    for _ in range(n_batches):
        next(loader)
    dt = time.perf_counter() - t0
    return {"imgs_per_s": batch * n_batches / dt, "ms_per_batch": dt / n_batches * 1e3}


def native_unavailable() -> str | None:
    """Why the native loader cannot run here, or None when it can."""
    from gan_control_torch.data import native_loader as nl

    if nl.available():
        return None
    try:
        nl.build()
    except RuntimeError as e:
        return str(e).splitlines()[-1] if str(e) else type(e).__name__
    return "the library did not load (see the log)"


def main(argv: list[str] | None = None) -> list[dict]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--images", type=int, default=256)
    ap.add_argument("--src", type=int, default=640)
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--batches", type=int, default=20)
    ap.add_argument("--workers", type=int, default=4)
    args = ap.parse_args(argv)

    from gan_control_torch.data.datasets import get_data_loader

    rows = []
    with tempfile.TemporaryDirectory(prefix="loader_bench_") as td:
        root = Path(td)
        make_corpus(root, args.images, args.src)
        backends = [("python_pil", False)]
        reason = native_unavailable()
        if reason is None:
            backends.insert(0, ("native_cpp", True))
        else:
            rows.append({"backend": "native_cpp", "skipped": reason})
            print(json.dumps(rows[-1]), flush=True)
        for name, native in backends:
            loader = get_data_loader({"data_set_name": "ffhq", "path": str(root), "native": native,
                                      "workers": args.workers}, args.batch, args.size)
            try:
                stats = measure(loader, args.batch, args.batches)
            finally:
                # stop the backend's workers before the corpus goes
                loader.close()
            rows.append({"backend": name, "decode_src_px": args.src, "out_px": args.size,
                         "batch": args.batch, "workers": args.workers, **stats})
            print(json.dumps(rows[-1]), flush=True)
    return rows


if __name__ == "__main__":
    main()
