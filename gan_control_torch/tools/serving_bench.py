"""A/B of the two serving paths: per-request latency, request to numpy
images on the host.

    python -m gan_control_torch.tools.serving_bench [--size 512]
        [--batches 1,3,16,64] [--requests 20] [--device cuda]

  - ``gen_batch_by_controls`` + ``.cpu()``: the reference-faithful API,
    each of the request's kernels launched from Python;
  - ``ServingController.generate``: the request as one CUDA graph replay
    per (group set, bucket), bucket-padded.

A controller directory at the FFHQ-512 scale (``configs/ffhq.json``'s
generator and four FcStack heads at random init; latency does not depend
on the weights) is written to a temporary directory first. The two paths
run on one ``ServingController`` (a ``Controller``), so they share every
module; their requests alternate, each timed alone after one warm call
(which captures the graph). One JSON line per (path, batch), with the
device's name. JAX-free port of ``tools/serving_bench.py``;
``chip_smoke.py`` calls these functions.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[2]
CONFIG = REPO / "gan_control_tpu" / "configs" / "ffhq.json"
CONTROL_DIMS = {"orientation": 3, "age": 1, "hair": 3, "gamma": 27}


def build_layout(root: Path, size: int = 512, dims: dict[str, int] = CONTROL_DIMS,
                 seed: int = 0) -> Path:
    """``root/generator`` (``configs/ffhq.json`` at ``size`` px) and one
    ``<group>_bench`` FcStack head per entry of ``dims`` (n_mlp 4, mid 512),
    at random init from ``seed``, in the JAX package's layout."""
    from gan_control_torch.models.blocks import init_params_
    from gan_control_torch.models.controller import FcStack
    from gan_control_torch.models.factory import build_generator, build_group_spec
    from gan_control_torch.utils.flax_bridge import save_flax_checkpoint

    config = json.loads(CONFIG.read_text())
    config["model_config"]["size"] = size
    gen_dir = root / "generator"
    gen_dir.mkdir(parents=True)
    (gen_dir / "args.json").write_text(json.dumps(config, indent=2))
    spec = build_group_spec(config)
    save_flax_checkpoint(gen_dir / "checkpoint", "g_ema",
                         build_generator(config, spec, device="cpu", seed=seed))
    for i, (group, in_dim) in enumerate(dims.items()):
        cdir = root / f"{group}_bench"
        cdir.mkdir()
        (cdir / "args.json").write_text(json.dumps(
            {"model_config": {"n_mlp": 4, "mid_dim": 512, "in_dim": in_dim, "lr_mlp": 0.01}}))
        head = FcStack(in_dim=in_dim, n_mlp=4, mid_dim=512,
                       out_dim=spec.group(group).latent_size, lr_mlp=0.01)
        save_flax_checkpoint(cdir / "checkpoint", "controller", init_params_(head, seed=seed + 10 + i))
    return root


def controls_for(n: int, seed: int = 0, dims: dict[str, int] = CONTROL_DIMS) -> dict:
    rng = np.random.default_rng(seed)
    return {g: rng.normal(size=(n, d)).astype(np.float32) for g, d in dims.items()}


def latency_stats(seconds: list[float]) -> dict:
    """p50, p90, mean and min in ms of per-request host-clock times."""
    ms = np.asarray(seconds) * 1e3
    return {"requests": len(ms), "p50_ms": float(np.median(ms)), "p90_ms": float(np.percentile(ms, 90)),
            "mean_ms": float(ms.mean()), "min_ms": float(ms.min())}


def request_latency(fn, requests: int) -> dict:
    """``latency_stats`` of ``requests`` calls of ``fn`` (each returns numpy
    images on the host), after one warm call."""
    fn()
    times = []
    for _ in range(requests):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    return latency_stats(times)


def ab_latency(serve, n: int, requests: int, controls: dict, latent=None, **kwargs) -> dict:
    """Per-request latency of ``gen_batch_by_controls`` + ``.cpu()`` and of
    ``generate`` on the same ``ServingController``, the same request
    (``latent`` drawn once from a seed when None), alternating, each after
    one warm call. ``kwargs`` go to ``generate`` (``output``,
    ``static_noise``). Returns ``{path: latency_stats}``."""
    if latent is None:
        latent = np.random.default_rng(n).standard_normal((n, serve.style_dim)).astype(np.float32)

    def eager():
        img, _, _ = serve.gen_batch_by_controls(batch_size=n, latent=latent, **controls)
        return img.cpu().numpy()

    def served():
        return serve.generate(latent=latent, **kwargs, **controls)[0]

    paths = {"gen_batch_by_controls": eager, "generate": served}
    times: dict[str, list[float]] = {p: [] for p in paths}
    for fn in paths.values():
        fn()
    for i in range(requests):
        for name in (list(paths) if i % 2 == 0 else list(paths)[::-1]):
            t0 = time.perf_counter()
            img = paths[name]()
            times[name].append(time.perf_counter() - t0)
            if img.shape[0] != n:
                raise RuntimeError(f"{name} returned {img.shape[0]} images for {n}")
    return {p: latency_stats(t) for p, t in times.items()}


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--size", type=int, default=512)
    parser.add_argument("--batches", default="1,3,16,64")
    parser.add_argument("--requests", type=int, default=20)
    parser.add_argument("--device", default=None, help="cuda unless given")
    args = parser.parse_args(argv)
    batches = [int(b) for b in args.batches.split(",")]
    os.environ.setdefault("GANCTL_LOG_STDERR", "1")  # stdout: the JSON lines alone

    from gan_control_torch.inference.serving import ServingController

    with tempfile.TemporaryDirectory(prefix="serving_bench_") as td:
        root = build_layout(Path(td), args.size)
        serve = ServingController(root, buckets=(1, 4, 16, 64), device=args.device)
        device = (torch.cuda.get_device_name(serve.device) if serve.device.type == "cuda"
                  else serve.device.type)
        for n in batches:
            res = ab_latency(serve, n, args.requests, controls_for(n))
            for path, stats in res.items():
                print(json.dumps({"metric": f"serving_latency_{args.size}px_batch{n}", "path": path,
                                  "bucket": serve.bucket_for(n), "unit": "ms/request",
                                  "device": device, **stats}), flush=True)


if __name__ == "__main__":
    main()
