"""Serving walkthrough (the port's counterpart of the JAX package's
``examples/serving_example.py``).

Given a trained controller directory:
  1. live serving: ``ServingController`` (each request one CUDA graph
     replay per (group set, batch bucket), captured by ``warmup()`` ahead
     of traffic), an odd request size riding the bucket ladder, uint8
     output quantised in the graph; with ``--mesh`` the request's rows are
     split over the listed devices;
  2. release: ``export_artifacts()``, each request module a
     ``torch.export`` program with its weights inside;
  3. the target fleet: ``load_exported_serving()`` serving the programs
     with no model code, checkpoint or config, checked against the live
     path.

    python -m gan_control_torch.examples.serving_example
        --controller_dir DIR [--out serving_out] [--device cpu]
        [--mesh cuda:0,cuda:1]
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np
import torch


def main(argv: list[str] | None = None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--controller_dir", required=True)
    parser.add_argument("--out", default="serving_out")
    parser.add_argument("--device", default=None, help="CUDA unless given (e.g. cpu)")
    parser.add_argument("--mesh", default=None,
                        help="comma-separated devices to split each request over (e.g. cuda:0,cuda:1)")
    args = parser.parse_args(argv)

    from gan_control_torch.evaluation.generation import save_image_grid
    from gan_control_torch.inference.exported import load_exported_serving
    from gan_control_torch.inference.serving import ServingController

    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    mesh = args.mesh.split(",") if args.mesh else None
    # every bucket divides by the mesh's devices
    buckets = tuple(len(mesh or [0]) * b for b in (1, 4))

    # -- 1. live serving ---------------------------------------------------
    srv = ServingController(args.controller_dir, buckets=buckets, mesh=mesh, device=args.device)
    group = next(iter(srv.fc_controls))
    dim = srv.control_dim(group)
    print(f"serving groups: {sorted(srv.fc_controls)} (demonstrating '{group}', control dim {dim}); "
          f"buckets {srv.buckets}" + (f", mesh {[str(d) for d in srv.mesh]}" if mesh else ""))
    srv.warmup(groups=[group])  # capture the bucket ladder up front

    controls = {group: np.linspace(-1.0, 1.0, 3 * dim, dtype=np.float32).reshape(3, dim)}
    # 3 rows pad to the smallest bucket; the padding rows are dropped
    imgs, z, w = srv.generate(batch_size=3, generator=torch.Generator().manual_seed(7), **controls)
    print(f"live: imgs {imgs.shape} {imgs.dtype}, z {z.shape}, w {w.shape}")
    imgs_u8, _, _ = srv.generate(batch_size=3, generator=torch.Generator().manual_seed(7),
                                 output="uint8", **controls)
    assert imgs_u8.dtype == np.uint8  # quantised in the graph: a quarter of the bytes

    # -- 2. release: export the request programs ----------------------------
    artifacts = out / "artifacts"
    manifest = srv.export_artifacts(artifacts, groups=[group], buckets=(srv.bucket_for(3),))
    print(f"exported {len(list(artifacts.glob('*.pt2')))} torch.export programs -> {artifacts}")
    (out / "manifest_echo.json").write_text(json.dumps(manifest, indent=1))

    # -- 3. the target fleet: model-code-free serving -----------------------
    fleet = load_exported_serving(artifacts, device=srv.device)
    imgs2, z2, _ = fleet.generate(batch_size=3, generator=torch.Generator().manual_seed(7), **controls)
    np.testing.assert_allclose(imgs2, imgs, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(z2, z)
    print("the exported programs reproduce the live path (same draws)")

    save_image_grid(imgs, out / "served.jpg", nrow=3)
    print(f"wrote {out / 'served.jpg'}")


if __name__ == "__main__":
    main()
