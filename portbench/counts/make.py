"""The committed counts of a configuration (``counts/<config>.json``):
operations by precision and the hand-written kernels' bytes, of the
reference at the program's precisions, on the meta device (shapes only).

    python -m portbench.counts.make [config ...]

Each kernel call site is listed as ``[kernel, input shape, dtype, bytes,
launches]``.

  - ``train``: per step kind at the published batch and, for one cadence of
    ``d_reg_every`` iterations (a ``d_step`` and a ``g_step`` each, R1 once,
    path length every ``g_reg_every``), the operations by precision (the
    frozen accountant: torch's flop formulas, the precision by dtype and the
    TF32 switches as the program runs; the kernels' own operations at f32)
    and the kernels' bytes (frozen ``kernel_work`` over each launch of the
    plain plan: no recompute); and, under ``launched``, the kernels' bytes
    and launches of the reg steps and of the cadence under the memory plan
    that the trainer resolves from the configuration (``remat_reg``: the
    recompute of G's and D's blocks in the reg steps' backward launches the
    kernels again), which is what the device runs;
  - ``serve``: per bucket of the serving mix, the same for one request of
    that many rows (heads, mapping, synthesis, uint8), and the operations of
    one more image and of a request apart from its rows.

The random draws of the steps are given as inputs (meta tensors) and ADA's
transforms as identities: the work does not depend on their values.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import sys
from collections import Counter
from pathlib import Path

import torch

from portbench import harness
from portbench.counts.accounting import Accountant
from portbench.reference import build
from portbench.reference.frozen.ops import kernels
from portbench.reference.frozen.training import ada
from portbench.reference.frozen.training.state import GANTrainState, reg_adam
from portbench.reference.frozen.training.train_step import (
    d_reg_step,
    d_step,
    g_reg_step,
    g_step,
)
from portbench.reference.serve_ref import ServeReference
from portbench.reference.train_ref import step_config

META = torch.device("meta")


def _work(fn) -> dict:
    """Operations by precision and kernel bytes and launches of ``fn()``."""
    with kernels.record() as seen, Accountant() as acc:
        fn()
    flops = Counter(acc.flops_by_precision())
    nbytes, launches, sites = 0, Counter(), Counter()
    for name, shape, dtype, static in seen:
        b, f = kernels.kernel_work(name, shape, dtype, static)
        nbytes += b
        flops["f32"] += f
        launches[name] += 1
        sites[(name, tuple(shape), str(dtype).replace("torch.", ""), b)] += 1
    return {"flops": dict(flops), "kernel_bytes": nbytes, "kernel_launches": dict(launches),
            "kernel_sites": [[n, list(shape), dt, b, c] for (n, shape, dt, b), c in sorted(sites.items())]}


def _sum(parts: list[tuple[int, dict]]) -> dict:
    """``n`` times each part's work, summed (the call sites stay with the
    parts)."""
    flops, nbytes, launches = Counter(), 0, Counter()
    for n, w in parts:
        for k, v in w["flops"].items():
            flops[k] += n * v
        nbytes += n * w["kernel_bytes"]
        for k, v in w["kernel_launches"].items():
            launches[k] += n * v
    return {"flops": dict(flops), "kernel_bytes": nbytes, "kernel_launches": dict(launches)}


@contextlib.contextmanager
def _identity_ada():
    """ADA's transforms drawn as identities while counting."""
    def affine(gen, p, batch, height, width):
        return torch.eye(3, device=META).expand(batch, 3, 3).clone()

    def color(gen, p, batch):
        return torch.eye(4, device=META).expand(batch, 4, 4).clone()

    saved = ada.sample_affine, ada.sample_color
    ada.sample_affine, ada.sample_color = affine, color
    try:
        yield
    finally:
        ada.sample_affine, ada.sample_color = saved


def train_counts(config: dict) -> dict:
    mc, tc = config["model_config"], config["training_config"]
    dtype = torch.bfloat16 if mc.get("mixed_precision") else torch.float32
    cfg = step_config(tc, mc, tc.get("predictor_dtype", "float32"))
    spec = build.group_spec(config)
    g = build.generator(config, spec, META, dtype, None)
    d = build.discriminator(config, META, dtype, None)
    g_ema = build.generator(config, spec, META, dtype, None).requires_grad_(False)
    specs, nets = build.battery(tc, META, None)
    for m in build.distinct(nets).values():
        m.to(dtype=torch.bfloat16 if cfg.predictor_dtype != "float32" else torch.float32)
    state = GANTrainState(
        generator=g, discriminator=d, g_ema=g_ema,
        g_opt=reg_adam(g.parameters(), tc["lr_g"], cfg.g_reg_every),
        d_opt=reg_adam(d.parameters(), tc["lr_d"], cfg.d_reg_every),
        mean_path_length=torch.zeros((), device=META), rng=torch.Generator(),
        ada_p=torch.zeros((), device=META))
    augment_fn = ada.augment if cfg.ada_enabled else None
    b, pb = cfg.batch, max(cfg.batch // max(cfg.path_batch_shrink, 1), 1)
    size = mc["size"]

    def z(n):
        return (torch.empty((n, cfg.style_dim), device=META),)

    def noise(n):
        return [torch.empty(s, device=META) for s in g.noise_shapes(n)]

    real = torch.empty((b, size, size, 3), device=META)
    with _identity_ada():
        per_step = {
            "d_step": _work(lambda: d_step(state, cfg, spec, real, z(b), noise=noise(b),
                                           augment_fn=augment_fn)),
            "d_reg_step": _work(lambda: d_reg_step(state, cfg, real)),
            "g_step": _work(lambda: g_step(state, cfg, spec, z(b), noise=noise(b), attr_losses=specs,
                                           predictors=nets, augment_fn=augment_fn)),
            "g_reg_step": _work(lambda: g_reg_step(state, cfg, z(pb), noise=noise(pb),
                                                   path_noise=torch.empty((pb, size, size, 3),
                                                                          device=META))),
        }
        # the trainer's plan: remat_reg unless model_config.remat (GeneratorTrainer's
        # remat_reg_plan)
        plan = bool(mc.get("remat_reg", True)) and not mc.get("remat", False)
        cfg_plan = dataclasses.replace(cfg, remat_reg=plan)
        launched_steps = dict(per_step, **{
            "d_reg_step": _work(lambda: d_reg_step(state, cfg_plan, real)),
            "g_reg_step": _work(lambda: g_reg_step(state, cfg_plan, z(pb), noise=noise(pb),
                                                   path_noise=torch.empty((pb, size, size, 3),
                                                                          device=META)))})
    n = cfg.d_reg_every

    def cadence_of(steps):
        return _sum([(n // tc.get("d_every", 1), steps["d_step"]), (1, steps["d_reg_step"]),
                     (n, steps["g_step"]), (n // cfg.g_reg_every, steps["g_reg_step"])])

    launched = cadence_of(launched_steps)
    return {"batch": b, "iterations": n, "per_step": per_step, "cadence": cadence_of(per_step),
            "launched": {"remat_reg": plan,
                         "per_step": {k: {"kernel_bytes": launched_steps[k]["kernel_bytes"],
                                          "kernel_launches": launched_steps[k]["kernel_launches"]}
                                      for k in ("d_reg_step", "g_reg_step")},
                         "cadence": {"kernel_bytes": launched["kernel_bytes"],
                                     "kernel_launches": launched["kernel_launches"]}}}


def serve_counts(config: dict, mix: dict) -> dict:
    mc = config["model_config"]
    dtype = torch.bfloat16 if mc.get("mixed_precision") else torch.float32
    ref = ServeReference.__new__(ServeReference)
    ref.spec = build.group_spec(config)
    ref.g = build.generator(config, ref.spec, META, dtype, None).eval()
    ref.heads = build.heads(ref.spec, mix["controls"], mix["head"], META, None)
    ref.noise = [torch.empty(s, device=META) for s in ref.g.noise_shapes(1)]
    ref.device = META
    per_bucket = {}
    for bucket in mix["buckets"]:
        per_bucket[str(bucket)] = _work(lambda: ref.forward_tensors(
            torch.empty((bucket, mc.get("latent_size", 512)), device=META),
            {gr: torch.empty((bucket, dim), device=META) for gr, dim in mix["controls"].items()}))
    # rows are independent: a request's operations are a fixed part (the
    # weights' modulation set-up) plus one part per row
    lo, hi = min(mix["buckets"]), max(mix["buckets"])
    f_lo, f_hi = per_bucket[str(lo)]["flops"], per_bucket[str(hi)]["flops"]
    per_image = {k: (f_hi.get(k, 0) - f_lo.get(k, 0)) / (hi - lo) for k in f_hi}
    per_request = {k: f_lo.get(k, 0) - lo * per_image[k] for k in f_hi}
    return {"per_bucket": per_bucket, "per_image_flops": per_image,
            "per_request_flops": per_request,
            "kernel_bytes_by_bucket": {k: v["kernel_bytes"] for k, v in per_bucket.items()}}


def counts(config_name: str) -> dict:
    """The counts of ``config_name`` for the kinds of cells that run it."""
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = False
    bench = harness.benchmark()
    config = harness.config(config_name)
    out = {}
    for w in bench["workloads"]:
        if w["config"] != config_name:
            continue
        mix = harness.workload(w["name"])["traffic"]
        if mix["kind"] == "train" and "train" not in out:
            out["train"] = train_counts(config)
        elif mix["kind"] == "serve" and "serve" not in out:
            out["serve"] = serve_counts(config, mix)
    return out


def main(argv=None) -> None:
    names = (argv if argv is not None else sys.argv[1:]) or [c["name"] for c in
                                                             harness.benchmark()["configs"]]
    for name in names:
        path = Path(harness.ROOT / "counts" / f"{name}.json")
        path.write_text(json.dumps(counts(name), indent=1, sort_keys=True) + "\n")
        print(path)


if __name__ == "__main__":
    main()
