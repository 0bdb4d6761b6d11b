"""Runs one cell of the benchmark of ``gan_control_torch`` on the card.

    python -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell's file (``portbench/workloads/<cell>.json``) names its
configuration, its driver and its traffic. With ``--trace 0`` the last line
of standard output carries the cell's end-to-end metrics of
``BENCHMARK.json``; with ``--trace 1`` its per-layer metrics, each read by
``portbench/metrics/<metric>.py`` from the traced run. ``correct`` compares
what the timed path produced with the plain reference
(``portbench/reference/``); each number compared is printed beside its
limit as the last lines of standard error and under ``checks``.
"""

from __future__ import annotations

import time

START = time.perf_counter()

import argparse  # noqa: E402
import sys  # noqa: E402

from portbench import harness  # noqa: E402


def parse(argv=None):
    p = argparse.ArgumentParser(description="one cell of the gan_control_torch benchmark")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def fail(msg: str, code: int = 2) -> None:
    print(f"portbench: {msg}", file=sys.stderr, flush=True)
    sys.exit(code)


def per_layer(bench_metrics: list[dict], ctx: dict) -> dict:
    out = {}
    for m in bench_metrics:
        reader = harness.load_module(harness.ROOT / "metrics" / f"{m['name']}.py", m["name"])
        value = reader.read(ctx)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def main(argv=None) -> None:
    args = parse(argv)
    harness.set_cache_dirs()
    bench = harness.benchmark()
    entry = next((w for w in bench["workloads"] if w["name"] == args.workload), None)
    if entry is None:
        fail(f"no workload {args.workload!r} in BENCHMARK.json")
    cell = harness.workload(args.workload)
    config = harness.config(cell["config"])

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < entry["chips"]:
        fail(f"needs {entry['chips']} CUDA device(s); "
             f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
    # the program's settings, as its command lines leave them
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)

    res = harness.driver(cell["traffic"]["kind"]).run(cell, config, args.seed, args.seconds,
                                                      bool(args.trace), device)
    e2e, layers = harness.cell_metrics(bench, args.workload)
    dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": 1,
           "memory_peak_bytes": int(res["memory_peak"])}
    breakdown = None
    if args.trace:
        ctx = dict(res["run"], trace=res["trace"], counts=harness.counts(cell["config"]))
        metrics = per_layer(layers, ctx)
        dev["busy_s"] = res["trace"]["busy_s"]
        dev["window_s"] = res["trace"]["window_s"]
        from portbench.trace import top

        breakdown = {"device_ops": top(res["trace"]["by_kernel"]),
                     "idle_gaps": top(res["trace"]["gaps"])}
    else:
        values = dict(res["e2e"], setup_s=res["setup_end"] - START)
        metrics = {m["name"]: {"value": float(values[m["name"]]), "unit": m["unit"]} for m in e2e}

    found = harness.forbidden_loaded()
    if found:
        fail(f"modules of JAX or the JAX package are loaded: {found}", 3)
    checks = res["checks"]
    correct = all(c["ok"] for c in checks) and res["failed"] == 0
    for c in checks:
        print(f"check {c['name']}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(harness.result_line(correct, res["attempted"], res["failed"], metrics, dev, checks,
                              breakdown), flush=True)


if __name__ == "__main__":
    main()
