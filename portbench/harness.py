"""What every cell shares: finding a cell's files by name, the cache
directories, the device checks and the result line.

A cell is ``workloads/<cell>.json``: its ``config`` (``configs/<config>.json``),
its ``traffic`` mix (``mixes/<mix>.json``: the driver ``kind``,
``drivers/<kind>.py``, and the mix's parameters) and the limits of its
correctness check. A per-layer metric is ``metrics/<metric>.py``,
whose ``read(run)`` returns the number or None. The metrics a cell reports are
those of ``BENCHMARK.json`` that name the cell (or, with no ``workloads``, that
move an end-to-end metric the cell reports).
"""

from __future__ import annotations

import importlib.util
import json
import math
import os
import sys
from pathlib import Path
from types import ModuleType

ROOT = Path(__file__).resolve().parent
REPO = ROOT.parent
CACHE = ROOT / "_cache"
# top-level module names that may not be loaded in the process that prints a result
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "gan_control_tpu")


def read_json(path: Path) -> dict:
    return json.loads(Path(path).read_text())


def benchmark() -> dict:
    return read_json(REPO / "BENCHMARK.json")


def workload(name: str) -> dict:
    """The cell: its configuration's and traffic mix's names and the limits
    of its check, with the mix's parameters under ``traffic``."""
    cell = read_json(ROOT / "workloads" / f"{name}.json")
    return dict(cell, mix=cell["traffic"], traffic=read_json(ROOT / "mixes" / f"{cell['traffic']}.json"))


# keys of a configuration file that describe it and are not run
DESCRIPTIVE = ("source", "reduced", "assumed")


def config(name: str) -> dict:
    """The configuration as the program takes it (without the keys that
    describe where it comes from)."""
    return {k: v for k, v in read_json(ROOT / "configs" / f"{name}.json").items()
            if k not in DESCRIPTIVE}


def counts(name: str) -> dict:
    return read_json(ROOT / "counts" / f"{name}.json")


def load_module(path: Path, name: str) -> ModuleType:
    """The Python file ``path`` as a module (its name may hold dots)."""
    spec = importlib.util.spec_from_file_location(f"portbench_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def driver(kind: str) -> ModuleType:
    return load_module(ROOT / "drivers" / f"{kind}.py", f"driver_{kind}")


def cell_metrics(bench: dict, cell: str) -> tuple[list[dict], list[dict]]:
    """The end-to-end and per-layer metrics of ``cell`` in ``bench``."""
    e2e = [m for m in bench["end_to_end"] if cell in m.get("workloads", [cell])]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if (cell in m["workloads"] if "workloads" in m else m["moves"] in names)]
    return e2e, per_layer


def set_cache_dirs() -> None:
    """Kernel caches at fixed paths inside the checkout, so that only the
    first run of a cell there compiles."""
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def forbidden_loaded() -> list[str]:
    """Top-level names of loaded modules that are JAX, its libraries or the
    JAX package, each name compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def log(msg: str) -> None:
    print(f"portbench: {msg}", file=sys.stderr, flush=True)


def finite(x: float) -> bool:
    return isinstance(x, (int, float)) and math.isfinite(x)


def check(name: str, value: float, limit: float) -> dict:
    """One number of the correctness check beside its limit: it passes when
    it is finite and at most the limit."""
    return {"name": name, "value": float(value), "limit": float(limit),
            "ok": bool(finite(value) and value <= limit)}


def result_line(correct: bool, attempted: int, failed: int, metrics: dict, device: dict,
                checks: list[dict], breakdown: dict | None = None) -> str:
    out = {"correct": bool(correct), "attempted": int(attempted), "failed": int(failed),
           "metrics": metrics, "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = {c["name"]: {"value": c["value"] if finite(c["value"]) else str(c["value"]),
                                 "limit": c["limit"]} for c in checks}
    return json.dumps(out, allow_nan=False)
