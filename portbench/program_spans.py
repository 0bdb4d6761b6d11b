"""What the ``program_span`` metrics read: the program's own spans, as
``gan_control_torch.utils.tracing`` keeps them for the part of a run that
ran under the profiler (the traced cadence, the traced requests). A program
without that module, or a run that recorded none of the names asked for,
gives None."""

from __future__ import annotations


def summary() -> dict:
    """The program's store by span name (empty without one)."""
    try:
        from gan_control_torch.utils import tracing
    except ImportError:
        return {}
    return tracing.summary()


def total_ms(spans: dict, names) -> float | None:
    """Host ms inside the spans ``names``, None when none was recorded."""
    found = [spans[n]["total_ms"] for n in names if n in spans]
    return sum(found) if found else None


def per_iteration(run: dict, ms: float | None) -> float | None:
    """``ms`` over the traced cadences' iterations."""
    iterations = run["cadence"] * run["traced_cadences"]
    return ms / iterations if ms is not None and iterations else None


def per_request(run: dict, spans: dict, ms: float | None) -> float | None:
    """``ms`` over the ``request`` spans recorded, in a run that traced
    requests."""
    n = spans.get("request", {}).get("count", 0)
    if ms is None or not n or not any(r[3] for r in run["requests"]):
        return None
    return ms / n
