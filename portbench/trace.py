"""The profiler's trace reduced to what the per-layer metrics read.

``events(prof)`` takes the raw Kineto events of a ``torch.profiler`` run as
``(name, kind, start_ns, end_ns)``: ``kind`` is ``"device"`` for work on the
card (kernels, copies, fills), ``"span"`` for the benchmark's own
``record_function`` ranges and ``"cpu"`` for the host's ATen ops.
:func:`reduce` turns them into the busy time (the union of the device
intervals, never their sum), the device time by kernel name, the idle gaps
named by what the host was doing, and the device time inside each span.
"""

from __future__ import annotations

import bisect
from collections import Counter, defaultdict

# the benchmark's own spans (record_function names)
SPANS = ("window", "next_real", "one_iteration", "generate")


def _is_span(name: str) -> bool:
    return name in SPANS or name.split(".")[0] in SPANS


def events(prof) -> list[tuple[str, str, int, int]]:
    out = []
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        start = e.start_ns()
        end = start + e.duration_ns()
        if "cuda" in str(e.device_type()).lower():
            # the spans' mirror on the device's timeline is no device work
            if not (_is_span(name) or getattr(e, "is_user_annotation", lambda: False)()):
                out.append((name, "device", start, end))
        elif _is_span(name):
            out.append((name, "span", start, end))
        else:
            out.append((name, "cpu", start, end))
    return out


def union(intervals: list[tuple[int, int]]) -> list[tuple[int, int]]:
    merged: list[list[int]] = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return [(s, e) for s, e in merged]


def clip(intervals, lo: int, hi: int) -> list[tuple[int, int]]:
    return [(max(s, lo), min(e, hi)) for s, e in intervals if e > lo and s < hi]


def covered_ns(merged: list[tuple[int, int]], lo: int, hi: int) -> int:
    return sum(e - s for s, e in clip(merged, lo, hi))


def _host_at(cpu: list[tuple[int, int, str]], starts: list[int], t: int) -> str:
    """The innermost host op running at ``t`` (the latest started that has
    not ended), or "python" when the host runs no ATen op."""
    i = bisect.bisect_right(starts, t) - 1
    for j in range(i, max(i - 500, -1), -1):
        if cpu[j][1] >= t:
            return cpu[j][2]
    return "python"


def reduce(evs: list[tuple[str, str, int, int]], window: str = "window") -> dict:
    """Busy and window seconds, device seconds by kernel name, the longest
    idle gaps by host activity, and the device seconds inside each span
    (the union of device intervals between the span's start and end)."""
    spans = [(n, s, e) for n, k, s, e in evs if k == "span"]
    wins = [(s, e) for n, s, e in spans if n == window]
    dev = [(s, e) for n, k, s, e in evs if k == "device"]
    if wins:
        lo, hi = min(s for s, _ in wins), max(e for _, e in wins)
    elif dev:
        lo, hi = min(s for s, _ in dev), max(e for _, e in dev)
    else:
        return {"busy_s": 0.0, "window_s": 0.0, "by_kernel": {}, "gaps": {}, "spans": {}}
    merged = union(clip(dev, lo, hi))
    by_kernel: Counter = Counter()
    for n, k, s, e in evs:
        if k == "device" and e > lo and s < hi:
            by_kernel[n] += (min(e, hi) - max(s, lo)) / 1e9
    cpu = sorted((s, e, n) for n, k, s, e in evs if k == "cpu")
    starts = [c[0] for c in cpu]
    host_spans = sorted((s, e, n) for n, s, e in spans if n != window)
    span_starts = [h[0] for h in host_spans]
    gaps: Counter = Counter()
    edges = [lo] + [x for iv in merged for x in iv] + [hi]
    for a, b in zip(edges[::2], edges[1::2]):
        if b <= a:
            continue
        mid = (a + b) // 2
        i = bisect.bisect_right(span_starts, mid) - 1
        where = host_spans[i][2] if i >= 0 and host_spans[i][1] >= mid else "outside spans"
        gaps[f"{where}/{_host_at(cpu, starts, mid)}"] += (b - a) / 1e9
    in_span: dict[str, list[float]] = defaultdict(list)
    for n, s, e in spans:
        if n != window:
            in_span[n].append(covered_ns(merged, s, e) / 1e9)
    return {"busy_s": covered_ns(merged, lo, hi) / 1e9, "window_s": (hi - lo) / 1e9,
            "by_kernel": dict(by_kernel), "gaps": dict(gaps), "spans": dict(in_span)}


def top(d: dict, n: int = 10) -> list[list]:
    return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:n]]


# the hand-written kernels of the port, as their names appear in a trace,
# and the name kernel_work knows each by
HAND_WRITTEN = (
    ("bias_act_grad_kernel", "fused_bias_act_grad"),
    ("bias_act_kernel", "fused_bias_act"),
    ("blur2x_up_kernel", "blur2x_up"),
    ("blur2x_down_kernel", "blur2x_down"),
    ("blur_sep_staged", "blur_sep"),
    ("blur_sep_direct", "blur_sep"),
    ("dequant_int8_kernel", "dequant_int8"),
)


def hand_written_s(by_kernel: dict) -> dict[str, float]:
    """Device seconds of each hand-written kernel, by its kernel_work name."""
    out: Counter = Counter()
    for name, secs in by_kernel.items():
        for needle, kname in HAND_WRITTEN:
            if needle in name:
                out[kname] += secs
                break
    return dict(out)
