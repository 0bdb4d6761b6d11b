"""Published peaks of one NVIDIA H100 SXM (data sheet, dense, at the full
700 W power limit): FLOP/s by the precision the card multiplies in, and the
HBM3 rate."""

PEAK_FLOPS = {"bf16": 989.4e12, "tf32": 494.7e12, "f32": 66.9e12, "f64": 66.9e12}
PEAK_BYTES_PER_S = 3.35e12


def seconds_at_peak(flops_by_precision: dict) -> float:
    """Each precision's operations over its peak, summed."""
    return sum(n / PEAK_FLOPS[p] for p, n in flops_by_precision.items())
