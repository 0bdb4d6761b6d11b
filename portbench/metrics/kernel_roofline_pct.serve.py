"""Share of their bandwidth floor that the hand-written kernels reach in the
traced requests: the bytes of their launches at each request's bucket
(committed counts, frozen ``kernel_work``) over 3.35 TB/s, against their
device time by name in the trace (inside the CUDA graphs' replays)."""

from portbench.peaks import PEAK_BYTES_PER_S
from portbench.trace import hand_written_s


def read(run):
    spent = sum(hand_written_s(run["trace"]["by_kernel"]).values())
    per_bucket = run["counts"]["serve"]["kernel_bytes_by_bucket"]
    nbytes = sum(per_bucket[str(b)] for _, b, _, traced in run["requests"] if traced)
    if spent <= 0 or not nbytes:
        return None
    return 100.0 * nbytes / PEAK_BYTES_PER_S / spent
