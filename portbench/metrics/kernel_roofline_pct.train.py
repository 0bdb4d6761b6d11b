"""Share of their bandwidth floor that the hand-written kernels reach in the
traced cadence: the bytes of the launches that one cadence makes under the
trainer's memory plan (committed counts, frozen ``kernel_work``; the reg
steps' recompute included) over 3.35 TB/s, against their device time by
name in the trace."""

from portbench.peaks import PEAK_BYTES_PER_S
from portbench.trace import hand_written_s


def read(run):
    spent = sum(hand_written_s(run["trace"]["by_kernel"]).values())
    if not run["traced_cadences"] or spent <= 0:
        return None
    floor = run["counts"]["train"]["launched"]["cadence"]["kernel_bytes"] * run["traced_cadences"] / PEAK_BYTES_PER_S
    return 100.0 * floor / spent
