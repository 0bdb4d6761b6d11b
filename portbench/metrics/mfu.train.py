"""Share of the card's peak in the window's plain cadences: the operations
of one cadence of the plain memory plan (committed counts, by precision,
each over its peak) times the cadences, over their host time."""

from portbench.peaks import seconds_at_peak


def read(run):
    if not run["plain_cadences"]:
        return None
    at_peak = seconds_at_peak(run["counts"]["train"]["cadence"]["flops"])
    return 100.0 * at_peak * run["plain_cadences"] / run["plain_s"]
