"""Share of the traced part of the window in which no operation ran on the
card (the union of the device intervals, not their sum)."""


def read(run):
    t = run["trace"]
    if t["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
