"""Host milliseconds per iteration inside ``trainer.next_real()`` over the
window's plain cadences."""


def read(run):
    iters = run["plain_cadences"] * run["cadence"]
    return 1e3 * run["feed_s"] / iters if iters else None
