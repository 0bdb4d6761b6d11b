"""Rows computed beyond the rows requested, over the rows computed, each
request padded to ``ServingController.bucket_for`` of its size, over the
whole window (a count)."""


def read(run):
    rows = sum(b for _, b, _, _ in run["requests"])
    asked = sum(n for n, _, _, _ in run["requests"])
    return 100.0 * (rows - asked) / rows if rows else None
