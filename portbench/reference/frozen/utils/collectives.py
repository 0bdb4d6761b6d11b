"""One process: the data-parallel hooks of the copied steps reduce to the
identity, so the reference computes the one-process update."""

from __future__ import annotations

import functools


def sharded_batch():
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            return fn(*args, **kwargs)
        return inner
    return wrap


def sharded() -> bool:
    return False


def global_batch(rows: int):
    return rows, slice(None)


def own_rows(full):
    return full


def gather_batch(x):
    return x


def mean_grads_(params) -> None:
    return None


def mean_metrics(metrics: dict) -> dict:
    return metrics
