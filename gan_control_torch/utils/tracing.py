"""The program's spans and counters, on the profiler's clock.

    from gan_control_torch.utils import tracing

    with tracing.span("g_step", id=i):
        ...
    tracing.count("graph_captures")

Tracing is on exactly while a ``torch.profiler`` records (the flag that
``torch.autograd.profiler`` keeps): the benchmark's traced window, or an
operator's own profiler. Then a span opens a ``record_function`` of its
name, so it sits in the profiler's trace (and its Chrome trace), and its
record goes to an in-memory store. Off, a span is one test of that flag and
returns a shared do-nothing context: no ``record_function``, no clock read,
no record, no device sync.

A record holds the name, its start and end in Unix-epoch nanoseconds (the
clock of Kineto's events), its parent (the innermost span open on its
thread; on a thread with none open, such as autograd's backward thread,
the innermost open ``backward`` span, whose work it is), the thread, an id
(the iteration in training, the request in serving: given at the entry
point, inherited by every span under it) and the attributes given.
:func:`summary` gives, for each name, the count, the total and the self
milliseconds (the span less what its children cover) and the milliseconds
under each parent's name; those totals stay exact whatever the cap on the
raw records (:data:`MAX_RECORDS`, :func:`records`). A counter adds to its
name's count. :func:`reset` clears the store.
"""

from __future__ import annotations

import threading
import time
from collections import defaultdict

import torch
from torch.autograd import profiler as _profiler

# raw records kept; the totals by name go on beyond it
MAX_RECORDS = 1_000_000
# the span whose work runs on autograd's thread
BACKWARD = "backward"


class Span:
    """One span: a context manager while open, a record once closed."""

    __slots__ = ("name", "start_ns", "end_ns", "parent", "thread", "id", "attrs", "_children_ns",
                 "_rf")

    def __init__(self, name: str, id, attrs: dict):
        stack = _stack()
        parent = stack[-1] if stack else (_backward[-1] if _backward else None)
        self.name = name
        self.parent = parent
        self.thread = threading.get_ident()
        self.id = parent.id if id is None and parent is not None else id
        self.attrs = attrs
        self.start_ns = self.end_ns = 0
        self._children_ns = 0

    def __enter__(self) -> "Span":
        self.start_ns = time.time_ns()
        self._rf = torch.profiler.record_function(self.name)
        self._rf.__enter__()
        _stack().append(self)
        if self.name == BACKWARD:
            with _lock:
                _backward.append(self)
        return self

    def __exit__(self, *exc) -> bool:
        _stack().pop()
        if self.name == BACKWARD:
            with _lock:
                _backward.remove(self)
        self._rf.__exit__(*exc)
        self._rf = None
        self.end_ns = time.time_ns()
        _close(self)
        return False

    def set(self, **attrs) -> None:
        """Attributes known only inside the span (a request's rows)."""
        self.attrs.update(attrs)


class _Off:
    """The span while tracing is off."""

    __slots__ = ()

    def __enter__(self) -> "_Off":
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def set(self, **attrs) -> None:
        pass


_OFF = _Off()


class _Total:
    __slots__ = ("count", "total_ns", "self_ns", "under")

    def __init__(self):
        self.count = 0
        self.total_ns = self.self_ns = 0
        self.under: dict[str | None, int] = defaultdict(int)


_lock = threading.Lock()
_local = threading.local()
_records: list[Span] = []
_totals: dict[str, _Total] = {}
# the open backward spans, innermost last
_backward: list[Span] = []


def _stack() -> list[Span]:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


def _total(name: str) -> _Total:
    t = _totals.get(name)
    if t is None:
        t = _totals[name] = _Total()
    return t


def _close(s: Span) -> None:
    dur = s.end_ns - s.start_ns
    with _lock:
        t = _total(s.name)
        t.count += 1
        t.total_ns += dur
        t.self_ns += dur - s._children_ns
        t.under[s.parent.name if s.parent is not None else None] += dur
        if s.parent is not None:
            s.parent._children_ns += dur
        if len(_records) < MAX_RECORDS:
            _records.append(s)


def enabled() -> bool:
    """Whether a ``torch.profiler`` records, and so spans record."""
    return _profiler._is_profiler_enabled


def span(name: str, id=None, **attrs):
    """A context manager: the span ``name`` while tracing is on, else
    nothing. ``id``: the iteration or request, by default the parent's."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return Span(name, id, attrs)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` while tracing is on."""
    if not _profiler._is_profiler_enabled:
        return
    with _lock:
        _total(name).count += n


def summary() -> dict[str, dict]:
    """name -> ``count``, ``total_ms``, ``self_ms`` and ``under`` (parent's
    name, None at the top -> ms), over every span closed and counter added
    since the last :func:`reset`."""
    with _lock:
        return {name: {"count": t.count, "total_ms": t.total_ns / 1e6, "self_ms": t.self_ns / 1e6,
                       "under": {p: ns / 1e6 for p, ns in t.under.items()}}
                for name, t in _totals.items()}


def records() -> list[Span]:
    """The closed spans in the order they closed, the first
    :data:`MAX_RECORDS` of them."""
    with _lock:
        return list(_records)


def reset() -> None:
    with _lock:
        _records.clear()
        _totals.clear()
