"""The program's host spans and counters, kept while a profiler records.

Tracing is on exactly while a ``torch.profiler`` session is recording:
``render --profile DIR`` and any caller that profiles the program (a
benchmark's traced run) turn it on, and nothing else does. Off, ``span``
returns one shared no-op context after that single check, reading no
clock and allocating nothing, and ``count`` adds its int to the counter's
total, which is always kept (``total``: the ``launch.*`` counts of the
kernel wrappers).

On, each ``span(name, request, arg)`` leaves a ``Span`` row: its start and
end on ``time.perf_counter()``, the id of the enclosing span of the same
thread (``parent``), the serial of the ``Renderer`` it worked for
(``request``: given, else the enclosing span's), so one live edit's
rebuild and chunk share an id, and the int ``arg`` it was given (the
frames of ``render.tail``). Each ``count`` leaves a ``Count`` row; a
device scalar is copied to pinned memory behind the work queued before
it and read only by ``rows()``, so the render gains no host wait. The
collector's passes are ``gc`` spans (``arg``: the generation), whoever
triggered them. The rows live in memory, the newest ``MAX_ROWS``.

The ``wait.<site>`` spans are one family: each holds only calls that
block the host on the card, and its ``arg`` is how many of them it holds
(a scalar or a table copied from pageable host memory, a copy to the
host, a ``float`` or ``int`` of a device value, a stream or event
synchronisation). On the card the host sits in such a call until the
stream has drained, so whatever host work follows it runs while the card
idles. The spans are kept on every device alike, so the CPU tests see
which sites a path passes and how many calls each holds; off, each costs
what any span costs.

No span puts an event on the card's timeline: the rows stay here, and
nothing calls ``torch.profiler.record_function``, whose ranges the
profiler copies onto the card's timeline, where they would read as busy
time. ``chrome_events`` turns the rows into Chrome trace events on a
trace's clock, which ``clock_map`` gives from two paired readings of both
clocks (``cli.py:_profiled``).
"""

from __future__ import annotations

import collections
import gc
import itertools
import threading
import time
from typing import NamedTuple

import torch
from torch.autograd import profiler as _profiler

MAX_ROWS = 1 << 18


class Span(NamedTuple):
    name: str
    start: float
    end: float
    parent: int | None
    request: int | None
    id: int
    arg: int | None = None  # gc: the generation collected; else the caller's


class Count(NamedTuple):
    name: str
    time: float
    value: object  # an int, or a device scalar's pending copy until rows()
    request: int | None


# plain tuples while recording (a NamedTuple costs more to build): a span
# has Span's 7 fields, a count Count's 4
_rows: collections.deque = collections.deque(maxlen=MAX_ROWS)
_totals: dict[str, int] = {}
_ids = itertools.count()
_local = threading.local()


def enabled() -> bool:
    """Whether a profiler session is recording, and so the rows are kept."""
    return _profiler._is_profiler_enabled


def _stack() -> list:
    """The open spans of this thread, innermost last."""
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


class _Off:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _On:
    __slots__ = ("name", "request", "arg", "id", "parent", "start")

    def __init__(self, name: str, request: int | None, arg: int | None):
        self.name = name
        self.request = request
        self.arg = arg

    def __enter__(self):
        stack = _stack()
        outer = stack[-1] if stack else None
        self.parent = None if outer is None else outer.id
        if self.request is None and outer is not None:
            self.request = outer.request
        self.id = next(_ids)
        stack.append(self)
        self.start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter()
        _stack().pop()
        _rows.append((self.name, self.start, end, self.parent, self.request, self.id, self.arg))
        return False


def span(name: str, request: int | None = None, arg: int | None = None):
    """A context manager that records the host's time in ``name`` (with
    ``arg``, an int the row keeps) while tracing; the shared no-op context
    otherwise."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return _On(name, request, arg)


class _Pinned:
    """A device scalar's copy to pinned memory, queued behind the work
    before it and read when the rows are."""

    __slots__ = ("host", "event", "value")

    def __init__(self, t: torch.Tensor):
        self.host = torch.empty((), dtype=t.dtype, pin_memory=True)
        self.host.copy_(t, non_blocking=True)
        self.event = torch.cuda.Event()
        self.event.record()
        self.value = None

    def read(self) -> int:
        if self.value is None:
            self.event.synchronize()
            self.value = int(self.host)
        return self.value


def count(name: str, value=1) -> None:
    """Add the int ``value`` to counter ``name`` (its total is always
    kept). While tracing, also leave a row; ``value`` may then be a
    device scalar, recorded as it stands once the work queued before it
    is done, and left out of the total."""
    if not _profiler._is_profiler_enabled:
        _totals[name] = _totals.get(name, 0) + value
        return
    if isinstance(value, torch.Tensor):
        value = _Pinned(value) if value.device.type == "cuda" else int(value)
    else:
        _totals[name] = _totals.get(name, 0) + value
    stack = _stack()
    _rows.append((name, time.perf_counter(), value, stack[-1].request if stack else None))


def total(name: str) -> int:
    """The sum of every int ``count(name, ...)`` of the process so far."""
    return _totals.get(name, 0)


def rows() -> list:
    """Every kept row, ``Span`` and ``Count``, in the order they closed;
    a device scalar's count waits here for its copy."""
    return [Span._make(r) if len(r) == 7 else
            Count(r[0], r[1], r[2].read() if isinstance(r[2], _Pinned) else r[2], r[3])
            for r in list(_rows)]


def clear() -> None:
    """Drop every kept row (the totals stay)."""
    _rows.clear()


def _on_gc(phase: str, info: dict) -> None:
    if not _profiler._is_profiler_enabled:
        return
    if phase == "start":
        _local.gc_start = time.perf_counter()
        return
    start = getattr(_local, "gc_start", None)
    if start is None:
        return
    _local.gc_start = None
    stack = _stack()
    outer = stack[-1] if stack else None
    _rows.append(("gc", start, time.perf_counter(), None if outer is None else outer.id,
                  None if outer is None else outer.request, next(_ids), info["generation"]))


gc.callbacks.append(_on_gc)


def clock_map(p0: float, t0: float, p1: float, t1: float):
    """The linear map of ``time.perf_counter()`` times onto another clock
    that takes ``p0`` to ``t0`` and ``p1`` to ``t1``: two paired readings
    of both clocks, one at each end of the stretch recorded, so that a
    difference in rate between the clocks is spread over the stretch
    rather than piled up at its far end. ``t`` is in the other clock's
    unit (seconds, microseconds)."""
    scale = (t1 - t0) / (p1 - p0)
    return lambda p: t0 + (p - p0) * scale


def chrome_events(rows_, to_us, pid: int, tid: int) -> list[dict]:
    """The rows as Chrome trace events of one track (``pid``, ``tid``):
    a span as a complete event ``spectral.<name>``, a count as an instant
    event with its value; ``to_us(t)`` maps a ``perf_counter`` time onto
    the trace's clock in microseconds."""
    out = [{"ph": "M", "name": "thread_name", "pid": pid, "tid": tid,
            "args": {"name": "spectral_tpu_torch spans"}}]
    for r in rows_:
        args = {"request": r.request}
        if isinstance(r, Span):
            args.update(id=r.id, parent=r.parent)
            if r.arg is not None:
                args["generation" if r.name == "gc" else "arg"] = r.arg
            out.append({"ph": "X", "cat": "spectral", "name": f"spectral.{r.name}",
                        "pid": pid, "tid": tid, "ts": to_us(r.start),
                        "dur": (r.end - r.start) * 1e6, "args": args})
        else:
            args["value"] = r.value
            out.append({"ph": "i", "s": "t", "cat": "spectral", "name": f"spectral.{r.name}",
                        "pid": pid, "tid": tid, "ts": to_us(r.time), "args": args})
    return out
