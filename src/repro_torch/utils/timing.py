"""Lightweight wall-clock timing helpers for benchmarks and the runtime:
``Timer`` and ``timed`` are the JAX package's ``utils/timing.py``, the same
semantics on the host clock (``time.perf_counter``). A caller timing work
on the card synchronizes before a section ends.

``SpanLog`` records nested spans (a name, start and end on
``time.perf_counter_ns``, ids of the span, its parent and its trace) in a
bounded ring: the clock of a benchmark's timed units and of a device trace
aligned to the host, so every span can be laid over both."""
from __future__ import annotations

import collections
import contextlib
import itertools
import threading
import time
from dataclasses import dataclass, field


@dataclass
class Timer:
    """Accumulating named timer. ``with timer.section("x"): ...``"""

    totals: dict = field(default_factory=dict)
    counts: dict = field(default_factory=dict)

    @contextlib.contextmanager
    def section(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def total(self, name: str) -> float:
        return self.totals.get(name, 0.0)

    def summary(self) -> str:
        return " ".join(f"{k}={v:.3f}s" for k, v in sorted(self.totals.items()))


@contextlib.contextmanager
def timed(out: dict, name: str):
    t0 = time.perf_counter()
    try:
        yield
    finally:
        out[name] = out.get(name, 0.0) + time.perf_counter() - t0


class Span:
    """One span: ``t1_ns`` is None while it is open."""

    __slots__ = ("name", "t0_ns", "t1_ns", "span_id", "parent_id",
                 "trace_id")

    def __init__(self, name, t0_ns, t1_ns, span_id, parent_id, trace_id):
        self.name = name
        self.t0_ns = t0_ns
        self.t1_ns = t1_ns
        self.span_id = span_id
        self.parent_id = parent_id
        self.trace_id = trace_id

    @property
    def seconds(self) -> float:
        return (self.t1_ns - self.t0_ns) * 1e-9

    def __iter__(self):
        """``(name, t0_ns, t1_ns, span_id, parent_id, trace_id)``."""
        return iter((self.name, self.t0_ns, self.t1_ns, self.span_id,
                     self.parent_id, self.trace_id))

    def __repr__(self) -> str:
        return f"Span{tuple(self)!r}"


class SpanLog:
    """Nested spans kept in a ring of the ``capacity`` last closed.

    ``span(name)`` opens a span under the innermost span open on the same
    thread; ``add`` records a span whose start was taken elsewhere, under
    ``parent``. A span takes its parent's trace id; a span with no parent
    starts a trace, numbered by the log. A span is kept when it closes, so
    a parent follows its children; ``dropped`` counts what fell off the
    ring. ``recorded`` counts every span kept so far: ``since(recorded)``
    returns the spans kept after that point, ``since(0)`` all the ring
    holds. Thread-safe; ``capacity`` 0 keeps nothing.
    """

    def __init__(self, capacity: int = 4096):
        self._ring: collections.deque = collections.deque(maxlen=capacity)
        self._lock = threading.Lock()
        self._local = threading.local()
        self._ids = itertools.count(1)
        self._traces = itertools.count(1)
        self.recorded = 0

    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def _new(self, name: str, t0_ns: int, t1_ns, parent) -> Span:
        if parent is None:
            return Span(name, t0_ns, t1_ns, next(self._ids), None,
                        next(self._traces))
        return Span(name, t0_ns, t1_ns, next(self._ids), parent.span_id,
                    parent.trace_id)

    def _keep(self, sp: Span) -> None:
        with self._lock:
            self._ring.append(sp)
            self.recorded += 1

    @property
    def dropped(self) -> int:
        """Spans that fell off the ring."""
        return max(0, self.recorded - self._ring.maxlen)

    def span(self, name: str) -> "_Open":
        """``with log.span(name) as sp:`` — ``sp`` is the open ``Span``; it
        closes, and is kept, when the block ends, raising or not."""
        stack = self._stack()
        sp = self._new(name, time.perf_counter_ns(), None,
                       stack[-1] if stack else None)
        stack.append(sp)
        return _Open(self, stack, sp)

    def add(self, name: str, t0_ns: int, t1_ns: int,
            parent: Span | None = None) -> Span:
        """Record a closed span timed elsewhere (``perf_counter_ns``)."""
        sp = self._new(name, int(t0_ns), int(t1_ns), parent)
        self._keep(sp)
        return sp

    def since(self, mark: int) -> list:
        """The spans kept after ``recorded`` read ``mark``, oldest first (as
        many as the ring still holds)."""
        with self._lock:
            n = min(self.recorded - mark, len(self._ring))
            return list(itertools.islice(self._ring, len(self._ring) - n,
                                         None))


class _Open:
    """The context manager of one open span (a class: cheaper than a
    generator's)."""

    __slots__ = ("log", "stack", "sp")

    def __init__(self, log: SpanLog, stack: list, sp: Span):
        self.log, self.stack, self.sp = log, stack, sp

    def __enter__(self) -> Span:
        return self.sp

    def __exit__(self, *exc) -> None:
        self.sp.t1_ns = time.perf_counter_ns()
        self.stack.pop()
        self.log._keep(self.sp)


def subtree(records: list, root: Span) -> list:
    """``root`` and the spans under it among ``records`` (closing order:
    a parent closes after its children), in the same order."""
    ids, out = {root.span_id}, []
    for r in reversed(records):
        if r is root or r.parent_id in ids:
            ids.add(r.span_id)
            out.append(r)
    return out[::-1]


def span_total(records: list, name: str) -> float:
    """Seconds of the spans named ``name`` among ``records``, summed."""
    return sum(r.seconds for r in records if r.name == name)


def self_seconds(sp: Span, records: list) -> float:
    """``sp``'s seconds less what its children among ``records`` cover."""
    kids = sorted((max(r.t0_ns, sp.t0_ns), min(r.t1_ns, sp.t1_ns))
                  for r in records if r.parent_id == sp.span_id)
    covered, end = 0, sp.t0_ns
    for a, b in kids:
        a = max(a, end)
        if b > a:
            covered += b - a
            end = b
    return sp.seconds - covered * 1e-9


__all__ = ["Span", "SpanLog", "Timer", "self_seconds", "span_total",
           "subtree", "timed"]
