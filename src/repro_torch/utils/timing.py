"""Lightweight wall-clock timing helpers for benchmarks and the runtime: the
JAX package's ``utils/timing.py``, the same semantics on the host clock
(``time.perf_counter``). A caller timing work on the card synchronizes
before a section ends."""
from __future__ import annotations

import contextlib
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


__all__ = ["Timer", "timed"]
