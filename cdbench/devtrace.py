"""The device trace of a ``--trace 1`` run, and what the host did meanwhile.

``Tracer`` wraps the measured window in ``torch.profiler`` with CUDA
activity only (the device's kernels, copies and sets; no host operator
events, which would cost far more), and samples the host's threads every
``SAMPLE_S`` seconds: for each thread, the innermost frame inside the
program's package and its nearest caller there. Two marker kernels,
launched on an idle device at known host times at the window's two ends,
align the trace's clock with the host's.

``TraceSummary`` holds, over the timed units' intervals, the seconds in
which any device operation ran (``busy_s``), the traced length
(``window_s``), the device seconds of each operation by name, and the idle
gaps named by what the host was sampled doing in them.
"""
from __future__ import annotations

import bisect
import collections
import os
import sys
import threading
import time
from dataclasses import dataclass, field

import torch

#: host sampling period (seconds)
SAMPLE_S = 0.005
#: cycles of the marker kernels (a few microseconds on the card)
MARK_CYCLES = 20000
#: longest name kept for an operation (characters)
NAME_CHARS = 120
#: entries of each breakdown list
TOP = 10


class HostSampler(threading.Thread):
    """Samples, per thread, the innermost frames inside ``package_dir``."""

    def __init__(self, package_dir: str):
        super().__init__(name="cdbench-sampler", daemon=True)
        self.package_dir = package_dir
        self.samples: list = []          # (host seconds, label)
        self._halt = threading.Event()

    def label(self, frame) -> str | None:
        """The innermost program frame, after its nearest program caller
        in another function (``caller > leaf``)."""
        names = []
        while frame is not None and len(names) < 2:
            path = frame.f_code.co_filename
            if path.startswith(self.package_dir):
                rel = os.path.relpath(path, self.package_dir)
                name = f"{rel}:{frame.f_code.co_name}"
                if not names or names[-1] != name:
                    names.append(name)
            frame = frame.f_back
        return " > ".join(reversed(names)) if names else None

    def run(self) -> None:
        me = threading.get_ident()
        while not self._halt.wait(SAMPLE_S):
            now = time.perf_counter()
            for tid, frame in sys._current_frames().items():
                if tid != me:
                    lab = self.label(frame)
                    if lab is not None:
                        self.samples.append((now, lab))

    def stop(self) -> None:
        self._halt.set()
        self.join()


@dataclass
class TraceSummary:
    busy_s: float
    window_s: float
    op_s: dict = field(default_factory=dict)        # name → device seconds
    idle_s: dict = field(default_factory=dict)      # host label → idle s
    n_events: int = 0

    @property
    def idle_pct(self) -> float:
        return 100.0 * (1.0 - self.busy_s / self.window_s)

    def kernel_s(self, fragment: str) -> float:
        """Device seconds of the operations whose name holds ``fragment``."""
        return sum(s for n, s in self.op_s.items() if fragment in n)

    def breakdown(self) -> dict:
        top = sorted(self.op_s.items(), key=lambda kv: -kv[1])[:TOP]
        gaps = sorted(self.idle_s.items(), key=lambda kv: -kv[1])[:TOP]
        return {"device_ops": [[n[:NAME_CHARS], s] for n, s in top],
                "idle_gaps": [[n[:NAME_CHARS], s] for n, s in gaps]}


def _device_events(prof) -> list:
    """(name, start ns, end ns) of every device operation in the trace."""
    out = []
    for e in prof.profiler.kineto_results.events():
        if str(e.device_type()).rsplit(".", 1)[-1] != "CUDA":
            continue
        s = int(e.start_ns())
        out.append((e.name(), s, s + int(e.duration_ns())))
    out.sort(key=lambda x: x[1])
    return out


def _union(intervals: list) -> list:
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _clip(intervals: list, windows: list) -> list:
    """The parts of sorted disjoint ``intervals`` inside sorted disjoint
    ``windows``."""
    out, i = [], 0
    for ws, we in windows:
        while i < len(intervals) and intervals[i][1] <= ws:
            i += 1
        j = i
        while j < len(intervals) and intervals[j][0] < we:
            s, e = max(intervals[j][0], ws), min(intervals[j][1], we)
            if e > s:
                out.append([s, e])
            j += 1
    return out


class Tracer:
    """The profiler and the host sampler around one measured window."""

    def __init__(self, device: torch.device):
        import repro_torch
        self.device = device
        self.sampler = HostSampler(os.path.dirname(repro_torch.__file__))
        self.prof = None

    def _mark(self) -> int:
        torch.cuda.synchronize(self.device)
        t = time.perf_counter_ns()
        with torch.cuda.device(self.device):
            torch.cuda._sleep(MARK_CYCLES)
        torch.cuda.synchronize(self.device)
        return t

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile
        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.start()
        self.h0 = self._mark()
        self.sampler.start()

    def stop(self) -> None:
        self.sampler.stop()
        self.h1 = self._mark()
        self.prof.stop()

    def summary(self, intervals: list) -> TraceSummary:
        """The trace over the host-clock ``intervals`` (seconds)."""
        ev = _device_events(self.prof)
        if len(ev) < 2:
            raise RuntimeError("the trace holds no device operation")
        first, last = ev[0], ev[-1]
        ev = ev[1:-1]
        # host ns → trace ns, from the two markers' launches
        scale = (last[1] - first[1]) / max(self.h1 - self.h0, 1)
        to_dev = lambda t: first[1] + (t * 1e9 - self.h0) * scale  # noqa: E731
        to_host = lambda d: (self.h0 + (d - first[1]) / scale) / 1e9  # noqa: E731
        windows = _union([[to_dev(a), to_dev(b)] for a, b in intervals])
        busy = _clip(_union([[s, e] for _, s, e in ev]), windows)
        op_s = collections.Counter()
        for name, s, e in ev:
            for cs, ce in _clip([[s, e]], windows):
                op_s[name] += (ce - cs) / 1e9
        gaps = []
        for ws, we in windows:
            cur = ws
            for bs, be in _clip(busy, [[ws, we]]):
                if bs > cur:
                    gaps.append((cur, bs))
                cur = max(cur, be)
            if we > cur:
                gaps.append((cur, we))
        samples = self.sampler.samples
        times = [t for t, _ in samples]
        idle = collections.Counter()
        for gs, ge in gaps:
            a, b = bisect.bisect_left(times, to_host(gs)), bisect.bisect_right(
                times, to_host(ge))
            labs = collections.Counter(lab for _, lab in samples[a:b])
            label = (labs.most_common(1)[0][0] if labs
                     else f"gaps under {SAMPLE_S * 1e3:g} ms")
            idle[label] += (ge - gs) / 1e9
        window_s = sum(e - s for s, e in windows) / 1e9
        busy_s = sum(e - s for s, e in busy) / 1e9
        return TraceSummary(busy_s=busy_s, window_s=window_s, op_s=dict(op_s),
                            idle_s=dict(idle), n_events=len(ev))


__all__ = ["HostSampler", "TraceSummary", "Tracer"]
