"""The trace's reduction: busy time, idle gaps named by the host sampler,
operation seconds, all inside the timed units; on fake device events."""
import os
import sys

import pytest

from cdbench import devtrace


class FakeTracer(devtrace.Tracer):
    def __init__(self, samples, h0, h1):
        self.prof = None
        self.sampler = devtrace.HostSampler("/nowhere")
        self.sampler.samples = samples
        self.h0, self.h1 = h0, h1


def test_summary_over_the_units(monkeypatch):
    # host: window 1.000–1.010 s; device clock: 5,000,000 ns ↔ 1.000 s
    ev = [("mark", 5_000_000, 5_000_010), ("k1", 5_000_100, 5_001_000),
          ("k2", 5_000_500, 5_002_000), ("k1", 5_004_000, 5_005_000),
          ("mark", 15_000_000, 15_000_010)]
    monkeypatch.setattr(devtrace, "_device_events", lambda prof: ev)
    t = FakeTracer([(1.0005, "a"), (1.003, "b"), (1.0031, "b")],
                   1_000_000_000, 1_010_000_000)
    s = t.summary([(1.0, 1.01)])
    assert s.busy_s == pytest.approx(2.9e-6)
    assert s.window_s == pytest.approx(0.01)
    assert s.op_s == pytest.approx({"k1": 1.9e-6, "k2": 1.5e-6})
    # the gap after the last kernel, 5,005,000–15,000,000 ns, holds "b"
    assert s.idle_s["b"] == pytest.approx(0.009995)
    assert s.idle_pct == pytest.approx(100 * (1 - 2.9e-4))
    bd = s.breakdown()
    assert bd["device_ops"][0] == ["k1", pytest.approx(1.9e-6)]
    assert bd["idle_gaps"][0][0] == "b"


def test_intervals_outside_the_units_are_left_out(monkeypatch):
    ev = [("mark", 0, 10), ("k", 100, 200), ("k", 1_000, 1_100),
          ("mark", 10_000, 10_010)]
    monkeypatch.setattr(devtrace, "_device_events", lambda prof: ev)
    t = FakeTracer([], 0, 10_000)
    s = t.summary([(0.0, 500e-9)])
    assert s.window_s == pytest.approx(500e-9)
    assert s.busy_s == pytest.approx(100e-9)


def test_sampler_names_leaf_and_caller():
    here = os.path.dirname(os.path.abspath(__file__))
    sampler = devtrace.HostSampler(here)

    def leaf():
        return sampler.label(sys._getframe())

    def caller():
        return leaf()

    assert caller() == ("test_cdbench_devtrace.py:caller > "
                        "test_cdbench_devtrace.py:leaf")
