"""The port's chunk prefetcher and the engine's staged scan, on the CPU.

The prefetcher's contract, as the JAX package's tests hold it: order at
every depth, telemetry, a raising stage as a typed ``PipelineStageError``
with the engine still reusable, a slow stage. The engine's scan through the
``SlabRing`` gives the same four grids, bit for bit, and the same decisions
at depths 0, 1 and 2 — also when the kernel is slower than the staging, so
the producer has to wait for a slot still being read.
"""
import torch_threads  # noqa: F401  (caps torch's threads a worker)
import threading
import time

import faults
import numpy as np
import pytest

from repro_torch.core import CopyConfig, DetectionEngine, build_index, engine
from repro_torch.core import index_detect_exact
from repro_torch.core.pipeline import ChunkPrefetcher, PipelineStageError
from repro_torch.core.types import ClaimsDataset

CFG = CopyConfig(alpha=0.1, s=0.8, n=50.0)


def _world(seed=0, n_src=40, n_items=160):
    rng = np.random.default_rng(seed)
    values = np.where(rng.random((n_src, n_items)) < 0.4,
                      rng.integers(0, 4, (n_src, n_items)),
                      -1).astype(np.int32)
    acc = rng.uniform(0.3, 0.95, n_src).astype(np.float32)
    p = np.where(values == 0, 0.9, 0.05).astype(np.float32)
    return ClaimsDataset(values=values, accuracy=acc), p


def _wait_threads(n0):
    deadline = time.monotonic() + 5
    while threading.active_count() > n0 and time.monotonic() < deadline:
        time.sleep(0.01)
    assert threading.active_count() == n0


@pytest.mark.parametrize("depth", [0, 1, 3])
def test_prefetcher_preserves_order_and_telemetry(depth):
    """Items arrive in descriptor order; depth=0 stages inline (stage_wait
    == staging by construction), depth ≥ 1 on a worker thread."""
    staged = []

    def stage(d):
        staged.append((d, threading.current_thread()
                       is threading.main_thread()))
        return d * 10
    pf = ChunkPrefetcher(list(range(5)), stage, depth=depth)
    try:
        assert list(pf) == [0, 10, 20, 30, 40]
    finally:
        pf.close()
    assert [d for d, _ in staged] == [0, 1, 2, 3, 4]
    assert {m for _, m in staged} == ({True} if depth == 0 else {False})
    assert pf.staging_s >= 0 and pf.stage_wait_s >= 0
    if depth == 0:
        assert pf.stage_wait_s == pf.staging_s


def test_prefetcher_raising_stage_is_a_typed_error():
    n0 = threading.active_count()

    def stage(d):
        if d == 2:
            raise faults.InjectedFault("boom at 2")
        return d
    pf = ChunkPrefetcher(list(range(6)), stage, depth=2)
    got = []
    with pytest.raises(PipelineStageError, match="boom at 2") as ei:
        for item in pf:
            got.append(item)
    assert isinstance(ei.value.__cause__, faults.InjectedFault)
    pf.close()
    assert got == [0, 1]
    _wait_threads(n0)


def test_prefetcher_slow_stage_keeps_order_and_counts_waits():
    def stage(d):
        time.sleep(0.02)
        return d
    pf = ChunkPrefetcher(list(range(4)), stage, depth=1)
    try:
        assert list(pf) == [0, 1, 2, 3]
    finally:
        pf.close()
    assert pf.staging_s >= 0.08
    assert pf.stage_wait_s > 0


def _scan(eng, ds, p, idx):
    ctx = eng._tiled_prologue(ds, p, idx)
    grids, run = eng._run_tiled_scan(ctx)
    return ctx, [g.numpy().copy() for g in grids], run


SCAN = dict(tile=16, n_buckets=12, device="cpu")


@pytest.fixture(scope="module")
def scan_world():
    """A world, its index, the depth-0 scan's grids and the exact INDEX."""
    ds, p = _world(5, n_src=50, n_items=160)
    idx = build_index(ds, p, CFG, chunk_entries=16, device="cpu")
    _, grids, _ = _scan(DetectionEngine(CFG, prefetch_depth=0, **SCAN), ds,
                        p, idx)
    return ds, p, idx, grids, index_detect_exact(ds, p, CFG, index=idx)


@pytest.mark.parametrize("depth", [0, 1, 2])
def test_depths_give_equal_grids_and_decisions(scan_world, depth):
    ds, p, idx, want, exact = scan_world
    eng = DetectionEngine(CFG, prefetch_depth=depth, **SCAN)
    _, got, _ = _scan(eng, ds, p, idx)
    assert eng._scan_stats["groups_run"] > depth + 1   # the ring wraps
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    res = eng.detect(ds, p, index=idx)
    np.testing.assert_array_equal(res.copying, exact.copying)
    st = eng.last_stats
    assert st["prefetch_depth"] == depth
    assert min(st["staging_s"], st["stage_wait_s"], st["compute_wait_s"]) >= 0


def test_slow_kernel_never_sees_a_refilled_slot(scan_world, monkeypatch):
    """With the kernel slower than the staging, the producer runs ahead
    until every slot is taken and must wait for the slot's reader: the
    grids still equal the synchronous scan's bit for bit."""
    ds, p, idx, want, _ = scan_world
    real = engine.group_tile_scores

    def slow(v, *args, **kwargs):
        snapshot = v.clone()
        time.sleep(0.01)
        assert bool((v == snapshot).all()), "slab changed under the kernel"
        return real(v, *args, **kwargs)
    monkeypatch.setattr(engine, "group_tile_scores", slow)
    eng = DetectionEngine(CFG, prefetch_depth=2, **SCAN)
    _, got, _ = _scan(eng, ds, p, idx)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert eng._scan_stats["compute_wait_s"] > 0


def test_engine_stage_fault_is_typed_and_engine_reusable(monkeypatch):
    ds, p = _world(3)
    idx = build_index(ds, p, CFG, device="cpu")
    eng = DetectionEngine(CFG, tile=16, prefetch_depth=2, device="cpu")
    ref = eng.detect(ds, p, index=idx)
    n0 = threading.active_count()

    def broken(*args, **kwargs):
        raise faults.InjectedFault("injected staging fault")
    with monkeypatch.context() as m:
        m.setattr(DetectionEngine, "_fill_group", broken)
        with pytest.raises(PipelineStageError, match="injected staging"):
            eng.detect(ds, p, index=idx)
    _wait_threads(n0)
    again = eng.detect(ds, p, index=idx)
    np.testing.assert_array_equal(again.copying, ref.copying)
