"""The port's span log (``repro_torch.utils.timing.SpanLog``) and the spans
the tiled pass and the detection service record on it.

``SpanLog`` alone: parents and trace ids across nesting and across two
threads (a span with no parent starts a trace the log numbers), ``add``,
the ring's bound and its ``dropped`` count, ``since``, ``subtree`` and
self time. A tiny ``bucketed`` pass: every named span present and nested,
``last_stats``' timing keys equal to their spans, every span inside the
wall interval the caller timed with ``time.perf_counter`` (the clock of
the benchmark's units and of its device trace); the owner fan-out's merge
is a ``scan.merge`` span. A service batch of three requests against its
committed index: one ``batch`` span with the transient commit, the pass
and the rollback under it in one trace, its spans' seconds in
``ServiceStats.span_s`` / ``span_n``; a batch whose pass raises still
closes its rollback and its batch.
"""
import torch_threads  # noqa: F401  (caps torch's threads a worker)
import threading
import time

import pytest

from repro_torch.core import CopyConfig, DetectionEngine, build_index
from repro_torch.core import serving
from repro_torch.core.serving import (
    DetectionService,
    DetectRequest,
    ReplicaRouter,
)
from repro_torch.data.claims import (
    SyntheticSpec,
    oracle_claim_probs,
    synthetic_claims,
    synthetic_query_rows,
)
from repro_torch.utils.timing import (
    SpanLog,
    self_seconds,
    span_total,
    subtree,
)

CFG = CopyConfig(alpha=0.1, s=0.8, n=50.0)
KW = dict(tile=32, device="cpu")
PASS_SPANS = {
    "detect": None,
    "index_build": "detect",
    "index_build.sort": "index_build",
    "prologue": "detect",
    "prologue.rechunk": "prologue",
    "scan": "detect",
    "finalize": "detect",
    "finalize.rescore": "finalize",
}
#: last_stats' timing keys and the spans they are read off
STAT_SPANS = {
    "index_build_s": "index_build",
    "index_build_sort_s": "index_build.sort",
    "prologue_s": "prologue",
    "rechunk_s": "prologue.rechunk",
    "scan_s": "scan",
    "rescore_s": "finalize.rescore",
    "finalize_s": "finalize",
}


@pytest.fixture(scope="module")
def world():
    sc = synthetic_claims(SyntheticSpec(n_sources=80, n_items=400,
                                        coverage="stock", n_cliques=4, seed=0))
    return sc, oracle_claim_probs(sc)


def _by_name(records):
    out = {}
    for r in records:
        assert r.name not in out, f"two {r.name} spans"
        out[r.name] = r
    return out


def _requests(sc, n, rid0=100):
    vals, acc, pq, _ = synthetic_query_rows(sc, n, seed=3)
    return [DetectRequest(rid=rid0 + i, values=vals[i:i + 1],
                          accuracy=acc[i:i + 1], p_claim=pq[i:i + 1])
            for i in range(n)]


def _is_root(log):
    """True when no span is open on this thread: a new span has no parent."""
    with log.span("probe") as probe:
        pass
    return probe.parent_id is None


# -- SpanLog -----------------------------------------------------------------

def test_nesting_gives_parents_and_inherits_the_trace():
    log = SpanLog()
    with log.span("a") as a:
        with log.span("b") as b:
            with log.span("c") as c:
                pass
        with log.span("d") as d:
            pass
    with log.span("e") as e:
        pass
    assert [r.name for r in log.since(0)] == ["c", "b", "d", "a", "e"]
    assert (a.parent_id, b.parent_id, c.parent_id, d.parent_id) == (
        None, a.span_id, b.span_id, a.span_id)
    assert e.parent_id is None
    # a root starts a trace; its spans share it; the next root starts another
    assert (a.trace_id, b.trace_id, c.trace_id, d.trace_id) == (1, 1, 1, 1)
    assert e.trace_id == 2
    name, t0, t1, sid, pid, tid = c
    assert (name, sid, pid, tid) == ("c", c.span_id, b.span_id, 1)
    assert a.t0_ns <= b.t0_ns <= c.t0_ns <= c.t1_ns <= b.t1_ns <= d.t0_ns
    assert d.t1_ns <= a.t1_ns <= e.t0_ns
    assert subtree(log.since(0), b) == [c, b]
    assert subtree(log.since(0), a) == [c, b, d, a]


def test_each_thread_nests_under_its_own_open_span():
    log = SpanLog()
    ready, go = threading.Barrier(2), threading.Event()
    seen = {}

    def work(tag):
        with log.span(f"outer-{tag}") as outer:
            ready.wait()
            go.wait(5)
            with log.span(f"inner-{tag}") as inner:
                seen[tag] = (outer, inner)

    threads = [threading.Thread(target=work, args=(t,)) for t in (1, 2)]
    for t in threads:
        t.start()
    go.set()
    for t in threads:
        t.join()
    for outer, inner in seen.values():
        assert inner.parent_id == outer.span_id
        assert inner.trace_id == outer.trace_id
        assert outer.parent_id is None
    assert {o.trace_id for o, _ in seen.values()} == {1, 2}
    assert log.recorded == 4 and log.dropped == 0


def test_a_span_closes_when_its_body_raises():
    log = SpanLog()
    with pytest.raises(ValueError):
        with log.span("boom") as sp:
            raise ValueError
    assert sp.t1_ns is not None and log.since(0) == [sp]
    assert _is_root(log)


def test_add_records_a_closed_span_with_no_implicit_parent():
    log = SpanLog()
    t0 = time.perf_counter_ns()
    with log.span("open") as open_:
        q = log.add("queue", t0, t0 + 2_000_000_000)
        kid = log.add("kid", t0, t0 + 1, parent=open_)
    assert q.parent_id is None and q.trace_id != open_.trace_id
    assert (kid.parent_id, kid.trace_id) == (open_.span_id, open_.trace_id)
    assert q.seconds == 2.0
    assert log.since(0) == [q, kid, open_]


def test_the_ring_keeps_the_newest_and_counts_what_fell_off():
    log = SpanLog(capacity=3)
    for i in range(5):
        with log.span(f"s{i}"):
            pass
    assert [r.name for r in log.since(0)] == ["s2", "s3", "s4"]
    assert log.dropped == 2 and log.recorded == 5
    assert [r.name for r in log.since(3)] == ["s3", "s4"]
    assert [r.name for r in log.since(0)] == ["s2", "s3", "s4"]
    nothing = SpanLog(capacity=0)
    with nothing.span("x"):
        pass
    assert nothing.since(0) == [] and nothing.dropped == 1


def test_self_time_leaves_out_what_children_cover():
    log = SpanLog()
    root = log.add("root", 0, 10_000)
    kids = [log.add("a", 1_000, 4_000, parent=root),
            log.add("b", 3_000, 5_000, parent=root),
            log.add("c", 9_000, 12_000, parent=root),
            log.add("x", 0, 10_000)]
    records = log.since(0)
    # covered: [1, 5) and [9, 10) µs of [0, 10)
    assert self_seconds(root, records) == pytest.approx(5e-6)
    assert span_total(records, "a") == pytest.approx(3e-6)
    assert span_total(records, "missing") == 0
    assert kids[-1] not in subtree(records, root)


# -- the tiled pass ------------------------------------------------------------

def test_a_pass_records_every_named_span_nested(world):
    sc, p = world
    eng = DetectionEngine(CFG, mode="bucketed", **KW)
    t0 = time.perf_counter()
    res = eng.detect(sc.dataset, p)
    t1 = time.perf_counter()
    recs = eng.spans.since(0)
    by = _by_name(recs)
    assert set(by) == set(PASS_SPANS)
    for name, parent in PASS_SPANS.items():
        want = None if parent is None else by[parent].span_id
        assert by[name].parent_id == want, name
    assert {r.trace_id for r in recs} == {by["detect"].trace_id}
    for r in recs:
        assert t0 <= r.t0_ns * 1e-9 <= r.t1_ns * 1e-9 <= t1, r.name
    st = eng.last_stats
    for key, name in STAT_SPANS.items():
        assert st[key] == by[name].seconds, key
    assert st["rechunk_s"] <= st["prologue_s"]
    assert st["index_build_sort_s"] <= st["index_build_s"]
    assert res.wall_time_s == pytest.approx(
        (by["finalize"].t1_ns - by["index_build"].t0_ns) * 1e-9)
    # the next pass is a trace of its own
    mark = eng.spans.recorded
    eng.detect(sc.dataset, p)
    again = _by_name(eng.spans.since(mark))
    assert again["detect"].trace_id == by["detect"].trace_id + 1


def test_a_pass_on_a_given_index_records_no_build(world):
    sc, p = world
    eng = DetectionEngine(CFG, mode="bucketed", **KW)
    idx = build_index(sc.dataset, p, CFG, device="cpu")
    eng.detect(sc.dataset, p, index=idx)
    by = _by_name(eng.spans.since(0))
    assert "index_build" not in by and "prologue.rechunk" in by
    assert eng.last_stats["index_build_s"] == 0
    assert eng.last_stats["index_build_sort_s"] == 0


def test_build_index_records_its_stages_only_when_given_a_log(world):
    sc, p = world
    log = SpanLog()
    with log.span("index_build") as top:
        build_index(sc.dataset, p, CFG, device="cpu", spans=log)
    assert [r.name for r in log.since(0)] == ["index_build.sort",
                                              "index_build"]
    assert log.since(0)[0].parent_id == top.span_id
    # no log: the same index, nothing recorded anywhere
    a = build_index(sc.dataset, p, CFG, device="cpu")
    b = build_index(sc.dataset, p, CFG, device="cpu", spans=SpanLog())
    assert a.store.n_entries == b.store.n_entries > 0


def test_the_owner_fanout_merge_is_a_scan_merge_span(world):
    sc, p = world
    ds = sc.dataset
    eng = DetectionEngine(CFG, mode="bucketed", n_shards=2, **KW)
    ctx = eng.owner_scan_context(ds, p)
    parts = [eng.detect_owner_partial(ds, p, s, ctx=ctx) for s in range(2)]
    mark = eng.spans.recorded
    res = eng.finalize_owner_partials(ds, p, ctx, parts)
    by = _by_name(eng.spans.since(mark))
    assert {"scan.merge", "finalize", "finalize.rescore"} <= set(by)
    assert eng.last_stats["merge_s"] == by["scan.merge"].seconds
    assert eng.last_stats["prologue_s"] > 0
    assert eng.last_stats["rechunk_s"] <= eng.last_stats["prologue_s"]
    assert res.wall_time_s >= eng.last_stats["finalize_s"] > 0


# -- the service ---------------------------------------------------------------

def test_a_batch_records_its_queue_commit_pass_and_rollback(world):
    sc, p = world
    svc = DetectionService(sc.dataset, p, CFG, max_batch_requests=8, **KW)
    reqs = _requests(sc, 3)
    mark = svc.engine.spans.recorded
    futs = [svc.submit(r) for r in reqs]
    svc.flush()
    assert [f.result().rid for f in futs] == [r.rid for r in reqs]
    # one queue wait a request, as the service has always recorded them
    assert len(svc.stats.queue_wait_samples) == 3
    recs = svc.engine.spans.since(mark)
    batches = [r for r in recs if r.name == "batch"]
    assert len(batches) == 1
    batch = batches[0]
    under = [r for r in recs if r is not batch]
    assert {r.name for r in under} >= {"serve.commit", "serve.rollback",
                                       "detect", "prologue.rechunk",
                                       "finalize.rescore"}
    # the batch and everything under it are one trace
    assert all(r.trace_id == batch.trace_id for r in under)
    assert set(subtree(recs, batch)) == set(recs)
    by = _by_name(under)
    for name in ("serve.commit", "detect", "serve.rollback"):
        assert by[name].parent_id == batch.span_id, name
    assert (by["serve.commit"].t1_ns <= by["detect"].t0_ns
            <= by["detect"].t1_ns <= by["serve.rollback"].t0_ns)
    # the service's stats hold the batch's seconds and counts by name
    st = svc.stats
    assert st.span_n["batch"] == 1 and st.span_n["serve.commit"] == 1
    assert st.span_s["batch"] == batch.seconds
    assert st.span_s["prologue.rechunk"] == by["prologue.rechunk"].seconds
    assert (st.span_s["serve.commit"] + st.span_s["serve.rollback"]
            + st.span_s["prologue.rechunk"] + st.span_s["finalize.rescore"]
            <= st.span_s["batch"])


def test_the_service_ring_is_bounded(world):
    sc, p = world
    svc = DetectionService(sc.dataset, p, CFG, max_batch_requests=1,
                           result_cache=False, **KW)
    svc.engine.spans = SpanLog(capacity=5)
    for r in _requests(sc, 3):
        svc.submit(r)
    svc.flush()
    log = svc.engine.spans
    assert len(log.since(0)) == 5 and log.dropped == log.recorded - 5
    assert log.since(0)[-1].name == "batch"
    # the stats keep a total a name, whatever the number of batches
    assert svc.stats.span_n["batch"] == 3
    assert set(svc.stats.span_s) == set(svc.stats.span_n)
    fields = {f.name for f in serving._stat_counter_fields()}
    assert not fields & {"span_s", "span_n", "queue_wait_samples"}


def test_a_router_sums_its_replicas_span_seconds(world):
    sc, p = world
    router = ReplicaRouter(sc.dataset, p, CFG, n_replicas=2,
                           max_batch_requests=1, **KW)
    for r in _requests(sc, 2):
        router.submit(r)
    router.flush()
    agg = router.stats
    assert agg.span_n["batch"] == sum(s.stats.span_n["batch"]
                                      for s in router.replicas) == 2
    assert agg.span_s["batch"] == pytest.approx(
        sum(s.stats.span_s["batch"] for s in router.replicas))


def test_a_failed_batch_still_closes_its_rollback_and_batch(world,
                                                              monkeypatch):
    sc, p = world
    svc = DetectionService(sc.dataset, p, CFG, max_batch_requests=8, **KW)

    def boom(*a, **kw):
        raise RuntimeError("pass failed")

    monkeypatch.setattr(svc.engine, "detect", boom)
    mark = svc.engine.spans.recorded
    futs = [svc.submit(r) for r in _requests(sc, 2)]
    svc.flush()
    for f in futs:
        with pytest.raises(RuntimeError):
            f.result()
    assert svc.stats.failed_batches == 1
    recs = svc.engine.spans.since(mark)
    assert [r.name for r in recs] == ["serve.commit", "serve.rollback",
                                      "batch"]
    by = _by_name(recs)
    assert by["serve.rollback"].parent_id == by["batch"].span_id
    assert by["serve.rollback"].t1_ns <= by["batch"].t1_ns
    assert svc.stats.span_n == {"serve.commit": 1, "serve.rollback": 1,
                                "batch": 1}
    assert _is_root(svc.engine.spans)
    # the index is whole again: the next batch answers
    monkeypatch.undo()
    fut = svc.submit(_requests(sc, 1, rid0=7)[0])
    svc.flush()
    assert fut.result().rid == 7
    assert svc.stats.span_n["batch"] == 2
