"""Traffic hardening of the port's detection service under overload.

Deadline propagation (admission shed → queue expiry → post-pass miss), the
adaptive batch limit, failed-pass accounting, the circuit breaker's closed
→ open → half-open → closed cycle, and the stop()-vs-submitters race — the
counterparts of the JAX package's ``tests/test_overload.py``, driven by the
fault helpers below (the JAX harness patches ``repro.core.serving`` and so
cannot drive the port). No real overload is needed: the service's clock is
injectable and the engine pass is wrapped.
"""
import torch_threads  # noqa: F401  (caps torch's threads a worker)
import contextlib
import sys
import threading
import time

import numpy as np
import pytest

import repro_torch.core.serving as serving_mod
from repro_torch.core import CopyConfig
from repro_torch.core.serving import (
    CircuitBreaker,
    DeadlineExceeded,
    DetectionService,
    DetectRequest,
    ReplicaBroadcastError,
    ReplicaRouter,
    ServiceOverloaded,
    ServiceStopped,
)
from repro_torch.data.claims import (
    SyntheticSpec,
    oracle_claim_probs,
    synthetic_claims,
    synthetic_query_rows,
)

CFG = CopyConfig(alpha=0.1, s=0.8, n=50.0)


# ---------------------------------------------------------------------------
# fault helpers
# ---------------------------------------------------------------------------

class InjectedFault(RuntimeError):
    """What an injected fault raises — typed, so a test tells it apart from
    a real failure leaking out of the code under test."""


class FakeClock:
    """A deterministic, manually advanced monotonic clock."""

    def __init__(self, start: float = 0.0):
        self.now = float(start)

    def __call__(self) -> float:
        return self.now

    def advance(self, dt: float) -> float:
        self.now += float(dt)
        return self.now


@contextlib.contextmanager
def failing_writes(svc, n: int = 10 ** 9):
    """``svc.commit`` / ``svc.retract`` raise for the next ``n`` calls; the
    yielded dict's ``left`` is the remaining budget (zero it to heal)."""
    state = {"left": int(n), "injected": 0}
    orig = {"commit": svc.commit, "retract": svc.retract}

    def _make(op):
        def call(*args, **kw):
            if state["left"] > 0:
                state["left"] -= 1
                state["injected"] += 1
                raise InjectedFault(f"injected {op} fault")
            return orig[op](*args, **kw)
        return call

    svc.commit = _make("commit")
    svc.retract = _make("retract")
    try:
        yield state
    finally:
        svc.commit, svc.retract = orig["commit"], orig["retract"]


@contextlib.contextmanager
def wrapped_passes(before):
    """Every ``serve_batch`` pass calls ``before()`` first (a slow or failing
    engine): the module global ``_run_batch`` resolves at call time, so the
    effect lands inside the service's batch timing."""
    orig = serving_mod.serve_batch

    def call(*args, **kw):
        before()
        return orig(*args, **kw)

    serving_mod.serve_batch = call
    try:
        yield
    finally:
        serving_mod.serve_batch = orig


def slow_passes(delay_s: float):
    """Every engine pass sleeps ``delay_s`` first."""
    return wrapped_passes(lambda: time.sleep(delay_s))


@contextlib.contextmanager
def skewed_clock(svc, skew_s: float):
    """Offset the service's deadline clock by ``skew_s`` seconds."""
    orig = svc._clock
    svc._clock = lambda: orig() + skew_s
    try:
        yield
    finally:
        svc._clock = orig


# ---------------------------------------------------------------------------
# world
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def world():
    sc = synthetic_claims(SyntheticSpec(n_sources=48, n_items=240,
                                        coverage="stock", n_cliques=3, seed=4))
    p = oracle_claim_probs(sc)
    vals, acc, pq, _ = synthetic_query_rows(sc, 3, seed=6)
    return sc, p, (vals, acc, pq)


def _req(world, rid, deadline_s=None):
    _, _, (vals, acc, pq) = world
    return DetectRequest(rid=rid, values=vals, accuracy=acc, p_claim=pq,
                         deadline_s=deadline_s)


def _svc(world, **kw):
    sc, p, _ = world
    kw.setdefault("mode", "bucketed")
    return DetectionService(sc.dataset, p, CFG, tile=64, device="cpu", **kw)


def _row(sc, rng):
    D = sc.dataset.n_items
    return (rng.integers(0, 3, (1, D)).astype(np.int32),
            rng.uniform(0.5, 0.9, 1).astype(np.float32),
            rng.uniform(0.2, 0.8, (1, D)).astype(np.float32))


# ---------------------------------------------------------------------------
# deadlines
# ---------------------------------------------------------------------------

def test_deadline_expires_while_queued(world):
    svc = _svc(world)
    clock = FakeClock()
    svc._clock = clock
    f_ddl = svc.submit(_req(world, "ddl", deadline_s=1.0))
    f_free = svc.submit(_req(world, "free"))
    clock.advance(2.0)
    svc.flush()
    with pytest.raises(DeadlineExceeded, match="queued"):
        f_ddl.result(timeout=5)
    assert f_free.result(timeout=5).rid == "free"
    assert svc.stats.expired == 1
    assert svc.stats.rejected == 0
    assert svc.stats.requests == 1


def test_admission_control_sheds_on_arrival(world):
    svc = _svc(world, max_batch_requests=2)
    svc._ewma_batch_s = 1.0                  # as if batches take 1 s
    queued = [svc.submit(_req(world, f"q{i}")) for i in range(2)]
    with pytest.raises(DeadlineExceeded, match="shed on arrival"):
        svc.submit(_req(world, "doomed", deadline_s=0.5))
    assert svc.stats.shed == 1
    ok = svc.submit(_req(world, "patient", deadline_s=60.0))
    svc.flush()
    assert all(f.result(timeout=5) for f in queued)
    assert ok.result(timeout=5).rid == "patient"
    assert _svc(world)._admission_wait_estimate() == 0.0


def test_queue_wait_percentiles_recorded(world):
    svc = _svc(world)
    assert svc.stats.queue_wait_p50 == 0.0 == svc.stats.queue_wait_p99
    futs = [svc.submit(_req(world, i)) for i in range(3)]
    svc.flush()
    [f.result(timeout=5) for f in futs]
    assert len(svc.stats.queue_wait_samples) == 3
    assert svc.stats.queue_wait_p99 >= svc.stats.queue_wait_p50 >= 0.0
    assert svc.stats.mean_batch == 3.0


def test_clock_jump_expires_typed_not_hung(world):
    svc = _svc(world)
    fut = svc.submit(_req(world, "jump", deadline_s=5.0))
    with skewed_clock(svc, 60.0):
        svc.flush()
    with pytest.raises(DeadlineExceeded):
        fut.result(timeout=5)
    assert svc.stats.expired == 1


# ---------------------------------------------------------------------------
# adaptive batch limit + failed-pass accounting
# ---------------------------------------------------------------------------

def test_adaptive_batch_shrinks_on_miss_then_regrows(world):
    svc = _svc(world, max_batch_requests=4)
    clock = FakeClock()
    svc._clock = clock
    with wrapped_passes(lambda: clock.advance(1.0)):   # a 1 s pass
        fut = svc.submit(_req(world, "miss", deadline_s=0.5))
        svc.flush()
        fut.result(timeout=5)                # a miss still gets its answer
        assert svc._batch_limit == 2 and svc.stats.batch_shrinks == 1
        assert svc._ewma_batch_s > 0.0
        for i in range(8):
            svc.submit(_req(world, f"ok{i}"))
            svc.flush()
        assert svc._batch_limit > 2
        assert svc.stats.batch_grows >= 1


def test_failed_pass_counts_failed_stats(world):
    svc = _svc(world)

    def boom():
        raise InjectedFault("engine on fire")

    with wrapped_passes(boom):
        futs = [svc.submit(_req(world, i)) for i in range(2)]
        svc.flush()
    for f in futs:
        with pytest.raises(InjectedFault, match="on fire"):
            f.result(timeout=5)
    assert svc.stats.failed_batches == 1
    assert svc.stats.failed_requests == 2
    assert svc.stats.requests == 0


# ---------------------------------------------------------------------------
# circuit breaker
# ---------------------------------------------------------------------------

def test_breaker_state_machine():
    clock = FakeClock()
    br = CircuitBreaker(failure_threshold=3, cooldown_s=10.0, clock=clock)
    assert br.allow() and br.state == "closed"
    br.record_failure()
    br.record_failure()
    assert br.allow()
    br.record_failure()
    assert br.state == "open" and br.trips == 1 and not br.allow()
    clock.advance(9.9)
    assert not br.allow()
    clock.advance(0.2)
    assert br.allow() and br.state == "half-open"
    br.record_failure()
    assert br.state == "open" and br.trips == 2 and not br.allow()
    clock.advance(10.1)
    assert br.allow()
    br.record_success()
    assert br.state == "closed" and br.failures == 0
    with pytest.raises(ValueError, match="threshold"):
        CircuitBreaker(failure_threshold=0)


def test_router_breaker_ejects_and_replica_rejoins(world):
    sc, p, _ = world
    rng = np.random.default_rng(9)
    router = ReplicaRouter(sc.dataset, p, CFG, n_replicas=2, mode="bucketed",
                           tile=64, device="cpu", breaker_threshold=2,
                           breaker_cooldown_s=10.0)
    clock = FakeClock()
    router.breakers[1]._clock = clock
    with failing_writes(router.replicas[1]) as fault:
        with pytest.raises(ReplicaBroadcastError) as ei:
            router.commit(*_row(sc, rng))
        assert ei.value.replica == 1
        assert isinstance(ei.value.__cause__, InjectedFault)
        assert router.epoch == 0
        infos = router.commit(*_row(sc, rng))
        assert infos[0] is not None and infos[1] is None
        assert router.epoch == 1 and router.replicas[1].epoch == 0
        st = router.stats
        assert st.breaker_trips == 1 and st.breaker_open == 1
        router.retract([3])
        assert router.epoch == 2 and len(router._backlogs[1]) == 2
        fut = router.submit(_req(world, "read"))
        router.replicas[0].flush()
        assert fut.result(timeout=5).copying.shape[1] == \
            router.replicas[0].resident.n_corpus
        fault["left"] = 0                    # replica healed
    clock.advance(11.0)
    router.commit(*_row(sc, rng))            # catch-up: 2 backlog ops + live
    assert router.replicas[1].epoch == router.replicas[0].epoch == 3
    assert router.stats.breaker_open == 0
    assert not router._backlogs[1]
    assert {svc.resident.n_corpus for svc in router.replicas} == \
        {sc.dataset.n_sources + 2 - 1}
    np.testing.assert_array_equal(router.replicas[0]._index.store.to_dense(),
                                  router.replicas[1]._index.store.to_dense())


def test_router_all_open_is_typed(world):
    sc, p, _ = world
    row = _row(sc, np.random.default_rng(11))
    router = ReplicaRouter(sc.dataset, p, CFG, n_replicas=1, mode="bucketed",
                           tile=64, device="cpu", breaker_threshold=1,
                           breaker_cooldown_s=1e9)
    with failing_writes(router.replicas[0]):
        with pytest.raises(ReplicaBroadcastError):
            router.commit(*row)
    assert not router._backlogs[0]
    assert router.breakers[0].state == "open"
    with pytest.raises(ReplicaBroadcastError, match="circuit breaker"):
        router.commit(*row)
    with pytest.raises(ServiceOverloaded, match="in-sync"):
        router.submit(_req(world, "r"))
    with pytest.raises(RuntimeError, match="no in-sync"):
        _ = router.epoch


# ---------------------------------------------------------------------------
# stop() vs blocked submitters and a mid-flight batch
# ---------------------------------------------------------------------------

def test_stop_race_no_stranded_futures(world):
    """stop() while submitters are blocked on backpressure and a batch is
    mid-flight, under a shortened thread switch interval: every submit
    either returns a future that resolves or raises a typed rejection, and
    the stats count exactly the futures that resolved."""
    svc = _svc(world, max_batch_requests=2, max_pending_rows=9)
    futures, errors = [], []
    lock = threading.Lock()

    def submitter(k):
        for j in range(4):
            try:
                fut = svc.submit(_req(world, f"{k}-{j}"), timeout=5.0)
                with lock:
                    futures.append(fut)
            except (ServiceStopped, ServiceOverloaded) as exc:
                with lock:
                    errors.append(exc)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        with slow_passes(0.05):
            svc.start()
            threads = [threading.Thread(target=submitter, args=(k,))
                       for k in range(12)]
            for t in threads:
                t.start()
            time.sleep(0.15)
            svc.stop()
            for t in threads:
                t.join(timeout=60)
                assert not t.is_alive(), "submitter deadlocked across stop()"
    finally:
        sys.setswitchinterval(interval)
    svc.flush()          # drain submits that landed after the stop settled
    assert len(futures) + len(errors) == 48
    for fut in futures:
        assert fut.done(), "future stranded past stop()+flush()"
        assert fut.result(timeout=0).copying is not None
    assert all(isinstance(e, (ServiceStopped, ServiceOverloaded))
               for e in errors)
    assert len(futures) > 0
    assert svc.stats.requests == len(futures)
    assert svc.stats.rows == 3 * len(futures)


def test_submit_after_stopping_flag_is_typed(world):
    svc = _svc(world)
    svc._stopping = True
    with pytest.raises(ServiceStopped, match="stopping"):
        svc.submit(_req(world, "late"))
    svc._stopping = False
