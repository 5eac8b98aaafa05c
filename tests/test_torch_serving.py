"""The port's batched detection service (``repro_torch.core.serving``).

The load-bearing property, as in the JAX package: folding many requests
into one engine pass returns exactly the decisions each request would get
from its own pass, and those equal ``index_detect_exact`` over the corpus
plus every request's rows. The port's tiled (``bucketed``) service is held
against ``index_detect_exact``, never against the JAX service's tiled
outputs, which fail on the installed jax (ROADMAP C1); in ``exact``,
``bound``, ``bound+`` and ``hybrid`` the port's service is held against the
JAX service itself (decisions equal, ``c_fwd`` and Pr(⊥) within rtol 2e-5 /
atol 1e-4, ROADMAP C3–C4). The data helpers (``synthetic_query_rows`` and
the Table V presets) make the JAX package's arrays from the same seed. The
``detect`` CLI runs end to end on the CPU, with a commit, a retraction, a
state dir and a restore. The ``gpu`` case holds the service on the card
against the CPU.
"""
import numpy as np
import pytest
import torch

import repro.core.serving as jserving
import repro.data.claims as jclaims
from repro.core.types import CopyConfig as JCopyConfig
from repro_torch.core import (
    CopyConfig,
    DetectionEngine,
    build_index,
    index_detect_exact,
)
from repro_torch.core.serving import (
    DetectionService,
    DetectRequest,
    MeshNotPortedError,
    ResidentCorpus,
    ServiceOverloaded,
    serve_batch,
)
from repro_torch.core.types import ClaimsDataset
from repro_torch.data import claims as tclaims
from repro_torch.data.claims import (
    SyntheticSpec,
    oracle_claim_probs,
    synthetic_claims,
    synthetic_query_rows,
)

CFG = CopyConfig(alpha=0.1, s=0.8, n=50.0)
KW = dict(tile=64, device="cpu")
RTOL, ATOL = 2e-5, 1e-4


@pytest.fixture(scope="module")
def corpus():
    sc = synthetic_claims(SyntheticSpec(n_sources=80, n_items=400,
                                        coverage="stock", n_cliques=4, seed=0))
    return sc, oracle_claim_probs(sc)


@pytest.fixture(scope="module")
def requests(corpus):
    sc, _ = corpus
    vals, acc, pq, origins = synthetic_query_rows(sc, 12, seed=1)
    reqs = [DetectRequest(rid=i, values=vals[3 * i: 3 * i + 3],
                          accuracy=acc[3 * i: 3 * i + 3],
                          p_claim=pq[3 * i: 3 * i + 3])
            for i in range(4)]
    return reqs, origins


def _engine(mode="bucketed"):
    return DetectionEngine(CFG, mode=mode, **KW)


def _exact_over(ds, p, reqs):
    """``index_detect_exact`` over the corpus plus every request's rows."""
    union = ClaimsDataset(
        values=np.concatenate([ds.values] + [r.values for r in reqs]),
        accuracy=np.concatenate([ds.accuracy] + [r.accuracy for r in reqs]))
    up = np.concatenate([p] + [r.p_claim for r in reqs])
    return index_detect_exact(union, up, CFG,
                              index=build_index(union, up, CFG, device="cpu"))


def _assert_exact(responses, reqs, exact, S0):
    """Each response's rows equal the exact decisions over the union, row
    for row (corpus columns and the request's own block)."""
    off = S0
    for req, resp in zip(reqs, responses):
        rows = slice(off, off + req.n_rows)
        np.testing.assert_array_equal(resp.copying, exact.copying[rows, :S0])
        np.testing.assert_array_equal(resp.intra_copying,
                                      exact.copying[rows, rows])
        off += req.n_rows


# ---------------------------------------------------------------------------
# the data helpers make the JAX package's arrays
# ---------------------------------------------------------------------------

def test_query_rows_and_presets_equal_jax(corpus):
    sc, _ = corpus
    jsc = jclaims.synthetic_claims(jclaims.SyntheticSpec(
        n_sources=80, n_items=400, coverage="stock", n_cliques=4, seed=0))
    for seed in (0, 1, 7):
        got = synthetic_query_rows(sc, 9, seed=seed)
        want = jclaims.synthetic_query_rows(jsc, 9, seed=seed)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
            assert a.dtype == b.dtype
    for name in ("book_cs_spec", "stock_1day_spec", "book_full_spec",
                 "stock_2wk_spec"):
        got, want = getattr(tclaims, name)(seed=3), getattr(jclaims, name)(3)
        assert vars(got) == vars(want), name


# ---------------------------------------------------------------------------
# serve_batch
# ---------------------------------------------------------------------------

def test_batched_equals_per_request_and_exact(corpus, requests):
    sc, p = corpus
    reqs, _ = requests
    eng = _engine()
    batched = serve_batch(sc.dataset, p, eng, reqs)
    assert [b.rid for b in batched] == [r.rid for r in reqs]
    for req, b in zip(reqs, batched):
        (s,) = serve_batch(sc.dataset, p, eng, [req])
        np.testing.assert_array_equal(b.copying, s.copying)
        np.testing.assert_array_equal(b.intra_copying, s.intra_copying)
        assert b.copying.shape == (req.n_rows, sc.dataset.n_sources)
        assert b.batch_requests == len(reqs)
        assert b.batch_rows == sum(r.n_rows for r in reqs)
    _assert_exact(batched, reqs, _exact_over(sc.dataset, p, reqs),
                  sc.dataset.n_sources)


def test_transient_commit_equals_exact(corpus, requests):
    """With a committed index the batch joins it through a transient commit
    (rolled back after the pass) and still decides like the exact INDEX."""
    sc, p = corpus
    reqs, _ = requests
    eng = _engine()
    idx = build_index(sc.dataset, p, CFG, device="cpu",
                      row_capacity=sc.dataset.n_sources + 12)
    before = {k: v.copy() for k, v in idx.state_dict().items()}
    out = serve_batch(sc.dataset, p, eng, reqs, index=idx)
    _assert_exact(out, reqs, _exact_over(sc.dataset, p, reqs),
                  sc.dataset.n_sources)
    after = idx.state_dict()
    assert before.keys() == after.keys()
    for k in before:
        np.testing.assert_array_equal(before[k], after[k])


def test_planted_copiers_detected(corpus, requests):
    """Query rows generated as copiers of a corpus source are detected."""
    sc, p = corpus
    reqs, origins = requests
    responses = serve_batch(sc.dataset, p, _engine(), reqs)
    hits = planted = 0
    for i, resp in enumerate(responses):
        for row in range(reqs[i].n_rows):
            o = int(origins[3 * i + row])
            if o >= 0:
                planted += 1
                hits += int(resp.copying[row, o])
    assert planted >= 4
    assert hits / planted >= 0.75, (hits, planted)


def test_serve_batch_rejects_bad_inputs(corpus, requests):
    sc, p = corpus
    reqs, _ = requests
    with pytest.raises(ValueError, match="stateless"):
        serve_batch(sc.dataset, p, _engine("incremental"), reqs)
    eng = _engine()
    bad = DetectRequest(rid=9, values=np.full((1, 7), -1, np.int32),
                        accuracy=np.array([0.5], np.float32),
                        p_claim=np.zeros((1, 7), np.float32))
    with pytest.raises(ValueError, match="items"):
        serve_batch(sc.dataset, p, eng, [bad])
    assert serve_batch(sc.dataset, p, eng, []) == []
    with pytest.raises(ValueError, match="q, D"):
        DetectRequest(rid=0, values=np.zeros((2, 4)), accuracy=np.zeros(2),
                      p_claim=np.zeros((2, 5)))
    with pytest.raises(ValueError, match="accuracy"):
        DetectRequest(rid=0, values=np.zeros((2, 4)), accuracy=np.zeros(3),
                      p_claim=np.zeros((2, 4)))
    with pytest.raises(ValueError, match="stateless"):
        DetectionService(sc.dataset, p, CFG, mode="incremental", **KW)


def test_request_casts_equal_jax(corpus, requests):
    """``DetectRequest`` casts as the JAX one does, so the result cache's
    content digest of one request is the same in both packages (a JAX
    snapshot's warm cache hits in the port)."""
    reqs, _ = requests
    r = reqs[0]
    args = dict(values=r.values.astype(np.int64),
                accuracy=r.accuracy.astype(np.float64),
                p_claim=r.p_claim.astype(np.float64))
    t = DetectRequest(rid=1, **args)
    j = jserving.DetectRequest(rid=1, **args)
    for name in ("values", "accuracy", "p_claim"):
        assert getattr(t, name).dtype == getattr(j, name).dtype
    from repro_torch.core.serving import ResultCache
    assert ResultCache.digest(t) == jserving.ResultCache.digest(j)


# ---------------------------------------------------------------------------
# the service: futures, flush, backpressure, resident buffers
# ---------------------------------------------------------------------------

def test_service_async_futures(corpus, requests):
    """The worker thread drains the queue; futures carry per-request slices
    identical to the synchronous path, and latency is recorded."""
    sc, p = corpus
    reqs, _ = requests
    eng = _engine()
    singles = [serve_batch(sc.dataset, p, eng, [r])[0] for r in reqs]
    svc = DetectionService(sc.dataset, p, CFG, mode="bucketed",
                           max_batch_requests=4, **KW)
    with svc:
        futs = [svc.submit(r) for r in reqs]
        outs = [f.result(timeout=300) for f in futs]
    for b, s in zip(outs, singles):
        np.testing.assert_array_equal(b.copying, s.copying)
        assert b.latency_s > 0
    assert svc.stats.requests == len(reqs)
    assert svc.stats.batches <= len(reqs)


def test_service_flush_without_worker(corpus, requests):
    """flush() drains synchronously when no worker thread is running."""
    sc, p = corpus
    reqs, _ = requests
    svc = DetectionService(sc.dataset, p, CFG, mode="bucketed",
                           max_batch_requests=8, **KW)
    futs = [svc.submit(r) for r in reqs]
    assert svc.flush() == len(reqs)
    assert all(f.done() for f in futs)
    assert svc.stats.batches == 1
    assert futs[0].result().batch_requests == len(reqs)
    _assert_exact([f.result() for f in futs], reqs,
                  _exact_over(sc.dataset, p, reqs), sc.dataset.n_sources)


def test_service_backpressure(corpus, requests):
    """submit blocks on a full queue and sheds load after the timeout."""
    sc, p = corpus
    reqs, _ = requests
    svc = DetectionService(sc.dataset, p, CFG, mode="bucketed",
                           max_pending_rows=7, **KW)   # two 3-row requests
    svc.submit(reqs[0], timeout=0.05)
    svc.submit(reqs[1], timeout=0.05)
    with pytest.raises(ServiceOverloaded):
        svc.submit(reqs[2], timeout=0.05)
    assert svc.stats.rejected == 1
    with pytest.raises(ValueError, match="max_pending_rows"):
        big = DetectRequest(rid=99, values=np.full((8, 400), -1, np.int32),
                            accuracy=np.full(8, 0.5, np.float32),
                            p_claim=np.zeros((8, 400), np.float32))
        svc.submit(big)
    assert svc.flush() == 2                      # queued work still serves
    svc.submit(reqs[2], timeout=0.05)            # and capacity freed up
    assert svc.flush() == 1


def test_cancelled_future_does_not_kill_worker(corpus, requests):
    sc, p = corpus
    reqs, _ = requests
    svc = DetectionService(sc.dataset, p, CFG, mode="bucketed",
                           max_batch_requests=8, **KW)
    f0 = svc.submit(reqs[0])
    rest = [svc.submit(r) for r in reqs[1:]]
    assert f0.cancel()
    assert svc.flush() == len(reqs)
    assert f0.cancelled()
    for f in rest:
        assert f.result(timeout=60).copying.shape[1] == sc.dataset.n_sources


def test_resident_store_zero_full_corpus_concat(corpus, requests,
                                                monkeypatch):
    """The resident buffers kill the per-batch O(S·D) union concat: while
    serving, no np.concatenate builds claims rows (an array on the item
    axis) longer than the query rows of one batch, the engine sees zero-copy
    views, and the staged bytes are the query rows'. (The port's entry
    gather concatenates its nonzero coordinate lists, which are O(nnz) of
    the index, not claims.)"""
    sc, p = corpus
    reqs, _ = requests
    svc = DetectionService(sc.dataset, p, CFG, mode="bucketed",
                           max_batch_requests=4, **KW)
    union, union_p, staged = svc.resident.stage(reqs)
    assert np.shares_memory(union.values, svc.resident.values)
    assert np.shares_memory(union_p, svc.resident.p_claim)
    assert staged == sum(r.values.nbytes + r.accuracy.nbytes +
                         r.p_claim.nbytes for r in reqs)
    assert svc.resident.capacity == (sc.dataset.n_sources
                                     + svc.max_pending_rows)

    D = sc.dataset.n_items
    claim_rows = []
    orig = np.concatenate

    def spy(arrays, *a, **kw):
        out = orig(arrays, *a, **kw)
        if out.ndim == 2 and out.shape[1] == D:
            claim_rows.append(out.shape[0])
        return out

    monkeypatch.setattr(np, "concatenate", spy)
    futs = [svc.submit(r) for r in reqs]
    assert svc.flush() == len(reqs)
    monkeypatch.undo()
    assert max(claim_rows, default=0) <= sum(r.n_rows for r in reqs), \
        "claims rows of the corpus were concatenated during serving"
    resp = futs[0].result()
    corpus_bytes = sc.dataset.values.nbytes
    assert 0 < resp.host_copy_bytes < corpus_bytes      # query rows only
    assert svc.stats.host_copy_bytes == resp.host_copy_bytes


def test_serve_batch_overflowing_resident_slack_rejected(corpus, requests):
    sc, p = corpus
    reqs, _ = requests
    rc = ResidentCorpus(sc.dataset, p, max_query_rows=2)
    with pytest.raises(ValueError, match="slack"):
        serve_batch(sc.dataset, p, _engine(), reqs, resident=rc)


def test_flush_refused_while_worker_runs(corpus):
    """flush() must not drive the engine from a second thread."""
    sc, p = corpus
    svc = DetectionService(sc.dataset, p, CFG, mode="bucketed", **KW)
    with svc:
        with pytest.raises(RuntimeError, match="worker"):
            svc.flush()
    assert svc.flush() == 0


# ---------------------------------------------------------------------------
# device and the options the port does not carry
# ---------------------------------------------------------------------------

def test_service_runs_on_the_card_unless_told(corpus):
    """No device means the card: without one the service raises, and never
    falls back to the CPU."""
    sc, p = corpus
    if torch.cuda.is_available():
        pytest.skip("a card is present: the no-card refusal cannot show")
    with pytest.raises(RuntimeError, match="CUDA"):
        DetectionService(sc.dataset, p, CFG)
    svc = DetectionService(sc.dataset, p, CFG, device="cpu")
    assert svc.engine.device.type == "cpu"


def test_mesh_options_refused_typed(corpus):
    sc, p = corpus
    with pytest.raises(MeshNotPortedError, match="A.3b"):
        DetectionService(sc.dataset, p, CFG, mesh_shape=(2, 2), **KW)
    with pytest.raises(MeshNotPortedError, match="A.3b"):
        DetectionService(sc.dataset, p, CFG, devices=4, **KW)
    svc = DetectionService(sc.dataset, p, CFG, devices=1, kernel_impl="auto",
                           mesh_shape=None, **KW)
    assert svc.engine.options.tile == 64


# ---------------------------------------------------------------------------
# the port's service against the JAX service, where the JAX one runs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["exact", "bound", "bound+", "hybrid"])
def test_service_equals_jax_service(corpus, requests, mode):
    """Two batches, a commit between them and a retraction: decisions equal
    the JAX service's, scores within the float32 bar."""
    sc, p = corpus
    reqs, _ = requests
    jreqs = [jserving.DetectRequest(rid=r.rid, values=r.values,
                                    accuracy=r.accuracy, p_claim=r.p_claim)
             for r in reqs]
    ds = sc.dataset
    jds = jclaims.ClaimsDataset(values=ds.values, accuracy=ds.accuracy)
    t = DetectionService(ds, p, CFG, mode=mode, **KW)
    j = jserving.DetectionService(jds, p, JCopyConfig(alpha=0.1, s=0.8,
                                                      n=50.0),
                                  mode=mode, tile=64)

    def wave(svc, rs):
        futs = [svc.submit(r) for r in rs]
        svc.flush()
        return [f.result() for f in futs]

    steps = [("serve", None), ("commit", reqs[1]), ("serve", None),
             ("retract", [3, 81]), ("serve", None)]
    for kind, arg in steps:
        if kind == "commit":
            t.commit(arg.values, arg.accuracy, arg.p_claim)
            j.commit(arg.values, arg.accuracy, arg.p_claim)
            continue
        if kind == "retract":
            t.retract(arg)
            j.retract(arg)
            continue
        for a, b in zip(wave(t, reqs), wave(j, jreqs)):
            np.testing.assert_array_equal(a.copying, b.copying)
            np.testing.assert_array_equal(a.intra_copying, b.intra_copying)
            np.testing.assert_allclose(a.c_fwd, b.c_fwd, rtol=RTOL,
                                       atol=ATOL)
            np.testing.assert_allclose(a.pr_independent, b.pr_independent,
                                       rtol=RTOL, atol=ATOL)
            assert a.cache_hit == b.cache_hit
    assert t.epoch == j.epoch == 2
    assert t.stats.cache_hits == j.stats.cache_hits


# ---------------------------------------------------------------------------
# the detect CLI, end to end on the CPU
# ---------------------------------------------------------------------------

def test_detect_cli_commits_retracts_and_restores(tmp_path, capsys):
    from repro_torch.launch import serve

    state = str(tmp_path / "state")
    argv = ["--task", "detect", "--sources", "64", "--items", "384",
            "--device", "cpu", "--requests", "6", "--batch-requests", "3",
            "--state-dir", state]
    serve.main(argv + ["--commit-accepted", "--retract-last", "2",
                       "--snapshot-every", "2"])
    first = capsys.readouterr().out
    assert "6/6 requests" in first and "mean batch 3.0" in first
    assert "committed" in first and "retracted 2 newest rows" in first
    epoch = int(first.rsplit("at epoch ", 1)[1].split()[0])
    corpus = int(first.rsplit("corpus now ", 1)[1].split()[0])
    serve.main(argv)
    second = capsys.readouterr().out
    assert (f"corpus {corpus} sources at epoch {epoch}" in second), second
    assert "6/6 requests" in second
    with pytest.raises(MeshNotPortedError, match="A.3b"):
        serve.main(["--task", "detect", "--device", "cpu",
                    "--mesh-shape", "2x2"])


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    """The card, or a skip where there is none (decided here, at run time)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    return torch.device("cuda")


@pytest.mark.gpu
def test_service_on_card_equals_cpu(cuda_device, corpus, requests):
    """The bucketed service on the card decides like the CPU service and the
    exact INDEX, through the worker thread, and launches B1 every pass."""
    sc, p = corpus
    reqs, _ = requests
    out = {}
    for dev in (cuda_device, "cpu"):
        svc = DetectionService(sc.dataset, p, CFG, mode="bucketed", tile=64,
                               device=dev, max_batch_requests=2)
        with svc:
            out[str(dev)] = [f.result(timeout=300)
                             for f in [svc.submit(r) for r in reqs]]
        if dev is cuda_device:
            assert svc.engine.last_stats["kernel_launches"] > 0
    for a, b in zip(out["cuda"], out["cpu"]):
        np.testing.assert_array_equal(a.copying, b.copying)
        np.testing.assert_allclose(a.c_fwd, b.c_fwd, rtol=RTOL, atol=ATOL)
    _assert_exact(out["cuda"], reqs, _exact_over(sc.dataset, p, reqs),
                  sc.dataset.n_sources)
