"""Batched copy-detection serving, with live corpus mutation, durability and
replica and shard-owner routing.

A detection service answers *queries against a shared corpus*: each request
carries a handful of query sources — dataset deltas (new or re-crawled
sources) or per-item queries (sparse rows claiming only the items the caller
cares about) — and asks which corpus sources they copy from. Running the
``DetectionEngine`` once per request wastes the engine's fixed costs (index
build, chunking, tile pruning, kernel dispatch) on a tile grid that is
~identical across requests.

``serve_batch`` instead answers the batch with ONE engine pass over the
union of corpus and query rows; in the production ``bucketed`` mode that is
the tiled pass, whose scan launches the fused copyscore kernel on the card.
The union is never concatenated: a ``ResidentCorpus`` preallocates the
claims buffers once with ``S_max`` slack rows, each batch writes only its
query rows into the slack (O(q·D), not O(S·D)), and the engine sees a
zero-copy row view. Each request's row-slice of the decision matrix is then
scattered back into its own response. This is sound because a pair's
exact-INDEX decision is intrinsic to the two sources' claims: co-batched
strangers can create new index entries, but those entries only ever
contribute to pairs that actually share the value, so batched decisions
equal the per-request ones. Cross-request pairs are computed (they ride
along in the same tiles for free) but never reported: each response sees
only its rows vs the corpus plus its own intra-request block.

The invariant is about *decisions*: ``copying``/``intra_copying`` are
batch-independent. The continuous fields (``c_fwd``, ``pr_independent``)
are the engine's bucketed approximation, and the bucket p̂-quantiles shift
with the union index — away from the decision boundary (where the engine
never exact-rescores) they can differ between batch compositions.

``DetectionService`` is the async layer on top: a worker thread drains a
bounded queue into ``serve_batch`` calls, ``submit`` hands back a
``concurrent.futures.Future`` and *blocks* once ``max_pending_rows`` query
rows are queued (backpressure), sheds requests whose deadline cannot hold
(admission control on an EWMA of batch latency) and adapts its batch limit
to deadline misses. ``launch/serve.py --task detect`` is the CLI on top of
this module. The service runs its engine on the card unless it is given
``device="cpu"``.

Live corpus mutation: ``DetectionService.commit`` folds accepted query rows
into the resident corpus AND the service's committed ``InvertedIndex``
(``index.commit_rows`` — delta chunks, no rebuild); per-batch unions reuse
that index through a transient commit + rollback, bit-exact even when the
pass raises, and carry the commit's delta into the engine's block-OR mask
cache. ``retract`` removes corpus sources the same way. A ``ResultCache``
memoizes per-request responses across batches, keyed by request content
and corpus epoch, and invalidates an entry exactly when a commit since its
epoch touches a claim key the request shares. ``ReplicaRouter`` fans
submits over N service replicas (on the one card) and broadcasts commits
under one lock, with LIFO rollback and per-replica circuit breakers; with
``shard_owners=N`` each replica owns one row range of a single sharded
index and a tiled read fans the scan out per owner
(``DetectionEngine.owner_scan_context`` / ``detect_owner_partial`` /
``finalize_owner_partials``).

Durability: pass ``durability=DurabilityOptions(state_dir=...)`` and every
``commit()`` appends one fsync'd, checksummed record to ``core/wal.py``'s
commit log before returning, with periodic full-state snapshots (resident
corpus, committed index, stats, touched-key log, result-cache entries).
``DetectionService.restore(state_dir)`` loads the newest valid snapshot,
truncates any torn log tail, deterministically replays the log records past
the snapshot epoch, and resumes serving with a warm cache — decisions equal
to a never-restarted service.

The file formats, the manifest's keys and the snapshot's arrays are the JAX
package's (``repro.core.serving``), so a state dir written by either
package restores in the other, with two differences kept on purpose: the
engine's device is never written into a manifest (a state dir written on
the card restores on the CPU and back), and the JAX engine's
``kernel_impl``, which this package does not carry (one kernel a path), is
dropped. ``devices`` and ``mesh_shape`` carry the engine's tile mesh in
both packages; ``restore(dir, devices=…)`` overrides the device count.
"""
from __future__ import annotations

import hashlib
import os
import threading
import time
import dataclasses
from collections import OrderedDict, deque
from concurrent.futures import Future
from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np

from repro_torch.core.engine import DetectionEngine
from repro_torch.core.index import (
    InvertedIndex,
    build_index,
    commit_rows,
    rollback_commit,
)
from repro_torch.core.index import retract_rows as index_retract_rows
from repro_torch.core.shardplan import (
    ShardScanError,
    ShardedCorpusStore,
    make_shard_plan,
    shard_store,
)
from repro_torch.core.types import ClaimsDataset, CopyConfig, claim_value_keys
from repro_torch.core.wal import (
    LOG_NAME,
    MANIFEST_NAME,
    CommitLog,
    CommitRecord,
    DurabilityOptions,
    ReplayDivergenceError,
    RestoreInfo,
    RetractRecord,
    latest_valid_snapshot,
    list_snapshots,
    read_manifest,
    write_manifest,
    write_snapshot,
)

#: Engine modes that consume a prebuilt InvertedIndex — for these the service
#: maintains ONE committed index across batches (per-batch transient commits
#: replace the per-batch rebuild); other modes index internally per pass.
INDEXED_MODES = ("exact", "bound", "bound+", "hybrid", "bucketed")


class ServiceOverloaded(TimeoutError):
    """Raised by ``DetectionService.submit`` when backpressure wins: the
    pending-row budget stayed full for the whole submit timeout."""


class DeadlineExceeded(TimeoutError):
    """A request's ``deadline_s`` cannot (or did not) hold.

    Distinct from ``ServiceOverloaded``: backpressure means the QUEUE is
    full; a deadline miss means this request's time budget is spent —
    either shed on arrival (the EWMA of recent batch latency predicts the
    queue wait alone exceeds the deadline — admission control, DESIGN.md
    §9) or expired while queued. The caller can retry with a looser
    deadline; retrying immediately with the same one will shed again.
    """


class ServiceStopped(RuntimeError):
    """Typed rejection for a submit that raced ``stop()``: the worker's
    final drain already ran (or is running), so enqueueing would strand the
    future. A ``RuntimeError`` subclass — pre-existing callers catching that
    still work."""


#: JAX ``EngineOptions`` fields this package's engine does not carry.
_JAX_ONLY_ENGINE_OPTIONS = ("kernel_impl",)


def _port_engine_options(options: dict) -> dict:
    """Engine options as this package's ``EngineOptions`` takes them: a JAX
    manifest's (or a caller's) ``kernel_impl`` is dropped, the port having
    one kernel a path; ``devices`` and ``mesh_shape`` go to the engine's
    tile mesh with JAX's meanings."""
    return {k: v for k, v in options.items()
            if k not in _JAX_ONLY_ENGINE_OPTIONS}


@dataclass
class DetectRequest:
    """One detection query: ``values.shape[0]`` query sources vs the corpus.

    Query rows must use the corpus's value coding — ``values[r, d]`` equal to
    a corpus source's code on item d means "the same value" (−1 = item not
    claimed; a per-item query is simply a row that claims few items).
    """

    rid: int                      # caller-chosen id, echoed on the response
    values: np.ndarray            # (q, D) int32 — same item axis as the corpus
    accuracy: np.ndarray          # (q,) float32 — accuracy estimate per row
    p_claim: np.ndarray           # (q, D) float32 — truth prob of each claim
    deadline_s: Optional[float] = None  # seconds from submit the caller is
                                  # willing to wait; the service sheds the
                                  # request (DeadlineExceeded) rather than
                                  # serve it late (DESIGN.md §9)

    def __post_init__(self):
        self.values = np.asarray(self.values, dtype=np.int32)
        self.accuracy = np.asarray(self.accuracy, dtype=np.float32)
        self.p_claim = np.asarray(self.p_claim, dtype=np.float32)
        if self.values.ndim != 2 or self.p_claim.shape != self.values.shape:
            raise ValueError("values/p_claim must both be (q, D)")
        if self.accuracy.shape != (self.values.shape[0],):
            raise ValueError("accuracy must be (q,)")

    @property
    def n_rows(self) -> int:
        """Number of query sources in this request."""
        return self.values.shape[0]


@dataclass
class DetectResponse:
    """Per-request slice of one batched engine pass.

    Row r of every matrix is the request's r-th query source; columns of the
    ``*_vs_corpus`` fields are corpus sources. Pairs with other requests in
    the same batch are never included. ``copying``/``intra_copying`` are
    batch-independent (equal to a solo engine pass); ``c_fwd`` and
    ``pr_independent`` carry the bucketed approximation away from the
    decision boundary and can vary with batch composition (module docstring).
    """

    rid: int
    copying: np.ndarray           # (q, S_corpus) bool — query copies corpus?
    pr_independent: np.ndarray    # (q, S_corpus) Pr(⊥ | Φ), approximate
    c_fwd: np.ndarray             # (q, S_corpus) C→ (bucketed approximation)
    intra_copying: np.ndarray     # (q, q) bool — within-request pairs
    batch_requests: int = 1       # how many requests shared the engine pass
    batch_rows: int = 0           # total query rows in that pass
    engine_wall_s: float = 0.0    # wall time of the shared pass
    latency_s: float = 0.0        # submit → result (filled by the service)
    host_copy_bytes: int = 0      # bytes staged into the resident buffers
                                  # for this batch (query rows only)
    cache_hit: bool = False       # served from the cross-batch ResultCache
                                  # (decisions provably unaffected by every
                                  # commit since the cached epoch — §7)

    def copying_sources(self, row: int = 0) -> np.ndarray:
        """Corpus source indices the given query row is detected to copy."""
        return np.nonzero(self.copying[row])[0]


class ResidentCorpus:
    """Preallocated corpus + query-slack claims buffers (DESIGN.md §6).

    The corpus rows are written ONCE at construction; every batch after that
    writes only its query rows into the ``max_query_rows`` slack and hands
    the engine a zero-copy row view — the O(S·D) per-batch union
    concatenation the legacy ``serve_batch`` did is gone. The buffers mirror
    the ``CorpusStore`` row-slack protocol (``store.append_rows``) one level
    up, at the claims layer the per-batch index build streams from.
    """

    def __init__(self, base: ClaimsDataset, base_p: np.ndarray,
                 max_query_rows: int):
        S0, D = base.values.shape
        self.n_corpus = S0
        self.max_query_rows = int(max_query_rows)
        self.capacity = S0 + self.max_query_rows
        self.values = np.full((self.capacity, D), -1, np.int32)
        self.accuracy = np.full(self.capacity, 0.5, np.float32)
        self.p_claim = np.zeros((self.capacity, D), np.float32)
        self.values[:S0] = base.values
        self.accuracy[:S0] = base.accuracy
        self.p_claim[:S0] = base_p
        self._item_names = base.item_names
        self._full = ClaimsDataset(values=self.values, accuracy=self.accuracy,
                                   item_names=base.item_names)

    @property
    def n_items(self) -> int:
        """D — item columns of the resident buffers."""
        return self.values.shape[1]

    def corpus_view(self) -> ClaimsDataset:
        """Zero-copy dataset over the corpus rows only (no query slack).

        Long-lived owners (``DetectionService``) rebind their corpus
        reference to this view so the resident buffers are the SINGLE copy
        of the corpus in memory — not a second one next to the caller's."""
        return self._full.row_view(self.n_corpus)

    def stage(self, requests: Sequence[DetectRequest]
              ) -> tuple[ClaimsDataset, np.ndarray, int]:
        """Write the batch's query rows into the slack; return the union view.

        Returns ``(union_dataset, union_p, bytes_written)`` where both union
        arrays are zero-copy views of the resident buffers covering the
        corpus plus the staged rows, and ``bytes_written`` counts only the
        query-row bytes (the measurable win over the legacy concat).
        """
        off = self.n_corpus
        written = 0
        for r in requests:
            if off + r.n_rows > self.capacity:
                raise ValueError(
                    f"batch of {sum(q.n_rows for q in requests)} query rows "
                    f"exceeds resident slack "
                    f"({self.capacity - self.n_corpus} rows)")
            rows = slice(off, off + r.n_rows)
            self.values[rows] = r.values
            self.accuracy[rows] = r.accuracy
            self.p_claim[rows] = r.p_claim
            written += r.values.nbytes + r.accuracy.nbytes + r.p_claim.nbytes
            off += r.n_rows
        return self._full.row_view(off), self.p_claim[:off], written

    # -- permanent commits (corpus mutation, DESIGN.md §7) -------------------

    def _grow(self, new_capacity: int) -> None:
        """Reallocate the resident buffers at a larger row capacity."""
        D = self.n_items
        values = np.full((new_capacity, D), -1, np.int32)
        accuracy = np.full(new_capacity, 0.5, np.float32)
        p_claim = np.zeros((new_capacity, D), np.float32)
        values[: self.capacity] = self.values
        accuracy[: self.capacity] = self.accuracy
        p_claim[: self.capacity] = self.p_claim
        self.values, self.accuracy, self.p_claim = values, accuracy, p_claim
        self.capacity = new_capacity
        self._full = ClaimsDataset(values=self.values, accuracy=self.accuracy,
                                   item_names=self._item_names)

    def commit_rows(self, values: np.ndarray, accuracy: np.ndarray,
                    p_claim: np.ndarray) -> int:
        """Make query rows PERMANENT corpus rows (they stop being slack).

        Grows the buffers geometrically when the committed corpus would eat
        into the ``max_query_rows`` staging slack — the invariant
        ``capacity ≥ n_corpus + max_query_rows`` survives any number of
        commits. Returns the new corpus row count. Callers holding views
        from ``corpus_view()`` must re-acquire them after a commit (growth
        reallocates; ``DetectionService.commit`` rebinds its own).
        """
        q = values.shape[0]
        needed = self.n_corpus + q + self.max_query_rows
        if needed > self.capacity:
            self._grow(max(needed, 2 * self.capacity))
        rows = slice(self.n_corpus, self.n_corpus + q)
        self.values[rows] = values
        self.accuracy[rows] = accuracy
        self.p_claim[rows] = p_claim
        self.n_corpus += q
        return self.n_corpus

    def truncate_corpus(self, n_rows: int) -> None:
        """Undo trailing ``commit_rows`` calls: corpus shrinks to ``n_rows``.

        The freed rows return to staging slack, reset to the buffer's inert
        fill (−1 / 0.5 / 0) so a later ``stage``/``commit_rows`` finds them
        exactly as preallocation left them. LIFO counterpart of
        ``commit_rows``, used by ``DetectionService.rollback_last_commit``.
        """
        n_rows = int(n_rows)
        if n_rows > self.n_corpus:
            raise ValueError(
                f"truncate_corpus({n_rows}) above n_corpus={self.n_corpus}")
        rows = slice(n_rows, self.n_corpus)
        self.values[rows] = -1
        self.accuracy[rows] = 0.5
        self.p_claim[rows] = 0.0
        self.n_corpus = n_rows

    def retract_rows(self, row_ids: np.ndarray) -> int:
        """Remove ARBITRARY corpus rows (source retraction, DESIGN.md §9).

        The surviving rows compact upward (fancy-index gather — a copy, so
        overlapping source/destination is safe), the freed tail returns to
        the inert fill, and ``n_corpus`` drops. Returns the new corpus row
        count. Mirrors ``CorpusStore.retract_rows`` one level up, at the
        claims layer.
        """
        row_ids = np.unique(np.asarray(row_ids, np.int64))
        if len(row_ids) and (row_ids[0] < 0 or row_ids[-1] >= self.n_corpus):
            raise ValueError(
                f"retract_rows: ids out of range [0, {self.n_corpus})")
        keep = np.ones(self.n_corpus, bool)
        keep[row_ids] = False
        n_keep = int(keep.sum())
        self.values[:n_keep] = self.values[: self.n_corpus][keep]
        self.accuracy[:n_keep] = self.accuracy[: self.n_corpus][keep]
        self.p_claim[:n_keep] = self.p_claim[: self.n_corpus][keep]
        tail = slice(n_keep, self.n_corpus)
        self.values[tail] = -1
        self.accuracy[tail] = 0.5
        self.p_claim[tail] = 0.0
        self.n_corpus = n_keep
        return self.n_corpus

    def unretract(self, row_ids: np.ndarray, values: np.ndarray,
                  accuracy: np.ndarray, p_claim: np.ndarray) -> int:
        """Re-insert retracted rows at their original indices (rollback).

        LIFO counterpart of ``retract_rows`` for the router's broadcast
        recovery: the saved rows scatter back to ``row_ids`` and the
        survivors shift back to their pre-retraction positions, so the row
        coordinate system is restored exactly. Returns the new row count.
        """
        row_ids = np.unique(np.asarray(row_ids, np.int64))
        k = len(row_ids)
        n_new = self.n_corpus + k
        if n_new > self.capacity - self.max_query_rows:
            raise ValueError("unretract would eat into the staging slack")
        keep_pos = np.setdiff1d(np.arange(n_new), row_ids)
        cur_v = self.values[: self.n_corpus].copy()
        cur_a = self.accuracy[: self.n_corpus].copy()
        cur_p = self.p_claim[: self.n_corpus].copy()
        self.values[keep_pos] = cur_v
        self.accuracy[keep_pos] = cur_a
        self.p_claim[keep_pos] = cur_p
        self.values[row_ids] = values
        self.accuracy[row_ids] = accuracy
        self.p_claim[row_ids] = p_claim
        self.n_corpus = n_new
        return self.n_corpus


def serve_batch(
    base: ClaimsDataset,
    base_p: np.ndarray,
    engine: DetectionEngine,
    requests: Sequence[DetectRequest],
    resident: Optional[ResidentCorpus] = None,
    index: Optional[InvertedIndex] = None,
) -> list[DetectResponse]:
    """Answer a batch of requests with ONE tiled engine pass (DESIGN.md §5).

    Args:
      base: the shared corpus (S, D).
      base_p: (S, D) per-claim truth probabilities of the corpus.
      engine: any stateless-mode DetectionEngine (``bucketed`` for exact
        serving, ``sample_verify`` for sampled serving at scale);
        ``incremental`` is rejected — its bookkeeping assumes a fixed source
        axis, which batching changes every call.
      requests: the pending requests; their rows are staged into the
        resident slack under the corpus rows, in order.
      resident: the preallocated buffers to stage into. ``DetectionService``
        passes its own (built once); a standalone call builds a transient
        one sized for this batch — the corpus copy then happens once here
        rather than once per batch.
      index: a committed ``InvertedIndex`` over the corpus rows (DESIGN.md
        §7). When given (and the engine mode consumes indexes), the batch's
        query rows join it through a TRANSIENT ``commit_rows`` — membership
        bits + delta chunks for newly-shared values — which is rolled back
        bit-exact after the pass, even on failure. This replaces the
        per-batch index rebuild the engine would otherwise do.

    Returns one ``DetectResponse`` per request, in request order.
    """
    if engine.mode == "incremental":
        raise ValueError("serve_batch requires a stateless engine mode")
    if not requests:
        return []
    D = base.n_items
    for r in requests:
        if r.values.shape[1] != D:
            raise ValueError(
                f"request {r.rid}: {r.values.shape[1]} items, corpus has {D}")
    S0 = base.n_sources
    n_rows = sum(r.n_rows for r in requests)
    if resident is None:
        resident = ResidentCorpus(base, base_p, max_query_rows=n_rows)
    elif resident.n_corpus != S0 or resident.n_items != D:
        # detection would silently run against the resident's corpus, not
        # ``base``, and the response slices would misalign — fail fast
        raise ValueError(
            f"resident corpus is {resident.n_corpus}×{resident.n_items}, "
            f"base is {S0}×{D}; serve_batch requires the resident to be "
            f"built over the same corpus")
    union, p, copied = resident.stage(requests)

    if index is not None and engine.mode in INDEXED_MODES:
        index.store.ensure_row_capacity(union.n_sources)
        info = commit_rows(index, union, p, engine.cfg,
                           union.n_sources - S0, compact=False)
        # carry the transient commit's delta into the engine's block-OR
        # mask cache so the batch detect updates O(touched) cells instead
        # of regathering all K chunk reductions (DESIGN.md §11)
        token = engine.apply_mask_delta(info.delta)
        try:
            res = engine.detect(union, p, index=index)
        finally:
            # bit-exact unwind — a mid-batch engine failure must never leave
            # the batch's transient rows/deltas in the committed index
            rollback_commit(index, info)
            if token is not None:
                engine.undo_mask_delta(token)
            else:
                # no cache existed before this transient commit — whatever
                # the detect pass adopted is anchored mid-transient; shrink
                # it back onto the restored base so the next batch chains
                engine.rebase_mask_cache(info.delta)
    else:
        res = engine.detect(union, p)

    out = []
    off = S0
    for r in requests:
        rows = slice(off, off + r.n_rows)
        out.append(DetectResponse(
            rid=r.rid,
            copying=res.copying[rows, :S0].copy(),
            pr_independent=res.pr_independent[rows, :S0].copy(),
            c_fwd=res.c_fwd[rows, :S0].copy(),
            intra_copying=res.copying[rows, rows].copy(),
            batch_requests=len(requests),
            batch_rows=n_rows,
            engine_wall_s=res.wall_time_s,
            host_copy_bytes=copied,
        ))
        off += r.n_rows
    return out


#: Queue-wait samples kept for the p50/p99 properties (ring-buffer bound).
_MAX_WAIT_SAMPLES = 4096


@dataclass
class ServiceStats:
    """Counters the service accumulates across batches (read via .stats)."""

    requests: int = 0
    batches: int = 0
    rows: int = 0
    rejected: int = 0             # submits that timed out on backpressure
    host_copy_bytes: int = 0      # total bytes staged into the resident
                                  # buffers (query rows only — the corpus is
                                  # written once, at service construction)
    cache_hits: int = 0           # requests served from the ResultCache
    cache_misses: int = 0         # requests that needed an engine pass
    cache_invalidations: int = 0  # cached entries killed by a commit's
                                  # touched-key overlap (DESIGN.md §7)
    commits: int = 0              # corpus mutations applied
    committed_rows: int = 0       # query rows folded into the corpus
    new_entries: int = 0          # delta entries appended across commits
    reindexed_entries: int = 0    # existing entries re-scored (providers grew)
    delta_chunks: int = 0         # delta chunks appended across commits
    compactions: int = 0          # delta→base folds
    failed_batches: int = 0       # engine passes that raised (DESIGN.md §9)
    failed_requests: int = 0      # requests whose pass raised (not cache hits)
    shed: int = 0                 # admitted-control rejections on arrival:
                                  # the EWMA predicted the deadline can't hold
    expired: int = 0              # queued requests whose deadline passed
                                  # before their batch ran
    retractions: int = 0          # source retractions applied (§9)
    retracted_rows: int = 0       # corpus rows removed by retractions
    gc_entries: int = 0           # entries GC'd (< 2 providers after retract)
    batch_shrinks: int = 0        # adaptive batch-limit halvings
    batch_grows: int = 0          # adaptive batch-limit regrowth steps
    breaker_trips: int = 0        # replica breakers tripped open (router)
    breaker_open: int = 0         # replicas currently open/half-open (router)
    queue_wait_samples: list = dataclasses.field(default_factory=list,
                                                 repr=False)

    def record_wait(self, seconds: float) -> None:
        """Record one request's submit→batch-start queue wait."""
        self.queue_wait_samples.append(float(seconds))
        if len(self.queue_wait_samples) > _MAX_WAIT_SAMPLES:
            del self.queue_wait_samples[: -_MAX_WAIT_SAMPLES]

    @property
    def queue_wait_p50(self) -> float:
        """Median queue wait (seconds) over the recent sample window."""
        s = self.queue_wait_samples
        return float(np.percentile(s, 50)) if s else 0.0

    @property
    def queue_wait_p99(self) -> float:
        """p99 queue wait (seconds) over the recent sample window."""
        s = self.queue_wait_samples
        return float(np.percentile(s, 99)) if s else 0.0

    @property
    def mean_batch(self) -> float:
        """Mean requests per engine pass (1.0 ⇒ batching never kicked in)."""
        return self.requests / self.batches if self.batches else 0.0

    @property
    def cache_hit_rate(self) -> float:
        """Fraction of requests answered without an engine pass."""
        total = self.cache_hits + self.cache_misses
        return self.cache_hits / total if total else 0.0


def _stat_counter_fields() -> list:
    """The int counter fields of ``ServiceStats`` (snapshot/aggregation
    currency — the wait-sample buffer is runtime-only and is skipped)."""
    return [f for f in dataclasses.fields(ServiceStats) if f.type == "int"]


class ResultCache:
    """Cross-batch response cache with commit-exact invalidation (§7).

    Entries are keyed by request CONTENT (a digest of values/accuracy/
    p_claim — the rid is echoed, not keyed) and stamped with the corpus
    epoch they were computed at. The conceptual key is (source pair, epoch):
    a cached response is the request's row-slice of pair decisions vs the
    corpus. On lookup, the entry is replayed against every commit since its
    epoch: if any commit's ``touched_keys`` (ALL claim keys of its committed
    rows) intersects the request's claim keys, some (query row, corpus
    source) pair may share a touched entry and the cache entry dies;
    otherwise NO pair the response reports can share any value a delta
    created or extended, so its decisions provably equal a fresh pass —
    including vs corpus sources committed later, which are padded in as
    independent (a pair sharing no value can never reach the copying
    threshold for α < .25, and is never *considered*, so the padding's
    False / 1.0 / 0.0 matches the fresh pass bit-for-bit, continuous
    fields included). DESIGN.md §7 carries the full argument.
    """

    def __init__(self, max_entries: int = 256):
        self.max_entries = int(max_entries)
        self.hits = 0
        self.misses = 0
        self.invalidations = 0
        self._entries: OrderedDict = OrderedDict()

    @staticmethod
    def digest(request: DetectRequest) -> bytes:
        """Content digest of a request (rid excluded — it is echoed back)."""
        h = hashlib.sha1()
        h.update(np.ascontiguousarray(request.values).tobytes())
        h.update(np.ascontiguousarray(request.accuracy).tobytes())
        h.update(np.ascontiguousarray(request.p_claim).tobytes())
        return h.digest()

    def lookup(self, request: DetectRequest, epoch: int, n_corpus: int,
               touched_log: Sequence) -> Optional[DetectResponse]:
        """Serve a request from cache, or None on miss/invalidation.

        ``touched_log`` is the service's [(epoch, touched_keys)] history;
        only commits AFTER the entry's validation epoch are replayed, and a
        surviving entry is re-stamped at ``epoch`` so each commit is tested
        at most once per entry.
        """
        key = self.digest(request)
        ent = self._entries.get(key)
        if ent is None:
            self.misses += 1
            return None
        for e, touched in touched_log:
            if e <= ent["epoch"]:
                continue
            if np.isin(ent["claim_keys"], touched,
                       assume_unique=True).any():
                del self._entries[key]
                self.invalidations += 1
                self.misses += 1
                return None
        s_at = ent["copying"].shape[1]
        if s_at < n_corpus:
            # corpus sources committed since the entry: provably independent
            # of these rows (no shared touched key), pad the columns in
            q = ent["copying"].shape[0]
            grow = n_corpus - s_at
            ent["copying"] = np.concatenate(
                [ent["copying"], np.zeros((q, grow), bool)], axis=1)
            ent["pr_independent"] = np.concatenate(
                [ent["pr_independent"], np.ones((q, grow), np.float32)], axis=1)
            ent["c_fwd"] = np.concatenate(
                [ent["c_fwd"], np.zeros((q, grow), np.float32)], axis=1)
        ent["epoch"] = epoch
        self._entries.move_to_end(key)
        self.hits += 1
        return DetectResponse(
            rid=request.rid,
            copying=ent["copying"].copy(),
            pr_independent=ent["pr_independent"].copy(),
            c_fwd=ent["c_fwd"].copy(),
            intra_copying=ent["intra_copying"].copy(),
            cache_hit=True,
        )

    def oldest_epoch(self, default: int) -> int:
        """The oldest validation epoch any cached entry carries.

        Commits at or before this epoch can never be replayed again (every
        lookup skips them), so the service prunes its touched-key log down
        to this floor. ``default`` is returned for an empty cache.
        """
        if not self._entries:
            return default
        return min(e["epoch"] for e in self._entries.values())

    def put(self, request: DetectRequest, response: DetectResponse,
            epoch: int) -> None:
        """Memoize a freshly computed response at the given epoch (LRU)."""
        key = self.digest(request)
        self._entries[key] = {
            "epoch": epoch,
            "claim_keys": claim_value_keys(request.values),
            "copying": response.copying.copy(),
            "pr_independent": response.pr_independent.copy(),
            "c_fwd": response.c_fwd.copy(),
            "intra_copying": response.intra_copying.copy(),
        }
        self._entries.move_to_end(key)
        while len(self._entries) > self.max_entries:
            self._entries.popitem(last=False)

    def apply_retraction(self, removed_cols: np.ndarray,
                         touched_keys: np.ndarray, n_before: int) -> int:
        """Eagerly reconcile every cached entry with a source retraction.

        The touched-key rule (§7) still decides life or death: an entry
        sharing a claim key with a retracted row may have paired with it —
        it dies. A survivor shares NO key with any retracted row, so its
        pairs against those sources were never copying (False / 1.0 / 0.0);
        its response just loses those columns. Survivors whose matrices
        predate ``n_before`` columns are padded first (the standard
        later-commit padding — if a commit between the entry's epoch and now
        actually touched it, the lookup-time replay will kill it anyway, so
        padding here is harmless). Done eagerly (not at lookup) because the
        retraction renumbers the corpus column axis — lookups after this
        point compare against the POST-retraction corpus. Returns the number
        of entries invalidated.
        """
        removed_cols = np.asarray(removed_cols, np.int64)
        dead = [key for key, ent in self._entries.items()
                if np.isin(ent["claim_keys"], touched_keys,
                           assume_unique=True).any()]
        for key in dead:
            del self._entries[key]
            self.invalidations += 1
        for ent in self._entries.values():
            q, s_at = ent["copying"].shape
            if s_at < n_before:
                grow = n_before - s_at
                ent["copying"] = np.concatenate(
                    [ent["copying"], np.zeros((q, grow), bool)], axis=1)
                ent["pr_independent"] = np.concatenate(
                    [ent["pr_independent"], np.ones((q, grow), np.float32)],
                    axis=1)
                ent["c_fwd"] = np.concatenate(
                    [ent["c_fwd"], np.zeros((q, grow), np.float32)], axis=1)
            for name in ("copying", "pr_independent", "c_fwd"):
                ent[name] = np.delete(ent[name], removed_cols, axis=1)
        return len(dead)

    def clear(self) -> int:
        """Drop every entry (counters survive). Returns the number dropped.

        Used by ``rollback_last_retract``: the eager column surgery of
        ``apply_retraction`` is not invertible entry-by-entry, so unwinding
        a retraction starts the cache cold.
        """
        n = len(self._entries)
        self._entries.clear()
        return n

    def drop_after(self, epoch: int) -> int:
        """Purge entries validated at an epoch later than ``epoch``.

        ``rollback_last_commit`` unwinds the corpus to ``epoch``; entries
        stamped later were validated (or memoized) against corpus state that
        no longer exists, so re-admitting them would skip the invalidation
        replay for the undone commit. Returns the number purged.
        """
        dead = [k for k, e in self._entries.items() if e["epoch"] > epoch]
        for k in dead:
            del self._entries[k]
        return len(dead)

    # -- (de)serialization (durability layer, DESIGN.md §8) ------------------

    def state_dict(self) -> dict:
        """Flat ``{key: ndarray}`` dict of every cached entry, in LRU order.

        Entries ride inside the service snapshot so a restored service wakes
        with a WARM cache: each entry keeps its digest, validation epoch and
        claim keys, which is exactly what the lookup-time invalidation
        replay needs to prove (or refute) that the entry survives the
        commits replayed after the snapshot (DESIGN.md §8.3).
        """
        d = {"cache/meta": np.array([len(self._entries), self.max_entries],
                                    np.int64)}
        for i, (key, ent) in enumerate(self._entries.items()):
            pre = f"cache/{i:05d}/"
            d[pre + "digest"] = np.frombuffer(key, np.uint8)
            d[pre + "epoch"] = np.array([ent["epoch"]], np.int64)
            d[pre + "claim_keys"] = ent["claim_keys"]
            d[pre + "copying"] = ent["copying"]
            d[pre + "pr_independent"] = ent["pr_independent"]
            d[pre + "c_fwd"] = ent["c_fwd"]
            d[pre + "intra_copying"] = ent["intra_copying"]
        return d

    def load_state_dict(self, d: dict) -> None:
        """Re-admit persisted entries (inverse of ``state_dict``)."""
        n = int(np.asarray(d["cache/meta"])[0])
        for i in range(n):
            pre = f"cache/{i:05d}/"
            key = np.asarray(d[pre + "digest"], np.uint8).tobytes()
            self._entries[key] = {
                "epoch": int(np.asarray(d[pre + "epoch"])[0]),
                "claim_keys": np.asarray(d[pre + "claim_keys"], np.int64),
                "copying": np.asarray(d[pre + "copying"], bool),
                "pr_independent": np.asarray(d[pre + "pr_independent"],
                                             np.float32),
                "c_fwd": np.asarray(d[pre + "c_fwd"], np.float32),
                "intra_copying": np.asarray(d[pre + "intra_copying"], bool),
            }
            self._entries.move_to_end(key)
        while len(self._entries) > self.max_entries:
            self._entries.popitem(last=False)


class DetectionService:
    """Queue + worker thread that batches requests through one engine.

    Lifecycle::

        svc = DetectionService(corpus, p, cfg, max_batch_requests=8)
        with svc:                       # starts the worker thread
            futs = [svc.submit(r) for r in reqs]   # blocks when queue full
            results = [f.result() for f in futs]

    ``submit`` applies backpressure: once ``max_pending_rows`` query rows are
    waiting, it blocks (up to ``timeout``) until the worker drains the queue,
    then raises ``ServiceOverloaded`` — load sheds at the edge instead of
    accumulating unbounded memory. Without the context manager (or
    ``start()``), ``flush()`` drains the queue synchronously in the caller's
    thread — the deterministic path tests and benchmarks use.
    """

    def __init__(
        self,
        base: ClaimsDataset,
        base_p: np.ndarray,
        cfg: CopyConfig,
        *,
        mode: str = "bucketed",
        max_batch_requests: int = 8,
        max_pending_rows: int = 256,
        result_cache: bool = True,
        cache_entries: int = 256,
        compact_threshold: float = 0.25,
        durability: Optional[DurabilityOptions] = None,
        device=None,
        _index_state: Optional[dict] = None,
        _shared_index: Optional[InvertedIndex] = None,
        **engine_options,
    ):
        """Build the service around a fresh engine.

        max_batch_requests: requests folded into one engine pass.
        max_pending_rows: backpressure bound on queued query rows.
        result_cache: keep the cross-batch ``ResultCache`` (DESIGN.md §7);
          False disables memoization (every request runs an engine pass).
        cache_entries: LRU capacity of the result cache.
        compact_threshold: delta fraction above which a ``commit`` folds
          delta chunks back into the score-sorted base.
        durability: a ``DurabilityOptions`` to make commits survive the
          process (commit log + snapshots under its state dir); None keeps
          the service in-memory only.
        device: the engine's device — None is the card (raising without
          one), ``"cpu"`` the plain PyTorch path. Never persisted: a
          restore takes it as an override.
        _index_state: restore-path internal — a serialized committed index
          (``InvertedIndex.state_dict``) loaded instead of ``build_index``,
          which is the dominant cost restore exists to skip.
        _shared_index: shard-owner internal (DESIGN.md §12) — adopt another
          service's committed index instead of building one. This replica
          NEVER mutates the shared object (the primary's commit path does);
          its own commits apply the claims state and log owner-range-tagged
          WAL records only, so its ``replica-<i>/`` dir restores
          independently.
        engine_options: forwarded to ``EngineOptions`` (tile, devices,
          mesh_shape, n_shards, ...); the JAX-only ``kernel_impl`` is
          dropped (``_port_engine_options``).
        """
        if mode == "incremental":
            raise ValueError(
                "DetectionService requires a stateless engine mode "
                "(incremental bookkeeping assumes a fixed source axis)")
        self.engine = DetectionEngine(cfg, mode=mode, device=device,
                                      **_port_engine_options(engine_options))
        self.max_batch_requests = int(max_batch_requests)
        self.max_pending_rows = int(max_pending_rows)
        self.compact_threshold = float(compact_threshold)
        # ONE resident buffer for the service's lifetime: corpus written
        # here once, every batch stages only its query rows (DESIGN.md §6).
        # base/base_p are then rebound to views of it, so the service holds
        # a single corpus copy (the caller's arrays are theirs to drop).
        self.resident = ResidentCorpus(base, np.asarray(base_p, np.float32),
                                       max_query_rows=self.max_pending_rows)
        self.base = self.resident.corpus_view()
        self.base_p = self.resident.p_claim[: self.resident.n_corpus]
        # committed index (DESIGN.md §7): built ONCE for index-backed modes,
        # then mutated by commit() and reused by every batch through the
        # transient commit/rollback in serve_batch — no per-batch rebuild
        opt = self.engine.options
        self._index: Optional[InvertedIndex] = None
        self._index_shared = _shared_index is not None
        if _shared_index is not None:
            self._index = _shared_index
        elif mode in INDEXED_MODES:
            row_cap = self.resident.n_corpus + self.max_pending_rows
            if _index_state is not None:
                self._index = InvertedIndex.from_state_dict(
                    _index_state, row_capacity=row_cap)
            else:
                self._index = build_index(
                    self.base, self.base_p, cfg,
                    chunk_entries=opt.store_chunk_entries,
                    chunk_bytes=opt.store_chunk_bytes,
                    row_capacity=row_cap, device=self.engine.device)
                if opt.n_shards and opt.n_shards > 1:
                    # row-range-sharded data plane (DESIGN.md §10): the
                    # committed store becomes per-shard row slices; commits,
                    # retractions, snapshots, and the engine's per-shard
                    # scans all flow through the facade. A restored index
                    # re-establishes its persisted plan instead (the
                    # shard_starts key in the state dict).
                    self._index.store = shard_store(
                        self._index.store,
                        make_shard_plan(self._index.store.n_rows,
                                        opt.n_shards))
        self.epoch = 0
        # the cache's exactness argument (§7.5) needs (a) considered-gated
        # decisions — pairwise scores EVERY pair, so disjoint-pair padding
        # would diverge from it; sampled nets shift as the corpus grows —
        # and (b) α < ¼ so no-shared-value pairs stay sub-threshold
        cacheable = mode in INDEXED_MODES and cfg.alpha < 0.25
        self.cache = (ResultCache(cache_entries)
                      if result_cache and cacheable else None)
        self._result_cache_requested = bool(result_cache)
        self._touched_log: list = []     # [(epoch, touched_keys)] per commit
        self.stats = ServiceStats()
        self._pending: deque = deque()   # (request, future, t_submit, t_ddl)
        self._pending_rows = 0
        self._cv = threading.Condition()
        self._corpus_lock = threading.Lock()   # serializes batches & commits
        self._worker: Optional[threading.Thread] = None
        self._stopping = False
        # traffic hardening (DESIGN.md §9): injectable clock (fault tests
        # skew it), EWMA of recent batch latency (admission control), and
        # the adaptive batch limit in [1, max_batch_requests]
        self._clock = time.monotonic
        self._ewma_batch_s = 0.0         # 0 = no estimate yet
        self._batch_limit = self.max_batch_requests
        self._ok_streak = 0              # deadline-clean batches in a row
        # durability state (all None/empty for an in-memory service)
        self.durability: Optional[DurabilityOptions] = None
        self.restore_info: Optional[RestoreInfo] = None
        self._log: Optional[CommitLog] = None
        self._last_commit: Optional[dict] = None   # rollback receipt
        self._last_retract: Optional[dict] = None  # rollback receipt (§9)
        if durability is not None:
            self._attach_durability(durability)

    # -- submission ---------------------------------------------------------

    def _admission_wait_estimate(self) -> float:
        """Predicted submit→result latency for a request arriving NOW.

        Queue depth in batches (at the current adaptive batch limit) times
        the EWMA of recent batch latency, plus one more batch for the
        request's own pass. 0.0 while no batch has completed yet (no
        estimate — admission control stands down rather than shed blind).
        """
        if self._ewma_batch_s <= 0.0:
            return 0.0
        batches_ahead = -(-len(self._pending) // max(self._batch_limit, 1))
        return (batches_ahead + 1) * self._ewma_batch_s

    def submit(self, request: DetectRequest,
               timeout: Optional[float] = 30.0) -> Future:
        """Enqueue a request; returns a Future resolving to DetectResponse.

        Blocks while the pending-row budget is full (backpressure); raises
        ``ServiceOverloaded`` if it stays full past ``timeout`` seconds,
        ``ValueError`` for a request that could never fit the budget, and —
        for a request carrying ``deadline_s`` — ``DeadlineExceeded`` ON
        ARRIVAL when the EWMA of recent batch latency predicts the deadline
        cannot hold (admission control: the engine pass is never wasted on
        a request that would miss anyway, DESIGN.md §9).
        """
        if request.n_rows > self.max_pending_rows:
            raise ValueError(
                f"request {request.rid}: {request.n_rows} rows exceeds "
                f"max_pending_rows={self.max_pending_rows}")
        deadline = None if timeout is None else self._clock() + timeout
        with self._cv:
            if self._stopping:
                # after the worker's final drain a queued entry would never
                # resolve — refuse instead of stranding the future
                raise ServiceStopped("service is stopping; submit rejected")
            if request.deadline_s is not None:
                est = self._admission_wait_estimate()
                if est > request.deadline_s:
                    self.stats.shed += 1
                    raise DeadlineExceeded(
                        f"request {request.rid}: predicted wait "
                        f"{est:.3f}s exceeds deadline "
                        f"{request.deadline_s:.3f}s — shed on arrival")
            while self._pending_rows + request.n_rows > self.max_pending_rows:
                wait = (None if deadline is None
                        else deadline - self._clock())
                if wait is not None and wait <= 0:
                    self.stats.rejected += 1
                    raise ServiceOverloaded(
                        f"queue full ({self._pending_rows} rows pending)")
                self._cv.wait(wait)
                if self._stopping:
                    # stop() drained the queue while we waited — enqueueing
                    # now would strand the future past the worker's exit
                    raise ServiceStopped(
                        "service is stopping; submit rejected")
            fut: Future = Future()
            now = self._clock()
            t_ddl = (None if request.deadline_s is None
                     else now + request.deadline_s)
            self._pending.append((request, fut, now, t_ddl))
            self._pending_rows += request.n_rows
            self._cv.notify_all()
        return fut

    # -- draining -----------------------------------------------------------

    def _take_batch(self) -> list:
        """Pop up to ``_batch_limit`` pending entries (caller holds _cv).

        The limit is the ADAPTIVE bound — ``max_batch_requests`` shrunk
        while deadline misses accumulate, regrown when headroom returns
        (DESIGN.md §9) — so an overloaded service trades batching
        efficiency for per-batch latency exactly when latency is what
        deadlines are missing on.
        """
        batch = []
        while self._pending and len(batch) < self._batch_limit:
            entry = self._pending.popleft()
            self._pending_rows -= entry[0].n_rows
            batch.append(entry)
        if batch:
            self._cv.notify_all()        # wake blocked submitters
        return batch

    @staticmethod
    def _resolve(fut: Future, *, result=None, exc=None) -> None:
        """Resolve a future, tolerating client-side cancellation — a
        cancelled future must never take down the worker thread."""
        if not fut.set_running_or_notify_cancel():
            return                                   # client cancelled it
        if exc is not None:
            fut.set_exception(exc)
        else:
            fut.set_result(result)

    def _expire_stale(self, batch: list) -> list:
        """Shed queued entries whose deadline already passed (DESIGN.md §9).

        Runs at batch start, BEFORE the engine pass: a request that cannot
        possibly be answered in time must not ride the pass (it would only
        slow every co-batched request down). Resolves the stale futures
        with ``DeadlineExceeded`` and returns the live remainder.
        """
        now = self._clock()
        live = []
        for entry in batch:
            request, fut, _, t_ddl = entry
            if t_ddl is not None and now >= t_ddl:
                self.stats.expired += 1
                self._resolve(fut, exc=DeadlineExceeded(
                    f"request {request.rid}: deadline passed while queued"))
            else:
                live.append(entry)
        return live

    def _adapt_batch_limit(self, missed: int) -> None:
        """Shrink/regrow the adaptive batch limit from deadline outcomes.

        Any miss halves the limit (a smaller batch is faster, so queued
        deadlines get a fighting chance); a streak of clean batches regrows
        it one step at a time back toward ``max_batch_requests`` — the
        classic multiplicative-decrease / additive-increase shape.
        """
        if missed:
            self._ok_streak = 0
            if self._batch_limit > 1:
                self._batch_limit = max(1, self._batch_limit // 2)
                self.stats.batch_shrinks += 1
        else:
            self._ok_streak += 1
            if (self._ok_streak >= 4
                    and self._batch_limit < self.max_batch_requests):
                self._batch_limit += 1
                self.stats.batch_grows += 1
                self._ok_streak = 0

    def _run_batch(self, batch: list) -> None:
        """One batch: shed stale deadlines, cache lookups, ONE serve_batch
        for the misses, resolve.

        Runs under ``_corpus_lock`` so commits never interleave with a
        batch's cache-validate → detect → memoize sequence (the cache entry
        epoch must match the corpus the engine saw). Every completed batch
        feeds the latency EWMA (admission control) and the adaptive batch
        limit; a batch that raises feeds the ``failed_batches`` /
        ``failed_requests`` counters instead of vanishing from the stats.
        """
        t_start = self._clock()
        batch = self._expire_stale(batch)
        if not batch:
            return
        for _, _, t_sub, _ in batch:
            self.stats.record_wait(t_start - t_sub)
        with self._corpus_lock:
            reqs = [entry[0] for entry in batch]
            responses: list = [None] * len(batch)
            miss_idx = list(range(len(batch)))
            if self.cache is not None:
                miss_idx = []
                inv0 = self.cache.invalidations
                for i, r in enumerate(reqs):
                    hit = self.cache.lookup(r, self.epoch,
                                            self.resident.n_corpus,
                                            self._touched_log)
                    if hit is None:
                        miss_idx.append(i)
                    else:
                        hit.batch_requests = len(batch)
                        hit.batch_rows = sum(q.n_rows for q in reqs)
                        responses[i] = hit
                self.stats.cache_hits += len(batch) - len(miss_idx)
                self.stats.cache_misses += len(miss_idx)
                # accumulate the delta so the counter survives the
                # stats-reset pattern the benchmarks use
                self.stats.cache_invalidations += \
                    self.cache.invalidations - inv0
            try:
                fresh = (serve_batch(self.base, self.base_p, self.engine,
                                     [reqs[i] for i in miss_idx],
                                     resident=self.resident,
                                     index=self._index)
                         if miss_idx else [])
            except Exception as exc:                  # noqa: BLE001
                # cache hits already have their exact responses in hand —
                # only the futures waiting on the failed engine pass fail
                done = self._clock()
                n_failed = 0
                for i, (_, fut, t_sub, _) in enumerate(batch):
                    if responses[i] is None:
                        n_failed += 1
                        self._resolve(fut, exc=exc)
                    else:
                        responses[i].latency_s = done - t_sub
                        self._resolve(fut, result=responses[i])
                self.stats.failed_batches += 1
                self.stats.failed_requests += n_failed
                return
            for i, resp in zip(miss_idx, fresh):
                responses[i] = resp
                if self.cache is not None:
                    self.cache.put(reqs[i], resp, self.epoch)
        done = self._clock()
        missed = 0
        for (request, fut, t_sub, t_ddl), resp in zip(batch, responses):
            resp.latency_s = done - t_sub
            if t_ddl is not None and done > t_ddl:
                missed += 1
            self._resolve(fut, result=resp)
        self.stats.requests += len(batch)
        self.stats.batches += 1
        self.stats.rows += sum(r.n_rows for r in reqs)
        self.stats.host_copy_bytes += fresh[0].host_copy_bytes if fresh else 0
        # EWMA of batch latency — what admission control predicts waits with
        dt = done - t_start
        self._ewma_batch_s = (dt if self._ewma_batch_s <= 0.0
                              else 0.7 * self._ewma_batch_s + 0.3 * dt)
        self._adapt_batch_limit(missed)

    # -- corpus mutation (DESIGN.md §7) --------------------------------------

    def commit(self, values: np.ndarray, accuracy: np.ndarray,
               p_claim: np.ndarray, *, compact: bool = True,
               _owner_range=None):
        """Fold accepted query rows into the corpus, permanently.

        Appends the rows to the resident buffers, advances the committed
        index through ``index.commit_rows`` (membership bits, delta chunks,
        refreshed scores, Ē mask — optionally compacting once deltas exceed
        ``compact_threshold``), bumps the corpus epoch, and records the
        commit's touched claim keys for the cache's exact invalidation.
        Serialized against in-flight batches by ``_corpus_lock`` — reads
        keep flowing between commits, writes never interleave with a pass.

        On a durable service the commit is also appended to the commit log
        (fsync'd per ``DurabilityOptions.fsync`` — the durability point is
        this method returning) and a full snapshot is written every
        ``snapshot_every`` commits.

        Returns the ``CommitInfo`` receipt (None for index-less modes).
        """
        with self._corpus_lock:
            return self._commit_locked(values, accuracy, p_claim,
                                       compact=compact,
                                       owner_range=_owner_range)

    def _commit_locked(self, values: np.ndarray, accuracy: np.ndarray,
                       p_claim: np.ndarray, *, compact: bool = True,
                       log: bool = True, owner_range=None):
        """Apply one commit; caller holds ``_corpus_lock``.

        ``log=False`` is the replay path (``restore``): the commit being
        applied already IS a log record, so appending it again would double
        it. Everything else — index mutation, epoch, touched-key log, stats
        — is identical, which is what makes replay reproduce the live
        commit bit-for-bit (DESIGN.md §8.2).

        On a shared-index replica (``_shared_index``) the committed index
        belongs to the primary and is mutated exactly once — there; this
        replica applies the claims state, bumps its epoch, and logs the
        record (tagged with ``owner_range`` when the router routed it).
        """
        values = np.asarray(values, np.int32)
        accuracy = np.asarray(accuracy, np.float32)
        p_claim = np.asarray(p_claim, np.float32)
        if values.shape[1] != self.resident.n_items:
            raise ValueError(
                f"commit: {values.shape[1]} items, corpus has "
                f"{self.resident.n_items}")
        q = values.shape[0]
        n_before = self.resident.n_corpus
        touched = claim_value_keys(values)
        self.resident.commit_rows(values, accuracy, p_claim)
        # growth may have reallocated — rebind the corpus views
        self.base = self.resident.corpus_view()
        self.base_p = self.resident.p_claim[: self.resident.n_corpus]
        info = None
        if self._index is not None and not self._index_shared:
            self._index.store.ensure_row_capacity(
                self.resident.n_corpus + self.max_pending_rows)
            info = commit_rows(
                self._index, self.base, self.base_p, self.engine.cfg, q,
                compact=compact,
                compact_threshold=self.compact_threshold)
            self.stats.new_entries += info.new_entries
            self.stats.reindexed_entries += info.touched_entries
            self.stats.delta_chunks += info.delta_chunks_added
            self.stats.compactions += int(info.compacted)
            # permanent commit: fold the changed cells into the engine's
            # block-OR mask cache so the next detect skips the full
            # regather (router broadcasts run this per replica)
            self.engine.apply_mask_delta(info.delta)
        self.epoch += 1
        if self.cache is not None:
            self._touched_log.append((self.epoch, touched))
            # log entries no surviving cache entry predates are dead
            # (lookups skip commits ≤ the entry's validation epoch) —
            # prune them so a long-lived service stays O(live entries)
            floor = self.cache.oldest_epoch(self.epoch)
            self._touched_log = [t for t in self._touched_log
                                 if t[0] > floor]
        self.stats.commits += 1
        self.stats.committed_rows += q
        snap_path = None
        if self._log is not None and log:
            lo, hi = owner_range if owner_range is not None else (-1, -1)
            self._log.append(CommitRecord(
                epoch=self.epoch, values=values, accuracy=accuracy,
                p_claim=p_claim, touched_keys=touched, compact=compact,
                compacted=bool(info.compacted) if info is not None else False,
                owner_lo=int(lo), owner_hi=int(hi)))
            every = self.durability.snapshot_every
            if every and self.epoch % every == 0:
                snap_path = self._write_snapshot_locked()
        # rollback receipt for rollback_last_commit (LIFO, router recovery)
        self._last_commit = {"info": info, "rows": q, "n_before": n_before,
                             "epoch": self.epoch, "touched": touched,
                             "logged": self._log is not None and log,
                             "snapshot": snap_path}
        self._last_retract = None    # LIFO: only the newest mutation unwinds
        return info

    def rollback_last_commit(self) -> None:
        """Undo the LAST ``commit()``, bit-exact (LIFO only).

        The recovery half of ``ReplicaRouter.commit``'s broadcast protocol:
        when a later replica fails mid-broadcast, each replica that already
        applied the commit unwinds it — index (``rollback_commit``),
        resident rows (``truncate_corpus``), epoch, touched-key log, stats,
        cache entries stamped at the undone epoch, the commit's log record,
        and any snapshot the commit triggered. Raises ``RuntimeError`` when
        there is no commit to unwind (or it was already unwound).
        """
        with self._corpus_lock:
            last = self._last_commit
            if last is None:
                raise RuntimeError("no commit to roll back")
            if last["epoch"] != self.epoch:
                raise RuntimeError(
                    f"rollback_last_commit: last receipt is epoch "
                    f"{last['epoch']}, service is at {self.epoch} — only the "
                    f"immediately-preceding commit can be unwound")
            info = last["info"]
            if info is not None:
                rollback_commit(self._index, info)
                # the mask cache's delta chain is broken by the unwind —
                # drop it; the next indexed detect rebuilds it fresh
                self.engine.invalidate_mask_cache()
                self.stats.new_entries -= info.new_entries
                self.stats.reindexed_entries -= info.touched_entries
                self.stats.delta_chunks -= info.delta_chunks_added
                self.stats.compactions -= int(info.compacted)
            self.resident.truncate_corpus(last["n_before"])
            self.base = self.resident.corpus_view()
            self.base_p = self.resident.p_claim[: self.resident.n_corpus]
            self.epoch -= 1
            self._touched_log = [t for t in self._touched_log
                                 if t[0] <= self.epoch]
            if self.cache is not None:
                # entries memoized/re-validated while the commit was live
                # assumed its corpus — they must not survive the unwind
                self.cache.drop_after(self.epoch)
            self.stats.commits -= 1
            self.stats.committed_rows -= last["rows"]
            if last["logged"] and self._log is not None:
                self._log.rollback_last()
            if last["snapshot"] is not None:
                try:
                    os.remove(last["snapshot"])
                except OSError:
                    pass
            self._last_commit = None

    # -- source retraction (DESIGN.md §9) ------------------------------------

    def retract(self, row_ids, *, _owner_range=None):
        """Remove committed corpus sources, permanently (DESIGN.md §9).

        ``row_ids`` index the CURRENT corpus rows to drop (a takedown, a
        poisoned crawl, a revoked source). The retraction compacts the
        resident corpus, unwinds the rows' membership bits in the committed
        index, GCs entries left below two providers (no longer *shared*
        values), re-scores surviving touched entries, re-derives the Ē
        boundary, eagerly reconciles the result cache (entries sharing a
        claim key with a retracted row die; survivors lose the columns),
        bumps the epoch, and — on a durable service — appends a
        ``RetractRecord`` to the commit log before returning, replayed on
        ``restore`` exactly like commits. Post-state decisions equal a
        service rebuilt without the retracted sources.

        Returns the ``RetractInfo`` receipt (None for index-less modes).
        """
        with self._corpus_lock:
            return self._retract_locked(row_ids, log=True,
                                        owner_range=_owner_range)

    def _retract_locked(self, row_ids, *, log: bool = True,
                        owner_range=None):
        """Apply one retraction; caller holds ``_corpus_lock``.

        ``log=False`` is the replay path (``restore``), mirroring
        ``_commit_locked`` — the retraction being applied already IS a log
        record.
        """
        row_ids = np.unique(np.asarray(row_ids, np.int64).ravel())
        n_before = self.resident.n_corpus
        if row_ids.size == 0:
            raise ValueError("retract: no rows given")
        if row_ids[0] < 0 or row_ids[-1] >= n_before:
            raise ValueError(
                f"retract: row ids must be in [0, {n_before}), got "
                f"[{row_ids[0]}, {row_ids[-1]}]")
        # save the rows before they vanish — the rollback receipt restores
        # them bit-exact, and their claim keys drive cache invalidation
        saved_values = self.resident.values[row_ids].copy()
        saved_accuracy = self.resident.accuracy[row_ids].copy()
        saved_p = self.resident.p_claim[row_ids].copy()
        touched = claim_value_keys(saved_values)
        self.resident.retract_rows(row_ids)
        self.base = self.resident.corpus_view()
        self.base_p = self.resident.p_claim[: self.resident.n_corpus]
        info = None
        if self._index is not None and not self._index_shared:
            info = index_retract_rows(self._index, self.base,
                                      self.engine.cfg, row_ids)
            self.stats.gc_entries += info.gc_entries
            # incremental mask-cache maintenance: recompute only the block
            # rows the compaction shifted, zero the GC'd columns
            self.engine.apply_mask_delta(info.delta)
        self.epoch += 1
        if self.cache is not None:
            # eager reconciliation, NOT a touched-log entry: the retraction
            # renumbers the corpus column axis, so lookup-time replay could
            # never re-align a surviving entry after the fact
            self.stats.cache_invalidations += self.cache.apply_retraction(
                row_ids, touched, n_before)
        self.stats.retractions += 1
        self.stats.retracted_rows += int(row_ids.size)
        snap_path = None
        if self._log is not None and log:
            lo, hi = owner_range if owner_range is not None else (-1, -1)
            self._log.append(RetractRecord(
                epoch=self.epoch, row_ids=row_ids, touched_keys=touched,
                n_before=n_before, owner_lo=int(lo), owner_hi=int(hi)))
            every = self.durability.snapshot_every
            if every and self.epoch % every == 0:
                snap_path = self._write_snapshot_locked()
        self._last_retract = {
            "info": info, "row_ids": row_ids, "n_before": n_before,
            "epoch": self.epoch, "values": saved_values,
            "accuracy": saved_accuracy, "p_claim": saved_p,
            "logged": self._log is not None and log, "snapshot": snap_path}
        self._last_commit = None     # LIFO: only the newest mutation unwinds
        return info

    def rollback_last_retract(self) -> None:
        """Undo the LAST ``retract()``, bit-exact (LIFO only).

        The recovery half of ``ReplicaRouter``'s broadcast protocol for
        retractions: restores the retracted rows at their original indices
        (``ResidentCorpus.unretract``), unwinds the index through the same
        snapshot receipt ``rollback_commit`` uses for commits, drops the
        epoch, the retraction's log record and any snapshot it triggered.
        The result cache restarts cold — ``apply_retraction``'s column
        surgery is not invertible entry-by-entry.
        """
        with self._corpus_lock:
            last = self._last_retract
            if last is None:
                raise RuntimeError("no retraction to roll back")
            if last["epoch"] != self.epoch:
                raise RuntimeError(
                    f"rollback_last_retract: last receipt is epoch "
                    f"{last['epoch']}, service is at {self.epoch} — only the "
                    f"immediately-preceding retraction can be unwound")
            info = last["info"]
            if info is not None:
                rollback_commit(self._index, info)
                # retraction applies are not invertible cell-by-cell —
                # drop the cache and let the next detect rebuild it
                self.engine.invalidate_mask_cache()
                self.stats.gc_entries -= info.gc_entries
            self.resident.unretract(last["row_ids"], last["values"],
                                    last["accuracy"], last["p_claim"])
            self.base = self.resident.corpus_view()
            self.base_p = self.resident.p_claim[: self.resident.n_corpus]
            self.epoch -= 1
            if self.cache is not None:
                self.cache.clear()
            self.stats.retractions -= 1
            self.stats.retracted_rows -= int(last["row_ids"].size)
            if last["logged"] and self._log is not None:
                self._log.rollback_last()
            if last["snapshot"] is not None:
                try:
                    os.remove(last["snapshot"])
                except OSError:
                    pass
            self._last_retract = None

    # -- durability (commit log + snapshots, DESIGN.md §8) -------------------

    def _attach_durability(self, opts: DurabilityOptions) -> None:
        """Wire this service to a state dir (called from ``__init__``).

        Creates the dir, writes the manifest when absent (the config needed
        to reconstruct the service at restore time), truncates any torn log
        tail, opens the log for appending, and — when the dir holds no
        snapshot yet — writes the initial one, so a restore never needs the
        original corpus arrays.
        """
        os.makedirs(opts.state_dir, exist_ok=True)
        self.durability = opts
        if not os.path.exists(os.path.join(opts.state_dir, MANIFEST_NAME)):
            write_manifest(opts.state_dir, self._manifest())
        log_path = os.path.join(opts.state_dir, LOG_NAME)
        CommitLog.recover(log_path)
        self._log = CommitLog(log_path, fsync=opts.fsync)
        if not list_snapshots(opts.state_dir):
            with self._corpus_lock:
                self._write_snapshot_locked()

    def _manifest(self) -> dict:
        """The JSON-serializable config a restore needs to rebuild ``self``."""
        return {
            "cfg": dataclasses.asdict(self.engine.cfg),
            "service": {
                "mode": self.engine.mode,
                "max_batch_requests": self.max_batch_requests,
                "max_pending_rows": self.max_pending_rows,
                "result_cache": self._result_cache_requested,
                "cache_entries": (self.cache.max_entries
                                  if self.cache is not None else 256),
                "compact_threshold": self.compact_threshold,
            },
            "engine_options": dataclasses.asdict(self.engine.options),
            "durability": {
                "snapshot_every": self.durability.snapshot_every,
                "fsync": self.durability.fsync,
                "retention": self.durability.retention,
            },
        }

    def _write_snapshot_locked(self) -> str:
        """Serialize full service state as the current epoch's snapshot.

        Caller holds ``_corpus_lock``. Captures the resident corpus rows,
        the committed index (``InvertedIndex.state_dict`` — the base+delta
        layout exactly as commits left it), the stats counters, the
        touched-key log, and the result-cache entries. Returns the path.
        """
        n = self.resident.n_corpus
        # a shared index belongs to the primary replica — it snapshots it;
        # this replica's snapshot carries only the claims state
        own_index = self._index is not None and not self._index_shared
        arrays = {
            "service/meta": np.array(
                [self.epoch, n, int(own_index),
                 int(self.cache is not None)], np.int64),
            "service/values": self.resident.values[:n],
            "service/accuracy": self.resident.accuracy[:n],
            "service/p_claim": self.resident.p_claim[:n],
            "service/stats": np.array(
                [getattr(self.stats, f.name)
                 for f in _stat_counter_fields()], np.int64),
            "service/touched_epochs": np.array(
                [e for e, _ in self._touched_log], np.int64),
            "service/touched_offsets": np.cumsum(
                [0] + [len(k) for _, k in self._touched_log]).astype(np.int64),
            "service/touched_keys": (
                np.concatenate([k for _, k in self._touched_log])
                if self._touched_log else np.zeros(0, np.int64)),
        }
        if own_index:
            arrays.update(self._index.state_dict())
        if self.cache is not None:
            arrays.update(self.cache.state_dict())
        return write_snapshot(self.durability.state_dir, self.epoch, arrays,
                              retention=self.durability.retention)

    @classmethod
    def restore(cls, state_dir: str, **overrides) -> "DetectionService":
        """Resurrect a durable service from its state dir.

        Reads the manifest, loads the newest snapshot that validates
        (corrupt ones are skipped), truncates the commit log's torn tail,
        replays the records past the snapshot epoch through the exact
        in-memory commit path, and reopens the log for appending — the
        returned service continues the SAME state dir. The warm cache's
        entries keep their pre-crash epochs, so the standard lookup-time
        invalidation replays them against whatever the log tail committed
        (DESIGN.md §8.3). ``overrides`` patch manifest config (e.g.
        ``device="cpu"``, which no manifest carries, or ``devices=8`` for a
        different host shape — engine knobs only; overriding corpus-shaping
        config would diverge from the log). A manifest written by the JAX
        package restores here (its ``kernel_impl`` dropped, its ``devices``
        and ``mesh_shape`` building the engine's mesh), and one written
        here restores in the JAX package.

        Raises ``NoValidSnapshotError`` when nothing loads and
        ``ReplayDivergenceError`` when a replayed commit does not land on
        the epoch/compaction outcome its record logged. The receipt is left
        on ``service.restore_info``.
        """
        t0 = time.perf_counter()
        manifest = read_manifest(state_dir)
        epoch_s, snap_file, arrays, skipped = latest_valid_snapshot(state_dir)
        t_load = time.perf_counter() - t0
        rec = CommitLog.recover(os.path.join(state_dir, LOG_NAME))

        meta = np.asarray(arrays["service/meta"], np.int64)
        snap_epoch, n_corpus, has_index, has_cache = (int(x) for x in meta[:4])
        base = ClaimsDataset(
            values=np.asarray(arrays["service/values"], np.int32),
            accuracy=np.asarray(arrays["service/accuracy"], np.float32))
        base_p = np.asarray(arrays["service/p_claim"], np.float32)

        kw = dict(manifest["service"])
        kw.update(manifest["engine_options"])
        dur = dict(manifest["durability"])
        for k, v in overrides.items():
            (dur if k in dur else kw)[k] = v
        cfg = CopyConfig(**manifest["cfg"])
        svc = cls(base, base_p, cfg,
                  _index_state=arrays if has_index else None, **kw)

        # snapshot-time dynamic state: epoch, stats, touched log, warm cache
        svc.epoch = snap_epoch
        # zip tolerates snapshots from older builds with fewer counters
        for f, v in zip(_stat_counter_fields(),
                        np.asarray(arrays["service/stats"], np.int64)):
            setattr(svc.stats, f.name, int(v))
        epochs = np.asarray(arrays["service/touched_epochs"], np.int64)
        offs = np.asarray(arrays["service/touched_offsets"], np.int64)
        keys = np.asarray(arrays["service/touched_keys"], np.int64)
        svc._touched_log = [(int(e), keys[offs[i]: offs[i + 1]])
                            for i, e in enumerate(epochs)]
        if has_cache and svc.cache is not None:
            svc.cache.load_state_dict(arrays)

        # replay the log tail: records past the snapshot epoch, in order,
        # through the exact live-commit path (no re-logging)
        t1 = time.perf_counter()
        replayed = 0
        records, _, _ = CommitLog.scan(os.path.join(state_dir, LOG_NAME))
        for record in records:
            if record.epoch <= svc.epoch:
                continue
            if record.epoch != svc.epoch + 1:
                raise ReplayDivergenceError(
                    f"log record for epoch {record.epoch} follows service "
                    f"epoch {svc.epoch} — a record is missing")
            if isinstance(record, RetractRecord):
                if record.n_before != svc.resident.n_corpus:
                    raise ReplayDivergenceError(
                        f"retraction record at epoch {record.epoch} was "
                        f"logged against {record.n_before} corpus rows, "
                        f"replay reached it with {svc.resident.n_corpus}")
                with svc._corpus_lock:
                    svc._retract_locked(record.row_ids, log=False)
                if svc.epoch != record.epoch:
                    raise ReplayDivergenceError(
                        f"replaying retraction for epoch {record.epoch} "
                        f"landed on epoch {svc.epoch}")
                replayed += 1
                continue
            with svc._corpus_lock:
                info = svc._commit_locked(
                    record.values, record.accuracy, record.p_claim,
                    compact=record.compact, log=False)
            if svc.epoch != record.epoch or (
                    info is not None
                    and bool(info.compacted) != record.compacted):
                raise ReplayDivergenceError(
                    f"replaying epoch {record.epoch} landed on epoch "
                    f"{svc.epoch} (compacted="
                    f"{None if info is None else info.compacted}, record "
                    f"said {record.compacted})")
            replayed += 1
        t_replay = time.perf_counter() - t1
        # the last replayed mutation's rollback receipt is unusable: its log
        # record predates this process (rollback could not unwind it there)
        svc._last_commit = None
        svc._last_retract = None

        svc._attach_durability(DurabilityOptions(state_dir=state_dir, **dur))
        svc.restore_info = RestoreInfo(
            snapshot_epoch=snap_epoch, snapshot_path=snap_file,
            replayed_commits=replayed, discarded_bytes=rec.discarded_bytes,
            skipped_snapshots=skipped, snapshot_load_s=t_load,
            replay_s=t_replay, wall_s=time.perf_counter() - t0)
        return svc

    def flush(self) -> int:
        """Synchronously drain the queue in the caller's thread.

        Returns the number of requests served. Only valid when no worker
        thread is running (deterministic tests / benchmarks) — the engine is
        stateful per pass, so two threads must never drive it concurrently."""
        if self._worker is not None and self._worker.is_alive():
            raise RuntimeError(
                "flush() while the worker thread is running would drive the "
                "engine from two threads; use the futures instead")
        served = 0
        while True:
            with self._cv:
                batch = self._take_batch()
            if not batch:
                return served
            self._run_batch(batch)
            served += len(batch)

    # -- worker lifecycle ---------------------------------------------------

    def _worker_loop(self) -> None:
        while True:
            with self._cv:
                while not self._pending and not self._stopping:
                    self._cv.wait()
                if self._stopping and not self._pending:
                    return
                batch = self._take_batch()
            if batch:
                self._run_batch(batch)

    def start(self) -> "DetectionService":
        """Start the background worker (idempotent)."""
        if self._worker is None or not self._worker.is_alive():
            self._stopping = False
            self._worker = threading.Thread(
                target=self._worker_loop, name="detection-service", daemon=True)
            self._worker.start()
        return self

    def stop(self) -> None:
        """Drain remaining requests, then join the worker."""
        if self._worker is None:
            self.flush()
            return
        with self._cv:
            self._stopping = True
            self._cv.notify_all()
        self._worker.join()
        self._worker = None
        with self._cv:
            # back to idle under the lock, so a submitter that raced the
            # shutdown either saw _stopping (and raised) or lands in the
            # defined idle state: enqueued for a later flush()/start()
            self._stopping = False

    def __enter__(self) -> "DetectionService":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()


class CircuitBreaker:
    """Classic closed → open → half-open breaker around one replica (§9).

    ``record_failure`` counts CONSECUTIVE failures; at ``failure_threshold``
    the breaker trips open and ``allow()`` refuses the protected operation
    until ``cooldown_s`` elapses, after which ONE probe is admitted
    (half-open). A half-open failure re-opens immediately (and restarts the
    cooldown); a success closes the breaker and resets the count. The clock
    is injectable so fault tests can drive the cooldown deterministically.
    """

    def __init__(self, failure_threshold: int = 5, cooldown_s: float = 5.0,
                 clock=time.monotonic):
        if failure_threshold < 1:
            raise ValueError(
                f"failure_threshold must be ≥ 1, got {failure_threshold}")
        self.failure_threshold = int(failure_threshold)
        self.cooldown_s = float(cooldown_s)
        self._clock = clock
        self.state = "closed"            # "closed" | "open" | "half-open"
        self.failures = 0                # consecutive, resets on success
        self.trips = 0                   # lifetime closed/half-open → open
        self._opened_at = 0.0

    def allow(self) -> bool:
        """May the protected operation be attempted right now?

        Closed: yes. Open: no until the cooldown elapses, then the breaker
        moves to half-open and admits the probe. Half-open: yes (the probe).
        """
        if self.state == "open":
            if self._clock() - self._opened_at < self.cooldown_s:
                return False
            self.state = "half-open"
        return True

    def record_success(self) -> None:
        """The protected operation succeeded — close and reset the count."""
        self.failures = 0
        self.state = "closed"

    def record_failure(self) -> None:
        """The protected operation failed — count it, trip at threshold.

        A half-open failure trips regardless of the count: the probe just
        proved the replica is still unhealthy.
        """
        self.failures += 1
        if (self.state == "half-open"
                or self.failures >= self.failure_threshold):
            self.trips += 1
            self.state = "open"
            self._opened_at = self._clock()


class ReplicaBroadcastError(RuntimeError):
    """A write broadcast failed on one replica and was rolled back.

    Raised by ``ReplicaRouter.commit``/``retract`` after every replica that
    had already applied the write unwound it (LIFO) — the fleet is back at
    the pre-write epoch, consistent. ``replica`` is the index of the service
    that raised (-1 when no replica could accept the write at all);
    ``__cause__`` carries its exception.
    """

    def __init__(self, replica: int, cause: Optional[BaseException] = None):
        if cause is not None:
            msg = (f"commit broadcast failed on replica {replica}: "
                   f"{cause!r}; preceding replicas rolled back")
        else:
            msg = ("broadcast rejected: every replica's circuit breaker "
                   "is open — no replica applied the write")
        super().__init__(msg)
        self.replica = replica


class ReplicaRouter:
    """Fan requests across N ``DetectionService`` replicas (DESIGN.md §7).

    Reads scale: ``submit`` round-robins over the replicas, each with its
    own engine, resident corpus, committed index, and result cache, so
    independent batches run concurrently. Writes stay serialized:
    ``commit`` holds the router's write lock while broadcasting the same
    rows to EVERY replica in order — each replica's own ``_corpus_lock``
    fences the commit against its in-flight batches, and because every
    replica applies the identical commit sequence, their corpus epochs stay
    equal (asserted after each broadcast — the epoch protocol §7 documents).
    A read routed to any replica therefore sees some prefix of the commit
    history, and the responses it returns are exactly the decisions of that
    epoch's corpus — never a torn mix of two epochs.

    Failure handling is two-tier (DESIGN.md §9). A replica that raises
    mid-broadcast *below* its breaker's failure threshold triggers LIFO
    rollback of the replicas that already applied (bit-exact), so the
    failed write leaves the fleet at the pre-write epoch instead of
    split-brained; the caller sees one ``ReplicaBroadcastError``. A replica
    that keeps failing trips its per-replica ``CircuitBreaker`` and is
    EJECTED instead: the fleet keeps committing without it, its missed
    writes queue in a per-replica backlog, reads route around it, and after
    the breaker cooldown one probe write replays the backlog (catch-up) —
    on success the replica rejoins with epoch equality, asserted by the
    post-broadcast check over in-sync replicas.
    """

    def __init__(self, base: ClaimsDataset, base_p: np.ndarray,
                 cfg: CopyConfig, *, n_replicas: int = 2,
                 breaker_threshold: int = 5, breaker_cooldown_s: float = 5.0,
                 shard_owners: Optional[int] = None,
                 breaker_clock=time.monotonic,
                 **service_kw):
        """Build ``n_replicas`` identical services over one corpus.

        A ``durability=DurabilityOptions(...)`` in ``service_kw`` is split
        into per-replica ``replica-<i>/`` subdirectories of its state dir —
        replicas must never interleave records in one commit log.
        ``breaker_threshold`` consecutive write failures eject a replica
        (circuit opens); ``breaker_cooldown_s`` later it is probed for
        recovery. ``breaker_clock`` is the breakers' time source (fault
        tests inject a fake one to drive the cooldown deterministically).

        ``shard_owners=n`` switches the fleet to SHARD-OWNER mode
        (DESIGN.md §12): replica count becomes ``n`` and each replica owns
        one row range of a single shared row-range-sharded index instead of
        a full corpus copy. Replica 0 (the primary) builds the index with
        ``n_shards=n``; replicas 1.. adopt it (``_shared_index``) and hold
        only the claims state + their own WAL. Reads in a tiled fan-out
        mode (``DetectionEngine.OWNER_FANOUT_MODES``) scatter per-owner
        tile scans gated by each owner's breaker and merge the partial
        grids with the exact rule; commits/retractions stamp the owning
        row range into every replica's WAL records.
        """
        self.shard_owners = (int(shard_owners)
                             if shard_owners is not None else None)
        if self.shard_owners is not None:
            if self.shard_owners < 1:
                raise ValueError(
                    f"shard_owners must be ≥ 1, got {shard_owners}")
            n_replicas = self.shard_owners
            if self.shard_owners > 1:
                # the shared index's store IS the placement: one slice per
                # owner replica, under a balanced row-range ShardPlan
                service_kw["n_shards"] = self.shard_owners
        if n_replicas < 1:
            raise ValueError(f"n_replicas must be ≥ 1, got {n_replicas}")
        dur = service_kw.pop("durability", None)
        self.replicas = []
        for i in range(n_replicas):
            kw = dict(service_kw)
            if dur is not None:
                kw["durability"] = dataclasses.replace(
                    dur, state_dir=os.path.join(dur.state_dir, f"replica-{i}"))
            if (self.shard_owners and i > 0
                    and self.replicas[0]._index is not None):
                kw["_shared_index"] = self.replicas[0]._index
            self.replicas.append(DetectionService(base, base_p, cfg, **kw))
        self.breakers = [
            CircuitBreaker(breaker_threshold, breaker_cooldown_s,
                           clock=breaker_clock)
            for _ in range(n_replicas)]
        self._backlogs = [deque() for _ in range(n_replicas)]
        self._rr = 0
        self._route_lock = threading.Lock()
        self._write_lock = threading.Lock()

    def _in_sync(self) -> list:
        """Replica indices at the fleet epoch: breaker closed, no backlog."""
        return [i for i in range(len(self.replicas))
                if self.breakers[i].state == "closed"
                and not self._backlogs[i]]

    def _epoch_locked(self) -> int:
        """Common epoch check over IN-SYNC replicas; caller must hold
        ``_write_lock`` (a read during a commit broadcast would otherwise
        see a healthy mid-broadcast prefix as divergence). An ejected
        replica is legitimately behind — its backlog measures by how much —
        so it is excluded until catch-up rejoins it."""
        sync = self._in_sync()
        if not sync:
            raise RuntimeError("no in-sync replica (all circuit-open)")
        epochs = {self.replicas[i].epoch for i in sync}
        if len(epochs) != 1:
            raise RuntimeError(f"replica epochs diverged: {sorted(epochs)}")
        return epochs.pop()

    @property
    def epoch(self) -> int:
        """The (common) corpus epoch; raises if replicas ever diverge."""
        with self._write_lock:
            return self._epoch_locked()

    @property
    def stats(self) -> ServiceStats:
        """Aggregate counters summed over every replica, plus the router's
        breaker gauges (``breaker_trips`` lifetime, ``breaker_open`` now)."""
        agg = ServiceStats()
        for svc in self.replicas:
            for f in dataclasses.fields(ServiceStats):
                setattr(agg, f.name,
                        getattr(agg, f.name) + getattr(svc.stats, f.name))
        agg.breaker_trips = sum(b.trips for b in self.breakers)
        agg.breaker_open = sum(1 for b in self.breakers
                               if b.state != "closed")
        return agg

    def submit(self, request: DetectRequest,
               timeout: Optional[float] = 30.0) -> Future:
        """Route one request to the next IN-SYNC replica (round-robin).

        An ejected replica is missing commits its backlog holds — serving
        reads from it would answer with a stale corpus, so reads route
        around open breakers until catch-up rejoins the replica. Raises
        ``ServiceOverloaded`` when every replica is circuit-open.

        In shard-owner mode there is no full-copy replica to round-robin
        over: a tiled fan-out mode scatters the scan across ALL owner
        replicas (``_submit_owner_fanout``); any other mode reads through
        the primary, whose shard facade assembles rows from every owner's
        slice.
        """
        if self.shard_owners and self.shard_owners > 1:
            if (self.replicas[0].engine.mode
                    in DetectionEngine.OWNER_FANOUT_MODES):
                return self._submit_owner_fanout(request)
            return self.replicas[0].submit(request, timeout=timeout)
        with self._route_lock:
            sync = self._in_sync()
            if not sync:
                raise ServiceOverloaded(
                    "no in-sync replica to serve reads (all circuit-open)")
            self._rr = self._rr % len(sync)
            svc = self.replicas[sync[self._rr]]
            self._rr = (self._rr + 1) % len(sync)
        return svc.submit(request, timeout=timeout)

    # -- shard-owner mode (DESIGN.md §12) ------------------------------------

    def _owner_plan(self):
        """The fleet's row-range placement (owner i ↔ shard slice i)."""
        idx = self.replicas[0]._index
        if idx is not None and isinstance(idx.store, ShardedCorpusStore):
            return idx.store.plan
        # index-less modes carry no persistent store — derive the balanced
        # plan the engine's one-shot build will use at the current size
        return make_shard_plan(self.replicas[0].resident.n_corpus,
                               self.shard_owners or 1)

    def owner_of_row(self, r: int) -> int:
        """Which owner replica's slice holds corpus row ``r``."""
        return int(self._owner_plan().owner_of_row(int(r)))

    def _submit_owner_fanout(self, request: DetectRequest) -> Future:
        """Serve one request by fanning the tile scan across owner replicas.

        Synchronous (the caller's thread runs the pass): stage the request
        on the primary's resident buffers, build ONE owner scan context,
        collect each owner's partial tile stacks — gated by that owner's
        circuit breaker, so a dead owner surfaces ONE typed
        ``ShardScanError`` carrying its id and NO partial grids are merged
        — then merge with the exact rule (counts summed, p̂-error bounds
        maxed) and finalize into decisions bit-equal to a single-host pass.
        The returned future is already resolved (result or exception).
        """
        fut: Future = Future()
        fut.set_running_or_notify_cancel()
        svc = self.replicas[0]
        t0 = time.perf_counter()
        try:
            # writes never interleave with a fan-out pass: the router's
            # write lock orders it in the broadcast history, the primary's
            # corpus lock fences its own worker/commits
            with self._write_lock, svc._corpus_lock:
                resp = self._owner_pass_locked(svc, request)
            resp.latency_s = time.perf_counter() - t0
            svc.stats.requests += 1
            svc.stats.batches += 1
            svc.stats.rows += request.n_rows
            fut.set_result(resp)
        except BaseException as exc:  # noqa: BLE001 — future carries it
            svc.stats.failed_batches += 1
            svc.stats.failed_requests += 1
            fut.set_exception(exc)
        return fut

    def _owner_pass_locked(self, svc: DetectionService,
                           request: DetectRequest) -> DetectResponse:
        """One owner-fan-out engine pass; caller holds the locks.

        Mirrors ``serve_batch``'s transient-commit protocol around the
        primary's committed index, but replaces the monolithic
        ``engine.detect`` with owner_scan_context → per-owner
        ``detect_owner_partial`` (breaker-gated) → ``finalize_owner_partials``.
        """
        eng = svc.engine
        S0 = svc.base.n_sources
        if request.values.shape[1] != svc.base.n_items:
            raise ValueError(
                f"request {request.rid}: {request.values.shape[1]} items, "
                f"corpus has {svc.base.n_items}")
        union, p, copied = svc.resident.stage([request])
        idx = svc._index
        info = token = None
        if idx is not None and eng.mode in INDEXED_MODES:
            idx.store.ensure_row_capacity(union.n_sources)
            info = commit_rows(idx, union, p, eng.cfg,
                               union.n_sources - S0, compact=False)
            token = eng.apply_mask_delta(info.delta)
        try:
            ctx = eng.owner_scan_context(union, p, index=idx)
            partials = []
            for i in range(len(self.replicas)):
                br = self.breakers[i]
                if not br.allow():
                    raise ShardScanError(
                        i, "owner replica is circuit-open (ejected); "
                           "refusing the scan before any partial merge")
                try:
                    part = eng.detect_owner_partial(union, p, i, ctx=ctx)
                except ShardScanError:
                    br.record_failure()
                    raise          # already typed with the owner id;
                                   # partials are discarded, never merged
                except Exception as exc:
                    br.record_failure()
                    raise ShardScanError(
                        i, f"owner scan failed: "
                           f"{type(exc).__name__}: {exc}") from exc
                br.record_success()
                partials.append(part)
            res = eng.finalize_owner_partials(union, p, ctx, partials)
        finally:
            if info is not None:
                rollback_commit(idx, info)
                if token is not None:
                    eng.undo_mask_delta(token)
                else:
                    eng.rebase_mask_cache(info.delta)
        rows = slice(S0, S0 + request.n_rows)
        svc.stats.host_copy_bytes += copied
        return DetectResponse(
            rid=request.rid,
            copying=res.copying[rows, :S0].copy(),
            pr_independent=res.pr_independent[rows, :S0].copy(),
            c_fwd=res.c_fwd[rows, :S0].copy(),
            intra_copying=res.copying[rows, rows].copy(),
            batch_requests=1,
            batch_rows=request.n_rows,
            engine_wall_s=res.wall_time_s,
            host_copy_bytes=copied,
        )

    def catch_up(self) -> list:
        """Replay backlogged writes into replicas whose cooldown elapsed.

        The read-side rejoin hook (``_broadcast`` does the same inline on
        the next write): for each replica with a backlog whose breaker
        admits a probe, replay its missed writes in order — success closes
        the breaker and rejoins the replica at the fleet epoch, a failure
        re-opens it with exactly the still-missing suffix queued. Returns
        per-replica counts of writes replayed.
        """
        replayed = [0] * len(self.replicas)
        with self._write_lock:
            for i, svc in enumerate(self.replicas):
                br = self.breakers[i]
                if not self._backlogs[i] or not br.allow():
                    continue
                try:
                    while self._backlogs[i]:
                        b_op, b_args, b_kw = self._backlogs[i][0]
                        getattr(svc, b_op)(*b_args, **b_kw)
                        self._backlogs[i].popleft()
                        replayed[i] += 1
                except Exception:  # noqa: BLE001 — breaker records it
                    br.record_failure()
                    continue
                br.record_success()
            if self._in_sync():
                self._epoch_locked()
        return replayed

    def rebalance(self, tolerance: float = 0.25) -> bool:
        """Unseal → rebalance → reseal the shared sharded store.

        The operator drill OPERATIONS.md §10 describes: when commit/retract
        growth skews the row-range placement past ``1 + tolerance``, re-split
        the rows evenly — unsealing first when the store is packed/spilled,
        and resealing with the engine's shard options afterward so the
        per-owner byte budgets re-apply under the NEW plan. Decisions are
        placement-independent (the merge rule is exact), so no cache entry
        is invalidated; the engine's block-OR mask caches are dropped
        because the store's membership sequence restarts. Returns True when
        rows moved.
        """
        svc = self.replicas[0]
        idx = svc._index
        if idx is None or not isinstance(idx.store, ShardedCorpusStore):
            raise RuntimeError(
                "rebalance needs a row-range-sharded committed index "
                "(shard_owners=n or n_shards>1 on an indexed mode)")
        opt = svc.engine.options
        with self._write_lock, svc._corpus_lock:
            store = idx.store
            was_sealed = store.sealed
            if was_sealed:
                store.unseal()
            moved = store.rebalance(tolerance)
            if was_sealed:
                store.seal(pack=opt.shard_pack,
                           spill_dir=opt.shard_spill_dir,
                           resident_bytes=opt.shard_spill_bytes)
            if moved:
                for r in self.replicas:
                    r.engine.invalidate_mask_cache()
        return moved

    def _broadcast(self, op: str, args: tuple, kw: dict) -> list:
        """Apply one write op to the fleet; caller holds ``_write_lock``.

        Per replica: an open breaker buffers the op in that replica's
        backlog (it stays ejected); a half-open breaker first replays the
        backlog (catch-up), then the live op. A failure below the breaker
        threshold aborts the wave — applied replicas roll back LIFO,
        tentatively-buffered ops pop back out, ``ReplicaBroadcastError``
        raises. A failure AT the threshold (or on a probe) ejects the
        replica instead: the wave continues and succeeds on the healthy
        rest. If no replica at all applies, the op never happened —
        buffered copies pop and ``ReplicaBroadcastError(-1)`` raises.
        """
        rollback = ("rollback_last_commit" if op == "commit"
                    else "rollback_last_retract")
        infos: list = [None] * len(self.replicas)
        applied: list = []       # replica indices that applied the live op
        deferred: list = []      # replicas that buffered it this wave
        for i, svc in enumerate(self.replicas):
            br = self.breakers[i]
            if not br.allow():
                self._backlogs[i].append((op, args, kw))
                deferred.append(i)
                continue
            try:
                # half-open probe: catch up on the missed writes first, in
                # order — each success pops, so a mid-catch-up failure
                # leaves exactly the still-missing suffix queued
                while self._backlogs[i]:
                    b_op, b_args, b_kw = self._backlogs[i][0]
                    getattr(svc, b_op)(*b_args, **b_kw)
                    self._backlogs[i].popleft()
                infos[i] = getattr(svc, op)(*args, **kw)
            except Exception as exc:               # noqa: BLE001
                br.record_failure()
                if br.state == "open":
                    # threshold (or probe) failure: eject, don't abort —
                    # the fleet keeps accepting writes without this replica
                    self._backlogs[i].append((op, args, kw))
                    deferred.append(i)
                    continue
                for j in reversed(applied):
                    getattr(self.replicas[j], rollback)()
                for j in deferred:
                    self._backlogs[j].pop()
                raise ReplicaBroadcastError(i, exc) from exc
            br.record_success()
            applied.append(i)
        if not applied:
            for j in deferred:
                self._backlogs[j].pop()
            raise ReplicaBroadcastError(-1)
        self._epoch_locked()                       # divergence check
        return infos

    def commit(self, values: np.ndarray, accuracy: np.ndarray,
               p_claim: np.ndarray, *, compact: bool = True) -> list:
        """Broadcast one commit to every replica, serialized (§7 protocol).

        Returns per-replica ``CommitInfo`` receipts (None at the index of a
        replica whose breaker deferred the commit to its backlog). A
        replica that raises below its breaker threshold aborts the
        broadcast: the replicas that already applied are rolled back in
        reverse order (``rollback_last_commit`` is LIFO-safe and
        bit-exact), and ONE ``ReplicaBroadcastError`` surfaces with the
        failing replica's index and cause — the fleet stays consistent at
        the pre-commit epoch. A replica that trips its breaker is ejected
        instead and the commit proceeds on the rest (§9 — see
        ``_broadcast``). The post-broadcast epoch check turns any remaining
        divergence among in-sync replicas (a replica that saw a different
        write order) into a hard error instead of silent split-brain.

        In shard-owner mode the commit additionally ROUTES: the appended
        rows land in ``owner_of_row(n_before)``'s slice (appends go to the
        plan's tail range; the shard facade places the bytes), and every
        replica's WAL record is stamped with the owning row range so each
        ``replica-<i>/`` dir restores independently (DESIGN.md §12).
        """
        with self._write_lock:
            kw: dict = {"compact": compact}
            if self.shard_owners:
                n_before = self.replicas[0].resident.n_corpus
                q = int(np.asarray(values).shape[0])
                kw["_owner_range"] = (n_before, n_before + q)
            return self._broadcast(
                "commit", (values, accuracy, p_claim), kw)

    def retract(self, row_ids) -> list:
        """Broadcast one source retraction to every replica, serialized.

        Same protocol as ``commit`` — LIFO rollback below the breaker
        threshold (``rollback_last_retract``), ejection + backlog at it —
        so retractions interleave with commits in one total write order,
        which is what keeps every replica's (and the WAL's) mutation
        history identical. Returns per-replica ``RetractInfo`` receipts.
        In shard-owner mode the WAL records carry the [lo, hi) row span
        covering the retracted ids (see ``commit``).
        """
        with self._write_lock:
            kw = {}
            if self.shard_owners:
                ids = np.asarray(row_ids, np.int64).ravel()
                if ids.size:
                    kw["_owner_range"] = (int(ids.min()), int(ids.max()) + 1)
            return self._broadcast("retract", (row_ids,), kw)

    def flush(self) -> int:
        """Drain every replica synchronously; returns requests served."""
        return sum(svc.flush() for svc in self.replicas)

    def start(self) -> "ReplicaRouter":
        """Start every replica's worker thread."""
        for svc in self.replicas:
            svc.start()
        return self

    def stop(self) -> None:
        """Drain and join every replica's worker."""
        for svc in self.replicas:
            svc.stop()

    def __enter__(self) -> "ReplicaRouter":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()


__all__ = ["CircuitBreaker", "DeadlineExceeded", "DetectRequest",
           "DetectResponse", "DetectionService", "DurabilityOptions",
           "ReplicaBroadcastError", "ReplicaRouter", "ResidentCorpus",
           "ResultCache", "ServiceOverloaded", "ServiceStats",
           "ServiceStopped", "serve_batch", "INDEXED_MODES"]
