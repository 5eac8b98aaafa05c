"""DetectionEngine — the entry point for copy detection.

Every mode of the JAX package's engine runs here, on the card or (with
``device="cpu"``) on the CPU. The production ``bucketed`` mode is the
pair-tiled dataflow of the JAX package's engine:

  1. build the inverted index (host numpy, streamed into the chunked
     ``CorpusStore``; the O(S²·D) ``l_counts`` product on the device) and
     re-chunk it p-sorted on each side of the Ē boundary
     (``engine_chunks`` — chunks double as the kernel's entry blocks);
  2. cut the S×S pair space into T×T tiles and prune, up front, every tile
     whose sources co-occur only inside the low-contribution suffix Ē
     (Proposition 3.4), from the per-chunk OR-reduced incidence — taken
     from the commit-maintained ``BlockOrCache`` when detecting against a
     persistent index it follows; only unordered (r ≤ c) tiles are
     scheduled;
  3. stream chunk groups (default one chunk per pass) host→device through
     the ``ChunkPrefetcher``: a producer thread fills pinned slabs of a
     ``SlabRing`` ``prefetch_depth`` groups ahead and uploads them on a side
     stream while the fused dual-direction copyscore kernel runs, once per
     group and mesh entry, over the entry's block of the surviving tile
     list; the five per-tile channels accumulate in device stacks across
     groups;
  4. scatter both orientations of every tile into (S, S) device grids,
     apply the INDEX step-3 different-value adjustment, exactly rescore
     every pair whose decision margin is within its accumulated error
     bound, and decide — all in torch on the engine's device. Decisions
     equal ``index_detect_exact``.

Modes
  pairwise      exhaustive oracle (§II-B)
  exact         entry-sequential INDEX with the paper's accounting (§III)
  bucketed      the tiled production INDEX (above)
  bound/bound+  early-terminating BOUND, optionally with timers (§IV)
  hybrid        BOUND+ for pairs sharing > l_threshold items (§IV-C)
  incremental   stateful rounds: the first call bootstraps HYBRID and its
                bookkeeping, later calls apply per-round deltas (§V)
  sampled       item sampling (§VI), then the tiled path on the subset
  sample_verify SCALESAMPLE candidate discovery, then an exact rescore of
                only the candidate pairs — decisions on the candidate set
                equal ``index_detect_exact``

Row-range shards (``n_shards`` > 1): indexes the engine builds are wrapped
in a ``ShardedCorpusStore`` (``core/shardplan.py``), which every mode reads
through. For the tiled modes the engine store is sealed for the scan —
bitpacked with ``shard_pack``, under a per-shard LRU byte cap that spills
cold blocks with ``shard_spill_bytes`` — and each shard owner scans only the
surviving tiles whose row block it owns, over a compact slab of the row
blocks those tiles touch; the owners' tile stacks stay on the device and
are scattered once into the grids. Per-tile kernel operands equal the
unsharded scan's, so at equal chunk groups the grids are bit-equal, and
decisions equal the unsharded engine's. ``owner_scan_context`` /
``detect_owner_partial`` / ``finalize_owner_partials`` split that scan into
one call per owner and a merge (the fan-out a shard-owner router drives).
The tile mesh (``devices``, ``mesh_shape``, ``core/distributed.py``): the
scan of every tiled mode runs over ``mesh()`` — the first ``devices`` of
``runtime.platform.local_devices(device)``, all of them by default: every
card, or the CPU entries ``set_host_device_count`` lists — or, with
``mesh_shape=(data, pod)``, over ``mesh2()``, tiles over ``data`` and each
group's chunks over ``pod``. Each surviving tile is scanned by one entry
(by one data member's pod members), the entries' stacks are gathered on the
mesh's first device and scattered there; on a 1-D mesh the grids are
bit-equal to the one-entry scan's. Row-range shards compose with it: every
owner's scan runs over the mesh. One process drives every device.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from repro_torch.core import tilecache
from repro_torch.core.bound import bound_detect
from repro_torch.core.bucketed import index_detect_exact
from repro_torch.core.distributed import (
    Mesh,
    MeshTileScan,
    group_tile_scores,
    make_mesh,
)
from repro_torch.core.incremental import (
    dataset_tensors,
    incremental_detect,
    make_incremental_state,
    rescore_pairs_exact,
)
from repro_torch.core.index import InvertedIndex, build_index, engine_chunks
from repro_torch.core.pipeline import (
    ChunkPrefetcher,
    PipelineStageError,
    SlabRing,
)
from repro_torch.core.sampling import sample_by_cell, sample_by_item, scale_sample
from repro_torch.core.scoring import (
    bucket_score_deltas,
    decide_copying,
    pairwise_detect,
    posterior_independence,
)
from repro_torch.core.shardplan import (
    OwnerPartial,
    ShardedCorpusStore,
    ShardScanError,
    make_shard_plan,
    merge_owner_partials,
    scatter_tile_stacks,
    shard_store,
)
from repro_torch.core.store import CorpusStore
from repro_torch.core.types import ClaimsDataset, CopyConfig, DetectionResult
from repro_torch.kernels.ops import pair_scores, tile_scores
from repro_torch.kernels.ref import PAIR_BATCH_ELEMENTS
from repro_torch.runtime.platform import local_devices
from repro_torch.utils.counters import ComputeCounter
from repro_torch.utils.device import resolve_device
from repro_torch.utils.timing import SpanLog, span_total

MODES = ("pairwise", "exact", "bucketed", "bound", "bound+", "hybrid",
         "incremental", "sampled", "sample_verify")


@dataclass
class EngineOptions:
    """Tuning knobs (the JAX engine's, where carried); mode-specific fields
    are ignored by other modes."""

    # entry buckets per index (count): the p̂ granularity of the chunks.
    n_buckets: int = 64
    # pair-tile edge (sources per tile side); clamped down for tiny datasets
    # (see _tile_edge).
    tile: int = 256
    # 1-D tile-mesh size (device count); None → every local device of the
    # engine's platform (runtime.platform.local_devices).
    devices: Optional[int] = None
    # decision-margin band (log-odds units) around z = 0 that triggers an
    # exact rescore on top of the accumulated p̂-error bound.
    rescore_margin: float = 1.0
    # incidence element type: auto | int8 (0/1 incidence, exact int32
    # counts). The JAX engine's bf16/f32 ablations are not carried.
    incidence_dtype: str = "auto"
    # hybrid crossover: apply BOUND checks only to pairs sharing more than
    # this many items; None → 16, the paper's §IV-C empirical crossover.
    l_threshold: Optional[int] = None
    # sampled / sample_verify: fraction of item columns to keep (0..1].
    # 0.1 reproduces the paper's §VI operating point (Table IX).
    sample_rate: float = 0.1
    # sampling strategy: scale (SCALESAMPLE) | item (BYITEM) | cell (BYCELL).
    sample_strategy: str = "scale"
    # SCALESAMPLE floor (items per source): every source keeps ≥ this many
    # sampled items when it has them. 4 is the paper's N (§VI-E).
    min_per_source: int = 4
    # RNG seed for the item sample — fixed so detection runs are replayable.
    sample_seed: int = 1
    # incremental: |ΔM̂| (log-odds units) above which an entry is treated as
    # a big change and replayed exactly (§V-A; 1.0 ≈ the paper's ρ).
    rho: float = 1.0
    # incremental: |ΔA| accuracy drift that forces a pair rescore
    # unconditionally (fraction, 0..1). 0.2 is the paper's ρ_acc.
    rho_acc: float = 0.2
    # sample_verify: initial half-width (log-odds units, sampled-score scale)
    # of the candidate net below the copying boundary z = 0. 2.0 ≈ the
    # decision band where sampling noise plausibly hides a true pair.
    verify_slack: float = 2.0
    # sample_verify: multiplicative step of the recall-slack sweep (> 1).
    verify_slack_growth: float = 1.6
    # sample_verify: stop widening when the next shell of near-miss pairs
    # holds fewer than this fraction of the current candidate set — the
    # empirical bound on pairs the net might still miss.
    verify_miss_frac: float = 0.02
    # chunks of the engine store shipped per device pass (count). 1 is
    # strict streaming; None → auto-size from chunk_group_bytes, capped at
    # K−1 so a chunked store's full incidence is never resident at once.
    chunk_group: Optional[int] = 1
    # HARD byte ceiling on the incidence slab shipped per device pass: it
    # narrows the engine chunk width when one chunk would exceed it (floored
    # at 8 entries × S_pad rows) and clamps chunk_group.
    chunk_group_bytes: int = 64 << 20
    # canonical CorpusStore chunk width (entries) for indexes this engine
    # builds; None → store default (512). Rounded up to a multiple of 8.
    store_chunk_entries: Optional[int] = None
    # byte budget for the largest single incidence allocation during index
    # build (wins over store_chunk_entries; width = bytes // rows).
    store_chunk_bytes: Optional[int] = None
    # chunk groups staged host→device AHEAD of the running kernel (count):
    # a producer thread fills and uploads group G+1's slab while group G
    # computes, double-buffered at depth 2. 0 → staging runs in the
    # consumer's thread between launches; stall telemetry (stage_wait_s /
    # compute_wait_s) lands in last_stats either way.
    prefetch_depth: int = 2
    # row-range shards of the corpus data plane (count). None/1 → unsharded.
    # Indexes this engine builds are wrapped in a ShardedCorpusStore; each
    # shard owner scans only the pair tiles whose ROW block it owns, and the
    # owners' tiles merge into decisions equal to the unsharded engine's.
    n_shards: Optional[int] = None
    # bitpack each shard's blocks of the scan store to 1 bit/entry (8× over
    # int8; unpacked on the host as each slab is assembled).
    shard_pack: bool = False
    # per-shard resident-set byte cap of the sealed stores (bytes): cold
    # blocks spill to checksummed frames under shard_spill_dir, LRU.
    # None → no cap.
    shard_spill_bytes: Optional[int] = None
    # directory under which each sealed store spills (in a fresh
    # subdirectory of its own); None → the system temp directory.
    shard_spill_dir: Optional[str] = None
    # 2-D device mesh (data, pod) for the tile scan: tiles over `data`,
    # each group's chunks over `pod`, summed over `pod` in a fixed order.
    # None → the 1-D tile mesh.
    mesh_shape: Optional[tuple] = None


@dataclass
class TileScanContext:
    """The deterministic prologue of one tiled pass: everything the scan and
    the finalize consume, computed once (host numpy)."""

    mark: int                      # engine.spans.recorded at the prologue's start
    ds: ClaimsDataset
    p_claim: np.ndarray
    base_idx: InvertedIndex
    ech: object                    # EngineChunks — p-ordered scan store
    delta: np.ndarray              # per-chunk p̂-error bound δ_k
    S: int
    T: int
    n_blocks: int
    S_pad: int
    acc_pad: np.ndarray
    chunk_keep: np.ndarray         # (K, n_blocks, n_blocks) bool
    coords: np.ndarray             # (n_tiles, 2) int32 — surviving r ≤ c tiles
    tiles_total: int
    n_tiles: int
    Gc: int                        # chunks per device pass
    chunk_nbytes: int
    mask_source: str = "fresh"     # tile masks from the cache or a fresh reduction
    sharded: bool = False          # the scan store is a ShardedCorpusStore
    resident_nbytes: int = 0       # one chunk's resident bytes (packed: 1 bit)
    items: Optional[np.ndarray] = None  # sampled modes' item subset (fan-out)


class DetectionEngine:
    """One engine per detection workload.

    ``device=None`` is the card; a missing card raises. Pass ``device="cpu"``
    to run the plain PyTorch path on the CPU. The tile scan runs over the
    engine's mesh (``mesh()`` / ``mesh2()``) of that platform's devices;
    everything else runs on ``device``. Stateless for one-shot modes;
    ``incremental`` carries the paper's §V bookkeeping across ``detect``
    calls (``reset()`` drops it).
    """

    def __init__(self, cfg: CopyConfig, mode: str = "bucketed", device=None,
                 **options):
        if mode not in MODES:
            raise ValueError(f"unknown mode {mode!r}; expected one of {MODES}")
        self.cfg = cfg
        self.mode = mode
        self.device = resolve_device(device)
        self.options = EngineOptions(**options)
        if self.options.incidence_dtype not in ("auto", "int8"):
            raise ValueError(
                f"incidence_dtype {self.options.incidence_dtype!r}: only "
                f"int8 incidence is carried ('auto' or 'int8')")
        if self.options.mesh_shape is not None:
            # a manifest carries it as a JSON list
            self.options.mesh_shape = tuple(
                int(x) for x in self.options.mesh_shape)
            if len(self.options.mesh_shape) != 2:
                raise ValueError(f"mesh_shape {self.options.mesh_shape}: "
                                 f"expected (data, pod)")
        # the tile meshes, built on first use (mesh(), mesh2())
        self._mesh: Optional[Mesh] = None
        self._mesh2: Optional[Mesh] = None
        self.last_stats: dict = {}
        self._scan_stats: dict = {}
        # the passes' spans (utils/timing.py); a service records its batches
        # on the same log, so a pass nests under its batch
        self.spans = SpanLog()
        self._inc_state = None
        # (S, S) bool on the device: the pairs the last tiled pass considered
        # (sample_verify: its candidate set)
        self._last_considered: Optional[torch.Tensor] = None
        # block-OR mask cache over the LAST persistent index this engine
        # detected against, delta-updated at commit/retract time
        self._mask_cache = None
        self._mask_cache_hits = 0
        self._mask_full_builds = 0

    # -- lifecycle ----------------------------------------------------------

    def reset(self) -> None:
        """Drop incremental bookkeeping (next detect() bootstraps afresh)."""
        self._inc_state = None

    @property
    def incremental_state(self):
        """§V bookkeeping (None until an incremental detect() has run)."""
        return self._inc_state

    def mesh(self) -> Mesh:
        """The 1-D tile mesh: the first ``devices`` of
        ``local_devices(device)``, all of them when ``devices`` is None or
        more than exist (as ``jax.devices()[:n]``). Built on first use."""
        if self._mesh is None:
            devs = local_devices(self.device)
            n = min(self.options.devices or len(devs), len(devs))
            self._mesh = make_mesh((n,), ("shards",), devs)
        return self._mesh

    def mesh2(self) -> Mesh:
        """The 2-D ``data``×``pod`` tile mesh (``mesh_shape``); raises
        ``ValueError`` when it needs more devices than exist."""
        if self._mesh2 is None:
            d, p = self.options.mesh_shape
            devs = local_devices(self.device)
            if d * p > len(devs):
                raise ValueError(
                    f"mesh_shape {d}x{p} needs {d * p} devices, "
                    f"{len(devs)} available")
            self._mesh2 = make_mesh((d, p), ("data", "pod"), devs)
        return self._mesh2

    def _tile_mesh(self) -> Mesh:
        """The mesh the tile scan runs over."""
        if self.options.mesh_shape is not None:
            return self.mesh2()
        return self.mesh()

    # -- incremental tile-prune mask cache ----------------------------------

    def apply_mask_delta(self, delta):
        """Propagate a commit/retract ``MutationDelta`` into the mask cache.

        Call right after ``commit_rows`` / ``retract_rows`` so the next
        ``detect(..., index=...)`` reuses the cached block incidence
        (updated in O(touched cells)) instead of regathering all K chunk
        reductions. Returns an opaque undo token for commits — pair it with
        ``undo_mask_delta`` around a transient commit→detect→rollback — and
        None otherwise. A no-op when no cache exists yet; a delta that
        doesn't chain (wrong ``from_mseq``, compaction) marks the cache
        stale for a fresh rebuild.
        """
        cache = self._mask_cache
        if cache is None or delta is None:
            return None
        inner = cache.apply(delta)
        return None if inner is None else (cache, inner)

    def undo_mask_delta(self, token) -> None:
        """Reverse ``apply_mask_delta`` after the index store rolled back.

        Re-adopts the cache object the token came from (a detect between
        apply and undo may have swapped ``_mask_cache``), so the restored
        incidence — bit-exact to the pre-commit state — serves the next
        pass. ``None`` tokens are no-ops.
        """
        if token is None:
            return
        cache, inner = token
        cache.undo(inner)
        self._mask_cache = cache

    def rebase_mask_cache(self, delta) -> None:
        """Re-anchor a cache adopted DURING a transient commit onto the base.

        Call (instead of ``undo_mask_delta``) when ``apply_mask_delta``
        returned no token — no cache existed before the transient commit,
        so whatever the detect pass adopted is anchored on the
        mid-transient store state. ``BlockOrCache.rebase`` shrinks it back
        onto the restored base store.
        """
        cache = self._mask_cache
        if cache is None:
            return
        if delta is None:
            self.invalidate_mask_cache()
            return
        cache.rebase(delta)
        if cache.stale:
            self._mask_cache = None

    def invalidate_mask_cache(self) -> None:
        """Drop the mask cache (the next indexed detect rebuilds it fresh)."""
        if self._mask_cache is not None:
            self._mask_cache.stale = True
        self._mask_cache = None

    # -- dispatch -----------------------------------------------------------

    def detect(
        self,
        ds: ClaimsDataset,
        p_claim: np.ndarray,
        index: InvertedIndex | None = None,
        items: np.ndarray | None = None,
    ) -> DetectionResult:
        """Run one detection pass in this engine's mode.

        Args:
          ds: the (S, D) claims dataset.
          p_claim: (S, D) float32 — truth probability of the value each
            source provides per item (equal across providers of one value;
            ignored where values[s, d] < 0).
          index: a prebuilt ``InvertedIndex`` to reuse (this package's, or
            one loaded from the JAX package's ``state_dict``; modes that
            index); None → built here.
          items: sampled/sample_verify only — an explicit item-column subset
            overriding the configured sampler.

        Returns a ``DetectionResult`` (numpy fields) over every ordered
        source pair; per-run diagnostics land in ``self.last_stats``. The
        pass is a ``detect`` span on ``self.spans``.
        """
        with self.spans.span("detect"):
            return self._detect(ds, p_claim, index, items)

    def _detect(self, ds, p_claim, index, items) -> DetectionResult:
        opt = self.options
        if self.mode == "pairwise":
            return pairwise_detect(ds, p_claim, self.cfg, device=self.device)
        if index is None and self.mode in ("exact", "bound", "bound+",
                                           "hybrid"):
            index = self._build_index(ds, p_claim)
        if self.mode == "exact":
            return index_detect_exact(ds, p_claim, self.cfg, index=index)
        if self.mode in ("bound", "bound+", "hybrid"):
            l_thr = opt.l_threshold
            if l_thr is None:
                l_thr = 16 if self.mode == "hybrid" else 0
            self.last_stats = {"device": str(self.device)}
            return bound_detect(
                ds, p_claim, self.cfg, n_buckets=opt.n_buckets,
                use_timers=self.mode in ("bound+", "hybrid"),
                l_threshold=l_thr, rescore_margin=opt.rescore_margin,
                index=index, device=self.device, stats=self.last_stats)
        if self.mode == "incremental":
            self.last_stats = {"device": str(self.device)}
            if self._inc_state is None:
                if index is None and opt.n_shards and opt.n_shards > 1:
                    index = self._build_index(ds, p_claim)
                result, self._inc_state = make_incremental_state(
                    ds, p_claim, self.cfg, n_buckets=opt.n_buckets,
                    chunk_entries=opt.store_chunk_entries,
                    chunk_bytes=opt.store_chunk_bytes, index=index,
                    device=self.device, stats=self.last_stats)
                return result
            return incremental_detect(ds, p_claim, self.cfg, self._inc_state,
                                      rho=opt.rho, rho_acc=opt.rho_acc,
                                      stats=self.last_stats)
        if self.mode == "sampled":
            if items is None:
                items = self._sample_items(ds)
            sub = ds.subset_items(items)
            return self._detect_tiled(sub, p_claim[:, items])
        if self.mode == "sample_verify":
            return self._detect_sample_verify(ds, p_claim, items=items)
        return self._detect_tiled(ds, p_claim, index=index)

    def _sample_items(self, ds: ClaimsDataset) -> np.ndarray:
        opt = self.options
        if opt.sample_strategy == "item":
            return sample_by_item(ds, opt.sample_rate, seed=opt.sample_seed)
        if opt.sample_strategy == "cell":
            return sample_by_cell(ds, opt.sample_rate, seed=opt.sample_seed)
        return scale_sample(ds, opt.sample_rate,
                            min_per_source=opt.min_per_source,
                            seed=opt.sample_seed)

    # -- sample-then-verify (§VI sampling + exact candidate rescore) --------

    def _detect_sample_verify(
        self,
        ds: ClaimsDataset,
        p_claim: np.ndarray,
        items: np.ndarray | None = None,
    ) -> DetectionResult:
        """SCALESAMPLE for candidate-pair discovery, exact rescore to decide.

        The sampled tiled pass is only a *net*: every pair whose sampled
        decision margin lands within the recall slack of the copying
        boundary becomes a candidate, the slack widening until the shell of
        near-miss pairs thins below ``verify_miss_frac``. Candidates are
        then rescored exactly on the FULL dataset, so the final decision of
        every candidate pair equals ``index_detect_exact`` — sampling error
        survives only as recall loss of the net, never as a wrong decision
        on a discovered pair.
        """
        t0 = time.perf_counter()
        if items is None:
            items = self._sample_items(ds)
        sub = ds.subset_items(items)
        sampled = self._detect_tiled(sub, p_claim[:, items])
        return self._sample_verify_finalize(
            ds, p_claim, items, sampled, self.last_stats,
            self._last_considered, t0)

    def _sample_verify_finalize(self, ds, p_claim, items, sampled,
                                sampled_stats, considered_s, t0):
        """Steps 2+3 of sample_verify, in torch on the engine's device: the
        recall-slack sweep and the exact candidate rescore.
        ``considered_s`` is the sampled pass's (S, S) considered set."""
        cfg, opt, dev = self.cfg, self.options, self.device
        S = ds.n_sources
        t_sweep = time.perf_counter()

        # -- 2. recall-slack sweep: widen the candidate net -----------------
        # z < 0 ⇔ independent; sampling noise can push a true copying pair
        # below 0, so candidates are all pairs with z ≥ -slack. The sweep
        # widens slack geometrically until the next shell (-g·slack, -slack]
        # is nearly empty relative to the net. z in float64, as the JAX
        # package's numpy computes it.
        c_s = torch.as_tensor(sampled.c_fwd, device=dev)
        z = (torch.logaddexp(c_s, c_s.T).double()
             + np.log(cfg.alpha / cfg.beta))
        del c_s
        tri = torch.triu(torch.as_tensor(considered_s, device=dev), 1)
        slack = float(opt.verify_slack)
        growth = max(float(opt.verify_slack_growth), 1.0 + 1e-6)
        z_floor = float(z[tri].min().item()) if bool(tri.any()) else 0.0
        sweep_rounds = 1
        while True:
            cand = tri & (z >= -slack)
            shell = tri & (z >= -slack * growth) & (z < -slack)
            n_cand = int(cand.sum().item())
            n_shell = int(shell.sum().item())
            del shell
            if (n_shell <= opt.verify_miss_frac * max(n_cand, 1)
                    or -slack <= z_floor):
                break
            slack *= growth
            sweep_rounds += 1
        del z, tri

        # -- 3. exact rescore of only the candidate pairs -------------------
        t_res = time.perf_counter()
        pi, pj = torch.nonzero(cand, as_tuple=True)
        del cand
        c_fwd = torch.zeros((S, S), dtype=torch.float32, device=dev)
        vals, p, acc = dataset_tensors(ds, p_claim, dev)
        rescore_pairs_exact(vals, p, acc, cfg, pi, pj, c_fwd)
        values_exact = _shared_items(vals >= 0, pi, pj)
        del vals, p, acc
        considered = torch.zeros((S, S), dtype=torch.bool, device=dev)
        considered[pi, pj] = True
        considered[pj, pi] = True

        copying = decide_copying(c_fwd, c_fwd.T, cfg) & considered
        pr_ind = torch.where(considered,
                             posterior_independence(c_fwd, c_fwd.T, cfg), 1.0)
        pr_ind.fill_diagonal_(1.0)
        copying.fill_diagonal_(False)
        self._last_considered = considered     # == the candidate set

        counter = ComputeCounter(
            pairs_considered=n_cand,
            shared_values_examined=(
                sampled.counter.shared_values_examined + values_exact),
            score_computations=(
                sampled.counter.score_computations + 2 * values_exact),
            index_entries=sampled.counter.index_entries,
        )
        self.last_stats = {
            "items_sampled": int(len(items)),
            "item_rate": round(len(items) / max(ds.n_items, 1), 4),
            "slack_final": round(slack, 3),
            "sweep_rounds": sweep_rounds,
            "candidate_pairs": n_cand,
            "shell_pairs": n_shell,
            "sampled_copying_pairs": len(sampled.copying_pairs()),
            "sampled_stats": sampled_stats,
            "sweep_s": t_res - t_sweep,
            "rescore_s": time.perf_counter() - t_res,
        }
        return DetectionResult(c_fwd=c_fwd.cpu().numpy(),
                               pr_independent=pr_ind.cpu().numpy(),
                               copying=copying.cpu().numpy(), counter=counter,
                               wall_time_s=time.perf_counter() - t0)

    # -- the tiled production path -------------------------------------------

    def _build_index(self, ds: ClaimsDataset, p_claim: np.ndarray,
                     streaming: bool = False) -> InvertedIndex:
        """Build an index honoring this engine's store-chunking options.

        With ``n_shards`` > 1 the store is wrapped in a ``ShardedCorpusStore``
        under a balanced row-range plan. ``streaming=True`` (the one-shot
        tiled path) streams the seal through the wrap when pack/spill
        options are set: blocks bitpack and spill under the cap as they are
        sliced, and the source chunks are released behind the slicing. The
        other modes keep the dense wrap (a sealed store refuses commits).
        """
        opt = self.options
        with self.spans.span("index_build"):
            idx = build_index(ds, p_claim, self.cfg,
                              chunk_entries=opt.store_chunk_entries,
                              chunk_bytes=opt.store_chunk_bytes,
                              device=self.device, spans=self.spans)
            if opt.n_shards and opt.n_shards > 1:
                plan = make_shard_plan(idx.store.n_rows, opt.n_shards)
                if streaming and self._shard_seal():
                    idx.store = shard_store(idx.store, plan, consume=True,
                                            **self._shard_seal())
                else:
                    idx.store = shard_store(idx.store, plan)
        return idx

    def _shard_seal(self) -> Optional[dict]:
        """The seal options of sharded scan stores, or None (no seal)."""
        opt = self.options
        if not (opt.shard_pack or opt.shard_spill_bytes is not None):
            return None
        return dict(pack=opt.shard_pack, spill_dir=opt.shard_spill_dir,
                    resident_bytes=opt.shard_spill_bytes)

    def _tile_edge(self, s_sources: int) -> int:
        """Tile edge: the smallest multiple of 8 that is ≥ min(S, requested
        tile) — tiny datasets pad by at most 7 sources."""
        t = min(self.options.tile, max(1, s_sources))
        return max(8, -(-t // 8) * 8)

    def _detect_tiled(
        self,
        ds: ClaimsDataset,
        p_claim: np.ndarray,
        index: InvertedIndex | None = None,
    ) -> DetectionResult:
        ctx = self._tiled_prologue(ds, p_claim, index)
        grids, chunk_tiles_run = self._run_tiled_scan(ctx)
        return self._tiled_finalize(ctx, grids, chunk_tiles_run)

    def _tiled_prologue(
        self,
        ds: ClaimsDataset,
        p_claim: np.ndarray,
        index: InvertedIndex | None = None,
    ) -> TileScanContext:
        """Steps 1–2 of the tiled pass: index, chunking, pruning, sizing.

        Spans: ``index_build`` (when no ``index`` is given), then
        ``prologue`` with ``prologue.rechunk``."""
        mark = self.spans.recorded
        base_idx = index
        if base_idx is None:
            base_idx = self._build_index(ds, p_claim, streaming=True)
        with self.spans.span("prologue"):
            return self._prologue(ds, p_claim, index, base_idx, mark)

    def _prologue(self, ds: ClaimsDataset, p_claim: np.ndarray,
                  index: InvertedIndex | None, base_idx: InvertedIndex,
                  mark: int) -> TileScanContext:
        """Step 2 of the tiled pass on the index ``base_idx``: chunking,
        pruning, sizing (``index`` is the caller's, None when built)."""
        opt = self.options
        S = ds.n_sources
        T = self._tile_edge(S)
        n_blocks = -(-S // T)
        S_pad = n_blocks * T
        itemsize = 1                                # int8 incidence
        # p-ordered, region-padded, uniform-width chunk store; rows carry the
        # tile-grid padding so chunks slice straight into pair tiles. The
        # byte budget caps the chunk width so even ONE shipped chunk
        # respects it (floored at 8 entries inside engine_chunks). A sharded
        # index gathers a sharded scan store, sealed (packed / capped) as it
        # is gathered when the seal options are set.
        sharded = isinstance(base_idx.store, ShardedCorpusStore)
        with self.spans.span("prologue.rechunk"):
            ech = engine_chunks(
                base_idx, opt.n_buckets, row_capacity=S_pad,
                max_width=opt.chunk_group_bytes // max(S_pad * itemsize, 1),
                seal=self._shard_seal() if sharded else None)
        K = ech.n_chunks
        b = ech.width
        # per-chunk bound δ_k on |f(p) − f(p̂_k)| for any entry p in chunk k
        delta = bucket_score_deltas(ech.p_hat, ech.p_lo, ech.p_hi, ds.accuracy,
                                    self.cfg)

        # ---- tile ∘ chunk pruning on the OR-reduced incidence -------------
        # chunk_keep[k][r, c] ⇔ some row-block-r source shares some entry of
        # chunk k with some col-block-c source. A tile survives if any NON-Ē
        # chunk keeps it; a surviving tile skips every chunk group whose
        # chunk_keep bits are all off. The keep matrix is symmetric, so only
        # unordered (r ≤ c) tiles are scheduled. 0/1 products sum exactly in
        # float32 (widths ≪ 2²⁴).
        keep = np.zeros((n_blocks, n_blocks), bool)
        chunk_keep = np.zeros((K, n_blocks, n_blocks), bool)
        base_store = base_idx.store
        cache = self._mask_cache if index is not None else None
        mask_source = "fresh"
        if (cache is not None and cache.matches(base_store, T)
                and cache.block_inc.shape == (n_blocks,
                                              base_store.n_entries)):
            # cache hit: each GATHERED chunk's mask permutes cached base
            # columns through the gather order — bit-equal to a fresh
            # reduction of the gathered chunk, with no chunk regathered
            mask_source = "cache"
            self._mask_cache_hits += 1
            masks = (cache.chunk_mask(ech.order[k * b:(k + 1) * b])
                     for k in range(K))
        else:
            masks = (tilecache.chunk_block_inc(ech.store, k, T, n_blocks)
                     for k in range(K))
        # detecting against a persistent index, a fresh reduction is adopted
        # as the new cache at no extra reduction: each gathered chunk's
        # columns scatter back to base entry order
        base_inc = None
        if mask_source == "fresh" and index is not None:
            base_inc = np.zeros((n_blocks, base_store.n_entries), bool)
        for k, g_bool in enumerate(masks):
            if base_inc is not None:
                sel = ech.order[k * b: k * b + g_bool.shape[1]]
                live = sel >= 0
                base_inc[:, sel[live]] = g_bool[:, live]
            g_k = g_bool.astype(np.float32)
            chunk_keep[k] = (g_k @ g_k.T) > 0
            if k < ech.ebar_chunk:
                keep |= chunk_keep[k]
        if base_inc is not None:
            self._mask_cache = tilecache.BlockOrCache(
                base_store, T, getattr(base_store, "mseq", -1), base_inc)
            self._mask_full_builds += 1
        coords = np.ascontiguousarray(np.argwhere(np.triu(keep)),
                                      dtype=np.int32)        # r ≤ c tiles
        tiles_total = n_blocks * (n_blocks + 1) // 2

        acc_pad = np.pad(ds.accuracy.astype(np.float32), (0, S_pad - S),
                         constant_values=0.5)
        chunk_nbytes = S_pad * b * itemsize
        # the byte budget clamps every group against RESIDENT bytes: a
        # bitpacked shard plane holds 1 bit an entry, so it streams 8× larger
        # groups under the same budget (each shipped slab is still unpacked;
        # peak_group_bytes reports that)
        resident_nbytes = chunk_nbytes
        if sharded and opt.shard_pack and ech.store.sealed:
            resident_nbytes = S_pad * (-(-b // 8))
        budget_chunks = max(1, opt.chunk_group_bytes // max(resident_nbytes, 1))
        if opt.chunk_group is not None:
            Gc = min(max(1, int(opt.chunk_group)), budget_chunks)
        else:
            Gc = min(budget_chunks, max(1, K - 1))
        return TileScanContext(
            mark=mark, ds=ds, p_claim=p_claim, base_idx=base_idx, ech=ech,
            delta=delta, S=S, T=T, n_blocks=n_blocks, S_pad=S_pad,
            acc_pad=acc_pad, chunk_keep=chunk_keep, coords=coords,
            tiles_total=tiles_total, n_tiles=len(coords), Gc=Gc,
            chunk_nbytes=chunk_nbytes, mask_source=mask_source,
            sharded=sharded, resident_nbytes=resident_nbytes)

    def _scan_groups(self, ctx: TileScanContext, tiles=None) -> list:
        """The chunk groups the scan runs over ``tiles`` (default every
        surviving tile): (chunk ids, live-tile mask) for every group in
        which some of those tiles is kept by some chunk."""
        tiles = ctx.coords if tiles is None else tiles
        K = ctx.ech.n_chunks
        tile_keep = ctx.chunk_keep[:, tiles[:, 0], tiles[:, 1]]
        groups = []
        for g0 in range(0, K, ctx.Gc):
            ks = list(range(g0, min(g0 + ctx.Gc, K)))
            gmask = tile_keep[ks].any(axis=0)
            if gmask.any():
                groups.append((ks, gmask))
        return groups

    def _fill_group(self, ctx: TileScanContext, ks, gmask, slab: torch.Tensor,
                    meta: torch.Tensor, coords: torch.Tensor,
                    tiles=None, runs=None) -> None:
        """Write one group's kernel operands into host tensors: the
        (pods, rows, Kp, w) int8 slab — chunk i of the group in slice
        i // Kp, column i % Kp, the mesh's ``pod`` slices (one for a 1-D
        mesh) —, the (pods, 3, Kp) per-chunk p̂ / δ / non-Ē rows (inert
        0.5 / 0 / 0 for the slots past the group's chunks: a short group,
        the ``pod`` padding) and the tile list (``tiles``, default every
        surviving tile) with chunk-pruned tiles marked (-1, -1), followed
        by (-1, -1) slots up to ``coords``' length (the mesh padding).
        ``runs`` lists the slab's row ranges as (slab row, global row from,
        global row to) — a shard owner's compact slab; None is the full
        S_pad rows. A plain ``CorpusStore`` chunk is copied as it is; a
        sharded one is assembled through the facade straight into the
        slab."""
        ech = ctx.ech
        store = ech.store
        tiles = ctx.coords if tiles is None else tiles
        kp = slab.shape[2]
        for i, k in enumerate(ks):
            q, j = divmod(i, kp)
            if runs is None and isinstance(store, CorpusStore):
                slab[q, :, j, :].copy_(torch.from_numpy(store.chunks[k]))
                continue
            dst = slab.numpy()[q, :, j, :]
            for o, r0, r1 in runs or ((0, 0, ctx.S_pad),):
                store.assemble_rows(k, r0, r1, out=dst[o: o + r1 - r0])
        m = meta.numpy()
        m[:, 0] = 0.5
        m[:, 1:] = 0.0
        for i in range(len(ks), slab.shape[0] * kp):
            q, j = divmod(i, kp)
            slab[q, :, j, :] = 0                # inert chunks
        for i, k in enumerate(ks):
            q, j = divmod(i, kp)
            m[q, :, j] = (ech.p_hat[k], ctx.delta[k], ech.nout[k])
        n = len(tiles)
        coords[:n] = torch.from_numpy(
            np.where(gmask[:, None], tiles, -1).astype(np.int32))
        coords[n:] = -1

    def _stage_group(self, ctx: TileScanContext, ks, gmask):
        """One group's kernel operands on the device, staged synchronously:
        (slab, p̂, δ, non-Ē, tile list) — the one-entry scan's operands, for
        checks outside the scan."""
        slab = torch.empty((1, ctx.S_pad, ctx.Gc, ctx.ech.width),
                           dtype=torch.int8)
        meta = torch.empty((1, 3, ctx.Gc), dtype=torch.float32)
        coords = torch.empty((ctx.n_tiles, 2), dtype=torch.int32)
        self._fill_group(ctx, ks, gmask, slab, meta, coords)
        dev = self.device
        return (slab[0].to(dev), meta[0, 0].to(dev), meta[0, 1].to(dev),
                meta[0, 2].to(dev), coords.to(dev))

    def _stream_groups(self, ctx: TileScanContext, groups, tiles,
                       acc: np.ndarray, rows: int, runs=None):
        """Stream ``groups`` through the kernel over the tile list ``tiles``
        of a slab of ``rows`` rows (``runs`` as in ``_fill_group``) with
        accuracies ``acc``, on the engine's tile mesh: the groups are
        staged into a ``SlabRing`` of ``prefetch_depth + 1`` slots by the
        ``ChunkPrefetcher``'s producer, ``prefetch_depth`` groups ahead of
        the kernels, and every mesh entry launches B1 on its share of each
        group (``MeshTileScan``). Returns the five ``(len(tiles), T, T)``
        stacks on the engine's device, B1's device ms (CUDA events, summed
        over the cards) and the staging telemetry.

        XLA's donation of a staged slab to the kernel (the JAX engine's
        ``_donate_ok``) has no counterpart: the ring's slots are reused in
        place, so no slab is allocated per group to donate."""
        dev = self.device
        T, n = ctx.T, len(tiles)
        depth = max(int(self.options.prefetch_depth), 0)
        scan = MeshTileScan(self._tile_mesh(), n, T, acc)
        kp = -(-ctx.Gc // scan.n_pod)
        ring = SlabRing(min(depth + 1, len(groups)),
                        (scan.n_pod, rows, kp, ctx.ech.width),
                        scan.n_padded, scan.places())
        cards = [d for d in scan.mesh.distinct() if d.type == "cuda"]

        def stage(desc):
            g, ks, gmask = desc
            slot = g % ring.n
            ring.acquire(slot)
            self._fill_group(ctx, ks, gmask, ring.host[slot],
                             ring.host_meta[slot], ring.host_coords[slot],
                             tiles=tiles, runs=runs)
            ring.upload(slot)
            return slot

        timed = []
        pf = ChunkPrefetcher([(g, ks, gm) for g, (ks, gm) in enumerate(groups)],
                             stage, depth=depth)
        try:
            for slot in pf:
                slabs, metas, coords_g = ring.use(slot)
                evs = [(d, torch.cuda.Event(enable_timing=True),
                        torch.cuda.Event(enable_timing=True)) for d in cards]
                for d, a, _ in evs:
                    a.record(torch.cuda.current_stream(d))
                scan.run_group(slabs, metas, coords_g, self.cfg,
                               kernel=group_tile_scores)
                for d, _, z in evs:
                    z.record(torch.cuda.current_stream(d))
                timed += evs
                ring.release(slot)
        finally:
            ring.close()
            pf.close()
            # a producer blocked on a slot still in use waited for the
            # kernel, not on staging
            pipe = {"staging_s": pf.staging_s - ring.slot_wait_s,
                    "stage_wait_s": pf.stage_wait_s,
                    "compute_wait_s": pf.compute_wait_s + ring.slot_wait_s}
        kernel_ms = 0.0
        for d in cards:
            torch.cuda.synchronize(d)
        if timed:
            kernel_ms = sum(a.elapsed_time(z) for _, a, z in timed)
        stacks = [st[:n].to(dev) for st in scan.gather()]
        return stacks, kernel_ms, pipe

    def _run_tiled_scan(self, ctx: TileScanContext):
        """Step 3: the tile∘chunk scan — the four (S_pad, S_pad) device
        grids (C_same→, count, non-Ē count, error bound) + run count.

        Unsharded, every group runs over the whole surviving tile list and
        the stacks scatter once. Sharded, each owner scans its own tiles
        over a compact slab (``_scan_owner``); only when every owner has
        returned are their stacks scattered into the grids
        (``merge_owner_partials``), so a failing owner leaves nothing
        merged.
        """
        dev = self.device
        with self.spans.span("scan") as sp:
            S_pad, n_tiles, K = ctx.S_pad, ctx.n_tiles, ctx.ech.n_chunks
            launches0 = tile_scores.launches
            chunk_tiles_run = 0
            if ctx.sharded and n_tiles and K:
                partials = [self._scan_owner(ctx, s)
                            for s in range(ctx.ech.store.n_shards)]
                grids, merge_s = self._merge_owners(ctx, partials)
                extra = self._owner_stats(partials)
                extra["merge_s"] = merge_s
                chunk_tiles_run = sum(p.chunk_tiles_run for p in partials)
                del partials
            else:
                grids = [torch.zeros((S_pad, S_pad), dtype=torch.float32,
                                     device=dev) for _ in range(4)]
                groups = self._scan_groups(ctx) if n_tiles and K else []
                extra = {"groups_run": len(groups), "scan_kernel_ms": 0.0,
                         "staging_s": 0.0, "stage_wait_s": 0.0,
                         "compute_wait_s": 0.0}
                if groups:
                    # a tile shipped with a group scans ALL the group's
                    # chunks, so count what really runs
                    chunk_tiles_run = sum(int(gm.sum()) * len(ks)
                                          for ks, gm in groups)
                    stacks, kernel_ms, pipe = self._stream_groups(
                        ctx, groups, ctx.coords, ctx.acc_pad, S_pad)
                    extra.update(pipe, scan_kernel_ms=kernel_ms)
                    scatter_tile_stacks(grids,
                                        torch.from_numpy(ctx.coords).to(dev),
                                        stacks, ctx.n_blocks, ctx.T)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
        self._scan_stats = {**extra,
                            "kernel_launches": tile_scores.launches - launches0,
                            "scan_s": sp.seconds}
        return grids, chunk_tiles_run

    def _merge_owners(self, ctx: TileScanContext, partials: list):
        """The owners' partials merged into the four grids under a
        ``scan.merge`` span, which ends with the merge's device work;
        returns the grids and the span's seconds."""
        dev = self.device
        with self.spans.span("scan.merge") as merge:
            grids = merge_owner_partials(list(partials), ctx.n_blocks, ctx.T,
                                         device=dev)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
        return grids, merge.seconds

    @staticmethod
    def _owner_stats(partials) -> dict:
        """The owners' scan telemetry, summed (groups, staging, B1 device
        ms), with each owner's scan seconds."""
        out = {k: sum(p.stats.get(k, 0) for p in partials)
               for k in ("groups_run", "staging_s", "stage_wait_s",
                         "compute_wait_s", "scan_kernel_ms")}
        out["owner_scan_s"] = [p.stats.get("scan_s", 0.0) for p in partials]
        return out

    def _block_owners(self, ctx: TileScanContext) -> np.ndarray:
        """(n_blocks,) — the shard owning each tile-row block (the shard of
        the block's first row; past the last row, the last row's)."""
        plan = ctx.ech.store.plan
        last_row = max(plan.n_rows - 1, 0)
        return np.array([plan.owner_of_row(min(r * ctx.T, last_row))
                         for r in range(ctx.n_blocks)], np.int64)

    def _scan_owner(self, ctx: TileScanContext, owner: int) -> OwnerPartial:
        """One owner's share of the scan: its surviving tiles' stacks on the
        device, or one ``ShardScanError`` carrying the owner id, the root
        fault chained (a staging failure arrives wrapped in
        ``PipelineStageError``; callers triage on what it wraps)."""
        owner = int(owner)
        mine = self._block_owners(ctx)[ctx.coords[:, 0]] == owner
        tiles = ctx.coords[mine]
        part = OwnerPartial(owner=owner, n_blocks=ctx.n_blocks, tile=ctx.T,
                            coords=tiles, stacks=None)
        if not (len(tiles) and ctx.ech.n_chunks):
            return part
        t0 = time.perf_counter()
        try:
            part.stacks, part.chunk_tiles_run, part.stats = (
                self._scan_one_shard(ctx, tiles))
        except Exception as e:
            root = (e.__cause__ if isinstance(e, PipelineStageError)
                    and e.__cause__ else e)
            raise ShardScanError(
                owner, f"owner tile scan failed: {type(e).__name__}: {e}"
            ) from root
        part.stats["scan_s"] = time.perf_counter() - t0
        return part

    def _scan_one_shard(self, ctx: TileScanContext, tiles: np.ndarray):
        """Stream chunk groups for ONE owner's tiles over a compact slab:
        only the row blocks its tiles touch (row and column sides), in
        contiguous runs assembled through the facade. Returns ``(stacks,
        chunk_tiles_run, stats)`` — the five ``(len(tiles), T, T)`` device
        stacks (None when every group was pruned)."""
        T = ctx.T
        needed = np.unique(tiles)
        pos = np.full(ctx.n_blocks, -1, np.int64)
        pos[needed] = np.arange(len(needed))
        local = pos[tiles].astype(np.int32)
        acc = ctx.acc_pad.reshape(ctx.n_blocks, T)[needed].reshape(-1)
        runs = [(int(pos[seg[0]]) * T, int(seg[0]) * T, int(seg[-1] + 1) * T)
                for seg in np.split(needed,
                                    np.flatnonzero(np.diff(needed) != 1) + 1)]
        groups = self._scan_groups(ctx, tiles)
        run = sum(int(gm.sum()) * len(ks) for ks, gm in groups)
        if not groups:
            return None, 0, {"groups_run": 0}
        stacks, kernel_ms, pipe = self._stream_groups(
            ctx, groups, local, acc, len(needed) * T, runs)
        return stacks, run, {"groups_run": len(groups),
                             "scan_kernel_ms": kernel_ms,
                             "slab_rows": len(needed) * T, **pipe}

    def _tiled_finalize(self, ctx: TileScanContext, grids,
                        chunk_tiles_run: int) -> DetectionResult:
        """Step 4 on the device: INDEX step 3 + error-bounded exact rescore
        + decide. ``grids`` may be device tensors or host arrays."""
        cfg, opt, dev = self.cfg, self.options, self.device
        ds, S, ech = ctx.ds, ctx.S, ctx.ech
        with self.spans.span("finalize") as fin:
            g = [torch.as_tensor(x, dtype=torch.float32, device=dev) for x in grids]
            c_same = g[0][:S, :S]
            n_cnt = g[1][:S, :S]
            err = g[3][:S, :S]
            considered = g[2][:S, :S] > 0.5
            considered.fill_diagonal_(False)

            # ---- INDEX step 3 (float64, as the host reference computes it) ----
            l_counts = torch.as_tensor(ctx.base_idx.l_counts, device=dev)
            adj = c_same.double() + (l_counts.double() - n_cnt.double()) * cfg.ln_1ms
            c_fwd = torch.where(considered, adj, 0.0).to(torch.float32)
            del adj
            c_fwd.fill_diagonal_(0.0)

            # a pair's decision can only differ from the exact INDEX if the
            # accumulated p̂ error reaches its decision margin — rescore exactly
            # every such pair (err bounds |Δ C→|; |Δz| ≤ max of both directions)
            t_res = time.perf_counter_ns()
            z = np.log(cfg.alpha / cfg.beta) + torch.logaddexp(c_fwd, c_fwd.T)
            near = considered & (z.abs() < opt.rescore_margin
                                 + torch.maximum(err, err.T))
            del z
            pi, pj = torch.nonzero(torch.triu(near, 1), as_tuple=True)
            del near
            rescore_launches0 = pair_scores.launches
            n_rescored = rescore_pairs_exact(
                *dataset_tensors(ds, ctx.p_claim, dev), cfg, pi, pj, c_fwd)
            rescore_launches = pair_scores.launches - rescore_launches0
            rescored = None
            if dev.type == "cuda":
                rescored = torch.cuda.Event()
                rescored.record(torch.cuda.current_stream(dev))
            t_res_end = time.perf_counter_ns()

            pr_ind = posterior_independence(c_fwd, c_fwd.T, cfg)
            copying = decide_copying(c_fwd, c_fwd.T, cfg) & considered
            pr_ind = torch.where(considered, pr_ind, 1.0)
            pr_ind.fill_diagonal_(1.0)
            copying.fill_diagonal_(False)
            self._last_considered = considered
            if rescored is not None:
                # the rescore's span ends with its device work, waited for
                # where the host waits anyway: the first read back below
                rescored.synchronize()
                t_res_end = time.perf_counter_ns()
            rescore = self.spans.add("finalize.rescore", t_res, t_res_end,
                                     parent=fin)

            # semantic (paper-metric) accounting, identical to the exact INDEX
            upper = torch.triu(considered, 1)
            values_examined = int(n_cnt[upper].double().sum().item())
            n_pairs = int(upper.sum().item())
            counter = ComputeCounter(
                pairs_considered=n_pairs,
                shared_values_examined=values_examined,
                score_computations=2 * values_examined + 2 * n_pairs + 2 * n_rescored,
                index_entries=ech.n_live,
            )
            c_fwd, pr_ind, copying = (c_fwd.cpu().numpy(), pr_ind.cpu().numpy(),
                                      copying.cpu().numpy())
        recs = self.spans.since(ctx.mark)
        result = DetectionResult(
            c_fwd=c_fwd, pr_independent=pr_ind, copying=copying,
            counter=counter,
            # from the pass's first span: the build's, or the prologue's
            wall_time_s=(fin.t1_ns - min(r.t0_ns for r in recs)) * 1e-9)
        scan = self._scan_stats
        self.last_stats = {
            "device": str(dev),
            "tile": ctx.T,
            "tiles_total": ctx.tiles_total,        # unordered (r ≤ c) tiles
            "tiles_kept": ctx.n_tiles,
            "tiles_pruned": ctx.tiles_total - ctx.n_tiles,
            "schedule": "triangular",
            "incidence_dtype": "int8",
            "n_devices": (int(np.prod(opt.mesh_shape)) if opt.mesh_shape
                          else self.mesh().shape["shards"]),
            "rescored_pairs": n_rescored,
            "rescore_launches": rescore_launches,     # pair_scores kernels
            "chunks": ech.n_chunks,
            "chunk_width": ech.width,
            "chunk_group": ctx.Gc,
            "chunk_tiles_total": ech.n_chunks * ctx.n_tiles,
            "chunk_tiles_run": chunk_tiles_run,
            "peak_group_bytes": int(ctx.Gc * ctx.chunk_nbytes),
            "groups_run": scan.get("groups_run", 0),
            "kernel_launches": scan.get("kernel_launches", 0),
            # async staging pipeline
            "prefetch_depth": int(opt.prefetch_depth),
            "staging_s": scan.get("staging_s", 0.0),
            "stage_wait_s": scan.get("stage_wait_s", 0.0),
            "compute_wait_s": scan.get("compute_wait_s", 0.0),
            # incremental tile-prune mask cache
            "mask_source": ctx.mask_source,
            "mask_cache_hits": self._mask_cache_hits,
            "mask_full_builds": self._mask_full_builds,
            "mask_blocks_updated": (self._mask_cache.blocks_updated
                                    if self._mask_cache is not None else 0),
            # host seconds, from the pass's spans
            "index_build_s": span_total(recs, "index_build"),
            "index_build_sort_s": span_total(recs, "index_build.sort"),
            "prologue_s": span_total(recs, "prologue"),
            "rechunk_s": span_total(recs, "prologue.rechunk"),
            "scan_s": scan.get("scan_s", 0.0),
            "scan_kernel_ms": scan.get("scan_kernel_ms", 0.0),
            "rescore_s": rescore.seconds,
            "finalize_s": fin.seconds,
        }
        if ctx.sharded:
            # shard-plane telemetry: what each shard held, its spill
            # traffic, and the owners' scans and merge
            st = ech.store
            self.last_stats.update({
                "n_shards": st.n_shards,
                "shard_plan": st.plan.sizes().tolist(),
                "shard_resident_bytes": st.shard_resident_bytes(),
                "shard_peak_resident_bytes": st.shard_peak_bytes(),
                "resident_chunk_bytes": int(ctx.resident_nbytes),
                "spill": st.spill_stats(),
                "owner_scan_s": scan.get("owner_scan_s", []),
                "merge_s": scan.get("merge_s", 0.0),
                "mesh_shape": (list(opt.mesh_shape) if opt.mesh_shape
                               else None),
            })
        return result

    # -- shard-owner fan-out --------------------------------------------------

    #: engine modes fanned out as per-owner partial tile scans; the other
    #: modes read through the shard facade in one engine instead
    OWNER_FANOUT_MODES = ("bucketed", "sampled", "sample_verify")

    def owner_scan_context(self, ds: ClaimsDataset, p_claim: np.ndarray,
                           index: InvertedIndex | None = None
                           ) -> TileScanContext:
        """The fan-out's shared prologue, computed once for all owners.

        Deterministic given (ds, p_claim, index, options): index build,
        engine chunking, bucket deltas and tile∘chunk pruning never rerun
        per owner. Sampled modes resolve their item subset here (``items``
        rides on the context for ``sample_verify``'s finalize). Requires a
        fan-out mode and a row-range-sharded store (``n_shards`` > 1, or a
        sharded ``index``).
        """
        if self.mode not in self.OWNER_FANOUT_MODES:
            raise ValueError(
                f"owner fan-out supports modes {self.OWNER_FANOUT_MODES}, "
                f"engine mode is {self.mode!r}")
        items = None
        if self.mode in ("sampled", "sample_verify"):
            items = self._sample_items(ds)
            ctx = self._tiled_prologue(ds.subset_items(items),
                                       p_claim[:, items])
        else:
            ctx = self._tiled_prologue(ds, p_claim, index)
        ctx.items = items
        if not ctx.sharded:
            raise ValueError(
                "owner fan-out requires a row-range-sharded engine store "
                "(build the index with n_shards > 1)")
        return ctx

    def detect_owner_partial(self, ds: ClaimsDataset, p_claim: np.ndarray,
                             owner: int, index: InvertedIndex | None = None,
                             ctx: TileScanContext | None = None
                             ) -> OwnerPartial:
        """ONE owner's share of the tiled pass: the surviving tiles whose
        row block falls in ``owner``'s row range, scanned over the row
        blocks they touch, as an ``OwnerPartial`` of device tile stacks.
        Kernel operands equal the single-pass scan's, so per-tile outputs
        are bit-equal. A failure is one ``ShardScanError`` carrying the
        owner id."""
        if ctx is None:
            ctx = self.owner_scan_context(ds, p_claim, index=index)
        n = ctx.ech.store.n_shards
        if not 0 <= int(owner) < n:
            raise ValueError(f"owner {owner} out of range for {n} owners")
        launches0 = tile_scores.launches
        part = self._scan_owner(ctx, owner)
        part.stats["kernel_launches"] = tile_scores.launches - launches0
        return part

    def finalize_owner_partials(self, ds: ClaimsDataset, p_claim: np.ndarray,
                                ctx: TileScanContext, partials: list
                                ) -> DetectionResult:
        """Merge the owners' partials and finish the pass.

        Refuses unless every owner contributed exactly one partial — after
        an owner failure nothing merges. The owners' tiles scatter once
        (``merge_owner_partials``), then the standard finalize (INDEX step
        3, error-bounded exact rescore, decide) runs on the merged grids;
        for ``sample_verify`` the sampled result then feeds the recall-slack
        sweep and the exact candidate rescore over the full dataset.
        """
        n = ctx.ech.store.n_shards
        got = sorted(int(p.owner) for p in partials)
        if got != list(range(n)):
            raise ValueError(
                f"finalize_owner_partials: partials cover owners {got}, "
                f"need each of 0..{n - 1} exactly once")
        grids, merge_s = self._merge_owners(ctx, partials)
        self._scan_stats = {
            **self._owner_stats(partials),
            "kernel_launches": sum(p.stats.get("kernel_launches", 0)
                                   for p in partials),
            "scan_s": sum(p.stats.get("scan_s", 0.0) for p in partials),
            "merge_s": merge_s}
        run = sum(int(p.chunk_tiles_run) for p in partials)
        result = self._tiled_finalize(ctx, grids, run)
        if self.mode == "sample_verify":
            t0 = min(r.t0_ns for r in self.spans.since(ctx.mark)) * 1e-9
            return self._sample_verify_finalize(
                ds, p_claim, ctx.items, result, self.last_stats,
                self._last_considered, t0)
        return result


def _shared_items(prov: torch.Tensor, pi: torch.Tensor,
                  pj: torch.Tensor) -> int:
    """Σ over the pairs (pi, pj) of the items both sources provide, from the
    (S, D) bool provision matrix, in batches of at most
    ``PAIR_BATCH_ELEMENTS`` pair-items."""
    D = prov.shape[1]
    step = max(1, PAIR_BATCH_ELEMENTS // max(D, 1))
    total = 0
    for b0 in range(0, len(pi), step):
        both = prov[pi[b0: b0 + step]] & prov[pj[b0: b0 + step]]
        total += int(both.sum(dtype=torch.int64).item())
    return total


__all__ = ["DetectionEngine", "EngineOptions", "MODES", "TileScanContext"]
