"""DetectionEngine — the entry point for copy detection, on one device.

The production ``bucketed`` mode is the pair-tiled dataflow of the JAX
package's engine, on one card:

  1. build the inverted index (host numpy, streamed into the chunked
     ``CorpusStore``; the O(S²·D) ``l_counts`` product on the device) and
     re-chunk it p-sorted on each side of the Ē boundary
     (``engine_chunks`` — chunks double as the kernel's entry blocks);
  2. cut the S×S pair space into T×T tiles and prune, up front, every tile
     whose sources co-occur only inside the low-contribution suffix Ē
     (Proposition 3.4), from the per-chunk OR-reduced incidence; only
     unordered (r ≤ c) tiles are scheduled;
  3. stream chunk groups (default one chunk per pass) host→device from
     pinned memory and launch the fused dual-direction copyscore kernel
     once per group over the whole surviving tile list; the five per-tile
     channels accumulate in device stacks across groups;
  4. scatter both orientations of every tile into (S, S) device grids,
     apply the INDEX step-3 different-value adjustment, exactly rescore
     every pair whose decision margin is within its accumulated error
     bound, and decide — all in torch on the engine's device. Decisions
     equal ``index_detect_exact``.

Modes carried in this slice: ``pairwise`` (the exhaustive oracle),
``exact`` (entry-sequential INDEX with the paper's accounting) and
``bucketed``. The others raise ``NotImplementedError`` naming the ROADMAP
item that ports them.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from repro_torch.core.bucketed import index_detect_exact
from repro_torch.core.distributed import group_tile_scores
from repro_torch.core.incremental import rescore_pairs_exact
from repro_torch.core.index import InvertedIndex, build_index, engine_chunks
from repro_torch.core.scoring import (
    bucket_score_deltas,
    decide_copying,
    pairwise_detect,
    posterior_independence,
)
from repro_torch.core.shardplan import scatter_tile_stacks
from repro_torch.core.tilecache import chunk_block_inc
from repro_torch.core.types import ClaimsDataset, CopyConfig, DetectionResult
from repro_torch.kernels.ops import tile_scores
from repro_torch.utils.counters import ComputeCounter
from repro_torch.utils.device import resolve_device

MODES = ("pairwise", "exact", "bucketed", "bound", "bound+", "hybrid",
         "incremental", "sampled", "sample_verify")

#: modes of the JAX engine this slice does not carry, and the ROADMAP item
#: that ports them
_NOT_PORTED = {"bound": "A8", "bound+": "A8", "hybrid": "A8",
               "incremental": "A8", "sampled": "A8", "sample_verify": "A8"}


@dataclass
class EngineOptions:
    """Tuning knobs of the tiled pass (the JAX engine's, where carried)."""

    # entry buckets per index (count): the p̂ granularity of the chunks.
    n_buckets: int = 64
    # pair-tile edge (sources per tile side); clamped down for tiny datasets
    # (see _tile_edge).
    tile: int = 256
    # decision-margin band (log-odds units) around z = 0 that triggers an
    # exact rescore on top of the accumulated p̂-error bound.
    rescore_margin: float = 1.0
    # incidence element type: auto | int8 (0/1 incidence, exact int32
    # counts). The JAX engine's bf16/f32 ablations are not carried.
    incidence_dtype: str = "auto"
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


@dataclass
class TileScanContext:
    """The deterministic prologue of one tiled pass: everything the scan and
    the finalize consume, computed once (host numpy)."""

    t0: float
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
    index_build_s: float = 0.0     # host seconds building the index (0 if given)
    prologue_s: float = 0.0        # host seconds of the rest of the prologue


class DetectionEngine:
    """One engine per detection workload, bound to one device.

    ``device=None`` is the card; a missing card raises. Pass ``device="cpu"``
    to run the plain PyTorch path on the CPU.
    """

    def __init__(self, cfg: CopyConfig, mode: str = "bucketed", device=None,
                 **options):
        if mode not in MODES:
            raise ValueError(f"unknown mode {mode!r}; expected one of {MODES}")
        if mode in _NOT_PORTED:
            raise NotImplementedError(
                f"mode {mode!r} is not ported yet (ROADMAP {_NOT_PORTED[mode]})")
        self.cfg = cfg
        self.mode = mode
        self.device = resolve_device(device)
        self.options = EngineOptions(**options)
        if self.options.incidence_dtype not in ("auto", "int8"):
            raise ValueError(
                f"incidence_dtype {self.options.incidence_dtype!r}: only "
                f"int8 incidence is carried ('auto' or 'int8')")
        self.last_stats: dict = {}
        self._scan_stats: dict = {}

    # -- dispatch -----------------------------------------------------------

    def detect(
        self,
        ds: ClaimsDataset,
        p_claim: np.ndarray,
        index: InvertedIndex | None = None,
    ) -> DetectionResult:
        """Run one detection pass in this engine's mode.

        Args:
          ds: the (S, D) claims dataset.
          p_claim: (S, D) float32 — truth probability of the value each
            source provides per item (equal across providers of one value;
            ignored where values[s, d] < 0).
          index: a prebuilt ``InvertedIndex`` to reuse (this package's, or
            one loaded from the JAX package's ``state_dict``); None → built
            here.

        Returns a ``DetectionResult`` (numpy fields) over every ordered
        source pair; per-run diagnostics land in ``self.last_stats``.
        """
        if self.mode == "pairwise":
            return pairwise_detect(ds, p_claim, self.cfg, device=self.device)
        if self.mode == "exact":
            if index is None:
                index = self._build_index(ds, p_claim)
            return index_detect_exact(ds, p_claim, self.cfg, index=index)
        return self._detect_tiled(ds, p_claim, index=index)

    # -- the tiled production path -------------------------------------------

    def _build_index(self, ds: ClaimsDataset,
                     p_claim: np.ndarray) -> InvertedIndex:
        """Build an index honoring this engine's store-chunking options."""
        opt = self.options
        return build_index(ds, p_claim, self.cfg,
                           chunk_entries=opt.store_chunk_entries,
                           chunk_bytes=opt.store_chunk_bytes,
                           device=self.device)

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
        """Steps 1–2 of the tiled pass: index, chunking, pruning, sizing."""
        t0 = time.perf_counter()
        opt = self.options
        S = ds.n_sources
        T = self._tile_edge(S)
        n_blocks = -(-S // T)
        S_pad = n_blocks * T
        base_idx = index
        index_build_s = 0.0
        if base_idx is None:
            base_idx = self._build_index(ds, p_claim)
            index_build_s = time.perf_counter() - t0
        itemsize = 1                                # int8 incidence
        # p-ordered, region-padded, uniform-width chunk store; rows carry the
        # tile-grid padding so chunks slice straight into pair tiles. The
        # byte budget caps the chunk width so even ONE shipped chunk
        # respects it (floored at 8 entries inside engine_chunks).
        ech = engine_chunks(
            base_idx, opt.n_buckets, row_capacity=S_pad,
            max_width=opt.chunk_group_bytes // max(S_pad * itemsize, 1))
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
        # unordered (r ≤ c) tiles are scheduled.
        keep = np.zeros((n_blocks, n_blocks), bool)
        chunk_keep = np.zeros((K, n_blocks, n_blocks), bool)
        for k in range(K):
            # 0/1 products sum exactly in float32 (widths ≪ 2²⁴)
            g_k = chunk_block_inc(ech.store, k, T, n_blocks).astype(np.float32)
            chunk_keep[k] = (g_k @ g_k.T) > 0
            if k < ech.ebar_chunk:
                keep |= chunk_keep[k]
        coords = np.ascontiguousarray(np.argwhere(np.triu(keep)),
                                      dtype=np.int32)        # r ≤ c tiles
        tiles_total = n_blocks * (n_blocks + 1) // 2

        acc_pad = np.pad(ds.accuracy.astype(np.float32), (0, S_pad - S),
                         constant_values=0.5)
        chunk_nbytes = S_pad * b * itemsize
        budget_chunks = max(1, opt.chunk_group_bytes // max(chunk_nbytes, 1))
        if opt.chunk_group is not None:
            Gc = min(max(1, int(opt.chunk_group)), budget_chunks)
        else:
            Gc = min(budget_chunks, max(1, K - 1))
        return TileScanContext(
            t0=t0, ds=ds, p_claim=p_claim, base_idx=base_idx, ech=ech,
            delta=delta, S=S, T=T, n_blocks=n_blocks, S_pad=S_pad,
            acc_pad=acc_pad, chunk_keep=chunk_keep, coords=coords,
            tiles_total=tiles_total, n_tiles=len(coords), Gc=Gc,
            chunk_nbytes=chunk_nbytes, index_build_s=index_build_s,
            prologue_s=time.perf_counter() - t0 - index_build_s)

    def _scan_groups(self, ctx: TileScanContext) -> list:
        """The chunk groups the scan runs: (chunk ids, live-tile mask) for
        every group in which some surviving tile is kept by some chunk."""
        K = ctx.ech.n_chunks
        tile_keep = ctx.chunk_keep[:, ctx.coords[:, 0], ctx.coords[:, 1]]
        groups = []
        for g0 in range(0, K, ctx.Gc):
            ks = list(range(g0, min(g0 + ctx.Gc, K)))
            gmask = tile_keep[ks].any(axis=0)
            if gmask.any():
                groups.append((ks, gmask))
        return groups

    def _stage_group(self, ctx: TileScanContext, ks, gmask, host: torch.Tensor):
        """Kernel operands of one group on the device: the (S_pad, Gc, w)
        int8 slab (written into the ``host`` buffer — pinned on the card —
        and copied synchronously), the per-chunk p̂ / δ / non-Ē arrays and
        the tile list with chunk-pruned tiles marked (-1, -1)."""
        ech, dev, Gc = ctx.ech, self.device, ctx.Gc
        slab = host.numpy()
        for i, k in enumerate(ks):
            slab[:, i, :] = ech.store.chunks[k]
        if len(ks) < Gc:
            slab[:, len(ks):, :] = 0            # inert chunks of a short group
        p_g = np.full(Gc, 0.5, np.float32)
        d_g = np.zeros(Gc, np.float32)
        o_g = np.zeros(Gc, np.float32)
        p_g[: len(ks)] = ech.p_hat[ks]
        d_g[: len(ks)] = ctx.delta[ks]
        o_g[: len(ks)] = ech.nout[ks]
        coords_g = np.ascontiguousarray(
            np.where(gmask[:, None], ctx.coords, -1), dtype=np.int32)
        return (host.to(dev), torch.from_numpy(p_g).to(dev),
                torch.from_numpy(d_g).to(dev), torch.from_numpy(o_g).to(dev),
                torch.from_numpy(coords_g).to(dev))

    def _run_tiled_scan(self, ctx: TileScanContext):
        """Step 3: the tile∘chunk scan — the four (S_pad, S_pad) device
        grids (C_same→, count, non-Ē count, error bound) + run count."""
        dev = self.device
        T, S_pad, n_tiles = ctx.T, ctx.S_pad, ctx.n_tiles
        K, b = ctx.ech.n_chunks, ctx.ech.width
        grids = [torch.zeros((S_pad, S_pad), dtype=torch.float32, device=dev)
                 for _ in range(4)]
        t0 = time.perf_counter()
        launches0 = tile_scores.launches
        chunk_tiles_run = 0
        kernel_ms = 0.0
        groups = self._scan_groups(ctx) if n_tiles and K else []
        if groups:
            # per-tile accumulators live on the device across groups; one
            # scatter at the end. Peak resident incidence = one group.
            stacks = [torch.zeros((n_tiles, T, T), dtype=torch.float32,
                                  device=dev) for _ in range(5)]
            acc = torch.from_numpy(ctx.acc_pad).to(dev)
            host = torch.empty((S_pad, ctx.Gc, b), dtype=torch.int8,
                               pin_memory=dev.type == "cuda")
            timed = []
            for ks, gmask in groups:
                # a tile shipped with a group scans ALL the group's chunks,
                # so count what really runs
                chunk_tiles_run += int(gmask.sum()) * len(ks)
                v, p_g, d_g, o_g, coords_g = self._stage_group(ctx, ks, gmask,
                                                               host)
                if dev.type == "cuda":
                    ev = (torch.cuda.Event(enable_timing=True),
                          torch.cuda.Event(enable_timing=True))
                    ev[0].record()
                group_tile_scores(v, acc, p_g, d_g, o_g, coords_g, stacks,
                                  self.cfg, tile=T)
                if dev.type == "cuda":
                    ev[1].record()
                    timed.append(ev)
            if timed:
                torch.cuda.synchronize(dev)
                kernel_ms = sum(a.elapsed_time(z) for a, z in timed)
            scatter_tile_stacks(grids, torch.from_numpy(ctx.coords).to(dev),
                                stacks, ctx.n_blocks, T)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        self._scan_stats = {"groups_run": len(groups),
                            "kernel_launches": tile_scores.launches - launches0,
                            "scan_s": time.perf_counter() - t0,
                            "scan_kernel_ms": kernel_ms}
        return grids, chunk_tiles_run

    def _tiled_finalize(self, ctx: TileScanContext, grids,
                        chunk_tiles_run: int) -> DetectionResult:
        """Step 4 on the device: INDEX step 3 + error-bounded exact rescore
        + decide. ``grids`` may be device tensors or host arrays."""
        t_fin = time.perf_counter()
        cfg, opt, dev = self.cfg, self.options, self.device
        ds, S, ech = ctx.ds, ctx.S, ctx.ech
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
        t_res = time.perf_counter()
        z = np.log(cfg.alpha / cfg.beta) + torch.logaddexp(c_fwd, c_fwd.T)
        near = considered & (z.abs() < opt.rescore_margin
                             + torch.maximum(err, err.T))
        del z
        pi, pj = torch.nonzero(torch.triu(near, 1), as_tuple=True)
        del near
        vals = torch.as_tensor(ds.values, device=dev)
        p = torch.as_tensor(np.asarray(ctx.p_claim, np.float32), device=dev)
        acc = torch.as_tensor(ds.accuracy, dtype=torch.float32, device=dev)
        n_rescored = rescore_pairs_exact(vals, p, acc, cfg, pi, pj, c_fwd)
        del vals, p
        rescore_s = time.perf_counter() - t_res

        pr_ind = posterior_independence(c_fwd, c_fwd.T, cfg)
        copying = decide_copying(c_fwd, c_fwd.T, cfg) & considered
        pr_ind = torch.where(considered, pr_ind, 1.0)
        pr_ind.fill_diagonal_(1.0)
        copying.fill_diagonal_(False)

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
        result = DetectionResult(
            c_fwd=c_fwd.cpu().numpy(), pr_independent=pr_ind.cpu().numpy(),
            copying=copying.cpu().numpy(), counter=counter,
            wall_time_s=time.perf_counter() - ctx.t0)
        scan = self._scan_stats
        self.last_stats = {
            "device": str(dev),
            "tile": ctx.T,
            "tiles_total": ctx.tiles_total,        # unordered (r ≤ c) tiles
            "tiles_kept": ctx.n_tiles,
            "tiles_pruned": ctx.tiles_total - ctx.n_tiles,
            "schedule": "triangular",
            "incidence_dtype": "int8",
            "rescored_pairs": n_rescored,
            "chunks": ech.n_chunks,
            "chunk_width": ech.width,
            "chunk_group": ctx.Gc,
            "chunk_tiles_total": ech.n_chunks * ctx.n_tiles,
            "chunk_tiles_run": chunk_tiles_run,
            "peak_group_bytes": int(ctx.Gc * ctx.chunk_nbytes),
            "mask_source": "fresh",
            "groups_run": scan.get("groups_run", 0),
            "kernel_launches": scan.get("kernel_launches", 0),
            "index_build_s": ctx.index_build_s,
            "prologue_s": ctx.prologue_s,
            "scan_s": scan.get("scan_s", 0.0),
            "scan_kernel_ms": scan.get("scan_kernel_ms", 0.0),
            "rescore_s": rescore_s,
            "finalize_s": time.perf_counter() - t_fin,
        }
        return result


__all__ = ["DetectionEngine", "EngineOptions", "MODES", "TileScanContext"]
