"""The row-range-sharded corpus data plane, and the tile-stack scatter.

  * ``ShardPlan`` — a row-range partition: shard ``s`` owns the contiguous
    global rows ``[bounds[s], bounds[s+1])``; ``make_shard_plan`` balances
    one, ``rebalance_plan`` re-splits after commits and retractions skew it.
  * ``ShardedCorpusStore`` — a facade speaking the full ``CorpusStore`` API
    (chunk views, slices, co-occurrence, gathers, row and entry mutation,
    snapshot, ``state_dict``) over per-shard row slices: each shard holds
    only its rows of every chunk, and per-shard peak resident bytes are
    tracked.
  * ``seal`` freezes the layout for a scan, optionally **bitpacked** (1 bit
    an entry, ``store.pack_membership``) and under a per-shard LRU byte cap
    that **spills** cold blocks to checksummed frames (``wal.write_framed``
    with ``SPILL_MAGIC``). A corrupt frame is never trusted: a store derived
    by ``gather_entries`` regathers the block from its source, any other
    raises ``SpillCorruptionError``. ``shard_store`` and ``gather_entries``
    can stream the seal through the build, so no shard's residency exceeds
    its cap while the store is made.
  * The detection merge. ``merge_shard_partials`` combines full per-shard
    grids — counts by sum, the p̂-error bound by elementwise max, so the
    rescore trigger is never weaker than one host's. The engine does not
    build full grids per shard: each owner's scan returns its tiles' five
    channels as device tile stacks (``OwnerPartial``), and
    ``merge_owner_partials`` scatters every owner's tiles once into one set
    of grids. Tile ownership partitions the pair space, so that scatter
    equals ``merge_shard_partials`` over the owners' ``to_grids``, bit for
    bit.

The arrays every read returns equal the JAX package's ``ShardedCorpusStore``
(``repro.core.shardplan``) on the same store, and a state dict or a spill
frame written by either loads in the other. Two choices differ on purpose:
each sealed store spills into a directory of its own under ``spill_dir``
(the reference names frames by shard and chunk only, so two stores sharing
a directory would read each other's frames), and a mutation drops the
regather source (which no longer matches the mutated rows).

A shard failing mid-scan never leaks a partial decision matrix: the engine
wraps each owner's scan and raises one typed ``ShardScanError``.
"""
from __future__ import annotations

import os
import shutil
import tempfile
import weakref
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Iterator, Optional

import numpy as np
import torch

from repro_torch.core import wal
from repro_torch.core.store import (
    ChunkView,
    CorpusStore,
    PackedBlock,
    _nonzero_2d,
    align_chunk,
    next_mseq,
    pack_membership,
    packed_count_matmul,
    unpack_membership,
)

#: Serialized-plan version (rides inside the store state dict).
SHARD_LAYOUT_VERSION = 1


class ShardScanError(RuntimeError):
    """One shard failed mid-scan; no partial decision matrix was produced.

    The merge runs only after every owning shard returned its tiles, so a
    raising shard surfaces as this one typed error, its cause chained.
    """

    def __init__(self, shard: int, message: str):
        super().__init__(f"shard {shard}: {message}")
        self.shard = int(shard)


class SpillCorruptionError(RuntimeError):
    """A spilled block failed frame validation and no source can regather it."""


class SealedShardError(RuntimeError):
    """A mutation was attempted on a sealed (packed/spilled) store; call
    ``unseal()`` first."""


# ---------------------------------------------------------------------------
# The plan
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ShardPlan:
    """A row-range partition: shard ``s`` owns rows [bounds[s], bounds[s+1]).

    ``bounds`` is a non-decreasing ``(n_shards + 1,)`` int64 array with
    ``bounds[0] == 0``; empty shards (equal consecutive bounds) are legal.
    """

    bounds: np.ndarray

    def __post_init__(self):
        b = np.asarray(self.bounds, np.int64)
        if b.ndim != 1 or len(b) < 2 or b[0] != 0 or np.any(np.diff(b) < 0):
            raise ValueError(f"invalid shard bounds {b!r}")
        object.__setattr__(self, "bounds", b)

    @property
    def n_shards(self) -> int:
        """Number of shards in the plan."""
        return len(self.bounds) - 1

    @property
    def n_rows(self) -> int:
        """Total rows the plan covers (the last bound)."""
        return int(self.bounds[-1])

    def sizes(self) -> np.ndarray:
        """Rows per shard, ``(n_shards,)`` int64."""
        return np.diff(self.bounds)

    def range_of(self, s: int) -> tuple[int, int]:
        """Global row range ``[r0, r1)`` owned by shard ``s``."""
        return int(self.bounds[s]), int(self.bounds[s + 1])

    def owner_of_row(self, r: int) -> int:
        """Shard owning global row ``r`` (rows past the last bound → last)."""
        s = int(np.searchsorted(self.bounds, int(r), side="right")) - 1
        return min(max(s, 0), self.n_shards - 1)

    def imbalance(self) -> float:
        """max shard size / ideal size (1.0 = perfectly balanced)."""
        if self.n_rows == 0:
            return 1.0
        return float(self.sizes().max() * self.n_shards / self.n_rows)


def make_shard_plan(n_rows: int, n_shards: int) -> ShardPlan:
    """A balanced plan: shard sizes differ by at most one row."""
    n_rows, n_shards = int(n_rows), int(n_shards)
    if n_shards < 1:
        raise ValueError(f"need at least one shard, got {n_shards}")
    if n_rows < 0:
        raise ValueError(f"negative n_rows {n_rows}")
    return ShardPlan(
        bounds=(np.arange(n_shards + 1, dtype=np.int64) * n_rows) // n_shards)


def rebalance_plan(plan: ShardPlan, n_rows: Optional[int] = None,
                   tolerance: float = 0.25) -> ShardPlan:
    """The plan to use after growth: re-split when skew exceeds tolerance.

    ``n_rows`` is the corpus's current row count (commits grow the last
    shard; retractions shrink interior ones). The plan is extended to cover
    it and re-balanced from scratch when its imbalance exceeds ``1 +
    tolerance``; otherwise the extended plan is kept, so shard-local state
    stays put.
    """
    rows = plan.n_rows if n_rows is None else int(n_rows)
    bounds = plan.bounds.copy()
    bounds[-1] = max(rows, int(bounds[-2]))
    grown = ShardPlan(bounds=bounds)
    if grown.imbalance() > 1.0 + float(tolerance):
        return make_shard_plan(rows, plan.n_shards)
    return grown


# ---------------------------------------------------------------------------
# The detection merge
# ---------------------------------------------------------------------------

def merge_shard_partials(partials: list, shape: Optional[tuple] = None,
                         device=None):
    """Combine full per-shard partial grids into the single-host grids.

    Each element of ``partials`` is ``(c_same, count, count_outside, err)``,
    full-size float32 grids (tensors or arrays) with only that shard's tiles
    populated. The three score/count channels combine by sum (on disjoint
    support x + 0 is exact); the p̂-error bound by elementwise max, so the
    merged bound dominates every shard's. Returns four float32 tensors
    (zeros of ``shape`` on ``device`` when there are no partials).
    """
    if not partials:
        if shape is None:
            raise ValueError("merge_shard_partials: no partials and no shape")
        z = torch.zeros(shape, dtype=torch.float32, device=device)
        return z, z.clone(), z.clone(), z.clone()
    c_same, n_cnt, n_out, err = (
        torch.as_tensor(g, dtype=torch.float32, device=device).clone()
        for g in partials[0])
    for cs, nc, no, er in partials[1:]:
        c_same += torch.as_tensor(cs, device=c_same.device)
        n_cnt += torch.as_tensor(nc, device=c_same.device)
        n_out += torch.as_tensor(no, device=c_same.device)
        torch.maximum(err, torch.as_tensor(er, device=c_same.device), out=err)
    return c_same, n_cnt, n_out, err


def scatter_tile_stacks(grids, coords: torch.Tensor, stacks, n_blocks: int,
                        tile: int) -> None:
    """Scatter both orientations of every unordered tile into full grids.

    ``grids`` = [c_same, n_cnt, n_out, err], each (S_pad, S_pad) float32;
    ``stacks`` holds the five kernel channels (C→, C←, shared count, non-Ē
    count, error bound) as ``(len(coords), T, T)`` tensors on the grids'
    device. The blocked transpose of a grid is a view, so an indexed write
    on tile coordinates lands each (T, T) block in place. The (c, r) mirror
    of tile (r, c) is C_same←ᵀ for the score and the plain transpose for the
    symmetric-role channels; diagonal tiles write identical values twice.
    """
    rr, cc = coords[:, 0].long(), coords[:, 1].long()
    cf_t, cb_t, n_t, o_t, e_t = stacks
    for grid, fwd, bwd in (
        (grids[0], cf_t, cb_t.transpose(1, 2)),
        (grids[1], n_t, None),
        (grids[2], o_t, None),
        (grids[3], e_t, None),
    ):
        g4 = grid.view(n_blocks, tile, n_blocks, tile).permute(0, 2, 1, 3)
        g4[rr, cc] = fwd
        g4[cc, rr] = fwd.transpose(1, 2) if bwd is None else bwd


@dataclass
class OwnerPartial:
    """One shard owner's share of a tiled detection pass.

    The owner scans only the surviving unordered tiles whose row block lies
    in its row range. ``stacks`` holds their five kernel channels (C→, C←,
    shared count, non-Ē count, error bound) as ``(k, T, T)`` float32
    tensors on the engine's device, aligned with ``coords``; ``stats`` the
    owner scan's telemetry (seconds, launches, staging).
    """

    owner: int                 # shard-owner id under the plan
    n_blocks: int              # tile-grid edge (blocks per side)
    tile: int                  # tile edge T
    coords: np.ndarray         # (k, 2) int32 — this owner's surviving tiles
    stacks: Optional[list]     # 5 × (k, T, T) float32 tensors, or None
    chunk_tiles_run: int = 0   # chunk∘tile pairs this owner scanned
    stats: dict = field(default_factory=dict)

    def to_grids(self, device=None) -> tuple:
        """This owner's partial grids, full-size with unowned tiles zero
        (on ``device``, default the stacks')."""
        if device is None:
            device = (self.stacks[0].device if self.stacks is not None
                      else torch.device("cpu"))
        s_pad = self.n_blocks * self.tile
        grids = [torch.zeros((s_pad, s_pad), dtype=torch.float32,
                             device=device) for _ in range(4)]
        if self.stacks is not None and len(self.coords):
            scatter_tile_stacks(
                grids, torch.as_tensor(self.coords).to(device),
                [s.to(device) for s in self.stacks], self.n_blocks, self.tile)
        return tuple(grids)


def merge_owner_partials(partials: list, n_blocks: int, tile: int,
                         device=None):
    """The merge of the owner fan-out: every owner's tiles scattered once.

    Requires every owner exactly once — a missing or duplicate owner would
    drop or double its tiles' counts, so the merge refuses. Each unordered
    tile (and its mirror) belongs to one owner, so every grid cell is
    written by at most one owner and left zero by the others: the scatter
    equals ``merge_shard_partials`` over the owners' full grids (x + 0 = x
    for the sums, max(e, 0) = e for the bound e ≥ 0) without building them.
    Returns the four (S_pad, S_pad) float32 grids on ``device`` (default
    the first owner's stacks').
    """
    owners = sorted(int(p.owner) for p in partials)
    if owners != list(range(len(owners))):
        raise ValueError(
            f"owner partials must cover each owner exactly once, got "
            f"owners {owners}")
    if device is None:
        device = next((p.stacks[0].device for p in partials
                       if p.stacks is not None), torch.device("cpu"))
    s_pad = n_blocks * tile
    grids = [torch.zeros((s_pad, s_pad), dtype=torch.float32, device=device)
             for _ in range(4)]
    for p in partials:
        if p.stacks is not None and len(p.coords):
            scatter_tile_stacks(grids, torch.as_tensor(p.coords).to(device),
                                [s.to(device) for s in p.stacks],
                                n_blocks, tile)
    return tuple(grids)


# ---------------------------------------------------------------------------
# Per-shard row slice
# ---------------------------------------------------------------------------

@dataclass
class _SpillRef:
    """Marker for a block whose bytes live on disk (spilled)."""

    path: str
    packed: bool               # was the resident form a PackedBlock?
    rows: int
    width: int


def _block_bytes(blk) -> int:
    """Resident bytes of a block (0 for a spilled one)."""
    if isinstance(blk, np.ndarray):
        return int(blk.nbytes)
    if isinstance(blk, PackedBlock):
        return blk.nbytes
    return 0


def _spill_dir(spill_dir: Optional[str],
               resident_bytes: Optional[int]) -> Optional[str]:
    """A fresh directory for one store's spill frames: under ``spill_dir``
    when given, under the system temp directory when only a byte cap is;
    None when the store may not spill."""
    if spill_dir is None and resident_bytes is None:
        return None
    if spill_dir is not None:
        os.makedirs(spill_dir, exist_ok=True)
    return tempfile.mkdtemp(prefix="cd-spill-", dir=spill_dir)


class _ShardSlice:
    """One shard's row slice of every chunk (dense | packed | spilled).

    ``blocks[c]`` holds this shard's rows of chunk ``c`` as a dense int8
    ``(cap_rows, width)`` array, a ``PackedBlock`` or a ``_SpillRef``.
    Residency is LRU-tracked; ``budget`` caps resident bytes once sealed;
    ``peak_bytes`` is the high-water mark (packed blocks at their packed
    size). The spill counters (frames written and read back, their bytes)
    accumulate for the slice's life.
    """

    def __init__(self, shard_id: int, start: int, cap_rows: int):
        self.shard_id = int(shard_id)
        self.start = int(start)
        self.cap_rows = int(cap_rows)
        self.blocks: list = []
        self.sealed = False
        self.budget: Optional[int] = None
        self.spill_dir: Optional[str] = None
        self.peak_bytes = 0
        self._lru: OrderedDict = OrderedDict()   # chunk id → resident bytes
        self._on_disk: set = set()               # chunks whose frame is current
        self._owner = None                       # back-ref for regather
        # resident bytes while sealed, kept by every change of a sealed
        # block (a sum over the blocks per eviction would cost O(chunks))
        self._res = 0
        self.spill_writes = self.spilled_bytes = 0
        self.reloads = self.reloaded_bytes = 0

    # -- residency accounting ------------------------------------------------

    _block_bytes = staticmethod(_block_bytes)

    @property
    def resident_bytes(self) -> int:
        """Bytes of incidence currently held in memory by this slice."""
        return sum(_block_bytes(b) for b in self.blocks)

    def _resident_now(self) -> int:
        return self._res if self.sealed else self.resident_bytes

    def _note_peak(self) -> None:
        self.peak_bytes = max(self.peak_bytes, self._resident_now())

    def _recount(self) -> None:
        """Recount the sealed resident bytes after blocks were swapped."""
        self._res = self.resident_bytes

    def _touch(self, c: int) -> None:
        self._lru[c] = _block_bytes(self.blocks[c])
        self._lru.move_to_end(c)

    def _seal_for_build(self, spill_dir: Optional[str],
                        budget: Optional[int]) -> None:
        """Seal an empty slice so a build streams its blocks in sealed."""
        self.sealed = True
        self.spill_dir = spill_dir
        self.budget = None if budget is None else int(budget)
        self._recount()

    def _add_block(self, blk, pack: bool) -> None:
        """Append one block during a streaming sealed build: pack it, note
        the peak with it resident, then evict under the budget."""
        if pack:
            blk = pack_membership(blk)
        self.blocks.append(blk)
        self._touch(len(self.blocks) - 1)
        self._res += _block_bytes(blk)
        self._note_peak()
        self._enforce_budget()

    # -- block access ---------------------------------------------------------

    def _resident(self, c: int):
        """Chunk ``c``'s block in memory (dense or packed), reloading a
        spilled one; marks it most recently used."""
        blk = self.blocks[c]
        if isinstance(blk, _SpillRef):
            blk = self._reload(c)
        self._touch(c)
        return blk

    def get_rows(self, c: int, lo: int, hi: int) -> np.ndarray:
        """Dense int8 ``(hi − lo, width)`` of local rows [lo, hi) — a packed
        block unpacks only those rows."""
        blk = self._resident(c)
        if isinstance(blk, PackedBlock):
            return unpack_membership(PackedBlock(blk.bits[lo:hi], blk.width))
        return blk[lo:hi]

    def get_column(self, c: int, off: int, n: int) -> np.ndarray:
        """Column ``off`` of chunk ``c`` over local rows [0, n), int8."""
        blk = self._resident(c)
        if isinstance(blk, PackedBlock):
            return ((blk.bits[:n, off >> 3] >> (7 - (off & 7))) & 1).view(
                np.int8)
        return blk[:n, off]

    def get_cols(self, c: int, n: int, c0: int, c1: int) -> np.ndarray:
        """Local columns [c0, c1) of chunk ``c`` over local rows [0, n)."""
        blk = self._resident(c)
        if isinstance(blk, PackedBlock):
            b0 = c0 >> 3
            sub = np.unpackbits(blk.bits[:n, b0: -(-c1 // 8)], axis=1)
            return sub[:, c0 - 8 * b0: c1 - 8 * b0].view(np.int8)
        return blk[:n, c0:c1]

    def block_or(self, c: int, n: int, fb: int, tile: int) -> tuple:
        """OR of chunk ``c``'s local rows [0, n) over each tile-row block:
        ``(starts, rows)`` — the local row where each block's part starts
        and a bool ``(len(starts), width)``. ``fb`` is the local row of the
        first block boundary. A packed block ORs its bytes and unpacks one
        row per block."""
        blk = self._resident(c)
        packed = isinstance(blk, PackedBlock)
        arr = blk.bits if packed else blk
        width = blk.width if packed else blk.shape[1]

        def reduce(x, axis):
            if packed:
                return np.unpackbits(np.bitwise_or.reduce(x, axis=axis),
                                     axis=-1, count=width).astype(bool)
            # incidence is 0/1 int8, so a max over the rows is the OR
            return x.max(axis=axis) != 0

        starts, parts = [], []
        if fb > 0:
            starts.append(0)
            parts.append(reduce(arr[: min(fb, n)], 0)[None])
        nf = max((n - fb) // tile, 0)
        if nf:
            starts += [fb + k * tile for k in range(nf)]
            parts.append(reduce(arr[fb: fb + nf * tile].reshape(
                nf, tile, arr.shape[1]), 1))
        tail = fb + nf * tile
        if fb <= tail < n:
            starts.append(tail)
            parts.append(reduce(arr[tail:n], 0)[None])
        return starts, np.concatenate(parts)

    def nonzero(self, c: int, lo: int, hi: int) -> tuple:
        """(rows, cols, values) of the nonzero cells of chunk ``c``'s local
        rows [lo, hi), rows relative to ``lo``, in row-major order. A packed
        block is scanned byte by byte: only its nonzero bytes expand."""
        blk = self._resident(c)
        if isinstance(blk, PackedBlock):
            bits = blk.bits[lo:hi]
            r, byte = np.nonzero(bits)
            wi, bi = np.nonzero(np.unpackbits(bits[r, byte][:, None], axis=1))
            rows, cols = r[wi], byte[wi].astype(np.int64) * 8 + bi
            return rows, cols, np.ones(len(rows), np.int8)
        sub = np.ascontiguousarray(blk[lo:hi])
        rows, cols = _nonzero_2d(sub)
        return rows, cols, sub[rows, cols]

    def packed_block(self, c: int) -> Optional[PackedBlock]:
        """Chunk ``c``'s resident ``PackedBlock``, or None when not packed."""
        blk = self.blocks[c]
        return blk if isinstance(blk, PackedBlock) else None

    # -- spill machinery --------------------------------------------------------

    def _spill_path(self, c: int) -> str:
        return os.path.join(self.spill_dir,
                            f"shard-{self.shard_id:03d}-chunk-{c:05d}.spill")

    def _write_spill(self, c: int) -> str:
        """Persist chunk ``c``'s resident block as a checksummed frame."""
        blk = self.blocks[c]
        if isinstance(blk, PackedBlock):
            arrays = {"bits": blk.bits,
                      "meta": np.array([1, blk.bits.shape[0], blk.width],
                                       np.int64)}
        else:
            arrays = {"bits": blk,
                      "meta": np.array([0, blk.shape[0], blk.shape[1]],
                                       np.int64)}
        path = wal.write_framed(self._spill_path(c), arrays,
                                magic=wal.SPILL_MAGIC, fsync=False)
        self._on_disk.add(c)
        self.spill_writes += 1
        self.spilled_bytes += os.path.getsize(path)
        return path

    def evict(self, c: int) -> None:
        """Spill chunk ``c`` to disk and drop its resident bytes (idempotent;
        a frame still current on disk is not written again)."""
        blk = self.blocks[c]
        if isinstance(blk, _SpillRef):
            return
        if self.spill_dir is None:
            raise SealedShardError(
                f"shard {self.shard_id}: no spill_dir; seal(spill_dir=...) first")
        packed = isinstance(blk, PackedBlock)
        if c not in self._on_disk:
            self._write_spill(c)
        self._res -= _block_bytes(blk)
        rows = blk.bits.shape[0] if packed else blk.shape[0]
        width = blk.width if packed else blk.shape[1]
        self.blocks[c] = _SpillRef(path=self._spill_path(c), packed=packed,
                                   rows=rows, width=width)
        self._lru.pop(c, None)

    def _reload(self, c: int):
        """Reinstate a spilled block, healing a corrupt frame by regather."""
        ref = self.blocks[c]
        try:
            d = wal.load_framed(ref.path, magic=wal.SPILL_MAGIC)
            meta = np.asarray(d["meta"], np.int64)
            if int(meta[0]):
                blk = PackedBlock(bits=np.asarray(d["bits"], np.uint8),
                                  width=int(meta[2]))
            else:
                blk = np.asarray(d["bits"], np.int8)
            self.reloads += 1
            self.reloaded_bytes += os.path.getsize(ref.path)
        except (wal.WalError, OSError) as e:
            blk = self._regather_block(c, ref, cause=e)
        self.blocks[c] = blk
        self._res += _block_bytes(blk)
        self._enforce_budget(protect=c)
        self._note_peak()
        return blk

    def _regather_block(self, c: int, ref: _SpillRef, cause: Exception):
        """Rebuild a corrupt spilled block from the source store it was
        gathered from (the same gather, so bit-equal), and rewrite its
        frame. Without a source: ``SpillCorruptionError``."""
        owner = self._owner
        regather = getattr(owner, "_regather", None) if owner else None
        if regather is None:
            raise SpillCorruptionError(
                f"shard {self.shard_id} chunk {c}: corrupt spill frame "
                f"({cause}) and no source store to regather from") from cause
        source, order = regather
        w = owner.chunk_entries
        sel = order[c * w: c * w + ref.width]
        dense = _gather_rows_cols(source, sel, self.start,
                                  self.start + ref.rows)
        blk = pack_membership(dense) if ref.packed else dense
        self.blocks[c] = blk
        self._write_spill(c)      # heal the on-disk copy
        return blk

    def _enforce_budget(self, protect: Optional[int] = None) -> None:
        """Evict LRU blocks until resident bytes fit the budget."""
        if self.budget is None:
            return
        while self._res > self.budget and self._lru:
            victim = next(iter(self._lru))
            if victim == protect:
                self._lru.move_to_end(victim)
                if len(self._lru) == 1:
                    break
                victim = next(iter(self._lru))
            self.evict(victim)

    def drop_spill(self) -> None:
        """Forget every frame on disk (the blocks are about to change)."""
        for c in self._on_disk:
            try:
                os.remove(self._spill_path(c))
            except OSError:
                pass
        self._on_disk.clear()


def _gather_rows_cols(src, order_slice: np.ndarray, r0: int,
                      r1: int) -> np.ndarray:
    """Dense ``(r1 − r0, len(order_slice))`` gather of global rows × columns.

    ``order_slice`` may contain ``-1`` padding markers (zero columns); rows
    past the source's capacity read zero. Takes a ``CorpusStore`` or a
    ``ShardedCorpusStore`` (the regather of one corrupt block).
    """
    order_slice = np.asarray(order_slice, np.int64)
    out = np.zeros((r1 - r0, len(order_slice)), np.int8)
    live = order_slice >= 0
    if not live.any():
        return out
    cols = order_slice[live]
    dst = np.nonzero(live)[0]
    w = max(src.chunk_entries, 1)
    for cid in np.unique(cols // w):
        m = cols // w == cid
        if isinstance(src, ShardedCorpusStore):
            blk = src.assemble_rows(int(cid), r0, r1)
            out[:, dst[m]] = blk[:, cols[m] - cid * w]
        else:
            src_blk = src.chunks[int(cid)]
            hi = min(r1, src_blk.shape[0])
            if hi > r0:
                out[: hi - r0, dst[m]] = src_blk[r0:hi, cols[m] - cid * w]
    return out


# ---------------------------------------------------------------------------
# The facade
# ---------------------------------------------------------------------------

class ShardedCorpusStore:
    """Row-range-sharded ``CorpusStore`` facade.

    Speaks the consumer API of ``CorpusStore`` — chunk views, column / slice
    / co-occurrence access, ``gather_entries``, the row and entry mutation
    protocol, snapshot/rollback, ``state_dict`` — over per-shard row slices
    (``_ShardSlice``): shard ``s`` holds rows ``[starts[s], starts[s+1])``
    of every chunk and nothing else. Entry metadata (item / value / p /
    score) is row-independent and stays global, with the copy-on-write
    discipline of ``CorpusStore``. Consumers that need a dense row range
    assemble it (``assemble_rows``).
    """

    def __init__(self, slices: list, starts: np.ndarray, widths: list,
                 entry_item, entry_value, entry_p, entry_score,
                 chunk_entries: int, n_rows: int, capacity: int,
                 delta_start: Optional[int], epoch: int):
        self._slices = list(slices)
        self._starts = np.asarray(starts, np.int64)
        self._widths = [int(w) for w in widths]
        self.entry_item = entry_item
        self.entry_value = entry_value
        self.entry_p = entry_p
        self.entry_score = entry_score
        self.chunk_entries = int(chunk_entries)
        self.n_rows = int(n_rows)
        self.capacity = int(capacity)
        self.delta_start = delta_start
        self.epoch = int(epoch)
        # membership-state identity (block-OR cache validity)
        self.mseq = next_mseq()
        self._regather = None            # (source store, gather order)
        for sl in self._slices:
            sl._owner = self
        self._own_spill_dirs(sl.spill_dir for sl in self._slices)

    def _own_spill_dirs(self, dirs) -> None:
        """Remove the spill directories this store created with it."""
        for d in {d for d in dirs if d is not None}:
            weakref.finalize(self, shutil.rmtree, d, True)

    # -- plan / geometry ------------------------------------------------------

    @property
    def n_shards(self) -> int:
        """Number of row-range shards."""
        return len(self._slices)

    @property
    def plan(self) -> ShardPlan:
        """The current row-range plan (last bound = live rows)."""
        return ShardPlan(bounds=np.append(
            self._starts, max(self.n_rows, int(self._starts[-1]))))

    def _coverage(self, s: int) -> tuple[int, int]:
        """Global row range shard ``s``'s blocks physically cover."""
        cov0 = int(self._starts[s])
        cov1 = (int(self._starts[s + 1]) if s + 1 < self.n_shards
                else self.capacity)
        return cov0, cov1

    def _live_span(self, s: int) -> tuple[int, int]:
        """(first global row, live local rows) of shard ``s``."""
        cov0, cov1 = self._coverage(s)
        return cov0, max(min(cov1, self.n_rows) - cov0, 0)

    @property
    def n_entries(self) -> int:
        """E — total entry columns across chunks (padding included)."""
        return len(self.entry_item)

    @property
    def n_chunks(self) -> int:
        """Number of entry chunks."""
        return len(self._widths)

    def chunk_width(self, c: int) -> int:
        """Column count of chunk ``c``."""
        return self._widths[c]

    @property
    def n_live_entries(self) -> int:
        """Entries that are real (non-padding) columns."""
        return int(np.count_nonzero(self.entry_item >= 0))

    @property
    def n_delta_entries(self) -> int:
        """Live entries in the delta region (appended since the last base)."""
        if self.delta_start is None:
            return 0
        return int(np.count_nonzero(self.entry_item[self.delta_start:] >= 0))

    @property
    def n_delta_chunks(self) -> int:
        """Chunks that hold at least one delta entry."""
        if self.delta_start is None:
            return 0
        return self.n_chunks - self.delta_start // self.chunk_entries

    def chunk_start(self, c: int) -> int:
        """Global index of chunk ``c``'s first entry column."""
        return c * self.chunk_entries

    # -- sealing / residency ----------------------------------------------------

    @property
    def sealed(self) -> bool:
        """True once ``seal`` froze the block layout (read-only mode)."""
        return any(sl.sealed for sl in self._slices)

    def _require_mutable(self) -> None:
        """Refuse a mutation while sealed; a mutation also retires the
        regather source, which would no longer match the rows."""
        if self.sealed:
            raise SealedShardError(
                "store is sealed (packed/spilled blocks); unseal() before "
                "mutating")
        self._regather = None

    def seal(self, pack: bool = False, spill_dir: Optional[str] = None,
             resident_bytes: Optional[int] = None) -> None:
        """Freeze the block layout; optionally bitpack and cap residency.

        ``pack=True`` converts every dense block to a ``PackedBlock`` (1 bit
        an entry; reads unpack transiently). ``resident_bytes`` puts each
        shard's resident set under an LRU byte cap, spilling cold blocks to
        checksummed frames in a fresh directory under ``spill_dir`` (under
        the system temp directory when none is given). Mutations raise
        ``SealedShardError`` until ``unseal``.
        """
        d = _spill_dir(spill_dir, resident_bytes)
        self._own_spill_dirs([d])
        for sl in self._slices:
            sl.sealed = True
            sl.spill_dir = d
            sl._on_disk.clear()
            sl.budget = None if resident_bytes is None else int(resident_bytes)
            if pack:
                sl.blocks = [pack_membership(b) if isinstance(b, np.ndarray)
                             else b for b in sl.blocks]
            sl._lru = OrderedDict(
                (c, _block_bytes(b)) for c, b in enumerate(sl.blocks)
                if not isinstance(b, _SpillRef))
            sl._recount()
            sl._note_peak()
            sl._enforce_budget()

    def unseal(self) -> None:
        """Reload/unpack every block to dense int8 and re-enable mutation."""
        for sl in self._slices:
            sl.budget = None
            for c in range(len(sl.blocks)):
                blk = sl.blocks[c]
                if isinstance(blk, _SpillRef):
                    blk = sl._reload(c)
                if isinstance(blk, PackedBlock):
                    sl.blocks[c] = unpack_membership(blk)
            sl.sealed = False
            sl.drop_spill()
            sl._lru.clear()
            sl._note_peak()

    def evict_block(self, shard: int, c: int) -> None:
        """Spill one block of one shard (test/operator hook; needs a seal)."""
        self._slices[shard].evict(c)

    def shard_resident_bytes(self) -> list:
        """Per-shard resident incidence bytes (packed counted packed)."""
        return [sl.resident_bytes for sl in self._slices]

    def shard_peak_bytes(self) -> list:
        """Per-shard peak resident incidence bytes since construction."""
        return [max(sl.peak_bytes, sl.resident_bytes) for sl in self._slices]

    def spill_stats(self) -> dict:
        """Spill traffic summed over the shards: frames written and read
        back, and their bytes on disk."""
        return {k: sum(getattr(sl, k) for sl in self._slices)
                for k in ("spill_writes", "spilled_bytes", "reloads",
                          "reloaded_bytes")}

    # -- assembly primitives ------------------------------------------------------

    def assemble_rows(self, c: int, r0: int, r1: int,
                      out: Optional[np.ndarray] = None) -> np.ndarray:
        """Dense int8 ``(r1 − r0, width_c)`` slab of chunk ``c``'s rows.

        Rows beyond the store's capacity read zero (tile padding), so the
        engine can request tile-aligned slabs straight off the facade.
        ``out`` (an int8 array of that shape, any strides) receives the
        slab instead of a fresh array.
        """
        if out is None:
            out = np.zeros((r1 - r0, self._widths[c]), np.int8)
        elif r1 > self.capacity:
            out[max(self.capacity - r0, 0):] = 0
        for s, sl in enumerate(self._slices):
            cov0, cov1 = self._coverage(s)
            lo, hi = max(r0, cov0), min(r1, cov1)
            if lo < hi:
                out[lo - r0: hi - r0] = sl.get_rows(c, lo - cov0, hi - cov0)
        return out

    def block_or(self, c: int, tile: int, n_blocks: int) -> np.ndarray:
        """Per-tile OR-reduction of chunk ``c`` — bool ``(n_blocks, width)``,
        reduced shard by shard (packed blocks on their bytes), so no host
        assembles the full chunk for it."""
        out = np.zeros((n_blocks, self._widths[c]), bool)
        for s, sl in enumerate(self._slices):
            cov0, lv = self._live_span(s)
            if lv == 0:
                continue
            starts, red = sl.block_or(c, lv, (-cov0) % tile, tile)
            for lo, row in zip(starts, red):
                b = (cov0 + lo) // tile
                if b < n_blocks:
                    out[b] |= row
        return out

    # -- CorpusStore consumer API ---------------------------------------------

    def chunk(self, c: int) -> ChunkView:
        """Chunk ``c`` as a handle (incidence assembled across shards, not
        memoized: caching assembled chunks would grow residency back to the
        full corpus)."""
        s0 = self.chunk_start(c)
        s1 = s0 + self._widths[c]
        return ChunkView(
            start=s0, V=self.assemble_rows(c, 0, self.n_rows),
            item=self.entry_item[s0:s1], value=self.entry_value[s0:s1],
            p=self.entry_p[s0:s1], score=self.entry_score[s0:s1])

    def iter_chunks(self) -> Iterator[ChunkView]:
        """Iterate chunk handles in entry order."""
        for c in range(self.n_chunks):
            yield self.chunk(c)

    def column(self, e: int) -> np.ndarray:
        """Incidence column of entry ``e`` over live rows (assembled)."""
        c, off = divmod(int(e), self.chunk_entries)
        out = np.zeros(self.n_rows, np.int8)
        for s, sl in enumerate(self._slices):
            cov0, lv = self._live_span(s)
            if lv:
                out[cov0: cov0 + lv] = sl.get_column(c, off, lv)
        return out

    def providers(self, e: int) -> np.ndarray:
        """S̄(E) — indices of the sources providing entry ``e``'s value."""
        return np.nonzero(self.column(e))[0]

    def slice_entries(self, e0: int, e1: int, dtype=np.int8,
                      rows: Optional[int] = None) -> np.ndarray:
        """Dense ``(rows, e1 − e0)`` gather of an entry range across chunks,
        equal to ``CorpusStore.slice_entries`` over the same corpus."""
        e0, e1 = int(e0), int(e1)
        n = self.n_rows if rows is None else int(rows)
        out = np.zeros((n, e1 - e0), dtype)
        w = self.chunk_entries
        nr = min(n, self.n_rows)
        for c in range(e0 // w if w else 0, self.n_chunks):
            s0 = self.chunk_start(c)
            if s0 >= e1:
                break
            lo, hi = max(e0, s0), min(e1, s0 + self._widths[c])
            if lo >= hi:
                continue
            for s, sl in enumerate(self._slices):
                cov0, cov1 = self._coverage(s)
                rhi = min(cov1, nr)
                if rhi > cov0:
                    out[cov0:rhi, lo - e0: hi - e0] = sl.get_cols(
                        c, rhi - cov0, lo - s0, hi - s0)
        return out

    def to_dense(self) -> np.ndarray:
        """The full ``(n_rows, E)`` incidence — compat/debug accessor ONLY."""
        if self.n_chunks == 0:
            return np.zeros((self.n_rows, 0), np.int8)
        return np.concatenate([self.assemble_rows(c, 0, self.n_rows)
                               for c in range(self.n_chunks)], axis=1)

    def cooccurrence(self, stop: Optional[int] = None, dtype=np.float32,
                     mask: Optional[np.ndarray] = None) -> np.ndarray:
        """Pair co-occurrence counts over selected entries (chunk-streamed).

        Exact small integers in float32, so equal to the dense product for
        any sharding. Fully selected chunks that every shard holds packed
        accumulate through ``packed_count_matmul`` without unpacking.
        """
        S = self.n_rows
        out = np.zeros((S, S), dtype)
        stop_eff = self.n_entries if stop is None else int(stop)
        for c in range(self.n_chunks):
            s0 = self.chunk_start(c)
            wc = self._widths[c]
            if mask is not None:
                m = mask[s0: s0 + wc]
                if not m.any():
                    continue
                whole = bool(m.all())
            else:
                if s0 >= stop_eff:
                    break
                whole = s0 + wc <= stop_eff
                m = None
            if whole and self._packed_coocc(c, out, dtype):
                continue
            v = self.assemble_rows(c, 0, S)
            if mask is not None and not whole:
                v = v[:, m]
            elif mask is None and not whole:
                v = v[:, : stop_eff - s0]
            v = v.astype(dtype)
            out += v @ v.T
        return out

    def _packed_coocc(self, c: int, out: np.ndarray, dtype) -> bool:
        """Accumulate chunk ``c``'s counts straight off packed bits; False
        (the caller assembles) unless every shard holds it packed."""
        packs = []
        for s, sl in enumerate(self._slices):
            pb = sl.packed_block(c)
            if pb is None:
                return False
            cov0, lv = self._live_span(s)
            packs.append((cov0, lv, PackedBlock(bits=pb.bits[:lv],
                                                width=pb.width)))
        for i, (ri, ni, pi) in enumerate(packs):
            if ni == 0:
                continue
            for rj, nj, pj in packs[i:]:
                if nj == 0:
                    continue
                blk = packed_count_matmul(pi, pj, dtype)
                out[ri: ri + ni, rj: rj + nj] += blk
                if rj != ri:
                    out[rj: rj + nj, ri: ri + ni] += blk.T
        return True

    # -- derived stores -----------------------------------------------------

    def gather_entries(self, order: np.ndarray,
                       chunk_entries: Optional[int] = None,
                       capacity: Optional[int] = None, *, pack: bool = False,
                       spill_dir: Optional[str] = None,
                       resident_bytes: Optional[int] = None
                       ) -> "ShardedCorpusStore":
        """A sharded store whose column ``j`` is this store's ``order[j]``.

        Same plan, shard by shard: shard ``s`` of the result is gathered
        only from the source rows it covers. ``order`` may hold ``-1``
        markers (inert zero columns) and repeat a live column. Each source
        block is scanned once and its set bits scattered to their new
        columns (a packed block by its nonzero bytes), so the cost follows
        the claims, not the (S, E) area per output chunk. ``pack`` /
        ``spill_dir`` / ``resident_bytes`` stream the seal through the
        build: each output block is packed as it is made and evicted under
        the byte cap, so no shard's residency exceeds the cap (plus one
        block) while the store is made. The result remembers ``(source,
        order)`` to regather a corrupt spilled block.
        """
        order = np.asarray(order, np.int64)
        E_out = len(order)
        w = (self.chunk_entries if chunk_entries is None
             else align_chunk(chunk_entries))
        cap = (self.capacity if capacity is None
               else max(int(capacity), self.n_rows))
        live = order >= 0
        safe = np.where(live, order, 0)
        item = np.full(E_out, -1, np.int32)
        value = np.full(E_out, -1, np.int32)
        p = np.zeros(E_out, np.float32)
        score = np.zeros(E_out, np.float32)
        item[live] = self.entry_item[safe[live]]
        value[live] = self.entry_value[safe[live]]
        p[live] = self.entry_p[safe[live]]
        score[live] = self.entry_score[safe[live]]

        streaming = pack or spill_dir is not None or resident_bytes is not None
        d = _spill_dir(spill_dir, resident_bytes) if streaming else None
        widths = [min(w, E_out - j0) for j0 in range(0, E_out, max(w, 1))]
        starts = self._starts.copy()
        # the destinations of each source column, sorted by source column
        src = order[live]
        by_src = np.argsort(src, kind="stable")
        src_s, dst_s = src[by_src], np.nonzero(live)[0][by_src]
        src_chunks = np.unique(src_s // max(self.chunk_entries, 1))
        slices = []
        for s in range(self.n_shards):
            cov0 = int(starts[s])
            cov1 = int(starts[s + 1]) if s + 1 < self.n_shards else cap
            sl = _ShardSlice(s, cov0, max(cov1 - cov0, 0))
            if streaming:
                sl._seal_for_build(d, resident_bytes)
            rows, dst, vals = self._gather_nonzeros(src_s, dst_s, src_chunks,
                                                    cov0, cov0 + sl.cap_rows)
            oc = (dst // max(w, 1)).astype(np.int32)
            by_chunk = np.argsort(oc, kind="stable")
            rows, dst, vals, oc = (rows[by_chunk], dst[by_chunk],
                                   vals[by_chunk], oc[by_chunk])
            bounds = np.searchsorted(oc, np.arange(len(widths) + 1))
            for j, width in enumerate(widths):
                lo, hi = bounds[j], bounds[j + 1]
                r, col = rows[lo:hi], dst[lo:hi] - j * w
                if streaming and pack:
                    # set the bits straight into the packed block (MSB
                    # first, as np.packbits): no dense block is made
                    bits = np.zeros((sl.cap_rows, -(-width // 8)), np.uint8)
                    on = vals[lo:hi] != 0
                    np.bitwise_or.at(bits, (r[on], col[on] >> 3),
                                     (0x80 >> (col[on] & 7)).astype(np.uint8))
                    sl._add_block(PackedBlock(bits, width), pack=False)
                    continue
                blk = np.zeros((sl.cap_rows, width), np.int8)
                blk[r, col] = vals[lo:hi]
                if streaming:
                    sl._add_block(blk, pack=False)
                else:
                    sl.blocks.append(blk)
            slices.append(sl)
        out = ShardedCorpusStore(
            slices=slices, starts=starts, widths=widths,
            entry_item=item, entry_value=value, entry_p=p, entry_score=score,
            chunk_entries=w, n_rows=self.n_rows, capacity=cap,
            delta_start=None, epoch=0)
        out._regather = (self, order)
        for sl in out._slices:
            sl._note_peak()
        return out

    def _gather_nonzeros(self, src_s, dst_s, src_chunks, r0: int, r1: int):
        """(rows − r0, destination columns, values) of every set cell of the
        selected source columns in global rows [r0, r1); a cell of a column
        selected twice appears once per destination."""
        rows_all, dst_all, val_all = [], [], []
        w = max(self.chunk_entries, 1)
        for s, sl in enumerate(self._slices):
            cov0, cov1 = self._coverage(s)
            lo, hi = max(r0, cov0), min(r1, cov1, self.capacity)
            if lo >= hi:
                continue
            for c in src_chunks:
                rows, cols, vals = sl.nonzero(int(c), lo - cov0, hi - cov0)
                gcol = int(c) * w + cols
                a = np.searchsorted(src_s, gcol, "left")
                cnt = np.searchsorted(src_s, gcol, "right") - a
                keep = cnt > 0
                rows, a, cnt, vals = rows[keep], a[keep], cnt[keep], vals[keep]
                if len(cnt) and cnt.max() > 1:
                    first = np.repeat(a, cnt)
                    offs = np.arange(first.size) - np.repeat(
                        np.cumsum(cnt) - cnt, cnt)
                    a = first + offs
                    rows, vals = np.repeat(rows, cnt), np.repeat(vals, cnt)
                rows_all.append(rows + (lo - r0))
                dst_all.append(dst_s[a])
                val_all.append(vals)
        if not rows_all:
            z = np.zeros(0, np.int64)
            return z, z, np.zeros(0, np.int8)
        return (np.concatenate(rows_all), np.concatenate(dst_all),
                np.concatenate(val_all))

    # -- row mutation ---------------------------------------------------------

    def append_rows(self, values_rows: np.ndarray,
                    collect_touched: bool = False):
        """Stage incidence rows for new sources, in the last shard (global
        row ids keep growing at the end); semantics of
        ``CorpusStore.append_rows``."""
        self._require_mutable()
        values_rows = np.asarray(values_rows, np.int32)
        q = values_rows.shape[0]
        if self.n_rows + q > self.capacity:
            raise ValueError(
                f"append_rows: {q} rows exceed capacity "
                f"({self.n_rows}/{self.capacity} used)")
        last = self._slices[-1]
        loc = self.n_rows - last.start
        bits = 0
        touched = []
        for c in range(self.n_chunks):
            s0 = self.chunk_start(c)
            s1 = s0 + self._widths[c]
            it = self.entry_item[s0:s1]
            va = self.entry_value[s0:s1]
            ok = it >= 0
            hit = np.zeros((q, s1 - s0), np.int8)
            if ok.any() and q:
                hit[:, ok] = (values_rows[:, it[ok]] == va[ok][None, :]
                              ).astype(np.int8)
            last.blocks[c][loc: loc + q] = hit
            bits += int(hit.sum())
            if collect_touched:
                touched.append(s0 + np.nonzero(hit.any(axis=0))[0])
        self.n_rows += q
        self.mseq = next_mseq()
        if collect_touched:
            return bits, (np.concatenate(touched) if touched
                          else np.zeros(0, np.int64))
        return bits

    def truncate_rows(self, n_rows: int) -> None:
        """Drop appended rows back down to ``n_rows`` (zeroing their slack)."""
        self._require_mutable()
        n_rows = int(n_rows)
        if n_rows > self.n_rows:
            raise ValueError(
                f"truncate_rows({n_rows}) above n_rows={self.n_rows}")
        last = self._slices[-1]
        if n_rows < last.start:
            raise ValueError(
                f"truncate_rows({n_rows}) would cross the last shard "
                f"boundary ({last.start}); retract_rows handles committed rows")
        lo, hi = n_rows - last.start, self.n_rows - last.start
        for blk in last.blocks:
            blk[lo:hi] = 0
        self.n_rows = n_rows
        self.mseq = next_mseq()

    def retract_rows(self, row_ids: np.ndarray) -> None:
        """Remove arbitrary live rows (source retraction).

        Each shard compacts its surviving rows into fresh arrays (a snapshot
        taken before stays bit-exact); the shard starts shift down by the
        rows removed before them. Bumps ``epoch``.
        """
        self._require_mutable()
        row_ids = np.unique(np.asarray(row_ids, np.int64))
        if len(row_ids) == 0:
            return
        if row_ids[0] < 0 or row_ids[-1] >= self.n_rows:
            raise ValueError(
                f"retract_rows: ids out of range [0, {self.n_rows})")
        keep = np.ones(self.n_rows, bool)
        keep[row_ids] = False
        new_starts = self._starts.copy()
        offset = 0
        for s, sl in enumerate(self._slices):
            cov0, lv = self._live_span(s)
            k_local = keep[cov0: cov0 + lv]
            n_keep = int(k_local.sum())
            new_starts[s] = offset
            for c in range(self.n_chunks):
                old = sl.blocks[c]
                blk = np.zeros((sl.cap_rows, old.shape[1]), np.int8)
                if n_keep:
                    blk[:n_keep] = old[:lv][k_local]
                sl.blocks[c] = blk
            offset += n_keep
        for s, sl in enumerate(self._slices):
            sl.start = int(new_starts[s])
        self._starts = new_starts
        self.capacity = int(new_starts[-1]) + self._slices[-1].cap_rows
        self.n_rows = offset
        self.epoch += 1
        self.mseq = next_mseq()

    def deactivate_entries(self, entry_ids: np.ndarray) -> None:
        """Turn entry columns into inert padding (retraction's GC), copy on
        write in every shard and in the metadata. Bumps ``epoch``."""
        self._require_mutable()
        entry_ids = np.asarray(entry_ids, np.int64)
        if len(entry_ids) == 0:
            return
        w = self.chunk_entries
        for cid in np.unique(entry_ids // w):
            cols = entry_ids[entry_ids // w == cid] - cid * w
            for sl in self._slices:
                blk = sl.blocks[int(cid)].copy()
                blk[:, cols] = 0
                sl.blocks[int(cid)] = blk
        item = self.entry_item.copy()
        value = self.entry_value.copy()
        p = self.entry_p.copy()
        score = self.entry_score.copy()
        item[entry_ids] = -1
        value[entry_ids] = -1
        p[entry_ids] = 0.0
        score[entry_ids] = 0.0
        self.entry_item, self.entry_value = item, value
        self.entry_p, self.entry_score = p, score
        self.epoch += 1
        self.mseq = next_mseq()

    # -- entry mutation ---------------------------------------------------------

    def _pad_last_chunk_full(self) -> None:
        """Pad the trailing chunk to the uniform width with inert columns
        (padded copies per shard; the metadata grows the same columns)."""
        if not self._widths:
            return
        w = self._widths[-1]
        if w == self.chunk_entries:
            return
        pad = self.chunk_entries - w
        for sl in self._slices:
            blk = np.zeros((sl.cap_rows, self.chunk_entries), np.int8)
            blk[:, :w] = sl.blocks[-1]
            sl.blocks[-1] = blk
        self._widths[-1] = self.chunk_entries
        self.entry_item = np.concatenate(
            [self.entry_item, np.full(pad, -1, np.int32)])
        self.entry_value = np.concatenate(
            [self.entry_value, np.full(pad, -1, np.int32)])
        self.entry_p = np.concatenate(
            [self.entry_p, np.zeros(pad, np.float32)])
        self.entry_score = np.concatenate(
            [self.entry_score, np.zeros(pad, np.float32)])

    def append_entries(self, cols: np.ndarray, item, value, p, score) -> int:
        """Append new entry columns as delta chunks, split by shard rows;
        semantics of ``CorpusStore.append_entries``. Bumps ``epoch``;
        returns the delta chunks added."""
        self._require_mutable()
        cols = np.asarray(cols, np.int8)
        n_new = cols.shape[1]
        if n_new == 0:
            return 0
        if cols.shape[0] != self.n_rows:
            raise ValueError(
                f"append_entries: {cols.shape[0]} rows, store has "
                f"{self.n_rows}")
        self._pad_last_chunk_full()
        if self.delta_start is None:
            self.delta_start = self.n_entries
        w = self.chunk_entries
        added = 0
        for j0 in range(0, n_new, w):
            width = min(w, n_new - j0)
            for s, sl in enumerate(self._slices):
                cov0, lv = self._live_span(s)
                blk = np.zeros((sl.cap_rows, width), np.int8)
                blk[:lv] = cols[cov0: cov0 + lv, j0: j0 + width]
                sl.blocks.append(blk)
            self._widths.append(width)
            added += 1
        self.entry_item = np.concatenate(
            [self.entry_item, np.asarray(item, np.int32)])
        self.entry_value = np.concatenate(
            [self.entry_value, np.asarray(value, np.int32)])
        self.entry_p = np.concatenate(
            [self.entry_p, np.asarray(p, np.float32)])
        self.entry_score = np.concatenate(
            [self.entry_score, np.asarray(score, np.float32)])
        self.epoch += 1
        self.mseq = next_mseq()
        return added

    def ensure_row_capacity(self, n: int) -> None:
        """Grow row capacity (slack lives in the last shard; geometric).
        Bumps ``epoch`` but not ``mseq``: membership is unchanged."""
        self._require_mutable()
        if n <= self.capacity:
            return
        new_cap = max(int(n), 2 * self.capacity)
        last = self._slices[-1]
        new_local = new_cap - last.start
        lv = max(self.n_rows - last.start, 0)
        for c in range(self.n_chunks):
            blk = np.zeros((new_local, last.blocks[c].shape[1]), np.int8)
            blk[:lv] = last.blocks[c][:lv]
            last.blocks[c] = blk
        last.cap_rows = new_local
        self.capacity = new_cap
        self.epoch += 1

    # -- rebalance ---------------------------------------------------------------

    def rebalance(self, tolerance: float = 0.25) -> bool:
        """Re-split rows evenly when commit/retract growth skewed the plan;
        True when rows moved. Chunks are re-sliced one at a time (one chunk
        assembled transiently, never the incidence whole)."""
        self._require_mutable()
        new_plan = rebalance_plan(self.plan, self.n_rows, tolerance)
        if np.array_equal(self.plan.bounds, new_plan.bounds):
            return False
        starts = new_plan.bounds[:-1].copy()
        slices = []
        for s in range(len(starts)):
            cov0 = int(starts[s])
            cov1 = (int(starts[s + 1]) if s + 1 < len(starts)
                    else self.capacity)
            slices.append(_ShardSlice(s, cov0, max(cov1 - cov0, 0)))
        for c in range(self.n_chunks):
            full = self.assemble_rows(c, 0, self.capacity)
            for sl in slices:
                sl.blocks.append(np.ascontiguousarray(
                    full[sl.start: sl.start + sl.cap_rows]))
        for sl in slices:
            sl._owner = self
            sl._note_peak()
        self._slices = slices
        self._starts = starts
        self.epoch += 1
        self.mseq = next_mseq()
        return True

    # -- snapshot / serialization --------------------------------------------

    def snapshot(self) -> "ShardedStoreSnapshot":
        """Capture a rollback point (block refs, not copies — O(blocks))."""
        return ShardedStoreSnapshot(
            store=self,
            slices=list(self._slices),
            blocks=[list(sl.blocks) for sl in self._slices],
            cap_rows=[sl.cap_rows for sl in self._slices],
            starts=self._starts.copy(), widths=list(self._widths),
            entry_item=self.entry_item, entry_value=self.entry_value,
            entry_p=self.entry_p, entry_score=self.entry_score,
            n_rows=self.n_rows, capacity=self.capacity,
            delta_start=self.delta_start, epoch=self.epoch)

    def state_dict(self, prefix: str = "store/") -> dict:
        """Flat ``{key: ndarray}`` dict capturing this store bit-exactly.

        The chunk payload is ``CorpusStore.state_dict``'s over the same
        corpus (assembled, trimmed to live rows), so an unsharded loader
        reads it unchanged, plus ``shard_starts`` for shard-aware loaders
        to re-establish the same plan. The keys of the JAX package's.
        """
        d = {
            prefix + "meta": np.array(
                [1, self.chunk_entries, self.n_rows,
                 -1 if self.delta_start is None else self.delta_start,
                 self.epoch, self.n_chunks], np.int64),
            prefix + "entry_item": self.entry_item,
            prefix + "entry_value": self.entry_value,
            prefix + "entry_p": self.entry_p,
            prefix + "entry_score": self.entry_score,
            prefix + "shard_starts": np.concatenate(
                [np.array([SHARD_LAYOUT_VERSION], np.int64), self._starts]),
        }
        for c in range(self.n_chunks):
            d[f"{prefix}chunk_{c:05d}"] = self.assemble_rows(c, 0, self.n_rows)
        return d

    @classmethod
    def from_state_dict(cls, d: dict, prefix: str = "store/",
                        capacity: Optional[int] = None) -> "ShardedCorpusStore":
        """Rebuild a sharded store (same plan) from ``state_dict`` output."""
        marker = np.asarray(d[prefix + "shard_starts"], np.int64)
        if int(marker[0]) > SHARD_LAYOUT_VERSION:
            raise ValueError(
                f"shard layout version {int(marker[0])} is newer than this "
                f"reader ({SHARD_LAYOUT_VERSION})")
        base = CorpusStore.from_state_dict(d, prefix=prefix, capacity=capacity)
        return shard_store(base, ShardPlan(bounds=np.append(marker[1:],
                                                            base.n_rows)))


@dataclass
class ShardedStoreSnapshot:
    """Rollback point for one ``ShardedCorpusStore`` (refs, not copies)."""

    store: "ShardedCorpusStore"
    slices: list                 # the slice objects (a rebalance swaps them)
    blocks: list                 # per shard: list of block refs
    cap_rows: list
    starts: np.ndarray
    widths: list
    entry_item: np.ndarray
    entry_value: np.ndarray
    entry_p: np.ndarray
    entry_score: np.ndarray
    n_rows: int
    capacity: int
    delta_start: Optional[int]
    epoch: int

    def restore(self) -> None:
        """Put the captured store back to its snapshot state, bit-exact:
        block refs, shard starts and capacities, then the row slack of every
        dense block zeroed (staged rows were written in place). Draws a
        fresh ``mseq``."""
        st = self.store
        st._slices = list(self.slices)
        for s, sl in enumerate(st._slices):
            sl.blocks = list(self.blocks[s])
            sl.cap_rows = int(self.cap_rows[s])
            sl.start = int(self.starts[s])
            sl._lru.clear()
            sl._on_disk.clear()
            sl._recount()
        st._starts = self.starts.copy()
        st._widths = list(self.widths)
        st.entry_item = self.entry_item
        st.entry_value = self.entry_value
        st.entry_p = self.entry_p
        st.entry_score = self.entry_score
        st.delta_start = self.delta_start
        st.epoch = self.epoch
        st.n_rows = self.n_rows
        st.capacity = self.capacity
        st.mseq = next_mseq()
        for s, sl in enumerate(st._slices):
            _, lv = st._live_span(s)
            for blk in sl.blocks:
                if isinstance(blk, np.ndarray):
                    blk[lv:] = 0


def shard_store(store: CorpusStore, plan, *, pack: bool = False,
                spill_dir: Optional[str] = None,
                resident_bytes: Optional[int] = None,
                consume: bool = False) -> ShardedCorpusStore:
    """Slice a ``CorpusStore`` into a ``ShardedCorpusStore`` under ``plan``
    (a ``ShardPlan`` or a shard count).

    Incidence rows are copied into per-shard blocks; entry metadata arrays
    are shared (both sides copy on write). Row slack lands in the last
    shard. ``pack`` / ``spill_dir`` / ``resident_bytes`` stream the seal
    through the build: each block is bitpacked as it is sliced and evicted
    under the LRU byte cap the moment its shard's resident set exceeds it,
    so the returned store is sealed and no shard's peak exceeds the cap
    (plus one block) during the build. ``consume=True`` also releases each
    source chunk once every shard sliced it (``CorpusStore.release_chunk``).
    """
    if isinstance(plan, int):
        plan = make_shard_plan(store.n_rows, plan)
    if plan.n_rows != store.n_rows:
        raise ValueError(
            f"plan covers {plan.n_rows} rows, store has {store.n_rows}")
    streaming = pack or spill_dir is not None or resident_bytes is not None
    d = _spill_dir(spill_dir, resident_bytes) if streaming else None
    starts = plan.bounds[:-1].copy()
    n_shards = plan.n_shards
    widths = [blk.shape[1] for blk in store.chunks]
    slices = []
    for s in range(n_shards):
        cov0 = int(starts[s])
        cov1 = int(starts[s + 1]) if s + 1 < n_shards else store.capacity
        sl = _ShardSlice(s, cov0, max(cov1 - cov0, 0))
        if streaming:
            sl._seal_for_build(d, resident_bytes)
        slices.append(sl)
    # chunk-major: every shard takes its rows of chunk c before chunk c+1,
    # so a streaming build seals each block at once and releases the source
    for c in range(store.n_chunks):
        src = store.chunks[c]
        for s, sl in enumerate(slices):
            cov1 = int(starts[s + 1]) if s + 1 < n_shards else store.capacity
            lv = max(min(cov1, store.n_rows) - sl.start, 0)
            if pack:
                # pack the live rows straight from the source; the slack
                # rows pack to zero bytes
                bits = np.zeros((sl.cap_rows, -(-widths[c] // 8)), np.uint8)
                bits[:lv] = pack_membership(src[sl.start: sl.start + lv]).bits
                sl._add_block(PackedBlock(bits, widths[c]), pack=False)
                continue
            blk = np.zeros((sl.cap_rows, widths[c]), np.int8)
            if lv:
                blk[:lv] = src[sl.start: sl.start + lv]
            if streaming:
                sl._add_block(blk, pack=False)
            else:
                sl.blocks.append(blk)
        if consume:
            store.release_chunk(c)
    for sl in slices:
        sl._note_peak()
    return ShardedCorpusStore(
        slices=slices, starts=starts, widths=widths,
        entry_item=store.entry_item, entry_value=store.entry_value,
        entry_p=store.entry_p, entry_score=store.entry_score,
        chunk_entries=store.chunk_entries, n_rows=store.n_rows,
        capacity=store.capacity, delta_start=store.delta_start,
        epoch=store.epoch)


__all__ = [
    "OwnerPartial", "SHARD_LAYOUT_VERSION", "SealedShardError", "ShardPlan",
    "ShardScanError", "ShardedCorpusStore", "ShardedStoreSnapshot",
    "SpillCorruptionError", "make_shard_plan", "merge_owner_partials",
    "merge_shard_partials", "rebalance_plan", "scatter_tile_stacks",
    "shard_store",
]
