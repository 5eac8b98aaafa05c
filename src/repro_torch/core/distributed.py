"""The tile scan over a mesh of devices, and the 2-D pair-space product.

The JAX package shards the detection pass's pair tiles over a device mesh
with ``shard_map``. The port keeps its design of one process driving every
device: a ``Mesh`` is a named grid of ``torch.device`` entries, CUDA launches
are asynchronous, so one host thread enqueues every entry's kernel, and
``shard_map``'s collectives become explicit copies to the mesh's first
device, with the sum over ``pod`` in a fixed order.

  * ``sharded_tile_scores`` — the engine's production dataflow over a 1-D
    mesh: the surviving (r ≤ c) tiles, padded with ``(-1, -1)`` slots to a
    multiple of the mesh size, are cut into contiguous blocks, one an entry
    (as ``P(axis)`` splits them); every entry scans its block with the fused
    kernel (B1, ``ops.tile_scores``) into stacks of its own, over the
    replicated group slab, accuracies, p̂, δ and non-Ē flags. The stacks are
    concatenated in order on the first entry's device. Per-tile sums are
    those of the one-device scan, so at equal chunk groups the grids are
    bit-equal to ``group_tile_scores``'s.
  * ``sharded_tile_scores_2d`` — tiles over ``data`` and the group's chunks
    over ``pod``: the chunk axis is padded to a multiple of ``pod`` with
    inert chunks (zero incidence, p̂ 0.5, δ 0, non-Ē flag 0), pod member
    ``(d, p)`` scans data block ``d``'s tiles over chunk slice ``p`` (a
    contiguous slab of its own), and the sum over ``pod`` runs in the order
    p = 0, 1, … on the data member's first device. Counts stay exact; the
    scores are reassociated, within float32 round-off (ROADMAP C4).
  * ``distributed_pair_scores`` — the SUMMA-like 2-D product of the full
    pair space: row blocks over ``data``, column blocks over ``model``, the
    entry width over ``pod`` when the mesh has one. Its body is a plain
    product (``jnp.dot`` in JAX), so here a ``torch.matmul``.
    ``distributed_pair_scores_lowerable`` and ``run.lower`` are its dry
    run: one entry's operand shapes and ``launch.roofline.analyze_step``'s
    terms of its body on ``meta`` tensors, with no incidence made.

``MeshTileScan`` is the state of one pass over a mesh: the engine stages
every chunk group into it (``core/pipeline.py:SlabRing`` places each slab
once a distinct device) and gathers the stacks after the last group.
Entries on the same physical device share one copy of the read-only
operands but keep their own stacks: that is how one card runs a mesh of
several ``cuda:0`` entries and the CPU a mesh of several ``cpu`` entries
(``runtime.platform.set_host_device_count``). A failed build or launch on
any entry raises; nothing falls back to another device or the plain
version.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.scoring import score_same
from repro_torch.core.types import CopyConfig
from repro_torch.kernels.ops import tile_scores
from repro_torch.utils.device import resolve_device

_CHANNELS = 5


# ---------------------------------------------------------------------------
# the mesh
# ---------------------------------------------------------------------------

class Mesh:
    """A named grid of devices: ``devices`` an ndarray of ``torch.device``
    (an entry may repeat a device) and one axis name a dimension.
    ``shape`` maps each axis name to its size, as JAX's does."""

    def __init__(self, devices, axis_names):
        arr = np.asarray(devices, dtype=object)
        axis_names = tuple(axis_names)
        if arr.ndim != len(axis_names):
            raise ValueError(f"{arr.ndim}-D devices need {arr.ndim} axis "
                             f"names, got {axis_names}")
        self.devices = np.empty(arr.shape, dtype=object)
        for i, d in np.ndenumerate(arr):
            self.devices[i] = torch.device(d)
        self.axis_names = axis_names

    @property
    def shape(self) -> dict:
        """Axis name → size."""
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        """Entries of the mesh."""
        return int(self.devices.size)

    def distinct(self) -> list:
        """The distinct devices, in the order of their first entry."""
        return _distinct(self.devices.flat)


def _distinct(devices) -> list:
    out = []
    for d in devices:
        if d not in out:
            out.append(d)
    return out


def make_mesh(shape, axes, devices=None) -> Mesh:
    """A mesh of ``shape`` over the first ``prod(shape)`` of ``devices``
    (None → every card, ``runtime.platform.local_devices``)."""
    from repro_torch.runtime.platform import local_devices

    shape = tuple(int(s) for s in shape)
    if len(shape) != len(tuple(axes)):
        raise ValueError(f"mesh shape {shape} and axes {tuple(axes)} differ "
                         f"in length")
    devs = local_devices(resolve_device(None)) if devices is None else [
        torch.device(d) for d in devices]
    n = int(np.prod(shape))
    if n > len(devs):
        raise ValueError(f"mesh shape {shape} needs {n} devices, "
                         f"{len(devs)} available")
    arr = np.empty(n, dtype=object)
    arr[:] = devs[:n]
    return Mesh(arr.reshape(shape), axes)


def _entry_grid(mesh: Mesh) -> np.ndarray:
    """The mesh as a (data, pod) grid: a 1-D mesh is (n, 1)."""
    if mesh.devices.ndim == 1:
        return mesh.devices.reshape(-1, 1)
    if mesh.devices.ndim == 2:
        return mesh.devices
    raise ValueError(f"the tile scan takes a 1-D or a (data, pod) mesh, got "
                     f"axes {mesh.axis_names}")


def pod_padding(n_chunks: int, n_pod: int) -> int:
    """Inert chunks that pad ``n_chunks`` to a multiple of ``n_pod``."""
    return (-int(n_chunks)) % int(n_pod)


# ---------------------------------------------------------------------------
# the tile scan of one pass over a mesh
# ---------------------------------------------------------------------------

def group_tile_scores(
    v: torch.Tensor,          # (S_pad, Gc, w) int8 group slab, on the device
    acc: torch.Tensor,        # (S_pad,) float32 accuracies (0.5 in padding rows)
    p_hat: torch.Tensor,      # (Gc,) float32 representative p̂ per chunk
    delta: torch.Tensor,      # (Gc,) float32 per-chunk score-error bound δ
    nout: torch.Tensor,       # (Gc,) float32 — 1.0 ⇔ chunk before the Ē boundary
    coords: torch.Tensor,     # (n_tiles, 2) int32 surviving (r ≤ c) tiles, (-1,-1) skip
    stacks,                   # five (n_tiles, T, T) float32 tile stacks
    cfg: CopyConfig,
    *,
    tile: int,
) -> None:
    """Add one chunk group's five channels into the per-tile stacks: one
    launch of B1 on one device (one mesh entry's share of a group).

    The stacks stay on the device across groups; the caller scatters them
    into the (S, S) grids once, after the last group.
    """
    tile_scores(v, acc, p_hat, delta, nout, coords, stacks, tile=tile,
                s=cfg.s, n_false=cfg.n)


class MeshTileScan:
    """One pass's tile scan over a 1-D mesh or a (``data``, ``pod``) mesh.

    ``n_tiles`` tiles are padded to ``n_data · n_local`` slots; data member
    ``d`` owns slots ``[d · n_local, (d + 1) · n_local)``. Entry ``(d, p)``
    keeps five ``(n_local, T, T)`` stacks on its device; ``acc`` is placed
    once a distinct device. ``run_group`` launches every entry's kernel on
    one staged group; ``gather`` sums over ``pod`` and concatenates over
    ``data`` on the mesh's first device.
    """

    def __init__(self, mesh: Mesh, n_tiles: int, tile: int, acc):
        self.mesh = mesh
        self.grid = _entry_grid(mesh)
        self.n_data, self.n_pod = self.grid.shape
        self.tile = int(tile)
        self.n_local = -(-int(n_tiles) // self.n_data)
        self.n_padded = self.n_local * self.n_data
        acc = torch.as_tensor(np.ascontiguousarray(acc), dtype=torch.float32)
        self.acc = {dev: acc.to(dev) for dev in mesh.distinct()}
        T = self.tile
        self.stacks = [[[torch.zeros((self.n_local, T, T), dtype=torch.float32,
                                     device=self.grid[d, p])
                         for _ in range(_CHANNELS)]
                        for p in range(self.n_pod)]
                       for d in range(self.n_data)]

    def places(self) -> list:
        """For each pod member ``p``, the distinct devices that read its
        chunk slice (one entry ``(d, p)`` a data member)."""
        return [_distinct(self.grid[:, p]) for p in range(self.n_pod)]

    def pad_coords(self, coords: np.ndarray) -> np.ndarray:
        """``coords`` padded with ``(-1, -1)`` slots to ``n_padded`` rows."""
        pad = self.n_padded - len(coords)
        return np.concatenate([np.asarray(coords, np.int32),
                               np.full((pad, 2), -1, np.int32)])

    def run_group(self, slabs: dict, metas: dict, coords: dict,
                  cfg: CopyConfig, kernel=group_tile_scores) -> None:
        """Launch every entry's share of one staged group.

        ``slabs[p, dev]`` is pod member ``p``'s contiguous (rows, Kp, w)
        int8 chunk slice on ``dev``, ``metas[p, dev]`` its (3, Kp) p̂ / δ /
        non-Ē rows, ``coords[dev]`` the (n_padded, 2) int32 tile list;
        entry ``(d, p)`` runs ``kernel`` (one B1 launch) over slots
        ``[d · n_local, (d + 1) · n_local)`` into its own stacks.
        """
        n = self.n_local
        for d in range(self.n_data):
            for p in range(self.n_pod):
                dev = self.grid[d, p]
                meta = metas[p, dev]
                kernel(slabs[p, dev], self.acc[dev], meta[0], meta[1],
                       meta[2], coords[dev][d * n:(d + 1) * n],
                       self.stacks[d][p], cfg, tile=self.tile)

    def gather(self) -> list:
        """The five ``(n_padded, T, T)`` stacks on the mesh's first device:
        per data member the sum over ``pod`` in the order p = 0, 1, … on
        its first device, then the data members concatenated in order."""
        first = self.grid[0, 0]
        rows = []
        for d in range(self.n_data):
            out = self.stacks[d][0]
            for p in range(1, self.n_pod):
                for c in range(_CHANNELS):
                    out[c] += self.stacks[d][p][c].to(out[c].device)
            rows.append(out)
        if self.n_data == 1:
            return [st.to(first) for st in rows[0]]
        return [torch.cat([r[c].to(first) for r in rows])
                for c in range(_CHANNELS)]


def _stage(mesh_scan: MeshTileScan, v, p_hat, delta, nout, coords):
    """One group's operands placed for ``run_group``: the chunk axis of
    ``v`` cut into ``n_pod`` contiguous slices, each copied once to every
    distinct device that reads it."""
    v = torch.as_tensor(v)
    kp = v.shape[1] // mesh_scan.n_pod
    meta = torch.stack([torch.as_tensor(np.asarray(x, np.float32))
                        for x in (p_hat, delta, nout)])
    coords_t = torch.from_numpy(mesh_scan.pad_coords(coords))
    slabs, metas = {}, {}
    for p, devs in enumerate(mesh_scan.places()):
        for dev in devs:
            slabs[p, dev] = v[:, p * kp:(p + 1) * kp].to(dev).contiguous()
            metas[p, dev] = meta[:, p * kp:(p + 1) * kp].to(dev).contiguous()
    return slabs, metas, {dev: coords_t.to(dev)
                          for dev in mesh_scan.mesh.distinct()}


def _nout_of(nout, K: int) -> np.ndarray:
    return (np.ones(K, np.float32) if nout is None
            else np.asarray(nout, np.float32))


def sharded_tile_scores(
    mesh: Mesh,
    v_skw,                    # (S_pad, K, w) int8 group slab, S_pad % tile == 0
    acc,                      # (S_pad,) accuracies (0.5 in padding rows)
    p_hat,                    # (K,) representative p̂ per chunk
    coords: np.ndarray,       # (n_tiles, 2) int32 surviving (row, col) tiles
    cfg: CopyConfig,
    *,
    tile: int,
    delta: np.ndarray,        # (K,) per-chunk score-error bound δ
    nout: np.ndarray = None,  # (K,) 1.0 ⇔ chunk before the Ē boundary
) -> list:
    """One chunk group over a 1-D mesh: five ``(n_padded, T, T)`` stacks on
    the mesh's first device (C→, C←, shared count, non-Ē count, error
    bound), ``n_padded`` the tile count rounded up to the mesh size.

    ``coords`` (r ≤ c tiles, ``(-1, -1)`` slots skipped) is padded with
    ``(-1, -1)`` and cut into contiguous blocks, one an entry; ``v_skw`` and
    the per-chunk arrays are replicated, one copy a distinct device. Each
    tile's channels equal ``group_tile_scores``'s on one device bit for bit.
    """
    if len(mesh.axis_names) != 1:
        raise ValueError(f"sharded_tile_scores takes a 1-D mesh, got axes "
                         f"{mesh.axis_names}")
    K = torch.as_tensor(v_skw).shape[1]
    scan = MeshTileScan(mesh, len(coords), tile, acc)
    scan.run_group(*_stage(scan, v_skw, p_hat, delta, _nout_of(nout, K),
                           coords), cfg)
    return scan.gather()


def sharded_tile_scores_2d(
    mesh: Mesh,
    v_skw,                    # (S_pad, K, w) int8 group slab, S_pad % tile == 0
    acc,                      # (S_pad,) accuracies (0.5 in padding rows)
    p_hat,                    # (K,) representative p̂ per chunk
    coords: np.ndarray,       # (n_tiles, 2) int32 surviving (row, col) tiles
    cfg: CopyConfig,
    *,
    tile: int,
    delta: np.ndarray,        # (K,) per-chunk score-error bound δ
    nout: np.ndarray = None,  # (K,) 1.0 ⇔ chunk before the Ē boundary
) -> list:
    """One chunk group over a (``data``, ``pod``) mesh: tiles in contiguous
    blocks over ``data``, chunks over ``pod``.

    The chunk axis is padded to a multiple of ``pod`` with inert chunks
    (zero incidence, p̂ 0.5, δ 0, non-Ē flag 0), which add exactly zero to
    every channel; pod member ``p`` scans chunk slice ``p`` (its own
    contiguous slab), and the sum over ``pod`` runs in a fixed order.
    Counts are exact; scores agree with the one-device scan within float32
    round-off. Returns what ``sharded_tile_scores`` returns.
    """
    if len(mesh.axis_names) != 2:
        raise ValueError(f"sharded_tile_scores_2d takes a (data, pod) mesh, "
                         f"got axes {mesh.axis_names}")
    n_pod = mesh.devices.shape[1]
    v = torch.as_tensor(v_skw)
    S_pad, K, w = v.shape
    p_hat = np.asarray(p_hat, np.float32)
    delta = np.asarray(delta, np.float32)
    nout = _nout_of(nout, K)
    kpad = pod_padding(K, n_pod)
    if kpad:
        v = torch.cat([v, torch.zeros((S_pad, kpad, w), dtype=v.dtype,
                                      device=v.device)], dim=1)
        p_hat = np.concatenate([p_hat, np.full(kpad, 0.5, np.float32)])
        delta = np.concatenate([delta, np.zeros(kpad, np.float32)])
        nout = np.concatenate([nout, np.zeros(kpad, np.float32)])
    scan = MeshTileScan(mesh, len(coords), tile, acc)
    scan.run_group(*_stage(scan, v, p_hat, delta, nout, coords), cfg)
    return scan.gather()


# ---------------------------------------------------------------------------
# 2-D pair-space product (the production mesh's SUMMA-like decomposition)
# ---------------------------------------------------------------------------

def _local_pair_scores(vr, vc, acc_r, acc_c, p_hat, s, n):
    """One entry: the C_same→ and shared-count block of its row block
    ``vr`` (S_r, K, w_q) against its column block ``vc`` (S_c, K, w_q),
    accumulated over the K buckets in order, as JAX's ``lax.scan`` does.
    ``p_hat`` (K, w_q) is each bucket's p̂ over its entry slice (JAX's
    layout; p̂ is constant within a bucket). 0/1 counts are exact in
    float32 (sums below 2²⁴)."""
    f_a1 = acc_r[:, None]
    f_a2 = acc_c[None, :]
    c_same = torch.zeros((vr.shape[0], vc.shape[0]), dtype=torch.float32,
                         device=vr.device)
    n_cnt = torch.zeros_like(c_same)
    for k in range(vr.shape[1]):
        count = vr[:, k].to(torch.float32) @ vc[:, k].to(torch.float32).T
        f = score_same(p_hat[k, 0], f_a1, f_a2, s, n)
        c_same = c_same + f * count
        n_cnt = n_cnt + count
    return c_same, n_cnt


def distributed_pair_scores(
    mesh: Mesh,
    v_ksw,                    # (K, S, w) bucketed 0/1 incidence (int8/float)
    p_hat,                    # (K,) (array or tensor, as the two above)
    acc,                      # (S,)
    cfg: CopyConfig,
):
    """The (S, S) C_same→ and shared counts over a (``data``, ``model``) or
    (``pod``, ``data``, ``model``) mesh.

    Rows are cut into contiguous blocks over ``data``, columns over
    ``model``, and the entry width over ``pod`` (zero-padded to a multiple
    of it: zero columns add nothing to a count). Each entry computes its
    block on its device; the partial blocks are summed over ``pod`` in
    order and assembled on the mesh's first device. Returns ``run``, a
    function of nothing giving ``(C_same→, count)``.
    """
    names = mesh.axis_names
    if names not in (("data", "model"), ("pod", "data", "model")):
        raise ValueError(f"distributed_pair_scores takes a (data, model) or "
                         f"(pod, data, model) mesh, got axes {names}")
    grid = mesh.devices if "pod" in names else mesh.devices[None]
    n_pod, n_data, n_model = grid.shape
    v = torch.as_tensor(v_ksw)
    K, S, w = v.shape
    w_pad = pod_padding(w, n_pod)
    if w_pad:
        v = torch.cat([v, torch.zeros((K, S, w_pad), dtype=v.dtype,
                                      device=v.device)], dim=2)
        w += w_pad
    v_skw = v.permute(1, 0, 2)
    acc = torch.as_tensor(acc, dtype=torch.float32)
    p_kw = torch.as_tensor(p_hat, dtype=torch.float32)[:, None].expand(K, w)
    def blocks(n):
        return [(i, slice(int(b[0]), int(b[-1]) + 1))
                for i, b in enumerate(np.array_split(np.arange(S), n))
                if len(b)]
    rows, cols = blocks(n_data), blocks(n_model)
    wq = w // n_pod

    def run():
        """Compute every entry's block and assemble (C_same→, count)."""
        first = grid.flat[0]
        c_out = torch.zeros((S, S), dtype=torch.float32, device=first)
        n_out = torch.zeros_like(c_out)
        for i, r in rows:
            for j, c in cols:
                c_blk = n_blk = None
                for q in range(n_pod):
                    dev = grid[q, i, j]
                    e = slice(q * wq, (q + 1) * wq)
                    cs, nc = _local_pair_scores(
                        v_skw[r][:, :, e].to(dev), v_skw[c][:, :, e].to(dev),
                        acc[r].to(dev), acc[c].to(dev), p_kw[:, e].to(dev),
                        cfg.s, cfg.n)
                    if c_blk is None:
                        c_blk, n_blk = cs, nc
                    else:
                        c_blk = c_blk + cs.to(c_blk.device)
                        n_blk = n_blk + nc.to(n_blk.device)
                c_out[r, c] = c_blk.to(first)
                n_out[r, c] = n_blk.to(first)
        return c_out, n_out

    def lower():
        """The dry run of ``run`` (``distributed_pair_scores_lowerable`` at
        its shapes), without running it."""
        return distributed_pair_scores_lowerable(
            mesh, S, K, w - w_pad, cfg, dtype=v.dtype)

    run.lower = lower
    return run


def distributed_pair_scores_lowerable(mesh, n_sources: int, K: int,
                                      width: int, cfg: CopyConfig,
                                      dtype=torch.int8) -> dict:
    """The dry run of ``distributed_pair_scores`` over (K, ``n_sources``,
    ``width``) incidence of ``dtype`` on ``mesh`` (a ``Mesh``, or any mesh
    ``runtime.sharding.mesh_axes`` reads, as an ``AbstractMesh`` of the
    production shape): shapes only, so the incidence, hundreds of GB at
    the production mesh's 131,072 sources, is never made.

    Returns one entry's record: ``operands``, the shapes of its row block
    ``vr`` (S/data, K, w/pod), column block ``vc`` (S/model, K, w/pod),
    ``acc_r``, ``acc_c`` and ``p_hat`` (K, w/pod) (w padded to a multiple
    of ``pod``, S cut as ``np.array_split`` cuts it: the first block is
    the largest), and ``launch.roofline.analyze_step``'s terms of
    ``_local_pair_scores`` run once on ``meta`` tensors of those shapes,
    with the sum over ``pod``: two all-reduces of (S/data × S/model)
    float32 blocks, JAX's ``psum`` pair. The JAX dry run tallies its
    bucket scan's body once and multiplies by K; the port's body loops
    over every bucket, so its counts need no factor."""
    from repro_torch.launch.roofline import analyze_step
    from repro_torch.runtime.sharding import mesh_axes

    axes = mesh_axes(mesh)
    if tuple(axes) not in (("data", "model"), ("pod", "data", "model")):
        raise ValueError(f"distributed_pair_scores takes a (data, model) or "
                         f"(pod, data, model) mesh, got axes {tuple(axes)}")
    n_pod = axes.get("pod", 1)
    w = width + pod_padding(width, n_pod)
    wq = w // n_pod
    s_r = -(-n_sources // axes["data"])
    s_c = -(-n_sources // axes["model"])

    def meta(*shape, dt=torch.float32):
        return torch.empty(shape, dtype=dt, device="meta")

    ops = {"vr": meta(s_r, K, wq, dt=dtype), "vc": meta(s_c, K, wq, dt=dtype),
           "acc_r": meta(s_r), "acc_c": meta(s_c), "p_hat": meta(K, wq)}
    calls = [("all-reduce", s_r * s_c * 4)] * 2 if n_pod > 1 else []
    out = analyze_step(
        lambda vr, vc, acc_r, acc_c, p: _local_pair_scores(
            vr, vc, acc_r, acc_c, p, cfg.s, cfg.n),
        *ops.values(), chips=int(np.prod(list(axes.values()))),
        collectives=calls)
    del out["result"]
    out["operands"] = {k: tuple(t.shape) for k, t in ops.items()}
    out["dtype"] = str(dtype).replace("torch.", "")
    out["mesh"] = dict(axes)
    return out


__all__ = ["Mesh", "MeshTileScan", "distributed_pair_scores",
           "distributed_pair_scores_lowerable", "group_tile_scores", "make_mesh", "pod_padding",
           "sharded_tile_scores", "sharded_tile_scores_2d"]
