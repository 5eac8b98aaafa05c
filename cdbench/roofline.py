"""The card's published peaks and B1's least time from its shapes.

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at its 700 W
limit): HBM 3.35 TB/s, int8 tensor cores 1,979 TOP/s, float32 outside the
tensor cores 67 TFLOP/s.

B1 (the fused dual-direction copyscore of a detection pass's tile scan)
runs once per chunk group over the group's surviving tiles. One launch on
a (S_pad, Gc, w) int8 slab and ``live`` tiles of T × T pairs needs:

* bytes: the slab read once, and the five float32 (T, T) channels of each
  tile read and written once: S_pad·Gc·w + live·5·4·T²·2;
* int8 operations: the count product, 2·T²·w per tile and chunk;
* float32 operations: ``F32_PER_PAIR_CHUNK`` per pair and chunk after the
  product (Pr(⊥) 9, f→ and f← 9 each, the five accumulations 10).

Over a pass, with ``chunk_tiles_run`` = Σ over groups of live tiles × the
group's chunks (the program's counter), the sums are S_pad·Gc·w per
launch, 2·T²·w·chunk_tiles_run and 37·T²·chunk_tiles_run; the channel
traffic is 5·4·T²·2 per live tile a launch, chunk_tiles_run / Gc live
tiles a launch summed (exact when every group holds Gc chunks, as with the
default of one chunk a group).
"""
from __future__ import annotations

HBM_BPS = 3.35e12
INT8_OPS = 1.979e15
F32_OPS = 67e12
F32_PER_PAIR_CHUNK = 37
CHANNELS = 5


def b1_bound(s_pad: int, gc: int, w: int, tile: int, launches: int,
             chunk_tiles_run: int) -> tuple:
    """(bytes, int8 operations, float32 operations) of ``launches`` B1
    launches on (s_pad, gc, w) slabs that ran ``chunk_tiles_run`` tile ×
    chunk products in all."""
    tt = tile * tile
    nbytes = (launches * s_pad * gc * w
              + chunk_tiles_run // max(gc, 1) * CHANNELS * 4 * tt * 2)
    return (nbytes, 2 * tt * w * chunk_tiles_run,
            F32_PER_PAIR_CHUNK * tt * chunk_tiles_run)


def b1_pass(stats: dict) -> tuple:
    """``b1_bound`` of one tiled pass, from the engine's ``last_stats``."""
    n = stats["tiles_total"]                    # n_blocks·(n_blocks+1)/2
    n_blocks = int(round(((8 * n + 1) ** 0.5 - 1) / 2))
    return b1_bound(n_blocks * stats["tile"], stats["chunk_group"],
                    stats["chunk_width"], stats["tile"],
                    stats["kernel_launches"], stats["chunk_tiles_run"])


def least_seconds(nbytes: float, int8_ops: float, f32_ops: float) -> tuple:
    """(seconds, "bytes" | "operations"): the larger of the byte time and
    the operation times at the peaks."""
    t_b = nbytes / HBM_BPS
    t_o = max(int8_ops / INT8_OPS, f32_ops / F32_OPS)
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


__all__ = ["F32_OPS", "F32_PER_PAIR_CHUNK", "HBM_BPS", "INT8_OPS",
           "b1_bound", "b1_pass", "least_seconds"]
