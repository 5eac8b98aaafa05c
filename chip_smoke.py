#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Drives the port's main path — ``repro_torch.core.DetectionEngine(mode=
"bucketed").detect`` — on the card and checks it phase by phase; any failure
exits non-zero. Phases:

  1. the card: ``nvidia-smi`` name and power limit, torch's device name;
  2. build every kernel under ``src/repro_torch/kernels/csrc`` from the
     checkout (seconds, ptxas registers / shared memory / spills);
  3. the copyscore kernel against its plain PyTorch version on the same
     device tensors: rectangular and diagonal tiles (C← == C→ᵀ bit for bit),
     (-1,-1) slots left untouched, w ∈ {8, 40, the full pass's chunk
     width}, Gc ∈ {1, 3}; counts equal, scores within rtol 2e-5 / atol 1e-4;
  4. decisions held against the exact INDEX on the S=512 book-like world,
     at tiles 128 and 256, and at S=2048 under a 1 MiB cap on every
     incidence allocation and group slab, with kernel launches > 0;
  5. the full-size pass: a book-like corpus of 16384 sources × 16384 items,
     default options; stage times, launches (== groups run), device memory,
     recall of the planted copy pairs, and a sample of the pass's groups
     held kernel against plain version;
  6. timing of the kernel at the full pass's shapes (CUDA events) beside
     the plain version, ``torch._int_mm`` of the count product alone, and
     the bound from the kernel's note.

The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``. Needs one card; exits 2 without one.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# the full-size pass: the repo's single-host tier, S = 16384 sources
FULL_SOURCES = 16384
FULL_ITEMS = 16384
# comparisons of the kernel with its plain version
RTOL, ATOL = 2e-5, 1e-4
# H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s, int8 tensor-core
# op/s, float32 op/s outside the tensor cores
HBM_BPS = 3.35e12
INT8_OPS = 1.979e15
F32_OPS = 67e12
# float32 operations the kernel does per pair and chunk after the count
# product: pr_ind (9), f→ and f← (9 each), the five accumulations (10)
F32_PER_PAIR_CHUNK = 37


def log(msg: str) -> None:
    print(msg, flush=True)


def _group_inputs(rng, torch, dev, T, nb, Gc, w):
    """A random group slab and its operands, on ``dev``; the tile list holds
    every r ≤ c tile of an nb×nb grid plus one (-1,-1) slot."""
    S_pad = nb * T
    gen = torch.Generator().manual_seed(int(rng.integers(1 << 31)))
    v = (torch.rand((S_pad, Gc, w), generator=gen) < 0.05).to(torch.int8)
    acc = torch.empty(S_pad).uniform_(0.35, 0.95, generator=gen)
    p = torch.empty(Gc).uniform_(0.01, 0.99, generator=gen)
    d = torch.empty(Gc).uniform_(0.0, 0.2, generator=gen)
    m = (torch.rand(Gc, generator=gen) < 0.7).to(torch.float32)
    live = [[r, c] for r in range(nb) for c in range(r, nb)]
    coords = torch.tensor(live[:1] + [[-1, -1]] + live[1:], dtype=torch.int32)
    return [x.to(dev) for x in (v, acc, p, d, m, coords)]


def _compare_group(torch, ops, ref, v, acc, p, d, m, coords, T, cfg):
    """Kernel vs plain version on one group from stacks of 0.25 (so the
    in-place add is checked too). Returns the max |Δ| over the score
    channels; raises on any disagreement."""
    n = coords.shape[0]
    st_k = [torch.full((n, T, T), 0.25, device=v.device) for _ in range(5)]
    st_r = [s.clone() for s in st_k]
    ops.tile_scores(v, acc, p, d, m, coords, st_k, tile=T, s=cfg.s,
                    n_false=cfg.n)
    torch.cuda.synchronize()
    ref.tile_scores_torch(v, acc, p, d, m, coords, st_r, tile=T, s=cfg.s,
                          n_false=cfg.n)
    torch.cuda.synchronize()
    for c, name in ((2, "n"), (3, "n_out")):
        if not torch.equal(st_k[c], st_r[c]):
            raise AssertionError(f"count channel {name} differs")
    worst = 0.0
    for c in (0, 1, 4):
        torch.testing.assert_close(st_k[c], st_r[c], rtol=RTOL, atol=ATOL)
        worst = max(worst, float((st_k[c] - st_r[c]).abs().max()))
    cl = coords.cpu().tolist()
    for i, (r, c) in enumerate(cl):
        if r < 0:
            if not all(bool((s[i] == 0.25).all()) for s in st_k):
                raise AssertionError("a (-1,-1) slot was written")
        elif r == c and not torch.equal(st_k[1][i], st_k[0][i].T):
            raise AssertionError("diagonal tile: C← != C→ᵀ bit for bit")
    return worst


def _time_ms(torch, fn, reps: int) -> float:
    """Mean milliseconds of ``fn`` over ``reps`` runs, CUDA events, after one
    warm-up run."""
    fn()
    torch.cuda.synchronize()
    a, z = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    z.record()
    torch.cuda.synchronize()
    return a.elapsed_time(z) / reps


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 2
    import numpy as np

    from repro_torch.core import (
        CopyConfig,
        DetectionEngine,
        EngineOptions,
        build_index,
        index_detect_exact,
    )
    from repro_torch.data.claims import (
        SyntheticSpec,
        oracle_claim_probs,
        synthetic_claims,
    )
    from repro_torch.kernels import _build, ops, ref

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    cfg = CopyConfig()
    rng = np.random.default_rng(0)

    # -- 1. the card ---------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    card = smi.splitlines()[0] if smi else "unknown"
    kind = torch.cuda.get_device_name(0)
    log(card)                                  # as nvidia-smi prints it
    log(f"[1] torch {torch.__version__} cuda {torch.version.cuda} device {kind} "
        f"count {torch.cuda.device_count()}")

    # -- 2. build ------------------------------------------------------------
    t0 = time.perf_counter()
    built = _build.build_all()
    log(f"[2] build: {time.perf_counter() - t0:.3f} s for {sorted(built)}")
    for name, info in built.items():
        log(f"[2] {name}: nvcc {info['seconds']:.3f} s cached={info['cached']}")
        for line in info["ptxas"].splitlines():
            log(f"[2]   {line.strip()}")

    # -- 3. kernel vs plain, synthetic groups --------------------------------
    w_full = EngineOptions().chunk_group_bytes // FULL_SOURCES
    worst = 0.0
    for T, nb, Gc, w in ((256, 3, 1, 8), (256, 3, 3, 40), (96, 3, 3, 40),
                         (256, 2, 1, w_full)):
        ops.tile_scores.launches = 0
        args = _group_inputs(rng, torch, dev, T, nb, Gc, w)
        err = _compare_group(torch, ops, ref, *args, T, cfg)
        if ops.tile_scores.launches != 1:
            raise AssertionError("the kernel wrapper did not launch once")
        worst = max(worst, err)
        log(f"[3] T={T} tiles={nb * (nb + 1) // 2}+1 pad Gc={Gc} w={w}: "
            f"counts equal, max |Δ| scores {err:.3e}, diagonal bit-exact, "
            f"pad slot untouched")

    # -- 4. decisions against the exact INDEX at S=512 ------------------------
    spec512 = SyntheticSpec(n_sources=512, n_items=1536, coverage="book",
                            n_cliques=14, clique_size=3, clique_items=12,
                            seed=0)
    sc = synthetic_claims(spec512)
    p512 = oracle_claim_probs(sc)
    idx512 = build_index(sc.dataset, p512, cfg, device=dev)
    exact = index_detect_exact(sc.dataset, p512, cfg, index=idx512)
    for tile in (128, 256):
        eng = DetectionEngine(cfg, tile=tile)
        res = eng.detect(sc.dataset, p512, index=idx512)
        if not np.array_equal(res.copying, exact.copying):
            raise AssertionError(f"S=512 tile {tile}: decisions != exact INDEX")
        if eng.last_stats["kernel_launches"] <= 0:
            raise AssertionError("S=512: the pass launched no kernel")
        log(f"[4] S=512 tile={tile}: decisions == exact INDEX "
            f"({len(exact.copying_pairs())} copying pairs), launches "
            f"{eng.last_stats['kernel_launches']}, tiles "
            f"{eng.last_stats['tiles_kept']}/{eng.last_stats['tiles_total']}")
    # S=2048 under a 1 MiB cap on every incidence allocation and group slab
    cap = 1 << 20
    sc = synthetic_claims(SyntheticSpec(
        n_sources=2048, n_items=3072, coverage="book", n_cliques=50,
        clique_size=3, clique_items=12, seed=0))
    p2k = oracle_claim_probs(sc)
    idx2k = build_index(sc.dataset, p2k, cfg, chunk_bytes=cap, device=dev)
    largest = max(c.nbytes for c in idx2k.store.chunks)
    if idx2k.store.n_chunks < 2 or largest > cap:
        raise AssertionError(f"S=2048 build: {idx2k.store.n_chunks} chunks, "
                             f"largest {largest} B over the {cap} B cap")
    exact = index_detect_exact(sc.dataset, p2k, cfg, index=idx2k)
    eng = DetectionEngine(cfg, tile=256, chunk_group_bytes=cap)
    res = eng.detect(sc.dataset, p2k, index=idx2k)
    st = eng.last_stats
    if (not np.array_equal(res.copying, exact.copying)
            or st["peak_group_bytes"] > cap or st["kernel_launches"] <= 0):
        raise AssertionError("S=2048 under the 1 MiB cap: decisions differ "
                             "from the exact INDEX or the cap was exceeded")
    log(f"[4] S=2048 1 MiB cap: decisions == exact INDEX "
        f"({len(exact.copying_pairs())} copying pairs), largest build chunk "
        f"{largest} B, group slab {st['peak_group_bytes']} B, launches "
        f"{st['kernel_launches']}")

    # -- 5. the full-size pass ------------------------------------------------
    spec = SyntheticSpec(n_sources=FULL_SOURCES, n_items=FULL_ITEMS,
                         coverage="book", n_cliques=200, clique_size=3,
                         clique_items=12, seed=0)
    t0 = time.perf_counter()
    sc = synthetic_claims(spec)
    ds, p = sc.dataset, oracle_claim_probs(sc)
    log(f"[5] data: S={ds.n_sources} D={ds.n_items} claims="
        f"{int((ds.values >= 0).sum())} in {time.perf_counter() - t0:.3f} s")
    t0 = time.perf_counter()
    index = build_index(ds, p, cfg, device=dev)
    build_s = time.perf_counter() - t0
    log(f"[5] index build: {build_s:.3f} s, E={index.n_entries} "
        f"store chunks={index.store.n_chunks}")
    eng = DetectionEngine(cfg)
    torch.cuda.reset_peak_memory_stats()
    ops.tile_scores.launches = 0              # count the main path's launches
    t0 = time.perf_counter()
    res = eng.detect(ds, p, index=index)
    detect_s = time.perf_counter() - t0
    launches = ops.tile_scores.launches
    st = eng.last_stats
    if launches <= 0 or launches != st["groups_run"]:
        raise AssertionError(f"launches {launches} != groups run "
                             f"{st['groups_run']}")
    S = ds.n_sources
    if res.c_fwd.shape != (S, S) or not np.isfinite(res.c_fwd).all():
        raise AssertionError("C→ is not a finite (S, S) matrix")
    if not (np.array_equal(res.copying, res.copying.T)
            and not res.copying.diagonal().any()):
        raise AssertionError("decisions are not symmetric with an empty diagonal")
    found = res.copying_pairs()
    recall = len(found & sc.copies) / len(sc.copies)
    log(f"[5] detect: {detect_s:.3f} s; E={res.counter.index_entries} "
        f"K={st['chunks']} w={st['chunk_width']} tiles "
        f"{st['tiles_kept']}/{st['tiles_total']} chunk_tiles_run="
        f"{st['chunk_tiles_run']} launches={launches}")
    log(f"[5] stages (s): index build {build_s:.3f}, prologue "
        f"{st['prologue_s']:.3f}, scan {st['scan_s']:.3f} (kernel device time "
        f"{st['scan_kernel_ms']:.3f} ms over {launches} launches), finalize "
        f"{st['finalize_s']:.3f} of which rescore {st['rescore_s']:.3f} "
        f"({st['rescored_pairs']} pairs)")
    log(f"[5] max device memory {torch.cuda.max_memory_allocated() / 2**30:.3f} "
        f"GiB; pairs considered {res.counter.pairs_considered}; copying "
        f"{len(found)}; planted recall {recall:.4f} "
        f"({len(found & sc.copies)}/{len(sc.copies)})")
    if recall < 0.9:
        raise AssertionError(f"planted-pair recall {recall:.4f} < 0.9")

    # sample of the pass's own groups, kernel vs plain version
    ctx = eng._tiled_prologue(ds, p, index)
    groups = eng._scan_groups(ctx)
    host = torch.empty((ctx.S_pad, ctx.Gc, ctx.ech.width), dtype=torch.int8,
                       pin_memory=True)
    T = ctx.T
    acc = torch.from_numpy(ctx.acc_pad).to(dev)
    for gi in sorted({0, len(groups) // 2, len(groups) - 1}):
        ks, gmask = groups[gi]
        v, p_g, d_g, o_g, coords_g = eng._stage_group(ctx, ks, gmask, host)
        err = _compare_group(torch, ops, ref, v, acc, p_g, d_g, o_g, coords_g,
                             T, cfg)
        worst = max(worst, err)
        log(f"[5] group {gi} (chunks {ks}): {int(gmask.sum())} live tiles, "
            f"kernel == plain (counts equal, max |Δ| scores {err:.3e})")

    # -- 6. timing at the full pass's shapes ----------------------------------
    ks, gmask = groups[len(groups) // 2]
    v, p_g, d_g, o_g, coords_g = eng._stage_group(ctx, ks, gmask, host)
    n = coords_g.shape[0]
    stacks = [torch.zeros((n, T, T), device=dev) for _ in range(5)]
    args = (v, acc, p_g, d_g, o_g, coords_g, stacks)
    kw = dict(tile=T, s=cfg.s, n_false=cfg.n)
    ms = _time_ms(torch, lambda: ops.tile_scores(*args, **kw), 10)
    plain_ms = _time_ms(torch, lambda: ref.tile_scores_torch(*args, **kw), 2)
    v2 = v.reshape(ctx.S_pad, -1)
    int_mm_ms = _time_ms(torch, lambda: torch._int_mm(v2, v2.t()), 5)
    live = int(gmask.sum())
    Gc, w = ctx.Gc, ctx.ech.width
    nbytes = v.numel() + live * 5 * 4 * T * T * 2
    int8_ops = live * 2 * T * T * w * Gc
    f32_ops = live * T * T * Gc * F32_PER_PAIR_CHUNK
    t_bytes, t_i8, t_f32 = (nbytes / HBM_BPS * 1e3, int8_ops / INT8_OPS * 1e3,
                            f32_ops / F32_OPS * 1e3)
    bound_ms = max(t_bytes, t_i8, t_f32)
    bound_by = "bytes" if bound_ms == t_bytes else "operations"
    log(f"[6] one group at the full pass's shapes: {live} live tiles of "
        f"{T}x{T}, Gc={Gc}, w={w}, slab {tuple(v.shape)} ({card})")
    log(f"[6] kernel {ms:.4f} ms; plain version {plain_ms:.4f} ms; bound "
        f"{bound_ms:.4f} ms by {bound_by} (bytes {t_bytes:.4f} ms for "
        f"{nbytes} B, int8 {t_i8:.4f} ms, f32 {t_f32:.4f} ms)")
    log(f"[6] torch._int_mm {int_mm_ms:.4f} ms — count product only, not the "
        f"fused function (the full {ctx.S_pad}^2 square, w·Gc={w * Gc})")
    log(f"[6] full pass: {launches} launches, kernel device time "
        f"{st['scan_kernel_ms']:.3f} ms; bound × launches "
        f"{bound_ms * launches:.3f} ms")
    for x in (ms, plain_ms, int_mm_ms, bound_ms):
        if not math.isfinite(x) or x <= 0:
            raise AssertionError("a timing is not a positive number")

    record = {"kernels": [{
        "name": "copyscore_fused",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/copyscore_fused.cu",
        "replaces": "src/repro/kernels/copyscore.py:192",
        "launches": launches,
        "max_abs_err": worst,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
    }]}
    print(json.dumps(record), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
