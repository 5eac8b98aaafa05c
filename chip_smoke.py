#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Drives the port's paths on the card — the detection pass
``repro_torch.core.DetectionEngine(mode="bucketed").detect``, the batched
detection service ``repro_torch.core.DetectionService`` with its commit
log, snapshots, restore and shard-owner fleet, and the
engine's other modes (``bound``, ``bound+``, ``hybrid``, ``incremental``,
``sampled``, ``sample_verify``), the
full-square and per-tile copyscore (``repro_torch.kernels.ops.copyscore_store``,
``copyscore_tile``), the index's commit/retract path, the row-range shard
plane with the engine's shard-owner fan-out, the LM serving path
``repro_torch.models.Model.prefill`` with
``repro_torch.runtime.ServeLoop``, and the LM training path
``repro_torch.runtime.train`` — and checks them phase by phase; any
failure exits non-zero. Phases 18 and 13–17 run right after phase 6, while
the full pass's store is still in memory; then phase 19, then phases 7–12.
Phases:

  1. the card: ``nvidia-smi`` name and power limit, torch's device name;
  2. build every kernel under ``src/repro_torch/kernels/csrc`` from the
     checkout (seconds, ptxas registers / shared memory / spills);
  3. the copyscore kernel (B1, int8 tensor cores) against its plain
     PyTorch version on the same device tensors: rectangular and diagonal
     tiles (C← == C→ᵀ bit for bit), (-1,-1) slots left untouched, T ∈ {96,
     128, 256}, w ∈ {8, 40, the full pass's chunk width}, Gc ∈ {1, 2, 3}
     (both of B1's variants at the full chunk width); counts equal, scores
     within rtol 2e-5 / atol 1e-4;
  4. decisions held against the exact INDEX on the S=512 book-like world,
     at tiles 128 and 256, and at S=2048 under a 1 MiB cap on every
     incidence allocation and group slab, with kernel launches > 0; at
     S=2048 the scan's four grids at prefetch depths 0 and 2 equal bit for
     bit, and decisions at depth 2 equal the exact INDEX; at S=512
     ``bound``, ``bound+``, ``hybrid`` (with their ``BoundState``) and
     ``sampled`` (rate 0.1) on the card against the same calls with
     ``device="cpu"``: decisions, decided pairs, decision buckets, the
     considered set and the counts equal, scores within rtol 2e-5 / atol
     1e-4;
  5. the full-size pass: a book-like corpus of 16384 sources × 16384 items,
     default options (staging through the prefetcher at depth 2); stage
     times, the staging telemetry (staging, stage wait, compute wait),
     launches (== groups run), device memory, recall of the planted copy
     pairs, and a sample of the pass's groups held kernel against plain
     version;
  6. timing of the kernel at the full pass's shapes (CUDA events) beside
     the plain version, ``torch._int_mm`` of the count product alone over
     the full square and over exactly the live r ≤ c tiles (one call per
     row block, the same work), and the bound computed from the shapes;
     the int8 rate B1 executes, its ptxas registers, spills and shared
     memory and resident blocks an SM; two launches bit-equal;
  7. the flash-attention kernel against its plain PyTorch version on the
     card: MHA, GQA (group 4), MQA, causal and not, windows 32 and 100,
     head_dim 64 and 128, float32 (CUDA cores) and bfloat16 (tensor cores,
     P split into bf16 hi + lo), ragged Sq = Sk = 1000, Sq != Sk, and
     causal Sq = 300, Sk = 428 (no multiple of the 128-row tiles); o and
     lse within the stated tolerances, and o == 1 for an all-ones v;
  8. the LM slice at full Llama-3.2-1B width (16 layers, d_model 2048,
     random weights from seed 0 on the card): ``Model.prefill`` of 8
     prompts × 2048 tokens in bfloat16 through the kernel (one launch per
     layer), held against the same prefill with the plain reference
     attention in float32 and with the kernel in float32; then a
     ``ServeLoop`` of 4 slots answers 8 requests (prompts of 64–512
     tokens, 32 new tokens each) in float32, each first token equal to
     the argmax of ``Model.prefill`` on its prompt, and again in the
     config's bfloat16 with a bfloat16 KV cache, each first token's
     bfloat16 prefill logit within a stated gap of the maximum; prefill and
     decode tokens/s and peak device memory of each;
  9. timing of the flash-attention kernel at the prefill's shapes (B=8,
     Hq=32, Hkv=8, S=2048, D=64, bf16, causal) beside the plain version,
     ``F.scaled_dot_product_attention`` (timed only; the port never calls
     it) and the bound computed from the shapes; beside the bound, the
     tensor operations the bf16 kernel does with the split, and its ptxas
     registers, spills and shared memory and resident blocks an SM;
 10. the two flash-attention backward kernels (dq; dk/dv) against their
     plain versions on every case of phase 7 in float32 and bfloat16, rows
     with nothing visible (zero gradients, no NaN), and the
     ``FlashAttention`` Function's gradient against autograd of the
     reference attention;
 11. the LM training slice at full Llama-3.2-1B width: (a) the gradient of
     ``Model.loss`` on 1 × 512 tokens through the kernels against the
     reference attention, both float32 (relative error per leaf), and the
     bf16 kernel path against the same reference (cosine); (b)
     ``runtime.train`` — the entry point of ``launch/train.py`` — for a
     few steps of 4 × 2048 tokens (float32 parameters, bf16 compute,
     ``remat``, AdamW) on one fixed batch: step-0 loss in a stated band,
     the last loss lower by a stated margin, the kernels' launches per
     step asserted, step time, tokens/s and peak device memory;
 12. timing of the backward kernels at the training step's shapes (B=4,
     Hq=32, Hkv=8, S=2048, D=64, bf16, causal) beside their plain versions
     and the backward of ``F.scaled_dot_product_attention`` (timed only),
     with their bounds; the forward at the same shapes; the kernels' share
     of a training step and the step's model-FLOP share of the bf16 peak;
     the dq and dk/dv kernels' tensor operations with the split beside
     their bounds and the rates they execute, and their ptxas registers,
     spills and shared memory and resident blocks an SM;
 13. the single-direction copyscore kernel (B3, and B2 with the error
     channel) against its plain version: full squares through
     ``ops.copyscore`` and ragged rectangles (100 × 37, 64 × 130) through
     ``ops.copyscore_tile`` with and without δ, block_e ∈ {8, 40, 512,
     4096}; counts equal, scores within rtol 2e-5 / atol 1e-4; and on one
     chunk of the full pass's width, B3's full square equal to B1's
     scattered C→/C← grid bit for bit;
 14. ``ops.copyscore_store`` over phase 5's engine store (16384 sources,
     chunks of 4096): seconds, launches (== chunks with a live entry),
     device ms and peak memory; a sample of chunks against the plain
     version; on the S=2048 world, the full square's counts equal to the
     engine's scan grid on its kept tiles and C→ within the tolerance; B3's
     timing per launch beside the plain version, ``torch._int_mm`` of the
     count product alone and the bound computed from the shapes, the int8
     rates both execute, and B3's ptxas registers, spills and shared memory
     and resident blocks an SM;
 15. the legacy per-ordered-tile dataflow (B2 on each of the 64 ordered
     tiles plus a separate non-Ē count product) against the fused one (B1
     over the 36 unordered tiles) at the JAX kernel bench's settings (the
     S=2048 world, tile 256, 64 buckets from ``bucketize_engine``,
     ``pad_buckets`` int8): grids agree, both times and their ratio; B2 at
     one tile's shapes against its plain version (counts equal, C→ and err
     within rtol 2e-5 / atol 1e-4), two launches bit-equal, its time a call
     (the record's) and on the card alone beside its bound and
     ``torch._int_mm`` of the tile's count product (the same product,
     without the epilogue) timed both ways, the int8 rates, B2's ptxas
     report and resident blocks an SM;
 16. the mutation path at S=512: commits of 8 and 32 rows, a retraction,
     its rollback, the retraction again, a commit of 4 rows rolled back and
     a compaction; one bucketed engine on the card follows every step
     through its block-OR mask cache (``apply_mask_delta``;
     ``undo_mask_delta`` after the commit's rollback restores the cache bit
     for bit), takes its tile masks from the cache wherever the deltas
     chain, and decides like the exact INDEX over a rebuild; and
     ``copyscore_store`` over the committed store (delta and all-padding
     chunks included) counts like its dense V·Vᵀ with one launch per chunk
     with a live entry;
 17. the other modes at the full pass's width, on phase 5's corpus, index
     and decisions (which equal the exact INDEX): (a) the ``incremental``
     bootstrap (HYBRID) with F ≥ 0.97 against phase 5, its stage seconds,
     rescored pairs, bound computations, shared values examined and peak
     memory; (b) one incremental round on p perturbed by N(0, 0.01) from
     seed 1, F ≥ 0.95 against a ``bucketed`` pass on the perturbed p, with
     its pass-1 settled share and seconds; (c) ``sample_verify`` at rate
     0.1 (SCALESAMPLE): B1's launches on the sampled pass, every candidate
     deciding as phase 5 does and no pair outside the candidates copying,
     the candidates, sweep rounds, recall of phase 5's copying pairs and
     the seconds of each stage;
 18. the row-range shard plane on phase 5's corpus: (a) its own index,
     built with the streaming seal (4 owners, bitpacked, spilled under a cap
     of half an owner's packed slice in a temporary directory), the owner
     fan-out (``owner_scan_context``, four ``detect_owner_partial``,
     ``merge_owner_partials``) with the tile list and the four merged grids
     equal to phase 5's unsharded scan bit for bit; (b) every owner's peak
     resident bytes below a quarter of the unsharded stores'; (c) the index
     build, the owner scans, the staging, the stage waits and the merge in
     seconds, B1's launches and device ms on the path, the spill traffic
     and the peak device memory; (d) at S=2048 under the same options, all
     nine modes with 2 and 4 shards deciding like the unsharded card run,
     and ``bucketed`` like the exact INDEX;
 19. the detection service at the repo's Book-full preset
     (``book_full_spec``: 3182 sources × 20,000 items, the CLI's
     ``CopyConfig(alpha=0.1, s=0.8, n=50.0)``): (a) 32 requests of 4 query
     rows (``synthetic_query_rows``, seed 1) through the worker thread of a
     durable bucketed ``DetectionService`` (batches of ≤ 8, snapshots every
     4 commits, ``fsync="commit"``), every response deciding like one
     ``index_detect_exact`` over the corpus plus the 128 rows; req/s,
     latency and queue-wait percentiles, passes and mean batch, B1's
     launches and device ms from each pass's ``last_stats``, the transient
     commit and rollback seconds and peak memory; (b) the wave's accepted
     rows (as the CLI commits them) and 16 new independent sources
     committed, the wave re-served: cache hits > 0, every response equal
     to a cache-free service restored from the state dir; commit ms,
     snapshot seconds and bytes, the restore receipt and replay rate; (c) a
     child process restores the state dir and commits batches one by one,
     is SIGKILLed after its third acknowledgement; the restore holds every
     acknowledged commit's rows bit for bit and decides like a
     never-restarted twin; (d) a retraction of the 16 newest rows decides
     like a fresh service over the retracted corpus, and its rollback like
     before it; (e) the wave's first 8 requests through a 4-owner packed
     ``ReplicaRouter`` fleet (one fan-out pass a request, ~4.5 s each)
     decide like (a), B1's launches an owner and the fleet's req/s.

The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``. Needs one card; exits 2 without one, and
exits 2 with a message where the checkout's ``src/repro_torch`` is missing
(the script copied alone into an empty directory).
"""
from __future__ import annotations

import gc
import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# the full-size pass: the repo's single-host tier, S = 16384 sources
FULL_SOURCES = 16384
FULL_ITEMS = 16384
# the S=512 world of phases 4 and 16, and the S=2048 world of phases 4, 14
# and 15: the JAX package's scaling specs (benchmarks/datasets.py:38,
# SCALING_SPECS), copied here, since the script imports nothing of it
WORLD_512 = dict(n_sources=512, n_items=1536, coverage="book", n_cliques=14,
                 clique_size=3, clique_items=12, seed=0)
WORLD_2048 = dict(n_sources=2048, n_items=3072, coverage="book", n_cliques=50,
                  clique_size=3, clique_items=12, seed=0)
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
# the same for the single-direction kernel per pair and entry block: pr_ind
# (9), f→ (9), C→ and n (3); the error channel adds 2
F32_PER_PAIR_BLOCK = {"copyscore": 21, "copyscore_err": 23}
# B2/B3 against their plain version (phase 13): entry-block widths; the full
# square of COPYSCORE_SQUARE sources through ops.copyscore, and ragged
# rectangles (rows × columns) through ops.copyscore_tile with and without δ
COPYSCORE_BLOCK_E = (8, 40, 512, 4096)
COPYSCORE_SQUARE = 200
COPYSCORE_RECTS = ((100, 37), (64, 130))
# the legacy per-ordered-tile dataflow against the fused one (phase 15), at
# the JAX package's kernel-bench settings (benchmarks/run.py:672-767)
LEGACY_TILE, LEGACY_BUCKETS = 256, 64
# its CPU numbers (BENCH_kernel.json: "backend": "cpu"), quoted beside ours
LEGACY_CPU_SPEEDUPS = "1.26x (int8) and 1.49x (f32)"
# the mutation schedule (phase 16): corpus rows before the commits, commit
# sizes, store chunk width, and the committed rows retracted again
MUTATION_BASE_ROWS = 472
MUTATION_COMMITS = (8, 32)
MUTATION_CHUNK = 8
# bf16 tensor-core op/s (dense), the rate the attention's products bound
BF16_OPS = 989e12
# flash attention, kernel vs plain version (tests/test_kernels_flash.py's):
# float32 o and lse 2e-5; bfloat16 o 2e-2 (one bf16 rounding of O(1)
# entries); lse is float32 arithmetic on the same inputs in both dtypes
FLASH_F32_TOL = dict(rtol=2e-5, atol=2e-5)
FLASH_BF16_TOL = dict(rtol=2e-2, atol=2e-2)
# (name, B, Hq, Hkv, Sq, Sk, D, causal, window)
FLASH_CASES = [
    ("MHA", 2, 8, 8, 512, 512, 64, True, None),
    ("GQA group 4", 2, 32, 8, 512, 512, 64, True, None),
    ("MQA", 2, 8, 1, 512, 512, 64, True, None),
    ("non-causal", 2, 8, 2, 384, 384, 64, False, None),
    ("window 32", 1, 8, 2, 512, 512, 64, True, 32),
    ("window 100", 1, 8, 2, 512, 512, 64, True, 100),
    ("head_dim 128", 2, 8, 2, 512, 512, 128, True, None),
    ("head_dim 128 window 100", 1, 8, 2, 512, 512, 128, True, 100),
    ("ragged Sq=Sk=1000", 1, 8, 2, 1000, 1000, 64, True, None),
    ("ragged Sq=100 Sk=37 non-causal", 1, 4, 2, 100, 37, 128, False, None),
    ("causal Sq=300 Sk=428", 1, 8, 2, 300, 428, 64, True, None),
]
# Llama-3.2-1B prefill (phase 8) and the kernel's timing shapes (phase 9)
PREFILL_BATCH, PREFILL_LEN = 8, 2048
# bf16 compute against the float32 reference, last-position logits (std
# ≈ 0.9): bf16 keeps 8 significant bits and rounds a few times per op, so
# over 16 layers the normalized final state drifts by ~1–2 % and the
# logits by ~0.02 on average, ~0.1 at most over 8 × 128256 of them; the
# bounds leave 2.5–3× headroom
BF16_LOGITS_MAX, BF16_LOGITS_MEAN = 0.3, 0.05
# the kernel against the plain reference, both in float32: the attention's
# summation order only
F32_LOGITS_MAX = 1e-3
SERVE_PROMPT_LENS = (64, 512, 128, 384, 96, 448, 256, 200)
SERVE_NEW_TOKENS, SERVE_SLOTS = 32, 4
# bf16 serving against the bf16 prefill of the same prompt: both round to
# bf16 at every op but in different orders (one token a step against the
# whole prompt), so their logits differ by as much as bf16 against float32
# does; the first served token's prefill logit must lie within this gap of
# the prefill's maximum
SERVE_BF16_LOGIT_GAP = BF16_LOGITS_MAX
# flash backward, kernels vs plain versions. float32: both sum in float32,
# in another order, over up to group·Sq ≈ 4,000 terms (dk, dv) whose
# magnitudes exceed the result where ds changes sign, so the difference is
# a few 1e-6 of the largest entries (≈ 10); bfloat16: one bf16 rounding of
# each gradient (2⁻⁸ relative) on top, as for the forward's o
FLASH_BWD_F32_TOL = dict(rtol=1e-4, atol=1e-4)
FLASH_BWD_BF16_TOL = dict(rtol=2e-2, atol=2e-2)
# the Function (three kernels) against autograd of attention_ref, float32:
# autograd differentiates through the normalised softmax, not from lse
FLASH_GRAD_TOL = dict(rtol=1e-4, atol=1e-4)
# rows with nothing visible: Sq > Sk under a causal window
EMPTY_ROWS_CASE = ("empty rows", 1, 4, 2, 128, 64, 64, True, 16)
# Llama-3.2-1B training (phase 11)
GRAD_BATCH, GRAD_LEN = 1, 512
# the kernel path against the reference attention, both float32: the
# prefill's logits agreed within 2e-5 of std 0.9 (phase 8); the backward
# repeats that rounding once more per layer, so per-leaf relative errors
# (‖Δg‖ / ‖g‖) of ~1e-5 are expected; the bound leaves ~100×
GRAD_F32_REL_MAX = 1e-3
# the bf16 kernel path against the float32 reference: bf16 keeps 8 bits,
# so each gradient entry carries a few-% relative error; for independent
# errors ε the cosine is ≈ 1 − ε²/2 ≈ 0.999, the bound allows ε ≈ 0.14
GRAD_BF16_COS_MIN = 0.99
TRAIN_BATCH, TRAIN_LEN, TRAIN_STEPS, TRAIN_WARMUP = 4, 2048, 8, 2
TRAIN_PEAK_LR = 3e-4                 # the default of runtime.train
# step-0 loss: logits x·e_v of a unit-RMS state and embeddings of std 0.02
# have std ≈ 0.02·√2048 ≈ 0.9, so the loss ≈ ln 128256 + σ²/2 ≈ 12.17
TRAIN_LOSS0_BAND = (11.5, 12.8)
# the last step's loss below the first by at least this much
TRAIN_LOSS_DROP_MIN = 0.5


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


def _device_ms(torch, fn, reps: int) -> float:
    """Mean milliseconds of ``fn`` on the card alone, CUDA events, after one
    warm-up run: the card first sleeps ~1 ms a run (``torch.cuda._sleep``
    of 2e6 cycles at the H100's ~2 GHz) while the host enqueues the runs,
    so the host's time between launches of a short kernel is not counted."""
    fn()
    torch.cuda.synchronize()
    a, z = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(2e6 * reps))
    a.record()
    for _ in range(reps):
        fn()
    z.record()
    torch.cuda.synchronize()
    return a.elapsed_time(z) / reps


def _flash_inputs(torch, dev, seed, B, Hq, Hkv, Sq, Sk, D, dtype):
    gen = torch.Generator(device=dev).manual_seed(seed)
    shapes = ((B, Hq, Sq, D), (B, Hkv, Sk, D), (B, Hkv, Sk, D))
    return [torch.randn(s, generator=gen, device=dev).to(dtype) for s in shapes]


def _compare_flash(torch, ops, ref, q, k, v, causal, window):
    """Kernel vs plain version on one input, plus the all-ones-v invariant.
    Returns (max |Δo|, max |Δlse|); raises on any disagreement."""
    o, lse = ops.flash_attention_fwd(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    o_p, lse_p = ref.flash_attention_fwd_torch(q, k, v, causal=causal,
                                               window=window)
    tol = FLASH_F32_TOL if q.dtype == torch.float32 else FLASH_BF16_TOL
    torch.testing.assert_close(o.float(), o_p.float(), **tol)
    torch.testing.assert_close(lse, lse_p, **FLASH_F32_TOL)
    ones, _ = ops.flash_attention_fwd(q, k, torch.ones_like(v), causal=causal,
                                      window=window)
    torch.cuda.synchronize()
    torch.testing.assert_close(ones.float(), torch.ones_like(ones.float()),
                               rtol=0, atol=1e-5)
    return (float((o.float() - o_p.float()).abs().max()),
            float((lse - lse_p).abs().max()))


def phase_flash_cases(torch, dev, ops, ref) -> float:
    """Phase 7: the flash kernel against its plain version, every case in
    float32 and bfloat16. Returns the worst |Δo|."""
    worst = 0.0
    for i, (name, B, Hq, Hkv, Sq, Sk, D, causal, window) in enumerate(FLASH_CASES):
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = _flash_inputs(torch, dev, i, B, Hq, Hkv, Sq, Sk, D, dtype)
            ops.flash_attention_fwd.launches = 0
            d_o, d_lse = _compare_flash(torch, ops, ref, q, k, v, causal, window)
            if ops.flash_attention_fwd.launches != 2:
                raise AssertionError("the flash wrapper did not launch twice")
            worst = max(worst, d_o)
            log(f"[7] {name} {str(dtype)[6:]} (B={B} Hq={Hq} Hkv={Hkv} Sq={Sq} "
                f"Sk={Sk} D={D}): max |Δo| {d_o:.3e}, max |Δlse| {d_lse:.3e}, "
                f"all-ones v → 1")
    return worst


def _argmax_rows(torch, logits):
    return torch.argmax(logits, dim=-1).cpu().tolist()


def phase_llama(torch, np, dev, ops) -> dict:
    """Phase 8: the LM slice at full Llama-3.2-1B width. Returns the main
    path's launches and the prefill's seconds."""
    from repro_torch.configs import get_config
    from repro_torch.models import Model
    from repro_torch.runtime import Request, ServeLoop

    cfg = get_config("llama3.2-1b")
    model = Model(cfg)
    t0 = time.perf_counter()
    params = model.init(seed=0)
    torch.cuda.synchronize()
    n_params = sum(int(t.numel()) for t in _tree_leaves(params))
    log(f"[8] {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.n_heads}/{cfg.n_kv_heads} heads of {cfg.resolved_head_dim}, "
        f"d_ff {cfg.d_ff}, vocab {cfg.vocab_size}; {n_params} parameters "
        f"({cfg.param_dtype}) drawn on the card in {time.perf_counter() - t0:.3f} s")
    rng = np.random.default_rng(1)
    prompts = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                            (PREFILL_BATCH, PREFILL_LEN)))
    model.prefill(params, prompts[:1, :128])           # warm-up: cuBLAS, kernel
    torch.cuda.synchronize()

    # the main path: bf16 prefill through the kernel
    torch.cuda.reset_peak_memory_stats()
    ops.flash_attention_fwd.launches = 0
    t0 = time.perf_counter()
    logits = model.prefill(params, prompts)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    launches = ops.flash_attention_fwd.launches
    prefill_peak = torch.cuda.max_memory_allocated()
    if launches != cfg.n_layers:
        raise AssertionError(f"prefill launched the flash kernel {launches} "
                             f"times, not once per layer ({cfg.n_layers})")
    if tuple(logits.shape) != (PREFILL_BATCH, cfg.vocab_size) \
            or not bool(torch.isfinite(logits).all()):
        raise AssertionError("prefill logits are not a finite (B, vocab) matrix")
    tok_s = PREFILL_BATCH * PREFILL_LEN / prefill_s
    log(f"[8] prefill {PREFILL_BATCH}x{PREFILL_LEN} bf16 (kernel): "
        f"{prefill_s:.4f} s, {tok_s:.1f} tok/s, {launches} kernel launches, "
        f"peak device memory {prefill_peak / 2**30:.3f} GiB")

    # the same prefill, plain reference attention, float32 compute
    t0 = time.perf_counter()
    ref32 = Model(cfg.replace(dtype="float32", attention_impl="reference"))
    logits_ref = ref32.prefill(params, prompts)
    torch.cuda.synchronize()
    ref_s = time.perf_counter() - t0
    d = (logits - logits_ref).abs()
    d_max, d_mean = float(d.max()), float(d.mean())
    am_k, am_r = _argmax_rows(torch, logits), _argmax_rows(torch, logits_ref)
    top2 = torch.topk(logits_ref, 2, dim=-1).values
    margins = (top2[:, 0] - top2[:, 1]).cpu().tolist()
    log(f"[8] bf16 kernel vs float32 reference ({ref_s:.3f} s): max |Δlogits| "
        f"{d_max:.4f} (≤ {BF16_LOGITS_MAX}), mean {d_mean:.5f} "
        f"(≤ {BF16_LOGITS_MEAN}), logits std {float(logits_ref.std()):.4f}; "
        f"argmax equal on {sum(a == b for a, b in zip(am_k, am_r))}/"
        f"{PREFILL_BATCH} rows; reference top-2 margins "
        f"{[round(m, 4) for m in margins]}")
    if d_max > BF16_LOGITS_MAX or d_mean > BF16_LOGITS_MEAN:
        raise AssertionError("bf16 prefill logits outside the stated tolerance")

    # the kernel in float32 against the same reference: equal argmax
    k32 = Model(cfg.replace(dtype="float32"))
    logits_k32 = k32.prefill(params, prompts)
    torch.cuda.synchronize()
    d32 = float((logits_k32 - logits_ref).abs().max())
    am_k32 = _argmax_rows(torch, logits_k32)
    log(f"[8] float32 kernel vs float32 reference: max |Δlogits| {d32:.3e} "
        f"(≤ {F32_LOGITS_MAX}), argmax equal on "
        f"{sum(a == b for a, b in zip(am_k32, am_r))}/{PREFILL_BATCH} rows")
    if d32 > F32_LOGITS_MAX or am_k32 != am_r:
        raise AssertionError("float32 kernel prefill differs from the reference")
    del logits_ref, logits_k32, ref32, d
    gc.collect()
    torch.cuda.empty_cache()

    # continuous-batching serve loop, 8 requests through 4 slots: in float32
    # (first tokens == the float32 prefill's argmax exactly), then in the
    # config's bfloat16 compute and KV cache (first tokens within a stated
    # logit gap of the bfloat16 prefill's maximum)
    prompts_s = [rng.integers(0, cfg.vocab_size, n) for n in SERVE_PROMPT_LENS]
    out32 = None
    for m, dtype in ((Model(cfg.replace(dtype="float32")), torch.float32),
                     (model, torch.bfloat16)):
        reqs, serve_s, loop, peak = _serve(torch, ServeLoop, Request, m, params,
                                           prompts_s, dtype)
        pre = [m.prefill(params, r.prompt[None])[0] for r in reqs]
        first = [int(torch.argmax(lg)) for lg in pre]
        name = str(dtype)[6:]
        if dtype == torch.float32:
            out32 = [r.output for r in reqs]
            bad = [r.rid for r, want in zip(reqs, first) if r.output[0] != want]
            if bad:
                raise AssertionError(f"requests {bad}: first token != float32 "
                                     f"prefill argmax")
            check = f"first tokens == prefill argmax (float32 kernel) for all {len(reqs)}"
        else:
            gaps = [float(lg.max() - lg[r.output[0]]) for r, lg in zip(reqs, pre)]
            if max(gaps) > SERVE_BF16_LOGIT_GAP:
                raise AssertionError(f"bf16 serving: a first token's prefill "
                                     f"logit lies {max(gaps):.4f} below the "
                                     f"maximum (> {SERVE_BF16_LOGIT_GAP})")
            check = (f"first tokens == bf16 prefill argmax for "
                     f"{sum(r.output[0] == w for r, w in zip(reqs, first))}/"
                     f"{len(reqs)}, largest gap to the prefill's max logit "
                     f"{max(gaps):.4f} (≤ {SERVE_BF16_LOGIT_GAP}); all tokens "
                     f"== the float32 loop's for "
                     f"{sum(r.output == o for r, o in zip(reqs, out32))}/"
                     f"{len(reqs)} requests")
        step_tok_s = loop.tokens_stepped / serve_s
        generated = sum(len(r.output) for r in reqs)
        log(f"[8] ServeLoop {name} {SERVE_SLOTS} slots, {len(reqs)} requests "
            f"(prompts {list(SERVE_PROMPT_LENS)}, {SERVE_NEW_TOKENS} new each): "
            f"all done in {serve_s:.3f} s, {loop.steps} steps, "
            f"{loop.tokens_stepped} tokens stepped ({step_tok_s:.1f} tok/s), "
            f"{generated} generated ({generated / serve_s:.1f} tok/s); {check}; "
            f"peak device memory {peak / 2**30:.3f} GiB")
        del loop, m
        gc.collect()
        torch.cuda.empty_cache()
    return {"launches": launches, "prefill_s": prefill_s}


def _serve(torch, ServeLoop, Request, model, params, prompts, dtype):
    """One ServeLoop of ``SERVE_SLOTS`` slots with a ``dtype`` KV cache
    answering ``prompts``; fails unless every request finishes with all its
    tokens. Returns (requests, seconds, loop, peak device bytes)."""
    max_seq = max(SERVE_PROMPT_LENS) + SERVE_NEW_TOKENS
    torch.cuda.reset_peak_memory_stats()
    loop = ServeLoop(model, params, n_slots=SERVE_SLOTS, max_seq=max_seq,
                     dtype=dtype)
    reqs = [Request(i, p, max_new=SERVE_NEW_TOKENS) for i, p in enumerate(prompts)]
    for r in reqs:
        loop.submit(r)
    t0 = time.perf_counter()
    loop.run()
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    if not all(r.done and len(r.output) == SERVE_NEW_TOKENS for r in reqs):
        raise AssertionError("a request did not finish with all its tokens")
    return reqs, serve_s, loop, torch.cuda.max_memory_allocated()


def _tree_leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _tree_leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tree_leaves(v)
    else:
        yield tree


def phase_flash_timing(torch, dev, ops, ref, card, llama) -> dict:
    """Phase 9: the flash kernel at the prefill's shapes, CUDA events."""
    import torch.nn.functional as F

    B, Hq, Hkv, S, D = PREFILL_BATCH, 32, 8, PREFILL_LEN, 64
    q, k, v = _flash_inputs(torch, dev, 99, B, Hq, Hkv, S, S, D, torch.bfloat16)
    d_o, d_lse = _compare_flash(torch, ops, ref, q, k, v, True, None)
    ms = _time_ms(torch, lambda: ops.flash_attention_fwd(q, k, v, causal=True), 20)
    plain_ms = _time_ms(torch, lambda: ref.flash_attention_fwd_torch(
        q, k, v, causal=True), 3)
    library = "scaled_dot_product_attention(is_causal=True, enable_gqa=True)"
    library_ms = _time_ms(torch, lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=True, enable_gqa=True), 20)
    ops_n = 4 * B * Hq * D * S * (S + 1) // 2        # visible (q, k) pairs only
    nbytes = 2 * (2 * q.numel() + k.numel() + v.numel()) + 4 * B * Hq * S
    t_ops, t_bytes = ops_n / BF16_OPS * 1e3, nbytes / HBM_BPS * 1e3
    bound_ms = max(t_ops, t_bytes)
    bound_by = "operations" if bound_ms == t_ops else "bytes"
    log(f"[9] flash forward B={B} Hq={Hq} Hkv={Hkv} S={S} D={D} bf16 causal "
        f"({card}): kernel vs plain max |Δo| {d_o:.3e}, max |Δlse| {d_lse:.3e}")
    log(f"[9] kernel {ms:.4f} ms; plain version {plain_ms:.4f} ms; {library} "
        f"{library_ms:.4f} ms; bound {bound_ms:.4f} ms by {bound_by} "
        f"({ops_n} operations {t_ops:.4f} ms at bf16 peak, {nbytes} B "
        f"{t_bytes:.4f} ms)")
    pairs = B * Hq * S * (S + 1) // 2
    split_n = pairs * 2 * (3 * D + 16)      # q·kᵀ, hi·v, lo·v, ones for l
    log(f"[9] bf16 kernel's tensor operations with the split (q·kᵀ, then "
        f"P·v as hi·v + lo·v, and l as P·1 in the same two passes): "
        f"{split_n} ({split_n / ops_n:.3f}x the bound's count), "
        f"{split_n / BF16_OPS * 1e3:.4f} ms at bf16 peak")
    _tc_report("9", "flash_attention_fwd", "flash_fwd_tc_kernel",
               "flash_attention_fwd_info", D)
    n, pre_ms = llama["launches"], llama["prefill_s"] * 1e3
    log(f"[9] in the prefill: {n} launches x {ms:.4f} ms = {n * ms:.3f} ms of "
        f"{pre_ms:.3f} ms ({n * ms / pre_ms:.1%})")
    for x in (ms, plain_ms, library_ms, bound_ms):
        if not math.isfinite(x) or x <= 0:
            raise AssertionError("a timing is not a positive number")
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "max_abs_err": d_o}


def _tc_report(tag: str, lib: str, entry: str, info_fn: str, D=None) -> None:
    """Print a tensor-core kernel's ptxas report (registers, spills, static
    shared memory) from this run's build log, and its dynamic shared memory
    and resident blocks an SM from the card: at head_dim D for a flash
    kernel (``info_fn(D, &smem, &blocks)``, the <D> instantiation's report),
    or, with D None, ``info_fn(&smem, &blocks)`` and every instantiation's
    report."""
    import ctypes

    from repro_torch.kernels import _build
    reports = _build.ptxas_entries(_build.BUILD_LOG.get(lib, {}).get("ptxas", ""))
    targ = "" if D is None else f"<{D}>"
    found = [(name, lines) for name, lines in reports.items()
             if entry in name and (D is None or re.search(rf"ILi{D}E", name))]
    for name, lines in found:
        log(f"[{tag}] ptxas {entry}{targ} ({name}): " + "; ".join(lines))
    if not found:
        log(f"[{tag}] ptxas: {entry} is not in this run's build log (a cached "
            f"library)")
    fn = getattr(_build.load(lib), info_fn)
    fn.restype = ctypes.c_int
    fn.argtypes = ([] if D is None else [ctypes.c_int]) + [
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
    smem, blocks = ctypes.c_int(0), ctypes.c_int(0)
    code = fn(*([] if D is None else [D]), ctypes.byref(smem),
              ctypes.byref(blocks))
    if code != 0:
        raise AssertionError(f"{info_fn} failed with CUDA error {code}")
    log(f"[{tag}] {entry}{targ}: {smem.value} B of dynamic shared memory, "
        f"{blocks.value} resident blocks an SM")


def _bwd_inputs(torch, ops, dev, seed, B, Hq, Hkv, Sq, Sk, D, dtype, causal,
                window):
    """q, k, v, do and the forward's (o, lse) and delta = rowsum(do·o)."""
    q, k, v = _flash_inputs(torch, dev, seed, B, Hq, Hkv, Sq, Sk, D, dtype)
    gen = torch.Generator(device=dev).manual_seed(seed + 1000)
    do = torch.randn(q.shape, generator=gen, device=dev).to(dtype)
    o, lse = ops.flash_attention_fwd(q, k, v, causal=causal, window=window)
    delta = (do.to(torch.float32) * o.to(torch.float32)).sum(-1)
    return q, k, v, do, o, lse, delta


def _compare_bwd(torch, ops, ref, q, k, v, do, lse, delta, causal, window):
    """Both backward kernels (one launch each) against their plain versions
    on one input. Returns ((dq, dk, dv), max |Δ| of dq, max |Δ| of dk/dv);
    raises on any disagreement."""
    kw = dict(causal=causal, window=window)
    ops.flash_attention_bwd_dq.launches = 0
    ops.flash_attention_bwd_dkv.launches = 0
    dq = ops.flash_attention_bwd_dq(q, k, v, do, lse, delta, **kw)
    dk, dv = ops.flash_attention_bwd_dkv(q, k, v, do, lse, delta, **kw)
    torch.cuda.synchronize()
    if (ops.flash_attention_bwd_dq.launches, ops.flash_attention_bwd_dkv.launches) != (1, 1):
        raise AssertionError("a backward wrapper did not launch its kernel once")
    dq_p = ref.flash_attention_bwd_dq_torch(q, k, v, do, lse, delta, **kw)
    dk_p, dv_p = ref.flash_attention_bwd_dkv_torch(q, k, v, do, lse, delta, **kw)
    tol = FLASH_BWD_F32_TOL if q.dtype == torch.float32 else FLASH_BWD_BF16_TOL
    errs = []
    for name, a, b in (("dq", dq, dq_p), ("dk", dk, dk_p), ("dv", dv, dv_p)):
        if a.dtype != q.dtype or not bool(torch.isfinite(a).all()):
            raise AssertionError(f"{name} is not finite in {q.dtype}")
        torch.testing.assert_close(a.float(), b.float(), **tol,
                                   msg=lambda m: f"{name}: {m}")
        errs.append(float((a.float() - b.float()).abs().max()))
    return (dq, dk, dv), errs[0], max(errs[1:])


def phase_flash_bwd_cases(torch, dev, ops, ref) -> dict:
    """Phase 10: the backward kernels against their plain versions on every
    forward case, rows with nothing visible, and the Function's gradient
    against autograd of the reference. Returns the worst |Δ| per kernel."""
    worst = {"dq": 0.0, "dkv": 0.0}
    cases = list(enumerate(FLASH_CASES)) + [(len(FLASH_CASES), EMPTY_ROWS_CASE)]
    for i, (name, B, Hq, Hkv, Sq, Sk, D, causal, window) in cases:
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v, do, o, lse, delta = _bwd_inputs(
                torch, ops, dev, i, B, Hq, Hkv, Sq, Sk, D, dtype, causal, window)
            (dq, dk, dv), e_dq, e_dkv = _compare_bwd(
                torch, ops, ref, q, k, v, do, lse, delta, causal, window)
            worst["dq"] = max(worst["dq"], e_dq)
            worst["dkv"] = max(worst["dkv"], e_dkv)
            extra = ""
            if name == "empty rows":          # rows from Sk − 1 + window see no key
                first = Sk - 1 + window
                if not (bool((lse[:, :, first:] == ref.NEG_INF).all())
                        and bool((dq[:, :, first:] == 0).all())
                        and bool(dq[:, :, :first].abs().sum() > 0)):
                    raise AssertionError("empty rows: lse or dq is wrong")
                extra = f"; rows {first}.. see no key, their dq == 0, no NaN"
            log(f"[10] {name} {str(dtype)[6:]} (B={B} Hq={Hq} Hkv={Hkv} Sq={Sq} "
                f"Sk={Sk} D={D}): max |Δdq| {e_dq:.3e}, max |Δdk,dv| "
                f"{e_dkv:.3e}{extra}")
    # the Function (forward + both backward kernels) against autograd
    for i in (1, 5):
        name, B, Hq, Hkv, Sq, Sk, D, causal, window = FLASH_CASES[i]
        q, k, v = _flash_inputs(torch, dev, 50 + i, B, Hq, Hkv, Sq, Sk, D,
                                torch.float32)
        g = torch.randn_like(q)
        grads = []
        for fn in (ops.flash_attention, ref.attention_ref):
            leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
            out = fn(*leaves, causal=causal, window=window)
            grads.append(torch.autograd.grad(out, leaves, g))
        torch.cuda.synchronize()
        errs = []
        for gn, a, b in zip(("dq", "dk", "dv"), *grads):
            torch.testing.assert_close(a, b, **FLASH_GRAD_TOL,
                                       msg=lambda m: f"{gn}: {m}")
            errs.append(float((a - b).abs().max()))
        log(f"[10] FlashAttention gradient vs autograd of attention_ref, "
            f"{name} float32: max |Δ| dq {errs[0]:.3e} dk {errs[1]:.3e} dv "
            f"{errs[2]:.3e} (≤ {FLASH_GRAD_TOL})")
    return worst


def _count_launches(ops):
    return (ops.flash_attention_fwd.launches, ops.flash_attention_bwd_dq.launches,
            ops.flash_attention_bwd_dkv.launches)


def _reset_launches(ops):
    ops.flash_attention_fwd.launches = 0
    ops.flash_attention_bwd_dq.launches = 0
    ops.flash_attention_bwd_dkv.launches = 0


def _loss_grads(torch, model, params, batch):
    from repro_torch.models.common import tree_leaves
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    loss = model.loss(params, batch)
    grads = torch.autograd.grad(loss, leaves)
    torch.cuda.synchronize()
    return float(loss.detach()), grads


def phase_train(torch, ops) -> dict:
    """Phase 11: the training slice at full Llama-3.2-1B width."""
    import itertools

    from repro_torch.configs import get_config
    from repro_torch.data.tokens import batches, synthetic_corpus
    from repro_torch.models import Model
    from repro_torch.runtime import StepMonitor, train

    cfg = get_config("llama3.2-1b")
    corpus = synthetic_corpus(vocab_size=cfg.vocab_size, doc_len=TRAIN_LEN + 1,
                              seed=0)

    # (a) gradient parity at full width on 1 × 512 tokens
    model = Model(cfg)
    params = model.init(seed=0)
    small = next(batches(corpus, GRAD_BATCH, GRAD_LEN, seed=1))
    l_ref, g_ref = _loss_grads(torch, Model(cfg.replace(
        dtype="float32", attention_impl="reference")), params, small)
    _reset_launches(ops)
    l_k32, g_k32 = _loss_grads(torch, Model(cfg.replace(dtype="float32")),
                               params, small)
    launches = _count_launches(ops)
    n = cfg.n_layers
    if launches != (2 * n, n, n):
        raise AssertionError(f"float32 loss gradient launched (fwd, dq, dkv) "
                             f"{launches}, not {(2 * n, n, n)}")
    rel = [float((a - b).norm() / b.norm().clamp_min(1e-30))
           for a, b in zip(g_k32, g_ref)]
    del g_k32
    l_bf, g_bf = _loss_grads(torch, model, params, small)
    dot = sum(float((a.float() * b).sum()) for a, b in zip(g_bf, g_ref))
    n_bf = math.sqrt(sum(float(a.float().square().sum()) for a in g_bf))
    n_ref = math.sqrt(sum(float(b.square().sum()) for b in g_ref))
    cos = dot / (n_bf * n_ref)
    log(f"[11] gradient of Model.loss at full width, {GRAD_BATCH}x{GRAD_LEN} "
        f"tokens: loss reference f32 {l_ref:.6f}, kernel f32 {l_k32:.6f}, "
        f"kernel bf16 {l_bf:.6f}; launches (fwd, dq, dkv) {launches}")
    log(f"[11] kernel f32 vs reference f32: per-leaf ‖Δg‖/‖g‖ max {max(rel):.3e} "
        f"(≤ {GRAD_F32_REL_MAX}) over {len(rel)} leaves; bf16 kernel vs f32 "
        f"reference: cosine {cos:.6f} (≥ {GRAD_BF16_COS_MIN}), gradient norms "
        f"{n_bf:.4f} / {n_ref:.4f}")
    if max(rel) > GRAD_F32_REL_MAX or not cos >= GRAD_BF16_COS_MIN:
        raise AssertionError("full-width gradients outside the stated bounds")
    del params, g_ref, g_bf, model
    gc.collect()
    torch.cuda.empty_cache()

    # (b) runtime.train on one fixed batch of 4 × 2048, repeated
    batch = next(batches(corpus, TRAIN_BATCH, TRAIN_LEN, seed=2))

    per_step = []

    class LaunchMonitor(StepMonitor):
        """Records the kernels' launches of each step, then resets them."""

        def record(self, step, seconds):
            per_step.append(_count_launches(ops))
            _reset_launches(ops)
            return super().record(step, seconds)

    torch.cuda.reset_peak_memory_stats()
    _reset_launches(ops)
    t0 = time.perf_counter()
    state, hist = train(Model(cfg), itertools.repeat(batch), steps=TRAIN_STEPS,
                        peak_lr=TRAIN_PEAK_LR, warmup=TRAIN_WARMUP,
                        monitor=LaunchMonitor(), log_every=1, log_fn=log)
    train_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    if per_step != [(2 * n, n, n)] * TRAIN_STEPS:
        raise AssertionError(f"launches (fwd, dq, dkv) per step {per_step}, "
                             f"not {(2 * n, n, n)} each")
    losses = [h["loss"] for h in hist]
    secs = [h["seconds"] for h in hist]
    step_s = sum(secs[1:]) / (len(secs) - 1)      # step 0 warms up
    tokens = TRAIN_BATCH * TRAIN_LEN
    log(f"[11] train {TRAIN_STEPS} steps of {TRAIN_BATCH}x{TRAIN_LEN} (float32 "
        f"params, bf16 compute, remat, AdamW, peak lr {TRAIN_PEAK_LR}, warmup "
        f"{TRAIN_WARMUP}) in {train_s:.3f} s incl. init; losses "
        f"{[round(x, 4) for x in losses]}; step seconds "
        f"{[round(x, 4) for x in secs]}")
    log(f"[11] step {step_s * 1e3:.2f} ms (mean of steps 1..{TRAIN_STEPS - 1}), "
        f"{tokens / step_s:.1f} tok/s, peak device memory {peak / 2**30:.3f} GiB; "
        f"launches per step (fwd, dq, dkv) {per_step[0]}")
    lo, hi = TRAIN_LOSS0_BAND
    if not all(math.isfinite(x) for x in losses) or not lo <= losses[0] <= hi:
        raise AssertionError(f"step-0 loss {losses[0]} outside {TRAIN_LOSS0_BAND}")
    if not losses[-1] <= losses[0] - TRAIN_LOSS_DROP_MIN:
        raise AssertionError(f"loss fell from {losses[0]} to {losses[-1]}, "
                             f"less than {TRAIN_LOSS_DROP_MIN}")
    del state
    gc.collect()
    torch.cuda.empty_cache()
    _profile_step(torch, cfg, batch)
    return {"launches": {"dq": sum(c[1] for c in per_step),
                         "dkv": sum(c[2] for c in per_step)},
            "step_s": step_s, "n_layers": n, "cfg": cfg}


def _profile_step(torch, cfg, batch, top: int = 12) -> None:
    """One train step (after a warm-up step) of the step function
    ``runtime.train`` runs, under ``torch.profiler``: device time by kernel,
    grouped, and the device's idle share of the step's wall time. A
    measurement only: a profiler that cannot trace the card is reported,
    not failed."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models import Model
    from repro_torch.optim import adamw, warmup_cosine
    from repro_torch.runtime import init_train_state, make_train_step

    model, opt = Model(cfg), adamw()
    state = init_train_state(model, opt, seed=0)
    step = make_train_step(model, opt, warmup_cosine(TRAIN_PEAK_LR, 1, 4))
    float(step(state, batch)[1]["loss"])                       # warm-up
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            float(step(state, batch)[1]["loss"])
            wall_ms = (time.perf_counter() - t0) * 1e3
        kernels = [(e.key, e.self_device_time_total / 1e3, e.count)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    except Exception as exc:          # noqa: BLE001 — report, do not fail
        log(f"[11] profiler unavailable: {exc!r}")
        return
    finally:
        del state
        gc.collect()
        torch.cuda.empty_cache()
    busy = sum(ms for _, ms, _ in kernels)
    if busy <= 0:
        log("[11] profiler traced no device time")
        return
    groups = {"flash kernels (this port)": 0.0, "GEMMs (cuBLAS)": 0.0, "other": 0.0}
    for name, ms, _ in kernels:
        low = name.lower()
        key = ("flash kernels (this port)" if "flash_" in low else
               "GEMMs (cuBLAS)" if any(w in low for w in ("gemm", "nvjet"))
               else "other")
        groups[key] += ms
    log(f"[11] profiled step: wall {wall_ms:.2f} ms, device busy {busy:.2f} ms, "
        f"idle share {1 - busy / wall_ms:.1%}; by group "
        + ", ".join(f"{k} {v:.2f} ms ({v / busy:.1%})" for k, v in groups.items()))
    for name, ms, count in sorted(kernels, key=lambda x: -x[1])[:top]:
        log(f"[11]   {ms:9.3f} ms  x{count:<4d} {name[:110]}")


def _model_flops(cfg, B, S) -> float:
    """Model FLOPs of one training step (forward and backward, no remat
    recompute): 6·T·N over the weight products (N counts each layer's
    q/k/v/o and MLP weights and the tied head), plus 12·D·P per layer for
    attention (2 products forward, 4 backward, 2·D FLOPs each per visible
    pair; P = B·Hq·S(S+1)/2 visible causal pairs)."""
    d, hd = cfg.d_model, cfg.resolved_head_dim
    layer = (d * cfg.n_heads * hd * 2 + d * cfg.n_kv_heads * hd * 2
             + 3 * d * cfg.d_ff)
    n_mat = cfg.n_layers * layer + d * cfg.vocab_size
    pairs = B * cfg.n_heads * S * (S + 1) // 2
    return 6.0 * B * S * n_mat + 12.0 * hd * pairs * cfg.n_layers


def phase_flash_bwd_timing(torch, dev, ops, ref, card, training) -> dict:
    """Phase 12: the backward kernels at the training step's shapes."""
    import torch.nn.functional as F

    B, Hq, Hkv, S, D = TRAIN_BATCH, 32, 8, TRAIN_LEN, 64
    kw = dict(causal=True, window=None)
    q, k, v, do, o, lse, delta = _bwd_inputs(
        torch, ops, dev, 98, B, Hq, Hkv, S, S, D, torch.bfloat16, True, None)
    _, e_dq, e_dkv = _compare_bwd(torch, ops, ref, q, k, v, do, lse, delta,
                                  True, None)
    args = (q, k, v, do, lse, delta)
    dq_ms = _time_ms(torch, lambda: ops.flash_attention_bwd_dq(*args, **kw), 10)
    dkv_ms = _time_ms(torch, lambda: ops.flash_attention_bwd_dkv(*args, **kw), 10)
    fwd_ms = _time_ms(torch, lambda: ops.flash_attention_fwd(q, k, v, causal=True), 10)
    dq_plain = _time_ms(torch, lambda: ref.flash_attention_bwd_dq_torch(*args, **kw), 3)
    dkv_plain = _time_ms(torch, lambda: ref.flash_attention_bwd_dkv_torch(*args, **kw), 3)
    leaves = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
    out = F.scaled_dot_product_attention(*leaves, is_causal=True, enable_gqa=True)
    backend = type(out.grad_fn).__name__
    sdpa_ms = _time_ms(torch, lambda: torch.autograd.grad(
        out, leaves, do, retain_graph=True), 10)
    pairs = B * Hq * S * (S + 1) // 2                # visible (q, k) pairs
    qb, kvb, stat = 2 * q.numel(), 2 * k.numel(), 4 * lse.numel()
    bounds = {}
    for name, n_prod, nbytes in (("dq", 3, 3 * qb + 2 * kvb + 2 * stat),
                                 ("dkv", 4, 2 * qb + 4 * kvb + 2 * stat)):
        flops = n_prod * 2 * D * pairs
        t_ops, t_bytes = flops / BF16_OPS * 1e3, nbytes / HBM_BPS * 1e3
        bound = max(t_ops, t_bytes)
        bounds[name] = (bound, "operations" if bound == t_ops else "bytes")
        log(f"[12] {name} bound {bound:.4f} ms by {bounds[name][1]} ({flops} "
            f"operations {t_ops:.4f} ms at bf16 peak, {nbytes} B {t_bytes:.4f} ms)")
    split_dq = 4 * 2 * D * pairs
    log(f"[12] dq bf16 kernel's tensor operations with the split (q·kᵀ, "
        f"do·vᵀ, then dS·k as hi + lo): {split_dq} (4/3 of the bound's "
        f"count), {split_dq / BF16_OPS * 1e3:.4f} ms at bf16 peak; executed "
        f"{split_dq / dq_ms / 1e9:.1f} TFLOP/s")
    _tc_report("12", "flash_attention_bwd", "flash_bwd_dq_tc_kernel",
               "flash_attention_bwd_dq_info", D)
    split_n = 6 * 2 * D * pairs
    log(f"[12] dk/dv bf16 kernel's tensor operations with the split (k·qᵀ, "
        f"v·doᵀ, then Pᵀ·do and dSᵀ·q each as hi + lo): {split_n} (1.5x the "
        f"bound's count), {split_n / BF16_OPS * 1e3:.4f} ms at bf16 peak; "
        f"executed {split_n / dkv_ms / 1e9:.1f} TFLOP/s")
    _tc_report("12", "flash_attention_bwd", "flash_bwd_dkv_tc_kernel",
               "flash_attention_bwd_dkv_info", D)
    log(f"[12] flash backward B={B} Hq={Hq} Hkv={Hkv} S={S} D={D} bf16 causal "
        f"({card}): kernels vs plain max |Δdq| {e_dq:.3e}, max |Δdk,dv| {e_dkv:.3e}")
    log(f"[12] dq kernel {dq_ms:.4f} ms (plain {dq_plain:.4f} ms); dk/dv kernel "
        f"{dkv_ms:.4f} ms (plain {dkv_plain:.4f} ms); forward kernel {fwd_ms:.4f} "
        f"ms; backward of scaled_dot_product_attention(is_causal=True, "
        f"enable_gqa=True) {sdpa_ms:.4f} ms ({backend}; dq, dk and dv together)")
    n, step_ms = training["n_layers"], training["step_s"] * 1e3
    kernels_ms = 2 * n * fwd_ms + n * (dq_ms + dkv_ms)
    mflops = _model_flops(training["cfg"], B, S)
    mfu = mflops / training["step_s"] / BF16_OPS
    log(f"[12] in a training step: {2 * n} x fwd + {n} x dq + {n} x dk/dv = "
        f"{kernels_ms:.3f} ms of {step_ms:.3f} ms ({kernels_ms / step_ms:.1%}, "
        f"per-launch CUDA-event times above x launches per step); model FLOPs "
        f"{mflops:.4e} per step = {mflops / training['step_s'] / 1e12:.2f} TFLOP/s, "
        f"{mfu:.2%} of the {BF16_OPS / 1e12:.0f} TFLOP/s bf16 peak")
    for x in (dq_ms, dkv_ms, fwd_ms, dq_plain, dkv_plain, sdpa_ms):
        if not math.isfinite(x) or x <= 0:
            raise AssertionError("a timing is not a positive number")
    return {"dq": {"ms": dq_ms, "plain_ms": dq_plain, "bound_ms": bounds["dq"][0],
                   "bound_by": bounds["dq"][1], "library_ms": sdpa_ms,
                   "max_abs_err": e_dq},
            "dkv": {"ms": dkv_ms, "plain_ms": dkv_plain,
                    "bound_ms": bounds["dkv"][0], "bound_by": bounds["dkv"][1],
                    "library_ms": sdpa_ms, "max_abs_err": e_dkv}}


def _single_inputs(torch, dev, seed, S_i, S_j, n_e, w):
    """Random row and column incidence (S_i, n_e·w) and (S_j, n_e·w) int8
    with their accuracies and per-block p̂ and δ, on ``dev``."""
    gen = torch.Generator().manual_seed(seed)
    E = n_e * w
    out = [(torch.rand((S_i, E), generator=gen) < 0.05).to(torch.int8),
           (torch.rand((S_j, E), generator=gen) < 0.05).to(torch.int8),
           torch.empty(S_i).uniform_(0.35, 0.95, generator=gen),
           torch.empty(S_j).uniform_(0.35, 0.95, generator=gen),
           torch.empty(n_e).uniform_(0.01, 0.99, generator=gen),
           torch.empty(n_e).uniform_(0.0, 0.2, generator=gen)]
    return [x.to(dev) for x in out]


def _compare_single(torch, got, want) -> float:
    """Kernel vs plain version of one pair block: counts equal, C→ (and
    err) within RTOL/ATOL. Returns the max |Δ| of the score channels."""
    if len(got) != len(want) or not torch.equal(got[1], want[1]):
        raise AssertionError("copyscore: counts differ from the plain version")
    worst = 0.0
    for c in range(0, len(got), 2):                    # C→, and err
        torch.testing.assert_close(got[c], want[c], rtol=RTOL, atol=ATOL)
        worst = max(worst, float((got[c] - want[c]).abs().max()))
    return worst


def _bound(nbytes: int, int8_ops: float, f32_ops: float):
    """(bound ms, "bytes" or "operations") at the card's published peaks."""
    t_bytes = nbytes / HBM_BPS * 1e3
    t_ops = max(int8_ops / INT8_OPS, f32_ops / F32_OPS) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_copyscore_cases(torch, dev, ops, ref, cfg, w_full) -> dict:
    """Phase 13: B2/B3 against their plain version on the card, and B3's
    full square against B1's scattered C→/C← grid on one chunk of the full
    pass's width. Returns the worst |Δ| per kernel."""
    from repro_torch.core.shardplan import scatter_tile_stacks

    kw = dict(s=cfg.s, n_false=cfg.n)
    worst = {"copyscore": 0.0, "copyscore_err": 0.0}
    for i, w in enumerate(COPYSCORE_BLOCK_E):
        n_e = 1 if w >= 4096 else 3
        S = COPYSCORE_SQUARE
        v, _, a, _, p, _ = _single_inputs(torch, dev, 10 + i, S, S, n_e, w)
        ops.copyscore.launches = 0
        got = ops.copyscore(v, p, a, block_e=w, **kw)
        torch.cuda.synchronize()
        if ops.copyscore.launches != 1:
            raise AssertionError("ops.copyscore did not launch the kernel once")
        e = _compare_single(torch, got, ref.copyscore_torch(v, p, a, block_e=w,
                                                            **kw))
        worst["copyscore"] = max(worst["copyscore"], e)
        log(f"[13] full square S={S} block_e={w} x{n_e}: counts equal, max "
            f"|Δ| C→ {e:.3e}")
        for S_i, S_j in COPYSCORE_RECTS:
            v_r, v_c, a_r, a_c, p, d = _single_inputs(torch, dev, S_i + w, S_i,
                                                      S_j, n_e, w)
            for name, dd in (("copyscore", None), ("copyscore_err", d)):
                ops.copyscore_tile.launches = 0
                got = ops.copyscore_tile(v_r, v_c, p, a_r, a_c, block_e=w,
                                         delta_blk=dd, **kw)
                torch.cuda.synchronize()
                if ops.copyscore_tile.launches != 1:
                    raise AssertionError("ops.copyscore_tile did not launch "
                                         "the kernel once")
                want = ref.copyscore_torch(v_r, p, a_r, v_cols=v_c,
                                           acc_cols=a_c, delta_blk=dd,
                                           block_e=w, **kw)
                e = _compare_single(torch, got, want)
                worst[name] = max(worst[name], e)
                log(f"[13] tile {S_i}x{S_j} block_e={w} x{n_e} "
                    f"{'with' if dd is not None else 'without'} δ: counts "
                    f"equal, max |Δ| scores {e:.3e}")

    # one chunk of the full pass's width: B3's square == B1's scatter
    S, T = 2048, 256
    nb = S // T
    v, _, a, _, p, d = _single_inputs(torch, dev, 99, S, S, 1, w_full)
    coords = torch.tensor([[r, c] for r in range(nb) for c in range(r, nb)],
                          dtype=torch.int32, device=dev)
    stacks = [torch.zeros((len(coords), T, T), device=dev) for _ in range(5)]
    ops.tile_scores(v.reshape(S, 1, w_full), a, p, d, torch.ones_like(p),
                    coords, stacks, tile=T, **kw)
    grids = [torch.zeros((S, S), device=dev) for _ in range(4)]
    scatter_tile_stacks(grids, coords, stacks, nb, T)
    c3, n3 = ops.copyscore(v, p, a, block_e=w_full, **kw)
    torch.cuda.synchronize()
    if not (torch.equal(c3, grids[0]) and torch.equal(n3, grids[1])):
        raise AssertionError("B3's full square differs from B1's scattered "
                             "C→/C← grid on one chunk")
    log(f"[13] one chunk S={S} w={w_full}: B3's full square == B1's scattered "
        f"C→/C← grid ({len(coords)} tiles of {T}) and counts, bit for bit")
    return worst


def phase_store(torch, np, dev, ops, ref, cfg, card, ctx, ds) -> dict:
    """Phase 14: ``copyscore_store`` over the full pass's engine store, one
    B3 launch per live chunk; a sample of chunks against the plain version;
    the full square against the engine's scan grid at S=2048; and B3's
    timing at the store's shapes."""
    from repro_torch.core import DetectionEngine, build_index
    from repro_torch.data.claims import (
        SyntheticSpec,
        oracle_claim_probs,
        synthetic_claims,
    )

    kw = dict(s=cfg.s, n_false=cfg.n)
    store, p_hat = ctx.ech.store, ctx.ech.p_hat
    S, K, w = store.n_rows, store.n_chunks, store.chunk_entries
    live = sum(bool((ch.item >= 0).any()) for ch in store.iter_chunks())
    acc = torch.from_numpy(ds.accuracy.astype(np.float32)).to(dev)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ev = (torch.cuda.Event(enable_timing=True),
          torch.cuda.Event(enable_timing=True))
    ops.copyscore_store.launches = 0          # count the main path's launches
    t0 = time.perf_counter()
    ev[0].record()
    c, n = ops.copyscore_store(store, p_hat, acc, **kw)
    ev[1].record()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = ops.copyscore_store.launches
    if launches != live or launches <= 0:
        raise AssertionError(f"copyscore_store launched {launches} times, "
                             f"live chunks {live}")
    if (tuple(c.shape) != (S, S) or not bool(torch.isfinite(c).all())
            or not torch.equal(n, n.T)):
        raise AssertionError("the full square is not a finite (S, S) C→ with "
                             "a symmetric count")
    log(f"[14] copyscore_store S={S} over {K} chunks of {w} ({live} live): "
        f"{secs:.3f} s, {launches} launches, device {ev[0].elapsed_time(ev[1]):.3f} "
        f"ms (CUDA events, staging included), peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB; ordered pairs "
        f"sharing an entry {int((n > 0).sum().item()) - int((n.diagonal() > 0).sum().item())}")

    worst = 0.0
    for k in sorted({0, K // 2, K - 1}):
        v = torch.from_numpy(store.chunks[k][:S]).to(dev)
        p_k = torch.from_numpy(p_hat[k: k + 1].astype(np.float32)).to(dev)
        e = _compare_single(torch, ops.copyscore(v, p_k, acc, block_e=w, **kw),
                            ref.copyscore_torch(v, p_k, acc, block_e=w, **kw))
        worst = max(worst, e)
        log(f"[14] chunk {k}: kernel == plain (counts equal, max |Δ| C→ "
            f"{e:.3e})")

    # B3's timing at the store's shapes: one accumulating launch
    k = K // 2
    v = torch.from_numpy(store.chunks[k][:S]).to(dev)
    p_k = torch.from_numpy(p_hat[k: k + 1].astype(np.float32)).to(dev)
    small = ops._single_operands(v, v, acc, acc, p_k, None, w)
    ms = _time_ms(torch, lambda: ops._launch_single(
        v, v, small, (c, n), block_e=w, accumulate=True, **kw), 5)
    plain_ms = _time_ms(torch, lambda: ref.copyscore_torch(
        v, p_k, acc, block_e=w, **kw), 2)
    int_mm_ms = _time_ms(torch, lambda: torch._int_mm(v, v.t()), 5)
    nbytes = S * w + 4 * S + 4 + 2 * 2 * 4 * S * S
    bound_ms, bound_by = _bound(nbytes, 2 * S * S * w,
                                S * S * F32_PER_PAIR_BLOCK["copyscore"])
    int8_ops = 2 * S * S * w
    log(f"[14] B3 one accumulating launch S={S} w={w} ({card}): {ms:.4f} ms; "
        f"plain version {plain_ms:.4f} ms; bound {bound_ms:.4f} ms by "
        f"{bound_by} ({nbytes} B, {int8_ops} int8 operations); "
        f"torch._int_mm {int_mm_ms:.4f} ms — count product only; square "
        f"{launches} x {ms:.4f} = {launches * ms:.1f} ms")
    log(f"[14] int8 operations executed: B3 {int8_ops / ms / 1e9:.1f} TOP/s "
        f"(count product with its epilogue and accumulator traffic), "
        f"torch._int_mm {int8_ops / int_mm_ms / 1e9:.1f} TOP/s (product "
        f"alone), of the {INT8_OPS / 1e12:.0f} TOP/s int8 peak")
    _tc_report("14", "copyscore", "copyscore_tc_kernel", "copyscore_info")
    del c, n, v, small
    gc.collect()
    torch.cuda.empty_cache()

    # the full square against the engine's scan grid on the S=2048 world
    sc = synthetic_claims(SyntheticSpec(**WORLD_2048))
    ds2, p2 = sc.dataset, oracle_claim_probs(sc)
    eng = DetectionEngine(cfg)
    ctx2 = eng._tiled_prologue(ds2, p2, build_index(ds2, p2, cfg, device=dev))
    grids, _ = eng._run_tiled_scan(ctx2)
    acc2 = torch.from_numpy(ds2.accuracy.astype(np.float32)).to(dev)
    c2, n2 = ops.copyscore_store(ctx2.ech.store, ctx2.ech.p_hat, acc2, **kw)
    S2, T, nb = ds2.n_sources, ctx2.T, ctx2.n_blocks
    kept = torch.zeros((nb, nb), dtype=torch.bool, device=dev)
    rc = torch.from_numpy(ctx2.coords).long().to(dev)
    kept[rc[:, 0], rc[:, 1]] = True
    kept[rc[:, 1], rc[:, 0]] = True
    mask = kept.repeat_interleave(T, 0).repeat_interleave(T, 1)[:S2, :S2]
    n_eng, c_eng = grids[1][:S2, :S2], grids[0][:S2, :S2]
    if not torch.equal(n_eng[mask], n2[mask]) or bool((n_eng[~mask] != 0).any()):
        raise AssertionError("S=2048: the full square's counts differ from the "
                             "engine's scan grid on its kept tiles")
    torch.testing.assert_close(c_eng[mask], c2[mask], rtol=RTOL, atol=ATOL)
    e = float((c_eng[mask] - c2[mask]).abs().max())
    log(f"[14] S={S2}: full-square n == the engine's scan grid n on its "
        f"{len(ctx2.coords)}/{ctx2.tiles_total} kept tiles (both orientations; "
        f"0 on the pruned ones), C→ max |Δ| {e:.3e} (bit-equal: "
        f"{torch.equal(c_eng[mask], c2[mask])})")
    for x in (ms, plain_ms, int_mm_ms, bound_ms):
        if not math.isfinite(x) or x <= 0:
            raise AssertionError("a timing is not a positive number")
    return {"launches": launches, "max_abs_err": worst, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by}


def phase_legacy(torch, np, dev, ops, ref, cfg, card) -> dict:
    """Phase 15: the legacy per-ordered-tile dataflow (B2 per tile plus a
    separate non-Ē count product) against the fused one (B1 over the
    unordered tiles) at the JAX kernel bench's shapes; then B2's timing at
    one tile's shapes."""
    from repro_torch.core import bucketize_engine, build_index, pad_buckets
    from repro_torch.core.scoring import bucket_score_deltas
    from repro_torch.core.shardplan import scatter_tile_stacks
    from repro_torch.data.claims import (
        SyntheticSpec,
        oracle_claim_probs,
        synthetic_claims,
    )

    kw = dict(s=cfg.s, n_false=cfg.n)
    sc = synthetic_claims(SyntheticSpec(**WORLD_2048))
    ds, p = sc.dataset, oracle_claim_probs(sc)
    b, p_lo, p_hi = bucketize_engine(build_index(ds, p, cfg, device=dev),
                                     LEGACY_BUCKETS)
    delta = bucket_score_deltas(b.p_hat, p_lo, p_hi, ds.accuracy, cfg)
    padded = pad_buckets(b, dtype=torch.int8, device=dev)
    K, S, w0 = padded.v_ksw.shape
    T = LEGACY_TILE
    nb = -(-S // T)
    # both kernels read whole 32-bit words (B1 needs w % 8): the bucket width
    # is padded up with inert zero columns
    w = -(-w0 // 8) * 8
    v = torch.zeros((nb * T, K, w), dtype=torch.int8, device=dev)
    v[:S, :, :w0] = padded.v_ksw.permute(1, 0, 2)
    acc = torch.full((nb * T,), 0.5, device=dev)
    acc[:S] = torch.from_numpy(ds.accuracy.astype(np.float32)).to(dev)
    p_hat = padded.p_hat
    d = torch.from_numpy(np.asarray(delta, np.float32)).to(dev)
    nout = (torch.arange(K, device=dev) < padded.ebar_bucket).to(torch.float32)
    e_out = padded.ebar_bucket * w
    ordered = [(r, c) for r in range(nb) for c in range(nb)]
    tri = torch.tensor([rc for rc in ordered if rc[0] <= rc[1]],
                       dtype=torch.int32, device=dev)

    def rows(r):
        return v[r * T:(r + 1) * T].reshape(T, K * w), acc[r * T:(r + 1) * T]

    def legacy():
        outs = []
        for r, c in ordered:
            (vr, a_r), (vc, a_c) = rows(r), rows(c)
            cf, n, err = ops.copyscore_tile(vr, vc, p_hat, a_r, a_c,
                                            block_e=w, delta_blk=d, **kw)
            n_out = vr[:, :e_out].float() @ vc[:, :e_out].float().T
            outs.append((cf, n, n_out, err))
        return outs

    def fused():
        stacks = [torch.zeros((len(tri), T, T), device=dev) for _ in range(5)]
        ops.tile_scores(v, acc, p_hat, d, nout, tri, stacks, tile=T, **kw)
        return stacks

    ops.copyscore_tile.launches = 0           # count the legacy path's launches
    outs = legacy()
    torch.cuda.synchronize()
    launches = ops.copyscore_tile.launches
    if launches != len(ordered):
        raise AssertionError(f"the legacy scan launched B2 {launches} times, "
                             f"not once per ordered tile ({len(ordered)})")
    g_leg = [torch.zeros((nb * T, nb * T), device=dev) for _ in range(4)]
    for (r, c), o in zip(ordered, outs):
        for g, x in zip(g_leg, o):
            g[r * T:(r + 1) * T, c * T:(c + 1) * T] = x
    g_fus = [torch.zeros_like(g) for g in g_leg]
    scatter_tile_stacks(g_fus, tri, fused(), nb, T)
    torch.cuda.synchronize()
    for i, name in ((1, "n"), (2, "n_out")):
        if not torch.equal(g_leg[i], g_fus[i]):
            raise AssertionError(f"legacy vs fused: {name} differs")
    worst, bitwise = 0.0, []
    for i in (0, 3):                                   # C→, err
        torch.testing.assert_close(g_leg[i], g_fus[i], rtol=RTOL, atol=ATOL)
        worst = max(worst, float((g_leg[i] - g_fus[i]).abs().max()))
        bitwise.append(torch.equal(g_leg[i], g_fus[i]))
    leg_ms = _time_ms(torch, legacy, 3)
    fus_ms = _time_ms(torch, fused, 3)
    log(f"[15] S={S} tile {T}, {K} buckets of {w0} (padded to {w}), int8: "
        f"legacy {len(ordered)} B2 launches + non-Ē count products vs fused "
        f"one B1 launch over {len(tri)} tiles; (C→, n, n_out, err) grids "
        f"agree: counts equal, max |Δ| scores {worst:.3e} (C→, err bit-equal: "
        f"{bitwise})")
    log(f"[15] legacy {leg_ms:.3f} ms, fused {fus_ms:.3f} ms: the fused scan "
        f"{leg_ms / fus_ms:.2f}x faster on the card ({card}); the JAX "
        f"package's CPU run gave {LEGACY_CPU_SPEEDUPS} (a CPU number)")

    # B2 at one ordered tile's shapes
    (vr, a_r), (vc, a_c) = rows(0), rows(1)

    def b2():
        return ops.copyscore_tile(vr, vc, p_hat, a_r, a_c, block_e=w,
                                  delta_blk=d, **kw)

    once, again = b2(), b2()
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(once, again)):
        raise AssertionError("B2: two launches on the same inputs differ")

    def plain():
        return ref.copyscore_torch(vr, p_hat, a_r, v_cols=vc, acc_cols=a_c,
                                   delta_blk=d, block_e=w, **kw)

    b2_err = _compare_single(torch, once, plain())
    ms = _time_ms(torch, b2, 20)
    dev_ms = _device_ms(torch, b2, 20)
    plain_ms = _time_ms(torch, plain, 3)
    int_mm_ms = _time_ms(torch, lambda: torch._int_mm(vr, vc.t()), 20)
    int_mm_dev_ms = _device_ms(torch, lambda: torch._int_mm(vr, vc.t()), 20)
    E = K * w
    nbytes = 2 * T * E + 2 * 4 * T + 2 * 4 * K + 3 * 4 * T * T
    bound_ms, bound_by = _bound(nbytes, 2 * T * T * E,
                                T * T * K * F32_PER_PAIR_BLOCK["copyscore_err"])
    splits = ops._err_splits(K, T, T, torch.cuda.get_device_properties(
        dev).multi_processor_count)
    log(f"[15] B2 one tile {T}x{T}, E={E} ({K} blocks of {w}, {splits} "
        f"ranges of entry blocks, then the range sum): B2 == plain version "
        f"(counts equal, max |Δ| C→/err {b2_err:.3e}); {ms:.4f} ms a call of "
        f"ops.copyscore_tile ({dev_ms:.4f} ms on the card alone, the host "
        f"path not counted); plain version {plain_ms:.4f} ms; bound "
        f"{bound_ms:.4f} ms by {bound_by} ({nbytes} B); torch._int_mm "
        f"{int_mm_ms:.4f} ms a call ({int_mm_dev_ms:.4f} ms on the card alone) "
        f"— the same count product over the tile, without the epilogue; two "
        f"launches bit-equal")
    ops_tile = 2 * T * T * E
    log(f"[15] int8 operations executed: B2 {ops_tile / ms / 1e9:.1f} TOP/s "
        f"a call ({ops_tile / dev_ms / 1e9:.1f} on the card alone), "
        f"torch._int_mm {ops_tile / int_mm_ms / 1e9:.1f} TOP/s a call "
        f"({ops_tile / int_mm_dev_ms / 1e9:.1f} on the card alone), of the "
        f"{INT8_OPS / 1e12:.0f} TOP/s int8 peak")
    _tc_report("15", "copyscore", "copyscore_tc_kernelILb1ELb1E",
               "copyscore_err_info")
    for x in (ms, dev_ms, plain_ms, int_mm_ms, int_mm_dev_ms, bound_ms, leg_ms,
              fus_ms):
        if not math.isfinite(x) or x <= 0:
            raise AssertionError("a timing is not a positive number")
    return {"launches": launches, "max_abs_err": b2_err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by}


def phase_prefetch(torch, np, dev, ops, cfg, ds, p, index, exact) -> None:
    """Phase 4, S=2048: the scan at prefetch depth 0 and 2 gives the same
    four grids bit for bit, and the pass at depth 2 decides like the exact
    INDEX."""
    from repro_torch.core import DetectionEngine

    grids = {}
    for depth in (0, 2):
        eng = DetectionEngine(cfg, prefetch_depth=depth)
        ops.tile_scores.launches = 0
        grids[depth], _ = eng._run_tiled_scan(
            eng._tiled_prologue(ds, p, index))
        torch.cuda.synchronize()
        st = eng._scan_stats
        if ops.tile_scores.launches != st["groups_run"] or not st["groups_run"]:
            raise AssertionError(f"S=2048 depth {depth}: launches "
                                 f"{ops.tile_scores.launches} != groups run")
        log(f"[4] S=2048 prefetch depth {depth}: {st['groups_run']} groups, "
            f"scan {st['scan_s']:.3f} s (B1 device time "
            f"{st['scan_kernel_ms']:.3f} ms), staging {st['staging_s']:.3f} "
            f"s, stage wait {st['stage_wait_s']:.3f} s, compute wait "
            f"{st['compute_wait_s']:.3f} s")
    for name, a, b in zip(("C_same", "count", "non-Ē count", "error bound"),
                          grids[0], grids[2]):
        if not torch.equal(a, b):
            raise AssertionError(f"S=2048: the {name} grid differs between "
                                 f"prefetch depths 0 and 2")
    res = DetectionEngine(cfg, prefetch_depth=2).detect(ds, p, index=index)
    if not np.array_equal(res.copying, exact.copying):
        raise AssertionError("S=2048 depth 2: decisions != exact INDEX")
    log("[4] S=2048: the four grids at depths 0 and 2 are equal bit for bit; "
        "decisions at depth 2 == exact INDEX")


def phase_modes(torch, np, dev, ops, cfg, ds, p, index) -> None:
    """Phase 4, S=512: BOUND, BOUND+, HYBRID and sampled (rate 0.1) on the
    card against the same functions with device="cpu": decisions, the
    BoundState's decisions, decision buckets, considered set and counts
    equal; scores within rtol 2e-5 / atol 1e-4 (C4)."""
    from repro_torch.core import DetectionEngine
    from repro_torch.core.bound import bound_detect

    def close(a, b, what):
        a, b = np.asarray(a), np.asarray(b)
        if not np.allclose(a, b, rtol=RTOL, atol=ATOL):
            raise AssertionError(f"S=512 {what}: card and CPU differ by "
                                 f"{float(np.abs(a - b).max()):.3e}")
        return float(np.abs(a - b).max())

    for mode, timers, l_thr in (("bound", False, 0), ("bound+", True, 0),
                                ("hybrid", True, 16)):
        got = {}
        for d in (dev, "cpu"):
            res = DetectionEngine(cfg, mode=mode, device=d).detect(
                ds, p, index=index)
            _, st = bound_detect(ds, p, cfg, use_timers=timers,
                                 l_threshold=l_thr, index=index,
                                 return_state=True, device=d)
            got[str(d)] = (res, {f: getattr(st, f).cpu().numpy() for f in (
                "decided", "dec_bucket", "considered", "n0", "n_full", "c0",
                "c_hat", "err")})
        (rc, sc_), (rh, sh) = got[str(dev)], got["cpu"]
        for f in ("decided", "dec_bucket", "considered", "n0", "n_full"):
            if not np.array_equal(sc_[f], sh[f]):
                raise AssertionError(f"S=512 {mode}: BoundState.{f} differs "
                                     f"between the card and the CPU")
        if (not np.array_equal(rc.copying, rh.copying)
                or rc.counter.shared_values_examined
                != rh.counter.shared_values_examined):
            raise AssertionError(f"S=512 {mode}: decisions or shared values "
                                 f"examined differ between the card and the "
                                 f"CPU")
        err = max(close(rc.c_fwd, rh.c_fwd, f"{mode} C→"),
                  *(close(sc_[f], sh[f], f"{mode} {f}")
                    for f in ("c0", "c_hat", "err")))
        # the BOUND+ timers are ceilings of float32 quotients, so a
        # last-place difference of the scores can move a re-check by a
        # bucket: the bound computations are printed, not compared
        log(f"[4] S=512 {mode}: card == CPU (decisions, decided, dec_bucket, "
            f"considered, n0, n_full, shared values examined; "
            f"{len(rc.copying_pairs())} copying pairs, "
            f"{int((sc_['decided'] != 0).sum())} frozen early), scores max "
            f"|Δ| {err:.3e}; bound computations {rc.counter.bound_computations}"
            f" on the card, {rh.counter.bound_computations} on the CPU")
    got = {}
    for d in (dev, "cpu"):
        eng = DetectionEngine(cfg, mode="sampled", sample_rate=0.1, device=d)
        ops.tile_scores.launches = 0
        got[str(d)] = (eng.detect(ds, p), ops.tile_scores.launches)
    (rc, launches), (rh, _) = got[str(dev)], got["cpu"]
    if launches <= 0 or not np.array_equal(rc.copying, rh.copying):
        raise AssertionError("S=512 sampled: no B1 launch on the card, or "
                             "decisions differ between the card and the CPU")
    err = close(rc.c_fwd, rh.c_fwd, "sampled C→")
    log(f"[4] S=512 sampled (rate 0.1): card == CPU ({len(rc.copying_pairs())} "
        f"copying pairs, B1 launches {launches}), C→ max |Δ| {err:.3e}")


def _perturb(np, p, seed, scale):
    """The JAX package's round perturbation (tests/test_incremental.py):
    N(0, scale) noise on the claimed probabilities, clipped to
    [1e-3, 0.999]."""
    rng = np.random.default_rng(seed)
    noise = rng.normal(0.0, scale, size=p.shape).astype(np.float32)
    return np.clip(p + np.where(p > 0, noise, 0.0), 1e-3, 0.999)


def phase_slice(torch, np, dev, ops, cfg, ds, p, index, copying5) -> None:
    """Phase 17: this slice's modes at the full pass's width (phase 5's
    S=16384 corpus, index and decisions, which equal the exact INDEX):
    (a) the INCREMENTAL bootstrap (HYBRID), F ≥ 0.97 against phase 5;
    (b) one INCREMENTAL round on p perturbed by N(0, 0.01) from seed 1,
    F ≥ 0.95 against a bucketed pass on the perturbed p; (c) sample_verify
    at rate 0.1 (SCALESAMPLE): every candidate decides as phase 5 does, no
    pair outside the candidates is copying."""
    from repro_torch.core import DetectionEngine, pair_f_measure

    truth5 = _pairs_of(np, copying5)

    def f_measure(copying, truth):
        return pair_f_measure(_pairs_of(np, copying), truth)

    # (a) the bootstrap: HYBRID with the round bookkeeping
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    eng = DetectionEngine(cfg, mode="incremental")
    t0 = time.perf_counter()
    boot = eng.detect(ds, p, index=index)
    boot_s = time.perf_counter() - t0
    st = eng.last_stats
    prec, rec, f = f_measure(boot.copying, truth5)
    log(f"[17a] incremental bootstrap (HYBRID) S={ds.n_sources}: {boot_s:.3f} "
        f"s (considered {st['considered_s']:.3f}, bound scan "
        f"{st['bound_scan_s']:.3f} over {st['buckets']} buckets, rescore "
        f"{st['rescore_s']:.3f} of {st['rescored_pairs']} pairs, bookkeeping "
        f"{st['bookkeeping_s']:.3f}); bound_computations "
        f"{boot.counter.bound_computations}, shared_values_examined "
        f"{boot.counter.shared_values_examined}; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    log(f"[17a] against phase 5 (== exact INDEX): precision {prec:.4f} "
        f"recall {rec:.4f} F {f:.4f} ({len(_pairs_of(np, boot.copying))} "
        f"copying pairs)")
    if f < 0.97:
        raise AssertionError(f"HYBRID bootstrap F {f:.4f} < 0.97")
    del boot

    # (b) one round on perturbed probabilities, against a bucketed pass
    p1 = _perturb(np, p, 1, 0.01)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    rnd = eng.detect(ds, p1)
    rnd_s = time.perf_counter() - t0
    st = eng.last_stats
    peak = torch.cuda.max_memory_allocated() / 2**30
    t0 = time.perf_counter()
    ref = DetectionEngine(cfg).detect(ds, p1)
    ref_s = time.perf_counter() - t0
    prec, rec, f = f_measure(rnd.copying, _pairs_of(np, ref.copying))
    log(f"[17b] incremental round: {rnd_s:.3f} s (pass 1 {st['pass1_s']:.3f}, "
        f"rescore {st['rescore_s']:.3f} of {st['candidates']} candidates; "
        f"{st['big_entries']} big-change entries); pass1_settled "
        f"{st['pass1_settled']:.4f}; peak device memory {peak:.3f} GiB")
    log(f"[17b] against a bucketed pass on the perturbed p ({ref_s:.3f} s "
        f"with its index build): precision {prec:.4f} recall {rec:.4f} F "
        f"{f:.4f}")
    if f < 0.95:
        raise AssertionError(f"incremental round F {f:.4f} < 0.95")
    del rnd, ref, p1, eng
    gc.collect()
    torch.cuda.empty_cache()

    # (c) sample-then-verify at rate 0.1, SCALESAMPLE
    torch.cuda.reset_peak_memory_stats()
    eng = DetectionEngine(cfg, mode="sample_verify", sample_rate=0.1)
    ops.tile_scores.launches = 0              # count this path's launches
    t0 = time.perf_counter()
    res = eng.detect(ds, p)
    sv_s = time.perf_counter() - t0
    launches = ops.tile_scores.launches
    st = eng.last_stats
    ss = st["sampled_stats"]
    cand = eng._last_considered.cpu().numpy()
    if launches <= 0 or launches != ss["kernel_launches"]:
        raise AssertionError(f"sample_verify: B1 launches {launches}, the "
                             f"sampled pass counted {ss['kernel_launches']}")
    if not (res.copying[cand] == copying5[cand]).all():
        raise AssertionError("sample_verify: a candidate pair decides unlike "
                             "phase 5 (the exact INDEX)")
    if res.copying[~cand].any():
        raise AssertionError("sample_verify: a pair outside the candidate "
                             "set is copying")
    found = _pairs_of(np, res.copying)
    log(f"[17c] sample_verify rate 0.1: {sv_s:.3f} s; {st['items_sampled']} "
        f"items ({st['item_rate']}); sampled pass: index build "
        f"{ss['index_build_s']:.3f}, prologue {ss['prologue_s']:.3f}, scan "
        f"{ss['scan_s']:.3f} ({launches} B1 launches, device "
        f"{ss['scan_kernel_ms']:.3f} ms), finalize {ss['finalize_s']:.3f}; "
        f"sweep {st['sweep_s']:.3f} s ({st['sweep_rounds']} rounds, slack "
        f"{st['slack_final']}), exact rescore {st['rescore_s']:.3f} s of "
        f"{st['candidate_pairs']} candidates")
    log(f"[17c] every candidate decides as phase 5, none outside is copying; "
        f"recall of phase 5's {len(truth5)} copying pairs "
        f"{len(found & truth5) / max(len(truth5), 1):.4f}; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")


# the shard plane (phase 18): owners, and the spill cap as a fraction of the
# packed scan store (half of each owner's packed slice: under a quarter of
# the packed bytes, so blocks spill and reload)
SHARD_OWNERS = 4
SHARD_CAP_OF_PACKED = 1 / 8


def _shard_options(cap: int, spill_dir: str, n_shards: int = SHARD_OWNERS):
    """The engine options of phase 18's sharded runs."""
    return dict(n_shards=n_shards, shard_pack=True, shard_spill_bytes=cap,
                shard_spill_dir=spill_dir)


def phase_shards(torch, np, dev, ops, cfg, ds, p, ctx5, grids5) -> dict:
    """Phase 18: the row-range shard plane at the full pass's width.

    (a) The owner fan-out on phase 5's corpus, on its own index built with
    the streaming seal (4 owners, bitpacked, spilled under a cap of half of
    each owner's packed slice, in a temporary directory):
    ``owner_scan_context``, four ``detect_owner_partial`` and
    ``merge_owner_partials``; the tile list and the four grids equal phase
    5's unsharded scan (``grids5``, over the prologue ``ctx5``) bit for bit.
    (b) Every owner's peak resident bytes, of the index store and of the
    scan store, below a quarter of the unsharded stores'. (c) Seconds of
    each stage, B1's launches and device ms, the spill traffic and the peak
    device memory. (d) At S=2048 under the same options, all nine modes
    with 2 and 4 shards decide like the unsharded card run, and
    ``bucketed`` like ``index_detect_exact``. Returns B1's record on this
    path: launches and device ms.
    """
    import tempfile

    from repro_torch.core import DetectionEngine, merge_owner_partials

    K, w = ctx5.ech.n_chunks, ctx5.ech.width
    unsharded = ctx5.S_pad * K * w              # phase 5's scan store, int8
    index_bytes = ds.n_sources * ctx5.base_idx.store.n_entries
    packed = ctx5.S_pad * K * (-(-w // 8))
    cap = int(packed * SHARD_CAP_OF_PACKED)
    torch.cuda.reset_peak_memory_stats()
    with tempfile.TemporaryDirectory(prefix="cd-phase18-") as spill:
        eng = DetectionEngine(cfg, **_shard_options(cap, spill))
        ops.tile_scores.launches = 0          # count this path's launches
        t0 = time.perf_counter()
        ctx = eng.owner_scan_context(ds, p)
        ctx_s = time.perf_counter() - t0
        parts = [eng.detect_owner_partial(ds, p, s, ctx=ctx)
                 for s in range(SHARD_OWNERS)]
        t1 = time.perf_counter()
        grids = merge_owner_partials(parts, ctx.n_blocks, ctx.T)
        torch.cuda.synchronize()
        merge_s = time.perf_counter() - t1
        launches = ops.tile_scores.launches
        total_s = time.perf_counter() - t0
        groups = sum(q.stats.get("groups_run", 0) for q in parts)
        if launches <= 0 or launches != groups:
            raise AssertionError(f"phase 18: B1 launches {launches} != the "
                                 f"owners' groups {groups}")
        if not np.array_equal(ctx.coords, ctx5.coords):
            raise AssertionError("phase 18: the sharded prologue's tile list "
                                 "differs from phase 5's")
        owned = np.concatenate([q.coords for q in parts])
        if len(owned) != len(ctx.coords) or len(
                {tuple(c) for c in owned.tolist()}) != len(ctx.coords):
            raise AssertionError("phase 18: the owners' tiles do not "
                                 "partition the tile list")
        for name, a, b in zip(("C_same", "count", "non-Ē count",
                               "error bound"), grids5, grids):
            if not torch.equal(a, b):
                raise AssertionError(f"phase 18: the merged {name} grid "
                                     f"differs from phase 5's scan")
        scan = ctx.ech.store
        base = ctx.base_idx.store
        peak_scan = max(scan.shard_peak_bytes())
        peak_base = max(base.shard_peak_bytes())
        if peak_scan >= unsharded / SHARD_OWNERS or (
                peak_base >= index_bytes / SHARD_OWNERS):
            raise AssertionError(
                f"phase 18: an owner's peak resident bytes (scan store "
                f"{peak_scan}, index store {peak_base}) reach a quarter of "
                f"the unsharded stores' ({unsharded}, {index_bytes})")
        kernel_ms = sum(q.stats.get("scan_kernel_ms", 0.0) for q in parts)
        spill_b, spill_s = base.spill_stats(), scan.spill_stats()
        log(f"[18a] S={ds.n_sources}, {SHARD_OWNERS} owners, packed, spill "
            f"cap {cap} B an owner ({packed} B packed, {unsharded} B "
            f"unsharded int8): the tile list ({len(ctx.coords)} tiles) and "
            f"the four merged grids == phase 5's scan, bit for bit")
        log(f"[18b] peak resident bytes an owner: index store "
            f"{base.shard_peak_bytes()} (bar {index_bytes // SHARD_OWNERS}), "
            f"scan store {scan.shard_peak_bytes()} (bar "
            f"{unsharded // SHARD_OWNERS})")
        log(f"[18c] seconds: index build with the streaming seal "
            f"{ctx.index_build_s:.3f}, prologue {ctx.prologue_s:.3f}, owner "
            f"scans {[round(q.stats.get('scan_s', 0.0), 3) for q in parts]} (staging "
            f"{sum(q.stats.get('staging_s', 0.0) for q in parts):.3f}, "
            f"stage wait "
            f"{sum(q.stats.get('stage_wait_s', 0.0) for q in parts):.3f}, "
            f"compute wait "
            f"{sum(q.stats.get('compute_wait_s', 0.0) for q in parts):.3f}), "
            f"merge {merge_s:.3f}; context {ctx_s:.3f}, total {total_s:.3f}")
        log(f"[18c] B1 on the sharded path: {launches} launches (groups an "
            f"owner {[q.stats.get('groups_run', 0) for q in parts]}, slab "
            f"rows {[q.stats.get('slab_rows', 0) for q in parts]}), device "
            f"{kernel_ms:.3f} ms; phase 5: {ctx5.ech.n_chunks} groups over "
            f"{ctx5.S_pad} rows")
        log(f"[18c] spill: index store {spill_b}, scan store {spill_s}; peak "
            f"device memory {torch.cuda.max_memory_allocated() / 2**30:.3f} "
            f"GiB")
        del parts, grids, ctx, scan, base, eng
        gc.collect()
    torch.cuda.empty_cache()
    phase_shard_modes(torch, np, dev, cfg)
    return {"launches": launches, "device_ms": kernel_ms}


def phase_shard_modes(torch, np, dev, cfg) -> None:
    """Phase 18d: at S=2048, every mode with 2 and 4 shards (bitpacked,
    spilled under the phase's cap) decides like the unsharded card run, and
    ``bucketed`` like ``index_detect_exact``."""
    import tempfile

    from repro_torch.core import (
        DetectionEngine,
        build_index,
        index_detect_exact,
    )
    from repro_torch.core.engine import MODES
    from repro_torch.data.claims import (
        SyntheticSpec,
        oracle_claim_probs,
        synthetic_claims,
    )

    sc = synthetic_claims(SyntheticSpec(**WORLD_2048))
    ds, p = sc.dataset, oracle_claim_probs(sc)
    exact = index_detect_exact(ds, p, cfg,
                               index=build_index(ds, p, cfg, device=dev))
    seconds = {}
    cap = None
    # bucketed first: its scan store sizes the spill cap
    for mode in ("bucketed",) + tuple(m for m in MODES if m != "bucketed"):
        t0 = time.perf_counter()
        eng = DetectionEngine(cfg, mode=mode)
        ref = eng.detect(ds, p)
        seconds[mode] = [time.perf_counter() - t0]
        if mode == "bucketed":
            st = eng.last_stats
            S_pad = -(-ds.n_sources // st["tile"]) * st["tile"]
            packed = S_pad * st["chunks"] * (-(-st["chunk_width"] // 8))
            cap = int(packed * SHARD_CAP_OF_PACKED)
            if not np.array_equal(ref.copying, exact.copying):
                raise AssertionError("S=2048 bucketed: decisions != exact")
        for n in (2, 4):
            with tempfile.TemporaryDirectory(prefix="cd-phase18-") as spill:
                t0 = time.perf_counter()
                res = DetectionEngine(cfg, mode=mode, **_shard_options(
                    cap, spill, n)).detect(ds, p)
                seconds[mode].append(time.perf_counter() - t0)
            if not np.array_equal(res.copying, ref.copying):
                raise AssertionError(f"S=2048 {mode}, {n} shards: decisions "
                                     f"differ from the unsharded run")
            if mode == "bucketed" and not np.array_equal(res.copying,
                                                         exact.copying):
                raise AssertionError(f"S=2048 bucketed, {n} shards: "
                                     f"decisions != exact INDEX")
    log(f"[18d] S={ds.n_sources}, 2 and 4 shards, packed, spill cap {cap} "
        f"B: all nine modes decide like the unsharded card run, bucketed "
        f"like the exact "
        f"INDEX ({len(exact.copying_pairs())} copying pairs); seconds "
        f"(unsharded, 2, 4 shards): " + "; ".join(
            f"{m} " + "/".join(f"{x:.2f}" for x in v)
            for m, v in seconds.items()))


def _pairs_of(np, copying):
    """The unordered copying pairs (i < j) of a decision matrix."""
    i, j = np.nonzero(np.triu(copying, 1))
    return set(zip(i.tolist(), j.tolist()))


def phase_mutation(torch, np, dev, ops, cfg) -> int:
    """Phase 16: the mutation path on the card at S=512. One engine follows
    a commit / retract / rollback / transient commit / compaction schedule
    through its block-OR mask cache (``apply_mask_delta``, and
    ``undo_mask_delta`` after a commit's rollback): after every step it
    detects against the persistent index, from the cache wherever the
    schedule's deltas chain, and decides like the exact INDEX over a
    rebuild; ``copyscore_store`` over the committed store counts like its
    dense V·Vᵀ with one launch per chunk with a live entry. Returns the
    store path's launches."""
    from repro_torch.core import (
        DetectionEngine,
        build_index,
        commit_rows,
        compact_index,
        index_detect_exact,
        retract_rows,
        rollback_commit,
    )
    from repro_torch.core.index import _segment_p_stats
    from repro_torch.core.types import ClaimsDataset
    from repro_torch.data.claims import (
        SyntheticSpec,
        oracle_claim_probs,
        synthetic_claims,
    )

    sc = synthetic_claims(SyntheticSpec(**WORLD_512))
    world, p_all = sc.dataset, oracle_claim_probs(sc)

    def claims(rows):
        return (ClaimsDataset(values=world.values[rows],
                              accuracy=world.accuracy[rows]), p_all[rows])

    rows = np.arange(MUTATION_BASE_ROWS)
    idx = build_index(*claims(rows), cfg, chunk_entries=MUTATION_CHUNK,
                      row_capacity=world.n_sources, device=dev)
    q1, q2 = MUTATION_COMMITS
    first = np.arange(MUTATION_BASE_ROWS, MUTATION_BASE_ROWS + q1)
    eng = DetectionEngine(cfg)
    receipts = []

    def detect(name, source):
        """The engine on the card over the persistent index against the
        exact INDEX over a rebuild, its tile masks from ``source``."""
        ds, p = claims(rows)
        exact = index_detect_exact(ds, p, cfg,
                                   index=build_index(ds, p, cfg, device=dev))
        res = eng.detect(ds, p, index=idx)
        st = eng.last_stats
        if not np.array_equal(res.copying, exact.copying):
            raise AssertionError(f"mutation step {name!r}: bucketed decisions "
                                 f"on the card != exact INDEX over a rebuild")
        if st["kernel_launches"] <= 0:
            raise AssertionError(f"mutation step {name!r}: no B1 launch")
        if st["mask_source"] != source:
            raise AssertionError(f"mutation step {name!r}: tile masks from "
                                 f"{st['mask_source']!r}, expected {source!r}")
        return ds, exact, st

    def commit(q, new=None):
        nonlocal rows
        before = rows
        rows = np.concatenate([rows, np.arange(len(rows), len(rows) + q)
                               if new is None else new])
        info = commit_rows(idx, *claims(rows), cfg, q, compact=False)
        receipts.append((info, before, eng.apply_mask_delta(info.delta)))

    def retract():
        nonlocal rows
        gone = np.concatenate([[5, 300], first])
        before = rows
        rows = np.delete(rows, gone)
        ds, _ = claims(rows)
        info = retract_rows(idx, ds, cfg, gone)
        receipts.append((info, before, eng.apply_mask_delta(info.delta)))

    def rollback():
        nonlocal rows
        info, rows, token = receipts.pop()
        rollback_commit(idx, info)
        eng.undo_mask_delta(token)

    def transient():
        """Commit 4 rows, detect on the committed corpus, roll back and undo
        the cache's update: its bits return to the pre-commit ones."""
        before = eng._mask_cache.block_inc.copy()
        commit(4, new=first[:4])
        _, exact, _ = detect("transient commit", "cache")
        rollback()
        if not np.array_equal(eng._mask_cache.block_inc, before):
            raise AssertionError("undo_mask_delta did not restore the cache")
        log(f"[16] transient commit of 4 rows: cache hit, decisions == exact "
            f"INDEX ({len(exact.copying_pairs())} copying pairs); after the "
            f"rollback undo_mask_delta restored the cache bit for bit")

    detect("before the schedule", "fresh")           # the cache's first build
    steps = [(f"commit q={q1}", lambda: commit(q1), "cache"),
             (f"commit q={q2}", lambda: commit(q2), "cache"),
             (f"retract {len(first) + 2} rows", retract, "cache"),
             ("rollback the retraction", rollback, "fresh"),
             (f"retract {len(first) + 2} rows again", retract, "cache"),
             ("commit 4 rows and roll back", transient, "cache"),
             ("compaction", lambda: compact_index(idx, cfg), "fresh")]
    launches, padding_seen = 0, 0
    for name, step, source in steps:
        step()
        ds, exact, est = detect(name, source)
        st = idx.store
        widths = [c.shape[1] for c in st.chunks]
        p_hat, _, _ = _segment_p_stats(st.entry_p, st.entry_item >= 0,
                                       np.concatenate([[0], np.cumsum(widths)]))
        live = sum(bool((ch.item >= 0).any()) for ch in st.iter_chunks())
        acc = torch.from_numpy(ds.accuracy.astype(np.float32)).to(dev)
        ops.copyscore_store.launches = 0
        c, n = ops.copyscore_store(st, p_hat, acc, s=cfg.s, n_false=cfg.n)
        torch.cuda.synchronize()
        V = torch.from_numpy(st.to_dense()).to(dev).float()
        if (ops.copyscore_store.launches != live
                or not torch.equal(n, V @ V.T)
                or not bool(torch.isfinite(c).all())):
            raise AssertionError(f"mutation step {name!r}: copyscore_store "
                                 f"counts or launches are wrong")
        launches += live
        padding_seen = max(padding_seen, st.n_chunks - live)
        log(f"[16] {name}: S={st.n_rows} E={st.n_entries} chunks {st.n_chunks} "
            f"({st.n_delta_chunks} delta, {st.n_chunks - live} all padding); "
            f"bucketed on the card == exact INDEX over a rebuild "
            f"({len(exact.copying_pairs())} copying pairs, B1 launches "
            f"{est['kernel_launches']}, tile masks from {est['mask_source']}, "
            f"cache hits {est['mask_cache_hits']}, full builds "
            f"{est['mask_full_builds']}, cells updated "
            f"{est['mask_blocks_updated']}); copyscore_store counts == V·Vᵀ, "
            f"{live} launches == live chunks")
    if not padding_seen:
        raise AssertionError("the schedule left no all-padding chunk: the "
                             "store path's skip was not exercised")
    return launches


# phase 19: the detection service at the repo's Book-full preset
# (``book_full_spec``: 3182 sources × 20,000 items); the CLI's CopyConfig
SERVICE_CFG = dict(alpha=0.1, s=0.8, n=50.0)
SERVICE_REQUESTS = 32          # the wave: requests of SERVICE_ROWS rows
SERVICE_ROWS = 4
SERVICE_BATCH = 8              # max_batch_requests
SERVICE_PENDING = 256          # max_pending_rows
SERVICE_SNAPSHOT_EVERY = 4
# (b) new sources committed after the wave's accepted rows: independent
# rows of synthetic_query_rows (seed 2), SERVICE_COMMIT_ROWS a commit
SERVICE_NEW_SOURCES = 16
SERVICE_COMMIT_ROWS = 2
# (c) the child commits up to this many batches (seed 3); the parent kills
# it after SERVICE_KILL_AFTER acknowledgements
SERVICE_CHILD_COMMITS = 6
SERVICE_KILL_AFTER = 3
SERVICE_PROBE = 8              # requests of the probe wave (c, d)
SERVICE_RETRACT = 16           # (d) newest rows retracted
SERVICE_FLEET_OWNERS = 4
# (e) the wave's first requests through the fleet: each is a fan-out pass
# of its own (~4.5 s on an H100), so 8, not the wave's 32, keep the phase
# near its time budget
SERVICE_FLEET_REQUESTS = 8

# the kill drill's child: restores the state dir, commits the saved batches
# one by one, and prints each acknowledged epoch on a line of its own
_KILL_CHILD = r"""
import sys
sys.path.insert(0, sys.argv[1])
import numpy as np
from repro_torch.core.serving import DetectionService
state, rows, device = sys.argv[2], np.load(sys.argv[3]), sys.argv[4]
svc = DetectionService.restore(state, device=device)
print("restored", svc.epoch, flush=True)
for k in range(len(rows["values"])):
    svc.commit(rows["values"][k], rows["accuracy"][k], rows["p_claim"][k])
    print("ack", svc.epoch, flush=True)
"""


def _wave(svc, reqs, timeout=600.0):
    """Serve ``reqs`` through the service's worker thread; the responses in
    request order and the wall seconds."""
    t0 = time.perf_counter()
    with svc:
        futs = [svc.submit(r, timeout=timeout) for r in reqs]
        out = [f.result(timeout=timeout) for f in futs]
    return out, time.perf_counter() - t0


def _same_decisions(np, got, want, what):
    """Hold two lists of responses to equal decisions, request by request."""
    if len(got) != len(want):
        raise AssertionError(f"{what}: {len(got)} responses, {len(want)} "
                             f"expected")
    for a, b in zip(got, want):
        if not (np.array_equal(a.copying, b.copying)
                and np.array_equal(a.intra_copying, b.intra_copying)):
            raise AssertionError(f"{what}: request {a.rid} decides "
                                 f"differently")


def phase_service(torch, np, dev, ops, spec=None) -> dict:
    """Phase 19: the batched detection service on the card, at the repo's
    Book-full preset, with durability and the shard-owner fleet.

    (a) 32 requests of 4 query rows through the worker thread of a durable
    bucketed ``DetectionService``: every response decides like one
    ``index_detect_exact`` over the corpus plus the 128 rows, row for row.
    (b) The wave's accepted rows (no copying, as the CLI commits them) and
    16 new sources are committed (fsync'd, snapshots every 4 commits) and
    the wave re-served: cache hits > 0, and every response equals a
    cache-free service restored from the state dir. (c) A child process
    restores the state dir and commits batches one by one; it is SIGKILLed
    after its third acknowledgement, and the restore holds every
    acknowledged commit bit for bit and decides like a never-restarted twin.
    (d) A retraction of the 16 newest rows decides like a fresh service over
    the retracted corpus; its rollback like before it. (e) The wave's
    first requests through a 4-owner fleet decide like (a). Returns B1's
    launches on the path.
    """
    import os
    import signal
    import tempfile

    import repro_torch.core.serving as serving_mod
    from repro_torch.core import (
        CopyConfig,
        DetectionService,
        DetectRequest,
        DurabilityOptions,
        ReplicaRouter,
        build_index,
        index_detect_exact,
    )
    from repro_torch.core.types import ClaimsDataset
    from repro_torch.data.claims import (
        book_full_spec,
        oracle_claim_probs,
        synthetic_claims,
        synthetic_query_rows,
    )

    cuda = dev.type == "cuda"
    cfg = CopyConfig(**SERVICE_CFG)
    t0 = time.perf_counter()
    sc = synthetic_claims(spec or book_full_spec(seed=0))
    ds, p = sc.dataset, oracle_claim_probs(sc)
    S0, D = ds.n_sources, ds.n_items
    q, n_req = SERVICE_ROWS, SERVICE_REQUESTS
    vals, acc, pq, origins = synthetic_query_rows(sc, n_req * q, seed=1)

    wave = [DetectRequest(rid=i, values=vals[i * q:(i + 1) * q],
                          accuracy=acc[i * q:(i + 1) * q],
                          p_claim=pq[i * q:(i + 1) * q])
            for i in range(n_req)]
    union = ClaimsDataset(values=np.concatenate([ds.values, vals]),
                          accuracy=np.concatenate([ds.accuracy, acc]))
    up = np.concatenate([p, pq])
    t1 = time.perf_counter()
    exact = index_detect_exact(union, up, cfg,
                               index=build_index(union, up, cfg, device=dev))
    log(f"[19] S={S0} D={D}, {n_req} requests of {q} rows; data "
        f"{t1 - t0:.3f} s, exact INDEX over the {S0 + n_req * q} rows "
        f"{time.perf_counter() - t1:.3f} s ({len(exact.copying_pairs())} "
        f"copying pairs)")
    del union, up
    tmp = tempfile.TemporaryDirectory(prefix="cd-phase19-")
    state = os.path.join(tmp.name, "state")
    try:
        # -- (a) serve the wave through the worker thread ------------------
        t0 = time.perf_counter()
        svc = DetectionService(
            ds, p, cfg, mode="bucketed", max_batch_requests=SERVICE_BATCH,
            max_pending_rows=SERVICE_PENDING, device=dev,
            durability=DurabilityOptions(
                state_dir=state, snapshot_every=SERVICE_SNAPSHOT_EVERY))
        build_s = time.perf_counter() - t0
        passes, timers = [], {"commit": [], "rollback": [], "snapshot": []}
        orig = {"detect": svc.engine.detect,
                "commit_rows": serving_mod.commit_rows,
                "rollback_commit": serving_mod.rollback_commit,
                "write_snapshot": serving_mod.write_snapshot}

        def timed(name, fn):
            def call(*a, **kw):
                t = time.perf_counter()
                out = fn(*a, **kw)
                dt = time.perf_counter() - t
                # a snapshot's bytes are read now: retention prunes it later
                timers[name].append((dt, os.path.getsize(out)
                                     if name == "snapshot" else None))
                return out
            return call

        def detect(*a, **kw):
            res = orig["detect"](*a, **kw)
            passes.append(dict(svc.engine.last_stats))
            return res

        # the pass's stats and the transient commit's seconds, read around
        # the service's own calls for this measurement only
        svc.engine.detect = detect
        serving_mod.commit_rows = timed("commit", orig["commit_rows"])
        serving_mod.rollback_commit = timed("rollback",
                                            orig["rollback_commit"])
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        ops.tile_scores.launches = 0          # count this path's launches
        try:
            first, wall = _wave(svc, wave)
        finally:
            svc.engine.detect = orig["detect"]
            serving_mod.commit_rows = orig["commit_rows"]
            serving_mod.rollback_commit = orig["rollback_commit"]
        launches_a = ops.tile_scores.launches
        launches_passes = sum(s["kernel_launches"] for s in passes)
        if cuda and (launches_a <= 0 or launches_a != launches_passes):
            raise AssertionError(f"19a: B1 launches {launches_a}, the passes' "
                                 f"last_stats {launches_passes}")
        for i, resp in enumerate(first):
            rows = slice(S0 + i * q, S0 + (i + 1) * q)
            if not (np.array_equal(resp.copying, exact.copying[rows, :S0])
                    and np.array_equal(resp.intra_copying,
                                       exact.copying[rows, rows])):
                raise AssertionError(f"19a: request {i} decides differently "
                                     f"from the exact INDEX over the union")
        planted = [(r, int(o)) for r, o in enumerate(origins) if o >= 0]
        found = sum(int(first[r // q].copying[r % q, o]) for r, o in planted)
        lat = np.array([r.latency_s for r in first])
        st = svc.stats
        tc = [t for t, _ in timers["commit"]]
        tr = [t for t, _ in timers["rollback"]]
        log(f"[19a] {n_req} requests in {wall:.3f} s ({n_req / wall:.3f} "
            f"req/s); latency p50 {np.percentile(lat, 50):.3f} s p99 "
            f"{np.percentile(lat, 99):.3f} s; queue wait p50 "
            f"{st.queue_wait_p50:.3f} s p99 {st.queue_wait_p99:.3f} s; "
            f"{st.batches} engine passes, mean batch {st.mean_batch:.2f}; "
            f"service build {build_s:.3f} s (index + initial snapshot)")
        log(f"[19a] B1: {launches_a} launches, "
            f"{sum(s['scan_kernel_ms'] for s in passes):.3f} ms device time "
            f"over the {len(passes)} passes (per pass: launches "
            f"{[s['kernel_launches'] for s in passes]}, ms "
            f"{[round(s['scan_kernel_ms'], 3) for s in passes]}); pass "
            f"seconds: prologue "
            f"{[round(s['prologue_s'], 3) for s in passes]}, scan "
            f"{[round(s['scan_s'], 3) for s in passes]}, finalize "
            f"{[round(s['finalize_s'], 3) for s in passes]} (rescored pairs "
            f"{[s['rescored_pairs'] for s in passes]}); mask source "
            f"{[s['mask_source'] for s in passes]}")
        log(f"[19a] transient commit {sum(tc):.3f} s / rollback {sum(tr):.3f} "
            f"s over {len(tc)} passes; staged {st.host_copy_bytes} B of query "
            f"rows; peak device memory "
            + (f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB"
               if cuda else "not measured"))
        log(f"[19a] decisions == exact INDEX over the union, row for row; "
            f"planted copiers detected {found}/{len(planted)}")

        # -- (b) commit, re-serve, hold against a cache-free restore --------
        twin = DetectionService(ds, p, cfg, mode="bucketed",
                                max_pending_rows=SERVICE_PENDING,
                                result_cache=False, device=dev)

        def commit_both(v, a, pc):
            t = time.perf_counter()
            svc.commit(v, a, pc)
            dt = time.perf_counter() - t
            twin.commit(v, a, pc)
            return dt

        def hold_restored(responses, what):
            t = time.perf_counter()
            cold = DetectionService.restore(state, result_cache=False,
                                            device=dev)
            restore_s = time.perf_counter() - t
            again, _ = _wave(cold, wave)
            _same_decisions(np, responses, again, what)
            return cold.restore_info, restore_s

        serving_mod.write_snapshot = timed("snapshot",
                                           orig["write_snapshot"])
        try:
            accepted = 0
            commit_s = []                    # seconds of each commit()
            for req, resp in zip(wave, first):
                keep = (~resp.copying.any(axis=1)
                        & ~resp.intra_copying.any(axis=1))
                if keep.any():
                    commit_s.append(commit_both(req.values[keep],
                                                req.accuracy[keep],
                                                req.p_claim[keep]))
                    accepted += int(keep.sum())
            hits0 = svc.stats.cache_hits
            resend1, _ = _wave(svc, wave)
            hits1 = svc.stats.cache_hits - hits0
            if accepted:
                hold_restored(resend1, "19b (accepted rows)")
            else:
                _same_decisions(np, resend1, first, "19b (no commit)")
            n_accepted_commits = len(commit_s)
            nv, na, npc, _ = synthetic_query_rows(sc, SERVICE_NEW_SOURCES,
                                                  p_copier=0.0, seed=2)
            k = SERVICE_COMMIT_ROWS
            for i in range(0, SERVICE_NEW_SOURCES, k):
                commit_s.append(commit_both(nv[i:i + k], na[i:i + k],
                                            npc[i:i + k]))
        finally:
            serving_mod.write_snapshot = orig["write_snapshot"]
        hits0 = svc.stats.cache_hits
        resend2, wall2 = _wave(svc, wave)
        hits2 = svc.stats.cache_hits - hits0
        info, restore_s = hold_restored(resend2, "19b (new sources)")
        if hits1 + hits2 <= 0:
            raise AssertionError("19b: the re-served waves had no cache hit")
        snaps = timers["snapshot"]
        log(f"[19b] the CLI's rule accepts {accepted} of {n_req * q} wave rows "
            f"(no copying found); re-served wave: {hits1} cache hits of "
            f"{n_req}; then {SERVICE_NEW_SOURCES} new independent sources in "
            f"{len(commit_s) - n_accepted_commits} commits of {k} rows")
        log(f"[19b] commit (fsync'd) ms: median "
            f"{np.median(commit_s) * 1e3:.3f}, max {max(commit_s) * 1e3:.3f} "
            f"over {len(commit_s)} commits; epoch {svc.epoch}; snapshots "
            f"written in (s, B): {[(round(t, 3), b) for t, b in snaps]}")
        log(f"[19b] re-served wave after the commits: {hits2} cache hits, "
            f"{wall2:.3f} s; both re-serves == a cache-free service restored "
            f"from the state dir; restore {restore_s:.3f} s (snapshot epoch "
            f"{info.snapshot_epoch}, {info.replayed_commits} commits "
            f"replayed in {info.replay_s:.3f} s, load "
            f"{info.snapshot_load_s:.3f} s)")
        del resend1, resend2

        # -- (c) kill and restart ----------------------------------------
        svc._log.close()                 # the child writes the log now
        del svc
        gc.collect()
        cv, ca, cpc, _ = synthetic_query_rows(
            sc, SERVICE_CHILD_COMMITS * k, p_copier=0.0, seed=3)
        batches = {"values": cv.reshape(SERVICE_CHILD_COMMITS, k, D),
                   "accuracy": ca.reshape(SERVICE_CHILD_COMMITS, k),
                   "p_claim": cpc.reshape(SERVICE_CHILD_COMMITS, k, D)}
        rows_file = os.path.join(tmp.name, "child_rows.npz")
        np.savez(rows_file, **batches)
        n_before, e_before = twin.resident.n_corpus, twin.epoch
        child = subprocess.Popen(
            [sys.executable, "-c", _KILL_CHILD, str(ROOT / "src"), state,
             rows_file, dev.type], stdout=subprocess.PIPE, text=True)
        acks = []
        t_child = time.perf_counter()
        try:
            for line in child.stdout:
                if line.startswith("ack"):
                    acks.append(int(line.split()[1]))
                    if len(acks) == SERVICE_KILL_AFTER:
                        child.send_signal(signal.SIGKILL)
                        break
        finally:
            child.kill()
            child.wait()
            child.stdout.close()
        child_s = time.perf_counter() - t_child
        if len(acks) != SERVICE_KILL_AFTER:
            raise AssertionError(f"19c: the child acknowledged {acks} before "
                                 f"it ended (rc {child.returncode})")
        t = time.perf_counter()
        svc = DetectionService.restore(state, device=dev)
        restore_s = time.perf_counter() - t
        info = svc.restore_info
        if svc.epoch < acks[-1] or svc.epoch > e_before + SERVICE_CHILD_COMMITS:
            raise AssertionError(f"19c: restored epoch {svc.epoch}, last "
                                 f"acknowledged {acks[-1]}")
        landed = svc.epoch - e_before
        for j in range(landed):
            rows = slice(n_before + j * k, n_before + (j + 1) * k)
            if not (np.array_equal(svc.resident.values[rows],
                                   batches["values"][j])
                    and np.array_equal(svc.resident.accuracy[rows],
                                       batches["accuracy"][j])
                    and np.array_equal(svc.resident.p_claim[rows],
                                       batches["p_claim"][j])):
                raise AssertionError(f"19c: commit {j + 1} of the child is "
                                     f"not there bit for bit")
            twin.commit(batches["values"][j], batches["accuracy"][j],
                        batches["p_claim"][j])
        probe = wave[:SERVICE_PROBE]
        got, _ = _wave(svc, probe)
        want, _ = _wave(twin, probe)
        _same_decisions(np, got, want, "19c (restored vs twin)")
        log(f"[19c] child killed after acknowledging epochs {acks} "
            f"({child_s:.3f} s from spawn); restored epoch {svc.epoch} "
            f"({landed} child commits landed) in {restore_s:.3f} s: snapshot "
            f"epoch {info.snapshot_epoch} + {info.replayed_commits} replayed "
            f"({info.replay_s:.3f} s, "
            f"{info.replay_s / max(info.replayed_commits, 1) * 1e3:.3f} ms a "
            f"commit; snapshot load {info.snapshot_load_s:.3f} s), "
            f"{info.discarded_bytes} torn-tail bytes "
            f"discarded, {info.skipped_snapshots} snapshots skipped; every "
            f"acknowledged commit's rows bit for bit; probe wave == the "
            f"never-restarted twin")
        del twin

        # -- (d) retract the newest rows, then roll the retraction back ----
        pre, _ = _wave(svc, probe)
        n = svc.resident.n_corpus
        t = time.perf_counter()
        rinfo = svc.retract(np.arange(n - SERVICE_RETRACT, n))
        retract_s = time.perf_counter() - t
        post, _ = _wave(svc, probe)
        m = svc.resident.n_corpus
        fresh = DetectionService(
            ClaimsDataset(values=svc.resident.values[:m].copy(),
                          accuracy=svc.resident.accuracy[:m].copy()),
            svc.resident.p_claim[:m].copy(), cfg, mode="bucketed",
            result_cache=False, device=dev)
        want, _ = _wave(fresh, probe)
        _same_decisions(np, post, want, "19d (retracted vs fresh)")
        del fresh
        t = time.perf_counter()
        svc.rollback_last_retract()
        rollback_s = time.perf_counter() - t
        back, _ = _wave(svc, probe)
        _same_decisions(np, back, pre, "19d (rolled back vs before)")
        log(f"[19d] retracted the {SERVICE_RETRACT} newest rows in "
            f"{retract_s * 1e3:.3f} ms ({rinfo.touched_entries} entries "
            f"touched, {rinfo.gc_entries} GC'd); probe wave == a fresh "
            f"service over the retracted corpus; rollback "
            f"{rollback_s * 1e3:.3f} ms, probe wave == before the retraction")
        svc._log.close()
        del svc, pre, post, back, want
        gc.collect()

        # -- (e) the shard-owner fleet ------------------------------------
        t = time.perf_counter()
        fleet = ReplicaRouter(ds, p, cfg, shard_owners=SERVICE_FLEET_OWNERS,
                              shard_pack=True, mode="bucketed", device=dev)
        fleet_build = time.perf_counter() - t
        eng = fleet.replicas[0].engine
        owner_launches = [0] * SERVICE_FLEET_OWNERS
        orig_partial = eng.detect_owner_partial

        def partial(*a, **kw):
            part = orig_partial(*a, **kw)
            owner_launches[part.owner] += part.stats.get("kernel_launches", 0)
            return part

        eng.detect_owner_partial = partial
        try:
            reqs = wave[:SERVICE_FLEET_REQUESTS]
            t = time.perf_counter()
            out = [fleet.submit(r).result() for r in reqs]
            fleet_s = time.perf_counter() - t
        finally:
            eng.detect_owner_partial = orig_partial
        _same_decisions(np, out, first[:len(reqs)], "19e (fleet vs 19a)")
        if cuda and min(owner_launches) <= 0:
            raise AssertionError(f"19e: an owner launched no B1 "
                                 f"({owner_launches})")
        log(f"[19e] {SERVICE_FLEET_OWNERS}-owner fleet (packed): "
            f"{len(reqs)} requests in {fleet_s:.3f} s "
            f"({len(reqs) / fleet_s:.3f} req/s, one fan-out pass each), "
            f"built in {fleet_build:.3f} s; B1 launches an owner "
            f"{owner_launches}; decisions == 19a's")
        del fleet, eng, out
    finally:
        tmp.cleanup()
    if cuda:
        torch.cuda.synchronize()
    launches = ops.tile_scores.launches
    if cuda and launches <= 0:
        raise AssertionError("phase 19: the service launched no B1")
    gc.collect()
    return {"launches": launches}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"chip_smoke: {ROOT} holds no src/repro_torch; run this script "
              f"from the root of a checkout of the repository", file=sys.stderr)
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
                         (128, 3, 1, 40), (256, 2, 1, w_full),
                         (256, 2, 2, w_full)):
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
    sc = synthetic_claims(SyntheticSpec(**WORLD_512))
    p512 = oracle_claim_probs(sc)
    ds512 = sc.dataset
    idx512 = build_index(ds512, p512, cfg, device=dev)
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
    sc = synthetic_claims(SyntheticSpec(**WORLD_2048))
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
    phase_prefetch(torch, np, dev, ops, cfg, sc.dataset, p2k,
                   build_index(sc.dataset, p2k, cfg, device=dev), exact)
    phase_modes(torch, np, dev, ops, cfg, ds512, p512, idx512)

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
    log(f"[5] staging at prefetch depth {st['prefetch_depth']} (s): staging "
        f"{st['staging_s']:.3f} on the producer thread, stage wait "
        f"{st['stage_wait_s']:.3f} (the kernel loop waiting for a slab), "
        f"compute wait {st['compute_wait_s']:.3f} (the producer waiting for "
        f"a slot or queue place), beside scan {st['scan_s']:.3f} and B1 "
        f"device time {st['scan_kernel_ms'] / 1e3:.3f}")
    log(f"[5] max device memory {torch.cuda.max_memory_allocated() / 2**30:.3f} "
        f"GiB; pairs considered {res.counter.pairs_considered}; copying "
        f"{len(found)}; planted recall {recall:.4f} "
        f"({len(found & sc.copies)}/{len(sc.copies)})")
    if recall < 0.9:
        raise AssertionError(f"planted-pair recall {recall:.4f} < 0.9")

    # sample of the pass's own groups, kernel vs plain version
    ctx = eng._tiled_prologue(ds, p, index)
    groups = eng._scan_groups(ctx)
    T = ctx.T
    acc = torch.from_numpy(ctx.acc_pad).to(dev)
    for gi in sorted({0, len(groups) // 2, len(groups) - 1}):
        ks, gmask = groups[gi]
        v, p_g, d_g, o_g, coords_g = eng._stage_group(ctx, ks, gmask)
        err = _compare_group(torch, ops, ref, v, acc, p_g, d_g, o_g, coords_g,
                             T, cfg)
        worst = max(worst, err)
        log(f"[5] group {gi} (chunks {ks}): {int(gmask.sum())} live tiles, "
            f"kernel == plain (counts equal, max |Δ| scores {err:.3e})")

    # -- 6. timing at the full pass's shapes ----------------------------------
    ks, gmask = groups[len(groups) // 2]
    v, p_g, d_g, o_g, coords_g = eng._stage_group(ctx, ks, gmask)
    n = coords_g.shape[0]
    stacks = [torch.zeros((n, T, T), device=dev) for _ in range(5)]
    args = (v, acc, p_g, d_g, o_g, coords_g, stacks)
    kw = dict(tile=T, s=cfg.s, n_false=cfg.n)
    ops.tile_scores(*args, **kw)                # two launches from zero
    first = [x.clone() for x in stacks]
    for x in stacks:
        x.zero_()
    ops.tile_scores(*args, **kw)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(first, stacks)):
        raise AssertionError("B1: two launches on the same inputs differ")
    del first
    ms = _time_ms(torch, lambda: ops.tile_scores(*args, **kw), 10)
    plain_ms = _time_ms(torch, lambda: ref.tile_scores_torch(*args, **kw), 2)
    v2 = v.reshape(ctx.S_pad, -1)
    int_mm_ms = _time_ms(torch, lambda: torch._int_mm(v2, v2.t()), 5)
    live_rows = coords_g[coords_g[:, 0] >= 0].cpu().tolist()
    row_first = {}
    for r, c in live_rows:
        row_first[r] = min(c, row_first.get(r, c))

    def live_product():                     # the same pairs B1 scores
        for r, c0 in row_first.items():
            torch._int_mm(v2[r * T:(r + 1) * T], v2[c0 * T:].t())

    # the calls cover the live pairs exactly when every row's live tiles
    # run from its first live column to the last column
    same_pairs = len(live_rows) == sum(ctx.S_pad // T - c0
                                       for c0 in row_first.values())
    live_mm_ms = _time_ms(torch, live_product, 5)
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
        f"{T}x{T}, Gc={Gc}, w={w}, slab {tuple(v.shape)} ({card}); two "
        f"launches bit-equal")
    log(f"[6] kernel {ms:.4f} ms; plain version {plain_ms:.4f} ms; bound "
        f"{bound_ms:.4f} ms by {bound_by} (bytes {t_bytes:.4f} ms for "
        f"{nbytes} B, int8 {t_i8:.4f} ms, f32 {t_f32:.4f} ms)")
    log(f"[6] torch._int_mm, count product only, not the fused function: "
        f"{int_mm_ms:.4f} ms over the full {ctx.S_pad}^2 square (w·Gc="
        f"{w * Gc}); {live_mm_ms:.4f} ms over the live tiles' rows, one call "
        f"per row block from its first live column ({len(row_first)} calls; "
        f"the same pairs as B1: {same_pairs})")
    log(f"[6] int8 operations executed: B1 {int8_ops / ms / 1e9:.1f} TOP/s "
        f"(with its five-channel epilogue and stack traffic), torch._int_mm "
        f"over the live tiles {int8_ops / live_mm_ms / 1e9:.1f} TOP/s "
        f"(product alone), of the {INT8_OPS / 1e12:.0f} TOP/s int8 peak")
    _tc_report("6", "copyscore_fused", "copyscore_fused_kernel",
               "copyscore_fused_info")
    log(f"[6] full pass: {launches} launches, kernel device time "
        f"{st['scan_kernel_ms']:.3f} ms; bound × launches "
        f"{bound_ms * launches:.3f} ms")
    for x in (ms, plain_ms, int_mm_ms, live_mm_ms, bound_ms):
        if not math.isfinite(x) or x <= 0:
            raise AssertionError("a timing is not a positive number")
    b1 = {"launches": launches, "max_abs_err": worst, "ms": ms,
          "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by}
    b1_pass = launches
    del (groups, acc, v, p_g, d_g, o_g, coords_g, stacks, args, v2,
         ds512, idx512, idx2k, p512, p2k, exact)
    gc.collect()
    torch.cuda.empty_cache()

    # -- 18. the row-range shard plane at the full pass's width -------------
    # phase 5's scan, rerun on its prologue, stays on the card for the
    # comparison with the owners' merge
    grids5, _ = eng._run_tiled_scan(ctx)
    sharded = phase_shards(torch, np, dev, ops, cfg, ds, p, ctx, grids5)
    del grids5
    gc.collect()
    torch.cuda.empty_cache()

    # -- 13. B2/B3 vs plain, and B3 vs B1's scatter on one chunk -------------
    worst_single = phase_copyscore_cases(torch, dev, ops, ref, cfg, w_full)

    # -- 14. copyscore_store over the full pass's store (B3) -----------------
    b3 = phase_store(torch, np, dev, ops, ref, cfg, card, ctx, ds)

    # -- 15. the legacy per-tile dataflow (B2) against the fused one ---------
    b2 = phase_legacy(torch, np, dev, ops, ref, cfg, card)

    # -- 16. the mutation path at S=512 --------------------------------------
    phase_mutation(torch, np, dev, ops, cfg)

    # -- 17. this slice's modes at the full pass's width ---------------------
    copying5 = res.copying
    del eng, res, ctx                         # phase 5's grids leave the card
    gc.collect()
    torch.cuda.empty_cache()
    phase_slice(torch, np, dev, ops, cfg, ds, p, index, copying5)

    # the detection side's data leave the card before the LM phases
    del sc, ds, p, index, copying5
    gc.collect()
    torch.cuda.empty_cache()

    # -- 19. the detection service at the Book-full preset -------------------
    service = phase_service(torch, np, dev, ops)
    gc.collect()
    torch.cuda.empty_cache()

    # -- 7. flash attention vs plain, every case ----------------------------
    flash_worst = phase_flash_cases(torch, dev, ops, ref)

    # -- 8. the LM slice at full Llama-3.2-1B width --------------------------
    llama = phase_llama(torch, np, dev, ops)

    # -- 9. flash timing at the prefill's shapes -----------------------------
    fl = phase_flash_timing(torch, dev, ops, ref, card, llama)

    # -- 10. flash backward vs plain, every case -----------------------------
    bwd_worst = phase_flash_bwd_cases(torch, dev, ops, ref)

    # -- 11. the training slice at full Llama-3.2-1B width -------------------
    training = phase_train(torch, ops)

    # -- 12. flash backward timing at the training step's shapes -------------
    bt = phase_flash_bwd_timing(torch, dev, ops, ref, card, training)
    bwd = []
    for name, key, line in (("flash_attention_bwd_dq", "dq", 151),
                            ("flash_attention_bwd_dkv", "dkv", 180)):
        bwd.append({
            "name": name,
            "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
            "replaces": f"src/repro/kernels/flash_attention.py:{line}",
            "launches": training["launches"][key],
            **bt[key],
            "max_abs_err": max(bwd_worst[key], bt[key]["max_abs_err"]),
        })

    single = [{
        "name": name,
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/copyscore.cu",
        "replaces": f"src/repro/kernels/copyscore.py:{line}",
        **rec,
        "max_abs_err": max(rec["max_abs_err"], worst_single[name]),
        "library_ms": None,
    } for name, line, rec in (("copyscore_err", 89, b2), ("copyscore", 67, b3))]
    # B1's launches: the full pass's, the sharded fan-out's and the
    # service's, added
    b1["launches"] = b1_pass + sharded["launches"] + service["launches"]
    b1["launches_by_path"] = {"bucketed pass (phase 5)": b1_pass,
                              "owner fan-out (phase 18)": sharded["launches"],
                              "detection service (phase 19)":
                                  service["launches"]}
    record = {"kernels": [{
        "name": "copyscore_fused",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/copyscore_fused.cu",
        "replaces": "src/repro/kernels/copyscore.py:192",
        **b1,
        "library_ms": None,
    }, *single, {
        "name": "flash_attention_fwd",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention_fwd.cu",
        "replaces": "src/repro/kernels/flash_attention.py:58",
        "launches": llama["launches"],
        "max_abs_err": max(flash_worst, fl["max_abs_err"]),
        "ms": fl["ms"],
        "plain_ms": fl["plain_ms"],
        "bound_ms": fl["bound_ms"],
        "bound_by": fl["bound_by"],
        "library_ms": fl["library_ms"],
    }, *bwd]}
    print(json.dumps(record), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
