#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Drives the port's two paths on the card — the detection pass
``repro_torch.core.DetectionEngine(mode="bucketed").detect`` and the LM
serving path ``repro_torch.models.Model.prefill`` with
``repro_torch.runtime.ServeLoop`` — and checks them phase by phase; any
failure exits non-zero. Phases:

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
     the bound from the kernel's note;
  7. the flash-attention kernel against its plain PyTorch version on the
     card: MHA, GQA (group 4), MQA, causal and not, windows 32 and 100,
     head_dim 64 and 128, float32 and bfloat16, ragged Sq = Sk = 1000 and
     Sq != Sk; o and lse within the stated tolerances, and o == 1 for an
     all-ones v;
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
     it) and the bound computed from the shapes.

The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``. Needs one card; exits 2 without one.
"""
from __future__ import annotations

import gc
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
    n, pre_ms = llama["launches"], llama["prefill_s"] * 1e3
    log(f"[9] in the prefill: {n} launches x {ms:.4f} ms = {n * ms:.3f} ms of "
        f"{pre_ms:.3f} ms ({n * ms / pre_ms:.1%})")
    for x in (ms, plain_ms, library_ms, bound_ms):
        if not math.isfinite(x) or x <= 0:
            raise AssertionError("a timing is not a positive number")
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "max_abs_err": d_o}


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
    b1 = {"launches": launches, "max_abs_err": worst, "ms": ms,
          "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by}
    # the detection pass's data leave the card before the LM phases
    del (sc, ds, p, index, eng, res, ctx, groups, host, acc, v, p_g, d_g, o_g,
         coords_g, stacks, args, v2, idx512, idx2k, p512, p2k, exact)
    gc.collect()
    torch.cuda.empty_cache()

    # -- 7. flash attention vs plain, every case ----------------------------
    flash_worst = phase_flash_cases(torch, dev, ops, ref)

    # -- 8. the LM slice at full Llama-3.2-1B width --------------------------
    llama = phase_llama(torch, np, dev, ops)

    # -- 9. flash timing at the prefill's shapes -----------------------------
    fl = phase_flash_timing(torch, dev, ops, ref, card, llama)

    record = {"kernels": [{
        "name": "copyscore_fused",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/copyscore_fused.cu",
        "replaces": "src/repro/kernels/copyscore.py:192",
        **b1,
        "library_ms": None,
    }, {
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
    }]}
    print(json.dumps(record), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
