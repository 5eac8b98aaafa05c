"""The engine on the row-range shard plane.

Every mode with ``n_shards`` ∈ {1, 2, 4}, plain, bitpacked, and bitpacked
under a spill cap, decides like the unsharded port engine, and ``exact`` /
``bucketed`` like ``index_detect_exact`` (never against the JAX engine's
tiled outputs, which fail on the installed jax: ROADMAP C1). The owner
fan-out's merged grids equal the unsharded scan's bit for bit at equal chunk
groups; an incomplete set of partials is refused; a fault in one owner's
staging is one ``ShardScanError`` carrying that owner and its root cause,
with nothing merged (the port's counterpart of the JAX package's
``test_shard_faults.py::test_shard_fault_mid_scan_is_one_typed_error``); and
a commit → retract → commit schedule on a sharded index decides like a
rebuild. The ``gpu`` case holds the sharded scan on the card against the
CPU run.
"""
import torch_threads  # noqa: F401  (caps torch's threads a worker)
import numpy as np
import pytest
import torch

import repro_torch.core.shardplan as shardplan
from repro_torch.core import (
    CopyConfig,
    DetectionEngine,
    ShardPlan,
    ShardScanError,
    build_index,
    commit_rows,
    index_detect_exact,
    merge_owner_partials,
    retract_rows,
    shard_store,
)
from repro_torch.core.engine import MODES
from repro_torch.core.types import ClaimsDataset
from repro_torch.data.claims import (
    SyntheticSpec,
    oracle_claim_probs,
    synthetic_claims,
)

CFG = CopyConfig(alpha=0.1, s=0.8, n=50.0)
SPECS = {
    64: SyntheticSpec(n_sources=64, n_items=384, coverage="book",
                      n_cliques=4, clique_size=3, clique_items=12, seed=0),
    512: SyntheticSpec(n_sources=512, n_items=768, coverage="book",
                       n_cliques=14, clique_size=3, clique_items=12, seed=0),
}
KW = dict(device="cpu", tile=64, sample_rate=0.2, sample_seed=1)
#: plain, bitpacked, and bitpacked under a spill cap small enough that
#: every owner spills and reloads
CONFIGS = {"plain": {}, "pack": {"shard_pack": True},
           "pack+spill": {"shard_pack": True, "shard_spill_bytes": 256}}
RTOL, ATOL = 2e-5, 1e-4


class InjectedFault(RuntimeError):
    """A fault planted in an owner's staging."""


_WORLDS: dict = {}


def _world(S):
    """(ds, p, exact decisions) of the S-source world, made once."""
    if S not in _WORLDS:
        sc = synthetic_claims(SPECS[S])
        ds, p = sc.dataset, oracle_claim_probs(sc)
        exact = index_detect_exact(ds, p, CFG, index=build_index(
            ds, p, CFG, device="cpu")).copying
        _WORLDS[S] = (ds, p, exact, {})
    return _WORLDS[S]


def _perturb(p, seed):
    rng = np.random.default_rng(seed)
    noise = rng.normal(0.0, 0.01, size=p.shape).astype(np.float32)
    return np.clip(p + np.where(p > 0, noise, 0.0), 1e-3, 0.999)


def _run(mode, ds, p, **opts):
    """One engine's decisions; ``incremental`` bootstraps, then one round."""
    eng = DetectionEngine(CFG, mode=mode, **KW, **opts)
    out = [eng.detect(ds, p).copying]
    if mode == "incremental":
        out.append(eng.detect(ds, _perturb(p, 1)).copying)
    return out


def _reference(S, mode):
    ds, p, _, refs = _world(S)
    if mode not in refs:
        refs[mode] = _run(mode, ds, p)
    return refs[mode]


def _cases():
    for S in (64, 512):
        for mode in MODES:
            for n in (1, 2, 4):
                for name in CONFIGS:
                    # at S=512: with one shard the options are the
                    # unsharded path's, and pairwise reads no index, so the
                    # plain case stands for the three configurations there
                    if S == 512 and name != "plain" and (
                            n == 1 or mode == "pairwise"):
                        continue
                    yield S, mode, n, name


@pytest.mark.parametrize("S,mode,n_shards,config", list(_cases()))
def test_modes_sharded_decide_like_unsharded(tmp_path, S, mode, n_shards,
                                             config):
    ds, p, exact, _ = _world(S)
    opts = dict(CONFIGS[config], n_shards=n_shards)
    if "shard_spill_bytes" in opts:
        opts["shard_spill_dir"] = str(tmp_path)
    got = _run(mode, ds, p, **opts)
    for a, b in zip(got, _reference(S, mode)):
        np.testing.assert_array_equal(a, b)
    if mode in ("exact", "bucketed"):
        np.testing.assert_array_equal(got[0], exact)


def _unsharded_scan(eng, ds, p, items=None):
    """The unsharded engine's prologue and scan grids (on the same items)."""
    if items is not None:
        ds, p = ds.subset_items(items), p[:, items]
    ctx = eng._tiled_prologue(ds, p)
    grids, _ = eng._run_tiled_scan(ctx)
    return ctx, grids


@pytest.mark.parametrize("mode", DetectionEngine.OWNER_FANOUT_MODES)
@pytest.mark.parametrize("chunk_group,config,group_bytes", [
    (1, "plain", 64 << 20), (1, "pack+spill", 64 << 20), (2, "pack", 64 << 20),
    (None, "pack+spill", 1 << 16)])
def test_owner_fanout_merges_bit_equal(tmp_path, mode, chunk_group, config,
                                       group_bytes):
    """owner_scan_context + detect_owner_partial per owner +
    finalize_owner_partials: at equal chunk groups the merged grids and the
    tile list equal the single pass's bit for bit, and the decisions (and
    C→) equal it; with chunk_group=None under a small byte budget the
    packed budget groups 8× more chunks, and decisions still equal."""
    ds, p, exact, _ = _world(512)
    opts = dict(CONFIGS[config], n_shards=4, chunk_group=chunk_group,
                chunk_group_bytes=group_bytes, shard_spill_dir=str(tmp_path))
    base = DetectionEngine(CFG, mode=mode, chunk_group=chunk_group,
                           chunk_group_bytes=group_bytes, **KW)
    eng = DetectionEngine(CFG, mode=mode, **KW, **opts)
    ctx = eng.owner_scan_context(ds, p)
    parts = [eng.detect_owner_partial(ds, p, s, ctx=ctx)
             for s in np.random.default_rng(0).permutation(4)]
    assert sum(len(q.coords) for q in parts) == ctx.n_tiles
    bctx, grids = _unsharded_scan(base, ds, p, ctx.items)
    np.testing.assert_array_equal(ctx.coords, bctx.coords)
    if ctx.Gc == bctx.Gc:
        merged = merge_owner_partials(parts, ctx.n_blocks, ctx.T)
        for a, b in zip(merged, grids):
            assert torch.equal(a, b)
    else:
        assert chunk_group is None and ctx.Gc > bctx.Gc
    res = eng.finalize_owner_partials(ds, p, ctx, parts)
    ref = base.detect(ds, p)
    np.testing.assert_array_equal(res.copying, ref.copying)
    if ctx.Gc == bctx.Gc:
        np.testing.assert_array_equal(res.c_fwd, ref.c_fwd)
    if mode == "bucketed":
        np.testing.assert_array_equal(res.copying, exact)
        st = eng.last_stats
        assert st["n_shards"] == 4 and len(st["owner_scan_s"]) == 4
        assert st["kernel_launches"] == 0       # the CPU launches no kernel
        if config == "pack+spill":
            assert st["spill"]["reloads"] > 0


def test_owner_fanout_refuses_bad_inputs():
    ds, p, _, _ = _world(64)
    eng = DetectionEngine(CFG, n_shards=2, **KW)
    ctx = eng.owner_scan_context(ds, p)
    parts = [eng.detect_owner_partial(ds, p, s, ctx=ctx) for s in range(2)]
    # the last owner missing: only the finalize, which knows the owner
    # count, can tell; the merge alone refuses the rest
    with pytest.raises(ValueError, match="exactly once"):
        eng.finalize_owner_partials(ds, p, ctx, parts[:1])
    for bad in (parts[1:], parts + parts[:1], [parts[0]] * 2):
        with pytest.raises(ValueError, match="exactly once"):
            eng.finalize_owner_partials(ds, p, ctx, bad)
        with pytest.raises(ValueError, match="exactly once"):
            merge_owner_partials(bad, ctx.n_blocks, ctx.T)
    with pytest.raises(ValueError, match="out of range"):
        eng.detect_owner_partial(ds, p, 2, ctx=ctx)
    with pytest.raises(ValueError, match="fan-out supports"):
        DetectionEngine(CFG, mode="exact", n_shards=2, **KW).owner_scan_context(
            ds, p)
    with pytest.raises(ValueError, match="row-range-sharded"):
        DetectionEngine(CFG, **KW).owner_scan_context(ds, p)


@pytest.mark.parametrize("seed", range(4))
def test_degenerate_owner_placements_decide_like_one_pass(seed):
    """Owner placements with empty and single-row ranges and ~1.25× skew,
    on a sharded index passed in: the fan-out decides like the single pass,
    C→ and Pr(⊥) equal."""
    rng = np.random.default_rng(seed)
    S, D = int(rng.integers(16, 49)), 24
    vals = rng.integers(0, 4, (S, D)).astype(np.int32)
    vals[rng.random((S, D)) < 0.3] = -1
    vals[S // 2] = vals[1]                      # one certain copier pair
    ds = ClaimsDataset(values=vals,
                       accuracy=rng.uniform(0.4, 0.9, S).astype(np.float32))
    p = rng.uniform(0.3, 0.9, (S, D)).astype(np.float32)
    n = int(rng.integers(2, 6))
    ref = DetectionEngine(CFG, device="cpu", tile=16).detect(
        ds, p, index=build_index(ds, p, CFG, device="cpu"))
    if seed % 2:
        big = min(S - 1, max(1, int(round(1.25 * S / n))))
        rest = np.arange(n) * (S - big) // (n - 1)
        bounds = np.concatenate(([0], big + rest))
    else:
        bounds = np.concatenate(([0], np.sort(rng.integers(0, S + 1, n - 1)),
                                 [S]))
    idx = build_index(ds, p, CFG, device="cpu")
    idx.store = shard_store(idx.store, ShardPlan(bounds=bounds))
    eng = DetectionEngine(CFG, device="cpu", tile=16)
    ctx = eng.owner_scan_context(ds, p, index=idx)
    parts = [eng.detect_owner_partial(ds, p, s, ctx=ctx) for s in range(n)]
    res = eng.finalize_owner_partials(ds, p, ctx, parts[::-1])
    for f in ("copying", "c_fwd", "pr_independent"):
        np.testing.assert_array_equal(getattr(res, f), getattr(ref, f))


@pytest.mark.parametrize("depth", [0, 2])
def test_owner_fault_is_one_typed_error(monkeypatch, depth):
    """A fault in an owner's staging surfaces as ONE ShardScanError with the
    owner's id and the fault as its cause, nothing merges, and the engine
    decides as before once the fault clears."""
    ds, p, exact, _ = _world(64)
    eng = DetectionEngine(CFG, n_shards=2, prefetch_depth=depth,
                          **{**KW, "tile": 16})      # 4 row blocks, 2 owners
    # armed on the engine's GATHERED scan store only (it carries a regather
    # source; the index store does not): the fault lands in the owner scan
    armed = {"on": True, "hits": 0, "owner_rows": 0}
    orig = shardplan.ShardedCorpusStore.assemble_rows

    def boom(self, c, r0, r1, out=None):
        if (armed["on"] and self._regather is not None
                and r0 >= armed["owner_rows"]):
            armed["hits"] += 1
            raise InjectedFault("shard slab read died mid-scan")
        return orig(self, c, r0, r1, out=out)

    monkeypatch.setattr(shardplan.ShardedCorpusStore, "assemble_rows", boom)
    with pytest.raises(ShardScanError) as ei:
        eng.detect(ds, p)
    assert ei.value.shard == 0
    assert isinstance(ei.value.__cause__, InjectedFault)
    assert armed["hits"] == 1, "the fault surfaces once, not per group"
    assert "n_shards" not in eng.last_stats      # nothing was merged

    # one owner's partial: the fault in owner 1's rows names owner 1
    armed["on"] = False
    ctx = eng.owner_scan_context(ds, p)
    armed.update(on=True, hits=0, owner_rows=ctx.ech.store.plan.range_of(1)[0])
    eng.detect_owner_partial(ds, p, 0, ctx=ctx)      # owner 0 reads row 0 first
    with pytest.raises(ShardScanError) as ei:
        eng.detect_owner_partial(ds, p, 1, ctx=ctx)
    assert ei.value.shard == 1 and "owner tile scan failed" in str(ei.value)
    assert isinstance(ei.value.__cause__, InjectedFault)

    armed["on"] = False
    np.testing.assert_array_equal(eng.detect(ds, p).copying, exact)


def test_commit_retract_commit_on_sharded_index_decides_like_rebuild():
    """A sharded index through commit → retract → commit: after each step
    the bucketed engine (sharded scan, mask cache following the deltas)
    and the exact INDEX on it decide like the exact INDEX on a rebuild."""
    sc = synthetic_claims(SPECS[64])
    ds0, p0 = sc.dataset, oracle_claim_probs(sc)
    rng = np.random.default_rng(2)
    values, acc, p = ds0.values[:52], ds0.accuracy[:52], p0[:52]
    idx = build_index(ClaimsDataset(values=values, accuracy=acc), p, CFG,
                      row_capacity=80, device="cpu")
    idx.store = shard_store(idx.store, 3)
    eng = DetectionEngine(CFG, device="cpu", tile=16)

    def check():
        ds = ClaimsDataset(values=values, accuracy=acc)
        want = index_detect_exact(ds, p, CFG, index=build_index(
            ds, p, CFG, device="cpu")).copying
        np.testing.assert_array_equal(
            index_detect_exact(ds, p, CFG, index=idx).copying, want)
        np.testing.assert_array_equal(eng.detect(ds, p, index=idx).copying,
                                      want)
        assert isinstance(idx.store, shardplan.ShardedCorpusStore)

    check()
    for step in ("commit", "retract", "commit"):
        if step == "commit":
            lo = len(values)
            values = np.concatenate([values, ds0.values[lo: lo + 6]])
            acc = np.concatenate([acc, ds0.accuracy[lo: lo + 6]])
            p = np.concatenate([p, p0[lo: lo + 6]])
            info = commit_rows(idx, ClaimsDataset(values=values, accuracy=acc),
                               p, CFG, 6, compact=False)
        else:
            gone = np.sort(rng.choice(len(values), 5, replace=False))
            keep = np.ones(len(values), bool)
            keep[gone] = False
            values, acc, p = values[keep], acc[keep], p[keep]
            info = retract_rows(idx, ClaimsDataset(values=values, accuracy=acc),
                                CFG, gone)
        eng.apply_mask_delta(info.delta)
        check()
        assert eng.last_stats["mask_source"] == "cache"


@pytest.fixture
def cuda_device():
    """The card, or a skip where there is none (decided here, at run time)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("config", ["plain", "pack+spill"])
def test_sharded_scan_on_card_equals_cpu(cuda_device, tmp_path, config):
    """The owner fan-out on the card against the same calls on the CPU: the
    tile lists equal, the counts equal, scores within rtol 2e-5 / atol 1e-4
    (ROADMAP C4), decisions equal; B1 launched once per owner group."""
    from repro_torch.kernels import ops

    ds, p, exact, _ = _world(512)
    out = {}
    for dev in (cuda_device, "cpu"):
        eng = DetectionEngine(CFG, **{**KW, "device": dev}, n_shards=4,
                              shard_spill_dir=str(tmp_path), **CONFIGS[config])
        ctx = eng.owner_scan_context(ds, p)
        ops.tile_scores.launches = 0
        parts = [eng.detect_owner_partial(ds, p, s, ctx=ctx) for s in range(4)]
        launches = ops.tile_scores.launches
        grids = [g.cpu() for g in merge_owner_partials(parts, ctx.n_blocks,
                                                       ctx.T)]
        res = eng.finalize_owner_partials(ds, p, ctx, parts)
        out[str(dev)] = (ctx.coords, grids, res, launches,
                         sum(q.stats.get("groups_run", 0) for q in parts))
    (cc, gc_, rc, lc, groups), (ch, gh, rh, _, _) = out["cuda"], out["cpu"]
    assert lc == groups > 0
    np.testing.assert_array_equal(cc, ch)
    for i in (1, 2):                                   # counts
        assert torch.equal(gc_[i], gh[i])
    for i in (0, 3):                                   # C_same, error bound
        np.testing.assert_allclose(gc_[i].numpy(), gh[i].numpy(),
                                   rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(rc.copying, rh.copying)
    np.testing.assert_array_equal(rc.copying, exact)
