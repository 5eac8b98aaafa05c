"""The port's DetectionEngine against the JAX package, on the CPU.

The JAX engine's tiled modes do not run on the installed jax (ROADMAP C1),
so the port's ``bucketed`` pass is held against JAX's ``index_detect_exact``
decisions, against the JAX engine's own prologue (numpy) and against its
finalize fed the same grids. ``pairwise`` and ``exact`` are held against
their JAX counterparts directly.
"""
import torch_threads  # noqa: F401  (caps torch's threads a worker)
import numpy as np
import pytest
import torch

from repro.core import DetectionEngine as JEngine
from repro.core import index as jidx
from repro.core.bucketed import index_detect_exact as j_exact
from repro.core.types import CopyConfig as JCfg
from repro.data import claims as jc
from repro_torch.core import DetectionEngine, InvertedIndex
from repro_torch.core.types import ClaimsDataset, CopyConfig

CFG_J = JCfg(alpha=0.1, s=0.8, n=50.0)
CFG = CopyConfig(alpha=0.1, s=0.8, n=50.0)
# float32 round-off between XLA and PyTorch (log, sum order) on C→
RTOL, ATOL = 2e-5, 1e-4


@pytest.fixture(scope="module")
def worlds():
    ds_m = jc.motivating_example()
    sc = jc.synthetic_claims(jc.SyntheticSpec(
        n_sources=96, n_items=480, coverage="book", n_cliques=5,
        clique_size=3, clique_items=12, seed=3))
    sc64 = jc.synthetic_claims(jc.SyntheticSpec(
        n_sources=64, n_items=384, coverage="book", n_cliques=4,
        clique_size=3, clique_items=12, seed=0))
    out = {}
    for name, ds, p in (("motivating", ds_m, jc.motivating_value_probs(ds_m)),
                        ("s96", sc.dataset, jc.oracle_claim_probs(sc)),
                        ("s64", sc64.dataset, jc.oracle_claim_probs(sc64))):
        out[name] = (ds, p, j_exact(ds, p, CFG_J))
    return out


def _port(ds):
    return ClaimsDataset(values=ds.values.copy(), accuracy=ds.accuracy.copy())


@pytest.mark.parametrize("world,tile", [("motivating", 64), ("s96", 32),
                                        ("s96", 128), ("s64", 256)])
def test_bucketed_decisions_equal_jax_exact(worlds, world, tile):
    ds, p, exact = worlds[world]
    eng = DetectionEngine(CFG, mode="bucketed", tile=tile, device="cpu")
    res = eng.detect(_port(ds), p)
    np.testing.assert_array_equal(res.copying, exact.copying)
    assert res.counter.pairs_considered == exact.counter.pairs_considered
    assert (res.counter.shared_values_examined
            == exact.counter.shared_values_examined)
    st = eng.last_stats
    n_blocks = -(-ds.n_sources // st["tile"])
    assert st["tiles_kept"] <= (n_blocks * n_blocks + n_blocks) // 2
    assert st["kernel_launches"] == 0 and st["device"] == "cpu"


@pytest.mark.parametrize("chunk_group", [1, 3, None])
def test_bucketed_chunk_groups_equal_jax_exact(worlds, chunk_group):
    ds, p, exact = worlds["s96"]
    res = DetectionEngine(CFG, tile=32, chunk_group=chunk_group,
                          device="cpu").detect(_port(ds), p)
    np.testing.assert_array_equal(res.copying, exact.copying)


@pytest.mark.parametrize("world", ["motivating", "s96"])
@pytest.mark.parametrize("mode", ["pairwise", "exact"])
def test_oracle_modes_equal_jax(worlds, world, mode):
    ds, p, _ = worlds[world]
    want = JEngine(CFG_J, mode=mode).detect(ds, p)
    got = DetectionEngine(CFG, mode=mode, device="cpu").detect(_port(ds), p)
    np.testing.assert_array_equal(got.copying, want.copying)
    np.testing.assert_allclose(got.c_fwd, want.c_fwd, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got.pr_independent, want.pr_independent,
                               rtol=RTOL, atol=1e-6)
    assert vars(got.counter) == vars(want.counter)


def test_exact_mode_paper_accounting(worlds):
    # Ex. 3.6: 26 pairs / 51 shared values / 154 computations
    ds, p, _ = worlds["motivating"]
    res = DetectionEngine(CFG, mode="exact", device="cpu").detect(_port(ds), p)
    assert res.counter.pairs_considered == 26
    assert res.counter.shared_values_examined == 51
    assert res.counter.score_computations == 154


@pytest.mark.parametrize("world,tile", [("motivating", 64), ("s96", 32),
                                        ("s96", 128)])
def test_prologue_equals_jax(worlds, world, tile):
    ds, p, _ = worlds[world]
    jctx = JEngine(CFG_J, mode="bucketed", tile=tile)._tiled_prologue(ds, p)
    tctx = DetectionEngine(CFG, tile=tile, device="cpu")._tiled_prologue(
        _port(ds), p)
    np.testing.assert_array_equal(tctx.coords, jctx.coords)
    np.testing.assert_array_equal(tctx.chunk_keep, jctx.chunk_keep)
    np.testing.assert_array_equal(tctx.delta, jctx.delta)
    np.testing.assert_array_equal(tctx.acc_pad, jctx.acc_pad)
    assert (tctx.T, tctx.Gc, tctx.S_pad) == (jctx.T, jctx.Gc, jctx.S_pad)


@pytest.mark.parametrize("world,tile", [("motivating", 64), ("s96", 32)])
def test_finalize_equals_jax_on_same_grids(worlds, world, tile):
    ds, p, _ = worlds[world]
    eng = DetectionEngine(CFG, tile=tile, device="cpu")
    tctx = eng._tiled_prologue(_port(ds), p)
    grids, run = eng._run_tiled_scan(tctx)
    grids = [g.numpy() for g in grids]
    got = eng._tiled_finalize(tctx, grids, run)
    jeng = JEngine(CFG_J, mode="bucketed", tile=tile)
    jctx = jeng._tiled_prologue(ds, p)
    want = jeng._tiled_finalize(jctx, [g.copy() for g in grids], run)
    np.testing.assert_array_equal(got.copying, want.copying)
    np.testing.assert_allclose(got.c_fwd, want.c_fwd, rtol=RTOL, atol=ATOL)
    assert eng.last_stats["rescored_pairs"] == jeng.last_stats["rescored_pairs"]
    assert vars(got.counter) == vars(want.counter)


def test_detect_on_jax_state_dict_index(worlds):
    ds, p, exact = worlds["s96"]
    jindex = jidx.build_index(ds, p, CFG_J, chunk_entries=64)
    index = InvertedIndex.from_state_dict(jindex.state_dict())
    res = DetectionEngine(CFG, tile=32, device="cpu").detect(_port(ds), p,
                                                            index=index)
    np.testing.assert_array_equal(res.copying, exact.copying)


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        assert DetectionEngine(CFG).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            DetectionEngine(CFG)


@pytest.mark.parametrize("mode", ["pairwise", "exact", "bucketed", "bound",
                                  "bound+", "hybrid", "incremental",
                                  "sampled", "sample_verify"])
def test_every_mode_runs_on_cpu(worlds, mode):
    """Each of the nine modes runs on the CPU; the non-sampled ones decide
    like the JAX engine on the motivating example (the sampled ones keep
    the items the sample holds, so they are held in
    tests/test_torch_sampling.py)."""
    from repro_torch.core.engine import MODES
    assert mode in MODES
    ds, p, _ = worlds["motivating"]
    eng = DetectionEngine(CFG, mode=mode, tile=64, n_buckets=13, device="cpu")
    res = eng.detect(_port(ds), p)
    S = ds.n_sources
    assert res.copying.shape == res.c_fwd.shape == (S, S)
    assert np.isfinite(res.c_fwd).all() and not res.copying.diagonal().any()
    if mode not in ("sampled", "sample_verify", "bucketed"):
        want = JEngine(CFG_J, mode=mode, tile=64, n_buckets=13).detect(ds, p)
        np.testing.assert_array_equal(res.copying, want.copying)
    if mode in ("bucketed", "sampled", "sample_verify"):
        assert eng._last_considered is not None


def test_engine_options_defaults_equal_jax():
    """Every option the port carries has the JAX engine's default."""
    import dataclasses

    from repro.core.engine import EngineOptions as JOptions
    from repro_torch.core import EngineOptions
    jdefaults = {f.name: f.default for f in dataclasses.fields(JOptions)}
    for f in dataclasses.fields(EngineOptions):
        assert f.default == jdefaults[f.name], f.name


def test_unknown_mode_and_dtype_raise():
    with pytest.raises(ValueError):
        DetectionEngine(CFG, mode="nope", device="cpu")
    with pytest.raises(ValueError, match="int8"):
        DetectionEngine(CFG, incidence_dtype="bf16", device="cpu")


def test_values_examined_is_exact_above_float32_range(worlds):
    """ROADMAP C2: the port sums the shared-value count in float64, exactly;
    the JAX finalize sums it in float32, which rounds past 2²⁴."""
    ds, p, _ = worlds["s96"]
    eng = DetectionEngine(CFG, tile=32, device="cpu")
    tctx = eng._tiled_prologue(_port(ds), p)
    grids = [np.zeros((tctx.S_pad, tctx.S_pad), np.float32) for _ in range(4)]
    for (i, j), count in (((0, 1), 2.0 ** 24 - 1), ((2, 3), 2.0)):
        for a, b in ((i, j), (j, i)):
            grids[1][a, b] = count            # shared-value count n
            grids[2][a, b] = 1.0              # considered (non-Ē count)
    got = eng._tiled_finalize(tctx, grids, 0)
    jeng = JEngine(CFG_J, mode="bucketed", tile=32)
    want = jeng._tiled_finalize(jeng._tiled_prologue(ds, p),
                                [g.copy() for g in grids], 0)
    assert got.counter.shared_values_examined == 2 ** 24 + 1
    assert want.counter.shared_values_examined == 2 ** 24
    np.testing.assert_array_equal(got.copying, want.copying)
