"""The port's tile mesh (``core/distributed.py``) and the engine's and
service's ``devices`` / ``mesh_shape``, on the CPU.

The CPU platform lists several entries after
``runtime.platform.set_host_device_count``, as JAX's tests run their meshes
on virtual host devices; every test here sets it through the ``host8``
fixture and puts it back after.

- ``sharded_tile_scores`` on meshes of 1, 2, 3 and 8 entries: the five
  stacks equal ``group_tile_scores`` on one device bit for bit, and each
  tile agrees with JAX's ``repro.kernels.ops.copyscore_tile_fused`` called
  directly (the JAX sharded scan does not run on the installed jax,
  ROADMAP C1).
- ``sharded_tile_scores_2d`` on (4, 2), (2, 2) and (1, 3) meshes with a
  chunk count that is no multiple of ``pod``: counts exact, scores within
  C4 (rtol 2e-5, atol 1e-4), since the sum over ``pod`` reassociates.
- ``distributed_pair_scores`` against JAX's own on 4×2 (``data``,
  ``model``) and 2×2×2 (``pod``, ``data``, ``model``) meshes: the JAX side
  runs in a subprocess with 8 forced host devices, as
  ``tests/test_distributed_core.py`` runs it, and hands back its arrays.
- The engine with ``devices=8``, ``n_shards=4`` × ``devices=8`` and
  ``mesh_shape=(4, 2)``: grids bit-equal to ``devices=1`` on the 1-D mesh
  (within C4 on the 2-D mesh at three chunks a group), decisions equal to
  ``index_detect_exact`` in ``bucketed`` and to ``devices=1`` in
  ``sampled`` and ``sample_verify``; ``n_devices``; a mesh larger than the
  platform raises; ``devices=16`` takes the 8 there are.

The ``gpu`` case runs the engine's scan on a mesh of four ``cuda:0``
entries on one card; JAX is imported inside the tests that use it, so the
file collects where JAX is not installed.
"""
import torch_threads  # noqa: F401  (caps torch's threads a worker)
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch.core import (
    CopyConfig,
    DetectionEngine,
    build_index,
    index_detect_exact,
)
from repro_torch.core.distributed import (
    Mesh,
    distributed_pair_scores,
    group_tile_scores,
    make_mesh,
    sharded_tile_scores,
    sharded_tile_scores_2d,
)
from repro_torch.core.types import ClaimsDataset
from repro_torch.runtime import platform

CFG = CopyConfig(alpha=0.1, s=0.8, n=50.0)
RTOL, ATOL = 2e-5, 1e-4
CPU = torch.device("cpu")


@pytest.fixture
def host8():
    """Eight CPU entries for the test, the count before it afterwards."""
    before = platform.host_device_count()
    platform.set_host_device_count(8)
    yield
    platform.set_host_device_count(before)


def _assert_stacks(got, want, exact):
    """Counts (channels 2, 3) equal; scores bit-equal or within C4."""
    for c, (a, b) in enumerate(zip(got, want)):
        a, b = np.asarray(a), np.asarray(b)
        if exact or c in (2, 3):
            np.testing.assert_array_equal(a, b)
        else:
            np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)


# ---------------------------------------------------------------------------
# one chunk group through the mesh scans
# ---------------------------------------------------------------------------

T, NB, W = 16, 4, 8


def _group(seed, K):
    """A (S_pad, K, w) int8 group, its per-chunk arrays and every r ≤ c
    tile of the grid with a (-1, -1) slot in the middle."""
    rng = np.random.default_rng(seed)
    S_pad = NB * T
    live = [[r, c] for r in range(NB) for c in range(r, NB)]
    mid = len(live) // 2
    return dict(
        v=(rng.random((S_pad, K, W)) < 0.3).astype(np.int8),
        acc=rng.uniform(0.05, 0.95, S_pad).astype(np.float32),
        p=rng.uniform(0.01, 0.99, K).astype(np.float32),
        d=rng.uniform(0.0, 0.2, K).astype(np.float32),
        m=(rng.random(K) < 0.6).astype(np.float32),
        coords=np.array(live[:mid] + [[-1, -1]] + live[mid:], np.int32))


def _one_device(g):
    """``group_tile_scores`` over the whole tile list on one device."""
    n = len(g["coords"])
    stacks = [torch.zeros((n, T, T)) for _ in range(5)]
    t = {k: torch.from_numpy(v) for k, v in g.items()}
    group_tile_scores(t["v"], t["acc"], t["p"], t["d"], t["m"], t["coords"],
                      stacks, CFG, tile=T)
    return stacks


@pytest.fixture(scope="module")
def group3():
    g = _group(3, 3)
    return g, _one_device(g)


@pytest.mark.parametrize("n_dev", [1, 2, 3, 8])
def test_sharded_tile_scores_equal_one_device(group3, host8, n_dev):
    """Contiguous tile blocks, one an entry: every tile's five channels
    equal the one-device scan's bit for bit, the mesh padding comes back
    as zero slots, and each tile agrees with JAX's fused tile function."""
    from repro.kernels import ops as jops

    g, want = group3
    mesh = make_mesh((n_dev,), ("shards",), platform.local_devices(CPU))
    got = sharded_tile_scores(mesh, g["v"], g["acc"], g["p"], g["coords"],
                              CFG, tile=T, delta=g["d"], nout=g["m"])
    n = len(g["coords"])
    assert got[0].shape == (-(-n // n_dev) * n_dev, T, T)
    _assert_stacks([x[:n] for x in got], want, exact=True)
    assert all(not x[n:].any() for x in got)
    v2 = g["v"].reshape(NB * T, -1)
    for i, (r, c) in enumerate(g["coords"]):
        if r < 0:
            assert all(not x[i].any() for x in got)
            continue
        rows, cols = slice(r * T, (r + 1) * T), slice(c * T, (c + 1) * T)
        jax_tile = jops.copyscore_tile_fused(
            v2[rows], v2[cols], g["p"], g["acc"][rows], g["acc"][cols],
            s=CFG.s, n_false=CFG.n, block_e=W, impl="ref",
            delta_blk=g["d"], nout_blk=g["m"])
        _assert_stacks([x[i] for x in got], jax_tile, exact=False)


@pytest.mark.parametrize("shape", [(4, 2), (2, 2), (1, 3)])
def test_sharded_tile_scores_2d_within_c4(host8, shape):
    """Five chunks over ``pod`` (no multiple of 2 or 3: inert padding),
    tiles over ``data``: counts exact, scores within C4 of the one-device
    scan, decisions' inputs unchanged by the reassociation."""
    g = _group(5, 5)
    want = _one_device(g)
    mesh = make_mesh(shape, ("data", "pod"), platform.local_devices(CPU))
    got = sharded_tile_scores_2d(mesh, g["v"], g["acc"], g["p"],
                                 g["coords"], CFG, tile=T, delta=g["d"],
                                 nout=g["m"])
    n = len(g["coords"])
    _assert_stacks([x[:n] for x in got], want, exact=False)
    assert all(not x[n:].any() for x in got)


def test_mesh_and_local_devices(host8):
    """``local_devices`` lists the host count of CPU entries; ``Mesh``
    names its axes with sizes; a mesh larger than the devices raises;
    the tile scans refuse a mesh of the wrong rank."""
    devs = platform.local_devices(CPU)
    assert devs == [CPU] * 8
    m = make_mesh((4, 2), ("data", "pod"), devs)
    assert m.shape == {"data": 4, "pod": 2} and m.size == 8
    assert m.distinct() == [CPU]
    assert Mesh(np.array([CPU, CPU], dtype=object), ("x",)).shape == {"x": 2}
    with pytest.raises(ValueError, match="needs 16 devices, 8 available"):
        make_mesh((4, 4), ("data", "pod"), devs)
    with pytest.raises(ValueError, match=">= 1"):
        platform.set_host_device_count(0)
    g = _group(1, 2)
    with pytest.raises(ValueError, match="1-D mesh"):
        sharded_tile_scores(m, g["v"], g["acc"], g["p"], g["coords"], CFG,
                            tile=T, delta=g["d"])
    with pytest.raises(ValueError, match="data, pod"):
        sharded_tile_scores_2d(make_mesh((2,), ("shards",), devs), g["v"],
                               g["acc"], g["p"], g["coords"], CFG, tile=T,
                               delta=g["d"])


# ---------------------------------------------------------------------------
# distributed_pair_scores against JAX's, 8 forced host devices
# ---------------------------------------------------------------------------

JAX_PAIR_SCRIPT = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import jax
    import jax.numpy as jnp
    import numpy as np

    from repro.core.bucketed import pad_buckets
    from repro.core.distributed import distributed_pair_scores
    from repro.core.index import build_index, bucketize
    from repro.core.types import CopyConfig
    from repro.data.claims import (SyntheticSpec, oracle_claim_probs,
                                   synthetic_claims)

    cfg = CopyConfig(alpha=0.1, s=0.8, n=50.0)
    sc = synthetic_claims(SyntheticSpec(n_sources=64, n_items=400,
                                        coverage="stock", n_cliques=4, seed=0))
    p = oracle_claim_probs(sc)
    padded = pad_buckets(bucketize(build_index(sc.dataset, p, cfg), 16),
                         dtype=jnp.float32)
    v = np.asarray(padded.v_ksw)
    # a width no multiple of the pod axis: the zero padding is exercised
    v = np.ascontiguousarray(v[:, :, : v.shape[2] - (v.shape[2] % 2 == 0)])
    out = dict(v=v, p_hat=np.asarray(padded.p_hat),
               acc=np.asarray(sc.dataset.accuracy))
    for axes, shape in ((("data", "model"), (4, 2)),
                        (("pod", "data", "model"), (2, 2, 2))):
        run = distributed_pair_scores(jax.make_mesh(shape, axes), v,
                                      out["p_hat"], out["acc"], cfg)
        c, n = run()
        key = "x".join(map(str, shape))
        out["c_" + key], out["n_" + key] = np.asarray(c), np.asarray(n)
    np.savez(sys.argv[1], **out)
""")


@pytest.fixture(scope="module")
def jax_pairs(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("pairs") / "jax.npz")
    env = {"PYTHONPATH": "src", "PATH": "/usr/bin:/bin",
           "JAX_PLATFORMS": "cpu",
           "OMP_NUM_THREADS": os.environ.get("OMP_NUM_THREADS", "1")}
    proc = subprocess.run([sys.executable, "-c", JAX_PAIR_SCRIPT, path],
                          capture_output=True, text=True, timeout=600,
                          env=env)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return dict(np.load(path))


@pytest.mark.parametrize("axes,shape", [
    (("data", "model"), (4, 2)),
    (("pod", "data", "model"), (2, 2, 2)),
])
def test_distributed_pair_scores_match_jax(jax_pairs, host8, axes, shape):
    """Row blocks over ``data``, column blocks over ``model``, the entry
    width (odd, zero-padded) over ``pod``: counts exact, C within C4 of
    JAX's ``distributed_pair_scores`` on the same mesh shape."""
    j = jax_pairs
    mesh = make_mesh(shape, axes, platform.local_devices(CPU))
    c, n = distributed_pair_scores(mesh, j["v"], j["p_hat"], j["acc"], CFG)()
    key = "x".join(map(str, shape))
    assert c.shape == n.shape == (64, 64)
    np.testing.assert_array_equal(n.numpy(), j["n_" + key])
    np.testing.assert_allclose(c.numpy(), j["c_" + key], rtol=RTOL, atol=ATOL)
    assert n.numpy().max() > 0


# ---------------------------------------------------------------------------
# the engine on a mesh of CPU entries
# ---------------------------------------------------------------------------

ENGINE_KW = dict(tile=16, device="cpu", store_chunk_entries=64)


@pytest.fixture(scope="module")
def world():
    rng = np.random.default_rng(0)
    n_src, n_items = 100, 300
    values = np.where(rng.random((n_src, n_items)) < 0.4,
                      rng.integers(0, 4, (n_src, n_items)),
                      -1).astype(np.int32)
    # three planted copiers, so the decisions hold copying pairs
    for c, s in ((90, 3), (91, 17), (92, 40)):
        values[c] = np.where(rng.random(n_items) < 0.85, values[s], values[c])
    ds = ClaimsDataset(values=values,
                       accuracy=rng.uniform(0.3, 0.95, n_src).astype(np.float32))
    p = np.where(values == 0, 0.9, 0.05).astype(np.float32)
    idx = build_index(ds, p, CFG, device="cpu")
    exact = index_detect_exact(ds, p, CFG, index=idx)
    assert len(exact.copying_pairs()) >= 3
    return ds, p, idx, exact


def _grids(eng, ds, p, idx):
    ctx = eng._tiled_prologue(ds, p, idx)
    g, _ = eng._run_tiled_scan(ctx)
    return [x.cpu().numpy() for x in g]


MESH_CONFIGS = {
    "devices8": dict(devices=8),
    "shards4_devices8": dict(devices=8, n_shards=4),
    "mesh4x2": dict(mesh_shape=(4, 2)),
}


@pytest.mark.parametrize("config", sorted(MESH_CONFIGS))
@pytest.mark.parametrize("mode", ["bucketed", "sampled", "sample_verify"])
def test_engine_on_mesh_decides_as_one_device(world, host8, mode, config):
    """Decisions on 8 CPU entries equal ``devices=1``'s, and the exact
    INDEX's in ``bucketed``; ``n_devices`` is 8."""
    ds, p, idx, exact = world
    kw = MESH_CONFIGS[config]
    one = DetectionEngine(CFG, mode=mode, devices=1, **ENGINE_KW)
    eng = DetectionEngine(CFG, mode=mode, **kw, **ENGINE_KW)
    index = idx if mode == "bucketed" and "n_shards" not in kw else None
    want = one.detect(ds, p, index=index)
    got = eng.detect(ds, p, index=index)
    np.testing.assert_array_equal(got.copying, want.copying)
    if mode == "bucketed":
        np.testing.assert_array_equal(got.copying, exact.copying)
    st = eng.last_stats
    st = st.get("sampled_stats", st)
    assert st["n_devices"] == 8
    assert one.last_stats.get("sampled_stats",
                              one.last_stats)["n_devices"] == 1


@pytest.mark.parametrize("config", sorted(MESH_CONFIGS))
def test_engine_mesh_grids(world, host8, config):
    """The scan's four grids: bit-equal to ``devices=1`` on the 1-D mesh,
    sharded or not; on the 2-D mesh at three chunks a group (one inert
    chunk a group over ``pod`` 2) counts exact and scores within C4."""
    ds, p, idx, _ = world
    kw = MESH_CONFIGS[config]
    group = 3 if "mesh_shape" in kw else 1
    want = _grids(DetectionEngine(CFG, devices=1, chunk_group=group,
                                  **ENGINE_KW), ds, p, idx)
    eng = DetectionEngine(CFG, chunk_group=group, **kw, **ENGINE_KW)
    got = _grids(eng, ds, p, None if "n_shards" in kw else idx)
    exact = "mesh_shape" not in kw
    for c, (a, b) in enumerate(zip(got, want)):
        if exact or c in (1, 2):
            np.testing.assert_array_equal(a, b)
        else:
            np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)
    assert eng._tile_mesh().size == 8


def test_engine_mesh_sizes(world, host8):
    """``mesh_shape`` needing more entries than the platform lists raises
    JAX's ``ValueError``; ``devices=16`` takes the 8 there are, and no
    ``devices`` takes all of them."""
    ds, p, idx, exact = world
    with pytest.raises(ValueError, match="needs 16 devices, 8 available"):
        DetectionEngine(CFG, mesh_shape=(4, 4), **ENGINE_KW).detect(
            ds, p, index=idx)
    for kw in (dict(devices=16), {}):
        eng = DetectionEngine(CFG, **kw, **ENGINE_KW)
        res = eng.detect(ds, p, index=idx)
        assert eng.last_stats["n_devices"] == 8
        np.testing.assert_array_equal(res.copying, exact.copying)
    assert DetectionEngine(CFG, mesh_shape=[2, 2],
                           **ENGINE_KW).options.mesh_shape == (2, 2)
    with pytest.raises(ValueError, match="data, pod"):
        DetectionEngine(CFG, mesh_shape=(8,), **ENGINE_KW)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    """The card, or a skip where there is none (decided here, at run time)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    return torch.device("cuda", 0)


@pytest.mark.gpu
def test_engine_mesh_of_one_card(cuda_device, world):
    """Four ``cuda:0`` entries (set on the engine's lazily built mesh, as
    one card lists one device) launch B1 four times a group; grids equal
    the one-entry card scan's bit for bit, decisions the exact INDEX's."""
    from repro_torch.kernels.ops import tile_scores

    ds, p, _, exact = world
    idx = build_index(ds, p, CFG, device=cuda_device)
    kw = dict(ENGINE_KW, device=cuda_device)
    want = _grids(DetectionEngine(CFG, **kw), ds, p, idx)
    eng = DetectionEngine(CFG, **kw)
    eng._mesh = make_mesh((4,), ("shards",), [cuda_device] * 4)
    tile_scores.launches = 0
    got = _grids(eng, ds, p, idx)
    assert tile_scores.launches == 4 * eng._scan_stats["groups_run"] > 0
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    res = eng.detect(ds, p, index=idx)
    np.testing.assert_array_equal(res.copying, exact.copying)
