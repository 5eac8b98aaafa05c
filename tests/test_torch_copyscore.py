"""The port's single-direction copyscore (B2 with the error channel, B3
without) against the JAX package's: the plain PyTorch version against
``copyscore_pallas`` in interpret mode; ``pad_for_copyscore``,
``copyscore``, ``copyscore_tile`` and ``copyscore_store`` on CPU tensors
against ``repro.kernels.ops`` with ``impl="ref"``; and, on a card, the
hand-written kernel against the plain version.

Tolerances: counts are sums of 0/1 products, exact in every version, so they
must be equal. Scores (C→, err) are float32 sums of per-block products; the
port associates Eq. 3 as a1·a2 first (the kernels' order) where the JAX
package multiplies p·a1 first, and XLA's and PyTorch's ``log`` differ by an
ulp here and there: rtol=2e-5, atol=1e-4 (ROADMAP C4) covers that round-off,
not a different formula.

The JAX package is imported inside the tests that compare with it, so the
card-only tests (``-m gpu``) also run where JAX is not installed.
"""
import torch_threads  # noqa: F401  (caps torch's threads a worker)
import numpy as np
import pytest
import torch

from repro_torch.core.store import CorpusStore
from repro_torch.kernels import ops, ref

S_PARAM, N_FALSE = 0.8, 50.0
RTOL, ATOL = 2e-5, 1e-4


def _instance(seed, S_r, S_c, n_e, w, dtype=np.int8):
    rng = np.random.default_rng(seed)
    E = n_e * w
    return dict(
        v_r=(rng.random((S_r, E)) < 0.2).astype(dtype),
        v_c=(rng.random((S_c, E)) < 0.2).astype(dtype),
        p=rng.uniform(0.01, 0.99, n_e).astype(np.float32),
        a_r=rng.uniform(0.05, 0.95, S_r).astype(np.float32),
        a_c=rng.uniform(0.05, 0.95, S_c).astype(np.float32),
        d=rng.uniform(0.0, 0.2, n_e).astype(np.float32))


def _assert_outputs(got, want):
    got = [np.asarray(g) for g in got]
    want = [np.asarray(g) for g in want]
    assert len(got) == len(want)
    np.testing.assert_array_equal(got[1], want[1])          # n
    for c in [0] + ([2] if len(got) == 3 else []):          # C→, err
        np.testing.assert_allclose(got[c], want[c], rtol=RTOL, atol=ATOL)


def _store(seed, S, E, w, capacity=None):
    """A chunked store over random 0/1 incidence with live metadata."""
    rng = np.random.default_rng(seed)
    V = (rng.random((S, E)) < 0.15).astype(np.int8)
    return CorpusStore.from_dense(
        V, np.arange(E), np.zeros(E), rng.uniform(0.05, 0.95, E),
        np.linspace(1.0, 0.0, E), chunk_entries=w, capacity=capacity)


@pytest.fixture(scope="module")
def jax_ops():
    """The JAX package's copyscore kernel and dispatch, with jax.numpy."""
    jnp = pytest.importorskip("jax.numpy")
    from repro.kernels import ops as jops
    from repro.kernels.copyscore import copyscore_pallas
    return jnp, copyscore_pallas, jops


@pytest.mark.parametrize("block_e", [8, 40, 128, 512])
@pytest.mark.parametrize("dtype", [np.int8, np.float32])
@pytest.mark.parametrize("err", [False, True], ids=["B3", "B2"])
@pytest.mark.parametrize("shape", ["square", "rectangular"])
def test_plain_matches_pallas_interpret(jax_ops, block_e, dtype, err, shape):
    jnp, copyscore_pallas, _ = jax_ops
    S_c = 64 if shape == "square" else 96
    x = _instance(block_e + S_c, 64, S_c, 2, block_e, dtype)
    square = shape == "square"
    v_c, a_c = (x["v_r"], x["a_r"]) if square else (x["v_c"], x["a_c"])
    want = copyscore_pallas(
        jnp.asarray(x["v_r"]), jnp.asarray(x["p"]), jnp.asarray(x["a_r"]),
        v_cols=None if square else jnp.asarray(v_c),
        acc_cols=None if square else jnp.asarray(a_c),
        delta_blk=jnp.asarray(x["d"]) if err else None,
        s=S_PARAM, n_false=N_FALSE, block_i=32, block_j=32, block_e=block_e,
        interpret=True)
    t = {k: torch.from_numpy(v) for k, v in x.items()}
    got = ref.copyscore_torch(
        t["v_r"], t["p"], t["a_r"], s=S_PARAM, n_false=N_FALSE,
        block_e=block_e, v_cols=None if square else t["v_c"],
        acc_cols=None if square else t["a_c"],
        delta_blk=t["d"] if err else None)
    _assert_outputs(got, want)


def test_pad_for_copyscore_equals_jax(jax_ops):
    _, _, jops = jax_ops
    rng = np.random.default_rng(3)
    v = (rng.random((37, 50)) < 0.3).astype(np.float32)
    p = rng.uniform(0.1, 0.9, 4).astype(np.float32)
    for kw in (dict(bucket_sizes=[13, 7, 20, 10]), {}):
        vv = v if kw else v[:, :48]
        got = ops.pad_for_copyscore(vv, p if kw else p[:3], 16, 16, **kw)
        want = jops.pad_for_copyscore(vv, p if kw else p[:3], 16, 16, **kw)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
        assert got[2] == want[2]


@pytest.mark.parametrize("block_e", [8, 40])
def test_copyscore_cpu_matches_jax_ref(jax_ops, block_e):
    _, _, jops = jax_ops
    x = _instance(block_e, 70, 70, 3, block_e)
    want = jops.copyscore(x["v_r"], x["p"], x["a_r"], s=S_PARAM,
                          n_false=N_FALSE, block_e=block_e, impl="ref")
    ops.copyscore.launches = 0
    got = ops.copyscore(torch.from_numpy(x["v_r"]), torch.from_numpy(x["p"]),
                        torch.from_numpy(x["a_r"]), s=S_PARAM,
                        n_false=N_FALSE, block_e=block_e)
    assert ops.copyscore.launches == 0
    _assert_outputs(got, want)


@pytest.mark.parametrize("err", [False, True], ids=["B3", "B2"])
def test_copyscore_tile_cpu_matches_jax_ref(jax_ops, err):
    jnp, _, jops = jax_ops
    x = _instance(11, 48, 80, 3, 40)
    kw = dict(s=S_PARAM, n_false=N_FALSE, block_e=40)
    want = jops.copyscore_tile(
        x["v_r"], x["v_c"], x["p"], x["a_r"], x["a_c"], impl="ref",
        delta_blk=x["d"] if err else None, **kw)
    t = {k: torch.from_numpy(v) for k, v in x.items()}
    ops.copyscore_tile.launches = 0
    got = ops.copyscore_tile(t["v_r"], t["v_c"], t["p"], t["a_r"], t["a_c"],
                             delta_blk=t["d"] if err else None, **kw)
    assert ops.copyscore_tile.launches == 0
    _assert_outputs(got, want)


@pytest.mark.parametrize("w", [16, 24, 40])
def test_copyscore_store_cpu_matches_jax_ref(jax_ops, w):
    """Chunk-streamed full square (a ragged last chunk when E % w != 0)
    against the JAX package's, and against one dense ``copyscore`` over the
    same chunks: counts bit-equal."""
    _, _, jops = jax_ops
    store = _store(w, 30, 96, w, capacity=34)
    rng = np.random.default_rng(w)
    p_hat = rng.uniform(0.05, 0.95, store.n_chunks).astype(np.float32)
    acc = rng.uniform(0.1, 0.9, 30).astype(np.float32)
    kw = dict(s=S_PARAM, n_false=N_FALSE)
    want = jops.copyscore_store(store, p_hat, acc, impl="ref", **kw)
    got = ops.copyscore_store(store, p_hat, torch.from_numpy(acc), **kw)
    _assert_outputs(got, want)
    # the dense call over the same chunks: one block per chunk when every
    # chunk has the same width
    if store.n_entries % store.chunk_entries == 0:
        dense = ops.copyscore(torch.from_numpy(store.to_dense()),
                              torch.from_numpy(p_hat), torch.from_numpy(acc),
                              block_e=w, **kw)
        assert torch.equal(got[1], dense[1])
        torch.testing.assert_close(got[0], dense[0], rtol=RTOL, atol=ATOL)


def test_copyscore_store_skips_all_padding_chunks(monkeypatch):
    """A chunk with no live entry adds nothing and is skipped: the plain
    version runs once per live chunk, and the counts equal V·Vᵀ."""
    store = _store(5, 20, 64, 16)
    store.deactivate_entries(np.arange(16, 32))          # chunk 1: all padding
    calls = []
    plain = ref.copyscore_torch
    monkeypatch.setattr(ref, "copyscore_torch",
                        lambda *a, **k: calls.append(1) or plain(*a, **k))
    acc = torch.full((20,), 0.7)
    c, n = ops.copyscore_store(store, np.full(4, 0.3, np.float32), acc,
                               s=S_PARAM, n_false=N_FALSE)
    assert len(calls) == 3
    V = store.to_dense().astype(np.float32)
    np.testing.assert_array_equal(n.numpy(), V @ V.T)
    assert bool(torch.isfinite(c).all())


def test_copyscore_store_numpy_accuracies_run_plain():
    store = _store(6, 12, 32, 16)
    c, n = ops.copyscore_store(store, np.full(2, 0.4, np.float32),
                               np.full(12, 0.6, np.float32), s=S_PARAM,
                               n_false=N_FALSE)
    assert c.device.type == "cpu" and tuple(n.shape) == (12, 12)


def test_copyscore_rejects_bad_operands():
    x = _instance(1, 16, 16, 2, 8)
    t = {k: torch.from_numpy(v) for k, v in x.items()}
    kw = dict(s=S_PARAM, n_false=N_FALSE)
    with pytest.raises(ValueError, match="multiple of block_e"):
        ops.copyscore(t["v_r"], t["p"], t["a_r"], block_e=6, **kw)
    with pytest.raises(ValueError, match="p_blk"):
        ops.copyscore(t["v_r"], t["p"][:1], t["a_r"], block_e=8, **kw)
    with pytest.raises(ValueError, match="acc_cols"):
        ops.copyscore_tile(t["v_r"], t["v_c"], t["p"], t["a_r"], t["a_c"][:3],
                           block_e=8, **kw)
    with pytest.raises(ValueError, match="incidence"):
        ops.copyscore_tile(t["v_r"], t["v_c"][:, :8], t["p"], t["a_r"],
                           t["a_c"], block_e=8, **kw)


@pytest.mark.parametrize("n_blocks,S_i,S_j", [
    (65, 256, 256),        # the legacy per-tile scan's launch
    (1, 256, 256), (3, 100, 37), (1000, 1024, 1024), (2, 16384, 16384)])
def test_err_splits_cover_every_block_once(n_blocks, S_i, S_j):
    """B2's split: contiguous ranges in order, none empty, covering every
    entry block once; the blocks reach the SMs where there are entry blocks
    enough, and no range is added past that."""
    sms = 132
    m = ops._err_splits(n_blocks, S_i, S_j, sms)
    # range k as the kernel takes it
    ranges = [(k * n_blocks // m, (k + 1) * n_blocks // m) for k in range(m)]
    assert ranges[0][0] == 0 and ranges[-1][1] == n_blocks
    assert all(lo < hi for lo, hi in ranges)
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
    tiles = -(-S_i // 128) * -(-S_j // 128)
    assert m * tiles >= sms or m == n_blocks
    assert m == 1 or (m - 1) * tiles < sms
    if (n_blocks, S_i, S_j) == (65, 256, 256):
        assert m == 33 and m * tiles == sms


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    """The card, or a skip where there is none (decided here, at run time)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("S_r,S_c", [(128, 128), (100, 37), (64, 200)])
@pytest.mark.parametrize("block_e", [8, 40, 512])
@pytest.mark.parametrize("err", [False, True], ids=["B3", "B2"])
def test_kernel_matches_plain_on_card(cuda_device, S_r, S_c, block_e, err):
    x = _instance(S_r + block_e, S_r, S_c, 2, block_e)
    t = {k: torch.from_numpy(v) for k, v in x.items()}
    c = {k: v.to(cuda_device) for k, v in t.items()}
    ops.copyscore_tile.launches = 0
    got = ops.copyscore_tile(c["v_r"], c["v_c"], c["p"], c["a_r"], c["a_c"],
                             s=S_PARAM, n_false=N_FALSE, block_e=block_e,
                             delta_blk=c["d"] if err else None)
    torch.cuda.synchronize()
    assert ops.copyscore_tile.launches == 1
    want = ref.copyscore_torch(t["v_r"], t["p"], t["a_r"], s=S_PARAM,
                               n_false=N_FALSE, block_e=block_e,
                               v_cols=t["v_c"], acc_cols=t["a_c"],
                               delta_blk=t["d"] if err else None)
    _assert_outputs([g.cpu() for g in got], want)


@pytest.mark.gpu
def test_copyscore_store_on_card_matches_plain(cuda_device):
    store = _store(8, 150, 100, 24)                      # ragged last chunk
    store.deactivate_entries(np.arange(24, 48))          # one padding chunk
    p_hat = np.random.default_rng(8).uniform(0.1, 0.9, store.n_chunks)
    acc = torch.from_numpy(np.random.default_rng(9).uniform(
        0.1, 0.9, 150).astype(np.float32))
    kw = dict(s=S_PARAM, n_false=N_FALSE)
    ops.copyscore_store.launches = 0
    got = ops.copyscore_store(store, p_hat, acc.to(cuda_device), **kw)
    torch.cuda.synchronize()
    assert ops.copyscore_store.launches == store.n_chunks - 1
    want = ops.copyscore_store(store, p_hat, acc, **kw)
    _assert_outputs([g.cpu() for g in got], want)


@pytest.mark.gpu
def test_kernel_takes_whole_words_only(cuda_device):
    """The kernel reads 4 entries a word: an entry block that is not a
    multiple of 4 wide raises on the card (ROADMAP C8), and the store path
    pads such a chunk with inert zero columns instead."""
    x = _instance(3, 32, 32, 2, 6)
    c = {k: torch.from_numpy(v).to(cuda_device) for k, v in x.items()}
    with pytest.raises(ValueError, match="multiple of 4"):
        ops.copyscore(c["v_r"], c["p"], c["a_r"], s=S_PARAM, n_false=N_FALSE,
                      block_e=6)
    store = _store(4, 20, 30, 8)                 # last chunk 6 wide
    acc = torch.full((20,), 0.6)
    got = ops.copyscore_store(store, np.full(4, 0.3), acc.to(cuda_device),
                              s=S_PARAM, n_false=N_FALSE)
    want = ops.copyscore_store(store, np.full(4, 0.3), acc, s=S_PARAM,
                               n_false=N_FALSE)
    _assert_outputs([g.cpu() for g in got], want)


@pytest.mark.gpu
def test_all_ones_counts_are_exact_on_card(cuda_device):
    """An all-ones incidence 4096 wide: every count is exactly 4096, the
    int32 count carried to float32 unrounded (a bf16 or fp8 path could not
    hold it), and C→ agrees with the plain version."""
    S, w = 160, 4096
    rng = np.random.default_rng(11)
    v = torch.ones((S, w), dtype=torch.int8)
    p = torch.tensor([0.3])
    a = torch.from_numpy(rng.uniform(0.05, 0.95, S).astype(np.float32))
    kw = dict(s=S_PARAM, n_false=N_FALSE, block_e=w)
    ops.copyscore.launches = 0
    got = ops.copyscore(v.to(cuda_device), p.to(cuda_device),
                        a.to(cuda_device), **kw)
    torch.cuda.synchronize()
    assert ops.copyscore.launches == 1
    assert torch.equal(got[1].cpu(), torch.full((S, S), float(w)))
    _assert_outputs([g.cpu() for g in got], ref.copyscore_torch(v, p, a, **kw))


@pytest.mark.gpu
@pytest.mark.parametrize("n_e", [1, 3])
def test_accumulate_adds_onto_outputs_on_card(cuda_device, n_e):
    """accumulate=1 onto non-zero outputs: they end as what they held plus
    the plain version's sums (counts exactly; C→ within the tolerance), for
    one entry block (the store path's launch) and for three."""
    w = 64
    x = _instance(21 + n_e, 150, 140, n_e, w)
    c = {k: torch.from_numpy(v).to(cuda_device) for k, v in x.items()}
    rng = np.random.default_rng(5)
    c0 = torch.from_numpy(rng.normal(0, 3, (150, 140)).astype(np.float32))
    n0 = torch.from_numpy(rng.integers(0, 50, (150, 140)).astype(np.float32))
    outs = (c0.to(cuda_device), n0.to(cuda_device))
    kw = dict(s=S_PARAM, n_false=N_FALSE)
    small = ops._single_operands(c["v_r"], c["v_c"], c["a_r"], c["a_c"],
                                 c["p"], None, w)
    ops._launch_single(c["v_r"], c["v_c"], small, outs, block_e=w,
                       accumulate=True, **kw)
    torch.cuda.synchronize()
    t = {k: torch.from_numpy(v) for k, v in x.items()}
    want = ref.copyscore_torch(t["v_r"], t["p"], t["a_r"], v_cols=t["v_c"],
                               acc_cols=t["a_c"], block_e=w, **kw)
    _assert_outputs([o.cpu() for o in outs], (c0 + want[0], n0 + want[1]))


@pytest.mark.gpu
@pytest.mark.parametrize("aligned", [True, False], ids=["16-byte", "4-byte"])
def test_wide_block_at_ragged_shape_on_card(cuda_device, aligned):
    """block_e = 4096 at a ragged 300 × 200 block: rows on 16-byte
    boundaries take the kernel's 16-byte loads, rows 4 bytes past one its
    4-byte loads; both against the plain version, edges included."""
    x = _instance(30, 300, 200, 1, 4096)

    def on_card(a):
        t = torch.from_numpy(a).to(cuda_device)
        if aligned:
            return t
        buf = torch.empty(t.numel() + 32, dtype=torch.int8, device=cuda_device)
        off = (-buf.data_ptr()) % 16 + 4
        view = buf[off: off + t.numel()].view(t.shape)
        view.copy_(t)
        assert view.data_ptr() % 16 == 4
        return view

    v_r, v_c = on_card(x["v_r"]), on_card(x["v_c"])
    c = {k: torch.from_numpy(x[k]).to(cuda_device) for k in ("p", "a_r", "a_c")}
    kw = dict(s=S_PARAM, n_false=N_FALSE, block_e=4096)
    ops.copyscore_tile.launches = 0
    got = ops.copyscore_tile(v_r, v_c, c["p"], c["a_r"], c["a_c"], **kw)
    torch.cuda.synchronize()
    assert ops.copyscore_tile.launches == 1
    t = {k: torch.from_numpy(v) for k, v in x.items()}
    want = ref.copyscore_torch(t["v_r"], t["p"], t["a_r"], v_cols=t["v_c"],
                               acc_cols=t["a_c"], **kw)
    _assert_outputs([g.cpu() for g in got], want)


@pytest.mark.gpu
@pytest.mark.parametrize("accumulate", [False, True])
def test_err_kernel_at_legacy_shape_on_card(cuda_device, accumulate):
    """B2 at the legacy per-tile scan's launch: a 256 × 256 tile over 65
    entry blocks of 248 (4-byte loads, a ragged last K-slice), split into
    ranges across the SMs and summed by the second pass, written or added
    onto non-zero outputs: counts exact, C→ and err within the tolerance."""
    x = _instance(40, 256, 256, 65, 248)
    c = {k: torch.from_numpy(v).to(cuda_device) for k, v in x.items()}
    kw = dict(s=S_PARAM, n_false=N_FALSE)
    rng = np.random.default_rng(6)
    start = [torch.from_numpy(rng.normal(0, 3, (256, 256)).astype(np.float32))
             if accumulate else torch.zeros((256, 256)) for _ in range(3)]
    start[1] = start[1].round().abs()
    outs = tuple(t.to(cuda_device) for t in start)
    small = ops._single_operands(c["v_r"], c["v_c"], c["a_r"], c["a_c"],
                                 c["p"], c["d"], 248)
    ops._launch_single(c["v_r"], c["v_c"], small, outs, block_e=248,
                       accumulate=accumulate, **kw)
    torch.cuda.synchronize()
    t = {k: torch.from_numpy(v) for k, v in x.items()}
    want = ref.copyscore_torch(t["v_r"], t["p"], t["a_r"], v_cols=t["v_c"],
                               acc_cols=t["a_c"], delta_blk=t["d"],
                               block_e=248, **kw)
    _assert_outputs([o.cpu() for o in outs],
                    [a + b for a, b in zip(start, want)])


@pytest.mark.gpu
@pytest.mark.parametrize("S_r,S_c,n_e", [(256, 256, 65), (300, 200, 1)])
def test_err_kernel_two_launches_bit_equal_on_card(cuda_device, S_r, S_c, n_e):
    """No atomics in either pass of B2: two launches on the same inputs give
    the same bits, split (256 × 256, 33 ranges) and not split (300 × 200,
    one entry block)."""
    x = _instance(41, S_r, S_c, n_e, 248)
    c = {k: torch.from_numpy(v).to(cuda_device) for k, v in x.items()}
    runs = [ops.copyscore_tile(c["v_r"], c["v_c"], c["p"], c["a_r"], c["a_c"],
                               s=S_PARAM, n_false=N_FALSE, block_e=248,
                               delta_blk=c["d"]) for _ in range(2)]
    torch.cuda.synchronize()
    for a, b in zip(*runs):
        assert torch.equal(a, b)
