"""The port's copyscore against the JAX package's: the plain PyTorch version
against ``copyscore_fused_pallas`` in interpret mode and against
``copyscore_fused_ref``; the tile-list wrapper on CPU tensors; and, on a
card, the hand-written kernel against the plain version.

Tolerances: counts (n, n_out) are sums of 0/1 products, exact in every
version, so they must be equal. Scores (C→, C←, err) are float32 sums of
per-block products with the same association in every version, but XLA's
and PyTorch's ``log`` differ by an ulp here and there (and PyTorch's CUDA
division by a scalar multiplies by its reciprocal): rtol=2e-5, atol=1e-4
covers that round-off, not a different formula.

The JAX package is imported inside the tests that compare with it, so the
card-only tests (``-m gpu``) also run where JAX is not installed.
"""
import torch_threads  # noqa: F401  (caps torch's threads a worker)
import numpy as np
import pytest
import torch

from repro_torch.kernels import ops, ref

S_PARAM, N_FALSE = 0.8, 50.0
RTOL, ATOL = 2e-5, 1e-4


def _instance(seed, S_r, S_c, n_e, w):
    rng = np.random.default_rng(seed)
    E = n_e * w
    return dict(
        v_r=(rng.random((S_r, E)) < 0.2).astype(np.int8),
        v_c=(rng.random((S_c, E)) < 0.2).astype(np.int8),
        p=rng.uniform(0.01, 0.99, n_e).astype(np.float32),
        a_r=rng.uniform(0.05, 0.95, S_r).astype(np.float32),
        a_c=rng.uniform(0.05, 0.95, S_c).astype(np.float32),
        d=rng.uniform(0.0, 0.2, n_e).astype(np.float32),
        m=(rng.random(n_e) < 0.6).astype(np.float32))


def _torch_fused(x, w, diagonal):
    t = {k: torch.from_numpy(v) for k, v in x.items()}
    return ref.copyscore_fused_torch(
        t["v_r"], t["p"], t["a_r"], s=S_PARAM, n_false=N_FALSE, block_e=w,
        v_cols=None if diagonal else t["v_c"],
        acc_cols=None if diagonal else t["a_c"],
        delta_blk=t["d"], nout_blk=t["m"])


def _assert_channels(got, want):
    got = [np.asarray(g) for g in got]
    want = [np.asarray(g) for g in want]
    np.testing.assert_array_equal(got[2], want[2])          # n
    np.testing.assert_array_equal(got[3], want[3])          # n_out
    for c in (0, 1, 4):                                     # C→, C←, err
        np.testing.assert_allclose(got[c], want[c], rtol=RTOL, atol=ATOL)


@pytest.fixture(scope="module")
def jax_ops():
    """The JAX package's copyscore kernel and oracle, with jax.numpy."""
    jnp = pytest.importorskip("jax.numpy")
    from repro.kernels.copyscore import copyscore_fused_pallas
    from repro.kernels.ref import copyscore_fused_ref
    return jnp, copyscore_fused_pallas, copyscore_fused_ref


@pytest.mark.parametrize("w", [8, 40, 64])
@pytest.mark.parametrize("n_e", [1, 3])
@pytest.mark.parametrize("diagonal", [False, True])
def test_plain_matches_pallas_interpret(jax_ops, w, n_e, diagonal):
    jnp, copyscore_fused_pallas, _ = jax_ops
    x = _instance(w * 10 + n_e, 32, 64, n_e, w)
    got = _torch_fused(x, w, diagonal)
    v_c, a_c = (x["v_r"], x["a_r"]) if diagonal else (x["v_c"], x["a_c"])
    want = copyscore_fused_pallas(
        jnp.asarray(x["v_r"]), jnp.asarray(x["p"]), jnp.asarray(x["a_r"]),
        v_cols=jnp.asarray(v_c), acc_cols=jnp.asarray(a_c),
        delta_blk=jnp.asarray(x["d"]), nout_blk=jnp.asarray(x["m"]),
        s=S_PARAM, n_false=N_FALSE, block_i=32, block_j=32, block_e=w,
        interpret=True)
    _assert_channels(got, want)


@pytest.mark.parametrize("w", [8, 40, 64])
@pytest.mark.parametrize("n_e", [1, 3])
def test_plain_matches_jax_ref(jax_ops, w, n_e):
    jnp, _, copyscore_fused_ref = jax_ops
    x = _instance(w + n_e, 24, 40, n_e, w)
    got = _torch_fused(x, w, diagonal=False)
    want = copyscore_fused_ref(
        jnp.asarray(x["v_r"]), jnp.asarray(x["p"]), jnp.asarray(x["a_r"]),
        v_cols=jnp.asarray(x["v_c"]), acc_cols=jnp.asarray(x["a_c"]),
        delta_blk=jnp.asarray(x["d"]), nout_blk=jnp.asarray(x["m"]),
        s=S_PARAM, n_false=N_FALSE, block_e=w)
    _assert_channels(got, want)


@pytest.mark.parametrize("n_e", [1, 3])
def test_plain_diagonal_backward_is_forward_transpose_bitwise(n_e):
    x = _instance(11, 48, 48, n_e, 40)
    cf, cb, *_ = _torch_fused(x, 40, diagonal=True)
    assert torch.equal(cb, cf.T)


def _group(seed, T, nb, Gc, w):
    rng = np.random.default_rng(seed)
    S_pad = nb * T
    return dict(
        v=torch.from_numpy((rng.random((S_pad, Gc, w)) < 0.2).astype(np.int8)),
        acc=torch.from_numpy(rng.uniform(0.05, 0.95, S_pad).astype(np.float32)),
        p=torch.from_numpy(rng.uniform(0.01, 0.99, Gc).astype(np.float32)),
        d=torch.from_numpy(rng.uniform(0.0, 0.2, Gc).astype(np.float32)),
        m=torch.from_numpy((rng.random(Gc) < 0.6).astype(np.float32)))


def _coords(nb, device="cpu"):
    """Every r ≤ c tile of an nb × nb grid, row-major, with a (-1, -1) slot
    in the middle of the list."""
    live = [[r, c] for r in range(nb) for c in range(r, nb)]
    mid = len(live) // 2
    return torch.tensor(live[:mid] + [[-1, -1]] + live[mid:],
                        dtype=torch.int32, device=device)


@pytest.mark.parametrize("Gc,w", [(1, 8), (3, 40)])
def test_tile_scores_cpu_takes_plain_version(Gc, w):
    T, nb = 16, 3
    g = _group(Gc * w, T, nb, Gc, w)
    coords = _coords(nb)
    stacks = [torch.full((len(coords), T, T), 0.5) for _ in range(5)]
    ops.tile_scores.launches = 0
    ops.tile_scores(g["v"], g["acc"], g["p"], g["d"], g["m"], coords, stacks,
                    tile=T, s=S_PARAM, n_false=N_FALSE)
    assert ops.tile_scores.launches == 0
    v2 = g["v"].reshape(nb * T, Gc * w)
    for i, (r, c) in enumerate(coords.tolist()):
        got = [st[i] for st in stacks]
        if r < 0:                       # (-1,-1) slot left untouched
            for t in got:
                assert (t == 0.5).all()
            continue
        want = ref.copyscore_fused_torch(
            v2[r * T:(r + 1) * T], g["p"], g["acc"][r * T:(r + 1) * T],
            v_cols=v2[c * T:(c + 1) * T], acc_cols=g["acc"][c * T:(c + 1) * T],
            s=S_PARAM, n_false=N_FALSE, block_e=w, delta_blk=g["d"],
            nout_blk=g["m"])
        for t, wv in zip(got, want):
            assert torch.equal(t, 0.5 + wv)


def test_tile_scores_rejects_bad_operands():
    T, nb, Gc, w = 16, 2, 1, 8
    g = _group(0, T, nb, Gc, w)
    coords = _coords(nb)
    stacks = [torch.zeros((len(coords), T, T)) for _ in range(5)]
    args = (g["acc"], g["p"], g["d"], g["m"], coords, stacks)
    with pytest.raises(ValueError, match="int8"):
        ops.tile_scores(g["v"].float(), *args, tile=T, s=S_PARAM,
                        n_false=N_FALSE)
    with pytest.raises(ValueError, match="S_pad % tile"):
        ops.tile_scores(g["v"], *args, tile=24, s=S_PARAM, n_false=N_FALSE)
    with pytest.raises(ValueError, match="coords"):
        ops.tile_scores(g["v"], g["acc"], g["p"], g["d"], g["m"],
                        coords.long(), stacks, tile=T, s=S_PARAM,
                        n_false=N_FALSE)


def test_copyscore_tile_fused_cpu_matches_plain():
    x = _instance(5, 32, 32, 2, 16)
    t = {k: torch.from_numpy(v) for k, v in x.items()}
    got = ops.copyscore_tile_fused(
        t["v_r"], t["v_c"], t["p"], t["a_r"], t["a_c"], s=S_PARAM,
        n_false=N_FALSE, block_e=16, delta_blk=t["d"], nout_blk=t["m"])
    want = _torch_fused(x, 16, diagonal=False)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.fixture
def cuda_device():
    """The card, or a skip where there is none (decided here, at run time)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    return torch.device("cuda")


#: (Gc, w) on the card: w = 8, 40 (chunks shorter than a K-slice), 136 and
#: 520 take the 4-byte loads with a ragged last K-slice; 64 and 4096 the
#: whole 16-byte ones (at Gc = 1 the detection pass's variant)
_CARD_GW = [(1, 8), (1, 64), (1, 136), (1, 4096), (2, 520), (3, 40), (3, 64)]


@pytest.mark.gpu
@pytest.mark.parametrize("Gc,w", _CARD_GW)
@pytest.mark.parametrize("T", [64, 96, 128, 256])
def test_kernel_matches_plain_on_card(cuda_device, T, Gc, w):
    """B1 against its plain version: one 128-row sub-tile over a smaller
    tile (T = 64, 96: rows and columns past T masked by the tile's edge),
    exactly one (128), several (256); one chunk (five channels staged in
    turn) and several (five sums in shared memory)."""
    nb = 3 if Gc == 3 else 2
    g = {k: v.to(cuda_device) for k, v in _group(T + w, T, nb, Gc, w).items()}
    coords = _coords(nb, cuda_device)
    st_k = [torch.full((len(coords), T, T), 0.25, device=cuda_device)
            for _ in range(5)]
    st_r = [s.clone() for s in st_k]
    ops.tile_scores.launches = 0
    ops.tile_scores(g["v"], g["acc"], g["p"], g["d"], g["m"], coords, st_k,
                    tile=T, s=S_PARAM, n_false=N_FALSE)
    torch.cuda.synchronize()
    assert ops.tile_scores.launches == 1
    ref.tile_scores_torch(g["v"], g["acc"], g["p"], g["d"], g["m"], coords,
                          st_r, tile=T, s=S_PARAM, n_false=N_FALSE)
    _assert_channels([s.cpu() for s in st_k], [s.cpu() for s in st_r])
    for i, (r, c) in enumerate(coords.tolist()):
        if r < 0:
            assert all((s[i] == 0.25).all() for s in st_k)
        elif r == c:
            assert torch.equal(st_k[1][i], st_k[0][i].T)


@pytest.mark.gpu
@pytest.mark.parametrize("Gc", [1, 3])
def test_all_ones_counts_are_exact_fused_on_card(cuda_device, Gc):
    """All-ones incidence 4096 wide a chunk: n is exactly 4096·Gc and n_out
    exactly 4096 times the number of non-Ē chunks, the int32 counts carried
    to float32 unrounded; the scores agree with the plain version."""
    T, nb, w = 128, 2, 4096
    g = {k: v.to(cuda_device) for k, v in _group(7 + Gc, T, nb, Gc, w).items()}
    g["v"] = torch.ones_like(g["v"])
    g["m"] = torch.tensor([1.0, 0.0, 1.0][:Gc], device=cuda_device)
    coords = _coords(nb, cuda_device)
    st_k = [torch.zeros((len(coords), T, T), device=cuda_device)
            for _ in range(5)]
    st_r = [s.clone() for s in st_k]
    ops.tile_scores(g["v"], g["acc"], g["p"], g["d"], g["m"], coords, st_k,
                    tile=T, s=S_PARAM, n_false=N_FALSE)
    ref.tile_scores_torch(g["v"], g["acc"], g["p"], g["d"], g["m"], coords,
                          st_r, tile=T, s=S_PARAM, n_false=N_FALSE)
    live = coords[:, 0] >= 0
    n_out = float(w * int(g["m"].sum().item()))
    assert torch.equal(st_k[2][live].cpu(),
                       torch.full((int(live.sum()), T, T), float(w * Gc)))
    assert torch.equal(st_k[3][live].cpu(),
                       torch.full((int(live.sum()), T, T), n_out))
    _assert_channels([s.cpu() for s in st_k], [s.cpu() for s in st_r])


@pytest.mark.gpu
@pytest.mark.parametrize("Gc,w", [(1, 4096), (3, 64)])
def test_two_launches_are_bit_equal_on_card(cuda_device, Gc, w):
    """No float atomics: two launches on the same inputs give the same
    bits in every channel."""
    T, nb = 256, 2
    g = {k: v.to(cuda_device) for k, v in _group(3, T, nb, Gc, w).items()}
    coords = _coords(nb, cuda_device)
    runs = []
    for _ in range(2):
        st = [torch.zeros((len(coords), T, T), device=cuda_device)
              for _ in range(5)]
        ops.tile_scores(g["v"], g["acc"], g["p"], g["d"], g["m"], coords, st,
                        tile=T, s=S_PARAM, n_false=N_FALSE)
        runs.append(st)
    torch.cuda.synchronize()
    for a, b in zip(*runs):
        assert torch.equal(a, b)


@pytest.mark.gpu
def test_copyscore_tile_fused_on_card_matches_plain(cuda_device):
    x = _instance(9, 64, 64, 3, 40)
    t = {k: torch.from_numpy(v) for k, v in x.items()}
    c = {k: v.to(cuda_device) for k, v in t.items()}
    ops.tile_scores.launches = 0
    got = ops.copyscore_tile_fused(
        c["v_r"], c["v_c"], c["p"], c["a_r"], c["a_c"], s=S_PARAM,
        n_false=N_FALSE, block_e=40, delta_blk=c["d"], nout_blk=c["m"])
    torch.cuda.synchronize()
    assert ops.tile_scores.launches == 1
    _assert_channels([g.cpu() for g in got], _torch_fused(x, 40, diagonal=False))
