"""The port's flash-attention forward against the JAX package's.

The plain PyTorch version (``ref.flash_attention_fwd_torch``, which the
CPU dispatch of ``ops.flash_attention_fwd`` takes) against
``flash_attention_fwd(..., interpret=True)`` and ``attention_ref`` of the
JAX package on the same seeded numpy inputs; the wrapper's checks; and, on
a card, the hand-written kernel against the plain version.

Tolerances are those of ``tests/test_kernels_flash.py``: float32 o and lse
within rtol/atol 2e-5 (the same float32 arithmetic summed in another
order); bfloat16 o within 2e-2 (one bf16 rounding of o, whose entries are
O(1)), its lse — float32 arithmetic on the same bf16-valued inputs — within
2e-5.

The JAX package is imported inside the tests that compare with it, so the
card-only tests (``-m gpu``) also run where JAX is not installed.
"""
import torch_threads  # noqa: F401  (caps torch's threads a worker)
import numpy as np
import pytest
import torch

from repro_torch.kernels import ops, ref

F32_TOL = dict(rtol=2e-5, atol=2e-5)
BF16_TOL = dict(rtol=2e-2, atol=2e-2)


def _qkv(seed, B, Hq, Hkv, Sq, D, Sk=None):
    rng = np.random.default_rng(seed)
    Sk = Sq if Sk is None else Sk
    return (rng.normal(0, 1, (B, Hq, Sq, D)).astype(np.float32),
            rng.normal(0, 1, (B, Hkv, Sk, D)).astype(np.float32),
            rng.normal(0, 1, (B, Hkv, Sk, D)).astype(np.float32))


def _torch(arrs, dtype=torch.float32, device="cpu"):
    return [torch.from_numpy(a).to(device=device, dtype=dtype) for a in arrs]


@pytest.fixture(scope="module")
def jax_flash():
    """The JAX package's flash forward and reference attention."""
    jnp = pytest.importorskip("jax.numpy")
    from repro.kernels.flash_attention import flash_attention_fwd
    from repro.kernels.ref import attention_ref
    return jnp, flash_attention_fwd, attention_ref


# (B, Hq, Hkv, S, D, block, causal, window): the block sizes are JAX's
CASES = [
    (1, 2, 2, 128, 64, 64, True, None),       # MHA
    (1, 4, 2, 128, 64, 64, True, None),       # GQA, group 2
    (1, 8, 2, 128, 64, 32, True, None),       # GQA, group 4
    (2, 4, 1, 128, 64, 64, True, None),       # MQA
    (1, 2, 2, 128, 64, 64, False, None),      # non-causal
    (1, 2, 1, 256, 64, 64, True, 32),         # sliding windows
    (1, 2, 1, 256, 64, 64, True, 64),
    (1, 2, 1, 256, 64, 64, True, 100),
    (1, 2, 2, 256, 128, 128, True, None),     # head_dim 128
]


def _case_id(c):
    B, Hq, Hkv, S, D, blk, causal, window = c
    return (f"B{B}-Hq{Hq}-Hkv{Hkv}-S{S}-D{D}-{'causal' if causal else 'full'}"
            f"-w{window}")


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_plain_matches_pallas_interpret(jax_flash, case):
    jnp, flash_attention_fwd, _ = jax_flash
    B, Hq, Hkv, S, D, blk, causal, window = case
    arrs = _qkv(S + Hq + D, B, Hq, Hkv, S, D)
    o, lse = ref.flash_attention_fwd_torch(*_torch(arrs), causal=causal,
                                           window=window)
    o_j, lse_j = flash_attention_fwd(*(jnp.asarray(a) for a in arrs),
                                     causal=causal, window=window,
                                     block_q=blk, block_k=blk, interpret=True)
    np.testing.assert_allclose(o.numpy(), np.asarray(o_j), **F32_TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_j), **F32_TOL)


@pytest.mark.parametrize("Hkv", [4, 2, 1])
def test_bf16_plain_matches_pallas_interpret(jax_flash, Hkv):
    jnp, flash_attention_fwd, _ = jax_flash
    arrs = _qkv(11 + Hkv, 1, 4, Hkv, 128, 64)
    o, lse = ref.flash_attention_fwd_torch(*_torch(arrs, torch.bfloat16))
    o_j, lse_j = flash_attention_fwd(
        *(jnp.asarray(a, jnp.bfloat16) for a in arrs), causal=True,
        block_q=64, block_k=64, interpret=True)
    assert o.dtype == torch.bfloat16 and lse.dtype == torch.float32
    np.testing.assert_allclose(o.float().numpy(),
                               np.asarray(o_j, dtype=np.float32), **BF16_TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_j), **F32_TOL)


@pytest.mark.parametrize("causal,window", [(True, None), (False, None),
                                           (True, 32), (True, 100)])
def test_ragged_plain_matches_attention_ref(jax_flash, causal, window):
    """Sq = Sk = 100 is no multiple of any block: the JAX kernel would leave
    rows unwritten (ROADMAP C5), the port's versions compute every row."""
    jnp, _, attention_ref = jax_flash
    arrs = _qkv(100 + (window or 0), 2, 4, 2, 100, 64)
    o, lse = ref.flash_attention_fwd_torch(*_torch(arrs), causal=causal,
                                           window=window)
    o_j = attention_ref(*(jnp.asarray(a) for a in arrs), causal=causal,
                        window=window)
    np.testing.assert_allclose(o.numpy(), np.asarray(o_j), **F32_TOL)
    o_r = ref.attention_ref(*_torch(arrs), causal=causal, window=window)
    np.testing.assert_allclose(o_r.numpy(), np.asarray(o_j), **F32_TOL)
    assert np.isfinite(lse.numpy()).all()


@pytest.mark.parametrize("case", CASES[:5], ids=_case_id)
def test_port_attention_ref_matches_jax(jax_flash, case):
    jnp, _, attention_ref = jax_flash
    B, Hq, Hkv, S, D, _, causal, window = case
    arrs = _qkv(7 * S + Hq, B, Hq, Hkv, S, D)
    got = ref.attention_ref(*_torch(arrs), causal=causal, window=window)
    want = attention_ref(*(jnp.asarray(a) for a in arrs), causal=causal,
                         window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)


def test_lse_is_the_logsumexp_of_the_visible_logits():
    q, k, v = _torch(_qkv(3, 1, 2, 1, 50, 64))
    _, lse = ref.flash_attention_fwd_torch(q, k, v, causal=True, window=20)
    s = torch.einsum("bhqd,bhkd->bhqk", q, k.expand(-1, 2, -1, -1)) / 8.0
    i = torch.arange(50)[:, None]
    j = torch.arange(50)[None, :]
    s = s.masked_fill(~((i >= j) & (i - j < 20)), float("-inf"))
    torch.testing.assert_close(lse, torch.logsumexp(s, dim=-1), **F32_TOL)


def test_row_with_nothing_visible_is_zero():
    """Sq > Sk under causal masking and a window: queries 39.. see no key
    (the last key is 29), so o = 0 and lse = NEG_INF + log 1."""
    q, k, v = _torch(_qkv(5, 1, 2, 2, 48, 64, Sk=30))
    o, lse = ops.flash_attention_fwd(q, k, v, causal=True, window=10)
    assert torch.equal(o[:, :, 39:], torch.zeros_like(o[:, :, 39:]))
    assert (lse[:, :, 39:] == ref.NEG_INF).all()
    assert (o[:, :, :39].abs().sum(-1) > 0).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_all_ones_v_gives_ones(dtype):
    """Invariant: with v = 1 every visible row averages to exactly 1."""
    q, k, _ = _torch(_qkv(9, 1, 4, 2, 70, 64), dtype)
    v = torch.ones_like(k)
    for causal, window in ((True, None), (False, None), (True, 16)):
        o, _ = ops.flash_attention_fwd(q, k, v, causal=causal, window=window)
        torch.testing.assert_close(o.float(), torch.ones_like(o.float()),
                                   rtol=0, atol=1e-5)


def test_cpu_dispatch_takes_plain_version():
    q, k, v = _torch(_qkv(1, 2, 4, 2, 70, 64))
    ops.flash_attention_fwd.launches = 0
    o, lse = ops.flash_attention_fwd(q, k, v, causal=True, window=32)
    o_p, lse_p = ref.flash_attention_fwd_torch(q, k, v, causal=True, window=32)
    assert torch.equal(o, o_p) and torch.equal(lse, lse_p)
    assert ops.flash_attention_fwd.launches == 0
    assert torch.equal(ops.flash_attention(q, k, v, impl="kernel"),
                       ref.flash_attention_fwd_torch(q, k, v)[0])
    assert torch.equal(ops.flash_attention(q, k, v, impl="reference"),
                       ref.attention_ref(q, k, v))
    with pytest.raises(ValueError, match="impl"):
        ops.flash_attention(q, k, v, impl="pallas")


def test_rejects_bad_operands():
    q, k, v = _torch(_qkv(2, 1, 4, 2, 64, 64))
    with pytest.raises(ValueError, match="dtype"):
        ops.flash_attention_fwd(q.half(), k.half(), v.half())
    with pytest.raises(ValueError, match="dtype"):
        ops.flash_attention_fwd(q, k.bfloat16(), v)
    with pytest.raises(ValueError, match="head_dim"):
        ops.flash_attention_fwd(q[..., :32].contiguous(),
                                k[..., :32].contiguous(),
                                v[..., :32].contiguous())
    with pytest.raises(ValueError, match="multiple of Hkv"):
        ops.flash_attention_fwd(q[:, :3].contiguous(), k, v)
    with pytest.raises(ValueError, match="contiguous"):
        ops.flash_attention_fwd(q.transpose(2, 3).contiguous().transpose(2, 3),
                                k, v)
    with pytest.raises(ValueError, match="window"):
        ops.flash_attention_fwd(q, k, v, window=0)
    with pytest.raises(ValueError, match="k and v"):
        ops.flash_attention_fwd(q, k, v[:, :, :10].contiguous())


# The bf16 kernel's split (csrc/flash_mma.cuh), emulated here on the CPU: a
# float32 x enters the tensor cores as hi + lo, hi = bf16(x), lo = bf16(x − hi),
# and each product hi·y, lo·y with a bf16 y is exact in float32.
def _split(x):
    hi = x.to(torch.bfloat16).float()
    return hi, (x - hi).to(torch.bfloat16).float()


def test_split_reproduces_float32_within_2_pow_minus_16():
    """Random float32 P in (0, 1] and signed dS over seven decades."""
    rng = np.random.default_rng(0)
    n = 200_000
    p = np.exp(-rng.exponential(4.0, n))
    ds = rng.normal(0, 1, n) * 10.0 ** rng.uniform(-6, 1, n)
    for x in (p, ds):
        x = torch.from_numpy(x.astype(np.float32))
        hi, lo = _split(x)
        assert bool(((x - (hi + lo)).abs() <= 2.0 ** -16 * x.abs()).all())


# (B, Hq, Hkv, Sq, Sk, D, causal, window): MHA, GQA, window, ragged
SPLIT_CASES = [
    (1, 2, 2, 128, 128, 64, True, None),
    (1, 8, 2, 128, 128, 64, True, None),
    (1, 2, 1, 256, 256, 64, True, 32),
    (2, 4, 2, 100, 100, 64, True, None),
    (1, 2, 2, 100, 37, 128, False, None),
]


@pytest.mark.parametrize("case", SPLIT_CASES,
                         ids=lambda c: "-".join(str(x) for x in c))
def test_split_forward_matches_plain(case):
    """The bf16 kernel's arithmetic: P·v as hi·v + lo·v and l = Σ(hi + lo),
    o = acc / l rounded once to bf16, agrees with the plain version within
    the bf16 tolerance ``chip_smoke.py`` states (FLASH_BF16_TOL); and before
    that rounding, one bf16 rounding of P (what SDPA does) errs far more
    than the split against P·v in float64."""
    B, Hq, Hkv, Sq, Sk, D, causal, window = case
    q, k, v = _torch(_qkv(Sq + Sk + Hq, B, Hq, Hkv, Sq, D, Sk=Sk),
                     torch.bfloat16)
    group = Hq // Hkv
    kk = k.float().repeat_interleave(group, dim=1)
    vv = v.float().repeat_interleave(group, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kk) / D ** 0.5
    mask = ref._visible(Sq, Sk, causal, window, q.device)
    s = s.masked_fill(~mask, ref.NEG_INF)
    p = torch.exp(s - s.amax(-1, keepdim=True)).masked_fill(~mask, 0.0)
    hi, lo = _split(p)
    acc = hi @ vv + lo @ vv
    l = (hi + lo).sum(-1, keepdim=True)
    o_p, _ = ref.flash_attention_fwd_torch(q, k, v, causal=causal,
                                           window=window)
    torch.testing.assert_close((acc / l).to(torch.bfloat16).float(),
                               o_p.float(), **BF16_TOL)
    exact = (p.double() @ vv.double()) / p.double().sum(-1, keepdim=True)
    e_split = float(((acc / l).double() - exact).abs().max())
    rounded = p.to(torch.bfloat16).float() @ vv / p.sum(-1, keepdim=True)
    e_round = float((rounded.double() - exact).abs().max())
    assert 50 * e_split < e_round, (e_split, e_round)


@pytest.fixture
def cuda_device():
    """The card, or a skip where there is none (decided here, at run time)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    return torch.device("cuda")


# (B, Hq, Hkv, Sq, Sk, D, causal, window)
CARD_CASES = [
    (2, 4, 4, 256, 256, 64, True, None),      # MHA
    (2, 8, 2, 256, 256, 64, True, None),      # GQA, group 4
    (1, 4, 1, 256, 256, 64, True, None),      # MQA
    (1, 4, 2, 192, 192, 64, False, None),     # non-causal
    (1, 4, 2, 256, 256, 64, True, 32),
    (1, 4, 2, 256, 256, 64, True, 100),
    (1, 4, 2, 256, 256, 128, True, None),     # head_dim 128
    (1, 4, 2, 1000, 1000, 64, True, None),    # ragged
    (1, 2, 2, 100, 37, 128, False, None),     # ragged, Sq != Sk
    (1, 4, 2, 300, 428, 64, True, None),      # causal, no multiple of 128
]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("case", CARD_CASES,
                         ids=lambda c: "-".join(str(x) for x in c))
def test_kernel_matches_plain_on_card(cuda_device, case, dtype):
    B, Hq, Hkv, Sq, Sk, D, causal, window = case
    q, k, v = _torch(_qkv(Sq + D, B, Hq, Hkv, Sq, D, Sk=Sk), dtype, cuda_device)
    ops.flash_attention_fwd.launches = 0
    o, lse = ops.flash_attention_fwd(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert ops.flash_attention_fwd.launches == 1
    o_p, lse_p = ref.flash_attention_fwd_torch(q, k, v, causal=causal,
                                               window=window)
    tol = F32_TOL if dtype == torch.float32 else BF16_TOL
    torch.testing.assert_close(o.float(), o_p.float(), **tol)
    torch.testing.assert_close(lse, lse_p, **F32_TOL)
    ones, _ = ops.flash_attention_fwd(q, k, torch.ones_like(v), causal=causal,
                                      window=window)
    torch.testing.assert_close(ones.float(), torch.ones_like(ones.float()),
                               rtol=0, atol=1e-5)


@pytest.mark.gpu
def test_kernel_refuses_to_build_a_graph(cuda_device):
    q, k, v = _torch(_qkv(4, 1, 2, 2, 64, 64), device=cuda_device)
    q.requires_grad_(True)
    with pytest.raises(RuntimeError, match="FlashAttention"):
        ops.flash_attention_fwd(q, k, v)
    with torch.no_grad():
        ops.flash_attention_fwd(q, k, v)
