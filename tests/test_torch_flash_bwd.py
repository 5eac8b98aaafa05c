"""The port's flash-attention backward against the JAX package's.

The plain PyTorch version (``ref.flash_attention_bwd_torch``, which the
CPU dispatch of ``ops.flash_attention_bwd`` takes) against the JAX
``flash_attention_bwd(..., block_q=64, block_k=64, interpret=True)`` on the
same seeded numpy inputs and the same (o, lse) from the JAX forward, at
multiples of 64 only: the JAX wrapper floors ragged tile counts (ROADMAP
C5). Then the CPU ``FlashAttention`` Function's gradient against autograd
of ``ref.attention_ref``, ragged sizes and rows with nothing visible
included; the wrappers' checks; the bf16 kernels' hi + lo split of P and
dS, emulated on the CPU (its error bound, and dq, dk, dv computed through
it against the plain versions); and, on a card, the hand-written kernels
against their plain versions.

Tolerances. float32 dq, dk, dv within rtol/atol 2e-5: the same float32
arithmetic summed in another order (observed ≤ 5e-6 on entries up to ≈ 8).
bfloat16 within 2e-2: both sides compute in float32 from the same
bf16-valued inputs and round each gradient once to bf16, so they differ by
at most a bf16 rounding step (2⁻⁸ relative) where the float32 values fall
on opposite sides of a rounding boundary. The Function against autograd of
``attention_ref`` (float32): 1e-4, since autograd differentiates the
softmax another way (through the normalised probabilities, not from lse).

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
AUTOGRAD_TOL = dict(rtol=1e-4, atol=1e-4)


def _inputs(seed, B, Hq, Hkv, Sq, D, Sk=None):
    """q, k, v, do as float32 numpy arrays from ``seed``."""
    rng = np.random.default_rng(seed)
    Sk = Sq if Sk is None else Sk
    return (rng.normal(0, 1, (B, Hq, Sq, D)).astype(np.float32),
            rng.normal(0, 1, (B, Hkv, Sk, D)).astype(np.float32),
            rng.normal(0, 1, (B, Hkv, Sk, D)).astype(np.float32),
            rng.normal(0, 1, (B, Hq, Sq, D)).astype(np.float32))


# (B, Hq, Hkv, S, D, causal, window)
JAX_CASES = [
    (1, 4, 4, 128, 64, True, None),       # MHA
    (2, 4, 2, 128, 64, True, None),       # GQA, group 2
    (1, 4, 1, 128, 64, True, None),       # MQA
    (1, 4, 2, 128, 64, False, None),      # non-causal
    (1, 4, 2, 192, 64, True, 48),         # window 48
    (1, 2, 1, 128, 128, True, None),      # head_dim 128
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", JAX_CASES,
                         ids=lambda c: "-".join(str(x) for x in c))
def test_plain_bwd_matches_jax_interpret(case, dtype):
    jax = pytest.importorskip("jax")
    jnp = jax.numpy
    from repro.kernels.flash_attention import (
        flash_attention_bwd as jax_bwd,
        flash_attention_fwd as jax_fwd,
    )
    B, Hq, Hkv, S, D, causal, window = case
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    jq, jk, jv, jdo = (jnp.asarray(a).astype(jdt)
                       for a in _inputs(S + Hq, B, Hq, Hkv, S, D))
    blocks = dict(block_q=64, block_k=64, interpret=True)
    o, lse = jax_fwd(jq, jk, jv, causal=causal, window=window, **blocks)
    want = jax_bwd(jq, jk, jv, o, lse, jdo, causal=causal, window=window,
                   **blocks)
    # bf16 values are exact in float32, so both sides see the same inputs
    tq, tk, tv, to, tdo = (torch.from_numpy(np.array(a.astype(jnp.float32))).to(tdt)
                           for a in (jq, jk, jv, o, jdo))
    got = ops.flash_attention_bwd(tq, tk, tv, to, torch.from_numpy(np.array(lse)),
                                  tdo, causal=causal, window=window)
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == tdt, name
        torch.testing.assert_close(
            g.float(), torch.from_numpy(np.array(w.astype(jnp.float32))),
            **tol, msg=lambda m: f"{name}: {m}")


def _grads(fn, q, k, v, g):
    q, k, v = (t.clone().requires_grad_(True) for t in (q, k, v))
    o = fn(q, k, v)
    return torch.autograd.grad(o, (q, k, v), g)


# (B, Hq, Hkv, Sq, Sk, D, causal, window)
AUTOGRAD_CASES = [
    (1, 4, 2, 128, 128, 64, True, None),
    (1, 4, 1, 100, 100, 64, True, None),      # ragged
    (1, 2, 2, 100, 37, 128, False, None),     # ragged, Sq != Sk
    (2, 4, 2, 96, 96, 64, True, 20),          # window, ragged
]


@pytest.mark.parametrize("case", AUTOGRAD_CASES,
                         ids=lambda c: "-".join(str(x) for x in c))
def test_function_grad_matches_autograd_of_reference(case):
    B, Hq, Hkv, Sq, Sk, D, causal, window = case
    q, k, v, g = (torch.from_numpy(a)
                  for a in _inputs(Sq + Sk, B, Hq, Hkv, Sq, D, Sk=Sk))
    got = _grads(lambda *t: ops.flash_attention(*t, causal=causal,
                                                window=window), q, k, v, g)
    want = _grads(lambda *t: ref.attention_ref(*t, causal=causal,
                                               window=window), q, k, v, g)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        torch.testing.assert_close(a, b, **AUTOGRAD_TOL,
                                   msg=lambda m: f"{name}: {m}")


def test_empty_rows_get_zero_gradients():
    """Sq > Sk under a causal window: queries 79.. see no key (j < 64 and
    i − j < 16). Their dq is 0, no gradient is NaN, and the visible rows
    agree with autograd of the reference."""
    B, Hq, Hkv, Sq, Sk, D, window = 1, 4, 2, 128, 64, 64, 16
    q, k, v, g = (torch.from_numpy(a)
                  for a in _inputs(5, B, Hq, Hkv, Sq, D, Sk=Sk))
    o, lse = ops.flash_attention_fwd(q, k, v, causal=True, window=window)
    assert bool((lse[:, :, 79:] == ref.NEG_INF).all())
    dq, dk, dv = _grads(lambda *t: ops.flash_attention(*t, causal=True,
                                                       window=window), q, k, v, g)
    for t in (dq, dk, dv):
        assert bool(torch.isfinite(t).all())
    assert bool((dq[:, :, 79:] == 0).all()) and bool(dq[:, :, :79].abs().sum() > 0)
    # the same gradients from the visible rows alone
    want = _grads(lambda q_, k_, v_: ref.attention_ref(
        q_, k_, v_, causal=True, window=window), q[:, :, :79], k, v, g[:, :, :79])
    torch.testing.assert_close(dq[:, :, :79], want[0], **AUTOGRAD_TOL)
    torch.testing.assert_close(dk, want[1], **AUTOGRAD_TOL)
    torch.testing.assert_close(dv, want[2], **AUTOGRAD_TOL)


def test_bwd_parts_compose():
    """``flash_attention_bwd`` is delta = rowsum(do·o), then the dq and the
    dk/dv wrappers."""
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(9, 1, 4, 2, 64, 64))
    o, lse = ops.flash_attention_fwd(q, k, v)
    delta = (do * o).sum(-1)
    dq, dk, dv = ops.flash_attention_bwd(q, k, v, o, lse, do)
    assert torch.equal(dq, ops.flash_attention_bwd_dq(q, k, v, do, lse, delta))
    dk2, dv2 = ops.flash_attention_bwd_dkv(q, k, v, do, lse, delta)
    assert torch.equal(dk, dk2) and torch.equal(dv, dv2)


def test_bwd_checks_its_operands():
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(1, 1, 2, 2, 64, 64))
    o, lse = ops.flash_attention_fwd(q, k, v)
    delta = (do * o).sum(-1)
    with pytest.raises(ValueError, match="do must be like q"):
        ops.flash_attention_bwd(q, k, v, o, lse, do[:, :, :10])
    with pytest.raises(ValueError, match="do must be like q"):
        ops.flash_attention_bwd_dq(q, k, v, do.double(), lse, delta)
    with pytest.raises(ValueError, match="lse"):
        ops.flash_attention_bwd(q, k, v, o, lse.double(), do)
    with pytest.raises(ValueError, match="delta"):
        ops.flash_attention_bwd_dkv(q, k, v, do, lse, delta[:, :, :5])
    with pytest.raises(ValueError, match="contiguous"):
        ops.flash_attention_bwd_dq(q, k, v, do.transpose(2, 3), lse, delta)
    with pytest.raises(ValueError, match="o must be like q"):
        ops.flash_attention_bwd(q, k, v, o[:, :1], lse, do)
    with pytest.raises(ValueError, match="head_dim"):
        ops.flash_attention_bwd_dq(q[..., :32].contiguous(),
                                   k[..., :32].contiguous(),
                                   v[..., :32].contiguous(),
                                   do[..., :32].contiguous(), lse, delta)


# The bf16 backward kernels' split (csrc/flash_mma.cuh), emulated here on
# the CPU: P and dS enter the second products as hi + lo, hi = bf16(x),
# lo = bf16(x − hi), and each product with a bf16 operand is exact in float32.
def _split(x):
    hi = x.to(torch.bfloat16).float()
    return hi, (x - hi).to(torch.bfloat16).float()


def test_split_error_bound_is_2_pow_minus_17():
    """The bound the kernels' source notes state, |x − (hi + lo)| ≤
    2⁻¹⁷·|x|, over every float32 of [1, 2) (the relative error repeats in
    every binade); and it is attained to within 1 %, so 2⁻¹⁸ would be
    wrong."""
    x = torch.arange(0x3F800000, 0x40000000, dtype=torch.int32).view(
        torch.float32)
    hi, lo = _split(x)
    rel = float(((x - (hi + lo)).double().abs() / x.double()).max())
    assert 0.99 * 2.0 ** -17 < rel <= 2.0 ** -17


def test_split_reproduces_p_and_ds_within_2_pow_minus_16():
    """P and dS of a real backward, split, within 2⁻¹⁶ relative."""
    q, k, v, do = (torch.from_numpy(a).to(torch.bfloat16)
                   for a in _inputs(3, 1, 4, 2, 128, 64))
    o, lse = ref.flash_attention_fwd_torch(q, k, v)
    delta = (do.float() * o.float()).sum(-1)
    p, ds, _, _ = ref._bwd_probs(q, k, v, do, lse, delta, True, None, None)
    assert bool((ds != 0).any())
    for x in (p, ds):
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
def test_split_dkv_matches_plain(case):
    """The bf16 dk/dv kernel's arithmetic: dv = Σ (hi + lo)(P)ᵀ·do and
    dk = Σ (hi + lo)(dS)ᵀ·q, each rounded once to bf16, agree with the plain
    version within the bf16 tolerance ``chip_smoke.py`` states
    (FLASH_BWD_BF16_TOL); and before that rounding, one bf16 rounding of P
    and of dS errs far more than the split against float64."""
    B, Hq, Hkv, Sq, Sk, D, causal, window = case
    q, k, v, do = (torch.from_numpy(a).to(torch.bfloat16)
                   for a in _inputs(Sq + Sk + Hq, B, Hq, Hkv, Sq, D, Sk=Sk))
    kw = dict(causal=causal, window=window)
    o, lse = ref.flash_attention_fwd_torch(q, k, v, **kw)
    delta = (do.float() * o.float()).sum(-1)
    p, ds, qg, dog = ref._bwd_probs(q, k, v, do, lse, delta, causal, None,
                                    window)
    dk_p, dv_p = ref.flash_attention_bwd_dkv_torch(q, k, v, do, lse, delta,
                                                   **kw)
    prod = "bhgqk,bhgqd->bhkd"
    for name, x, y, plain in (("dv", p, dog, dv_p), ("dk", ds, qg, dk_p)):
        hi, lo = _split(x)
        got = torch.einsum(prod, hi, y) + torch.einsum(prod, lo, y)
        torch.testing.assert_close(got.to(torch.bfloat16).float(),
                                   plain.float(), **BF16_TOL,
                                   msg=lambda m: f"{name}: {m}")
        exact = torch.einsum(prod, x.double(), y.double())
        e_split = float((got.double() - exact).abs().max())
        rounded = torch.einsum(prod, x.to(torch.bfloat16).float(), y)
        e_round = float((rounded.double() - exact).abs().max())
        assert 50 * e_split < e_round, (name, e_split, e_round)


@pytest.mark.parametrize("case", SPLIT_CASES,
                         ids=lambda c: "-".join(str(x) for x in c))
def test_split_dq_matches_plain(case):
    """The bf16 dq kernel's arithmetic: S and dP exact from bf16 inputs in
    float32, dS split, dq = Σ (hi + lo)(dS)·k rounded once to bf16, agrees
    with the plain version within the bf16 tolerance ``chip_smoke.py``
    states (FLASH_BWD_BF16_TOL); and before that rounding, one bf16
    rounding of dS errs far more than the split against float64."""
    B, Hq, Hkv, Sq, Sk, D, causal, window = case
    q, k, v, do = (torch.from_numpy(a).to(torch.bfloat16)
                   for a in _inputs(Sq + Sk + Hq + 1, B, Hq, Hkv, Sq, D, Sk=Sk))
    kw = dict(causal=causal, window=window)
    o, lse = ref.flash_attention_fwd_torch(q, k, v, **kw)
    delta = (do.float() * o.float()).sum(-1)
    _, ds, _, _ = ref._bwd_probs(q, k, v, do, lse, delta, causal, None, window)
    plain = ref.flash_attention_bwd_dq_torch(q, k, v, do, lse, delta, **kw)
    prod = "bhgqk,bhkd->bhgqd"
    kf = k.float()
    hi, lo = _split(ds)
    got = torch.einsum(prod, hi, kf) + torch.einsum(prod, lo, kf)
    torch.testing.assert_close(got.reshape(q.shape).to(torch.bfloat16).float(),
                               plain.float(), **BF16_TOL)
    exact = torch.einsum(prod, ds.double(), kf.double())
    e_split = float((got.double() - exact).abs().max())
    rounded = torch.einsum(prod, ds.to(torch.bfloat16).float(), kf)
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
    (1, 4, 2, 256, 256, 64, True, 48),
    (1, 4, 2, 256, 256, 128, True, 100),      # head_dim 128, window
    (1, 4, 2, 1000, 1000, 64, True, None),    # ragged
    (1, 2, 2, 100, 37, 128, False, None),     # ragged, Sq != Sk
    (1, 4, 2, 128, 64, 64, True, 16),         # empty rows
    (1, 4, 2, 300, 428, 64, True, None),      # causal, no multiple of 128
]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("case", CARD_CASES,
                         ids=lambda c: "-".join(str(x) for x in c))
def test_kernels_match_plain_on_card(cuda_device, case, dtype):
    B, Hq, Hkv, Sq, Sk, D, causal, window = case
    q, k, v, do = (torch.from_numpy(a).to(cuda_device, dtype)
                   for a in _inputs(Sq + D, B, Hq, Hkv, Sq, D, Sk=Sk))
    kw = dict(causal=causal, window=window)
    o, lse = ops.flash_attention_fwd(q, k, v, **kw)
    ops.flash_attention_bwd_dq.launches = 0
    ops.flash_attention_bwd_dkv.launches = 0
    got = ops.flash_attention_bwd(q, k, v, o, lse, do, **kw)
    torch.cuda.synchronize()
    assert ops.flash_attention_bwd_dq.launches == 1
    assert ops.flash_attention_bwd_dkv.launches == 1
    want = ref.flash_attention_bwd_torch(q, k, v, o, lse, do, **kw)
    tol = F32_TOL if dtype == torch.float32 else BF16_TOL
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == dtype and bool(torch.isfinite(a).all()), name
        torch.testing.assert_close(a.float(), b.float(), **tol,
                                   msg=lambda m: f"{name}: {m}")


@pytest.mark.gpu
def test_function_grad_on_card(cuda_device):
    """The Function on the card against autograd of the reference (float32),
    through the three kernels."""
    q, k, v, g = (torch.from_numpy(a).to(cuda_device)
                  for a in _inputs(2, 2, 8, 2, 256, 64))
    ops.flash_attention_fwd.launches = 0
    got = _grads(lambda *t: ops.flash_attention(*t), q, k, v, g)
    torch.cuda.synchronize()
    assert ops.flash_attention_fwd.launches == 1
    want = _grads(lambda *t: ref.attention_ref(*t), q, k, v, g)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, **AUTOGRAD_TOL)
