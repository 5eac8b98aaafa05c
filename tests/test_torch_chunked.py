"""The port's chunked reference attention against the JAX package's.

``kernels.ref.attention_chunked`` (chunks of query rows, a grouped product
over the GQA group, k and v in their own dtype, a sliding window's keys
sliced per chunk) against JAX's ``kernels.ref.attention_chunked`` at
Sq = Sk = 8192, chunk 2048, B 1, Hq 4, Hkv 2, D 16: causal, non-causal,
causal with a window of 1000 (the slice's start clipped at 0 on the first
chunk), bf16 q/k/v, and ``unroll=True``. ``ops.flash_attention
(impl="reference")`` takes the chunked form from 8192 query rows on, as
JAX's ``flash_attention(impl="ref")`` does, and equals it there; below,
``attention_ref``. ``attention_chunked`` asserts Sq % chunk == 0 as JAX's
does; ``impl="chunked"`` takes a sequence shorter than one chunk as one
chunk, where JAX's assert refuses it. A reduced Llama's loss and
gradients with ``attention_impl="chunked"`` (4096 tokens, two chunks)
equal those with ``"reference"``.

Tolerances. Both sides compute the same float32 logits, masked softmax
and products; only the products' summation order differs, so float32
outputs are held to rtol/atol 2e-5 (the bar of the flash forward's
float32 parity). bf16 outputs are rounded once from float32 on both sides:
one bf16 ulp (rtol 2⁻⁷, atol 2⁻⁸ for entries near 0). The model's loss
and gradients, chunked against whole logits, to rtol/atol 1e-5, the bar
of ``tests/test_torch_train.py``.
"""
import torch_threads  # noqa: F401  (caps torch's threads a worker)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jax_ops
from repro.kernels import ref as jax_ref
from repro_torch.configs import get_config
from repro_torch.kernels import ops, ref
from repro_torch.models import Model
from repro_torch.models.common import tree_leaves

F32_TOL = dict(rtol=2e-5, atol=2e-5)
BF16_TOL = dict(rtol=2 ** -7, atol=2 ** -8)
MODEL_TOL = dict(rtol=1e-5, atol=1e-5)
B, HQ, HKV, S, D = 1, 4, 2, 8192, 16

# case: (causal, window, dtype, unroll)
CASES = {
    "causal": (True, None, np.float32, False),
    "non-causal": (False, None, np.float32, False),
    "window 1000": (True, 1000, np.float32, False),
    "bf16": (True, None, "bfloat16", False),
    "unroll": (True, None, np.float32, True),
}


def _qkv(seed, Sq=S, Sk=S):
    rng = np.random.default_rng(seed)
    return (rng.normal(0, 1, (B, HQ, Sq, D)).astype(np.float32),
            rng.normal(0, 1, (B, HKV, Sk, D)).astype(np.float32),
            rng.normal(0, 1, (B, HKV, Sk, D)).astype(np.float32))


def _check(got, want, tol):
    torch.testing.assert_close(
        got.float(), torch.from_numpy(np.array(jnp.asarray(want, jnp.float32))),
        **tol)


@pytest.mark.parametrize("case", list(CASES))
def test_attention_chunked_matches_jax(case):
    causal, window, dtype, unroll = CASES[case]
    q, k, v = _qkv(0)
    if dtype == "bfloat16":
        tq, tk, tv = (torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v))
        jq, jk, jv = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v))
    else:
        tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
        jq, jk, jv = (jnp.asarray(x) for x in (q, k, v))
    kw = dict(causal=causal, window=window, chunk=2048, unroll=unroll)
    got = ref.attention_chunked(tq, tk, tv, **kw)
    want = jax_ref.attention_chunked(jq, jk, jv, **kw)
    assert got.dtype == tq.dtype and got.shape == (B, HQ, S, D)
    _check(got, want, BF16_TOL if dtype == "bfloat16" else F32_TOL)


def test_reference_impl_switches_to_chunked_at_8192(monkeypatch):
    """``impl="reference"`` equals JAX's ``impl="ref"`` at Sq = 8192 (its
    chunked form; window 1000, whose chunks read 3048 keys), and calls
    ``attention_chunked`` there and ``attention_ref`` below (window 100 at
    2048)."""
    q, k, v = _qkv(1)
    got = ops.flash_attention(*(torch.from_numpy(x) for x in (q, k, v)),
                              window=1000, impl="reference")
    want = jax_ops.flash_attention(*(jnp.asarray(x) for x in (q, k, v)),
                                   window=1000, impl="ref")
    _check(got, want, F32_TOL)
    calls = []
    for name in ("attention_chunked", "attention_ref"):
        fn = getattr(ref, name)
        monkeypatch.setattr(ref, name, lambda *a, _f=fn, _n=name, **kw:
                            calls.append(_n) or _f(*a, **kw))
    small = [torch.from_numpy(x[:, :, :2048]) for x in (q, k, v)]
    ops.flash_attention(*small, window=100, impl="reference")
    ops.flash_attention(*(torch.from_numpy(x) for x in (q, k, v)),
                        window=100, impl="reference")
    assert calls == ["attention_ref", "attention_chunked"]


def test_sq_not_a_multiple_of_the_chunk_raises():
    q, k, v = (torch.from_numpy(x) for x in _qkv(2, Sq=3000, Sk=3000))
    with pytest.raises(AssertionError):
        ref.attention_chunked(q, k, v, chunk=2048)
    with pytest.raises(AssertionError):
        jax_ref.attention_chunked(*(jnp.asarray(x.numpy()) for x in (q, k, v)),
                                  chunk=2048)
    with pytest.raises(AssertionError):
        ops.flash_attention(q, k, v, impl="chunked")


@pytest.mark.parametrize("impl", ["chunked", "chunked_unroll"])
def test_short_sequences_are_one_chunk(impl):
    """Below 2048 rows ``impl="chunked"`` is one chunk and equals
    ``attention_ref`` (a window of 24 at 100 rows); JAX's assert refuses
    the same call."""
    q, k, v = _qkv(3, Sq=100, Sk=100)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    got = ops.flash_attention(tq, tk, tv, window=24, impl=impl)
    torch.testing.assert_close(
        got, ref.attention_ref(tq, tk, tv, window=24), **F32_TOL)
    with pytest.raises(AssertionError):
        jax_ops.flash_attention(*(jnp.asarray(x) for x in (q, k, v)),
                                window=24, impl=impl)


def test_model_loss_chunked_equals_reference():
    """A reduced Llama (1 layer, 4 heads of 64) on 1 × 4096 tokens: the
    loss and every gradient with ``attention_impl="chunked"`` (two chunks
    of 2048 query rows) equal those with ``"reference"`` (whole logits)."""
    cfg = get_config("llama3.2-1b").reduced(
        n_layers=1, d_model=256, d_ff=256, vocab=128).replace(remat=False)
    toks = np.random.default_rng(4).integers(0, 128, (1, 4097))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    params = Model(cfg, device="cpu").init(seed=0)
    out = []
    for impl in ("chunked", "reference"):
        leaves = tree_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        loss = Model(cfg.replace(attention_impl=impl), device="cpu").loss(
            params, batch)
        out.append((loss.detach(), torch.autograd.grad(loss, leaves)))
    torch.testing.assert_close(out[0][0], out[1][0], **MODEL_TOL)
    for a, b in zip(out[0][1], out[1][1]):
        torch.testing.assert_close(a, b, **MODEL_TOL)
