"""The port's Mamba-1 mixer against the JAX package's ``models/mamba.py``.

The JAX ``init_mamba`` parameters are carried across with
``params_from_jax``; both packages run the same seeded numpy inputs
through ``mamba_forward`` (S ∈ {16, 64, 128}: one chunk shorter than
``ssm_chunk``, one chunk, two chunks; with and without an initial state)
and ``mamba_decode_step`` step by step, caches compared after every step.

Configuration: reduced falcon-mamba-7b (``reduced(d_model=64)``: d_inner
128, state 8, dt_rank 4, conv kernel 4, chunk 64), float32.

Tolerance: rtol/atol 2e-5, the bar of ``tests/test_torch_models.py``.
Both sides run float32 throughout and differ only in summation order and
in where a multiply-add is fused.
"""
import torch_threads  # noqa: F401  (caps torch's threads a worker)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import mamba as jmamba
from repro_torch.configs import get_config
from repro_torch.models import mamba
from repro_torch.models import params_from_jax

TOL = dict(rtol=2e-5, atol=2e-5)
B = 2


@pytest.fixture(scope="module")
def pair():
    """(jax cfg, jax params, port cfg, port params)."""
    jcfg = jax_get_config("falcon-mamba-7b").reduced()
    tcfg = get_config("falcon-mamba-7b").reduced()
    jp = jmamba.init_mamba(jax.random.PRNGKey(0), jcfg)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, jp, tcfg, tp


def _x(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def test_init_matches_jax_layout_and_constants(pair):
    jcfg, jp, tcfg, _ = pair
    assert (tcfg.resolved_d_inner, tcfg.ssm_state, tcfg.resolved_dt_rank,
            tcfg.conv_kernel, tcfg.ssm_chunk) == (128, 8, 4, 4, 64)
    own = mamba.init_mamba(torch.Generator().manual_seed(3), tcfg)
    assert sorted(own) == sorted(jp)
    for k, a in jp.items():
        assert tuple(own[k].shape) == a.shape and own[k].dtype == torch.float32, k
    for k in ("conv_b", "dt_bias", "D"):               # the deterministic leaves
        np.testing.assert_array_equal(own[k].numpy(), np.asarray(jp[k]), err_msg=k)
    # log(1..n): XLA's and torch's log differ by an ulp (ROADMAP C4)
    np.testing.assert_allclose(own["A_log"].numpy(), np.asarray(jp["A_log"]),
                               rtol=1e-7, atol=0)


@pytest.mark.parametrize("with_h0", [False, True], ids=["h0_zero", "h0_given"])
@pytest.mark.parametrize("S", [16, 64, 128])
def test_mamba_forward_matches_jax(pair, S, with_h0):
    jcfg, jp, tcfg, tp = pair
    x = _x(S, (B, S, tcfg.d_model))
    h0 = (_x(S + 1, (B, tcfg.resolved_d_inner, tcfg.ssm_state)) * 0.1
          if with_h0 else None)
    want = jmamba.mamba_forward(jp, jnp.asarray(x), jcfg,
                                h0=None if h0 is None else jnp.asarray(h0))
    got = mamba.mamba_forward(tp, torch.from_numpy(x), tcfg,
                              h0=None if h0 is None else torch.from_numpy(h0))
    assert got.shape == (B, S, tcfg.d_model) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_mamba_forward_refuses_a_ragged_chunk(pair):
    """JAX asserts S % chunk == 0; the port raises."""
    _, _, tcfg, tp = pair
    with pytest.raises(ValueError, match="multiple of the scan chunk"):
        mamba.mamba_forward(tp, torch.zeros((1, 96, tcfg.d_model)), tcfg)


def test_mamba_decode_step_matches_jax(pair):
    jcfg, jp, tcfg, tp = pair
    T = 10
    x = _x(5, (B, T, tcfg.d_model))
    jc = jax.tree.map(lambda a: a[0], jmamba.init_ssm_cache(jcfg, 1, B))
    tc_all = mamba.init_ssm_cache(tcfg, 1, B, device="cpu")
    tc = {k: v[0] for k, v in tc_all.items()}
    assert tc["h"].dtype == torch.float32 and tc["conv"].shape == (B, 3, 128)
    for t in range(T):
        jo, jc = jmamba.mamba_decode_step(jp, jnp.asarray(x[:, t: t + 1]), jc, jcfg)
        to, tc2 = mamba.mamba_decode_step(tp, torch.from_numpy(x[:, t: t + 1]),
                                          tc, tcfg)
        assert tc2 is tc                               # written in place
        np.testing.assert_allclose(to.numpy(), np.asarray(jo), **TOL)
        for k in ("h", "conv"):
            np.testing.assert_allclose(tc[k].numpy(), np.asarray(jc[k]), **TOL,
                                       err_msg=f"step {t} {k}")
    # the layer's slice is a view: the stacked cache holds the new state
    np.testing.assert_array_equal(tc_all["h"][0].numpy(), tc["h"].numpy())


def test_decode_steps_equal_forward(pair):
    """Stepping a sequence through the decode path gives the forward's
    output at every position (the port alone; both sides float32)."""
    _, _, tcfg, tp = pair
    S = 64
    x = torch.from_numpy(_x(9, (B, S, tcfg.d_model)))
    full = mamba.mamba_forward(tp, x, tcfg)
    c = {k: v[0] for k, v in mamba.init_ssm_cache(tcfg, 1, B).items()}
    outs = [mamba.mamba_decode_step(tp, x[:, t: t + 1], c, tcfg)[0]
            for t in range(S)]
    torch.testing.assert_close(torch.cat(outs, dim=1), full, **TOL)


def test_cache_takes_the_cache_dtype_for_conv_only(pair):
    _, _, tcfg, _ = pair
    c = mamba.init_ssm_cache(tcfg, 3, B, dtype=torch.bfloat16)
    assert c["h"].dtype == torch.float32 and c["conv"].dtype == torch.bfloat16
    assert tuple(c["h"].shape) == (3, B, 128, 8)
    assert tuple(c["conv"].shape) == (3, B, 3, 128)
