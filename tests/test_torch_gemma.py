"""gemma-2b and head_dim 256 in the port, against the JAX package.

The registry equals JAX's, arch by arch and in order, and gemma-2b's
fields equal JAX's at full size and reduced. The flash kernels' plain
versions at head_dim 256 (MQA, Sq = Sk ∈ {128, 256}, causal and not) equal
JAX's Pallas kernels in interpret mode, forward (o, lse) and backward
(dq, dk, dv). A reduced gemma-2b with head_dim 256 (GeGLU, one kv head,
the tied head) equals the JAX ``Model`` with carried-across parameters in
``forward``, ``prefill`` (both impls), ``decode_step`` (one shared and
per-row positions), ``greedy_decode`` and the serve loop, and in
``Model.loss`` and every gradient. On a card, the D = 256 kernels (the
bf16 forward with q's fragments read from shared memory each k-step, the
bf16 dq kernel likewise, the bf16 dk/dv kernel split over two column
halves, and the float32 kernels with their 32-row backward tiles) are held
against their plain versions; those tests skip here.

Configuration: ``reduced(d_model=256, d_ff=256, vocab=128)`` with
``head_dim=256``: 4 query heads of 256 and 1 kv head (group 4), float32.
Tolerance: flash forward and backward rtol/atol 1e-5 (the same float32
arithmetic summed in another order; at D = 256 each score sums 256
products); logits, caches, loss and gradients 2e-5, the bar of
``tests/test_torch_models.py``; greedy tokens equal. On the card, phases 7
and 10 of ``chip_smoke.py``'s bars: float32 2e-5 (forward) and 1e-4
(backward), bf16 2e-2.

The JAX package is imported inside the tests that compare with it (the
``jx`` fixture), so the card-only tests also run where JAX is not
installed.
"""
import torch_threads  # noqa: F401  (caps torch's threads a worker)
import dataclasses
import types

import numpy as np
import pytest
import torch

from repro_torch.configs import ARCH_IDS, ATTENTION_IMPLS, REGISTRY, get_config
from repro_torch.kernels import ops, ref
from repro_torch.models import Model, greedy_decode, params_from_jax
from repro_torch.models.common import tree_leaves
from repro_torch.runtime import Request, ServeLoop

FLASH_TOL = dict(rtol=1e-5, atol=1e-5)
TOL = dict(rtol=2e-5, atol=2e-5)
REDUCED = dict(d_model=256, d_ff=256, vocab=128)
GEMMA = "gemma-2b"


@pytest.fixture(scope="module")
def jx():
    """The JAX package's modules this file compares with."""
    jax = pytest.importorskip("jax")
    from repro import configs
    from repro.kernels.flash_attention import (
        flash_attention_bwd,
        flash_attention_fwd,
    )
    from repro.models import Model as JaxModel
    from repro.models.model import greedy_decode as jax_greedy_decode
    from repro.runtime import serve_loop
    return types.SimpleNamespace(
        jax=jax, jnp=jax.numpy, configs=configs, fwd=flash_attention_fwd,
        bwd=flash_attention_bwd, Model=JaxModel, greedy_decode=jax_greedy_decode, serve_loop=serve_loop)


@pytest.fixture(scope="module")
def pair(jx):
    """(jax model, jax params, port cfg, port params) of the reduced gemma
    with head_dim 256."""
    jcfg = jx.configs.get_config(GEMMA).reduced(**REDUCED).replace(head_dim=256)
    tcfg = get_config(GEMMA).reduced(**REDUCED).replace(head_dim=256)
    jmodel = jx.Model(jcfg)
    jmodel.decode_step = jx.jax.jit(jmodel.decode_step)     # one trace a shape
    jparams = jx.jax.jit(jmodel.init)(jx.jax.random.PRNGKey(0))
    tparams = params_from_jax(jx.jax.tree.map(np.asarray, jparams), device="cpu")
    return jmodel, jparams, tcfg, tparams


def _tokens(seed, shape, vocab=REDUCED["vocab"]):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(np.int32)


def _normal(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.normal(0, 1, s).astype(np.float32) for s in shapes]


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

def test_registry_equals_jax_s(jx):
    assert ARCH_IDS == jx.configs.ARCH_IDS
    assert all(REGISTRY[a].name == a for a in ARCH_IDS)


@pytest.mark.parametrize("size", ["full", "reduced"])
def test_gemma_fields_equal_jax(jx, size):
    t, j = get_config(GEMMA), jx.configs.get_config(GEMMA)
    if size == "reduced":
        t, j = t.reduced(**REDUCED), j.reduced(**REDUCED)
    for f in dataclasses.fields(j):
        if f.name != "attention_impl":      # "kernel" | "reference" by design
            assert getattr(t, f.name) == getattr(j, f.name), f.name
    assert (t.plan, t.resolved_head_dim) == (j.plan, j.resolved_head_dim)
    if size == "full":
        assert (t.n_heads, t.n_kv_heads, t.resolved_head_dim, t.mlp_type,
                t.tie_embeddings) == (8, 1, 256, "geglu", True)


# ---------------------------------------------------------------------------
# the plain flash versions at head_dim 256 against JAX's interpret kernels
# ---------------------------------------------------------------------------

# (B, Hq, Hkv, S, causal): MQA at head_dim 256
FLASH_CASES = [(1, 4, 1, 128, True), (1, 2, 1, 256, True), (1, 2, 1, 128, False)]


@pytest.mark.parametrize("case", FLASH_CASES,
                         ids=lambda c: "-".join(str(x) for x in c))
def test_plain_flash_d256_matches_jax_interpret(jx, case):
    B, Hq, Hkv, S, causal = case
    D = 256
    q, k, v, do = _normal(S + Hq, (B, Hq, S, D), (B, Hkv, S, D), (B, Hkv, S, D),
                          (B, Hq, S, D))
    jnp = jx.jnp
    o, lse = jx.fwd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                    causal=causal, interpret=True)
    tq, tk, tv, tdo = (torch.from_numpy(a) for a in (q, k, v, do))
    to, tlse = ops.flash_attention_fwd(tq, tk, tv, causal=causal)
    torch.testing.assert_close(to, torch.from_numpy(np.array(o)), **FLASH_TOL)
    torch.testing.assert_close(tlse, torch.from_numpy(np.array(lse)), **FLASH_TOL)
    want = jx.bwd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), o, lse,
                  jnp.asarray(do), causal=causal, interpret=True)
    got = ops.flash_attention_bwd(tq, tk, tv, torch.from_numpy(np.array(o)),
                                  torch.from_numpy(np.array(lse)), tdo,
                                  causal=causal)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        torch.testing.assert_close(g, torch.from_numpy(np.array(w)), **FLASH_TOL,
                                   msg=lambda m: f"{name}: {m}")


def test_head_dims_the_wrapper_takes():
    q = torch.zeros((1, 2, 8, 256))
    o, lse = ops.flash_attention_fwd(q, q[:, :1].contiguous(), q[:, :1].contiguous())
    assert o.shape == q.shape and lse.shape == (1, 2, 8)
    for D in (32, 96, 512):
        x = torch.zeros((1, 2, 8, D))
        with pytest.raises(ValueError, match=r"head_dim must be one of \(64, 128, 256\)"):
            ops.flash_attention_fwd(x, x, x)


# ---------------------------------------------------------------------------
# the reduced gemma with head_dim 256 against the JAX Model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("impl", ATTENTION_IMPLS)
def test_forward_and_prefill_match_jax(jx, pair, impl):
    jmodel, jparams, tcfg, tparams = pair
    assert tcfg.resolved_head_dim == 256 and tcfg.n_kv_heads == 1
    model = Model(tcfg.replace(attention_impl=impl), device="cpu")
    toks = _tokens(3, (2, 40))
    jt = jx.jnp.asarray(toks)
    np.testing.assert_allclose(model.forward(tparams, toks).numpy(),
                               np.asarray(jmodel.forward(jparams, jt)), **TOL)
    np.testing.assert_allclose(model.prefill(tparams, toks).numpy(),
                               np.asarray(jmodel.prefill(jparams, jt)), **TOL)


@pytest.mark.parametrize("per_row", [True, False], ids=["per_row", "scalar"])
def test_decode_step_matches_jax(jx, pair, per_row):
    jmodel, jparams, tcfg, tparams = pair
    jnp = jx.jnp
    model = Model(tcfg, device="cpu")
    B, S_c = 3, 12
    jcache = jmodel.init_cache(B, S_c, dtype=jnp.float32)
    tcache = model.init_cache(B, S_c, dtype=torch.float32)
    toks = _tokens(7, (B, 8))
    for t in range(8):
        pos = np.array([t, t + 2, t + 4], np.int32) if per_row else t
        jl, jcache = jmodel.decode_step(jparams, jcache, jnp.asarray(toks[:, t]),
                                        jnp.asarray(pos) if per_row else jnp.int32(t))
        tl, tcache = model.decode_step(tparams, tcache, toks[:, t],
                                       torch.from_numpy(pos) if per_row else t)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    for name in ("k", "v"):
        np.testing.assert_allclose(tcache[0]["kv"][name].numpy(),
                                   np.asarray(jcache[0]["kv"][name]), **TOL)


def test_greedy_decode_and_serve_loop_match_jax(jx, pair):
    jmodel, jparams, tcfg, tparams = pair
    model = Model(tcfg, device="cpu")
    prompt = _tokens(5, (2, 7))
    want = np.asarray(jx.greedy_decode(jmodel, jparams, jx.jnp.asarray(prompt), 6))
    np.testing.assert_array_equal(greedy_decode(model, tparams, prompt, 6).numpy(),
                                  want)
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, tcfg.vocab_size, L).astype(np.int32)
               for L in (6, 2, 9, 4, 5)]
    jloop = jx.serve_loop.ServeLoop(jmodel, jparams, n_slots=2, max_seq=32)
    tloop = ServeLoop(model, tparams, n_slots=2, max_seq=32)
    jreqs = [jx.serve_loop.Request(i, p, max_new=5) for i, p in enumerate(prompts)]
    treqs = [Request(i, p, max_new=5) for i, p in enumerate(prompts)]
    for jr, tr in zip(jreqs, treqs):
        jloop.submit(jr)
        tloop.submit(tr)
    jloop.run()
    tloop.run()
    assert [r.output for r in treqs] == [r.output for r in jreqs]
    assert all(r.done for r in treqs) and tloop.steps == jloop.steps


@pytest.mark.parametrize("impl", ATTENTION_IMPLS)
def test_loss_and_gradients_match_jax(jx, pair, impl):
    jmodel, jparams, tcfg, _ = pair
    jax, jnp = jx.jax, jx.jnp
    toks = _tokens(13, (2, 65))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    jl, jg = jax.value_and_grad(jmodel.loss)(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    leaves = tree_leaves(tparams)
    for p in leaves:
        p.requires_grad_(True)
    loss = Model(tcfg.replace(attention_impl=impl), device="cpu").loss(
        tparams, {k: torch.from_numpy(v) for k, v in batch.items()})
    grads = torch.autograd.grad(loss, leaves)
    torch.testing.assert_close(loss.detach(), torch.tensor(float(jl)), **TOL)
    want = jax.tree.leaves(jg)
    assert len(grads) == len(want)
    for i, (g, w) in enumerate(zip(grads, want)):
        torch.testing.assert_close(g, torch.from_numpy(np.asarray(w)), **TOL,
                                   msg=lambda m: f"leaf {i}: {m}")


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    """The card, or a skip where there is none (decided here, at run time)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    return torch.device("cuda")


# (B, Hq, Hkv, Sq, Sk, causal, window) at head_dim 256
CARD_CASES = [(2, 8, 1, 2048, 2048, True, None), (1, 8, 1, 300, 428, True, None),
              (1, 4, 2, 100, 37, False, None), (1, 4, 2, 128, 64, True, 16)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
@pytest.mark.parametrize("case", CARD_CASES,
                         ids=lambda c: "-".join(str(x) for x in c))
def test_d256_kernels_match_plain_on_card(cuda_device, case, dtype):
    B, Hq, Hkv, Sq, Sk, causal, window = case
    gen = torch.Generator(device=cuda_device).manual_seed(Sq + Hq)
    q, k, v, do = (torch.randn(s, generator=gen, device=cuda_device).to(dtype)
                   for s in ((B, Hq, Sq, 256), (B, Hkv, Sk, 256),
                             (B, Hkv, Sk, 256), (B, Hq, Sq, 256)))
    kw = dict(causal=causal, window=window)
    launches = (ops.flash_attention_fwd.launches,
                ops.flash_attention_bwd_dq.launches,
                ops.flash_attention_bwd_dkv.launches)
    o, lse = ops.flash_attention_fwd(q, k, v, **kw)
    got = ops.flash_attention_bwd(q, k, v, o, lse, do, **kw)
    torch.cuda.synchronize()
    assert (ops.flash_attention_fwd.launches, ops.flash_attention_bwd_dq.launches,
            ops.flash_attention_bwd_dkv.launches) == tuple(n + 1 for n in launches)
    o_p, lse_p = ref.flash_attention_fwd_torch(q, k, v, **kw)
    f32 = dtype == torch.float32
    torch.testing.assert_close(o.float(), o_p.float(),
                               **(dict(rtol=2e-5, atol=2e-5) if f32
                                  else dict(rtol=2e-2, atol=2e-2)))
    torch.testing.assert_close(lse, lse_p, rtol=2e-5, atol=2e-5)
    delta = (do.float() * o.float()).sum(-1)
    want = (ref.flash_attention_bwd_dq_torch(q, k, v, do, lse, delta, **kw),
            *ref.flash_attention_bwd_dkv_torch(q, k, v, do, lse, delta, **kw))
    tol = dict(rtol=1e-4, atol=1e-4) if f32 else dict(rtol=2e-2, atol=2e-2)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == dtype and bool(torch.isfinite(g).all()), name
        torch.testing.assert_close(g.float(), w.float(), **tol,
                                   msg=lambda m: f"{name}: {m}")


@pytest.mark.gpu
def test_reduced_gemma_trains_on_card(cuda_device):
    """The reduced gemma with head_dim 256 in bf16 on the card: one loss
    gradient through B4, B5 and B6 (2 + 1 + 1 launches a layer under
    remat), finite and within cosine 0.99 of the float32 reference's."""
    cfg = get_config(GEMMA).reduced(**REDUCED).replace(head_dim=256)
    model = Model(cfg.replace(dtype="bfloat16"), device=cuda_device)
    params = model.init(seed=0)
    toks = _tokens(1, (2, 257))
    batch = {"tokens": torch.from_numpy(toks[:, :-1]),
             "labels": torch.from_numpy(toks[:, 1:])}
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    before = (ops.flash_attention_fwd.launches, ops.flash_attention_bwd_dq.launches,
              ops.flash_attention_bwd_dkv.launches)
    g_bf = torch.autograd.grad(model.loss(params, batch), leaves)
    after = (ops.flash_attention_fwd.launches, ops.flash_attention_bwd_dq.launches,
             ops.flash_attention_bwd_dkv.launches)
    n = cfg.n_layers
    assert tuple(a - b for a, b in zip(after, before)) == (2 * n, n, n)
    g_ref = torch.autograd.grad(Model(cfg.replace(attention_impl="reference"),
                                      device=cuda_device).loss(params, batch), leaves)
    dot = sum(float((a.float() * b).sum()) for a, b in zip(g_bf, g_ref))
    norm = (sum(float(a.float().square().sum()) for a in g_bf)
            * sum(float(b.square().sum()) for b in g_ref)) ** 0.5
    assert dot / norm >= 0.99
