"""The port's ``moe`` block kind against the JAX package's, at reduced
phi3.5-moe-42b-a6.6b and grok-1-314b.

Module level: ``models.moe.moe_forward`` against JAX's
``_moe_forward_local`` and ``_moe_forward_global`` on the same carried
parameters and seeded inputs, at capacity factors 1.25 and 0.5 (so tokens
are dropped, and the drop order — the earliest tokens kept — is tested),
and a zero router, where every probability ties and the experts chosen
must be ``lax.top_k``'s (the lower index first; ROADMAP C20). Whole model
at reduced phi3.5-moe: ``forward`` and ``prefill`` with the port's
``kernel`` impl (its plain version on the CPU) and ``reference`` impl
against JAX's ``reference``, ``decode_step`` with one shared and with
per-row positions, ``greedy_decode`` and the serve loop. A ``moe`` plan
trains (its gradients against JAX's are ``tests/test_torch_xtrain.py``'s).

Configuration: ``reduced(d_model=256, d_ff=256, vocab=128)``: 4 experts,
top-2, 4 query heads of 64 with 2 kv heads, float32.

Tolerance: rtol/atol 2e-5 on outputs, logits and caches, the bar of
``tests/test_torch_models.py``; greedy tokens and chosen experts equal.
"""
import torch_threads  # noqa: F401  (caps torch's threads a worker)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import Model as JaxModel
from repro.models import moe as jax_moe
from repro.models.model import greedy_decode as jax_greedy_decode
from repro.runtime.serve_loop import Request as JaxRequest
from repro.runtime.serve_loop import ServeLoop as JaxServeLoop
from repro_torch.configs import ATTENTION_IMPLS, get_config
from repro_torch.kernels import ops
from repro_torch.models import Model, greedy_decode, params_from_jax
from repro_torch.models.moe import moe_forward, route
from repro_torch.runtime import Request, ServeLoop, train

TOL = dict(rtol=2e-5, atol=2e-5)
REDUCED = dict(d_model=256, d_ff=256, vocab=128)
PHI, GROK = "phi3.5-moe-42b-a6.6b", "grok-1-314b"


def _cfgs(arch, **replace):
    jcfg = jax_get_config(arch).reduced(**REDUCED).replace(n_kv_heads=2, **replace)
    tcfg = get_config(arch).reduced(**REDUCED).replace(n_kv_heads=2, **replace)
    return jcfg, tcfg


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _tokens(seed, shape, vocab=REDUCED["vocab"]):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(np.int32)


def _x(seed, B=2, S=64, D=REDUCED["d_model"]):
    return np.random.default_rng(seed).normal(0, 1, (B, S, D)).astype(np.float32)


def _moe_params(jcfg, seed=0):
    jp = jax_moe.init_moe(jax.random.PRNGKey(seed), jcfg)
    return jp, params_from_jax(_np(jp), device="cpu")


def _dropped(tcfg, tp, x):
    """Tokens routed to an expert beyond its capacity (per row, or over all
    rows under global routing), by the port's own routing."""
    B, S, _ = x.shape
    rows = x if tcfg.moe_routing == "local" else x.reshape(1, B * S, -1)
    N = rows.shape[1]
    cap = min(int(np.ceil(tcfg.capacity_factor * tcfg.top_k * N / tcfg.n_experts)), N)
    _, idx = route(tp, torch.from_numpy(rows), tcfg.top_k)
    per = torch.stack([(idx == e).any(-1).sum(-1) for e in range(tcfg.n_experts)])
    return int((per - cap).clamp(min=0).sum())


# ---------------------------------------------------------------------------
# module level
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", [PHI, GROK])
@pytest.mark.parametrize("routing", ["local", "global"])
@pytest.mark.parametrize("cf", [1.25, 0.5])
def test_moe_forward_matches_jax(arch, routing, cf):
    jcfg, tcfg = _cfgs(arch, moe_routing=routing, capacity_factor=cf)
    jp, tp = _moe_params(jcfg)
    x = _x(1)
    jfn = jax_moe._moe_forward_global if routing == "global" else jax_moe._moe_forward_local
    want = np.asarray(jfn(jp, jnp.asarray(x), jcfg))
    got = moe_forward(tp, torch.from_numpy(x), tcfg)
    assert got.shape == x.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    dropped = _dropped(tcfg, tp, x)
    if cf == 0.5:
        assert dropped > 0                 # the drop order is exercised


def test_capacity_keeps_the_earliest_tokens():
    """A capacity of one slot a row: each expert keeps only the first token
    routed to it, so the later tokens' outputs lack that expert's term."""
    jcfg, tcfg = _cfgs(PHI, capacity_factor=0.01)
    jp, tp = _moe_params(jcfg)
    x = _x(2, B=1, S=16)
    got = moe_forward(tp, torch.from_numpy(x), tcfg)
    np.testing.assert_allclose(
        got.numpy(), np.asarray(jax_moe._moe_forward_local(jp, jnp.asarray(x), jcfg)),
        **TOL)
    _, idx = route(tp, torch.from_numpy(x), tcfg.top_k)
    first = {e: int(torch.nonzero((idx[0] == e).any(-1))[0]) for e in
             range(tcfg.n_experts) if bool((idx[0] == e).any())}
    kept = set(first.values())
    for t in range(16):
        assert bool(got[0, t].abs().sum() > 0) == (t in kept)


def test_zero_router_ties_pick_lax_top_k_experts():
    """C20: a zero router gives every token equal probabilities; JAX's
    ``lax.top_k`` picks experts 0 and 1, ``torch.topk`` on the CPU others;
    the port's ``route`` picks 0 and 1, and the layer equals JAX's."""
    jcfg, tcfg = _cfgs(PHI)
    jp, tp = _moe_params(jcfg)
    jp = dict(jp, router=jnp.zeros_like(jp["router"]))
    tp = dict(tp, router=torch.zeros_like(tp["router"]))
    x = _x(3)
    probs = jnp.full((4,), 0.25)
    assert np.asarray(jax.lax.top_k(probs, 2)[1]).tolist() == [0, 1]
    vals, idx = route(tp, torch.from_numpy(x), tcfg.top_k)
    assert bool((idx == torch.tensor([0, 1])).all())
    assert bool((vals == 0.5).all())
    for routing in ("local", "global"):
        fn = jax_moe._moe_forward_global if routing == "global" else jax_moe._moe_forward_local
        np.testing.assert_allclose(
            moe_forward(tp, torch.from_numpy(x), tcfg.replace(moe_routing=routing)).numpy(),
            np.asarray(fn(jp, jnp.asarray(x), jcfg)), **TOL)


def test_route_breaks_ties_as_lax_top_k():
    """Probabilities with many exact ties (logits on a grid of 0.5): the
    chosen experts equal ``lax.top_k``'s row by row."""
    rng = np.random.default_rng(4)
    logits = (rng.integers(0, 3, (512, 8)) * 0.5).astype(np.float32)
    probs = jax.nn.softmax(jnp.asarray(logits), axis=-1)
    want = np.asarray(jax.lax.top_k(probs, 2)[1])
    router = {"router": torch.eye(8)}
    _, got = route(router, torch.from_numpy(logits), 2)
    np.testing.assert_array_equal(got.numpy(), want)


# ---------------------------------------------------------------------------
# the whole model at reduced phi3.5-moe
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def pair():
    jcfg, tcfg = _cfgs(PHI)
    jmodel = JaxModel(jcfg)
    jmodel.decode_step = jax.jit(jmodel.decode_step)    # one trace a shape
    jparams = jax.jit(jmodel.init)(jax.random.PRNGKey(0))
    return jmodel, jparams, tcfg, params_from_jax(_np(jparams), device="cpu")


def test_params_from_jax_carries_the_experts(pair):
    _, jparams, tcfg, tparams = pair
    moe = tparams["segments"][0]["moe"]
    L, E, D, F = tcfg.n_layers, tcfg.n_experts, tcfg.d_model, tcfg.d_ff
    assert tuple(moe["wg"].shape) == (L, E, D, F)
    assert tuple(moe["wd"].shape) == (L, E, F, D)
    assert tuple(moe["router"].shape) == (L, D, E)
    np.testing.assert_array_equal(moe["wu"].numpy(),
                                  np.asarray(jparams["segments"][0]["moe"]["wu"]))
    own = Model(tcfg, device="cpu").init(seed=1)["segments"][0]["moe"]
    assert {k: tuple(v.shape) for k, v in own.items()} == \
        {k: tuple(v.shape) for k, v in moe.items()}


@pytest.mark.parametrize("impl", ATTENTION_IMPLS)
def test_forward_and_prefill_match_jax_reference(pair, impl):
    jmodel, jparams, tcfg, tparams = pair
    model = Model(tcfg.replace(attention_impl=impl), device="cpu")
    toks = _tokens(64, (2, 64))
    ops.flash_attention_fwd.launches = 0
    got = model.forward(tparams, toks)
    assert ops.flash_attention_fwd.launches == 0           # CPU: plain version
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(jmodel.forward(jparams, jnp.asarray(toks))),
                               **TOL)
    np.testing.assert_allclose(model.prefill(tparams, toks).numpy(),
                               np.asarray(jmodel.prefill(jparams, jnp.asarray(toks))),
                               **TOL)


@pytest.mark.parametrize("per_row", [True, False], ids=["per_row", "scalar"])
def test_decode_step_matches_jax(pair, per_row):
    jmodel, jparams, tcfg, tparams = pair
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
    np.testing.assert_array_equal(tcache[0]["kv"]["pos_ids"].numpy(),
                                  np.asarray(jcache[0]["kv"]["pos_ids"]))


def test_greedy_decode_matches_jax(pair):
    jmodel, jparams, tcfg, tparams = pair
    prompt = _tokens(5, (2, 7))
    want = np.asarray(jax_greedy_decode(jmodel, jparams, jnp.asarray(prompt), 6))
    got = greedy_decode(Model(tcfg, device="cpu"), tparams, prompt, 6)
    np.testing.assert_array_equal(got.numpy(), want)


def test_serve_loop_matches_jax(pair):
    """5 requests through 2 slots (3 in reused slots: the KV cache's
    ``pos_ids`` mask the earlier request's rows on both sides)."""
    jmodel, jparams, tcfg, tparams = pair
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, tcfg.vocab_size, L).astype(np.int32)
               for L in (6, 2, 9, 4, 5)]
    jloop = JaxServeLoop(jmodel, jparams, n_slots=2, max_seq=32)
    tloop = ServeLoop(Model(tcfg, device="cpu"), tparams, n_slots=2, max_seq=32)
    jreqs = [JaxRequest(i, p, max_new=4) for i, p in enumerate(prompts)]
    treqs = [Request(i, p, max_new=4) for i, p in enumerate(prompts)]
    for jr, tr in zip(jreqs, treqs):
        jloop.submit(jr)
        tloop.submit(tr)
    jloop.run()
    tloop.run()
    assert [r.output for r in treqs] == [r.output for r in jreqs]
    assert all(r.done for r in treqs) and tloop.steps == jloop.steps


@pytest.mark.parametrize("arch", [PHI, GROK])
def test_training_a_moe_plan_raises(arch):
    """A ``moe`` plan trains: its loss is finite and its gradient reaches
    every router and expert (their parity with JAX is
    ``tests/test_torch_xtrain.py``'s). grok-1's optimizer, ``adafactor``,
    no longer raises: ``runtime.train`` takes a step with it."""
    _, tcfg = _cfgs(arch)
    model = Model(tcfg, device="cpu")
    params = model.init(seed=0)
    batch = {"tokens": _tokens(1, (1, 8)), "labels": _tokens(2, (1, 8))}
    moe = [seg["moe"] for seg in params["segments"]]
    leaves = [p[k] for p in moe for k in ("router", "wg", "wu", "wd")]
    for p in leaves:
        p.requires_grad_(True)
    loss = model.loss(params, batch)
    grads = torch.autograd.grad(loss, leaves)
    assert bool(torch.isfinite(loss))
    assert all(bool(torch.isfinite(g).all()) and float(g.abs().max()) > 0
               for g in grads)
    if tcfg.optimizer == "adafactor":
        state, history = train(model, iter([batch]), steps=1, log_every=0)
        assert "f" in state["opt"] and np.isfinite(history[0]["loss"])


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
def test_moe_bf16_prefill_on_card(cuda_device, pair):
    """Reduced phi3.5-moe on the card: the bf16 prefill through B4 (one
    launch a layer) against the float32 reference, within 0.08σ mean and
    0.5σ max of the reference's logits (chip_smoke phase 21's bars); the
    card's stable sort picks ``lax.top_k``'s experts on a zero router."""
    _, jparams, tcfg, _ = pair
    params = params_from_jax(_np(jparams), device=cuda_device)
    toks = _tokens(11, (2, 128))
    ops.flash_attention_fwd.launches = 0
    got = Model(tcfg.replace(dtype="bfloat16"), device=cuda_device).prefill(params, toks)
    torch.cuda.synchronize()
    assert ops.flash_attention_fwd.launches == tcfg.n_layers
    want = Model(tcfg.replace(attention_impl="reference"),
                 device=cuda_device).prefill(params, toks)
    d, sigma = (got - want).abs(), float(want.std())
    assert float(d.mean()) <= 0.08 * sigma and float(d.max()) <= 0.5 * sigma
    zero = {"router": torch.zeros((8, 16), device=cuda_device)}
    _, idx = route(zero, torch.ones((4096, 8), device=cuda_device), 2)
    assert bool((idx == torch.tensor([0, 1], device=cuda_device)).all())
