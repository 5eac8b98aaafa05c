"""The port's LM stack against the JAX package's, at a reduced Llama-3.2-1B.

The JAX ``Model.init`` parameters are carried across with
``params_from_jax`` and both packages run the same seeded numpy tokens:
``forward``, ``prefill``, ``decode_step`` (per-row and one shared position)
and ``greedy_decode``, then the serve loop's two properties of
``tests/test_serve_loop.py`` on the port and its outputs against the JAX
``ServeLoop``.

Configuration: ``reduced(d_model=256, d_ff=256, vocab=128)`` with 2 kv
heads for 4 query heads (GQA, group 2), head_dim 64 — the kernel's smallest
head_dim — all in float32.

Tolerance: logits and caches within rtol/atol 2e-5. Both sides run float32
throughout; they differ only in the order XLA and PyTorch sum the products
(observed ≤ 3e-6 on logits of magnitude ≈ 1). Greedy tokens must be equal.
"""
import torch_threads  # noqa: F401  (caps torch's threads a worker)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import Model as JaxModel
from repro.models.model import greedy_decode as jax_greedy_decode
from repro.runtime.serve_loop import Request as JaxRequest
from repro.runtime.serve_loop import ServeLoop as JaxServeLoop
from repro_torch.configs import ATTENTION_IMPLS, get_config
from repro_torch.kernels import ops
from repro_torch.models import Model, greedy_decode, params_from_jax
from repro_torch.runtime import Request, ServeLoop

TOL = dict(rtol=2e-5, atol=2e-5)
REDUCED = dict(d_model=256, d_ff=256, vocab=128)


@pytest.fixture(scope="module")
def pair():
    """(jax cfg, jax model, jax params, port cfg, port params)."""
    jcfg = jax_get_config("llama3.2-1b").reduced(**REDUCED).replace(n_kv_heads=2)
    tcfg = get_config("llama3.2-1b").reduced(**REDUCED).replace(n_kv_heads=2)
    jmodel = JaxModel(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    return jcfg, jmodel, jparams, tcfg, tparams


def _tokens(seed, shape, vocab=REDUCED["vocab"]):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(np.int32)


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (i,))
    else:
        yield path, tree


def test_reduced_configs_agree(pair):
    jcfg, _, _, tcfg, _ = pair
    for f in ("n_layers", "d_model", "n_heads", "n_kv_heads", "d_ff",
              "vocab_size", "resolved_head_dim", "plan", "rope_theta",
              "dtype", "param_dtype"):
        assert getattr(jcfg, f) == getattr(tcfg, f), f
    assert jcfg.mlp_type == "swiglu" and jcfg.tie_embeddings and not jcfg.qkv_bias
    assert tcfg.resolved_head_dim == 64 and tcfg.attention_impl == "kernel"


def test_params_from_jax_round_trip(pair):
    _, _, jparams, tcfg, tparams = pair
    jl = list(_leaves(jax.tree.map(np.asarray, jparams)))
    tl = list(_leaves(tparams))
    assert [p for p, _ in jl] == [p for p, _ in tl]
    for (path, a), (_, t) in zip(jl, tl):
        assert t.dtype == torch.float32 and t.device.type == "cpu", path
        np.testing.assert_array_equal(t.numpy(), a, err_msg=str(path))
    # the port's own init draws a tree of the same paths, shapes and dtypes
    own = list(_leaves(Model(tcfg, device="cpu").init(seed=3)))
    assert [(p, tuple(t.shape), t.dtype) for p, t in own] == \
        [(p, tuple(t.shape), t.dtype) for p, t in tl]


def test_params_from_jax_keeps_bfloat16():
    a = np.asarray(jnp.asarray([[1.5, -2.25], [0.1, 3.0]], jnp.bfloat16))
    t = params_from_jax({"w": a}, device="cpu")["w"]
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.float().numpy(), a.astype(np.float32))


@pytest.mark.parametrize("impl", ATTENTION_IMPLS)
@pytest.mark.parametrize("S", [1, 40])
def test_forward_and_prefill_match_jax_reference(pair, impl, S):
    jcfg, jmodel, jparams, tcfg, tparams = pair
    model = Model(tcfg.replace(attention_impl=impl), device="cpu")
    toks = _tokens(S, (2, S))
    got = model.forward(tparams, toks)
    assert got.shape == (2, S, tcfg.vocab_size) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(jmodel.forward(jparams, jnp.asarray(toks))),
                               **TOL)
    np.testing.assert_allclose(model.prefill(tparams, toks).numpy(),
                               np.asarray(jmodel.prefill(jparams, jnp.asarray(toks))),
                               **TOL)


def test_forward_matches_jax_interpret_kernel(pair):
    """S = 128, a multiple of the JAX kernel's 128 block: the Pallas kernel
    in interpret mode against the port's kernel dispatch."""
    jcfg, _, jparams, tcfg, tparams = pair
    jmodel = JaxModel(jcfg.replace(attention_impl="interpret"))
    toks = _tokens(128, (2, 128))
    ops.flash_attention_fwd.launches = 0
    got = Model(tcfg, device="cpu").forward(tparams, toks)
    assert ops.flash_attention_fwd.launches == 0           # CPU: plain version
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(jmodel.forward(jparams, jnp.asarray(toks))),
                               **TOL)


@pytest.mark.parametrize("per_row", [True, False], ids=["per_row", "scalar"])
def test_decode_step_matches_jax(pair, per_row):
    _, jmodel, jparams, tcfg, tparams = pair
    model = Model(tcfg, device="cpu")
    B, S_c = 3, 12
    jcache = jmodel.init_cache(B, S_c, dtype=jnp.float32)
    tcache = model.init_cache(B, S_c, dtype=torch.float32)
    toks = _tokens(7, (B, 8))
    for t in range(8):
        pos = np.array([t, t + 2, t + 5], np.int32) if per_row else t
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


def test_decode_matches_forward_last_position(pair):
    """Stepping a prompt through the cache gives the prefill's logits."""
    _, _, _, tcfg, tparams = pair
    model = Model(tcfg, device="cpu")
    toks = _tokens(9, (2, 10))
    cache = model.init_cache(2, 16, dtype=torch.float32)
    for t in range(10):
        logits, cache = model.decode_step(tparams, cache, toks[:, t], t)
    torch.testing.assert_close(logits, model.prefill(tparams, toks), **TOL)


def test_greedy_decode_matches_jax(pair):
    _, jmodel, jparams, tcfg, tparams = pair
    prompt = _tokens(5, (2, 7))
    want = np.asarray(jax_greedy_decode(jmodel, jparams, jnp.asarray(prompt), 9))
    got = greedy_decode(Model(tcfg, device="cpu"), tparams, prompt, 9)
    assert got.shape == (2, 16)
    np.testing.assert_array_equal(got.numpy(), want)


def _sequential_reference(model, params, prompt, n_new, max_seq):
    """Single-request greedy decode via the shared-position path."""
    cache = model.init_cache(1, max_seq, dtype=torch.float32)
    tok = [int(prompt[0])]
    out = []
    for t in range(len(prompt) + n_new - 1):
        logits, cache = model.decode_step(params, cache, tok, t)
        nxt = int(torch.argmax(logits[0]))
        if t + 1 < len(prompt):
            tok = [int(prompt[t + 1])]
        else:
            out.append(nxt)
            tok = [nxt]
    return out


def test_interleaved_requests_match_sequential(pair):
    _, _, _, tcfg, tparams = pair
    model = Model(tcfg, device="cpu")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, tcfg.vocab_size, L).astype(np.int32)
               for L in (5, 9, 3, 7, 4, 6)]           # > n_slots, mixed lengths
    n_new = 6
    refs = [_sequential_reference(model, tparams, p, n_new, 64) for p in prompts]

    loop = ServeLoop(model, tparams, n_slots=3, max_seq=64)
    reqs = [Request(rid=i, prompt=p, max_new=n_new)
            for i, p in enumerate(prompts)]
    for r in reqs:
        loop.submit(r)
    loop.run()

    for r, ref in zip(reqs, refs):
        assert r.done
        assert r.output == ref, (r.rid, r.output, ref)
    # continuous batching: 6 requests through 3 slots in one loop instance
    assert loop.steps < sum(len(p) + n_new for p in prompts)
    assert loop.tokens_stepped == sum(len(p) + n_new - 1 for p in prompts)


def test_slot_reuse_is_isolated(pair):
    """A slot reused by a later request must not see the earlier request's
    KV entries (absolute-position masking + overwrite discipline)."""
    _, _, _, tcfg, tparams = pair
    model = Model(tcfg, device="cpu")
    rng = np.random.default_rng(1)
    long_p = rng.integers(0, tcfg.vocab_size, 12).astype(np.int32)
    short_p = rng.integers(0, tcfg.vocab_size, 3).astype(np.int32)
    late_p = rng.integers(0, tcfg.vocab_size, 4).astype(np.int32)

    loop = ServeLoop(model, tparams, n_slots=2, max_seq=64)
    reqs = [Request(0, long_p, max_new=4), Request(1, short_p, max_new=2),
            Request(2, late_p, max_new=4)]            # reuses a slot mid-run
    for r in reqs:
        loop.submit(r)
    loop.run()

    assert reqs[2].output == _sequential_reference(model, tparams, late_p, 4, 64)


def test_serve_loop_matches_jax(pair):
    _, jmodel, jparams, tcfg, tparams = pair
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, tcfg.vocab_size, L).astype(np.int32)
               for L in (6, 2, 9, 4, 5)]
    jloop = JaxServeLoop(jmodel, jparams, n_slots=2, max_seq=32)
    tloop = ServeLoop(Model(tcfg, device="cpu"), tparams, n_slots=2, max_seq=32)
    jreqs = [JaxRequest(i, p, max_new=5) for i, p in enumerate(prompts)]
    treqs = [Request(i, p, max_new=5) for i, p in enumerate(prompts)]
    for jr, tr in zip(jreqs, treqs):
        jloop.submit(jr)
        tloop.submit(tr)
    jloop.run()
    tloop.run()
    assert [r.output for r in treqs] == [r.output for r in jreqs]
    assert all(r.done for r in treqs) and tloop.steps == jloop.steps


def test_unported_kinds_and_options_raise():
    """A kind the JAX package lacks raises, and so do an unknown
    ``attention_impl`` and an unknown arch; ``moe`` and ``cross`` now
    train (a finite loss), and gemma-2b is in the registry."""
    cfg = get_config("llama3.2-1b").reduced(**REDUCED)
    with pytest.raises(NotImplementedError, match="ROADMAP A.7"):
        Model(cfg.replace(layer_plan=(("mamba2", 2),)), device="cpu")
    batch = {"tokens": _tokens(1, (1, 8)), "labels": _tokens(2, (1, 8)),
             "cond": np.zeros((1, 8, 256), np.float32)}
    for kind in ("moe", "cross"):
        model = Model(cfg.replace(layer_plan=((kind, 2),), n_experts=4,
                                  cond_len=8, cond_dim=256), device="cpu")
        assert bool(torch.isfinite(model.loss(model.init(seed=0), batch)))
    with pytest.raises(ValueError, match="attention_impl"):
        Model(cfg.replace(attention_impl="pallas"), device="cpu")
    assert get_config("gemma-2b").resolved_head_dim == 256
    with pytest.raises(KeyError, match="unknown arch"):
        get_config("gemma-7b")


def test_model_defaults_to_the_card():
    """With no device the model runs on ``cuda``; without one it raises
    instead of falling back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Model(get_config("llama3.2-1b").reduced(**REDUCED))
