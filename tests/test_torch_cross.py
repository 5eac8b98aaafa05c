"""The port's ``cross`` block kind, QKV bias and the three MLPs against the
JAX package's, at reduced musicgen-large, llama-3.2-vision-11b, qwen2.5-3b
and starcoder2-15b.

Cross attention (module level) and the whole conditioned models —
``forward``, ``prefill``, ``decode_step`` (one shared and per-row
positions), ``greedy_decode`` and the serve loop, all with a seeded
N(0, 1) ``cond`` — are held against JAX's ``reference`` impl: JAX's
Pallas flash kernel (and its interpret mode) leaves the output unwritten
below one block of keys, so with ``cond_len`` 8 it returns non-finite rows
(ROADMAP C18, shown here on JAX's side). The serve loop: with no request
``cond`` both loops decode against zeros and agree; JAX's loop ignores a
request's own ``cond``, the port's decodes against it (C19).

QKV bias at reduced qwen2.5-3b (SwiGLU, tied head) and starcoder2-15b
(GELU): JAX draws the biases as zeros, so nonzero ones are drawn here
before the parameters are carried across; forward, prefill and decode
equal JAX's, and qwen's ``Model.loss`` and every gradient equal
``jax.value_and_grad``'s. The three MLPs (SwiGLU, GeGLU, GELU; both GELUs
the tanh form of ``jax.nn.gelu``) equal JAX's ``mlp_forward``; the
registry, the new configs and ``reduced()`` equal JAX's (the field by
field comparison of every arch is ``test_torch_hybrid.py``'s).

Configuration: ``reduced(d_model=256, d_ff=256, vocab=128)``: 4 query heads
of 64 (2 kv heads where the config has GQA), cond_len 8, cond_dim 256,
float32. Tolerance: rtol/atol 2e-5 on outputs, logits and caches, the bar
of ``tests/test_torch_models.py``; loss and gradients 1e-5, the bar of
``tests/test_torch_train.py``; greedy tokens equal.
"""
import torch_threads  # noqa: F401  (caps torch's threads a worker)
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS as JAX_ARCH_IDS
from repro.configs import get_config as jax_get_config
from repro.models import Model as JaxModel
from repro.models import attention as jax_attention
from repro.models import mlp as jax_mlp
from repro.models.model import greedy_decode as jax_greedy_decode
from repro.runtime.serve_loop import Request as JaxRequest
from repro.runtime.serve_loop import ServeLoop as JaxServeLoop
from repro_torch.configs import ARCH_IDS, ATTENTION_IMPLS, REGISTRY, get_config
from repro_torch.kernels import ops
from repro_torch.launch.train import main as train_main
from repro_torch.models import Model, greedy_decode, params_from_jax
from repro_torch.models.attention import cross_attention
from repro_torch.models.common import tree_leaves
from repro_torch.models.mlp import mlp_forward
from repro_torch.runtime import Request, ServeLoop

TOL = dict(rtol=2e-5, atol=2e-5)
GRAD_TOL = dict(rtol=1e-5, atol=1e-5)
REDUCED = dict(d_model=256, d_ff=256, vocab=128)
CROSS = ["musicgen-large", "llama-3.2-vision-11b"]
BIAS = ["qwen2.5-3b", "starcoder2-15b"]
NEW = ["qwen2.5-3b", "starcoder2-15b", "phi3.5-moe-42b-a6.6b", "grok-1-314b",
       "musicgen-large", "llama-3.2-vision-11b"]


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _tokens(seed, shape, vocab=REDUCED["vocab"]):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(np.int32)


def _normal(seed, shape):
    return np.random.default_rng(seed).normal(0, 1, shape).astype(np.float32)


def _cfgs(arch):
    jcfg = jax_get_config(arch).reduced(**REDUCED)
    tcfg = get_config(arch).reduced(**REDUCED)
    if jcfg.n_kv_heads == 4 and jax_get_config(arch).n_kv_heads < jax_get_config(arch).n_heads:
        jcfg, tcfg = jcfg.replace(n_kv_heads=2), tcfg.replace(n_kv_heads=2)
    return jcfg, tcfg


def _with_biases(jparams, seed):
    """JAX's parameters with every bq/bk/bv drawn N(0, 0.5) from ``seed``."""
    rng = np.random.default_rng(seed)

    def walk(t):
        if isinstance(t, dict):
            return {k: (jnp.asarray(rng.normal(0, 0.5, v.shape), jnp.float32)
                        if k in ("bq", "bk", "bv") else walk(v))
                    for k, v in t.items()}
        if isinstance(t, list):
            return [walk(v) for v in t]
        return t
    return walk(jparams)


@functools.lru_cache(maxsize=None)
def _pair(arch):
    """(jax model, jax params, port cfg, port params); biases nonzero. One
    pair an arch for the module: no test changes it."""
    jcfg, tcfg = _cfgs(arch)
    jmodel = JaxModel(jcfg)
    jmodel.decode_step = jax.jit(jmodel.decode_step)    # one trace a shape
    jparams = jax.jit(jmodel.init)(jax.random.PRNGKey(0))
    if jcfg.qkv_bias:
        jparams = _with_biases(jparams, 1)
    return jmodel, jparams, tcfg, params_from_jax(_np(jparams), device="cpu")


@pytest.fixture(scope="module", params=CROSS + BIAS)
def pair(request):
    return _pair(request.param)


@pytest.fixture(scope="module", params=CROSS)
def cross_pair(request):
    return _pair(request.param)


def _cond(cfg, B, seed=3):
    return _normal(seed, (B, cfg.cond_len, cfg.cond_dim)) if cfg.cond_len else None


def _j(a):
    return None if a is None else jnp.asarray(a)


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

def test_registry_is_jax_s_without_gemma():
    """The registry is JAX's, gemma-2b included since the flash kernels
    take its head_dim of 256; an unknown arch raises."""
    assert ARCH_IDS == JAX_ARCH_IDS
    assert all(REGISTRY[a].name == a for a in ARCH_IDS)
    assert get_config("gemma-2b").resolved_head_dim == 256
    with pytest.raises(KeyError, match="unknown arch"):
        get_config("gemma-7b")


def _fields(cfg):
    """Every field but ``attention_impl`` ("kernel" | "reference" by design),
    with the properties the models read."""
    d = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)
         if f.name != "attention_impl"}
    d.update(plan=cfg.plan, head_dim=cfg.resolved_head_dim)
    return d


@pytest.mark.parametrize("arch", NEW)
@pytest.mark.parametrize("n_experts", [None, 2])
def test_new_configs_and_reduced_equal_jax(arch, n_experts):
    """The port's ModelConfig has JAX's fields, and the new configs and
    their ``reduced()`` (with its ``n_experts`` argument) equal JAX's."""
    t, j = get_config(arch), jax_get_config(arch)
    assert _fields(t) == _fields(j)
    assert _fields(t.reduced(d_model=128, n_experts=n_experts)) == \
        _fields(j.reduced(d_model=128, n_experts=n_experts))


def test_reduced_conditioning_and_expert_fields():
    m = get_config("musicgen-large")
    assert (m.cond_len, m.cond_dim, m.mlp_type, m.plan) == \
        (64, 1024, "gelu", (("cross", 48),))
    r = m.reduced(d_model=96)
    assert (r.cond_len, r.cond_dim) == (8, 96)
    v = get_config("llama-3.2-vision-11b").reduced()
    assert v.plan == (("dense", 1), ("cross", 1)) and v.cond_len == 8
    phi = get_config("phi3.5-moe-42b-a6.6b")
    assert (phi.n_experts, phi.top_k, phi.capacity_factor, phi.moe_routing) == \
        (16, 2, 1.25, "local")
    assert phi.reduced().n_experts == 4 and phi.reduced(n_experts=8).n_experts == 8
    assert get_config("grok-1-314b").optimizer == "adafactor"
    assert get_config("qwen2.5-3b").qkv_bias and get_config("llama3.2-1b").reduced().n_experts == 0


# ---------------------------------------------------------------------------
# modules
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mlp_type", ["swiglu", "geglu", "gelu"])
def test_mlp_forward_matches_jax(mlp_type):
    jcfg, tcfg = _cfgs("llama3.2-1b")
    jcfg, tcfg = jcfg.replace(mlp_type=mlp_type), tcfg.replace(mlp_type=mlp_type)
    jp = jax_mlp.init_mlp(jax.random.PRNGKey(5), jcfg)
    x = _normal(6, (2, 16, 256)) * 3          # reaches GELU's curved range
    got = mlp_forward(params_from_jax(_np(jp), device="cpu"), torch.from_numpy(x), tcfg)
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(jax_mlp.mlp_forward(jp, jnp.asarray(x), jcfg)),
                               **TOL)


@pytest.mark.parametrize("arch", CROSS)
@pytest.mark.parametrize("impl", ATTENTION_IMPLS)
@pytest.mark.parametrize("S", [1, 64])
def test_cross_attention_matches_jax_reference(arch, impl, S):
    """Prefill rows (S = 64) and a decode step's one row against 8 keys."""
    jcfg, tcfg = _cfgs(arch)
    jp = jax_attention.init_attention(jax.random.PRNGKey(7), jcfg, cross=True)
    tp = params_from_jax(_np(jp), device="cpu")
    assert tuple(tp["wk"].shape) == (tcfg.cond_dim, tcfg.n_kv_heads, 64)
    x, cond = _normal(8, (2, S, 256)), _cond(tcfg, 2)
    ops.flash_attention_fwd.launches = 0
    got = cross_attention(tp, torch.from_numpy(x), torch.from_numpy(cond),
                          tcfg.replace(attention_impl=impl))
    assert ops.flash_attention_fwd.launches == 0           # CPU: plain version
    want = jax_attention.cross_attention(jp, jnp.asarray(x), jnp.asarray(cond), jcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_jax_interpret_cross_attention_is_not_finite():
    """C18: JAX's Pallas flash kernel in interpret mode floors the key
    blocks, so 8 keys (< one block of 128) are never attended and the rows
    are not finite; its ``reference`` impl and the port's kernel dispatch
    give finite rows that agree."""
    jcfg, tcfg = _cfgs("musicgen-large")
    jp = jax_attention.init_attention(jax.random.PRNGKey(7), jcfg, cross=True)
    x, cond = _normal(9, (1, 128, 256)), _cond(tcfg, 1)
    bad = jax_attention.cross_attention(jp, jnp.asarray(x), jnp.asarray(cond),
                                        jcfg.replace(attention_impl="interpret"))
    assert not np.isfinite(np.asarray(bad)).all()
    want = np.asarray(jax_attention.cross_attention(jp, jnp.asarray(x),
                                                    jnp.asarray(cond), jcfg))
    got = cross_attention(params_from_jax(_np(jp), device="cpu"),
                          torch.from_numpy(x), torch.from_numpy(cond), tcfg)
    assert np.isfinite(want).all()
    np.testing.assert_allclose(got.numpy(), want, **TOL)


# ---------------------------------------------------------------------------
# whole models: conditioned (cross) and biased (dense with qkv_bias)
# ---------------------------------------------------------------------------

def test_biases_are_carried_nonzero(pair):
    _, jparams, tcfg, tparams = pair
    leaves = tparams["segments"][0]["attn"]
    if not tcfg.qkv_bias:
        assert "bq" not in leaves
        assert "xattn" in tparams["segments"][-1]
        return
    L = tcfg.n_layers
    assert tuple(leaves["bq"].shape) == (L, tcfg.n_heads, 64)
    assert tuple(leaves["bk"].shape) == (L, tcfg.n_kv_heads, 64)
    assert float(leaves["bv"].abs().min()) > 0
    np.testing.assert_array_equal(
        leaves["bk"].numpy(), np.asarray(jparams["segments"][0]["attn"]["bk"]))
    own = Model(tcfg, device="cpu").init(seed=1)["segments"][0]["attn"]
    assert float(own["bq"].abs().max()) == 0.0            # JAX's zeros


@functools.lru_cache(maxsize=None)
def _jax_forward(arch):
    """JAX's forward logits on 2 × 64 seeded tokens (and cond)."""
    jmodel, jparams, tcfg, _ = _pair(arch)
    toks, cond = _tokens(64, (2, 64)), _cond(tcfg, 2)
    return np.asarray(jmodel.forward(jparams, jnp.asarray(toks), cond=_j(cond)))


@pytest.mark.parametrize("impl", ATTENTION_IMPLS)
def test_forward_and_prefill_match_jax_reference(pair, impl):
    """Also JAX's prefill, which is its forward's last position."""
    jmodel, jparams, tcfg, tparams = pair
    model = Model(tcfg.replace(attention_impl=impl), device="cpu")
    toks, cond = _tokens(64, (2, 64)), _cond(tcfg, 2)
    want = _jax_forward(tcfg.name)
    np.testing.assert_allclose(model.forward(tparams, toks, cond=cond).numpy(),
                               want, **TOL)
    np.testing.assert_allclose(model.prefill(tparams, toks, cond=cond).numpy(),
                               want[:, -1], **TOL)


@pytest.mark.parametrize("per_row", [True, False], ids=["per_row", "scalar"])
def test_decode_step_matches_jax(pair, per_row):
    jmodel, jparams, tcfg, tparams = pair
    model = Model(tcfg, device="cpu")
    B, S_c = 3, 12
    jcache = jmodel.init_cache(B, S_c, dtype=jnp.float32)
    tcache = model.init_cache(B, S_c, dtype=torch.float32)
    toks, cond = _tokens(7, (B, 8)), _cond(tcfg, B)
    for t in range(8):
        pos = np.array([t, t + 2, t + 4], np.int32) if per_row else t
        jl, jcache = jmodel.decode_step(jparams, jcache, jnp.asarray(toks[:, t]),
                                        jnp.asarray(pos) if per_row else jnp.int32(t),
                                        cond=_j(cond))
        tl, tcache = model.decode_step(tparams, tcache, toks[:, t],
                                       torch.from_numpy(pos) if per_row else t,
                                       cond=cond)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    for ts, js in zip(tcache, jcache):
        for name in ("k", "v"):
            np.testing.assert_allclose(ts["kv"][name].numpy(),
                                       np.asarray(js["kv"][name]), **TOL)


def test_decode_matches_prefill_last_position(pair):
    _, _, tcfg, tparams = pair
    model = Model(tcfg, device="cpu")
    toks, cond = _tokens(9, (2, 20)), _cond(tcfg, 2)
    cache = model.init_cache(2, 24, dtype=torch.float32)
    for t in range(20):
        logits, cache = model.decode_step(tparams, cache, toks[:, t], t, cond=cond)
    torch.testing.assert_close(logits, model.prefill(tparams, toks, cond=cond), **TOL)


def test_greedy_decode_matches_jax(cross_pair):
    jmodel, jparams, tcfg, tparams = cross_pair
    prompt, cond = _tokens(5, (2, 7)), _cond(tcfg, 2)
    want = np.asarray(jax_greedy_decode(jmodel, jparams, jnp.asarray(prompt), 6,
                                        cond=_j(cond)))
    got = greedy_decode(Model(tcfg, device="cpu"), tparams, prompt, 6, cond=cond)
    np.testing.assert_array_equal(got.numpy(), want)


def _loops(jmodel, jparams, tcfg, tparams, prompts, conds=None, n_new=4):
    """The same requests through JAX's and the port's 2-slot loops."""
    jloop = JaxServeLoop(jmodel, jparams, n_slots=2, max_seq=32)
    tloop = ServeLoop(Model(tcfg, device="cpu"), tparams, n_slots=2, max_seq=32)
    conds = conds or [None] * len(prompts)
    jreqs = [JaxRequest(i, p, max_new=n_new, cond=c)
             for i, (p, c) in enumerate(zip(prompts, conds))]
    treqs = [Request(i, p, max_new=n_new, cond=c)
             for i, (p, c) in enumerate(zip(prompts, conds))]
    for jr, tr in zip(jreqs, treqs):
        jloop.submit(jr)
        tloop.submit(tr)
    jloop.run()
    tloop.run()
    return jreqs, treqs, jloop, tloop


def test_serve_loop_matches_jax(cross_pair):
    """5 requests through 2 slots, no request cond: both loops decode
    against a zero cond."""
    jmodel, jparams, tcfg, tparams = cross_pair
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, tcfg.vocab_size, L).astype(np.int32)
               for L in (6, 2, 9, 4, 5)]
    jreqs, treqs, jloop, tloop = _loops(jmodel, jparams, tcfg, tparams, prompts)
    assert [r.output for r in treqs] == [r.output for r in jreqs]
    assert all(r.done for r in treqs) and tloop.steps == jloop.steps


def test_serve_loop_decodes_against_the_request_cond(cross_pair):
    """C19. JAX's loop feeds zeros whatever ``Request.cond`` holds, so its
    outputs with and without request conds are equal; the port's loop
    decodes each request against its own cond (zeros where it has none):
    every output equals ``greedy_decode`` of that request alone with that
    cond, and the conds change some output."""
    jmodel, jparams, tcfg, tparams = cross_pair
    rng = np.random.default_rng(12)
    prompts = [rng.integers(0, tcfg.vocab_size, L).astype(np.int32)
               for L in (5, 3, 7, 4)]
    conds = [_normal(20 + i, (tcfg.cond_len, tcfg.cond_dim)) * 3 for i in range(3)]
    conds.append(None)
    j_plain, t_plain, _, _ = _loops(jmodel, jparams, tcfg, tparams, prompts, n_new=6)
    j_cond, t_cond, _, _ = _loops(jmodel, jparams, tcfg, tparams, prompts, conds, n_new=6)
    assert [r.output for r in j_cond] == [r.output for r in j_plain]
    assert [r.output for r in t_plain] == [r.output for r in j_plain]
    model = Model(tcfg, device="cpu")
    for r, p, c in zip(t_cond, prompts, conds):
        c = np.zeros((tcfg.cond_len, tcfg.cond_dim), np.float32) if c is None else c
        want = greedy_decode(model, tparams, p[None], 6, cond=c[None])[0, len(p):]
        assert r.output == want.tolist(), r.rid
    assert [r.output for r in t_cond] != [r.output for r in t_plain]


def test_cross_needs_cond():
    _, tcfg = _cfgs("musicgen-large")
    model = Model(tcfg, device="cpu")
    with pytest.raises(ValueError, match="pass cond"):
        model.prefill(model.init(seed=0), _tokens(1, (1, 4)))


# ---------------------------------------------------------------------------
# training: the biased dense kind and the cross kind
# ---------------------------------------------------------------------------

def test_qkv_bias_loss_and_gradients_match_jax():
    jmodel, jparams, tcfg, _ = _pair("qwen2.5-3b")
    tparams = params_from_jax(_np(jparams), device="cpu")     # a copy to mark
    toks = _tokens(13, (2, 65))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    jl, jg = jax.value_and_grad(jmodel.loss)(jparams, {k: jnp.asarray(v)
                                                       for k, v in batch.items()})
    leaves = tree_leaves(tparams)
    for p in leaves:
        p.requires_grad_(True)
    loss = Model(tcfg, device="cpu").loss(
        tparams, {k: torch.from_numpy(v) for k, v in batch.items()})
    grads = torch.autograd.grad(loss, leaves)
    torch.testing.assert_close(loss.detach(), torch.tensor(float(jl)), **GRAD_TOL)
    want = jax.tree.leaves(jg)
    assert len(grads) == len(want)
    for i, (g, w) in enumerate(zip(grads, want)):
        torch.testing.assert_close(g, torch.tensor(np.asarray(w)), **GRAD_TOL,
                                   msg=lambda m: f"leaf {i}: {m}")
    bq = tparams["segments"][0]["attn"]["bq"]
    assert float(next(g for g, p in zip(grads, leaves) if p is bq).abs().max()) > 0


@pytest.mark.parametrize("arch", CROSS)
def test_training_a_cross_plan_raises(arch):
    """A ``cross`` plan trains on a batch with a cond: the loss is finite
    and the gradient reaches the cross attention's k/v projections of cond
    (parity with JAX: ``tests/test_torch_xtrain.py``). The train CLI, which
    has no conditioning frontend to make a cond (nor has JAX's, C21),
    raises."""
    _, tcfg = _cfgs(arch)
    model = Model(tcfg, device="cpu")
    params = model.init(seed=0)
    batch = {"tokens": _tokens(1, (1, 8)), "labels": _tokens(2, (1, 8)),
             "cond": _cond(tcfg, 1)}
    leaves = [seg["xattn"][k] for seg in params["segments"] if "xattn" in seg
              for k in ("wk", "wv")]
    for p in leaves:
        p.requires_grad_(True)
    loss = model.loss(params, batch)
    grads = torch.autograd.grad(loss, leaves)
    assert bool(torch.isfinite(loss)) and all(float(g.abs().max()) > 0
                                              for g in grads)
    with pytest.raises(ValueError, match="conditioning frontend"):
        train_main(["--arch", arch, "--reduced", "--device", "cpu", "--steps", "1"])


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
def test_cross_bf16_prefill_on_card(cuda_device):
    """Reduced musicgen-large on the card: the bf16 prefill through B4 (a
    self and a cross launch a layer, the cross one non-causal over 8 keys)
    against the float32 reference, within 0.08σ mean and 0.5σ max of the
    reference's logits (chip_smoke phase 21's bars)."""
    _, jparams, tcfg, _ = _pair("musicgen-large")
    params = params_from_jax(_np(jparams), device=cuda_device)
    toks, cond = _tokens(11, (2, 128)), torch.from_numpy(_cond(tcfg, 2))
    ops.flash_attention_fwd.launches = 0
    got = Model(tcfg.replace(dtype="bfloat16"), device=cuda_device).prefill(
        params, toks, cond=cond)
    torch.cuda.synchronize()
    assert ops.flash_attention_fwd.launches == 2 * tcfg.n_layers
    want = Model(tcfg.replace(attention_impl="reference"),
                 device=cuda_device).prefill(params, toks, cond=cond)
    d, sigma = (got - want).abs(), float(want.std())
    assert float(d.mean()) <= 0.08 * sigma and float(d.max()) <= 0.5 * sigma
