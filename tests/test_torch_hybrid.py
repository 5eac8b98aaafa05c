"""The port's ``ssm`` and ``hybrid_swa``/``hybrid_full`` models against the
JAX package's, at reduced falcon-mamba-7b and hymba-1.5b.

The JAX ``Model.init`` parameters (with the untied ``lm_head``) are carried
across with ``params_from_jax`` and both packages run the same seeded
numpy tokens: ``forward`` and ``prefill`` with the port's ``kernel`` impl
(its plain version on the CPU) and ``reference`` impl, ``decode_step``
with one shared and with per-row positions, ``greedy_decode``, a rotating
sliding-window cache, and the serve loop. The configs, ``reduced()`` and
``SHAPES`` / ``shape_applicable`` equal the JAX package's.

C17: the JAX serve loop reuses a slot without clearing its SSM state, so
a request in a reused slot starts from its predecessor's state. A test
shows the leak on the JAX side and its absence in the port's loop.

Configuration: ``reduced(d_model=256, d_ff=256, vocab=128)`` with 2 kv
heads for 4 query heads of 64 (the kernel's smallest head_dim), d_inner
512, state 8, hymba's window 32 (shorter than S = 64 and 128, so it
masks), all float32.

Tolerance: logits and caches within rtol/atol 2e-5, the bar of
``tests/test_torch_models.py``; greedy tokens equal.
"""
import torch_threads  # noqa: F401  (caps torch's threads a worker)
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import SHAPES as JAX_SHAPES
from repro.configs import get_config as jax_get_config
from repro.configs import shape_applicable as jax_shape_applicable
from repro.models import Model as JaxModel
from repro.models.model import greedy_decode as jax_greedy_decode
from repro.runtime.serve_loop import Request as JaxRequest
from repro.runtime.serve_loop import ServeLoop as JaxServeLoop
from repro_torch.configs import (
    ARCH_IDS,
    ATTENTION_IMPLS,
    SHAPES,
    ModelConfig,
    get_config,
    shape_applicable,
)
from repro_torch.kernels import ops
from repro_torch.launch.train import main as train_main
from repro_torch.models import Model, greedy_decode, params_from_jax
from repro_torch.runtime import Request, ServeLoop, train

TOL = dict(rtol=2e-5, atol=2e-5)
REDUCED = dict(d_model=256, d_ff=256, vocab=128)
ARCHS = ["falcon-mamba-7b", "hymba-1.5b"]


def _pair(arch, **replace):
    """(jax model, jax params, port cfg, port params) of a reduced arch."""
    jcfg = jax_get_config(arch).reduced(**REDUCED).replace(n_kv_heads=2, **replace)
    tcfg = get_config(arch).reduced(**REDUCED).replace(n_kv_heads=2, **replace)
    jmodel = JaxModel(jcfg)
    jmodel.decode_step = jax.jit(jmodel.decode_step)    # one trace a shape
    jparams = jmodel.init(jax.random.PRNGKey(0))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    return jmodel, jparams, tcfg, tparams


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    return _pair(request.param)


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


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

_PROPS = ("resolved_head_dim", "resolved_d_inner", "resolved_dt_rank", "plan")


def _same_config(t, j):
    for f in dataclasses.fields(ModelConfig):
        if f.name != "attention_impl":      # "kernel" | "reference" by design
            assert getattr(t, f.name) == getattr(j, f.name), f.name
    for f in _PROPS:
        assert getattr(t, f) == getattr(j, f), f


@pytest.mark.parametrize("arch", ARCH_IDS)
@pytest.mark.parametrize("size", ["full", "reduced", "reduced_256"])
def test_configs_equal_jax(arch, size):
    t, j = get_config(arch), jax_get_config(arch)
    if size == "reduced":
        t, j = t.reduced(), j.reduced()
    elif size == "reduced_256":
        t, j = t.reduced(**REDUCED), j.reduced(**REDUCED)
    _same_config(t, j)


def test_reduced_hybrid_fields():
    """JAX's ``reduced()`` rules for the SSM and window fields."""
    for arch in ARCHS:
        cfg = get_config(arch).reduced(d_model=96)
        assert cfg.d_inner == 192 and cfg.ssm_state == 8 and cfg.dt_rank == 0
        assert cfg.resolved_dt_rank == 6
    h = get_config("hymba-1.5b").reduced()
    assert h.swa_window == 32 and h.plan == (("hybrid_full", 1), ("hybrid_swa", 1))
    llama = get_config("llama3.2-1b")
    assert llama.tie_embeddings and llama.family == "dense"
    assert llama.reduced().d_inner == 0 and llama.reduced().swa_window is None


def test_shapes_equal_jax():
    assert list(SHAPES) == list(JAX_SHAPES)
    for name, s in SHAPES.items():
        js = JAX_SHAPES[name]
        assert (s.name, s.seq_len, s.global_batch, s.kind, s.is_decode) == \
            (js.name, js.seq_len, js.global_batch, js.kind, js.is_decode)
    for arch in ARCH_IDS:
        for name in SHAPES:
            assert shape_applicable(get_config(arch), SHAPES[name]) == \
                jax_shape_applicable(jax_get_config(arch), JAX_SHAPES[name])
    assert not shape_applicable(get_config("llama3.2-1b"), SHAPES["long_500k"])[0]
    assert shape_applicable(get_config("hymba-1.5b"), SHAPES["long_500k"])[0]


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------

def test_params_from_jax_round_trip(pair):
    _, jparams, tcfg, tparams = pair
    jl = list(_leaves(jax.tree.map(np.asarray, jparams)))
    tl = list(_leaves(tparams))
    assert [p for p, _ in jl] == [p for p, _ in tl]
    assert ("lm_head",) in [p for p, _ in tl]
    for (path, a), (_, t) in zip(jl, tl):
        assert t.dtype == torch.float32 and t.device.type == "cpu", path
        np.testing.assert_array_equal(t.numpy(), a, err_msg=str(path))
    own = list(_leaves(Model(tcfg, device="cpu").init(seed=3)))
    assert [(p, tuple(t.shape), t.dtype) for p, t in own] == \
        [(p, tuple(t.shape), t.dtype) for p, t in tl]


def test_untied_head_is_the_head(pair):
    """The logits come from ``lm_head``, not from ``embed``ᵀ."""
    _, _, tcfg, tparams = pair
    model = Model(tcfg, device="cpu")
    toks = _tokens(3, (1, 16))
    base = model.prefill(tparams, toks)
    bumped = dict(tparams, lm_head=tparams["lm_head"] * 2)
    torch.testing.assert_close(model.prefill(bumped, toks), base * 2, **TOL)


# ---------------------------------------------------------------------------
# forward / prefill / decode against JAX
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("impl", ATTENTION_IMPLS)
@pytest.mark.parametrize("S", [64, 128])
def test_forward_and_prefill_match_jax_reference(pair, impl, S):
    jmodel, jparams, tcfg, tparams = pair
    model = Model(tcfg.replace(attention_impl=impl), device="cpu")
    toks = _tokens(S, (2, S))
    ops.flash_attention_fwd.launches = 0
    got = model.forward(tparams, toks)
    assert ops.flash_attention_fwd.launches == 0           # CPU: plain version
    assert got.shape == (2, S, tcfg.vocab_size) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(jmodel.forward(jparams, jnp.asarray(toks))),
                               **TOL)
    np.testing.assert_allclose(model.prefill(tparams, toks).numpy(),
                               np.asarray(jmodel.prefill(jparams, jnp.asarray(toks))),
                               **TOL)


def test_hybrid_forward_matches_jax_interpret_kernel():
    """S = 128, a multiple of the JAX kernel's 128 block, window 32: the
    Pallas kernel in interpret mode on the SWA and full layers against the
    port's kernel dispatch."""
    jmodel, jparams, tcfg, tparams = _pair("hymba-1.5b")
    jmodel = JaxModel(jmodel.cfg.replace(attention_impl="interpret"))
    toks = _tokens(128, (2, 128))
    got = Model(tcfg, device="cpu").forward(tparams, toks)
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(jmodel.forward(jparams, jnp.asarray(toks))),
                               **TOL)


def _compare_caches(tcache, jcache):
    for ts, js in zip(tcache, jcache):
        assert sorted(ts) == sorted(js)
        for part in ts:
            for name in ts[part]:
                t, j = ts[part][name].numpy(), np.asarray(js[part][name])
                if name == "pos_ids":
                    np.testing.assert_array_equal(t, j)
                else:
                    np.testing.assert_allclose(t, j, **TOL, err_msg=f"{part}.{name}")


@pytest.mark.parametrize("per_row", [True, False], ids=["per_row", "scalar"])
def test_decode_step_matches_jax(pair, per_row):
    jmodel, jparams, tcfg, tparams = pair
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
    _compare_caches(tcache, jcache)


def test_decode_matches_forward_last_position(pair):
    """Stepping a prompt through the cache gives the prefill's logits; the
    64-token prompt is longer than hymba's window of 32."""
    _, _, tcfg, tparams = pair
    model = Model(tcfg, device="cpu")
    toks = _tokens(9, (2, 64))
    cache = model.init_cache(2, 80, dtype=torch.float32)
    for t in range(64):
        logits, cache = model.decode_step(tparams, cache, toks[:, t], t)
    torch.testing.assert_close(logits, model.prefill(tparams, toks), **TOL)


def test_swa_cache_rotates():
    """``swa_window=8``: the SWA layer's cache holds 8 rows, written at
    pos % 8, and 20 decode steps equal JAX's step by step and the forward's
    last position."""
    jmodel, jparams, tcfg, tparams = _pair("hymba-1.5b", swa_window=8)
    model = Model(tcfg, device="cpu")
    B, S = 2, 20
    toks = _tokens(11, (B, S))
    jcache = jmodel.init_cache(B, 32, dtype=jnp.float32)
    tcache = model.init_cache(B, 32, dtype=torch.float32)
    kinds = [k for k, _ in tcfg.plan]
    swa = tcache[kinds.index("hybrid_swa")]["kv"]
    full = tcache[kinds.index("hybrid_full")]["kv"]
    assert swa["k"].shape[3] == 8 and full["k"].shape[3] == 32
    for t in range(S):
        jl, jcache = jmodel.decode_step(jparams, jcache, jnp.asarray(toks[:, t]),
                                        jnp.int32(t))
        tl, tcache = model.decode_step(tparams, tcache, toks[:, t], t)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    _compare_caches(tcache, jcache)
    want_pos = [p for p in range(S - 8, S)]
    assert sorted(swa["pos_ids"][0, 0].tolist()) == want_pos
    assert swa["pos_ids"][0, 0, (S - 1) % 8] == S - 1
    torch.testing.assert_close(tl, model.prefill(tparams, toks), **TOL)


def test_greedy_decode_matches_jax(pair):
    jmodel, jparams, tcfg, tparams = pair
    prompt = _tokens(5, (2, 7))
    want = np.asarray(jax_greedy_decode(jmodel, jparams, jnp.asarray(prompt), 9))
    got = greedy_decode(Model(tcfg, device="cpu"), tparams, prompt, 9)
    np.testing.assert_array_equal(got.numpy(), want)


# ---------------------------------------------------------------------------
# serving, and C17 (a reused slot's SSM state)
# ---------------------------------------------------------------------------

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
    """6 requests through 3 slots (so 3 land in reused slots) equal each
    request decoded alone on a fresh cache."""
    _, _, tcfg, tparams = pair
    model = Model(tcfg, device="cpu")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, tcfg.vocab_size, L).astype(np.int32)
               for L in (5, 9, 3, 7, 4, 6)]
    n_new = 6
    refs = [_sequential_reference(model, tparams, p, n_new, 64) for p in prompts]
    loop = ServeLoop(model, tparams, n_slots=3, max_seq=64)
    reqs = [Request(rid=i, prompt=p, max_new=n_new) for i, p in enumerate(prompts)]
    for r in reqs:
        loop.submit(r)
    loop.run()
    for r, ref in zip(reqs, refs):
        assert r.done and r.output == ref, (r.rid, r.output, ref)
    assert loop.steps < sum(len(p) + n_new for p in prompts)


def test_serve_loop_matches_jax_without_slot_reuse(pair):
    """With a slot for every request (no reuse, so C17 cannot show) the
    port's loop and the JAX loop give the same tokens in as many steps."""
    jmodel, jparams, tcfg, tparams = pair
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, tcfg.vocab_size, L).astype(np.int32)
               for L in (6, 2, 9, 4)]
    jloop = JaxServeLoop(jmodel, jparams, n_slots=4, max_seq=32)
    tloop = ServeLoop(Model(tcfg, device="cpu"), tparams, n_slots=4, max_seq=32)
    jreqs = [JaxRequest(i, p, max_new=5) for i, p in enumerate(prompts)]
    treqs = [Request(i, p, max_new=5) for i, p in enumerate(prompts)]
    for jr, tr in zip(jreqs, treqs):
        jloop.submit(jr)
        tloop.submit(tr)
    jloop.run()
    tloop.run()
    assert [r.output for r in treqs] == [r.output for r in jreqs]
    assert tloop.steps == jloop.steps


def _jax_slot_logits(jmodel, jparams, prompts):
    """JAX's decode steps on one one-row cache, each request's positions
    restarting at 0 as ``ServeLoop._attach`` does: the last request's
    logits at every step."""
    cache = jmodel.init_cache(1, 32, dtype=jnp.float32)
    for p in prompts:
        steps = []
        for t, tok in enumerate(p):
            lg, cache = jmodel.decode_step(jparams, cache, jnp.asarray([tok]),
                                           jnp.asarray([t], jnp.int32))
            steps.append(np.asarray(lg[0]))
    return np.stack(steps)


def _port_loop_logits(model, params, prompts):
    """The port's one-slot ``ServeLoop`` serving ``prompts`` one after the
    other (each later request in the reused slot): the last request's
    logits at every step, recorded around ``decode_step``."""
    seen = []
    step = model.decode_step

    def recording(*a, **kw):
        logits, cache = step(*a, **kw)
        seen.append(logits[0].clone())
        return logits, cache

    model.decode_step = recording
    loop = ServeLoop(model, params, n_slots=1, max_seq=32)
    for i, p in enumerate(prompts):
        loop.submit(Request(i, p, max_new=1))
    loop.run()
    return torch.stack(seen[-len(prompts[-1]):]).numpy()


@pytest.mark.parametrize("arch", ARCHS)
def test_reused_slot_starts_from_a_clean_state(arch):
    """C17. Request a (8 tokens) then request b (6 tokens) in one slot. In
    JAX b's logits differ from b on a fresh cache by more than 1e-2 (the
    reference leaks a's SSM state into b); in the port's loop they equal a
    fresh slot's, and JAX's fresh-slot logits."""
    jmodel, jparams, tcfg, tparams = _pair(arch)
    a, b = _tokens(21, (8,)), _tokens(22, (6,))
    j_reused = _jax_slot_logits(jmodel, jparams, [a, b])
    j_fresh = _jax_slot_logits(jmodel, jparams, [b])
    assert np.abs(j_reused - j_fresh).max() > 1e-2
    t_reused = _port_loop_logits(Model(tcfg, device="cpu"), tparams, [a, b])
    t_fresh = _port_loop_logits(Model(tcfg, device="cpu"), tparams, [b])
    np.testing.assert_array_equal(t_reused, t_fresh)
    np.testing.assert_allclose(t_fresh, j_fresh, **TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_cli_trains_the_ssm_kinds(arch):
    """``launch.train --arch falcon-mamba-7b | hymba-1.5b --reduced`` trains
    on the CPU: 2 steps of 2 × 128 tokens (two scan chunks), finite
    losses."""
    state, history = train_main(["--arch", arch, "--reduced", "--device", "cpu",
                                 "--steps", "2", "--batch", "2", "--seq", "128"])
    assert int(state["step"]) == 2 and len(history) == 2
    assert all(np.isfinite(h["loss"]) for h in history)
    assert "lm_head" in state["params"]


def test_unported_kinds_still_raise():
    """What the port cannot train raises before anything is built: an
    optimizer name it does not have (``runtime.train``), and in the train
    CLI a conditioned arch, whose cond no frontend makes (C21). grok-1's
    ``adafactor`` trains (``tests/test_torch_xtrain.py``)."""
    cfg = get_config("hymba-1.5b").reduced(d_model=256)
    with pytest.raises(KeyError, match="unknown optimizer"):
        train(Model(cfg, device="cpu"), iter([]), steps=1,
              optimizer_name="lion")
    with pytest.raises(ValueError, match="conditioning frontend"):
        train_main(["--arch", "musicgen-large", "--reduced", "--device", "cpu",
                    "--steps", "1"])


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
@pytest.mark.parametrize("S", [64, 128])
def test_hybrid_kernel_path_matches_plain_on_card(cuda_device, S):
    """Reduced hymba on the card: the kernel path (B4 on every layer, the
    SWA layer windowed) against the plain reference attention, float32."""
    _, jparams, tcfg, _ = _pair("hymba-1.5b")
    params = params_from_jax(jax.tree.map(np.asarray, jparams), device=cuda_device)
    toks = _tokens(S, (2, S))
    ops.flash_attention_fwd.launches = 0
    got = Model(tcfg, device=cuda_device).forward(params, toks)
    torch.cuda.synchronize()
    assert ops.flash_attention_fwd.launches == tcfg.n_layers
    want = Model(tcfg.replace(attention_impl="reference"),
                 device=cuda_device).forward(params, toks)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
