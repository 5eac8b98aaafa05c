"""The port's training slice against the JAX package's, at a reduced Llama.

Configuration: ``reduced(d_model=256, d_ff=256, vocab=128)`` with 2 kv heads
for 4 query heads (GQA, group 2) and head_dim 64 — the flash kernels'
smallest — in float32; the JAX parameters and train state are carried
across with ``params_from_jax`` / ``train_state_from_jax`` and both sides
take the same seeded numpy tokens. The fault-recovery test, which compares
nothing with JAX, runs a smaller model on the reference attention.

Tolerances. Loss within rtol 1e-5 and gradients per leaf within rtol/atol
1e-5: float32 on both sides, differing only in the order XLA and PyTorch
sum (observed ≤ 1e-6 relative on the loss). AdamW moments, masters and
parameters within rtol/atol 1e-6 after the same float32 update formula;
bf16 parameters within one bf16 step (rtol 1e-2) of each other, since a
master that differs in its last float32 bit can round to the neighbouring
bf16 value. Three train steps: losses within rtol 1e-5 and parameters
within atol 1e-5, as the JAX package's own grad-accumulation test holds
its two paths. Remat on and off give bit-identical gradients on the CPU
(the recompute repeats the same operations in the same order), except
the tied embedding's, whose two contributions are summed in another order
(within rtol 1e-6 / atol 1e-7; observed 1.5e-8 on entries up to 0.17,
one float32 step).
"""
import torch_threads  # noqa: F401  (caps torch's threads a worker)
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.checkpoint import load_checkpoint as jax_load_checkpoint
from repro.checkpoint import save_checkpoint as jax_save_checkpoint
from repro.configs import get_config as jax_get_config
from repro.data.tokens import batches as jax_batches
from repro.data.tokens import synthetic_corpus as jax_synthetic_corpus
from repro.models import Model as JaxModel
from repro.optim import adamw as jax_adamw
from repro.optim.schedule import clip_by_global_norm as jax_clip
from repro.optim.schedule import warmup_cosine as jax_warmup_cosine
from repro.runtime.train_loop import init_train_state as jax_init_train_state
from repro.runtime.train_loop import make_train_step as jax_make_train_step
from repro_torch.checkpoint import (
    CheckpointManager,
    load_checkpoint,
    save_checkpoint,
)
from repro_torch.checkpoint.checkpoint import _paths
from repro_torch.configs import get_config
from repro_torch.data.tokens import batches, synthetic_corpus
from repro_torch.launch import train as train_cli
from repro_torch.models import Model, params_from_jax, train_state_from_jax
from repro_torch.models.common import tree_leaves, tree_map
from repro_torch.optim import adamw, clip_by_global_norm, warmup_cosine
from repro_torch.runtime import FaultInjector, make_train_step, train

LOSS_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-5, atol=1e-5)
OPT_TOL = dict(rtol=1e-6, atol=1e-6)
REDUCED = dict(d_model=256, d_ff=256, vocab=128)


@pytest.fixture(scope="module")
def pair():
    """(jax cfg, jax params, port cfg) of the reduced GQA llama."""
    jcfg = jax_get_config("llama3.2-1b").reduced(**REDUCED).replace(n_kv_heads=2)
    tcfg = get_config("llama3.2-1b").reduced(**REDUCED).replace(n_kv_heads=2)
    jparams = JaxModel(jcfg).init(jax.random.PRNGKey(0))
    return jcfg, jparams, tcfg


def _batch(seed, B, S, vocab=REDUCED["vocab"]):
    toks = np.random.default_rng(seed).integers(0, vocab, (B, S + 1))
    return {"tokens": toks[:, :-1].astype(np.int32),
            "labels": toks[:, 1:].astype(np.int32)}


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _loss_and_grads(model, params, batch):
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    loss = model.loss(params, batch)
    return loss, torch.autograd.grad(loss, leaves)


def _assert_tree_close(got, want, msg="", **tol):
    """Port leaves (tensors) against JAX leaves (numpy) in tree order."""
    got, want = tree_leaves(got), jax.tree.leaves(want)
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        torch.testing.assert_close(
            g.detach().float(), torch.from_numpy(np.asarray(w, np.float32)),
            **tol, msg=lambda m: f"{msg} leaf {i}: {m}")


@pytest.mark.parametrize("impl,S", [("reference", 32), ("interpret", 128)])
def test_loss_and_grads_match_jax(pair, impl, S):
    """``Model.loss`` and its gradient per leaf: JAX ``reference`` against the
    port's ``reference``, and the JAX Pallas kernels in interpret mode
    against the port's kernel dispatch (the ``FlashAttention`` Function's
    plain versions on the CPU)."""
    jcfg, jparams, tcfg = pair
    batch = _batch(S, 2, S)
    jl, jg = jax.value_and_grad(JaxModel(jcfg.replace(attention_impl=impl)).loss)(
        jparams, _jax(batch))
    timpl = "reference" if impl == "reference" else "kernel"
    model = Model(tcfg.replace(attention_impl=timpl), device="cpu")
    params = params_from_jax(_np(jparams), device="cpu")
    loss, grads = _loss_and_grads(model, params, _torch(batch))
    torch.testing.assert_close(loss.detach(), torch.tensor(float(jl)), **LOSS_TOL)
    _assert_tree_close(list(grads), _np(jg), "grad", **GRAD_TOL)


def test_remat_gives_the_same_gradients(pair):
    _, jparams, tcfg = pair
    batch = _torch(_batch(3, 2, 64))
    out = []
    for remat in (True, False):
        model = Model(tcfg.replace(remat=remat), device="cpu")
        params = params_from_jax(_np(jparams), device="cpu")
        out.append(_loss_and_grads(model, params, batch))
    assert torch.equal(out[0][0], out[1][0])
    for name, a, b in zip(_paths(params), out[0][1], out[1][1]):
        if name == "['embed']":
            # the tied embedding's two contributions (lookup and head) are
            # summed in another order under remat
            torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)
        else:
            assert torch.equal(a, b), name


def _opt_trees(seed, dtype):
    rng = np.random.default_rng(seed)
    shapes = {"a": (3, 5), "b": {"c": (7,), "d": (2, 2, 4)}}

    def draw(scale):
        return jax.tree.map(lambda s: (rng.normal(0, scale, s)).astype(np.float32),
                            shapes, is_leaf=lambda x: isinstance(x, tuple))
    params, g1, g2 = draw(1.0), draw(0.1), draw(0.1)
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    as_jax = lambda t: jax.tree.map(lambda a: jnp.asarray(a).astype(jdt), t)
    as_torch = lambda t: tree_map(lambda a: torch.from_numpy(a).to(tdt), t)
    return (as_jax(params), [as_jax(g1), as_jax(g2)],
            as_torch(params), [as_torch(g1), as_torch(g2)])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adamw_matches_jax(dtype):
    """Two AdamW updates; with bf16 parameters the state carries a float32
    master copy on both sides."""
    jparams, jgrads, tparams, tgrads = _opt_trees(4, dtype)
    jopt, topt = jax_adamw(), adamw()
    jstate, tstate = jopt.init(jparams), topt.init(tparams)
    assert ("master" in jstate) == ("master" in tstate) == (dtype == "bfloat16")
    for step, (jg, tg) in enumerate(zip(jgrads, tgrads)):
        jparams, jstate = jopt.update(jg, jstate, jparams, jnp.int32(step), 1e-2)
        tparams, tstate = topt.update(tg, tstate, tparams,
                                      torch.tensor(step), 1e-2)
    for key in jstate:
        _assert_tree_close(tstate[key], _np(jstate[key]), key, **OPT_TOL)
    ptol = OPT_TOL if dtype == "float32" else dict(rtol=1e-2, atol=1e-6)
    _assert_tree_close(tparams, _np(jax.tree.map(lambda a: a.astype(jnp.float32),
                                                 jparams)), "params", **ptol)


def test_schedule_and_clipping_match_jax():
    jlr, tlr = jax_warmup_cosine(3e-3, 3, 10), warmup_cosine(3e-3, 3, 10)
    for step in range(13):
        torch.testing.assert_close(tlr(torch.tensor(step)),
                                   torch.tensor(float(jlr(step))),
                                   rtol=1e-6, atol=0)
    rng = np.random.default_rng(5)
    leaves = [rng.normal(0, 1, s).astype(np.float32) for s in ((4, 3), (6,))]
    for max_norm in (0.5, 100.0):                 # clipped, and left alone
        jg, jn = jax_clip([jnp.asarray(a) for a in leaves], max_norm)
        tg, tn = clip_by_global_norm([torch.from_numpy(a.copy()) for a in leaves],
                                     max_norm)
        torch.testing.assert_close(tn, torch.tensor(float(jn)), rtol=1e-6, atol=0)
        _assert_tree_close(tg, _np(jg), "clipped", **OPT_TOL)


def test_three_train_steps_match_jax(pair):
    jcfg, _, tcfg = pair
    jmodel = JaxModel(jcfg)
    jopt = jax_adamw()
    lr = dict(peak_lr=1e-3, warmup_steps=1, total_steps=3)
    jstate = jax_init_train_state(jmodel, jopt, jax.random.PRNGKey(1))
    jstep = jax.jit(jax_make_train_step(jmodel, jopt, jax_warmup_cosine(**lr)))
    model = Model(tcfg.replace(attention_impl="reference"), device="cpu")
    tstate = train_state_from_jax(_np(jstate), device="cpu")
    tstep = make_train_step(model, adamw(), warmup_cosine(**lr))
    for i in range(3):
        batch = _batch(10 + i, 2, 32)
        jstate, jm = jstep(jstate, _jax(batch))
        tstate, tm = tstep(tstate, _torch(batch))
        for k in ("loss", "grad_norm", "lr"):
            torch.testing.assert_close(tm[k].detach(), torch.tensor(float(jm[k])),
                                       **LOSS_TOL, msg=lambda m: f"step {i} {k}: {m}")
    assert int(tstate["step"]) == int(jstate["step"]) == 3
    _assert_tree_close(tstate["params"], _np(jstate["params"]), "params",
                       rtol=0, atol=1e-5)
    _assert_tree_close(tstate["opt"]["m"], _np(jstate["opt"]["m"]), "m",
                       rtol=1e-4, atol=1e-7)


def test_grad_accum_matches_full_batch(pair):
    _, jparams, tcfg = pair
    model = Model(tcfg.replace(attention_impl="reference"), device="cpu")
    lr = warmup_cosine(1e-3, 1, 10)
    full = _torch(_batch(7, 8, 16))
    micro = {k: v.reshape(4, 2, *v.shape[1:]) for k, v in full.items()}
    out = []
    for accum, batch in ((1, full), (4, micro)):
        opt = adamw()
        params = params_from_jax(_np(jparams), device="cpu")
        state = {"params": params, "opt": opt.init(params),
                 "step": torch.zeros((), dtype=torch.int64)}
        out.append(make_train_step(model, opt, lr, grad_accum=accum)(state, batch))
    (s1, m1), (s4, m4) = out
    torch.testing.assert_close(m1["loss"], m4["loss"], rtol=1e-5, atol=0)
    for a, b in zip(tree_leaves(s1["params"]), tree_leaves(s4["params"])):
        torch.testing.assert_close(a.detach(), b.detach(), rtol=0, atol=1e-5)


def test_jax_checkpoint_loads_in_the_port(pair, tmp_path):
    """A JAX-written train state (plus a bf16 tree) loads into the port's
    template by path, and the port's own checkpoint loads into JAX."""
    jcfg, _, _ = pair
    jstate = jax_init_train_state(JaxModel(jcfg), jax_adamw(),
                                  jax.random.PRNGKey(2))
    jtree = {"state": jstate, "half": {"w": jnp.linspace(-3, 3, 12,
                                                          dtype=jnp.bfloat16)}}
    jax_save_checkpoint(str(tmp_path / "jax"), 5, jtree, {"note": "x"})
    template = {"state": train_state_from_jax(_np(jstate), device="cpu"),
                "half": {"w": torch.zeros(12, dtype=torch.bfloat16)}}
    restored, manifest = load_checkpoint(str(tmp_path / "jax"), template)
    assert manifest["step"] == 5 and manifest["metadata"] == {"note": "x"}
    assert restored["half"]["w"].dtype == torch.bfloat16
    assert restored["state"]["step"].dtype == torch.int64
    _assert_tree_close(restored, _np(jax.tree.map(
        lambda a: a.astype(jnp.float32), jtree)), "restored", rtol=0, atol=0)

    # the port's checkpoint of a float32 state, read back by both packages
    tstate = train_state_from_jax(_np(jstate), device="cpu")
    save_checkpoint(str(tmp_path / "port"), 6, tstate)
    back, _ = load_checkpoint(str(tmp_path / "port"), tstate)
    for a, b in zip(tree_leaves(back), tree_leaves(tstate)):
        assert torch.equal(a, b)
    jback, _ = jax_load_checkpoint(str(tmp_path / "port"), jstate)
    _assert_tree_close(tstate, _np(jback), "jax reads the port's", rtol=0, atol=0)


def test_bf16_checkpoint_round_trip_and_keep_k(tmp_path):
    tree = {"p": torch.linspace(-2, 2, 10).to(torch.bfloat16),
            "s": torch.tensor(3, dtype=torch.int64)}
    mgr = CheckpointManager(str(tmp_path), keep=2, async_save=True)
    for s in (1, 2, 3):
        mgr.save(s, tree)
        saved = tree["p"].clone()
        tree["p"] += 1                      # in place, after the snapshot
    mgr.wait()
    assert sorted(p.name for p in tmp_path.iterdir()) == ["step_00000002",
                                                          "step_00000003"]
    back, manifest = mgr.restore(tree)
    assert manifest["step"] == 3 and manifest["dtypes"] == ["bfloat16", "int64"]
    assert torch.equal(back["p"], saved) and int(back["s"]) == 3


def _small_model():
    cfg = get_config("llama3.2-1b").reduced(d_model=32, d_ff=64, vocab=64)
    return Model(cfg.replace(attention_impl="reference"), device="cpu")


def _stream(vocab, n, B=4, S=16, seed=0):
    """Learnable stream: each row is a modular-successor sequence."""
    rng = np.random.default_rng(seed)
    for _ in range(n):
        start = rng.integers(0, vocab, (B, 1))
        toks = (start + np.arange(S + 1)) % vocab
        yield _torch({"tokens": toks[:, :-1].astype(np.int32),
                      "labels": toks[:, 1:].astype(np.int32)})


def test_fault_recovery_resumes_from_checkpoint(tmp_path):
    model = _small_model()
    inj = FaultInjector(fail_at=[7, 11])
    state, hist = train(model, _stream(64, 100), steps=16, peak_lr=5e-3,
                        warmup=2, checkpoint_dir=str(tmp_path),
                        checkpoint_every=5, fault_injector=inj,
                        async_checkpoint=False, log_every=0)
    assert int(state["step"]) == 16
    steps_seen = [h["step"] for h in hist]
    # restarted from step 5 after the fault at 7, from 10 after the one at 11
    assert steps_seen.count(5) == 2 and steps_seen.count(10) == 2
    assert all(np.isfinite(h["loss"]) for h in hist)
    first = np.mean([h["loss"] for h in hist[:3]])
    assert hist[-1]["loss"] < first


def test_corpus_and_batches_match_jax():
    kw = dict(n_sources=6, docs_per_source=5, doc_len=33, vocab_size=97,
              n_copiers=2, seed=3)
    jc, tc = jax_synthetic_corpus(**kw), synthetic_corpus(**kw)
    assert len(jc.docs) == len(tc.docs)
    for a, b in zip(jc.docs, tc.docs):
        np.testing.assert_array_equal(a, b)
    for f in ("doc_source", "doc_topic", "source_accuracy"):
        np.testing.assert_array_equal(getattr(jc, f), getattr(tc, f))
    assert jc.copy_edges == tc.copy_edges
    w = np.linspace(0.5, 1.5, 6)
    jb = jax_batches(jc, 3, 32, source_weights=w, seed=1)
    tb = batches(tc, 3, 32, source_weights=w, seed=1)
    for _ in range(3):
        j, t = next(jb), next(tb)
        for k in ("tokens", "labels"):
            assert t[k].dtype == torch.int32 and tuple(t[k].shape) == (3, 32)
            np.testing.assert_array_equal(np.asarray(j[k]), t[k].numpy())
    # rows the JAX package would silently shorten (ROADMAP C7)
    with pytest.raises(ValueError, match="seq_len 33"):
        next(batches(tc, 3, 33))


def test_train_cli_runs_on_cpu(tmp_path):
    state, history = train_cli.main([
        "--reduced", "--device", "cpu", "--steps", "2", "--batch", "2",
        "--seq", "32", "--checkpoint-dir", str(tmp_path)])
    assert int(state["step"]) == 2 and len(history) == 2
    assert all(np.isfinite(h["loss"]) for h in history)
    assert (tmp_path / "step_00000002").is_dir()
    # --fusion-weighted: truth finding over the corpus, then weighted batches
    state, history = train_cli.main([
        "--reduced", "--device", "cpu", "--fusion-weighted", "--steps", "2",
        "--batch", "2", "--seq", "32"])
    assert int(state["step"]) == 2 and len(history) == 2
    assert all(np.isfinite(h["loss"]) for h in history)
