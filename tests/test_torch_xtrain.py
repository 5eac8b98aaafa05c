"""Training the port's ``moe`` and ``cross`` block kinds against the JAX
package, at reduced phi3.5-moe-42b-a6.6b, grok-1-314b, musicgen-large and
llama-3.2-vision-11b.

``Model.loss`` and the gradient of every parameter leaf equal
``jax.value_and_grad`` of JAX's ``Model.loss`` on carried-across
parameters: phi with row-local routing at its capacity factor and at a
dropping one (0.5), with global routing, and with a zero router (every
probability ties, so the experts chosen are ``lax.top_k``'s, the lower
index first; ROADMAP C20); grok; and the two conditioned models with a
seeded N(0, 1) ``cond`` in the batch. The port runs its ``reference``
impl and its ``kernel`` impl (on the CPU, the ``FlashAttention``
Function's plain versions) against JAX's ``reference``: JAX's interpret
kernel is not finite below one 128-key block, which the cross attention's
8 keys are (C18). Under ``remat`` the layers are recomputed and route
alike, so the gradients do not move. Three AdamW steps equal JAX's
``make_train_step``, also with ``grad_accum`` 2 and ``cond`` sliced with
the micro-batches. The train CLI trains phi, and grok through its own
optimizer (Adafactor); it refuses the conditioned archs (no conditioning
frontend; JAX's CLI feeds no ``cond`` either and fails, C21, shown on
JAX's side); ``runtime.train`` trains musicgen on batches that carry
``cond``, and grok with Adafactor.

Configuration: ``reduced(d_model=256, d_ff=256, vocab=128)``: 4 query
heads of 64 (2 kv heads where the config has GQA), 4 experts top-2,
cond_len 8, cond_dim 256, float32. Tolerance: loss and gradients rtol/atol
1e-5, the bar of ``tests/test_torch_train.py``; the train steps' metrics
1e-5 and parameters atol 1e-5, as there.
"""
import torch_threads  # noqa: F401  (caps torch's threads a worker)
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import Model as JaxModel
from repro.optim import adamw as jax_adamw
from repro.optim.schedule import warmup_cosine as jax_warmup_cosine
from repro.runtime.train_loop import init_train_state as jax_init_train_state
from repro.runtime.train_loop import make_train_step as jax_make_train_step
from repro_torch.configs import get_config
from repro_torch.launch.train import main as train_main
from repro_torch.models import Model, params_from_jax, train_state_from_jax
from repro_torch.models.common import tree_leaves
from repro_torch.optim import adamw, warmup_cosine
from repro_torch.runtime import make_train_step, train

GRAD_TOL = dict(rtol=1e-5, atol=1e-5)
REDUCED = dict(d_model=256, d_ff=256, vocab=128)
PHI, GROK = "phi3.5-moe-42b-a6.6b", "grok-1-314b"
MUSICGEN, VISION = "musicgen-large", "llama-3.2-vision-11b"

# (arch, config fields replaced on both sides, zero router)
CASES = {
    "phi-local": (PHI, {}, False),
    "phi-local-cf0.5": (PHI, {"capacity_factor": 0.5}, False),
    "phi-global": (PHI, {"moe_routing": "global", "capacity_factor": 0.5}, False),
    "phi-zero-router": (PHI, {}, True),
    "grok": (GROK, {}, False),
    "musicgen": (MUSICGEN, {}, False),
    "llama-vision": (VISION, {}, False),
}


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _cfgs(arch, **replace):
    jcfg = jax_get_config(arch).reduced(**REDUCED)
    tcfg = get_config(arch).reduced(**REDUCED)
    if jax_get_config(arch).n_kv_heads < jax_get_config(arch).n_heads:
        replace = {"n_kv_heads": 2, **replace}
    return jcfg.replace(**replace), tcfg.replace(**replace)


def _zero_router(jparams):
    """JAX's parameters with every MoE router zeroed."""
    def walk(t):
        if isinstance(t, dict):
            return {k: (jnp.zeros_like(v) if k == "router" else walk(v))
                    for k, v in t.items()}
        if isinstance(t, list):
            return [walk(v) for v in t]
        return t
    return walk(jparams)


@functools.lru_cache(maxsize=None)
def _pair(case):
    """(jax model, jax params, port cfg) of a case; no test changes them."""
    arch, replace, zero = CASES[case]
    jcfg, tcfg = _cfgs(arch, **replace)
    jmodel = JaxModel(jcfg)
    jparams = jax.jit(jmodel.init)(jax.random.PRNGKey(0))
    if zero:
        jparams = _zero_router(jparams)
    return jmodel, jparams, tcfg


def _batch(cfg, seed, B, S):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, S + 1))
    batch = {"tokens": toks[:, :-1].astype(np.int32),
             "labels": toks[:, 1:].astype(np.int32)}
    if cfg.cond_len:
        batch["cond"] = rng.normal(0, 1, (B, cfg.cond_len, cfg.cond_dim)).astype(
            np.float32)
    return batch


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


@pytest.mark.parametrize("impl", ["reference", "kernel"])
@pytest.mark.parametrize("case", list(CASES))
def test_loss_and_grads_match_jax(case, impl):
    jmodel, jparams, tcfg = _pair(case)
    batch = _batch(tcfg, 7, 2, 64)
    jl, jg = jax.value_and_grad(jmodel.loss)(jparams, _jax(batch))
    model = Model(tcfg.replace(attention_impl=impl), device="cpu")
    params = params_from_jax(_np(jparams), device="cpu")
    loss, grads = _loss_and_grads(model, params, _torch(batch))
    torch.testing.assert_close(loss.detach(), torch.tensor(float(jl)), **GRAD_TOL)
    _assert_tree_close(list(grads), _np(jg), "grad", **GRAD_TOL)
    # every leaf is reached: the routers and experts of a moe plan, the
    # cross attention's k/v projections of cond
    assert all(float(g.abs().max()) > 0 for g in grads)


@pytest.mark.parametrize("case", ["phi-local-cf0.5", "musicgen"])
def test_remat_gives_the_same_gradients(case):
    """With ``remat`` each layer is recomputed in the backward; its routing,
    recomputed from the same input, picks the same experts and the same
    capacity drops, so loss and gradients equal those without."""
    _, jparams, tcfg = _pair(case)
    batch = _torch(_batch(tcfg, 3, 2, 64))
    out = []
    for remat in (True, False):
        model = Model(tcfg.replace(remat=remat), device="cpu")
        out.append(_loss_and_grads(model, params_from_jax(_np(jparams),
                                                          device="cpu"), batch))
    assert torch.equal(out[0][0], out[1][0])
    for a, b in zip(out[0][1], out[1][1]):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)


def _three_steps(case, grad_accum):
    jmodel, _, tcfg = _pair(case)
    jopt = jax_adamw()
    lr = dict(peak_lr=1e-3, warmup_steps=1, total_steps=3)
    jstate = jax_init_train_state(jmodel, jopt, jax.random.PRNGKey(1))
    jstep = jax.jit(jax_make_train_step(jmodel, jopt, jax_warmup_cosine(**lr),
                                        grad_accum=grad_accum))
    model = Model(tcfg.replace(attention_impl="reference"), device="cpu")
    tstate = train_state_from_jax(_np(jstate), device="cpu")
    tstep = make_train_step(model, adamw(), warmup_cosine(**lr),
                            grad_accum=grad_accum)
    for i in range(3):
        batch = _batch(tcfg, 10 + i, 2 * grad_accum, 32)
        if grad_accum > 1:            # (grad_accum, micro_batch, ...) leaves
            batch = {k: v.reshape(grad_accum, 2, *v.shape[1:])
                     for k, v in batch.items()}
        jstate, jm = jstep(jstate, _jax(batch))
        tstate, tm = tstep(tstate, _torch(batch))
        for k in ("loss", "grad_norm", "lr"):
            torch.testing.assert_close(tm[k].detach(), torch.tensor(float(jm[k])),
                                       rtol=1e-5, atol=1e-5,
                                       msg=lambda m: f"step {i} {k}: {m}")
    assert int(tstate["step"]) == int(jstate["step"]) == 3
    _assert_tree_close(tstate["params"], _np(jstate["params"]), "params",
                       rtol=0, atol=1e-5)
    _assert_tree_close(tstate["opt"]["m"], _np(jstate["opt"]["m"]), "m",
                       rtol=1e-4, atol=1e-7)


@pytest.mark.parametrize("case", ["phi-local-cf0.5", "musicgen"])
def test_three_train_steps_match_jax(case):
    _three_steps(case, grad_accum=1)


def test_grad_accum_with_cond_matches_jax():
    """``grad_accum`` 2: each micro-batch carries its own slice of cond."""
    _three_steps("musicgen", grad_accum=2)


def test_train_cli_trains_moe_and_refuses_what_it_cannot_feed():
    state, history = train_main(["--arch", PHI, "--reduced", "--device", "cpu",
                                 "--steps", "2", "--batch", "2", "--seq", "32"])
    assert int(state["step"]) == 2 and len(history) == 2
    assert all(np.isfinite(h["loss"]) for h in history)
    state, history = train_main(["--arch", GROK, "--reduced", "--device", "cpu",
                                 "--steps", "2", "--batch", "2", "--seq", "32"])
    assert int(state["step"]) == 2 and len(history) == 2
    assert all(np.isfinite(h["loss"]) for h in history)
    assert set(state["opt"]) == {"f"}               # Adafactor's factors
    for arch in (MUSICGEN, VISION):
        with pytest.raises(ValueError, match="conditioning frontend"):
            train_main(["--arch", arch, "--reduced", "--device", "cpu",
                        "--steps", "1"])


def test_jax_cli_path_fails_without_cond():
    """ROADMAP C21 on JAX's side: JAX's train CLI feeds token batches only,
    and its ``Model.loss`` of a cross plan then fails in the cross
    attention's k/v projection of ``cond=None``."""
    jmodel, jparams, tcfg = _pair("musicgen")
    batch = _batch(tcfg, 1, 1, 8)
    del batch["cond"]
    with pytest.raises(ValueError, match="shape of None"):
        jmodel.loss(jparams, _jax(batch))


def test_runtime_train_takes_batches_with_cond():
    """musicgen through ``runtime.train`` (AdamW, the port's default warmup),
    each batch with a cond: two steps, finite losses; grok through its
    config's optimizer, Adafactor: one step, a finite loss."""
    _, _, tcfg = _pair("musicgen")
    batches = iter([_torch(_batch(tcfg, 20 + i, 2, 32)) for i in range(2)])
    state, history = train(Model(tcfg, device="cpu"), batches, steps=2,
                           log_every=0)
    assert int(state["step"]) == 2
    assert all(np.isfinite(h["loss"]) for h in history)
    _, _, gcfg = _pair("grok")
    state, history = train(Model(gcfg, device="cpu"),
                           iter([_torch(_batch(gcfg, 30, 2, 32))]), steps=1,
                           log_every=0)
    assert "f" in state["opt"] and np.isfinite(history[0]["loss"])
