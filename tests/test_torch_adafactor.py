"""The port's Adafactor against the JAX package's.

``optim.adafactor`` (the sliced, in-place update) against JAX's
``adafactor`` over 3 successive updates of one parameter tree, which holds
a stacked (3, 16, 24) leaf (updated matrix by matrix in two passes), a
stacked (3, 24) leaf (2-D: factored across its layers, updated whole), a
(40, 24) leaf and a (24,) leaf (a full second moment), in a list under a
dict as a model's segments are. Cases: float32 and bf16 parameters (the
float32 master copy), ``clip_threshold`` 1.0 (the RMS clip active from the
first update) and 1e3 (inactive), ``weight_decay`` 0 and 0.1. The sliced
update is also held against the plain whole-leaf ``adafactor_ref``, and
``make_train_step`` with Adafactor against JAX's for 3 steps of reduced
falcon-mamba-7b and grok-1-314b.

Tolerances. The updates are the same float32 arithmetic on both sides;
only the order of the sums (the factors' means, the leaf's RMS) differs,
so every factor is held to rtol 1e-6 (atol 1e-9), and every parameter and
master to rtol 1e-6 with atol 1e-6: an entry that the updates bring near
0 keeps their own error, ~1e-6 of lr·|u| (lr ≤ 3e-2; |u| a few with the
clip, up to ~30 without it). bf16 parameters are the masters rounded
once, so equal masters round alike except at a rounding boundary: they are
held to one bf16 ulp (rtol 2⁻⁷, an ulp at the bottom of a binade). The train steps at the three-step tests' bars
(``tests/test_torch_xtrain.py``: metrics rtol/atol 1e-5, parameters atol
1e-5).
"""
import torch_threads  # noqa: F401  (caps torch's threads a worker)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import Model as JaxModel
from repro.optim.adafactor import adafactor as jax_adafactor
from repro.optim.schedule import warmup_cosine as jax_warmup_cosine
from repro.runtime.train_loop import init_train_state as jax_init_train_state
from repro.runtime.train_loop import make_train_step as jax_make_train_step
from repro_torch.configs import get_config
from repro_torch.models import Model, train_state_from_jax
from repro_torch.models.common import tree_leaves
from repro_torch.optim import adafactor, adafactor_ref, get_optimizer, warmup_cosine
from repro_torch.runtime import make_train_step

TOL = dict(rtol=1e-6, atol=1e-9)
PARAM_TOL = dict(rtol=1e-6, atol=1e-6)
BF16_TOL = dict(rtol=2 ** -7, atol=1e-6)
STEP_TOL = dict(rtol=1e-5, atol=1e-5)
SHAPES = {"stack": (3, 16, 24), "norm": (3, 24), "w": (40, 24), "b": (24,)}
LRS = (1e-2, 3e-2, 2e-2)
REDUCED = dict(d_model=256, d_ff=256, vocab=128)


def _tree(seed):
    """{"segments": [{"stack", "norm"}], "w", "b"} of float32 numpy leaves."""
    rng = np.random.default_rng(seed)
    leaf = {k: rng.normal(0, 1, s).astype(np.float32) for k, s in SHAPES.items()}
    return {"segments": [{"stack": leaf["stack"], "norm": leaf["norm"]}],
            "w": leaf["w"], "b": leaf["b"]}


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map(fn, v) for v in tree]
    return fn(tree)


def _torch_tree(tree, dtype):
    return _map(lambda a: torch.tensor(a).to(dtype), tree)


def _jax_tree(tree, dtype):
    return _map(lambda a: jnp.asarray(a).astype(dtype), tree)


def _as_f32(x):
    return torch.from_numpy(np.array(jnp.asarray(x, jnp.float32)))


def _assert_close(got, want, what, **tol):
    """Port leaves (tensors) against JAX leaves in tree order."""
    got, want = tree_leaves(got), jax.tree.leaves(want)
    assert len(got) == len(want) > 0
    for i, (g, w) in enumerate(zip(got, want)):
        torch.testing.assert_close(g.float(), _as_f32(w), **tol,
                                   msg=lambda m: f"{what} leaf {i}: {m}")


@pytest.mark.parametrize("weight_decay", [0.0, 0.1])
@pytest.mark.parametrize("clip", [1.0, 1e3])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_updates_match_jax(dtype, clip, weight_decay):
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    kw = dict(clip_threshold=clip, weight_decay=weight_decay)
    jopt, topt = jax_adafactor(**kw), adafactor(**kw)
    jparams, tparams = _jax_tree(_tree(0), jdt), _torch_tree(_tree(0), tdt)
    jstate, tstate = jopt.init(jparams), topt.init(tparams)
    assert ("master" in tstate) == ("master" in jstate) == (dtype == "bfloat16")
    for i, lr in enumerate(LRS):
        g = _tree(1 + i)
        before = tparams["w"].float().clone()
        jparams, jstate = jopt.update(_jax_tree(g, jdt), jstate, jparams, i, lr)
        out, tstate = topt.update(_torch_tree(g, tdt), tstate, tparams, i, lr)
        assert out is tparams                            # updated in place
        _assert_close(tstate["f"], jstate["f"], f"update {i} factors", **TOL)
        if dtype == "bfloat16":
            _assert_close(tstate["master"], jstate["master"],
                          f"update {i} master", **PARAM_TOL)
        _assert_close(tparams, jparams, f"update {i} params",
                      **(PARAM_TOL if dtype == "float32" else BF16_TOL))
        if i == 0 and dtype == "float32" and not weight_decay:
            # the first update's u has an RMS of ~10 (vr, vc are 1 % of
            # g²): clipped to 1 at clip 1.0, left as it is at 1e3
            step_rms = float((tparams["w"] - before).square().mean().sqrt()) / lr
            assert (abs(step_rms - 1.0) < 1e-3 if clip == 1.0 else step_rms > 5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_sliced_update_matches_the_plain_version(dtype):
    """Identical copies through ``adafactor`` (matrix by matrix, two
    passes) and ``adafactor_ref`` (whole leaves): parameters, masters and
    factors after 3 updates within the tolerances above (the RMS sums in
    another order)."""
    out = []
    for opt in (adafactor(weight_decay=0.1), adafactor_ref(weight_decay=0.1)):
        params = _torch_tree(_tree(0), dtype)
        state = opt.init(params)
        for i, lr in enumerate(LRS):
            opt.update(_torch_tree(_tree(1 + i), dtype), state, params, i, lr)
        out.append((params, state))
    (p, s), (p_ref, s_ref) = out
    for a, b in zip(tree_leaves(s["f"]), tree_leaves(s_ref["f"])):
        torch.testing.assert_close(a, b, **TOL)
    for a, b in zip(tree_leaves(s.get("master", [])),
                    tree_leaves(s_ref.get("master", []))):
        torch.testing.assert_close(a, b, **PARAM_TOL)
    for a, b in zip(tree_leaves(p), tree_leaves(p_ref)):
        torch.testing.assert_close(a.float(), b.float(), **(
            PARAM_TOL if dtype == torch.float32 else BF16_TOL))


def test_factor_layout_is_jax():
    """``vr`` drops the last axis, ``vc`` the second-to-last; a stacked
    (L, d) leaf is factored across its layers; a 1-D leaf keeps ``v``."""
    state = adafactor().init(_torch_tree(_tree(0), torch.float32))
    jstate = jax_adafactor().init(_jax_tree(_tree(0), jnp.float32))
    shapes = [tuple(x.shape) for x in tree_leaves(state["f"])]
    assert shapes == [tuple(x.shape) for x in jax.tree.leaves(jstate["f"])]
    seg = state["f"]["segments"][0]
    assert seg["stack"]["vr"].shape == (3, 16) and seg["stack"]["vc"].shape == (3, 24)
    assert seg["norm"]["vr"].shape == (3,) and seg["norm"]["vc"].shape == (24,)
    assert set(state["f"]["b"]) == {"v"}
    assert get_optimizer("adafactor") is adafactor


@pytest.mark.parametrize("arch", ["falcon-mamba-7b", "grok-1-314b"])
def test_three_train_steps_match_jax(arch):
    """``make_train_step`` with Adafactor (grok-1's own optimizer; falcon
    trains with it on the card at full depth) against JAX's: the loss,
    gradient norm and lr of each step, the parameters and the factors."""
    jcfg = jax_get_config(arch).reduced(**REDUCED).replace(n_kv_heads=2)
    tcfg = get_config(arch).reduced(**REDUCED).replace(n_kv_heads=2)
    jmodel = JaxModel(jcfg)
    jopt = jax_adafactor()
    lr = dict(peak_lr=1e-3, warmup_steps=1, total_steps=3)
    jstate = jax_init_train_state(jmodel, jopt, jax.random.PRNGKey(1))
    jstep = jax.jit(jax_make_train_step(jmodel, jopt, jax_warmup_cosine(**lr)))
    model = Model(tcfg.replace(attention_impl="reference"), device="cpu")
    tstate = train_state_from_jax(jax.tree.map(np.asarray, jstate), device="cpu")
    tstep = make_train_step(model, adafactor(), warmup_cosine(**lr))
    for i in range(3):
        toks = np.random.default_rng(10 + i).integers(0, REDUCED["vocab"], (2, 65))
        batch = {"tokens": toks[:, :-1].astype(np.int32),
                 "labels": toks[:, 1:].astype(np.int32)}
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
        tstate, tm = tstep(tstate, {k: torch.from_numpy(v)
                                    for k, v in batch.items()})
        for k in ("loss", "grad_norm", "lr"):
            torch.testing.assert_close(tm[k].detach(), torch.tensor(float(jm[k])),
                                       **STEP_TOL, msg=lambda m: f"step {i} {k}: {m}")
    assert int(tstate["step"]) == int(jstate["step"]) == 3
    _assert_close([p.detach() for p in tree_leaves(tstate["params"])],
                  jax.tree.leaves(jstate["params"]), "params", rtol=0, atol=1e-5)
    _assert_close(tstate["opt"]["f"], jstate["opt"]["f"], "factors",
                  rtol=1e-4, atol=1e-9)
