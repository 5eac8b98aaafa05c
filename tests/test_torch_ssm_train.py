"""Training the port's ``ssm`` and ``hybrid_swa``/``hybrid_full`` kinds
against the JAX package, at reduced falcon-mamba-7b and hymba-1.5b.

``mamba.SelectiveScan`` (the chunk-checkpointed scan, the counterpart of
``jax.checkpoint`` on each chunk of JAX's ``mamba_forward``) against
autograd through ``mamba.selective_scan_ref`` (the same loop), for every
gradient, and the memory it keeps; ``Model.loss`` and its gradient per
leaf against ``jax.value_and_grad(Model.loss)`` with the reference and the
interpret-mode Pallas attention; remat on and off; three AdamW train steps
against JAX's ``make_train_step``. ``launch.train`` on these archs is
tested in ``tests/test_torch_hybrid.py``.

Configuration: ``reduced(d_model=256, d_ff=256, vocab=128)`` with 2 kv
heads (the size of ``tests/test_torch_hybrid.py``): d_inner 512, state 8,
chunk 64, hymba's window 32, float32. S = 128 is two scan chunks, and
hymba's window masks.

Tolerances. The scan's output is the same loop on both sides, so it is
compared bit for bit; its gradients sum in another order (whole-chunk
products against autograd's step by step), observed ≤ 3e-7 of the
largest entry, held to rtol/atol 1e-5. The loss and gradients against JAX
at ``LOSS_TOL``/``GRAD_TOL`` of ``tests/test_torch_train.py`` (1e-5), and
the train steps at its bars, except the parameters that AdamW's
normalisation makes sensitive (``_assert_params_close``).
"""
import torch_threads  # noqa: F401  (caps torch's threads a worker)
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
from repro_torch.checkpoint.checkpoint import _paths
from repro_torch.configs import get_config
from repro_torch.models import Model, mamba, params_from_jax, train_state_from_jax
from repro_torch.models.common import tree_leaves
from repro_torch.optim import adamw, warmup_cosine
from repro_torch.runtime import make_train_step

LOSS_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-5, atol=1e-5)
SCAN_TOL = dict(rtol=1e-5, atol=1e-5)
REDUCED = dict(d_model=256, d_ff=256, vocab=128)
ARCHS = ["falcon-mamba-7b", "hymba-1.5b"]
SCAN_B, SCAN_S, SCAN_DI, SCAN_N = 2, 128, 48, 8


def _cfgs(arch):
    jcfg = jax_get_config(arch).reduced(**REDUCED).replace(n_kv_heads=2)
    tcfg = get_config(arch).reduced(**REDUCED).replace(n_kv_heads=2)
    return jcfg, tcfg


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    """(jax cfg, jax params, port cfg) of a reduced arch."""
    jcfg, tcfg = _cfgs(request.param)
    return jcfg, JaxModel(jcfg).init(jax.random.PRNGKey(0)), tcfg


def _batch(seed, B, S, vocab=REDUCED["vocab"]):
    toks = np.random.default_rng(seed).integers(0, vocab, (B, S + 1))
    return {"tokens": toks[:, :-1].astype(np.int32),
            "labels": toks[:, 1:].astype(np.int32)}


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _loss_and_grads(model, params, batch):
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    loss = model.loss(params, {k: torch.from_numpy(v) for k, v in batch.items()})
    return loss, torch.autograd.grad(loss, leaves)


def _assert_tree_close(got, want, msg="", **tol):
    """Port leaves (tensors) against JAX leaves (numpy) in tree order."""
    got, want = tree_leaves(got), jax.tree.leaves(want)
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        torch.testing.assert_close(
            g.detach().float(), torch.from_numpy(np.asarray(w, np.float32)),
            **tol, msg=lambda m: f"{msg} leaf {i}: {m}")


# ---------------------------------------------------------------------------
# the scan Function against its plain version
# ---------------------------------------------------------------------------

def _scan_inputs(seed, with_h0, device="cpu"):
    """A (di, n) < 0, x, dt > 0, B, C, h0 and the output cotangent, from a
    seeded numpy stream."""
    rng = np.random.default_rng(seed)
    B, S, di, n = SCAN_B, SCAN_S, SCAN_DI, SCAN_N
    arrs = [-np.exp(rng.normal(0, 1, (di, n))),
            rng.normal(0, 1, (B, S, di)),
            np.log1p(np.exp(rng.normal(-2, 1, (B, S, di)))),
            rng.normal(0, 1, (B, S, n)),
            rng.normal(0, 1, (B, S, n)),
            rng.normal(0, 0.5, (B, di, n)),
            rng.normal(0, 1, (B, S, di))]
    t = [torch.tensor(a, dtype=torch.float32, device=device) for a in arrs]
    return t[:5], (t[5] if with_h0 else None), t[6]


def _scan_grads(fn, ins, h0, gy, chunk):
    leaves = [a.clone().requires_grad_(True) for a in ins]
    h = None if h0 is None else h0.clone().requires_grad_(True)
    y = fn(*leaves, chunk, h0=h)
    grads = torch.autograd.grad(y, leaves + ([h] if h is not None else []), gy)
    return y.detach(), grads


@pytest.mark.parametrize("with_h0", [False, True], ids=["h0_zero", "h0_given"])
@pytest.mark.parametrize("chunk", [1, 16, 64])
def test_selective_scan_matches_autograd_of_the_plain_loop(chunk, with_h0):
    ins, h0, gy = _scan_inputs(chunk, with_h0)
    y, grads = _scan_grads(mamba.selective_scan, ins, h0, gy, chunk)
    y_ref, grads_ref = _scan_grads(mamba.selective_scan_ref, ins, h0, gy, chunk)
    assert torch.equal(y, y_ref)
    names = ["A", "x", "dt", "B", "C", "h0"][:len(grads)]
    assert len(grads) == len(grads_ref) == 5 + with_h0
    for name, g, r in zip(names, grads, grads_ref):
        assert g.shape == r.shape and bool(r.abs().max() > 0), name
        torch.testing.assert_close(g, r, **SCAN_TOL, msg=lambda m: f"{name}: {m}")


@pytest.mark.parametrize("fn", [mamba.selective_scan, mamba.selective_scan_ref],
                         ids=["function", "plain"])
def test_scan_refuses_a_ragged_chunk(fn):
    """JAX asserts S % chunk == 0; both versions raise."""
    ins, _, _ = _scan_inputs(0, False)
    with pytest.raises(ValueError, match="multiple of the scan chunk"):
        fn(*ins, 48)


def _saved_storages(fn, ins, chunk):
    """The tensors the autograd graph of ``fn`` keeps: (largest element
    count of one saved tensor, elements over the distinct storages)."""
    leaves = [a.clone().requires_grad_(True) for a in ins]
    storages, largest = {}, 0

    def pack(t):
        nonlocal largest
        largest = max(largest, t.numel())
        st = t.untyped_storage()
        storages[st.data_ptr()] = st.nbytes() // t.element_size()
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        y = fn(*leaves, chunk)
    del y
    return largest, sum(storages.values())


@pytest.mark.parametrize("chunk", [16, 64])
def test_scan_function_keeps_only_chunk_boundary_states(chunk):
    """The Function saves its inputs and one (B, d_inner, n) state a chunk:
    no saved tensor has S·B·d_inner·n elements, and all it keeps is less
    than one state a step, which autograd through the loop keeps."""
    ins, _, _ = _scan_inputs(1, False)
    B, S, di, n = SCAN_B, SCAN_S, SCAN_DI, SCAN_N
    per_step = S * B * di * n
    largest, total = _saved_storages(mamba.selective_scan, ins, chunk)
    inputs = sum(a.numel() for a in ins)
    assert largest == max((S // chunk) * B * di * n, B * S * di)
    assert largest < per_step
    assert total == inputs + (S // chunk) * B * di * n < per_step
    _, total_ref = _saved_storages(mamba.selective_scan_ref, ins, chunk)
    assert total_ref >= per_step


# ---------------------------------------------------------------------------
# Model.loss and its gradients against JAX
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("impl", ["reference", "interpret"])
def test_loss_and_grads_match_jax(pair, impl):
    """``Model.loss`` and its gradient per leaf on 2 × 128 tokens (two scan
    chunks): JAX ``reference`` against the port's ``reference``, and the
    JAX Pallas kernels in interpret mode against the port's kernel
    dispatch (the flash Function's plain versions on the CPU)."""
    jcfg, jparams, tcfg = pair
    batch = _batch(7, 2, 128)
    jl, jg = jax.value_and_grad(JaxModel(jcfg.replace(attention_impl=impl)).loss)(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    timpl = "reference" if impl == "reference" else "kernel"
    model = Model(tcfg.replace(attention_impl=timpl), device="cpu")
    loss, grads = _loss_and_grads(model, params_from_jax(_np(jparams), "cpu"),
                                  batch)
    torch.testing.assert_close(loss.detach(), torch.tensor(float(jl)), **LOSS_TOL)
    _assert_tree_close(list(grads), _np(jg), "grad", **GRAD_TOL)


def _scan_nodes(loss):
    """The ``SelectiveScan`` nodes of a loss's autograd graph."""
    seen, stack, found = set(), [loss.grad_fn], 0
    while stack:
        node = stack.pop()
        if node is None or node in seen:
            continue
        seen.add(node)
        found += type(node).__name__ == "SelectiveScanBackward"
        stack.extend(n for n, _ in node.next_functions)
    return found


def test_remat_gives_the_same_gradients(pair):
    """Per-layer remat recomputes each layer's forward (the scan's included)
    in the same order: the gradients are bit-identical, except the
    embedding's, whose backward sums a token's repeated rows in an order
    that depends on the CPU's threads (two runs without remat differ too;
    within rtol 1e-6 / atol 1e-7, observed 7.5e-9 on entries up to 0.08,
    one float32 step). Without remat the loss's graph holds one
    ``SelectiveScan`` node a Mamba layer."""
    _, jparams, tcfg = pair
    batch = _batch(3, 2, 128)
    out = []
    for remat in (True, False):
        model = Model(tcfg.replace(remat=remat), device="cpu")
        params = params_from_jax(_np(jparams), device="cpu")
        out.append(_loss_and_grads(model, params, batch))
    assert _scan_nodes(out[1][0]) == tcfg.n_layers
    assert torch.equal(out[0][0], out[1][0])
    for name, a, b in zip(_paths(params), out[0][1], out[1][1]):
        if name == "['embed']":
            torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)
        else:
            assert torch.equal(a, b), name


def _assert_params_close(got, want, v, total_lr):
    """Parameters after AdamW steps: within atol 1e-5 of JAX's, except
    entries whose second moment v is below 1e-12 (gradients below ~1e-6):
    there √v is within ~100× AdamW's eps, so a gradient difference far
    inside ``GRAD_TOL`` changes the normalised update m/(√v + eps) by tens
    of % (observed: an embedding entry with gradient 5e-8, 2.7e-5 apart
    after three steps); those are held to twice the steps' summed learning
    rate, the most two updates of |m/√v| ≲ 1 can part."""
    got, want, v = tree_leaves(got), jax.tree.leaves(want), jax.tree.leaves(v)
    assert len(got) == len(want) == len(v)
    for i, (g, w, vv) in enumerate(zip(got, want, v)):
        g, w = g.detach().float(), torch.from_numpy(np.asarray(w, np.float32))
        tiny = torch.from_numpy(np.asarray(vv) < 1e-12)
        torch.testing.assert_close(g[~tiny], w[~tiny], rtol=0, atol=1e-5,
                                   msg=lambda m: f"params leaf {i}: {m}")
        assert bool(((g - w).abs()[tiny] <= 2 * total_lr).all()), i


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
        batch = _batch(10 + i, 2, 64)
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
        tstate, tm = tstep(tstate, {k: torch.from_numpy(v) for k, v in batch.items()})
        for k in ("loss", "grad_norm", "lr"):
            torch.testing.assert_close(tm[k].detach(), torch.tensor(float(jm[k])),
                                       **LOSS_TOL, msg=lambda m: f"step {i} {k}: {m}")
    assert int(tstate["step"]) == int(jstate["step"]) == 3
    total_lr = sum(float(jax_warmup_cosine(**lr)(s)) for s in range(3))
    _assert_params_close(tstate["params"], _np(jstate["params"]),
                         _np(jstate["opt"]["v"]), total_lr)
    _assert_tree_close(tstate["opt"]["m"], _np(jstate["opt"]["m"]), "m",
                       rtol=1e-4, atol=1e-7)


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
def test_scan_function_matches_plain_on_card(cuda_device):
    """The Function against autograd of the plain loop on the card, chunk
    16, with an initial state: the output equal, gradients within 1e-4
    (the card's float32 sums in other orders than the CPU's)."""
    ins, h0, gy = _scan_inputs(5, True, device=cuda_device)
    y, grads = _scan_grads(mamba.selective_scan, ins, h0, gy, 16)
    y_ref, grads_ref = _scan_grads(mamba.selective_scan_ref, ins, h0, gy, 16)
    torch.cuda.synchronize()
    assert torch.equal(y, y_ref)
    for g, r in zip(grads, grads_ref):
        torch.testing.assert_close(g, r, rtol=1e-4, atol=1e-4)
