"""Per-layer roofline probes on the ``meta`` device.

The port of the JAX package's ``launch/probes.py``. JAX probes one layer
of each block kind, the head and the optimizer update, because XLA's
``cost_analysis`` tallies a loop body once; the port's eager step has no
loop body to undercount, but the whole step the dry run runs for a cell's
peak is not the cell's work (at most two micro-batches, an Adafactor leaf
cut to two matrices, by depth fewer layers), and one layer of each kind
costs far less to dispatch (the Mamba kinds' scan at 32,768 steps, the
expert loop). So the cell's roofline terms come from the probes alone,
assembled as JAX assembles them, and that run counts memory only:

  train:   accum · [ Σ_kind count_k · block_k  +  head ]  +  optimizer
  prefill:            Σ_kind count_k · block_fwd_k + head_fwd
  decode:             Σ_kind count_k · block_dec_k + head_dec

Each probe runs the port's own code (``block_forward`` under remat as
``run_segment`` runs it, ``block_decode``, the loss or the prefill's last
position, the optimizer's ``update``) once on ``meta`` tensors through
``launch.roofline.analyze_step``, at one card's local shapes: its rows of
the batch (over ``("pod", "data")``, or ``data``, or every row where the
batch does not divide, as the act specs place them) and each weight at the
``model`` shard that ``runtime.sharding.spec_for`` gives it
(``local_config``: d_ff / 16, vocab / 16, heads / 16, or every head where
they do not divide, as gemma's 8 on a 16-way axis). A weight's ``data``
shard is gathered before it is used, so the products see its whole
``d_model``; the optimizer probe updates each leaf's full shard. A probe
returns (FLOPs, HBM bytes, collective bytes) a device; the collectives are
``placement_collectives``' arithmetic on the full layer's specs.

Attention runs as on the card (``impl="kernel"``): the flash kernels'
``meta`` branches report their operations and bytes and no S² logits
exist. The JAX probes switch to ``chunked_unroll`` from 8192 rows instead.
The train probe runs the block under ``torch.utils.checkpoint`` when the
config remats, so the recompute is counted (JAX's per-block ``jax.grad``
leaves it out). JAX's ``PROBE_UNROLL`` switch has no twin: the port's
expert loop already runs every expert on capacity-shaped, data-independent
buffers. The Mamba recurrence is added analytically, as in JAX: 10 FLOPs a
(token · d_inner_local · state), ×3 in training (FlopCounterMode counts no
elementwise op); its bytes are the port's real traffic and are counted.
The prefill head is the port's (the last position's logits), where JAX's
probe computes the whole sequence's loss.
"""
from __future__ import annotations

import math

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.launch.roofline import analyze_step, placement_collectives
from repro_torch.models.common import (
    DTYPES,
    MetaGenerator,
    cast_tree,
    make_rope,
    rms_norm,
    tree_leaves,
    tree_map,
)
from repro_torch.models.transformer import (
    SSM_KINDS,
    block_decode,
    block_dims,
    block_forward,
    init_block,
    init_segment_cache,
)
from repro_torch.runtime.sharding import mesh_axes, spec_for


def _batch_axes(mesh) -> tuple:
    return ("pod", "data") if "pod" in mesh_axes(mesh) else ("data",)


def batch_parallel(mesh) -> int:
    """Devices a batch row is spread over: the product of the batch axes."""
    axes = mesh_axes(mesh)
    return int(np.prod([axes[a] for a in _batch_axes(mesh)]))


def local_rows(mesh, rows: int, decode: bool = False) -> int:
    """One device's rows of ``rows``: train and prefill activations are
    placed ``(("pod", "data"), None, None)`` (JAX's ``_act_spec``), a
    decode step's by ``spec_for`` (a batch that divides no axis, as
    long_500k's 1, stays whole on every device)."""
    if not decode:
        return max(rows // batch_parallel(mesh), 1)
    axes = mesh_axes(mesh)
    spec = spec_for(("batch", "d0", "d1"), (rows, 0, 0), mesh, "act")
    entry = spec[0]
    for a in (entry if isinstance(entry, tuple) else (entry,)) if entry else ():
        rows //= axes[a]
    return rows


def local_config(cfg, mesh):
    """``cfg`` at one device's ``model`` shard: each width that
    ``spec_for`` shards over ``model`` divided by its size (heads,
    d_ff, vocab, d_inner), the others whole. Where q heads shard and kv
    heads do not (Llama's 8 on 16), a device keeps the kv heads its q
    heads read."""
    m = mesh_axes(mesh)["model"]
    hd = cfg.resolved_head_dim

    def shards(dims, sizes):
        return "model" in spec_for(dims, sizes, mesh, "param")

    D, H, KV = cfg.d_model, cfg.n_heads, cfg.n_kv_heads
    h_loc = H // m if shards(("d_model", "heads", "head_dim"), (D, H, hd)) else H
    if shards(("d_model", "kv_heads", "head_dim"), (D, KV, hd)):
        kv_loc = KV // m
    elif h_loc < H:
        kv_loc = max(h_loc // (H // KV), 1)
    else:
        kv_loc = KV
    di = cfg.resolved_d_inner
    F, V = cfg.d_ff, cfg.vocab_size
    return cfg.replace(
        n_heads=h_loc, n_kv_heads=kv_loc, head_dim=hd,
        d_ff=F // m if F and shards(("d_model", "d_ff"), (D, F)) else F,
        vocab_size=V // m if shards(("vocab", "d_model"), (V, D)) else V,
        d_inner=di // m if shards(("conv_k", "d_inner"), (cfg.conv_kernel, di))
        else di,
        dt_rank=cfg.resolved_dt_rank)


def _meta(shape, dtype, grad=False):
    return torch.empty(tuple(shape), dtype=dtype, device="meta",
                       requires_grad=grad)


def _layer(cfg, kind):
    """One layer's parameters of ``kind`` on meta, in the param dtype."""
    return cast_tree(init_block(MetaGenerator(), kind, cfg),
                     DTYPES[cfg.param_dtype])


def _terms(r) -> np.ndarray:
    return np.array([r["flops_per_device"], r["hbm_bytes_per_device"],
                     r["collective_bytes_per_device"]])


def _expert_tokens(cfg, rows: int, seq_len: int) -> int:
    """Rows an expert leaf's products take, summed over experts: E ×
    capacity slots of each routing row."""
    if not cfg.n_experts:
        return 0
    R, N = (rows, seq_len) if cfg.moe_routing != "global" else (1, rows * seq_len)
    cap = min(int(math.ceil(cfg.capacity_factor * cfg.top_k * N / cfg.n_experts)), N)
    return cfg.n_experts * R * cap


def _recurrence(cfg, lcfg, rows: int, seq_len: int, train: bool) -> float:
    return rows * seq_len * lcfg.resolved_d_inner * cfg.ssm_state * 10.0 * (
        3.0 if train else 1.0)


def probe_block(cfg, kind, mesh, rows, seq_len, *, train=True):
    """One layer of ``kind``: forward (and, ``train``, backward under remat)
    terms a device, for ``rows`` global rows of ``seq_len`` tokens."""
    lcfg = local_config(cfg, mesh)
    r = local_rows(mesh, rows)
    dt = DTYPES[cfg.dtype]
    params = _layer(lcfg, kind)
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(train)
    x = _meta((r, seq_len, cfg.d_model), dt, grad=train)
    cond = (_meta((r, cfg.cond_len, cfg.cond_dim), dt)
            if kind == "cross" else None)
    rope = make_rope(torch.arange(seq_len, device="meta"),
                     lcfg.resolved_head_dim, cfg.rope_theta)

    def fn(params, x, cond):
        if train and cfg.remat:
            y = checkpoint(block_forward, kind, params, x, rope, lcfg, cond,
                           use_reentrant=False)
        else:
            y = block_forward(kind, params, x, rope, lcfg, cond=cond)
        loss = torch.sum(y.to(torch.float32) ** 2)
        if train:
            return torch.autograd.grad(loss, leaves + [x])
        return loss

    calls = placement_collectives(
        _layer(cfg, kind), block_dims(kind, cfg), mesh, tokens=r * seq_len,
        itemsize=dt.itemsize, train=train, remat=cfg.remat,
        expert_tokens=_expert_tokens(cfg, r, seq_len))
    with torch.set_grad_enabled(train):
        t = _terms(analyze_step(fn, params, x, cond, chips=1,
                                collectives=calls))
    if kind in SSM_KINDS:
        t[0] += _recurrence(cfg, lcfg, r, seq_len, train)
    return t


def probe_block_decode(cfg, kind, mesh, batch, seq_len):
    """One layer of ``kind``: one decode step's terms a device, over a
    cache of ``seq_len`` positions, at the last of them."""
    lcfg = local_config(cfg, mesh)
    b = local_rows(mesh, batch, decode=True)
    dt = DTYPES[cfg.dtype]
    params = _layer(lcfg, kind)
    cache = tree_map(lambda c: c[0], init_segment_cache(
        kind, 1, lcfg, b, seq_len, dtype=dt, device="meta"))
    x = _meta((b, 1, cfg.d_model), dt)
    cond = (_meta((b, cfg.cond_len, cfg.cond_dim), dt)
            if kind == "cross" else None)

    def fn(params, cache, x, cond):
        return block_decode(kind, params, x, cache, seq_len - 1, lcfg,
                            cond=cond)

    calls = placement_collectives(
        _layer(cfg, kind), block_dims(kind, cfg), mesh, tokens=b,
        itemsize=dt.itemsize, expert_tokens=_expert_tokens(cfg, b, 1))
    with torch.no_grad():
        t = _terms(analyze_step(fn, params, cache, x, cond, chips=1,
                                collectives=calls))
    if kind in SSM_KINDS:
        t[0] += _recurrence(cfg, lcfg, b, 1, False)
    return t


def _head_params(cfg, lcfg, grad):
    """embed (V_loc, D), final_norm and the untied lm_head (D, V_loc)."""
    p = {"embed": _meta((lcfg.vocab_size, cfg.d_model), torch.float32, grad),
         "final_norm": _meta((cfg.d_model,), torch.float32, grad)}
    if not cfg.tie_embeddings:
        p["lm_head"] = _meta((cfg.d_model, lcfg.vocab_size), torch.float32,
                             grad)
    return p


def _head_calls(cfg, mesh, tokens, *, train, logits_rows=0):
    """The head's placement collectives, and where the vocab shards over
    ``model``: the lookup's all-reduce of (tokens, D) float32 rows; in
    training the loss's two all-reduces (max and sum of exp) of a float32
    a token and the backward's all-reduce of (tokens, D) float32; in
    serving the all-gather of the last position's (rows, V) logits."""
    full = _head_params(cfg, cfg, False)
    dims = {"embed": ("vocab", "d_model"), "final_norm": ("d_model",)}
    if "lm_head" in full:
        dims["lm_head"] = ("d_model", "vocab")
    calls = placement_collectives(full, dims, mesh, tokens=tokens,
                                  itemsize=4, train=train)
    m = mesh_axes(mesh)["model"]
    V, D = cfg.vocab_size, cfg.d_model
    if m > 1 and "model" in spec_for(("vocab", "d_model"), (V, D), mesh):
        calls.append(("all-reduce", tokens * D * 4))
        if train:
            calls += [("all-reduce", tokens * 4, 2),
                      ("all-reduce", tokens * D * 4)]
        else:
            calls.append(("all-gather", logits_rows * V * 4))
    return calls


def probe_head(cfg, mesh, rows, seq_len, *, train=True):
    """The embedding lookup, the final norm and the head: in training the
    loss (every position's float32 logits, logsumexp less the gold logit)
    and its gradients, in serving the prefill's last-position logits."""
    lcfg = local_config(cfg, mesh)
    r = local_rows(mesh, rows)
    dt = DTYPES[cfg.dtype]
    params = _head_params(cfg, lcfg, train)
    x_mid = _meta((r, seq_len, cfg.d_model), dt, grad=train)
    tokens = _meta((r, seq_len), torch.long)

    def head(p):
        return p["embed"].T if cfg.tie_embeddings else p["lm_head"]

    def fn(p, x_mid, tokens):
        x0 = p["embed"][tokens].to(dt)
        if train:
            x = rms_norm(x_mid + x0, p["final_norm"])
            logits = x.to(torch.float32) @ head(p).to(torch.float32)
            lse = torch.logsumexp(logits, dim=-1)
            gold = torch.gather(logits, -1, tokens[..., None])[..., 0]
            loss = torch.mean(lse - gold)
            return torch.autograd.grad(loss, tree_leaves(p) + [x_mid])
        x = rms_norm((x_mid + x0)[:, -1], p["final_norm"])
        return x.to(torch.float32) @ head(p).to(torch.float32)

    calls = _head_calls(cfg, mesh, r * seq_len, train=train, logits_rows=r)
    with torch.set_grad_enabled(train):
        return _terms(analyze_step(fn, params, x_mid, tokens, chips=1,
                                   collectives=calls))


def probe_head_decode(cfg, mesh, batch):
    """One decode step's lookup, final norm and logits."""
    lcfg = local_config(cfg, mesh)
    b = local_rows(mesh, batch, decode=True)
    dt = DTYPES[cfg.dtype]
    params = _head_params(cfg, lcfg, False)
    x = _meta((b, cfg.d_model), dt)
    tokens = _meta((b,), torch.long)

    def fn(p, x, tokens):
        h = p["embed"].T if cfg.tie_embeddings else p["lm_head"]
        y = rms_norm(x + p["embed"][tokens].to(dt), p["final_norm"])
        return y.to(torch.float32) @ h.to(torch.float32)

    calls = _head_calls(cfg, mesh, b, train=False, logits_rows=b)
    with torch.no_grad():
        return _terms(analyze_step(fn, params, x, tokens, chips=1,
                                   collectives=calls))


def shard_shapes(tree, specs, mesh):
    """Meta tensors of each leaf's shard: every dim divided by the sizes of
    the axes its spec entry names."""
    axes = mesh_axes(mesh)

    def leaf(t, spec):
        shape = list(t.shape)
        for i, entry in enumerate(spec or ()):
            for a in (entry if isinstance(entry, tuple) else (entry,)) \
                    if entry else ():
                shape[i] //= axes[a]
        return _meta(shape, t.dtype)

    return tree_map(leaf, tree, specs)


#: Adafactor updates a leaf of ≥ 3 dims one (m, n) matrix at a time; a
#: shapes-only run updates its first CUT_MATRICES matrices, whose ops and
#: temporaries stand for every other's (grok-1's stacked wq is 393,216
#: matrices of 3 × 128 at a model shard).
CUT_MATRICES = 2


def _cut(t, lead: int):
    """The first ``CUT_MATRICES`` entries of ``t``'s ``lead`` leading dims,
    flattened: a view."""
    return t.reshape((-1,) + tuple(t.shape[lead:]))[:CUT_MATRICES]


def leafwise_updates(opt_name: str, grads, state, params):
    """(update of one leaf, scale) for every parameter: callables that run
    the optimizer's ``update`` on that leaf alone (AdamW: one call on the
    whole tree, scale 1). An Adafactor leaf of more than ``CUT_MATRICES``
    matrices is cut to them (views of the same tensors), its scale the
    number of matrices over ``CUT_MATRICES``."""
    from repro_torch.optim import get_optimizer

    opt = get_optimizer(opt_name)()
    step = torch.zeros((), dtype=torch.int64, device=tree_leaves(params)[0].device)
    if opt_name != "adafactor":
        return [(lambda: opt.update(grads, state, params, step, 1e-4), 1.0)]
    from repro_torch.optim.adafactor import _leaves

    out = []
    for g, f, p, w in _leaves(grads, state, params):
        lead = p.dim() - 2
        n_mat = int(np.prod(p.shape[:lead])) if lead > 0 else 1
        if lead > 0 and n_mat > CUT_MATRICES:
            g, p, w = (_cut(t, lead) for t in (g, p, w))
            f = {"vr": _cut(f["vr"], lead), "vc": _cut(f["vc"], lead)}
            scale = n_mat / CUT_MATRICES
        else:
            scale = 1.0
        st = {"f": [f]} if w is p else {"f": [f], "master": [w]}
        out.append((lambda g=g, st=st, p=p: opt.update([g], st, [p], step,
                                                      1e-4), scale))
    return out


def probe_optimizer(cfg, mesh):
    """The optimizer's update of every parameter's shard, in place
    (``leafwise_updates``, each leaf's terms times its scale)."""
    from repro_torch.models.model import Model
    from repro_torch.optim import get_optimizer
    from repro_torch.runtime.sharding import tree_specs

    model = Model(cfg, device="meta")
    shapes = model.init()
    params = shard_shapes(shapes, tree_specs(shapes, model.param_dims(), mesh),
                          mesh)
    state = get_optimizer(cfg.optimizer)().init(params)
    grads = tree_map(lambda p: _meta(p.shape, p.dtype), params)
    total = np.zeros(3)
    with torch.no_grad():
        for update, scale in leafwise_updates(cfg.optimizer, grads, state,
                                              params):
            total += scale * _terms(analyze_step(update, chips=1))
    return total


def probe_cell_terms(cfg, shape, mesh, grad_accum: int = None) -> dict:
    """Assembled per-step (FLOPs, HBM bytes, collective bytes) a device."""
    dp = batch_parallel(mesh)
    kinds = {}
    total = np.zeros(3)
    if shape.kind == "train":
        accum = grad_accum or max(shape.global_batch // dp, 1)
        rows = shape.global_batch // accum
        for kind, count in cfg.plan:
            if kind not in kinds:
                kinds[kind] = probe_block(cfg, kind, mesh, rows, shape.seq_len,
                                          train=True)
            total += kinds[kind] * count
        total += probe_head(cfg, mesh, rows, shape.seq_len, train=True)
        total *= accum
        total += probe_optimizer(cfg, mesh)
    elif shape.kind == "prefill":
        rows = shape.global_batch
        for kind, count in cfg.plan:
            if kind not in kinds:
                kinds[kind] = probe_block(cfg, kind, mesh, rows, shape.seq_len,
                                          train=False)
            total += kinds[kind] * count
        total += probe_head(cfg, mesh, rows, shape.seq_len, train=False)
    else:  # decode
        B = shape.global_batch
        for kind, count in cfg.plan:
            if kind not in kinds:
                kinds[kind] = probe_block_decode(cfg, kind, mesh, B,
                                                 shape.seq_len)
            total += kinds[kind] * count
        total += probe_head_decode(cfg, mesh, B)
    return {
        "flops_per_device": float(total[0]),
        "hbm_bytes_per_device": float(total[1]),
        "collective_bytes_per_device": float(total[2]),
        "per_kind": {k: v.tolist() for k, v in kinds.items()},
    }


__all__ = ["batch_parallel", "local_config", "local_rows", "probe_block",
           "probe_block_decode", "probe_cell_terms", "probe_head",
           "probe_head_decode", "probe_optimizer", "leafwise_updates",
           "shard_shapes"]
