"""Sharding rules: logical dimension names → a spec → DTensor placements.

The port of the JAX package's ``runtime/sharding.py``. Every parameter and
cache leaf carries a tuple of logical dim names (the ``*_dims`` functions
of ``repro_torch.models``). ``spec_for`` assigns at most one dim of a leaf
to the ``model`` axis (tensor parallelism) and at most one to the ``data``
axis (FSDP or batch), with a strict divisibility check and a priority
order: gemma's 8 q-heads do not divide a 16-way ``model`` axis, so its
small attention weights replicate, and hymba's 32001-entry vocab
replicates. Activations' and caches' ``batch`` shards over ``("pod",
"data")`` on a mesh with a ``pod`` axis (``pod`` major), over ``data``
alone where the batch does not divide both.

A spec is a tuple with one entry a tensor dim: ``None``, an axis name, or
a tuple of axis names (JAX's ``PartitionSpec``, whose entries it lists).
A mesh is anything that names its axes and their sizes: a
``torch.distributed.device_mesh.DeviceMesh`` with ``mesh_dim_names``, the
port's ``core.distributed.Mesh`` or an ``AbstractMesh`` (shapes only,
for the rules at production size).
``placements`` is the counterpart of ``NamedSharding``: one ``Shard(i)``
a mesh axis that the spec assigns to tensor dim i, ``Replicate()`` for
every other; ``named`` maps it over a tree of specs, giving
``(DeviceMesh, placements)`` pairs that ``distribute_tensor`` and
``checkpoint.load_checkpoint(shardings=...)`` take.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

from repro_torch.models.common import is_dims, tree_map

# priority order for the tensor-parallel ('model') axis. Parameters never
# shard head_dim: a hd-sharded QK/PV contraction sums full logits across
# the axis every layer; odd-head archs (hymba 25 heads, gemma 8 on a
# 16-way axis) replicate their small attention weights instead.
MODEL_PRIORITY = ("d_ff", "heads", "kv_heads", "vocab", "d_inner", "d_inner2",
                  "dt_plus")
# activations and caches: kv heads first, then the cache's sequence dim (a
# seq-sharded KV cache turns decode attention into a sum of (B, H, 1)),
# head_dim as the last resort.
MODEL_PRIORITY_ACT = ("kv_heads", "d_inner", "d_inner2", "seq", "head_dim")
# priority order for the FSDP/data axis on parameters
DATA_PRIORITY_PARAM = ("d_model", "cond_dim")
# priority order for the data axis on activations and caches
DATA_PRIORITY_ACT = ("batch",)


class AbstractMesh:
    """Axis names and sizes without devices (JAX's ``AbstractMesh``): the
    rules at production size, e.g. ``AbstractMesh((16, 16), ("data",
    "model"))``."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str]):
        if len(shape) != len(axis_names):
            raise ValueError(f"mesh shape {tuple(shape)} and axes "
                             f"{tuple(axis_names)} differ in length")
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, (int(s) for s in shape)))


class NamedSharding(NamedTuple):
    """A leaf's placement on a mesh: the ``DeviceMesh`` and one placement
    a mesh dim, as ``distribute_tensor`` takes them."""

    mesh: object
    placements: tuple


def mesh_axes(mesh) -> dict:
    """``{axis name: size}`` of a mesh, in the mesh's axis order."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:                               # a DeviceMesh
        return dict(zip(names, (int(s) for s in mesh.shape)))
    return {a: int(mesh.shape[a]) for a in mesh.axis_names}


def _pick(dims: Sequence[str], sizes: Sequence[int], priority, axis_len,
          taken: set) -> Optional[int]:
    for want in priority:
        for pos, d in enumerate(dims):
            if d == want and pos not in taken and sizes[pos] % axis_len == 0:
                return pos
    return None


def spec_for(dims: Sequence[str], sizes: Sequence[int], mesh,
             kind: str = "param") -> tuple:
    """kind: 'param' (TP + FSDP) | 'act' (batch over pod+data, TP on model)."""
    axes = mesh_axes(mesh)
    has_pod = "pod" in axes
    model_len, data_len = axes["model"], axes["data"]
    assign: dict[int, object] = {}
    taken: set[int] = set()

    m_priority = MODEL_PRIORITY if kind == "param" else MODEL_PRIORITY_ACT
    m = _pick(dims, sizes, m_priority, model_len, taken)
    if m is not None:
        assign[m] = "model"
        taken.add(m)

    if kind == "param":
        d = _pick(dims, sizes, DATA_PRIORITY_PARAM, data_len, taken)
        if d is not None:
            assign[d] = "data"
            taken.add(d)
    else:
        batch_len = data_len * (axes["pod"] if has_pod else 1)
        d = _pick(dims, sizes, DATA_PRIORITY_ACT, batch_len, taken)
        if d is not None:
            assign[d] = ("pod", "data") if has_pod else "data"
            taken.add(d)
        else:
            # batch not divisible by pod×data: try data alone (long_500k's
            # B = 1 stays replicated on the batch dim)
            d = _pick(dims, sizes, DATA_PRIORITY_ACT, data_len, taken)
            if d is not None:
                assign[d] = "data"
                taken.add(d)

    return tuple(assign.get(i) for i in range(len(dims)))


def tree_specs(tree_shapes, tree_dims, mesh, kind: str = "param"):
    """(tree of shaped leaves — tensors, meta tensors —, the dims tree
    beside it) → tree of specs: JAX's ``tree_specs`` and
    ``_dims_tree_specs``, which differ only in how JAX walks the trees."""
    return tree_map(lambda s, d: spec_for(d, tuple(s.shape), mesh, kind=kind),
                    tree_shapes, tree_dims)


def model_shardings(model, mesh, batch: int = 0, seq_len: int = 0):
    """(param specs, cache specs or None) for a ``Model``; the shapes come
    from the model's config on the ``meta`` device, so grok-1's take no
    memory."""
    from repro_torch.models.model import Model

    shapes = Model(model.cfg, device="meta")
    p_specs = tree_specs(shapes.init(0), model.param_dims(), mesh, "param")
    c_specs = None
    if batch:
        c_specs = tree_specs(shapes.init_cache(batch, seq_len),
                             model.cache_dims(), mesh, "act")
    return p_specs, c_specs


def batch_input_specs(specs: dict, mesh) -> dict:
    """Specs of ``Model.input_specs``' stand-ins: the leading dim is the
    batch."""
    out = {}
    for name, t in specs.items():
        ndim = len(t.shape)
        if ndim == 0:
            out[name] = ()
            continue
        dims = ("batch",) + ("seq",) * (ndim - 1)
        if name == "cond":
            dims = ("batch", "seq", "d_model_like")
        out[name] = spec_for(dims, tuple(t.shape), mesh, kind="act")
    return out


def placements(spec: tuple, mesh) -> tuple:
    """One placement a dim of ``mesh`` (a ``DeviceMesh``): ``Shard(i)``
    for a mesh axis the spec assigns to tensor dim i, ``Replicate()`` for
    every other. A tuple entry shards one tensor dim over several axes,
    the first major, so its axes must come in the mesh's order."""
    from torch.distributed.tensor import Replicate, Shard

    names = list(mesh_axes(mesh))
    out = [Replicate()] * len(names)
    for i, entry in enumerate(spec):
        if entry is None:
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        pos = [names.index(a) for a in axes]
        if pos != sorted(pos):
            raise ValueError(f"spec entry {entry} names its axes out of the "
                             f"mesh's order {tuple(names)}")
        for p in pos:
            out[p] = Shard(i)
    return tuple(out)


def named(tree_spec, mesh):
    """A tree of specs → a tree of ``NamedSharding(mesh, placements)``."""
    return tree_map(lambda s: NamedSharding(mesh, placements(s, mesh)),
                    tree_spec, is_leaf=is_dims)


__all__ = ["AbstractMesh", "DATA_PRIORITY_ACT", "DATA_PRIORITY_PARAM",
           "MODEL_PRIORITY", "MODEL_PRIORITY_ACT", "NamedSharding",
           "batch_input_specs", "mesh_axes", "model_shardings", "named",
           "placements", "spec_for", "tree_specs"]
