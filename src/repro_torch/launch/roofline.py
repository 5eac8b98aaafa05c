"""Roofline terms and model FLOPs on one card.

The port of the JAX package's ``launch/roofline.py``, its plain-arithmetic
half: the ``Roofline`` record and its ``finalize``,
    compute    = FLOPs per device / peak FLOP/s,
    memory     = HBM bytes per device / HBM bytes/s,
    collective = collective bytes per device / link bytes/s,
``count_params`` (total and active parameters of a parameter tree) and
``model_flops_for`` (6·N·D training, 2·N·D prefill, 2·N·B decode).

The constants are the card's, not the TPU v5e's of the JAX package's
``launch/mesh.py``: NVIDIA H100 80GB HBM3 (SXM) at 700.00 W as
``nvidia-smi --query-gpu=name,power.limit`` reports it, from NVIDIA's data
sheet: the dense bf16 tensor-core peak, the HBM3 bandwidth, and the NVLink
4 bandwidth of one direction (900 GB/s both ways) in place of the TPU's
ICI link. A card set below 700 W runs slower than these peaks.

``sharded_bytes`` is one device's bytes of a tree placed by specs
(``runtime/sharding.py``).

``analyze_step`` is the counterpart of JAX's ``analyze_compiled``. The
port has no compiled artifact: it runs the step once on ``meta`` tensors
(at one card's local shapes) under three counters and returns the same
keys. FLOPs are ``torch.utils.flop_counter.FlopCounterMode``'s (the
products; elementwise ops count nothing, as in XLA's tally of dots) plus
each hand-written kernel's own count, which its ``meta`` branch reports
(``kernels.ops.flash_counts``). HBM bytes are the bytes of every aten
op's tensor inputs and outputs (views and uninitialised allocations move
none), plus each kernel's own bytes: what the eager port moves, op by op,
with no fusion, so it is not XLA's "bytes accessed" after fusion and
stands above it. Memory is a tracker of every storage the run creates,
freed when the storage dies: the peak of live bytes, the inputs' bytes
(``argument_bytes``), the result's (``output_bytes``), the result's bytes
that are inputs updated in place (``alias_bytes``, XLA's donation) and
the rest of the peak (``temp_bytes``).

``collective_bytes`` is JAX's per-kind tally in JAX's convention: the
result bytes of each collective on one device, an async pair once. The
port has no HLO to parse; it sums the collectives one step needs, from
two sources. Where the port issues a collective itself, the call reports
it (``utils.costs``): ``compressed_grad_sum``'s int8 all-gather,
``pipeline_apply``'s sends (``collective-permute``) and its closing
broadcast (an ``all-reduce``, JAX's masked ``psum``), and
``distributed_pair_scores``' sum over ``pod`` (two all-reduces of the
(S/data × S/model) float32 blocks). For an LM step, data and tensor
parallelism are the placements' arithmetic (``placement_collectives``,
from ``runtime.sharding``'s specs): per layer and micro-batch, each
parameter sharded over ``data`` is all-gathered (its model shard), once
in the forward and again in a training step under remat; in training its
gradient is reduce-scattered over ``data`` (the result is its shard) and
then all-reduced over ``pod``, and a parameter not sharded over ``data``
has its gradient all-reduced over the batch axes; each product whose
contracted dim is sharded over ``model`` (row-parallel: ``wo``, ``wd``,
``w2``, ``out_proj``, ``x_proj``) ends in an all-reduce of its output,
in the forward, again under remat, and once in the backward (at the
column-parallel product that feeds it, Megatron's conjugate). Axes of
size 1 move nothing. The port runs no tensor-parallel forward yet, so
this half is arithmetic on the placements, not a count of calls.
"""
from __future__ import annotations

import weakref
from dataclasses import asdict, dataclass

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro_torch.models.common import tree_map
from repro_torch.utils.costs import recording

#: JAX's collective kinds (HLO op names), in its order.
COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")

# NVIDIA H100 80GB HBM3 (SXM), 700.00 W: roofline constants per card
PEAK_FLOPS_BF16 = 989e12          # FLOP/s, dense bf16 tensor cores
HBM_BW = 3.35e12                  # bytes/s
NVLINK_BW = 450e9                 # bytes/s, one direction


@dataclass
class Roofline:
    flops_per_device: float
    hbm_bytes_per_device: float
    collective_bytes_per_device: float
    compute_s: float = 0.0
    memory_s: float = 0.0
    collective_s: float = 0.0
    bottleneck: str = ""
    model_flops: float = 0.0          # 6·N_active·D (train) / 2·N_active·D
    useful_flops_ratio: float = 0.0   # MODEL_FLOPS / (chips · FLOPs)

    def finalize(self, chips: int):
        self.compute_s = self.flops_per_device / PEAK_FLOPS_BF16
        self.memory_s = self.hbm_bytes_per_device / HBM_BW
        self.collective_s = self.collective_bytes_per_device / NVLINK_BW
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        self.bottleneck = max(terms, key=terms.get)
        if self.model_flops:
            self.useful_flops_ratio = self.model_flops / max(
                self.flops_per_device * chips, 1.0)
        return self


def collective_bytes(calls=()) -> dict:
    """Per-kind result bytes of ``calls``, each ``(kind, bytes)`` or
    ``(kind, bytes, count)`` (``count`` calls of that many bytes each):
    JAX's ``{"bytes", "counts", "total_bytes"}``. The rule that gives an
    LM step's calls is in the module docstring."""
    per_kind = {k: 0 for k in COLLECTIVES}
    counts = {k: 0 for k in COLLECTIVES}
    for call in calls:
        kind, nbytes = call[0], call[1]
        n = call[2] if len(call) > 2 else 1
        if kind not in per_kind:
            raise ValueError(f"unknown collective {kind!r}; JAX's kinds are "
                             f"{COLLECTIVES}")
        per_kind[kind] += int(nbytes) * int(n)
        counts[kind] += int(n)
    return {"bytes": per_kind, "counts": counts,
            "total_bytes": sum(per_kind.values())}


# the leading dims of a weight leaf that a product contracts, after its
# batch dims (``layer``, ``experts``); leaves not named here enter no
# product (norms, biases, the conv, A, D, the embedding's lookup)
_CONTRACTED = {"wq": 1, "wk": 1, "wv": 1, "wo": 2, "wg": 1, "wu": 1,
               "wd": 1, "w1": 1, "w2": 1, "router": 1, "in_proj": 1,
               "x_proj": 1, "dt_proj": 1, "out_proj": 1}
_BATCH_DIMS = ("layer", "experts")


def placement_collectives(params, dims, mesh, *, tokens: int, itemsize: int,
                          train: bool = False, remat: bool = False,
                          expert_tokens: int = 0) -> list:
    """The collectives that ``runtime.sharding``'s placements imply for one
    layer's (or the head's) parameters ``params`` (shaped leaves at their
    full size) with logical ``dims``, over ``tokens`` rows of activations
    a device (``expert_tokens``: the rows an expert leaf's products take,
    summed over experts) in the compute dtype's ``itemsize``: a list of
    ``collective_bytes`` calls, by the rule of the module docstring."""
    from repro_torch.runtime.sharding import mesh_axes, spec_for

    axes = mesh_axes(mesh)
    n_data, n_model = axes.get("data", 1), axes.get("model", 1)
    n_pod = axes.get("pod", 1)
    calls = []

    def leaf(keys, p, d):
        spec = spec_for(d, tuple(p.shape), mesh, "param")
        named = [e for e in spec if e is not None]
        model_dim = next((i for i, e in enumerate(spec) if e == "model"), None)
        local = p.numel() * p.element_size() // (n_model if model_dim
                                                  is not None else 1)
        if "data" in named and n_data > 1:
            calls.append(("all-gather", local, 2 if train and remat else 1))
            if train:
                calls.append(("reduce-scatter", local // n_data))
                if n_pod > 1:
                    calls.append(("all-reduce", local // n_data))
        elif train and n_data * n_pod > 1:
            calls.append(("all-reduce", local))
        name = keys[-1] if keys else ""
        if name not in _CONTRACTED or model_dim is None or n_model == 1:
            return
        lead = sum(1 for x in d if x in _BATCH_DIMS)
        if not lead <= model_dim < lead + _CONTRACTED[name]:
            return                                   # column-parallel
        out = 1
        for s in p.shape[lead + _CONTRACTED[name]:]:
            out *= int(s)
        rows = expert_tokens if "experts" in d else tokens
        calls.append(("all-reduce", rows * out * itemsize,
                      (3 if remat else 2) if train else 1))

    def walk(p, d, keys):
        if isinstance(p, dict):
            for k in sorted(p):
                walk(p[k], d[k], keys + (k,))
        elif isinstance(p, (list, tuple)):
            for a, b in zip(p, d):
                walk(a, b, keys)
        else:
            leaf(keys, p, d)

    walk(params, dims, ())
    return calls


class StepCounter(TorchDispatchMode):
    """Counts a run's HBM bytes (every aten op's tensor inputs and outputs,
    views and uninitialised allocations excepted) and tracks its storages'
    live bytes and peak. A storage is keyed by its Python object, which
    PyTorch keeps for as long as the storage lives, and is taken off the
    live bytes when that object dies; ``track`` registers the inputs
    before the run."""

    _FREE = {"aten::empty", "aten::empty_strided", "aten::empty_like",
             "aten::new_empty", "aten::new_empty_strided"}

    def __init__(self):
        super().__init__()
        self.hbm_bytes = 0
        self.kernel_flops = 0.0
        self.collectives = []
        self.live = 0
        self.peak = 0
        self._storages = {}

    def track(self, tree) -> int:
        """Register every tensor of ``tree``; the bytes of the storages new
        to the tracker."""
        added = 0
        for t in tree_flatten(tree)[0]:
            if isinstance(t, torch.Tensor):
                added += self._track(t)
        return added

    def storage_bytes(self, tree) -> int:
        """Bytes of the distinct storages of ``tree``'s tensors."""
        seen = {}
        for t in tree_flatten(tree)[0]:
            if isinstance(t, torch.Tensor):
                st = t.untyped_storage()
                seen[id(st)] = st.nbytes()
        return sum(seen.values())

    def _track(self, t) -> int:
        st = t.untyped_storage()
        key = id(st)
        if key in self._storages:
            return 0
        n = st.nbytes()

        def gone(_ref, key=key, n=n):
            self.live -= n
            self._storages.pop(key, None)

        self._storages[key] = weakref.ref(st, gone)
        self.live += n
        self.peak = max(self.peak, self.live)
        return n

    def kernel(self, name, operations, nbytes):
        self.kernel_flops += operations
        self.hbm_bytes += nbytes

    def collective(self, kind, nbytes):
        self.collectives.append((kind, nbytes))

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        outs = _tensors((out,))
        if not func.is_view and func._schema.name not in self._FREE:
            self.hbm_bytes += sum(t.numel() * t.element_size() for t in
                                  _tensors(args) + _tensors(kwargs.values())
                                  + outs)
        for t in outs:
            self._track(t)
        return out


def _tensors(values) -> list:
    """The tensors among an aten op's arguments or results: each a tensor,
    or a list or tuple of them (``Tensor[]``)."""
    out = []
    for v in values:
        if isinstance(v, torch.Tensor):
            out.append(v)
        elif isinstance(v, (list, tuple)):
            out.extend(t for t in v if isinstance(t, torch.Tensor))
    return out


def analyze_step(fn, *meta_args, chips: int, model_flops: float = 0.0,
                 collectives=(), count_flops: bool = True) -> dict:
    """Run ``fn(*meta_args)`` once on ``meta`` tensors under the counters
    (module docstring) and return ``analyze_compiled``'s keys: the
    ``Roofline`` fields, ``collectives`` (``collective_bytes`` of the
    calls the run reported and of ``collectives``) and ``memory``. Also
    ``"result"``: what ``fn`` returned. Nothing is allocated on a device:
    every tensor must lie on ``meta``. ``count_flops=False`` leaves
    ``FlopCounterMode`` out (a quarter of a long run's dispatch) and
    reports 0 FLOPs: a run wanted for its memory alone."""
    from contextlib import nullcontext

    from torch.utils.flop_counter import FlopCounterMode

    for t in tree_flatten(meta_args)[0]:
        if isinstance(t, torch.Tensor) and t.device.type != "meta":
            raise ValueError(f"analyze_step takes meta tensors, got one on "
                             f"{t.device}")
    counter = StepCounter()
    arg_bytes = counter.track(meta_args)
    flops = FlopCounterMode(display=False) if count_flops else None
    with recording(counter), flops or nullcontext(), counter:
        result = fn(*meta_args)
    out_bytes = counter.storage_bytes(result)
    arg_ids = {id(t.untyped_storage()) for t in tree_flatten(meta_args)[0]
               if isinstance(t, torch.Tensor)}
    alias = {}
    for t in tree_flatten(result)[0]:
        if isinstance(t, torch.Tensor) and id(t.untyped_storage()) in arg_ids:
            st = t.untyped_storage()
            alias[id(st)] = st.nbytes()
    alias_bytes = sum(alias.values())
    coll = collective_bytes(list(counter.collectives) + list(collectives))
    rl = Roofline(
        flops_per_device=float(flops.get_total_flops() + counter.kernel_flops
                               if count_flops else 0.0),
        hbm_bytes_per_device=float(counter.hbm_bytes),
        collective_bytes_per_device=float(coll["total_bytes"]),
        model_flops=model_flops,
    ).finalize(chips)
    out = asdict(rl)
    out["collectives"] = coll
    temp = max(counter.peak - arg_bytes - (out_bytes - alias_bytes), 0)
    out["memory"] = {"argument_bytes": arg_bytes, "output_bytes": out_bytes,
                     "temp_bytes": temp, "peak_bytes": counter.peak,
                     "alias_bytes": alias_bytes,
                     "per_device_gb": (arg_bytes + temp) / 2**30}
    out["result"] = result
    return out


def _leaves_with_keys(tree, keys=()):
    """(dict keys on the path, leaf) for every leaf of a tree of dicts and
    lists; list positions add no key, as JAX's ``SequenceKey`` has none."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves_with_keys(tree[k], keys + (k,))
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves_with_keys(v, keys)
    else:
        yield keys, tree


def count_params(tree, active_expert_frac: float = 1.0,
                 expert_paths=("wg", "wu", "wd")) -> tuple[float, float]:
    """(total params, active params) of a parameter tree: tensors, or
    ``torch.empty(shape, device="meta")`` leaves (only ``.shape`` is read).

    Leaves reached under a 'moe' key have a leading expert dim; only
    top_k/E of them are active per token. ``embed`` and ``lm_head`` are
    left out of the active count (of 6·N·D).
    """
    total = active = 0.0
    for keys, leaf in _leaves_with_keys(tree):
        n = 1
        for s in leaf.shape:
            n *= s
        total += n
        if "moe" in keys and any(k in expert_paths for k in keys):
            active += n * active_expert_frac
        elif "embed" in keys or "lm_head" in keys:
            pass                                   # excluded from 6ND
        else:
            active += n
    return total, active


def sharded_bytes(shapes_tree, specs_tree, mesh) -> float:
    """Exact per-device bytes of a tree of shaped leaves (tensors, meta
    tensors, DTensors by their logical shape) placed by a tree of specs
    on ``mesh`` (anything ``runtime.sharding.mesh_axes`` reads)."""
    from repro_torch.runtime.sharding import mesh_axes

    axes = mesh_axes(mesh)
    total = 0.0

    def leaf(t, spec):
        nonlocal total
        shard = 1
        for entry in spec or ():
            if entry is None:
                continue
            for a in entry if isinstance(entry, tuple) else (entry,):
                shard *= axes[a]
        n = 1
        for s in t.shape:
            n *= int(s)
        total += n * t.dtype.itemsize / shard

    tree_map(leaf, shapes_tree, specs_tree)
    return float(total)


def model_flops_for(cfg, shape, total_params: float, active_params: float) -> float:
    """MODEL_FLOPS = 6·N·D (train) / 2·N·D (prefill) / 2·N·B (decode), for
    the port's ``ShapeConfig``."""
    if shape.kind == "train":
        return 6.0 * active_params * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * active_params * shape.global_batch * shape.seq_len
    return 2.0 * active_params * shape.global_batch          # decode: 1 token


__all__ = ["COLLECTIVES", "HBM_BW", "NVLINK_BW", "PEAK_FLOPS_BF16", "Roofline",
           "StepCounter", "analyze_step", "collective_bytes", "count_params",
           "model_flops_for", "placement_collectives", "sharded_bytes"]
