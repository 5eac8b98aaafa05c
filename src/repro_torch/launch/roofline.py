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
(``runtime/sharding.py``). Not ported: ``collective_bytes`` and
``analyze_compiled`` parse XLA's compiled HLO (ROADMAP A.8).
"""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch.models.common import tree_map

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


__all__ = ["HBM_BW", "NVLINK_BW", "PEAK_FLOPS_BF16", "Roofline",
           "count_params", "model_flops_for", "sharded_bytes"]
