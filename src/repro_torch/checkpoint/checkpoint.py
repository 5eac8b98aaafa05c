"""Checkpointing: atomic, async-capable, keep-K, in the JAX package's format.

Format (the JAX package's ``checkpoint/checkpoint.py``): one
``step_<n:08d>/`` directory per checkpoint with
  * ``arrays.npz``    — the leaves as ``leaf_0``, ``leaf_1``, … in tree order
                        (dict keys sorted, list items in order);
  * ``manifest.json`` — step, the leaves' paths written as
                        ``jax.tree_util.keystr`` writes them (e.g.
                        ``['params']['embed']``, ``['params']['segments'][0]``),
                        shapes, dtypes and user metadata.
Writes go to ``step_<n>.tmp/`` and are renamed into place, so a failure
mid-save never corrupts the latest checkpoint. The port's flattener gives
the same paths in the same order, so a checkpoint the JAX package wrote
loads into the port.

bfloat16 leaves: numpy has no bfloat16 type of its own (the JAX package
writes them through ``ml_dtypes``, which the port does not need). The port
writes a bf16 leaf as its raw 16-bit patterns (``uint16``) with the dtype
``bfloat16`` in the manifest, and reads any leaf the manifest calls
``bfloat16`` by reinterpreting its two bytes per element, whatever numpy
type ``np.load`` gives them (``uint16``, a two-byte void, or
``ml_dtypes.bfloat16`` where that package is loaded).

Elastic restore, as in the JAX package: the saved arrays are logical
(unsharded). A tree of ``DTensor`` leaves is saved as each leaf's
``full_tensor()`` — every rank takes part in that gather, rank 0 alone
writes, and every rank waits for the write — in the same format, and
``load_checkpoint(..., shardings=...)`` places each leaf as a ``DTensor``
on the current mesh (``distribute_tensor``), so a checkpoint written by a
world of one size restores into a world of another.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Optional

import numpy as np
import torch

from repro_torch.models.common import tree_leaves, tree_map, tree_unflatten


def _is_dtensor(t) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(t, DTensor)


def _writes(leaves) -> bool:
    """False on ranks other than 0 where the tree holds ``DTensor``s."""
    import torch.distributed as dist

    return not (any(_is_dtensor(t) for t in leaves) and dist.is_initialized()
                and dist.get_rank() != 0)


def _barrier(leaves) -> None:
    """Every rank waits for rank 0's write of a ``DTensor`` tree."""
    import torch.distributed as dist

    if any(_is_dtensor(t) for t in leaves) and dist.is_initialized():
        dist.barrier()


def _paths(tree, prefix: str = "") -> list:
    """The leaves' paths in ``tree_leaves`` order, as ``keystr`` writes them."""
    if isinstance(tree, dict):
        return [p for k in sorted(tree) for p in _paths(tree[k], f"{prefix}[{k!r}]")]
    if isinstance(tree, (list, tuple)):
        return [p for i, v in enumerate(tree) for p in _paths(v, f"{prefix}[{i}]")]
    return [prefix]


def _host(t: torch.Tensor) -> tuple:
    """(numpy copy on the host, dtype name) of a leaf; a ``DTensor``'s
    logical array (a collective: every rank of its mesh calls it)."""
    if _is_dtensor(t):
        t = t.full_tensor()
    t = t.detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    return t.numpy(), str(t.numpy().dtype)


def _leaf(a: np.ndarray, dtype: str, like: torch.Tensor,
          device=None) -> torch.Tensor:
    """A stored array as a tensor of ``like``'s dtype on ``device``
    (default ``like``'s device)."""
    if dtype == "bfloat16":
        bits = np.ascontiguousarray(a).view(np.uint16).view(np.int16)
        t = torch.from_numpy(bits.copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))
    return t.to(device=like.device if device is None else device,
                dtype=like.dtype)


def _write(directory: str, step: int, paths, arrays, dtypes,
           metadata: Optional[dict]) -> str:
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    np.savez(os.path.join(tmp, "arrays.npz"),
             **{f"leaf_{i}": a for i, a in enumerate(arrays)})
    manifest = {
        "step": step,
        "paths": paths,
        "shapes": [list(a.shape) for a in arrays],
        "dtypes": dtypes,
        "metadata": metadata or {},
    }
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def save_checkpoint(directory: str, step: int, tree,
                    metadata: Optional[dict] = None) -> str:
    """Write ``tree`` (dicts and lists of tensors or ``DTensor``s) as
    ``step_<n>/``; returns the directory."""
    leaves = tree_leaves(tree)
    host = [_host(t) for t in leaves]
    final = os.path.join(directory, f"step_{step:08d}")
    if _writes(leaves):
        final = _write(directory, step, _paths(tree), [a for a, _ in host],
                       [d for _, d in host], metadata)
    _barrier(leaves)
    return final


def _placed(a: torch.Tensor, sharding):
    """A restored leaf as a ``DTensor`` on ``sharding``'s mesh: a
    ``runtime.sharding.NamedSharding`` or a (``DeviceMesh``, placements)
    pair."""
    from torch.distributed.tensor import distribute_tensor

    mesh, placements = sharding
    dev = (torch.device("cuda", torch.cuda.current_device())
           if mesh.device_type == "cuda" else torch.device(mesh.device_type))
    return distribute_tensor(a.to(dev), mesh, list(placements))


def load_checkpoint(directory: str, template, step: Optional[int] = None,
                    shardings=None):
    """Restore into the structure of ``template``: every leaf in the
    template leaf's dtype, on its device, or, where ``shardings`` (a tree
    of (``DeviceMesh``, placements) like the template) is given, as a
    ``DTensor`` placed so on the current mesh (elastic restore; every rank
    of the mesh calls it). Returns (tree, manifest)."""
    step_dir = (os.path.join(directory, f"step_{step:08d}") if step is not None
                else latest_checkpoint(directory))
    if step_dir is None:
        raise FileNotFoundError(f"no checkpoint in {directory}")
    with open(os.path.join(step_dir, "manifest.json")) as f:
        manifest = json.load(f)
    t_paths = _paths(template)
    if t_paths != manifest["paths"]:
        raise ValueError(f"checkpoint/template structure mismatch in {step_dir}")
    cpu = torch.device("cpu")
    with np.load(os.path.join(step_dir, "arrays.npz")) as data:
        leaves = [_leaf(data[f"leaf_{i}"], d, like, cpu if shardings is not None
                        else None) for i, (d, like) in
                  enumerate(zip(manifest["dtypes"], tree_leaves(template)))]
    tree = tree_unflatten(template, leaves)
    if shardings is not None:
        tree = tree_map(_placed, tree, shardings)
    return tree, manifest


def latest_checkpoint(directory: str) -> Optional[str]:
    if not os.path.isdir(directory):
        return None
    steps = sorted(d for d in os.listdir(directory)
                   if d.startswith("step_") and not d.endswith(".tmp"))
    return os.path.join(directory, steps[-1]) if steps else None


class CheckpointManager:
    """keep-K rotation + optional async saves."""

    def __init__(self, directory: str, keep: int = 3, async_save: bool = False):
        self.directory = directory
        self.keep = keep
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def save(self, step: int, tree, metadata: Optional[dict] = None):
        # copy to the host synchronously (the train step updates the
        # tensors in place); write in the background
        paths = _paths(tree)
        leaves = tree_leaves(tree)
        host = [_host(t) for t in leaves]
        if not _writes(leaves):
            return

        def work():
            _write(self.directory, step, paths, [a for a, _ in host],
                   [d for _, d in host], metadata)
            self._gc()

        if self.async_save:
            self.wait()
            self._thread = threading.Thread(target=work, daemon=True)
            self._thread.start()
        else:
            work()

    def restore(self, template, shardings=None, step: Optional[int] = None):
        """The latest (or ``step``'s) checkpoint into ``template``'s
        structure; with ``shardings``, as ``DTensor``s on the current mesh
        once rank 0's writes have ended (every rank calls it)."""
        self.wait()
        if shardings is not None:
            import torch.distributed as dist

            if dist.is_initialized():
                dist.barrier()
        return load_checkpoint(self.directory, template, step=step,
                               shardings=shardings)

    def _gc(self):
        steps = sorted(d for d in os.listdir(self.directory)
                       if d.startswith("step_") and not d.endswith(".tmp"))
        for d in steps[: -self.keep] if self.keep else []:
            shutil.rmtree(os.path.join(self.directory, d), ignore_errors=True)

    def latest_step(self) -> Optional[int]:
        p = latest_checkpoint(self.directory)
        return int(os.path.basename(p).split("_")[1]) if p else None
