"""GPipe-style pipeline parallelism over the ranks of a process group.

The port of the JAX package's ``runtime/pipeline_parallel.py``. Each rank
of ``group`` is one stage and holds only its own stage's parameters (JAX
shards a stacked parameter tree over the mesh axis; here the caller hands
each rank its slice). Microbatches stream through: at tick t, stage s
computes microbatch t − s and passes its activation to stage s + 1 with
``batch_isend_irecv``; the run takes n_micro + n_stages − 1 ticks (the
classic bubble). JAX's stages compute on every tick and the results of
the bubble's ticks are thrown away; here a stage computes only on its
n_micro live ticks, which gives the same outputs. The last stage records
each finished microbatch, and a broadcast from it gives every rank the
outputs, as JAX's masked ``psum`` replicates them. A one-stage pipeline
sends nothing (JAX's ``ppermute`` 0 → 0 is the identity; a rank cannot
send to itself over gloo or NCCL). Each send and the broadcast report
their result bytes to ``utils.costs`` (the dry run's collective count;
JAX's ``ppermute`` is a ``collective-permute``, its ``psum`` an
``all-reduce``).
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.utils.costs import record_collective


def _live(stage: int, tick: int, n_micro: int) -> bool:
    return 0 <= tick - stage < n_micro


def pipeline_apply(stage_fn, stage_params, x_micro: torch.Tensor, group=None):
    """Run a pipelined stack.

    stage_fn(stage_params, x) → x of the same shape and dtype;
    stage_params: this rank's stage (rank r of ``group`` is stage r);
    x_micro: (n_micro, mb, ...) microbatched inputs, on every rank (only
    stage 0 reads them). Returns the (n_micro, mb, ...) outputs of the
    last stage on every rank.
    """
    n_stages = dist.get_world_size(group)
    stage = dist.get_rank(group)
    n_micro = x_micro.shape[0]
    peer = (lambda s: s) if group is None else (
        lambda s: dist.get_global_rank(group, s))
    outputs = torch.zeros_like(x_micro)
    state = torch.empty_like(x_micro[0])
    for t in range(n_micro + n_stages - 1):
        out = None
        if _live(stage, t, n_micro):
            inp = x_micro[t] if stage == 0 else state
            out = stage_fn(stage_params, inp)
            if out.shape != inp.shape or out.dtype != inp.dtype:
                raise ValueError(f"stage_fn changed {tuple(inp.shape)} "
                                 f"{inp.dtype} into {tuple(out.shape)} "
                                 f"{out.dtype}")
            if stage == n_stages - 1:
                outputs[t - stage] = out
        ops = []
        if stage < n_stages - 1 and out is not None:
            ops.append(dist.P2POp(dist.isend, out.contiguous(),
                                  peer(stage + 1), group))
            record_collective("collective-permute",
                              out.numel() * out.element_size())
        if stage > 0 and _live(stage - 1, t, n_micro):
            ops.append(dist.P2POp(dist.irecv, state, peer(stage - 1), group))
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
    if n_stages > 1:
        dist.broadcast(outputs, peer(n_stages - 1), group=group)
        record_collective("all-reduce", outputs.numel() * outputs.element_size())
    return outputs


__all__ = ["pipeline_apply"]
