"""Gradient compression for the reduction across ranks: an int8 quantized
all-gather with error feedback.

The port of the JAX package's ``optim/compression.py``, over a
``torch.distributed`` process group in place of a mesh axis. Each rank
quantizes its ``x + err`` with one scale a leaf, ``max|y| / 127`` (at
least 1e-12), rounding half to even as ``jnp.round`` does, and keeps
XLA's float32 arithmetic (the scale a product with 1/127, the residual
one fused multiply-subtract); the int8
payload and the float32 scales are all-gathered, dequantized and summed
locally in rank order. The quantization residual is returned as the
error fed into the next step, which keeps long-run drift small. The
payload on the wire is a quarter of a float32 all-reduce's (plus four
bytes a rank and leaf). Sum semantics, as ``psum``. Each leaf reports
its all-gather's result bytes to ``utils.costs`` (the dry run's
collective count).
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.models.common import tree_leaves, tree_map, tree_unflatten
from repro_torch.utils.costs import record_collective


def quantize_int8(y: torch.Tensor) -> tuple:
    """(int8 payload, float32 scale) of a float32 tensor. The scale is
    ``max|y| / 127`` as XLA computes it: a product with the float32
    reciprocal of 127."""
    scale = torch.clamp(torch.max(torch.abs(y)) * (1.0 / 127.0), min=1e-12)
    q = torch.clamp(torch.round(y / scale), -127, 127).to(torch.int8)
    return q, scale


def compress_allreduce(x: torch.Tensor, err: torch.Tensor, group=None) -> tuple:
    """One leaf: ``x + err`` → int8 all-gather-sum over ``group`` (None is
    the world). Returns (summed float32, new error)."""
    y = x.to(torch.float32) + err
    q, scale = quantize_int8(y)
    # y − q·scale rounded once, as XLA's fused multiply-subtract gives it:
    # q·scale is exact in float64 and the difference, at most scale / 2,
    # too, so only the cast to float32 rounds
    new_err = (y.double() - q.double() * scale.double()).to(torch.float32)

    n = dist.get_world_size(group)
    q_all = [torch.empty_like(q) for _ in range(n)]
    s_all = [torch.empty_like(scale.reshape(1)) for _ in range(n)]
    dist.all_gather(q_all, q.contiguous(), group=group)
    dist.all_gather(s_all, scale.reshape(1), group=group)
    record_collective("all-gather", n * (q.numel() * q.element_size() + 4))
    summed = torch.zeros_like(y)
    for s_r, q_r in zip(s_all, q_all):
        summed += s_r * q_r.to(torch.float32)
    return summed, new_err


def compressed_grad_sum(grads, err_tree, group=None) -> tuple:
    """Tree-wise int8 error-feedback all-reduce over ``group``."""
    outs = [compress_allreduce(g, e, group)
            for g, e in zip(tree_leaves(grads), tree_leaves(err_tree))]
    return (tree_unflatten(grads, [o[0] for o in outs]),
            tree_unflatten(grads, [o[1] for o in outs]))


def init_error_state(params):
    """Float32 zeros shaped like every leaf of ``params``."""
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


__all__ = ["compress_allreduce", "compressed_grad_sum", "init_error_state",
           "quantize_int8"]
