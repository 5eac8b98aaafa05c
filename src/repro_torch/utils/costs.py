"""What a shapes-only run records beside the aten ops it dispatches.

A run on ``meta`` tensors computes nothing, and the counters of
``launch/roofline.py`` see only the aten ops it dispatches. Two kinds of
work are not aten ops: a hand-written kernel (its ``meta`` branch in
``kernels/ops.py`` launches nothing) and a collective the port issues
itself (``optim/compression.py``'s all-gather, ``runtime/
pipeline_parallel.py``'s sends and broadcast). Each reports its own
operations and bytes here, to every recorder that ``recording`` has
opened; with none open, a report costs a list walk. A recorder has two
methods, ``kernel(name, operations, nbytes)`` and ``collective(kind,
nbytes)``: ``kind`` is one of JAX's HLO collective names
(``launch.roofline.COLLECTIVES``), ``nbytes`` its result bytes on one
device.
"""
from __future__ import annotations

from contextlib import contextmanager

_recorders: list = []


@contextmanager
def recording(recorder):
    """Send every report of the block to ``recorder``."""
    _recorders.append(recorder)
    try:
        yield recorder
    finally:
        _recorders.remove(recorder)


def record_kernel(name: str, operations: float, nbytes: float) -> None:
    """A kernel's work: its operations and the bytes it must move."""
    for r in _recorders:
        r.kernel(name, operations, nbytes)


def record_collective(kind: str, nbytes: float) -> None:
    """A collective's result bytes on one device."""
    for r in _recorders:
        r.collective(kind, nbytes)


__all__ = ["record_collective", "record_kernel", "recording"]
