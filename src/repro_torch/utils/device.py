"""Device resolution for the port's entry points.

Entry points run on the card unless the caller asks for another device:
``device=None`` means ``cuda`` (or the CPU, where the process asked for it
through ``runtime.platform.set_platform("cpu")``), and a CUDA request on a
machine without a CUDA device raises instead of falling back to the CPU.
"""
from __future__ import annotations

import torch


#: What ``device=None`` means: ``cuda`` unless the process asked for the
#: CPU (``runtime.platform.set_platform("cpu")``).
_DEFAULT = "cuda"


def resolve_device(device=None) -> torch.device:
    """``None`` → the process's default, ``cuda`` unless
    ``runtime.platform.set_platform("cpu")`` made it the CPU; a CUDA
    device that is not present raises."""
    dev = torch.device(_DEFAULT if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the CPU")
    return dev


__all__ = ["resolve_device"]
