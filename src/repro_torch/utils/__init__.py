from repro_torch.utils.counters import ComputeCounter
from repro_torch.utils.device import resolve_device

__all__ = ["ComputeCounter", "resolve_device"]
