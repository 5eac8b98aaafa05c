from repro_torch.utils.counters import ComputeCounter
from repro_torch.utils.device import resolve_device
from repro_torch.utils.timing import Timer, timed

__all__ = ["ComputeCounter", "Timer", "resolve_device", "timed"]
