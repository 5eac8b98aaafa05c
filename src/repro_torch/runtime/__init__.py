"""Serving runtime of the port: the slot-based continuous-batching loop."""
from repro_torch.runtime.serve_loop import Request, ServeLoop

__all__ = ["Request", "ServeLoop"]
