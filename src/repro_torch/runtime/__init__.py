"""Runtime of the port: the slot-based continuous-batching serve loop and
the fault-tolerant training loop."""
from repro_torch.runtime.serve_loop import Request, ServeLoop
from repro_torch.runtime.train_loop import (
    FaultInjector,
    StepMonitor,
    init_train_state,
    make_train_step,
    train,
    train_state_dims,
)

__all__ = ["FaultInjector", "Request", "ServeLoop", "StepMonitor",
           "init_train_state", "make_train_step", "train", "train_state_dims"]
