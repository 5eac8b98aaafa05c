"""The training runtime: the train step (gradient accumulation, clipping,
schedule), the fault-tolerant training loop (checkpoint/restart on failure)
and straggler monitoring.

The port of the JAX package's ``runtime/train_loop.py``. PyTorch runs
eagerly, so the step is a Python function, not a jitted one; gradient
accumulation is a Python loop over the micro-batches; the parameters and
optimizer state are updated in place (``optim.adamw``). Train state is
``{params, opt, step}`` with ``step`` an int64 scalar tensor on the model's
device.

Fault model, as in the JAX package: a failed step (a ``RuntimeError``, which
is what PyTorch raises for a CUDA fault or an out-of-memory) → restore the
latest checkpoint and resume, with bounded retries; slow steps are flagged
by a wall-time EMA watchdog. A step that fails inside the optimizer update
may leave the state half-updated, so without a checkpoint the retry starts
from that state (the JAX package's functional step leaves it untouched).
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Optional

import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.models.common import tree_leaves, tree_unflatten
from repro_torch.optim import get_optimizer
from repro_torch.optim.schedule import clip_by_global_norm, warmup_cosine


# ---------------------------------------------------------------------------
# the step
# ---------------------------------------------------------------------------

def make_train_step(model, optimizer, lr_fn, *, grad_accum: int = 1,
                    max_grad_norm: float = 1.0):
    """Returns train_step(state, batch) → (state, metrics).

    state = {params, opt, step}, updated in place and returned; batch
    leaves have a leading (grad_accum,) micro-batch dimension when
    grad_accum > 1. metrics = {loss, grad_norm, lr} as float32 scalar
    tensors on the model's device.
    """

    def compute_grads(params, leaves, batch):
        if grad_accum == 1:
            loss = model.loss(params, batch)
            return loss.detach(), list(torch.autograd.grad(loss, leaves))
        acc_loss = torch.zeros((), dtype=torch.float32, device=model.device)
        acc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
               for p in leaves]
        for i in range(grad_accum):
            micro = {k: v[i] for k, v in batch.items()}
            loss = model.loss(params, micro)
            for a, g in zip(acc, torch.autograd.grad(loss, leaves)):
                a.add_(g)
            acc_loss += loss.detach()
        scale = 1.0 / grad_accum
        return acc_loss * scale, [a.mul_(scale) for a in acc]

    def train_step(state, batch):
        params = state["params"]
        leaves = tree_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        loss, grads = compute_grads(params, leaves, batch)
        grads, gnorm = clip_by_global_norm(grads, max_grad_norm)
        lr = lr_fn(state["step"])
        optimizer.update(tree_unflatten(params, grads), state["opt"], params,
                         state["step"], lr)
        state["step"] += 1
        return state, {"loss": loss, "grad_norm": gnorm, "lr": lr}

    return train_step


def init_train_state(model, optimizer, seed: int = 0):
    params = model.init(seed)
    return {"params": params, "opt": optimizer.init(params),
            "step": torch.zeros((), dtype=torch.int64, device=model.device)}


def train_state_dims(model, optimizer):
    """The logical dims of ``init_train_state``'s tree, for the sharding
    rules (``runtime/sharding.py``): the parameters', the optimizer
    state's (with the float32 master copy where the parameters are
    bfloat16) and ``()`` for the scalar step."""
    pd = model.param_dims()
    has_master = model.cfg.param_dtype == "bfloat16"
    return {"params": pd,
            "opt": optimizer.state_dims(pd, has_master=has_master),
            "step": ()}


# ---------------------------------------------------------------------------
# straggler monitoring
# ---------------------------------------------------------------------------

@dataclass
class StepMonitor:
    """EMA wall-time watchdog: flags steps slower than slack × EMA."""

    slack: float = 2.0
    ema_decay: float = 0.9
    ema: Optional[float] = None
    slow_steps: list = field(default_factory=list)
    on_straggler: Optional[Callable[[int, float, float], None]] = None

    def record(self, step: int, seconds: float) -> bool:
        is_slow = False
        if self.ema is not None and seconds > self.slack * self.ema:
            is_slow = True
            self.slow_steps.append((step, seconds, self.ema))
            if self.on_straggler:
                self.on_straggler(step, seconds, self.ema)
        # slow outliers shouldn't poison the baseline
        upd = min(seconds, (self.slack * self.ema) if self.ema else seconds)
        self.ema = upd if self.ema is None else (
            self.ema_decay * self.ema + (1 - self.ema_decay) * upd)
        return is_slow


# ---------------------------------------------------------------------------
# fault-tolerant training loop
# ---------------------------------------------------------------------------

class FaultInjector:
    """Test hook: raises at scheduled steps (once each)."""

    def __init__(self, fail_at=()):
        self.fail_at = set(fail_at)

    def check(self, step: int):
        if step in self.fail_at:
            self.fail_at.discard(step)
            raise RuntimeError(f"injected fault at step {step}")


def train(
    model,
    data_iter,
    *,
    steps: int,
    optimizer_name: Optional[str] = None,
    peak_lr: float = 3e-4,
    warmup: int = 20,
    grad_accum: int = 1,
    checkpoint_dir: Optional[str] = None,
    checkpoint_every: int = 50,
    keep: int = 3,
    async_checkpoint: bool = True,
    seed: int = 0,
    fault_injector: Optional[FaultInjector] = None,
    max_retries: int = 3,
    monitor: Optional[StepMonitor] = None,
    log_every: int = 10,
    log_fn=print,
):
    """Run training with checkpoint/restart fault tolerance from parameters
    drawn by ``model.init(seed)``. Returns (final_state, history): one dict
    per completed step with its step, seconds (host clock, ending when the
    step's metrics reach the host) and metrics. Batches of a model with
    ``cross`` layers carry ``cond`` (B, cond_len, cond_dim), with a leading
    micro-batch dimension under ``grad_accum`` as every leaf has. The
    optimizer is ``optimizer_name``, else the config's (``adamw``, or
    ``adafactor`` for grok-1-314b); an unknown name raises ``KeyError``
    before anything is built."""
    optimizer = get_optimizer(optimizer_name or model.cfg.optimizer)()
    lr_fn = warmup_cosine(peak_lr, warmup, steps)
    step_fn = make_train_step(model, optimizer, lr_fn, grad_accum=grad_accum)
    state = init_train_state(model, optimizer, seed)
    monitor = monitor or StepMonitor()
    mgr = (CheckpointManager(checkpoint_dir, keep=keep,
                             async_save=async_checkpoint)
           if checkpoint_dir else None)

    # resume if a checkpoint exists
    if mgr and mgr.latest_step() is not None:
        state, _ = mgr.restore(state)
        log_fn(f"[train] resumed from step {int(state['step'])}")

    history = []
    retries = 0
    step = int(state["step"])
    batches = iter(data_iter)
    pending = None
    while step < steps:
        try:
            if pending is None:
                pending = next(batches)
            if fault_injector:
                fault_injector.check(step)
            t0 = time.perf_counter()
            state, metrics = step_fn(state, pending)
            metrics = {k: float(v) for k, v in metrics.items()}
            dt = time.perf_counter() - t0
            monitor.record(step, dt)
            pending = None
            retries = 0
            history.append({"step": step, "seconds": dt, **metrics})
            if log_every and step % log_every == 0:
                log_fn(f"[train] step {step} loss {metrics['loss']:.4f} "
                       f"({dt * 1e3:.0f} ms)")
            step = int(state["step"])
            if mgr and step % checkpoint_every == 0:
                mgr.save(step, state)
        except RuntimeError as e:  # noqa: PERF203
            retries += 1
            log_fn(f"[train] step {step} failed ({e}); retry {retries}")
            if retries > max_retries:
                raise
            if mgr and mgr.latest_step() is not None:
                state, _ = mgr.restore(state)
                step = int(state["step"])
                log_fn(f"[train] restored checkpoint at step {step}")
    if mgr:
        mgr.save(step, state)
        mgr.wait()
    return state, history
