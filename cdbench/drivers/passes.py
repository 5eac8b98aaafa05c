"""Driver ``passes``: a closed loop of one-shot detection passes.

Each pass builds a fresh ``DetectionEngine`` in the mix's ``mode`` and runs
``detect`` on the cell's world with no prebuilt index, so the index build
and every piece of a pass's state are paid each time, as by a user who runs
a pass on a new dataset. The world and its claim probabilities are made
once, in set-up. Traffic keys: ``mode``, ``engine_options``,
``warm_units`` (passes run in set-up).

The window runs passes back to back until ``seconds`` have passed and
ends when the pass under way ends. Every pass's answer is judged.
"""
from __future__ import annotations

import time

import numpy as np

from cdbench import check as cmp


def _engine(ctx):
    from repro_torch.core.engine import DetectionEngine
    return DetectionEngine(ctx.copy_config(), mode=ctx.traffic["mode"],
                           device=ctx.device,
                           **ctx.traffic.get("engine_options", {}))


def setup(ctx) -> dict:
    ds = ctx.dataset()
    state = {"ds": ds, "answers": []}
    for _ in range(int(ctx.traffic.get("warm_units", 1))):
        _engine(ctx).detect(ds, ctx.p_claim)
    return state


def window(ctx, state, seconds: float, run) -> None:
    from cdbench.harness import Unit
    ds, p = state["ds"], ctx.p_claim
    run.window_t0 = t = time.perf_counter()
    while t - run.window_t0 < seconds:
        try:
            eng = _engine(ctx)
            res = eng.detect(ds, p)
            ok, stats = True, dict(eng.last_stats)
            state["answers"].append((res.c_fwd, res.copying))
            del eng, res
        except Exception as exc:                      # noqa: BLE001
            ok, stats = False, {"error": repr(exc)}
        t1 = time.perf_counter()
        run.units.append(Unit(t0=t, t1=t1, ok=ok, stats=stats))
        t = t1
    run.window_t1 = t


def release(ctx, state) -> None:
    state.pop("ds", None)


def check(ctx, state, run, control: bool = False) -> dict:
    w, m, dev = ctx.world, ctx.model, ctx.device
    ref = cmp.square_scores(w.values, w.accuracy, ctx.p_claim, m, device=dev)
    answers = state["answers"]
    if control:
        answers = [cmp.control_square(w.values, w.accuracy, ctx.p_claim,
                                        m, dev)] * max(len(answers), 1)
    numbers = [cmp.judge_square(np.asarray(c), np.asarray(cp), ref, m)
               for c, cp in answers]
    return cmp.merge(numbers)
