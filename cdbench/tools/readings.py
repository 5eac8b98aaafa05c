"""The readings a cell's limits are set from: the program's numbers and the
control's, seed by seed, in one process.

    python3 cdbench/tools/readings.py --workload <cell> --seeds 1,2,3 \
        --seconds 1 [--control-seeds 1,2,3] [--config '{"data_seed": 1}'] \
        [--traffic '{...}']

Each seed runs the cell as ``run.py`` does (the world from the seed, the
program's set-up, a window of ``--seconds``) and judges its answers against
the reference (``program``); on the control's seeds the same answers'
places are then taken by the reference in bfloat16 (``control``). Only
the first seed runs the mix's warm units: the kernels are loaded by then.
``--config`` and ``--traffic`` replace keys of the cell's files (another
world by its ``data_seed``, other ``claim_probs``). Prints one JSON line a
seed, with the mean of each count the units report (``unit_stats``), and
a summary line: the largest program reading and the smallest control
reading of each number.
"""
from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
HERE = os.path.dirname(os.path.abspath(__file__))
sys.path = [ROOT, os.path.join(ROOT, "src")] + [
    p for p in sys.path if os.path.abspath(p or ".") != HERE]

import torch  # noqa: E402

from cdbench.harness import (  # noqa: E402
    Run,
    cell_files,
    load_json,
    load_module,
    make_context,
)

WARM_KEYS = ("warm_units", "warm_batches")


def unit_stats(run) -> dict:
    """The mean over the run's answered units of each number they report."""
    sums: dict = {}
    for u in run.done:
        for k, v in u.stats.items():
            if isinstance(v, (int, float)) and not isinstance(v, bool):
                sums.setdefault(k, []).append(float(v))
    return {k: sum(v) / len(v) for k, v in sorted(sums.items())}


def readings(workload: str, seeds: list, control_seeds: set, seconds: float,
             device: str = "cuda", overrides=None, traffic_overrides=None):
    """Yield one dict a seed: its program and (where asked) control numbers."""
    bench = load_json(os.path.join(ROOT, "BENCHMARK.json"))
    files = cell_files(bench, workload)
    driver = load_module(files["driver"])
    tr = dict(traffic_overrides or {})
    for i, seed in enumerate(seeds):
        if i:
            tr.update({k: 0 for k in WARM_KEYS})
        t0 = time.perf_counter()
        ctx = make_context(workload, seed, device, files, overrides, tr)
        state = driver.setup(ctx)
        run = Run()
        driver.window(ctx, state, seconds, run)
        driver.release(ctx, state)
        gc.collect()
        if ctx.device.type == "cuda":
            torch.cuda.empty_cache()
        out = {"seed": seed, "units": len(run.units),
               "failed": sum(not u.ok for u in run.units),
               "unit_stats": unit_stats(run),
               "program": driver.check(ctx, state, run)}
        if seed in control_seeds:
            out["control"] = driver.check(ctx, state, run, control=True)
        out["seconds"] = time.perf_counter() - t0
        del state, ctx, run
        gc.collect()
        yield out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--config", default="{}")
    ap.add_argument("--traffic", default="{}")
    args = ap.parse_args(argv)
    seeds = [int(s) for s in args.seeds.split(",")]
    ctrl = {int(s) for s in args.control_seeds.split(",") if s}
    worst, least = {}, {}
    for r in readings(args.workload, seeds, ctrl, args.seconds, "cuda",
                      json.loads(args.config), json.loads(args.traffic)):
        print(json.dumps(r), flush=True)
        for k, v in r["program"].items():
            worst[k] = max(worst.get(k, v), v)
        for k, v in r.get("control", {}).items():
            least[k] = min(least.get(k, v), v)
    print(json.dumps({"workload": args.workload, "config": args.config,
                      "traffic": args.traffic, "program_max": worst,
                      "control_min": least}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
