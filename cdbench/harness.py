"""The benchmark's harness: a cell found by name, run once, its line printed.

A cell of ``BENCHMARK.json`` names a configuration and a traffic mix. The
harness reads ``configs/<config>.json`` (the generator's sizes and the copy
model), ``traffic/<traffic>.json`` (the mix's parameters, and the driver in
``drivers/<driver>.py`` that plays it), ``limits/<cell>.json`` (the limit of
each number compared for ``correct``) and one reader in
``metrics/<metric>.py`` for each metric the cell reports: a ``read(run)``
that returns the metric's value, or None where it finds nothing to read;
its name, unit, layer and what it moves are ``BENCHMARK.json``'s. Nothing
here names a cell, a mix or a metric: a later cell adds files.

A run: set-up (the world from the seed, the program's state, the driver's
warm units), the measured window, the device's peak memory, the program's
state freed, the reference's comparison, the metrics, one JSON line.
"""
from __future__ import annotations

import argparse
import gc
import importlib.util
import json
import sys
import time
from dataclasses import dataclass, field, fields
from pathlib import Path

import numpy as np
import torch

from cdbench import data
from cdbench.reference import CopyModel

ROOT = Path(__file__).resolve().parents[1]
#: Top-level module names that may not be loaded in a run's process.
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


@dataclass
class Unit:
    """One timed unit of work (a pass, a round, a request)."""

    t0: float
    t1: float
    ok: bool
    stats: dict = field(default_factory=dict)


@dataclass
class Run:
    """What a run measured; the metric readers read it."""

    setup_s: float = 0.0
    window_t0: float = 0.0
    window_t1: float = 0.0
    units: list = field(default_factory=list)
    extra: dict = field(default_factory=dict)
    trace: object = None                 # devtrace.TraceSummary with --trace 1

    @property
    def window_s(self) -> float:
        return self.window_t1 - self.window_t0

    @property
    def done(self) -> list:
        return [u for u in self.units if u.ok]


@dataclass
class Context:
    """A cell's inputs, as the driver sees them."""

    name: str
    seed: int
    device: torch.device
    config: dict
    traffic: dict
    model: CopyModel
    spec: data.SyntheticSpec
    world: data.World
    relabel: data.Relabel
    base_world: data.World
    truth: np.ndarray            # (D, n_false + 1) truth probabilities
    p_claim: np.ndarray

    def copy_config(self):
        """The copy model as the program's ``CopyConfig``."""
        from repro_torch.core.types import CopyConfig
        m = self.model
        return CopyConfig(alpha=m.alpha, s=m.s, n=m.n)

    def dataset(self):
        """The cell's world as the program's ``ClaimsDataset``."""
        from repro_torch.core.types import ClaimsDataset
        return ClaimsDataset(values=self.world.values,
                             accuracy=self.world.accuracy)


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path):
    """A module from its file (metric and driver names may hold dots)."""
    spec = importlib.util.spec_from_file_location(
        "cdbench_" + path.stem.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_files(bench: dict, name: str, root: Path = ROOT) -> dict:
    """The files a cell is made of, found by the names in ``bench``."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    base = root / "cdbench"
    traffic = base / "traffic" / f"{w['traffic']}.json"
    out = {"workload": w, "config": root / configs[w["config"]]["file"],
           "traffic": traffic, "limits": base / "limits" / f"{name}.json",
           "driver": base / "drivers" / f"{load_json(traffic)['driver']}.py",
           "metrics": {}}
    for kind in ("end_to_end", "per_layer"):
        out["metrics"][kind] = [
            (m, base / "metrics" / f"{m['name']}.py")
            for m in cell_metrics(bench, name, kind)]
    return out


def cell_metrics(bench: dict, name: str, kind: str) -> list:
    """The cell's metrics of one kind: an end-to-end metric where it names
    the cell (or names none); a per-layer metric where it names the cell,
    or names none and the cell reports the metric it moves."""
    e2e = [m for m in bench["end_to_end"]
           if "workloads" not in m or name in m["workloads"]]
    if kind == "end_to_end":
        return e2e
    moved = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if (name in m["workloads"] if "workloads" in m
                else m["moves"] in moved)]


def forbidden_modules() -> list:
    """Loaded modules whose whole top-level name is forbidden."""
    return sorted({m for m in list(sys.modules)
                   if m.split(".", 1)[0] in FORBIDDEN})


def make_context(name: str, seed: int, device, files: dict,
                 overrides: dict | None = None,
                 traffic_overrides: dict | None = None) -> Context:
    """The cell's world and parameters; ``overrides`` and
    ``traffic_overrides`` replace keys of its files (tests run tiny cells
    this way)."""
    config = {**load_json(files["config"]), **(overrides or {})}
    traffic = {**load_json(files["traffic"]), **(traffic_overrides or {})}
    names = {f.name for f in fields(data.SyntheticSpec)}
    spec = data.SyntheticSpec(**{k: config[k] for k in names & config.keys()
                                 if k != "seed"}, seed=config["data_seed"])
    base = data.synthetic_claims(spec)
    rl = data.relabel(seed, spec.n_sources, spec.n_items, spec.n_false)
    world = rl.world(base)
    model = CopyModel(alpha=config["alpha"], s=config["s"], n=config["n"])
    truth = data.truth_table(world.values, world.accuracy, spec.n_false,
                             config["claim_probs"])
    return Context(name=name, seed=seed, device=torch.device(device),
                   config=config, traffic=traffic, model=model, spec=spec,
                   world=world, relabel=rl, base_world=base, truth=truth,
                   p_claim=data.claim_probs(world.values, truth))


def run_cell(name: str, seed: int, seconds: float, trace: bool, device,
             t_start: float, *, root: Path = ROOT, control: bool = False,
             overrides: dict | None = None,
             traffic_overrides: dict | None = None) -> tuple:
    """Run one cell once; returns (the result line's object, the checks,
    the ``Run``).

    ``control`` judges the reference in bfloat16 in the program's place
    (the control of the comparison) instead of the program's answers.
    """
    bench = load_json(root / "BENCHMARK.json")
    files = cell_files(bench, name, root)
    driver = load_module(files["driver"])
    limits = load_json(files["limits"])
    ctx = make_context(name, seed, device, files, overrides,
                       traffic_overrides)
    dev = ctx.device
    state = driver.setup(ctx)
    run = Run()
    tracer = None
    if trace:
        from cdbench.devtrace import Tracer
        tracer = Tracer(dev)
        tracer.start()
    run.setup_s = time.perf_counter() - t_start
    driver.window(ctx, state, seconds, run)
    if tracer is not None:
        tracer.stop()
        run.trace = tracer.summary([(u.t0, u.t1) for u in run.units])
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0)
    driver.release(ctx, state)
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    numbers = driver.check(ctx, state, run, control=control)
    numbers["missing"] = sum(not u.ok for u in run.units)
    checks = {k: {"value": numbers[k], "limit": limits[k]} for k in limits}
    correct = all(c["value"] <= c["limit"] for c in checks.values())

    kind = "per_layer" if trace else "end_to_end"
    metrics = {}
    for entry, path in files["metrics"][kind]:
        value = load_module(path).read(run)
        if value is not None:
            metrics[entry["name"]] = {"value": float(value),
                                      "unit": entry["unit"]}
    devinfo = {"platform": "gpu" if dev.type == "cuda" else dev.type,
               "kind": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                        else "cpu"),
               "count": files["workload"]["chips"],
               "memory_peak_bytes": int(peak)}
    line = {"correct": bool(correct), "attempted": len(run.units),
            "failed": sum(not u.ok for u in run.units), "metrics": metrics,
            "device": devinfo}
    if run.trace is not None:
        devinfo["busy_s"] = run.trace.busy_s
        devinfo["window_s"] = run.trace.window_s
        line["breakdown"] = run.trace.breakdown()
    line["checks"] = checks
    return line, checks, run


def parse(argv) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv, t_start: float) -> int:
    args = parse(argv)
    bench = load_json(ROOT / "BENCHMARK.json")
    chips = {w["name"]: w["chips"] for w in bench["workloads"]}
    if args.workload not in chips:
        print(f"no workload {args.workload!r}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("no CUDA device: the benchmark runs only on the card",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < chips[args.workload]:
        print(f"{args.workload} needs {chips[args.workload]} devices, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 2
    seed = args.seed % (1 << 63)
    line, checks, run = run_cell(args.workload, seed, args.seconds,
                                 bool(args.trace), "cuda", t_start)
    bad = forbidden_modules()
    if bad:
        print(f"forbidden modules loaded: {', '.join(bad)}", file=sys.stderr)
        return 3
    # each unit's seconds (! marks a failed one) and the driver's notes,
    # for the record; the numbers compared come last
    print("units " + " ".join(f"{u.t1 - u.t0:.4f}{'' if u.ok else '!'}"
                              for u in run.units), file=sys.stderr)
    for note in run.extra.get("notes", []):
        print(note, file=sys.stderr)
    for k, c in checks.items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


__all__ = ["Context", "Run", "Unit", "cell_files", "cell_metrics",
           "forbidden_modules", "main", "run_cell"]
