"""Dry run of every (arch × shape × mesh) cell on the ``meta`` device.

The port of the JAX package's ``launch/dryrun.py``. JAX lowers and
compiles each cell's jitted program for 512 forced host devices and reads
XLA's ``memory_analysis``, ``cost_analysis`` and HLO. The port has no
compiler to ask: it runs the cell's own step once on ``meta`` tensors at
one card's local shapes (``launch.probes.local_config`` and
``local_rows``: its batch rows, each weight at its ``model`` shard) under
``launch.roofline.analyze_step``, which allocates nothing on any device,
so grok-1 costs no memory. A cell is

  * train: ``runtime.make_train_step`` with grad accumulation to the
    global batch (one sequence a data shard a micro-batch, as JAX), remat
    and the optimizer's update (``launch.probes.leafwise_updates``);
  * prefill: ``Model.prefill`` of the global batch;
  * decode: one ``Model.decode_step`` over a cache of ``seq_len``
    positions, at the last of them;
  * copyscore: ``core.distributed.distributed_pair_scores_lowerable`` at
    JAX's sizes (1,048,576 / 8 sources, 2,097,152 / 4 entries, 16
    buckets, int8).

``memory`` comes from that run's tracker, with the resident trees
(parameters, optimizer state, cache) counted at their shards
(``sharded_bytes`` of ``runtime.sharding``'s specs), not at the compute
shapes the run holds them at: the data axis's share of the state, and of
the gradients and their accumulators, is taken off the tracked peak
(``memory["sharding_correction_bytes"]``, 0 on a (1, 1) mesh). A train
cell runs two micro-batches where it accumulates more: the accumulators
exist from the first, and every later micro-batch repeats the second's
allocations, so the peak is the same. A cell whose plan holds a Mamba
kind (its scan dispatches one op a token a layer), or more layers ×
experts than ``WHOLE_STEP_MAX``, assembles its peak from whole-step runs
at ``LAYER_DEPTHS`` layers a multi-layer segment, extrapolated linearly
in depth to the config's (``memory["method"]`` says which).

That run is for memory alone and counts no FLOPs: with at most two
micro-batches, an Adafactor leaf cut to two matrices and, by depth,
fewer layers, its work is not the cell's. The roofline terms come from
the probes alone (``launch/probes.py``), assembled as JAX assembles
them, with ``per_kind_terms``. ``artifact_raw`` keeps the memory run's
own tally, as JAX's keeps its artifact's: the HBM bytes its tracker
counted in the same pass, FLOPs ``None``, and ``collectives``, only the
ones the port issues itself (the LM's data and tensor parallelism is the
probes' placement arithmetic, in ``collective_bytes_per_device``). The
constants are the H100's (``launch/roofline.py``). ``lower_s`` is the
seconds to build the cell's meta stand-ins, ``compile_s`` the seconds of
its analysis. A result has JAX's keys, so ``experiments/render_table.py``
renders an ``--all`` file unchanged.

Usage:
  python -m repro_torch.launch.dryrun --arch llama3.2-1b --shape train_4k --mesh single
  python -m repro_torch.launch.dryrun --all --out dryrun_torch.json
  python -m repro_torch.launch.dryrun --copyscore --mesh multi
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

from repro_torch.configs import ARCH_IDS, SHAPES, get_config, shape_applicable
from repro_torch.launch.mesh import production_mesh_shape
from repro_torch.launch.probes import (
    batch_parallel,
    leafwise_updates,
    local_config,
    local_rows,
    probe_cell_terms,
)
from repro_torch.launch.roofline import (
    Roofline,
    analyze_step,
    count_params,
    model_flops_for,
    sharded_bytes,
)
from repro_torch.models.common import DTYPES, tree_leaves
from repro_torch.models.model import Model
from repro_torch.models.transformer import SSM_KINDS
from repro_torch.optim import get_optimizer
from repro_torch.optim.adamw import Optimizer
from repro_torch.optim.schedule import warmup_cosine
from repro_torch.runtime.sharding import AbstractMesh, mesh_axes, tree_specs
from repro_torch.runtime.train_loop import make_train_step, train_state_dims


def production_mesh(mesh_kind: str) -> AbstractMesh:
    """The production mesh's shape without devices: 16 × 16 ``single``, 2 ×
    16 × 16 ``multi``."""
    return AbstractMesh(*production_mesh_shape(multi_pod=mesh_kind == "multi"))


def _meta(shape, dtype):
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def _bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree))


def _cut_optimizer(name: str) -> Optimizer:
    """The optimizer whose update runs ``leafwise_updates`` (an Adafactor
    leaf cut to its first matrices: the same peak, far fewer meta ops)."""
    opt = get_optimizer(name)()

    def update(grads, state, params, step, lr):
        for fn, _ in leafwise_updates(name, grads, state, params):
            fn()
        return params, state

    return Optimizer(init=opt.init, update=update, state_dims=opt.state_dims)


def _params_info(cfg, mesh):
    """Full-size meta parameters, their specs, (total, active) counts."""
    full = Model(cfg, device="meta")
    params = full.init()
    specs = tree_specs(params, full.param_dims(), mesh, "param")
    counts = count_params(params, active_expert_frac=(
        cfg.top_k / cfg.n_experts if cfg.n_experts else 1.0))
    return full, params, specs, counts


def _accum(shape, mesh, grad_accum=None) -> int:
    """A train cell's micro-batches; None is JAX's rule: one sequence a
    data shard a micro-batch."""
    return grad_accum or max(shape.global_batch // batch_parallel(mesh), 1)


def train_info(cfg, shape, mesh, grad_accum=None):
    """→ (model FLOPs, extra, (the state's bytes at its shards, the
    parameters' at theirs)), from full-size meta trees."""
    grad_accum = _accum(shape, mesh, grad_accum)
    micro = shape.global_batch // grad_accum
    opt = get_optimizer(cfg.optimizer)()
    full, fparams, p_specs, (total, active) = _params_info(cfg, mesh)
    fstate = {"params": fparams, "opt": opt.init(fparams),
              "step": _meta((), torch.int64)}
    s_specs = tree_specs(fstate, train_state_dims(full, opt), mesh, "param")
    state_sh = sharded_bytes(fstate, s_specs, mesh)
    params_sh = sharded_bytes(fparams, p_specs, mesh)
    act_gb = (micro * shape.seq_len * cfg.d_model * 4 * 8) / 2**30 / max(
        batch_parallel(mesh), 1)
    state_gb, grads_gb = state_sh / 2**30, params_sh / 2**30
    extra = {"grad_accum": grad_accum, "total_params": total,
             "active_params": active,
             "analytic_gb": {"state": round(state_gb, 2),
                             "grads": round(grads_gb, 2),
                             "activations": round(act_gb, 2),
                             "total": round(state_gb + grads_gb + act_gb, 2)}}
    return model_flops_for(cfg, shape, total, active), extra, (state_sh,
                                                               params_sh)


def build_train(cfg, shape, mesh, grad_accum=None):
    """→ (step fn, meta args, chips, model FLOPs, extra, correction)."""
    mf, extra, (state_sh, params_sh) = train_info(cfg, shape, mesh,
                                                  grad_accum)
    grad_accum = extra["grad_accum"]
    run_accum = min(grad_accum, 2)
    rows = local_rows(mesh, shape.global_batch // grad_accum)
    model = Model(local_config(cfg, mesh), device="meta")
    params = model.init()
    state = {"params": params,
             "opt": get_optimizer(cfg.optimizer)().init(params),
             "step": _meta((), torch.int64)}
    lead = (run_accum,) if run_accum > 1 else ()
    batch = {"tokens": _meta(lead + (rows, shape.seq_len), torch.long),
             "labels": _meta(lead + (rows, shape.seq_len), torch.long)}
    if cfg.cond_len:
        batch["cond"] = _meta(lead + (rows, cfg.cond_len, cfg.cond_dim),
                              DTYPES[cfg.dtype])
    step = make_train_step(model, _cut_optimizer(cfg.optimizer),
                           warmup_cosine(3e-4, 100, 10_000),
                           grad_accum=run_accum)
    n_grad = 2 if run_accum > 1 else 1            # gradients, accumulators
    correction = (_bytes(state) - state_sh,
                  n_grad * (_bytes(params) - params_sh))
    return (lambda s, b: step(s, b)[0], (state, batch), mesh_size(mesh), mf,
            extra, correction)


def serve_info(cfg, shape, mesh):
    """→ (model FLOPs, extra, (the parameters' bytes at their shards, the
    decode cache's at its, 0 for a prefill)), from full-size meta trees."""
    full, fparams, p_specs, (total, active) = _params_info(cfg, mesh)
    cache_sh = 0
    if shape.kind == "decode":
        fcache = full.init_cache(shape.global_batch, shape.seq_len,
                                 dtype=DTYPES[cfg.dtype])
        cache_sh = sharded_bytes(
            fcache, tree_specs(fcache, full.cache_dims(), mesh, "act"), mesh)
    extra = {"total_params": total, "active_params": active}
    return model_flops_for(cfg, shape, total, active), extra, (
        sharded_bytes(fparams, p_specs, mesh), cache_sh)


def build_serve(cfg, shape, mesh, prefill=False):
    """→ (step fn, meta args, chips, model FLOPs, extra, correction)."""
    mf, extra, (params_sh, cache_sh) = serve_info(cfg, shape, mesh)
    model = Model(local_config(cfg, mesh), device="meta")
    params = model.init()
    dt = DTYPES[cfg.dtype]
    resident = _bytes(params) - params_sh
    B = shape.global_batch
    if prefill:
        rows = local_rows(mesh, B)
        tokens = _meta((rows, shape.seq_len), torch.long)
        cond = (_meta((rows, cfg.cond_len, cfg.cond_dim), dt)
                if cfg.cond_len else None)

        def fn(p, t, c):
            with torch.no_grad():
                return model.prefill(p, t, cond=c)

        return (fn, (params, tokens, cond), mesh_size(mesh), mf, extra,
                (resident, 0))
    b = local_rows(mesh, B, decode=True)
    cache = model.init_cache(b, shape.seq_len, dtype=dt)
    resident += _bytes(cache) - cache_sh
    tokens = _meta((b,), torch.long)
    cond = (_meta((b, cfg.cond_len, cfg.cond_dim), dt)
            if cfg.cond_len else None)

    def fn(p, c, t, cd):
        with torch.no_grad():
            return model.decode_step(p, c, t, shape.seq_len - 1, cond=cd)

    return (fn, (params, cache, tokens, cond), mesh_size(mesh), mf, extra,
            (resident, 0))


def build_copyscore(mesh, n_sources=1_048_576 // 8, n_entries=2_097_152 // 4,
                    n_buckets=16):
    """The paper's own workload on the production mesh: the 2-D
    pair-space product, entries over pods, int8 incidence in K = 16
    buckets (JAX's sizes). → (record, chips, useful FLOPs, extra)."""
    from repro_torch.core.distributed import distributed_pair_scores_lowerable
    from repro_torch.core.types import CopyConfig

    K = n_buckets
    rec = distributed_pair_scores_lowerable(mesh, n_sources, K,
                                            n_entries // K, CopyConfig(),
                                            dtype=torch.int8)
    flops = 2.0 * n_sources * n_sources * n_entries    # useful matmul flops
    return rec, mesh_size(mesh), flops, {"n_sources": n_sources,
                                         "n_entries": n_entries,
                                         "n_buckets": K}


def mesh_size(mesh) -> int:
    return int(np.prod(list(mesh_axes(mesh).values())))


#: The depths a multi-layer segment is cut to for the ``layers`` method:
#: below ~8 layers the head's transient can set the peak, above it the
#: layers' gradients do (falcon-mamba-7b at 4 × 256: 0.785 GiB a layer
#: from 2 to 4 layers, 1.035 from 8 on).
LAYER_DEPTHS = (8, 16)

#: A train or prefill cell with more layers × experts than this assembles
#: its peak by depth (the whole step of grok-1 dispatches ~220,000 meta
#: ops, ~45 s on one CPU core).
WHOLE_STEP_MAX = 64


def memory_method(cfg, shape) -> str:
    """``"whole_step"``, or ``"layers"`` for a train or prefill cell whose
    plan holds a Mamba kind or more than ``WHOLE_STEP_MAX`` layers ×
    experts."""
    if shape.kind == "decode":
        return "whole_step"
    has_ssm = any(kind in SSM_KINDS for kind, _ in cfg.plan)
    depth = sum(c for _, c in cfg.plan)
    return ("layers" if has_ssm or depth * max(cfg.n_experts, 1)
            > WHOLE_STEP_MAX else "whole_step")


def _memory(cfg, shape, mesh, grad_accum=None):
    """(the memory run's analysis, memory dict, extra, model FLOPs)."""
    def build_fn(c):
        if shape.kind == "train":
            return build_train(c, shape, mesh, grad_accum=grad_accum)
        return build_serve(c, shape, mesh, prefill=shape.kind == "prefill")

    L = sum(c for _, c in cfg.plan)
    cuts = [tuple((k, min(c, d)) for k, c in cfg.plan) for d in LAYER_DEPTHS]
    if memory_method(cfg, shape) == "whole_step" or sum(
            c for _, c in cuts[-1]) >= L:
        fn, args, chips, mf, extra, corr = build_fn(cfg)
        r = analyze_step(fn, *args, chips=chips, count_flops=False)
        mem = _corrected(r["memory"], corr)
        mem["method"] = "whole_step"
        return r, mem, extra, mf
    # whole steps at LAYER_DEPTHS layers a multi-layer segment, extrapolated
    # linearly in depth
    runs = []
    for plan in cuts:
        cut = cfg.replace(layer_plan=plan, n_layers=sum(c for _, c in plan))
        fn, args, chips, _, _, corr = build_fn(cut)
        r = analyze_step(fn, *args, chips=chips, count_flops=False)
        runs.append((sum(c for _, c in plan), r, _corrected(r["memory"], corr)))
    (la, ra, ma), (lb, _, mb) = runs
    mf, extra, _ = (train_info(cfg, shape, mesh, grad_accum)
                    if shape.kind == "train" else serve_info(cfg, shape, mesh))
    mem = {k: int(ma[k] + (mb[k] - ma[k]) * (L - la) / (lb - la))
           for k in ("argument_bytes", "output_bytes", "temp_bytes",
                     "peak_bytes", "alias_bytes", "sharding_correction_bytes")}
    mem["per_device_gb"] = (mem["argument_bytes"] + mem["temp_bytes"]) / 2**30
    mem["method"] = (f"layers: whole steps at {la} and {lb} layers, "
                     f"extrapolated linearly to {L}")
    return ra, mem, extra, mf


def _corrected(mem: dict, correction) -> dict:
    """``mem`` with the resident trees at their shards: ``correction`` is
    (the resident inputs' bytes beyond their shards, the gradients' and
    accumulators')."""
    resident, grads = correction
    out = dict(mem)
    out["peak_bytes"] = mem["peak_bytes"] - resident - grads
    out["argument_bytes"] = mem["argument_bytes"] - resident
    out["output_bytes"] = max(mem["output_bytes"] - resident, 0)
    out["alias_bytes"] = max(mem["alias_bytes"] - resident, 0)
    out["sharding_correction_bytes"] = resident + grads
    out["temp_bytes"] = max(out["peak_bytes"] - out["argument_bytes"]
                            - (out["output_bytes"] - out["alias_bytes"]), 0)
    out["per_device_gb"] = (out["argument_bytes"] + out["temp_bytes"]) / 2**30
    return out


def _finish(result, chips, mf):
    rl = Roofline(result["flops_per_device"], result["hbm_bytes_per_device"],
                  result["collective_bytes_per_device"],
                  model_flops=mf).finalize(chips)
    result.update({"compute_s": rl.compute_s, "memory_s": rl.memory_s,
                   "collective_s": rl.collective_s,
                   "bottleneck": rl.bottleneck,
                   "useful_flops_ratio": rl.useful_flops_ratio})


def _mesh_name(mesh) -> str:
    return "x".join(str(s) for s in mesh_axes(mesh).values())


def run_cell(arch, shape_name, mesh_kind, *, grad_accum=None):
    """One cell's result. ``arch`` is an arch id, ``"copyscore"`` or a
    ``ModelConfig``; ``shape_name`` a key of ``SHAPES`` or a
    ``ShapeConfig``; ``mesh_kind`` ``"single"``, ``"multi"`` or any mesh
    ``runtime.sharding.mesh_axes`` reads (an ``AbstractMesh``);
    ``grad_accum`` a train cell's micro-batches (None: JAX's rule)."""
    t0 = time.time()
    mesh = (production_mesh(mesh_kind) if isinstance(mesh_kind, str)
            else mesh_kind)
    mesh_name = mesh_kind if isinstance(mesh_kind, str) else _mesh_name(mesh)
    name = arch if isinstance(arch, str) else arch.name
    head = {"arch": name, "shape": shape_name if isinstance(shape_name, str)
            else shape_name.name, "mesh": mesh_name}
    if arch == "copyscore":
        result, chips, mf, extra = build_copyscore(mesh)
        t_lower = time.time() - t0
        result["artifact_raw"] = {k: result[k] for k in
                                  ("flops_per_device", "hbm_bytes_per_device",
                                   "collective_bytes_per_device")}
    else:
        cfg = get_config(arch) if isinstance(arch, str) else arch
        shape = SHAPES[shape_name] if isinstance(shape_name, str) else shape_name
        ok, why = shape_applicable(cfg, shape)
        if not ok:
            return {**head, "status": "skipped", "reason": why}
        run, mem, extra, mf = _memory(cfg, shape, mesh, grad_accum=grad_accum)
        chips = mesh_size(mesh)
        t_lower = time.time() - t0
        probe = probe_cell_terms(cfg, shape, mesh,
                                 grad_accum=extra.get("grad_accum"))
        result = {k: probe[k] for k in ("flops_per_device",
                                        "hbm_bytes_per_device",
                                        "collective_bytes_per_device")}
        result.update({
            "per_kind_terms": probe["per_kind"], "memory": mem,
            "collectives": run["collectives"],
            "artifact_raw": {"flops_per_device": None,
                             "hbm_bytes_per_device":
                                 run["hbm_bytes_per_device"],
                             "collective_bytes_per_device":
                                 run["collective_bytes_per_device"]}})
    t_compile = time.time() - t0 - t_lower
    _finish(result, chips, mf)
    result.update({**head, "chips": chips, "status": "ok", "model_flops": mf,
                   "lower_s": round(t_lower, 1),
                   "compile_s": round(t_compile, 1), **extra})
    return result


def all_cells():
    for arch in ARCH_IDS:
        for shape_name in SHAPES:
            yield arch, shape_name


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", default="single", choices=["single", "multi"])
    ap.add_argument("--copyscore", action="store_true",
                    help="dry-run the paper's distributed copy-score workload")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=None)
    ap.add_argument("--timeout", type=int, default=1800)
    args = ap.parse_args(argv)

    if args.all:
        # a subprocess a cell: isolated, resumable
        results = {}
        if args.out and os.path.exists(args.out):
            with open(args.out) as f:
                results = json.load(f)
        cells = [(a, s, m) for a, s in all_cells() for m in ("single", "multi")]
        cells += [("copyscore", "pairscore", m) for m in ("single", "multi")]
        src = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
        env = {**os.environ, "PYTHONPATH": os.pathsep.join(
            [src] + [p for p in os.environ.get("PYTHONPATH", "").split(
                os.pathsep) if p])}
        for arch, shape_name, mesh_kind in cells:
            key = f"{arch}|{shape_name}|{mesh_kind}"
            if key in results and results[key].get("status") in ("ok", "skipped"):
                continue
            cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                   "--mesh", mesh_kind]
            cmd += (["--copyscore"] if arch == "copyscore"
                    else ["--arch", arch, "--shape", shape_name])
            print(f"[dryrun] {key} ...", flush=True)
            try:
                proc = subprocess.run(cmd, capture_output=True, text=True,
                                      timeout=args.timeout, env=env)
                line = [ln for ln in proc.stdout.splitlines()
                        if ln.startswith("CELLRESULT")]
                if proc.returncode == 0 and line:
                    results[key] = json.loads(line[0][len("CELLRESULT"):])
                else:
                    results[key] = {"arch": arch, "shape": shape_name,
                                    "mesh": mesh_kind, "status": "error",
                                    "error": (proc.stderr or proc.stdout)[-2000:]}
            except subprocess.TimeoutExpired:
                results[key] = {"arch": arch, "shape": shape_name,
                                "mesh": mesh_kind, "status": "timeout"}
            if args.out:
                os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
                with open(args.out, "w") as f:
                    json.dump(results, f, indent=1)
            print(f"[dryrun] {key}: {results[key].get('status')}", flush=True)
        n_ok = sum(1 for r in results.values() if r.get("status") == "ok")
        print(f"[dryrun] done: {n_ok}/{len(results)} ok")
        return 0

    if args.copyscore:
        result = run_cell("copyscore", "pairscore", args.mesh)
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape (or --copyscore, or --all)")
        result = run_cell(args.arch, args.shape, args.mesh)
    if result.get("status") == "ok":
        mem = result.get("memory", {})
        print(f"memory: args={mem.get('argument_bytes', 0) / 2**30:.2f} GiB "
              f"temp={mem.get('temp_bytes', 0) / 2**30:.2f} GiB "
              f"peak={mem.get('peak_bytes', 0) / 2**30:.2f} GiB per device")
        print(f"terms: flops/device={result['flops_per_device']:.3e} "
              f"bytes/device={result['hbm_bytes_per_device']:.3e} "
              f"collective bytes/device={result['collective_bytes_per_device']:.3e}")
        print(f"roofline terms (s): compute={result['compute_s']:.4f} "
              f"memory={result['memory_s']:.4f} "
              f"collective={result['collective_s']:.4f} "
              f"→ {result['bottleneck']}-bound")
    print("CELLRESULT" + json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
