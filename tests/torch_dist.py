"""Spawned ``torch.distributed`` worlds for the port's multi-rank tests.

``run_world(fn, world, tmp_dir, *args)`` starts ``world`` processes from
a ``forkserver`` that has imported torch, ``torch.distributed.tensor``
and the port's ``runtime.platform`` once (a process started with
``spawn`` spends ~4 s importing them; the server's children are forked
from a fresh single-purpose process, as DataLoader workers are), each of
which opens its rank of a ``gloo`` world
through ``repro_torch.runtime.platform.process_group`` (a ``file://``
store in a fresh directory under ``tmp_dir``, so worlds of test files run
side by side by pytest-xdist never meet), runs ``fn(rank, world, *args)``
with one torch thread, and saves what it returns. The parent joins every
process under one deadline (``JOIN_TIMEOUT``), kills what is still alive
after it, and fails with each rank's traceback; otherwise it returns the
ranks' results in rank order.

The workers below run in those processes. They import neither JAX nor
the JAX package: the tests compare what they return with JAX's outputs.
"""
import multiprocessing as mp
import os
import tempfile
import time
import traceback

import numpy as np
import torch

JOIN_TIMEOUT = 120.0


def _child(fn, rank, world, store_dir, out_dir, args):
    torch.set_num_threads(1)
    from repro_torch.runtime.platform import process_group

    try:
        with process_group(rank, world, store_dir, device="cpu",
                           timeout_s=JOIN_TIMEOUT):
            result = fn(rank, world, *args)
        torch.save(result, os.path.join(out_dir, f"rank{rank}.pt"))
    except BaseException:
        with open(os.path.join(out_dir, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise


def run_world(fn, world: int, tmp_dir, *args, timeout: float = JOIN_TIMEOUT):
    """Run ``fn`` on every rank of a spawned ``world``-rank gloo world and
    return the ranks' results; fail on an error or a hang."""
    ctx = mp.get_context("forkserver")
    ctx.set_forkserver_preload(["torch", "torch.distributed.tensor",
                                "repro_torch.runtime.platform", "torch_dist"])
    store_dir = tempfile.mkdtemp(prefix="store", dir=tmp_dir)
    out_dir = tempfile.mkdtemp(prefix="out", dir=tmp_dir)
    env_threads = os.environ.get("OMP_NUM_THREADS")
    os.environ["OMP_NUM_THREADS"] = "1"
    try:
        procs = [ctx.Process(target=_child, args=(fn, r, world, store_dir,
                                                  out_dir, args))
                 for r in range(world)]
        for p in procs:
            p.start()
    finally:
        if env_threads is None:
            os.environ.pop("OMP_NUM_THREADS", None)
        else:
            os.environ["OMP_NUM_THREADS"] = env_threads
    deadline = time.monotonic() + timeout
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join(10)
    errors = []
    for r in range(world):
        path = os.path.join(out_dir, f"rank{r}.err")
        if os.path.exists(path):
            with open(path) as f:
                errors.append(f"rank {r}:\n{f.read()}")
    if hung:
        raise AssertionError(f"ranks {hung} of {world} still running after "
                             f"{timeout} s\n" + "\n".join(errors))
    if errors or any(p.exitcode != 0 for p in procs):
        raise AssertionError(f"exit codes {[p.exitcode for p in procs]}\n"
                             + "\n".join(errors))
    return [torch.load(os.path.join(out_dir, f"rank{r}.pt"),
                       weights_only=False) for r in range(world)]


# ---------------------------------------------------------------------------
# workers
# ---------------------------------------------------------------------------

def _tanh_stage(w_s, h):
    return torch.tanh(h @ w_s)


def pipeline_tanh(rank, world, w, x):
    """Stage r multiplies by w[r] and takes tanh; every rank's outputs."""
    from repro_torch.runtime.pipeline_parallel import pipeline_apply

    out = pipeline_apply(_tanh_stage, torch.from_numpy(w[rank]),
                         torch.from_numpy(x))
    return out.numpy()


def pipeline_one_rank(rank, world, w, x):
    """A one-stage pipeline's outputs, and the stage applied to each
    microbatch in turn."""
    from repro_torch.runtime.pipeline_parallel import pipeline_apply

    w0, xs = torch.from_numpy(w[0]), torch.from_numpy(x)
    out = pipeline_apply(_tanh_stage, w0, xs)
    ref = torch.stack([_tanh_stage(w0, xs[m]) for m in range(xs.shape[0])])
    return out.numpy(), ref.numpy()


def _llama_layers(params, lo, hi):
    """Layers lo … hi − 1 of the one segment, stacked."""
    from repro_torch.models.common import tree_map

    return tree_map(lambda t: t[lo:hi], params["segments"][0])


def pipeline_llama(rank, world, cfg, tokens):
    """A reduced Llama pipelined one layer a stage, and (rank 0) the same
    layers run unpipelined on every microbatch."""
    from repro_torch.models import Model
    from repro_torch.models.common import make_rope
    from repro_torch.models.transformer import run_segment
    from repro_torch.runtime.pipeline_parallel import pipeline_apply

    model = Model(cfg, device="cpu")
    params = model.init(seed=0)
    toks = torch.from_numpy(tokens)                     # (n_micro, mb, S)
    x = params["embed"][toks]
    rope = make_rope(torch.arange(toks.shape[-1]), cfg.resolved_head_dim,
                     cfg.rope_theta)

    def stage_fn(p, h):
        return run_segment("dense", p, h, rope, cfg)

    with torch.no_grad():
        out = pipeline_apply(stage_fn, _llama_layers(params, rank, rank + 1), x)
        ref = None
        if rank == 0:
            every = _llama_layers(params, 0, cfg.n_layers)
            ref = torch.stack([stage_fn(every, x[m])
                               for m in range(x.shape[0])]).numpy()
    return out.numpy(), ref


def compress(rank, world, gs):
    """``compress_allreduce`` over ``gs`` (steps, world, n), each step's
    residual fed into the next: per step this rank's int8 payload, the
    sum and the residual; and ``compressed_grad_sum`` on a two-leaf tree
    against the leaves one at a time."""
    from repro_torch.optim.compression import (
        compress_allreduce,
        compressed_grad_sum,
        init_error_state,
        quantize_int8,
    )

    err = torch.zeros(gs.shape[-1])
    qs, sums, errs = [], [], []
    for g_step in gs:
        g = torch.from_numpy(g_step[rank])
        qs.append(quantize_int8(g + err)[0].numpy())
        s, err = compress_allreduce(g, err)
        sums.append(s.numpy())
        errs.append(err.numpy())
    tree = {"a": torch.from_numpy(gs[0, rank]),
            "b": [torch.from_numpy(gs[1, rank, :16].reshape(4, 4))]}
    e0 = init_error_state(tree)
    t_sum, t_err = compressed_grad_sum(tree, e0)
    one_a = compress_allreduce(tree["a"], e0["a"])
    one_b = compress_allreduce(tree["b"][0], e0["b"][0])
    tree_equal = all(torch.equal(a, b) for a, b in (
        (t_sum["a"], one_a[0]), (t_err["a"], one_a[1]),
        (t_sum["b"][0], one_b[0]), (t_err["b"][0], one_b[1])))
    return np.stack(qs), np.stack(sums), np.stack(errs), tree_equal


def local_blocks(rank, world, shape, mesh_shape, axis_names, specs):
    """This rank's local block of ``arange(shape)`` placed by each spec on
    a ``DeviceMesh`` of ``mesh_shape``."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.runtime.sharding import placements

    mesh = init_device_mesh("cpu", tuple(mesh_shape),
                            mesh_dim_names=tuple(axis_names))
    full = torch.arange(int(np.prod(shape)), dtype=torch.float32).reshape(shape)
    return [distribute_tensor(full, mesh, list(placements(s, mesh)))
            .to_local().numpy() for s in specs]


def elastic_write(rank, world, ckpt_dir, arr):
    """``arr`` sharded over a ``world``-way ``data`` mesh, saved."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Shard, distribute_tensor

    from repro_torch.checkpoint import save_checkpoint

    mesh = init_device_mesh("cpu", (world,), mesh_dim_names=("data",))
    w = distribute_tensor(torch.from_numpy(arr), mesh, [Shard(0)])
    save_checkpoint(ckpt_dir, 1, {"w": w})
    return tuple(w.to_local().shape)


def elastic_read(rank, world, ckpt_dir, shape):
    """The checkpoint restored onto a ``world``-way ``data`` mesh: this
    rank's block, the logical array, and the DTensor's mesh size."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Shard

    from repro_torch.checkpoint import load_checkpoint
    from repro_torch.runtime.sharding import NamedSharding

    mesh = init_device_mesh("cpu", (world,), mesh_dim_names=("data",))
    tree, _ = load_checkpoint(
        ckpt_dir, {"w": torch.empty(shape)},
        shardings={"w": NamedSharding(mesh, (Shard(0),))})
    w = tree["w"]
    return w.to_local().numpy(), w.full_tensor().numpy(), w.device_mesh.size()


def _train_state(cfg):
    """A reduced Llama train state with AdamW moments drawn from a seed."""
    from repro_torch.models import Model
    from repro_torch.models.common import tree_leaves
    from repro_torch.optim import adamw
    from repro_torch.runtime import init_train_state

    model = Model(cfg, device="cpu")
    opt = adamw()
    state = init_train_state(model, opt, seed=0)
    gen = torch.Generator().manual_seed(1)
    for t in tree_leaves(state["opt"]):
        t.normal_(generator=gen)
    state["step"].fill_(7)
    return model, opt, state


def _placed_state(cfg, mesh_shape):
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.runtime import train_state_dims
    from repro_torch.runtime.sharding import named, tree_specs

    model, opt, state = _train_state(cfg)
    mesh = init_device_mesh("cpu", tuple(mesh_shape),
                            mesh_dim_names=("data", "model"))
    specs = tree_specs(state, train_state_dims(model, opt), mesh)
    return state, named(specs, mesh)


def train_state_roundtrip(rank, world, ckpt_dir, cfg, write_shape,
                          read_shape):
    """The train state placed by the sharding rules on a (data, model)
    mesh of ``write_shape`` and saved, then restored onto one of
    ``read_shape`` (the same ranks): the paths of leaves not bit-equal to
    the state, the leaves split across ranks on either mesh, and the
    leaves."""
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.checkpoint import load_checkpoint, save_checkpoint
    from repro_torch.checkpoint.checkpoint import _paths
    from repro_torch.models.common import tree_leaves, tree_map

    def split(tree):
        return sum(tuple(t.to_local().shape) != tuple(t.shape)
                   for t in tree_leaves(tree))

    state, shardings = _placed_state(cfg, write_shape)
    placed = tree_map(lambda t, sh: distribute_tensor(t, sh.mesh,
                                                      list(sh.placements)),
                      state, shardings)
    save_checkpoint(ckpt_dir, 1, placed)
    state, shardings = _placed_state(cfg, read_shape)
    back, _ = load_checkpoint(ckpt_dir, state, shardings=shardings)
    got, want = tree_leaves(back), tree_leaves(state)
    bad = [p for p, a, b in zip(_paths(state), got, want)
           if a.dtype != b.dtype or not torch.equal(a.full_tensor(), b)]
    return bad, split(placed), split(back), len(got)
