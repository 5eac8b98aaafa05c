"""The port's launch tools on the ``meta`` device: ``launch/roofline.py``'s
``analyze_step`` and ``collective_bytes``, ``launch/probes.py``,
``core/distributed.py``'s ``distributed_pair_scores_lowerable`` and
``run.lower``, ``launch/dryrun.py`` and ``runtime/platform.py``'s
``set_platform``.

- (a) ``probe_cell_terms``' assembly equals JAX's: in a JAX subprocess the
  five probes of ``repro.launch.probes`` are replaced by fixed vectors, and
  the port's by the same; train (grad accumulation), prefill and decode of
  hymba-1.5b, phi3.5-moe, falcon-mamba-7b and gemma-2b on both production
  meshes agree exactly. The Mamba recurrence term is JAX's formula.
- (b) the copyscore cell against JAX on 8 forced host devices: every
  operand's shard shape of JAX's compiled ``distributed_pair_scores_
  lowerable`` and its all-reduce result bytes equal the port's record.
- (c) the counters by hand: a ``Linear`` forward and backward, the peak of a
  two-layer step, ``collective_bytes`` of one dense block on a 2 × 2 mesh;
  and the Mamba scan's whole-chunk ``meta`` stand-ins against its step
  loops on the CPU under the same tracker: the same peak, the same bytes
  but the forward's copy of each chunk's last state.
- (d) per-device terms add up: chips × FLOPs a device on a 2 × 2 mesh
  equals the (1, 1) mesh's FLOPs of the same global step within 1 %.
- (e) the flash wrappers' meta branches: the plain versions' shapes and
  dtypes, ``flash_counts`` recorded, no launch counted.
- (f) the CLI end to end, and ``experiments/render_table.py`` on the port's
  results.
- (g) ``set_platform``, and the serving CLI's ``--platform`` that calls it.
"""
import torch_threads  # noqa: F401  (caps torch's threads a worker)
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch.configs import SHAPES, ShapeConfig, get_config
from repro_torch.core.distributed import (
    distributed_pair_scores,
    distributed_pair_scores_lowerable,
    make_mesh,
)
from repro_torch.core.types import CopyConfig
from repro_torch.kernels import ops
from repro_torch.kernels import ref as kref
from repro_torch.launch import dryrun, probes
from repro_torch.launch.roofline import (
    StepCounter,
    analyze_step,
    collective_bytes,
    placement_collectives,
)
from repro_torch.models.common import MetaGenerator, cast_tree
from repro_torch.models.transformer import block_dims, init_block
from repro_torch.runtime import platform
from repro_torch.runtime.sharding import AbstractMesh
from repro_torch.utils import device as device_mod
from repro_torch.utils.costs import recording

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SINGLE = AbstractMesh((16, 16), ("data", "model"))
MULTI = AbstractMesh((2, 16, 16), ("pod", "data", "model"))


def _env():
    return {"PYTHONPATH": "src", "PATH": "/usr/bin:/bin",
            "JAX_PLATFORMS": "cpu",
            "OMP_NUM_THREADS": os.environ.get("OMP_NUM_THREADS", "1")}


def _meta(*shape, dtype=torch.float32, grad=False):
    return torch.empty(shape, dtype=dtype, device="meta", requires_grad=grad)


# ---------------------------------------------------------------------------
# (a) the assembly, against JAX's probe_cell_terms
# ---------------------------------------------------------------------------

ARCHS = ("hymba-1.5b", "phi3.5-moe-42b-a6.6b", "falcon-mamba-7b", "gemma-2b")
KINDS = ("dense", "moe", "cross", "ssm", "hybrid_swa", "hybrid_full")
CASES = [(a, s, m) for a in ARCHS
         for s in ("train_4k", "prefill_32k", "decode_32k")
         for m in ("single", "multi")]


def fixed_block(kind, rows, seq_len, train):
    """A vector that depends on every argument the assembly passes."""
    i = KINDS.index(kind) + 1
    return np.array([1e9 * i + rows * 7 + seq_len * (3 if train else 1),
                     2e8 * i + rows + seq_len, 3e6 * i + (11 if train else 5)])


def fixed_head(rows, seq_len, train):
    return np.array([5e9 + rows * 13 + seq_len, 7e8 + rows, 1e6 + (2 if train else 1)])


def fixed_optimizer(name):
    return np.array([3e10 + len(name), 9e9, 4e7])


JAX_ASSEMBLY = textwrap.dedent("""
    import json, sys, types
    import numpy as np
    import repro.launch.probes as P
    from repro.configs import SHAPES, get_config
    KINDS = %r
    def fixed_block(kind, rows, seq_len, train):
        i = KINDS.index(kind) + 1
        return np.array([1e9 * i + rows * 7 + seq_len * (3 if train else 1),
                         2e8 * i + rows + seq_len, 3e6 * i + (11 if train else 5)])
    def fixed_head(rows, seq_len, train):
        return np.array([5e9 + rows * 13 + seq_len, 7e8 + rows, 1e6 + (2 if train else 1)])
    P.probe_block = lambda cfg, kind, mesh, rows, seq_len, train=True, **k: \\
        fixed_block(kind, rows, seq_len, train)
    P.probe_block_decode = lambda cfg, kind, mesh, batch, seq_len: \\
        fixed_block(kind, batch, seq_len, False) * 0.5
    P.probe_head = lambda cfg, mesh, rows, seq_len, train=True: \\
        fixed_head(rows, seq_len, train)
    P.probe_head_decode = lambda cfg, mesh, batch: fixed_head(batch, 1, False) * 3
    P.probe_optimizer = lambda cfg, mesh: np.array(
        [3e10 + len(cfg.optimizer), 9e9, 4e7])
    meshes = {"single": types.SimpleNamespace(
                  shape={"data": 16, "model": 16}, axis_names=("data", "model")),
              "multi": types.SimpleNamespace(
                  shape={"pod": 2, "data": 16, "model": 16},
                  axis_names=("pod", "data", "model"))}
    out = {}
    for arch, shape, mesh in json.loads(sys.argv[1]):
        out["|".join((arch, shape, mesh))] = P.probe_cell_terms(
            get_config(arch), SHAPES[shape], meshes[mesh])
    print("RESULT" + json.dumps(out))
""") % (KINDS,)


@pytest.fixture(scope="module")
def jax_assembly():
    proc = subprocess.run([sys.executable, "-c", JAX_ASSEMBLY,
                           json.dumps(CASES)], capture_output=True, text=True,
                          timeout=600, env=_env(), cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = [ln for ln in proc.stdout.splitlines() if ln.startswith("RESULT")]
    return json.loads(line[0][len("RESULT"):])


@pytest.mark.parametrize("arch,shape,mesh", CASES)
def test_assembly_equals_jax(arch, shape, mesh, jax_assembly, monkeypatch):
    monkeypatch.setattr(probes, "probe_block",
                        lambda cfg, kind, mesh, rows, seq_len, train=True:
                        fixed_block(kind, rows, seq_len, train))
    monkeypatch.setattr(probes, "probe_block_decode",
                        lambda cfg, kind, mesh, batch, seq_len:
                        fixed_block(kind, batch, seq_len, False) * 0.5)
    monkeypatch.setattr(probes, "probe_head",
                        lambda cfg, mesh, rows, seq_len, train=True:
                        fixed_head(rows, seq_len, train))
    monkeypatch.setattr(probes, "probe_head_decode",
                        lambda cfg, mesh, batch: fixed_head(batch, 1, False) * 3)
    monkeypatch.setattr(probes, "probe_optimizer",
                        lambda cfg, mesh: fixed_optimizer(cfg.optimizer))
    got = probes.probe_cell_terms(get_config(arch), SHAPES[shape],
                                  {"single": SINGLE, "multi": MULTI}[mesh])
    want = jax_assembly["|".join((arch, shape, mesh))]
    assert got == want


@pytest.mark.parametrize("mesh", [SINGLE, MULTI])
@pytest.mark.parametrize("train", [True, False])
def test_mamba_recurrence_is_jax_formula(mesh, train):
    """JAX: rows / dp · S · d_inner / model · state · 10, ×3 in training."""
    cfg = get_config("falcon-mamba-7b")
    rows, S = 16, 4096
    dp = int(np.prod([mesh.shape[a] for a in mesh.shape if a != "model"]))
    want = (max(rows / dp, 1) * S * cfg.resolved_d_inner / mesh.shape["model"]
            * cfg.ssm_state * 10.0 * (3.0 if train else 1.0))
    lcfg = probes.local_config(cfg, mesh)
    got = probes._recurrence(cfg, lcfg, probes.local_rows(mesh, rows), S, train)
    assert got == want


# ---------------------------------------------------------------------------
# (b) the copyscore cell against JAX's compiled lowerable
# ---------------------------------------------------------------------------

PAIR_S, PAIR_K, PAIR_W = 256, 4, 37
PAIR_MESHES = ((("pod", "data", "model"), (2, 2, 2)),
               (("data", "model"), (4, 2)))

JAX_LOWERABLE = textwrap.dedent("""
    import os, sys, json
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import jax
    import jax.numpy as jnp
    from repro.core.distributed import distributed_pair_scores_lowerable
    from repro.core.types import CopyConfig
    from repro.launch.roofline import analyze_compiled
    S, K, w = %d, %d, %d
    out = {}
    for axes, shape in %r:
        mesh = jax.make_mesh(shape, axes)
        comp = distributed_pair_scores_lowerable(
            mesh, S, K, w, CopyConfig(), dtype=jnp.int8).compile()
        w_pad = w + (-w) %% (mesh.shape["pod"] if "pod" in axes else 1)
        glob = [(S, K, w_pad), (S, K, w_pad), (S,), (S,), (K, w_pad)]
        shard = [list(sh.shard_shape(g)) for sh, g in
                 zip(comp.input_shardings[0], glob)]
        r = analyze_compiled(comp, len(jax.devices()))
        out["x".join(map(str, shape))] = {
            "shards": shard,
            "all_reduce": r["collectives"]["bytes"]["all-reduce"]}
    print("RESULT" + json.dumps(out))
""") % (PAIR_S, PAIR_K, PAIR_W, PAIR_MESHES)


@pytest.fixture(scope="module")
def jax_lowerable():
    proc = subprocess.run([sys.executable, "-c", JAX_LOWERABLE],
                          capture_output=True, text=True, timeout=600,
                          env=_env(), cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = [ln for ln in proc.stdout.splitlines() if ln.startswith("RESULT")]
    return json.loads(line[0][len("RESULT"):])


@pytest.mark.parametrize("axes,shape", PAIR_MESHES)
def test_lowerable_equals_jax(axes, shape, jax_lowerable):
    rec = distributed_pair_scores_lowerable(AbstractMesh(shape, axes), PAIR_S,
                                            PAIR_K, PAIR_W, CopyConfig())
    want = jax_lowerable["x".join(map(str, shape))]
    got = [list(rec["operands"][k])
           for k in ("vr", "vc", "acc_r", "acc_c", "p_hat")]
    assert got == want["shards"]
    assert rec["collectives"]["bytes"]["all-reduce"] == want["all_reduce"]
    assert rec["dtype"] == "int8" and rec["flops_per_device"] > 0


def test_run_lower_is_the_lowerable_of_its_shapes():
    """``distributed_pair_scores(...).lower()`` gives the record of its own
    shapes (odd width padded over ``pod``) and runs nothing."""
    mesh = make_mesh((2, 2, 2), ("pod", "data", "model"),
                     [torch.device("cpu")] * 8)
    v = torch.zeros((PAIR_K, 64, 21), dtype=torch.int8)
    run = distributed_pair_scores(mesh, v, np.full(PAIR_K, 0.5),
                                  np.full(64, 0.8), CopyConfig())
    rec = run.lower()
    assert rec["operands"]["vr"] == (32, PAIR_K, 11)
    assert rec["operands"]["p_hat"] == (PAIR_K, 11)
    assert rec == distributed_pair_scores_lowerable(mesh, 64, PAIR_K, 21,
                                                    CopyConfig())


# ---------------------------------------------------------------------------
# (c) the counters, by hand
# ---------------------------------------------------------------------------

def test_linear_forward_backward_by_hand():
    B, I, O = 8, 64, 32
    x, w, g = _meta(B, I, grad=True), _meta(I, O, grad=True), _meta(B, O)

    def fn(x, w, g):
        y = x @ w
        return torch.autograd.grad(y, (x, w), g)

    r = analyze_step(fn, x, w, g, chips=1)
    assert r["flops_per_device"] == 3 * 2 * B * I * O
    # three products, each reading its two operands and writing its result
    assert r["hbm_bytes_per_device"] == 4 * ((B * I + I * O + B * O)
                                             + (B * O + I * O + B * I)
                                             + (B * I + B * O + I * O))


def test_two_layer_step_peak_by_hand():
    B, D, H = 16, 32, 128
    x, w1, w2 = _meta(B, D), _meta(D, H), _meta(H, D)

    def step(x, w1, w2):
        h = torch.relu(x @ w1)        # x @ w1 and its relu live together
        y = h @ w2
        w2.sub_(1e-3 * w2)            # an in-place update of an input
        return y, w2

    r = analyze_step(step, x, w1, w2, chips=1)
    mem = r["memory"]
    args = 4 * (B * D + D * H + H * D)
    assert mem["argument_bytes"] == args
    # peak: the product and its relu (two (B, H)), or h, y and the
    # update's temporary (H, D)
    assert mem["peak_bytes"] == args + max(2 * 4 * B * H,
                                           4 * (B * H + B * D + H * D))
    assert mem["output_bytes"] == 4 * (B * D + H * D)
    assert mem["alias_bytes"] == 4 * H * D
    assert mem["temp_bytes"] == mem["peak_bytes"] - args - 4 * B * D


def test_storage_freed_when_it_dies():
    counter = StepCounter()
    with counter:
        a = torch.empty(1000, device="meta") + 1
        b = a.view(10, 100) * 2                    # a view adds no storage
        del a
        c = b + 1
    assert counter.peak == 2 * 4000
    assert counter.live == 2 * 4000
    del b, c
    assert counter.live == 0


def test_collective_bytes_of_a_dense_block_by_hand():
    cfg = get_config("llama3.2-1b").reduced(d_model=256, d_ff=512, vocab=512)
    mesh = AbstractMesh((2, 2), ("data", "model"))
    T, D, F, H, hd = 4 * 128, 256, 512, 4, 64
    layer = cast_tree(init_block(MetaGenerator(), "dense", cfg), torch.float32)
    calls = placement_collectives(layer, block_dims("dense", cfg), mesh,
                                  tokens=T, itemsize=4, train=True, remat=True)
    got = collective_bytes(calls)
    # every leaf is data-sharded on d_model; heads and d_ff shard on model
    local = {"norm1": D, "norm2": D, "wq": D * H * hd // 2,
             "wk": D * H * hd // 2, "wv": D * H * hd // 2,
             "wo": H * hd * D // 2, "wg": D * F // 2, "wu": D * F // 2,
             "wd": F * D // 2}
    gathered = 4 * sum(local.values())
    assert got["bytes"]["all-gather"] == 2 * gathered      # forward, remat
    assert got["bytes"]["reduce-scatter"] == gathered // 2
    # wo and wd contract their model-sharded dim: forward, remat, backward
    assert got["bytes"]["all-reduce"] == 2 * 3 * T * D * 4
    assert got["counts"]["all-reduce"] == 6
    assert got["total_bytes"] == sum(got["bytes"].values())
    one = placement_collectives(layer, block_dims("dense", cfg),
                                AbstractMesh((1, 1), ("data", "model")),
                                tokens=T, itemsize=4, train=True, remat=True)
    assert collective_bytes(one)["total_bytes"] == 0


def _scan_inputs(dev, *shapes):
    gen = torch.Generator().manual_seed(0)
    return [(0.5 * torch.rand(s, generator=gen)).to(dev) for s in shapes]


def _scan_grads(A, x, dt, Bc, Cc, gy, chunk):
    from repro_torch.models.mamba import selective_scan

    leaves = [t.requires_grad_(True) for t in (A, x, dt, Bc, Cc)]
    y = selective_scan(*leaves, chunk)
    return torch.autograd.grad(y, leaves, gy)


@pytest.mark.parametrize("branch", ["scan_chunk", "chunk_states",
                                    "scan_forward_backward"])
@pytest.mark.parametrize("B,di,n,T,chunks", [(2, 4, 3, 4, 2), (3, 8, 16, 8, 3)])
def test_mamba_meta_stand_ins_hold_the_loops_memory(branch, B, di, n, T,
                                                    chunks):
    """``models/mamba.py`` runs each step loop on ``meta`` as whole-chunk
    ops: against the loops on the CPU, under the same tracker, the same
    peak, and the same bytes but 2 states' a forward chunk (the meta
    forward copies its last state out of the chunk's stack)."""
    from repro_torch.models import mamba

    state = B * di * n * 4
    if branch == "scan_chunk":
        fn, chunks = mamba._scan_chunk, 1
        shapes = [(di, n), (B, di, n), (T, B, di), (T, B, di), (T, B, n),
                  (T, B, n)]
    elif branch == "chunk_states":
        fn, chunks = mamba._chunk_states, 0
        shapes = [(di, n), (B, di, n), (T, B, di), (T, B, di), (T, B, n)]
    else:
        S = T * chunks

        def fn(*args):
            return _scan_grads(*args, T)
        shapes = [(di, n), (B, S, di), (B, S, di), (B, S, n), (B, S, n),
                  (B, S, di)]
    got = {}
    for dev in ("cpu", "meta"):
        args = _scan_inputs(dev, *shapes)
        counter = StepCounter()
        counter.track(args)
        with counter:
            fn(*args)
        got[dev] = (counter.hbm_bytes, counter.peak)
    assert got["meta"][1] == got["cpu"][1]
    assert got["meta"][0] == got["cpu"][0] + 2 * state * chunks


def test_ported_collectives_report_through_costs():
    got = []

    class Rec:
        def kernel(self, *a):
            pass

        def collective(self, kind, nbytes):
            got.append((kind, nbytes))

    import torch.distributed as dist

    from repro_torch.optim.compression import compress_allreduce
    from repro_torch.runtime.platform import process_group

    import tempfile
    with tempfile.TemporaryDirectory() as d, \
            process_group(0, 1, d, device="cpu"), recording(Rec()):
        assert dist.get_world_size() == 1
        compress_allreduce(torch.ones(10, 3), torch.zeros(10, 3))
    assert got == [("all-gather", 30 + 4)]


# ---------------------------------------------------------------------------
# (d) per-device terms add up
# ---------------------------------------------------------------------------

def test_per_device_flops_add_up():
    cfg = get_config("llama3.2-1b").reduced(d_model=256, d_ff=512, vocab=512)
    shape = ShapeConfig("t", 128, 4, "train")
    one = probes.probe_cell_terms(cfg, shape, AbstractMesh((1, 1),
                                                           ("data", "model")))
    four = probes.probe_cell_terms(cfg, shape, AbstractMesh((2, 2),
                                                            ("data", "model")))
    total = 4 * four["flops_per_device"]
    assert abs(total - one["flops_per_device"]) <= 0.01 * one["flops_per_device"]
    assert one["collective_bytes_per_device"] == 0
    assert four["collective_bytes_per_device"] > 0


# ---------------------------------------------------------------------------
# (e) the flash wrappers' meta branches
# ---------------------------------------------------------------------------

FLASH_META = [((2, 4, 2, 80, 80, 64), True, None), ((1, 4, 4, 33, 70, 128),
                                                     False, None),
              ((2, 2, 1, 96, 96, 64), True, 17)]


@pytest.mark.parametrize("shape,causal,window", FLASH_META)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_meta_branches(shape, causal, window, dtype):
    B, Hq, Hkv, Sq, Sk, D = shape
    gen = torch.Generator().manual_seed(0)
    q = torch.randn(B, Hq, Sq, D, generator=gen).to(dtype)
    k = torch.randn(B, Hkv, Sk, D, generator=gen).to(dtype)
    v = torch.randn(B, Hkv, Sk, D, generator=gen).to(dtype)
    kw = dict(causal=causal, window=window)
    o, lse = kref.flash_attention_fwd_torch(q, k, v, **kw)
    delta = (o.float() * o.float()).sum(-1)
    want = {"fwd": (o, lse),
            "dq": (kref.flash_attention_bwd_dq_torch(q, k, v, o, lse, delta,
                                                     **kw),),
            "dkv": kref.flash_attention_bwd_dkv_torch(q, k, v, o, lse, delta,
                                                      **kw)}
    mq, mk, mv = (torch.empty_like(t, device="meta") for t in (q, k, v))
    mlse, mdelta = (torch.empty_like(t, device="meta") for t in (lse, delta))
    got = []

    class Rec:
        def kernel(self, name, operations, nbytes):
            got.append((name, operations, nbytes))

        def collective(self, *a):
            pass

    launches = [f.launches for f in (ops.flash_attention_fwd,
                                     ops.flash_attention_bwd_dq,
                                     ops.flash_attention_bwd_dkv)]
    with recording(Rec()):
        outs = {"fwd": ops.flash_attention_fwd(mq, mk, mv, **kw),
                "dq": (ops.flash_attention_bwd_dq(mq, mk, mv, mq, mlse, mdelta,
                                                  **kw),),
                "dkv": ops.flash_attention_bwd_dkv(mq, mk, mv, mq, mlse,
                                                   mdelta, **kw)}
    assert [f.launches for f in (ops.flash_attention_fwd,
                                 ops.flash_attention_bwd_dq,
                                 ops.flash_attention_bwd_dkv)] == launches
    for which in ("fwd", "dq", "dkv"):
        assert [(t.shape, t.dtype) for t in outs[which]] == \
            [(t.shape, t.dtype) for t in want[which]]
        assert all(t.is_meta for t in outs[which])
    pairs = B * Hq * sum(1 for i in range(Sq) for j in range(Sk)
                         if (not causal or j <= i)
                         and (window is None or i - j < window))
    want_counts = [(f"flash_attention_{w}",) + ops.flash_counts(
        w, q.shape, k.shape, q.element_size(), **kw) for w in ("fwd", "dq", "dkv")]
    assert got == want_counts
    assert [c[1] for c in got] == [n * 2 * D * pairs for n in (2, 3, 4)]


def test_flash_counts_are_the_bounds_counts():
    """The counts chip_smoke.py's bounds print for Llama (phases 9, 12)."""
    assert ops.flash_counts("fwd", (8, 32, 2048, 64), (8, 8, 2048, 64), 2)[0] \
        == 137_506_062_336
    assert ops.flash_counts("dq", (4, 32, 2048, 64), (4, 8, 2048, 64), 2)[0] \
        == 103_129_546_752
    assert ops.flash_counts("dkv", (4, 32, 2048, 64), (4, 8, 2048, 64), 2)[0] \
        == 137_506_062_336
    # hymba's window of 1024 over 2048 rows (PERF.md: 1,573,376 a head)
    assert ops.visible_pairs(2048, 2048, True, 1024) == 1_573_376


# ---------------------------------------------------------------------------
# (f) the CLI and the table
# ---------------------------------------------------------------------------

JAX_RUN_CELL_KEYS = {
    "flops_per_device", "hbm_bytes_per_device", "collective_bytes_per_device",
    "compute_s", "memory_s", "collective_s", "bottleneck", "model_flops",
    "useful_flops_ratio", "collectives", "memory", "artifact_raw",
    "per_kind_terms", "arch", "shape", "mesh", "chips", "status", "lower_s",
    "compile_s", "grad_accum", "total_params", "active_params", "analytic_gb"}
JAX_MEMORY_KEYS = {"argument_bytes", "output_bytes", "temp_bytes", "peak_bytes",
                   "alias_bytes", "per_device_gb"}


def test_cli_and_render_table(tmp_path):
    env = {**_env(), "HOME": str(tmp_path)}
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "llama3.2-1b", "--shape", "train_4k", "--mesh", "single"],
        capture_output=True, text=True, timeout=600, env=env, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = [ln for ln in proc.stdout.splitlines() if ln.startswith("CELLRESULT")]
    cell = json.loads(line[0][len("CELLRESULT"):])
    assert JAX_RUN_CELL_KEYS <= set(cell)
    assert JAX_MEMORY_KEYS <= set(cell["memory"])
    assert cell["status"] == "ok" and cell["chips"] == 256
    assert cell["grad_accum"] == 16 and cell["memory"]["method"] == "whole_step"
    assert 0 < cell["useful_flops_ratio"] < 1

    results = {"llama3.2-1b|train_4k|single": cell,
               "llama3.2-1b|long_500k|single":
                   dryrun.run_cell("llama3.2-1b", "long_500k", "single"),
               "copyscore|pairscore|multi":
                   dryrun.run_cell("copyscore", "pairscore", "multi")}
    assert results["llama3.2-1b|long_500k|single"]["status"] == "skipped"
    path = tmp_path / "dryrun.json"
    path.write_text(json.dumps(results))
    proc = subprocess.run([sys.executable, "experiments/render_table.py",
                           str(path)], capture_output=True, text=True,
                          timeout=120, env=env, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "### single-pod mesh" in proc.stdout
    assert "### multi-pod mesh" in proc.stdout
    assert "| llama3.2-1b" in proc.stdout and "N/A (skip)" in proc.stdout
    assert "| copyscore" in proc.stdout


def test_run_cell_on_the_cards_mesh():
    """Any ``AbstractMesh`` and ``ShapeConfig`` from Python, a config object
    and a grad accumulation of one: the (1, 1) mesh needs no correction."""
    cfg = get_config("llama3.2-1b").reduced(d_model=256, d_ff=512, vocab=512)
    r = dryrun.run_cell(cfg, ShapeConfig("s", 64, 2, "train"),
                        AbstractMesh((1, 1), ("data", "model")), grad_accum=1)
    assert r["status"] == "ok" and r["mesh"] == "1x1" and r["chips"] == 1
    assert r["grad_accum"] == 1
    mem = r["memory"]
    assert mem["sharding_correction_bytes"] == 0
    # every argument but the batch's tokens and labels (2 × 64 int64 each)
    # is updated in place and returned
    assert mem["alias_bytes"] == mem["argument_bytes"] - 2 * (2 * 64) * 8
    assert mem["peak_bytes"] > mem["argument_bytes"] > 0
    # the terms are the probes' alone; the memory run counts no FLOPs
    terms = probes.probe_cell_terms(cfg, ShapeConfig("s", 64, 2, "train"),
                                    AbstractMesh((1, 1), ("data", "model")),
                                    grad_accum=1)
    assert r["flops_per_device"] == terms["flops_per_device"] > 0
    assert r["hbm_bytes_per_device"] == terms["hbm_bytes_per_device"]
    assert r["artifact_raw"]["flops_per_device"] is None


# ---------------------------------------------------------------------------
# (g) set_platform
# ---------------------------------------------------------------------------

@pytest.fixture
def restore_platform():
    before = device_mod._DEFAULT
    yield
    device_mod._DEFAULT = before


def test_set_platform(restore_platform):
    platform.set_platform("cpu")
    assert device_mod.resolve_device(None) == torch.device("cpu")
    assert device_mod.resolve_device("meta") == torch.device("meta")
    platform.set_platform("gpu")
    if torch.cuda.is_available():
        assert device_mod.resolve_device(None).type == "cuda"
    else:
        with pytest.raises(RuntimeError):
            device_mod.resolve_device(None)
    with pytest.raises(ValueError):
        platform.set_platform("tpu")
    assert "XLA_FLAGS" not in os.environ or \
        "xla_gpu" not in os.environ["XLA_FLAGS"]


SERVE_ARGV = {
    "detect": ["--task", "detect", "--sources", "64", "--items", "256",
               "--requests", "2", "--batch-requests", "2"],
    "lm": ["--task", "lm", "--reduced", "--batch", "2", "--prompt-len", "8",
           "--new-tokens", "2"],
}


@pytest.mark.parametrize("task", sorted(SERVE_ARGV))
def test_serve_platform_flag(task, restore_platform, capsys):
    """``--platform cpu`` makes the whole serve run on the CPU through
    ``set_platform``; without it (and without a card) it raises."""
    from repro_torch.launch import serve

    serve.main(["--platform", "cpu", *SERVE_ARGV[task]])
    out = capsys.readouterr().out
    assert device_mod._DEFAULT == "cpu"
    assert ("device=cpu" if task == "detect" else " on cpu ") in out
    platform.set_platform("gpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            serve.main(SERVE_ARGV[task])


def test_no_port_module_sets_xla_flags():
    """``XLA_FLAGS`` appears in no code of the port, only in prose."""
    import ast
    import pathlib

    root = pathlib.Path(ROOT)
    for path in sorted((root / "src" / "repro_torch").rglob("*.py")) + [
            root / "chip_smoke.py"]:
        tree = ast.parse(path.read_text())
        docs = {id(n.body[0].value) for n in ast.walk(tree)
                if isinstance(n, (ast.Module, ast.FunctionDef, ast.ClassDef,
                                  ast.AsyncFunctionDef))
                and n.body and isinstance(n.body[0], ast.Expr)
                and isinstance(n.body[0].value, ast.Constant)}
        bad = [n.lineno for n in ast.walk(tree)
               if isinstance(n, ast.Constant) and isinstance(n.value, str)
               and "XLA_FLAGS" in n.value and id(n) not in docs]
        assert not bad, f"{path.relative_to(root)}:{bad} names XLA_FLAGS"
