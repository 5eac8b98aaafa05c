"""The LM's multi-rank half on the CPU: spawned ``gloo`` worlds against
the JAX package on 8 forced host devices.

JAX's outputs come from one subprocess (``JAX_PLATFORMS=cpu``, 8 forced
host devices, as ``tests/test_parallel_features.py`` runs its script) on
inputs drawn here with numpy: ``pipeline_apply`` over 4 stages, 8
microbatches of 2 × 16; ``compress_allreduce`` on an 8-way axis over 20
steps with the residual fed back, its int8 payload read where JAX's
function hands it to ``all_gather``; and ``devices_indices_map`` of
specs on 2×2 and 2×2×2 meshes. The port's side runs in worlds of
``tests/torch_dist.py`` (one a test case, every rank joined under
``JOIN_TIMEOUT``):

- ``pipeline_apply``: every rank's outputs within 1e-5 of JAX's; a
  reduced 4-layer Llama pipelined one layer a stage within 1e-5 of the
  port's unpipelined stack; a one-rank world equal to ``stage_fn`` on each
  microbatch, bit for bit.
- ``compress_allreduce`` on 8 ranks: payloads equal to JAX's, sums within
  1e-5 and residuals within 1e-6; JAX's own bars (relative error < 0.05,
  a residual kept, drift < 0.5 over 20 steps); ``compressed_grad_sum``
  equal to the leaves one at a time.
- Placements: each rank's local block equals the block JAX's
  ``NamedSharding.devices_indices_map`` gives the same mesh position.
- Elastic restore: a ``DTensor`` written by 4 ranks restores bit-equal
  onto 8 (8 shards of 2 rows); a reduced Llama train state placed by the
  rules on a 2×2 (data, model) mesh of 4 ranks restores bit-equal onto a
  4×1 mesh of the same ranks.
"""
import torch_threads  # noqa: F401  (caps torch's threads a worker)
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

import torch_dist as td
from repro_torch.configs import get_config

STAGES, N_MICRO, MB, D = 4, 8, 2, 16
COMPRESS_RANKS, COMPRESS_STEPS, COMPRESS_N = 8, 20, 64
PIPE_TOL, SUM_TOL, ERR_TOL = 1e-5, 1e-5, 1e-6
PLACEMENT_CASES = {
    "2x2": ((2, 2), ("data", "model"), (4, 6, 8),
            [["data", None, "model"], [None, "model", "data"],
             ["model", None, None], [None, None, None]]),
    "2x2x2": ((2, 2, 2), ("pod", "data", "model"), (8, 4, 6),
              [[["pod", "data"], None, "model"], ["model", ["pod", "data"], None],
               [None, "data", "model"], ["pod", None, None]]),
}
LLAMA = get_config("llama3.2-1b").reduced(n_layers=4, d_model=256, d_ff=256,
                                          vocab=128)

JAX_SCRIPT = textwrap.dedent("""
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import json, sys
    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P
    try:
        from jax import shard_map
        _nocheck = {"check_vma": False}
    except ImportError:
        from jax.experimental.shard_map import shard_map
        _nocheck = {"check_rep": False}
    from repro.optim import compression
    from repro.runtime.pipeline_parallel import pipeline_apply

    inp = np.load(sys.argv[1])
    out = {}
    w, x = jnp.asarray(inp["w"]), jnp.asarray(inp["x"])
    out["pipeline"] = np.asarray(pipeline_apply(
        lambda w_s, h: jnp.tanh(h @ w_s), w, x,
        jax.make_mesh((w.shape[0],), ("stage",)), "stage"))

    # the int8 payload, read where compress_allreduce gathers it
    def local(g, err):
        seen = {}
        gather = jax.lax.all_gather

        def spy(v, axis, **kw):
            if v.dtype == jnp.int8:
                seen["q"] = v
            return gather(v, axis, **kw)

        jax.lax.all_gather = spy
        try:
            s, e = compression.compress_allreduce(g, err, "data")
        finally:
            jax.lax.all_gather = gather
        return s, e, seen["q"]

    fn = jax.jit(shard_map(local, mesh=jax.make_mesh((8,), ("data",)),
                           in_specs=(P("data"), P("data")),
                           out_specs=(P(None), P("data"), P("data")),
                           **_nocheck))
    gs = inp["gs"]
    err = jnp.zeros(gs.shape[1:], jnp.float32)
    qs, sums, errs = [], [], []
    for g in gs:
        s, err, q = fn(jnp.asarray(g), err)
        qs.append(np.asarray(q))
        sums.append(np.asarray(s)[0])
        errs.append(np.asarray(err))
    out["q"], out["sums"], out["errs"] = map(np.stack, (qs, sums, errs))

    blocks = {}
    for name, (shape, axes, gshape, specs) in json.loads(
            inp["placements"].item()).items():
        n = int(np.prod(shape))
        mesh = jax.make_mesh(tuple(shape), tuple(axes),
                             devices=jax.devices()[:n])
        per_spec = []
        for spec in specs:
            spec = P(*[tuple(e) if isinstance(e, list) else e for e in spec])
            m = NamedSharding(mesh, spec).devices_indices_map(tuple(gshape))
            per_spec.append([
                [list(sl.indices(size)[:2]) for sl, size in
                 zip(m[mesh.devices[pos]], gshape)]
                for pos in np.ndindex(*mesh.devices.shape)])
        blocks[name] = per_spec
    out["blocks"] = np.asarray(json.dumps(blocks))
    np.savez(sys.argv[2], **out)
""")


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(0)
    w = rng.normal(0, 0.5, (STAGES, D, D)).astype(np.float32)
    x = rng.normal(0, 1, (N_MICRO, MB, D)).astype(np.float32)
    gs = np.random.default_rng(1).normal(
        0, 1, (COMPRESS_STEPS, COMPRESS_RANKS, COMPRESS_N)).astype(np.float32)
    return {"w": w, "x": x, "gs": gs}


@pytest.fixture(scope="module")
def jax_out(inputs, tmp_path_factory):
    d = tmp_path_factory.mktemp("jax_parallel")
    src, dst = str(d / "in.npz"), str(d / "out.npz")
    np.savez(src, placements=np.asarray(json.dumps(PLACEMENT_CASES)), **inputs)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {"PYTHONPATH": os.path.join(root, "src"), "PATH": "/usr/bin:/bin",
           "JAX_PLATFORMS": "cpu",
           "OMP_NUM_THREADS": os.environ.get("OMP_NUM_THREADS", "1")}
    proc = subprocess.run([sys.executable, "-c", JAX_SCRIPT, src, dst],
                          capture_output=True, text=True, timeout=300, env=env)
    assert proc.returncode == 0, proc.stderr[-3000:]
    with np.load(dst) as f:
        out = {k: f[k] for k in f.files}
    out["blocks"] = json.loads(out["blocks"].item())
    return out


def test_pipeline_matches_jax(inputs, jax_out, tmp_path):
    outs = td.run_world(td.pipeline_tanh, STAGES, tmp_path, inputs["w"],
                        inputs["x"])
    ref = inputs["x"]
    for s in range(STAGES):
        ref = np.tanh(ref @ inputs["w"][s])
    for out in outs:                      # every rank holds the outputs
        np.testing.assert_allclose(out, jax_out["pipeline"], rtol=0,
                                   atol=PIPE_TOL)
        np.testing.assert_allclose(out, ref, rtol=0, atol=PIPE_TOL)


def test_pipeline_reduced_llama_one_layer_a_stage(tmp_path):
    tokens = np.random.default_rng(2).integers(
        0, LLAMA.vocab_size, (4, 2, 16))
    outs = td.run_world(td.pipeline_llama, LLAMA.n_layers, tmp_path, LLAMA,
                        tokens)
    ref = outs[0][1]
    assert ref.shape == (4, 2, 16, LLAMA.d_model)
    for out, _ in outs:
        np.testing.assert_allclose(out, ref, rtol=0, atol=PIPE_TOL)


def test_pipeline_one_rank_is_stage_fn(inputs, tmp_path):
    (out, ref), = td.run_world(td.pipeline_one_rank, 1, tmp_path, inputs["w"],
                               inputs["x"])
    np.testing.assert_array_equal(out, ref)


def test_compress_allreduce_matches_jax(inputs, jax_out, tmp_path):
    gs = inputs["gs"]
    outs = td.run_world(td.compress, COMPRESS_RANKS, tmp_path, gs)
    q = np.stack([o[0] for o in outs], axis=1)          # (steps, ranks, n)
    errs = np.stack([o[2] for o in outs], axis=1)
    np.testing.assert_array_equal(q, jax_out["q"])
    for o in outs:
        np.testing.assert_allclose(o[1], jax_out["sums"], rtol=0, atol=SUM_TOL)
        assert o[3], "compressed_grad_sum differs from the leaves one by one"
    np.testing.assert_allclose(errs, jax_out["errs"], rtol=0, atol=ERR_TOL)
    # JAX's own bars
    sums = outs[0][1]
    exact = gs.sum(axis=1)
    assert np.abs(sums[0] - exact[0]).max() / np.abs(exact[0]).max() < 0.05
    assert np.abs(errs[0]).max() > 0
    assert np.abs(sums.sum(0) - exact.sum(0)).max() < 0.5


@pytest.mark.parametrize("case", PLACEMENT_CASES)
def test_placements_match_jax_devices_indices_map(case, jax_out, tmp_path):
    mesh_shape, axes, gshape, specs = PLACEMENT_CASES[case]
    specs = [tuple(tuple(e) if isinstance(e, list) else e for e in s)
             for s in specs]
    world = int(np.prod(mesh_shape))
    outs = td.run_world(td.local_blocks, world, tmp_path, gshape, mesh_shape,
                        axes, specs)
    full = np.arange(int(np.prod(gshape)), dtype=np.float32).reshape(gshape)
    for k, spec_blocks in enumerate(jax_out["blocks"][case]):
        for rank, bounds in enumerate(spec_blocks):
            want = full[tuple(slice(a, b) for a, b in bounds)]
            np.testing.assert_array_equal(outs[rank][k], want,
                                          err_msg=f"spec {specs[k]} rank {rank}")


def test_elastic_restore_4_ranks_to_8(tmp_path):
    arr = np.random.default_rng(3).normal(0, 1, (16, 8)).astype(np.float32)
    ckpt = str(tmp_path / "ckpt")
    written = td.run_world(td.elastic_write, 4, tmp_path, ckpt, arr)
    assert written == [(4, 8)] * 4
    outs = td.run_world(td.elastic_read, 8, tmp_path, ckpt, arr.shape)
    for rank, (local, full, mesh_size) in enumerate(outs):
        np.testing.assert_array_equal(full, arr)
        np.testing.assert_array_equal(local, arr[2 * rank:2 * rank + 2])
        assert mesh_size == 8


def test_train_state_restores_from_2x2_onto_4x1(tmp_path):
    cfg = LLAMA.replace(n_layers=2)
    outs = td.run_world(td.train_state_roundtrip, 4, tmp_path,
                        str(tmp_path / "ckpt"), cfg, (2, 2), (4, 1))
    for bad, split22, split41, n in outs:
        # the rules split some leaves on both meshes
        assert bad == [] and split22 > 0 and split41 > 0 and n > 10
