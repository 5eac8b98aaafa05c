"""The port's sharding rules (``runtime/sharding.py``), ``sharded_bytes``
and the production mesh against the JAX package's, on abstract meshes.

- JAX's four rule cases (``tests/test_runtime.py``'s divisibility
  fallback), with the specs as tuples.
- For every arch at full size on a 16×16 (``data``, ``model``) and a
  2×16×16 (``pod``, ``data``, ``model``) mesh: ``model_shardings``' param
  and cache specs (decode at 128 × 32768 and long_500k's 1 × 524288, where
  the batch falls back to ``data`` or replicates), ``batch_input_specs``
  of every applicable shape's inputs, and ``sharded_bytes`` of the
  parameters, equal JAX's exactly. The port takes its shapes from
  ``Model(cfg, device="meta")``, JAX from ``jax.eval_shape``.
- ``placements`` on an abstract mesh: ``Shard`` of the tensor dim a mesh
  axis is assigned, ``Replicate`` for the rest, ``("pod", "data")`` in
  mesh order only. Placements on real meshes of ranks are held against
  JAX's ``devices_indices_map`` in ``tests/test_torch_parallel.py``.
- ``make_production_mesh``' shapes and axis names, and its error in a
  world of another size.
"""
import torch_threads  # noqa: F401  (caps torch's threads a worker)
import functools
import math
import itertools

import jax
import pytest
from jax.sharding import AbstractMesh as JaxAbstractMesh
from jax.sharding import PartitionSpec as P
from torch.distributed.tensor import Replicate, Shard

from repro.configs import SHAPES as JAX_SHAPES
from repro.configs import get_config as jax_get_config
from repro.launch.roofline import sharded_bytes as jax_sharded_bytes
from repro.models import Model as JaxModel
from repro.runtime import sharding as jax_sharding
from repro_torch.configs import ARCH_IDS, SHAPES, get_config, shape_applicable
from repro_torch.launch.mesh import make_production_mesh, production_mesh_shape
from repro_torch.launch.roofline import sharded_bytes
from repro_torch.models import Model
from repro_torch.runtime.sharding import (
    AbstractMesh,
    batch_input_specs,
    mesh_axes,
    model_shardings,
    placements,
    spec_for,
)

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
CACHES = {"decode_32k": (128, 32768), "long_500k": (1, 524288)}


def _jax_mesh(shape, axes):
    try:
        return JaxAbstractMesh(shape, axes)                 # jax ≥ 0.5
    except TypeError:
        return JaxAbstractMesh(tuple(zip(axes, shape)))     # jax 0.4.x


def _as_tuples(tree):
    """JAX's tree of PartitionSpecs with each spec as a tuple."""
    return jax.tree.map(tuple, tree, is_leaf=lambda x: isinstance(x, P))


@functools.lru_cache(maxsize=None)
def _jax_param_shapes(arch):
    model = JaxModel(jax_get_config(arch))
    return jax.eval_shape(model.init, jax.random.PRNGKey(0))


@functools.lru_cache(maxsize=None)
def _jax_cache_shapes(arch, batch, seq):
    model = JaxModel(jax_get_config(arch))
    return jax.eval_shape(lambda: model.init_cache(batch, seq))


def test_rule_cases_of_the_jax_tests():
    mesh11 = AbstractMesh((1, 1), ("data", "model"))
    assert spec_for(("d_model", "heads", "head_dim"), (2048, 32, 64),
                    mesh11) == ("data", "model", None)
    mesh16 = AbstractMesh((16, 16), ("data", "model"))
    # gemma: 8 heads do not divide 16 → the attention weight replicates
    # on 'model' (head_dim is never sharded for params)
    assert spec_for(("d_model", "heads", "head_dim"), (2048, 8, 256),
                    mesh16) == ("data", None, None)
    # a decode cache prefers kv_heads, then its seq dim
    assert spec_for(("layer", "batch", "kv_heads", "seq", "head_dim"),
                    (18, 128, 1, 32768, 256), mesh16, kind="act") == (
        None, "data", None, "model", None)
    # hymba's vocab of 32001 replicates
    assert spec_for(("vocab", "d_model"), (32001, 1600), mesh16) == (None,
                                                                      "data")


@pytest.mark.parametrize("arch,mesh", itertools.product(ARCH_IDS, MESHES))
def test_model_shardings_equal_jax(arch, mesh):
    shape, axes = MESHES[mesh]
    ours_mesh, jax_mesh = AbstractMesh(shape, axes), _jax_mesh(shape, axes)
    model = Model(get_config(arch), device="meta")
    jmodel = JaxModel(jax_get_config(arch))
    # JAX's model_shardings once; its body (eval_shape, then
    # _dims_tree_specs) on cached shapes for the other cache
    (batch, seq), (batch2, seq2) = CACHES.values()
    p, c = model_shardings(model, ours_mesh, batch, seq)
    jp, jc = jax_sharding.model_shardings(jmodel, jax_mesh, batch, seq)
    assert p == _as_tuples(jp)
    assert c == _as_tuples(jc)
    _, c2 = model_shardings(model, ours_mesh, batch2, seq2)
    jc2 = jax_sharding._dims_tree_specs(_jax_cache_shapes(arch, batch2, seq2),
                                        jmodel.cache_dims(), jax_mesh, "act")
    assert c2 == _as_tuples(jc2)
    assert model_shardings(model, ours_mesh)[1] is None


@pytest.mark.parametrize("arch,mesh", itertools.product(ARCH_IDS, MESHES))
def test_batch_input_specs_equal_jax(arch, mesh):
    shape, axes = MESHES[mesh]
    model = Model(get_config(arch), device="meta")
    jmodel = JaxModel(jax_get_config(arch))
    for name, sh in SHAPES.items():
        if not shape_applicable(model.cfg, sh)[0]:
            continue
        got = batch_input_specs(model.input_specs(sh), AbstractMesh(shape, axes))
        want = jax_sharding.batch_input_specs(
            jmodel.input_specs(JAX_SHAPES[name]), _jax_mesh(shape, axes))
        assert got == {k: tuple(v) for k, v in want.items()}, name
        assert {k: tuple(v.shape) for k, v in model.input_specs(sh).items()} == {
            k: tuple(v.shape)
            for k, v in jmodel.input_specs(JAX_SHAPES[name]).items()}


@pytest.mark.parametrize("arch,mesh", itertools.product(ARCH_IDS, MESHES))
def test_sharded_bytes_equal_jax(arch, mesh):
    shape, axes = MESHES[mesh]
    model = Model(get_config(arch), device="meta")
    ours_mesh, jax_mesh = AbstractMesh(shape, axes), _jax_mesh(shape, axes)
    p_specs, _ = model_shardings(model, ours_mesh)
    jshapes = _jax_param_shapes(arch)
    jp = jax_sharding._dims_tree_specs(
        jshapes, JaxModel(jax_get_config(arch)).param_dims(), jax_mesh, "param")
    params = model.init(0)
    got = sharded_bytes(params, p_specs, ours_mesh)
    assert got == jax_sharded_bytes(jshapes, jp, jax_mesh)
    # the unsharded bytes over the mesh size bound it from below
    total = sharded_bytes(params, jax.tree.map(
        lambda s: (), p_specs, is_leaf=lambda x: isinstance(x, tuple)),
        ours_mesh)
    assert total / math.prod(shape) <= got <= total


def test_placements_on_an_abstract_mesh():
    mesh = AbstractMesh((2, 4, 8), ("pod", "data", "model"))
    assert mesh_axes(mesh) == {"pod": 2, "data": 4, "model": 8}
    assert placements((("pod", "data"), None, "model"), mesh) == (
        Shard(0), Shard(0), Shard(2))
    assert placements(("model", "data"), mesh) == (Replicate(), Shard(1),
                                                   Shard(0))
    assert placements((), mesh) == (Replicate(),) * 3
    with pytest.raises(ValueError, match="order"):
        placements((("data", "pod"),), mesh)


def test_production_mesh_shapes_and_world_check():
    assert production_mesh_shape() == ((16, 16), ("data", "model"))
    assert production_mesh_shape(multi_pod=True) == (
        (2, 16, 16), ("pod", "data", "model"))
    # no process group here: a world of one rank
    with pytest.raises(ValueError, match="needs 256 ranks; the world has 1"):
        make_production_mesh(device="cpu")
    with pytest.raises(ValueError, match="needs 512 ranks; the world has 1"):
        make_production_mesh(multi_pod=True, device="cpu")
