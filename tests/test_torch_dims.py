"""The logical-dims trees of the port's LM against the JAX package's.

- For every arch of the registry at full size: ``Model.param_dims``,
  ``Model.cache_dims`` and ``runtime.train_state_dims`` with AdamW and
  Adafactor, the parameters in float32 (no master) and in bfloat16 (a
  float32 master in the state), equal JAX's exactly. These are plain
  Python trees of dicts, lists and tuples of names; no array is made.
- On each arch's reduced config: every dims tree has the structure of the
  port's own tree (the parameters ``Model.init`` draws, the cache
  ``init_cache`` makes, the state ``Optimizer.init`` makes) and each
  dims tuple has its leaf's rank.
- ``Model(cfg, device="meta").init`` gives grok-1's full shapes without
  memory and ``Model.init``'s drawn values do not change on the CPU (the
  meta path takes no draws from the generator).
"""
import torch_threads  # noqa: F401  (caps torch's threads a worker)
import itertools

import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import Model as JaxModel
from repro.optim import adafactor as jax_adafactor
from repro.optim import adamw as jax_adamw
from repro.runtime.train_loop import train_state_dims as jax_train_state_dims
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.models import Model
from repro_torch.models.common import is_dims
from repro_torch.optim import adafactor, adamw
from repro_torch.runtime import train_state_dims

OPTIMIZERS = {"adamw": (adamw, jax_adamw), "adafactor": (adafactor, jax_adafactor)}
PARAM_DTYPES = ("float32", "bfloat16")
REDUCED = dict(d_model=256, d_ff=256, vocab=128)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_and_cache_dims_equal_jax(arch):
    ours = Model(get_config(arch), device="meta")
    theirs = JaxModel(jax_get_config(arch))
    assert ours.param_dims() == theirs.param_dims()
    assert ours.cache_dims() == theirs.cache_dims()


@pytest.mark.parametrize("arch,opt,param_dtype",
                         itertools.product(ARCH_IDS, OPTIMIZERS, PARAM_DTYPES))
def test_train_state_dims_equal_jax(arch, opt, param_dtype):
    ours_opt, jax_opt = OPTIMIZERS[opt]
    ours = Model(get_config(arch).replace(param_dtype=param_dtype),
                 device="meta")
    theirs = JaxModel(jax_get_config(arch).replace(param_dtype=param_dtype))
    got = train_state_dims(ours, ours_opt())
    assert got == jax_train_state_dims(theirs, jax_opt())
    assert ("master" in got["opt"]) == (param_dtype == "bfloat16")
    for has_master in (False, True):
        assert (ours_opt().state_dims(ours.param_dims(), has_master=has_master)
                == jax_opt().state_dims(theirs.param_dims(),
                                        has_master=has_master))


def _assert_matches(dims, tree, path="tree"):
    """Same dicts and lists; each dims tuple as long as its leaf's rank."""
    if is_dims(dims):
        assert isinstance(tree, torch.Tensor), path
        assert len(dims) == tree.dim(), (path, dims, tuple(tree.shape))
    elif isinstance(dims, dict):
        assert isinstance(tree, dict) and set(dims) == set(tree), path
        for k in dims:
            _assert_matches(dims[k], tree[k], f"{path}[{k!r}]")
    else:
        assert isinstance(dims, list) and isinstance(tree, list), path
        assert len(dims) == len(tree), path
        for i, (d, t) in enumerate(zip(dims, tree)):
            _assert_matches(d, t, f"{path}[{i}]")


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_dims_trees_match_the_ports_trees(arch):
    cfg = get_config(arch).reduced(**REDUCED)
    model = Model(cfg, device="cpu")
    params = model.init(seed=0)
    _assert_matches(model.param_dims(), params)
    _assert_matches(model.cache_dims(), model.init_cache(2, 16))
    for make in (adamw, adafactor):
        for dtype in PARAM_DTYPES:
            m = Model(cfg.replace(param_dtype=dtype), device="cpu")
            opt = make()
            p = m.init(seed=0)
            state = {"params": p, "opt": opt.init(p),
                     "step": torch.zeros((), dtype=torch.int64)}
            _assert_matches(train_state_dims(m, opt), state)


def test_meta_init_gives_shapes_without_draws():
    cfg = get_config("grok-1-314b")
    params = Model(cfg, device="meta").init(0)
    leaves = []
    stack = [params]
    while stack:
        t = stack.pop()
        if isinstance(t, dict):
            stack.extend(t.values())
        elif isinstance(t, list):
            stack.extend(t)
        else:
            leaves.append(t)
    assert all(t.device.type == "meta" for t in leaves)
    n = sum(t.numel() for t in leaves)
    assert n > 300e9, n                                 # 314 B parameters
    assert params["embed"].shape == (cfg.vocab_size, cfg.d_model)
    # the CPU draws stay what the generator gives from the seed
    small = get_config("llama3.2-1b").reduced(**REDUCED)
    a = Model(small, device="cpu").init(seed=3)
    gen = torch.Generator(device="cpu").manual_seed(3)
    want = torch.randn((small.vocab_size, small.d_model), generator=gen) * 0.02
    assert torch.equal(a["embed"], want)
