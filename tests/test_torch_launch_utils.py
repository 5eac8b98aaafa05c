"""The port's single-card launch and runtime utilities against the JAX
package's: ``utils.timing`` (``Timer``, ``timed``) under one patched clock,
``runtime.platform``'s ``autotune`` / ``load_autotune`` on the CPU with a
fake timing function (the same JSON as JAX's; a corrupt or partial cache
reads as None; ``force=True`` sweeps again), and ``launch.roofline``:
``Roofline.finalize`` (JAX's with the card's constants patched in),
``count_params`` (total and active) and ``model_flops_for`` for every
arch of the registry at every shape. The full-size parameter trees are
JAX's ``eval_shape`` of ``Model.init`` as ``meta`` tensors (the port's
trees have JAX's layout, ``tests/test_torch_models.py``); at reduced
size the port's own initialised tree is counted too. Everything is exact:
the same arithmetic in the same order.
"""
import torch_threads  # noqa: F401  (caps torch's threads a worker)
import itertools
import json
import time

import jax
import pytest
import torch

from repro.configs import ARCH_IDS as JAX_ARCH_IDS
from repro.configs import SHAPES as JAX_SHAPES
from repro.configs import get_config as jax_get_config
from repro.launch import roofline as jax_roofline
from repro.models import Model as JaxModel
from repro.runtime import platform as jax_platform
from repro.utils.timing import Timer as JaxTimer
from repro.utils.timing import timed as jax_timed
from repro_torch.configs import ARCH_IDS, SHAPES, get_config
from repro_torch.launch import roofline
from repro_torch.models import Model
from repro_torch.runtime import platform
from repro_torch.utils import Timer, timed

SWEEP_WALL = {(128, 1): 0.51234, (128, 2): 0.40001, (256, 1): 0.39999,
              (256, 2): 0.6}


def _drive(timer_cls, timed_fn):
    """One fixed sequence of sections, nested and repeated, and one
    section that raises."""
    t, out = timer_cls(), {}
    with t.section("scan"):
        with timed_fn(out, "inner"):
            pass
    with t.section("finalize"):
        pass
    with t.section("scan"):
        pass
    with pytest.raises(ValueError):
        with t.section("boom"):
            raise ValueError
    with timed_fn(out, "inner"):
        pass
    return t, out


def test_timer_and_timed_match_jax(monkeypatch):
    results = []
    for timer_cls, timed_fn in ((JaxTimer, jax_timed), (Timer, timed)):
        clock = itertools.count(start=0.25, step=0.375)
        monkeypatch.setattr(time, "perf_counter", lambda: next(clock))
        t, out = _drive(timer_cls, timed_fn)
        results.append((t.totals, t.counts, t.summary(), t.total("scan"),
                        t.total("absent"), out))
    assert results[0] == results[1]
    assert results[1][1] == {"scan": 2, "finalize": 1, "boom": 1}


def _fake_run(calls):
    def run_fn(tile, group):
        calls.append((tile, group))
        return SWEEP_WALL[(tile, group)]
    return run_fn


def test_autotune_writes_jax_json_and_reads_it_back(tmp_path):
    calls, jcalls = [], []
    port_dir, jax_dir = str(tmp_path / "port"), str(tmp_path / "jax")
    won = platform.autotune(_fake_run(calls), cache_dir=port_dir, device="cpu")
    jwon = jax_platform.autotune(_fake_run(jcalls), cache_dir=jax_dir)
    assert jax.default_backend() == "cpu" == platform.device_key("cpu")
    assert won == jwon and calls == jcalls and len(calls) == 4
    # walls are rounded to 4 places before the minimum, as JAX's: 0.40001
    # and 0.39999 tie at 0.4, and the first point of the sweep wins
    assert (won["tile"], won["chunk_group"], won["wall_s"]) == (128, 2, 0.4)
    with open(tmp_path / "port" / "cpu.json") as f, \
            open(tmp_path / "jax" / "cpu.json") as g:
        assert f.read() == g.read()
    assert platform.load_autotune(port_dir, device="cpu") == won
    # a cache answers without sweeping; force sweeps again
    assert platform.autotune(_fake_run(calls), cache_dir=port_dir,
                             device="cpu") == won and len(calls) == 4
    platform.autotune(_fake_run(calls), cache_dir=port_dir, device="cpu",
                      force=True)
    assert len(calls) == 8


@pytest.mark.parametrize("content", ["{not json", '{"tile": 128}', ""])
def test_corrupt_or_partial_cache_reads_as_none(tmp_path, content):
    (tmp_path / "cpu.json").write_text(content)
    assert platform.load_autotune(str(tmp_path), device="cpu") is None
    assert jax_platform.load_autotune(str(tmp_path)) is None
    calls = []
    won = platform.autotune(_fake_run(calls), cache_dir=str(tmp_path),
                            device="cpu")
    assert len(calls) == 4 and json.loads((tmp_path / "cpu.json").read_text()) == won


def test_device_key():
    assert platform.device_key("cpu") == "cpu"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            platform.device_key(None)
    assert platform.AUTOTUNE_DIR == jax_platform.AUTOTUNE_DIR


def test_roofline_finalize_matches_jax_with_the_cards_constants(monkeypatch):
    for name, value in (("PEAK_FLOPS_BF16", roofline.PEAK_FLOPS_BF16),
                        ("HBM_BW", roofline.HBM_BW),
                        ("ICI_BW", roofline.NVLINK_BW)):
        monkeypatch.setattr(jax_roofline, name, value)
    assert (roofline.PEAK_FLOPS_BF16, roofline.HBM_BW) == (989e12, 3.35e12)
    for terms in ((4.2e15, 1.1e12, 3.0e10, 2.9e15),   # compute-bound
                  (1.0e12, 9.0e11, 1.0e9, 0.0),       # memory-bound
                  (1.0e9, 1.0e9, 4.5e11, 1.0e9)):     # link-bound
        kw = dict(flops_per_device=terms[0], hbm_bytes_per_device=terms[1],
                  collective_bytes_per_device=terms[2], model_flops=terms[3])
        got = roofline.Roofline(**kw).finalize(chips=1)
        want = jax_roofline.Roofline(**kw).finalize(chips=1)
        assert vars(got) == vars(want)
    assert [roofline.Roofline(1e12, 1e9, 0).finalize(1).bottleneck,
            roofline.Roofline(1, 1e12, 0).finalize(1).bottleneck,
            roofline.Roofline(1, 1, 1e12).finalize(1).bottleneck] == [
        "compute", "memory", "collective"]


def _frac(cfg):
    return cfg.top_k / cfg.n_experts if cfg.n_experts else 1.0


def _meta(shapes):
    return jax.tree.map(lambda s: torch.empty(s.shape, device="meta"), shapes)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_count_params_and_model_flops_match_jax(arch):
    assert ARCH_IDS == JAX_ARCH_IDS and list(SHAPES) == list(JAX_SHAPES)
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    shapes = jax.eval_shape(JaxModel(jcfg).init, jax.random.PRNGKey(0))
    got = roofline.count_params(_meta(shapes), active_expert_frac=_frac(cfg))
    want = jax_roofline.count_params(shapes, active_expert_frac=_frac(jcfg))
    assert got == want and got[1] < got[0]
    for name, shape in SHAPES.items():
        assert (roofline.model_flops_for(cfg, shape, *got)
                == jax_roofline.model_flops_for(jcfg, JAX_SHAPES[name], *want))
    # the port's own initialised tree, at reduced size
    small = dict(d_model=256, d_ff=256, vocab=128)
    params = Model(cfg.reduced(**small), device="cpu").init(seed=0)
    jsmall = jax.eval_shape(JaxModel(jcfg.reduced(**small)).init,
                            jax.random.PRNGKey(0))
    assert (roofline.count_params(params, active_expert_frac=_frac(cfg))
            == jax_roofline.count_params(jsmall, active_expert_frac=_frac(jcfg)))
