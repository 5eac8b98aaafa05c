"""A run end to end on the CPU at a tiny size, through ``run_cell`` (the
entry under ``run.py``'s look for a card), and the command's refusals."""
import json
import math
import os
import shutil
import subprocess
import sys

import pytest

from cdbench.harness import ROOT, cell_metrics, load_json, run_cell
from conftest import TINY, TINY_SERVE

BENCH = load_json(ROOT / "BENCHMARK.json")
CELLS = [w["name"] for w in BENCH["workloads"]]


def tiny(cell: str) -> dict:
    return TINY_SERVE if "serve" in cell else {}


@pytest.mark.parametrize("cell", CELLS)
def test_tiny_cell_prints_a_well_formed_line(cell):
    line, checks, _ = run_cell(cell, 2**31 + 99, 0.3, False, "cpu", 0.0,
                               overrides=TINY, traffic_overrides=tiny(cell))
    json.loads(json.dumps(line))
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "checks"]
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] >= 1
    want = {m["name"] for m in cell_metrics(BENCH, cell, "end_to_end")}
    assert set(line["metrics"]) == want
    for m in line["metrics"].values():
        assert math.isfinite(m["value"]) and m["value"] > 0
    assert set(line["device"]) == {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    assert set(checks) == {"decisions_wrong", "score_gap", "missing"}
    assert line["checks"] == checks


SCRIPT = r"""
import json, sys
sys.path[:0] = [{root!r}, {src!r}]
from cdbench.harness import run_cell, forbidden_modules
sys.path.insert(0, {tests!r})
from conftest import TINY, TINY_SERVE
tr = TINY_SERVE if "serve" in {cell!r} else {{}}
line, _, _ = run_cell({cell!r}, 5, 0.2, False, "cpu", 0.0,
                      overrides=TINY, traffic_overrides=tr)
print(json.dumps({{"correct": line["correct"], "bad": forbidden_modules(),
                  "loaded": sorted({{m.split(".")[0] for m in sys.modules}})}}))
"""


@pytest.mark.parametrize("cell", CELLS)
def test_a_run_loads_neither_jax_nor_the_jax_package(cell):
    code = SCRIPT.format(root=str(ROOT), src=str(ROOT / "src"),
                         tests=os.path.dirname(__file__), cell=cell)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["bad"] == []
    assert "repro_torch" in res["loaded"]
    assert not {"jax", "jaxlib", "flax", "repro"} & set(res["loaded"])


def _command(cwd, *args):
    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTHONPATH", "CUDA_VISIBLE_DEVICES")}
    return subprocess.run(["python3", "cdbench/run.py", *args],
                          capture_output=True, text=True, cwd=cwd, env=env,
                          timeout=300)


def test_command_without_a_card_exits_without_a_result():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = _command(ROOT, "--workload", CELLS[0], "--seed", "1",
                   "--seconds", "1", "--trace", "0")
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def test_command_in_a_bare_checkout_exits_without_a_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "cdbench", tmp_path / "cdbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _command(tmp_path, "--workload", CELLS[0], "--seed", "1",
                   "--seconds", "1", "--trace", "0")
    assert out.returncode != 0
    assert out.stdout.strip() == ""


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_tiny_cell_on_the_card(cell, cuda):
    line, _, _ = run_cell(cell, 3, 0.5, True, cuda, 0.0, overrides=TINY,
                          traffic_overrides=tiny(cell))
    assert line["correct"] and line["device"]["platform"] == "gpu"
    assert line["device"]["busy_s"] > 0
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}


def test_main_prints_the_line_last_and_the_checks_last_on_stderr(
        monkeypatch, capsys):
    from cdbench import harness
    monkeypatch.setattr(harness.torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(harness.torch.cuda, "device_count", lambda: 1)
    real = harness.run_cell

    def on_cpu(name, seed, seconds, trace, device, t_start, **kw):
        return real(name, seed, seconds, trace, "cpu", t_start,
                    overrides=TINY, traffic_overrides=tiny(name))

    monkeypatch.setattr(harness, "run_cell", on_cpu)
    cell = "book_full.serve"
    rc = harness.main(["--workload", cell, "--seed", str(2**31 + 7),
                       "--seconds", "0.3", "--trace", "0"], 0.0)
    out, err = capsys.readouterr()
    assert rc == 0
    line = json.loads(out.strip().splitlines()[-1])
    assert line["correct"] and list(line)[-1] == "checks"
    tail = err.strip().splitlines()[-3:]
    assert [t.split()[1] for t in tail] == list(line["checks"])
    assert any(t.startswith("service batches") and "cache_hits 0" in t
               for t in err.splitlines())


def test_the_config_chooses_the_truth_probabilities():
    import numpy as np
    from cdbench.harness import cell_files, make_context
    files = cell_files(BENCH, "book_full.pass")
    ctx = make_context("book_full.pass", 1, "cpu", files,
                       {**TINY, "claim_probs": "vote"})
    claimed = ctx.world.values >= 0
    assert np.unique(ctx.p_claim[claimed]).size > 50
    oracle = make_context("book_full.pass", 1, "cpu", files, TINY)
    assert set(np.unique(oracle.p_claim[claimed]).tolist()) == {
        np.float32(0.95), np.float32(0.02)}
