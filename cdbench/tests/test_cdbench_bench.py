"""``BENCHMARK.json`` against the contract, and every cell resolving to its
files by name."""
import ast
import json
import os
import re

import pytest

from cdbench.harness import ROOT, cell_files, cell_metrics, load_module

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]
KEYS = {"configs": {"name", "source", "file", "reduced", "why"},
        "workloads": {"name", "config", "traffic", "chips", "why"},
        "end_to_end": {"name", "unit", "better", "bound", "source"},
        "per_layer": {"name", "unit", "better", "source", "layer", "moves"}}


def test_top_level_keys_and_limits():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    assert BENCH["command"] == ["python3", "cdbench/run.py"]
    assert BENCH["paths"] == ["cdbench"]
    assert len(json.dumps(BENCH)) < 64 * 1024
    names = set()
    for kind, keys in KEYS.items():
        for e in BENCH[kind]:
            extra = {"workloads"} if kind in ("end_to_end", "per_layer") else set()
            assert keys <= set(e) <= keys | extra, (kind, e["name"])
            assert NAME.match(e["name"]), e["name"]
            if kind in ("end_to_end", "per_layer"):
                assert e["name"] not in names
                names.add(e["name"])
                assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
            for text in ("why", "layer", "source"):
                if text in e:
                    assert 1 <= len(e[text]) <= 200, (e["name"], text)
                    assert not set(e[text]) & {"\n", "\t"}


def test_metric_rules():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    layers = {}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        if "roofline" in m["name"]:
            assert m["unit"] == "%"
        layers.setdefault(m["layer"].lower(), set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())


@pytest.mark.parametrize("cell", CELLS)
def test_cell_resolves_to_its_files(cell):
    files = cell_files(BENCH, cell)
    for key in ("config", "traffic", "limits", "driver"):
        assert files[key].is_file(), (cell, key)
    for kind in ("end_to_end", "per_layer"):
        for entry, path in files["metrics"][kind]:
            assert path.is_file(), path
            mod = load_module(path)
            assert callable(mod.read)
            # the name, unit, layer and what it moves are BENCHMARK.json's
            assert not {"NAME", "UNIT", "LAYER", "MOVES"} & set(vars(mod))
    driver = load_module(files["driver"])
    for fn in ("setup", "window", "release", "check"):
        assert callable(getattr(driver, fn))


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_reports_setup_another_and_a_layer(cell):
    e2e = {m["name"] for m in cell_metrics(BENCH, cell, "end_to_end")}
    assert "setup_s" in e2e and len(e2e) >= 2
    layer = cell_metrics(BENCH, cell, "per_layer")
    assert layer
    moved = {m["moves"] for m in layer}
    assert moved <= e2e


def test_per_layer_metrics_cover_every_cell_reporting_what_they_move():
    for m in BENCH["per_layer"]:
        reporting = {c for c in CELLS
                     if m["moves"] in {e["name"] for e in
                                       cell_metrics(BENCH, c, "end_to_end")}}
        assert set(m.get("workloads", reporting)) == reporting, m["name"]


def test_configs_are_used_and_reduced_names_no_width():
    used = {w["config"] for w in BENCH["workloads"]}
    for c in BENCH["configs"]:
        assert c["name"] in used
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["reduced"] == c["reduced"]
        for k in c["reduced"]:
            assert not k.endswith(("_dim", "_rank")) and k in cfg
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(set(pairs)) == len(pairs)
    assert all(w["chips"] == 1 for w in BENCH["workloads"])


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_no_source_imports_jax_or_the_jax_package_or_reads_benchmarks():
    base = ROOT / "cdbench"
    for dirpath, _, files in os.walk(base):
        for f in files:
            if not f.endswith(".py"):
                continue
            path = os.path.join(dirpath, f)
            tops = {m.split(".", 1)[0] for m in _imports(path)}
            assert not tops & {"jax", "jaxlib", "flax", "repro"}, path
            assert "bench" + "marks/" not in open(path).read(), path
    reference = base / "reference"
    for f in reference.glob("*.py"):
        tops = {m.split(".", 1)[0] for m in _imports(f)}
        assert "repro_torch" not in tops, f
