"""The span readers (``rechunk_s.pass``, ``index_build_sort_s.pass``,
``rechunk_s.serve``, ``commit_s.serve``, ``rescore_s.serve``,
``batch_s.serve``) on a tiny run of each cell on the CPU through
``run_cell``, and on a run whose program records no spans."""
import math

import pytest

from cdbench.harness import ROOT, Run, Unit, load_json, load_module, run_cell
from conftest import TINY, TINY_SERVE

BENCH = load_json(ROOT / "BENCHMARK.json")
READERS = {"book_full.pass": ["rechunk_s.pass", "index_build_sort_s.pass"],
           "book_full.serve": ["rechunk_s.serve", "commit_s.serve",
                               "rescore_s.serve", "batch_s.serve"]}


def reader(name):
    return load_module(ROOT / "cdbench" / "metrics" / f"{name}.py").read


@pytest.fixture(scope="module", params=sorted(READERS))
def cell_run(request):
    cell = request.param
    tr = TINY_SERVE if "serve" in cell else {}
    line, _, run = run_cell(cell, 2**31 + 17, 0.3, False, "cpu", 0.0,
                            overrides=TINY, traffic_overrides=tr)
    assert line["correct"]
    return cell, run


def test_each_reader_is_finite_and_positive(cell_run):
    cell, run = cell_run
    for name in READERS[cell]:
        v = reader(name)(run)
        assert v is not None and math.isfinite(v) and v > 0, name


def test_the_parts_fit_inside_their_whole(cell_run):
    cell, run = cell_run
    if cell == "book_full.pass":
        assert reader("rechunk_s.pass")(run) <= reader("prologue_s.pass")(run)
        assert (reader("index_build_sort_s.pass")(run)
                <= reader("index_build_s.pass")(run))
    else:
        parts = sum(reader(n)(run) for n in ("rechunk_s.serve",
                                             "commit_s.serve",
                                             "rescore_s.serve"))
        assert parts <= reader("batch_s.serve")(run)


def test_the_new_entries_name_their_readers_and_one_cell_each():
    entries = {m["name"]: m for m in BENCH["per_layer"]}
    for cell, names in READERS.items():
        for name in names:
            m = entries[name]
            assert m["source"] == "program_span" and m["unit"] == "s"
            assert m["workloads"] == [cell]
            assert (ROOT / "cdbench" / "metrics" / f"{name}.py").is_file()


class _NoSpans:
    """A service's stats as a program without spans has them."""
    batches = 3


@pytest.mark.parametrize("name", sorted(n for v in READERS.values()
                                        for n in v))
def test_a_program_without_spans_reads_none(name):
    run = Run(window_t0=0.0, window_t1=1.0,
              units=[Unit(t0=0.0, t1=1.0, ok=True,
                          stats={"prologue_s": 0.5})],
              extra={"service": _NoSpans()})
    assert reader(name)(run) is None
    assert reader(name)(Run()) is None
