"""The comparison fails what it must: the control (the reference in
bfloat16 in the program's place) and the timed path broken underneath a
run, at a size the CPU holds. On the card at the cells' own sizes the
control runs through ``tools/readings.py``."""
import numpy as np
import pytest

from cdbench.harness import ROOT, load_json, run_cell
from conftest import TINY, TINY_SERVE

BENCH = load_json(ROOT / "BENCHMARK.json")
CELLS = [w["name"] for w in BENCH["workloads"]]
SEEDS = [11, 2**31 + 3, 987654321]


def run(cell, seed=11, control=False):
    tr = TINY_SERVE if "serve" in cell else {}
    line, checks, _ = run_cell(cell, seed, 0.3, False, "cpu", 0.0,
                               overrides=TINY, traffic_overrides=tr,
                               control=control)
    return line, checks


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cell, seed):
    line, checks = run(cell, seed, control=True)
    assert line["correct"] is False
    assert checks["score_gap"]["value"] > checks["score_gap"]["limit"]


def _altered(detect):
    """An answer altered where it is produced: the pair the engine is surest
    copies is reported independent."""
    def wrapped(self, *a, **kw):
        res = detect(self, *a, **kw)
        if res.copying.any():
            c = np.where(res.copying, res.c_fwd + res.c_fwd.T, -np.inf)
            i, j = np.unravel_index(np.argmax(c), c.shape)
            res.copying[i, j] = res.copying[j, i] = False
        return res
    return wrapped


def _unchanged(detect):
    """A step that returns its state unchanged: the engine's initial answer
    (nothing scored, nothing copying) instead of its pass."""
    def wrapped(self, ds, *a, **kw):
        res = detect(self, ds, *a, **kw)
        res.c_fwd[:] = 0.0
        res.copying[:] = False
        return res
    return wrapped


@pytest.mark.parametrize("fault", [_altered, _unchanged])
@pytest.mark.parametrize("cell", [c for c in CELLS if "serve" not in c])
def test_a_broken_timed_path_is_not_correct(cell, fault, monkeypatch):
    from repro_torch.core.engine import DetectionEngine
    monkeypatch.setattr(DetectionEngine, "detect",
                        fault(DetectionEngine.detect))
    line, _ = run(cell)
    assert line["correct"] is False


def _altered_response(serve_batch):
    """A served answer altered where it is produced: each response's
    decision on its row's best-scored corpus source is flipped."""
    def wrapped(*a, **kw):
        out = serve_batch(*a, **kw)
        for resp in out:
            i, j = np.unravel_index(np.argmax(resp.c_fwd), resp.c_fwd.shape)
            resp.copying[i, j] = not resp.copying[i, j]
        return out
    return wrapped


def _unchanged_response(serve_batch):
    """A served pass that returns its state unchanged: nothing scored,
    nothing copying."""
    def wrapped(*a, **kw):
        out = serve_batch(*a, **kw)
        for resp in out:
            resp.c_fwd[:] = 0.0
            resp.copying[:] = False
        return out
    return wrapped


@pytest.mark.parametrize("fault", [_altered_response, _unchanged_response])
@pytest.mark.parametrize("cell", [c for c in CELLS if "serve" in c])
def test_a_broken_served_path_is_not_correct(cell, fault, monkeypatch):
    from repro_torch.core import serving
    monkeypatch.setattr(serving, "serve_batch", fault(serving.serve_batch))
    line, _ = run(cell)
    assert line["correct"] is False


@pytest.mark.parametrize("cell", [c for c in CELLS if "serve" in c])
def test_half_of_each_batch_left_out_is_not_correct(cell, monkeypatch):
    from repro_torch.core import serving
    real = serving.serve_batch

    def half(base, base_p, engine, requests, *a, **kw):
        keep = max(len(requests) // 2, 1)
        out = real(base, base_p, engine, requests[:keep], *a, **kw)
        for r in requests[keep:]:
            q, S = r.n_rows, base.n_sources
            out.append(serving.DetectResponse(
                rid=r.rid, copying=np.zeros((q, S), bool),
                pr_independent=np.ones((q, S), np.float32),
                c_fwd=np.zeros((q, S), np.float32),
                intra_copying=np.zeros((q, q), bool)))
        return out

    monkeypatch.setattr(serving, "serve_batch", half)
    line, _ = run(cell)
    assert line["correct"] is False


@pytest.mark.parametrize("cell", CELLS)
def test_the_unbroken_path_is_correct(cell):
    line, _ = run(cell)
    assert line["correct"] is True
