"""The tool behind the limits: the readings of a cell's program and
control, on the CPU at a tiny size."""
import pytest

from cdbench.tools.readings import readings
from conftest import TINY, TINY_SERVE


def test_readings_give_program_and_control_numbers():
    out = list(readings("book_full.serve", [1, 2], {2}, 0.3, "cpu", TINY,
                        TINY_SERVE))
    assert [r["seed"] for r in out] == [1, 2]
    assert "control" not in out[0] and "control" in out[1]
    assert out[1]["program"]["decisions_wrong"] == 0
    assert out[1]["control"]["score_gap"] > out[1]["program"]["score_gap"]


@pytest.mark.parametrize("probs", ["oracle", "vote"])
def test_readings_of_a_pass_report_its_counts(probs):
    (r,) = readings("book_full.pass", [4], {4}, 0.1, "cpu",
                    {**TINY, "claim_probs": probs, "data_seed": 3})
    assert r["program"]["decisions_wrong"] == 0
    assert r["control"]["score_gap"] > r["program"]["score_gap"]
    assert r["unit_stats"]["rescored_pairs"] > 0
