"""The check's control: the reference computed from bfloat16 inputs in
the program's place comes out as not correct, on every cell."""
import pytest

from helpers import CELLS, run


@pytest.mark.parametrize("cell", CELLS)
def test_bf16_control_is_not_correct(cell):
    res = run(cell, control=True)
    assert res["correct"] is False
    failed = [n for n, c in res["checks"].items() if c["value"] is None or c["value"] > c["limit"]]
    assert "frontend_t_gap_m" in failed and "solve_t_gap_m" in failed
