"""Each cell end to end on the CPU at a tiny size: the result has the
contract's keys, the cell's metrics with their units, the checks last
and every check within its limit (the program agrees with the reference
on every compared layer)."""
import json

import pytest

from helpers import CELLS, benchmark, run


@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_and_agrees_with_the_reference(cell):
    res = run(cell)
    spec = benchmark()
    assert list(res)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(res)[-1] == "checks"
    json.loads(json.dumps(res))  # one JSON object
    want = {m["name"]: m["unit"] for m in spec["end_to_end"]
            if "workloads" not in m or cell in m["workloads"]}
    assert {k: v["unit"] for k, v in res["metrics"].items()} == want
    assert all(v["value"] > 0 for v in res["metrics"].values())
    assert res["attempted"] > 0 and res["failed"] == 0
    assert res["device"]["count"] == 1 and res["device"]["platform"] == "cpu"
    for name, c in res["checks"].items():
        assert c["value"] is not None and c["value"] <= c["limit"], (name, c)
    assert res["correct"] is True


def test_traced_run_reports_the_per_layer_metrics():
    cell = "hdl32-lio-walk"
    res = run(cell, trace=True)
    spec = benchmark()
    layer = {m["name"]: m for m in spec["per_layer"]
             if "workloads" not in m or cell in m["workloads"]}
    assert set(res["metrics"]) <= set(layer)
    for name in ("frontend_ms.mean", "compose_ms.mean", "graph_captures"):
        assert name in res["metrics"]
    for name, m in res["metrics"].items():
        assert m["unit"] == layer[name]["unit"]
    assert "vgicp_accum_roofline" not in res["metrics"]  # no device trace on the CPU
    assert {"busy_s", "window_s"} <= set(res["device"])
    assert list(res)[-1] == "checks" and res["correct"] is True
