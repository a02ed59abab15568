"""Each per-layer metric's file states the unit, layer and `moves` that
`BENCHMARK.json` gives it; each configuration, mix and limit file that a
cell names exists."""
from helpers import ROOT, benchmark


def test_metric_files_match_the_benchmark():
    from slambench import harness

    for m in benchmark()["per_layer"]:
        mod = harness.load_metric(ROOT, m["name"])
        assert (mod.UNIT, mod.LAYER, mod.MOVES, mod.SOURCE) == \
            (m["unit"], m["layer"], m["moves"], m["source"]), m["name"]


def test_every_cell_has_its_files():
    from slambench import harness

    spec = benchmark()
    for w in spec["workloads"]:
        cell = harness.load_cell(ROOT, w["name"])
        assert cell.limits and cell.mix["robots"] >= 1 and cell.config["slam"]
    for c in spec["configs"]:
        assert (ROOT / c["file"]).exists()


def test_roofline_counts():
    from slambench import roofline

    flops, nbytes = roofline.vgicp_launch(8, 16384)
    assert flops == 8 * 16384 * 169
    pct, bound = roofline.share(flops, nbytes, 6e-6)
    assert bound == "memory" and 0.0 < pct < 100.0
