"""The readers of the metrics on the program's sync, capture and
loop-correction counters, its solve-preparation span and the front-end's
share of the idle gaps: each reads the right number from a hand-made
context, and 0 or nothing where what it reads is absent."""
import pytest

from helpers import ROOT

GATE = "online.frontend.gate_read"  # every call of a program with the counters opens it


def ctx(spans=None, counters=None, profile=None, calls=4):
    from slambench import harness

    return harness.Context(spans=spans or {}, counters=counters or {}, captures=0,
                           profile=profile, cfg=None, roofline=None, calls_s=[0.05] * calls)


def read(name, c):
    from slambench import harness

    return harness.load_metric(ROOT, name).read(c)


def test_host_syncs_per_frame():
    c = ctx(spans={GATE: (4, 0.001)},
            counters={"sync.frontend.gate": 4.0, "sync.frontend.project": 16.0,
                      "sync.loop.retrieve": 6.0, "loops.candidates": 9.0})
    assert read("host_syncs_per_frame", c) == pytest.approx(26.0 / 4)
    assert read("host_syncs_per_frame", ctx(spans={GATE: (4, 0.001)})) == 0.0
    assert read("host_syncs_per_frame", ctx(counters={"sync.tf": 2.0})) is None
    assert read("host_syncs_per_frame", ctx(spans={GATE: (4, 0.001)}, calls=0)) is None


def test_frontend_idle_share():
    gaps = [["online.frontend", 0.8], ["online.solve", 0.5], ["online.frontend.project", 0.4],
            ["online.frontend.gate_read", 0.2], ["bench.host", 0.1], ["online.frontends", 0.3]]
    p = dict(busy_s=3.0, window_s=5.0, idle_gaps=gaps, ops={}, device_ops=[])
    assert read("frontend_idle_share", ctx(profile=p)) == pytest.approx(100.0 * 1.4 / 5.0)
    assert read("frontend_idle_share", ctx(profile=dict(p, idle_gaps=[]))) == 0.0
    assert read("frontend_idle_share", ctx(profile=None)) is None
    assert read("frontend_idle_share", ctx(profile=dict(p, busy_s=0.0))) is None


def test_solve_prepare_ms_mean():
    c = ctx(spans={"online.solve.prepare": (4, 0.02), "online.solve": (4, 1.6)})
    assert read("solve_prepare_ms.mean", c) == pytest.approx(5.0)
    assert read("solve_prepare_ms.mean", ctx(spans={"online.solve": (4, 1.6)})) is None


def test_loop_correction_ms_mean():
    c = ctx(counters={"loops.corrected": 4.0, "loops.correction_s": 2.0})
    assert read("loop_correction_ms.mean", c) == pytest.approx(500.0)
    assert read("loop_correction_ms.mean", ctx(counters={"loops.accepted": 3.0})) is None


def test_graph_capture_s():
    c = ctx(spans={GATE: (4, 0.001)},
            counters={"graph.solve.capture_s": 0.5, "graph.solve.eager_s": 2.25,
                      "graph.verify.capture_s": 0.25, "graph.solve.captures": 2.0,
                      "sync.solve.plan": 3.0})
    assert read("graph_capture_s", c) == pytest.approx(3.0)
    assert read("graph_capture_s", ctx(spans={GATE: (4, 0.001)})) == 0.0
    assert read("graph_capture_s", ctx(counters={"graph.solve.capture_s": 0.5})) is None
