"""The port's offline pose-graph runner (`examples/run_pgo_g2o.py`) on a
small g2o file written with the port's `eval/g2o`, for both optimizers,
against the reference runner's `graph_chi2` on the same graph.

The graph: `graphgen.multi_robot_graph` with two robots of 30 nodes and
inter-robot loops. Bounds: the optimized graph's chi2 well below the
drifted one's; the runner's result equal to calling the optimizer on
the imported graph (the same code, bit for bit); the written file reads
back with the optimized poses to the text format's 1e-6; chi2 of the
input graph within 1e-4 relative of the reference runner's."""
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from mr_slam_torch.backend import chordal, gauss_seidel
from mr_slam_torch.eval import g2o, graphgen
from mr_slam_torch.examples import run_pgo_g2o

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def graph_file(tmp_path_factory):
    g, *_ = graphgen.multi_robot_graph(n_robots=2, nodes_per_robot=30, radius=12.0, laps=1.2,
                                       loop_stride=6, min_separation=10, seed=4, device="cpu")
    path = tmp_path_factory.mktemp("g2o") / "in.g2o"
    g2o.export_g2o(str(path), g)
    return path


@pytest.mark.parametrize("gs", (False, True), ids=("chordal", "gauss_seidel"))
def test_runner_optimizes(graph_file, tmp_path, gs):
    out = tmp_path / "out.g2o"
    rec = run_pgo_g2o.run(str(graph_file), str(out), gauss_seidel=gs, device="cpu")
    assert rec["optimizer"] == ("gauss_seidel" if gs else "chordal_gn")
    assert rec["robots"] == 2 and rec["nodes"] == 60
    assert rec["chi2_post"] < 0.2 * rec["chi2_pre"], rec
    g = g2o.import_g2o(str(graph_file))
    anchors = torch.zeros(g.node_capacity, dtype=torch.bool)
    anchors[0] = anchors[30] = True
    opt = gauss_seidel.optimize(g, anchors, 2) if gs else chordal.optimize(g, anchors)
    assert run_pgo_g2o.graph_chi2(g, opt) == rec["chi2_post"]
    back = g2o.import_g2o(str(out))
    np.testing.assert_allclose(back.poses.t.numpy(), opt.t.numpy(), atol=1e-6, rtol=0)


def test_chi2_matches_reference(graph_file):
    import jax.numpy as jnp
    import importlib.util

    from mr_slam_tpu.eval import g2o as jg2o

    spec = importlib.util.spec_from_file_location("ref_run_pgo_g2o",
                                                  ROOT / "examples" / "run_pgo_g2o.py")
    ref = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ref)
    jg = jg2o.import_g2o(str(graph_file))
    g = g2o.import_g2o(str(graph_file))
    want = ref.graph_chi2(jg, jg.poses)
    assert jnp.isfinite(want)
    np.testing.assert_allclose(run_pgo_g2o.graph_chi2(g, g.poses), want, rtol=1e-4)


def test_cli_prints_one_json_line(graph_file):
    out = subprocess.run([sys.executable, "-m", "mr_slam_torch.examples.run_pgo_g2o",
                          str(graph_file), "--device", "cpu", "--gn-iters", "4"],
                         cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    rec = json.loads(out.stdout.strip().splitlines()[-1])
    assert rec["chi2_post"] < rec["chi2_pre"] and rec["device"] == "cpu"


def test_runner_defaults_to_the_card(graph_file):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run_pgo_g2o.run(str(graph_file))
