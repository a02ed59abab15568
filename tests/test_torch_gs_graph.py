"""The Gauss-Seidel solve's runner (`runtime/solve_graph.GSRunner`), which
replays a CUDA graph a sweep on the card, against the eager solve it
replaces (`gauss_seidel._optimize_eager`) and against the reference's
compiled solve (`mr_slam_tpu.backend.gauss_seidel.optimize`).

The runner calls the same sweeps on the same values as the eager solve,
so on one device the two agree bit for bit. On the CPU the runner runs
its segments eagerly; `padded` (from `test_torch_solve_graph`) makes
every plan the card's gather-sum plan, and `replayed` re-runs every
segment after its first call as a CUDA graph replays: the function it
first ran, on the buffers it first saw, writing into the outputs it
first returned. So the CPU checks that a later graph's arrays, plan and
robot labels flow through the static buffers, and that each replayed
sweep reads its index from the runner's counter, not from a value fixed
at capture. Against the reference the bounds are
`tests/test_torch_gauss_seidel.py`'s: ATE within 5 mm, poses within
0.1 m and 0.03 on rotation entries.

Graphs: the reference tests' two drifted circles tied by exact loops
(`tests/test_gauss_seidel.build_two_robot_graph`, 2 x 24 nodes, carried
across through numpy), at the reference tests' configs; and
`graphgen.multi_robot_graph` with 3 robots x 20 nodes (12 inter-robot
loops), where flagged initialization gates robot 2 out of the first two
rotation sweeps. The `gpu` test runs the runner on the card against the
eager solve there (the card machine has no JAX):

    python -m pytest --noconftest -o addopts= -m gpu tests/test_torch_gs_graph.py
"""
import numpy as np
import pytest
import torch

from mr_slam_torch.backend import gauss_seidel as gs
from mr_slam_torch.eval import graphgen
from mr_slam_torch.runtime import frame_graph, solve_graph
from test_torch_solve_graph import _copy_into, assert_same, with_loops
from test_torch_solve_graph import padded  # noqa: F401 (a fixture)
from torch_parity import graph_to_jax, graph_to_torch

# the reference tests' configs (`tests/test_gauss_seidel.py`) by variant:
# (two-robot graph seed, config)
VARIANTS = {
    "gauss_seidel": (0, gs.GSConfig(rot_sweeps=15, pose_sweeps=15, cg_iters=12)),
    "jacobi_gamma": (1, gs.GSConfig(rot_sweeps=20, pose_sweeps=20, cg_iters=12, jacobi=True,
                                    gamma=0.8)),
    "no_flagged_init": (2, gs.GSConfig(rot_sweeps=10, pose_sweeps=10, cg_iters=15,
                                       flagged_init=False)),
    "cg1": (0, gs.GSConfig(rot_sweeps=15, pose_sweeps=15, cg_iters=1)),
}
THREE = dict(n_robots=3, nodes_per_robot=20, radius=10.0, laps=1.5, loop_stride=4,
             min_separation=8)
SMALL = gs.GSConfig(rot_sweeps=4, pose_sweeps=3, cg_iters=4)
# a loop edge between robot 0's node 5 and robot 2's node 45, both of
# degree 2: another graph under the same key (plan width 8)
EXTRA_LOOP = (5, 45)


def two_robot(seed: int):
    """(reference graph, port graph, true positions, anchors: node 0)."""
    from tests.test_gauss_seidel import build_two_robot_graph

    jg, true_t = build_two_robot_graph(seed=seed)
    anchors = torch.zeros(jg.node_capacity, dtype=torch.bool)
    anchors[0] = True
    return jg, graph_to_torch(jg), np.asarray(true_t), anchors


def three_robot(dev="cpu"):
    """(graph, true poses, anchors: each robot's first node)."""
    g, true, anchors, _ = graphgen.multi_robot_graph(**THREE, seed=0, device=dev)
    return g, true, anchors


def relabeled(g):
    """`g` with robots 1 and 2 swapped: the same arrays of one key, other
    blocks and another join order."""
    robot = g.node_robot.clone()
    robot[g.node_robot == 1], robot[g.node_robot == 2] = 2, 1
    return g._replace(node_robot=robot)


@pytest.fixture
def replayed(monkeypatch):
    """`Segments.run` as graph replays, per runner: the first call of a
    runner's segment runs it and keeps the function, the buffer dict it
    saw and the outputs it gave; every later call runs that function on
    those buffers and writes the results into those outputs. Starts from
    no runner."""
    calls = {}

    def run(self, name, fn, bufs):
        key = (self, name)
        if key not in calls:
            calls[key] = (fn, dict(bufs), fn(bufs))
            return calls[key][2]
        first, seen, out = calls[key]
        _copy_into(out, first(seen))
        return out

    solve_graph.clear()
    monkeypatch.setattr(frame_graph.Segments, "run", run)
    yield calls
    solve_graph.clear()


@pytest.mark.parametrize("plan", ["padded", "index"])
@pytest.mark.parametrize("variant", VARIANTS)
def test_runner_equals_eager_solve(request, replayed, variant, plan):
    """Three solves of one graph (the runner's eager first solve, then
    its replayed sweeps) bit for bit, on the card's plan and the CPU's:
    one runner, rot_sweeps + pose_sweeps segment runs a solve."""
    if plan == "padded":
        request.getfixturevalue("padded")
    seed, cfg = VARIANTS[variant]
    _, g, _, anchors = two_robot(seed)
    want = gs._optimize_eager(g, anchors, 2, cfg)
    for _ in range(3):
        assert_same(gs.optimize(g, anchors, 2, cfg), want)
    (runner,) = solve_graph.gs_stats()
    assert runner["solves"] == 3 and runner["robots"] == 2
    assert runner["width"] == (None if plan == "index" else 4)  # node degrees 3 and below
    assert set(name for _, name in replayed) == {"rot", "pose"}


def test_replayed_sweeps_gate_as_eager_sweeps(padded, replayed):
    """With three robots and flagged initialization robot r joins at
    sweep r: the replays of the rotation sweep captured at sweep 0 gate
    each later sweep as the eager sweep of that index does."""
    g, _, anchors = three_robot()
    want = gs._optimize_eager(g, anchors, 3, SMALL)
    for _ in range(3):
        assert_same(gs.optimize(g, anchors, 3, SMALL), want)


def test_replay_catches_a_baked_sweep(padded, replayed, monkeypatch):
    """A rotation sweep whose index is fixed at its first value, as a
    graph would fix a host int at capture, gates robots 1 and 2 out of
    every sweep: the solve then differs from the eager one (the check
    the test above relies on)."""
    g, _, anchors = three_robot()
    want = gs._optimize_eager(g, anchors, 3, SMALL)
    sweep_fn, baked = gs.rotation_sweep, []

    def rotation_sweep(X, sweep, *args):
        if isinstance(sweep, torch.Tensor):  # the runner's counter, not the oracle's ints
            baked.append(int(sweep))
            sweep = baked[0]
        return sweep_fn(X, sweep, *args)

    monkeypatch.setattr(gs, "rotation_sweep", rotation_sweep)
    got = gs.optimize(g, anchors, 3, SMALL)
    assert baked == list(range(SMALL.rot_sweeps))
    assert not torch.equal(got.t, want.t)


def test_relabeled_graph_shares_the_runner(padded, replayed):
    """A graph of the same key whose robot labels differ reaches the
    replays through the `node_robot` buffer: its own result, bit for bit,
    from the one runner."""
    g, _, anchors = three_robot()
    g2 = relabeled(g)
    want, want2 = gs._optimize_eager(g, anchors, 3, SMALL), gs._optimize_eager(g2, anchors, 3,
                                                                              SMALL)
    assert not torch.equal(want.t, want2.t)
    for h, w in ((g, want), (g, want), (g2, want2), (g, want)):
        assert_same(gs.optimize(h, anchors, 3, SMALL), w)
    assert [s["solves"] for s in solve_graph.gs_stats()] == [4]


@pytest.mark.parametrize("buffer", ["node_robot", "slots", "sweep"])
def test_replay_catches_a_rebound_buffer(padded, replayed, buffer):
    """A buffer rebound to a new tensor, not written with `copy_` (or
    `zero_` for the counter), leaves the replays on the old one: the
    harness then differs from the eager solve of another graph of the
    key (relabeled, one loop edge more)."""
    g, true, anchors = three_robot()
    g2 = with_loops(relabeled(g), true, [EXTRA_LOOP])
    for _ in range(2):
        gs.optimize(g, anchors, 3, SMALL)
    (runner,) = solve_graph._gs_runners.values()
    runner.b[buffer] = torch.empty_like(runner.b[buffer])
    got, want = gs.optimize(g2, anchors, 3, SMALL), gs._optimize_eager(g2, anchors, 3, SMALL)
    assert not torch.equal(got.t, want.t)


def test_keys(padded):
    """Two graphs of one capacity (and plan width) share a runner; another
    robot count or GSConfig is another key. The chordal runners are kept
    apart."""
    g, _, anchors = three_robot()
    for h, n, cfg in ((g, 3, SMALL), (relabeled(g), 3, SMALL), (g, 4, SMALL),
                      (g, 3, SMALL._replace(cg_iters=5)), (g, 3, SMALL)):
        assert_same(gs.optimize(h, anchors, n, cfg), gs._optimize_eager(h, anchors, n, cfg))
    runners = solve_graph.gs_stats()
    assert [(r["robots"], r["iters"], r["solves"]) for r in runners] == [
        (4, (4, 3, 4), 1), (3, (4, 3, 5), 1), (3, (4, 3, 4), 3)]
    assert solve_graph.stats() == []


@pytest.mark.parametrize("variant", ["gauss_seidel", "jacobi_gamma", "no_flagged_init"])
def test_runner_matches_reference(padded, variant):
    """The runner's second solve (its segments' runs) on the card's plan
    against the reference's compiled solve of the same graph."""
    import jax.numpy as jnp

    from mr_slam_tpu.backend import gauss_seidel as jgs
    from tests.test_backend import ate_rmse

    seed, cfg = VARIANTS[variant]
    jg, g, true_t, anchors = two_robot(seed)
    gs.optimize(g, anchors, 2, cfg)
    got = gs.optimize(g, anchors, 2, cfg)
    want = jgs.optimize(jg, jnp.asarray(anchors.numpy()), 2, jgs.GSConfig(*cfg))
    valid = np.asarray(jg.node_valid)

    def ate(t):
        return float(ate_rmse(jnp.asarray(np.asarray(t)), jnp.asarray(true_t), jnp.asarray(valid)))

    assert abs(ate(got.t) - ate(want.t)) < 5e-3
    np.testing.assert_allclose(got.t.numpy()[valid], np.asarray(want.t)[valid], atol=0.1, rtol=0)
    np.testing.assert_allclose(got.R.numpy()[valid], np.asarray(want.R)[valid], atol=0.03, rtol=0)


def test_three_robot_runner_matches_reference(padded):
    """The same bounds on the three-robot graph, carried to the reference
    through numpy, at SMALL and the default config."""
    import jax.numpy as jnp

    from mr_slam_tpu.backend import gauss_seidel as jgs

    g, true, anchors = three_robot()
    jg, ja = graph_to_jax(g), jnp.asarray(anchors.numpy())
    valid = g.node_valid.numpy()
    n = int(g.n_nodes)

    def ate(t):
        return float(np.sqrt(np.mean(np.sum((np.asarray(t)[:n] - true.t.numpy()) ** 2, -1))))

    for cfg in (SMALL, gs.GSConfig()):
        gs.optimize(g, anchors, 3, cfg)
        got = gs.optimize(g, anchors, 3, cfg)
        want = jgs.optimize(jg, ja, 3, jgs.GSConfig(*cfg))
        assert abs(ate(got.t) - ate(want.t)) < 5e-3
        np.testing.assert_allclose(got.t.numpy()[valid], np.asarray(want.t)[valid], atol=0.1,
                                   rtol=0)
        np.testing.assert_allclose(got.R.numpy()[valid], np.asarray(want.R)[valid], atol=0.03,
                                   rtol=0)


@pytest.mark.gpu
def test_graphs_equal_eager_solve_on_card():
    """Three solves of the three-robot graph on the card at the default
    config (eager, captured and replayed, replayed), then one of the
    relabeled graph, against the eager solve bit for bit: 2 captures and
    25 + 25 replays a solve after the first."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the runner captures CUDA graphs only there")
    solve_graph.clear()
    try:
        g, _, anchors = three_robot(torch.device("cuda", 0))
        cfg = gs.GSConfig()
        for h in (g, g, g, relabeled(g)):
            assert_same(gs.optimize(h, anchors, 3, cfg), gs._optimize_eager(h, anchors, 3, cfg))
        (runner,) = solve_graph.gs_stats()
        assert runner["captures"] == 2 and runner["replays"] == 3 * 50
    finally:
        solve_graph.clear()
