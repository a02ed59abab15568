"""The chordal solve's runner (`runtime/solve_graph`), which replays CUDA
graphs on the card, against the eager solve it replaces
(`chordal._optimize_eager`) and against the reference's compiled solve
(`mr_slam_tpu.backend.chordal.optimize`).

The runner calls the same stages on the same values as the eager solve,
so on one device the two agree bit for bit. On the CPU the runner runs
its segments eagerly; `padded` makes every plan the card's gather-sum
plan (`segment.ScatterPlan(padded=True)`), and `replayed` re-runs every
segment after its first call on the buffers it first saw, writing into
the outputs it first returned, as a CUDA graph replays, so the CPU
checks that a second graph's arrays and plan flow through the static
buffers. Against the reference the bound is `tests/test_torch_backend.py`'s:
positions and rotations within 1e-3.

Sizes: `graphgen.multi_robot_graph` with 2 robots x 40 nodes (96 node
and 320 edge slots), seed 0 clean and seed 1 with 10 % outlier loops, at
the default budget (60 + 12 x 40 CG steps) and at 3 / 3 / 3. The `gpu`
tests run the runner on the card against the eager solve there, and
check the assumption the plan's width buckets rest on (the card machine
has no JAX):

    python -m pytest --noconftest -o addopts= -m gpu tests/test_torch_solve_graph.py
"""
import numpy as np
import pytest
import torch

from mr_slam_torch.backend import chordal, factor_graph as tfg
from mr_slam_torch.eval import graphgen
from mr_slam_torch.geometry import se3 as tse3
from mr_slam_torch.ops import segment
from mr_slam_torch.runtime import frame_graph, solve_graph
from torch_parity import pose_to_torch, to_torch

GRAPH_KW = dict(n_robots=2, nodes_per_robot=40, radius=15.0, laps=1.5, loop_stride=8,
                min_separation=15)
CASES = {"clean": (0, 0.0), "outliers": (1, 0.1)}
CONFIGS = {"default": chordal.PGOConfig(),
           "small": chordal.PGOConfig(rot_cg_iters=3, gn_iters=3, pose_cg_iters=3)}
# a loop edge between two nodes of degree 2 (robot 0's node 5, robot 1's
# node 3): another graph under the same key
EXTRA_LOOP = (5, 43)


def graph(case: str, dev="cpu"):
    """(graph, true poses, anchors) of a case."""
    seed, outliers = CASES[case]
    g, true, anchors, _ = graphgen.multi_robot_graph(**GRAPH_KW, outlier_frac=outliers,
                                                     seed=seed, device=dev)
    return g, true, anchors


def with_loops(g: tfg.FactorGraph, true, pairs) -> tfg.FactorGraph:
    """`g` with a loop edge a -> b for each (a, b) in `pairs`, measured
    from the true poses."""
    ia = torch.tensor([a for a, _ in pairs], device=g.edge_i.device)
    ib = torch.tensor([b for _, b in pairs], device=g.edge_i.device)
    meas = tse3.between(tse3.index(true, ia), tse3.index(true, ib))
    return tfg.add_edges_batch(g, ia, ib, meas, tfg.INTER_LOOP, 1.0, 1.0)[0]


def assert_same(got, want):
    assert torch.equal(got.R, want.R) and torch.equal(got.t, want.t)


@pytest.fixture
def padded(monkeypatch):
    """Every scatter plan the card's padded gather-sum plan. Starts from
    no runner."""
    class Padded(segment.ScatterPlan):
        def __init__(self, index, n, keep=None, padded=None, slots=None):
            super().__init__(index, n, keep, True, slots)

    solve_graph.clear()
    monkeypatch.setattr(segment, "ScatterPlan", Padded)
    yield
    solve_graph.clear()


def _copy_into(dst, src):
    if isinstance(dst, torch.Tensor):
        dst.copy_(src)
    else:
        for k in dst:
            _copy_into(dst[k], src[k])


@pytest.fixture
def replayed(monkeypatch):
    """`Segments.run` as a graph replays: the first call of a segment
    runs it and keeps the buffer dict it saw and the outputs it gave;
    every later call runs it on those buffers and writes the results
    into those outputs. Starts from no runner."""
    calls = {}

    def run(self, name, fn, bufs):
        if name not in calls:
            calls[name] = (dict(bufs), fn(bufs))
            return calls[name][1]
        seen, out = calls[name]
        _copy_into(out, fn(seen))
        return out

    solve_graph.clear()
    monkeypatch.setattr(frame_graph.Segments, "run", run)
    yield calls
    solve_graph.clear()


@pytest.mark.parametrize("config", CONFIGS)
@pytest.mark.parametrize("case", CASES)
def test_runner_equals_eager_solve(padded, case, config):
    """Two solves of one graph (the runner's eager first solve, then its
    segments' runs) on the card's plan, bit for bit."""
    g, _, anchors = graph(case)
    cfg = CONFIGS[config]
    want = chordal._optimize_eager(g, anchors, cfg)
    for _ in range(2):
        assert_same(chordal.optimize(g, anchors, cfg), want)
    (runner,) = solve_graph.stats()
    assert runner["solves"] == 2 and runner["width"] == 4  # node degrees 4 and below


@pytest.mark.parametrize("plan", ["padded", "index"])
def test_replayed_segments_equal_eager_solve(request, replayed, plan):
    """Solves replayed on the buffers the segments first saw: a second
    graph of the same key (one loop edge more) reaches them through the
    static buffers, its plan (the card's slots, the CPU's index) too."""
    if plan == "padded":
        request.getfixturevalue("padded")
    g, true, anchors = graph("outliers")
    g2 = with_loops(g, true, [EXTRA_LOOP])
    cfg = CONFIGS["small"]
    for h in (g, g, g2, g):
        assert_same(chordal.optimize(h, anchors, cfg), chordal._optimize_eager(h, anchors, cfg))
    assert set(replayed) == {"rot", "gn"}
    assert [s["solves"] for s in solve_graph.stats()] == [4]  # one key: g2 reused the runner
    assert not torch.equal(chordal._optimize_eager(g2, anchors, cfg).t,
                           chordal._optimize_eager(g, anchors, cfg).t)


@pytest.mark.parametrize("buffer", ["slots", "meas_R"])
def test_replay_catches_a_rebound_buffer(padded, replayed, buffer):
    """A buffer rebound to a new tensor, not written with `copy_`, leaves
    the replays (and the plan) on the old one: the harness then differs
    from the eager solve (the check the test above relies on)."""
    g, true, anchors = graph("outliers")
    g2 = with_loops(g, true, [EXTRA_LOOP])
    cfg = CONFIGS["small"]
    for _ in range(2):
        chordal.optimize(g, anchors, cfg)
    (runner,) = solve_graph._runners.values()
    runner.b[buffer] = torch.empty_like(runner.b[buffer])
    got, want = chordal.optimize(g2, anchors, cfg), chordal._optimize_eager(g2, anchors, cfg)
    assert not torch.equal(got.t, want.t)


def test_new_width_makes_new_runner(padded):
    """Loops onto one node raise its degree across the width buckets
    (4, 16, 32, 64, 128): each bucket is a key, and the least recently
    used runner goes first."""
    g, true, anchors = graph("clean")
    cfg = CONFIGS["small"]
    for k in (1, 8, 20, 40, 70):
        h = with_loops(g, true, [(0, 10 + i) for i in range(k)])
        assert_same(chordal.optimize(h, anchors, cfg), chordal._optimize_eager(h, anchors, cfg))
    widths = [s["width"] for s in solve_graph.stats()]
    assert widths == [16, 32, 64, 128][-solve_graph.MAX_RUNNERS:]


def _graph_to_torch(g) -> tfg.FactorGraph:
    return tfg.FactorGraph(
        poses=pose_to_torch(g.poses), node_robot=to_torch(g.node_robot).long(),
        node_valid=to_torch(g.node_valid), n_nodes=int(g.n_nodes),
        edge_i=to_torch(g.edge_i).long(), edge_j=to_torch(g.edge_j).long(),
        edge_meas=pose_to_torch(g.edge_meas), edge_kind=to_torch(g.edge_kind).long(),
        edge_w_rot=to_torch(g.edge_w_rot), edge_w_trans=to_torch(g.edge_w_trans),
        edge_valid=to_torch(g.edge_valid), n_edges=int(g.n_edges))


@pytest.mark.parametrize("case", CASES)
def test_runner_matches_reference(padded, case):
    """The runner's second solve (its segments' runs) on the card's plan
    against the reference's compiled solve of the same graph."""
    from mr_slam_tpu.backend import chordal as jch
    from mr_slam_tpu.eval import graphgen as jgraphgen

    seed, outliers = CASES[case]
    jg, _, janchors, _ = jgraphgen.multi_robot_graph(**GRAPH_KW, outlier_frac=outliers, seed=seed)
    g, anchors = _graph_to_torch(jg), to_torch(janchors)
    chordal.optimize(g, anchors)
    got = chordal.optimize(g, anchors)
    want = jch.optimize(jg, janchors, jch.PGOConfig())
    valid = np.asarray(jg.node_valid)
    np.testing.assert_allclose(got.t.numpy()[valid], np.asarray(want.t)[valid], atol=1e-3, rtol=0)
    np.testing.assert_allclose(got.R.numpy()[valid], np.asarray(want.R)[valid], atol=1e-3, rtol=0)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the runner captures CUDA graphs only there")
    solve_graph.clear()
    yield torch.device("cuda", 0)
    solve_graph.clear()


@pytest.mark.gpu
@pytest.mark.parametrize("case", CASES)
def test_graphs_equal_eager_solve_on_card(card, case):
    """Three solves of one graph (eager, captured and replayed, replayed),
    then one of a graph with a loop edge more, against the eager solve bit
    for bit: 2 captures, a rotation replay and 12 GN replays a solve."""
    g, true, anchors = graph(case, card)
    g2 = with_loops(g, true, [EXTRA_LOOP])
    for h in (g, g, g, g2):
        assert_same(chordal.optimize(h, anchors), chordal._optimize_eager(h, anchors))
    (runner,) = solve_graph.stats()
    assert runner["captures"] == 2 and runner["replays"] == 3 * 13


# the solve's node count and the plan widths a session's graphs reach
WIDTH_NODES = 1024
WIDTHS = range(2, 17)


def _slots(rng, n: int, width: int, m: int) -> torch.Tensor:
    """(n, width) source rows of a plan whose largest count is `width`:
    each node's sources first, then m (the zero row)."""
    counts = rng.integers(1, width + 1, n)
    counts[rng.integers(n)] = width
    slots = np.full((n, width), m, np.int64)
    for i, c in enumerate(counts):
        slots[i, :c] = rng.choice(m, c, replace=False)
    return torch.from_numpy(slots)


@pytest.mark.gpu
@pytest.mark.parametrize("row", [(6,), (3, 3)])
def test_gather_sum_ignores_zero_columns_on_card(row):
    """`values[slots].sum(dim=1)`, the padded plan's scatter, gives the
    same bits when every row of `slots` gets more columns that read the
    zero row: plans padded to a width bucket sum as plans of the exact
    width do."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the bits in question are the card's reduction's")
    rng = np.random.default_rng(0)
    dev = torch.device("cuda", 0)
    m = 4 * WIDTH_NODES
    for width in WIDTHS:
        vals = torch.from_numpy(rng.normal(0, 10.0 ** rng.integers(-3, 4), (m, *row))
                                .astype(np.float32))
        values = torch.cat([vals, torch.zeros((1, *row))]).to(dev)
        slots = _slots(rng, WIDTH_NODES, width, m).to(dev)
        want = values[slots].sum(dim=1)
        for extra in range(1, 2 * max(WIDTHS) - width + 1):
            wide = torch.cat([slots, torch.full((WIDTH_NODES, extra), m, device=dev)], dim=1)
            got = values[wide].sum(dim=1)
            assert torch.equal(got.view(torch.int32), want.view(torch.int32)), (width, extra)
