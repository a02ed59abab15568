"""The port's fixed-order scatter-adds (`ops/segment.py`): on the CPU
they equal `index_add_` bit for bit, one call of several parts the
separate calls it replaces; the padded gather-sum of `ScatterPlan` is
run here on CPU tensors too. On the card the segment-sum kernel equals
the CPU's sums bit for bit (onto a zero base; onto another base it
rounds once more at the end, as PyTorch's sorted `index_put_` does),
equals that `index_put_`, reruns bit-identically, replays from a CUDA
graph, and counts its launches.

    python -m pytest --noconftest -o addopts= -m gpu tests/test_torch_segment.py
"""
import numpy as np
import pytest
import torch

from mr_slam_torch.ops import pointcloud, segment


def colliding(seed, m=20000, n=64, width=(3,)):
    """m values scattered into n slots (~300 per slot), with magnitudes
    spread over six decades so that the order of the sums shows."""
    rng = np.random.default_rng(seed)
    idx = torch.from_numpy(rng.integers(0, n, m))
    vals = rng.normal(size=(m, *width)) * 10.0 ** rng.integers(-3, 3, (m, *width))
    return idx, torch.from_numpy(vals.astype(np.float32)), n


@pytest.mark.parametrize("width", [(), (3,), (3, 3)])
def test_scatter_sum_equals_index_add_on_cpu(width):
    idx, vals, n = colliding(0, width=width)
    ref = torch.zeros((n, *width)).index_add_(0, idx, vals)
    assert torch.equal(segment.scatter_sum(n, idx, vals), ref)
    base = torch.from_numpy(np.random.default_rng(1).normal(size=(n, *width)).astype(np.float32))
    assert torch.equal(segment.index_add(base, idx, vals), base.index_add(0, idx, vals))


@pytest.mark.parametrize("width", [(), (6,)])
def test_sorted_index_put_sums_in_index_order(width):
    """`index_put_(accumulate=True)`, the card's path before the
    segment-sum kernel and still the benchmark reference's, adds each
    slot's values in their original order: on one CPU thread it equals
    `index_add_` bit for bit."""
    idx, vals, n = colliding(2, width=width)
    ref = torch.zeros((n, *width)).index_add_(0, idx, vals)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # several CPU threads take a float-atomic path
    try:
        out = torch.zeros((n, *width)).index_put_((idx,), vals, accumulate=True)
    finally:
        torch.set_num_threads(threads)
    assert torch.equal(out, ref)


@pytest.mark.parametrize("widths", [((), (3,), (9,)), ((3,), ()), ((6,), ()), ((3, 3), (2,))])
def test_parts_side_by_side_equal_the_separate_index_adds(widths):
    """One call of several parts (one sort on the card) equals the
    `index_add_` calls it replaces, column for column, from zeros and
    onto a base."""
    idx, _, n = colliding(8, m=5000, n=50)
    rng = np.random.default_rng(9)
    parts = [torch.from_numpy((rng.normal(size=(5000, *w)) * 10.0 ** rng.integers(-3, 3, (5000, *w)))
                              .astype(np.float32)) for w in widths]
    bases = [torch.from_numpy(rng.normal(size=(n, *w)).astype(np.float32)) for w in widths]
    flat = lambda ts: torch.cat([t.reshape(t.shape[0], -1) for t in ts], dim=1)  # noqa: E731
    got = segment.scatter_sum(n, idx, *parts)
    want = flat([torch.zeros_like(b).index_add_(0, idx, p) for b, p in zip(bases, parts)])
    assert torch.equal(got, want)
    got = segment.index_add(flat(bases), idx, *parts)
    want = flat([b.index_add(0, idx, p) for b, p in zip(bases, parts)])
    assert torch.equal(got, want)
    assert torch.equal(segment.scatter_sum(n, idx.sort().values, *parts, sorted_index=True),
                       flat([torch.zeros_like(b).index_add_(0, idx.sort().values, p)
                             for b, p in zip(bases, parts)]))


@pytest.mark.parametrize("batch", [(), (3,)])
def test_voxel_downsample_scatters_through_a_sorted_index(monkeypatch, batch):
    """`voxel_downsample` tells the card its index is sorted (no sort):
    its slots are nondecreasing for random batched clouds with parked
    points, points out of bounds and more voxels than the capacity."""
    seen = []
    real = segment.scatter_sum

    def spy(n, index, *parts, sorted_index=False):
        seen.append((index.clone(), sorted_index))
        return real(n, index, *parts, sorted_index=sorted_index)

    monkeypatch.setattr(segment, "scatter_sum", spy)
    rng = np.random.default_rng(12)
    for cap in (64, 700, 5000):
        xyz = rng.uniform(-60.0, 60.0, (*batch, 3000, 3)).astype(np.float32)
        xyz[..., :40, :] = xyz[..., 40:80, :]  # points sharing voxels
        mask = rng.random((*batch, 3000)) < 0.8
        pc = pointcloud.park(pointcloud.PointCloud(torch.from_numpy(xyz), torch.from_numpy(mask)))
        out = pointcloud.voxel_downsample(pc, 0.5, cap, bounds=((-50.0,) * 3, (50.0,) * 3))
        index, sorted_index = seen[-1]
        assert sorted_index
        assert bool((index[1:] >= index[:-1]).all())
        full = out.mask.all(dim=-1)  # over capacity: every slot taken
        assert bool(full.all()) if cap < 1000 else not bool(full.any())
    assert len(seen) == 3


def test_count_equals_bincount():
    """Integer counts (the M2DP and range-histogram bins) over kept
    entries only."""
    idx, _, n = colliding(5)
    keep = torch.from_numpy(np.random.default_rng(6).random(len(idx)) < 0.7)
    got = segment.count(n, idx, keep)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.bincount(idx.numpy()[keep.numpy()], minlength=n))


@pytest.mark.parametrize("keep_frac", [1.0, 0.6])
def test_padded_plan_matches_index_add(keep_frac):
    idx, vals, n = colliding(3, m=4096, n=100, width=(6,))
    keep = torch.from_numpy(np.random.default_rng(4).random(len(idx)) < keep_frac)
    vals = torch.where(keep[:, None], vals, 0.0)  # dropped sources carry zeros
    ref = torch.zeros((n, 6)).index_add_(0, idx, vals)
    plan = segment.ScatterPlan(idx, n, keep=keep, padded=True)
    out = plan(vals[:1000], vals[1000:])
    np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=1e-5, atol=1e-4)
    cpu_plan = segment.ScatterPlan(idx, n)
    assert not cpu_plan.padded
    assert torch.equal(cpu_plan(vals[:1000], vals[1000:]), ref)


def test_padded_plan_is_exact_on_integers():
    idx, _, n = colliding(5, m=3000, n=40)
    vals = torch.from_numpy(np.random.default_rng(6).integers(-50, 50, (3000, 2)).astype(np.float32))
    plan = segment.ScatterPlan(idx, n + 5, padded=True)  # 5 slots receive nothing
    ref = torch.zeros((n + 5, 2)).index_add_(0, idx, vals)
    assert torch.equal(plan(vals), ref)


@pytest.mark.gpu
@pytest.mark.parametrize("width", [(), (3,), (9,)])
def test_scatter_is_bit_stable_on_card(width):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    idx, vals, n = colliding(7, m=1 << 20, n=512, width=width)
    idx, vals = idx.cuda(), vals.cuda()
    runs = [segment.scatter_sum(n, idx, vals) for _ in range(3)]
    plan = segment.ScatterPlan(idx, n)
    assert plan.padded
    plans = [plan(vals) for _ in range(3)]
    torch.cuda.synchronize()
    for r in runs[1:]:
        assert torch.equal(r, runs[0])
    for r in plans[1:]:
        assert torch.equal(r, plans[0])
    ref = torch.zeros((n, *width), dtype=torch.float64).index_add_(0, idx.cpu(), vals.cpu().double())
    np.testing.assert_allclose(runs[0].cpu().numpy(), ref.numpy(), rtol=1e-4, atol=1e-2)


# --------------------------------------------------------------------------
# the segment-sum kernel, on the card
# --------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


def long_run(seed, m=20000, n=64, width=(3,), run=16384):
    """`colliding`, with `run` of its entries sent to one slot."""
    idx, vals, n = colliding(seed, m=m, n=n, width=width)
    pick = torch.from_numpy(np.random.default_rng(seed + 100).permutation(m)[:run])
    idx[pick] = n // 2
    return idx, vals, n


def runs(seed, cols, sorted_index):
    """Runs of every length around the kernel's windows (1 to 16,384
    entries) in a random slot order, slots left empty between them."""
    rng = np.random.default_rng(seed)
    lengths = [1, 2, 7, 8, 9, 31, 32, 33, 63, 64, 65, 95, 96, 97, 127, 128, 129, 191, 255, 256,
               257, 383, 1000, 4097, 16384] + list(rng.integers(1, 40, 200))
    slots = rng.permutation(3 * len(lengths))[:len(lengths)]
    idx = np.repeat(slots, lengths)
    if not sorted_index:
        idx = idx[rng.permutation(len(idx))]
    else:
        idx = np.sort(idx, kind="stable")
    vals = rng.normal(size=(len(idx), cols)) * 10.0 ** rng.integers(-3, 3, (len(idx), cols))
    return torch.from_numpy(idx), torch.from_numpy(vals.astype(np.float32)), 3 * len(lengths)


@pytest.mark.gpu
@pytest.mark.parametrize("width", [(), (3,), (9,), (13,)])
@pytest.mark.parametrize("case", ["colliding", "long_run"])
def test_kernel_equals_cpu_index_add_on_card(cuda_device, width, case):
    """Onto zeros the kernel's sums are the CPU's `index_add_`, bit for
    bit; onto a base, base + (the sum from zero), and a slot no entry
    reaches keeps its base."""
    make = colliding if case == "colliding" else long_run
    idx, vals, n = make(20, width=width)
    n += 5  # slots n - 5 .. n - 1 receive nothing
    ref = torch.zeros((n, *width)).index_add_(0, idx, vals)
    segment.reset_launch_count()
    got = segment.scatter_sum(n, idx.to(cuda_device), vals.to(cuda_device))
    assert segment.launch_count() == 1
    assert torch.equal(got.cpu(), ref)
    base = torch.from_numpy(np.random.default_rng(21).normal(size=(n, *width)).astype(np.float32))
    got = segment.index_add(base.to(cuda_device), idx.to(cuda_device), vals.to(cuda_device)).cpu()
    assert torch.equal(got, base + ref)
    assert torch.equal(got[-5:], base[-5:])


@pytest.mark.gpu
@pytest.mark.parametrize("cols", [1, 2, 3, 4, 5, 7, 8, 9, 13, 16, 17, 31, 32])
@pytest.mark.parametrize("sorted_index", [False, True])
def test_kernel_sums_runs_of_every_length_on_card(cuda_device, cols, sorted_index):
    """Every run length around the kernel's 32-position windows and its
    long-run windows, at every lane layout (a lane a column, 32 / cols
    runs side by side), with and without the sort."""
    idx, vals, n = runs(cols, cols, sorted_index)
    ref = torch.zeros((n, cols)).index_add_(0, idx, vals)
    segment.reset_launch_count()
    got = segment.scatter_sum(n, idx.to(cuda_device), vals.to(cuda_device), sorted_index=sorted_index)
    assert segment.launch_count() == 1
    assert torch.equal(got.cpu(), ref)


@pytest.mark.gpu
def test_kernel_refuses_what_it_cannot_sum_on_card(cuda_device):
    """Over 32 columns, another dtype than float32, or an index on
    another device: a ValueError, and nothing launched."""
    idx, vals, n = runs(0, 33, False)
    idx, vals = idx.to(cuda_device), vals.to(cuda_device)
    segment.reset_launch_count()
    for bad in (lambda: segment.scatter_sum(n, idx, vals),
                lambda: segment.scatter_sum(n, idx, vals[:, :3].double()),
                lambda: segment.scatter_sum(n, idx.cpu(), vals[:, :3])):
        with pytest.raises(ValueError):
            bad()
    assert segment.launch_count() == 0


@pytest.mark.gpu
@pytest.mark.parametrize("width", [(3,), (9,), (13,)])
def test_kernel_equals_index_put_on_card(cuda_device, width):
    """At 2 to 32 columns PyTorch's sorted `index_put_(...,
    accumulate=True)` (the card's path before the kernel, and the
    benchmark reference's) adds in the kernel's order, onto any base."""
    idx, vals, n = long_run(22, width=width, run=7033)
    idx, vals = idx.to(cuda_device), vals.to(cuda_device)
    base = torch.from_numpy(np.random.default_rng(23).normal(size=(n, *width)).astype(np.float32))
    base = base.to(cuda_device)
    want = base.clone().index_put_((idx,), vals, accumulate=True)
    assert torch.equal(segment.index_add(base, idx, vals), want)
    parts = [vals[:, :1], vals[:, 1:]]  # one call of two parts
    assert torch.equal(segment.index_add(base.reshape(n, -1), idx, *parts), want.reshape(n, -1))


@pytest.mark.gpu
def test_kernel_equals_index_put_on_weights_on_card(cuda_device):
    """A single column of 0/1 weights onto integer counts (the counts of
    `voxel_grid` and `voxel_downsample`): PyTorch's single-column
    `index_put_` adds in no fixed order, but any order gives these sums,
    so the kernel equals it; on values that round it need not."""
    idx, _, n = long_run(24, m=70000, run=16384)
    rng = np.random.default_rng(25)
    w = torch.from_numpy((rng.random(70000) < 0.6).astype(np.float32)).to(cuda_device)
    base = torch.from_numpy(rng.integers(0, 1000, n).astype(np.float32)).to(cuda_device)
    idx = idx.to(cuda_device)
    want = base.clone().index_put_((idx,), w, accumulate=True)
    assert torch.equal(segment.index_add(base, idx, w), want)
    assert torch.equal(segment.scatter_sum(n, idx, w), torch.zeros_like(base).index_put_((idx,), w,
                                                                                        accumulate=True))


@pytest.mark.gpu
@pytest.mark.parametrize("width", [(), (13,)])
def test_kernel_reruns_are_bit_identical_on_card(cuda_device, width):
    idx, vals, n = colliding(7, m=1 << 20, n=512, width=width)
    idx, vals = idx.to(cuda_device), vals.to(cuda_device)
    first = segment.scatter_sum(n, idx, vals)
    for _ in range(2):
        assert torch.equal(segment.scatter_sum(n, idx, vals), first)


@pytest.mark.gpu
def test_kernel_capture_and_replay_equal_the_eager_call_on_card(cuda_device):
    """A call captured into a CUDA graph records its launch and counts
    none; replays equal the eager call bit for bit, and a replay inside
    `frame_graph.Segments` adds the launch its capture recorded."""
    from mr_slam_torch.runtime import frame_graph

    idx, vals, n = long_run(26, width=(13,))
    base = torch.from_numpy(np.random.default_rng(27).normal(size=(n, 13)).astype(np.float32))
    bufs = dict(base=base.to(cuda_device), idx=idx.to(cuda_device), vals=vals.to(cuda_device))
    fn = lambda b: dict(out=segment.index_add(b["base"], b["idx"], b["vals"][:, :4],  # noqa: E731
                                              b["vals"][:, 4:]))
    eager = fn(bufs)["out"]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn(bufs)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    segment.reset_launch_count()
    recorded = segment.recorded_count()
    with torch.cuda.graph(graph):
        captured = fn(bufs)["out"]
    assert segment.launch_count() == 0
    assert segment.recorded_count() == recorded + 1
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(captured, eager)

    segs = frame_graph.Segments(cuda_device, "frontend")
    with segs.on_stream():
        segs.eager("sum", fn, bufs)
        segment.reset_launch_count()
        for _ in range(2):
            out = segs.run("sum", fn, bufs)  # the first captures, then replays
    torch.cuda.synchronize()
    assert segs.captures == 1 and segs.replays == 2
    assert segment.launch_count() == 2
    assert torch.equal(out["out"], eager)
    segs.close(2)
