"""The port's fixed-order scatter-adds (`ops/segment.py`): on the CPU
they equal `index_add_` bit for bit; the card's algorithms (PyTorch's
sorted `index_put_(..., accumulate=True)` and the padded gather-sum of
`ScatterPlan`) are run here on CPU tensors too; on the card two runs of
a heavily colliding scatter are bit-identical.

    python -m pytest --noconftest -o addopts= -m gpu tests/test_torch_segment.py
"""
import numpy as np
import pytest
import torch

from mr_slam_torch.ops import segment


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
    """The card's path, `index_put_(accumulate=True)`, adds each slot's
    values in their original order: on one CPU thread it equals
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
