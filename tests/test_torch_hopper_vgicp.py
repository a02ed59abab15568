"""The VGICP accumulation: the port's plain PyTorch twin against the
reference (both modes), and the Hopper kernel against the twin.

Tolerances are those of `tests/test_pallas_vgicp.py`: H rtol 2e-3 /
atol 1e-3; b rtol 1e-2 / atol 0.1 (b entries are small cancellations of
~1e3-magnitude terms, so f32 summation order alone moves them by a few
percent); cost rtol 1e-3; inlier counts exact (the per-point gates are
evaluated with the same IEEE operations in the same order).

The reference is imported inside its two tests, so that the `gpu` tests
also run on a card machine without JAX:

    python -m pytest --noconftest -o addopts= -m gpu tests/test_torch_hopper_vgicp.py

For the same reason `torch_parity` is imported by its own name (pytest
puts this directory on `sys.path`): under `tests.torch_parity`, an
installed package called `tests` shadows this directory there.
"""
import numpy as np
import pytest
import torch

from mr_slam_torch.geometry import se3 as tse3, so3 as tso3
from mr_slam_torch.ops import hopper_vgicp, pointcloud as tpcl, voxel_grid as tvg
from torch_parity import structured_cloud, to_jax

B, N = 2, 2048
LEAF = 0.5
MAX_CORR2 = 1.0


def assert_terms_close(t, j):
    Ht, bt, ct, nt = (np.asarray(x) for x in t)
    Hj, bj, cj, nj = (np.asarray(x) for x in j)
    np.testing.assert_array_equal(nt, nj)
    np.testing.assert_allclose(Ht, Hj, rtol=2e-3, atol=1e-3)
    np.testing.assert_allclose(bt, bj, rtol=1e-2, atol=0.1)
    np.testing.assert_allclose(ct, cj, rtol=1e-3)


@pytest.fixture(scope="module")
def setup():
    """B targets (structured clouds), plane-regularized tables built by
    the port, and sources moved by small known poses."""
    tables, tps, masks = [], [], []
    for k in range(B):
        target = structured_cloud(k, N)
        grid = tvg.build(target, LEAF, 1 << 13, min_points=3, regularize="plane")
        pose = tse3.Pose(tso3.exp(torch.tensor([0.01, -0.02, 0.05 * (k + 1)])),
                         torch.tensor([0.2, -0.1, 0.05]))
        source = tpcl.transform(target, tse3.inverse(pose))
        tp = tse3.apply(pose, source.xyz)
        mask = source.mask.clone()
        mask[::7] = False
        tables.append(grid.packed)
        tps.append(tp)
        masks.append(mask)
    return torch.stack(tps), torch.stack(masks), torch.stack(tables)


def test_plain_hash_mode_matches_pallas_kernel(setup):
    import jax.numpy as jnp
    from mr_slam_tpu.ops import pallas_vgicp

    tp, mask, table = setup
    t = hopper_vgicp.gn_accumulate(tp, mask, table, leaf=LEAF, max_corr2=MAX_CORR2)
    j = pallas_vgicp.gn_accumulate_batch(
        to_jax(tp), to_jax(mask), to_jax(table), jnp.float32(LEAF),
        max_corr_dist=1.0, interpret=True,
    )
    assert_terms_close(t, j)


@pytest.mark.parametrize("centered", [False, True])
def test_plain_slot_mode_matches_gn_terms_from_rows(setup, centered):
    import jax.numpy as jnp
    from mr_slam_tpu.ops import registration as jreg

    tp, mask, table = setup
    grids = tvg.VoxelGrid(table, LEAF)
    slot, found = tvg.lookup_slots(grids, tp)
    center = tp.mean(dim=1) if centered else None
    t = hopper_vgicp.gn_accumulate(
        tp, mask, table, slot=slot, found=found, max_corr2=MAX_CORR2, center=center
    )
    outs = []
    for k in range(B):
        rows = table[k][slot[k].long()]
        outs.append(jreg._gn_terms_from_rows(
            to_jax(tp[k]), to_jax(mask[k]), to_jax(rows), to_jax(found[k]),
            jnp.float32(MAX_CORR2), center=None if center is None else to_jax(center[k]),
        ))
    j = [np.stack([np.asarray(o[i]) for o in outs]) for i in range(4)]
    assert_terms_close(t, j)


def test_modes_agree(setup):
    """Slot mode with lookup_slots' correspondences is hash mode."""
    tp, mask, table = setup
    slot, found = tvg.lookup_slots(tvg.VoxelGrid(table, LEAF), tp)
    a = hopper_vgicp.gn_accumulate(tp, mask, table, leaf=LEAF)
    b = hopper_vgicp.gn_accumulate(tp, mask, table, slot=slot, found=found)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x.numpy(), y.numpy())


def test_wrapper_rejects_bad_arguments(setup):
    tp, mask, table = setup
    with pytest.raises(ValueError):
        hopper_vgicp.gn_accumulate(tp, mask, table)  # neither mode
    with pytest.raises(ValueError):
        hopper_vgicp.gn_accumulate(tp, mask.float(), table, leaf=LEAF)
    with pytest.raises(ValueError):
        hopper_vgicp.gn_accumulate(tp[:, :, :2], mask, table, leaf=LEAF)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("slot_mode", [False, True])
@pytest.mark.parametrize("centered", [False, True])
def test_kernel_matches_plain_on_card(setup, cuda_device, slot_mode, centered):
    tp, mask, table = (x.to(cuda_device) for x in setup)
    center = tp.mean(dim=1).contiguous() if centered else None
    if slot_mode:
        slot, found = tvg.lookup_slots(tvg.VoxelGrid(table, LEAF), tp)
        kw = dict(slot=slot, found=found)
    else:
        kw = dict(leaf=LEAF)
    hopper_vgicp.reset_launch_count()
    out = hopper_vgicp.gn_accumulate(tp, mask, table, center=center, **kw)
    again = hopper_vgicp.gn_accumulate(tp, mask, table, center=center, **kw)
    torch.cuda.synchronize()
    assert hopper_vgicp.launch_count() == 2
    ref = hopper_vgicp.gn_accumulate_plain(tp, mask, table, center=center, **kw)
    assert_terms_close([x.cpu() for x in out], [x.cpu() for x in ref])
    for x, y in zip(out, again):  # no float atomics: bit-identical reruns
        assert torch.equal(x, y)
