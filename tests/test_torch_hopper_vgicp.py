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


def _pose(seed=5):
    """A seeded (B,) pose of a few degrees and decimetres, from numpy."""
    rng = np.random.default_rng(seed)
    xi = torch.as_tensor(rng.normal(0, [0.1, 0.1, 0.02, 0.02, 0.02, 0.05], (B, 6)),
                         dtype=torch.float32)
    return tse3.exp(xi)


@pytest.mark.parametrize("centered", [False, True])
def test_plain_pose_matches_gn_terms_from_rows(setup, centered):
    """pose= transforms inside: the reference's `_gn_terms_from_rows` on
    `se3.apply(P, xyz)` with the same cached rows."""
    import jax.numpy as jnp
    from mr_slam_tpu.geometry import se3 as jse3
    from mr_slam_tpu.ops import registration as jreg
    from torch_parity import pose_to_jax

    tp, mask, table = setup
    P = _pose()
    xyz = tse3.apply(tse3.inverse(P), tp)  # P maps xyz back near tp
    slot, found = tvg.lookup_slots(tvg.VoxelGrid(table, LEAF), hopper_vgicp.transform_plain(P, xyz))
    center = tp.mean(dim=1) if centered else None
    t = hopper_vgicp.gn_accumulate(xyz, mask, table, slot=slot, found=found,
                                   max_corr2=MAX_CORR2, center=center, pose=P)
    jtp = jse3.apply(pose_to_jax(P), to_jax(xyz))
    outs = []
    for k in range(B):
        rows = table[k][slot[k].long()]
        outs.append(jreg._gn_terms_from_rows(
            jtp[k], to_jax(mask[k]), to_jax(rows), to_jax(found[k]), jnp.float32(MAX_CORR2),
            center=None if center is None else to_jax(center[k]),
        ))
    j = [np.stack([np.asarray(o[i]) for o in outs]) for i in range(4)]
    assert_terms_close(t, j)


def test_plain_pose_hash_mode_matches_pallas_kernel(setup):
    """Hash mode with pose= against the Pallas kernel (interpret mode) on
    the points the reference transforms."""
    import jax.numpy as jnp
    from mr_slam_tpu.geometry import se3 as jse3
    from mr_slam_tpu.ops import pallas_vgicp
    from torch_parity import pose_to_jax

    tp, mask, table = setup
    P = _pose(6)
    xyz = tse3.apply(tse3.inverse(P), tp)
    t = hopper_vgicp.gn_accumulate(xyz, mask, table, leaf=LEAF, max_corr2=MAX_CORR2, pose=P)
    j = pallas_vgicp.gn_accumulate_batch(
        jse3.apply(pose_to_jax(P), to_jax(xyz)), to_jax(mask), to_jax(table), jnp.float32(LEAF),
        max_corr_dist=1.0, interpret=True,
    )
    assert_terms_close(t, j)


@pytest.mark.parametrize("slot_mode", [False, True])
def test_identity_pose_is_pose_free(setup, slot_mode):
    """pose = identity gives exactly the pose-free result."""
    tp, mask, table = setup
    kw = dict(leaf=LEAF)
    if slot_mode:
        slot, found = tvg.lookup_slots(tvg.VoxelGrid(table, LEAF), tp)
        kw = dict(slot=slot, found=found)
    eye = tse3.identity((B,))
    a = hopper_vgicp.gn_accumulate(tp, mask, table, center=tp.mean(dim=1), **kw)
    b = hopper_vgicp.gn_accumulate(tp, mask, table, center=tp.mean(dim=1), pose=eye, **kw)
    assert torch.equal(hopper_vgicp.transform_plain(eye, tp), tp)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


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
    with pytest.raises(ValueError):  # a pose of another batch
        hopper_vgicp.gn_accumulate(tp, mask, table, leaf=LEAF, pose=tse3.identity((B + 1,)))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


def _card_case(setup, dev, slot_mode, centered, posed):
    tp, mask, table = (x.to(dev) for x in setup)
    center = tp.mean(dim=1).contiguous() if centered else None
    kw = dict(leaf=LEAF)
    if slot_mode:
        slot, found = tvg.lookup_slots(tvg.VoxelGrid(table, LEAF), tp)
        kw = dict(slot=slot, found=found)
    xyz = tp
    if posed:
        P = _pose().to(dev)
        kw["pose"] = tse3.Pose(P.R.contiguous(), P.t.contiguous())
        xyz = tse3.apply(tse3.inverse(P), tp).contiguous()
    return xyz, mask, table, dict(kw, center=center)


@pytest.mark.gpu
@pytest.mark.parametrize("slot_mode", [False, True])
@pytest.mark.parametrize("centered", [False, True])
@pytest.mark.parametrize("posed", [False, True])
def test_kernel_matches_plain_on_card(setup, cuda_device, slot_mode, centered, posed):
    xyz, mask, table, kw = _card_case(setup, cuda_device, slot_mode, centered, posed)
    hopper_vgicp.reset_launch_count()
    out = hopper_vgicp.gn_accumulate(xyz, mask, table, **kw)
    again = hopper_vgicp.gn_accumulate(xyz, mask, table, **kw)
    torch.cuda.synchronize()
    assert hopper_vgicp.launch_count() == 2
    ref = hopper_vgicp.gn_accumulate_plain(xyz, mask, table, **kw)
    assert_terms_close([x.cpu() for x in out], [x.cpu() for x in ref])
    for x, y in zip(out, again):  # no float atomics: bit-identical reruns
        assert torch.equal(x, y)


@pytest.mark.gpu
@pytest.mark.parametrize("cluster", [1, 2, 4, 8, 16])
@pytest.mark.parametrize("threads", [128, 512])
def test_every_cluster_size_matches_plain_on_card(setup, cuda_device, cluster, threads):
    """The cross-CTA sum is right at every cluster and block size (a
    launch without the cluster would drop all but one CTA's share)."""
    xyz, mask, table, kw = _card_case(setup, cuda_device, True, True, True)
    out = hopper_vgicp._launch(xyz, mask, table, None, kw["slot"], kw["found"], 1e-6, MAX_CORR2,
                               kw["center"], kw["pose"], cluster, threads)
    ref = hopper_vgicp.gn_accumulate_plain(xyz, mask, table, **kw)
    H = out[:, :36].view(B, 6, 6)
    assert_terms_close([x.cpu() for x in (H, out[:, 36:42], out[:, 42], out[:, 43])],
                       [x.cpu() for x in ref])


@pytest.mark.gpu
def test_one_launch_per_call_and_graph_capture_on_card(setup, cuda_device):
    """One launch per call, counted where the kernel runs (a capture
    records the launch, runs nothing and counts none), and the call
    captured in a CUDA graph replays to the eager result bit for bit."""
    xyz, mask, table, kw = _card_case(setup, cuda_device, True, True, True)
    hopper_vgicp.reset_launch_count()
    eager = hopper_vgicp.gn_accumulate(xyz, mask, table, **kw)
    assert hopper_vgicp.launch_count() == 1
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        hopper_vgicp.gn_accumulate(xyz, mask, table, **kw)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    B = xyz.shape[0]
    recorded = hopper_vgicp.recorded_by_batch().get(B, 0)
    with torch.cuda.graph(graph):
        captured = hopper_vgicp.gn_accumulate(xyz, mask, table, **kw)
    assert hopper_vgicp.launch_count() == 2
    assert hopper_vgicp.recorded_by_batch()[B] == recorded + 1
    graph.replay()
    torch.cuda.synchronize()
    for x, y in zip(eager, captured):
        assert torch.equal(x, y)
