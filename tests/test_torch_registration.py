"""Registration of the port against the reference on the same inputs:
final poses within 1 cm and 0.1 deg.

The clouds are the reference tests' structured scene (ground + two
walls, near the origin) with the source moved by a known pose: a
well-conditioned problem, so both packages converge to the same pose
and the bound measures the port, not the problem. (On a far-from-origin
lidar scene the point-to-plane association pools f32 moments whose
cancellation follows summation order; there the packages agree only
statistically — see `test_torch_frontend.py`.)"""
import numpy as np
import pytest
import torch

from mr_slam_torch.geometry import se3 as tse3, so3 as tso3
from mr_slam_torch.ops import pointcloud as tpcl, registration as treg, voxel_grid as tvg
from mr_slam_tpu.ops import pointcloud as jpcl, registration as jreg, voxel_grid as jvg
from tests.torch_parity import (
    cloud_to_jax, pose_to_jax, rot_err_deg, structured_cloud, to_jax,
)

T_TOL = 0.01      # m
R_TOL = 0.1       # deg
B = 3


def assert_pose_close(pt, pj):
    np.testing.assert_allclose(pt.t.numpy(), np.asarray(pj.t), atol=T_TOL, rtol=0)
    Rt, Rj = pt.R.numpy().reshape(-1, 3, 3), np.asarray(pj.R).reshape(-1, 3, 3)
    for a, b in zip(Rt, Rj):
        assert rot_err_deg(a, b) < R_TOL


def offsets(k):
    return tse3.Pose(
        tso3.exp(torch.tensor([0.02 * k, -0.03, 0.08 - 0.04 * k])),
        torch.tensor([0.3 - 0.2 * k, -0.2, 0.05 * k]),
    )


@pytest.fixture(scope="module")
def vgicp_batch():
    """B (source, plane-regularized target table, init) triples."""
    srcs, masks, tables, inits = [], [], [], []
    for k in range(B):
        target = structured_cloud(10 + k, 4096)
        source = tpcl.transform(target, tse3.inverse(offsets(k)))
        grid = tvg.build(target, 0.5, 1 << 13, min_points=3, regularize="plane")
        srcs.append(source.xyz)
        masks.append(source.mask)
        tables.append(grid.packed)
        inits.append(tse3.identity())
    return (tpcl.PointCloud(torch.stack(srcs), torch.stack(masks)),
            tvg.VoxelGrid(torch.stack(tables), 0.5), tse3.stack(inits))


@pytest.mark.parametrize("schedule", [None, ((5, 4), (8, 2), (17, 1))],
                         ids=["uniform", "annealed"])
def test_vgicp_direct1_matches_reference(vgicp_batch, schedule):
    src, grid, init = vgicp_batch
    res = treg._vgicp_direct1(src, grid, init, iters=30, schedule=schedule)
    for k in range(B):
        jres = jreg._vgicp_direct1(
            cloud_to_jax(tpcl.PointCloud(src.xyz[k], src.mask[k])),
            jvg.VoxelGrid(to_jax(grid.packed[k]), np.float32(0.5)),
            pose_to_jax(tse3.index(init, k)), iters=30, schedule=schedule,
        )
        assert_pose_close(tse3.index(res.pose, k), jres.pose)
        np.testing.assert_allclose(float(res.fitness[k]), float(jres.fitness), atol=1e-3)
        # and both recover the true offset
        np.testing.assert_allclose(res.pose.t[k].numpy(), offsets(k).t.numpy(), atol=0.05)


@pytest.mark.parametrize("centered", [False, True])
def test_gn_terms_from_rows_matches_reference(vgicp_batch, centered):
    """The port's `_gn_terms_from_rows` (points already transformed)
    against the reference's on the same cached rows, with the
    tolerances of `tests/test_pallas_vgicp.py`."""
    import jax.numpy as jnp

    src, grid, _ = vgicp_batch
    tp = tse3.apply(tse3.stack([offsets(k) for k in range(B)]), src.xyz)
    slot, found = tvg.lookup_slots(grid, tp)
    center = tp.mean(dim=1) if centered else None
    H, b, cost, n = treg._gn_terms_from_rows(tp, src.mask, grid.packed, slot, found, 1.0,
                                             center=center)
    for k in range(B):
        j = jreg._gn_terms_from_rows(
            to_jax(tp[k]), to_jax(src.mask[k]), to_jax(grid.packed[k][slot[k].long()]),
            to_jax(found[k]), jnp.float32(1.0), center=None if center is None else to_jax(center[k]),
        )
        assert float(n[k]) == float(j[3]) and float(n[k]) > 100
        np.testing.assert_allclose(H[k].numpy(), np.asarray(j[0]), rtol=2e-3, atol=1e-3)
        np.testing.assert_allclose(b[k].numpy(), np.asarray(j[1]), rtol=1e-2, atol=0.1)
        np.testing.assert_allclose(float(cost[k]), float(j[2]), rtol=1e-3)


def test_vgicp_rejects_unported_paths(vgicp_batch):
    src, grid, init = vgicp_batch
    with pytest.raises(NotImplementedError):
        treg.vgicp(src, grid, init, neighbors="direct7")
    with pytest.raises(NotImplementedError):
        treg.vgicp(src, grid, init, neighbors="direct7", schedule=((5, 1),))
    with pytest.raises(NotImplementedError):
        treg.vgicp(src, grid, init, source_covs=torch.zeros(B, 4096, 3, 3))


@pytest.mark.parametrize("neighbors,inner,schedule", [
    ("direct7", 2, ((2, 4), (2, 2), (4, 1))),
    ("direct7", 4, None),
    ("direct27", 1, None),
])
def test_point_to_plane_icp_matches_reference(neighbors, inner, schedule):
    target = structured_cloud(20, 4096)
    off = offsets(1)
    source = tpcl.voxel_downsample(tpcl.transform(target, tse3.inverse(off)), 0.25, 2048)
    grid = tvg.insert(tvg.empty(1.0, 1 << 13), target)
    jgrid = jvg.insert(jvg.empty(1.0, 1 << 13), cloud_to_jax(target))
    kw = dict(iters=8, max_corr_dist=1.0, neighbors=neighbors, inner=inner, schedule=schedule)
    res = treg.point_to_plane_icp(source, grid, tse3.identity(), **kw)
    jres = jreg.point_to_plane_icp(cloud_to_jax(source), jgrid, pose_to_jax(tse3.identity()), **kw)
    assert_pose_close(res.pose, jres.pose)


def test_fitness_matches_reference_on_the_same_grid():
    """Fitness takes each matched cell's plane from eigh3; on one table
    (a registration table: plane-regularized, >= 3 points a cell) and
    one pose the packages agree to f32 rounding (1e-5). A 2-point cell's
    covariance has a doubly degenerate spectrum whose planarity flag and
    normal follow rounding noise in either package, so tables with such
    cells agree only to ~1e-3 (`test_vgicp_direct1_matches_reference`)."""
    target = structured_cloud(21, 4096)
    grid = tvg.build(target, 0.5, 1 << 13, min_points=3, regularize="plane")
    jgrid = jvg.VoxelGrid(to_jax(grid.packed), np.float32(0.5))
    for k in range(B):
        source = tpcl.transform(target, tse3.inverse(offsets(k)))
        pose = offsets(k)
        ft = treg.fitness(source, grid, pose)
        fj = jreg.fitness(cloud_to_jax(source), jgrid, pose_to_jax(pose))
        np.testing.assert_allclose(float(ft), float(fj), atol=1e-5, rtol=0)
