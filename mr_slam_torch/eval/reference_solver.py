"""Independent trusted SE(3) pose-graph solver, the cross-check role
gtsam plays in the reference's back-end (port of
`mr_slam_tpu/eval/reference_solver.py`).

It shares NO math or code with `backend/chordal.py`, and imports nothing
from it: agreement between the two optimizers on one graph is evidence
of correctness, not of a shared bug.

  parameterization  global rotation vector per node (scipy Rotation),
                    against the chordal relaxation + GN retraction
  solver            scipy.optimize.least_squares TRF with a sparse
                    finite-difference Jacobian, against matrix-free CG
                    inside hand-derived Gauss-Newton
  assembly          float64 numpy / scipy on the host, against batched
                    tensor ops on the device

Slow but trusted: host only, for evaluation, never on a production path.
"""
from __future__ import annotations

import numpy as np
import torch

from ..backend import factor_graph as fg
from ..geometry.se3 import Pose


def _host(x: torch.Tensor, dtype=None) -> np.ndarray:
    x = x.detach().cpu().numpy()
    return x if dtype is None else x.astype(dtype)


def _extract(graph: fg.FactorGraph):
    """The valid graph content as host numpy (float64 poses)."""
    n, e = int(graph.n_nodes), int(graph.n_edges)
    return (
        _host(graph.poses.R[:n], np.float64), _host(graph.poses.t[:n], np.float64),
        _host(graph.edge_i[:e]), _host(graph.edge_j[:e]),
        _host(graph.edge_meas.R[:e], np.float64), _host(graph.edge_meas.t[:e], np.float64),
        _host(graph.edge_w_rot[:e], np.float64), _host(graph.edge_w_trans[:e], np.float64),
    )


def solve(
    graph: fg.FactorGraph,
    anchors,
    anchor_weight: float = 1e3,
    max_nfev: int | None = None,
    verbose: int = 0,
    loss: str = "linear",
) -> Pose:
    """Full nonlinear SE(3) PGO via scipy TRF least squares.

    Residuals per edge (i, j) with measurement (R_m, t_m):
        r_t = sqrt(w_t) * (R_i^T (t_j - t_i) - t_m)
        r_R = sqrt(w_r) * Log(R_m^T R_i^T R_j)
    plus anchor priors pinning each anchored node at its input pose.
    Returns a float32 Pose batched over graph.node_capacity on the
    graph's device (invalid nodes keep their input pose), the contract
    of `chordal.optimize`."""
    from scipy.optimize import least_squares
    from scipy.sparse import lil_matrix
    from scipy.spatial.transform import Rotation

    nodes_R, nodes_t, ei, ej, meas_R, meas_t, w_rot, w_trans = _extract(graph)
    N = nodes_t.shape[0]
    E = ei.shape[0]
    if N == 0:
        return graph.poses
    anchors = np.asarray(anchors.cpu() if isinstance(anchors, torch.Tensor) else anchors,
                         bool)[:N]
    aidx = np.flatnonzero(anchors)
    A = len(aidx)

    sw_t = np.sqrt(w_trans)[:, None]
    sw_r = np.sqrt(w_rot)[:, None]
    anchor_R0 = Rotation.from_matrix(nodes_R[aidx]) if A else None
    anchor_t0 = nodes_t[aidx]
    meas_rot = Rotation.from_matrix(meas_R)

    def unpack(x):
        x = x.reshape(N, 6)
        return x[:, :3], Rotation.from_rotvec(x[:, 3:])

    def residuals(x):
        t, rot = unpack(x)
        Ri = rot[ei]
        Rj = rot[ej]
        r_t = Ri.inv().apply(t[ej] - t[ei]) - meas_t
        r_R = (meas_rot.inv() * Ri.inv() * Rj).as_rotvec()
        out = [sw_t * r_t, sw_r * r_R]
        if A:
            out.append(anchor_weight * (t[aidx] - anchor_t0))
            out.append(anchor_weight * (anchor_R0.inv() * rot[aidx]).as_rotvec())
        return np.concatenate([o.ravel() for o in out])

    # sparse finite-difference Jacobian structure: each edge's residual
    # block touches the 12 states of its two endpoints; rows follow
    # `residuals`: [r_t (3E), r_R (3E), anchor_t (3A), anchor_R (3A)]
    S = lil_matrix((6 * E + 6 * A, 6 * N), dtype=np.int8)
    for e in range(E):
        for node in (ei[e], ej[e]):
            S[3 * e:3 * e + 3, 6 * node:6 * node + 6] = 1
            S[3 * E + 3 * e:3 * E + 3 * e + 3, 6 * node:6 * node + 6] = 1
    for a in range(A):
        col = slice(6 * aidx[a], 6 * aidx[a] + 6)
        S[6 * E + 3 * a:6 * E + 3 * a + 3, col] = 1
        S[6 * E + 3 * A + 3 * a:6 * E + 3 * A + 3 * a + 3, col] = 1

    x0 = np.concatenate([nodes_t, Rotation.from_matrix(nodes_R).as_rotvec()], axis=1).ravel()
    res = least_squares(residuals, x0, jac_sparsity=S, method="trf", x_scale="jac",
                        max_nfev=max_nfev, verbose=verbose, loss=loss)
    t, rot = unpack(res.x)

    out_R = _host(graph.poses.R).copy()
    out_t = _host(graph.poses.t).copy()
    out_R[:N] = rot.as_matrix().astype(np.float32)
    out_t[:N] = t.astype(np.float32)
    dev = graph.poses.t.device
    return Pose(torch.from_numpy(out_R).to(dev), torch.from_numpy(out_t).to(dev))
