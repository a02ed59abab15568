"""Decentralized Gauss-Seidel / Jacobi PGO of the port
(`backend/gauss_seidel.py`) against the reference's: the four cases of
`tests/test_gauss_seidel.py` run on the port, and the port's poses
against the reference's on the same graphs.

Graphs: the reference tests' own builders (two drifted circles tied by
exact inter-robot loops; one drifted circle), carried across through
numpy. Both packages run the same sweeps and CG iterations in f32 from
the same start, but the block solves are ill-conditioned (the 1e6
anchor rows against unit-weight edges, a few CG iterations a block),
so an ulp of summation order grows: on these graphs both f32 solves lie
up to 0.10 m and 0.010 (rotation entries) from a float64 solve of the
port, and up to 0.044 m / 0.011 from each other. Parity is therefore
held on the trajectory, ATE within 5 mm of the reference's (measured
0.7-2 mm), and pose by pose within that rounding spread: 0.1 m on
translations, 0.03 on rotation entries.

That the spread is rounding and not a difference of algorithm is shown
in float64 on both sides (`test_matches_reference_float64`: the
reference in JAX's x64 mode in a process of its own, the port on the
same graph cast to float64). The rotation stage then agrees to 1e-10,
and `_masked_cg` on a well-conditioned system to 1e-12. In the pose
stage each CG iteration of a block solve can multiply a difference of
summation order by up to 1e3 (the 1e6 anchor rows), so even float64
runs part by more than their rounding: measured 6.2e-6 m / 1.2e-6
(Gauss-Seidel), 1.0e-6 / 4.5e-7 (Jacobi with gamma), 2.8e-6 / 8.3e-7
(Jacobi with gamma at one CG iteration a block), 3e-15 for the other
one-iteration cases. Every float64 case is held to 2e-5, 5000 times
tighter than the float32 bound. Without flagged initialization and at
15 CG iterations a block the float64 runs part by 0.10 m as the float32
ones do (10 sweeps leave the solve unconverged and chaotic), so that
variant is held in float64 at one CG iteration a block only."""
import json
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mr_slam_torch.backend import chordal as tch, gauss_seidel as tgs
from mr_slam_tpu.backend import gauss_seidel as jgs
from tests.test_backend import ate_rmse, build_circle_graph
from tests.test_gauss_seidel import build_two_robot_graph
from tests.torch_parity import graph_astype, graph_to_jax, graph_to_numpy, graph_to_torch

REPO = Path(__file__).resolve().parents[1]
F64_ATOL = 2e-5   # float64 on both sides: m on translations, and on rotation entries


def _two_robot(seed):
    g, true_t = build_two_robot_graph(seed=seed)
    anchors = np.zeros(g.node_capacity, bool)
    anchors[0] = True
    return g, graph_to_torch(g), np.asarray(true_t), anchors


def _ate(t, true_t, valid):
    return ate_rmse(jnp.asarray(np.asarray(t)), jnp.asarray(true_t), jnp.asarray(valid))


def test_config_matches_reference():
    assert tgs.GSConfig._fields == jgs.GSConfig._fields
    assert tgs.GSConfig() == jgs.GSConfig()


def test_two_robot_convergence():
    g, tg, true_t, anchors = _two_robot(0)
    valid = np.asarray(g.node_valid)
    a = torch.from_numpy(anchors)
    before = _ate(tg.poses.t, true_t, valid)
    opt = tgs.optimize(tg, a, 2, tgs.GSConfig(rot_sweeps=15, pose_sweeps=15, cg_iters=12))
    after = _ate(opt.t, true_t, valid)
    assert torch.isfinite(opt.t).all()
    cen_err = _ate(tch.optimize(tg, a, tch.PGOConfig()).t, true_t, valid)
    assert after < before, (before, after)
    assert after < 1.35 * cen_err, (after, cen_err)


def test_matches_centralized_fixed_point():
    g, tg, true_t, anchors = _two_robot(3)
    valid = np.asarray(g.node_valid)
    a = torch.from_numpy(anchors)
    gs = tgs.optimize(tg, a, 2, tgs.GSConfig(rot_sweeps=25, pose_sweeps=25, cg_iters=15))
    cen = tch.optimize(tg, a, tch.PGOConfig(rot_cg_iters=60, gn_iters=12, pose_cg_iters=40))
    err_gs, err_cen = _ate(gs.t, true_t, valid), _ate(cen.t, true_t, valid)
    assert err_gs < max(2.0 * err_cen, 0.05), (err_gs, err_cen)


def test_jacobi_and_relaxation_variants():
    g, tg, true_t, anchors = _two_robot(1)
    valid = np.asarray(g.node_valid)
    before = _ate(tg.poses.t, true_t, valid)
    jac = tgs.optimize(tg, torch.from_numpy(anchors), 2,
                       tgs.GSConfig(rot_sweeps=20, pose_sweeps=20, cg_iters=12, jacobi=True,
                                    gamma=0.8))
    assert _ate(jac.t, true_t, valid) < 0.95 * before


def test_single_robot_matches_chordal():
    g, true, _ = build_circle_graph(n=24, node_cap=32, edge_cap=64)
    tg = graph_to_torch(g)
    a = torch.zeros(tg.node_capacity, dtype=torch.bool)
    a[0] = True
    gs = tgs.optimize(tg, a, 1, tgs.GSConfig(rot_sweeps=10, pose_sweeps=15, cg_iters=20,
                                             flagged_init=False))
    true_t = np.asarray(true.t)
    err = ate_rmse(jnp.asarray(gs.t.numpy()[:24]), jnp.asarray(true_t))
    cen = tch.optimize(tg, a, tch.PGOConfig())
    cen_err = ate_rmse(jnp.asarray(cen.t.numpy()[:24]), jnp.asarray(true_t))
    # single robot: the block solve IS the global solve -> the same optimum
    assert err < 1.05 * cen_err, (err, cen_err)


VARIANTS = {
    "gauss_seidel": dict(seed=0, cfg=dict(rot_sweeps=15, pose_sweeps=15, cg_iters=12)),
    "jacobi_gamma": dict(seed=1, cfg=dict(rot_sweeps=20, pose_sweeps=20, cg_iters=12,
                                          jacobi=True, gamma=0.8)),
    "no_flagged_init": dict(seed=2, cfg=dict(rot_sweeps=10, pose_sweeps=10, cg_iters=15,
                                             flagged_init=False)),
}


@pytest.mark.parametrize("name", VARIANTS)
def test_matches_reference(name):
    v = VARIANTS[name]
    g, tg, true_t, anchors = _two_robot(v["seed"])
    port = tgs.optimize(tg, torch.from_numpy(anchors), 2, tgs.GSConfig(**v["cfg"]))
    ref = jgs.optimize(g, jnp.asarray(anchors), 2, jgs.GSConfig(**v["cfg"]))
    valid = np.asarray(g.node_valid)
    assert abs(_ate(port.t, true_t, valid) - _ate(ref.t, true_t, valid)) < 5e-3
    np.testing.assert_allclose(port.t.numpy()[valid], np.asarray(ref.t)[valid], atol=0.1, rtol=0)
    np.testing.assert_allclose(port.R.numpy()[valid], np.asarray(ref.R)[valid], atol=0.03, rtol=0)


def test_rerun_bit_identical():
    _, tg, _, anchors = _two_robot(0)
    cfg = tgs.GSConfig(rot_sweeps=5, pose_sweeps=5, cg_iters=8)
    a = tgs.optimize(tg, torch.from_numpy(anchors), 2, cfg)
    b = tgs.optimize(tg, torch.from_numpy(anchors), 2, cfg)
    assert torch.equal(a.t, b.t) and torch.equal(a.R, b.R)



# float64 on both sides: (variant whose graph is used, its config with
# these changes)
F64_CASES = {
    "gauss_seidel": ("gauss_seidel", {}),
    "jacobi_gamma": ("jacobi_gamma", {}),
    "gauss_seidel_cg1": ("gauss_seidel", dict(cg_iters=1)),
    "jacobi_gamma_cg1": ("jacobi_gamma", dict(cg_iters=1)),
    "no_flagged_init_cg1": ("no_flagged_init", dict(cg_iters=1)),
}


def _f64_config(case):
    variant, change = F64_CASES[case]
    return dict(VARIANTS[variant]["cfg"], **change)


def _cg_system(seed=0, n=12):
    """A well-conditioned SPD system (n, 3) with half its rows masked:
    (matrix, b, mask)."""
    rng = np.random.default_rng(seed)
    Q = rng.normal(size=(3 * n, 3 * n))
    return Q @ Q.T / (3 * n) + np.eye(3 * n), rng.normal(size=(n, 3)), np.arange(n) % 2 == 0


def _reference_f64(inp: str, out: str) -> None:
    """The reference's `optimize` of every F64_CASES case and its
    `_masked_cg` on `_cg_system()` in float64 (run in a process with
    JAX_ENABLE_X64 set): the graphs and anchors from `inp`, the results
    to `out`."""
    import jax

    assert jax.config.jax_enable_x64
    data = np.load(inp)
    res = {}
    for case, (variant, _) in F64_CASES.items():
        a = {k.split("/", 1)[1]: data[k] for k in data.files if k.startswith(variant + "/")}
        opt = jgs.optimize(graph_to_jax(a, jnp.float64), jnp.asarray(a["anchors"]), 2,
                           jgs.GSConfig(**_f64_config(case)))
        assert opt.t.dtype == jnp.float64
        res[f"{case}/R"], res[f"{case}/t"] = np.asarray(opt.R), np.asarray(opt.t)
    M, b, mask = (jnp.asarray(x) for x in _cg_system())
    res["cg"] = np.asarray(jgs._masked_cg(lambda x: (M @ x.reshape(-1)).reshape(x.shape), b,
                                          mask, 8))
    np.savez(out, **res)


@pytest.fixture(scope="module")
def reference_f64(tmp_path_factory):
    """The reference's float64 results (`_reference_f64`) and the port's
    graphs {variant: (graph, anchors, valid)}, from one child process
    (x64 must not reach this process's other JAX tests)."""
    d = tmp_path_factory.mktemp("gs64")
    graphs, arrays = {}, {}
    for name, v in VARIANTS.items():
        g, tg, _, anchors = _two_robot(v["seed"])
        graphs[name] = (tg, anchors, np.asarray(g.node_valid))
        a = graph_to_numpy(g)
        a["anchors"] = anchors
        arrays.update({f"{name}/{k}": np.asarray(x) for k, x in a.items()})
    np.savez(d / "in.npz", **arrays)
    env = dict(os.environ, JAX_ENABLE_X64="1", JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join([str(REPO), os.environ.get("PYTHONPATH", "")]))
    subprocess.run([sys.executable, "-m", "tests.test_torch_gauss_seidel", str(d / "in.npz"),
                    str(d / "out.npz")], env=env, cwd=REPO, check=True, timeout=300)
    return dict(np.load(d / "out.npz")), graphs


@pytest.mark.parametrize("case", F64_CASES)
def test_matches_reference_float64(case, reference_f64):
    ref, graphs = reference_f64
    tg, anchors, valid = graphs[F64_CASES[case][0]]
    port = tgs.optimize(graph_astype(tg, torch.float64), torch.from_numpy(anchors), 2,
                        tgs.GSConfig(**_f64_config(case)))
    assert port.t.dtype == torch.float64
    gap = (float(np.abs(port.t.numpy() - ref[f"{case}/t"])[valid].max()),
           float(np.abs(port.R.numpy() - ref[f"{case}/R"])[valid].max()))
    print(f"{case}: float64 gap {gap[0]:.3g} m, {gap[1]:.3g} on rotation entries")
    assert gap[0] <= F64_ATOL and gap[1] <= F64_ATOL, json.dumps(gap)


def test_masked_cg_matches_reference_float64(reference_f64):
    ref, _ = reference_f64
    M, b, mask = (torch.from_numpy(x) for x in _cg_system())
    x = tgs._masked_cg(lambda v: (M @ v.reshape(-1)).reshape(v.shape), b, mask, 8)
    assert not x[~mask].any()
    np.testing.assert_allclose(x.numpy(), ref["cg"], atol=1e-12, rtol=0)


if __name__ == "__main__":
    _reference_f64(sys.argv[1], sys.argv[2])
