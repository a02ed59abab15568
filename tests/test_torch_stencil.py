"""The 5x5 terrain stencil: the port's plain version against the
reference (`elevation.features_xla` and the Pallas kernel
`pallas_stencil.terrain_features` in interpret mode) and a float64
evaluation, and the Hopper kernel against the plain version on the card.

The port fits each window's plane in window-local coordinates; the
reference in absolute ones, whose moments cancel in float32 as the map
widens. So the plain version is held tightly to a float64 evaluation of
the same fit, and to the reference only as far as the reference is
itself right: cell by cell, |plain - reference| may not exceed the
reference's own error against float64 plus the plain version's bound.
On the `tests/test_pallas_stencil.py` cases the reference's own error
reaches 2.5e-3 rad (slope) and 1.5e-3 m (roughness) at 96 x 200, and
3e-2 on the sparse case. `step` is exact (extrema), border included.

The reference is imported inside its tests, so that the `gpu` tests
also run on a card machine without JAX:

    python -m pytest --noconftest -o addopts= -m gpu tests/test_torch_stencil.py
"""
import numpy as np
import pytest
import torch

from mr_slam_torch.mapping import elevation as tel
from mr_slam_torch.ops import hopper_stencil

RES = 0.2
CRIT = (0.6, 0.15, 0.3)
# plain vs float64, in the window-local fit (measured: slope <= 2.7e-6
# rad, roughness <= 1.3e-4 m, traversability <= 1e-6). Roughness is the
# square root of a residual variance, so a float32 residue of ~1e-8 m^2
# on exactly-fitting windows (three valid cells) shows as ~1e-4 m; the
# blend divides roughness by 0.15, hence traversability's bound.
TOL64 = dict(slope=1e-5, roughness=5e-4, traversability=4e-3)


def case(H, W, seed=0, frac_valid=0.8):
    """`tests/test_pallas_stencil.py`'s inputs: a random walk down the
    rows, a random valid mask."""
    rng = np.random.default_rng(seed)
    height = (rng.normal(0, 1, (H, W)).astype(np.float32).cumsum(0)) * 0.02
    valid = rng.random((H, W)) < frac_valid
    return height.astype(np.float32), valid


def terrain(H, W, seed=11, frac_valid=0.8):
    """Smooth rolling terrain with 1 cm noise."""
    rng = np.random.default_rng(seed)
    ii, jj = np.meshgrid(np.arange(H) * RES, np.arange(W) * RES, indexing="ij")
    h = 0.3 * np.sin(ii / 3.0) + 0.25 * np.cos(jj / 4.0) + 0.01 * rng.standard_normal((H, W))
    return h.astype(np.float32), rng.random((H, W)) < frac_valid


def oracle64(height, valid, res=RES, window=5, crit=CRIT):
    """The features in float64 with window-local metre coordinates, the
    reference's formulas and det floor; an independent evaluation."""
    H, W = height.shape
    p = window // 2
    v = valid.astype(np.float64)
    z = np.where(valid, height, 0.0).astype(np.float64)
    vp, zp = np.pad(v, p), np.pad(z, p)
    zmax_p = np.pad(z, p, constant_values=-np.inf)
    zmin_p = np.pad(np.where(valid, height, np.inf).astype(np.float64), p,
                    constant_values=np.inf)
    names = ("1", "x", "y", "z", "xx", "yy", "xy", "xz", "yz", "zz")
    S = {k: np.zeros((H, W)) for k in names}
    zmax = np.full((H, W), -np.inf)
    zmin = np.full((H, W), np.inf)
    r = float(np.float32(res))
    for di in range(-p, p + 1):
        for dj in range(-p, p + 1):
            win = np.s_[p + di:p + di + H, p + dj:p + dj + W]
            vs, zs, x, y = vp[win], zp[win], di * r, dj * r
            for k, val in zip(names, (vs, vs * x, vs * y, vs * zs, vs * x * x, vs * y * y,
                                      vs * x * y, vs * x * zs, vs * y * zs, vs * zs * zs)):
                S[k] += val
            zmax = np.maximum(zmax, zmax_p[win])
            zmin = np.minimum(zmin, zmin_p[win])
    n = np.maximum(S["1"], 1.0)
    mx, my, mz = S["x"] / n, S["y"] / n, S["z"] / n
    cxx, cyy = S["xx"] / n - mx * mx, S["yy"] / n - my * my
    cxy, cxz = S["xy"] / n - mx * my, S["xz"] / n - mx * mz
    cyz, czz = S["yz"] / n - my * mz, S["zz"] / n - mz * mz
    det = cxx * cyy - cxy * cxy
    ds = np.where(np.abs(det) < 1e-9, 1e-9, det)
    a = (cyy * cxz - cxy * cyz) / ds
    b = (cxx * cyz - cxy * cxz) / ds
    slope = np.arctan(np.sqrt(a * a + b * b))
    rough = np.sqrt(np.maximum(czz - (a * cxz + b * cyz), 0.0))
    step = np.where(np.isfinite(zmin), zmax - zmin, 0.0)
    enough = S["1"] >= 3
    trav = 1.0 - np.maximum(np.maximum(slope / crit[0], rough / crit[1]), step / crit[2])
    trav = np.where(enough & valid, np.clip(trav, 0.0, 1.0), 0.5)
    return dict(slope=np.where(enough, slope, 0.0), roughness=np.where(enough, rough, 0.0),
                step=step, traversability=trav, det=det, enough=enough)


def plain(height, valid, window=5):
    m = tel.ElevationMap(torch.from_numpy(height), torch.ones(height.shape),
                         torch.from_numpy(valid), torch.zeros(2), torch.tensor(RES))
    return {k: v.numpy() for k, v in tel.features_plain(m, window)._asdict().items()}


def reference(height, valid, window=5):
    import jax.numpy as jnp
    from mr_slam_tpu.mapping import elevation as jel

    m = jel.ElevationMap(jnp.asarray(height), jnp.ones(height.shape), jnp.asarray(valid),
                         jnp.zeros(2), jnp.float32(RES))
    return {k: np.asarray(v) for k, v in jel.features_xla(m, window)._asdict().items()}


def pallas(height, valid):
    import jax.numpy as jnp
    from mr_slam_tpu.ops import pallas_stencil

    out = pallas_stencil.terrain_features(jnp.asarray(height), jnp.asarray(valid),
                                          jnp.float32(RES))
    return dict(zip(("slope", "roughness", "step", "traversability"),
                    (np.asarray(o) for o in out)))


CASES = {"dense_96x200": (96, 200, 0, 0.8), "sparse_64x140": (64, 140, 3, 0.05)}


@pytest.fixture(scope="module", params=sorted(CASES))
def runs(request):
    h, v = case(*CASES[request.param])
    return dict(h=h, v=v, plain=plain(h, v), f64=oracle64(h, v))


LAYERS = ("slope", "roughness", "traversability")


@pytest.mark.parametrize("layer", LAYERS)
def test_plain_matches_float64(runs, layer):
    t, o = runs["plain"], runs["f64"]
    np.testing.assert_allclose(t[layer], o[layer], rtol=0, atol=TOL64[layer])


def test_near_singular_windows_follow_float64(runs):
    """Windows with |det| < 1e-6 m^4 (few or collinear valid cells): the
    exact xy moments make collinear windows exactly singular, with a
    zero gradient, as in exact arithmetic."""
    t, o = runs["plain"], runs["f64"]
    near = o["enough"] & (np.abs(o["det"]) < 1e-6)
    if runs["v"].mean() < 0.5:
        assert near.sum() > 10  # the sparse case has such windows
    for layer in ("slope", "roughness"):
        np.testing.assert_allclose(t[layer][near], o[layer][near], rtol=0, atol=TOL64[layer])


@pytest.mark.parametrize("impl", ["features_xla", "pallas"])
def test_plain_step_matches_reference(runs, impl):
    ref = reference(runs["h"], runs["v"]) if impl == "features_xla" else pallas(runs["h"], runs["v"])
    t = runs["plain"]
    # features_xla everywhere; the Pallas stripe pads the border with z = 0
    sl = np.s_[:, :] if impl == "features_xla" else np.s_[2:-2, 2:-2]
    np.testing.assert_allclose(t["step"][sl], ref["step"][sl], rtol=0, atol=1e-5)
    np.testing.assert_array_equal(t["step"], runs["f64"]["step"].astype(np.float32))


@pytest.mark.parametrize("impl", ["features_xla", "pallas"])
@pytest.mark.parametrize("layer", LAYERS)
def test_plain_matches_reference_up_to_its_own_error(runs, impl, layer):
    ref = reference(runs["h"], runs["v"]) if impl == "features_xla" else pallas(runs["h"], runs["v"])
    t, o = runs["plain"], runs["f64"]
    inner = np.s_[2:-2, 2:-2]
    gap = np.abs(t[layer] - ref[layer])[inner]
    ref_err = np.abs(ref[layer] - o[layer])[inner]
    near = (o["enough"] & (np.abs(o["det"]) < 1e-6))[inner]
    ok = gap <= ref_err + TOL64[layer]
    assert ok.all(), (layer, int((~ok).sum()), float(gap[~ok].max()))
    if runs["v"].mean() > 0.5:  # dense: the interior agrees within the outer bound
        assert float(gap[~near].max()) <= 2e-2


def test_unknown_cells_are_mid_score(runs):
    """Cells with < 3 valid neighbours: traversability 0.5, slope and
    roughness 0."""
    t, o = runs["plain"], runs["f64"]
    unknown = ~o["enough"]
    if runs["v"].mean() < 0.5:
        assert unknown.sum() > 100
    assert np.all(t["traversability"][unknown | ~runs["v"]] == 0.5)
    assert np.all(t["slope"][unknown] == 0) and np.all(t["roughness"][unknown] == 0)
    for a in t.values():
        assert np.isfinite(a).all()


def test_conditioning_on_a_wide_strip():
    """64 x 2048 cells at 0.2 m (a 410 m strip of smooth terrain): at the
    far columns the plain version stays within 1e-3 of float64, where
    the reference's absolute-coordinate moments cancel (its documented
    defect, pinned here: errors above 1e-2 rad / 1e-2 m)."""
    h, v = terrain(64, 2048)
    t, o, ref = plain(h, v), oracle64(h, v), reference(h, v)
    far = np.s_[:, 1800:]
    for layer in ("slope", "roughness"):
        assert np.abs(t[layer] - o[layer])[far].max() < 1e-3, layer
        assert np.abs(ref[layer] - o[layer])[far].max() > 1e-2, layer
    near = np.s_[:, :200]
    assert np.abs(ref["slope"] - o["slope"])[near].max() < 1e-3  # fine near the origin


def test_window3_matches_reference():
    h, v = case(40, 60, seed=1)
    t, ref, o = plain(h, v, 3), reference(h, v, 3), oracle64(h, v, window=3)
    np.testing.assert_array_equal(t["step"], ref["step"])
    for layer in LAYERS:
        gap = np.abs(t[layer] - ref[layer])
        assert (gap <= np.abs(ref[layer] - o[layer]) + TOL64[layer]).all(), layer


@pytest.mark.parametrize("frac_valid", [0.05, 0.5, 0.8])
def test_separable_xy_moments_are_exact_integers(frac_valid):
    """The separable sums keep the six xy moments (S1, Su, Sw, Suu, Sww,
    Suw) exact: equal to their integer values, border included."""
    h, v = case(37, 53, seed=4, frac_valid=frac_valid)
    m = hopper_stencil.window_moments(torch.from_numpy(h), torch.from_numpy(v))
    vp = np.pad(v.astype(np.int64), 2)
    want = {k: np.zeros(v.shape, np.int64) for k in ("1", "u", "w", "uu", "ww", "uw")}
    for u in range(-2, 3):
        for w in range(-2, 3):
            vs = vp[2 + u:2 + u + v.shape[0], 2 + w:2 + w + v.shape[1]]
            for k, c in (("1", 1), ("u", u), ("w", w), ("uu", u * u), ("ww", w * w), ("uw", u * w)):
                want[k] += c * vs
    for got, k in zip(m[:6], ("1", "u", "w", "uu", "ww", "uw")):
        np.testing.assert_array_equal(got.numpy(), want[k].astype(np.float32), err_msg=k)


def test_dispatch_on_cpu_runs_plain_version():
    h, v = case(30, 40, seed=2)
    m = tel.ElevationMap(torch.from_numpy(h), torch.ones(h.shape), torch.from_numpy(v),
                         torch.zeros(2), torch.tensor(RES))
    hopper_stencil.reset_launch_count()
    for a, b in zip(tel.features(m), tel.features_plain(m)):
        assert torch.equal(a, b)
    for a, b in zip(tel.features_fused(m), tel.features_plain(m)):
        assert torch.equal(a, b)
    assert hopper_stencil.launch_count() == 0


def test_wrapper_rejects_bad_arguments():
    h = torch.zeros((8, 8))
    v = torch.ones((8, 8), dtype=torch.bool)
    with pytest.raises(ValueError):
        hopper_stencil.terrain_features(h.double(), v, RES)
    with pytest.raises(ValueError):
        hopper_stencil.terrain_features(h, v.float(), RES)
    with pytest.raises(ValueError):
        hopper_stencil.terrain_features(h, v[:4], RES)
    with pytest.raises(ValueError):
        hopper_stencil.terrain_features(h[None], v[None], RES)


# --------------------------------------------------------------------------
# the kernel, on the card
# --------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


def kernel_and_plain(h, v, dev):
    ht = torch.from_numpy(h).to(dev)
    vt = torch.from_numpy(v).to(dev)
    res = torch.tensor(RES, device=dev)
    out = hopper_stencil.terrain_features(ht, vt, res)
    again = hopper_stencil.terrain_features(ht, vt, res)
    ref = hopper_stencil.terrain_features_plain(ht, vt, res)
    torch.cuda.synchronize()
    return out, again, ref


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(256, 300), (2048, 2048), (1, 1), (3, 4), (7, 33), (100, 37),
                                   (40, 1), (33, 68), (65, 132)])
@pytest.mark.parametrize("kind", ["random", "terrain"])
def test_kernel_matches_plain_on_card(cuda_device, shape, kind):
    h, v = case(*shape) if kind == "random" else terrain(*shape)
    hopper_stencil.reset_launch_count()
    out, again, ref = kernel_and_plain(h, v, cuda_device)
    assert hopper_stencil.launch_count() == 2
    assert torch.equal(out[2], ref[2])  # step: exact
    for a, b in zip(out, ref):  # the other layers: the same operations in order
        np.testing.assert_allclose(a.cpu().numpy(), b.cpu().numpy(), rtol=0, atol=1e-6)
    for a, b in zip(out, again):  # no atomics: bit-identical reruns
        assert torch.equal(a, b)


@pytest.mark.gpu
def test_features_dispatch_launches_kernel_on_card(cuda_device):
    h, v = terrain(64, 96)
    m = tel.ElevationMap(torch.from_numpy(h).to(cuda_device), torch.ones(h.shape, device=cuda_device),
                         torch.from_numpy(v).to(cuda_device), torch.zeros(2, device=cuda_device),
                         torch.tensor(RES, device=cuda_device))
    hopper_stencil.reset_launch_count()
    f = tel.features(m)
    g = tel.features(m, window=3)  # another window: the plain version
    torch.cuda.synchronize()
    assert hopper_stencil.launch_count() == 1
    o = oracle64(h, v)
    np.testing.assert_allclose(f.slope.cpu().numpy(), o["slope"], atol=TOL64["slope"])
    assert g.step.shape == (64, 96)


@pytest.mark.gpu
def test_one_launch_per_call_and_graph_capture_on_card(cuda_device):
    """One launch per call, none counted while a CUDA graph captures the
    call (the capture records it and runs nothing), and the captured
    call replays to the eager result bit for bit."""
    h, v = terrain(96, 160)
    ht, vt = torch.from_numpy(h).to(cuda_device), torch.from_numpy(v).to(cuda_device)
    res = torch.tensor(RES, device=cuda_device)
    eager = hopper_stencil.terrain_features(ht, vt, res)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        hopper_stencil.terrain_features(ht, vt, res)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    hopper_stencil.reset_launch_count()
    recorded = hopper_stencil.recorded_count()
    with torch.cuda.graph(graph):
        captured = hopper_stencil.terrain_features(ht, vt, res)
    assert hopper_stencil.launch_count() == 0
    assert hopper_stencil.recorded_count() == recorded + 1
    graph.replay()
    torch.cuda.synchronize()
    for a, b in zip(eager, captured):
        assert torch.equal(a, b)


@pytest.mark.gpu
def test_segment_replays_count_the_recorded_launch_on_card(cuda_device):
    """A stencil call captured in a `frame_graph.Segments` graph and
    replayed twice reads 2 launches: each replay adds the launch its
    capture recorded."""
    from mr_slam_torch.runtime import frame_graph

    h, v = terrain(96, 160)
    bufs = dict(height=torch.from_numpy(h).to(cuda_device), valid=torch.from_numpy(v).to(cuda_device),
                res=torch.tensor(RES, device=cuda_device))

    def fn(b):
        return dict(zip(("slope", "roughness", "step", "travers"),
                        hopper_stencil.terrain_features(b["height"], b["valid"], b["res"])))

    segs = frame_graph.Segments(cuda_device, "frontend")
    with segs.on_stream():
        eager = segs.eager("stencil", fn, bufs)  # makes the workspaces, as a runner's first call
        hopper_stencil.reset_launch_count()
        for _ in range(2):
            out = segs.run("stencil", fn, bufs)  # the first captures, then replays
    torch.cuda.synchronize()
    assert segs.captures == 1 and segs.replays == 2
    assert hopper_stencil.launch_count() == 2
    for k in eager:
        assert torch.equal(out[k], eager[k])
    segs.close(2)
