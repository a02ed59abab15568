"""Row-sharded terrain features of the port
(`mapping/sharded_elevation.py`) on 2 and 4 gloo ranks on the CPU,
against the reference's `features_sharded` on as many virtual devices
and against the port's unsharded `features_plain`.

The grid is the reference test's (`tests/test_sharded_elevation.py`:
a 128 x 256 random walk, 80 % valid). Against the port's unsharded
features: bit for bit on rows [2:-2]; on the two border rows at each
end, slope and roughness too, while step and traversability follow the
reference's sharded border (zero-height empty halo rows). Against the
reference on every row: step exactly (both take the window's max and
min of the same cells). Slope, roughness and traversability are held
to the reference as `test_torch_stencil.py` holds the unsharded
features, only as far as the reference is itself right: cell by cell
the gap may not exceed the reference's own error against a float64
evaluation plus the port's float64 bound (`TOL64`). The reference's
plane fit takes absolute coordinates and cancels in f32 (its error
reaches 6e-3 on this grid); the port's takes window-local offsets.
Traversability is held so on rows [2:-2], since the float64
evaluation has the unsharded border."""
import jax
import numpy as np
import pytest

from mr_slam_tpu.mapping import sharded_elevation as jsharded
from tests import torch_dist
from tests.test_torch_stencil import TOL64, oracle64
from tests.torch_parity import emap_to_jax


def _grid(H=128, W=256, seed=0):
    rng = np.random.default_rng(seed)
    height = (rng.normal(0, 1, (H, W)).astype(np.float32).cumsum(0) * 0.02).astype(np.float32)
    return height, rng.random((H, W)) > 0.2


@pytest.fixture(scope="module", params=(2, 4), ids=("2ranks", "4ranks"))
def sharded(request, tmp_path_factory):
    world = request.param
    h, v = _grid()
    outs = torch_dist.run_ranks(torch_dist.sharded_features, world,
                                tmp_path_factory.mktemp("sharded"), h, v, 0.2)
    return world, h, v, outs


def test_ranks_agree(sharded):
    _, _, _, outs = sharded
    for out in outs[1:]:
        assert all(np.array_equal(a, b) for a, b in zip(out, outs[0]))


def test_matches_unsharded_port(sharded):
    from mr_slam_torch.mapping import elevation

    _, h, v, outs = sharded
    ref = elevation.features_plain(torch_dist.emap(h, v, 0.2))
    for name, a, b in zip(("slope", "roughness", "step", "traversability"), outs[0], ref):
        b = b.numpy()
        assert a.shape == b.shape
        assert np.array_equal(a[2:-2], b[2:-2]), name
        if name in ("slope", "roughness"):
            assert np.array_equal(a, b), name


def test_matches_reference(sharded):
    world, h, v, outs = sharded
    m = emap_to_jax(torch_dist.emap(h, v, 0.2))
    ref = jsharded.features_sharded(m, jax.make_mesh((world,), ("robot",)))
    np.testing.assert_array_equal(outs[0][2], np.asarray(ref.step))
    f64 = oracle64(h, v)
    for name, a, b, rows in (("slope", outs[0][0], ref.slope, np.s_[:]),
                             ("roughness", outs[0][1], ref.roughness, np.s_[:]),
                             ("traversability", outs[0][3], ref.traversability, np.s_[2:-2])):
        b = np.asarray(b)
        gap = np.abs(a - b)[rows]
        ok = gap <= np.abs(b - f64[name])[rows] + TOL64[name]
        assert ok.all(), (name, int((~ok).sum()), float(gap[~ok].max()))


@pytest.mark.parametrize("rows", (4, 130), ids=("short_blocks", "uneven"))
def test_bad_row_counts_raise(rows, tmp_path):
    msgs = torch_dist.run_ranks(torch_dist.sharded_bad_rows, 4, tmp_path, rows)
    assert all(m is not None and "must split" in m for m in msgs)
