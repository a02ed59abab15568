"""The transform buffer (`geometry/tf_tree.py`): the reference's
`tests/test_tf_tree.py` cases run on both packages, and every lookup of
the port equal to the reference's within 1e-12."""
import numpy as np
import pytest

from mr_slam_torch.geometry import tf_tree as ttf
from mr_slam_tpu.geometry import tf_tree as jtf

PACKAGES = pytest.mark.parametrize("tf", [ttf, jtf], ids=["port", "reference"])


def rot_z(a):
    c, s = np.cos(a), np.sin(a)
    return np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])


def rot(w):
    a = np.linalg.norm(w)
    k = w / a
    K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(a) * K + (1 - np.cos(a)) * (K @ K)


@PACKAGES
def test_single_edge_interpolation(tf):
    buf = tf.TransformBuffer()
    buf.set_transform("map", "odom", 0.0, np.eye(3), np.zeros(3))
    buf.set_transform("map", "odom", 1.0, rot_z(np.pi / 2), np.array([2.0, 0, 0]))
    R, t = buf.lookup("map", "odom", 0.5)
    np.testing.assert_allclose(R, rot_z(np.pi / 4), atol=1e-9)
    np.testing.assert_allclose(t, [1.0, 0, 0], atol=1e-9)
    R, t = buf.lookup("map", "odom", 5.0)  # clamped outside the buffer
    np.testing.assert_allclose(t, [2.0, 0, 0], atol=1e-12)


@PACKAGES
def test_chain_and_inverse(tf):
    buf = tf.TransformBuffer()
    buf.set_transform("map", "odom", 0.0, rot_z(np.pi / 2), np.array([1.0, 0, 0]))
    buf.set_transform("odom", "base", 0.0, np.eye(3), np.array([0.0, 3.0, 0]))
    R, t = buf.lookup("map", "base", 0.0)
    np.testing.assert_allclose(R, rot_z(np.pi / 2), atol=1e-12)
    np.testing.assert_allclose(t, [1.0 - 3.0, 0.0, 0.0], atol=1e-12)
    Ri, ti = buf.lookup("base", "map", 0.0)
    np.testing.assert_allclose(Ri @ R, np.eye(3), atol=1e-12)
    np.testing.assert_allclose(Ri @ t + ti, 0.0, atol=1e-12)


@PACKAGES
def test_disconnected_and_unknown(tf):
    buf = tf.TransformBuffer()
    buf.set_transform("map", "odom", 0.0, np.eye(3), np.zeros(3))
    buf.set_transform("a", "b", 0.0, np.eye(3), np.zeros(3))
    assert buf.can_transform("map", "odom")
    assert not buf.can_transform("map", "b")
    with pytest.raises(LookupError):
        buf.lookup("map", "b", 0.0)
    with pytest.raises(LookupError):
        buf.lookup("map", "nope", 0.0)
    with pytest.raises(ValueError):
        buf.set_transform("odom", "map", 1.0, np.eye(3), np.zeros(3))


@PACKAGES
def test_out_of_order_insert(tf):
    buf = tf.TransformBuffer()
    buf.set_transform("map", "odom", 2.0, np.eye(3), np.array([2.0, 0, 0]))
    buf.set_transform("map", "odom", 0.0, np.eye(3), np.zeros(3))
    _, t = buf.lookup("map", "odom", 1.0)
    np.testing.assert_allclose(t, [1.0, 0, 0], atol=1e-12)


@PACKAGES
def test_publish_map_to_odom(tf):
    buf = tf.TransformBuffer()
    T = np.eye(4)
    T[:3, :3] = rot_z(0.3)
    T[:3, 3] = [1.0, 2.0, 0.5]
    tf.publish_map_to_odom(buf, 2, T, 1.5)
    R, t = buf.lookup("map", "robot_2/odom", 1.5)
    np.testing.assert_allclose(R, T[:3, :3], atol=1e-9)
    np.testing.assert_allclose(t, T[:3, 3], atol=1e-12)


@PACKAGES
def test_quat_roundtrip_random(tf):
    rng = np.random.default_rng(0)
    for _ in range(20):
        R = rot(rng.normal(size=3))
        np.testing.assert_allclose(tf._R_from_quat(tf._quat_from_R(R)), R, atol=1e-9)


def test_lookups_equal_reference():
    """A random 4-frame tree with out-of-order stamps, a trimmed cache
    and near-identical quaternions (the lerp branch of slerp): every
    lookup in both directions and at stamps inside, between and outside
    the samples equals the reference's within 1e-12."""
    rng = np.random.default_rng(7)
    bufs = [ttf.TransformBuffer(cache_size=8), jtf.TransformBuffer(cache_size=8)]
    edges = [("map", "robot_0/odom"), ("map", "robot_1/odom"), ("robot_0/odom", "base")]
    for parent, child in edges:
        stamps = rng.permutation(np.arange(14) * 0.1 + rng.uniform(0, 0.05))
        for s in stamps:
            w = rng.normal(size=3) * (1e-3 if s < 0.4 else 1.0)
            R, t = rot(w), rng.normal(size=3)
            for b in bufs:
                b.set_transform(parent, child, s, R, t)
    assert bufs[0].frames() == bufs[1].frames()
    for target, source in [("map", "base"), ("base", "map"), ("robot_1/odom", "base"),
                           ("robot_0/odom", "map")]:
        for s in (-1.0, 0.05, 0.37, 0.8, 0.95, 3.0):
            (Ra, ta), (Rb, tb) = (b.lookup(target, source, s) for b in bufs)
            np.testing.assert_allclose(Ra, Rb, rtol=0, atol=1e-12)
            np.testing.assert_allclose(ta, tb, rtol=0, atol=1e-12)
