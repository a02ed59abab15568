"""Checkpoint / restore of the whole SLAM state (port of
`mr_slam_tpu/runtime/checkpoint.py`: `save`, `restore`, `save_session`,
`load_session`).

The files are the reference's: `save` writes one npz entry per leaf,
keyed by the leaf's path; `save_session` writes the online session as
numbered leaves per part (`mstore.{i}`, `graph.{i}`, `opt.{i}`,
`odo.{r}.{i}`, `gem.{r}.{i}`, `gemlp.{r}.{i}`), the flushed GEM submaps
(`gemf.{r}.xyz/mask`), the loop and candidate transforms
(`loops.R/t`, `cands.R/t`) and a uint8 `manifest` holding the JSON of
the config, the scheduler state and the host-side records. A session
file written by either package loads into the other.

So the leaves are numbered as `jax.tree_util` numbers them: NamedTuple
fields in declaration order, dict keys sorted (a ScanContext
descriptor `{"sc", "key"}` is stored `key` first), lists in order,
`None` dropped. A field the port keeps on the host (the factor graph's
node and edge counts, the odometry frame counter, a voxel grid's leaf)
is a leaf all the same, written as the reference's 0-d array and read
back into a Python number. Integer arrays are written as int32, the
reference's integer type, and read back in the dtype of the port's
template (int64 counts and indices).

The reference's orbax wrappers (`save_orbax`, `restore_orbax`) wrap a
JAX library and have no counterpart here.
"""
from __future__ import annotations

import json
import os
from typing import Any

import numpy as np
import torch


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def flatten(tree: Any, path: str = ""):
    """[(path, leaf)] in `jax.tree_util` order. Paths are written as
    jax's `keystr` parts are (`.field`, `['key']`, `[i]`), joined by
    '/'."""
    if tree is None:
        return []
    join = (lambda p: f"{path}/{p}") if path else (lambda p: p)
    if _is_namedtuple(tree):
        return [x for f in tree._fields for x in flatten(getattr(tree, f), join(f".{f}"))]
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in flatten(tree[k], join(f"[{k!r}]"))]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree) for x in flatten(v, join(f"[{i}]"))]
    return [(path, tree)]


def unflatten(template: Any, leaves):
    """`template`'s structure with its leaves taken in order from the
    iterator `leaves`."""
    if template is None:
        return None
    if _is_namedtuple(template):
        return type(template)(*(unflatten(getattr(template, f), leaves) for f in template._fields))
    if isinstance(template, dict):
        out = {k: unflatten(template[k], leaves) for k in sorted(template)}
        return {k: out[k] for k in template}
    if isinstance(template, (list, tuple)):
        return type(template)(unflatten(v, leaves) for v in template)
    return next(leaves)


def to_numpy(leaf) -> np.ndarray:
    """A leaf as the reference stores it: a host COPY (the session's
    tensors are written in place by later frames), integers as int32, a
    Python float as float32."""
    if isinstance(leaf, torch.Tensor):
        arr = leaf.detach().cpu().numpy().copy()
    elif isinstance(leaf, bool):
        arr = np.asarray(leaf)
    elif isinstance(leaf, int):
        arr = np.asarray(leaf, np.int32)
    elif isinstance(leaf, float):
        arr = np.asarray(leaf, np.float32)
    else:
        arr = np.array(leaf)
    if arr.dtype == np.int64:
        arr = arr.astype(np.int32)
    return arr


def from_numpy(arr: np.ndarray, like, name: str = "leaf"):
    """`arr` in the form of the template leaf `like`: a tensor of its
    dtype on its device (shapes must match), or a host number."""
    if isinstance(like, torch.Tensor):
        if tuple(arr.shape) != tuple(like.shape):
            raise ValueError(f"shape mismatch for {name}: {arr.shape} vs {tuple(like.shape)}")
        return torch.from_numpy(np.ascontiguousarray(arr)).to(dtype=like.dtype, device=like.device)
    if arr.shape != ():
        raise ValueError(f"shape mismatch for {name}: {arr.shape} vs a scalar")
    if isinstance(like, bool):
        return bool(arr)
    if isinstance(like, int):
        return int(arr)
    # a host float: keep the template's value when it is the stored one
    # in float32 (the file holds float32, the port the config's double)
    return like if np.float32(like) == arr else float(arr)


def save(path: str, tree: Any) -> None:
    """Save a tree of tensors (NamedTuples, dicts, lists) to `path` (npz;
    the structure is the template's at restore time)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez_compressed(path, **{k: to_numpy(v) for k, v in flatten(tree)})


def restore(path: str, template: Any) -> Any:
    """Restore into the structure, dtypes and devices of `template`
    (shapes must match — fixed-capacity state makes this exact)."""
    data = np.load(path if path.endswith(".npz") else path + ".npz")
    leaves = []
    for key, leaf in flatten(template):
        if key not in data:
            raise KeyError(f"checkpoint missing leaf {key}")
        leaves.append(from_numpy(data[key], leaf, key))
    return unflatten(template, iter(leaves))


# --------------------------------------------------------------------------
# full online-session checkpoint / resume
# --------------------------------------------------------------------------


def save_session(session, path: str) -> None:
    """Serialize a live `runtime.online.OnlineSlam` session: the batched
    store, per-robot odometry state, factor graph, optimized poses, GEM
    grids and flushed submaps, loop records and the scheduler manifest.
    One npz with an embedded JSON manifest, the reference's format. Every
    tensor is copied to the host before this returns."""
    arrays: dict[str, np.ndarray] = {}

    def put(prefix: str, tree: Any) -> None:
        for i, (_, leaf) in enumerate(flatten(tree)):
            arrays[f"{prefix}.{i}"] = to_numpy(leaf)

    put("mstore", session.mstore)
    put("graph", session.graph)
    if session.opt_poses is not None:
        put("opt", session.opt_poses)
    robots_meta = {}
    for r, rs in session.robots.items():
        put(f"odo.{r}", rs["odo"])
        meta = {"frame": rs["frame"], "row": session.rows[r]}
        if "gem_local" in rs:
            put(f"gem.{r}", rs["gem_local"])
            if rs.get("gem_last_pose") is not None:
                put(f"gemlp.{r}", rs["gem_last_pose"])
                meta["has_gem_last"] = True
            fl = rs.get("gem_flushed", [])
            meta["gem_flushed_k"] = [int(k) for k, _ in fl]
            if fl:
                arrays[f"gemf.{r}.xyz"] = to_numpy(torch.stack([c.xyz for _, c in fl]))
                arrays[f"gemf.{r}.mask"] = to_numpy(torch.stack([c.mask for _, c in fl]))
        robots_meta[str(r)] = meta
    for name, recs in (("loops", session.loops), ("cands", session._inter_candidates)):
        if recs:
            arrays[f"{name}.R"] = to_numpy(torch.stack([l["rel"].R for l in recs]))
            arrays[f"{name}.t"] = to_numpy(torch.stack([l["rel"].t for l in recs]))
    manifest = {
        "config": session.cfg.to_json(),
        "enable_gem": session.enable_gem,
        "loop_every": session.loop_every,
        "robots": robots_meta,
        "node_of": [[r, k, v] for (r, k), v in session.node_of.items()],
        "pending": [[r, k] for r, k in session._pending_kf],
        "has_opt": session.opt_poses is not None,
        "loops": [{k: v for k, v in l.items() if k != "rel"} for l in session.loops],
        "inter_candidates": [
            {k: v for k, v in l.items() if k != "rel"} for l in session._inter_candidates
        ],
        "searched": [
            [ra, rb, sorted(map(list, pairs))] for (ra, rb), pairs in session._searched.items()
        ],
        "sched": {
            "loop": session._last_loop_stamp,
            "compose": session._last_compose_stamp,
            "tf": session._last_tf_stamp,
        },
    }
    arrays["manifest"] = np.frombuffer(json.dumps(manifest).encode(), dtype=np.uint8)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez_compressed(path, **arrays)


def load_session(path: str, device="cuda"):
    """Rebuild an `OnlineSlam` on `device` from a `save_session` file of
    either package. The config comes FROM the manifest; continuing the
    stream after `load_session` reproduces an uninterrupted run bit for
    bit. As in the reference, the graph size at the last solve is not
    stored: until the next solve, TF and the merged map read keyframe
    odometry, and `result()` re-solves."""
    from ..geometry.se3 import Pose
    from ..ops.pointcloud import PointCloud
    from .config import SlamConfig
    from .online import OnlineSlam

    data = np.load(path if path.endswith(".npz") else path + ".npz")
    manifest = json.loads(bytes(data["manifest"]).decode())
    cfg = SlamConfig.from_json(manifest["config"])
    sess = OnlineSlam(cfg, enable_gem=manifest["enable_gem"], device=device)
    sess.loop_every = manifest["loop_every"]
    dev = sess.device

    def get(prefix: str, template: Any) -> Any:
        leaves = [from_numpy(data[f"{prefix}.{i}"], leaf, f"{prefix}.{i}")
                  for i, (_, leaf) in enumerate(flatten(template))]
        return unflatten(template, iter(leaves))

    def tensor(arr):
        return torch.from_numpy(np.ascontiguousarray(arr)).to(dev)

    # register robots in row order so store rows line up
    metas = sorted(((int(r), m) for r, m in manifest["robots"].items()),
                   key=lambda rm: rm[1]["row"])
    for r, meta in metas:
        sess.register_robot(r)
        if sess.rows[r] != meta["row"]:
            raise ValueError(f"robot {r}: store row {sess.rows[r]} != saved row {meta['row']}")
    sess.mstore = get("mstore", sess.mstore)
    counts = sess.mstore.stores.count.tolist()
    sess.kf_counts = {r: int(counts[sess.rows[r]]) for r in sess.robots}
    sess.graph = get("graph", sess.graph)
    if manifest["has_opt"]:
        sess.opt_poses = get("opt", sess.graph.poses)
    for r, meta in metas:
        rs = sess.robots[r]
        rs["odo"] = get(f"odo.{r}", rs["odo"])
        rs["frame"] = meta["frame"]
        if sess.enable_gem and f"gem.{r}.0" in data:
            rs["gem_local"] = get(f"gem.{r}", rs["gem_local"])
            if meta.get("has_gem_last"):
                rs["gem_last_pose"] = get(f"gemlp.{r}", Pose(torch.eye(3, device=dev),
                                                             torch.zeros(3, device=dev)))
            ks = meta.get("gem_flushed_k", [])
            if ks:
                xs, ms = data[f"gemf.{r}.xyz"], data[f"gemf.{r}.mask"]
                rs["gem_flushed"] = [(k, PointCloud(tensor(xs[i]), tensor(ms[i])))
                                     for i, k in enumerate(ks)]
    sess.node_of = {(r, k): v for r, k, v in manifest["node_of"]}
    sess._pending_kf = [(r, k) for r, k in manifest["pending"]]

    def records(name: str, key: str):
        return [{**l, "rel": Pose(tensor(data[f"{name}.R"][i]), tensor(data[f"{name}.t"][i]))}
                for i, l in enumerate(manifest.get(key, []))]

    sess.loops = records("loops", "loops")
    sess._inter_candidates = records("cands", "inter_candidates")
    sess._searched = {
        (ra, rb): {tuple(p) for p in pairs} for ra, rb, pairs in manifest.get("searched", [])
    }
    sched = manifest.get("sched", {})
    sess._last_loop_stamp = sched.get("loop")
    sess._last_compose_stamp = sched.get("compose")
    sess._last_tf_stamp = sched.get("tf")
    return sess
