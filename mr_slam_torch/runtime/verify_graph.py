"""Loop verification replayed as CUDA graphs: the port's counterpart of
the reference's compiled `loopstage.verify_chunk`
(`mr_slam_tpu/runtime/loopstage.py:141-245`, one jitted program that
every chunk of CHUNK candidates reuses).

A runner holds static buffers for one key (device, batch B, same robot
or not, seeds S, `LoopCfg`, the store and sinogram shapes): both
stores' keyframe clouds, masks, poses and counts, the RING sinograms
when the candidates register from both SE(2) seeds, and the chunk's
indices and yaw guesses. A chunk is three segments of
`frame_graph.Segments` on those buffers:

  coarse   both sides' `_prep_side`, the three grid builds, the seeds
           and the S-fold, the coarse GN rounds (`_vgicp_direct1_raw`)
           [frame_graph.project, eager: so3.project's SVD syncs the host]
  fine     the fine GN rounds
           [frame_graph.project, eager]
  score    the subsampled fitness, the best seed, se3.inverse

A runner's first chunk runs the segments eagerly on its buffers: that
run makes the device constants, the cuFFT plans and the workspaces that
a capture cannot make. From its second chunk on, each segment is
captured once and replayed, the VGICP kernel's 15 launches a stage
inside. Replays launch the eager kernels on the same inputs, so a chunk
equals `loopstage._verify_chunk_eager` bit for bit, and every caller
(`pipeline.run_backend`, `OnlineSlam.run_loop_stage`, the pair-sharded
backend) reads the eager card path's loops. A failed capture raises:
there is no eager fallback on the card. On the CPU the segments run
eagerly, in the same order, on the same buffers.

`verifier` copies a pair's stores into the runner of its key (`copy_`,
once per `search_pair_loops` call) and keeps at most MAX_RUNNERS
runners (`frame_graph.RunnerCache`), dropping the least recently
used: `OnlineSlam`'s stores grow by doubling, and each capacity is a
key.
"""
from __future__ import annotations

import torch

from ..frontend import keyframes as kf
from ..geometry.se3 import Pose
from ..ops import registration
from . import frame_graph, loopstage
from .config import SlamConfig

MAX_RUNNERS = 4

_runners = frame_graph.RunnerCache(MAX_RUNNERS)


def _store_bufs(store: kf.KeyframeStore, side: str) -> dict:
    return {f"{side}_xyz": torch.empty(store.xyz.shape, device=store.xyz.device),
            f"{side}_mask": torch.empty(store.mask.shape, dtype=torch.bool, device=store.xyz.device),
            f"{side}_R": torch.empty(store.poses.R.shape, device=store.xyz.device),
            f"{side}_t": torch.empty(store.poses.t.shape, device=store.xyz.device),
            f"{side}_count": torch.empty((), dtype=store.count.dtype, device=store.xyz.device)}


def _store(b: dict, side: str) -> kf.KeyframeStore:
    """The buffers' store: what `_prep_side` reads (no stamps, no gate anchor)."""
    return kf.KeyframeStore(xyz=b[f"{side}_xyz"], mask=b[f"{side}_mask"],
                            poses=Pose(b[f"{side}_R"], b[f"{side}_t"]), stamps=None,
                            count=b[f"{side}_count"], last_pose=None)


class Runner:
    """The segments and static buffers of one key; `runner(ia, ib, yaw)`
    verifies a chunk of the stores last `load`ed."""

    def __init__(self, store_a, store_b, sinos, cfg: SlamConfig, same_robot: bool, batch: int):
        dev = store_a.xyz.device
        self.cfg, self.same_robot, self.batch = cfg, same_robot, batch
        self.segs = frame_graph.Segments(dev, "verify")
        self.chunks = 0
        self.b = dict(ia=torch.zeros((batch,), dtype=torch.int64, device=dev),
                      ib=torch.zeros((batch,), dtype=torch.int64, device=dev),
                      yaw=torch.zeros((batch,), device=dev),
                      coarse_R=torch.empty((batch * (1 if sinos is None else 2), 3, 3), device=dev),
                      **_store_bufs(store_a, "a"), **_store_bufs(store_b, "b"))
        self.b["fine_R"] = torch.empty_like(self.b["coarse_R"])
        if sinos is not None:
            self.b["a_sino"] = torch.empty(sinos[0].shape, dtype=sinos[0].dtype, device=dev)
            self.b["b_sino"] = torch.empty(sinos[1].shape, dtype=sinos[1].dtype, device=dev)

    def load(self, store_a, store_b, sinos) -> None:
        """Copy a pair's stores (and seed sinograms) into the buffers."""
        b = self.b
        with self.segs.on_stream():
            for side, store in (("a", store_a), ("b", store_b)):
                b[f"{side}_xyz"].copy_(store.xyz)
                b[f"{side}_mask"].copy_(store.mask)
                b[f"{side}_R"].copy_(store.poses.R)
                b[f"{side}_t"].copy_(store.poses.t)
                b[f"{side}_count"].copy_(store.count)
            if sinos is not None:
                b["a_sino"].copy_(sinos[0])
                b["b_sino"].copy_(sinos[1])

    def _coarse(self, b: dict) -> dict:
        sinos = (b["a_sino"], b["b_sino"]) if "a_sino" in b else None
        src, coarse_g, fine_g, fit_g, seed = loopstage._chunk_inputs(
            _store(b, "a"), _store(b, "b"), b["ia"], b["ib"], b["yaw"], self.cfg,
            self.same_robot, sinos)
        res = registration._vgicp_direct1_raw(src, coarse_g, seed, **loopstage.COARSE)
        return dict(src=src, fine_g=fine_g, fit_g=fit_g, coarse=res.pose)

    def _fine(self, b: dict) -> dict:
        res = registration._vgicp_direct1_raw(b["src"], b["fine_g"],
                                              Pose(b["coarse_R"], b["coarse"].t),
                                              **loopstage.FINE)
        return dict(fine=res.pose)

    def _score(self, b: dict) -> dict:
        rel, fit = loopstage._score(b["src"], b["fit_g"], Pose(b["fine_R"], b["fine"].t),
                                    self.batch, self.cfg)
        return dict(rel=rel, fit=fit)

    def __call__(self, ia: torch.Tensor, ib: torch.Tensor, yaw: torch.Tensor):
        """(rel Pose (B,), fitness (B,)) of the chunk, tensors of their own."""
        if ia.shape != (self.batch,):
            raise ValueError(f"the runner verifies chunks of {self.batch}, not {tuple(ia.shape)}")
        b = self.b
        run = self.segs.eager if self.chunks == 0 else self.segs.run
        with self.segs.on_stream():
            b["ia"].copy_(ia)
            b["ib"].copy_(ib)
            b["yaw"].copy_(yaw)
            b.update(run("coarse", self._coarse, b))
            b["coarse_R"].copy_(frame_graph.project(b["coarse"].R, "verify.project"))
            b.update(run("fine", self._fine, b))
            b["fine_R"].copy_(frame_graph.project(b["fine"].R, "verify.project"))
            b.update(run("score", self._score, b))
        self.chunks += 1
        # the graphs rewrite their outputs at the next replay
        return Pose(b["rel"].R.clone(), b["rel"].t.clone()), b["fit"].clone()

    def stats(self) -> dict:
        s = self.segs
        return dict(chunks=self.chunks, captures=s.captures, replays=s.replays,
                    capture_s=s.capture_s, pool_bytes=s.pool_bytes())

    def close(self) -> None:
        """Release the graphs once their last replay has run."""
        self.segs.close(self.chunks)


def verifier(store_a: kf.KeyframeStore, store_b: kf.KeyframeStore, cfg: SlamConfig,
             same_robot: bool, descs_a: dict | None = None, descs_b: dict | None = None,
             batch: int = loopstage.CHUNK) -> Runner:
    """The runner of the pair's key with the pair's stores copied in: a
    function (ia, ib, yaw) (batch,) -> (rel, fitness), as
    `loopstage.verify_chunk` on these stores."""
    sinos = loopstage._seed_sinograms(cfg, same_robot, descs_a, descs_b)
    key = (store_a.xyz.device, batch, same_robot, cfg.loops, tuple(store_a.xyz.shape),
           tuple(store_b.xyz.shape), store_a.count.dtype,
           None if sinos is None else (tuple(sinos[0].shape), tuple(sinos[1].shape),
                                       sinos[0].dtype))
    runner = _runners.get(key, lambda: Runner(store_a, store_b, sinos, cfg, same_robot, batch))
    runner.load(store_a, store_b, sinos)
    return runner


def stats() -> list[dict]:
    """Each kept runner's chunks, captures, replays, capture seconds and
    graph-pool bytes, with its key's same_robot, seeds a candidate and
    store shapes."""
    return _runners.stats(lambda k: dict(same_robot=k[2], seeds=1 if k[7] is None else 2,
                                         store_a=k[4], store_b=k[5]))


def clear() -> None:
    """Drop every runner (their graphs and buffers)."""
    _runners.clear()
