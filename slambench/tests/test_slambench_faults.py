"""A run whose timed path is broken underneath comes out as not correct:
a step that leaves its state unchanged (the map insert skipped), half
of a batch left out (every other point of each scan the front-end
registers and inserts), and an answer
altered where it is produced (a loop's relative pose, by 0.5 m; loops
accepted with the fitness gate off, their scores reported as they are
or under the gate). One chip: no exchange between chips to leave out."""
from dataclasses import replace

import pytest
import torch

from helpers import run

CELL = "os64-scan2map-drive"


def test_map_insert_skipped(monkeypatch):
    from mr_slam_torch.frontend import odometry

    monkeypatch.setattr(odometry, "insert_fine", lambda grid, scan, pose, config: grid)
    res = run(CELL)
    assert res["correct"] is False
    assert res["checks"]["frontend_map_gap"]["value"] > res["checks"]["frontend_map_gap"]["limit"]


def test_half_of_each_scan(monkeypatch):
    from mr_slam_torch.ops.pointcloud import PointCloud
    from mr_slam_torch.runtime import online

    step = online.OnlineSlam._frontend_graphs

    def half(self, robot, rs, scan, *a):
        keep = torch.zeros_like(scan.mask)
        keep[::2] = True  # every other point: half of the valid ones wherever they sit
        return step(self, robot, rs, PointCloud(scan.xyz, scan.mask & keep), *a)

    monkeypatch.setattr(online.OnlineSlam, "_frontend_graphs", half)
    res = run(CELL)
    assert res["correct"] is False
    c = res["checks"]
    assert c["frontend_t_gap_m"]["value"] > c["frontend_t_gap_m"]["limit"]


def test_loop_answer_altered(monkeypatch):
    from mr_slam_torch.geometry.se3 import Pose
    from mr_slam_torch.runtime import loopstage

    score = loopstage._score

    def moved(*a, **kw):
        rel, fit = score(*a, **kw)
        return Pose(rel.R, rel.t + torch.tensor([0.5, 0.0, 0.0], device=rel.t.device)), fit

    monkeypatch.setattr(loopstage, "_score", moved)
    res = run(CELL)
    assert res["correct"] is False
    assert res["checks"]["loop_gap_m"]["value"] > res["checks"]["loop_gap_m"]["limit"]


@pytest.mark.parametrize("reported", ["as_scored", "under_the_gate"])
def test_fitness_gate_off(monkeypatch, reported):
    from mr_slam_torch.runtime import loopstage

    search = loopstage.search_pair_loops

    def no_gate(store_a, descs_a, store_b, descs_b, cfg, *a, **kw):
        gate = cfg.loops.fitness_thresh
        loops = search(store_a, descs_a, store_b, descs_b,
                       replace(cfg, loops=replace(cfg.loops, fitness_thresh=float("inf"))), *a, **kw)
        if reported == "under_the_gate":  # the scores hidden: only the reference's re-score sees it
            for l in loops:
                l["fitness"] = min(l["fitness"], 0.5 * gate)
        return loops

    monkeypatch.setattr(loopstage, "search_pair_loops", no_gate)
    res = run(CELL)
    assert res["correct"] is False
    assert res["checks"]["loop_gap_m"]["value"] > res["checks"]["loop_gap_m"]["limit"]
