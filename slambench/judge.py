"""The comparison that decides `correct`: what the window's timed path
produced, held stage by stage against the plain reference
(`reference/stages.py`), each number against its limit
(`limits/<cell>.json`).

Numbers (the worst over what was checked):
  frontend_t_gap_m   front-end frames sampled from the seed: the pose's
                     position after the frame, program against a reference
                     step from the program's state before it
  frontend_R_gap     the same frames' rotation (Frobenius norm)
  frontend_map_gap   the same frames' voxel maps after the frame (largest
                     difference of any packed cell value)
  keyframe_gap_m     the keyframe store: every frame's gate decision
                     against the gate's rule on the returned poses, and
                     every stored keyframe cloud against the reference's
                     downsample of that frame's scan (a keyframe on one
                     side only, or other valid points, counts 1e6 m)
  loop_gap_m         loop-stage rounds of the window sampled from the seed,
                     retrieval and VGICP verification replayed: the
                     relative pose of each loop both sides found. Counts
                     1e6 m: a loop the program accepted at a fitness at
                     or above the gate (any loop it found, sampled round
                     or not); a loop accepted on one side only, unless
                     the reference scored it, and each side that scored
                     it did so, within rounding of the gate; a robot
                     pair whose PCM-kept loops are not a maximum clique
                     of the reference's consistency graph (bfloat16
                     inputs move no PCM clique, so PCM's check has no
                     number of its own that the control fails)
  solve_t_gap_m      the last chordal solve's poses, program against the
                     reference's solve of the same graph
  solve_R_gap        their rotations

With `control` the candidate is not the program but the reference with
every stage's inputs rounded through bfloat16, judged the same way."""
from __future__ import annotations

import time

import numpy as np
import torch

from .reference import stages

MISSING_M = 1e6  # a keyframe or a loop on one side only
# A loop both sides scored may fall on either side of the acceptance gate
# by rounding only where each side's fitness lies within this of the gate:
# five times the widest fitness gap of a loop both sides found over the
# sound runs of every cell (PERF.md, section 2)
FITNESS_ROUNDING = 4e-3


def keyframe_events(stream, rec) -> list:
    """(robot, kf index, frame) of every keyframe the program gated, in the
    order it gated them."""
    count: dict = {}
    out = []
    for r, i in stream.order[: rec.fed]:
        k = rec.kf_after[(r, i)]
        if k > count.get(r, 0):
            out.append((r, k - 1, i))
        count[r] = k
    return out


def _loop_key(l) -> tuple:
    return (l["robot_a"], l["kf_a"], l["robot_b"], l["kf_b"])


def _rounds(events: list, loop_every: int) -> list:
    """The loop-stage rounds: the pending keyframes of each, in order."""
    return [events[s:s + loop_every] for s in range(0, len(events) - loop_every + 1, loop_every)]


def judge(cfg, sensor: dict, mix: dict, stream, rec, seed: int, device, control: bool = False,
          log=print) -> dict:
    """The numbers above for this run (a missing one: nothing to
    compare). `control`: judge the bf16 reference instead of the program."""
    q_c = stages.bf16 if control else None
    t0 = time.perf_counter()
    out = rec.out
    nums: dict = {}

    # -- front-end -------------------------------------------------------------
    gaps = []
    for r, i, before, after in rec.samples:
        xyz, mask, times, imu = stream.frame(r, i)
        ref = stages.frontend_step(cfg, before, xyz, mask, times, imu)
        if control:
            cand = stages.frontend_step(cfg, before, xyz, mask, times, imu, q=q_c)
            after = _as_snapshot(cand)
        gaps.append(stages.frontend_gaps(ref, after))
    if gaps:
        g = np.asarray(gaps)
        nums["frontend_t_gap_m"], nums["frontend_R_gap"], nums["frontend_map_gap"] = \
            (float(x) for x in g.max(axis=0))
    t_front = time.perf_counter()

    # -- keyframe gate and store -----------------------------------------------------
    # one number for the store: a keyframe gated on one side only, or a
    # stored cloud whose points differ in which are valid, counts as
    # MISSING_M; a cloud otherwise by its largest coordinate gap
    fed = stream.order[: rec.fed]
    kf_gap = 0.0
    cap = max(cfg.keyframes.capacity, 1)
    for r in sorted({r for r, _ in fed}):
        frames = [i for rr, i in fed if rr == r]
        ts = np.stack([rec.poses[(r, i)][1].double().cpu().numpy() for i in frames])
        added, margin = stages.gate_decisions(ts, cfg.keyframes.dist_thresh, cap)
        if control:
            prog, _ = stages.gate_decisions(ts, cfg.keyframes.dist_thresh, cap, q=stages.bf16)
        else:
            ks = [0] + [rec.kf_after[(r, i)] for i in frames]
            prog = np.diff(ks) > 0
        if np.any((added != prog) & (margin > stages.GATE_ROUNDING_M)):
            kf_gap = MISSING_M
    events = keyframe_events(stream, rec)
    P = cfg.keyframes.points_per_kf
    clouds: dict = {}
    for r, k, i in events:
        xyz, mask, _, _ = stream.frame(r, i)
        clouds[(r, k)] = stages.keyframe_cloud(cfg, xyz, mask, P)
        if control:
            c_xyz, c_mask = stages.keyframe_cloud(cfg, xyz, mask, P, q=q_c)
        else:
            c_xyz, c_mask = out["stores"][r]["xyz"][k], out["stores"][r]["mask"][k]
        if not torch.equal(clouds[(r, k)][1], c_mask):
            kf_gap = MISSING_M
        else:
            kf_gap = max(kf_gap, float(torch.max(torch.abs(clouds[(r, k)][0] - c_xyz))))
    nums["keyframe_gap_m"] = kf_gap
    t_gate = time.perf_counter()

    # -- loop stage rounds ---------------------------------------------------------
    kf_pose = {(r, k): rec.poses[(r, i)] for r, k, i in events}
    found = out["found"]
    loop_every = out["loop_every"]
    rounds = _rounds([(r, k) for r, k, _ in events], loop_every)
    frame_of = {(r, k): i for r, k, i in events}
    window = set(rec.window)
    in_window = [m for m, rd in enumerate(rounds) if (rd[-1][0], frame_of[rd[-1]]) in window]
    rng = np.random.default_rng([int(seed) % (1 << 63), 11])
    n = min(mix["sample_rounds"], len(in_window))
    picked = sorted(rng.choice(in_window, size=n, replace=False).tolist()) if n else []
    round_of = {}
    for m, rd in enumerate(rounds):
        for e in rd:
            round_of[e] = m
    cap_kf = cfg.keyframes.capacity
    thresh = cfg.loops.fitness_thresh
    loop_gap, fit_gap, borderline = 0.0, 0.0, 0
    # the gate on the program's own scores, over every loop it found
    over_gate = 0 if control else sum(1 for l in found if not l["fitness"] < thresh)
    if over_gate:
        loop_gap = MISSING_M
    for m in picked:
        upto = [(r, k) for rd in rounds[: m + 1] for r, k in rd]
        counts = {r: sum(1 for rr, _ in upto if rr == r) for r in out["robots"]}
        searched: dict = {}
        for l in found:  # the pairs the session excluded when round m began
            if round_of.get((l["robot_a"], l["kf_a"]), 1 << 30) < m:
                searched.setdefault((l["robot_a"], l["robot_b"]), set()).add((l["kf_a"], l["kf_b"]))
                searched.setdefault((l["robot_b"], l["robot_a"]), set()).add((l["kf_b"], l["kf_a"]))

        def replay(q, scores):
            st, ds = {}, {}
            for r in out["robots"]:
                cl = [clouds[(r, k)] if q is stages.exact else
                      stages.keyframe_cloud(cfg, *stream.frame(r, frame_of[(r, k)])[:2], P, q=q)
                      for k in range(counts[r])]
                st[r] = stages.reference_store(cl, [kf_pose[(r, k)] for k in range(counts[r])],
                                               counts[r], cap_kf, P, device, q=q)
                ds[r] = stages.describe(cfg, st[r])
            return stages.replay_round(cfg, st, ds, out["robots"], rounds[m],
                                       {k: set(v) for k, v in searched.items()}, loop_every,
                                       scores=scores)

        ref_scores: dict = {}  # the reference's fitness of every candidate it verified
        ref = {_loop_key(l): l for l in replay(stages.exact, ref_scores)}
        cand_scores: dict = {}  # the same of the candidate, where it reports them
        if control:
            cand = {_loop_key(l): l for l in replay(q_c, cand_scores)}
        else:
            pend = set(rounds[m])
            cand = {_loop_key(l): l for l in found if (l["robot_a"], l["kf_a"]) in pend}
        cand_scores.update({k: l["fitness"] for k, l in cand.items()})
        for key in set(ref) ^ set(cand):
            # accepted on one side only: rounding only where the reference
            # scored the loop, and each side's score lies within rounding
            # of the gate; else a fault (a broken gate, another candidate)
            near = [f for f in (ref_scores.get(key), cand_scores.get(key)) if f is not None]
            if key in ref_scores and all(abs(f - thresh) <= FITNESS_ROUNDING for f in near):
                borderline += 1
            else:
                loop_gap = MISSING_M
        for key in set(ref) & set(cand):
            loop_gap = max(loop_gap, float(torch.linalg.norm(ref[key]["rel"][1].double()
                                                             - cand[key]["rel"][1].double())))
            fit_gap = max(fit_gap, abs(ref[key]["fitness"] - cand[key]["fitness"]))
    t_loops = time.perf_counter()

    # -- PCM ---------------------------------------------------------------------
    inter = [l for l in found if l["robot_a"] != l["robot_b"]]
    pcm_bad = 0
    if inter:
        kept = set(out["kept"])
        if control:  # the bf16 reference's own choice: a maximum clique of its graph
            kept = set()
            loops = [dict(l, rel=stages.Pose(stages.bf16(l["rel"][0]), stages.bf16(l["rel"][1])))
                     for l in inter]
            for group, adj in stages.helpers.pcm_groups(
                    loops, lambda r, k: stages.Pose(*(stages.bf16(x) for x in kf_pose[(r, k)])),
                    cfg):
                keys = [_loop_key(l) for l in group]
                idx = range(len(keys)) if adj is None else stages.pcm.max_clique_plain(adj)
                kept |= {keys[j] for j in idx}
        pcm_bad = stages.pcm_faults(cfg, inter, kept, lambda r, k: kf_pose[(r, k)])
        if pcm_bad:
            loop_gap = MISSING_M
    if picked or inter or over_gate:
        nums["loop_gap_m"] = loop_gap
    t_pcm = time.perf_counter()

    # -- chordal solve -------------------------------------------------------------
    if out["opt"] is not None:
        n = out["opt_n_nodes"]
        ev = [(r, k) for r, k, _ in events]
        if any(out["node_of"].get(e) != j for j, e in enumerate(ev[:n])):
            nums["solve_t_gap_m"] = nums["solve_R_gap"] = float("inf")
        else:
            by_key = {_loop_key(l): l for l in found}
            loops = [by_key[k] for k in out["kept"]]
            ref = stages.solve(cfg, ev, kf_pose, loops, n, device)
            if control:
                c = stages.solve(cfg, ev, kf_pose, loops, n, device, q=q_c)
                cR, ct = c.R[:n], c.t[:n]
            else:
                cR, ct = out["opt"]
            nums["solve_t_gap_m"] = float(torch.max(torch.linalg.norm(
                ref.t[:n].double() - ct.double(), dim=-1)))
            nums["solve_R_gap"] = float(torch.max(torch.linalg.norm(
                (ref.R[:n].double() - cR.double()).reshape(n, 9), dim=-1)))
    t_end = time.perf_counter()
    log(f"[judge] {len(rec.samples)} front-end frames {t_front - t0:.1f} s, gate and "
        f"{len(events)} keyframe clouds {t_gate - t_front:.1f} s, {len(picked)} of "
        f"{len(in_window)} window rounds {t_loops - t_gate:.1f} s (fitness gap {fit_gap:.3g}, "
        f"{borderline} at the gate, {over_gate} accepted over it), PCM over {len(inter)} "
        f"({pcm_bad} pairs at fault) {t_pcm - t_loops:.1f} s, solve {t_end - t_pcm:.1f} s")
    return nums


def _as_snapshot(state) -> dict:
    """A slamref state in `drive.snapshot`'s form."""
    def conv(x):
        if isinstance(x, tuple) and hasattr(x, "_fields"):
            return {"_type": type(x).__name__, **{f: conv(getattr(x, f)) for f in x._fields}}
        return x
    return conv(state)


def verdict(nums: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {name: {"value", "limit"}}): every limited number present
    and at most its limit."""
    checks, ok = {}, True
    for name, lim in limits.items():
        v = nums.get(name)
        checks[name] = {"value": v, "limit": lim}
        if v is None or not np.isfinite(v) or v > lim:
            ok = False
    return ok, checks
