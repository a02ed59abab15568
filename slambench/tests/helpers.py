"""Tiny sizes of the cells for the CPU tests, and a run of one."""
from __future__ import annotations

import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# 16 x 256 rays, short streams, a cheap solve: minutes on a CPU. The
# walking convoys go at 0.3 m a frame, so robots meet within the prefix.
TINY = {
    "sensor": {"rings": 16, "azimuth": 256},
    "slam": {"pgo": {"rot_cg_iters": 10, "gn_iters": 3, "pose_cg_iters": 10}},
    "mix": {"frames_per_robot": 60, "prefix_frames_per_robot": 24, "sample_every_frames": 2,
            "sample_rounds": 2},
}
WALK_PACE_M = 0.3
SECONDS = 12.0
CELLS = ("os64-scan2map-walk", "hdl32-lio-walk", "os64-scan2map-drive")


def run(cell: str, seed: int = 2**31 + 12345, trace: bool = False, control: bool = False,
        root: Path = ROOT, seconds: float = SECONDS) -> dict:
    import torch

    from slambench import harness

    torch.set_num_threads(2)
    shrink = json.loads(json.dumps(TINY))
    if "walk" in cell:
        shrink["mix"]["road"] = {"pace_m": WALK_PACE_M}
    return harness.run_cell(root, cell, seed, seconds, trace, "cpu", control=control,
                            shrink=shrink, log=lambda *a: None)


def benchmark() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())
