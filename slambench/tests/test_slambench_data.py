"""A cell, a traffic mix and a per-layer metric are added as new files
and new `BENCHMARK.json` entries, with no edit to a file that exists."""
import json
import shutil

from helpers import ROOT, run


def test_a_throwaway_mix_and_metric_run_from_files_alone(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "slambench", tmp_path / "slambench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    data = tmp_path / "slambench"
    mix = json.loads((data / "traffic" / "walk-convoy.json").read_text())
    mix.update(why="a throwaway mix", road=dict(mix["road"], pace_m=0.2, gap_m=6.0))
    (data / "traffic" / "tiny-throwaway.json").write_text(json.dumps(mix))
    (data / "limits" / "os64-scan2map-throwaway.json").write_text(
        (data / "limits" / "os64-scan2map-walk.json").read_text())
    (data / "metrics" / "frames_in_window.py").write_text(
        'UNIT = "count"\nLAYER = "session"\nMOVES = "fleet_frames_per_s"\n'
        'SOURCE = "host_clock"\n\n\ndef read(ctx):\n    return float(len(ctx.calls_s))\n')
    spec = json.loads((tmp_path / "BENCHMARK.json").read_text())
    spec["workloads"].append({"name": "os64-scan2map-throwaway", "config": "os64-scan2map",
                              "traffic": "tiny-throwaway", "chips": 1, "why": "a test"})
    spec["per_layer"].append({"name": "frames_in_window", "unit": "count", "better": "higher",
                              "source": "host_clock", "layer": "session",
                              "moves": "fleet_frames_per_s",
                              "workloads": ["os64-scan2map-throwaway"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    res = run("os64-scan2map-throwaway", root=tmp_path, trace=True)
    assert res["metrics"]["frames_in_window"]["value"] == res["attempted"] > 0
    assert res["correct"] is True
