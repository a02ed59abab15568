"""Run one cell of the port's benchmark once:

    python3 slambench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. Prints the result as one JSON object, the
last line of standard output, and each number compared with its limit
as the last lines of standard error. Exits non-zero, with no result,
without the CUDA cards the cell asks for.

`--control 1` judges the reference computed from bfloat16 inputs in the
program's place instead of the program (the check's control, which
has to come out as not correct)."""
from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CACHE = ROOT / "build" / "slambench-cache"  # fixed, inside the checkout


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="one run of one cell of the port's benchmark")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(CACHE / sub)
    sys.path.insert(0, str(ROOT))
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    chips = {w["name"]: w["chips"] for w in spec["workloads"]}.get(a.workload, 1)

    import torch

    def log(*args):
        print(*args, file=sys.stderr, flush=True)

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        log(f"the cell {a.workload} needs {chips} CUDA card(s); this machine has {n}")
        return 2
    from slambench import harness

    result = harness.run_cell(ROOT, a.workload, a.seed, a.seconds, bool(a.trace), "cuda",
                              control=bool(a.control), log=log)
    harness.report_checks(result["checks"], log)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
