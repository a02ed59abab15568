"""One run of one cell: load the cell's configuration, traffic mix, limits
and metric readers by the names `BENCHMARK.json` gives, make the stream
from the seed, warm the session up with the mix's prefix, measure the
window, judge what it produced against the reference, and build the
result line."""
from __future__ import annotations

import gc
import importlib.util
import json
import os
import statistics
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

FORBIDDEN = ("jax", "jaxlib", "flax", "mr_slam_tpu")


def process_start() -> float:
    """The process's start on `time.time()`'s clock (Linux: from
    /proc/self/stat and the boot time), or now where that cannot be read."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/stat") as f:
            boot = next(int(line.split()[1]) for line in f if line.startswith("btime"))
        return boot + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, StopIteration):
        return time.time()


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


@dataclass
class Cell:
    name: str
    spec: dict        # BENCHMARK.json
    config: dict      # configs/<config>.json
    mix: dict         # traffic/<traffic>.json
    limits: dict      # limits/<cell>.json: {number: limit}
    end_to_end: list  # the cell's end-to-end metric entries
    per_layer: list   # the cell's per-layer metric entries


def _for_cell(entries: list, cell: str) -> list:
    return [m for m in entries if "workloads" not in m or cell in m["workloads"]]


def load_cell(root: Path, workload: str) -> Cell:
    """The cell `workload` of `root`/BENCHMARK.json and its files."""
    spec = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload}; BENCHMARK.json has {sorted(cells)}")
    w = cells[workload]
    conf = {c["name"]: c for c in spec["configs"]}[w["config"]]
    return Cell(
        name=workload, spec=spec,
        config=json.loads((root / conf["file"]).read_text()),
        mix=json.loads((root / "slambench" / "traffic" / f"{w['traffic']}.json").read_text()),
        limits=json.loads((root / "slambench" / "limits" / f"{workload}.json").read_text())["limits"],
        end_to_end=_for_cell(spec["end_to_end"], workload),
        per_layer=_for_cell(spec["per_layer"], workload),
    )


def _merge(into: dict, new: dict) -> None:
    for k, v in new.items():
        if isinstance(v, dict) and isinstance(into.get(k), dict):
            _merge(into[k], v)
        else:
            into[k] = v


def load_metric(root: Path, name: str):
    """The reader module of a per-layer metric (`metrics/<name>.py`)."""
    path = root / "slambench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"slambench_metric_{name.replace('.', '_')}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclass
class Context:
    """What a per-layer reader reads: the window's span and counter
    deltas, the captures, the profiled slice, the cell's configuration
    and the roofline functions."""
    spans: dict                   # name -> (count, total s) in the window
    counters: dict
    captures: int
    profile: dict | None
    cfg: object
    roofline: object
    calls_s: list = field(default_factory=list)   # host seconds of each window call

    def span_mean_ms(self, name: str):
        n, total = self.spans.get(name, (0, 0.0))
        return 1e3 * total / n if n else None

    def kernel(self, needle: str) -> tuple[int, float]:
        """(launches, device seconds) of the profiled device ops whose name
        holds `needle`."""
        if not self.profile:
            return 0, 0.0
        hits = [v for k, v in self.profile["ops"].items() if needle in k]
        return sum(v[0] for v in hits), sum(v[1] for v in hits)


def span_totals(tracer) -> dict:
    return {k: (v.count, v.total_s) for k, v in tracer.stats.items()}


def _delta(after: dict, before: dict) -> dict:
    out = {}
    for k, (n, t) in after.items():
        n0, t0 = before.get(k, (0, 0.0))
        if n > n0:
            out[k] = (n - n0, t - t0)
    return out


class CaptureCount:
    """Counts `torch.cuda.CUDAGraph.capture_begin` calls of the process."""

    def __init__(self):
        import torch

        self.n = 0
        begin = torch.cuda.CUDAGraph.capture_begin

        def counted(graph, *a, **kw):
            self.n += 1
            return begin(graph, *a, **kw)

        torch.cuda.CUDAGraph.capture_begin = counted


def run_cell(root: Path, workload: str, seed: int, seconds: float, trace: bool, device: str,
             control: bool = False, shrink: dict | None = None, log=None) -> dict:
    """Run the cell once and return the result object (the contract's
    keys, `checks` last). `control`: judge the bf16 reference in the
    program's place. `shrink`: values that replace the configuration's
    (`sensor`, `slam`, nested) and the mix's (`mix`): the CPU tests'
    tiny sizes."""
    t_proc = process_start()
    log = log or (lambda *a: print(*a, file=sys.stderr, flush=True))
    cell = load_cell(root, workload)
    if shrink:
        _merge(cell.config, {k: v for k, v in shrink.items() if k != "mix"})
        _merge(cell.mix, shrink.get("mix", {}))
    setup = {}
    t = time.time()
    import torch

    from mr_slam_torch.runtime import observability as obs
    from mr_slam_torch.runtime import online
    from mr_slam_torch.runtime.config import SlamConfig

    from . import drive, judge, roofline, traffic, trace as tr
    from .reference.slamref.runtime.config import SlamConfig as RefConfig

    setup["import_s"] = time.time() - t
    dev = torch.device(device)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    t = time.time()
    if dev.type == "cuda":
        torch.cuda.init()
        torch.empty(1, device=dev)
    setup["card_s"] = time.time() - t
    captures = CaptureCount()
    cfg_json = json.dumps(cell.config["slam"])
    cfg = SlamConfig.from_json(cfg_json)
    ref_cfg = RefConfig.from_json(cfg_json)
    sensor = cell.config["sensor"]

    t = time.time()
    stream = traffic.generate(cell.mix, sensor, seed, dev)
    sync()
    setup["stream_s"] = time.time() - t

    if trace:
        tr.mirror_spans(obs.tracer)
    t = time.time()
    if dev.type == "cuda":  # the VGICP kernel, built at a checkout's first run
        from mr_slam_torch.ops import cuda_build

        cuda_build.load("vgicp_accum")
    setup["kernels_s"] = time.time() - t
    t = time.time()
    sess = online.OnlineSlam(cfg, enable_gem=False, device=dev)
    drv = drive.Driver(sess, stream, seed, sync)
    drv.prefix()
    setup["prefix_s"] = time.time() - t
    setup["prefix_captures"] = captures.n
    setup_s = time.time() - t_proc

    spans0, counters0, cap0 = span_totals(obs.tracer), dict(obs.metrics.counters), captures.n
    slice_ = None
    if trace:
        # the profiled slice: from `start_s` into the window until the
        # first frame after `min_s` by which `count` more `span`s have
        # ended, or after `max_s` (the mix's `trace_slice` or these)
        sl = dict(start_s=1.0, min_s=2.0, max_s=10.0, span="loop.verify", count=1)
        sl.update(cell.mix.get("trace_slice", {}))

        def ended(at_start):  # the spans ended so far, or whether `count` more have
            st = obs.tracer.stats.get(sl["span"])
            n = st.count if st is not None else 0
            return n if at_start is None else n - at_start >= sl["count"]

        slice_ = tr.Slice(start_s=sl["start_s"], min_s=sl["min_s"], max_s=sl["max_s"], device=dev,
                          ready=ended)
    drv.window(seconds, on_frame=None if slice_ is None else slice_.on_frame)
    profile = None
    if slice_ is not None:
        slice_.stop()
        if slice_.prof is not None:
            t = time.time()
            profile = tr.reduce(slice_.prof, slice_.wall_s)
            log(f"[trace] slice {slice_.wall_s:.2f} s reduced in {time.time() - t:.1f} s")
            log("[trace] " + json.dumps(dict(
                busy_s=profile["busy_s"], window_s=profile["window_s"],
                ops=sorted(profile["ops"].items(), key=lambda kv: -kv[1][1])[:25])))
    spans = _delta(span_totals(obs.tracer), spans0)
    counters = {k: v - counters0.get(k, 0.0) for k, v in obs.metrics.counters.items()
                if v != counters0.get(k, 0.0)}
    cap_window = captures.n - cap0
    mem_peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    rec = drv.rec

    # the window is closed: copy out what is judged, drop the program's state
    drv.collect()
    from mr_slam_torch.runtime import solve_graph, verify_graph

    drv.sess = sess = None
    verify_graph.clear()
    solve_graph.clear()
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    calls = np.asarray(rec.call_s)
    e2e = {
        "fleet_frames_per_s": len(calls) / rec.window_s,
        "frame_p95_ms": 1e3 * float(np.percentile(calls, 95)) if len(calls) else float("nan"),
        "setup_s": setup_s,
    }
    log("[window] " + json.dumps(dict(e2e, setup=setup, frames=len(calls),
                                      memory_peak_bytes=int(mem_peak))))

    t = time.time()
    nums = judge.judge(ref_cfg, sensor, cell.mix, stream, rec, seed, dev, control=control, log=log)
    judge_s = time.time() - t
    correct, checks = judge.verdict(nums, cell.limits)
    units = {m["name"]: m["unit"] for m in cell.spec["end_to_end"] + cell.spec["per_layer"]}
    metrics = {}
    breakdown = None
    if not trace:
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}
    else:
        ctx = Context(spans=spans, counters=counters, captures=cap_window, profile=profile,
                      cfg=ref_cfg, roofline=roofline, calls_s=list(rec.call_s))
        for m in cell.per_layer:
            v = load_metric(root, m["name"]).read(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": units[m["name"]]}
        if profile is not None:
            breakdown = {"device_ops": profile["device_ops"], "idle_gaps": profile["idle_gaps"]}
    device_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
                   "count": 1, "memory_peak_bytes": int(mem_peak)}
    if trace:
        device_info["busy_s"] = profile["busy_s"] if profile else 0.0
        device_info["window_s"] = profile["window_s"] if profile else 0.0

    summary = dict(
        cell=workload, seed=seed, frames=len(calls), window_s=rec.window_s,
        frame_median_ms=1e3 * statistics.median(calls) if len(calls) else None,
        setup=setup, judge_s=judge_s, captures_window=cap_window,
        kinds={k: rec.kinds.count(k) / max(len(rec.kinds), 1)
               for k in ("solve", "loop", "compose", "tf", "plain")},
        spans={k: [n, s] for k, (n, s) in sorted(spans.items())},
        counters=counters, e2e=e2e, control=control)
    log("[summary] " + json.dumps(summary))
    found = forbidden_modules()
    if found:
        raise SystemExit(f"modules of JAX or the JAX package are loaded: {found}")
    result = {"correct": bool(correct), "attempted": len(calls), "failed": 0,
              "metrics": metrics, "device": device_info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = checks
    return result


def report_checks(checks: dict, log) -> None:
    """The numbers compared, each beside its limit, one to a line."""
    for name, c in checks.items():
        log(f"check {name} = {c['value']!r} limit {c['limit']!r}")
