"""Named spans and counters of the port's host-side work.

The reference scatters `TicToc` stopwatches and ROS_DEBUG prints across
stages (SURVEY.md §5.1: `tic_toc.h`, per-stage chrono spans) with no
registry. Here one `Tracer` times named spans on the host clock and one
`Metrics` holds named counters; both are process-wide (`tracer`,
`metrics`).

A span's key is its name when the name holds a `.`
(`online.frontend.project`), else the name under the key of the span
it opens in (`robot0`, then `frontend` inside it: `robot0.frontend`).
Each span adds its time to its parent's `child_s`, so `SpanStats.self_s`
is the time a span spent outside its children: a layer's own time.

Spans read the host clock: a span that times device work ends in a host
wait. The benchmark's traced run also makes each span a `torch.profiler`
range of the same name (`slambench/trace.py`), so the card's idle gaps
fall to the innermost span the host was in, on the profiler's clock;
that is why a sub-span takes a dotted name, which is then both its key
and its range's name.

Counters the online session keeps (`runtime/online.py` and its runners):

  sync.<site>            host waits on the card at each site (a `.item()`,
                         `.cpu()`, a pageable host-to-device copy, an SVD,
                         `torch.cuda.synchronize`), counted on every device
  graph.<kind>.captures  CUDA graphs captured by the runners of a kind
                         (`frontend`, `verify`, `solve`, `register`)
  graph.<kind>.capture_s host seconds of those captures
  graph.<kind>.eager_s   host seconds of the kind's eager first calls
  loops.corrected        loops kept by a solve, each counted once
  loops.correction_s     their seconds from the later of their two
                         keyframes to the end of the solve that kept them
"""
from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from dataclasses import dataclass


@dataclass
class SpanStats:
    count: int = 0
    total_s: float = 0.0
    child_s: float = 0.0  # time of the spans opened inside this one

    @property
    def mean_s(self) -> float:
        return self.total_s / max(self.count, 1)

    @property
    def self_s(self) -> float:
        return self.total_s - self.child_s


class Tracer:
    """Named wall-clock spans: `with tracer.span("online.solve"):`. A
    dotted name is its own key; a bare name nests under the open span's
    key (module docstring)."""

    def __init__(self) -> None:
        self.stats: dict[str, SpanStats] = defaultdict(SpanStats)
        self._stack: list[str] = []  # keys of the open spans

    @contextlib.contextmanager
    def span(self, name: str):
        parent = self._stack[-1] if self._stack else None
        key = name if parent is None or "." in name else f"{parent}.{name}"
        self._stack.append(key)
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self._stack.pop()
            s = self.stats[key]
            s.count += 1
            s.total_s += dt
            if parent is not None:
                self.stats[parent].child_s += dt

    def report(self) -> dict[str, dict[str, float]]:
        """Each key's count, mean and mean self milliseconds a span, and
        total seconds."""
        return {
            k: dict(count=v.count, mean_ms=v.mean_s * 1e3,
                    self_ms=v.self_s * 1e3 / max(v.count, 1), total_s=v.total_s)
            for k, v in sorted(self.stats.items())
        }


class Metrics:
    """Named counters."""

    def __init__(self) -> None:
        self.counters: dict[str, float] = defaultdict(float)

    def inc(self, name: str, value: float = 1.0) -> None:
        self.counters[name] += value


# module-level defaults, importable anywhere
tracer = Tracer()
metrics = Metrics()
