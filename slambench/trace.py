"""The traced run's device readings: `torch.profiler` over a slice of the
window, reduced to the device's busy time (the union of its operations'
intervals), the top device operations, each kernel's device time, and
the longest idle gaps by what the host was doing (the innermost span
open at the gap's middle: the program's own spans, mirrored into the
profiler for the traced run; `bench.host` where none is open)."""
from __future__ import annotations

import contextlib
import time
from collections import defaultdict

import torch

BENCH_HOST = "bench.host"    # between two calls of the window: no span open
SPAN_PREFIXES = ("online.", "loop.")  # the program's spans, mirrored into the profiler


def mirror_spans(tracer):
    """Make each span of the program's tracer also a profiler range
    (`record_function`) for the rest of the process."""
    span = tracer.span

    @contextlib.contextmanager
    def both(name):
        with torch.profiler.record_function(name), span(name):
            yield

    tracer.span = both


class Slice:
    """The profiler over part of the window: it starts at the first frame
    `start_s` into the window and stops at the first frame after `min_s`
    more seconds once `ready()` holds, or after `max_s`."""

    def __init__(self, start_s: float, min_s: float, max_s: float, ready, device):
        """`ready(at_start)`: whether the slice holds what it waits for,
        given `ready(None)`'s reading when the profiler started."""
        self.start_s, self.min_s, self.max_s, self.ready = start_s, min_s, max_s, ready
        self.at_start = None
        self.device = device
        self.prof = None
        self.t0 = self.wall_s = None
        self.done = False

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def on_frame(self, j: int, elapsed: float) -> float:
        """Start or stop the profiler after a frame; returns the seconds
        spent here (starting and stopping a profiler is not the program's
        time, and the window leaves it out)."""
        t = time.perf_counter()
        self._step(elapsed)
        return time.perf_counter() - t

    def _step(self, elapsed: float) -> None:
        if self.done:
            return
        if self.prof is None:
            if elapsed >= self.start_s:
                acts = [torch.profiler.ProfilerActivity.CPU]
                if self.device.type == "cuda":
                    acts.append(torch.profiler.ProfilerActivity.CUDA)
                self._sync()
                self.prof = torch.profiler.profile(activities=acts)
                self.prof.__enter__()
                self.t0 = time.perf_counter()
                self.at_start = self.ready(None)
            return
        span = time.perf_counter() - self.t0
        if (span >= self.min_s and self.ready(self.at_start)) or span >= self.max_s:
            self.stop()

    def stop(self) -> None:
        if self.prof is None or self.done:
            return
        self._sync()
        self.wall_s = time.perf_counter() - self.t0
        self.prof.__exit__(None, None, None)
        self.done = True


def reduce(prof, wall_s: float, top: int = 10) -> dict:
    """busy_s, window_s, device ops {name: [count, device s]}, the top
    device ops and the idle gaps by host span, from a stopped profiler."""
    from torch.autograd import DeviceType

    # one pass over the events: a device operation's own interval is its
    # device time (what `key_averages` reports as its self device time,
    # without the recursive sums over host events that make that slow); a
    # profiler range (`record_function`) shows again as a device event
    # spanning its kernels: it is no device operation of its own
    ops: dict = defaultdict(lambda: [0, 0.0])
    dev, host = [], []
    for e in prof.events():
        tr = e.time_range
        if e.name.startswith(SPAN_PREFIXES):
            if e.device_type == DeviceType.CPU:
                host.append((tr.start, tr.end, e.name))
        elif e.device_type == DeviceType.CUDA:
            ops[e.key][0] += 1
            ops[e.key][1] += 1e-6 * (tr.end - tr.start)
            dev.append((tr.start, tr.end))
            host.append((tr.start, tr.end, e.name))
    dev.sort()
    merged = []
    for s, t in dev:
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], t)
        else:
            merged.append([s, t])
    busy_us = sum(t - s for s, t in merged)
    # the innermost span open at each gap's middle: spans nest, so a
    # sweep over them in start order keeps the open ones on a stack
    gaps: dict = defaultdict(float)
    host.sort()
    stack, h = [], 0
    for mid, width in sorted((0.5 * (t0 + s1), s1 - t0) for (_, t0), (s1, _) in zip(merged, merged[1:])):
        while h < len(host) and host[h][0] <= mid:
            while stack and stack[-1][1] < host[h][0]:
                stack.pop()
            stack.append(host[h])
            h += 1
        while stack and stack[-1][1] < mid:
            stack.pop()
        gaps[stack[-1][2] if stack else BENCH_HOST] += 1e-6 * width
    top_ops = sorted(([k, v[1]] for k, v in ops.items()), key=lambda kv: -kv[1])[:top]
    top_gaps = sorted(([k, v] for k, v in gaps.items()), key=lambda kv: -kv[1])[:top]
    return dict(busy_s=1e-6 * busy_us, window_s=wall_s, ops={k: v for k, v in ops.items()},
                device_ops=top_ops, idle_gaps=top_gaps)
