"""The traced unit: torch.profiler over one timed unit of the cell, read
from the raw kineto events (no event tree is built), reduced to what the
per-layer readers and the breakdown need.

- device operations: kernels, memcopies and memsets on the card; the busy
  time is the union of their intervals, the launches the kernels alone;
- stages: each device operation belongs to the device-side range
  (``gpu_user_annotation``) that holds its start, e.g. ``mcts.evaluate``;
- idle gaps: every gap between busy intervals inside the window, named by
  the innermost host range (a ``mcts.*`` range of the program or one of
  the harness's spans) open at the gap's start.
"""

from __future__ import annotations

import bisect
import sys
import time

import torch

DEVICE_OPS = ("kernel", "gpu_memcpy", "gpu_memset")


def device_kind(e):
    """kineto's activity type of a device event: 'kernel', 'gpu_memcpy',
    'gpu_memset' or 'gpu_user_annotation' (torch 2.11's events have no
    activity_type())."""
    if hasattr(e, "activity_type"):
        return e.activity_type()
    if e.is_user_annotation():
        return "gpu_user_annotation"
    name = e.name()
    if name.startswith("Memcpy"):
        return "gpu_memcpy"
    return "gpu_memset" if name.startswith("Memset") else "kernel"


def run_traced(fn, sync):
    """(fn's result, Trace) of one call of `fn` under the profiler."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        sync()
        t0 = time.perf_counter_ns()
        out = fn()
        sync()
        t1 = time.perf_counter_ns()
    t2 = time.perf_counter_ns()
    events = prof.profiler.kineto_results.events()
    t3 = time.perf_counter_ns()
    tr = Trace(events, (t1 - t0) / 1e3)
    print(f"trace: unit {(t1 - t0) / 1e9:.1f} s, profiler stop {(t2 - t1) / 1e9:.1f} s, "
          f"{len(events)} events in {(t3 - t2) / 1e9:.1f} s, read in "
          f"{(time.perf_counter_ns() - t3) / 1e9:.1f} s", file=sys.stderr)
    return out, tr


def _span(e):
    start = e.start_ns()
    return (start / 1e3, (start + e.duration_ns()) / 1e3, e.name())


class Trace:
    def __init__(self, events, wall_us):
        ops, ranges, host = [], [], []
        cuda = torch.autograd.DeviceType.CUDA
        for e in events:
            if e.device_type() != cuda:
                # most events are the host's operators: one call decides
                if e.is_user_annotation():
                    host.append(_span(e))
                continue
            kind = device_kind(e)
            if kind in DEVICE_OPS:
                ops.append(_span(e) + (kind,))
            elif kind == "gpu_user_annotation":
                ranges.append(_span(e))
        ops.sort()
        ranges.sort()
        host.sort()
        self.ops = ops
        self.launches = sum(1 for o in ops if o[3] == "kernel")
        self.window_us = wall_us
        self.busy_us, self.gaps = self._busy_and_gaps(ops)
        self.stage = self._stages(ops, ranges)
        self.host = host

    @staticmethod
    def _busy_and_gaps(ops):
        busy, end, gaps = 0.0, None, []
        for s, t, _, _ in ops:
            if end is not None and s > end:
                gaps.append((end, s))
            if end is None or t > end:
                busy += t - (s if end is None else max(s, end))
                end = t
        return busy, gaps

    @staticmethod
    def _stages(ops, ranges):
        """Per device op, the name of the device range holding its start."""
        starts = [r[0] for r in ranges]
        out = []
        for s, _, _, _ in ops:
            i = bisect.bisect_right(starts, s) - 1
            out.append(ranges[i][2] if i >= 0 and s < ranges[i][1] else None)
        return out

    def idle_share(self):
        """Per cent of the traced unit's wall time in which no operation ran
        on the card."""
        return 100.0 * (1.0 - self.busy_us / self.window_us)

    def stage_us(self, name):
        """(device us, kernel launches) of the ops under ranges called `name`."""
        us = n = 0
        for (s, t, _, kind), st in zip(self.ops, self.stage):
            if st == name:
                us += t - s
                n += kind == "kernel"
        return us, n

    def top_ops(self, k=10):
        per = {}
        for s, t, name, _ in self.ops:
            per[name] = per.get(name, 0.0) + (t - s)
        return [[n, us / 1e6] for n, us in sorted(per.items(), key=lambda kv: -kv[1])[:k]]

    def idle_by_host(self, k=10):
        """Idle time summed by the innermost host range open at each gap's
        start ("outside" when none), the largest `k`."""
        bounds = sorted([(h[0], 1, i) for i, h in enumerate(self.host)]
                        + [(h[1], 0, i) for i, h in enumerate(self.host)])
        per, stack, j = {}, [], 0
        for s, t in self.gaps:
            while j < len(bounds) and bounds[j][0] <= s:
                _, opens, i = bounds[j]
                if opens:
                    stack.append(i)
                elif i in stack:
                    stack.remove(i)
                j += 1
            name = self.host[stack[-1]][2] if stack else "outside"
            per[name] = per.get(name, 0.0) + (t - s)
        return [[n, us / 1e6] for n, us in sorted(per.items(), key=lambda kv: -kv[1])[:k]]
