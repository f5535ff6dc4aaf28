"""The traced span: torch.profiler (CPU and CUDA activities) over one call,
reduced to what the per-layer readers read.

The busy and idle arithmetic is word2bits_tpu_torch/tools/profile_step.py's
(commit 26809b4dee3683ec1871bc5d1e1a6fa56c4992c9): device time over the
span's wall time on the host's clock, the span ending in
torch.cuda.synchronize().  Rewritten in two ways: busy time is the union of
the device activities' intervals (kernels, copies and sets, which on one
stream never overlap, so the union equals profile_step.py's sum there), and
events are read raw from the profiler's results, which keeps the reduction
of a span of a million events to seconds.
"""

from __future__ import annotations

import bisect
import re
import time
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Callable, List, Tuple

import torch

Interval = Tuple[str, float, float]      # name, start s, end s


@dataclass
class Trace:
    device: List[Interval] = field(default_factory=list)
    host: List[Interval] = field(default_factory=list)
    wall_s: float = 0.0

    def busy_s(self) -> float:
        """Seconds in which some device activity ran (their union)."""
        return sum(b - a for a, b in self.merged())

    def merged(self) -> List[Tuple[float, float]]:
        out: List[List[float]] = []
        for _, a, b in sorted(self.device, key=lambda e: e[1]):
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return [(a, b) for a, b in out]

    def matching(self, patterns, exclude=()) -> List[Interval]:
        pat = [re.compile(p) for p in patterns]
        exc = [re.compile(p) for p in exclude]
        return [e for e in self.device
                if any(p.search(e[0]) for p in pat)
                and not any(p.search(e[0]) for p in exc)]

    def top_device_ops(self, n: int = 10) -> List[List]:
        by = defaultdict(float)
        for name, a, b in self.device:
            by[name] += b - a
        return [[k, v] for k, v in sorted(by.items(),
                                          key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10) -> List[List]:
        """The device's idle time between activities, by the innermost
        host operation running at the middle of each gap, longest
        total first."""
        host = sorted(self.host, key=lambda e: e[1])
        starts = [h[1] for h in host]
        by = defaultdict(float)
        m = self.merged()
        for (_, b0), (a1, _) in zip(m, m[1:]):
            gap = a1 - b0
            if gap <= 0:
                continue
            mid = 0.5 * (a1 + b0)
            i = bisect.bisect_right(starts, mid)
            name = "host outside any op"
            # the latest-starting op that still runs at `mid`
            for j in range(i - 1, max(i - 64, -1), -1):
                if host[j][2] >= mid:
                    name = host[j][0]
                    break
            by[name] += gap
        return [[k, v] for k, v in sorted(by.items(),
                                          key=lambda kv: -kv[1])[:n]]


def traced(fn: Callable, device) -> Tuple[object, Trace]:
    """Run fn() under the profiler; (its result, the Trace of the span)."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        out = fn()
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    tr = Trace(wall_s=wall)
    for e in prof.profiler.kineto_results.events():
        a, b = e.start_ns() * 1e-9, e.end_ns() * 1e-9
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            tr.device.append((e.name(), a, b))
        elif not e.name().startswith(("cuda", "cu")):
            tr.host.append((e.name(), a, b))
    return out, tr
