"""The program's own spans of the traced call, for the readers of the
training loop's layers.

`word2bits_tpu_torch.utils.trace.spans()` holds the newest recorded
`train.train` call's spans: (name, start ns, end ns, parent index), on
the clock torch.profiler stamps its events with, so a span and the device
activity issued inside it line up in a `trace.Trace` (seconds).  A
program without that module, or a call that recorded no span (no
profiler), gives None, and every reader built on it reads nothing.
"""

from __future__ import annotations

import bisect
from typing import List, Optional, Tuple

Span = Tuple[str, float, float, int]     # name, start s, end s, parent
Window = Tuple[float, float]


def program_spans() -> Optional[List[Span]]:
    try:
        from word2bits_tpu_torch.utils import trace
    except ImportError:
        return None
    out = [(n, a * 1e-9, b * 1e-9, p) for n, a, b, p in trace.spans()]
    return out or None


def windows(spans: List[Span], *names: str, top: bool = False
            ) -> List[Window]:
    """The (start, end) of the spans named `names` (with `top`, only those
    that no other span encloses), by start."""
    return sorted((a, b) for n, a, b, p in spans
                  if n in names and (p < 0 or not top))


def length(ws: List[Window]) -> float:
    return sum(b - a for a, b in ws)


def busy_in(tr, ws: List[Window]) -> float:
    """Seconds of device activity (the union of its intervals) inside the
    disjoint windows `ws`."""
    return length(ws) - length(idle_in(tr, ws))


def idle_in(tr, ws: List[Window]) -> List[Window]:
    """The device's idle intervals inside the disjoint windows `ws`."""
    merged = tr.merged()
    ends = [b for _, b in merged]
    out = []
    for a, b in ws:
        t, i = a, bisect.bisect_right(ends, a)
        while i < len(merged) and merged[i][0] < b:
            x, y = merged[i]
            if x > t:
                out.append((t, x))
            t, i = max(t, y), i + 1
        if t < b:
            out.append((t, b))
    return out


def inside(ws: List[Window], points: List[float]) -> List[bool]:
    """For each point, whether it lies in one of the windows `ws` (sorted,
    disjoint)."""
    starts = [a for a, _ in ws]
    out = []
    for t in points:
        i = bisect.bisect_right(starts, t) - 1
        out.append(i >= 0 and t <= ws[i][1])
    return out
