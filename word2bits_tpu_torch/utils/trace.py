"""The program's own spans: named host intervals of a train() call.

    with span("step.gather"):
        ...

While no torch profiler session records, `span` returns one shared no-op
object: no clock read, no allocation.  While one records (the benchmark's
traced epoch, `-profile-dir`, tools/profile_step.py), each span appends
(name, start_ns, end_ns, parent) to an in-memory list, stamped with
time.time_ns(): Unix time in ns, the clock torch.profiler stamps its
events with, so a span lines up with the kernels it issued.  `parent` is
the index of the enclosing span, -1 at the top.

The spans are not torch.profiler.record_function ranges: the profiler
copies each such range onto the device's timeline, where every reader of
device activity would count it, and a range costs microseconds even with
no profiler running.

`phase(name, seconds)` is a span that also adds its host seconds to
seconds[key] whether or not a profiler records (TrainResult.seconds):
the seconds of a phase exclude those of the phases nested inside it.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple

from torch.autograd import profiler as _profiler

Span = Tuple[str, int, int, int]      # name, start ns, end ns, parent index

_spans: List[list] = []
_open: List[int] = []                 # indices of the spans entered
_phases: List["phase"] = []


class _Off:
    # cheaper to enter and leave than contextlib.nullcontext
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _On:
    __slots__ = ("name", "rec", "i")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.i = len(_spans)
        self.rec = [self.name, time.time_ns(), 0, _open[-1] if _open else -1]
        _spans.append(self.rec)
        _open.append(self.i)
        return self

    def __exit__(self, *exc):
        self.rec[2] = time.time_ns()
        if _open and _open[-1] == self.i:   # a clear() may have come between
            _open.pop()
        return False


def span(name: str):
    """A context manager: the span `name` while a profiler records."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return _On(name)


def recording() -> bool:
    return bool(_profiler._is_profiler_enabled)


def clear() -> None:
    """Forget the recorded spans (train() does this on entry while a
    profiler records)."""
    _spans.clear()
    _open.clear()


def spans() -> List[Span]:
    """The spans recorded since the last clear(): the newest recorded
    train() call's, in the order they were entered."""
    return [tuple(s) for s in _spans]


class phase:
    """with phase(name, seconds[, key]): span(name), and the host seconds
    spent inside it, less those of the phases nested inside it, added to
    seconds[key] (key: name with '.' as '_')."""

    __slots__ = ("seconds", "key", "sp", "t0", "inner")

    def __init__(self, name: str, seconds: Dict[str, float],
                 key: Optional[str] = None):
        self.seconds = seconds
        self.key = key or name.replace(".", "_")
        self.sp = span(name)

    def __enter__(self):
        self.sp.__enter__()
        self.inner = 0.0
        _phases.append(self)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self.t0
        _phases.pop()
        if _phases:
            _phases[-1].inner += dt
        self.seconds[self.key] = (self.seconds.get(self.key, 0.0) + dt
                                  - self.inner)
        return self.sp.__exit__(*exc)
