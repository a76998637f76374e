"""The traced window: ``torch.profiler`` (CUPTI) over the measured seconds,
and its reduction to what the per-layer metrics read.

Only device activity is traced (kernels, copies, sets), so the trace
costs the host next to nothing and leaves the host-bound parts of a run
as they are untraced. The harness records its own ranges around its
calls into the system (``bench.search``, ``bench.upload``,
``bench.commit``, ``bench.query``) on the wall clock the profiler uses.
From these: busy seconds (the union of device intervals), the idle gaps
between them named by the ranges open at the time, and device time by
kernel name.
"""

from __future__ import annotations

import contextlib
import re
import sys
import time

# device work is kernels, copies and sets; the device-side images of host
# ``record_function`` labels are not
_DEVICE_WORK = ("kernel", "gpu_memcpy", "gpu_memset")


def _t(e) -> tuple[float, float]:
    """(start, end) of a raw profiler event in wall-clock seconds."""
    if hasattr(e, "start_ns"):
        return e.start_ns() * 1e-9, e.end_ns() * 1e-9
    s = e.start_us() * 1e-6
    return s, s + e.duration_us() * 1e-6


def _is_work(e) -> bool:
    if hasattr(e, "activity_type"):
        return e.activity_type() in _DEVICE_WORK
    # without the activity's kind: kernels, copies and sets carry a
    # signature or a direction in parentheses, host labels do not
    return "(" in e.name()


def quiet(name: str):
    """A harness range that records nothing (untraced runs)."""
    return contextlib.nullcontext()


class _Range:
    __slots__ = ("out", "name", "t0")

    def __init__(self, out: list, name: str) -> None:
        self.out, self.name = out, name

    def __enter__(self):
        self.t0 = time.time_ns()
        return self

    def __exit__(self, *exc) -> None:
        self.out.append((self.t0 * 1e-9, time.time_ns() * 1e-9, self.name))


class Window:
    """The profiler around the measured window (``on`` False: the clock
    only, and ``span`` records nothing)."""

    def __init__(self, on: bool, cuda: bool = True) -> None:
        self.on, self.cuda = on, cuda
        self.prof = None
        self.t0 = self.t1 = 0
        self.ranges: list = []

    def span(self, name: str):
        """A harness range around one call into the system."""
        if not self.on:
            return contextlib.nullcontext()
        return _Range(self.ranges, name)

    def __enter__(self):
        if self.on and self.cuda:
            import torch
            from torch.profiler import ProfilerActivity, profile
            torch.cuda.synchronize()
            self.prof = profile(activities=[ProfilerActivity.CUDA])
            self.prof.__enter__()
        self.t0 = time.time_ns()
        return self

    def close(self) -> None:
        """End of the measured window (the profiler stops after it)."""
        self.t1 = time.time_ns()

    def __exit__(self, *exc) -> None:
        if not self.t1:
            self.close()
        if self.prof is not None:
            self.prof.__exit__(*exc)

    def reduce(self) -> "Reduced | None":
        if not self.on:
            return None
        events = (self.prof.profiler.kineto_results.events()
                  if self.prof is not None else [])
        return Reduced(events, self.t0 * 1e-9, self.t1 * 1e-9, self.ranges)


class Reduced:
    """What the per-layer readers take from one traced window."""

    def __init__(self, events, t0: float, t1: float, ranges=()) -> None:
        """``events`` are the profiler's raw events; ``t0`` .. ``t1`` the
        measured window on the wall clock: device work outside it is cut
        off. ``ranges`` are the harness's (start, end, name)."""
        self.window_s = t1 - t0
        self.ranges = list(ranges)
        dev = [(*_t(e), e.name()) for e in events
               if not str(e.device_type()).endswith("CPU") and _is_work(e)]
        inside = sorted((max(s, t0), min(t, t1), n)
                        for s, t, n in dev if t > t0 and s < t1)
        if dev and not inside:
            # the profiler's clock is not the wall clock here: keep it all
            print("trace: no device event inside the window's wall-clock "
                  "bounds; the whole trace is kept", file=sys.stderr)
            inside = sorted(dev)
        self.device = inside     # (start, end, name), by start
        self._union(t0, t1)

    def _union(self, t0: float, t1: float) -> None:
        """Busy seconds and the idle gaps of the device timeline, the
        window's edges included."""
        busy, gaps = 0.0, []
        cur_s, cur_e = None, t0
        for s, t, _n in self.device:
            if s > cur_e:
                if cur_s is not None:
                    busy += cur_e - cur_s
                gaps.append((cur_e, s))
                cur_s, cur_e = s, t
            else:
                if cur_s is None:
                    cur_s = s
                cur_e = max(cur_e, t)
        if cur_s is not None:
            busy += cur_e - cur_s
        if t1 > cur_e:
            gaps.append((cur_e, t1))
        self.busy_s = busy
        self.gaps = gaps

    def device_time(self, pattern: str) -> float:
        """Seconds of device operations whose name matches ``pattern``."""
        rx = re.compile(pattern)
        return sum(t - s for s, t, n in self.device if rx.search(n))

    def top_ops(self, n: int = 10) -> list:
        agg = {}
        for s, t, name in self.device:
            agg[name] = agg.get(name, 0.0) + (t - s)
        return sorted(([k, v] for k, v in agg.items()),
                      key=lambda kv: -kv[1])[:n]

    def top_gaps(self, n: int = 10) -> list:
        """The longest idle gaps, each named by the harness ranges open at
        the gap's middle."""
        out = []
        for a, b in sorted(self.gaps, key=lambda g: g[0] - g[1])[:n]:
            mid = 0.5 * (a + b)
            names = sorted({r[2] for r in self.ranges
                            if r[0] <= mid <= r[1]})
            out.append(["+".join(names) or "no bench range", b - a])
        return out
