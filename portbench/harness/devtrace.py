"""The benchmark's view of the card: one ``torch.profiler`` trace over the
measured window, reduced to device intervals on the host's clock.  A traced
run takes one, and so does an untraced run of a cell that reports an
end-to-end metric read from the card (``"source": "device_trace"``).

The trace records the card's activity only (kernels, copies, sets, and
the runtime's launch calls), which keeps a window of tens of thousands of
launches quick to read.  It opens before the window (a process's first
profiler start takes seconds, which :attr:`DeviceProfile.start_s` keeps
and the run leaves out of its set-up time) and closes after it with the card
synchronised.  A ``torch.cuda._sleep`` kernel launched right after a
synchronise, at a known host time, is the mark that puts the card's times on
``time.perf_counter`` microseconds: its start lies a launch's latency (some
microseconds) after that host time, which is far below the gaps the
breakdown labels.
"""

from __future__ import annotations

import time
from typing import List, Tuple

Interval = Tuple[float, float]
MARK_CYCLES = 1000


def union(intervals: List[Interval]) -> List[Interval]:
    """Sorted, disjoint cover of ``intervals``."""
    out: List[Interval] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


def covered(intervals: List[Interval], lo: float, hi: float) -> float:
    """Length of ``[lo, hi]`` that the disjoint sorted ``intervals`` cover."""
    total = 0.0
    for a, b in intervals:
        if b <= lo:
            continue
        if a >= hi:
            break
        total += min(b, hi) - max(a, lo)
    return total


class DeviceProfile:
    """One profiler trace; :meth:`events` gives ``(name, start_us,
    end_us)`` of every device event, on the host's ``perf_counter``."""

    def __init__(self) -> None:
        self._prof = None
        self._mark_us = 0.0
        self.start_s = 0.0
        self.read_s = 0.0

    def start(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile

        t0 = time.perf_counter()
        torch.cuda.synchronize()
        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self._prof.__enter__()
        torch.cuda.synchronize()
        self._mark_us = time.perf_counter_ns() / 1e3
        torch.cuda._sleep(MARK_CYCLES)
        torch.cuda.synchronize()
        self.start_s = time.perf_counter() - t0

    def stop(self) -> None:
        import torch

        torch.cuda.synchronize()
        t0 = time.perf_counter()
        self._prof.__exit__(None, None, None)
        self.read_s = time.perf_counter() - t0

    def events(self) -> List[Tuple[str, float, float]]:
        import torch

        t0 = time.perf_counter()
        cuda = torch.autograd.DeviceType.CUDA
        raw = [(e.name, e.time_range.start, e.time_range.end) for e in self._prof.events()
               if e.device_type == cuda]
        marks = [a for name, a, _b in raw if "spin_kernel" in name or "sleep" in name]
        offset = self._mark_us - min(marks) if marks else 0.0
        self.read_s += time.perf_counter() - t0
        return [(name, a + offset, b + offset) for name, a, b in raw
                if not ("spin_kernel" in name or "sleep" in name)]
