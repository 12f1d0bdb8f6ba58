"""Per-peer clock-offset estimation from (send, recv) timestamp pairs.

Every traced message carries the sender's monotonic microsecond clock
(``TraceContext.sent_us``); the receiver reads its own clock at delivery.
The difference ``recv_local - sent_remote`` equals the true clock offset
plus the one-way network delay, so the MINIMUM over many pairs is the
tightest one-sided offset estimate available without an NTP-style
round-trip — exactly the classic one-way-delay bound.  Loopback clusters
share one process clock, record no samples here, and export offset zero.

The estimator is process-global (like the trace recorder): transports
feed it, exports snapshot it, and the timeline tool
(:mod:`go_ibft_tpu_torch.obs.timeline`) uses the per-origin estimates to rebase
foreign-process timestamps onto the local clock before reconstructing a
cross-node consensus timeline.  Estimates are therefore *upper bounds*
(offset + min one-way delay); the timeline report labels them as such.
"""

from __future__ import annotations

import threading
from typing import Dict, Optional

__all__ = ["ClockOffsets", "observe", "estimate", "snapshot", "reset"]


class ClockOffsets:
    """Thread-safe per-origin min(recv - send) tracker (bounded)."""

    def __init__(self, max_origins: int = 1024) -> None:
        self._lock = threading.Lock()
        self._min_delta: Dict[str, int] = {}
        self._samples: Dict[str, int] = {}
        self.max_origins = max_origins

    def observe(self, origin: str, sent_us: int, recv_us: int) -> None:
        delta = recv_us - sent_us
        with self._lock:
            if origin not in self._min_delta:
                if len(self._min_delta) >= self.max_origins:
                    return  # bounded: a spammer cannot grow this forever
                self._min_delta[origin] = delta
                self._samples[origin] = 1
            else:
                if delta < self._min_delta[origin]:
                    self._min_delta[origin] = delta
                self._samples[origin] += 1

    def estimate(self, origin: str) -> Optional[int]:
        """Best offset estimate for ``origin`` in µs (``None``: no data)."""
        with self._lock:
            return self._min_delta.get(origin)

    def snapshot(self) -> Dict[str, dict]:
        """``{origin: {"offset_us": est, "samples": n}}`` for exports."""
        with self._lock:
            return {
                origin: {
                    "offset_us": delta,
                    "samples": self._samples[origin],
                }
                for origin, delta in self._min_delta.items()
            }

    def reset(self) -> None:
        with self._lock:
            self._min_delta.clear()
            self._samples.clear()


# Process-global instance (one per node process, like the trace recorder).
_global = ClockOffsets()


def observe(origin: str, sent_us: int, recv_us: int) -> None:
    _global.observe(origin, sent_us, recv_us)


def estimate(origin: str) -> Optional[int]:
    return _global.estimate(origin)


def snapshot() -> Dict[str, dict]:
    return _global.snapshot()


def reset() -> None:
    _global.reset()
