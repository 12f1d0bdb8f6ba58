"""What a run hands the metric readers (``portbench/metrics/<name>.py``).

A reader is a file with one function, ``read(run) -> float or None``: it
takes its metric from what this record holds and returns ``None`` where it
finds nothing to read, and the harness then leaves the metric out of the
result line.  A reader never returns 0 for a share of a roofline or a peak
that it could not measure.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from .devtrace import covered, union

Span = Tuple[str, str, float, float, dict]  # name, track, start_us, end_us, args


@dataclass
class RunRecord:
    cell: object
    window: object
    setup_s: float
    start_us: float
    end_us: float
    # Traced runs only: the program's spans and the card's events in the
    # window, and the recovery kernel's bound over the window's lanes.
    spans: Optional[List[Span]] = None
    device: Optional[List[Tuple[str, float, float]]] = None
    recover_bound_s: Optional[float] = None
    # The program's counters (``utils/metrics.py``) that the window moved, by
    # key, and by how much.
    counters: Dict[tuple, float] = field(default_factory=dict)

    @property
    def window_s(self) -> float:
        return (self.end_us - self.start_us) / 1e6

    def spans_named(self, name: str, **args) -> List[Span]:
        return [s for s in self.spans or () if s[0] == name
                and all((s[4] or {}).get(k) == v for k, v in args.items())]

    def busy_s(self) -> Optional[float]:
        if not self.device:
            return None
        return covered(union([(a, b) for _n, a, b in self.device]), self.start_us, self.end_us) / 1e6

    def kernel_s(self, fragment: str) -> float:
        return sum(b - a for name, a, b in self.device or () if fragment in name) / 1e6


def p95(values: List[float]) -> Optional[float]:
    """Nearest-rank 95th percentile."""
    if not values:
        return None
    ordered = sorted(values)
    k = max(0, -(-95 * len(ordered) // 100) - 1)
    return ordered[k]
