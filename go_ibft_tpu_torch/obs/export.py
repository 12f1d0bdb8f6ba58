"""Chrome ``trace_event`` / Perfetto JSON export for the flight recorder
(a copy of the JAX package's ``obs/export.py``: the same document, byte for
byte, from the same records).

Produces the JSON-object flavor of the trace-event format (the one both
``chrome://tracing`` and https://ui.perfetto.dev load directly)::

    {
      "displayTimeUnit": "ms",
      "traceEvents": [
        {"ph": "M", "pid": 0, "tid": 3, "name": "thread_name",
         "args": {"name": "node-1a2b3c"}},
        {"ph": "X", "pid": 0, "tid": 3, "name": "commit.drain",
         "cat": "obs", "ts": 12345, "dur": 210, "args": {"round": 0}},
        {"ph": "i", "pid": 0, "tid": 3, "name": "round.timeout",
         "cat": "obs", "ts": 99999, "s": "t", "args": {"round": 1}}
      ]
    }

Each recorder *track* becomes one ``tid`` with a ``thread_name`` metadata
event, so a 6-node height renders as six labeled rows.  Timestamps are the
recorder's shared monotonic microsecond clock, rebased to the earliest
record so traces start near zero.
"""

from __future__ import annotations

import json
from typing import Dict, Iterable, List, Optional

from .recorder import Record, RingRecorder

__all__ = ["to_chrome_trace", "write_chrome_trace"]

_PID = 0
_CAT = "obs"


def to_chrome_trace(
    records: Iterable[Record],
    dropped: int = 0,
    *,
    node: Optional[str] = None,
    clock_offsets: Optional[dict] = None,
) -> dict:
    """Recorder records -> a Chrome trace-event JSON object (as a dict).

    ``dropped`` (records overwritten after the ring filled) is surfaced in
    the document's ``otherData`` so a truncated flight-recorder window is
    visible in the artifact itself: spans near the wrap boundary may have
    lost their children, and tooling must not treat such a trace as a
    complete record.

    ``node`` stamps the exporting process's node identity and
    ``clock_offsets`` its per-peer clock-offset estimates
    (:mod:`go_ibft_tpu_torch.obs.clock` snapshot) into ``otherData`` — the
    cross-process telemetry plane's export contract: the timeline tool
    merges N per-node files and needs both to rebase foreign timestamps.
    A loopback export carries an empty offsets map (one shared clock).
    """
    records = list(records)
    base = min((r[3] for r in records), default=0)
    tids: Dict[str, int] = {}
    events: List[dict] = []
    for ph, name, track, ts_us, dur_us, args in records:
        tid = tids.get(track)
        if tid is None:
            tid = tids[track] = len(tids)
            events.append(
                {
                    "ph": "M",
                    "pid": _PID,
                    "tid": tid,
                    "name": "thread_name",
                    "args": {"name": track},
                }
            )
        event = {
            "ph": ph,
            "pid": _PID,
            "tid": tid,
            "name": name,
            "cat": _CAT,
            "ts": ts_us - base,
            "args": args or {},
        }
        if ph == "X":
            event["dur"] = dur_us
        elif ph == "i":
            event["s"] = "t"  # thread-scoped instant
        events.append(event)
    # Raw-clock anchor of the rebase: ts 0 in this document is this raw
    # monotonic microsecond.  Device-trace merging (obs/timeline.py::
    # merge_device_trace) uses it to place a device profiler window —
    # whose own timestamps count from the capture's start — onto this
    # document's clock.
    other = {"droppedRecords": dropped, "clockBaseUs": base}
    if node is not None:
        other["node"] = node
    if clock_offsets is not None:
        other["clockOffsetsUs"] = clock_offsets
    return {
        "displayTimeUnit": "ms",
        "otherData": other,
        "traceEvents": events,
    }


def write_chrome_trace(
    path: str,
    recorder: Optional[RingRecorder] = None,
    *,
    node: Optional[str] = None,
    clock_offsets: Optional[dict] = None,
) -> int:
    """Export ``recorder`` (default: the active trace recorder) to ``path``.

    Returns the number of trace events written (metadata included).  An
    empty or missing recorder still writes a valid empty trace, so a
    ``--trace`` run that recorded nothing leaves a loadable artifact
    rather than a crash.  ``clock_offsets`` defaults to the process-global
    :mod:`~go_ibft_tpu_torch.obs.clock` snapshot whenever ``node`` is given (a
    per-node export is exactly the cross-process case that needs it).
    """
    if recorder is None:
        from . import trace

        recorder = trace.recorder()
    if clock_offsets is None and node is not None:
        from . import clock

        clock_offsets = clock.snapshot()
    doc = to_chrome_trace(
        recorder.snapshot() if recorder is not None else [],
        dropped=recorder.dropped if recorder is not None else 0,
        node=node,
        clock_offsets=clock_offsets,
    )
    with open(path, "w") as fh:
        json.dump(doc, fh)
    return len(doc["traceEvents"])
