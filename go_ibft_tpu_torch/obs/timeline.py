"""Cross-node consensus timeline reconstruction (a copy of the JAX package's
``obs/timeline.py``: the same reports from the same exports).

Merges N per-node flight-recorder exports (or one multi-track loopback
export) into a per-height consensus timeline:

    proposal broadcast -> PREPARE quorum waterfall -> COMMIT quorum ->
    finalize

and computes the height's **critical path**: which node finalized last,
which validator's message completed each quorum there, and how the time
split between network wait, signature verification, and drain wakeup.

Inputs are the Chrome ``trace_event`` documents ``obs/export.py`` writes.
The records that matter:

* ``net.send`` instants (args: height, round, type, span) — stamped by
  the engine at multicast time on the sender's track;
* ``net.recv`` instants (args: origin, height, round, type, span,
  sent_us) — recorded at delivery on the receiver's track (engine ingress
  for loopback dispatch, the wire boundary for ``GrpcTransport``);
* ``sequence.start`` / ``sequence.done`` instants (args: height) — the
  per-node height window;
* ``verify.drain`` / ``*.drain`` spans — verification and phase-drain
  time attribution on the node's track.

Cross-process clock alignment uses each file's ``otherData.clockOffsetsUs``
(the :mod:`go_ibft_tpu_torch.obs.clock` min one-way-delay estimates): events
from a foreign file are rebased onto the reference file's clock via the
reference node's estimate for that origin.  The estimates are upper
bounds (true offset + min one-way delay), so sub-millisecond cross-node
orderings are approximate — the per-node quorum waterfalls, which only
ever compare timestamps recorded on ONE clock, are exact.  Loopback
exports share one clock and skip alignment entirely.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

__all__ = [
    "TraceFile",
    "Event",
    "load_trace_file",
    "merge_events",
    "default_quorum",
    "reconstruct",
    "HeightTimeline",
    "NodePhases",
    "render_report",
    "to_perfetto",
    "merge_device_trace",
]

# Message-type codes as stamped in net.send/net.recv args (wire enum).
_PREPREPARE, _PREPARE, _COMMIT = 0, 1, 2

# Span names counted as signature-verification work on a node's track.
_VERIFY_SPANS = frozenset({"verify.drain"})
# Span names counted as phase-drain (store walk + state machine) work.
_DRAIN_SPANS = frozenset({"proposal.drain", "prepare.drain", "commit.drain"})


@dataclass
class Event:
    """One normalized record on the merged timeline (µs, aligned clock)."""

    name: str
    track: str
    ts: int
    dur: int
    args: dict
    ph: str
    source: str  # originating trace file (diagnostics)


@dataclass
class TraceFile:
    """One parsed export: events with resolved track names + metadata."""

    path: str
    node: Optional[str]
    clock_offsets: Dict[str, int]
    dropped: int
    events: List[Event]


def load_trace_file(path: str) -> TraceFile:
    """Parse one ``obs/export.py`` document into normalized events."""
    with open(path) as fh:
        doc = json.load(fh)
    other = doc.get("otherData", {}) or {}
    offsets_raw = other.get("clockOffsetsUs", {}) or {}
    clock_offsets = {
        origin: int(entry.get("offset_us", 0))
        if isinstance(entry, dict)
        else int(entry)
        for origin, entry in offsets_raw.items()
    }
    tracks: Dict[int, str] = {}
    events: List[Event] = []
    for e in doc.get("traceEvents", []):
        if e.get("ph") == "M":
            if e.get("name") == "thread_name":
                tracks[e["tid"]] = e.get("args", {}).get("name", str(e["tid"]))
            continue
        events.append(
            Event(
                name=e.get("name", ""),
                track=tracks.get(e.get("tid"), str(e.get("tid"))),
                ts=int(e.get("ts", 0)),
                dur=int(e.get("dur", 0)),
                args=e.get("args", {}) or {},
                ph=e.get("ph", "i"),
                source=path,
            )
        )
    return TraceFile(
        path=path,
        node=other.get("node"),
        clock_offsets=clock_offsets,
        dropped=int(other.get("droppedRecords", 0) or 0),
        events=events,
    )


def merge_events(traces: Sequence[TraceFile]) -> List[Event]:
    """Concatenate per-file events on one clock (reference = file 0).

    For a foreign file whose ``node`` identity the reference file holds a
    clock-offset estimate for, every event timestamp is rebased with that
    estimate; files without an estimate (loopback, or no traffic yet)
    merge unshifted.  Note each export already rebased its own timestamps
    to its earliest record, so the ``net.recv.sent_us`` args — NOT the
    event ``ts`` fields — carry the raw cross-file clock relation; the
    offset estimates come from the same raw pairs, so the rebase below
    first undoes each file's export rebase using the raw anchor stored in
    its own send/recv args.
    """
    if not traces:
        return []
    merged: List[Event] = []
    reference = traces[0]
    for trace_file in traces:
        shift = 0
        if trace_file is not reference and trace_file.node is not None:
            # Raw-clock anchors: export rebased ts to the file's earliest
            # raw timestamp; net.send instants carry no raw copy, but
            # net.recv ones carry the ORIGIN's raw sent_us.  Recover each
            # file's rebase base from any (event ts, raw ts) pair it has.
            est = reference.clock_offsets.get(trace_file.node)
            ref_base = _rebase_anchor(reference)
            own_base = _rebase_anchor(trace_file)
            if est is not None and ref_base is not None and own_base is not None:
                # foreign raw = ts + own_base; local raw ~= foreign raw +
                # est; local ts = local raw - ref_base.
                shift = own_base + est - ref_base
        for event in trace_file.events:
            if shift:
                event = Event(
                    event.name,
                    event.track,
                    event.ts + shift,
                    event.dur,
                    event.args,
                    event.ph,
                    event.source,
                )
            merged.append(event)
    merged.sort(key=lambda e: e.ts)
    return merged


def _rebase_anchor(trace_file: TraceFile) -> Optional[int]:
    """The export's rebase base: raw_ts - exported_ts for this file.

    A node's OWN ``net.send`` and the self-delivered ``net.recv`` carry
    ``sent_us`` (raw clock) in args while ``ts`` is export-rebased; their
    difference recovers the base.  Falls back to ``None`` when the file
    recorded no traced sends (alignment then degrades to no shift).
    """
    for event in trace_file.events:
        if event.name == "net.recv" and event.args.get("origin") == trace_file.node:
            sent = event.args.get("sent_us")
            span_ts = _send_ts(trace_file, event.args.get("span"))
            if sent is not None and span_ts is not None:
                return int(sent) - span_ts
    return None


def _send_ts(trace_file: TraceFile, span_id) -> Optional[int]:
    if span_id is None:
        return None
    for event in trace_file.events:
        if event.name == "net.send" and event.args.get("span") == span_id:
            return event.ts
    return None


def default_quorum(n: int) -> int:
    """Optimal IBFT quorum for ``n`` equally-weighted validators:
    ``n - floor((n-1)/3)`` (e.g. 3 of 4, 5 of 7, 67 of 100)."""
    return n - (n - 1) // 3


@dataclass
class NodePhases:
    """One node's view of one height (all timestamps µs, merged clock)."""

    node: str
    proposal_recv: Optional[int] = None
    prepare_quorum_at: Optional[int] = None
    prepare_completer: Optional[str] = None
    commit_quorum_at: Optional[int] = None
    commit_completer: Optional[str] = None
    finalized_at: Optional[int] = None
    verify_us: int = 0
    drain_us: int = 0

    def wakeup_us(self) -> Optional[int]:
        """Post-COMMIT-quorum latency not attributable to verify/drain
        spans: event-loop wakeup + store walk scheduling — the drain
        wakeup share of the critical path."""
        if self.finalized_at is None or self.commit_quorum_at is None:
            return None
        tail = self.finalized_at - self.commit_quorum_at
        return max(0, tail - self._busy_after_commit)

    _busy_after_commit: int = 0


@dataclass
class HeightTimeline:
    """The reconstructed consensus timeline for one height."""

    height: int
    proposer: Optional[str]
    proposal_sent: Optional[int]
    nodes: Dict[str, NodePhases] = field(default_factory=dict)

    @property
    def critical_node(self) -> Optional[NodePhases]:
        """The node whose finalize completed the height (the slowest)."""
        finalized = [p for p in self.nodes.values() if p.finalized_at is not None]
        if not finalized:
            return None
        return max(finalized, key=lambda p: p.finalized_at)

    def to_dict(self) -> dict:
        crit = self.critical_node
        return {
            "height": self.height,
            "proposer": self.proposer,
            "proposal_sent_us": self.proposal_sent,
            "critical_node": crit.node if crit else None,
            "critical_path": _phase_split(self, crit) if crit else None,
            "nodes": {
                node: {
                    "proposal_recv_us": p.proposal_recv,
                    "prepare_quorum_us": p.prepare_quorum_at,
                    "prepare_completer": p.prepare_completer,
                    "commit_quorum_us": p.commit_quorum_at,
                    "commit_completer": p.commit_completer,
                    "finalized_us": p.finalized_at,
                    "verify_us": p.verify_us,
                    "drain_us": p.drain_us,
                }
                for node, p in sorted(self.nodes.items())
            },
        }


def _phase_split(tl: HeightTimeline, p: NodePhases) -> dict:
    """The critical node's time split, each leg in µs (None = unknown)."""

    def gap(a, b):
        return (b - a) if (a is not None and b is not None) else None

    return {
        "proposal_broadcast_us": gap(tl.proposal_sent, p.proposal_recv),
        "prepare_wait_us": gap(p.proposal_recv, p.prepare_quorum_at),
        "commit_wait_us": gap(p.prepare_quorum_at, p.commit_quorum_at),
        "finalize_tail_us": gap(p.commit_quorum_at, p.finalized_at),
        "verify_us": p.verify_us,
        "drain_us": p.drain_us,
        "wakeup_us": p.wakeup_us(),
        "total_us": gap(tl.proposal_sent, p.finalized_at),
        "prepare_completer": p.prepare_completer,
        "commit_completer": p.commit_completer,
    }


def reconstruct(
    events: Iterable[Event], *, quorum: Optional[int] = None
) -> List[HeightTimeline]:
    """Merged events -> one :class:`HeightTimeline` per finalized height.

    ``quorum`` defaults to :func:`default_quorum` over the number of
    distinct consensus tracks observed (equal voting powers; pass the
    exact value for weighted sets).
    """
    events = list(events)
    sends: Dict[int, List[Event]] = {}
    recvs: Dict[int, List[Event]] = {}
    seq_done: Dict[Tuple[str, int], int] = {}
    seq_start: Dict[Tuple[str, int], int] = {}
    # Consensus tracks are derived from ENGINE evidence only — outbound
    # net.send instants and sequence boundaries.  net.recv events may
    # additionally land on transport diagnostics tracks (an unnamed
    # GrpcTransport records wire-boundary recvs on ``net-<addr>``); those
    # must neither count as nodes (they would inflate the derived quorum)
    # nor contribute quorum points, so recvs are filtered to consensus
    # tracks below.
    consensus_tracks: set = set()
    busy_by_track: Dict[str, List[Event]] = {}
    for e in events:
        h = e.args.get("height")
        if e.name == "net.send" and h is not None:
            sends.setdefault(h, []).append(e)
            consensus_tracks.add(e.track)
        elif e.name == "net.recv" and h is not None:
            recvs.setdefault(h, []).append(e)
        elif e.name == "sequence.done" and h is not None:
            seq_done[(e.track, h)] = e.ts
            consensus_tracks.add(e.track)
        elif e.name == "sequence.start" and h is not None:
            seq_start[(e.track, h)] = e.ts
            consensus_tracks.add(e.track)
        elif e.ph == "X" and e.name in _VERIFY_SPANS | _DRAIN_SPANS:
            busy_by_track.setdefault(e.track, []).append(e)
    n = len(consensus_tracks)
    k = quorum if quorum is not None else default_quorum(max(1, n))

    heights = sorted(set(sends) | set(recvs))
    out: List[HeightTimeline] = []
    for h in heights:
        h_sends = sends.get(h, [])
        h_recvs = recvs.get(h, [])
        proposals = [e for e in h_sends if e.args.get("type") == _PREPREPARE]
        proposer = min(proposals, key=lambda e: e.ts).track if proposals else None
        proposal_sent = min((e.ts for e in proposals), default=None)
        tl = HeightTimeline(height=h, proposer=proposer, proposal_sent=proposal_sent)

        by_node: Dict[str, List[Event]] = {}
        for e in h_recvs:
            if e.track in consensus_tracks:
                by_node.setdefault(e.track, []).append(e)
        for node in consensus_tracks:
            p = NodePhases(node=node)
            node_recvs = sorted(by_node.get(node, []), key=lambda e: e.ts)
            prop = [e for e in node_recvs if e.args.get("type") == _PREPREPARE]
            if prop:
                p.proposal_recv = prop[0].ts
            elif node == proposer:
                p.proposal_recv = proposal_sent
            p.prepare_quorum_at, p.prepare_completer = _quorum_point(
                node_recvs, _PREPARE, k
            )
            p.commit_quorum_at, p.commit_completer = _quorum_point(
                node_recvs, _COMMIT, k
            )
            p.finalized_at = seq_done.get((node, h))
            # Busy-time attribution inside the node's height window
            # (pre-bucketed by track: a 30-node soak trace must not cost
            # O(nodes x heights x total_events) rescans).
            lo = seq_start.get((node, h), p.proposal_recv)
            hi = p.finalized_at
            if lo is not None and hi is not None:
                for e in busy_by_track.get(node, ()):
                    if e.ts < lo or e.ts > hi:
                        continue
                    if e.name in _VERIFY_SPANS:
                        p.verify_us += e.dur
                    else:
                        p.drain_us += e.dur
                    if (
                        p.commit_quorum_at is not None
                        and e.ts >= p.commit_quorum_at
                    ):
                        p._busy_after_commit += e.dur
            if node_recvs or p.finalized_at is not None or node == proposer:
                tl.nodes[node] = p
        out.append(tl)
    return out


def _quorum_point(
    node_recvs: Sequence[Event], msg_type: int, k: int
) -> Tuple[Optional[int], Optional[str]]:
    """(ts, origin) of the k-th DISTINCT-origin arrival of ``msg_type``.

    First arrival per origin counts (chaos duplication and future-buffer
    re-records are later by construction); for PREPARE the proposer never
    sends one, so its own implicit prepare is not modeled — quorum here
    means k prepare *messages*, matching the engine's message-count
    semantics for equal powers.
    """
    seen: set = set()
    for e in node_recvs:
        if e.args.get("type") != msg_type:
            continue
        origin = e.args.get("origin")
        if origin in seen:
            continue
        seen.add(origin)
        if len(seen) >= k:
            return e.ts, origin
    return None, None


def render_report(timelines: Sequence[HeightTimeline]) -> str:
    """Human-readable per-height critical-path report."""
    lines: List[str] = []
    for tl in timelines:
        crit = tl.critical_node
        lines.append(f"height {tl.height}")
        lines.append(f"  proposer          {tl.proposer or '?'}")
        if crit is None:
            lines.append("  (no node finalized this height in the trace window)")
            continue
        split = _phase_split(tl, crit)

        def ms(v):
            return "?" if v is None else f"{v / 1000:.3f}ms"

        lines.append(
            f"  critical node     {crit.node}  (finalized last, "
            f"total {ms(split['total_us'])})"
        )
        lines.append(
            f"    proposal broadcast {ms(split['proposal_broadcast_us'])}"
        )
        lines.append(
            f"    PREPARE quorum     {ms(split['prepare_wait_us'])}"
            f"  completed by {split['prepare_completer'] or '?'}"
        )
        lines.append(
            f"    COMMIT quorum      {ms(split['commit_wait_us'])}"
            f"  completed by {split['commit_completer'] or '?'}"
        )
        lines.append(
            f"    finalize tail      {ms(split['finalize_tail_us'])}"
            f"  (verify {ms(split['verify_us'])}, drain {ms(split['drain_us'])},"
            f" wakeup {ms(split['wakeup_us'])})"
        )
        waterfall = sorted(
            (p.finalized_at, node)
            for node, p in tl.nodes.items()
            if p.finalized_at is not None
        )
        if waterfall:
            base = waterfall[0][0]
            order = ", ".join(
                f"{node} +{(ts - base) / 1000:.3f}ms" for ts, node in waterfall
            )
            lines.append(f"  finalize waterfall  {order}")
    return "\n".join(lines)


def to_perfetto(traces: Sequence[TraceFile]) -> dict:
    """Merged multi-node Perfetto document: one pid per source file (a
    ``process_name`` row each), tids per track — N single-node exports
    render as N labeled process groups on one aligned clock."""
    events: List[dict] = []
    merged_by_file: Dict[str, List[Event]] = {}
    for event in merge_events(traces):
        merged_by_file.setdefault(event.source, []).append(event)
    dropped = 0
    for pid, trace_file in enumerate(traces):
        dropped += trace_file.dropped
        events.append(
            {
                "ph": "M",
                "pid": pid,
                "tid": 0,
                "name": "process_name",
                "args": {"name": trace_file.node or trace_file.path},
            }
        )
        tids: Dict[str, int] = {}
        for event in merged_by_file.get(trace_file.path, []):
            tid = tids.get(event.track)
            if tid is None:
                tid = tids[event.track] = len(tids)
                events.append(
                    {
                        "ph": "M",
                        "pid": pid,
                        "tid": tid,
                        "name": "thread_name",
                        "args": {"name": event.track},
                    }
                )
            rendered = {
                "ph": event.ph,
                "pid": pid,
                "tid": tid,
                "name": event.name,
                "cat": "obs",
                "ts": event.ts,
                "args": event.args,
            }
            if event.ph == "X":
                rendered["dur"] = event.dur
            elif event.ph == "i":
                rendered["s"] = "t"
            events.append(rendered)
    return {
        "displayTimeUnit": "ms",
        "otherData": {
            "droppedRecords": dropped,
            "sources": [t.path for t in traces],
        },
        "traceEvents": events,
    }


def merge_device_trace(
    doc: dict,
    device_trace_path: str,
    *,
    host_anchor_us: Optional[int] = None,
    keep_python_frames: bool = False,
) -> dict:
    """Merge a device profiler's Chrome trace into a host trace document.

    ``doc`` is a flight-recorder export (``obs/export.py``) or a
    :func:`to_perfetto` merge; ``device_trace_path`` is a Chrome trace
    such as ``torch.profiler``'s ``export_chrome_trace`` writes (``.json``,
    or gzipped ``.json.gz``).  The device events land as extra
    process groups (pids above the host ones, each ``process_name``
    prefixed ``device:``) so one Perfetto load shows consensus phases
    over host spans over device ops — the cost-ledger drill-down view.

    Clock alignment: device timestamps are relative to the profiler's
    start; ``host_anchor_us`` (the capture's anchor — the flight
    recorder's monotonic µs clock read when the profiler started) minus
    the document's ``otherData.clockBaseUs`` rebases them onto the host
    document's clock.  Without either anchor the device group merges
    unshifted, ordered internally but not aligned (flagged in
    ``otherData.deviceTraceAligned``).

    The profiler's Python-frame events (names starting ``$``) duplicate
    what the flight recorder's spans already show and dominate the file
    size; they are dropped unless ``keep_python_frames``.  Mutates and
    returns ``doc``.
    """
    import gzip

    opener = gzip.open if device_trace_path.endswith(".gz") else open
    with opener(device_trace_path, "rt") as fh:
        device_doc = json.load(fh)

    other = doc.setdefault("otherData", {})
    base = other.get("clockBaseUs")
    shift = 0
    aligned = host_anchor_us is not None and base is not None
    if aligned:
        shift = int(host_anchor_us) - int(base)

    events = doc.setdefault("traceEvents", [])
    pid_base = max((e.get("pid", 0) for e in events), default=0) + 1
    pid_map: Dict[int, int] = {}
    merged = 0
    for e in device_doc.get("traceEvents", []):
        ph = e.get("ph")
        pid = e.get("pid", 0)
        if pid not in pid_map:
            pid_map[pid] = pid_base + len(pid_map)
        out = dict(e)
        out["pid"] = pid_map[pid]
        if ph == "M":
            if e.get("name") == "process_name":
                args = dict(e.get("args", {}))
                args["name"] = f"device:{args.get('name', pid)}"
                out["args"] = args
            events.append(out)
            continue
        if ph != "X":
            continue
        name = e.get("name", "")
        if name.startswith("$") and not keep_python_frames:
            continue
        out["ts"] = e.get("ts", 0) + shift
        out.setdefault("cat", "device")
        events.append(out)
        merged += 1
    other["deviceTrace"] = device_trace_path
    other["deviceTraceAligned"] = aligned
    other["deviceTraceEvents"] = merged
    return doc
