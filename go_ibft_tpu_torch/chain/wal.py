"""Write-ahead log: crash-durable chain state for one validator node (the
port of the JAX package's ``chain/wal.py``: the same records, byte for byte).

go-ibft leaves persistence entirely to the embedder (SURVEY §1 — the
reference's ``Backend.InsertProposal`` is the last it ever hears of a
finalized block).  A continuously-running node needs two durable facts to
restart safely:

* **Finalized heights** — ``(height, proposal, committed seals)``,
  appended with ``fsync`` BEFORE the engine prunes the height's quorum
  evidence from the message store (the finalize -> WAL append -> prune
  ordering enforced in ``core/ibft.py::_insert_block``).  A crash between
  any two steps never loses a finalized height: before the append the
  un-pruned store still carries the commit quorum, after it the height is
  on disk.
* **The in-flight lock** — the prepared certificate pinned when a prepare
  quorum lands (``IBFT.on_lock``).  A validator that sent COMMIT for a
  proposal and then crashed must NOT restart as a blank slate: round 0 of
  a re-run could prepare a *different* proposal for the same height —
  equivocation.  Replaying the lock lets ``ChainRunner.recover()`` re-enter
  the height mid-round with the certificate intact
  (``IBFT.run_sequence(..., restore=)``).

Format: append-only JSONL, one record per line, all message payloads
serialized through the wire codec (:mod:`go_ibft_tpu_torch.messages.wire`) as
hex — a ``Proposal`` / ``PreparedCertificate`` round-trips bit-identically
through ``encode``/``decode``, so a recovered lock carries the exact
signed messages it was built from.  Replay tolerates a torn tail (a crash
mid-append leaves at most one partial final line, which is dropped) but
refuses interior corruption — a damaged middle record means the file is
not the log this code wrote, and silently skipping it could resurrect an
equivocation.

Finalize records carrying an aggregate quorum certificate
(:mod:`go_ibft_tpu_torch.crypto.quorum_cert`) and epoch ``checkpoint``
records (:mod:`go_ibft_tpu_torch.lightsync.checkpoint`) are written and
replayed as the JAX package does.
"""

from __future__ import annotations

import json
import os
import threading
import time
from dataclasses import dataclass, field
from typing import List, Optional

from ..messages.helpers import CommittedSeal
from ..messages.wire import PreparedCertificate, Proposal
from ..obs import trace
from ..utils import metrics

# Fixed-bucket append latency (fsync included) for the /metrics endpoint;
# recorded only while metrics.enable_fixed_histograms() is on.
WAL_APPEND_MS_KEY = ("go-ibft", "latency", "wal_append_ms")

__all__ = [
    "FinalizedBlock",
    "WalCorruptionError",
    "WalLock",
    "WalState",
    "WriteAheadLog",
]


class WalCorruptionError(ValueError):
    """An interior (non-tail) WAL record failed to parse."""


@dataclass
class FinalizedBlock:
    """One durable chain entry: what ``InsertProposal`` received.

    ``cert`` (an :class:`~go_ibft_tpu_torch.crypto.quorum_cert.
    AggregateQuorumCertificate`) is the O(1) alternative to ``seals``: a
    block finalized — or compressed at persist time — under the
    aggregate-COMMIT mode carries ONE aggregated G2 seal plus a signer
    bitmap instead of N individual seals, and every consumer (WAL replay,
    block-sync verification) re-checks it with ONE pairing equation.
    The two evidence forms are mutually exclusive: ``append_finalize``
    writes an empty seal list whenever a certificate rides, and the sync
    client REJECTS a peer-served block carrying both (a seal list next to
    a certificate would bypass seal verification entirely).
    """

    height: int
    proposal: Proposal
    seals: List[CommittedSeal] = field(default_factory=list)
    cert: Optional[object] = None


@dataclass
class WalLock:
    """The in-flight prepared-certificate lock for an unfinished height."""

    height: int
    round: int
    certificate: Optional[PreparedCertificate] = None


@dataclass
class WalState:
    """Replay result: the durable chain plus the live lock (if any).

    ``checkpoints`` are the epoch checkpoint records
    (:class:`~go_ibft_tpu_torch.lightsync.checkpoint.CheckpointRecord`) the
    node built at epoch boundaries — replayed so a restarted node serves
    its skip chain without re-signing history.
    """

    blocks: List[FinalizedBlock] = field(default_factory=list)
    lock: Optional[WalLock] = None
    dropped_tail: bool = False
    checkpoints: List[object] = field(default_factory=list)

    @property
    def next_height(self) -> int:
        """First height NOT finalized in the log (1 for an empty log)."""
        return self.blocks[-1].height + 1 if self.blocks else 1


class WriteAheadLog:
    """Append-only JSONL log with fsync-on-finalize durability.

    Thread-safe (the engine loop appends locks while a sync catch-up may
    append finalized blocks from an executor thread).  ``fsync_locks``
    defaults True — the kill -9 recovery contract covers the mid-round
    lock, not just finalized heights; a deployment that accepts losing the
    lock on power failure (process crash still keeps it via the OS page
    cache) can turn the per-round fsync off.
    """

    def __init__(self, path: str, *, fsync_locks: bool = True) -> None:
        self.path = str(path)
        self._fsync_locks = fsync_locks
        self._lock = threading.Lock()
        self._fh = None
        self._tail_sanitized = False

    # -- appends --------------------------------------------------------

    def _sanitize_tail_locked(self) -> None:
        """Cut any torn final line BEFORE the first append (callers hold
        the lock).  A crash mid-append leaves partial bytes with no
        newline; appending blindly would merge the next record into one
        unparseable INTERIOR line, permanently poisoning the log — and
        nothing forces an embedder to run replay()/recover() (which also
        truncates) before appending."""
        if self._tail_sanitized:
            return
        self._tail_sanitized = True
        if not os.path.exists(self.path):
            return
        with open(self.path, "r+b") as fh:
            data = fh.read()
            if not data or data.endswith(b"\n"):
                return
            keep = data.rfind(b"\n") + 1  # 0 when the only line is torn
            fh.truncate(keep)
            fh.flush()
            os.fsync(fh.fileno())

    def _file(self):
        if self._fh is None or self._fh.closed:
            self._sanitize_tail_locked()
            self._fh = open(self.path, "ab")
        return self._fh

    def _append(self, record: dict, fsync: bool) -> None:
        line = json.dumps(record, separators=(",", ":")) + "\n"
        t0 = (
            time.perf_counter()
            if metrics.fixed_histograms_enabled()
            else None
        )
        with self._lock:
            fh = self._file()
            fh.write(line.encode())
            fh.flush()
            if fsync:
                ts = trace.now_us()
                os.fsync(fh.fileno())
                if ts is not None:
                    trace.complete("wal.fsync", ts, kind=record.get("kind"))
        if t0 is not None:
            metrics.observe_fixed(
                WAL_APPEND_MS_KEY, (time.perf_counter() - t0) * 1e3
            )

    def append_finalize(
        self,
        height: int,
        proposal: Proposal,
        seals: List[CommittedSeal],
        cert=None,
    ) -> None:
        """Durably record one finalized height (fsync before returning).

        ``cert`` (an AggregateQuorumCertificate) replaces the per-seal
        list on disk: the finalize record becomes O(1) in committee size
        — 240 bytes + 1 bitmap bit per validator instead of one 192-byte
        seal each — and replay hands the certificate back for one-pairing
        re-verification instead of N seal lanes.
        """
        record = {
            "kind": "finalize",
            "height": height,
            "proposal": proposal.encode().hex(),
        }
        if cert is not None:
            record["cert"] = cert.encode().hex()
        record["seals"] = (
            []
            if cert is not None
            else [[s.signer.hex(), s.signature.hex()] for s in seals]
        )
        self._append(record, fsync=True)

    def append_lock(
        self, height: int, round_: int, certificate: Optional[PreparedCertificate]
    ) -> None:
        """Record the in-flight prepared-certificate lock for a height."""
        record = {"kind": "lock", "height": height, "round": round_}
        if certificate is not None:
            record["pc"] = certificate.encode().hex()
        self._append(record, fsync=self._fsync_locks)

    def append_checkpoint(self, record) -> None:
        """Durably record one epoch checkpoint (fsync — the record chains
        into every later epoch's skip links, so losing it would orphan the
        structure on restart).  ``record`` is a
        :class:`~go_ibft_tpu_torch.lightsync.checkpoint.CheckpointRecord`."""
        self._append(
            {
                "kind": "checkpoint",
                "epoch": record.epoch,
                "height": record.height,
                "rec": record.encode().hex(),
            },
            fsync=True,
        )

    def close(self) -> None:
        with self._lock:
            if self._fh is not None and not self._fh.closed:
                self._fh.close()

    # -- replay ---------------------------------------------------------

    @staticmethod
    def _parse(record: dict):
        kind = record["kind"]
        if kind == "finalize":
            cert_hex = record.get("cert")
            cert = None
            if cert_hex is not None:
                # Lazy import: the certificate codec pulls the BLS stack,
                # which plain ECDSA-seal WALs never need.
                from ..crypto.quorum_cert import AggregateQuorumCertificate

                cert = AggregateQuorumCertificate.decode(
                    bytes.fromhex(cert_hex)
                )
            return FinalizedBlock(
                height=int(record["height"]),
                proposal=Proposal.decode(bytes.fromhex(record["proposal"])),
                seals=[
                    CommittedSeal(
                        signer=bytes.fromhex(signer),
                        signature=bytes.fromhex(signature),
                    )
                    for signer, signature in record.get("seals", ())
                ],
                cert=cert,
            )
        if kind == "lock":
            pc_hex = record.get("pc")
            return WalLock(
                height=int(record["height"]),
                round=int(record["round"]),
                certificate=(
                    PreparedCertificate.decode(bytes.fromhex(pc_hex))
                    if pc_hex is not None
                    else None
                ),
            )
        if kind == "checkpoint":
            # Lazy import, like the certificate codec: checkpoint-less
            # WALs never pay for the lightsync stack.
            from ..lightsync.checkpoint import CheckpointRecord

            return CheckpointRecord.decode(bytes.fromhex(record["rec"]))
        raise ValueError(f"unknown WAL record kind {kind!r}")

    def _truncate_tail(self, data: bytes, torn: bytes) -> None:
        """Cut the torn final line off the file (fsynced, lock-guarded).

        ``torn`` is the last (partial) line of ``data``; everything before
        it is kept.  The file is re-read under the lock and only truncated
        if its tail still matches the snapshot — a concurrent append (which
        sanitizes the tail itself) must never lose fsynced records to a
        stale offset."""
        keep = data.rfind(torn)
        with self._lock:
            if self._fh is not None and not self._fh.closed:
                self._fh.close()
                self._fh = None
            with open(self.path, "r+b") as fh:
                if fh.read() != data:
                    return  # tail already repaired or log moved on
                fh.truncate(keep)
                fh.flush()
                os.fsync(fh.fileno())

    def replay(self) -> WalState:
        """Re-derive the durable state from the log.

        Finalized heights must be non-decreasing (a duplicate height —
        possible when a crash landed between the WAL append and the prune
        and block-sync re-delivered the block — keeps the FIRST, durable,
        record).  The returned lock is the latest lock record for a height
        that was never finalized; locks superseded by a finalize replay to
        nothing.
        """
        state = WalState()
        if not os.path.exists(self.path):
            return state
        with self._lock:
            with open(self.path, "rb") as fh:
                data = fh.read()
        raw_lines = data.split(b"\n")
        # A trailing newline yields one empty tail entry; drop empties at
        # the end but treat interior blank lines as corruption.
        while raw_lines and not raw_lines[-1].strip():
            raw_lines.pop()
        latest_lock: Optional[WalLock] = None
        for i, raw in enumerate(raw_lines):
            try:
                parsed = self._parse(json.loads(raw))
            except Exception as err:  # noqa: BLE001 - classified below
                if i == len(raw_lines) - 1:
                    # Torn tail: the crash interrupted the final append;
                    # everything before it is intact by the append-only
                    # discipline.  TRUNCATE the partial bytes now — left
                    # in place, the next append would merge with them
                    # into one unparseable line, and a later replay would
                    # either drop that line (losing a record whose fsync
                    # succeeded) or refuse the log as interior-corrupt.
                    state.dropped_tail = True
                    self._truncate_tail(data, raw)
                    break
                raise WalCorruptionError(
                    f"WAL record {i} of {self.path} is corrupt: {err}"
                ) from err
            if isinstance(parsed, FinalizedBlock):
                if state.blocks and parsed.height <= state.blocks[-1].height:
                    continue  # duplicate/stale re-append: first write wins
                state.blocks.append(parsed)
            elif isinstance(parsed, WalLock):
                latest_lock = parsed
            else:  # checkpoint record (first write wins, like finalizes)
                if any(c.epoch == parsed.epoch for c in state.checkpoints):
                    continue
                state.checkpoints.append(parsed)
        if latest_lock is not None and (
            not state.blocks or latest_lock.height > state.blocks[-1].height
        ):
            state.lock = latest_lock
        return state
