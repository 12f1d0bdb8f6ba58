"""The benchmark's instruments at two of the program's seams, and the faults
its tests plant there.

* :class:`RecordingVerifier` stands between a caller (the engine, or a
  ``SyncClient``) and the verifier it was given, and keeps every verdict the
  program returned with what it was asked: the answers that the plain
  reference judges after the window.
* :class:`RecordingDispatcher` stands between the ``TenantScheduler`` and
  its ``CoalescedDispatcher`` (the scheduler's ``dispatcher`` argument) and
  keeps the signatures of every lane that a flush took to the card, so that
  a verdict served from anywhere else shows.

Both pass every other attribute through, and record only while ``on`` is
set (the measured window).  Recording keeps references and a copy of each
verdict array, no work the program would not do.

A fault (:data:`FAULTS`) breaks the path underneath on purpose, so that a
test can see ``correct`` come out false; the benchmark's own runs plant
none.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

# Faults a test plants (``run.py --fault``), each at the seam named:
#   flip        - an answer altered where it is produced: the last verdict of
#                 every call of two lanes or more inverted;
#   half        - half of the batch left out: the second half of each call's
#                 lanes never verified, its verdicts copied from the first
#                 half's;
#   stale       - a step that returns its state unchanged: each call answers
#                 with the previous call's verdicts;
#   reject_all  - an answer altered where it is produced: every verdict false
#                 (no quorum forms, so heights stall);
#   alter_block - an answer altered where it is produced: the finalized
#                 block's last proposal byte flipped before it is persisted;
#   accept_all  - the control: every committed seal accepted unverified (the
#                 guarantee that no invalid or Byzantine seal finalizes);
#   skip_wal    - the control: finalized heights not written to the log (the
#                 guarantee that a height is durable before the next starts);
#   no_fsync    - the control: finalize records written to the log but not
#                 synced (the same guarantee, against a crash of the machine);
#   skip_verify - the control: the engine's committed seals never verified,
#                 every one answered valid at the verifier's seam and never
#                 taken to the card (the guarantee that every signature that
#                 counts toward a quorum is verified).
FAULTS = ("flip", "half", "stale", "reject_all", "alter_block", "accept_all", "skip_wal", "no_fsync",
          "skip_verify")
# The faults planted at a verifier or dispatcher seam.
VERDICT_FAULTS = ("flip", "half", "stale", "reject_all", "accept_all")


class _Planted:
    def __init__(self, fault: Optional[str]):
        self.fault = fault
        self.calls = 0
        self._last: List[np.ndarray] = []

    def answer(self, lanes: list, verify, kinds: List[int]) -> List[np.ndarray]:
        """Run ``verify(lanes) -> [mask, ...]`` with the fault applied;
        ``kinds`` gives, per returned mask, whether its lanes are seals (1)."""
        self.calls += 1
        fault = self.fault
        if fault == "half":
            keep = [part[: (len(part) + 1) // 2] for part in lanes]
            masks = verify(keep)
            out = []
            for part, m in zip(lanes, masks):
                m = np.asarray(m, dtype=bool)
                full = np.zeros(len(part), dtype=bool)
                full[: len(m)] = m
                for i in range(len(m), len(part)):
                    full[i] = m[i - len(m)] if len(m) else True
                out.append(full)
            return out
        if fault == "stale" and self._last and self.calls > 1:
            out = []
            for part, last in zip(lanes, self._last):
                full = np.ones(len(part), dtype=bool)
                n = min(len(part), len(last))
                full[:n] = last[:n]
                out.append(full)
            return out
        masks = [np.array(m, dtype=bool) for m in verify(lanes)]
        if fault == "stale":
            self._last = [m.copy() for m in masks]
        if fault == "flip":
            for m in masks:
                if len(m) >= 2:
                    m[-1] = ~m[-1]
                    break
        if fault == "accept_all":
            for m, kind in zip(masks, kinds):
                if kind:
                    m[:] = True
        if fault == "reject_all":
            for m in masks:
                m[:] = False
        return masks


class RecordingVerifier:
    """A verifier as its caller sees it, with every verdict recorded.

    ``log`` receives ``(kind, height, proposal_hash, signatures, claimed,
    mask)`` per call: ``kind`` is ``senders`` (``height`` and
    ``proposal_hash`` None), ``seals``, or ``seal_lanes`` (``proposal_hash``
    then a list of ``(lane, proposal hash, signer)`` probes, ``claimed``
    None)."""

    def __init__(self, inner, fault: Optional[str] = None, pass_no: Optional[int] = None,
                 skip_seals: bool = False):
        self._inner = inner
        self.log: list = []
        self.on = False
        self.pass_no = pass_no
        self._planted = _Planted(fault if fault in VERDICT_FAULTS else None)
        self._skip_seals = skip_seals  # the fault skip_verify

    def __getattr__(self, name):
        return getattr(self._inner, name)

    def verify_senders(self, msgs):
        msgs = list(msgs)
        (mask,) = self._planted.answer([msgs], lambda parts: [self._inner.verify_senders(parts[0])], [0])
        if self.on:
            self.log.append(("senders", None, None, [m.signature for m in msgs], [m.sender for m in msgs],
                             np.array(mask, dtype=bool)))
        return mask

    def verify_committed_seals(self, proposal_hash, seals, height):
        seals = list(seals)
        if self._skip_seals:
            return np.ones(len(seals), dtype=bool)
        (mask,) = self._planted.answer(
            [seals], lambda parts: [self._inner.verify_committed_seals(proposal_hash, parts[0], height)], [1])
        if self.on:
            self.log.append(("seals", height, proposal_hash, [s.signature for s in seals],
                             [s.signer for s in seals], np.array(mask, dtype=bool)))
        return mask

    def verify_seal_lanes(self, lanes, height):
        lanes = list(lanes)
        (mask,) = self._planted.answer(
            [lanes], lambda parts: [self._inner.verify_seal_lanes(parts[0], height)], [1])
        if self.on:
            # Every lane's signature, and every 256th lane's proposal hash and
            # signer: a range is tens of thousands of lanes, and keeping the
            # program's lane tuples would make the collector's work grow
            # through the window.
            probes = [(i, lanes[i][0], lanes[i][1].signer) for i in range(0, len(lanes), 256)]
            self.log.append(("seal_lanes", height, probes, [seal.signature for _h, seal in lanes], None,
                             np.array(mask, dtype=bool)))
        return mask


class RecordingDispatcher:
    """A ``CoalescedDispatcher`` whose flushes are recorded: ``log`` gets
    ``(tag, sender signatures, seal signatures)`` a flush, ``tag`` being
    what the benchmark set last (the pass of a live run)."""

    def __init__(self, inner, fault: Optional[str] = None):
        self._inner = inner
        self.log: list = []
        self.on = False
        self.tag = None
        self._planted = _Planted(fault if fault in VERDICT_FAULTS else None)

    def __getattr__(self, name):
        return getattr(self._inner, name)

    def dispatch(self, sender_msgs, seal_lanes, pack_caches=None):
        sender_msgs, seal_lanes = list(sender_msgs), list(seal_lanes)
        carried: list = []

        def verify(parts):
            carried.append(parts)
            return list(self._inner.dispatch(parts[0], parts[1], pack_caches))

        sender_ok, seal_ok = self._planted.answer([sender_msgs, seal_lanes], verify, [0, 1])
        if self.on:
            for msgs, lanes in carried:
                self.log.append((self.tag, [m.signature for m in msgs], [s.signature for _h, s in lanes]))
        return sender_ok, seal_ok
