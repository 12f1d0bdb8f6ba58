"""What decides ``correct``: the program's answers in the window against the
plain reference's, each count beside its limit.

Every count is of things that must not happen, so every limit is 0 (an
exact comparison).  The reference (:mod:`portbench.reference`) works out
from the pool's signed bytes alone whether each signature recovers to the
address it claims and that address is a member; everything the program
answered in the window is judged against that:

Live cells (one validator's stack):
  verdicts_wrong    lanes where a verdict the program gave its engine
                    differs from the reference's (or where the lane it was
                    asked about is not one the traffic sent);
  finalized_wrong   finalized heights with another proposal than the one
                    proposed, a seal the reference rejects or that belongs
                    to another height, or seal power below the quorum;
  wal_wrong         finalized heights whose record the log does not replay
                    exactly, and records of heights that never finalized;
  wal_unsynced      finalized heights whose finalize record lay beyond the
                    log's synced bytes when the runner handed the height on,
                    and heights whose COMMIT the engine sent before its lock
                    record (the prepared certificate) was synced: what a
                    crash of the machine would lose;
  heights_stalled   heights that did not finalize in time;
  lanes_off_card    signatures verified in a pass that no flush of that pass
                    took to the card, plus flushes served on the host;
  counted_off_card  signatures that counted toward a finalized height (its
                    committed seals, the COMMIT envelopes that carried them,
                    the PREPREPARE and PREPAREs of its prepared certificate
                    in the log) that no flush of its pass took to the card:
                    a program that never asked its verifier shows here.
Sync cells (catch-up):
  verdicts_wrong    as above, over every lane of every range (the proposal
                    hash and signer the program was asked about, on every
                    256th lane);
  ranges_wrong      ranges accepted that the reference refuses, or refused
                    that it accepts;
  lanes_off_card    (on the card) recovery launches short of what the
                    window's lanes need at the program's largest batch.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Tuple

from ..reference import keccak as ref_keccak
from ..reference import verdicts as ref_verdicts
from . import wire


def _reference(pool, signatures, workers: int) -> Dict[bytes, bool]:
    members = set(pool.committee.addresses)
    lanes = [pool.lanes[s] for s in signatures if s in pool.lanes]
    keys = dict(zip(pool.committee.addresses, pool.committee.keys))
    ok = ref_verdicts.verdicts([(ln.signed, ln.signature, ln.claimed) for ln in lanes], members, workers, keys)
    return {ln.signature: v for ln, v in zip(lanes, ok)}


def _proposal_hashes(raws: List[bytes]) -> List[bytes]:
    return ref_keccak.keccak256_many([wire.proposal(raw, 0) for raw in raws])


def _log_lines(path: str):
    """The log's records as written, each with the offset at which its
    line ends: ``{height: end}`` of the first finalize record of each height,
    and ``{height: (end, certificate signatures)}`` of the first lock record."""
    from go_ibft_tpu_torch.messages.wire import PreparedCertificate

    finals: Dict[int, int] = {}
    locks: Dict[int, tuple] = {}
    if not os.path.exists(path):  # nothing was ever appended
        return finals, locks
    with open(path, "rb") as fh:
        data = fh.read()
    end = 0
    for line in data.split(b"\n"):
        end += len(line) + 1
        if not line.strip() or end > len(data):
            continue
        rec = json.loads(line)
        h = int(rec.get("height", 0))
        if rec.get("kind") == "finalize":
            finals.setdefault(h, end)
        elif rec.get("kind") == "lock" and h not in locks:
            sigs = []
            if rec.get("pc"):
                pc = PreparedCertificate.decode(bytes.fromhex(rec["pc"]))
                msgs = [pc.proposal_message] + list(pc.prepare_messages or ())
                sigs = [m.signature for m in msgs if m is not None]
            locks[h] = (end, sigs)
    return finals, locks


def judge_live(cell, win, workers: int) -> Tuple[Dict[str, int], List[str]]:
    from ..generators.live import read_wal

    pool = cell.pool
    notes: List[str] = []
    calls = [(v.pass_no, call) for v in cell.verifiers for call in v.log]
    offered = set()
    for _p, (_kind, _h, _ph, sigs, _claimed, _mask) in calls:
        offered.update(sigs)
    finalized_sigs = {sig for f in win.finalized for _s, sig in f.seals}
    verdict = _reference(pool, offered | finalized_sigs, workers)
    phash = dict(zip([hp.height for hp in pool.heights], _proposal_hashes([hp.raw for hp in pool.heights])))

    verdicts_wrong = 0
    for _p, (kind, height, proposal_hash, sigs, claimed, mask) in calls:
        for sig, who, ok in zip(sigs, claimed, mask):
            lane = pool.lanes.get(sig)
            if lane is None or who != lane.claimed or bool(ok) != verdict[sig]:
                verdicts_wrong += 1
            elif kind == "seals" and (lane.kind != "seal" or height != lane.height
                                      or proposal_hash != phash[lane.height]):
                verdicts_wrong += 1
    if verdicts_wrong:
        notes.append(f"{verdicts_wrong} verdicts differ from the reference's")

    bad = {pool.committee.addresses[i] for i in pool.bad}
    finalized_wrong = 0
    for f in win.finalized:
        hp = pool.heights[f.height - 1]
        wrong = f.raw != hp.raw or f.round != 0
        for signer, sig in f.seals:
            lane = pool.lanes.get(sig)
            if (lane is None or lane.kind != "seal" or lane.height != f.height or lane.claimed != signer
                    or not verdict.get(sig, False) or signer in bad):
                wrong = True
        power = sum(pool.committee.powers.get(s, 0) for s in {s for s, _sig in f.seals})
        if power < pool.committee.quorum:
            wrong = True
        finalized_wrong += wrong
    if finalized_wrong:
        notes.append(f"{finalized_wrong} finalized heights are wrong")

    wal_wrong = 0
    for pass_no, path in win.wal_paths.items():
        logged = {rec[0]: rec for rec in read_wal(path)}
        mine = {f.height: (f.height, f.raw, f.round, f.seals) for f in win.finalized if f.pass_no == pass_no}
        for h in set(logged) | set(mine):
            if logged.get(h) != mine.get(h):
                wal_wrong += 1
    if wal_wrong:
        notes.append(f"{wal_wrong} heights differ between the log and what finalized")

    logs = {pass_no: _log_lines(path) for pass_no, path in win.wal_paths.items()}
    wal_unsynced = 0
    for f in win.finalized:
        finals, locks = logs.get(f.pass_no, ({}, {}))
        end = finals.get(f.height)
        if end is None or end > f.synced:
            wal_unsynced += 1
        sent = win.commit_synced.get((f.pass_no, f.height))
        if sent is not None and (f.height not in locks or locks[f.height][0] > sent):
            wal_unsynced += 1
    if wal_unsynced:
        notes.append(f"{wal_unsynced} finalize or lock records were not synced when the height moved on")

    lanes_off_card = cell.host_routes()
    dispatched: Dict[int, set] = {}
    for pass_no, senders, seals in cell.dispatcher.log:
        dispatched.setdefault(pass_no, set()).update(senders, seals)
    for pass_no, (_kind, _h, _ph, sigs, _claimed, _mask) in calls:
        seen = dispatched.get(pass_no, set())
        lanes_off_card += sum(1 for s in set(sigs) if s not in seen)
    if lanes_off_card:
        notes.append(f"{lanes_off_card} lanes were not recovered on the card in their pass")

    counted_off_card = 0
    for f in win.finalized:
        seen = dispatched.get(f.pass_no, set())
        carriers = pool.heights[f.height - 1].carriers
        counted = {sig for _s, sig in f.seals}
        counted |= {carriers[sig] for _s, sig in f.seals if sig in carriers}
        counted |= set(logs.get(f.pass_no, ({}, {}))[1].get(f.height, (0, ()))[1])
        counted_off_card += sum(1 for s in counted if s not in seen)
    if counted_off_card:
        notes.append(f"{counted_off_card} signatures counted toward finalized heights were never taken to the card")
    checks = {
        "verdicts_wrong": verdicts_wrong,
        "finalized_wrong": finalized_wrong,
        "wal_wrong": wal_wrong,
        "wal_unsynced": wal_unsynced,
        "heights_stalled": win.stalled,
        "lanes_off_card": lanes_off_card,
        "counted_off_card": counted_off_card,
    }
    return checks, notes


def judge_sync(cell, win, workers: int, on_card: bool, largest_batch: int) -> Tuple[Dict[str, int], List[str]]:
    pool = cell.pool
    notes: List[str] = []
    calls = list(cell.verifier.log)
    offered = {sig for _kind, _h, _probes, sigs, _c, _m in calls for sig in sigs}
    verdict = _reference(pool, offered | {bad for _k, _j, bad in pool.tampered}, workers)
    signed = sorted({ln.signed for ln in pool.lanes.values()})
    hashes = dict(zip(signed, ref_keccak.keccak256_many(signed)))

    verdicts_wrong = 0
    needed_launches = 0
    for _kind, _height, probes, sigs, _c, mask in calls:
        needed_launches += -(-len(sigs) // largest_batch)
        for sig, ok in zip(sigs, mask):
            if sig not in pool.lanes or bool(ok) != verdict[sig]:
                verdicts_wrong += 1
        for i, proposal_hash, signer in probes:
            lane = pool.lanes.get(sigs[i])
            if lane is not None and (signer != lane.claimed or proposal_hash != hashes[lane.signed]):
                verdicts_wrong += 1
    if verdicts_wrong:
        notes.append(f"{verdicts_wrong} seal verdicts differ from the reference's")

    q = len(pool.proposals)
    quorum = pool.committee.quorum
    clean_ok = [sum(verdict[s] for _a, s in seals) >= quorum for seals in pool.seals]
    ranges_wrong = 0
    for req in win.requests:
        expect = all(clean_ok[(h - 1) % q] for h in range(req.start, req.start + req.heights))
        if req.tampered is not None:
            h, j, bad_sig = req.tampered
            seals = list(pool.seals[(h - 1) % q])
            seals[j] = (seals[j][0], bad_sig)
            expect = expect and sum(verdict[s] for _a, s in seals) >= quorum
        if req.accepted != expect:
            ranges_wrong += 1
            notes.append(f"range from {req.start}: accepted {req.accepted}, the reference says {expect} "
                         f"({req.error[:200]})")
    checks = {"verdicts_wrong": verdicts_wrong, "ranges_wrong": ranges_wrong}
    if on_card:
        checks["lanes_off_card"] = max(0, needed_launches - win.launches)
        if checks["lanes_off_card"]:
            notes.append(f"{win.launches} recovery launches where the window's lanes need {needed_launches}")
    return checks, notes

