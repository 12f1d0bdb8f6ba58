"""Drive the port's chain layer among a signed committee.

The shapes of the JAX package's two chain benchmarks (``bench.py``), at one
engine among ``bench/engine.py``'s :class:`~.engine.Committee` (real
secp256k1 keys from ``bench/workload.py``, one vote each, every message
signed before the clock starts):

* :func:`commit_critical_path` — ``config11_commit_critical_path``: one
  non-proposer engine runs heights against a scripted arrival schedule in
  which most of the COMMIT flood arrives before the proposal, then a gossip
  gap, the PREPREPARE and the PREPAREs, then the last COMMITs.  Run with
  ``speculate=False`` (no speculator, no COMMIT early exit) and ``True``
  (a :class:`~go_ibft_tpu_torch.verify.SpeculativeVerifier` and the early
  exit) on the same schedule;
* :class:`ChainFeeder` — ``config7_chain``'s mechanics for one validator: a
  :class:`~go_ibft_tpu_torch.chain.ChainRunner` with a WAL, the overlap
  worker and a speculator runs back-to-back heights while the feeder sends
  height H+1's PREPREPARE, PREPAREs and first COMMITs during H's COMMIT
  phase (so that the overlap worker has next-height envelopes to verify and
  the speculator early seals), then H's last COMMITs.  With tracing on it
  stamps each fed message with a trace context from its sender's track, so
  that ``obs/timeline.py`` reconstructs the heights;
* :func:`recover_runner` and :func:`sync_runner` — a fresh runner on the
  same WAL (``recover()``), and one with an empty WAL catching up from a
  peer through ``SyncClient`` over ``LoopbackSyncNetwork``;
* :func:`concurrent_drains` — several threads through one verifier, each
  with its own height's batches, every mask held against an expected mask;
* :func:`span_split` and :func:`phase_split` — a height's host time by span
  name, and the timeline's phase split, from a Chrome trace the runner
  exported.
"""

from __future__ import annotations

import asyncio
import dataclasses
import json
import statistics
import threading
import time
from typing import Callable, Dict, List, Sequence

import numpy as np

from ..chain import ChainRunner, FinalizedBlock, LoopbackSyncNetwork, SyncClient, WriteAheadLog
from ..core import IBFT, StateName
from ..crypto.backend import ECDSABackend
from ..messages.helpers import CommittedSeal
from ..messages.wire import TraceContext
from ..obs import timeline, trace
from ..utils import metrics
from ..verify import SpeculativeVerifier
from ..verify.batch import EARLY_EXIT_SKIPPED_KEY
from .engine import Committee, NullLogger, _Silent

# Every wait of a driven height: no round may expire on the card's schedule.
TIMEOUT_S = 120.0
# config #11's gossip gap between the early COMMIT flood and the proposal.
GAP_S = 0.08
# Calls of each of the two drains a thread makes in concurrent_drains.
THREAD_ITERATIONS = 50

# Span names a height's host time is split by (verify spans nest inside
# the engine's drains and ingress batches; each is summed on its own).
SPLIT_SPANS = (
    "chain.height", "chain.handoff", "chain.overlap", "ingress.batch", "proposal.drain",
    "prepare.drain", "commit.drain", "verify.drain", "verify.early_exit", "verify.pack",
    "verify.dispatch", "verify.device_wait", "verify.quorum", "verify.speculate",
)


async def _until(cond: Callable[[], bool], what: str) -> None:
    deadline = time.monotonic() + TIMEOUT_S
    while not cond():
        if time.monotonic() > deadline:
            raise TimeoutError(f"timed out waiting for {what}")
        await asyncio.sleep(0)


def proposer_free_validator(committee: Committee, heights: int) -> int:
    """The first validator that proposes none of heights ``1..heights`` at
    round 0 (a chain's driven validator never builds a proposal)."""
    proposers = {committee.proposer(h) for h in range(1, heights + 1)}
    return next(i for i in range(committee.n) if i not in proposers)


# -- the commit critical path ---------------------------------------------------


def commit_critical_path(
    committee: Committee,
    me: int,
    verifier,
    heights: Sequence[int],
    *,
    speculate: bool,
) -> dict:
    """One engine (validator ``me``) over ``heights`` on the config #11
    schedule: ⌊2n'/3⌋ of the n' COMMITs, a :data:`GAP_S` gossip gap, the
    PREPREPARE, the PREPAREs, the remaining COMMITs.  Returns the
    accept -> finalize times (host clock), what each height inserted, the
    speculator's counters and the early-exit lanes skipped."""
    backend = ECDSABackend(committee.keys[me], committee.src)
    speculator = SpeculativeVerifier(verifier) if speculate else None
    engine = IBFT(NullLogger(), backend, _Silent(), batch_verifier=verifier, speculator=speculator,
                  commit_early_exit=speculate)
    engine.set_base_round_timeout(TIMEOUT_S)
    accept: Dict[int, float] = {}
    final: Dict[int, float] = {}
    state = engine.state
    set_proposal = state.set_proposal_message

    def timed_set(message):
        if message is not None:
            accept.setdefault(state.height, time.perf_counter())
        set_proposal(message)

    state.set_proposal_message = timed_set
    engine.on_finalize = lambda h, p, s: final.setdefault(h, time.perf_counter())
    schedules = {h: committee.schedule(h) for h in heights}  # signed off the clock
    skipped = metrics.get_counter(EARLY_EXIT_SKIPPED_KEY)

    async def drive() -> None:
        for h in heights:
            pmsg, prepares, commits = schedules[h]
            cut = (2 * len(commits)) // 3
            seq = asyncio.create_task(engine.run_sequence(h))
            await asyncio.sleep(0)  # the engine enters the round
            engine.add_messages(commits[:cut])  # the flood ahead of the phase
            await asyncio.sleep(GAP_S)  # the gossip gap
            engine.add_message(pmsg)  # accept -> finalize starts here
            await asyncio.sleep(0)
            engine.add_messages(prepares)
            await asyncio.sleep(0)
            engine.add_messages(commits[cut:])
            await asyncio.wait_for(seq, TIMEOUT_S)

    try:
        asyncio.run(drive())
    finally:
        engine.messages.close()
        if speculator is not None:
            speculator.stop()  # on the card, raises the worker's first fault
    samples = [(final[h] - accept[h]) * 1e3 for h in heights]
    return {
        "accept_to_finalize_ms": samples,
        "median_ms": statistics.median(samples),
        "inserted": list(backend.inserted),
        "speculation": speculator.stats() if speculator is not None else None,
        "early_exit_lanes_skipped": metrics.get_counter(EARLY_EXIT_SKIPPED_KEY) - skipped,
    }


# -- the chain ------------------------------------------------------------------


class ChainFeeder:
    """One :class:`ChainRunner` for validator ``me`` of ``committee``, with
    a WAL at ``wal_path`` (fsync on), the overlap worker and a speculator;
    :meth:`run` feeds it heights back-to-back (see the module docstring)."""

    def __init__(self, committee: Committee, me: int, verifier, wal_path: str):
        self.committee = committee
        self.engine = IBFT(NullLogger(), ECDSABackend(committee.keys[me], committee.src), _Silent(),
                           batch_verifier=verifier)
        self.engine.set_base_round_timeout(TIMEOUT_S)
        self.speculator = SpeculativeVerifier(verifier)
        self.runner = ChainRunner(self.engine, WriteAheadLog(wal_path), speculator=self.speculator,
                                  overlap_poll_s=0.0005)

    def _send(self, msgs) -> None:
        """Deliver ``msgs`` as one ingress batch; with tracing on, first
        stamp each as its sender's engine would (``IBFT._multicast``)."""
        if trace.enabled():
            for m in msgs:
                origin = "node-" + bytes(m.sender).hex()[:16]
                ctx = TraceContext(origin=origin, height=m.view.height, round=m.view.round,
                                   sent_us=time.perf_counter_ns() // 1000, span_id=trace.next_span_id())
                m.trace_ctx = ctx
                trace.instant("net.send", track=origin, height=ctx.height, round=ctx.round,
                              type=int(m.type), span=ctx.span_id)
        self.engine.add_messages(msgs)

    def run(self, heights: int) -> dict:
        """Run heights ``1..heights``; returns the runner's evidence and the
        wall time (host clock)."""
        schedules = {h: self.committee.schedule(h) for h in range(1, heights + 2)}  # off the clock
        engine, runner = self.engine, self.runner

        def early(h):
            pmsg, prepares, commits = schedules[h]
            return [pmsg], prepares, commits[: len(commits) // 3]

        async def feed() -> None:
            for batch in early(1):
                self._send(batch)
            for h in range(1, heights + 1):
                await _until(lambda: engine.state.height == h and engine.state.name == StateName.COMMIT,
                             f"height {h}'s COMMIT phase")
                if h < heights:
                    for batch in early(h + 1):  # next height's early traffic: the future buffer
                        self._send(batch)
                    await asyncio.sleep(0.002)  # the overlap worker polls every 0.5 ms
                commits = schedules[h][2]
                self._send(commits[len(commits) // 3:])
                await _until(lambda: runner.height > h, f"height {h} to finalize")

        async def main() -> float:
            t0 = time.perf_counter()
            await asyncio.wait_for(asyncio.gather(runner.run(until_height=heights), feed()), 600)
            return time.perf_counter() - t0

        try:
            elapsed = asyncio.run(main())
        finally:
            engine.messages.close()
            runner.wal.close()
            self.speculator.stop()  # on the card, raises the worker's first fault
        stats = runner.stats()
        stats["elapsed_s"] = elapsed
        stats["blocks_per_s"] = heights / elapsed
        return stats


def _fresh_runner(committee: Committee, me: int, verifier, wal_path: str, **runner_kw):
    backend = ECDSABackend(committee.keys[me], committee.src)
    engine = IBFT(NullLogger(), backend, _Silent(), batch_verifier=verifier)
    engine.set_base_round_timeout(TIMEOUT_S)
    return ChainRunner(engine, WriteAheadLog(wal_path), overlap=False, **runner_kw), backend


def recover_runner(committee: Committee, me: int, verifier, wal_path: str):
    """A fresh runner on ``wal_path`` after ``recover()``: ``(runner,
    resumed height, the blocks it re-inserted)``."""
    runner, backend = _fresh_runner(committee, me, verifier, wal_path)
    resumed = runner.recover()
    runner.engine.messages.close()
    runner.wal.close()
    return runner, resumed, list(backend.inserted)


def sync_runner(committee: Committee, me: int, verifier, wal_path: str, peer, until_height: int):
    """A fresh runner with an empty WAL that catches up ``1..until_height``
    from ``peer`` (a ``SyncSource``) through its sync watcher."""
    net = LoopbackSyncNetwork()
    net.register(b"peer", peer)
    address = committee.keys[me].address
    client = SyncClient(address, net, verifier, committee.src)
    runner, _ = _fresh_runner(committee, me, verifier, wal_path, sync=client, sync_poll_s=0.005)
    net.register(address, runner)

    async def main():
        await asyncio.wait_for(runner.run(until_height=until_height), TIMEOUT_S)

    try:
        asyncio.run(main())
    finally:
        runner.engine.messages.close()
        runner.wal.close()
    return runner


class StaticSource:
    """A ``SyncSource`` serving a fixed list of blocks."""

    def __init__(self, blocks: Sequence[FinalizedBlock]):
        self.blocks = list(blocks)

    def latest_height(self) -> int:
        return self.blocks[-1].height if self.blocks else 0

    def get_blocks(self, start: int, end: int) -> List[FinalizedBlock]:
        return [b for b in self.blocks if start <= b.height <= end]


def corrupt_seals(block: FinalizedBlock, count: int) -> FinalizedBlock:
    """``block`` with its first ``count`` seals' signatures corrupted
    (byte 5 flipped: each recovers to another key or none)."""
    seals = [
        CommittedSeal(s.signer, s.signature[:5] + bytes([s.signature[5] ^ 0xFF]) + s.signature[6:])
        if i < count else s
        for i, s in enumerate(block.seals)
    ]
    return dataclasses.replace(block, seals=seals)


# -- concurrent drains ------------------------------------------------------------


def concurrent_drains(verifier, rounds: Sequence) -> int:
    """One thread per signed round (``bench/workload.py``'s
    ``SignedRound``, each at its own height) calls
    ``verifier.verify_senders`` on its PREPAREs and
    ``verifier.verify_seal_lanes`` on its seals :data:`THREAD_ITERATIONS`
    times; every
    mask must equal the round's expected masks.  Raises on the first
    mismatch or fault; returns the number of calls."""
    errors: List[BaseException] = []
    calls = [0]
    lock = threading.Lock()
    start = threading.Barrier(len(rounds))

    def body(rnd) -> None:
        try:
            lanes = [(rnd.proposal_hash, seal) for seal in rnd.seals]
            start.wait()
            for i in range(THREAD_ITERATIONS):
                senders = verifier.verify_senders(rnd.prepares)
                seals = verifier.verify_seal_lanes(lanes, rnd.height)
                if not np.array_equal(senders, rnd.expected_prepare_mask):
                    raise AssertionError(f"height {rnd.height} call {i}: sender mask != expected")
                if not np.array_equal(seals, rnd.expected_seal_mask):
                    raise AssertionError(f"height {rnd.height} call {i}: seal-lane mask != expected")
                with lock:
                    calls[0] += 2
        except BaseException as err:  # noqa: BLE001 - raised below
            errors.append(err)

    threads = [threading.Thread(target=body, args=(rnd,), name=f"drain-h{rnd.height}") for rnd in rounds]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    return calls[0]


# -- the trace -------------------------------------------------------------------


def span_split(trace_path: str, heights: int) -> Dict[str, float]:
    """Milliseconds a height per span name of :data:`SPLIT_SPANS`, summed
    over every track of the runner's Chrome trace."""
    with open(trace_path) as fh:
        doc = json.load(fh)
    total: Dict[str, float] = {name: 0.0 for name in SPLIT_SPANS}
    for e in doc["traceEvents"]:
        if e.get("ph") == "X" and e.get("name") in total:
            total[e["name"]] += e.get("dur", 0) / 1e3
    return {name: ms / heights for name, ms in total.items()}


def phase_split(trace_path: str, node: str, quorum: int) -> Dict[str, float]:
    """``obs/timeline.py``'s phase split of ``node``'s heights (``reconstruct``
    and ``_phase_split``), each leg's mean over the heights in ms."""
    events = timeline.merge_events([timeline.load_trace_file(trace_path)])
    legs: Dict[str, List[float]] = {}
    heights = 0
    for tl in timeline.reconstruct(events, quorum=quorum):
        p = tl.nodes.get(node)
        if p is None or p.finalized_at is None:
            continue
        heights += 1
        for leg, us in timeline._phase_split(tl, p).items():
            if leg.endswith("_us") and us is not None:
                legs.setdefault(leg[:-3] + "_ms", []).append(us / 1e3)
    out: Dict[str, float] = {leg: statistics.mean(v) for leg, v in legs.items()}
    out["heights"] = heights
    return out
