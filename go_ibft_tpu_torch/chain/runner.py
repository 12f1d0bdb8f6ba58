"""ChainRunner: a per-height consensus engine turned continuous node (the
port of the JAX package's ``chain/runner.py``).

go-ibft stops at "one ``run_sequence(height)`` per call" and leaves chain
driving to the embedder (SURVEY §1).  Every embedder so far — including
``examples/minimal_embedder.py`` — drove heights behind a full
``asyncio.gather`` barrier: the FASTEST node of a cluster idles until the
slowest finishes each height, engine tasks are re-spawned per height, and
early traffic for height H+1 sat unexploited while H finished its COMMIT
drain.  :class:`ChainRunner` removes all three costs:

* **No inter-height barrier.**  Each node owns ONE persistent runner task
  that loops heights back-to-back; nodes de-synchronize naturally and
  re-synchronize through consensus itself (a node cannot finalize H+1
  without a quorum at H+1).  The per-height handoff is explicit and
  measured (``chain.handoff`` span + ``("go-ibft","chain","handoff_ms")``).
* **Cross-height verify overlap.**  While H's COMMIT drain is in flight,
  a persistent overlap worker drains the engine's bounded future-height
  buffer and batch-verifies H+1's early envelopes off the event loop
  (device route rides the double-buffered ``verify/pipeline.py`` drains;
  host route releases the GIL in the native verifier), handing verified
  survivors straight into the store (``IBFT.add_verified_messages``) so
  run_sequence(H+1) finds its PREPAREs pre-verified.  Instrumented as
  ``chain.overlap`` spans.
* **Durability + catch-up.**  Finalized heights and the mid-round
  prepared-certificate lock ride the :class:`~go_ibft_tpu_torch.chain.wal.
  WriteAheadLog` (finalize -> WAL append -> prune ordering, see
  ``core/ibft.py::_insert_block``); :meth:`recover` replays it so a
  crashed validator rejoins at the correct height without equivocating.
  A node that falls behind its peers (the sync watcher polls the
  :class:`~go_ibft_tpu_torch.chain.sync.SyncClient` seam) abandons the stale
  sequence and catches up via one batched seal drain per validator-set
  snapshot.

Two differences from the JAX package.  On the card
(:func:`~go_ibft_tpu_torch.verify.batch.on_card` of the engine's verifier)
a fault of the overlap worker's drain ends :meth:`ChainRunner.run` with
that fault instead of re-verifying the batch on the host; off the card the
JAX behaviour stays.  And the hooks whose modules the port does not have
yet raise :class:`~go_ibft_tpu_torch.chain.wal.NotPortedError` naming the
slice they wait for: ``certifier=`` and ``checkpointer=`` (BLS and
serving) and :meth:`ChainRunner.warm_start` (boot).
"""

from __future__ import annotations

import asyncio
import time
from collections import deque
from typing import Deque, List, Optional

from ..core.ibft import IBFT, RestoredState
from ..core.state import StateName
from ..messages.helpers import CommittedSeal
from ..messages.wire import PreparedCertificate, Proposal
from ..obs import trace
from ..utils import metrics
from ..verify.batch import on_card
from .sync import SyncClient, SyncError
from .wal import CERT_NOT_PORTED, CHECKPOINT_NOT_PORTED, FinalizedBlock, NotPortedError, WriteAheadLog

__all__ = ["ChainRunner", "HANDOFF_MS_KEY", "HEIGHT_MS_KEY", "OVERLAP_LANES_KEY"]

HANDOFF_MS_KEY = ("go-ibft", "chain", "handoff_ms")
HEIGHT_MS_KEY = ("go-ibft", "chain", "height_ms")
OVERLAP_LANES_KEY = ("go-ibft", "chain", "overlap_lanes")


class ChainRunner:
    """Drives one engine through consecutive heights; implements the
    :class:`~go_ibft_tpu_torch.chain.sync.SyncSource` protocol for peers.

    ``overlap`` enables the cross-height pre-verification worker;
    ``sync`` (a :class:`SyncClient`) enables the fall-behind watcher and
    catch-up.  Both are persistent tasks owned by :meth:`run` — nothing is
    spawned or torn down per height beyond what the engine's own round
    workers require.
    """

    def __init__(
        self,
        engine: IBFT,
        wal: Optional[WriteAheadLog] = None,
        *,
        sync: Optional[SyncClient] = None,
        certifier=None,
        checkpointer=None,
        speculator=None,
        overlap: bool = True,
        overlap_poll_s: float = 0.002,
        max_chain_blocks: int = 8192,
        sync_poll_s: float = 0.05,
        sync_lag: int = 1,
        sync_stall_s: Optional[float] = None,
    ) -> None:
        self.engine = engine
        self.wal = wal
        self.sync = sync
        # Aggregate-COMMIT compression and epoch checkpoints wait for the
        # BLS and serving slices.
        if certifier is not None:
            raise NotPortedError(CERT_NOT_PORTED)
        if checkpointer is not None:
            raise NotPortedError(CHECKPOINT_NOT_PORTED)
        # Speculative verification plane: attaching a
        # :class:`~go_ibft_tpu_torch.verify.speculate.SpeculativeVerifier`
        # here wires it into the engine — ingress COMMIT seals verify
        # off the event loop as they land (including the future-height
        # COMMITs the overlap worker hands over via
        # ``add_verified_messages``), and the COMMIT drain's early-exit
        # remainder resolves through the same worker.  The engine owns
        # the lifecycle hooks; the runner only surfaces the evidence
        # (``stats()["speculation"]``).
        if speculator is not None:
            engine.speculator = speculator
        self.overlap = overlap
        self._overlap_poll_s = overlap_poll_s
        self._sync_poll_s = sync_poll_s
        # Peers this many heights past OUR current height trigger catch-up
        # (>= 1: a peer that finalized height H+lag can only have done so
        # after a quorum left our height behind).
        self.sync_lag = max(1, sync_lag)
        # Second trigger: a peer that finalized exactly OUR current height
        # is already conclusive evidence we can fetch it — but during
        # normal operation every node sees its peers finish moments before
        # it does, so this trigger additionally requires the current
        # sequence to have been running for ``sync_stall_s`` without
        # finalizing (default: 1.5x the engine's base round timeout — a
        # full round 0 plus slack).  Covers the restarted-mid-round node
        # whose peers finalized its height and then stalled waiting for it
        # at the next one (neither side can make consensus progress;
        # without this trigger that wedge is permanent).
        self.sync_stall_s = sync_stall_s
        self._height_started = time.monotonic()
        # In-memory tail of the finalized chain (contiguous, ascending —
        # consensus appends sequentially and sync fills gaps before the
        # runner advances).  Bounded: run() may drive heights forever;
        # heights evicted from the tail are served to peers from the WAL.
        self.chain: List[FinalizedBlock] = []
        self.max_chain_blocks = max_chain_blocks
        self.height = 1  # next height to run
        self._restore: Optional[RestoredState] = None
        # Readiness half of the supervisor contract (/readyz): flips in
        # recover() — a node with a WAL is not routable before its replay
        # completed, however long warm-start takes.
        self._recovered = False
        self._sync_wake = asyncio.Event() if sync is not None else None
        self._running = False
        # Evidence counters (the chain bench reads these).
        self.heights_run = 0
        self.synced_heights = 0
        self.overlapped_lanes = 0
        self.overlap_batches = 0
        # Bounded: run() may drive heights forever; the full distribution
        # lives in the metrics histogram (HANDOFF_MS_KEY), this window
        # serves stats()/bench.
        self.handoff_ms: Deque[float] = deque(maxlen=4096)
        # A card fault of a persistent worker, and the run() task it ends.
        self._fault: Optional[BaseException] = None
        self._run_task: Optional[asyncio.Task] = None
        try:
            self._track = "chain-" + bytes(engine.backend.id()).hex()[:16]
        except Exception:  # noqa: BLE001 - mocks without a stable id
            self._track = f"chain-{id(self) & 0xFFFF:04x}"
        # Chain hooks: WAL append rides INSIDE the engine's finalize step
        # (between insert_proposal and the store prune — the
        # crash-consistency ordering), locks append at PC-pin time.
        engine.on_finalize = self._on_finalize
        engine.on_lock = self._on_lock

    # -- SyncSource (what this node serves to peers) ---------------------

    def latest_height(self) -> int:
        return self.chain[-1].height if self.chain else 0

    def validators_for_height(self, height: int) -> dict:
        """Per-height validator-set snapshot (the proof-serving seam).

        The serve layer (the JAX package's ``serve``) builds finality proofs
        from a ``SyncSource`` plus this snapshot source, so it mounts a
        running node unchanged, rotation-aware: the engine backend's
        ``get_voting_powers`` is already the height-keyed seam every
        verifier uses."""
        return self.engine.backend.get_voting_powers(height)

    def get_blocks(self, start: int, end: int) -> List[FinalizedBlock]:
        # The in-memory tail is contiguous ascending, so a range request
        # is an index slice, not a scan (peers poll this at sync cadence).
        if self.chain and start >= self.chain[0].height:
            first = self.chain[0].height
            lo = max(0, start - first)
            hi = min(len(self.chain), end - first + 1)
            return self.chain[lo:hi]
        if self.wal is not None:
            # Deep history (evicted from the tail): replay the WAL — the
            # rare path, paid only by peers asking for old heights.
            return [
                b
                for b in self.wal.replay().blocks
                if start <= b.height <= end
            ]
        return []

    def _append_block(self, block: FinalizedBlock) -> None:
        self.chain.append(block)
        if len(self.chain) > self.max_chain_blocks:
            del self.chain[: len(self.chain) - self.max_chain_blocks]

    # -- engine hooks ----------------------------------------------------

    def _on_finalize(
        self, height: int, proposal: Proposal, seals: List[CommittedSeal]
    ) -> None:
        # A height the engine finalized from an aggregate certificate
        # persists that certificate (the WAL raises NotPortedError for
        # it until the BLS slice): its seal list is a synthetic sentinel
        # no peer's seal-lane verify could accept.
        cert = getattr(self.engine, "finalized_certificate", None)
        stored_seals = [] if cert is not None else list(seals)
        if self.wal is not None:
            self.wal.append_finalize(height, proposal, stored_seals, cert=cert)
        self._append_block(
            FinalizedBlock(height, proposal, stored_seals, cert=cert)
        )

    def _on_lock(
        self,
        height: int,
        round_: int,
        certificate: PreparedCertificate,
        _proposal: Optional[Proposal],
    ) -> None:
        if self.wal is not None:
            self.wal.append_lock(height, round_, certificate)

    # -- crash recovery --------------------------------------------------

    def recover(self) -> int:
        """Replay the WAL; returns the height the node resumes at.

        Re-inserts every durable block into the embedder backend (the
        chain the old process had built), then restores the in-flight
        prepared-certificate lock so the first ``run_sequence`` re-enters
        its height mid-round instead of starting over — the restarted
        validator can never prepare a different proposal for a height it
        already sent COMMIT for.
        """
        if self.wal is None:
            raise ValueError("recover() needs a WAL")
        state = self.wal.replay()
        for block in state.blocks:
            self.engine.backend.insert_proposal(block.proposal, block.seals)
            self._append_block(block)
        self.height = state.next_height
        self._restore = None
        self._recovered = True
        if state.lock is not None and state.lock.height >= self.height:
            self.height = state.lock.height
            self._restore = RestoredState(
                height=state.lock.height,
                round=state.lock.round,
                certificate=state.lock.certificate,
            )
        trace.instant(
            "chain.recover",
            track=self._track,
            height=self.height,
            locked=self._restore is not None,
            blocks=len(state.blocks),
        )
        return self.height

    def warm_start(self, **kw):
        """The JAX package's full warm restore: not ported (raises
        :class:`NotPortedError`; it needs ``boot.warmstart``)."""
        raise NotPortedError(
            "warm_start is not ported: it needs boot.warmstart, which comes "
            "with the boot slice"
        )

    # -- the height loop -------------------------------------------------

    async def run(
        self,
        heights: Optional[int] = None,
        *,
        until_height: Optional[int] = None,
    ) -> None:
        """Run heights back-to-back until ``until_height`` (inclusive) or
        for ``heights`` more heights; forever when neither is given.

        ONE call owns the node: the height loop, the overlap worker, and
        the sync watcher all live inside it and are torn down on exit or
        cancellation.
        """
        if until_height is not None:
            stop: Optional[int] = until_height
        elif heights is not None:
            stop = self.height + heights - 1
        else:
            stop = None
        if self._running:
            raise RuntimeError("ChainRunner.run is already active")
        self._running = True
        self._fault = None
        self._run_task = asyncio.current_task()
        workers: List[asyncio.Task] = []
        if self.overlap:
            workers.append(
                asyncio.create_task(
                    self._overlap_worker(), name="chain-overlap"
                )
            )
        if self.sync is not None:
            workers.append(
                asyncio.create_task(self._sync_watcher(), name="chain-sync")
            )
        try:
            while stop is None or self.height <= stop:
                if self.sync is not None and self._sync_wake.is_set():
                    self._sync_wake.clear()
                    await self._catch_up()
                    continue
                await self._run_one_height()
        except asyncio.CancelledError:
            if self._fault is None:
                raise
            # _fail's own cancel: a worker's card fault ends run() with it.
            asyncio.current_task().uncancel()
            raise self._fault from None
        finally:
            self._running = False
            self._run_task = None
            for task in workers:
                task.cancel()
            await asyncio.gather(*workers, return_exceptions=True)

    def _fail(self, err: BaseException) -> None:
        """End :meth:`run` with a persistent worker's card fault."""
        if self._fault is None:
            self._fault = err
            if self._run_task is not None:
                self._run_task.cancel()

    async def _run_one_height(self) -> None:
        height = self.height
        restore, self._restore = self._restore, None
        self._height_started = time.monotonic()
        t0 = time.perf_counter()
        sequence = asyncio.create_task(
            self.engine.run_sequence(height, restore=restore),
            name=f"chain-seq-h{height}",
        )
        interrupted = False
        with trace.span(
            "chain.height",
            track=self._track,
            height=height,
            restored=restore is not None,
        ):
            if self.sync is None:
                await sequence
            else:
                waiter = asyncio.create_task(self._sync_wake.wait())
                try:
                    await asyncio.wait(
                        {sequence, waiter},
                        return_when=asyncio.FIRST_COMPLETED,
                    )
                finally:
                    waiter.cancel()
                    await asyncio.gather(waiter, return_exceptions=True)
                    if not sequence.done():
                        # Either the sync watcher fired (we abandon the
                        # stale height for catch-up) or run() itself is
                        # being cancelled: tear the sequence down cleanly
                        # before leaving — the engine's teardown barrier
                        # runs inside.
                        interrupted = True
                        sequence.cancel()
                        await asyncio.gather(sequence, return_exceptions=True)
            if sequence.done() and not sequence.cancelled():
                sequence.result()  # propagate engine errors
        if interrupted:
            return
        metrics.observe(HEIGHT_MS_KEY, (time.perf_counter() - t0) * 1e3)
        self.heights_run += 1
        t0 = time.perf_counter()
        with trace.span("chain.handoff", track=self._track, height=height):
            self._handoff(height)
        dt_ms = (time.perf_counter() - t0) * 1e3
        metrics.observe(HANDOFF_MS_KEY, dt_ms)
        self.handoff_ms.append(dt_ms)
        self.height = height + 1

    def _handoff(self, height: int) -> None:
        """Between-heights bookkeeping, attributed to its own span.

        The WAL finalize append already ran INSIDE the finalize step (the
        crash-consistency ordering); what remains is rolling the verifier
        caches and pruning the store up to the next height — all
        idempotent with ``run_sequence``'s own start-of-height work, so
        driving the engine directly (without a runner) stays correct.
        """
        engine = self.engine
        engine.messages.prune_by_height(height + 1)
        verifier = engine.batch_verifier
        if hasattr(verifier, "reset_pack_cache"):
            verifier.reset_pack_cache()
        if hasattr(verifier, "note_round"):
            verifier.note_round(0)

    # -- persistent workers ----------------------------------------------

    async def _overlap_worker(self) -> None:
        """Pre-verify next-height ingress while COMMIT is in flight.

        Runs forever at a small poll interval; only acts when the engine
        sits in the COMMIT phase (the window where the current height's
        seal drain is on the device/native path) AND the future buffer
        holds messages for the next height.  Verification runs in an
        executor thread — the engine's event loop keeps draining COMMIT
        wakeups while the envelopes for H+1 verify concurrently; on the
        device route the drain itself is the double-buffered
        ``verify/pipeline.py`` chunk pipeline — the route is the
        verifier's decision, invisible here.  On the card a faulted drain
        ends :meth:`run` with its fault (:meth:`_fail`).
        """
        loop = asyncio.get_running_loop()
        engine = self.engine
        while True:
            await asyncio.sleep(self._overlap_poll_s)
            if engine.state.name != StateName.COMMIT:
                continue
            next_height = engine.state.height + 1
            batch = engine.take_future_messages(next_height)
            if not batch:
                continue
            with trace.span(
                "chain.overlap",
                track=self._track,
                height=next_height,
                lanes=len(batch),
            ):
                verifier = engine.batch_verifier
                try:
                    if verifier is not None:
                        mask = await loop.run_in_executor(
                            None, verifier.verify_senders, batch
                        )
                        accepted = [
                            m for m, ok in zip(batch, mask) if bool(ok)
                        ]
                    else:
                        accepted = await loop.run_in_executor(
                            None,
                            lambda: [
                                m
                                for m in batch
                                if engine.backend.is_valid_validator(m)
                            ],
                        )
                except Exception as err:  # noqa: BLE001 - degraded path below
                    if on_card(verifier):
                        self._fail(err)  # no host route for the card's fault
                        return
                    # A faulted drain must not eat the messages.  Re-
                    # buffering alone is not enough: the engine may have
                    # advanced to the batch's height during the executor
                    # call, and _buffer_future silently rejects heights
                    # that are no longer future.  Anything un-bufferable
                    # goes back through the one-message verified ingress
                    # (each guarded — the verifier just faulted once).
                    for message in batch:
                        if engine._buffer_future(message):
                            continue
                        try:
                            engine.add_message(message)
                        except Exception:  # noqa: BLE001 - still faulting
                            pass
                    continue
                engine.add_verified_messages(accepted)
            self.overlapped_lanes += len(batch)
            self.overlap_batches += 1
            metrics.inc_counter(OVERLAP_LANES_KEY, len(batch))

    async def _sync_watcher(self) -> None:
        """Wake the height loop when peers have demonstrably moved on.

        A peer advertising height >= ours + ``sync_lag`` finalized our
        current height without us — consensus there is over, only block
        sync can rejoin us.  Two consecutive observations are required so
        the normal end-of-height race (a fast peer finishing moments
        before we do) never cancels a sequence that is about to finalize.
        """
        behind_streak = 0
        while True:
            await asyncio.sleep(self._sync_poll_s)
            if self._sync_wake.is_set():
                continue
            try:
                best = self.sync.best_peer_height()
            except Exception:  # noqa: BLE001 - unreachable peers: retry
                continue
            # Fast path: commit-quorum evidence for a FUTURE height in
            # the ingress buffer is conclusive — peers finalized past us
            # (e.g. this node's proposal for the current height was
            # dropped beyond the one-ahead buffer horizon while it was
            # still catching up), so waiting out the stall timer only
            # burns liveness.  Triggers immediately, no streak, as long
            # as a peer can actually serve the gap.
            quorum = self.engine.validator_manager.quorum_size
            if (
                quorum > 0
                and best >= self.height
                and self.engine.future_commit_evidence(self.height + 1)
                >= quorum
            ):
                trace.instant(
                    "chain.sync.behind",
                    track=self._track,
                    height=self.height,
                    best_peer=best,
                    evidence="future-commits",
                )
                self._sync_wake.set()
                continue
            stall_s = (
                self.sync_stall_s
                if self.sync_stall_s is not None
                else 1.5 * self.engine.base_round_timeout
            )
            stalled = (
                best >= self.height
                and time.monotonic() - self._height_started > stall_s
            )
            if best >= self.height + self.sync_lag or stalled:
                behind_streak += 1
                if behind_streak >= 2:
                    behind_streak = 0
                    trace.instant(
                        "chain.sync.behind",
                        track=self._track,
                        height=self.height,
                        best_peer=best,
                        stalled=stalled,
                    )
                    self._sync_wake.set()
            else:
                behind_streak = 0

    async def _catch_up(self) -> None:
        """Fetch and verify the missing range; one drain per snapshot."""
        target = self.sync.best_peer_height()
        if target < self.height:
            return
        loop = asyncio.get_running_loop()
        with trace.span(
            "chain.sync",
            track=self._track,
            start=self.height,
            target=target,
        ):
            try:
                blocks = await loop.run_in_executor(
                    None, self.sync.catch_up, self.height, target
                )
            except SyncError as err:
                self.engine.log.error("block sync failed", err)
                return
        # Embedder content check: committed seals sign (raw_proposal,
        # round) — NOT the height — so in-protocol verification alone
        # cannot catch a peer relabeling a genuine block at a different
        # height.  Height binding lives in the proposal content (real
        # chains embed height/parent-hash in the block and reject it
        # here), exactly as in the reference where block sync is wholly
        # the embedder's job; is_valid_proposal is the seam for it.
        for block in blocks:
            try:
                ok = self.engine.backend.is_valid_proposal(
                    block.proposal.raw_proposal
                )
            except Exception:  # noqa: BLE001 - treat a crash as rejection
                ok = False
            if not ok:
                self.engine.log.error(
                    "block sync: embedder rejected synced proposal",
                    block.height,
                )
                return
        for block in blocks:
            self.engine.backend.insert_proposal(block.proposal, block.seals)
            if self.wal is not None:
                self.wal.append_finalize(
                    block.height, block.proposal, block.seals, cert=block.cert
                )
            self._append_block(block)
        if blocks:
            self.synced_heights += len(blocks)
            self.height = blocks[-1].height + 1
            self._restore = None  # the locked height was finalized by peers

    # -- telemetry plane (live endpoints + per-node trace export) ---------

    def start_telemetry(
        self,
        port: int = 0,
        *,
        host: str = "127.0.0.1",
        wedged_after_s: Optional[float] = None,
        extra_status: Optional[dict] = None,
    ):
        """Mount /metrics, /healthz, /statusz for this node.

        Default-off: nothing calls this unless the embedder (or
        ``examples/minimal_embedder.py --telemetry``) asks — benches are
        unaffected.  Also turns the fixed-bucket latency histograms on
        (they are what /metrics serves).  ``wedged_after_s`` is the
        /healthz liveness bound: a runner that has not advanced a height
        for that long while running reports unhealthy (default: 3x the
        engine's base round timeout + 5s — a full round 0 plus round-
        change slack).  ``extra_status`` maps status keys to zero-arg
        callables merged into /statusz per scrape (mount scheduler or
        proof-server stats here).  Returns the started
        :class:`~go_ibft_tpu_torch.obs.httpd.TelemetryServer` (``.port`` holds
        the bound port).
        """
        from ..obs.httpd import TelemetryServer

        metrics.enable_fixed_histograms()
        self._telemetry_extra = dict(extra_status or {})
        self._wedged_after_s = wedged_after_s
        server = TelemetryServer(
            status_fn=self.telemetry_status,
            health_fn=self.telemetry_health,
            ready_fn=self.telemetry_ready,
            host=host,
            port=port,
        )
        server.start()
        self._telemetry = server
        return server

    def stop_telemetry(self) -> None:
        server = getattr(self, "_telemetry", None)
        if server is not None:
            server.stop()
            self._telemetry = None

    def telemetry_status(self) -> dict:
        """The /statusz payload: one lock-free snapshot of the node."""
        from ..obs import trace

        engine = self.engine
        recorder = trace.recorder()
        verifier = engine.batch_verifier
        breaker = getattr(verifier, "breaker", None)
        speculator = getattr(engine, "speculator", None)
        status = {
            "node": self._track,
            "running": self._running,
            "height": engine.state.height,
            "round": engine.state.round,
            "state": str(getattr(engine.state.name, "name", engine.state.name)),
            "next_height": self.height,
            "chain_height": self.latest_height(),
            "heights_run": self.heights_run,
            "synced_heights": self.synced_heights,
            "overlapped_lanes": self.overlapped_lanes,
            "breaker_level": getattr(breaker, "level", None),
            "speculation": (
                speculator.stats() if speculator is not None else None
            ),
            "ring_dropped": recorder.dropped if recorder is not None else None,
            "handoff_ms_mean": (
                sum(self.handoff_ms) / len(self.handoff_ms)
                if self.handoff_ms
                else None
            ),
        }
        for key, fn in getattr(self, "_telemetry_extra", {}).items():
            try:
                status[key] = fn()
            except Exception as err:  # noqa: BLE001 - a scrape never crashes
                status[key] = {"error": repr(err)}
        return status

    def telemetry_health(self):
        """The /healthz verdict: (ok, payload).

        Unhealthy iff the runner is live but has not started a new height
        within the wedge bound — the restart signal a fleet orchestrator
        polls.  A stopped runner is healthy (it is not wedged, it is
        done); a sequence legitimately waiting out round changes stays
        healthy until the bound, which defaults past a full round 0.
        """
        limit = getattr(self, "_wedged_after_s", None)
        if limit is None:
            limit = 3.0 * self.engine.base_round_timeout + 5.0
        stale_s = time.monotonic() - self._height_started
        wedged = self._running and stale_s > limit
        return not wedged, {
            "ok": not wedged,
            "wedged": wedged,
            "running": self._running,
            "stale_s": round(stale_s, 3),
            "limit_s": limit,
            "height": self.height,
            "chain_height": self.latest_height(),
        }

    def telemetry_ready(self):
        """The /readyz verdict: (ready, payload) — may traffic be routed?

        Distinct from :meth:`telemetry_health` (liveness) on purpose: a
        warm-starting node is alive the whole time ``recover()`` replays
        the WAL, but routing clients to it before the replay lands them
        on a stale (or empty) chain.  Ready iff

        * the WAL, when there is one, has been replayed
          (``recover()`` completed — the supervisor contract from
          supervisor contract), and
        * at least one height is finalized on the chain tail, so the
          node can actually serve reads (a fresh genesis node becomes
          ready the moment height 1 lands).
        """
        recovered = self.wal is None or self._recovered
        first_height = self.latest_height() >= 1
        ready = recovered and first_height
        return ready, {
            "ready": ready,
            "recovered": recovered,
            "chain_height": self.latest_height(),
            "running": self._running,
        }

    def export_trace(self, path: str) -> int:
        """Per-node flight-recorder export with node identity + clock
        offsets stamped in (the cross-process timeline contract).

        The stamped identity is the ENGINE's track (``node-<id>``), not
        the runner's ``chain-<id>``: peers key their clock-offset
        estimates by the trace-context ``origin``, which is the engine
        track — the timeline tool matches ``otherData.node`` against
        those keys to rebase this file's clock.
        """
        from ..obs.export import write_chrome_trace

        return write_chrome_trace(
            path, node=getattr(self.engine, "_obs_track", self._track)
        )

    # -- evidence ---------------------------------------------------------

    def stats(self) -> dict:
        """Bench/evidence snapshot (the chain bench reads this)."""
        n = len(self.handoff_ms)
        speculator = getattr(self.engine, "speculator", None)
        return {
            "heights_run": self.heights_run,
            "synced_heights": self.synced_heights,
            "overlapped_lanes": self.overlapped_lanes,
            "overlap_batches": self.overlap_batches,
            "handoff_ms_mean": (sum(self.handoff_ms) / n) if n else None,
            "handoff_ms_max": max(self.handoff_ms) if n else None,
            "chain_height": self.latest_height(),
            "speculation": (
                speculator.stats() if speculator is not None else None
            ),
        }
