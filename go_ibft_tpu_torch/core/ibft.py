"""The IBFT 2.0 consensus engine.

Re-design of the reference's state machine (core/ibft.go:59-1315) on asyncio.
One :class:`IBFT` instance drives one validator; a cluster of instances
multicasting to each other reaches agreement on one proposal per *height*,
possibly across multiple *rounds* with rotating proposer and exponentially
growing timeouts.

Control flow stays on host (it is branchy and latency-bound); the O(N)
per-phase data plane — signature and seal verification — is delegated to a
:class:`~go_ibft_tpu_torch.core.backend.BatchVerifier` when the backend provides
one, draining each phase's message store in one device batch (SURVEY.md §7).

Concurrency model (mirrors reference core/ibft.go:323-394 exactly):
every round spawns four workers — round timer, future-proposal watcher,
round-change-certificate watcher, and the state machine — whose first
completed signal wins the round arbitration; teardown cancels and awaits all
workers (the reference's WaitGroup barrier) before the next round starts.
"""

from __future__ import annotations

import asyncio
import threading
import time
from dataclasses import dataclass
from typing import Callable, Optional, Sequence

from ..messages import helpers
from ..messages.events import SubscriptionDetails
from ..messages.helpers import CommittedSeal
from ..messages.store import MessageStore
from ..messages.wire import (
    IbftMessage,
    MessageType,
    PreparedCertificate,
    Proposal,
    RoundChangeCertificate,
    TraceContext,
    View,
)
from ..obs import trace
from ..utils import metrics
from ..utils.metrics import set_gauge
from .backend import Backend, BatchVerifier
from .state import SequenceState, StateName
from .transport import Transport
from .validator_manager import Logger, ValidatorManager, senders_of

# Default base round (round 0) timeout, seconds (reference core/ibft.go:49-50).
DEFAULT_BASE_ROUND_TIMEOUT = 10.0

# Fixed-bucket latency family (telemetry plane): proposal-accept ->
# finalize, the per-height number the /metrics endpoint and the SLO soak
# gates read.  Recorded only while ``metrics.enable_fixed_histograms()``
# is on — the same one-predicate disabled posture as the tracer.
ACCEPT_FINALIZE_MS_KEY = ("go-ibft", "latency", "accept_finalize_ms")

_ROUND_FACTOR_BASE = 2.0

# Exponent cap for the round-timeout formula: 2.0**round_ raises
# OverflowError past round ~1023, so a long-stalled sequence (or a
# Byzantine-driven round jump) would CRASH the timer worker instead of
# timing out.  10s * 2^62 is ~1.5e12 years — indistinguishable from
# "forever" while staying finite, monotone, and arithmetic-safe.
MAX_TIMEOUT_EXPONENT = 62


def get_round_timeout(
    base_round_timeout: float, additional_timeout: float, round_: int
) -> float:
    """Exponential round timeout: base·2^round + additional
    (reference core/ibft.go:1300-1315).  The exponent saturates at
    ``MAX_TIMEOUT_EXPONENT`` so arbitrarily high rounds return a finite
    timeout instead of raising ``OverflowError`` (the reference's Go
    ``time.Duration`` shift overflows silently there; we saturate)."""
    exponent = min(round_, MAX_TIMEOUT_EXPONENT)
    return base_round_timeout * (_ROUND_FACTOR_BASE**exponent) + additional_timeout


@dataclass
class RestoredState:
    """Crash-recovered in-flight state for one height (chain/wal.py lock
    records).  ``run_sequence(height, restore=...)`` re-enters the height
    at ``round`` with the prepared-certificate lock intact, so a restarted
    validator that had already sent COMMIT for a proposal can never
    prepare a different one for the same height (the equivocation the WAL
    exists to prevent)."""

    height: int
    round: int
    certificate: Optional[PreparedCertificate] = None


class _NewProposalEvent:
    """A valid proposal for a higher round (reference core/ibft.go:195-198)."""

    __slots__ = ("proposal_message", "round")

    def __init__(self, proposal_message: IbftMessage, round_: int) -> None:
        self.proposal_message = proposal_message
        self.round = round_


class _RoundSignals:
    """Per-round-iteration signal slots.

    The reference uses unbuffered channels selected against ctx.Done
    (core/ibft.go:77-94,170-207); futures owned by a single round iteration
    give the same no-stale-events guarantee — they are dropped wholesale at
    teardown.
    """

    def __init__(self) -> None:
        self.new_proposal: asyncio.Future = asyncio.get_running_loop().create_future()
        self.round_certificate: asyncio.Future = (
            asyncio.get_running_loop().create_future()
        )
        self.round_expired: asyncio.Future = asyncio.get_running_loop().create_future()
        self.round_done: asyncio.Future = asyncio.get_running_loop().create_future()
        # Process-fatal BaseException surfaced by a worker (a simulated
        # kill -9, KeyboardInterrupt, ...): unlike an ordinary worker crash
        # (logged at teardown; the round retries via its timer) this must
        # END the sequence — a worker replaced next round would let a
        # "dead" node keep participating.
        self.fatal: asyncio.Future = asyncio.get_running_loop().create_future()

    def all(self) -> list[asyncio.Future]:
        return [
            self.new_proposal,
            self.round_certificate,
            self.round_expired,
            self.round_done,
            self.fatal,
        ]

    @staticmethod
    def fire(fut: asyncio.Future, value=None) -> None:
        if not fut.done():
            fut.set_result(value)


class IBFT:
    """A single IBFT consensus state machine instance (reference core/ibft.go:59-136)."""

    def __init__(
        self,
        logger: Logger,
        backend: Backend,
        transport: Transport,
        *,
        message_store: Optional[MessageStore] = None,
        batch_verifier: Optional[BatchVerifier] = None,
        cert_verifier=None,
        speculator=None,
        commit_early_exit: bool = True,
    ) -> None:
        self.log = logger
        self.backend = backend
        self.transport = transport
        self.messages = message_store if message_store is not None else MessageStore()
        self.state = SequenceState()
        self.validator_manager = ValidatorManager(backend, logger)
        self.base_round_timeout = DEFAULT_BASE_ROUND_TIMEOUT
        self.additional_timeout = 0.0
        # Explicit batch verifier wins; otherwise use the backend when it
        # implements the BatchVerifier protocol.
        if batch_verifier is not None:
            self.batch_verifier: Optional[BatchVerifier] = batch_verifier
        elif isinstance(backend, BatchVerifier):
            self.batch_verifier = backend
        else:
            self.batch_verifier = None
        self._signals: Optional[_RoundSignals] = None
        # Committed-seal verdict cache, scoped per round: round -> {(sender,
        # proposal hash, seal bytes) -> bool}.  Every signature is verified
        # EXACTLY ONCE: envelopes at ingress (add_message/add_messages),
        # seals at first sight here, certificate innards when the carrying
        # message validates.  Phase wakeups after that are pure exact-int
        # arithmetic — re-dispatching crypto per wakeup made the phase loop
        # O(n^2) in signatures.  The key carries the
        # proposal hash the seal was verified AGAINST: a cached
        # True can never validate a seal against a hash it did not sign,
        # even if a future path re-set the accepted proposal mid-round.
        # Cleared per sequence (run_sequence -> state.reset) and bounded
        # round-first (``_evict_seal_verdicts``): a Byzantine seal-rewrite
        # flood mints a fresh key per delivery, and must compete with dead
        # rounds' verdicts before it can evict the live view's.
        self._seal_verdicts: dict[int, dict[tuple, bool]] = {}
        self._seal_verdict_count = 0
        self._seal_verdict_cap = 16384
        # accept -> finalize latency anchor (set by _accept_proposal,
        # consumed by _insert_block into ACCEPT_FINALIZE_MS_KEY).
        self._accept_ts: Optional[float] = None
        # Memoized is_valid_proposal_hash verdicts for the ACCEPTED proposal
        # (cleared whenever it changes): a prepare/commit drain checks the
        # carried hash once per message per wakeup, and the backend call
        # re-hashes the proposal each time — at 4 validators that keccak was
        # a measurable slice of the happy-path phase loop.  Each distinct
        # carried hash now costs one backend call per round.
        self._hash_memo: dict[bytes, bool] = {}
        self._hash_memo_cap = 1024
        # Bounded future-height ingress buffer: messages for height H+1
        # arriving while H is still finalizing are held here (dedup by
        # (type, height, round, sender), the store's slot rule) instead of
        # flowing straight into the main store — the pre-chain gate let ANY
        # future height in, an unbounded spam surface.  Flushed through the
        # verified ingress path by run_sequence(H+1), or pre-verified early
        # by the chain runner's overlap worker (take_future_messages).
        # Signatures are NOT verified at buffer time, so both a per-sender
        # and a total cap bound what a sender-forging spammer can pin.
        self._future_lock = threading.Lock()
        self._future_buffer: dict[bytes, dict[tuple, IbftMessage]] = {}
        self._future_count = 0
        self.future_cap_per_sender = 16
        self.future_cap_total = 4096
        # PREPREPAREs get a longer buffer horizon than the flood-prone
        # types: a proposal is one message per (height, proposer) by the
        # dedup key, so holding a few heights' worth is still strictly
        # bounded — and dropping one wedges a lagging node permanently
        # (proposers never re-send; a node that missed the proposal for
        # height H while catching up can neither run H nor, if it is H+1's
        # proposer, let anyone else proceed).
        self.future_proposal_horizon = 4
        # Aggregate-COMMIT path: ``cert_verifier`` (a
        # BLSCertifier or compatible — one ``verify(cert)`` doing ONE
        # pairing equation + exact quorum power over the cert's signer
        # bitmap) enables finalizing a height straight from an
        # AggregateQuorumCertificate delivered by the aggregation-tree
        # gossip transport (net/aggtree.py) — the engine never needs a
        # quorum of INDIVIDUAL COMMITs when a verified certificate proves
        # one existed.  Certificates land in a tiny pending slot keyed by
        # height (latest wins; one live height + one ahead, same bounded
        # posture as the future-message buffer) and are consumed by the
        # COMMIT drain on the event loop, where the accepted proposal is
        # stable.  ``finalized_certificate`` records the cert that
        # finalized the CURRENT height (None for per-seal finalization);
        # the chain runner persists it as the height's O(1) WAL record.
        self.cert_verifier = cert_verifier
        self._cert_lock = threading.Lock()
        self._pending_certs: dict[int, object] = {}
        self.finalized_certificate = None
        # Speculative cross-phase verification: ``speculator``
        # (a :class:`~go_ibft_tpu_torch.verify.speculate.SpeculativeVerifier`)
        # verifies COMMIT seals OFF the event loop as they land at
        # ingress — seal validity is proposal-independent (the digest is
        # the hash carried IN the message), so nothing about it needs
        # the COMMIT phase to be open.  The drain then consults the
        # speculation cache (full binding: height, round, carried hash,
        # sender, signature — a verdict can never leak across a
        # different binding) before dispatching fresh crypto.  Opt-in,
        # like cert_verifier: the embedder decides whether a background
        # verify thread exists.
        self.speculator = speculator
        # Incremental quorum early-exit: the COMMIT drain
        # stops verifying at the exact voting-power quorum and hands the
        # unverified remainder to the speculator for lazy off-path
        # resolution (or resolves it synchronously if the early exit
        # mispredicted — liveness never depends on a deferred lane).
        self.commit_early_exit = commit_early_exit
        # Chain-layer hooks (go_ibft_tpu_torch.chain): on_lock fires when a
        # prepare quorum pins the PC (the WAL's in-flight lock record);
        # on_finalize fires after insert_proposal and BEFORE the store
        # prune — the crash-consistent finalize -> WAL append -> prune
        # ordering the chain WAL relies on.
        self.on_lock: Optional[
            Callable[[int, int, PreparedCertificate, Optional[Proposal]], None]
        ] = None
        self.on_finalize: Optional[
            Callable[[int, Proposal, list[CommittedSeal]], None]
        ] = None
        # Flight-recorder track: one timeline row per node, so a 6-node
        # height renders as six labeled rows (obs/export.py).  Named after
        # the validator identity when the backend provides one.
        try:
            self._obs_track = "node-" + bytes(backend.id()).hex()[:16]
        except Exception:  # noqa: BLE001 - mocks without a stable id
            self._obs_track = f"node-{id(self) & 0xFFFF:04x}"

    # -- configuration (reference core/ibft.go:1151-1159) -------------------

    def extend_round_timeout(self, amount: float) -> None:
        """Extend each round's timer by ``amount`` seconds."""
        self.additional_timeout = amount

    def set_base_round_timeout(self, base: float) -> None:
        """Set the base (round 0) timeout in seconds."""
        self.base_round_timeout = base

    # ------------------------------------------------------------------
    # sequence loop (reference core/ibft.go:304-395)
    # ------------------------------------------------------------------

    async def run_sequence(
        self, height: int, *, restore: Optional[RestoredState] = None
    ) -> None:
        """Run the IBFT sequence for ``height`` until a proposal is finalized.

        Cancel the surrounding task to abort; the backend's
        ``sequence_cancelled`` callback fires and CancelledError propagates.

        ``restore`` re-enters the height mid-round with a crash-recovered
        prepared-certificate lock (chain/wal.py): the state machine resumes
        in COMMIT for the restored round and re-announces its COMMIT for
        the locked proposal instead of starting the height from scratch.
        """
        start_time = time.monotonic()

        self.state.reset(height)
        self._seal_verdicts.clear()
        self._seal_verdict_count = 0
        self._hash_memo.clear()
        self._accept_ts = None
        self.finalized_certificate = None
        with self._cert_lock:
            for h in [h for h in self._pending_certs if h < height]:
                del self._pending_certs[h]
        # New sequence: drop the verifier's per-message pack cache (same
        # lifecycle as the seal-verdict cache) and tag round 0.
        bv = self.batch_verifier
        if hasattr(bv, "reset_pack_cache"):
            bv.reset_pack_cache()
        if hasattr(bv, "note_round"):
            bv.note_round(0)
        if self.speculator is not None:
            # Pin the live view; verdicts speculated for FUTURE heights
            # survive (that early traffic is the whole point), stale
            # heights drop.
            self.speculator.note_view(height, 0)

        try:
            self.validator_manager.init(height)
        except Exception as err:  # noqa: BLE001 - parity: the reference logs
            # and aborts on any init failure (ibft.go:310-314)
            self.log.error(
                "failed to run sequence - validator manager init",
                height,
                err,
            )
            return

        self.messages.prune_by_height(height)
        # Early traffic for THIS height that arrived while the previous
        # height was finalizing: flush it through the verified ingress path
        # (unless the chain runner's overlap worker already did).
        self._flush_future(height)
        if restore is not None and restore.height == height:
            self._apply_restore(restore)

        self.log.info("sequence started", height)
        trace.instant("sequence.start", track=self._obs_track, height=height)
        try:
            while True:
                view = self.state.view

                try:
                    self.backend.round_starts(view)
                except Exception as err:  # noqa: BLE001 - callback is advisory
                    self.log.error(
                        "failed to handle start round callback on backend", view, err
                    )

                self.log.info("round started", view.round)
                trace.instant(
                    "round.start",
                    track=self._obs_track,
                    height=height,
                    round=view.round,
                )

                current_round = view.round
                signals = _RoundSignals()
                self._signals = signals
                workers = [
                    asyncio.create_task(
                        self._guard_worker(
                            self._start_round_timer(signals, current_round),
                            signals,
                        ),
                        name=f"ibft-timer-h{height}-r{current_round}",
                    ),
                    asyncio.create_task(
                        self._guard_worker(
                            self._watch_for_future_proposal(signals), signals
                        ),
                        name=f"ibft-future-proposal-h{height}-r{current_round}",
                    ),
                    asyncio.create_task(
                        self._guard_worker(
                            self._watch_for_round_change_certificates(signals),
                            signals,
                        ),
                        name=f"ibft-rcc-watch-h{height}-r{current_round}",
                    ),
                    asyncio.create_task(
                        self._guard_worker(self._start_round(signals), signals),
                        name=f"ibft-round-h{height}-r{current_round}",
                    ),
                ]

                async def teardown() -> None:
                    # The reference's cancelRound(); wg.Wait() barrier
                    # (core/ibft.go:349-352): all workers exit before the
                    # next round may start.
                    for task in workers:
                        task.cancel()
                    results = await asyncio.gather(*workers, return_exceptions=True)
                    for task, result in zip(workers, results):
                        if isinstance(result, Exception) and not isinstance(
                            result, asyncio.CancelledError
                        ):
                            self.log.error(
                                "round worker crashed", task.get_name(), result
                            )

                try:
                    await asyncio.wait(
                        signals.all(), return_when=asyncio.FIRST_COMPLETED
                    )
                except asyncio.CancelledError:
                    # ctx cancelled by the embedder (core/ibft.go:383-392)
                    await teardown()
                    try:
                        self.backend.sequence_cancelled(view)
                    except Exception as err:  # noqa: BLE001
                        self.log.error(
                            "failed to handle sequence cancelled callback", view, err
                        )
                    self.log.debug("sequence cancelled")
                    raise

                # Arbitration order: the reference's Go select picks randomly
                # among ready channels (core/ibft.go:354-393), so no signal is
                # ever systematically starved.  Deterministic asyncio must pick
                # an order; round_done goes FIRST: if consensus finished while
                # the loop was busy (e.g. a verifier compile stalled it past the
                # round timer), finishing beats a moot round change — the
                # liveness-safe resolution of the tie the reference leaves to
                # chance.
                if signals.fatal.done():
                    # A worker hit a process-fatal BaseException (simulated
                    # kill -9, KeyboardInterrupt): the sequence ENDS —
                    # letting the round timer replace the dead worker would
                    # keep a "dead" node participating in consensus.
                    await teardown()
                    raise signals.fatal.result()
                elif signals.round_done.done():
                    # Consensus for this height is finished (ibft.go:376-382).
                    await teardown()
                    self._insert_block()
                    return
                elif signals.new_proposal.done():
                    ev: _NewProposalEvent = signals.new_proposal.result()
                    await teardown()
                    self.log.info("received future proposal", ev.round)
                    self._move_to_new_round(ev.round)
                    self._accept_proposal(ev.proposal_message)
                    self.state.set_round_started(True)
                    # NOTE: the reference multicasts this PREPARE with the
                    # view captured at round start, not ev.round
                    # (core/ibft.go:355-362); mirrored bit-for-bit.
                    self._send_prepare_message(view)
                elif signals.round_certificate.done():
                    round_ = signals.round_certificate.result()
                    await teardown()
                    self.log.info("received future RCC", round_)
                    self._move_to_new_round(round_)
                elif signals.round_expired.done():
                    await teardown()
                    self.log.info("round timeout expired", current_round)
                    new_round = current_round + 1
                    self._move_to_new_round(new_round)
                    self._send_round_change_message(height, new_round)
        finally:
            self._signals = None
            set_gauge(("go-ibft", "sequence", "duration"), time.monotonic() - start_time)
            trace.instant("sequence.done", track=self._obs_track, height=height)
            self.log.info("sequence done", height)

    # -- round workers ------------------------------------------------------

    async def _guard_worker(self, coro, signals: _RoundSignals) -> None:
        """Surface process-fatal worker deaths to the round arbitration.

        Ordinary ``Exception`` crashes keep today's semantics (logged at
        teardown; the round retries through its timer).  A non-Exception
        ``BaseException`` — a simulated kill -9 from the chaos harness, a
        KeyboardInterrupt — fires the ``fatal`` signal so ``run_sequence``
        tears the round down immediately and re-raises it, instead of the
        next round silently spawning a replacement worker."""
        try:
            await coro
        except asyncio.CancelledError:
            raise
        except Exception:
            raise
        except BaseException as err:
            # The exception IS the signal value; run_sequence re-raises it.
            signals.fire(signals.fatal, err)
            raise

    async def _start_round_timer(self, signals: _RoundSignals, round_: int) -> None:
        """Exponential round timer worker (reference core/ibft.go:145-165)."""
        start_time = time.monotonic()
        timeout = get_round_timeout(
            self.base_round_timeout, self.additional_timeout, round_
        )
        try:
            await asyncio.sleep(timeout)
            trace.instant(
                "round.timeout",
                track=self._obs_track,
                round=round_,
                timeout_s=timeout,
            )
            signals.fire(signals.round_expired)
        finally:
            set_gauge(("go-ibft", "round", "duration"), time.monotonic() - start_time)

    async def _watch_for_future_proposal(self, signals: _RoundSignals) -> None:
        """Jump rounds on valid proposals for higher rounds
        (reference core/ibft.go:211-253)."""
        view = self.state.view
        height, next_round = view.height, view.round + 1

        sub = self._subscribe(
            SubscriptionDetails(
                message_type=MessageType.PREPREPARE,
                view=View(height=height, round=next_round),
                has_min_round=True,
            )
        )
        try:
            while True:
                round_ = await sub.wait()
                if round_ is None:
                    return
                proposal = self._handle_preprepare(View(height=height, round=round_))
                if proposal is None:
                    continue
                signals.fire(
                    signals.new_proposal, _NewProposalEvent(proposal, round_)
                )
                return
        finally:
            self.messages.unsubscribe(sub.id)

    async def _watch_for_round_change_certificates(
        self, signals: _RoundSignals
    ) -> None:
        """Jump rounds on valid RCCs for higher rounds
        (reference core/ibft.go:258-301)."""
        view = self.state.view
        height, round_ = view.height, view.round

        sub = self._subscribe(
            SubscriptionDetails(
                message_type=MessageType.ROUND_CHANGE,
                view=View(height=height, round=round_ + 1),  # only higher rounds
                has_min_round=True,
            )
        )
        try:
            while True:
                wake = await sub.wait()
                if wake is None:
                    return
                rcc = self._handle_round_change_message(
                    View(height=height, round=round_)
                )
                if rcc is None:
                    continue
                new_round = rcc.round_change_messages[0].view.round
                signals.fire(signals.round_certificate, new_round)
                return
        finally:
            self.messages.unsubscribe(sub.id)

    async def _start_round(self, signals: _RoundSignals) -> None:
        """The per-round state machine worker (reference core/ibft.go:398-429)."""
        self.state.new_round()

        validator_id = self.backend.id()
        view = self.state.view

        if (
            self.backend.is_proposer(validator_id, view.height, view.round)
            and self.state.proposal_message is None
        ):
            # The proposal_message guard covers crash recovery: a restored
            # lock re-enters the round with its proposal already accepted,
            # and re-proposing over it would tear the lock down.
            self.log.info("we are the proposer")

            proposal_message = await self._build_proposal(view)
            if proposal_message is None:
                self.log.error("unable to build proposal")
                return

            self._accept_proposal(proposal_message)
            self.log.debug("block proposal accepted")

            self._send_preprepare_message(proposal_message)
            self.log.debug("pre-prepare message multicasted")

        await self._run_states(signals)

    # -- state machine loop (reference core/ibft.go:554-576) ----------------

    async def _run_states(self, signals: _RoundSignals) -> None:
        while True:
            name = self.state.name
            if name == StateName.NEW_ROUND:
                done = await self._run_new_round()
            elif name == StateName.PREPARE:
                done = await self._run_prepare()
            elif name == StateName.COMMIT:
                done = await self._run_commit()
            else:  # FIN
                signals.fire(signals.round_done)
                return
            if done:
                # Subscription closed from under us (store shut down) — the
                # asyncio analogue of the reference's errTimeoutExpired exit.
                return

    async def _run_new_round(self) -> bool:
        """Wait for and validate a proposal (reference core/ibft.go:579-625).

        Returns True when the engine should stop running states.
        """
        self.log.debug("enter: new round state")
        view = self.state.view
        sub = self._subscribe(
            SubscriptionDetails(message_type=MessageType.PREPREPARE, view=view)
        )
        try:
            while True:
                wake = await sub.wait()
                if wake is None:
                    return True
                with trace.span(
                    "proposal.drain", track=self._obs_track, round=view.round
                ):
                    proposal_message = self._handle_preprepare(view)
                if proposal_message is None:
                    continue

                self._hash_memo.clear()
                self.state.set_proposal_message(proposal_message)
                # Non-proposer accept point: the accept -> finalize
                # latency anchor (the proposer's is _accept_proposal).
                self._accept_ts = time.perf_counter()
                self._send_prepare_message(view)
                self.log.debug("prepare message multicasted")
                self.state.change_state(StateName.PREPARE)
                return False
        finally:
            self.messages.unsubscribe(sub.id)
            self.log.debug("exit: new round state")

    async def _run_prepare(self) -> bool:
        """Wait for a prepare quorum (reference core/ibft.go:816-851)."""
        self.log.debug("enter: prepare state")
        view = self.state.view
        sub = self._subscribe(
            SubscriptionDetails(message_type=MessageType.PREPARE, view=view)
        )
        try:
            while True:
                wake = await sub.wait()
                if wake is None:
                    return True
                # Batched drain arbitration: wakeups queued behind this one
                # are covered by the store re-read below — coalesce them
                # instead of re-draining the phase once per signal.
                sub.drain_pending()
                with trace.span(
                    "prepare.drain", track=self._obs_track, round=view.round
                ):
                    quorum = self._handle_prepare(view)
                if not quorum:
                    continue
                return False
        finally:
            self.messages.unsubscribe(sub.id)
            self.log.debug("exit: prepare state")

    async def _run_commit(self) -> bool:
        """Wait for a commit quorum (reference core/ibft.go:892-927)."""
        self.log.debug("enter: commit state")
        view = self.state.view
        sub = self._subscribe(
            SubscriptionDetails(message_type=MessageType.COMMIT, view=view)
        )
        try:
            while True:
                wake = await sub.wait()
                if wake is None:
                    return True
                # Same coalescing as the prepare drain: the commit drain
                # snapshots the whole view, so stale queued signals only
                # repeat it (each repeat is crypto-free thanks to the seal
                # verdict cache, but still walks the store).
                sub.drain_pending()
                with trace.span(
                    "commit.drain", track=self._obs_track, round=view.round
                ):
                    quorum = self._handle_commit(view)
                if not quorum:
                    continue
                return False
        finally:
            self.messages.unsubscribe(sub.id)
            self.log.debug("exit: commit state")

    # -- message handling ---------------------------------------------------

    def _handle_preprepare(self, view: View) -> Optional[IbftMessage]:
        """Fetch-and-validate proposals for a view (reference core/ibft.go:792-813)."""

        def is_valid_preprepare(message: IbftMessage) -> bool:
            if view.round == 0:
                return self._validate_proposal_0(message, view)
            return self._validate_proposal(message, view)

        msgs = self.messages.get_valid_messages(
            view, MessageType.PREPREPARE, is_valid_preprepare
        )
        return msgs[0] if msgs else None

    def _validate_proposal_common(self, msg: IbftMessage, view: View) -> bool:
        """Validations shared by all rounds (reference core/ibft.go:629-655)."""
        proposal = helpers.extract_proposal(msg)
        proposal_hash = helpers.extract_proposal_hash(msg)

        if proposal is None:
            return False
        # round matches
        if proposal.round != view.round:
            return False
        # sender is the proposer for this view
        if not self.backend.is_proposer(msg.sender, view.height, view.round):
            return False
        # hash matches keccak(proposal)
        if not self.backend.is_valid_proposal_hash(proposal, proposal_hash or b""):
            return False
        # the embedder accepts the proposal body
        return self.backend.is_valid_proposal(proposal.raw_proposal)

    def _validate_proposal_0(self, msg: IbftMessage, view: View) -> bool:
        """Round-0 proposal validation (reference core/ibft.go:658-680)."""
        if msg.view is None or msg.view.round != 0:
            return False
        if not self._validate_proposal_common(msg, view):
            return False
        # we must not be the proposer ourselves
        return not self.backend.is_proposer(self.backend.id(), view.height, view.round)

    def _validate_proposal(self, msg: IbftMessage, view: View) -> bool:
        """Round-N proposal validation with RCC (reference core/ibft.go:683-788)."""
        height, round_ = view.height, view.round
        proposal = helpers.extract_proposal(msg)
        rcc = helpers.extract_round_change_certificate(msg)

        if not self._validate_proposal_common(msg, view):
            return False
        if rcc is None:
            return False
        if not helpers.has_unique_senders(rcc.round_change_messages):
            return False
        if not self._has_quorum_by_msg_type(
            rcc.round_change_messages, MessageType.ROUND_CHANGE
        ):
            return False
        if self.backend.is_proposer(self.backend.id(), height, round_):
            return False

        # Structural checks on every RCC member.
        for rc in rcc.round_change_messages:
            if rc.type != MessageType.ROUND_CHANGE:
                return False
            if rc.view is None or rc.view.height != height:
                return False
            if rc.view.round != round_:
                return False

        # Sender validity: one device batch when available, else per-message
        # (reference loops IsValidValidator per message, ibft.go:718-738).
        if not self._all_senders_valid(rcc.round_change_messages):
            return False

        # maxRound re-proposal rule (reference ibft.go:740-788): among the
        # valid PCs inside the RCC, the proposal must hash-match the prepared
        # proposal of the highest prepared round.
        max_round: Optional[int] = None
        expected_hash: Optional[bytes] = None
        for rc_message in rcc.round_change_messages:
            cert = helpers.extract_latest_pc(rc_message)
            if cert is None or not self._valid_pc(cert, msg.view.round, height):
                continue
            assert cert.proposal_message is not None  # _valid_pc guarantees
            cert_round = cert.proposal_message.view.round
            cert_hash = helpers.extract_proposal_hash(cert.proposal_message)
            if max_round is None or cert_round >= max_round:
                max_round = cert_round
                expected_hash = cert_hash

        if max_round is None:
            return True

        assert proposal is not None  # _validate_proposal_common guarantees
        return self.backend.is_valid_proposal_hash(
            Proposal(raw_proposal=proposal.raw_proposal, round=max_round),
            expected_hash or b"",
        )

    def _handle_prepare(self, view: View) -> bool:
        """Drain PREPAREs; move to commit on quorum (reference core/ibft.go:855-889).

        NO cryptography here, by design: every stored PREPARE already had
        its envelope signature recovered and membership-checked at ingress
        (``add_message``/``add_messages`` — the device-batched path at
        scale), so the phase check is a cheap host predicate (proposal-hash
        equality) plus the exact big-int prepare quorum.  Re-verifying the
        envelopes per wakeup — the earlier "fused phase" design — burned
        one full batch of signature recoveries on EVERY prepare arrival;
        the fused device programs (``ops/quorum``) remain the data plane
        for ingress floods and certificate validation, where the
        signatures genuinely have not been seen before."""

        def is_valid_prepare(message: IbftMessage) -> bool:
            proposal = self.state.proposal
            if proposal is None:
                return False
            return self._proposal_hash_ok(
                proposal, helpers.extract_prepare_hash(message) or b""
            )

        prepare_messages = self.messages.get_valid_messages(
            view, MessageType.PREPARE, is_valid_prepare
        )

        if not self._has_quorum_by_msg_type(prepare_messages, MessageType.PREPARE):
            return False

        certificate = PreparedCertificate(
            proposal_message=self.state.proposal_message,
            prepare_messages=prepare_messages,
        )
        proposal = self.state.proposal
        self.state.finalize_prepare(certificate, proposal)
        if self.on_lock is not None:
            # The WAL's in-flight lock record, made durable BEFORE the
            # commit multicast below: once a COMMIT for this proposal can
            # exist on the network, a crash-and-restart of this node must
            # find the lock and can never prepare a different proposal for
            # the height (the reference orders send-then-state in memory,
            # ibft.go:855-889; with persistence in the loop the lock has
            # to lead).  A FAILED append therefore withholds the COMMIT —
            # the node stays locked in memory and still finalizes from its
            # peers' commits, it just contributes no commit of its own
            # this round (safety over one node's liveness share; sending
            # anyway would re-open the equivocation window the ordering
            # exists to close).
            try:
                self.on_lock(view.height, view.round, certificate, proposal)
            except Exception as err:  # noqa: BLE001 - degrade, don't equivocate
                self.log.error(
                    "lock hook failed; commit withheld", view, err
                )
                return True
        self._send_commit_message(view)
        self.log.debug("commit message multicasted")
        return True

    def _handle_commit(self, view: View) -> bool:
        """Drain COMMITs; move to fin on quorum (reference core/ibft.go:931-967).

        With a batch verifier this is the seal hot path: committed seals
        are NEW cryptographic material (not covered by the ingress envelope
        check), verified in batches at first sight and cached by identity
        (``_seal_verdicts``), so each seal costs exactly one recover no
        matter how many wakeups the phase takes.  The quorum reduction is
        exact host ints over the cached-valid set.

        Aggregate short-circuit: a pending quorum certificate for this
        height that hash-matches the accepted proposal and verifies (ONE
        pairing, quorum power from the signer bitmap) finalizes the
        height immediately — no per-sender COMMIT quorum needed, which is
        what makes tree-aggregated dissemination O(1) wire per node.
        """
        if self._certificate_finalizes(view):
            return True
        commit_messages = self._drain_valid_commits(view)
        if not self._has_quorum_by_msg_type(commit_messages, MessageType.COMMIT):
            return False

        try:
            commit_seals = helpers.extract_committed_seals(commit_messages)
        except helpers.WrongCommitMessageTypeError as err:  # safe check
            self.log.error("failed to extract committed seals", err)
            return False

        self.state.set_committed_seals(commit_seals)
        self.state.change_state(StateName.FIN)
        return True

    def _drain_valid_commits(self, view: View) -> list[IbftMessage]:
        """Validity-filtered COMMIT drain — batched when possible."""
        proposal = self.state.proposal

        if self.batch_verifier is None or proposal is None:
            # Reference path: per-message predicates inside the store lock.
            def is_valid_commit(message: IbftMessage) -> bool:
                proposal_hash = helpers.extract_commit_hash(message)
                committed_seal = helpers.extract_committed_seal(message)
                if proposal is None or committed_seal is None:
                    return False
                if not self._proposal_hash_ok(proposal, proposal_hash or b""):
                    return False
                return self.backend.is_valid_committed_seal(
                    proposal_hash or b"", committed_seal, view.height
                )

            return self.messages.get_valid_messages(
                view, MessageType.COMMIT, is_valid_commit
            )

        # Batched path: snapshot, one host pass for the (cheap) hash
        # equality, then verification of the seals this engine has never
        # verified before — repeat wakeups in the same phase re-verify
        # nothing (the verdict cache keys on the seal bytes themselves, so
        # a store-evicting rewrite from the same sender re-verifies).
        # Fresh seals first consult the SPECULATION cache (verdicts the
        # off-path worker produced while the phase was closed;
        # the lookup binds height, round, carried hash, sender and
        # signature, so a speculated verdict for proposal H can never
        # certify H' at the same height/round), then drain with quorum
        # EARLY-EXIT when the verifier supports it: verification stops at
        # the exact voting-power quorum and the unverified remainder
        # resolves lazily off-path.  Deferred lanes are neither valid nor
        # invalid this wakeup — they stay in the store untouched.
        candidates, invalid = self._collect_commit_candidates(view, proposal)
        valid_messages: list[IbftMessage] = []
        if candidates:
            round_cache = self._seal_verdicts.setdefault(view.round, {})
            keys = [
                (m.sender, phash, seal.signature)
                for m, phash, seal in candidates
            ]
            verdicts = {k: round_cache[k] for k in keys if k in round_cache}
            fresh = [i for i, k in enumerate(keys) if k not in verdicts]
            stored = 0

            def note(i: int, ok: bool) -> None:
                nonlocal stored
                verdicts[keys[i]] = ok
                round_cache[keys[i]] = ok
                stored += 1

            if fresh and self.speculator is not None:
                missed = []
                for i in fresh:
                    hit = self.speculator.lookup_seal(
                        view.height,
                        view.round,
                        keys[i][1],
                        keys[i][0],
                        keys[i][2],
                    )
                    if hit is None:
                        missed.append(i)
                    else:
                        note(i, bool(hit))
                fresh = missed
            deferred: list[int] = []
            if fresh:
                deferred = self._verify_fresh_seals(
                    view, candidates, keys, fresh, verdicts, note
                )
            mask = [verdicts.get(k) for k in keys]
            for (message, _, _), ok in zip(candidates, mask):
                if ok is None:
                    continue  # deferred: not valid, not pruned
                if ok:
                    valid_messages.append(message)
                else:
                    invalid.append(message)
            if deferred and not self._has_quorum_by_msg_type(
                valid_messages, MessageType.COMMIT
            ):
                # Early-exit misprediction (the incremental tally and the
                # exact quorum check disagreed): resolve the remainder NOW
                # — liveness must never wait on an off-path worker, since
                # no further wakeup is guaranteed.
                fresh_mask = self.batch_verifier.verify_committed_seals(
                    candidates[0][1],
                    [candidates[i][2] for i in deferred],
                    view.height,
                )
                for i, ok in zip(deferred, fresh_mask):
                    note(i, bool(ok))
                    if bool(ok):
                        valid_messages.append(candidates[i][0])
                    else:
                        invalid.append(candidates[i][0])
                deferred = []
            elif deferred and self.speculator is not None:
                # Quorum certified without them: the remainder resolves
                # lazily off-path and a later wakeup (or nothing at all)
                # sees the verdicts as cache hits.
                self.speculator.submit_seal_lanes(
                    view.height,
                    view.round,
                    candidates[0][1],
                    [
                        (candidates[i][0].sender, candidates[i][2])
                        for i in deferred
                    ],
                )
            if stored:
                self._seal_verdict_count += stored
                self._evict_seal_verdicts(view.round)

        if invalid:
            self.messages.remove_messages(view, MessageType.COMMIT, invalid)
        return valid_messages

    def _verify_fresh_seals(
        self, view: View, candidates, keys, fresh, verdicts, note
    ) -> list[int]:
        """Verify the fresh commit-seal lanes, early-exiting at quorum.

        Returns the lanes left unverified (deferred).  Without an
        early-exit-capable verifier — or with ``commit_early_exit``
        off — this is the original one-batch drain and nothing defers.
        """
        early = (
            getattr(self.batch_verifier, "verify_seals_early_exit", None)
            if self.commit_early_exit
            else None
        )
        if early is None:
            fresh_mask = self.batch_verifier.verify_committed_seals(
                candidates[0][1],
                [candidates[i][2] for i in fresh],
                view.height,
            )
            for i, ok in zip(fresh, fresh_mask):
                note(i, bool(ok))
            return []
        # Power already certified by cached/speculated verdicts shrinks
        # the drain's stop threshold (distinct senders: the store holds
        # one slot per sender, so candidate senders never repeat).
        certified = sum(
            self.validator_manager.power_of(candidates[i][0].sender)
            for i, k in enumerate(keys)
            if verdicts.get(k)
        )
        remaining = max(0, self.validator_manager.quorum_size - certified)
        report = early(
            candidates[0][1],
            [candidates[i][2] for i in fresh],
            view.height,
            threshold=remaining,
        )
        deferred: list[int] = []
        for j, i in enumerate(fresh):
            if report.verified[j]:
                note(i, bool(report.mask[j]))
            else:
                deferred.append(i)
        return deferred

    def _evict_seal_verdicts(self, current_round: int) -> None:
        """Oldest-round-first seal-verdict eviction.

        A Byzantine seal-rewrite flood (fresh seal bytes per delivery mint
        fresh cache keys) competes first with verdicts from rounds the
        engine has already left behind; only when the live round is all
        that remains does it evict within itself (FIFO there — insertion
        order is verification order)."""
        while self._seal_verdict_count > self._seal_verdict_cap:
            oldest = min(self._seal_verdicts)
            bucket = self._seal_verdicts[oldest]
            if oldest == current_round:
                bucket.pop(next(iter(bucket)))
                self._seal_verdict_count -= 1
                if not bucket:
                    del self._seal_verdicts[oldest]
            else:
                self._seal_verdict_count -= len(bucket)
                del self._seal_verdicts[oldest]

    # -- aggregate quorum certificates ------------------------

    def add_quorum_certificate(self, cert) -> bool:
        """Feed an aggregate COMMIT certificate into the engine (thread-
        safe; the aggregation-tree transport's delivery seam).

        The certificate is NOT verified here — verification (one pairing
        equation) runs in the COMMIT drain on the event loop, where the
        accepted proposal is stable and the cost is attributed to the
        phase span.  Bounded exactly like the future-message buffer: one
        pending slot for the live height and one for the next (latest
        certificate wins a slot; anything staler or further ahead drops).
        Returns True when the certificate was buffered.
        """
        if self.cert_verifier is None or cert is None:
            return False
        height = getattr(cert, "height", None)
        if not isinstance(height, int):
            return False
        state_height = self.state.height
        if not state_height <= height <= state_height + 1:
            return False
        with self._cert_lock:
            self._pending_certs[height] = cert
        # Wake the COMMIT drain; the subscription re-checks the store AND
        # the pending slot, so a cert arriving before the engine enters
        # COMMIT is found by the phase's subscribe-then-recheck.
        self.messages.signal_event(MessageType.COMMIT, self.state.view)
        return True

    def _take_pending_cert(self, height: int):
        with self._cert_lock:
            return self._pending_certs.pop(height, None)

    def _certificate_finalizes(self, view: View) -> bool:
        """Try to finalize the view from a pending aggregate certificate.

        Acceptance requires: a verifier is configured, the certificate's
        proposal hash matches the ACCEPTED proposal (so a certificate can
        never finalize a proposal this node did not validate), and the
        certificate verifies — signer bitmap resolves inside the height's
        validator set, combined voting power reaches quorum, and the one
        pairing equation holds.  A failing certificate is dropped (the
        normal per-seal path continues; a fresh certificate can arrive).
        """
        cert = self._take_pending_cert(view.height)
        if cert is None or self.cert_verifier is None:
            return False
        proposal = self.state.proposal
        accepted_hash = self.state.proposal_hash
        if (
            proposal is None
            or accepted_hash is None
            or getattr(cert, "proposal_hash", None) != accepted_hash
        ):
            # Not consumable YET — re-buffer instead of dropping: the hub
            # broadcasts a certified key exactly once, and under tree
            # dissemination the certificate may be this node's ONLY
            # commit evidence.  An equivocation victim that accepted P'
            # while the quorum certified P re-finds the certificate here
            # after the round change lands it on P (a newer certificate
            # arriving meanwhile wins the slot — never overwrite it with
            # a stale one).  The re-check per wakeup is a bytes compare.
            with self._cert_lock:
                self._pending_certs.setdefault(view.height, cert)
            return False
        with trace.span(
            "commit.cert_verify", track=self._obs_track, round=view.round
        ):
            try:
                ok = bool(self.cert_verifier.verify(cert))
            except Exception as err:  # noqa: BLE001 - a bad cert must not
                # take down the round; per-seal COMMITs still finalize it
                self.log.error("quorum certificate verification crashed", err)
                ok = False
        if not ok:
            self.log.debug("quorum certificate rejected")
            return False
        trace.instant(
            "commit.cert_finalize",
            track=self._obs_track,
            height=view.height,
            signers=len(cert.signer_indices())
            if hasattr(cert, "signer_indices")
            else None,
        )
        self.finalized_certificate = cert
        self.state.set_committed_seals([cert.to_seal()])
        self.state.change_state(StateName.FIN)
        return True

    def _proposal_hash_ok(self, proposal: Proposal, hash_: bytes) -> bool:
        """Memoized ``backend.is_valid_proposal_hash`` against the accepted
        proposal.  The accepted proposal is fixed until the round moves (the
        memo is cleared at every point that changes it), so each distinct
        carried hash costs ONE backend keccak per round instead of one per
        message per wakeup.  Bounded: a flood of distinct bogus hashes
        clears the memo rather than growing it."""
        hit = self._hash_memo.get(hash_)
        if hit is None:
            if len(self._hash_memo) >= self._hash_memo_cap:
                self._hash_memo.clear()
            hit = self.backend.is_valid_proposal_hash(proposal, hash_)
            self._hash_memo[hash_] = hit
        return hit

    def _collect_commit_candidates(
        self, view: View, proposal: Optional[Proposal]
    ) -> tuple[list[tuple[IbftMessage, bytes, CommittedSeal]], list[IbftMessage]]:
        """Snapshot the view's COMMITs and split into hash-valid candidates
        (message, hash, seal) vs invalid messages (shared by the batched and
        fused drains so their pruning semantics cannot diverge)."""
        candidates: list[tuple[IbftMessage, bytes, CommittedSeal]] = []
        invalid: list[IbftMessage] = []
        for message in self.messages.snapshot_view(view, MessageType.COMMIT):
            proposal_hash = helpers.extract_commit_hash(message)
            committed_seal = helpers.extract_committed_seal(message)
            if (
                committed_seal is None
                or not self._proposal_hash_ok(proposal, proposal_hash or b"")
            ):
                invalid.append(message)
                continue
            candidates.append((message, proposal_hash or b"", committed_seal))
        return candidates, invalid

    def _all_senders_valid(self, msgs: Sequence[IbftMessage]) -> bool:
        """IsValidValidator over a message set — batched when possible."""
        if not msgs:
            return True
        if self.batch_verifier is not None:
            mask = self.batch_verifier.verify_senders(list(msgs))
            return bool(all(bool(x) for x in mask))
        return all(self.backend.is_valid_validator(m) for m in msgs)

    # -- round change / certificates ----------------------------------------

    async def _wait_for_rcc(
        self, height: int, round_: int
    ) -> Optional[RoundChangeCertificate]:
        """Block until a valid RCC materializes (reference core/ibft.go:432-466)."""
        view = View(height=height, round=round_)
        sub = self._subscribe(
            SubscriptionDetails(message_type=MessageType.ROUND_CHANGE, view=view)
        )
        try:
            while True:
                wake = await sub.wait()
                if wake is None:
                    return None
                rcc = self._handle_round_change_message(view)
                if rcc is None:
                    continue
                return rcc
        finally:
            self.messages.unsubscribe(sub.id)

    def _handle_round_change_message(
        self, view: View
    ) -> Optional[RoundChangeCertificate]:
        """Validate RC messages and build an RCC (reference core/ibft.go:470-512)."""
        height = view.height
        has_accepted_proposal = self.state.proposal is not None

        def is_valid_msg(msg: IbftMessage) -> bool:
            proposal = helpers.extract_last_prepared_proposal(msg)
            certificate = helpers.extract_latest_pc(msg)
            if msg.view is None:
                return False
            if not self._valid_pc(certificate, msg.view.round, height):
                return False
            return self._proposal_matches_certificate(proposal, certificate)

        def is_valid_rcc(round_: int, msgs: list[IbftMessage]) -> bool:
            # Accept an RCC for our own round only if we have not accepted a
            # proposal in it (reference ibft.go:489-497).
            if round_ == view.round and has_accepted_proposal:
                return False
            return self._has_quorum_by_msg_type(msgs, MessageType.ROUND_CHANGE)

        extended_rcc = self.messages.get_extended_rcc(
            height, is_valid_msg, is_valid_rcc
        )
        if not extended_rcc:
            return None
        return RoundChangeCertificate(round_change_messages=list(extended_rcc))

    def _proposal_matches_certificate(
        self,
        proposal: Optional[Proposal],
        certificate: Optional[PreparedCertificate],
    ) -> bool:
        """PC must accompany — and hash-match — a prepared proposal
        (reference core/ibft.go:516-551)."""
        if proposal is None and certificate is None:
            return True
        if certificate is None:
            return False
        # NOTE: proposal may be None here with a set certificate; like the
        # reference we defer to the hash check (IsValidProposalHash(nil, ..)).
        hashes: list[bytes] = [
            helpers.extract_proposal_hash(certificate.proposal_message) or b""
            if certificate.proposal_message is not None
            else b""
        ]
        for msg in certificate.prepare_messages or ():
            hashes.append(helpers.extract_prepare_hash(msg) or b"")

        return all(
            self.backend.is_valid_proposal_hash(
                proposal if proposal is not None else Proposal(), h
            )
            for h in hashes
        )

    def _valid_pc(
        self,
        certificate: Optional[PreparedCertificate],
        round_limit: int,
        height: int,
    ) -> bool:
        """Prepared-certificate validity (reference core/ibft.go:1161-1231)."""
        if certificate is None:
            # PCs that are not set are valid by default.
            return True

        if certificate.proposal_message is None or certificate.prepare_messages is None:
            return False

        all_messages = [certificate.proposal_message, *certificate.prepare_messages]

        # Quorum over PP+P senders (mixed types: use HasQuorum directly).
        if not self.validator_manager.has_quorum(senders_of(all_messages)):
            return False

        if certificate.proposal_message.type != MessageType.PREPREPARE:
            return False
        if any(
            m.type != MessageType.PREPARE for m in certificate.prepare_messages
        ):
            return False

        # Same height/round/hash, unique senders.
        if not helpers.are_valid_pc_messages(all_messages, height, round_limit):
            return False

        proposal_msg = certificate.proposal_message
        if proposal_msg.view is None:
            return False
        if not self.backend.is_proposer(
            proposal_msg.sender, proposal_msg.view.height, proposal_msg.view.round
        ):
            return False

        # Sender signatures: proposal + each prepare (batched when possible).
        if not self._all_senders_valid(all_messages):
            return False

        # Prepare messages must come from validators that are NOT the
        # proposer for their view.
        for message in certificate.prepare_messages:
            if message.view is None:
                return False
            if self.backend.is_proposer(
                message.sender, message.view.height, message.view.round
            ):
                return False

        return True

    # -- proposal building (reference core/ibft.go:1005-1091) ---------------

    async def _build_proposal(self, view: View) -> Optional[IbftMessage]:
        height, round_ = view.height, view.round

        if round_ == 0:
            raw_proposal = self.backend.build_proposal(View(height=height, round=round_))
            return self.backend.build_preprepare_message(
                raw_proposal, None, View(height=height, round=round_)
            )

        # round > 0 needs an RCC
        rcc = await self._wait_for_rcc(height, round_)
        if rcc is None:
            return None  # store shut down

        # Re-propose the prepared proposal of the highest prepared round
        # carried inside the RCC, if any (maxRound rule, ibft.go:1036-1063).
        previous_proposal: Optional[bytes] = None
        max_round = 0
        for msg in rcc.round_change_messages:
            latest_pc = helpers.extract_latest_pc(msg)
            if latest_pc is None or latest_pc.proposal_message is None:
                continue
            proposal = helpers.extract_proposal(latest_pc.proposal_message)
            if proposal is None:
                continue
            cert_round = proposal.round
            if previous_proposal is not None and cert_round <= max_round:
                continue
            last_pb = helpers.extract_last_prepared_proposal(msg)
            if last_pb is None:
                continue
            previous_proposal = last_pb.raw_proposal
            max_round = cert_round

        if previous_proposal is None:
            raw_proposal = self.backend.build_proposal(View(height=height, round=round_))
            return self.backend.build_preprepare_message(
                raw_proposal, rcc, View(height=height, round=round_)
            )

        return self.backend.build_preprepare_message(
            previous_proposal, rcc, View(height=height, round=round_)
        )

    # -- inbound path (reference core/ibft.go:1101-1149) --------------------

    def _record_recv(self, message: IbftMessage) -> None:
        """``net.recv`` instant for a delivered traced message.

        Called from the ingress paths with tracing already known enabled.
        Loopback dispatch hands the SAME message object to every engine,
        so the context is never mutated here — each receiver records its
        own instant on its own track; a socket transport that already
        recorded at the wire boundary sets ``ctx.recorded`` and is
        skipped.  A message re-entering ingress via the future-buffer
        flush may record twice on one node; the timeline tool keys on
        first arrival per (node, origin), so duplicates are harmless
        (chaos duplication produces them anyway).
        """
        ctx = getattr(message, "trace_ctx", None)
        if ctx is None or ctx.recorded:
            return
        trace.instant(
            "net.recv",
            track=self._obs_track,
            origin=ctx.origin,
            height=ctx.height,
            round=ctx.round,
            type=int(message.type),
            span=ctx.span_id,
            sent_us=ctx.sent_us,
        )

    def add_message(self, message: Optional[IbftMessage]) -> None:
        """Feed one message into the engine (thread-safe).

        Validates the sender signature eagerly, stores, and signals
        subscribers when the view's message set became quorum-capable.
        """
        if message is None:
            return
        if trace.enabled():
            self._record_recv(message)
        if not self._is_acceptable_message(message):
            self._buffer_future(message)
            return
        self.messages.add_message(message)
        self._speculate([message])
        self._signal_if_quorum(message.view, message.type)

    def add_messages(self, batch: Sequence[IbftMessage]) -> None:
        """Batched inbound path — the device-batched ingress.

        Sender signatures for the whole batch are verified in one device call
        (when a batch verifier is present), then each message passes the same
        height/round acceptance gate as ``add_message``.  Observable semantics
        match N calls to ``add_message``; cost is one kernel launch.
        """
        if not batch:
            return
        if trace.enabled():
            for m in batch:
                self._record_recv(m)
        with trace.span(
            "ingress.batch", track=self._obs_track, lanes=len(batch)
        ):
            gated = []
            for m in batch:
                if self._gate_height_round(m):
                    gated.append(m)
                else:
                    self._buffer_future(m)
            if self.batch_verifier is not None:
                mask = self.batch_verifier.verify_senders(gated)
                accepted = [m for m, ok in zip(gated, mask) if bool(ok)]
            else:
                accepted = [
                    m for m in gated if self.backend.is_valid_validator(m)
                ]

        # Store everything first, then signal once per (view, type) key —
        # signaling mid-batch could find quorum incomplete and never re-check.
        to_signal: dict[tuple[int, int, int], tuple[View, object]] = {}
        for message in accepted:
            self.messages.add_message(message)
            if message.view is not None:
                key = (message.view.height, message.view.round, int(message.type))
                to_signal.setdefault(key, (message.view, message.type))
        self._speculate(accepted)
        for view, message_type in to_signal.values():
            self._signal_if_quorum(view, message_type)

    def add_verified_messages(self, batch: Sequence[IbftMessage]) -> None:
        """Store messages whose envelope signatures the caller has ALREADY
        verified through this engine's own verifier.

        The chain runner's cross-height overlap worker uses this: it
        drains the future-height buffer and batch-verifies the envelopes
        while the previous height's COMMIT drain is still in flight, then
        hands the survivors over here — no re-verification, no height gate
        (the messages are for a height the engine has not reached yet; the
        store keys them by their own view and ``run_sequence`` finds them
        via subscribe-then-recheck).  NEVER feed this from an unverified
        source: the store's last-write-wins dedup would let a forged
        sender evict a genuine message.
        """
        to_signal: dict[tuple[int, int, int], tuple[View, object]] = {}
        stored: list[IbftMessage] = []
        for message in batch:
            if message.view is None or not isinstance(message.type, MessageType):
                continue
            self.messages.add_message(message)
            stored.append(message)
            key = (message.view.height, message.view.round, int(message.type))
            to_signal.setdefault(key, (message.view, message.type))
        self._speculate(stored)
        for view, message_type in to_signal.values():
            self._signal_if_quorum(view, message_type)

    def _speculate(self, msgs: Sequence[IbftMessage]) -> None:
        """Queue stored COMMITs' seals for off-path speculative
        verification (no-op without a speculator).  Runs AFTER the store
        insert so a verdict can never exist for a message the store
        rejected; the cache key binds the carried proposal hash, so the
        verdict is only ever a hit when the drain's accepted proposal
        matches."""
        if self.speculator is None or not msgs:
            return
        try:
            self.speculator.submit_commit_messages(msgs)
        except Exception as err:  # noqa: BLE001 - speculation is advisory
            self.log.debug("speculative submit failed", err)

    # -- future-height buffer (chain handoff support) -----------------------

    def _buffer_future(self, message: Optional[IbftMessage]) -> bool:
        """Hold a message ONE height ahead (bounded, deduped).

        Anything further ahead is dropped: consensus only ever needs the
        NEXT height's early traffic, and an unbounded horizon is an
        unbounded spam surface.  Dedup key (type, height, round, sender)
        matches the store's slot rule with last-write-wins.  PREPREPAREs
        alone get ``future_proposal_horizon`` heights (see __init__: one
        proposal per height per sender, and a dropped one is a liveness
        wedge)."""
        if message is None or message.view is None:
            return False
        if not isinstance(message.type, MessageType):
            return False
        view = message.view
        horizon = (
            self.future_proposal_horizon
            if message.type == MessageType.PREPREPARE
            else 1
        )
        if not self.state.height < view.height <= self.state.height + horizon:
            return False
        # Membership pre-filter on the CLAIMED sender (no signature work):
        # without it, forged identities fill future_cap_total for free and
        # starve genuine validators' early traffic every height.  A
        # non-member claim can never verify at flush anyway; when the
        # embedder cannot answer for a future height, fall through — the
        # caps still bound the buffer.
        try:
            if message.sender not in self.backend.get_voting_powers(
                view.height
            ):
                return False
        except Exception:  # noqa: BLE001 - unknown future set: caps bound it
            pass
        key = (int(message.type), view.height, view.round, message.sender)
        with self._future_lock:
            per_sender = self._future_buffer.setdefault(message.sender, {})
            slot = per_sender.get(key)
            if slot is not None:
                # Each slot keeps the FIRST and the LATEST candidate.  The
                # buffer holds UNVERIFIED messages, so plain last-write-
                # wins would let a forged-sender message evict a genuine
                # buffered one (and first-write-wins would let a forgery
                # that raced ahead pin the slot).  With both ends kept,
                # the genuine message survives either arrival order; the
                # flush verifies all candidates and the store's own
                # (verified) last-write-wins dedup settles the slot.
                if len(slot) == 1:
                    slot.append(message)
                    self._future_count += 1
                else:
                    slot[1] = message
                return True
            if (
                len(per_sender) >= self.future_cap_per_sender
                or self._future_count >= self.future_cap_total
            ):
                if not per_sender:
                    del self._future_buffer[message.sender]
                return False
            per_sender[key] = [message]
            self._future_count += 1
        return True

    def take_future_messages(self, height: int) -> list[IbftMessage]:
        """Pop every buffered message for ``height``; drop anything staler.

        Called by ``run_sequence(height)`` at height start (the default
        flush) and by the chain runner's overlap worker, which pre-verifies
        the batch off the critical path and re-inserts the survivors via
        :meth:`add_verified_messages`."""
        out: list[IbftMessage] = []
        with self._future_lock:
            for sender in list(self._future_buffer):
                per_sender = self._future_buffer[sender]
                for key in list(per_sender):
                    if key[1] <= height:
                        slot = per_sender.pop(key)
                        self._future_count -= len(slot)
                        if key[1] == height:
                            out.extend(slot)
                if not per_sender:
                    del self._future_buffer[sender]
        return out

    @property
    def future_buffered(self) -> int:
        with self._future_lock:
            return self._future_count

    def future_commit_evidence(self, height: int) -> int:
        """Combined voting power of the distinct senders with buffered
        COMMITs for ``height`` — in the same units as
        ``validator_manager.quorum_size``, so weighted validator sets
        compare correctly (a raw sender count never reaches a
        power-denominated quorum).

        The chain layer's fall-behind tripwire: a quorum's worth of
        COMMITs for a FUTURE height means peers are finalizing past this
        node — consensus here cannot catch up, only block sync can.  The
        senders are not signature-verified yet (the buffer holds raw
        ingress; unknown senders weigh zero), so callers treat the value
        as a hint: the sync path re-verifies every fetched block against
        real quorums, making a spoofed trigger a wasted poll, never a
        wrong chain."""
        commit = int(MessageType.COMMIT)
        with self._future_lock:
            senders = [
                sender
                for sender, per_sender in self._future_buffer.items()
                if any(
                    key[0] == commit and key[1] == height
                    for key in per_sender
                )
            ]
        return sum(self.validator_manager.power_of(s) for s in senders)

    def _flush_future(self, height: int) -> None:
        batch = self.take_future_messages(height)
        if batch:
            self.add_messages(batch)

    def _apply_restore(self, restore: RestoredState) -> None:
        """Re-enter a height mid-round from a WAL lock record.

        The restored engine resumes in COMMIT for the locked round with
        the PC pinned (``latest_pc``), so its ROUND_CHANGE messages carry
        the certificate and it can never prepare a different proposal for
        this height — the no-equivocation recovery invariant.  It also
        re-announces its COMMIT: the seal is rebuilt from the same key
        over the same proposal hash, which peers dedup by sender."""
        certificate = restore.certificate
        self.state.set_view(View(height=restore.height, round=restore.round))
        if hasattr(self.batch_verifier, "note_round"):
            self.batch_verifier.note_round(restore.round)
        if certificate is not None and certificate.proposal_message is not None:
            proposal = helpers.extract_proposal(certificate.proposal_message)
            self.state.set_proposal_message(certificate.proposal_message)
            self.state.finalize_prepare(certificate, proposal)
            self.state.set_round_started(True)
            self._send_commit_message(self.state.view)
        trace.instant(
            "sequence.restore",
            track=self._obs_track,
            height=restore.height,
            round=restore.round,
            locked=certificate is not None,
        )

    def _signal_if_quorum(self, view: Optional[View], message_type) -> None:
        """Signal subscribers when quorum became possible
        (reference core/ibft.go:1111-1121)."""
        if view is None or view.height != self.state.height:
            return
        msgs = self.messages.get_valid_messages(view, message_type, lambda _m: True)
        if self._has_quorum_by_msg_type(msgs, message_type):
            self.messages.signal_event(message_type, view)

    def _is_acceptable_message(self, message: IbftMessage) -> bool:
        """Inbound acceptance gate (reference core/ibft.go:1126-1149).

        Signature verification is NEVER deferred past the store: the store
        dedups by (type, height, round, sender) with last-write-wins, so an
        unverified message with a forged ``sender`` field could evict a
        validator's genuine stored message and break round liveness.  Batch
        ingress (:meth:`add_messages`) keeps the same gate, just amortized
        over one device call per burst.
        """
        if not self._gate_height_round(message):
            return False
        # sender signature + validator-set membership (embedder crypto)
        return self.backend.is_valid_validator(message)

    def _gate_height_round(self, message: IbftMessage) -> bool:
        if message.view is None:
            return False
        # Unknown open-enum types preserved by the wire codec are not
        # consensus messages: reject at the ingress gate so the signal path
        # never consults the store with a type it has no key for.
        if not isinstance(message.type, MessageType):
            return False
        state_height = self.state.height
        if state_height > message.view.height:
            return False
        if state_height == message.view.height:
            return message.view.round >= self.state.round
        # Future heights never enter the store through the gate: height+1
        # goes through the bounded dedup buffer (the ingress paths call
        # _buffer_future on gate failure), anything further is dropped —
        # the old "accept any future height" rule let one spammer grow the
        # store without bound.
        return False

    # -- quorum dispatch (reference core/ibft.go:1272-1284) -----------------

    def _has_quorum_by_msg_type(
        self, msgs: Sequence[IbftMessage], message_type
    ) -> bool:
        if message_type == MessageType.PREPREPARE:
            return len(msgs) >= 1
        if message_type == MessageType.PREPARE:
            return self.validator_manager.has_prepare_quorum(
                self.state.name, self.state.proposal_message, msgs
            )
        if message_type in (MessageType.ROUND_CHANGE, MessageType.COMMIT):
            return self.validator_manager.has_quorum(senders_of(msgs))
        return False

    def _subscribe(self, details: SubscriptionDetails):
        """Subscribe-then-recheck (closes the missed-message race;
        reference core/ibft.go:1286-1298).  A pending aggregate quorum
        certificate counts as a COMMIT wake condition — under tree-
        aggregated dissemination the certificate may be the ONLY commit
        evidence this node ever receives, so missing it would stall the
        phase forever."""
        subscription = self.messages.subscribe(details)
        msgs = self.messages.get_valid_messages(
            details.view, details.message_type, lambda _m: True
        )
        if self._has_quorum_by_msg_type(msgs, details.message_type):
            self.messages.signal_event(details.message_type, details.view)
        elif (
            details.message_type == MessageType.COMMIT
            and self.cert_verifier is not None
        ):
            with self._cert_lock:
                pending = details.view.height in self._pending_certs
            if pending:
                self.messages.signal_event(details.message_type, details.view)
        return subscription

    # -- state helpers ------------------------------------------------------

    def _move_to_new_round(self, round_: int) -> None:
        """(reference core/ibft.go:994-1003)"""
        trace.instant("round.change", track=self._obs_track, round=round_)
        self._hash_memo.clear()
        # Round advance drives the pack cache's oldest-round-first eviction
        # (entries packed for dead rounds yield before the live round's).
        if hasattr(self.batch_verifier, "note_round"):
            self.batch_verifier.note_round(round_)
        if self.speculator is not None:
            self.speculator.note_view(self.state.height, round_)
        self.state.set_view(View(height=self.state.height, round=round_))
        self.state.set_round_started(False)
        self.state.set_proposal_message(None)
        self.state.change_state(StateName.NEW_ROUND)

    def _accept_proposal(self, proposal_message: IbftMessage) -> None:
        """Accept a proposal and move to PREPARE (reference core/ibft.go:1094-1098)."""
        trace.instant(
            "proposal.accept", track=self._obs_track, round=self.state.round
        )
        # accept -> finalize latency anchor (one clock read per proposal;
        # the histogram itself records only when fixed histograms are on).
        self._accept_ts = time.perf_counter()
        self._hash_memo.clear()
        self.state.set_proposal_message(proposal_message)
        self.state.change_state(StateName.PREPARE)

    def _insert_block(self) -> None:
        """Insert the finalized block and GC (reference core/ibft.go:978-991).

        The step order is the chain layer's crash-consistency contract:
        finalize (insert_proposal) -> on_finalize (the WAL's fsynced
        append) -> prune.  A crash between any two steps never loses a
        finalized height — before the WAL append the store still holds the
        commit-quorum evidence (nothing pruned yet), after it the height
        is durable.  on_finalize is deliberately NOT exception-guarded: a
        WAL that cannot append must stop the height from pruning the only
        other copy of its evidence (chaos kill-point test pins this)."""
        height = self.state.height
        proposal = Proposal(
            raw_proposal=self.state.raw_proposal or b"",
            round=self.state.round,
        )
        seals = self.state.committed_seals
        if self._accept_ts is not None:
            metrics.observe_fixed(
                ACCEPT_FINALIZE_MS_KEY,
                (time.perf_counter() - self._accept_ts) * 1e3,
            )
            self._accept_ts = None
        self.backend.insert_proposal(proposal, seals)
        if self.on_finalize is not None:
            self.on_finalize(height, proposal, seals)
        self.messages.prune_by_height(height)

    # -- outbound (reference core/ibft.go:1234-1270) ------------------------

    def _multicast(self, message: IbftMessage) -> None:
        """Stamp + multicast: the telemetry plane's outbound seam.

        When tracing is enabled every outbound message gains a
        :class:`~go_ibft_tpu_torch.messages.wire.TraceContext` (origin track,
        view, monotonic send µs, fresh span id) and a ``net.send``
        instant; receivers record the matching ``net.recv`` at ingress,
        so N nodes' flight recorders hold causally-linked records the
        timeline tool (:mod:`go_ibft_tpu_torch.obs.timeline`) can merge.  The
        context rides OUTSIDE the signed bytes — object attribute on
        loopback, :func:`~go_ibft_tpu_torch.messages.wire.encode_traced` frame
        on socket transports — so signatures are unaffected.  Disabled
        tracing keeps this a single predicate check.
        """
        if trace.enabled():
            view = message.view
            ctx = TraceContext(
                origin=self._obs_track,
                height=view.height if view is not None else self.state.height,
                round=view.round if view is not None else self.state.round,
                sent_us=time.perf_counter_ns() // 1000,
                span_id=trace.next_span_id(),
            )
            message.trace_ctx = ctx
            trace.instant(
                "net.send",
                track=self._obs_track,
                height=ctx.height,
                round=ctx.round,
                type=int(message.type),
                span=ctx.span_id,
            )
        self.transport.multicast(message)

    # Each send is an ``engine.send`` span while tracing: the message built
    # and signed through the backend, then multicast.

    def _send_preprepare_message(self, message: IbftMessage) -> None:
        t0 = trace.now_us()
        self._multicast(message)
        if t0 is not None:
            trace.complete("engine.send", t0, track=self._obs_track, type="PREPREPARE")

    def _send_round_change_message(self, height: int, new_round: int) -> None:
        t0 = trace.now_us()
        self._multicast(
            self.backend.build_round_change_message(
                self.state.latest_prepared_proposal,
                self.state.latest_pc,
                View(height=height, round=new_round),
            )
        )
        if t0 is not None:
            trace.complete("engine.send", t0, track=self._obs_track, type="ROUND_CHANGE")

    def _send_prepare_message(self, view: View) -> None:
        t0 = trace.now_us()
        self._multicast(
            self.backend.build_prepare_message(self.state.proposal_hash or b"", view)
        )
        if t0 is not None:
            trace.complete("engine.send", t0, track=self._obs_track, type="PREPARE")

    def _send_commit_message(self, view: View) -> None:
        t0 = trace.now_us()
        self._multicast(
            self.backend.build_commit_message(self.state.proposal_hash or b"", view)
        )
        if t0 is not None:
            trace.complete("engine.send", t0, track=self._obs_track, type="COMMIT")
