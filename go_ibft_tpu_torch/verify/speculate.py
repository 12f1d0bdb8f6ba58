"""Speculative cross-phase verification: take seal crypto OFF the
phase-ordered critical path (the port of the JAX package's
``verify/speculate.py``; the one difference is the card's fault rule below).

The engine's phase discipline verifies signatures exactly once — but only
when the *phase* that consumes them opens: a COMMIT seal that arrives
while the PREPARE drain is still running sits unverified in the store
until the prepare quorum lands, and then the whole seal batch is paid on
the commit critical path (PAPERS.md 2302.00418: signature verification
dominates commit latency in exactly this regime).  Signature validity is
*proposal-independent* — the seal signs the proposal hash carried IN the
message — so nothing about it needs the phase to be open.

This module verifies those arrivals as they land, off the event loop:

* :class:`SpeculationCache` — a thread-safe verdict cache whose key is
  the FULL binding ``(owner, height, round, proposal_hash, phase,
  sender, signature)``.  A verdict can never leak across a different
  binding: a speculatively verified COMMIT for proposal hash ``H`` is
  unreachable for ``H'`` at the same height/round, for a different
  round, for a different sender, or for another tenant (``owner``).
  Eviction is round-scoped like the engine's seal-verdict cache (dead
  heights/rounds evict whole before the live view sheds FIFO).  A
  quarantine EVICT hook exists (:meth:`SpeculativeVerifier.
  quarantine_seals`) for embedders that condemn lanes out of band;
  note the binding itself already prevents the stale-verdict hazard —
  a corrected re-send carries different signature bytes and therefore
  a different key, so it can never be served a condemned verdict.

* :class:`SpeculativeVerifier` — a bounded work queue + one daemon
  worker thread that drains queued seal lanes through the engine's OWN
  batch verifier (host native or the card — the route is the verifier's
  decision), storing verdicts into the cache.  Everything is best-effort:
  a full queue drops the lane (it simply verifies at drain time as
  before), a worker fault off the card drops the batch, and a verdict is
  only ever a *cache hit* for work the drain would have done anyway —
  speculation can change WHEN a signature verifies, never a verdict.

  On the card (:func:`~go_ibft_tpu_torch.verify.batch.on_card` of the
  verifier) a worker fault is a kernel fault, and no fault of the card
  is hidden: the worker keeps the first one, counts it, and
  :meth:`SpeculativeVerifier.drain` and :meth:`SpeculativeVerifier.stop`
  raise it.  Off the card a fault is counted and the batch dropped, as in
  the JAX package.

The same worker doubles as the **lazy remainder resolver** for the
early-exit drains (:meth:`~go_ibft_tpu_torch.verify.batch.HostBatchVerifier.
verify_seals_early_exit`): lanes past the quorum cut are submitted here,
resolve off-path, and the next wakeup (or the post-quorum bookkeeping)
sees them as cache hits.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

from ..messages import helpers
from ..messages.wire import IbftMessage, MessageType
from ..obs import trace
from ..utils import metrics
from .batch import on_card

__all__ = [
    "SpeculationCache",
    "SpeculativeVerifier",
    "SPEC_HITS_KEY",
    "SPEC_MISSES_KEY",
    "SPEC_LANES_KEY",
    "SPEC_DROPPED_KEY",
]

SPEC_HITS_KEY = ("go-ibft", "speculate", "hits")
SPEC_MISSES_KEY = ("go-ibft", "speculate", "misses")
SPEC_LANES_KEY = ("go-ibft", "speculate", "lanes")
SPEC_DROPPED_KEY = ("go-ibft", "speculate", "dropped")

# Phase tags for the cache binding.  Only COMMIT seals are speculated
# today (envelopes verify at ingress already), but the phase rides the
# key so an envelope verdict could never alias a seal verdict if a
# future path speculates both.
PHASE_COMMIT_SEAL = "commit-seal"


class SpeculationCache:
    """Thread-safe verdict cache with full-binding keys.

    Buckets are keyed ``(owner, height, round)`` so eviction and the
    engine lifecycle hooks stay scope-exact: ``note_view`` pins the
    owner's live (height, round); on cap pressure every bucket that is
    not some owner's live view evicts whole (oldest (height, round)
    first), and only when nothing dead remains does the oldest live
    bucket shed FIFO — the engine seal-verdict-cache posture, extended
    with the owner dimension for multi-tenant sharing.
    """

    def __init__(self, cap: int = 16384):
        self._lock = threading.Lock()
        # (owner, height, round) -> {(phash, phase, sender, sig) -> bool}
        self._buckets: Dict[Tuple[str, int, int], Dict[tuple, bool]] = {}
        self._live: Dict[str, Tuple[int, int]] = {}
        self._count = 0
        self._cap = cap
        self.hits = 0
        self.misses = 0

    def __len__(self) -> int:
        with self._lock:
            return self._count

    # -- lifecycle ------------------------------------------------------

    def note_view(self, height: int, round_: int, owner: str = "") -> None:
        """Pin ``owner``'s live (height, round) and drop its stale
        buckets (anything below the live height — a new sequence can
        never hit them again; higher heights are KEPT: speculation's
        whole point is verifying next-height traffic early)."""
        with self._lock:
            self._live[owner] = (height, round_)
            for key in [
                k
                for k in self._buckets
                if k[0] == owner and k[1] < height
            ]:
                self._count -= len(self._buckets[key])
                del self._buckets[key]

    def clear(self, owner: Optional[str] = None) -> None:
        with self._lock:
            if owner is None:
                self._buckets.clear()
                self._live.clear()
                self._count = 0
                return
            for key in [k for k in self._buckets if k[0] == owner]:
                self._count -= len(self._buckets[key])
                del self._buckets[key]
            self._live.pop(owner, None)

    # -- verdicts -------------------------------------------------------

    def store(
        self,
        height: int,
        round_: int,
        proposal_hash: bytes,
        phase: str,
        sender: bytes,
        signature: bytes,
        verdict: bool,
        owner: str = "",
    ) -> None:
        with self._lock:
            bucket = self._buckets.setdefault((owner, height, round_), {})
            key = (proposal_hash, phase, sender, signature)
            if key not in bucket:
                self._count += 1
            bucket[key] = verdict
            self._evict_locked()

    def lookup(
        self,
        height: int,
        round_: int,
        proposal_hash: bytes,
        phase: str,
        sender: bytes,
        signature: bytes,
        owner: str = "",
    ) -> Optional[bool]:
        """The verdict for EXACTLY this binding, or None.  No partial
        match exists by construction — a different proposal hash, round,
        phase, sender, signature, or owner is a different key."""
        with self._lock:
            bucket = self._buckets.get((owner, height, round_))
            hit = (
                None
                if bucket is None
                else bucket.get((proposal_hash, phase, sender, signature))
            )
            if hit is None:
                self.misses += 1
                metrics.inc_counter(SPEC_MISSES_KEY)
            else:
                self.hits += 1
                metrics.inc_counter(SPEC_HITS_KEY)
            return hit

    def contains(
        self,
        height: int,
        round_: int,
        proposal_hash: bytes,
        phase: str,
        sender: bytes,
        signature: bytes,
        owner: str = "",
    ) -> bool:
        """Hit test WITHOUT touching the hit/miss counters (dedup gate
        for the submit path)."""
        with self._lock:
            bucket = self._buckets.get((owner, height, round_))
            return (
                bucket is not None
                and (proposal_hash, phase, sender, signature) in bucket
            )

    def evict_seal(
        self,
        height: int,
        round_: int,
        proposal_hash: bytes,
        sender: bytes,
        signature: bytes,
        owner: str = "",
    ) -> None:
        """Quarantine hook: a condemned lane's verdict must not outlive
        the quarantine (a corrected re-send re-verifies from bytes)."""
        with self._lock:
            bucket = self._buckets.get((owner, height, round_))
            if bucket is None:
                return
            if bucket.pop(
                (proposal_hash, PHASE_COMMIT_SEAL, sender, signature), None
            ) is not None:
                self._count -= 1
                if not bucket:
                    del self._buckets[(owner, height, round_)]

    def _evict_locked(self) -> None:
        while self._count > self._cap and self._buckets:
            live = set(self._live.items())
            dead = [
                k
                for k in self._buckets
                if (k[0], (k[1], k[2])) not in live
            ]
            pool = dead if dead else list(self._buckets)
            oldest = min(pool, key=lambda k: (k[1], k[2], k[0]))
            bucket = self._buckets[oldest]
            if dead:
                self._count -= len(bucket)
                del self._buckets[oldest]
            else:
                bucket.pop(next(iter(bucket)))
                self._count -= 1
                if not bucket:
                    del self._buckets[oldest]


class _SealJob:
    __slots__ = ("owner", "height", "round", "proposal_hash", "lanes")

    def __init__(self, owner, height, round_, proposal_hash, lanes):
        self.owner = owner
        self.height = height
        self.round = round_
        self.proposal_hash = proposal_hash
        self.lanes = lanes  # [(sender, CommittedSeal), ...]


class SpeculativeVerifier:
    """Background seal verification feeding a :class:`SpeculationCache`.

    ``verifier`` is any object with the seal half of the BatchVerifier
    protocol (``verify_committed_seals(proposal_hash, seals, height)``);
    the engine passes its own batch verifier so speculative verdicts are
    produced by the SAME route (and the same degradation ladder) the
    drain would use.  One daemon worker; the queue is bounded in lanes
    and drops on overflow (best-effort — a dropped lane verifies at
    drain time exactly as without speculation).

    Thread-notes: the worker calls the verifier from its own thread
    concurrently with the event loop's drains.  The host verifier is
    stateless; the device verifier's pack cache, per-height tables and
    pinned staging slots are lock-guarded
    (:class:`~go_ibft_tpu_torch.verify.pipeline.PackCache`,
    :class:`~go_ibft_tpu_torch.verify.batch.DeviceBatchVerifier`), and its
    launches go onto one CUDA stream in the order the threads make them.
    The engine only ever consumes verdicts through the cache, so no
    partially-verified state is observable.
    """

    def __init__(
        self,
        verifier,
        *,
        cache: Optional[SpeculationCache] = None,
        max_queue_lanes: int = 4096,
        owner: str = "",
        batch_lanes: int = 256,
    ):
        self.verifier = verifier
        self.cache = cache if cache is not None else SpeculationCache()
        self.owner = owner
        self.max_queue_lanes = max_queue_lanes
        self.batch_lanes = batch_lanes
        self._queue: "queue.Queue[Optional[_SealJob]]" = queue.Queue()
        self._queued_lanes = 0
        self._lock = threading.Lock()
        self._started = False
        self._stopped = False
        self._idle = threading.Event()
        self._idle.set()
        self._thread: Optional[threading.Thread] = None
        # Evidence counters (the commit-critical-path bench reads these).
        self.speculated_lanes = 0
        self.dropped_lanes = 0
        self.batches = 0
        self.faults = 0
        # On the card the first worker fault is kept and re-raised by
        # drain() and stop(); off it faults are only counted.
        self.on_card = on_card(verifier)
        self.fault: Optional[BaseException] = None

    # -- lifecycle -------------------------------------------------------

    def _ensure_worker(self) -> None:
        with self._lock:
            if self._started or self._stopped:
                return
            self._started = True
            self._thread = threading.Thread(
                target=self._worker, name="spec-verify", daemon=True
            )
            self._thread.start()

    def _raise_fault(self) -> None:
        if self.fault is not None:
            raise self.fault

    def stop(self) -> None:
        """Stop the worker; on the card, then raise its first fault."""
        with self._lock:
            self._stopped = True
            started = self._started
        if started:
            self._queue.put(None)
            if self._thread is not None:
                self._thread.join(timeout=5.0)
                self._thread = None
        self._raise_fault()

    def drain(self, timeout_s: float = 5.0) -> bool:
        """Block until the queue is empty and the worker is idle (tests
        and the bench's warm gate).  Returns False on timeout; on the
        card, raises the worker's first fault."""
        t0 = time.monotonic()
        while time.monotonic() - t0 < timeout_s:
            self._raise_fault()
            with self._lock:
                empty = self._queued_lanes == 0
            if empty and self._idle.wait(timeout=0.05):
                with self._lock:
                    if self._queued_lanes == 0:
                        self._raise_fault()
                        return True
            time.sleep(0.002)
        self._raise_fault()
        return False

    # -- engine lifecycle hooks -----------------------------------------

    def note_view(self, height: int, round_: int) -> None:
        self.cache.note_view(height, round_, owner=self.owner)

    def reset(self) -> None:
        self.cache.clear(owner=self.owner)

    def quarantine_seals(
        self, height: int, round_: int, proposal_hash: bytes, lanes
    ) -> None:
        for sender, seal in lanes:
            self.cache.evict_seal(
                height,
                round_,
                proposal_hash,
                sender,
                seal.signature,
                owner=self.owner,
            )

    # -- submission ------------------------------------------------------

    def submit_commit_messages(self, msgs: Sequence[IbftMessage]) -> int:
        """Queue the COMMIT seals of ``msgs`` for speculative
        verification; non-COMMITs and malformed lanes are skipped.
        Returns the number of lanes queued."""
        jobs: Dict[Tuple[int, int, bytes], List[tuple]] = {}
        for m in msgs:
            if m.view is None or m.type != MessageType.COMMIT:
                continue
            phash = helpers.extract_commit_hash(m)
            seal = helpers.extract_committed_seal(m)
            if phash is None or seal is None or len(phash) != 32:
                continue
            if self.cache.contains(
                m.view.height,
                m.view.round,
                phash,
                PHASE_COMMIT_SEAL,
                m.sender,
                seal.signature,
                owner=self.owner,
            ):
                continue
            jobs.setdefault(
                (m.view.height, m.view.round, phash), []
            ).append((m.sender, seal))
        queued = 0
        for (height, round_, phash), lanes in jobs.items():
            queued += self.submit_seal_lanes(height, round_, phash, lanes)
        return queued

    def submit_seal_lanes(
        self, height: int, round_: int, proposal_hash: bytes, lanes
    ) -> int:
        """Queue raw ``(sender, seal)`` lanes sharing one carried hash —
        the lazy-remainder entry the early-exit drains use."""
        if not lanes:
            return 0
        lanes = list(lanes)
        with self._lock:
            if self._stopped:
                return 0
            room = self.max_queue_lanes - self._queued_lanes
            if room < len(lanes):
                overflow = len(lanes) - max(room, 0)
                self.dropped_lanes += overflow
                metrics.inc_counter(SPEC_DROPPED_KEY, overflow)
                if room <= 0:
                    return 0
                lanes = lanes[:room]
            self._queued_lanes += len(lanes)
        self._queue.put(
            _SealJob(self.owner, height, round_, proposal_hash, lanes)
        )
        self._ensure_worker()
        return len(lanes)

    # -- consumption -----------------------------------------------------

    def lookup_seal(
        self,
        height: int,
        round_: int,
        proposal_hash: bytes,
        sender: bytes,
        signature: bytes,
    ) -> Optional[bool]:
        return self.cache.lookup(
            height,
            round_,
            proposal_hash,
            PHASE_COMMIT_SEAL,
            sender,
            signature,
            owner=self.owner,
        )

    def stats(self) -> dict:
        return {
            "speculated_lanes": self.speculated_lanes,
            "dropped_lanes": self.dropped_lanes,
            "batches": self.batches,
            "faults": self.faults,
            "cache_hits": self.cache.hits,
            "cache_misses": self.cache.misses,
            "cache_entries": len(self.cache),
        }

    # -- the worker ------------------------------------------------------

    def _take_batch(self, first: _SealJob) -> List[_SealJob]:
        batch = [first]
        lanes = len(first.lanes)
        while lanes < self.batch_lanes:
            try:
                job = self._queue.get_nowait()
            except queue.Empty:
                break
            if job is None:
                self._queue.put(None)  # keep the stop sentinel
                break
            batch.append(job)
            lanes += len(job.lanes)
        return batch

    def _worker(self) -> None:
        while True:
            job = self._queue.get()
            if job is None:
                return
            self._idle.clear()
            try:
                for j in self._take_batch(job):
                    self._run_job(j)
            finally:
                self._idle.set()

    def _run_job(self, job: _SealJob) -> None:
        n = len(job.lanes)
        try:
            with trace.span(
                "verify.speculate",
                lanes=n,
                height=job.height,
                round=job.round,
            ):
                mask = self.verifier.verify_committed_seals(
                    job.proposal_hash,
                    [seal for _sender, seal in job.lanes],
                    job.height,
                )
            for (sender, seal), ok in zip(job.lanes, mask):
                self.cache.store(
                    job.height,
                    job.round,
                    job.proposal_hash,
                    PHASE_COMMIT_SEAL,
                    sender,
                    seal.signature,
                    bool(ok),
                    owner=job.owner,
                )
            self.speculated_lanes += n
            self.batches += 1
            metrics.inc_counter(SPEC_LANES_KEY, n)
        except Exception as err:  # noqa: BLE001 - best-effort: drop, drain pays
            self.faults += 1
            if self.on_card and self.fault is None:
                self.fault = err  # a kernel fault: drain()/stop() raise it
        finally:
            with self._lock:
                self._queued_lanes -= n
