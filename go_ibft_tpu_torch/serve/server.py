"""ProofServer / ProofVerifier: the cache-and-coalesce read plane (the port
of the JAX package's ``serve/server.py``).

The write side of this node finalizes fast; this module makes
that pay off for users who are NOT validators.  Thousands of concurrent
untrusted-client proof requests reduce to a small number of shared
device/host drains through three mechanisms:

* **Canonical-range proof cache** (``serve/cache.py``): finality is
  irreversible, so full chunks are built once, self-checked once, and
  served forever; overlapping client ranges share chunk entries, and a
  per-chunk build lock coalesces the cold stampede (1000 clients asking
  for the same cold chunk build it exactly once).
* **Shared signature-verdict cache**: a committed seal's validity —
  ``recover(proposal_hash, sig) == signer`` — mentions no validator set
  and no client, so the verdict for a ``(hash, signer, signature)`` lane
  is process-shareable.  N clients verifying overlapping ranges pay the
  recover ONCE; membership and quorum (the per-client part) are exact
  host dict arithmetic over each client's own diff-walked set.  The same
  split that makes the multi-tenant dispatcher exact
  (``sched/dispatch.py``) makes this cache sound.
* **Coalesced fresh drains**: cache-miss lanes submit through a
  read-tier :class:`~go_ibft_tpu_torch.sched.TenantScheduler` handle (when one
  is attached), so concurrent ``verify_proof`` calls — and the server's
  own pre-serve self-check — merge into shared batched dispatches
  instead of per-client sequential verifies.  The read tier is
  priority-classed below consensus: a proof flood can never starve a
  live round (the QoS satellite, pinned in tests/test_serve.py).

Verdict honesty: every accept/reject is pinned to the sequential oracle
— signature validity comes from the same verifier ladder every other
drain uses (an any-signer membership source reduces its mask to exactly
signature validity), and membership/quorum are exact Python ints per
client.  The conformance tests pin proof verdicts lane-for-lane against
:class:`~go_ibft_tpu_torch.verify.batch.HostBatchVerifier`.
"""

from __future__ import annotations

import itertools
import threading
import time
from collections import OrderedDict
from typing import Callable, Dict, List, Mapping, Optional, Tuple

import numpy as np

from ..core.validator_manager import calculate_quorum
from ..crypto.backend import proposal_hash_of
from ..obs import ledger as cost_ledger
from ..obs import trace
from ..utils import metrics
from ..utils.device import DeviceLike, resolve_device
from ..verify.batch import HostBatchVerifier
from .cache import CachedChunk, ProofCache
from .proof import (
    FinalityProof,
    ProofBuilder,
    ProofEntry,
    ProofError,
    SetDiff,
    walk_sets,
)

__all__ = [
    "DispatcherLanes",
    "ProofServer",
    "ProofVerifier",
    "SigVerdictCache",
    "any_signer_source",
    "SERVE_PROOFS_KEY",
    "SERVE_VERIFY_LANES_KEY",
    "SERVE_SIG_HITS_KEY",
    "SERVE_PAIRINGS_KEY",
]

SERVE_PROOFS_KEY = ("go-ibft", "serve", "proofs_served")
SERVE_VERIFY_LANES_KEY = ("go-ibft", "serve", "verify_lanes")
SERVE_SIG_HITS_KEY = ("go-ibft", "serve", "sig_cache_hits")
SERVE_PAIRINGS_KEY = ("go-ibft", "serve", "pairings")
# Fixed-bucket proof-serving latency for the /metrics endpoint (off
# unless metrics.enable_fixed_histograms() ran).
SERVE_PROOF_MS_KEY = ("go-ibft", "latency", "serve_proof_ms")

_VERIFIER_IDS = itertools.count()


class _AnySigner(Mapping):
    """Membership-vacuous validator source: every address is a member.

    Feeding this to a verifier (or a scheduler tenant) reduces its
    ``signature-valid AND member`` mask to pure signature validity — the
    chain-agnostic half of the predicate, exactly the trick the
    multi-tenant dispatcher uses with its claimed-address table.  The
    per-client membership AND happens afterwards against the client's own
    diff-walked set."""

    def __contains__(self, _addr) -> bool:
        return True

    def __getitem__(self, _addr) -> int:
        return 1

    def __iter__(self):
        return iter(())

    def __len__(self) -> int:
        return 1  # never falsy: emptiness checks must not reject the source


_ANY_SIGNERS = _AnySigner()


def any_signer_source(_height: int) -> Mapping[bytes, int]:
    """``validators_for_height`` seam returning the any-signer set."""
    return _ANY_SIGNERS


class DispatcherLanes:
    """A lane verifier of signature validity through a
    :class:`~go_ibft_tpu_torch.sched.CoalescedDispatcher` of its own (no
    scheduler, no coalescing across callers): the claimed-address table
    makes its mask exactly what :func:`any_signer_source` gives a
    verifier.  ``route="device"`` launches the card's kernels on
    ``torch_device`` (``None``: the card)."""

    def __init__(self, route: str = "device", torch_device: DeviceLike = None):
        from ..sched.dispatch import CoalescedDispatcher

        self.dispatcher = CoalescedDispatcher(route, torch_device=torch_device)

    @property
    def device(self):
        """What :func:`~go_ibft_tpu_torch.verify.batch.on_card` reads."""
        return self.dispatcher.device

    def verify_seal_lanes(self, lanes, height):
        return self.dispatcher.dispatch([], list(lanes))[1]


class SigVerdictCache:
    """Process-wide ``(proposal_hash, signer, signature) -> sig valid``.

    Sound to share across clients and heights because the key pins every
    input of the recover: the verdict is a pure function of the lane
    bytes.  Bounded LRU (a verdict is one bool; the default cap holds
    ~256k lanes), thread-safe, hit/miss counters for the evidence line.
    """

    def __init__(self, cap: int = 262_144):
        if cap < 1:
            raise ValueError("sig-verdict cache cap must be >= 1")
        self.cap = cap
        self._lock = threading.Lock()
        self._verdicts: "OrderedDict[tuple, bool]" = OrderedDict()
        self.hits = 0
        self.misses = 0

    @staticmethod
    def key(proposal_hash: bytes, seal) -> tuple:
        return (proposal_hash, seal.signer, seal.signature)

    def lookup_batch(
        self, keys: List[tuple]
    ) -> Tuple[Dict[int, bool], List[int]]:
        """Split ``keys`` into cached verdicts (index -> verdict) and the
        indices that must verify fresh."""
        known: Dict[int, bool] = {}
        fresh: List[int] = []
        with self._lock:
            for i, key in enumerate(keys):
                verdict = self._verdicts.get(key)
                if verdict is None:
                    self.misses += 1
                    fresh.append(i)
                else:
                    self._verdicts.move_to_end(key)
                    self.hits += 1
                    known[i] = verdict
        if known:
            metrics.inc_counter(SERVE_SIG_HITS_KEY, len(known))
        return known, fresh

    def store_batch(self, keys: List[tuple], verdicts) -> None:
        with self._lock:
            for key, verdict in zip(keys, verdicts):
                self._verdicts[key] = bool(verdict)
                self._verdicts.move_to_end(key)
            while len(self._verdicts) > self.cap:
                self._verdicts.popitem(last=False)

    def clear(self) -> None:
        with self._lock:
            self._verdicts.clear()

    def stats(self) -> dict:
        with self._lock:
            hits, misses, size = self.hits, self.misses, len(self._verdicts)
        lookups = hits + misses
        return {
            "entries": size,
            "cap": self.cap,
            "hits": hits,
            "misses": misses,
            "hit_rate": round(hits / lookups, 3) if lookups else None,
        }


class ProofVerifier:
    """Client-side (and pre-serve self-check) finality-proof verification.

    Checks, in cost order, for a proof against a trusted ``(checkpoint
    height, powers)`` anchor:

    1. structure + diff-chain walk (:func:`~go_ibft_tpu_torch.serve.proof.
       walk_sets`) — contiguity, ascending in-range diffs, no diff on the
       anchor height;
    2. evidence-form exclusivity — an entry carrying BOTH a certificate
       and a seal list is rejected (the sync client's smuggling gate,
       enforced at the serve layer too);
    3. certificate entries: hash-binding to the served header for EVERY
       entry first, then ALL surviving certificates through ONE batched
       multi-pairing dispatch (:meth:`~go_ibft_tpu_torch.crypto.quorum_cert.
       BLSCertifier.verify_many`) built over the diff-walked
       sets (so a certificate spliced across a rotation verifies against
       the RIGHT set — or fails).  Requires ``bls_keys_for_height`` (a
       PoP-gated registry); a cert-carrying proof without one is a
       :class:`ProofError`, never silently trusted;
    4. seal entries: one batched signature-validity drain for every lane
       not already in the shared :class:`SigVerdictCache` (through the
       scheduler read tier when attached — concurrent callers coalesce),
       then per-height membership + voting-power quorum over the walked
       set (exact ints, per client).

    ``scheduler`` routes fresh drains through a read-tier tenant;
    ``lane_verifier`` overrides the drain engine (any object with
    ``verify_seal_lanes``; it MUST be built over
    :func:`any_signer_source` so its mask is pure signature validity).
    ``device`` (default on) runs the rest on ``torch_device`` (``None``:
    the card), whose faults propagate: fresh drains without a scheduler or
    a lane verifier through a :class:`DispatcherLanes` on the device
    route, and the certificate entries' batched pairing through the
    multi-pairing kernels.  ``device=False`` asks for the host route, the
    JAX package's: the sequential ``HostBatchVerifier`` and the host
    batch pairing.
    """

    def __init__(
        self,
        *,
        scheduler=None,
        lane_verifier=None,
        bls_keys_for_height: Optional[Callable[[int], Mapping]] = None,
        sig_cache: Optional[SigVerdictCache] = None,
        tenant_id: Optional[str] = None,
        require_commitments: bool = False,
        device: bool = True,
        torch_device: DeviceLike = None,
    ):
        # Enforce next-set content commitments per diff hop
        # (lightsync/commitment.py).  Off by default — proofs from
        # commitment-free chains predate the scheme and must keep
        # verifying; a client of a commitment-producing chain turns it
        # on and fabricated/omitted rotations die in walk_sets.
        self._require_commitments = require_commitments
        self._device = device
        self._torch_device = resolve_device(torch_device) if device else None
        self._sched = None
        self._tenant_id = None
        if lane_verifier is not None:
            self._verifier = lane_verifier
        elif scheduler is not None:
            self._sched = scheduler
            self._tenant_id = tenant_id or f"serve-verify-{next(_VERIFIER_IDS)}"
            self._verifier = scheduler.register(
                self._tenant_id, any_signer_source, priority="read"
            )
        elif device:
            self._verifier = DispatcherLanes("device", self._torch_device)
        else:
            self._verifier = HostBatchVerifier(any_signer_source)
        self._bls_keys = bls_keys_for_height
        self.sig_cache = sig_cache if sig_cache is not None else SigVerdictCache()
        # Counter lock: verify() is documented thread-safe, and LOAD/ADD/
        # STORE increments from concurrent clients would lose updates.
        self._stats_lock = threading.Lock()
        self.proofs_verified = 0
        self.lanes_verified = 0
        self.pairings = 0

    def close(self) -> None:
        """Release the scheduler tenant (no-op without a scheduler)."""
        if self._sched is not None and self._tenant_id is not None:
            self._sched.unregister(self._tenant_id)
            self._tenant_id = None

    # -- verification ----------------------------------------------------

    def verify(
        self,
        proof: FinalityProof,
        trusted_powers: Mapping[bytes, int],
    ) -> dict:
        """Verify ``proof`` against the trusted checkpoint powers.

        Returns a report dict (heights/lanes/cache-hit evidence) on
        acceptance; raises :class:`ProofError` naming the failing height
        on rejection.  Thread-safe — concurrent calls share the sig-
        verdict cache and (with a scheduler) coalesce their fresh drains.
        """
        sets = walk_sets(
            trusted_powers,
            proof,
            require_commitments=self._require_commitments,
        )
        lanes: List[Tuple[bytes, object]] = []
        cert_entries: List[ProofEntry] = []
        for entry in proof.entries:
            if entry.cert is not None and entry.seals:
                raise ProofError(
                    f"height {entry.height}: certificate entry carries a "
                    "seal list (unverifiable evidence mix)"
                )
            if entry.cert is not None:
                cert_entries.append(entry)
            else:
                proposal_hash = proposal_hash_of(entry.proposal)
                lanes.extend((proposal_hash, seal) for seal in entry.seals)
        with trace.span(
            "serve.verify",
            heights=len(proof.entries),
            lanes=len(lanes),
            certs=len(cert_entries),
        ):
            sig_ok = self._sig_validity(lanes)
            pairings = self._verify_certs(cert_entries, sets)
            self._check_quorums(proof, sets, sig_ok)
        with self._stats_lock:
            self.proofs_verified += 1
            self.lanes_verified += len(lanes)
            self.pairings += pairings
        metrics.inc_counter(SERVE_VERIFY_LANES_KEY, len(lanes))
        return {
            "checkpoint": proof.checkpoint_height,
            "target": proof.target,
            "heights": len(proof.entries),
            "lanes": len(lanes),
            "pairings": pairings,
        }

    def _sig_validity(self, lanes: List[tuple]) -> np.ndarray:
        """Shared-cache + coalesced-drain signature validity per lane."""
        sig_ok = np.zeros(len(lanes), dtype=bool)
        if not lanes:
            return sig_ok
        keys = [
            SigVerdictCache.key(proposal_hash, seal)
            for proposal_hash, seal in lanes
        ]
        known, fresh = self.sig_cache.lookup_batch(keys)
        for i, verdict in known.items():
            sig_ok[i] = verdict
        if fresh:
            # One drain for every fresh lane of the whole proof.  The
            # membership source is any-signer, so the height argument
            # only labels the drain — every lane carries its OWN
            # proposal hash (the verify_seal_lanes shape).  route_tag:
            # a DIRECT drain records in the cost ledger as
            # ``serve/<route>``.  With a TenantScheduler attached the
            # tag intentionally does NOT propagate: the scheduler's
            # flush thread coalesces lanes from many tenants into ONE
            # dispatch, so per-consumer attribution of that launch is
            # undefined by construction — scheduled serve work shows up
            # under the scheduler's own route like every other tenant's.
            with cost_ledger.route_tag("serve"):
                mask = np.asarray(
                    self._verifier.verify_seal_lanes(
                        [lanes[i] for i in fresh], 0
                    ),
                    dtype=bool,
                )
            for j, i in enumerate(fresh):
                sig_ok[i] = mask[j]
            self.sig_cache.store_batch([keys[i] for i in fresh], mask)
        return sig_ok

    def _verify_certs(self, cert_entries: List[ProofEntry], sets) -> int:
        if not cert_entries:
            return 0
        if self._bls_keys is None:
            raise ProofError(
                "proof carries aggregate quorum certificates but this "
                "verifier has no BLS key source to check them"
            )
        from ..crypto.quorum_cert import BLSCertifier

        # The certifier's power source is the DIFF-WALKED set, not any
        # server-trusted snapshot: a certificate spliced across a
        # rotation verifies against the set the client derived for that
        # height, or fails (the rotation-aware satellite).
        certifier = BLSCertifier(
            lambda h: sets[h],
            self._bls_keys,
            device=self._device,
            torch_device=self._torch_device,
        )
        # Hash-binding gates for EVERY entry run before any pairing work
        # (a relabeled certificate must cost zero crypto — pinned in
        # tests/test_serve.py); the survivors then verify as ONE batched
        # multi-pairing dispatch (a multi-height cert proof is
        # one dispatch, not one pairing call per height).
        for entry in cert_entries:
            cert = entry.cert
            if (
                cert.height != entry.height
                or cert.proposal_hash != proposal_hash_of(entry.proposal)
            ):
                raise ProofError(
                    f"height {entry.height}: certificate does not bind "
                    "the served header"
                )
        with trace.span(
            "serve.cert_verify", heights=len(cert_entries)
        ):
            # Ledger attribution: the batched multi-pairing this issues
            # records as ``serve/<route>`` (see _sig_validity).
            with cost_ledger.route_tag("serve"):
                mask = np.asarray(
                    certifier.verify_many([e.cert for e in cert_entries]),
                    dtype=bool,
                )
        for entry, ok in zip(cert_entries, mask):
            if not bool(ok):
                raise ProofError(
                    f"height {entry.height}: aggregate quorum certificate "
                    "failed verification"
                )
        pairings = len(cert_entries)
        metrics.inc_counter(SERVE_PAIRINGS_KEY, pairings)
        return pairings

    @staticmethod
    def _check_quorums(
        proof: FinalityProof, sets, sig_ok: np.ndarray
    ) -> None:
        offset = 0
        for entry in proof.entries:
            if entry.cert is not None:
                continue
            mask = sig_ok[offset : offset + len(entry.seals)]
            offset += len(entry.seals)
            powers = sets[entry.height]
            # Distinct signers only (a duplicated seal must not double its
            # power), membership against the walked set.
            signers = {
                seal.signer
                for seal, ok in zip(entry.seals, mask)
                if bool(ok) and seal.signer in powers
            }
            quorum = calculate_quorum(sum(powers.values()))
            got = sum(powers[a] for a in signers)
            if got < quorum:
                raise ProofError(
                    f"height {entry.height}: committed-seal power {got} < "
                    f"quorum {quorum} "
                    f"({int(mask.sum())}/{len(entry.seals)} seals valid)"
                )

    def stats(self) -> dict:
        with self._stats_lock:
            proofs, lanes = self.proofs_verified, self.lanes_verified
            pairings = self.pairings
        return {
            "proofs_verified": proofs,
            "lanes_verified": lanes,
            "pairings": pairings,
            "sig_cache": self.sig_cache.stats(),
        }


class ProofServer:
    """Serves finality proofs over a :class:`~go_ibft_tpu_torch.serve.proof.
    ProofBuilder`, with canonical-chunk caching, stampede coalescing, and
    a pre-serve self-check.

    ``self_check=True`` (default) verifies every freshly-built chunk (and
    every partial tail segment) through the SAME verifier clients use
    before it is served or cached — a corrupted local chain, a WAL
    decode bug, or a builder regression surfaces here, not at a client.
    Self-check drains warm the shared sig-verdict cache, so the first
    client verifying a just-served range pays near zero crypto.
    ``device`` / ``torch_device`` are its :class:`ProofVerifier`'s (the
    card unless ``device=False``).
    """

    def __init__(
        self,
        builder: ProofBuilder,
        cache: Optional[ProofCache] = None,
        *,
        scheduler=None,
        lane_verifier=None,
        bls_keys_for_height: Optional[Callable[[int], Mapping]] = None,
        sig_cache: Optional[SigVerdictCache] = None,
        self_check: bool = True,
        max_proof_heights: int = 4096,
        tenant_id: Optional[str] = None,
        device: bool = True,
        torch_device: DeviceLike = None,
    ) -> None:
        self.builder = builder
        self.cache = cache if cache is not None else ProofCache()
        # ``sig_cache`` makes the verdict cache genuinely process-wide:
        # multiple servers (or a server plus standalone verifiers) over
        # the same chain share one by passing it explicitly.
        self.verifier = ProofVerifier(
            scheduler=scheduler,
            lane_verifier=lane_verifier,
            bls_keys_for_height=bls_keys_for_height,
            sig_cache=sig_cache,
            tenant_id=tenant_id,
            device=device,
            torch_device=torch_device,
        )
        self.self_check = self_check
        self.max_proof_heights = max_proof_heights
        self._locks_guard = threading.Lock()
        self._build_locks: Dict[int, threading.Lock] = {}
        # Concurrent clients increment these; bare += would lose updates.
        self._stats_lock = threading.Lock()
        self.proofs_served = 0
        self.chunks_built = 0

    def close(self) -> None:
        self.verifier.close()

    # -- serving ---------------------------------------------------------

    def get_proof(
        self, checkpoint_height: int, target: Optional[int] = None
    ) -> FinalityProof:
        """Assemble the proof for ``(checkpoint_height, target]``.

        ``target`` defaults to (and is clamped at) the chain's latest
        finalized height; ranges are also clamped to
        ``max_proof_heights`` (the sync client's bounded-batch posture —
        a cold client loops).  Raises :class:`ProofError` when the range
        is empty or the chain cannot serve it.
        """
        t0 = time.perf_counter() if metrics.fixed_histograms_enabled() else None
        latest = self.builder.latest_height()
        if target is None:
            target = latest
        target = min(target, latest, checkpoint_height + self.max_proof_heights)
        if checkpoint_height < 0 or target <= checkpoint_height:
            raise ProofError(
                f"nothing to prove past checkpoint {checkpoint_height} "
                f"(target {target}, latest finalized {latest})"
            )
        start = checkpoint_height + 1
        entries: List[ProofEntry] = []
        diffs: List[SetDiff] = []
        with trace.span(
            "serve.proof", start=start, target=target
        ):
            for chunk_start in self.cache.chunk_starts(start, target):
                chunk_end = chunk_start + self.cache.chunk_heights - 1
                if chunk_end <= latest:
                    chunk = self._full_chunk(chunk_start)
                else:
                    # Partial tail window: still growing, never cached.
                    chunk = self._tail_segment(chunk_start, target)
                for entry in chunk.entries:
                    if start <= entry.height <= target:
                        entries.append(entry)
                for diff in chunk.diffs:
                    if start < diff.height <= target:
                        diffs.append(diff)
        with self._stats_lock:
            self.proofs_served += 1
        metrics.inc_counter(SERVE_PROOFS_KEY)
        if t0 is not None:
            metrics.observe_fixed(
                SERVE_PROOF_MS_KEY, (time.perf_counter() - t0) * 1e3
            )
        return FinalityProof(
            checkpoint_height=checkpoint_height, entries=entries, diffs=diffs
        )

    def verify_proof(
        self, proof: FinalityProof, trusted_powers: Mapping[bytes, int]
    ) -> dict:
        """Verify a proof through the server's shared read plane (the
        coalescing entry point N client sessions share)."""
        return self.verifier.verify(proof, trusted_powers)

    # -- chunk machinery -------------------------------------------------

    def _full_chunk(self, chunk_start: int) -> CachedChunk:
        chunk = self.cache.get(chunk_start)
        if chunk is not None:
            return chunk
        with self._locks_guard:
            lock = self._build_locks.setdefault(chunk_start, threading.Lock())
        try:
            with lock:
                # Re-check under the build lock: the cold-range stampede
                # coalesces here — whoever lost the race finds the
                # winner's chunk and builds nothing.
                chunk = self.cache.peek(chunk_start)
                if chunk is not None:
                    return chunk
                chunk_end = chunk_start + self.cache.chunk_heights - 1
                with trace.span(
                    "serve.build", start=chunk_start, end=chunk_end
                ):
                    entries, diffs = self.builder.build_range(
                        chunk_start, chunk_end
                    )
                    if self.self_check:
                        self._self_check(chunk_start, entries, diffs)
                chunk = self.cache.put(chunk_start, entries, diffs)
                with self._stats_lock:
                    self.chunks_built += 1
            return chunk
        finally:
            with self._locks_guard:
                self._build_locks.pop(chunk_start, None)

    def _tail_segment(self, seg_start: int, target: int) -> CachedChunk:
        with trace.span("serve.build", start=seg_start, end=target, tail=True):
            entries, diffs = self.builder.build_range(seg_start, target)
            if self.self_check:
                self._self_check(seg_start, entries, diffs)
        return CachedChunk(
            start=seg_start,
            end=target,
            entries=tuple(entries),
            diffs=tuple(diffs),
        )

    def _self_check(
        self,
        seg_start: int,
        entries: List[ProofEntry],
        diffs: List[SetDiff],
    ) -> None:
        """Pre-serve verification of a freshly-built segment, anchored at
        the server's own snapshot for the segment's first height.  Runs
        through the shared read plane, so its drains coalesce with (and
        pre-warm the sig cache for) concurrent client verifies."""
        segment = FinalityProof(
            checkpoint_height=seg_start - 1,
            entries=list(entries),
            diffs=[d for d in diffs if d.height > seg_start],
        )
        try:
            self.verifier.verify(
                segment, self.builder.validators_for_height(seg_start)
            )
        except ProofError as err:
            raise ProofError(
                f"pre-serve self-check failed for heights "
                f"[{seg_start}, {entries[-1].height}]: {err}"
            ) from err

    # -- evidence --------------------------------------------------------

    def stats(self) -> dict:
        with self._stats_lock:
            served, built = self.proofs_served, self.chunks_built
        return {
            "proofs_served": served,
            "chunks_built": built,
            "cache": self.cache.stats(),
            "verify": self.verifier.stats(),
        }
