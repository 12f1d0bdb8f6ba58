"""Block-sync / catch-up: aggregate-verified finalized-height transfer (the
port of the JAX package's ``chain/sync.py``).

A validator that restarts behind its peers — or observes commit-quorum
evidence for a future height — cannot finish old heights through
consensus (its peers have left them; the reference documents block sync
as the embedder's job, core/ibft.go RunSequence contract).  This module
is that job, done the device-batched way: a stranded node fetches the missing
``(proposal, committed seals)`` range from any peer and verifies ALL
committed seals across the whole range in ONE batched drain
(``verify_seal_lanes`` — per-lane proposal hashes through the same
recovery kernel as the live COMMIT path).  This
is the light-client primitive ("Practical Light Clients for
Committee-Based Blockchains", PAPERS.md): trust nothing from the peer,
re-derive every height's commit quorum from the seals alone.

One binding is deliberately the embedder's (as in the reference, where
block sync is wholly embedder-owned): committed seals sign
``keccak(raw_proposal, round)`` — the HEIGHT is not covered by the
signature, so the in-protocol check alone cannot catch a peer relabeling
a genuine block at a different height.  Real chains close this in the
proposal content (height/parent-hash inside the block bytes); the chain
runner therefore passes every synced proposal through the embedder's
``is_valid_proposal`` before inserting, which is where that content
check belongs (docs/CHAIN.md).

The peer seam is deliberately as thin as the consensus ``Transport``
(one-method multicast): a :class:`SyncSource` answers ``latest_height``
and ``get_blocks`` — :class:`~go_ibft_tpu_torch.chain.runner.ChainRunner`
implements it from its in-memory chain, :class:`LoopbackSyncNetwork`
wires sources in-process (tests, single-host clusters), and a gRPC/DCN
implementation slots in for multi-host deployments.

Blocks carrying an aggregate quorum certificate instead of seals verify
through a ``cert_verifier`` (a
:class:`~go_ibft_tpu_torch.crypto.quorum_cert.BLSCertifier`): the whole
range's pairing work in ONE batched ``verify_many``.
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, List, Mapping, Optional, Protocol, Sequence, Tuple

import numpy as np

from ..core.validator_manager import calculate_quorum
from ..crypto.backend import proposal_hash_of
from ..messages.helpers import CommittedSeal
from ..obs import trace
from ..utils import metrics
from .wal import FinalizedBlock

__all__ = [
    "LoopbackSyncNetwork",
    "SyncClient",
    "SyncError",
    "SYNC_CERT_HEIGHTS_KEY",
    "SyncSource",
    "SYNCED_HEIGHTS_KEY",
    "SYNC_DRAINS_KEY",
]

SYNCED_HEIGHTS_KEY = ("go-ibft", "chain", "synced_heights")
SYNC_DRAINS_KEY = ("go-ibft", "chain", "sync_drains")
SYNC_CERT_HEIGHTS_KEY = ("go-ibft", "chain", "sync_cert_heights")


class SyncError(RuntimeError):
    """Catch-up failed: no peer could serve the range, or verification
    rejected the fetched evidence."""


class SyncSource(Protocol):
    """What a peer serves to catch-up requests (the sync seam)."""

    def latest_height(self) -> int: ...

    def get_blocks(self, start: int, end: int) -> List[FinalizedBlock]: ...


class LoopbackSyncNetwork:
    """In-process sync peer registry (the test/single-host fabric).

    Mirrors ``core.LoopbackTransport``'s posture: registration order is
    deterministic, a node never serves itself, and a fault hook lets chaos
    suites drop or truncate responses per (requester, server).
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._sources: Dict[bytes, SyncSource] = {}
        # Optional fault hook: (requester_id, server_id) -> serve?
        self.should_serve: Callable[[bytes, bytes], bool] = lambda _r, _s: True

    def register(self, node_id: bytes, source: SyncSource) -> None:
        with self._lock:
            self._sources[node_id] = source

    def peers_of(self, node_id: bytes) -> List[Tuple[bytes, SyncSource]]:
        with self._lock:
            return [
                (peer_id, src)
                for peer_id, src in self._sources.items()
                if peer_id != node_id and self.should_serve(node_id, peer_id)
            ]


class SyncClient:
    """Fetch-and-verify catch-up for one node.

    ``verifier`` is any object with ``verify_seal_lanes(lanes, height)``
    (Host/Device/Resilient/Adaptive all implement it); verdicts are
    pinned to the sequential host oracle by the conformance tests, so a
    device route can never accept a range the reference semantics would
    reject.  On the card a range drains in chunks of the largest lane
    bucket (2,048 lanes) through the verifier's double-buffered pipeline.
    """

    def __init__(
        self,
        node_id: bytes,
        network: LoopbackSyncNetwork,
        verifier,
        validators_for_height: Callable[[int], Mapping[bytes, int]],
        *,
        cert_verifier=None,
        max_batch_heights: int = 4096,
    ) -> None:
        self.node_id = node_id
        self.network = network
        self.verifier = verifier
        self._validators = validators_for_height
        # Aggregate-certificate route: blocks served with an
        # AggregateQuorumCertificate instead of per-validator seals verify
        # through this (a BLSCertifier or compatible) — quorum power from
        # the signer bitmap, and the WHOLE range's pairing work in ONE
        # batched multi-pairing dispatch (``verify_many``) — instead of N
        # seal lanes per height through ``verifier``.
        self.cert_verifier = cert_verifier
        self.max_batch_heights = max_batch_heights

    # -- peer observation ----------------------------------------------

    def best_peer_height(self) -> int:
        """Highest finalized height any reachable peer advertises."""
        best = 0
        for _peer_id, source in self.network.peers_of(self.node_id):
            try:
                best = max(best, source.latest_height())
            except Exception:  # noqa: BLE001 - a dead peer is not an error
                continue
        return best

    # -- catch-up -------------------------------------------------------

    def catch_up(self, start: int, target: int) -> List[FinalizedBlock]:
        """Fetch ``[start, target]`` from peers and verify the whole range.

        Peers are tried in registration order; the first one serving a
        non-empty prefix wins (a peer that is itself behind serves what it
        has — the caller loops until caught up).  Raises :class:`SyncError`
        when no peer can serve ``start`` or verification rejects the
        evidence.
        """
        target = min(target, start + self.max_batch_heights - 1)
        blocks: List[FinalizedBlock] = []
        for _peer_id, source in self.network.peers_of(self.node_id):
            try:
                got = source.get_blocks(start, target)
            except Exception:  # noqa: BLE001 - try the next peer
                continue
            if got and got[0].height == start:
                blocks = got
                break
        if not blocks:
            raise SyncError(
                f"no peer could serve heights [{start}, {target}]"
            )
        expected = list(range(start, start + len(blocks)))
        if [b.height for b in blocks] != expected:
            raise SyncError("peer served a non-contiguous height range")
        self.verify_blocks(blocks)
        metrics.inc_counter(SYNCED_HEIGHTS_KEY, len(blocks))
        return blocks

    def verify_blocks(self, blocks: Sequence[FinalizedBlock]) -> None:
        """Verify every fetched block's commit evidence.

        Blocks carrying an aggregate quorum certificate verify on the
        O(1) route: one pairing equation per height-range entry (the
        certificate's proposal hash must match the block's proposal, the
        signer bitmap must reach quorum power — both checked inside the
        cert verifier — so a peer can never relabel a certificate onto a
        different proposal).  Requires ``cert_verifier``; a cert-carrying
        block without one is a :class:`SyncError`, never silently trusted.

        Seal-carrying blocks take the batched lane route: one
        ``verify_seal_lanes`` drain per validator-set snapshot — with a
        static validator set (the common case) the WHOLE height range is
        a single drain.  Grouping by snapshot keeps the device's
        one-table-per-drain shape exactly as honest as the sequential
        oracle: every lane in a drain shares the validator set its own
        height would select.  After the mask comes back, each height's
        valid signers must reach that height's voting-power quorum.
        """
        cert_blocks = [b for b in blocks if b.cert is not None]
        if cert_blocks:
            self._verify_cert_blocks(cert_blocks)
        blocks = [b for b in blocks if b.cert is None]
        if not blocks:
            return
        t0 = trace.now_us()
        groups: Dict[tuple, List[int]] = {}
        snapshots: List[Mapping[bytes, int]] = []
        heights: List[int] = []
        for i, block in enumerate(blocks):
            powers = self._validators(block.height)
            key = tuple(sorted(powers.items()))
            if key not in groups:
                groups[key] = []
            groups[key].append(i)
            snapshots.append(powers)
            heights.append(block.height)
        if t0 is not None:
            trace.complete("sync.group", t0, heights=len(blocks))

        masks: List[Optional[np.ndarray]] = [None] * len(blocks)
        total_lanes = sum(len(b.seals) for b in blocks)
        with trace.span(
            "chain.sync.verify",
            lanes=total_lanes,
            heights=len(blocks),
            drains=len(groups),
        ):
            for idxs in groups.values():
                t0 = trace.now_us()
                lanes: List[Tuple[bytes, CommittedSeal]] = []
                spans: List[Tuple[int, int, int]] = []  # (block idx, lo, hi)
                for i in idxs:
                    block = blocks[i]
                    proposal_hash = proposal_hash_of(block.proposal)
                    lo = len(lanes)
                    lanes.extend(
                        (proposal_hash, seal) for seal in block.seals
                    )
                    spans.append((i, lo, len(lanes)))
                if t0 is not None:
                    trace.complete("sync.lanes", t0, heights=len(idxs), lanes=len(lanes))
                if not lanes:
                    for i in idxs:
                        masks[i] = np.zeros(0, dtype=bool)
                    continue
                # ONE batched drain for the whole snapshot group; the
                # representative height picks the (identical) table.
                mask = np.asarray(
                    self.verifier.verify_seal_lanes(
                        lanes, heights[idxs[-1]]
                    ),
                    dtype=bool,
                )
                metrics.inc_counter(SYNC_DRAINS_KEY)
                for i, lo, hi in spans:
                    masks[i] = mask[lo:hi]

        t0 = trace.now_us()
        try:
            for block, mask, powers in zip(blocks, masks, snapshots):
                valid_signers = {
                    seal.signer
                    for seal, ok in zip(block.seals, mask)
                    if bool(ok)
                }
                quorum = calculate_quorum(sum(powers.values()))
                got = sum(powers.get(a, 0) for a in valid_signers)
                if got < quorum:
                    raise SyncError(
                        f"height {block.height}: committed-seal power {got} < "
                        f"quorum {quorum} ({int(mask.sum())}/{len(block.seals)} "
                        "seals valid)"
                    )
        finally:
            if t0 is not None:
                trace.complete("sync.quorum", t0, heights=len(blocks))

    def _verify_cert_blocks(self, blocks: Sequence[FinalizedBlock]) -> None:
        """Batched verification of certificate-carrying blocks.

        Structural gates run per block BEFORE any pairing work; the
        surviving certificates then verify through ONE batched
        multi-pairing dispatch (``cert_verifier.verify_many``)
        — a 1000-height catch-up range costs one dispatch instead of
        1000 independent pairing calls.  A verifier without
        ``verify_many`` (a custom embedder seam) keeps the per-height
        route, verdict-identically.
        """
        if self.cert_verifier is None:
            raise SyncError(
                "peer served aggregate-certificate blocks but this client "
                "has no cert_verifier to check them"
            )
        with trace.span(
            "chain.sync.cert_verify", heights=len(blocks)
        ):
            for block in blocks:
                cert = block.cert
                if block.seals:
                    # A cert block carries NO per-validator seals (the WAL
                    # writes them mutually exclusively); a peer serving
                    # both is smuggling seals past verification — this
                    # path checks only the certificate, and the runner
                    # would otherwise insert and re-serve the unchecked
                    # seal list as commit evidence.
                    raise SyncError(
                        f"height {block.height}: certificate block "
                        "carries a seal list (unverifiable evidence mix)"
                    )
                if (
                    cert.height != block.height
                    or cert.proposal_hash != proposal_hash_of(block.proposal)
                ):
                    raise SyncError(
                        f"height {block.height}: certificate does not bind "
                        "the served proposal"
                    )
            verify_many = getattr(self.cert_verifier, "verify_many", None)
            if verify_many is not None:
                mask = np.asarray(
                    verify_many([b.cert for b in blocks]), dtype=bool
                )
            else:
                mask = np.asarray(
                    [self.cert_verifier.verify(b.cert) for b in blocks],
                    dtype=bool,
                )
            for block, ok in zip(blocks, mask):
                if not bool(ok):
                    raise SyncError(
                        f"height {block.height}: aggregate quorum "
                        "certificate failed verification"
                    )
                metrics.inc_counter(SYNC_CERT_HEIGHTS_KEY)
