"""Aggregation-tree gossip: COMMIT dissemination that stops scaling with N
(the port of ``go_ibft_tpu/net/aggtree.py``; with a
:class:`~go_ibft_tpu_torch.verify.aggregate.G2MergeTree` as its merger, each
sweep level's merges are one launch of the merge kernel on the card).

Full-mesh multicast moves every COMMIT to every node — O(N²) messages per
round, each carrying a full seal — and every node then verifies O(N)
seals.  This module implements the aggregated-signature-gossip alternative
("Scalable BFT Consensus Mechanism Through Aggregated Signature Gossip",
PAPERS.md 1911.04698) over the framework's one-method ``Transport`` seam:

* nodes form a ``fan_in``-ary tree (registration order; node 0 is the
  root);
* a COMMIT no longer floods — the node self-delivers it and buffers its
  BLS seal as a *partial aggregate* (one G2 point + a signer set, exactly
  a certificate-shaped payload);
* dissemination is PERIODIC, the paper's gossip cadence: each
  :meth:`pump` sweep walks nodes children-first, and every node whose
  merged partial grew since its last send pushes ONE partial to its
  parent (every interior node keeps one slot per child; child subtrees
  are disjoint by construction, so merging is plain point addition — no
  double-count bookkeeping).  Children-first order makes a single sweep
  converge: everything buffered anywhere reaches the root in one pump;
* the root watches merged voting power; at quorum it builds ONE
  :class:`~go_ibft_tpu_torch.crypto.quorum_cert.AggregateQuorumCertificate`,
  VERIFIES it (one pairing — the tree merges unverified, so the root
  must never broadcast unchecked; a failing aggregate bisects the slot
  tree to evict the Byzantine contribution while every honest seal
  survives, O(k·fan_in·log N) equations for k bad seals) and broadcasts
  it DOWN the tree, each node forwarding to at most ``fan_in`` children
  and handing the certificate to its engine
  (:meth:`IBFT.add_quorum_certificate` — one pairing to finalize).

Ingest is gated: only COMMITs with a decodable r-torsion BLS seal, a
well-formed 32-byte proposal hash, and a registered-validator sender
enter the aggregate path (everything else floods — the reference path,
where engine-side validation applies); the in-flight key set is bounded
AND attributed (``max_inflight_keys`` globally, ``max_keys_per_sender``
per introducing validator — a spammer's forged keys evict each other,
never honest keys), a COMMIT refused admission floods instead of
dropping (a full window costs efficiency, never liveness), and
relay-state GC is anchored to CERTIFIED progress, so no forged message
can wipe or grow hub state unboundedly.

Per-node wire cost for the COMMIT phase: at most ONE partial of
O(192 + N/8) bytes up per pump sweep per in-flight round plus O(fan_in)
certificate forwards down — a per-node send RATE independent of
committee size (the batching is what the periodic cadence buys over
eager per-seal relay, where interior nodes would forward once per
descendant).  Total traffic is O(N) partials per round in the
everyone-commits-then-pump case and O(N log N) worst case under maximal
interleaving, vs O(N²) full seals for flooding.  The hub counts bytes
and messages per node (:meth:`stats`) so the bench reports the shape
instead of asserting it.

Non-COMMIT messages (and COMMITs whose seal is not a decodable BLS G2
point — an ECDSA cluster can mount this transport unmodified) flood to
every node, the reference posture: the tree mode changes COMMIT
dissemination only.

Like :class:`~go_ibft_tpu_torch.core.transport.LoopbackTransport` and
:class:`~go_ibft_tpu_torch.chain.sync.LoopbackSyncNetwork`, the hub is
in-process (tests, single-host clusters, benches); a DCN implementation
would put one gRPC hop per tree edge behind the same port API.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Callable, Dict, FrozenSet, List, Optional, Tuple

from ..crypto import bls as hbls
from ..crypto.quorum_cert import AggregateQuorumCertificate, BLSCertifier
from ..messages.helpers import extract_commit_hash, extract_committed_seal
from ..messages.wire import IbftMessage, MessageType
from ..obs import ledger as cost_ledger
from ..obs import trace
from ..utils import metrics
from ..verify.bls import decode_seal, encode_seal

__all__ = ["AggregationTreeGossip", "TreePort"]

CERTS_BUILT_KEY = ("go-ibft", "aggtree", "certs_built")
PARTIALS_SENT_KEY = ("go-ibft", "aggtree", "partials_sent")
REJECTED_PARTIALS_KEY = ("go-ibft", "aggtree", "rejected_partials")


class TreePort:
    """The per-node ``Transport`` seam handed to one engine."""

    def __init__(self, hub: "AggregationTreeGossip", index: int) -> None:
        self._hub = hub
        self.index = index

    def multicast(self, message: IbftMessage) -> None:
        self._hub._multicast(self.index, message)


@dataclass
class _Node:
    address: bytes
    deliver: Callable[[IbftMessage], None]
    deliver_cert: Optional[Callable[[AggregateQuorumCertificate], None]]
    # (height, round, proposal_hash) -> slot id ("self" or child index) ->
    # (merged G2 point, disjoint signer set)
    slots: Dict[tuple, Dict[object, Tuple[object, FrozenSet[bytes]]]] = field(
        default_factory=dict
    )
    # Keys whose merged partial grew since the last upward send (the pump
    # sweep drains this) and what was last sent per key (dedup).
    dirty: set = field(default_factory=set)
    sent: Dict[tuple, FrozenSet[bytes]] = field(default_factory=dict)
    # wire accounting
    commit_bytes: int = 0
    commit_msgs: int = 0
    flood_bytes: int = 0
    flood_msgs: int = 0


class AggregationTreeGossip:
    """In-process aggregation-tree hub (register → ports → engines)."""

    def __init__(
        self,
        certifier: BLSCertifier,
        *,
        fan_in: int = 2,
        step_interval: float = 0.002,
        auto_pump: bool = True,
        merger=None,
        logger=None,
    ) -> None:
        if fan_in < 1:
            raise ValueError("fan_in must be >= 1")
        self.certifier = certifier
        self.fan_in = fan_in
        self.step_interval = step_interval
        # Optional batched merge seam: a
        # :class:`~go_ibft_tpu_torch.verify.aggregate.G2MergeTree` (anything
        # with ``merge_groups``) turns each sweep LEVEL's slot merges
        # into ONE vmapped combine — O(depth) dispatches per sweep
        # instead of per-node-per-key Python g2_adds.  None keeps the
        # host fold (bit-identical; the small-committee default).
        self.merger = merger
        # auto_pump: sweep inline after each ingest while no cadence task
        # runs (synchronous callers converge without an event loop).
        # False = strictly periodic/manual pumping — the batched mode.
        self.auto_pump = auto_pump
        self._log = logger
        self._lock = threading.Lock()
        self._nodes: List[_Node] = []
        # Keys the root has already certified (late partials are no-ops).
        # GC is anchored to CERTIFIED progress, never to a height claimed
        # by an incoming message — a forged high-height COMMIT must not be
        # able to wipe every in-flight partial hub-wide.
        self._certified: set = set()
        self._certified_high = 0
        # Bound on distinct in-flight (height, round, hash) keys: an
        # attacker minting fresh keys (bogus rounds/hashes at plausible
        # heights) grows relay state without it.  Admission is attributed:
        # each key remembers the sender that INTRODUCED it, and one sender
        # holds at most ``max_keys_per_sender`` live introductions (its
        # own lowest-height key evicts first) — so a Byzantine validator
        # forging high-height COMMITs competes with its own spam and can
        # never starve other validators' keys out of the window.  The
        # global cap is a backstop; a key refused admission is not
        # dropped — its COMMIT floods (reference path), so a full window
        # costs efficiency, never liveness.
        self.max_inflight_keys = 64
        self.max_keys_per_sender = 4
        self._live: set = set()
        self._key_introducer: Dict[tuple, bytes] = {}
        self._introduced: Dict[bytes, set] = {}
        self.rejected_partials = 0
        self.certs_built = 0
        self._task = None
        # (node count, depth -> indices) — see _levels().
        self._levels_cache = None

    # -- wiring ----------------------------------------------------------

    def register(
        self,
        address: bytes,
        deliver: Callable[[IbftMessage], None],
        deliver_cert: Optional[
            Callable[[AggregateQuorumCertificate], None]
        ] = None,
    ) -> TreePort:
        """Register one node (tree position = registration order; node 0
        is the root).  ``deliver`` receives flooded messages and the
        node's own self-delivered ones; ``deliver_cert`` receives the
        round's aggregate certificate (wire it to
        ``engine.add_quorum_certificate``)."""
        with self._lock:
            index = len(self._nodes)
            self._nodes.append(_Node(bytes(address), deliver, deliver_cert))
        return TreePort(self, index)

    def _parent(self, i: int) -> Optional[int]:
        return None if i == 0 else (i - 1) // self.fan_in

    def _children(self, i: int) -> List[int]:
        lo = i * self.fan_in + 1
        return [c for c in range(lo, lo + self.fan_in) if c < len(self._nodes)]

    @property
    def depth(self) -> int:
        d, i = 0, len(self._nodes) - 1
        while i > 0:
            i = (i - 1) // self.fan_in
            d += 1
        return d

    # -- the transport seam ----------------------------------------------

    def _multicast(self, origin: int, message: IbftMessage) -> None:
        seal = (
            extract_committed_seal(message)
            if message.type == MessageType.COMMIT
            else None
        )
        point = decode_seal(seal.signature) if seal is not None else None
        phash = extract_commit_hash(message) if seal is not None else None
        view = message.view
        # Tree eligibility: a decodable BLS seal, a well-formed 32-byte
        # proposal hash (anything else would poison the certificate codec
        # in the pump), and a sender that is actually a validator with a
        # registered key at this height (a foreign signer would make
        # every build_from_aggregate for the round fail).  Everything
        # else floods — the reference path, where the engines' own
        # validation applies.
        if (
            point is None
            or phash is None
            or len(phash) != 32
            or view is None
            or not self.certifier.is_member(view.height, message.sender)
        ):
            self._flood(origin, message)
            return
        key = (view.height, view.round, phash)
        with self._lock:
            admitted = self._admit_key(message.sender, key)
            if admitted:
                self._set_slot(
                    origin, key, "self", point, frozenset([message.sender])
                )
        if not admitted:
            # The in-flight window refused the key: degrade to the
            # reference flood path rather than dropping — engines collect
            # a per-seal quorum instead, so a full window (spam or a
            # genuine burst) costs wire efficiency, never liveness.
            self._flood(origin, message)
            return
        # COMMIT with a decodable BLS seal: self-deliver (engines expect
        # their own messages back); the buffered partial rides the next
        # pump sweep.
        self._nodes[origin].deliver(message)
        if self.auto_pump and self._task is None:
            # No cadence task: pump inline so synchronous callers (tests,
            # the bench's dissemination model) converge without an event
            # loop.  With :meth:`start` running (or auto_pump off),
            # ingests BATCH until the next sweep — that cadence is what
            # caps interior nodes at one upward partial per sweep instead
            # of one per descendant.
            self.pump()

    def _flood(self, origin: int, message: IbftMessage) -> None:
        """Reference-path dissemination: every node gets the message."""
        payload_len = len(message.encode())
        nodes = self._nodes
        node = nodes[origin]
        node.flood_bytes += payload_len * max(0, len(nodes) - 1)
        node.flood_msgs += max(0, len(nodes) - 1)
        for peer in nodes:
            peer.deliver(message)

    # -- tree mechanics ---------------------------------------------------

    @staticmethod
    def _slot_parts(slots) -> Tuple[List[object], FrozenSet[bytes]]:
        """One key's slot dict -> (points, merged signer set) — the ONE
        fold shape shared by _merged, the pump's level walk, and the
        root candidate block (so slot semantics can never diverge
        between them)."""
        points: List[object] = []
        signers: FrozenSet[bytes] = frozenset()
        for p, s in slots.values():
            points.append(p)
            signers = signers | s
        return points, signers

    def _merged(self, i: int, key: tuple):
        points, signers = self._slot_parts(self._nodes[i].slots.get(key, {}))
        point = None
        for p in points:
            point = hbls.g2_add(point, p)
        return point, signers

    def _set_slot(self, i: int, key: tuple, slot, point, signers) -> None:
        """Update one slot at node ``i`` (callers hold the lock).  Child
        subtrees are disjoint, so slot replacement is exact; a partial
        that did not grow the signer set is dropped (dedup — re-sends and
        late duplicates mark nothing dirty and cost no wire)."""
        node = self._nodes[i]
        slots = node.slots.setdefault(key, {})
        prev = slots.get(slot)
        if prev is not None and not (signers - prev[1]):
            return  # nothing new from this subtree
        slots[slot] = (point, signers)
        node.dirty.add(key)

    def _depth_of(self, i: int) -> int:
        d = 0
        while i > 0:
            i = (i - 1) // self.fan_in
            d += 1
        return d

    def _levels(self) -> Dict[int, List[int]]:
        """depth -> node indices (root excluded), cached: the topology is
        fixed by registration order, and pump() runs inline after every
        ingest — rebuilding the grouping under the hub lock per COMMIT
        would be O(N log N) of pure overhead (callers hold the lock)."""
        cached = self._levels_cache
        if cached is not None and cached[0] == len(self._nodes):
            return cached[1]
        by_depth: Dict[int, List[int]] = {}
        for i in range(1, len(self._nodes)):
            by_depth.setdefault(self._depth_of(i), []).append(i)
        self._levels_cache = (len(self._nodes), by_depth)
        return by_depth

    def _merge_level(self, work: List[tuple]) -> List[object]:
        """Merge each work item's slot points — one vmapped combine for
        the whole level through :attr:`merger`, or the host fold."""
        groups = [pts for _i, _key, _signers, pts in work]
        if self.merger is not None:
            # route_tag: the merge-tree dispatch this issues records in
            # the cost ledger as ``aggtree/device``, splitting the gossip
            # pump's per-sweep combines from certifier-build merges.
            with cost_ledger.route_tag("aggtree"):
                return self.merger.merge_groups(groups)
        out = []
        for pts in groups:
            point = None
            for p in pts:
                point = hbls.g2_add(point, p)
            out.append(point)
        return out

    def _send_up(self, i: int, key: tuple, merged_point, merged_signers):
        """Push one merged partial to node ``i``'s parent (lock held).

        One certificate-shaped partial up the tree: the 192-byte merged
        point + signer bitmap — size independent of how many seals the
        subtree merged (the bitmap's 1 bit/validator is the only
        N-term).  A merge CAN cancel to infinity (a Byzantine seal equal
        to a sibling's negation — the tree relays unverified); the
        partial still travels, encoded as zeros, and the root's
        quarantine evicts the offending leaf when certification fails.
        """
        node = self._nodes[i]
        node.sent[key] = merged_signers
        height, round_, phash = key
        wire = AggregateQuorumCertificate(
            height=height,
            round=round_,
            proposal_hash=phash,
            agg_seal=(
                encode_seal(merged_point)
                if merged_point is not None
                else b"\x00" * 192
            ),
            bitmap=b"\x00" * ((len(self._nodes) + 7) // 8),
        )
        node.commit_bytes += len(wire.encode())
        node.commit_msgs += 1
        metrics.inc_counter(PARTIALS_SENT_KEY)
        self._set_slot(self._parent(i), key, i, merged_point, merged_signers)

    def pump(self) -> None:
        """One gossip sweep: children-first, each dirty node sends ONE
        merged partial per in-flight key to its parent; the root then
        certifies any key that reached quorum.

        The walk is grouped by tree LEVEL (deepest first — same
        children-first convergence as the node-ordered walk, since a
        parent is always strictly shallower than its children): a single
        sweep fully converges, every node's send rate stays capped at
        one partial per key per sweep, and with a :attr:`merger`
        attached every level's slot merges run as ONE vmapped device
        combine instead of per-child Python g2_adds (O(depth)
        merge dispatches per sweep).  Runs inline after every ingest
        (cheap: nothing dirty = no-op) and from the optional
        :meth:`start` cadence task.
        """
        to_deliver = []
        with self._lock:
            # Level membership is walked deepest-first with the DIRTY
            # check at visit time (not snapshotted): a push from depth
            # d+1 dirties a depth-d parent mid-sweep, and children-first
            # convergence requires that parent to send in THIS sweep.
            by_depth = self._levels()
            for depth in sorted(by_depth, reverse=True):
                work: List[tuple] = []
                for i in by_depth[depth]:
                    node = self._nodes[i]
                    if not node.dirty:
                        continue
                    for key in sorted(node.dirty):
                        points, signers = self._slot_parts(
                            node.slots.get(key, {})
                        )
                        if not (
                            signers - node.sent.get(key, frozenset())
                        ):
                            continue  # nothing new: no merge, no send
                        work.append((i, key, signers, points))
                    node.dirty.clear()
                for (i, key, signers, _pts), point in zip(
                    work, self._merge_level(work)
                ):
                    self._send_up(i, key, point, signers)
            root = self._nodes[0] if self._nodes else None
            candidates = []
            if root is not None and root.dirty:
                rwork = []
                for key in sorted(root.dirty):
                    points, signers = self._slot_parts(
                        root.slots.get(key, {})
                    )
                    rwork.append((0, key, signers, points))
                root.dirty.clear()
                for (_i, key, signers, _pts), point in zip(
                    rwork, self._merge_level(rwork)
                ):
                    candidates.append((key, point, signers))
        # Certification pairs OUTSIDE the lock (a host pairing is ~1 s;
        # holding the hub lock through it would block every node's COMMIT
        # ingest); only the unhappy-path quarantine re-acquires it.
        for key, point, signers in candidates:
            cert = self._certify(key, point, signers)
            if cert is not None:
                to_deliver.append(cert)
        for cert in to_deliver:
            self._broadcast_cert(0, cert)

    async def _run(self) -> None:
        import asyncio

        while True:
            await asyncio.sleep(self.step_interval)
            self.pump()

    def start(self) -> None:
        """Run :meth:`pump` on a periodic asyncio cadence (optional —
        ingest already pumps inline; the cadence only bounds latency for
        partials that raced a sweep)."""
        import asyncio

        if self._task is None:
            self._task = asyncio.get_running_loop().create_task(
                self._run(), name="aggtree-pump"
            )

    async def stop(self) -> None:
        import asyncio

        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass
            self._task = None

    def _certify(
        self, key: tuple, point, signers
    ) -> Optional[AggregateQuorumCertificate]:
        """Build AND VERIFY the key's certificate once quorum power
        merged (called WITHOUT the lock — pairings must not block
        ingest; broadcasting happens in the caller).

        The tree merges without verifying (that is what keeps relay
        cheap), so the root must never broadcast unchecked: ONE pairing
        verifies the candidate certificate.  On failure — a Byzantine
        contribution somewhere in the tree — the slot tree is BISECTED
        (:meth:`_quarantine`, under the lock): each bad subtree is
        pairing-checked level by level down to the offending leaf seals,
        which are evicted while every honest contribution survives, and
        certification retries on the cleaned aggregate.  k bad seals
        cost O(k · fan_in · log N) equations; the happy path stays at
        one, computed over a snapshot (commits landing mid-pairing ride
        the next sweep).
        """
        with self._lock:
            if key in self._certified:
                return None
        height, round_, phash = key
        cert = None
        if point is not None:
            cert = self.certifier.build_from_aggregate(
                height, round_, phash, point, list(signers)
            )
            if cert is None:
                return None  # below quorum: keep merging
        if cert is None or not self.certifier.verify(cert):
            # Either the pairing failed, or the merge cancelled to
            # infinity outright (point None with signers present — a
            # Byzantine seal equal to the negation of its siblings' sum).
            # Same disease either way: a bad contribution somewhere in
            # the tree.  Bisect to evict it, then retry on the cleaned
            # aggregate.
            if not signers:
                return None
            with self._lock:
                self._quarantine(0, key, height, phash)
                point, signers = self._merged(0, key)
            cert = (
                self.certifier.build_from_aggregate(
                    height, round_, phash, point, list(signers)
                )
                if point is not None
                else None
            )
            if cert is None or not self.certifier.verify(cert):
                # honest power below quorum after eviction: stay
                # uncertified so late honest commits can still finish
                return None
        with self._lock:
            if key in self._certified:
                return None  # a concurrent sweep won the race
            self._certified.add(key)
            self._certified_high = max(self._certified_high, height)
            self.certs_built += 1
            self._gc()
        metrics.inc_counter(CERTS_BUILT_KEY)
        trace.instant(
            "aggtree.certified", height=height, signers=len(signers)
        )
        return cert

    def _quarantine(self, i: int, key: tuple, height: int, phash) -> None:
        """Bisect node ``i``'s slots for ``key``: pairing-check each, dig
        into bad child subtrees, evict bad leaf seals, and rebuild the
        cleaned merged contributions bottom-up (callers hold the lock).

        In a multi-host deployment this walk is a bisect request down the
        tree; in-process the hub holds every node's slots directly."""
        node = self._nodes[i]
        slots = node.slots.get(key, {})
        for slot_id in list(slots):
            point, signers = slots[slot_id]
            if self.certifier.partial_valid(height, phash, point, signers):
                continue
            if slot_id == "self":
                # the offending leaf seal: evict it (a corrected re-send
                # re-enters through the normal ingest path)
                del slots[slot_id]
                self.rejected_partials += 1
                metrics.inc_counter(REJECTED_PARTIALS_KEY)
                trace.instant(
                    "aggtree.rejected", node=i, height=height
                )
                continue
            self._quarantine(slot_id, key, height, phash)
            child_point, child_signers = self._merged(slot_id, key)
            if child_signers:
                slots[slot_id] = (child_point, child_signers)
                self._nodes[slot_id].sent[key] = child_signers
            else:
                del slots[slot_id]

    def _broadcast_cert(
        self, i: int, cert: AggregateQuorumCertificate
    ) -> None:
        """Root-down dissemination: each node forwards to its children
        (<= fan_in sends) and hands the certificate to its engine."""
        node = self._nodes[i]
        children = self._children(i)
        cert_bytes = len(cert.encode())
        node.commit_bytes += cert_bytes * len(children)
        node.commit_msgs += len(children)
        if node.deliver_cert is not None:
            try:
                node.deliver_cert(cert)
            except Exception as err:  # noqa: BLE001 - one engine's failure
                # must not stop the broadcast reaching its siblings
                if self._log:
                    self._log.error("aggtree cert delivery failed", err)
        for c in children:
            self._broadcast_cert(c, cert)

    def _drop_key(self, key: tuple) -> None:
        for node in self._nodes:
            node.slots.pop(key, None)
            node.sent.pop(key, None)
            node.dirty.discard(key)
        self._live.discard(key)
        introducer = self._key_introducer.pop(key, None)
        if introducer is not None:
            mine = self._introduced.get(introducer)
            if mine is not None:
                mine.discard(key)
                if not mine:
                    del self._introduced[introducer]

    def _admit_key(self, sender: bytes, key: tuple) -> bool:
        """Bound the in-flight key set (callers hold the lock).

        A known key is always admitted.  A fresh key is ATTRIBUTED to the
        sender introducing it, and one sender holds at most
        ``max_keys_per_sender`` live introductions — past that its own
        lowest-height key evicts first, so an attacker minting bogus
        (height, round, hash) keys competes with its own spam and can
        never starve other validators' keys out of the window.  The
        global cap is a backstop (honest rounds share ONE key introduced
        by whoever committed first, so it binds only under pathological
        churn); eviction there is lowest-height-first, newcomers at or
        below the floor refused.  A refusal is not a drop: the caller
        floods the COMMIT instead."""
        if key in self._certified or key in self._live:
            return True
        mine = self._introduced.setdefault(sender, set())
        if len(mine) >= self.max_keys_per_sender:
            self._drop_key(min(mine))
        if len(self._live) >= self.max_inflight_keys:
            oldest = min(self._live, key=lambda k: k[0])
            if key[0] <= oldest[0]:
                if not mine:
                    del self._introduced[sender]
                return False
            self._drop_key(oldest)
        self._live.add(key)
        self._key_introducer[key] = sender
        mine.add(key)
        return True

    def _gc(self) -> None:
        """Drop relay state more than two heights behind CERTIFIED
        progress (callers hold the lock).  Anchoring to certification —
        never to a height claimed by an incoming message — means no
        forged COMMIT can wipe in-flight partials hub-wide."""
        floor = self._certified_high - 2
        if floor <= 0:
            return
        for key in [k for k in self._live if k[0] < floor]:
            self._drop_key(key)
        self._certified = {k for k in self._certified if k[0] >= floor}

    # -- evidence ----------------------------------------------------------

    def stats(self) -> dict:
        """Per-node wire accounting (bench config #9 reads this)."""
        return {
            "nodes": len(self._nodes),
            "fan_in": self.fan_in,
            "depth": self.depth,
            "certs_built": self.certs_built,
            "rejected_partials": self.rejected_partials,
            "commit_bytes_per_node": [n.commit_bytes for n in self._nodes],
            "commit_msgs_per_node": [n.commit_msgs for n in self._nodes],
            "flood_bytes_per_node": [n.flood_bytes for n in self._nodes],
        }
