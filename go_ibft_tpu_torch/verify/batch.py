"""BatchVerifier implementations: the host oracle and the card's batch kernels.

The port of ``go_ibft_tpu.verify.batch``.  The same observable semantics — a
validity mask over a message set, and the fused voting-power quorum — come
from one batch of work on the card:

    payload bytes --pack--> keccak blocks --digest--> ecrecover ladder
                 --> pubkey --keccak--> address --compare--> mask

The digest is one launch of the ``keccak256_digest`` kernel and the
recovery plus address hash one launch of ``secp256k1_recover``; membership
and the power reduction are PyTorch ops around them.  On a CPU tensor each
step takes its plain PyTorch version.

* :class:`HostBatchVerifier` — sequential per-item verification over Python
  ints (native C++ ecrecover when :mod:`go_ibft_tpu_torch.native` loaded);
  the semantics oracle and the in-process baseline.
* :class:`DeviceBatchVerifier` — the card's batches: per-height
  device-resident tables, a :class:`~.pipeline.PackCache`, pinned staging
  buffers and asynchronous uploads, chunked drains through
  :class:`~.pipeline.VerifyPipeline`, and the early-exit seal drain.
* :class:`ResilientBatchVerifier` — quarantines poison lanes by bisection
  and demotes a faulting device rung down the ``device -> host -> python``
  ladder through a :class:`~.pipeline.CircuitBreaker`.
* :class:`AdaptiveBatchVerifier` — tiny batches on the host, the rest on
  the device rung through the resilient ladder.

Neither moves the card's work to the host: where the device rung runs on a
CUDA device (:func:`on_card`), a fault of its kernels propagates to the
caller.  The ladder's host rungs and the ``certify_fallback`` route serve a
device rung on the CPU, and on the card only the quarantine of a lane the
packer names (:class:`MalformedLaneError`).
* :class:`EngineScope` — one shared verifier, per-engine lifecycle hooks.

The packers are copies of the JAX package's (numpy, bit-identical outputs,
same lane/block/table buckets).  Malformed lanes are filtered before packing
(``False`` in the output); degenerate rounds take per-phase fallbacks.  An
optional ``mesh`` rung (a :class:`~go_ibft_tpu_torch.verify.mesh_batch.MeshBatchVerifier`,
lane-sharded drains over several devices) sits above the device rung of
the resilient and adaptive ladders; on the card its faults propagate too.

Signature format: 65 bytes ``r(32, big-endian) || s(32, big-endian) || v(1)``,
signing ``keccak256(payload_no_sig)`` for envelopes and the proposal hash
directly for committed seals.
"""

from __future__ import annotations

import threading
import time
from contextlib import ExitStack
from dataclasses import dataclass
from typing import Callable, Dict, Iterable, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.validator_manager import calculate_quorum
from ..crypto import ecdsa as host_ecdsa
from ..crypto.keccak import keccak256, keccak256_many
from ..messages.helpers import CommittedSeal
from ..messages.wire import IbftMessage
from ..obs import ledger as cost_ledger
from ..obs import trace
from ..ops import keccak as dk
from ..ops import quorum
from ..ops import secp256k1 as sec
from ..ops.fields import LIMB_BITS, LIMB_MASK
from ..utils import metrics
from ..utils.device import DeviceLike, resolve_device
from .pipeline import CircuitBreaker, PackCache, SenderPack, VerifyPipeline

SIG_BYTES = 65  # r(32) || s(32) || v(1)
ADDRESS_BYTES = 20

# Pad-to buckets (the JAX package's): batch lanes, keccak blocks per
# message, validator-set size.
_BATCH_BUCKETS = (8, 32, 128, 512, 1024, 2048)
_BLOCK_BUCKETS = (2, 8, 32)
_TABLE_BUCKETS = (8, 128, 512, 2048)

# Largest payload the device digest path can absorb; one byte is reserved
# for keccak padding in the last block.
MAX_DEVICE_PAYLOAD = _BLOCK_BUCKETS[-1] * dk.RATE_BYTES - 1

ValidatorSource = Callable[[int], Mapping[bytes, int]]

EARLY_EXIT_SKIPPED_KEY = ("go-ibft", "early_exit", "lanes_skipped")
EARLY_EXIT_DRAINS_KEY = ("go-ibft", "early_exit", "drains")

# Fixed-bucket drain-latency family: one series per route (the key's 4th
# part renders as the ``tag`` label).  Recorded only while
# metrics.enable_fixed_histograms() is on.
VERIFY_DRAIN_MS_KEY = ("go-ibft", "latency", "verify_drain_ms")

QUARANTINED_LANES_KEY = ("go-ibft", "resilient", "quarantined_lanes")
DRAIN_FAULTS_KEY = ("go-ibft", "resilient", "drain_faults")
CERTIFY_FALLBACK_KEY = ("go-ibft", "resilient", "certify_fallback")

# Below this many lanes a sharded dispatch loses to one single-device
# dispatch: the mesh pads every drain to ``bucket x dp`` lanes and pays a
# launch per shard.  Half the largest single-device bucket by default;
# callers with a measured crossover pass their own.
MESH_CUTOVER_LANES = _BATCH_BUCKETS[-1] // 2


class MalformedLaneError(ValueError):
    """A packer input lane has an invalid length, named by index.

    A ``ValueError`` subclass carrying the offending lane, so degraded-mode
    drains can quarantine exactly that lane and verify the rest
    (:class:`ResilientBatchVerifier`).
    """

    def __init__(self, lane: int, field: str, expected: int, got: int):
        self.lane = lane
        self.field = field
        self.expected = expected
        self.got = got
        super().__init__(f"lane {lane}: {field} must be {expected} bytes, got {got}")


def on_card(verifier) -> bool:
    """Whether ``verifier`` launches CUDA kernels (its ``device`` is a CUDA
    device, or its device rung's is, through the resilient and adaptive
    ladders and :class:`EngineScope`): its faults are the card's, and no
    host route may hide them."""
    dev = getattr(verifier, "device", None)
    if isinstance(dev, torch.device):
        return dev.type == "cuda"
    return dev is not None and dev is not verifier and on_card(dev)


def _bucket(n: int, buckets: Sequence[int]) -> int:
    for b in buckets:
        if n <= b:
            return b
    raise ValueError(f"size {n} exceeds largest bucket {buckets[-1]}")


def _lane_count(n: int, pad_lanes: int = 0) -> int:
    """Static lane dimension for an ``n``-lane pack: an explicit
    ``pad_lanes >= n`` pins it, otherwise the next bucket."""
    if pad_lanes >= max(n, 1):
        return pad_lanes
    return max(_bucket(n, _BATCH_BUCKETS), pad_lanes)


def host_quorum_reached(
    validators_for_height: ValidatorSource,
    valid_addrs: Iterable[bytes],
    height: int,
    threshold: Optional[int],
) -> bool:
    """Exact host-int voting-power quorum over a drain's valid addresses
    (distinct validators counted once, exact Python ints for any power
    range) — the one host-side reduction the fallback routes share."""
    powers = validators_for_height(height)
    thr = calculate_quorum(sum(powers.values())) if threshold is None else threshold
    if thr <= 0:
        return True
    return sum(powers.get(a, 0) for a in set(valid_addrs)) >= thr


@dataclass
class EarlyExitReport:
    """One early-exit seal drain's outcome.

    ``mask`` carries per-lane verdicts — ``False`` both for invalid lanes
    and for lanes the drain never reached; ``verified`` distinguishes them
    (True = the lane has a REAL verdict, bit-identical to the sequential
    oracle's).  ``reached`` is the exact voting-power quorum over the
    verified-valid distinct signers; ``skipped`` counts the lanes left
    unverified.  Early exit changes WHEN a lane verifies, never a verdict.
    """

    mask: np.ndarray
    verified: np.ndarray
    reached: bool
    skipped: int


class _PowerTally:
    """Exact incremental voting-power quorum (distinct signers counted
    once), fed one verdict at a time."""

    def __init__(self, powers: Mapping[bytes, int], threshold: int):
        self.powers = powers
        self.threshold = threshold
        self.power = 0
        self._counted: set = set()

    @property
    def reached(self) -> bool:
        return self.power >= self.threshold

    def add(self, signer: bytes) -> bool:
        if signer not in self._counted:
            self._counted.add(signer)
            self.power += self.powers.get(signer, 0)
        return self.reached


def split_signature(sig: bytes) -> Tuple[int, int, int]:
    """65-byte ``r || s || v`` -> ints; raises on wrong length."""
    if len(sig) != SIG_BYTES:
        raise ValueError(f"signature must be {SIG_BYTES} bytes, got {len(sig)}")
    return (
        int.from_bytes(sig[:32], "big"),
        int.from_bytes(sig[32:64], "big"),
        sig[64],
    )


class HostBatchVerifier:
    """Sequential per-item verification over Python ints.

    Mirrors exactly what the reference does per message — the semantics
    oracle the device path must match, and the in-process baseline.
    ``recover_fn`` overrides the ecrecover primitive: the degraded-mode
    ladder's bottom rung passes ``ecdsa.recover_pure``.
    """

    def __init__(self, validators_for_height: ValidatorSource, recover_fn: Optional[Callable] = None):
        self._validators = validators_for_height
        self._recover = recover_fn if recover_fn is not None else host_ecdsa.recover

    def _is_member(self, height: int, address: bytes) -> bool:
        return address in self._validators(height)

    def _drain(self, prepared: list, site: str, out: np.ndarray) -> np.ndarray:
        """Recover each prepared ``(i, claimed, digest, r, s, v, height)``
        lane, then check address and membership; the flight-recorder phase
        structure mirrors the device path (pack -> dispatch -> wait ->
        quorum), the wait empty on this synchronous route."""
        with cost_ledger.dispatch_span(
            "ecdsa_recover", route="host", live=len(prepared), padded=len(prepared), site=site
        ):
            with trace.span("verify.dispatch", route="host", lanes=len(prepared)):
                recovered = [
                    (i, claimed, h, self._recover(digest, r, s, v))
                    for i, claimed, digest, r, s, v, h in prepared
                ]
        with trace.span("verify.device_wait", route="host"):
            pass  # nothing in flight on the synchronous route
        with trace.span("verify.quorum", lanes=len(recovered)):
            for i, claimed, h, pub in recovered:
                if pub is None:
                    continue
                out[i] = host_ecdsa.pubkey_to_address(*pub) == claimed and self._is_member(h, claimed)
        return out

    def _timed(self, kind: str, n: int, body: Callable[[], np.ndarray]) -> np.ndarray:
        t0 = time.perf_counter() if metrics.fixed_histograms_enabled() else None
        with trace.span("verify.drain", kind=kind, route="host", lanes=n):
            out = body()
        if t0 is not None:
            metrics.observe_fixed(VERIFY_DRAIN_MS_KEY + ("host",), (time.perf_counter() - t0) * 1e3)
        return out

    def verify_senders(self, msgs: Sequence[IbftMessage]) -> np.ndarray:
        def body():
            with trace.span("verify.pack", lanes=len(msgs)):
                prepared = []
                for i, msg in enumerate(msgs):
                    if msg.view is None or len(msg.sender) != ADDRESS_BYTES:
                        continue
                    if len(msg.signature) != SIG_BYTES:
                        continue
                    r, s, v = split_signature(msg.signature)
                    digest = keccak256(msg.encode(include_signature=False))
                    prepared.append((i, msg.sender, digest, r, s, v, msg.view.height))
            return self._drain(
                prepared, "verify/batch.py:HostBatchVerifier.verify_senders",
                np.zeros(len(msgs), dtype=bool),
            )

        return self._timed("senders", len(msgs), body)

    def verify_committed_seals(
        self, proposal_hash: bytes, seals: Sequence[CommittedSeal], height: int
    ) -> np.ndarray:
        # Same malformed-hash rejection as ECDSABackend.is_valid_committed_seal
        # and the device path (a seal signs a 32-byte keccak hash).
        if len(proposal_hash) != 32:
            return np.zeros(len(seals), dtype=bool)
        return self._seal_drain("seals", [(proposal_hash, s) for s in seals], height)

    def verify_seal_lanes(self, lanes: Sequence[Tuple[bytes, CommittedSeal]], height: int) -> np.ndarray:
        """Per-lane-hash seal verification (the block-sync drain shape):
        each lane is ``(proposal_hash, seal)``, recovered against its own
        hash, membership against ``height``'s validator set."""
        return self._seal_drain("seal_lanes", lanes, height)

    def _seal_drain(self, kind: str, lanes: Sequence[Tuple[bytes, CommittedSeal]], height: int) -> np.ndarray:
        def body():
            with trace.span("verify.pack", lanes=len(lanes)):
                prepared = []
                for i, (proposal_hash, seal) in enumerate(lanes):
                    if (
                        len(proposal_hash) != 32
                        or len(seal.signer) != ADDRESS_BYTES
                        or len(seal.signature) != SIG_BYTES
                    ):
                        continue
                    prepared.append((i, seal.signer, proposal_hash, *split_signature(seal.signature), height))
            return self._drain(
                prepared, f"verify/batch.py:HostBatchVerifier.{kind}",
                np.zeros(len(lanes), dtype=bool),
            )

        return self._timed(kind, len(lanes), body)

    def verify_seals_early_exit(
        self,
        proposal_hash: bytes,
        seals: Sequence[CommittedSeal],
        height: int,
        threshold: Optional[int] = None,
    ) -> EarlyExitReport:
        """Arrival-order seal verification that RETURNS at quorum.

        Lanes verify sequentially in arrival order; the exact voting-power
        tally runs alongside and the loop stops the moment verified power
        reaches ``threshold`` (the height's quorum when None).  Malformed
        lanes cost no crypto and get their (False) verdict immediately.
        """
        n = len(seals)
        mask = np.zeros(n, dtype=bool)
        verified = np.zeros(n, dtype=bool)
        powers = self._validators(height)
        thr = calculate_quorum(sum(powers.values())) if threshold is None else threshold
        if len(proposal_hash) != 32:
            verified[:] = True  # batch-wide reject: every verdict is False
            return EarlyExitReport(mask, verified, thr <= 0, 0)
        tally = _PowerTally(powers, thr)
        done = 0
        t0 = time.perf_counter() if metrics.fixed_histograms_enabled() else None
        with trace.span("verify.early_exit", route="host", kind="seals", lanes=n):
            for i, seal in enumerate(seals):
                if tally.reached:
                    break
                verified[i] = True
                done = i + 1
                if len(seal.signer) != ADDRESS_BYTES or len(seal.signature) != SIG_BYTES:
                    continue
                pub = self._recover(proposal_hash, *split_signature(seal.signature))
                if pub is None:
                    continue
                ok = host_ecdsa.pubkey_to_address(*pub) == seal.signer and self._is_member(height, seal.signer)
                mask[i] = ok
                if ok:
                    tally.add(seal.signer)
        skipped = n - done
        metrics.inc_counter(EARLY_EXIT_DRAINS_KEY)
        if skipped:
            metrics.inc_counter(EARLY_EXIT_SKIPPED_KEY, skipped)
        # Lane counts are only known at exit (the drain stops at quorum).
        cost_ledger.record_dispatch("ecdsa_recover", "host", live=done, padded=done)
        if t0 is not None:
            metrics.observe_fixed(VERIFY_DRAIN_MS_KEY + ("host",), (time.perf_counter() - t0) * 1e3)
        return EarlyExitReport(mask, verified, tally.reached, skipped)


# ---------------------------------------------------------------------------
# Packers (copies of the JAX package's; numpy, bit-identical)
# ---------------------------------------------------------------------------


def _split_signatures(sigs: Sequence[bytes]) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """N sigs -> ``(r_words, s_words, v)``: ``(N, 8)`` uint32 little-endian
    value words and ``(N,)`` int32 recovery ids."""
    for i, sig in enumerate(sigs):
        if len(sig) != SIG_BYTES:
            raise MalformedLaneError(i, "signature", SIG_BYTES, len(sig))
    n = len(sigs)
    if n == 0:
        z = np.zeros((0, 8), dtype=np.uint32)
        return z, z.copy(), np.zeros((0,), dtype=np.int32)
    flat = np.frombuffer(b"".join(sigs), dtype=np.uint8).reshape(n, SIG_BYTES)
    r_words = np.ascontiguousarray(flat[:, 31::-1]).view("<u4")
    s_words = np.ascontiguousarray(flat[:, 63:31:-1]).view("<u4")
    return r_words, s_words, flat[:, 64].astype(np.int32)


def _words_to_limbs(words: np.ndarray, nlimbs: int) -> np.ndarray:
    """``(N, nw)`` uint32 LE value words -> ``(N, nlimbs)`` int32 limbs."""
    nw = words.shape[-1]
    out = np.zeros(words.shape[:-1] + (nlimbs,), dtype=np.int32)
    for k in range(nlimbs):
        j, sh = divmod(LIMB_BITS * k, 32)
        if j >= nw:
            break
        acc = words[..., j] >> np.uint32(sh)
        if sh + LIMB_BITS > 32 and j + 1 < nw:
            acc = acc | (words[..., j + 1] << np.uint32(32 - sh))
        out[..., k] = (acc & np.uint32(LIMB_MASK)).astype(np.int32)
    return out


def pack_validator_table(addresses: Sequence[bytes], bucket: bool = True) -> np.ndarray:
    """Addresses -> ``(V, 5)`` uint32 words, padded by repeating row 0."""
    addresses = [a for a in addresses if len(a) == ADDRESS_BYTES]
    if not addresses:
        raise ValueError("empty validator set")
    v = _bucket(len(addresses), _TABLE_BUCKETS) if bucket else len(addresses)
    table = np.zeros((v, 5), dtype=np.uint32)
    table[: len(addresses)] = dk.addresses_to_words(addresses)
    table[len(addresses) :] = table[0]  # padding adds no new member
    return table


def pack_sender_batch(
    msgs: Sequence[IbftMessage],
    pad_lanes: int = 0,
    payloads: Optional[List[bytes]] = None,
    cache: Optional[PackCache] = None,
    cache_payloads: Optional[List[bytes]] = None,
    cache_hits: Optional[List[Optional[SenderPack]]] = None,
):
    """Messages -> ``(blocks, counts, r, s, v, senders, live)`` numpy arrays
    padded to bucketed shapes.

    A wrong-length sender or signature raises :class:`MalformedLaneError`
    naming the lane; ``payloads`` overrides the per-message signed bytes
    (oversize lanes are digested on the host).  ``cache`` reuses a message's
    encoded payload and limb rows from an earlier pack and stores fresh
    ones; ``cache_payloads`` supplies the TRUE payloads for stores when
    ``payloads`` carries substituted bytes (without it, an explicit
    ``payloads`` disables stores); ``cache_hits`` passes lookups a caller
    already made.  An empty input gives a fully dead batch.
    """
    n = len(msgs)
    for i, m in enumerate(msgs):
        if len(m.signature) != SIG_BYTES:
            raise MalformedLaneError(i, "signature", SIG_BYTES, len(m.signature))
        if len(m.sender) != ADDRESS_BYTES:
            raise MalformedLaneError(i, "sender", ADDRESS_BYTES, len(m.sender))
    bb = _lane_count(n, pad_lanes)
    nl = sec.FIELD.nlimbs
    r_limbs = np.zeros((bb, nl), dtype=np.int32)
    s_limbs = np.zeros((bb, nl), dtype=np.int32)
    v = np.zeros((bb,), dtype=np.int32)
    senders = np.zeros((bb, 5), dtype=np.uint32)
    live = np.zeros((bb,), dtype=bool)
    if n == 0:
        blocks = np.zeros((bb, _BLOCK_BUCKETS[0], 17, 2), dtype=np.uint32)
        return blocks, np.ones((bb,), np.int32), r_limbs, s_limbs, v, senders, live

    if cache_hits is not None:
        hits: List[Optional[SenderPack]] = cache_hits
    elif cache is not None:
        hits = [cache.lookup(m) for m in msgs]
    else:
        hits = [None] * n
    if payloads is None:
        payloads = [
            h.payload if h is not None else m.encode(include_signature=False)
            for h, m in zip(hits, msgs)
        ]
        cache_payloads = payloads

    max_len = max(len(p) for p in payloads)
    nb = _bucket((max_len + 1 + dk.RATE_BYTES - 1) // dk.RATE_BYTES, _BLOCK_BUCKETS)
    blocks = np.zeros((bb, nb, 17, 2), dtype=np.uint32)
    counts = np.ones((bb,), dtype=np.int32)
    pb, pc = dk.pack_messages(payloads, nb)
    blocks[:n] = pb
    counts[:n] = pc

    miss = [i for i, h in enumerate(hits) if h is None]
    if miss:
        rw, sw, vv = _split_signatures([msgs[i].signature for i in miss])
        rl = _words_to_limbs(rw, nl)
        sl = _words_to_limbs(sw, nl)
        aw = dk.addresses_to_words([msgs[i].sender for i in miss])
        idx = np.asarray(miss)
        r_limbs[idx] = rl
        s_limbs[idx] = sl
        v[idx] = vv
        senders[idx] = aw
        if cache is not None and cache_payloads is not None:
            for j, i in enumerate(miss):
                cache.store(
                    msgs[i],
                    SenderPack(
                        payload=cache_payloads[i],
                        r_limbs=rl[j].copy(),
                        s_limbs=sl[j].copy(),
                        v=int(vv[j]),
                        sender_words=aw[j].copy(),
                    ),
                )
    for i, h in enumerate(hits):
        if h is not None:
            r_limbs[i] = h.r_limbs
            s_limbs[i] = h.s_limbs
            v[i] = h.v
            senders[i] = h.sender_words
    live[:n] = True
    return blocks, counts, r_limbs, s_limbs, v, senders, live


def pack_seal_batch(proposal_hash: bytes, seals: Sequence[CommittedSeal], pad_lanes: int = 0):
    """Seals -> ``(hash_words, r, s, v, signers, live)`` numpy arrays; the
    proposal hash is broadcast to every lane as little-endian value words.
    A non-32-byte hash is a plain ``ValueError`` (batch-wide)."""
    if len(proposal_hash) != 32:
        raise ValueError(f"proposal hash must be 32 bytes, got {len(proposal_hash)}")
    for i, s in enumerate(seals):
        if len(s.signature) != SIG_BYTES:
            raise MalformedLaneError(i, "signature", SIG_BYTES, len(s.signature))
        if len(s.signer) != ADDRESS_BYTES:
            raise MalformedLaneError(i, "signer", ADDRESS_BYTES, len(s.signer))
    n = len(seals)
    bb = _lane_count(n, pad_lanes)
    hw = np.frombuffer(proposal_hash, ">u4")[::-1].astype(np.uint32)  # LE words
    hash_zw = np.broadcast_to(hw, (bb, 8)).copy()
    nl = sec.FIELD.nlimbs
    r_limbs = np.zeros((bb, nl), dtype=np.int32)
    s_limbs = np.zeros((bb, nl), dtype=np.int32)
    v = np.zeros((bb,), dtype=np.int32)
    signers = np.zeros((bb, 5), dtype=np.uint32)
    live = np.zeros((bb,), dtype=bool)
    if n:
        rw, sw, vv = _split_signatures([s.signature for s in seals])
        r_limbs[:n] = _words_to_limbs(rw, nl)
        s_limbs[:n] = _words_to_limbs(sw, nl)
        v[:n] = vv
        signers[:n] = dk.addresses_to_words([s.signer for s in seals])
        live[:n] = True
    return hash_zw, r_limbs, s_limbs, v, signers, live


def validate_seal_lanes(lanes: Sequence[Tuple[bytes, CommittedSeal]]) -> None:
    """Shape-validate ``(proposal_hash, seal)`` lanes, naming the bad lane:
    the one definition of a well-formed sync lane, shared by the per-lane
    packer and the resilient fallback rung."""
    for i, (proposal_hash, seal) in enumerate(lanes):
        if len(proposal_hash) != 32:
            raise MalformedLaneError(i, "proposal_hash", 32, len(proposal_hash))
        if len(seal.signature) != SIG_BYTES:
            raise MalformedLaneError(i, "signature", SIG_BYTES, len(seal.signature))
        if len(seal.signer) != ADDRESS_BYTES:
            raise MalformedLaneError(i, "signer", ADDRESS_BYTES, len(seal.signer))


def pack_seal_lanes(lanes: Sequence[Tuple[bytes, CommittedSeal]], pad_lanes: int = 0):
    """``(proposal_hash, seal)`` lanes -> ``(hash_words, r, s, v, signers,
    live)`` with PER-LANE hashes (the block-sync drain verifies a whole
    height range at once; every height signs its own proposal hash)."""
    validate_seal_lanes(lanes)
    n = len(lanes)
    bb = _lane_count(n, pad_lanes)
    nl = sec.FIELD.nlimbs
    hash_zw = np.zeros((bb, 8), dtype=np.uint32)
    r_limbs = np.zeros((bb, nl), dtype=np.int32)
    s_limbs = np.zeros((bb, nl), dtype=np.int32)
    v = np.zeros((bb,), dtype=np.int32)
    signers = np.zeros((bb, 5), dtype=np.uint32)
    live = np.zeros((bb,), dtype=bool)
    if n:
        # 8 big-endian u32 words per hash, reversed to little-endian value order.
        hw = np.frombuffer(b"".join(h for h, _ in lanes), ">u4").reshape(n, 8)[:, ::-1]
        hash_zw[:n] = hw.astype(np.uint32)
        rw, sw, vv = _split_signatures([s.signature for _, s in lanes])
        r_limbs[:n] = _words_to_limbs(rw, nl)
        s_limbs[:n] = _words_to_limbs(sw, nl)
        v[:n] = vv
        signers[:n] = dk.addresses_to_words([s.signer for _, s in lanes])
        live[:n] = True
    return hash_zw, r_limbs, s_limbs, v, signers, live


@dataclass
class _SenderLanes:
    """A packed envelope chunk on the host: keccak blocks (digested on the
    card at dispatch) and the lanes whose payload exceeds the largest block
    bucket, digested on the host (``big`` indices, ``big_zw`` rows)."""

    blocks: np.ndarray
    counts: np.ndarray
    r: np.ndarray
    s: np.ndarray
    v: np.ndarray
    claimed: np.ndarray
    live: np.ndarray
    big: List[int]
    big_zw: Optional[np.ndarray]


@dataclass
class _DigestLanes:
    """A packed chunk whose digests are already known (seals: the proposal
    hash; pre-digested rows)."""

    zw: np.ndarray
    r: np.ndarray
    s: np.ndarray
    v: np.ndarray
    claimed: np.ndarray
    live: np.ndarray


def pack_sender_lanes(msgs: Sequence[IbftMessage], *, cache=None, hits=None, pad_lanes: int = 0) -> _SenderLanes:
    """The device sender-route pack: cache-hit reuse, oversize payloads
    digested on the host (a PREPREPARE carrying a round-change certificate
    easily exceeds the largest block bucket), every other payload packed
    into keccak blocks for the card's digest kernel."""
    if hits is None:
        hits = [cache.lookup(m) for m in msgs] if cache is not None else [None] * len(msgs)
    payloads = [
        h.payload if h is not None else m.encode(include_signature=False)
        for h, m in zip(hits, msgs)
    ]
    big = [i for i, p in enumerate(payloads) if len(p) > MAX_DEVICE_PAYLOAD]
    device_payloads = list(payloads)
    for i in big:
        device_payloads[i] = b""
    blocks, counts, r, s, v, senders, live = pack_sender_batch(
        msgs,
        pad_lanes=pad_lanes,
        payloads=device_payloads,
        cache=cache,
        cache_payloads=payloads,
        cache_hits=hits,
    )
    big_zw = None
    if big:
        big_zw = np.stack(
            [np.frombuffer(d, ">u4")[::-1].astype(np.uint32)
             for d in keccak256_many([payloads[i] for i in big])]
        )
    return _SenderLanes(blocks, counts, r, s, v, senders, live, big, big_zw)


def sender_digest_rows(
    lanes: _SenderLanes, upload: Callable[[str, np.ndarray], torch.Tensor], out: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """The digest rows of a packed envelope chunk (:func:`pack_sender_lanes`)
    on the device: one launch of the digest kernel
    (``ops/quorum.py::digest_words``), into ``out`` where given, and the
    host digests of oversize payloads written over their rows.
    ``upload(name, array)`` moves each host array to the device."""
    zw = quorum.digest_words(upload("blocks", lanes.blocks), upload("counts", lanes.counts), out=out)
    if lanes.big:
        idx = torch.as_tensor(lanes.big, device=zw.device)
        zw[idx] = upload("big_zw", lanes.big_zw)
    return zw


def pack_sender_digest_rows(
    lanes: _SenderLanes, upload: Callable[[str, np.ndarray], torch.Tensor]
) -> Tuple[torch.Tensor, ...]:
    """The device sender route's one digest sequence over a packed chunk
    (:func:`sender_digest_rows`), then the other fields uploaded.  Returns
    the device tensors ``(zw, r, s, v, claimed, live)``.

    ONE implementation serves both the single-tenant plane
    (:meth:`DeviceBatchVerifier._upload`) and the multi-tenant coalesced
    dispatcher (``sched/dispatch.py``), so a fix to the oversize path can
    never apply to one and silently miss the other.
    """
    zw = sender_digest_rows(lanes, upload)
    return (
        zw, upload("r", lanes.r), upload("s", lanes.s), upload("v", lanes.v),
        upload("claimed", lanes.claimed), upload("live", lanes.live),
    )


_SENDER_UPLOADS = ("blocks", "counts", "r", "s", "v", "claimed", "live")


def upload_sender_lanes(
    lanes: _SenderLanes, upload: Callable[[str, np.ndarray], torch.Tensor]
) -> Dict[str, torch.Tensor]:
    """The upload half of :func:`pack_sender_digest_rows`: every host array
    it takes to the device (the oversize payloads' host digests as
    ``big_zw``), uploaded now and returned by name.  For a caller whose
    uploads all precede the chunk's first launch, which then launches with
    :func:`launch_sender_digest_rows`."""
    up = {name: upload(name, getattr(lanes, name)) for name in _SENDER_UPLOADS}
    if lanes.big:
        up["big_zw"] = upload("big_zw", lanes.big_zw)
    return up


def launch_sender_digest_rows(
    lanes: _SenderLanes, uploaded: Mapping[str, torch.Tensor]
) -> Tuple[torch.Tensor, ...]:
    """The launch half: :func:`pack_sender_digest_rows` over the tensors of
    :func:`upload_sender_lanes`.  Returns ``(zw, r, s, v, claimed, live)``."""
    return pack_sender_digest_rows(lanes, lambda name, _a: uploaded[name])


def _threshold(thr: int) -> Tuple[int, int]:
    thr = max(thr, 0)
    return thr & 0xFFFF, thr >> 16


def _as_signed(a: np.ndarray) -> np.ndarray:
    """uint32 words as their int32 bit patterns (PyTorch has no unsigned
    32-bit arithmetic); other dtypes unchanged."""
    a = np.ascontiguousarray(a)
    return a.view(np.int32) if a.dtype == np.uint32 else a


class _Staging:
    """Host->card staging for one verifier.

    On the card each packed array is copied into a page-locked host buffer
    (one per array name, shape and dtype in each of ``slots`` slots, kept
    and reused) and uploaded with ``non_blocking=True`` on the current
    stream, so the host goes on packing while the copy and the kernels run.
    On the CPU nothing is pinned and every copy is synchronous.

    Safe for concurrent callers (the chain's overlap worker, the
    speculator's worker and the event loop drain through one verifier):
    :meth:`begin` hands a caller a free slot and holds it for that caller
    until its :meth:`finish`, waiting while every slot is held, and a slot
    is reused only after the event :meth:`finish` recorded at the end of its
    last dispatch (after the mask's copy back) has completed.  ``event``
    makes that event (default: a CUDA event on the current stream on the
    card, none on the CPU).
    """

    def __init__(self, device: torch.device, slots: int = 2, event: Optional[Callable[[], object]] = None):
        self.device = device
        self._bufs: List[Dict[tuple, torch.Tensor]] = [{} for _ in range(slots)]
        self._done: List[Optional[object]] = [None] * slots
        self._held = [False] * slots
        self._next = 0
        self._cond = threading.Condition()
        self._event = event if event is not None else (self._record_cuda if self.pinned else None)

    @property
    def pinned(self) -> bool:
        return self.device.type == "cuda"

    def _record_cuda(self) -> torch.cuda.Event:
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(self.device))
        return done

    def begin(self) -> int:
        """Take a free slot (round robin), held until :meth:`finish`."""
        with self._cond:
            while all(self._held):
                self._cond.wait()
            n = len(self._held)
            slot = next(i % n for i in range(self._next, self._next + n) if not self._held[i % n])
            self._held[slot] = True
            self._next = (slot + 1) % n
            done = self._done[slot]
        if done is not None:
            done.synchronize()
        return slot

    def host(self, slot: int, name: str, *parts: np.ndarray) -> torch.Tensor:
        """``parts`` one after the other along the first axis, in the slot's
        page-locked buffer for ``name`` (a CPU tensor of them on the CPU)."""
        if not self.pinned:
            return torch.from_numpy(_as_signed(parts[0] if len(parts) == 1 else np.concatenate(parts)))
        ts = [torch.from_numpy(_as_signed(a)) for a in parts]
        shape = (sum(t.shape[0] for t in ts),) + tuple(ts[0].shape[1:])
        key = (name, shape, ts[0].dtype)
        buf = self._bufs[slot].get(key)
        if buf is None:
            buf = torch.empty(shape, dtype=ts[0].dtype, pin_memory=True)
            self._bufs[slot][key] = buf
        at = 0
        for t in ts:
            buf[at:at + t.shape[0]].copy_(t)
            at += t.shape[0]
        return buf

    def upload(self, slot: int, name: str, *parts: np.ndarray) -> torch.Tensor:
        """``parts`` concatenated on the host (:meth:`host`), then one copy
        to the device."""
        return self.host(slot, name, *parts).to(self.device, non_blocking=self.pinned)

    def download(self, t: torch.Tensor) -> torch.Tensor:
        """Start copying a device result back into pinned host memory; read
        it after :meth:`finish`'s event has completed."""
        if not self.pinned:
            return t
        out = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        out.copy_(t, non_blocking=True)
        return out

    def finish(self, slot: int):
        """Record the slot's end-of-dispatch event and release the slot;
        returns the event (None on the CPU).  Call it also when the
        dispatch raised, so that the slot is released."""
        done = self._event() if self._event is not None else None
        with self._cond:
            self._done[slot] = done
            self._held[slot] = False
            self._cond.notify()
        return done


class DeviceBatchVerifier:
    """Batch verification and the fused quorum on one device (the card by
    default).

    ``validators_for_height`` supplies the voting-power map (the engine's
    ``ValidatorBackend.get_voting_powers`` works directly); address tables
    and power halves are packed once per height and kept on the device.
    ``device=None`` means ``cuda`` and raises where there is none; the
    tests pass ``device="cpu"``.
    """

    def __init__(
        self,
        validators_for_height: ValidatorSource,
        cache_heights: int = 4,
        device: DeviceLike = None,
    ):
        self.device = resolve_device(device)
        self._validators = validators_for_height
        # One full dispatch's lane capacity: floods above it chunk into
        # several dispatches riding the double-buffered pipeline.
        self._dispatch_cap = _BATCH_BUCKETS[-1]
        self._route = "device"
        self._tables: Dict[int, Tuple[np.ndarray, List[bytes]]] = {}
        # Device-resident twins of the packed tables/power vectors:
        # uploaded once per height, reused by every dispatch of it.
        self._tables_dev: Dict[int, torch.Tensor] = {}
        self._quorum_packs: Dict[int, Optional[Tuple[np.ndarray, np.ndarray, np.ndarray, int]]] = {}
        self._quorum_dev: Dict[int, Tuple[torch.Tensor, torch.Tensor]] = {}
        self._cache_heights = cache_heights
        # The four per-height caches are read and evicted by concurrent
        # drains (a sync drain at old heights beside the live ones): every
        # lookup, insert and eviction holds this lock; uploads run outside.
        self._cache_lock = threading.RLock()
        # Per-message pack cache (round-scoped, like the engine's
        # seal-verdict cache): wakeups that re-verify the same messages
        # skip the re-encode and re-limb.
        self._pack_cache = PackCache()
        self._staging = _Staging(self.device)
        # The newest chunked drain's PipelineReport (pack/dispatch/wait split).
        self.last_pipeline = None

    def note_round(self, round_: int) -> None:
        """Engine hook: tag pack-cache entries with the live round."""
        self._pack_cache.note_round(round_)

    def reset_pack_cache(self) -> None:
        """Engine hook: new sequence -> drop all cached packs."""
        self._pack_cache.clear()

    def _pack_caches(self) -> List[PackCache]:
        """The lifecycle-scoped caches this verifier owns (EngineScope)."""
        return [self._pack_cache]

    def scoped(self, owner: str) -> "EngineScope":
        """A per-engine lifecycle facade for sharing this verifier."""
        return EngineScope(self, owner)

    def quarantine(self, msgs: Sequence[IbftMessage]) -> None:
        """Degraded-mode hook: evict the condemned lanes' cached packs, so a
        corrected re-send re-packs from the live bytes."""
        for m in msgs:
            self._pack_cache.evict(m)

    def warmup(self, lanes: Sequence[int] = (8,), blocks: Sequence[int] = (2, 8), table_rows: int = 8) -> None:
        """Build and load the kernels before the first round needs them.

        A consensus engine must never stall mid-round on a build (the round
        timer would expire); on the card this builds both kernels (``nvcc``,
        or the build cache) and runs one dead-lane dispatch of the mask
        program per ``(lanes, blocks)`` bucket.  On the CPU there is nothing
        to build, and nothing runs.
        """
        if self.device.type != "cuda":
            return
        from .. import _build

        _build.build_all()
        table = torch.zeros((table_rows, 5), dtype=torch.int32, device=self.device)
        for bb in lanes:
            for nb in blocks:
                with cost_ledger.dispatch_span(
                    "ecdsa_recover", route="warmup", padded=bb, site="verify/batch.py:warmup"
                ):
                    dead = _SenderLanes(
                        np.zeros((bb, nb, 17, 2), np.uint32), np.ones((bb,), np.int32),
                        np.zeros((bb, sec.FIELD.nlimbs), np.int32),
                        np.zeros((bb, sec.FIELD.nlimbs), np.int32),
                        np.zeros((bb,), np.int32), np.zeros((bb, 5), np.uint32),
                        np.zeros((bb,), bool), [], None,
                    )
                    self._readback(self._dispatch_async(dead, table, None))

    # -- validator table management ------------------------------------

    def _bounded(self, cache: dict) -> None:
        """Evict the oldest heights past ``cache_heights`` (lock held)."""
        while len(cache) > self._cache_heights:
            cache.pop(min(cache))

    def _table_and_addrs(self, height: int) -> Tuple[np.ndarray, List[bytes]]:
        """Packed address table + the filtered address list its rows follow."""
        with self._cache_lock:
            hit = self._tables.get(height)
            if hit is not None:
                return hit
            addrs = [a for a in self._validators(height) if len(a) == ADDRESS_BYTES]
            hit = self._tables[height] = (pack_validator_table(addrs), addrs)
            self._bounded(self._tables)
            return hit

    def _table_dev(self, height: int) -> torch.Tensor:
        """Device-resident packed table (uploaded once per height)."""
        with self._cache_lock:
            hit = self._tables_dev.get(height)
            if hit is not None:
                return hit
            table = self._table_and_addrs(height)[0]
        up = torch.from_numpy(_as_signed(table)).to(self.device)
        with self._cache_lock:
            hit = self._tables_dev.setdefault(height, up)
            self._bounded(self._tables_dev)
        return hit

    def _quorum_powers_dev(self, height: int, plo: np.ndarray, phi: np.ndarray) -> Tuple[torch.Tensor, torch.Tensor]:
        """Device-resident power vectors for the fused-quorum path."""
        with self._cache_lock:
            hit = self._quorum_dev.get(height)
        if hit is not None:
            return hit
        up = (torch.from_numpy(plo).to(self.device), torch.from_numpy(phi).to(self.device))
        with self._cache_lock:
            hit = self._quorum_dev.setdefault(height, up)
            self._bounded(self._quorum_dev)
        return hit

    def _quorum_pack(self, height: int) -> Optional[Tuple[np.ndarray, np.ndarray, np.ndarray, int]]:
        """Per-height ``(table, powers_lo, powers_hi, quorum)``, or None when
        the split-int32 path cannot represent the set exactly (a power or
        the total >= 2**31, or an empty set): callers then fall back to
        the host big-int quorum."""
        with self._cache_lock:
            if height in self._quorum_packs:
                return self._quorum_packs[height]
            powers_map = self._validators(height)
            pack = None
            try:
                table, addrs = self._table_and_addrs(height)
            except ValueError:  # empty validator set
                addrs = []
            # The total is over the FULL map, like the host ValidatorManager.
            total = sum(powers_map.values())
            if addrs and 0 < total < (1 << 31) and all(0 <= p < (1 << 31) for p in powers_map.values()):
                v = table.shape[0]
                plo = np.zeros(v, dtype=np.int32)
                phi = np.zeros(v, dtype=np.int32)
                for i, a in enumerate(addrs):
                    plo[i], phi[i] = quorum.split_power(powers_map[a])
                pack = (table, plo, phi, calculate_quorum(total))
            self._quorum_packs[height] = pack
            self._bounded(self._quorum_packs)
            return pack

    def supports_fused(self, height: int) -> bool:
        """True when the fused mask+quorum path is exact for this height."""
        return self._quorum_pack(height) is not None

    # -- shared pack/dispatch scaffolding -------------------------------

    @staticmethod
    def _well_formed_sender(m: IbftMessage, height: Optional[int]) -> bool:
        return (
            m.view is not None
            and (height is None or m.view.height == height)
            and len(m.sender) == ADDRESS_BYTES
            and len(m.signature) == SIG_BYTES
        )

    @staticmethod
    def _well_formed_seal(seal: CommittedSeal) -> bool:
        return len(seal.signer) == ADDRESS_BYTES and len(seal.signature) == SIG_BYTES

    def _pad_lanes(self, n: int) -> int:
        """Minimum packed lane count for an ``n``-lane dispatch: 0 on one
        device (the packers bucket freely); the mesh subclass returns the
        smallest bucket-aligned multiple of its device count, so that every
        shard gets the same local shape."""
        return 0

    def _program_of(self, quorum_args) -> str:
        """Cost-ledger program identity for one dispatch."""
        return "ecdsa_recover" if quorum_args is None else "quorum_certify"

    def _upload(self, slot: int, lanes, tag: str = "") -> Tuple[torch.Tensor, ...]:
        """A packed host chunk -> device ``(zw, r, s, v, claimed, live)``;
        an envelope chunk goes through :func:`pack_sender_digest_rows`
        (one launch of the digest kernel, host digests of oversize lanes
        written over its rows).  Chunks uploaded in one slot take distinct
        ``tag`` s, so that no pinned buffer is refilled while its copy is in
        flight."""

        def up(slot, name, a):
            return self._staging.upload(slot, tag + name, a)

        if isinstance(lanes, _SenderLanes):
            return pack_sender_digest_rows(lanes, lambda name, a: up(slot, name, a))
        zw = up(slot, "zw", lanes.zw)
        return (
            zw, up(slot, "r", lanes.r), up(slot, "s", lanes.s), up(slot, "v", lanes.v),
            up(slot, "claimed", lanes.claimed), up(slot, "live", lanes.live),
        )

    def _upload_round(self, slot: int, prep: _SenderLanes, seal: _DigestLanes) -> Tuple[torch.Tensor, ...]:
        """A round's two packed halves -> device ``(zw, r, s, v, claimed,
        live)`` of both, PREPARE lanes first, with no concatenation on the
        device: each field's halves meet in one staging buffer on the host
        and go up in one copy; the digest kernel writes the envelopes' rows
        into the first half of ``zw``, the proposal hash rows fill its
        second half."""
        n = prep.live.shape[0]
        zw = torch.empty((n + seal.live.shape[0], 8), dtype=torch.int32, device=self.device)
        zw[n:].copy_(self._staging.host(slot, "round.seal_zw", seal.zw), non_blocking=self._staging.pinned)
        sender_digest_rows(prep, lambda name, a: self._staging.upload(slot, "round." + name, a), out=zw[:n])
        return (zw,) + tuple(
            self._staging.upload(slot, "round." + name, getattr(prep, name), getattr(seal, name))
            for name in ("r", "s", "v", "claimed", "live")
        )

    @staticmethod
    def _mask(inputs, table: torch.Tensor) -> torch.Tensor:
        """Validity mask (signature + membership): the recovery, then the
        ``certify_lanes`` kernel with no phase (its plain version on the
        CPU)."""
        return quorum.certify_zw(*inputs, table)[0]

    def _dispatch_async(self, lanes, table: torch.Tensor, quorum_args):
        """Queue the mask (``quorum_args`` None) or mask+quorum (``(plo,
        phi, thr)``) work for one packed chunk and start the copy of its
        result back; returns a handle for :meth:`_readback` without waiting
        for the card, so the caller can pack the next chunk meanwhile."""
        with cost_ledger.dispatch_span(
            self._program_of(quorum_args),
            route=self._route,
            live_mask=lanes.live,
            block=False,
            site="verify/batch.py:_dispatch_async",
        ):
            with trace.span("verify.dispatch", route="device"):
                slot = self._staging.begin()
                try:
                    inputs = self._upload(slot, lanes)
                    reached = None
                    if quorum_args is None:
                        ok = self._mask(inputs, table)
                    else:
                        plo, phi, thr = quorum_args
                        ok, reached, _, _ = quorum.certify_zw(*inputs, table, plo, phi, [_threshold(thr)])
                        reached = self._staging.download(reached)
                    mask = self._staging.download(ok)
                finally:
                    done = self._staging.finish(slot)
                return mask, reached, done

    @staticmethod
    def _readback(handle) -> Tuple[np.ndarray, Optional[bool]]:
        """Wait for one :meth:`_dispatch_async` handle -> host results."""
        mask, reached, done = handle
        with trace.span("verify.device_wait", route="device"):
            if done is not None:
                done.synchronize()
            return mask.numpy().copy(), None if reached is None else bool(reached)

    def _dispatch(self, lanes, table, quorum_args, metric: str):
        """Synchronous pack->kernels->readback (single-batch callers)."""
        t0 = time.perf_counter()
        mask, reached = self._readback(self._dispatch_async(lanes, table, quorum_args))
        dt_ms = (time.perf_counter() - t0) * 1e3
        metrics.observe(("go-ibft", "device", metric), dt_ms)
        metrics.observe_fixed(VERIFY_DRAIN_MS_KEY + ("device",), dt_ms)
        cost_ledger.add_device_ms(self._program_of(quorum_args), self._route, dt_ms)
        return mask, reached

    def _sender_inputs(self, msgs: List[IbftMessage], pad_lanes: int = 0) -> _SenderLanes:
        """Pack envelopes (payloads and limb rows from the pack cache when
        this verifier already packed the message)."""
        pad_lanes = max(pad_lanes, self._pad_lanes(len(msgs)))
        with trace.span("verify.pack", kind="senders", lanes=len(msgs)):
            cache = self._pack_cache
            return pack_sender_lanes(msgs, cache=cache, hits=[cache.lookup(m) for m in msgs], pad_lanes=pad_lanes)

    def _seal_inputs(self, proposal_hash: bytes, seals: List[CommittedSeal], pad_lanes: int = 0) -> _DigestLanes:
        pad_lanes = max(pad_lanes, self._pad_lanes(len(seals)))
        with trace.span("verify.pack", kind="seals", lanes=len(seals)):
            return _DigestLanes(*pack_seal_batch(proposal_hash, seals, pad_lanes=pad_lanes))

    # -- fused mask + quorum (the engine's phase hot path) --------------

    def _fused_pack(self, height: int, threshold: Optional[int]):
        pack = self._quorum_pack(height)
        if pack is None:
            raise ValueError(f"fused quorum unsupported for height {height}")
        _, plo, phi, quorum_size = pack
        thr = quorum_size if threshold is None else threshold
        plo_dev, phi_dev = self._quorum_powers_dev(height, plo, phi)
        return self._table_dev(height), (plo_dev, phi_dev, thr), thr

    def certify_senders(
        self, msgs: Sequence[IbftMessage], height: int, threshold: Optional[int] = None
    ) -> Tuple[np.ndarray, bool]:
        """Envelope recovery + membership + voting-power quorum in one batch.

        All messages must share ``height``; ``threshold`` overrides the
        quorum size (``None`` means the height's quorum).  Returns
        ``(mask, reached)``; requires :meth:`supports_fused`.
        """
        table, qargs, thr = self._fused_pack(height, threshold)
        out = np.zeros(len(msgs), dtype=bool)
        idxs = [i for i, m in enumerate(msgs) if self._well_formed_sender(m, height)]
        if not idxs:
            return out, thr <= 0
        with trace.span("verify.drain", route="device", kind="certify_senders", lanes=len(idxs)):
            mask, reached = self._dispatch(
                self._sender_inputs([msgs[i] for i in idxs]), table, qargs, "certify_senders_ms"
            )
            with trace.span("verify.quorum", route="device-fused"):
                out[np.asarray(idxs)] = mask[: len(idxs)]
        return out, reached

    def certify_seals(
        self,
        proposal_hash: bytes,
        seals: Sequence[CommittedSeal],
        height: int,
        threshold: Optional[int] = None,
    ) -> Tuple[np.ndarray, bool]:
        """COMMIT-phase check: seal recovery + membership + quorum.
        Returns ``(mask, reached)``."""
        table, qargs, thr = self._fused_pack(height, threshold)
        out = np.zeros(len(seals), dtype=bool)
        idxs = [i for i, s in enumerate(seals) if self._well_formed_seal(s)]
        if not idxs or len(proposal_hash) != 32:
            return out, thr <= 0
        with trace.span("verify.drain", route="device", kind="certify_seals", lanes=len(idxs)):
            mask, reached = self._dispatch(
                self._seal_inputs(proposal_hash, [seals[i] for i in idxs]), table, qargs, "certify_seals_ms"
            )
            with trace.span("verify.quorum", route="device-fused"):
                out[np.asarray(idxs)] = mask[: len(idxs)]
        return out, reached

    def certify_round(
        self,
        msgs: Sequence[IbftMessage],
        proposal_hash: bytes,
        seals: Sequence[CommittedSeal],
        height: int,
        prepare_threshold: Optional[int] = None,
    ) -> Tuple[np.ndarray, bool, np.ndarray, bool]:
        """Certify BOTH phases of a round in one batch.

        PREPARE envelopes and COMMIT seals are packed to one common lane
        bucket, concatenated and run through one recovery launch with two
        quorum reductions.  Returns ``(sender_mask, prepare_reached,
        seal_mask, commit_reached)``.  Requires :meth:`supports_fused`.
        """
        table, (plo, phi, seal_thr), _ = self._fused_pack(height, None)
        p_thr = seal_thr if prepare_threshold is None else prepare_threshold
        sender_mask = np.zeros(len(msgs), dtype=bool)
        seal_mask = np.zeros(len(seals), dtype=bool)
        midx = [i for i, m in enumerate(msgs) if self._well_formed_sender(m, height)]
        sidx = [i for i, s in enumerate(seals) if self._well_formed_seal(s)]
        if not midx or not sidx or len(proposal_hash) != 32:
            # Degenerate rounds fall back to the per-phase paths (an empty
            # half would break the split-at-half contract).
            if midx:
                sender_mask, p_ok = self.certify_senders(msgs, height, threshold=prepare_threshold)
            else:
                p_ok = p_thr <= 0
            if sidx:
                seal_mask, s_ok = self.certify_seals(proposal_hash, seals, height)
            else:
                s_ok = seal_thr <= 0
            return sender_mask, p_ok, seal_mask, s_ok

        lanes = max(_bucket(len(midx), _BATCH_BUCKETS), _bucket(len(sidx), _BATCH_BUCKETS))
        t0 = time.perf_counter()
        with trace.span("verify.drain", route="device", kind="certify_round", lanes=lanes):
            prep = self._sender_inputs([msgs[i] for i in midx], pad_lanes=lanes)
            seal = self._seal_inputs(proposal_hash, [seals[i] for i in sidx], pad_lanes=lanes)
            with cost_ledger.dispatch_span(
                "round_certify",
                route=self._route,
                live=len(midx) + len(sidx),
                padded=2 * lanes,
                site="verify/batch.py:certify_round",
            ):
                with trace.span("verify.dispatch", route="device"):
                    slot = self._staging.begin()
                    try:
                        inputs = self._upload_round(slot, prep, seal)
                        ok, reached, _, _ = quorum.certify_zw(
                            *inputs, table, plo, phi, [_threshold(p_thr), _threshold(seal_thr)], split=lanes
                        )
                        mask = self._staging.download(ok)
                        both_reached = self._staging.download(reached)
                    finally:
                        done = self._staging.finish(slot)
                with trace.span("verify.device_wait", route="device"):
                    if done is not None:
                        done.synchronize()
                    mask = mask.numpy()
                    p_ok, s_ok = (bool(x) for x in both_reached.numpy())
            with trace.span("verify.quorum", route="device-fused"):
                sender_mask[np.asarray(midx)] = mask[: len(midx)]
                seal_mask[np.asarray(sidx)] = mask[lanes : lanes + len(sidx)]
        metrics.observe(("go-ibft", "device", "certify_round_ms"), (time.perf_counter() - t0) * 1e3)
        return sender_mask, p_ok, seal_mask, s_ok

    # -- BatchVerifier protocol ----------------------------------------

    def _run_chunk_pipeline(self, items, pack, metric: str):
        """Pipeline (pack -> async dispatch -> readback) over chunk items.

        ``pack(item)`` returns ``(item, lanes, table_dev)``.  Host packing of
        chunk N+1 overlaps the card's work on chunk N (double buffered).
        Returns ``[(item, mask), ...]`` in item order.
        """
        t0 = time.perf_counter()
        report = VerifyPipeline(depth=2, ledger_key=(self._program_of(None), self._route)).run(
            items,
            pack,
            dispatch=lambda p: (p[0], self._dispatch_async(p[1], p[2], None)),
            readback=lambda h: (h[0], self._readback(h[1])[0]),
        )
        metrics.observe(("go-ibft", "device", metric), (time.perf_counter() - t0) * 1e3)
        self.last_pipeline = report
        return report.results

    def verify_senders(self, msgs: Sequence[IbftMessage]) -> np.ndarray:
        """Per-message sender validity, grouped by height, in chunks of at
        most the largest lane bucket riding the double-buffered pipeline."""
        if not msgs:
            return np.zeros(0, dtype=bool)
        out = np.zeros(len(msgs), dtype=bool)
        by_height: Dict[int, List[int]] = {}
        for i, m in enumerate(msgs):
            if self._well_formed_sender(m, None):
                by_height.setdefault(m.view.height, []).append(i)
        items = [
            (height, idxs[start : start + self._dispatch_cap])
            for height, idxs in by_height.items()
            for start in range(0, len(idxs), self._dispatch_cap)
        ]
        if not items:
            return out

        def pack(item):
            height, chunk = item
            return item, self._sender_inputs([msgs[i] for i in chunk]), self._table_dev(height)

        with trace.span("verify.drain", route=self._route, kind="senders", chunks=len(items)):
            results = self._run_chunk_pipeline(items, pack, "verify_senders_ms")
            with trace.span("verify.quorum", route="mask"):
                for (_, chunk), mask in results:
                    out[np.asarray(chunk)] = mask[: len(chunk)]
        return out

    def verify_sender_rows(
        self,
        height: int,
        zw: np.ndarray,
        r: np.ndarray,
        s: np.ndarray,
        v: np.ndarray,
        claimed: np.ndarray,
        live: np.ndarray,
    ) -> np.ndarray:
        """Pre-digested rows -> per-lane sender-validity mask (one recovery
        dispatch, no re-encode): ``zw`` is ``(n, 8)`` little-endian digest
        words, the other arrays follow :func:`pack_sender_batch`'s rows."""
        n = int(zw.shape[0])
        if n == 0:
            return np.zeros(0, dtype=bool)
        bb = _lane_count(n, self._pad_lanes(n))
        if bb > n:
            pad = bb - n

            def grow(a, dtype=None):
                return np.concatenate([a, np.zeros((pad,) + a.shape[1:], dtype or a.dtype)])

            zw, r, s, v, claimed = (grow(a) for a in (zw, r, s, v, claimed))
            live = grow(live, bool)
        mask, _ = self._dispatch(
            _DigestLanes(zw, r, s, v, claimed, live), self._table_dev(height), None, "verify_sender_rows_ms"
        )
        return np.asarray(mask[:n], dtype=bool)

    def verify_committed_seals(
        self, proposal_hash: bytes, seals: Sequence[CommittedSeal], height: int
    ) -> np.ndarray:
        """Per-seal validity against ``height``'s validator set."""
        out = np.zeros(len(seals), dtype=bool)
        idxs = [i for i, s in enumerate(seals) if self._well_formed_seal(s)]
        if not idxs or len(proposal_hash) != 32:
            return out
        items = [idxs[start : start + self._dispatch_cap] for start in range(0, len(idxs), self._dispatch_cap)]

        def pack(chunk):
            return chunk, self._seal_inputs(proposal_hash, [seals[i] for i in chunk]), self._table_dev(height)

        with trace.span("verify.drain", route=self._route, kind="seals", chunks=len(items)):
            results = self._run_chunk_pipeline(items, pack, "verify_seals_ms")
            with trace.span("verify.quorum", route="mask"):
                for chunk, mask in results:
                    out[np.asarray(chunk)] = mask[: len(chunk)]
        return out

    def verify_seal_lanes(self, lanes: Sequence[Tuple[bytes, CommittedSeal]], height: int) -> np.ndarray:
        """Cross-height batched seal drain with per-lane proposal hashes
        (:func:`pack_seal_lanes`), all lanes against ``height``'s table."""
        out = np.zeros(len(lanes), dtype=bool)
        idxs = [
            i for i, (proposal_hash, seal) in enumerate(lanes)
            if len(proposal_hash) == 32 and self._well_formed_seal(seal)
        ]
        if not idxs:
            return out
        items = [idxs[start : start + self._dispatch_cap] for start in range(0, len(idxs), self._dispatch_cap)]

        def pack(chunk):
            with trace.span("verify.pack", kind="seal_lanes", lanes=len(chunk)):
                packed = _DigestLanes(
                    *pack_seal_lanes([lanes[i] for i in chunk], pad_lanes=self._pad_lanes(len(chunk)))
                )
            return chunk, packed, self._table_dev(height)

        with trace.span("verify.drain", route=self._route, kind="seal_lanes", chunks=len(items)):
            results = self._run_chunk_pipeline(items, pack, "verify_seal_lanes_ms")
            with trace.span("verify.quorum", route="mask"):
                for chunk, mask in results:
                    out[np.asarray(chunk)] = mask[: len(chunk)]
        return out

    def verify_seals_early_exit(
        self,
        proposal_hash: bytes,
        seals: Sequence[CommittedSeal],
        height: int,
        threshold: Optional[int] = None,
    ) -> EarlyExitReport:
        """Power-ordered chunked seal drain that STOPS DISPATCHING at quorum.

        Lanes are ordered by claimed signer power (descending, stable:
        arrival order breaks ties); the first chunk is the smallest lane
        bucket covering the claimed-power quorum prefix, later chunks
        double.  After each readback the exact host-int tally updates and
        the loop exits before the next dispatch once quorum is certain —
        remaining lanes are reported ``skipped``.
        """
        n = len(seals)
        mask = np.zeros(n, dtype=bool)
        verified = np.zeros(n, dtype=bool)
        powers = self._validators(height)
        thr = calculate_quorum(sum(powers.values())) if threshold is None else threshold
        well_formed = [i for i, s in enumerate(seals) if self._well_formed_seal(s)]
        if len(proposal_hash) != 32:
            verified[:] = True
            return EarlyExitReport(mask, verified, thr <= 0, 0)
        # Malformed lanes have their (False) verdict without crypto.
        malformed = set(range(n)) - set(well_formed)
        if malformed:
            verified[np.asarray(sorted(malformed))] = True
        order = sorted(well_formed, key=lambda i: -powers.get(seals[i].signer, 0))
        # First chunk: the claimed-power quorum prefix, bucket-padded.
        claimed = _PowerTally(powers, thr)
        prefix = 0
        for i in order:
            prefix += 1
            if claimed.add(seals[i].signer):
                break
        chunk = min(_bucket(max(prefix, 1), _BATCH_BUCKETS), self._dispatch_cap) if order else 0
        tally = _PowerTally(powers, thr)
        pos = 0
        with trace.span("verify.early_exit", route=self._route, kind="seals", lanes=n):
            while pos < len(order) and not tally.reached:
                take = order[pos : pos + chunk]
                cmask, _ = self._dispatch(
                    self._seal_inputs(proposal_hash, [seals[i] for i in take]),
                    self._table_dev(height),
                    None,
                    "early_exit_ms",
                )
                for j, i in enumerate(take):
                    verified[i] = True
                    if cmask[j]:
                        mask[i] = True
                        tally.add(seals[i].signer)
                pos += len(take)
                chunk = min(chunk * 2, self._dispatch_cap)
        skipped = len(order) - pos
        metrics.inc_counter(EARLY_EXIT_DRAINS_KEY)
        if skipped:
            metrics.inc_counter(EARLY_EXIT_SKIPPED_KEY, skipped)
        return EarlyExitReport(mask, verified, tally.reached, skipped)

    def verify_round_chunked(
        self,
        msgs: Sequence[IbftMessage],
        proposal_hash: bytes,
        seals: Sequence[CommittedSeal],
        height: int,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """BOTH phases' drains through ONE pipeline (oversize rounds):
        envelope and seal chunks share the in-flight window.  Masks only;
        the quorum stays with the caller (exact host ints)."""
        sender_mask = np.zeros(len(msgs), dtype=bool)
        seal_mask = np.zeros(len(seals), dtype=bool)
        cap = self._dispatch_cap
        midx = [i for i, m in enumerate(msgs) if self._well_formed_sender(m, height)]
        sidx = (
            [i for i, s in enumerate(seals) if self._well_formed_seal(s)]
            if len(proposal_hash) == 32
            else []
        )
        items = [("sender", midx[start : start + cap]) for start in range(0, len(midx), cap)] + [
            ("seal", sidx[start : start + cap]) for start in range(0, len(sidx), cap)
        ]
        if not items:
            return sender_mask, seal_mask

        def pack(item):
            kind, chunk = item
            if kind == "sender":
                packed = self._sender_inputs([msgs[i] for i in chunk])
            else:
                packed = self._seal_inputs(proposal_hash, [seals[i] for i in chunk])
            return item, packed, self._table_dev(height)

        with trace.span("verify.drain", route=self._route, kind="round_chunked", chunks=len(items)):
            results = self._run_chunk_pipeline(items, pack, "round_drain_ms")
            with trace.span("verify.quorum", route="mask"):
                for (kind, chunk), mask in results:
                    target = sender_mask if kind == "sender" else seal_mask
                    target[np.asarray(chunk)] = mask[: len(chunk)]
        return sender_mask, seal_mask


class ResilientBatchVerifier:
    """Degraded-mode drain: quarantine poison lanes, demote dead rungs.

    Implements the ``BatchVerifier`` protocol over a fastest-first ladder of
    rungs — ``device -> host (native) -> pure Python``, with an optional
    ``mesh`` rung on top (lane-sharded drains; a mesh fault demotes to the
    single device as a device fault demotes to the host, and drains below
    ``mesh_cutover_lanes`` enter at the device rung) — governed by a
    :class:`~.pipeline.CircuitBreaker`:

    * **Poison batches never propagate.**  A drain whose rung raises is
      bisected: halves re-verify independently, a single lane that still
      raises is retried one rung down, and only a lane no rung can process
      is condemned (mask False).  :class:`MalformedLaneError`
      short-circuits the bisection: the packer named the lane.
    * **Circuit breaker.**  ``k`` consecutive faulted drains at a rung
      demote all traffic one rung down; after ``cooldown_s`` the breaker
      probes the faster rung with one live drain and climbs back on
      success.
    * **Quarantine eviction.**  Condemned sender lanes are reported to the
      fast rung's ``quarantine`` hook, which evicts their pack-cache
      entries.

    On the CPU a drain therefore always returns a verdict per lane and
    never raises.  On the card (:func:`on_card` of the mesh or device rung)
    a fault of that rung propagates instead: no kernel failure is served by
    a slower rung.  Malformed lanes are quarantined on both.
    """

    def __init__(
        self,
        device,
        host: Optional[HostBatchVerifier] = None,
        python: Optional[HostBatchVerifier] = None,
        *,
        mesh=None,
        mesh_cutover_lanes: Optional[int] = None,
        validators_for_height: Optional[ValidatorSource] = None,
        breaker: Optional[CircuitBreaker] = None,
    ):
        if (host is None or python is None) and validators_for_height is None:
            raise ValueError("validators_for_height required when host/python rungs are not supplied")
        if host is None:
            host = HostBatchVerifier(validators_for_height)
        if python is None:
            python = HostBatchVerifier(
                validators_for_height or host._validators, recover_fn=host_ecdsa.recover_pure
            )
        self._rungs = [("device", device), ("host", host), ("python", python)]
        self.mesh = mesh
        if mesh is not None:
            self._rungs.insert(0, ("mesh", mesh))
        self.mesh_cutover = mesh_cutover_lanes if mesh_cutover_lanes is not None else MESH_CUTOVER_LANES
        self.breaker = breaker if breaker is not None else CircuitBreaker(tuple(name for name, _ in self._rungs))
        self.device = device
        self.host = host
        self.on_card = on_card(device)
        # The levels whose faults are the card's: never served by a slower rung.
        self._card_levels = frozenset(
            i for i, (name, rung) in enumerate(self._rungs) if name in ("mesh", "device") and on_card(rung)
        )

    # -- engine hooks (forwarded to the fast rungs when they have them) --
    # The mesh and device rungs each own a PackCache and table cache, so
    # lifecycle hooks fan out to both.

    def _fast_rungs(self) -> list:
        return [self.device] if self.mesh is None else [self.mesh, self.device]

    def warmup(self, **kw) -> None:
        for rung in self._fast_rungs():
            if hasattr(rung, "warmup"):
                rung.warmup(**kw)

    def note_round(self, round_: int) -> None:
        for rung in self._fast_rungs():
            if hasattr(rung, "note_round"):
                rung.note_round(round_)

    def reset_pack_cache(self) -> None:
        for rung in self._fast_rungs():
            if hasattr(rung, "reset_pack_cache"):
                rung.reset_pack_cache()

    def _pack_caches(self) -> List[PackCache]:
        return [cache for rung in self._fast_rungs() if hasattr(rung, "_pack_caches") for cache in rung._pack_caches()]

    def _below_mesh_cutover(self, level: int, probe: bool, n: int) -> Tuple[int, bool]:
        """Small drains skip the mesh rung (the padding and a launch a shard
        lose below the cutover).  A pending mesh probe cannot be answered by
        a drain that will not run the mesh: it is released for the next big
        drain.  Faults recorded at this forced device level are no-ops while
        the breaker sits at the mesh level (it counts faults at its active
        level only), as in the JAX package."""
        if self.mesh is not None and level == 0 and n < self.mesh_cutover:
            if probe:
                self.breaker.abort_probe(level)
            return 1, False
        return level, probe

    def scoped(self, owner: str) -> "EngineScope":
        """Per-engine lifecycle facade over the shared ladder."""
        return EngineScope(self, owner)

    # -- BatchVerifier ---------------------------------------------------

    def verify_senders(self, msgs: Sequence[IbftMessage]) -> np.ndarray:
        msgs = list(msgs)
        return self._drain(
            msgs, lambda rung, idxs: rung.verify_senders([msgs[i] for i in idxs]), quarantinable=msgs
        )

    def verify_committed_seals(
        self, proposal_hash: bytes, seals: Sequence[CommittedSeal], height: int
    ) -> np.ndarray:
        seals = list(seals)
        return self._drain(
            seals,
            lambda rung, idxs: rung.verify_committed_seals(proposal_hash, [seals[i] for i in idxs], height),
        )

    def verify_seal_lanes(self, lanes: Sequence[Tuple[bytes, CommittedSeal]], height: int) -> np.ndarray:
        """Cross-height sync drain through the degradation ladder."""
        lanes = list(lanes)
        return self._drain(
            lanes, lambda rung, idxs: self._run_seal_lanes(rung, [lanes[i] for i in idxs], height)
        )

    def verify_seals_early_exit(
        self,
        proposal_hash: bytes,
        seals: Sequence[CommittedSeal],
        height: int,
        threshold: Optional[int] = None,
    ) -> EarlyExitReport:
        """Early-exit drain through the degradation ladder: the breaker's
        active rung serves it; a rung fault — or a malformed lane, which
        the early-exit packers cannot bisect around — falls back to the
        FULL resilient drain (quarantine + breaker accounting intact),
        reported with ``skipped=0``."""
        seals = list(seals)
        level, probe = self._below_mesh_cutover(*self.breaker.acquire(), len(seals))
        rung = self._rungs[level][1]
        fn = getattr(rung, "verify_seals_early_exit", None)
        if fn is not None:
            try:
                report = fn(proposal_hash, seals, height, threshold=threshold)
            except MalformedLaneError:
                # Input poison, not a rung fault: release a pending probe.
                self.breaker.abort_probe(level)
            except Exception:
                if level in self._card_levels:
                    raise
                # ONE breaker fault per underlying failure: the full drain
                # below re-acquires this rung and records it.  A pending
                # probe is answered here (the probed rung ran and failed).
                if probe:
                    self.breaker.record_fault(level)
            else:
                self.breaker.record_success(level)
                return report
        elif probe:
            self.breaker.abort_probe(level)
        mask = self.verify_committed_seals(proposal_hash, seals, height)
        reached = host_quorum_reached(
            self.host._validators, [s.signer for s, ok in zip(seals, mask) if ok], height, threshold
        )
        return EarlyExitReport(mask, np.ones(len(seals), dtype=bool), reached, 0)

    @staticmethod
    def _run_seal_lanes(rung, lanes, height) -> np.ndarray:
        if hasattr(rung, "verify_seal_lanes"):
            return rung.verify_seal_lanes(lanes, height)
        # A bare BatchVerifier: validate lane shapes FIRST (drain-relative
        # lane indices for the bisection), then one single-hash drain per
        # distinct hash.
        validate_seal_lanes(lanes)
        out = np.zeros(len(lanes), dtype=bool)
        groups: Dict[bytes, List[int]] = {}
        for i, (proposal_hash, _seal) in enumerate(lanes):
            groups.setdefault(proposal_hash, []).append(i)
        for proposal_hash, idxs in groups.items():
            mask = np.asarray(
                rung.verify_committed_seals(proposal_hash, [lanes[i][1] for i in idxs], height), dtype=bool
            )
            out[np.asarray(idxs)] = mask[: len(idxs)]
        return out

    # -- drain machinery -------------------------------------------------

    def _drain(self, items, run, quarantinable=None) -> np.ndarray:
        n = len(items)
        out = np.zeros(n, dtype=bool)
        if n == 0:
            return out
        level, _ = self._below_mesh_cutover(*self.breaker.acquire(), n)
        quarantined: List[int] = []
        faulted = [False]
        self._verify(level, list(range(n)), run, out, quarantined, faulted)
        if faulted[0]:
            metrics.inc_counter(DRAIN_FAULTS_KEY)
            self.breaker.record_fault(level)
        else:
            self.breaker.record_success(level)
        if quarantined:
            metrics.inc_counter(QUARANTINED_LANES_KEY, len(quarantined))
            if quarantinable is not None:
                condemned = [quarantinable[i] for i in quarantined]
                for rung in self._fast_rungs():
                    if hasattr(rung, "quarantine"):
                        rung.quarantine(condemned)
        return out

    def _verify(self, level, idxs, run, out, quarantined, faulted) -> None:
        """Verify ``idxs`` at rung ``level``, bisecting around failures.

        Writes verdicts into ``out``; lanes no rung can process land in
        ``quarantined``.  ``faulted`` records whether THIS drain hit any
        non-malformed rung failure (one breaker fault per drain).
        """
        while idxs:
            try:
                mask = np.asarray(run(self._rungs[level][1], idxs), dtype=bool)
                out[np.asarray(idxs)] = mask[: len(idxs)]
                return
            except MalformedLaneError as err:
                # The packer named the lane: condemn it, retry the rest in
                # one piece (no bisection, no breaker fault).
                if not 0 <= err.lane < len(idxs):
                    quarantined.extend(idxs)
                    return
                quarantined.append(idxs[err.lane])
                idxs = idxs[: err.lane] + idxs[err.lane + 1 :]
            except Exception:
                if level in self._card_levels:
                    raise
                faulted[0] = True
                if len(idxs) == 1:
                    if level + 1 < len(self._rungs):
                        self._verify(level + 1, idxs, run, out, quarantined, faulted)
                    else:
                        quarantined.extend(idxs)
                    return
                mid = len(idxs) // 2
                self._verify(level, idxs[:mid], run, out, quarantined, faulted)
                idxs = idxs[mid:]


class AdaptiveBatchVerifier:
    """Host/device router: tiny batches on the host, large ones on the card.

    A device round trip has a fixed dispatch floor that dwarfs a handful of
    native per-message recovers, so a 4-validator cluster should not pay
    it, while a 100-validator quorum drain should.  Batches with fewer than
    ``cutover_lanes`` items run the sequential host path; everything else
    goes to the card.  Both paths give identical accept-sets, so the route
    is invisible to the engine.

    Implements both engine protocols (``BatchVerifier`` and
    ``FusedBatchVerifier``); the host fallback computes the voting-power
    quorum with exact Python ints.  Device-routed drains ride a
    :class:`ResilientBatchVerifier` ladder, and the fused certify paths fall
    back to the exact host-int route on any device exception — counted
    under ``("go-ibft", "resilient", "certify_fallback")`` — so a
    consensus phase never loses its verdict to a device fault.  On the card
    (:func:`on_card` of ``device``, or of ``mesh`` for the mesh route) there
    is no such fallback: a kernel fault propagates.

    An optional ``mesh`` route (a
    :class:`~go_ibft_tpu_torch.verify.mesh_batch.MeshBatchVerifier`) adds a
    second, upper cutover: drains of at least ``mesh_cutover_lanes`` lanes
    dispatch lane-sharded first, with the single-device routes as their
    breaker-accounted fallback off the card (ladder ``mesh -> device ->
    host -> python``).  It is never built by default: sharding is the
    caller's choice.
    """

    def __init__(
        self,
        validators_for_height: ValidatorSource,
        cutover_lanes: Optional[int] = None,
        device: Optional[DeviceBatchVerifier] = None,
        host: Optional[HostBatchVerifier] = None,
        breaker: Optional[CircuitBreaker] = None,
        *,
        mesh=None,
        mesh_cutover_lanes: Optional[int] = None,
    ):
        from ..utils import calibration

        self._validators = validators_for_height
        if cutover_lanes is None:
            # Measurement first (a record of this card), the static
            # conservative default only when none exists.
            cutover_lanes = calibration.measured_cutover() or calibration.DEFAULT_CUTOVER_LANES
        self.cutover = cutover_lanes
        self.device = device if device is not None else DeviceBatchVerifier(validators_for_height)
        self.host = host if host is not None else HostBatchVerifier(validators_for_height)
        self._mesh = mesh
        self._resilient = ResilientBatchVerifier(
            self.device,
            host=self.host,
            mesh=mesh,
            mesh_cutover_lanes=mesh_cutover_lanes,
            validators_for_height=validators_for_height,
            breaker=breaker,
        )
        self.mesh_cutover = self._resilient.mesh_cutover
        # The single-device rung's breaker level: 0 without a mesh, 1 with
        # one (the mesh occupies level 0).
        self._device_level = 0 if mesh is None else 1
        self.breaker = self._resilient.breaker

    def warmup(self, **kw) -> None:
        self._resilient.warmup(**kw)

    def note_round(self, round_: int) -> None:
        """Engine hook: forward round advances to the fast-rung pack caches."""
        self._resilient.note_round(round_)

    def reset_pack_cache(self) -> None:
        self._resilient.reset_pack_cache()

    def _pack_caches(self) -> List[PackCache]:
        return self._resilient._pack_caches()

    def scoped(self, owner: str) -> "EngineScope":
        """Per-engine lifecycle facade over the shared adaptive router."""
        return EngineScope(self, owner)

    def _host_reached(self, valid_addrs: Iterable[bytes], height: int, threshold: Optional[int]) -> bool:
        with trace.span("verify.quorum", route="host-int"):
            return host_quorum_reached(self._validators, valid_addrs, height, threshold)

    # -- BatchVerifier ---------------------------------------------------

    def _host_sized(self, n: int) -> bool:
        # Below the cutover the dispatch floor loses to a handful of native
        # host recovers.  No upper bound: floods above the largest lane
        # bucket stay on the card as chunked full-bucket dispatches.
        return n < self.cutover

    def verify_senders(self, msgs: Sequence[IbftMessage]) -> np.ndarray:
        if self._host_sized(len(msgs)):
            return self.host.verify_senders(msgs)
        return self._resilient.verify_senders(msgs)

    def verify_committed_seals(
        self, proposal_hash: bytes, seals: Sequence[CommittedSeal], height: int
    ) -> np.ndarray:
        if self._host_sized(len(seals)):
            return self.host.verify_committed_seals(proposal_hash, seals, height)
        return self._resilient.verify_committed_seals(proposal_hash, seals, height)

    def verify_seal_lanes(self, lanes: Sequence[Tuple[bytes, CommittedSeal]], height: int) -> np.ndarray:
        if self._host_sized(len(lanes)):
            return self.host.verify_seal_lanes(lanes, height)
        return self._resilient.verify_seal_lanes(lanes, height)

    def verify_seals_early_exit(
        self,
        proposal_hash: bytes,
        seals: Sequence[CommittedSeal],
        height: int,
        threshold: Optional[int] = None,
    ) -> EarlyExitReport:
        """Tiny batches take the host's arrival-order early exit, larger
        ones the ladder's power-ordered chunked route."""
        if self._host_sized(len(seals)):
            return self.host.verify_seals_early_exit(proposal_hash, seals, height, threshold=threshold)
        return self._resilient.verify_seals_early_exit(proposal_hash, seals, height, threshold=threshold)

    # -- FusedBatchVerifier ---------------------------------------------

    def supports_fused(self, height: int) -> bool:
        """Always true: sets the device range cannot represent exactly
        (powers >= 2**31) are routed to the host big-int path instead."""
        return True

    def _route_device(self, n: int, height: int) -> bool:
        # One fused dispatch fits one lane bucket; larger floods use the
        # chunked device crypto with the quorum on host ints.
        return self.cutover <= n <= _BATCH_BUCKETS[-1] and self.device.supports_fused(height)

    def _breaker_gate(self) -> Tuple[bool, Optional[int]]:
        """Consult the breaker before a fused device dispatch:
        ``(use_device, acquired_level)``.  When the ladder is demoted the
        dispatch is suppressed, and the acquisition is released with
        ``abort_probe`` once the call ends (a pending probe must neither
        leak nor count as evidence for a rung that did not run).  At the
        device rung, its own cooldown probe included, success or fault at
        the device level is the answer.  With a mesh the device sits at
        level 1: a pending mesh probe is not consumed by a single-device
        dispatch (it stays pending through the fallback), while a healthy
        mesh level lets the device run without evidence against the
        mesh."""
        level, probe = self.breaker.acquire()
        if level == self._device_level:
            return True, None
        if level < self._device_level and not probe:
            return True, None
        return False, level

    def _device_faulted(self) -> None:
        """Inside an ``except``: re-raise on the card, else count the
        fallback and record the fault."""
        if self._resilient.on_card:
            raise
        metrics.inc_counter(CERTIFY_FALLBACK_KEY)
        self.breaker.record_fault(self._device_level)

    def _try_mesh(self, n: int, call):
        """One fused dispatch on the mesh rung, breaker-accounted.

        Returns the call's result, or ``None`` when the mesh route is not
        taken (no mesh, under the cutover, breaker demoted), faulted off the
        card (recorded; the single-device routes serve the call) or met a
        malformed lane (probe released; the ladder quarantines it).  On the
        card a mesh fault propagates."""
        if self._mesh is None or n < self.mesh_cutover:
            return None
        level, probe = self.breaker.acquire()
        if level != 0:
            if probe:
                # A probe of a slower rung cannot be answered by a mesh
                # dispatch that will not run: the next gate re-acquires it.
                self.breaker.abort_probe(level)
            return None
        try:
            result = call(self._mesh)
        except MalformedLaneError:
            self.breaker.abort_probe(0)
            return None
        except Exception:
            if on_card(self._mesh):
                raise
            metrics.inc_counter(CERTIFY_FALLBACK_KEY)
            self.breaker.record_fault(0)
            return None
        self.breaker.record_success(0)
        return result

    @staticmethod
    def _chunked_device(n: int) -> bool:
        # No supports_fused gate: the chunked route's quorum is host ints.
        return n > _BATCH_BUCKETS[-1]

    def _certify(
        self, n: int, height: int, mesh: Callable, fused: Callable, ladder: Callable, host: Callable, valid_of
    ):
        """One certify call: the mesh route for big drains, then the fused
        device dispatch when routed there, else (or after a fault off the
        card) the ladder or the host drain with the exact host-int quorum."""
        result = self._try_mesh(n, mesh)
        if result is not None:
            return result
        fallback_level = None
        device_route = self._route_device(n, height)
        if device_route:
            use_device, fallback_level = self._breaker_gate()
            if use_device:
                try:
                    result = fused()
                    self.breaker.record_success(self._device_level)
                    return result
                except MalformedLaneError:
                    # Input poison, not a device fault: release a pending
                    # probe; the ladder below quarantines the lane.
                    self.breaker.abort_probe(self._device_level)
                except Exception:
                    # Device fault mid-phase: the fallback below still
                    # produces the verdict.
                    self._device_faulted()
        mask = ladder() if device_route or self._chunked_device(n) else host()
        if fallback_level is not None:
            self.breaker.abort_probe(fallback_level)
        return mask, valid_of(mask)

    def certify_senders(
        self, msgs: Sequence[IbftMessage], height: int, threshold: Optional[int] = None
    ) -> Tuple[np.ndarray, bool]:
        def valid_of(mask):
            # Same height gate as the device path (certify is per-view).
            for i, m in enumerate(msgs):
                if m.view is None or m.view.height != height:
                    mask[i] = False
            return self._host_reached([m.sender for m, ok in zip(msgs, mask) if ok], height, threshold)

        return self._certify(
            len(msgs), height,
            lambda m: m.certify_senders(msgs, height, threshold),
            lambda: self.device.certify_senders(msgs, height, threshold),
            lambda: self._resilient.verify_senders(msgs),
            lambda: self.host.verify_senders(msgs),
            valid_of,
        )

    def certify_seals(
        self,
        proposal_hash: bytes,
        seals: Sequence[CommittedSeal],
        height: int,
        threshold: Optional[int] = None,
    ) -> Tuple[np.ndarray, bool]:
        return self._certify(
            len(seals), height,
            lambda m: m.certify_seals(proposal_hash, seals, height, threshold),
            lambda: self.device.certify_seals(proposal_hash, seals, height, threshold),
            lambda: self._resilient.verify_committed_seals(proposal_hash, seals, height),
            lambda: self.host.verify_committed_seals(proposal_hash, seals, height),
            lambda mask: self._host_reached([s.signer for s, ok in zip(seals, mask) if ok], height, threshold),
        )

    def certify_round(
        self,
        msgs: Sequence[IbftMessage],
        proposal_hash: bytes,
        seals: Sequence[CommittedSeal],
        height: int,
        prepare_threshold: Optional[int] = None,
    ) -> Tuple[np.ndarray, bool, np.ndarray, bool]:
        if msgs and seals and len(proposal_hash) == 32:
            result = self._try_mesh(
                max(len(msgs), len(seals)),
                lambda m: m.certify_round(msgs, proposal_hash, seals, height, prepare_threshold),
            )
            if result is not None:
                return result
        fallback_level = None
        if self._route_device(max(len(msgs), len(seals)), height) and msgs and seals:
            use_device, fallback_level = self._breaker_gate()
            if use_device:
                try:
                    result = self.device.certify_round(msgs, proposal_hash, seals, height, prepare_threshold)
                    self.breaker.record_success(self._device_level)
                    return result
                except MalformedLaneError:
                    self.breaker.abort_probe(self._device_level)
                except Exception:
                    # The per-phase routes below carry their own breaker
                    # accounting and ladder fallbacks.
                    self._device_faulted()
        if (
            msgs
            and seals
            and len(proposal_hash) == 32
            and self._chunked_device(max(len(msgs), len(seals)))
            and min(len(msgs), len(seals)) >= self.cutover
            and hasattr(self.device, "verify_round_chunked")
        ):
            # Oversize round: BOTH phases drain through one device pipeline;
            # the quorum reduces on exact host ints.
            try:
                sender_mask, seal_mask = self.device.verify_round_chunked(msgs, proposal_hash, seals, height)
            except Exception:
                self._device_faulted()
            else:
                p_ok = self._host_reached(
                    [m.sender for m, ok in zip(msgs, sender_mask) if ok], height, prepare_threshold
                )
                s_ok = self._host_reached([s.signer for s, ok in zip(seals, seal_mask) if ok], height, None)
                if fallback_level is not None:
                    self.breaker.abort_probe(fallback_level)
                return sender_mask, p_ok, seal_mask, s_ok
        sender_mask, p_ok = self.certify_senders(msgs, height, threshold=prepare_threshold)
        seal_mask, s_ok = self.certify_seals(proposal_hash, seals, height)
        if fallback_level is not None:
            # Released AFTER the per-phase routes: their own gates see the
            # probe as still pending and cannot double-acquire it.
            self.breaker.abort_probe(fallback_level)
        return sender_mask, p_ok, seal_mask, s_ok


class EngineScope:
    """Per-engine lifecycle facade over a SHARED verifier ladder.

    N engines may share one verifier so their drains land on one device
    data plane, but the lifecycle hooks carry per-sequence/per-round state:
    ``ladder.scoped("chain-a")`` returns a drop-in ``BatchVerifier`` whose
    verify calls attribute their pack-cache stores to the owner
    (:meth:`PackCache.owned`) and whose ``note_round`` /
    ``reset_pack_cache`` rotate/drop ONLY the owner's entries; every other
    attribute delegates to the shared parent.
    """

    def __init__(self, parent, owner: str):
        if not owner:
            raise ValueError("EngineScope requires a non-empty owner label")
        self._parent = parent
        self._owner = owner

    @property
    def owner(self) -> str:
        return self._owner

    def __getattr__(self, name: str):
        return getattr(self._parent, name)

    def _caches(self) -> List[PackCache]:
        fn = getattr(self._parent, "_pack_caches", None)
        return fn() if fn is not None else []

    def _owned(self) -> ExitStack:
        stack = ExitStack()
        for cache in self._caches():
            stack.enter_context(cache.owned(self._owner))
        return stack

    # -- owner-scoped engine lifecycle hooks -----------------------------

    def note_round(self, round_: int) -> None:
        for cache in self._caches():
            cache.note_round(round_, owner=self._owner)

    def reset_pack_cache(self) -> None:
        for cache in self._caches():
            cache.clear(owner=self._owner)

    # -- BatchVerifier (stores attributed to the owner) ------------------

    def verify_senders(self, msgs: Sequence[IbftMessage]) -> np.ndarray:
        with self._owned():
            return self._parent.verify_senders(msgs)

    def verify_committed_seals(
        self, proposal_hash: bytes, seals: Sequence[CommittedSeal], height: int
    ) -> np.ndarray:
        with self._owned():
            return self._parent.verify_committed_seals(proposal_hash, seals, height)

    def verify_seal_lanes(self, lanes: Sequence[Tuple[bytes, CommittedSeal]], height: int) -> np.ndarray:
        with self._owned():
            return self._parent.verify_seal_lanes(lanes, height)
