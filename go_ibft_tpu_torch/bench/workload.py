"""Deterministic signed-round workload builder (port of
``go_ibft_tpu.bench.workload``).

Builds what a real IBFT round at height ``h`` produces: one PREPARE
envelope and one COMMIT seal per validator, all genuinely ECDSA-signed,
packed into the static-shape arrays ``round_certify`` consumes — the same
numpy arrays, bit for bit, as the JAX package's builder for the same
arguments.  A ``corrupt_frac`` knob flips signature
bytes on a deterministic subset — the Byzantine-mix config — whose lanes
the kernels must mask out.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

import numpy as np

from ..crypto import PrivateKey
from ..crypto.backend import ECDSABackend, proposal_hash_of
from ..messages.helpers import CommittedSeal, extract_committed_seal
from ..messages.wire import Proposal, View
from ..ops.quorum import split_power
from ..verify.batch import pack_seal_batch, pack_sender_batch, pack_validator_table

_key_cache: Dict[Tuple[int, int], list] = {}


def _keys(n: int, seed: int) -> list:
    hit = _key_cache.get((n, seed))
    if hit is None:
        hit = [
            PrivateKey.from_seed(b"bench-%d-%d" % (seed, i)) for i in range(n)
        ]
        _key_cache[(n, seed)] = hit
    return hit


@dataclass
class SignedRound:
    """One round's raw signed material, BEFORE device packing.

    The unpacked twin of :class:`RoundWorkload`: the messages and seals
    feed :meth:`DeviceBatchVerifier.certify_round`, the packed form feeds
    :func:`go_ibft_tpu_torch.ops.quorum.round_certify`.
    """

    n_validators: int
    height: int
    prepares: list
    seals: list
    proposal_hash: bytes
    table: np.ndarray  # (V, 5) uint32
    powers_lo: np.ndarray
    powers_hi: np.ndarray
    thr_lo: int
    thr_hi: int
    expected_prepare_mask: np.ndarray
    expected_seal_mask: np.ndarray

    def pack(self, pad_lanes: int = 0) -> "RoundWorkload":
        """Pack PREPARE envelopes + COMMIT seals to device-ready arrays."""
        return RoundWorkload(
            n_validators=self.n_validators,
            height=self.height,
            prepare=pack_sender_batch(self.prepares, pad_lanes),
            seals=pack_seal_batch(self.proposal_hash, self.seals, pad_lanes),
            table=self.table,
            powers_lo=self.powers_lo,
            powers_hi=self.powers_hi,
            thr_lo=self.thr_lo,
            thr_hi=self.thr_hi,
            expected_prepare_mask=self.expected_prepare_mask,
            expected_seal_mask=self.expected_seal_mask,
        )


@dataclass
class RoundWorkload:
    """Device-ready arrays for one round's PREPARE + COMMIT phases."""

    n_validators: int
    height: int
    # prepare phase: (blocks, counts, r, s, v, senders, live)
    prepare: tuple
    # commit-seal phase: (hash_words, r, s, v, signers, live)
    seals: tuple
    table: np.ndarray  # (V, 5) uint32
    powers_lo: np.ndarray
    powers_hi: np.ndarray
    thr_lo: int
    thr_hi: int
    expected_prepare_mask: np.ndarray
    expected_seal_mask: np.ndarray


def build_signed_round(
    n_validators: int,
    *,
    height: int = 1,
    corrupt_frac: float = 0.0,
    seed: int = 0,
) -> SignedRound:
    """Build one signed (unpacked) round: real keys, real ECDSA envelopes
    and seals, deterministic corruption for the Byzantine variants."""
    keys = _keys(n_validators, seed)
    powers = {k.address: 1 for k in keys}
    src = ECDSABackend.static_validators(powers)
    backends = [ECDSABackend(k, src) for k in keys]
    view = View(height=height, round=0)
    proposal = Proposal(raw_proposal=b"bench block %d" % height, round=0)
    phash = proposal_hash_of(proposal)

    prepares = [b.build_prepare_message(phash, view) for b in backends]
    commits = [b.build_commit_message(phash, view) for b in backends]
    seals = [extract_committed_seal(c) for c in commits]

    n_corrupt = int(n_validators * corrupt_frac)
    rng = np.random.default_rng(seed)
    corrupt_idx = rng.choice(n_validators, size=n_corrupt, replace=False)
    expected_prepare = np.ones(n_validators, dtype=bool)
    expected_seal = np.ones(n_validators, dtype=bool)
    for i in corrupt_idx:
        sig = bytearray(prepares[i].signature)
        sig[5] ^= 0xFF  # mangle r -> recovers to a different key
        prepares[i].signature = bytes(sig)
        expected_prepare[i] = False
        seal_sig = bytearray(seals[i].signature)
        seal_sig[5] ^= 0xFF
        seals[i] = CommittedSeal(signer=seals[i].signer, signature=bytes(seal_sig))
        expected_seal[i] = False

    table = pack_validator_table([k.address for k in keys])
    lo_hi = [split_power(powers[k.address]) for k in keys]
    v = table.shape[0]
    powers_lo = np.zeros(v, dtype=np.int32)
    powers_hi = np.zeros(v, dtype=np.int32)
    powers_lo[:n_validators] = [lh[0] for lh in lo_hi]
    powers_hi[:n_validators] = [lh[1] for lh in lo_hi]
    total = sum(powers.values())
    threshold = (2 * total) // 3 + 1
    thr_lo, thr_hi = threshold & 0xFFFF, threshold >> 16

    return SignedRound(
        n_validators=n_validators,
        height=height,
        prepares=prepares,
        seals=seals,
        proposal_hash=phash,
        table=table,
        powers_lo=powers_lo,
        powers_hi=powers_hi,
        thr_lo=thr_lo,
        thr_hi=thr_hi,
        expected_prepare_mask=expected_prepare,
        expected_seal_mask=expected_seal,
    )


def build_round_workload(
    n_validators: int,
    *,
    height: int = 1,
    corrupt_frac: float = 0.0,
    seed: int = 0,
    pad_lanes: int = 0,
) -> RoundWorkload:
    return build_signed_round(
        n_validators, height=height, corrupt_frac=corrupt_frac, seed=seed
    ).pack(pad_lanes)


@dataclass
class SealLaneWorkload:
    """A multi-height committed-seal lane set (the block-sync drain shape).

    ``lanes`` are ``(proposal_hash, seal)`` pairs spanning several heights
    (each height signs its own hash — the per-lane-hash shape
    ``verify_seal_lanes`` drains); ``expected_mask`` is the sequential
    oracle's verdict per lane.  Distinct signatures are bounded by
    ``n_validators x heights`` and TILED out to ``n_lanes`` — duplicated
    lanes cost the verifier exactly the same ladder work as distinct ones
    (no dedup anywhere in the drain), so throughput measurements stay
    honest while host signing stays off the critical path.
    """

    lanes: list  # [(proposal_hash, CommittedSeal), ...]
    height: int  # representative height for the (static) validator table
    validators: object  # ValidatorSource (height -> {address: power})
    expected_mask: np.ndarray


def build_seal_lane_workload(
    n_lanes: int,
    *,
    n_validators: int = 100,
    heights: int = 4,
    corrupt_frac: float = 0.0,
    seed: int = 0,
) -> SealLaneWorkload:
    """Build ``n_lanes`` seal lanes across ``heights`` proposal hashes."""
    keys = _keys(n_validators, seed)
    powers = {k.address: 1 for k in keys}
    src = ECDSABackend.static_validators(powers)
    backends = [ECDSABackend(k, src) for k in keys]
    distinct: list = []
    ok: list = []
    rng = np.random.default_rng(seed)
    for h in range(1, heights + 1):
        proposal = Proposal(raw_proposal=b"mesh bench block %d" % h, round=0)
        phash = proposal_hash_of(proposal)
        view = View(height=h, round=0)
        for b in backends:
            seal = extract_committed_seal(b.build_commit_message(phash, view))
            good = True
            if corrupt_frac and rng.random() < corrupt_frac:
                sig = bytearray(seal.signature)
                sig[5] ^= 0xFF
                seal = CommittedSeal(signer=seal.signer, signature=bytes(sig))
                good = False
            distinct.append((phash, seal))
            ok.append(good)
            if len(distinct) >= n_lanes:
                break
        if len(distinct) >= n_lanes:
            break
    reps = (n_lanes + len(distinct) - 1) // len(distinct)
    lanes = (distinct * reps)[:n_lanes]
    expected = (np.asarray(ok, dtype=bool).tolist() * reps)[:n_lanes]
    return SealLaneWorkload(
        lanes=lanes,
        height=1,
        validators=src,
        expected_mask=np.asarray(expected, dtype=bool),
    )
