"""Aggregate quorum certificates: O(1)-size proof that a COMMIT quorum sealed
(the port of ``go_ibft_tpu/crypto/quorum_cert.py``; the device routes run the
port's pairing kernels, on ``torch_device``, ``None`` meaning the card).

The engine's per-seal finalization evidence is O(N): one 192-byte BLS (or
65-byte ECDSA) seal per committing validator, re-verified seal-by-seal at
every consumer (WAL replay sanity, block-sync catch-up, light clients).
This module compresses a round's COMMIT quorum into a constant-size
:class:`AggregateQuorumCertificate` — one aggregated G2 point plus a
signer bitmap over the height's sorted validator set — verified with ONE
pairing equation regardless of committee size ("Performance of EdDSA and
BLS Signatures in Committee-Based Consensus", PAPERS.md 2302.00418).

Three consumers share it end to end:

* the engine (:meth:`IBFT.add_quorum_certificate`) finalizes a height
  straight from a verified certificate when the aggregation-tree gossip
  transport (:mod:`go_ibft_tpu_torch.net.aggtree`) delivers one;
* the WAL (:mod:`go_ibft_tpu_torch.chain.wal`) persists the certificate instead
  of N seals — finalize records stop scaling with committee size;
* block-sync (:mod:`go_ibft_tpu_torch.chain.sync`) re-verifies a fetched range
  with one certificate equation per height instead of N seal lanes —
  batched: the whole range's equations verify as ONE multi-pairing
  dispatch through :meth:`BLSCertifier.verify_many`.

Rogue-key safety: aggregation is only sound over public keys whose
holders have proven possession of the secret scalar (a registered
``pk' = pk_rogue - sum(honest)`` would otherwise let one attacker forge
the whole quorum).  :class:`BLSKeyRegistry` is the enforcement point —
registration REQUIRES a valid proof of possession
(:func:`go_ibft_tpu_torch.crypto.bls.prove_possession`), and the certifier's
key source is expected to be built from one.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass
from typing import Callable, Dict, List, Mapping, Optional, Sequence

from ..core.validator_manager import calculate_quorum
from ..messages.helpers import CommittedSeal
from ..verify.bls import (
    BLS_SEAL_BYTES,
    aggregate_check,
    decode_seal,
    encode_seal,
)
from ..utils.device import DeviceLike, resolve_device
from ..verify.batch import on_card
from . import bls as hbls

__all__ = [
    "AGG_CERT_SIGNER",
    "AggregateQuorumCertificate",
    "BLSCertifier",
    "BLSKeyRegistry",
]

_VERSION = 1
_HEADER = struct.Struct(">BQIH")  # version, height, round, bitmap length

# Sentinel signer for the synthetic CommittedSeal an engine records when a
# height finalized from an aggregate certificate rather than individual
# seals (no 20-byte consensus address can be all-0xFF: addresses are
# keccak-derived, and the validator registries never contain it).
AGG_CERT_SIGNER = b"\xff" * 20


@dataclass
class AggregateQuorumCertificate:
    """One round's COMMIT quorum, compressed to O(1).

    ``bitmap`` bit *i* (LSB-first within each byte) marks the *i*-th
    address of the height's SORTED validator set as a signer — the one
    canonical ordering every party can re-derive, so the certificate
    needs no address list.
    """

    height: int
    round: int
    proposal_hash: bytes  # 32 bytes
    agg_seal: bytes  # 192-byte aggregated G2 point
    bitmap: bytes

    # -- codec ----------------------------------------------------------

    def encode(self) -> bytes:
        if len(self.proposal_hash) != 32:
            raise ValueError("proposal hash must be 32 bytes")
        if len(self.agg_seal) != BLS_SEAL_BYTES:
            raise ValueError("aggregated seal must be 192 bytes")
        return (
            _HEADER.pack(_VERSION, self.height, self.round, len(self.bitmap))
            + self.proposal_hash
            + self.agg_seal
            + self.bitmap
        )

    @classmethod
    def decode(cls, blob: bytes) -> "AggregateQuorumCertificate":
        if len(blob) < _HEADER.size + 32 + BLS_SEAL_BYTES:
            raise ValueError("quorum certificate too short")
        version, height, round_, bitmap_len = _HEADER.unpack_from(blob)
        if version != _VERSION:
            raise ValueError(f"unknown quorum certificate version {version}")
        body = blob[_HEADER.size :]
        expected = 32 + BLS_SEAL_BYTES + bitmap_len
        if len(body) != expected:
            raise ValueError(
                f"quorum certificate body {len(body)}B != {expected}B"
            )
        return cls(
            height=height,
            round=round_,
            proposal_hash=body[:32],
            agg_seal=body[32 : 32 + BLS_SEAL_BYTES],
            bitmap=body[32 + BLS_SEAL_BYTES :],
        )

    # -- bitmap helpers --------------------------------------------------

    def signer_indices(self) -> List[int]:
        return [
            byte_i * 8 + bit
            for byte_i, byte in enumerate(self.bitmap)
            for bit in range(8)
            if byte >> bit & 1
        ]

    def signers(self, ordered_validators: Sequence[bytes]) -> List[bytes]:
        """Resolve the bitmap against the height's sorted validator set.

        Raises :class:`ValueError` on out-of-range bits — a certificate
        claiming signers beyond the set is malformed, not merely
        unsatisfied.
        """
        idxs = self.signer_indices()
        if idxs and idxs[-1] >= len(ordered_validators):
            raise ValueError("certificate bitmap exceeds the validator set")
        return [ordered_validators[i] for i in idxs]

    def to_seal(self) -> CommittedSeal:
        """The synthetic seal an engine without a chain layer records."""
        return CommittedSeal(signer=AGG_CERT_SIGNER, signature=self.encode())

    @staticmethod
    def bitmap_of(indices: Sequence[int], n: int) -> bytes:
        out = bytearray((n + 7) // 8)
        for i in indices:
            out[i // 8] |= 1 << (i % 8)
        return bytes(out)


class BLSKeyRegistry:
    """Proof-of-possession-gated BLS pubkey registry for one validator set.

    The ONLY way a key enters the aggregation set is :meth:`register` with
    a valid PoP — the rogue-key defense lives here, not in every verifier.
    The registry is callable with a height (returns the address -> pubkey
    map) so it drops into every ``bls_keys_for_height`` seam unchanged.
    """

    def __init__(self) -> None:
        self._keys: Dict[bytes, "hbls.PointG1"] = {}

    def register(
        self, address: bytes, pubkey: "hbls.PointG1", proof: "hbls.PointG2"
    ) -> None:
        if not hbls.verify_possession(pubkey, proof):
            raise ValueError(
                "BLS pubkey registration rejected: invalid proof of "
                "possession (rogue-key defense)"
            )
        self._keys[bytes(address)] = pubkey

    def register_key(self, address: bytes, key: "hbls.BLSPrivateKey") -> None:
        """Register a locally-held key (derives the PoP itself)."""
        self.register(address, key.pubkey, hbls.prove_possession(key))

    def __call__(self, _height: int) -> Mapping[bytes, "hbls.PointG1"]:
        return self._keys

    def __len__(self) -> int:
        return len(self._keys)


class BLSCertifier:
    """Builds and verifies aggregate quorum certificates for a chain.

    ``validators_for_height`` is the voting-power source (the engine's
    own seam); ``bls_keys_for_height`` maps height -> {address: G1
    pubkey} and MUST be PoP-gated (:class:`BLSKeyRegistry`).  ``device``
    routes the pairing through
    :func:`go_ibft_tpu_torch.ops.bls12_381.aggregate_verify_commit` (and
    ``verify_many`` through the multi-pairing kernels) on ``torch_device``.
    """

    def __init__(
        self,
        validators_for_height: Callable[[int], Mapping[bytes, int]],
        bls_keys_for_height: Callable[[int], Mapping[bytes, "hbls.PointG1"]],
        *,
        device: bool = False,
        multipair=None,
        aggregator=None,
        torch_device: DeviceLike = None,
    ) -> None:
        self._validators = validators_for_height
        self._keys = bls_keys_for_height
        self._device = device
        # Where the device routes run (None: the card).
        self._torch_device = resolve_device(torch_device) if device else None
        # Batched verification route: ``multipair`` is a
        # :class:`~go_ibft_tpu_torch.verify.aggregate.MultiPairVerifier` (or
        # anything with ``check(lanes)``); :meth:`verify_many` routes a
        # whole certificate batch through ONE batched dispatch.  Default:
        # the functional ``multi_aggregate_check`` on the device or
        # host-batch route per ``device``.
        self._multipair = multipair
        # ``aggregator`` is a :class:`~go_ibft_tpu_torch.verify.aggregate.
        # G2MergeTree` (or anything with ``merge(points)``): ``build``'s
        # seal aggregation then rides the vmapped device merge tree
        # instead of the sequential host g2_add loop (bit-identical
        # results; the host loop is the oracle and the default).
        self._aggregator = aggregator

    @property
    def device(self):
        """What :func:`~go_ibft_tpu_torch.verify.batch.on_card` reads: the
        merge tree or multi-pairing verifier where one runs on the card,
        else this certifier's own device (None on the host route)."""
        on = [c for c in (self._aggregator, self._multipair) if c is not None and on_card(c)]
        return on[0] if on else self._torch_device

    # -- build -----------------------------------------------------------

    def build(
        self,
        height: int,
        round_: int,
        proposal_hash: bytes,
        seals: Sequence[CommittedSeal],
    ) -> Optional[AggregateQuorumCertificate]:
        """Compress a seal quorum into a certificate (no pairing: the
        seals were verified when the quorum formed).

        Seals that do not decode, or whose signer is outside the height's
        validator set, are skipped; returns None when the survivors'
        voting power does not reach quorum (a certificate that cannot
        verify is worse than per-seal evidence) or when any input is the
        synthetic aggregate seal (already a certificate).
        """
        members = self._validators(height)
        points: List["hbls.PointG2"] = []
        signers: List[bytes] = []
        for seal in seals:
            if seal.signer == AGG_CERT_SIGNER:
                return None
            if seal.signer not in members or seal.signer in signers:
                continue
            pt = decode_seal(seal.signature)
            if pt is None:
                continue
            points.append(pt)
            signers.append(seal.signer)
        if not points:
            return None
        if self._aggregator is not None:
            # Device merge tree: one dispatch folds the whole quorum
            # (log-depth) instead of len(points) sequential host adds.
            agg = self._aggregator.merge(points)
        else:
            agg = hbls.aggregate_signatures(points)
        if agg is None:
            return None
        return self.build_from_aggregate(
            height, round_, proposal_hash, agg, signers
        )

    def build_from_aggregate(
        self,
        height: int,
        round_: int,
        proposal_hash: bytes,
        agg_point: "hbls.PointG2",
        signers: Sequence[bytes],
    ) -> Optional[AggregateQuorumCertificate]:
        """Certificate from an ALREADY-MERGED aggregate (the aggregation-
        tree root's seam: the tree merged disjoint partials on the way
        up, so the root holds one G2 point + a signer set, never
        individual seals).  Returns None below quorum power or when a
        signer is outside the height's validator set."""
        if agg_point is None:
            return None
        powers = self._validators(height)
        ordered = sorted(powers)
        index_of = {addr: i for i, addr in enumerate(ordered)}
        indices = []
        for addr in set(signers):
            idx = index_of.get(addr)
            if idx is None:
                return None
            indices.append(idx)
        got = sum(powers[ordered[i]] for i in indices)
        if got < calculate_quorum(sum(powers.values())):
            return None
        return AggregateQuorumCertificate(
            height=height,
            round=round_,
            proposal_hash=bytes(proposal_hash),
            agg_seal=encode_seal(agg_point),
            bitmap=AggregateQuorumCertificate.bitmap_of(
                sorted(indices), len(ordered)
            ),
        )

    def is_member(self, height: int, address: bytes) -> bool:
        """Cheap membership gate: is ``address`` a validator at ``height``
        with a registered BLS key?  (The aggregation tree drops non-member
        COMMITs from the aggregate path at ingest — a foreign signer would
        otherwise poison every ``build_from_aggregate`` for the round.)"""
        return (
            address in self._validators(height)
            and self._keys(height).get(address) is not None
        )

    def partial_valid(
        self,
        height: int,
        proposal_hash: bytes,
        point: "hbls.PointG2",
        signers: Sequence[bytes],
    ) -> bool:
        """ONE pairing over a partial aggregate: does ``point`` verify as
        the aggregate seal of exactly ``signers`` over ``proposal_hash``?
        The aggregation tree's quarantine walk uses this to bisect a
        failing root aggregate down to the Byzantine contribution."""
        if point is None or not signers:
            return False
        keys = self._keys(height)
        pubkeys = []
        for addr in signers:
            pk = keys.get(addr)
            if pk is None:
                return False
            pubkeys.append(pk)
        return aggregate_check(
            proposal_hash, [point], pubkeys, device=self._device, torch_device=self._torch_device
        )

    # -- verify ----------------------------------------------------------

    def _lane_of(self, cert: AggregateQuorumCertificate):
        """The certificate's pairing lane ``(proposal_hash, [point],
        pubkeys)`` after every cheap check, or None when a structural
        check already condemns it (no pairing needed).

        Checks, in cost order: structural sanity, bitmap-resolved signers
        exist in BOTH the power map and the PoP-gated key registry,
        combined voting power reaches the height's quorum, and the
        aggregated point is a valid r-torsion G2 element.
        """
        if len(cert.proposal_hash) != 32:
            return None
        powers = self._validators(cert.height)
        if not powers:
            return None
        ordered = sorted(powers)
        try:
            signers = cert.signers(ordered)
        except ValueError:
            return None
        if not signers:
            return None
        quorum = calculate_quorum(sum(powers.values()))
        if sum(powers[a] for a in signers) < quorum:
            return None
        keys = self._keys(cert.height)
        pubkeys = []
        for addr in signers:
            pk = keys.get(addr)
            if pk is None:
                return None
            pubkeys.append(pk)
        point = decode_seal(cert.agg_seal)
        if point is None:
            return None
        return cert.proposal_hash, [point], pubkeys

    def verify(self, cert: AggregateQuorumCertificate) -> bool:
        """ONE pairing equation + exact-int quorum power over the bitmap
        (see :meth:`_lane_of` for the pre-pairing check order)."""
        lane = self._lane_of(cert)
        if lane is None:
            return False
        phash, points, pubkeys = lane
        return aggregate_check(
            phash, points, pubkeys, device=self._device, torch_device=self._torch_device
        )

    def verify_many(self, certs: Sequence[AggregateQuorumCertificate]):
        """MANY certificates through ONE batched multi-pairing dispatch.

        Per-cert verdicts (numpy bool array) bit-identical to
        :meth:`verify` lane-for-lane: structurally-condemned certificates
        are False without costing any pairing work, the survivors verify
        together through the injected
        :class:`~go_ibft_tpu_torch.verify.aggregate.MultiPairVerifier` (or the
        functional batch entry on the device/host route per the
        certifier's ``device`` flag).  This is the block-sync / proof-
        serving seam: a 1000-height certificate range is one call here,
        one batched dispatch below.
        """
        import numpy as np

        from ..verify.aggregate import multi_aggregate_check

        out = np.zeros(len(certs), dtype=bool)
        lanes = []
        idx = []
        for i, cert in enumerate(certs):
            lane = self._lane_of(cert)
            if lane is None:
                continue
            lanes.append(lane)
            idx.append(i)
        if not lanes:
            return out
        if self._multipair is not None:
            mask = self._multipair.check(lanes)
        else:
            mask = multi_aggregate_check(
                lanes, route="device" if self._device else "host", torch_device=self._torch_device
            )
        out[np.asarray(idx)] = np.asarray(mask, dtype=bool)
        return out
