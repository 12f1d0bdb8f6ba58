"""Epoch checkpoint certificates with power-of-2 skip links (the port of the
JAX package's ``lightsync/checkpoint.py``).

A light client checkpointed a million heights back should not walk a
million set diffs to resync ("Practical Light Clients for
Committee-Based Blockchains", PAPERS.md 2410.03347).  Instead, at every
epoch boundary ``E`` (``height = E * spacing``) the node builds a
:class:`CheckpointRecord` — a quorum-signed commitment to ("validator
set at the boundary", "chain commitment at the boundary") — and chains
it into a deterministic skip structure: record ``E`` carries the digest
of every record at ``E - 2**j``, so a path from genesis to any epoch is
O(log n) records (:func:`skip_path`) and each hop is bound to its
predecessor by content digest BEFORE any cryptography runs.

The certificate shape is the aggregate-quorum-certificate posture
applied to epochs: ONE aggregated BLS G2 seal + an LSB-first signer
bitmap over the SORTED validator set, signed over the record's
:meth:`~CheckpointRecord.digest` under a dedicated domain (a checkpoint
seal can never be confused with a COMMIT seal or a PoP — different
domain, different preimage length).  Verification is the batched
plane: the client resolves every record's signing set with cheap exact-
int checks (bitmap membership, quorum power, r-torsion decode — forged
or short-power certificates die here, costing zero pairings), then
verifies ALL hops of the skip chain in ONE
:func:`~go_ibft_tpu_torch.verify.aggregate.multi_aggregate_check` dispatch.

Producer side, :class:`Checkpointer` hooks ``ChainRunner._on_finalize``
(``ChainRunner(checkpointer=...)``), persists records through the WAL
(``kind: "checkpoint"``), and serves the skip path as a wire payload for
``GET /checkpoints`` (``node/proof_api.py``).  Client side,
:class:`CheckpointVerifier` (and the HTTP-speaking
:class:`~go_ibft_tpu_torch.lightsync.client.CheckpointClient`) walks the path
from a trusted genesis set, bridging across rotations with
commitment-enforced finality proofs.
"""

from __future__ import annotations

import struct
import threading
from dataclasses import dataclass, replace
from typing import Callable, Dict, List, Mapping, Optional, Sequence, Tuple

from ..core.validator_manager import calculate_quorum
from ..crypto import bls as hbls
from ..crypto.keccak import keccak256
from ..crypto.quorum_cert import AggregateQuorumCertificate
from ..utils.device import DeviceLike, resolve_device
from ..verify.bls import BLS_SEAL_BYTES, decode_seal, encode_seal
from .commitment import SET_ROOT_BYTES, set_root

__all__ = [
    "CHECKPOINT_WIRE_VERSION",
    "CheckpointAnchor",
    "CheckpointError",
    "CheckpointRecord",
    "CheckpointVerifier",
    "Checkpointer",
    "skip_epochs",
    "skip_path",
]

CHECKPOINT_WIRE_VERSION = 1

_DOMAIN = b"go-ibft-checkpoint-v1:"
# version, epoch, height, link count, bitmap length, seal length
_HEADER = struct.Struct(">BQQBHH")
_DIGEST_HEADER = struct.Struct(">BQQ")


class CheckpointError(Exception):
    """A checkpoint chain failed verification (names the epoch)."""


def skip_epochs(epoch: int) -> List[int]:
    """Ascending exponents ``j`` with ``epoch - 2**j >= 1`` — the skip
    links record ``epoch`` carries (one digest per exponent)."""
    return [j for j in range(max(epoch, 1).bit_length()) if epoch - (1 << j) >= 1]


def skip_path(epoch: int) -> List[int]:
    """The ascending epoch path genesis -> ``epoch`` using the largest
    valid skip at every step: O(log epoch) hops, each a real link."""
    if epoch < 1:
        raise ValueError("epochs start at 1")
    path = [epoch]
    e = epoch
    while e > 1:
        e -= 1 << skip_epochs(e)[-1]
        path.append(e)
    path.reverse()
    return path


@dataclass(frozen=True)
class CheckpointRecord:
    """One epoch boundary's quorum-sealed commitment.

    ``set_root`` commits the validator set IN FORCE at ``height`` (the
    set whose quorum signs this record); ``chain_commitment`` is the
    finalized proposal hash at ``height`` (binding the record to one
    chain); ``skip_digests`` are the digests of the records at
    ``epoch - 2**j`` for every ``j`` in :func:`skip_epochs`, ascending.

    :meth:`digest` covers the BODY only (never the seal/bitmap), so an
    unsigned record's digest — and every later record's skip link to it
    — is stable whether signing happens eagerly or lazily.
    """

    epoch: int
    height: int
    set_root: bytes
    chain_commitment: bytes
    skip_digests: Tuple[bytes, ...] = ()
    agg_seal: bytes = b""
    bitmap: bytes = b""

    def __post_init__(self) -> None:
        if len(self.set_root) != SET_ROOT_BYTES:
            raise ValueError("set_root must be 32 bytes")
        if len(self.chain_commitment) != 32:
            raise ValueError("chain_commitment must be 32 bytes")
        if any(len(d) != 32 for d in self.skip_digests):
            raise ValueError("skip digests must be 32 bytes")

    def _body(self) -> bytes:
        return (
            _DIGEST_HEADER.pack(CHECKPOINT_WIRE_VERSION, self.epoch, self.height)
            + self.set_root
            + self.chain_commitment
            + b"".join(self.skip_digests)
        )

    def digest(self) -> bytes:
        """Signing message AND skip-link target for later records."""
        return keccak256(_DOMAIN + self._body())

    @property
    def signed(self) -> bool:
        return bool(self.agg_seal)

    def encode(self) -> bytes:
        return (
            _HEADER.pack(
                CHECKPOINT_WIRE_VERSION,
                self.epoch,
                self.height,
                len(self.skip_digests),
                len(self.bitmap),
                len(self.agg_seal),
            )
            + self.set_root
            + self.chain_commitment
            + b"".join(self.skip_digests)
            + self.bitmap
            + self.agg_seal
        )

    @classmethod
    def decode(cls, blob: bytes) -> "CheckpointRecord":
        if len(blob) < _HEADER.size:
            raise ValueError("checkpoint record too short")
        version, epoch, height, n_links, bm_len, seal_len = _HEADER.unpack_from(
            blob
        )
        if version != CHECKPOINT_WIRE_VERSION:
            raise ValueError(f"unknown checkpoint record version {version}")
        if seal_len not in (0, BLS_SEAL_BYTES):
            raise ValueError("checkpoint seal length invalid")
        body = blob[_HEADER.size :]
        need = 64 + 32 * n_links + bm_len + seal_len
        if len(body) != need:
            raise ValueError("checkpoint record length mismatch")
        links = tuple(
            body[64 + 32 * i : 96 + 32 * i] for i in range(n_links)
        )
        off = 64 + 32 * n_links
        return cls(
            epoch=epoch,
            height=height,
            set_root=body[:32],
            chain_commitment=body[32:64],
            skip_digests=links,
            bitmap=body[off : off + bm_len],
            agg_seal=body[off + bm_len :],
        )


@dataclass
class CheckpointAnchor:
    """What a verified checkpoint chain buys the client: a trust anchor
    ``(height, powers)`` to hand a ``ProofVerifier`` for the tail."""

    height: int
    epoch: int
    powers: Dict[bytes, int]
    spacing: int
    lanes: int = 0


def _bitmap_signers(
    bitmap: bytes, ordered: Sequence[bytes], epoch: int
) -> List[bytes]:
    """LSB-first bitmap -> signer addresses over the SORTED set (the
    quorum-cert convention); any bit outside the set is a hard error."""
    if len(bitmap) != (len(ordered) + 7) // 8:
        raise CheckpointError(
            f"epoch {epoch}: bitmap length {len(bitmap)} does not match "
            f"a {len(ordered)}-validator set"
        )
    out: List[bytes] = []
    for i in range(len(bitmap) * 8):
        if bitmap[i // 8] >> (i % 8) & 1:
            if i >= len(ordered):
                raise CheckpointError(
                    f"epoch {epoch}: bitmap bit {i} outside the "
                    f"{len(ordered)}-validator set"
                )
            out.append(ordered[i])
    return out


class Checkpointer:
    """Builds, persists, and serves the epoch checkpoint chain.

    ``signers`` maps validator address -> :class:`BLSPrivateKey` for
    every key this process can sign with (a simulation holds the whole
    committee; a production deployment would aggregate partials through
    ``net/aggtree.py`` exactly like COMMIT seals — the record digest is
    just another message).  ``lazy_sign=True`` defers the quorum signing
    to serve time (:meth:`ensure_signed`): record BODIES are cheap
    keccak chains, so a million-height chain only ever pays pure-Python
    G2 signing for the O(log n) records a skip path actually serves.

    Thread-safe: ``on_finalize`` runs on the runner's loop thread while
    ``wire_payload`` serves from the proof-API worker pool.
    """

    def __init__(
        self,
        spacing: int,
        validators_for_height: Callable[[int], Mapping[bytes, int]],
        *,
        signers: Optional[Mapping[bytes, "hbls.BLSPrivateKey"]] = None,
        lazy_sign: bool = False,
    ) -> None:
        if spacing < 1:
            raise ValueError("checkpoint spacing must be >= 1")
        self.spacing = spacing
        self._validators = validators_for_height
        self._signers = dict(signers or {})
        self._lazy = lazy_sign
        self._records: Dict[int, CheckpointRecord] = {}
        self._lock = threading.Lock()

    @property
    def latest_epoch(self) -> int:
        with self._lock:
            return max(self._records, default=0)

    def record(self, epoch: int) -> Optional[CheckpointRecord]:
        with self._lock:
            return self._records.get(epoch)

    # -- build -----------------------------------------------------------

    def on_finalize(
        self, height: int, proposal_hash: bytes
    ) -> Optional[CheckpointRecord]:
        """Runner hook: build (and, unless lazy, quorum-sign) the record
        when ``height`` is an epoch boundary; None otherwise.  Idempotent
        per epoch (recovery replay may re-deliver a boundary)."""
        if height <= 0 or height % self.spacing:
            return None
        epoch = height // self.spacing
        with self._lock:
            if epoch in self._records:
                return None
            links = []
            for j in skip_epochs(epoch):
                prev = self._records.get(epoch - (1 << j))
                if prev is None:
                    raise CheckpointError(
                        f"epoch {epoch}: missing prior record at "
                        f"{epoch - (1 << j)} for skip link 2**{j}"
                    )
                links.append(prev.digest())
            rec = CheckpointRecord(
                epoch=epoch,
                height=height,
                set_root=set_root(self._validators(height)),
                chain_commitment=bytes(proposal_hash),
                skip_digests=tuple(links),
            )
            if self._signers and not self._lazy:
                rec = self._sign(rec)
            self._records[epoch] = rec
            return rec

    def _sign(self, rec: CheckpointRecord) -> CheckpointRecord:
        powers = self._validators(rec.height)
        ordered = sorted(powers)
        quorum = calculate_quorum(sum(powers.values()))
        msg = rec.digest()
        indices: List[int] = []
        points: List["hbls.PointG2"] = []
        got = 0
        for i, addr in enumerate(ordered):
            key = self._signers.get(addr)
            if key is None:
                continue
            points.append(key.sign(msg))
            indices.append(i)
            got += powers[addr]
            if got >= quorum:
                break
        if got < quorum:
            raise CheckpointError(
                f"epoch {rec.epoch}: held signing keys reach {got} of "
                f"quorum {quorum} voting power"
            )
        agg = hbls.aggregate_signatures(points)
        return replace(
            rec,
            agg_seal=encode_seal(agg),
            bitmap=AggregateQuorumCertificate.bitmap_of(indices, len(ordered)),
        )

    def ensure_signed(self, epoch: int) -> CheckpointRecord:
        """The record at ``epoch``, quorum-signed (signing now if it was
        deferred).  Skip-link digests are body-only, so late signing
        never invalidates records already chained on top."""
        with self._lock:
            rec = self._records.get(epoch)
            if rec is None:
                raise CheckpointError(f"no checkpoint record for epoch {epoch}")
            if rec.signed:
                return rec
            rec = self._sign(rec)
            self._records[epoch] = rec
            return rec

    # -- persistence -----------------------------------------------------

    def restore(self, records: Sequence[CheckpointRecord]) -> None:
        """WAL-replay entry: adopt durable records (first write wins,
        matching the WAL's duplicate-finalize posture)."""
        with self._lock:
            for rec in records:
                self._records.setdefault(rec.epoch, rec)

    # -- serving ---------------------------------------------------------

    def wire_payload(
        self,
        *,
        target_epoch: Optional[int] = None,
        include_all: bool = False,
    ) -> Dict[str, object]:
        """The ``GET /checkpoints`` response body: the skip path from
        genesis to ``target_epoch`` (default: latest), every record
        signed.  ``include_all`` serves the full epoch list instead (the
        linear shape — consecutive epochs are gap ``2**0`` hops, so the
        same verifier consumes it; useful as a measured baseline)."""
        latest = self.latest_epoch
        if latest == 0:
            return {
                "version": CHECKPOINT_WIRE_VERSION,
                "spacing": self.spacing,
                "latest_epoch": 0,
                "checkpoints": [],
            }
        epoch = latest if target_epoch is None else int(target_epoch)
        if not 1 <= epoch <= latest:
            raise CheckpointError(
                f"target epoch {epoch} outside [1, {latest}]"
            )
        epochs = list(range(1, epoch + 1)) if include_all else skip_path(epoch)
        return {
            "version": CHECKPOINT_WIRE_VERSION,
            "spacing": self.spacing,
            "latest_epoch": latest,
            "checkpoints": [self.ensure_signed(e).encode().hex() for e in epochs],
        }


class CheckpointVerifier:
    """Client-side skip-chain verification: everything cheap first, then
    ONE batched pairing dispatch over every hop.

    The client trusts a genesis anchor — the validator powers in force
    from height 1.  Walking the served path, each record must (1) chain:
    carry the previous path record's digest in the skip slot matching
    the hop gap (power-of-2 gaps only; genesis record carries no links);
    (2) resolve its signing set: ``set_root`` equal to the current
    trusted set's root — or, on a rotation, a ``bridge`` callback
    produces the new set via a commitment-enforced finality proof and
    the root must match it; (3) pass the exact-int certificate gates
    (bitmap over the SORTED resolved set, quorum voting power, r-torsion
    seal decode, a registered PoP-gated BLS key per signer).  Lanes from
    every hop — bridged or not — then verify in one
    ``multi_aggregate_check``; any failing lane rejects the whole sync.

    A skip link that bypasses a real rotation cannot pass: an honest
    quorum never signed a record with a stale ``set_root``, and a forged
    record fails its pairing lane.

    ``device`` (default on) runs the batched check through the
    multi-pairing kernels on ``torch_device`` (``None``: the card), whose
    fault propagates; ``device=False`` asks for the host batch, the JAX
    package's default.
    """

    def __init__(
        self,
        bls_keys_for_height: Callable[[int], Mapping[bytes, "hbls.PointG1"]],
        *,
        device: bool = True,
        multipair=None,
        torch_device: DeviceLike = None,
    ) -> None:
        self._keys = bls_keys_for_height
        self._device = device
        self._torch_device = resolve_device(torch_device) if device else None
        self._multipair = multipair

    @property
    def device(self):
        """What :func:`~go_ibft_tpu_torch.verify.batch.on_card` reads: the
        injected multi-pairing verifier, else the device route's device
        (None on the host route)."""
        return self._multipair if self._multipair is not None else self._torch_device

    def build_lanes(
        self,
        payload: Mapping[str, object],
        trusted_powers: Mapping[bytes, int],
        *,
        bridge: Optional[
            Callable[[int, int, Dict[bytes, int]], Mapping[bytes, int]]
        ] = None,
    ):
        """All pre-pairing work: structural path checks, set resolution,
        certificate gates.  Returns ``(lanes, records, anchor)`` with one
        pairing lane per record; exposed so the dispatch-parity tests can
        compare the batched verdicts against the sequential per-record
        oracle on the exact same lanes."""
        if payload.get("version") != CHECKPOINT_WIRE_VERSION:
            raise CheckpointError(
                f"unknown checkpoint payload version {payload.get('version')!r}"
            )
        spacing = payload.get("spacing")
        if not isinstance(spacing, int) or spacing < 1:
            raise CheckpointError(f"invalid checkpoint spacing {spacing!r}")
        raw = payload.get("checkpoints")
        if not isinstance(raw, list) or not raw:
            raise CheckpointError("checkpoint payload carries no records")
        try:
            records = [CheckpointRecord.decode(bytes.fromhex(r)) for r in raw]
        except (TypeError, ValueError) as err:
            raise CheckpointError(f"undecodable checkpoint record: {err}")
        if records[0].epoch != 1:
            raise CheckpointError(
                f"checkpoint chain starts at epoch {records[0].epoch}, "
                "expected the genesis epoch 1"
            )
        cur_powers: Dict[bytes, int] = dict(trusted_powers)
        if not cur_powers:
            raise CheckpointError("trusted genesis powers are empty")
        cur_root = set_root(cur_powers)
        lanes = []
        prev: Optional[CheckpointRecord] = None
        prev_height = 0
        for rec in records:
            e = rec.epoch
            if rec.height != e * spacing:
                raise CheckpointError(
                    f"epoch {e}: height {rec.height} != epoch * spacing "
                    f"{e * spacing}"
                )
            if len(rec.skip_digests) != len(skip_epochs(e)):
                raise CheckpointError(
                    f"epoch {e}: {len(rec.skip_digests)} skip links, "
                    f"expected {len(skip_epochs(e))}"
                )
            if prev is not None:
                gap = e - prev.epoch
                if gap <= 0 or gap & (gap - 1):
                    raise CheckpointError(
                        f"epoch {e}: gap {gap} from {prev.epoch} is not a "
                        "power-of-2 skip"
                    )
                slot = skip_epochs(e).index(gap.bit_length() - 1)
                if rec.skip_digests[slot] != prev.digest():
                    raise CheckpointError(
                        f"epoch {e}: skip link does not bind the verified "
                        f"record at epoch {prev.epoch}"
                    )
            if rec.set_root != cur_root:
                if bridge is None:
                    raise CheckpointError(
                        f"epoch {e}: validator set rotated since height "
                        f"{prev_height} and no bridge source is available"
                    )
                new_powers = dict(bridge(prev_height, rec.height, dict(cur_powers)))
                if set_root(new_powers) != rec.set_root:
                    raise CheckpointError(
                        f"epoch {e}: bridged validator set does not match "
                        "the record's committed set root"
                    )
                cur_powers, cur_root = new_powers, rec.set_root
            if not rec.signed:
                raise CheckpointError(f"epoch {e}: record carries no seal")
            ordered = sorted(cur_powers)
            signers = _bitmap_signers(rec.bitmap, ordered, e)
            got = sum(cur_powers[a] for a in signers)
            quorum = calculate_quorum(sum(cur_powers.values()))
            if got < quorum:
                raise CheckpointError(
                    f"epoch {e}: signer power {got} below quorum {quorum}"
                )
            keys = self._keys(rec.height)
            pubkeys = []
            for addr in signers:
                pk = keys.get(addr)
                if pk is None:
                    raise CheckpointError(
                        f"epoch {e}: signer {addr.hex()[:16]} has no "
                        "registered BLS key (PoP-gated registry required)"
                    )
                pubkeys.append(pk)
            point = decode_seal(rec.agg_seal)
            if point is None:
                raise CheckpointError(
                    f"epoch {e}: aggregate seal does not decode to an "
                    "r-torsion G2 point"
                )
            lanes.append((rec.digest(), [point], pubkeys))
            prev, prev_height = rec, rec.height
        anchor = CheckpointAnchor(
            height=prev_height,
            epoch=prev.epoch,
            powers=dict(cur_powers),
            spacing=spacing,
            lanes=len(lanes),
        )
        return lanes, records, anchor

    def verify_chain(
        self,
        payload: Mapping[str, object],
        trusted_powers: Mapping[bytes, int],
        *,
        bridge: Optional[
            Callable[[int, int, Dict[bytes, int]], Mapping[bytes, int]]
        ] = None,
    ) -> CheckpointAnchor:
        """Verify a served checkpoint payload end to end; returns the
        anchor (height, powers at that height) on success, raises
        :class:`CheckpointError` naming the first failing epoch."""
        lanes, records, anchor = self.build_lanes(
            payload, trusted_powers, bridge=bridge
        )
        if self._multipair is not None:
            mask = self._multipair.check(lanes)
        else:
            from ..verify.aggregate import multi_aggregate_check

            mask = multi_aggregate_check(
                lanes,
                route="device" if self._device else "host",
                torch_device=self._torch_device,
            )
        for rec, ok in zip(records, mask):
            if not bool(ok):
                raise CheckpointError(
                    f"epoch {rec.epoch}: aggregate checkpoint seal fails "
                    "the pairing check"
                )
        return anchor
