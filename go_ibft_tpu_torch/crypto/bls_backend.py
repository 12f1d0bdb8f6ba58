"""Hybrid backend: ECDSA envelopes + BLS12-381 aggregatable committed seals
(the port of ``go_ibft_tpu/crypto/bls_backend.py``).

The reference's Backend seam leaves seal semantics to the embedder
(core/backend.go:39-41 BuildCommitMessage "must create a committed seal",
:50-55 IsValidCommittedSeal).  This embedder half keeps ECDSA for envelope
sender identity (cheap recovery, address-sized identities) and signs the
COMMIT seal with BLS — so a finalized block ships a quorum certificate
that verifies with ONE pairing equation regardless of validator count
(BASELINE.md config #4).
"""

from __future__ import annotations

from typing import Callable, Mapping, Optional

from ..messages.helpers import CommittedSeal
from ..verify.bls import BLS_SEAL_BYTES, decode_seal, encode_seal
from . import bls as hbls
from . import ecdsa as ec
from .backend import ECDSABackend


class HybridBLSBackend(ECDSABackend):
    """ECDSABackend whose committed seals are BLS G2 signatures.

    ``bls_keys_for_height`` maps height -> {consensus address: G1 pubkey}
    (the BLS analogue of the voting-power map).
    """

    def __init__(
        self,
        key: ec.PrivateKey,
        bls_key: hbls.BLSPrivateKey,
        validators_for_height: Callable[[int], Mapping[bytes, int]],
        bls_keys_for_height: Callable[[int], Mapping[bytes, "hbls.PointG1"]],
        build_proposal_fn=None,
    ):
        super().__init__(key, validators_for_height, build_proposal_fn)
        self.bls_key = bls_key
        self._bls_keys = bls_keys_for_height

    def build_commit_message(self, proposal_hash: bytes, view):
        from ..messages.wire import CommitMessage, IbftMessage, MessageType

        seal = encode_seal(self.bls_key.sign(proposal_hash))
        return self._sign_envelope(
            IbftMessage(
                view=view.copy(),
                sender=self.address,
                type=MessageType.COMMIT,
                commit_data=CommitMessage(
                    proposal_hash=proposal_hash, committed_seal=seal
                ),
            )
        )

    def is_valid_committed_seal(
        self,
        proposal_hash: bytes,
        committed_seal: CommittedSeal,
        height: Optional[int] = None,
    ) -> bool:
        if (
            len(committed_seal.signature) != BLS_SEAL_BYTES
            or len(proposal_hash) != 32
        ):
            return False
        point = decode_seal(committed_seal.signature)
        if point is None:
            return False
        # membership + key lookup in the BLS registry (engine supplies the
        # finalizing height; None means registry of height 0 semantics is
        # undefined, so reject)
        if height is None:
            return False
        pubkey = self._bls_keys(height).get(committed_seal.signer)
        if pubkey is None:
            return False
        return hbls.verify(pubkey, proposal_hash, point)


class HybridBatchVerifier:
    """BatchVerifier composition: device ECDSA envelopes + BLS aggregate
    seals — the engine's batched paths stay identical, only the seal
    math changes."""

    def __init__(self, sender_verifier, seal_verifier):
        self._senders = sender_verifier
        self._seals = seal_verifier

    def verify_senders(self, msgs):
        return self._senders.verify_senders(msgs)

    def verify_committed_seals(self, proposal_hash, seals, height):
        return self._seals.verify_committed_seals(proposal_hash, seals, height)
