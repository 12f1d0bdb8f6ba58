"""A complete, real-cryptography embedder backend.

A copy of ``go_ibft_tpu.crypto.backend``, the next-set commitment option
(``commit_next_set``, through :mod:`go_ibft_tpu_torch.lightsync.commitment`)
included.  Constructing a backend registers the native C++ fast paths once
(:func:`_try_native_fast_paths`).

The reference leaves all of this to the embedder (go-ibft
core/backend.go:12-85); this module is the standalone framework's built-in
embedder half: secp256k1 keys, keccak-256 hashing, signed message
construction, and verification predicates that agree bit-for-bit with the
batched device path (:mod:`go_ibft_tpu_torch.verify`).

Conventions (shared with ``verify.batch``):

* envelope signature: 65-byte ``r || s || v`` over
  ``keccak256(payload_no_sig)`` (the reference's canonical signing bytes,
  messages/proto/helper.go:13-27);
* proposal hash: ``keccak256(Proposal.encode())`` — covers both the raw
  proposal and the round, so a round-hijacked proposal re-hash fails;
* committed seal: 65-byte signature over the proposal hash itself;
* proposer selection: round-robin over the sorted validator addresses,
  index ``(height + round) % n`` (the scheme the reference's test clusters
  use, core/helpers_test.go:103-108).
"""

from __future__ import annotations

from typing import Callable, Mapping, Optional, Sequence

from ..messages.helpers import CommittedSeal
from ..messages.wire import (
    CommitMessage,
    IbftMessage,
    MessageType,
    PreparedCertificate,
    PrePrepareMessage,
    PrepareMessage,
    Proposal,
    RoundChangeCertificate,
    RoundChangeMessage,
    View,
)
from . import ecdsa as ec
from .keccak import keccak256

SIG_BYTES = 65

_native_tried = False


def _try_native_fast_paths() -> None:
    """Best-effort one-time registration of the C++ fast paths.

    Signing each outbound message costs tens of ms of pure Python (one
    nonce scalar-mult); the native path is bit-identical
    (``tests/test_torch_native.py``) and degrades gracefully when no
    compiler exists."""
    global _native_tried
    if _native_tried:
        return
    _native_tried = True
    try:
        from .. import native

        native.install()
    except Exception:  # noqa: BLE001 - missing toolchain keeps pure Python
        pass

def encode_signature(r: int, s: int, v: int) -> bytes:
    return r.to_bytes(32, "big") + s.to_bytes(32, "big") + bytes([v])


def proposal_hash_of(proposal: Proposal) -> bytes:
    """Canonical proposal hash: keccak over the (raw, round) encoding."""
    return keccak256(proposal.encode())


class ECDSABackend:
    """Backend with real keys; optionally paired with a BatchVerifier.

    ``validators_for_height`` returns the voting-power map per height
    (static single-map clusters can use ``static_validators``).  The
    per-message predicates (``is_valid_validator``,
    ``is_valid_committed_seal``) are the sequential reference path; wiring a
    :class:`go_ibft_tpu_torch.verify.DeviceBatchVerifier` into the engine routes
    the hot phases through the device instead.
    """

    def __init__(
        self,
        key: ec.PrivateKey,
        validators_for_height: Callable[[int], Mapping[bytes, int]],
        build_proposal_fn: Optional[Callable[[View], bytes]] = None,
        *,
        commit_next_set: bool = False,
    ):
        _try_native_fast_paths()
        self.key = key
        self.address = key.address
        self._validators = validators_for_height
        self._build_proposal_fn = build_proposal_fn or (
            lambda view: b"block %d" % view.height
        )
        # When on, every built proposal carries a next-set commitment
        # suffix over validators_for_height(height + 1), and
        # is_valid_proposal requires the suffix frame to be present.  The
        # engine seam passes only raw bytes (no height), so this side
        # checks presence; the exact-root check happens where the height
        # is known — serve.proof.walk_sets(require_commitments=True).
        self.commit_next_set = commit_next_set
        self.inserted: list[tuple[Proposal, list[CommittedSeal]]] = []

    @staticmethod
    def static_validators(
        powers: Mapping[bytes, int]
    ) -> Callable[[int], Mapping[bytes, int]]:
        snapshot = dict(powers)
        return lambda _height: snapshot

    # -- signing --------------------------------------------------------

    def _sign_envelope(self, msg: IbftMessage) -> IbftMessage:
        digest = keccak256(msg.encode(include_signature=False))
        msg.signature = encode_signature(*ec.sign(self.key, digest))
        return msg

    # -- MessageConstructor (reference core/backend.go:12-34) -----------

    def build_preprepare_message(
        self,
        raw_proposal: bytes,
        certificate: Optional[RoundChangeCertificate],
        view: View,
    ) -> IbftMessage:
        proposal = Proposal(raw_proposal=raw_proposal, round=view.round)
        return self._sign_envelope(
            IbftMessage(
                view=view.copy(),
                sender=self.address,
                type=MessageType.PREPREPARE,
                preprepare_data=PrePrepareMessage(
                    proposal=proposal,
                    proposal_hash=proposal_hash_of(proposal),
                    certificate=certificate,
                ),
            )
        )

    def build_prepare_message(self, proposal_hash: bytes, view: View) -> IbftMessage:
        return self._sign_envelope(
            IbftMessage(
                view=view.copy(),
                sender=self.address,
                type=MessageType.PREPARE,
                prepare_data=PrepareMessage(proposal_hash=proposal_hash),
            )
        )

    def build_commit_message(self, proposal_hash: bytes, view: View) -> IbftMessage:
        seal = encode_signature(*ec.sign(self.key, proposal_hash))
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

    def build_round_change_message(
        self,
        proposal: Optional[Proposal],
        certificate: Optional[PreparedCertificate],
        view: View,
    ) -> IbftMessage:
        return self._sign_envelope(
            IbftMessage(
                view=view.copy(),
                sender=self.address,
                type=MessageType.ROUND_CHANGE,
                round_change_data=RoundChangeMessage(
                    last_prepared_proposal=proposal,
                    latest_prepared_certificate=certificate,
                ),
            )
        )

    # -- Verifier (reference core/backend.go:37-56) ---------------------

    def is_valid_proposal(self, raw_proposal: bytes) -> bool:
        if not raw_proposal:
            return False
        if self.commit_next_set:
            from ..lightsync.commitment import extract_next_set

            return extract_next_set(raw_proposal) is not None
        return True

    def is_valid_validator(self, msg: IbftMessage) -> bool:
        if msg.view is None or len(msg.signature) != SIG_BYTES:
            return False
        r = int.from_bytes(msg.signature[:32], "big")
        s = int.from_bytes(msg.signature[32:64], "big")
        v = msg.signature[64]
        digest = keccak256(msg.encode(include_signature=False))
        pub = ec.recover(digest, r, s, v)
        if pub is None:
            return False
        return (
            ec.pubkey_to_address(*pub) == msg.sender
            and msg.sender in self._validators(msg.view.height)
        )

    def is_proposer(self, validator_id: bytes, height: int, round_: int) -> bool:
        ordered = sorted(self._validators(height))
        if not ordered:
            return False
        return ordered[(height + round_) % len(ordered)] == validator_id

    def is_valid_proposal_hash(self, proposal: Proposal, hash_: bytes) -> bool:
        return proposal_hash_of(proposal) == hash_

    def is_valid_committed_seal(
        self,
        proposal_hash: bytes,
        committed_seal: CommittedSeal,
        height: Optional[int] = None,
    ) -> bool:
        if len(committed_seal.signature) != SIG_BYTES or len(proposal_hash) != 32:
            return False
        sig = committed_seal.signature
        pub = ec.recover(
            proposal_hash,
            int.from_bytes(sig[:32], "big"),
            int.from_bytes(sig[32:64], "big"),
            sig[64],
        )
        if pub is None:
            return False
        if ec.pubkey_to_address(*pub) != committed_seal.signer:
            return False
        # Membership: same rule as HostBatchVerifier/DeviceBatchVerifier —
        # the signer must belong to the validator set of the height being
        # finalized (the engine always supplies it).
        if height is not None:
            return committed_seal.signer in self._validators(height)
        return True

    # -- ValidatorBackend / Notifier / misc -----------------------------

    def get_voting_powers(self, height: int) -> Mapping[bytes, int]:
        return self._validators(height)

    def round_starts(self, view: View) -> None:  # pragma: no cover - hook
        pass

    def sequence_cancelled(self, view: View) -> None:  # pragma: no cover - hook
        pass

    def build_proposal(self, view: View) -> bytes:
        raw = self._build_proposal_fn(view)
        if self.commit_next_set:
            from ..lightsync.commitment import embed_next_set, set_root

            raw = embed_next_set(raw, set_root(self._validators(view.height + 1)))
        return raw

    def insert_proposal(
        self, proposal: Proposal, committed_seals: Sequence[CommittedSeal]
    ) -> None:
        self.inserted.append((proposal, list(committed_seals)))

    def id(self) -> bytes:
        return self.address
