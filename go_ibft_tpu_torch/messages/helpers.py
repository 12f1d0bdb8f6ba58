"""Stateless extractors and certificate validators.

Mirrors the behavior of the reference's messages/helpers.go:16-227: payload
extraction out of the oneof envelope and the PreparedCertificate message-set
validity rules.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterable, Optional, Sequence

from .wire import (
    IbftMessage,
    MessageType,
    PreparedCertificate,
    Proposal,
    RoundChangeCertificate,
)


class WrongCommitMessageTypeError(ValueError):
    """A non-COMMIT message was included in COMMIT messages.

    Mirrors ErrWrongCommitMessageType (reference messages/helpers.go:12).
    """


@dataclass
class CommittedSeal:
    """Validator proof of signing a committed proposal.

    Mirrors messages.CommittedSeal (reference messages/helpers.go:16-19).
    """

    signer: bytes
    signature: bytes


def extract_committed_seals(
    commit_messages: Sequence[IbftMessage],
) -> list[CommittedSeal]:
    """Extract committed seals (reference messages/helpers.go:22-35).

    Raises WrongCommitMessageTypeError if a non-COMMIT message sneaks in.
    """
    seals = []
    for msg in commit_messages:
        if msg.type != MessageType.COMMIT:
            raise WrongCommitMessageTypeError(
                "wrong type message is included in COMMIT messages"
            )
        seal = extract_committed_seal(msg)
        if seal is not None:
            seals.append(seal)
    return seals


def extract_committed_seal(commit_message: IbftMessage) -> Optional[CommittedSeal]:
    """Extract one committed seal (reference messages/helpers.go:38-48)."""
    if commit_message.commit_data is None:
        return None
    return CommittedSeal(
        signer=commit_message.sender,
        signature=commit_message.commit_data.committed_seal,
    )


def extract_commit_hash(commit_message: IbftMessage) -> Optional[bytes]:
    """Extract COMMIT proposal hash (reference messages/helpers.go:51-62)."""
    if commit_message.type != MessageType.COMMIT:
        return None
    if commit_message.commit_data is None:
        return None
    return commit_message.commit_data.proposal_hash


def extract_proposal(proposal_message: IbftMessage) -> Optional[Proposal]:
    """Extract the (raw, round) proposal (reference messages/helpers.go:65-76)."""
    if proposal_message.type != MessageType.PREPREPARE:
        return None
    if proposal_message.preprepare_data is None:
        return None
    return proposal_message.preprepare_data.proposal


def extract_proposal_hash(proposal_message: IbftMessage) -> Optional[bytes]:
    """Extract PREPREPARE proposal hash (reference messages/helpers.go:79-90)."""
    if proposal_message.type != MessageType.PREPREPARE:
        return None
    if proposal_message.preprepare_data is None:
        return None
    return proposal_message.preprepare_data.proposal_hash


def extract_round_change_certificate(
    proposal_message: IbftMessage,
) -> Optional[RoundChangeCertificate]:
    """Extract the RCC from a PREPREPARE (reference messages/helpers.go:93-104)."""
    if proposal_message.type != MessageType.PREPREPARE:
        return None
    if proposal_message.preprepare_data is None:
        return None
    return proposal_message.preprepare_data.certificate


def extract_prepare_hash(prepare_message: IbftMessage) -> Optional[bytes]:
    """Extract PREPARE proposal hash (reference messages/helpers.go:107-118)."""
    if prepare_message.type != MessageType.PREPARE:
        return None
    if prepare_message.prepare_data is None:
        return None
    return prepare_message.prepare_data.proposal_hash


def extract_latest_pc(
    round_change_message: IbftMessage,
) -> Optional[PreparedCertificate]:
    """Extract the latest PC (reference messages/helpers.go:121-132)."""
    if round_change_message.type != MessageType.ROUND_CHANGE:
        return None
    if round_change_message.round_change_data is None:
        return None
    return round_change_message.round_change_data.latest_prepared_certificate


def extract_last_prepared_proposal(
    round_change_message: IbftMessage,
) -> Optional[Proposal]:
    """Extract the last prepared proposal (reference messages/helpers.go:135-146)."""
    if round_change_message.type != MessageType.ROUND_CHANGE:
        return None
    if round_change_message.round_change_data is None:
        return None
    return round_change_message.round_change_data.last_prepared_proposal


def has_unique_senders(messages: Iterable[IbftMessage]) -> bool:
    """True iff non-empty and all senders distinct (reference messages/helpers.go:149-166)."""
    seen: set[bytes] = set()
    count = 0
    for msg in messages:
        count += 1
        if msg.sender in seen:
            return False
        seen.add(msg.sender)
    return count > 0


def are_valid_pc_messages(
    messages: Sequence[IbftMessage], height: int, round_limit: int
) -> bool:
    """Validate a PreparedCertificate's message set.

    Mirrors AreValidPCMessages (reference messages/helpers.go:169-213): the set
    must be non-empty; all messages share one height (== ``height``) and one
    round (< ``round_limit``); all carry the same proposal hash (extracted per
    message type — COMMIT/ROUND_CHANGE messages are invalid here); and all
    senders are unique.
    """
    if len(messages) < 1:
        return False

    if messages[0].view is None:
        return False
    round_ = messages[0].view.round
    senders: set[bytes] = set()
    hash_: Optional[bytes] = None

    for msg in messages:
        if msg.view is None or msg.view.height != height:
            return False
        if msg.view.round != round_ or msg.view.round >= round_limit:
            return False

        extracted, ok = _extract_pc_message_hash(msg)
        if hash_ is None:
            # No previous hash for comparison: the first one becomes the
            # reference (stays None while extracted hashes are missing,
            # matching Go's nil-slice semantics where nil == empty).
            hash_ = extracted
        if not ok or (hash_ or b"") != (extracted or b""):
            return False

        if msg.sender in senders:
            return False
        senders.add(msg.sender)

    return True


def _extract_pc_message_hash(message: IbftMessage) -> tuple[Optional[bytes], bool]:
    """Extract the hash a PC member commits to (reference messages/helpers.go:216-227).

    Returns ``(hash, ok)``: ``ok`` is False for message types that cannot be
    part of a PC (COMMIT / ROUND_CHANGE); a PREPREPARE/PREPARE with a missing
    payload yields ``(None, True)``, matching the Go nil-slice semantics.
    """
    if message.type == MessageType.PREPREPARE:
        return extract_proposal_hash(message), True
    if message.type == MessageType.PREPARE:
        return extract_prepare_hash(message), True
    return None, False
