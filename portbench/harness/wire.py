"""The IBFT wire encoding the benchmark signs and sends: a frozen copy of the
encoding half of ``go_ibft_tpu_torch/messages/wire.py`` (itself go-ibft's
``messages/proto/messages.proto`` in proto3 field order).

Only what the traffic needs: a ``View``, a ``Proposal``, and the PREPREPARE,
PREPARE and COMMIT envelopes, with and without their signature (the signed
bytes are the envelope with the signature left out, go-ibft's
``PayloadNoSig``).  The program decodes these bytes with its own codec, as
its gRPC transport does with a peer's.
"""

from __future__ import annotations

PREPREPARE, PREPARE, COMMIT = 0, 1, 2


def _varint(value: int) -> bytes:
    out = bytearray()
    while True:
        b = value & 0x7F
        value >>= 7
        if value:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _uint(field: int, value: int) -> bytes:
    return _varint(field << 3) + _varint(value) if value else b""


def _bytes(field: int, value: bytes) -> bytes:
    return _varint((field << 3) | 2) + _varint(len(value)) + value if value else b""


def _msg(field: int, encoded: bytes) -> bytes:
    return _varint((field << 3) | 2) + _varint(len(encoded)) + encoded


def view(height: int, round_: int) -> bytes:
    return _uint(1, height) + _uint(2, round_)


def proposal(raw: bytes, round_: int) -> bytes:
    """``Proposal{raw_proposal, round}``: its keccak-256 is the proposal hash
    that PREPAREs, COMMITs and committed seals carry."""
    return _bytes(1, raw) + _uint(2, round_)


def envelope(height: int, round_: int, sender: bytes, kind: int, payload: bytes,
             signature: bytes = b"") -> bytes:
    """An ``IbftMessage``: view, sender, signature (left out when empty, as in
    the signed bytes), type, and the payload in its oneof field."""
    return (_msg(1, view(height, round_)) + _bytes(2, sender) + _bytes(3, signature)
            + _uint(4, kind) + _msg(5 + kind, payload))


def preprepare_payload(raw: bytes, round_: int, proposal_hash: bytes) -> bytes:
    return _msg(1, proposal(raw, round_)) + _bytes(2, proposal_hash)


def prepare_payload(proposal_hash: bytes) -> bytes:
    return _bytes(1, proposal_hash)


def commit_payload(proposal_hash: bytes, seal: bytes) -> bytes:
    return _bytes(1, proposal_hash) + _bytes(2, seal)
