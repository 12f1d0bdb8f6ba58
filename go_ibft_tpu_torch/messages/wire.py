"""Wire schema for IBFT messages (copied from ``go_ibft_tpu.messages.wire``).

The port keeps its own copy so that it imports nothing of the JAX package,
the trace-context framing (:class:`TraceContext`) included: the engine
stamps outbound messages with it while tracing is on.

Python dataclasses mirroring the protobuf schema of the reference
(reference messages/proto/messages.proto:1-111) plus a minimal,
dependency-free protobuf wire codec.  Encoding follows proto3 semantics with
fields emitted in field-number order, which makes ``payload_no_sig`` bytes
byte-identical to the Go reference's ``(*IbftMessage).PayloadNoSig()``
(reference messages/proto/helper.go:13-27), so an embedder can
interoperate on signatures with go-ibft nodes.

Decoding follows proto3 merge semantics so foreign bytes parse exactly as a
protobuf implementation would: duplicated scalar fields keep the last value,
duplicated singular message fields merge, repeated fields append, switching
oneof members clears the previous member, and unknown enum values / fields
are preserved / skipped (enums are open in proto3).

The codec is deliberately tiny: four message types in a oneof envelope, two
certificate containers, ``View`` and ``Proposal``.  No reflection, no
generated code.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Optional, Union

from ..obs import trace


class MessageType(enum.IntEnum):
    """Message types (reference messages/proto/messages.proto:7-12)."""

    PREPREPARE = 0
    PREPARE = 1
    COMMIT = 2
    ROUND_CHANGE = 3


def _open_enum(value: int) -> Union[MessageType, int]:
    """proto3 enums are open: unknown values are preserved, not rejected."""
    try:
        return MessageType(value)
    except ValueError:
        return value


# ---------------------------------------------------------------------------
# protobuf wire primitives
# ---------------------------------------------------------------------------

_WIRE_VARINT = 0
_WIRE_LEN = 2


def _encode_varint(value: int) -> bytes:
    if value < 0:
        raise ValueError("negative varint")
    out = bytearray()
    while True:
        b = value & 0x7F
        value >>= 7
        if value:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _decode_varint(buf: bytes, pos: int) -> tuple[int, int]:
    result = 0
    shift = 0
    while True:
        if pos >= len(buf):
            raise ValueError("truncated varint")
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            if result > 0xFFFFFFFFFFFFFFFF:
                # protobuf varints are at most uint64
                raise ValueError("varint overflows uint64")
            return result, pos
        shift += 7
        if shift > 70:
            raise ValueError("varint too long")


def _tag(field_number: int, wire_type: int) -> bytes:
    return _encode_varint((field_number << 3) | wire_type)


def _emit_uint(out: bytearray, field_number: int, value: int) -> None:
    if value:
        out += _tag(field_number, _WIRE_VARINT)
        out += _encode_varint(value)


def _emit_bytes(out: bytearray, field_number: int, value: Optional[bytes]) -> None:
    # proto3: empty bytes are omitted; None means unset.
    if value:
        out += _tag(field_number, _WIRE_LEN)
        out += _encode_varint(len(value))
        out += value


def _emit_msg(out: bytearray, field_number: int, encoded: Optional[bytes]) -> None:
    # A set-but-empty nested message is emitted as tag + zero length,
    # distinguishable from unset (None) — matching Go pointer semantics.
    if encoded is not None:
        out += _tag(field_number, _WIRE_LEN)
        out += _encode_varint(len(encoded))
        out += encoded


def _read_bytes(buf: bytes, pos: int) -> tuple[bytes, int]:
    length, pos = _decode_varint(buf, pos)
    end = pos + length
    if end > len(buf):
        raise ValueError("truncated length-delimited field")
    return buf[pos:end], end


def _skip_field(buf: bytes, pos: int, wire_type: int) -> int:
    if wire_type == _WIRE_VARINT:
        _, pos = _decode_varint(buf, pos)
        return pos
    if wire_type == _WIRE_LEN:
        _, pos = _read_bytes(buf, pos)
        return pos
    if wire_type == 5:  # 32-bit
        if pos + 4 > len(buf):
            raise ValueError("truncated fixed32 field")
        return pos + 4
    if wire_type == 1:  # 64-bit
        if pos + 8 > len(buf):
            raise ValueError("truncated fixed64 field")
        return pos + 8
    raise ValueError(f"unsupported wire type {wire_type}")


class _Decodable:
    """Mixin providing proto3-merge decoding on top of ``_merge_field``."""

    @classmethod
    def decode(cls, buf: bytes):
        msg = cls()
        msg.merge_from(buf)
        return msg

    def merge_from(self, buf: bytes) -> None:
        """Parse ``buf`` into ``self`` with proto3 merge semantics."""
        pos = 0
        while pos < len(buf):
            key, pos = _decode_varint(buf, pos)
            fnum, wtype = key >> 3, key & 7
            consumed = self._merge_field(fnum, wtype, buf, pos)
            if consumed is None:
                pos = _skip_field(buf, pos, wtype)
            else:
                pos = consumed

    def _merge_field(
        self, fnum: int, wtype: int, buf: bytes, pos: int
    ) -> Optional[int]:
        raise NotImplementedError

    def _merge_nested(self, attr: str, klass, buf: bytes, pos: int) -> int:
        """Merge a length-delimited singular message field into ``attr``."""
        raw, pos = _read_bytes(buf, pos)
        existing = getattr(self, attr)
        if existing is None:
            existing = klass()
            setattr(self, attr, existing)
        existing.merge_from(raw)
        return pos


# ---------------------------------------------------------------------------
# message dataclasses
# ---------------------------------------------------------------------------


@dataclass
class View(_Decodable):
    """(height, round) pair (reference messages/proto/messages.proto:15-21)."""

    height: int = 0
    round: int = 0

    def encode(self) -> bytes:
        out = bytearray()
        _emit_uint(out, 1, self.height)
        _emit_uint(out, 2, self.round)
        return bytes(out)

    def _merge_field(self, fnum, wtype, buf, pos):
        if fnum == 1 and wtype == _WIRE_VARINT:
            self.height, pos = _decode_varint(buf, pos)
            return pos
        if fnum == 2 and wtype == _WIRE_VARINT:
            self.round, pos = _decode_varint(buf, pos)
            return pos
        return None

    def copy(self) -> "View":
        return View(self.height, self.round)


@dataclass
class Proposal(_Decodable):
    """(raw_proposal, round) tuple (reference messages/proto/messages.proto:104-110)."""

    raw_proposal: bytes = b""
    round: int = 0

    def encode(self) -> bytes:
        out = bytearray()
        _emit_bytes(out, 1, self.raw_proposal)
        _emit_uint(out, 2, self.round)
        return bytes(out)

    def _merge_field(self, fnum, wtype, buf, pos):
        if fnum == 1 and wtype == _WIRE_LEN:
            self.raw_proposal, pos = _read_bytes(buf, pos)
            return pos
        if fnum == 2 and wtype == _WIRE_VARINT:
            self.round, pos = _decode_varint(buf, pos)
            return pos
        return None


@dataclass
class PrePrepareMessage(_Decodable):
    """PREPREPARE payload (reference messages/proto/messages.proto:47-57)."""

    proposal: Optional[Proposal] = None
    proposal_hash: bytes = b""
    certificate: Optional["RoundChangeCertificate"] = None

    def encode(self) -> bytes:
        out = bytearray()
        _emit_msg(out, 1, self.proposal.encode() if self.proposal is not None else None)
        _emit_bytes(out, 2, self.proposal_hash)
        _emit_msg(
            out, 3, self.certificate.encode() if self.certificate is not None else None
        )
        return bytes(out)

    def _merge_field(self, fnum, wtype, buf, pos):
        if fnum == 1 and wtype == _WIRE_LEN:
            return self._merge_nested("proposal", Proposal, buf, pos)
        if fnum == 2 and wtype == _WIRE_LEN:
            self.proposal_hash, pos = _read_bytes(buf, pos)
            return pos
        if fnum == 3 and wtype == _WIRE_LEN:
            return self._merge_nested("certificate", RoundChangeCertificate, buf, pos)
        return None


@dataclass
class PrepareMessage(_Decodable):
    """PREPARE payload (reference messages/proto/messages.proto:60-63)."""

    proposal_hash: bytes = b""

    def encode(self) -> bytes:
        out = bytearray()
        _emit_bytes(out, 1, self.proposal_hash)
        return bytes(out)

    def _merge_field(self, fnum, wtype, buf, pos):
        if fnum == 1 and wtype == _WIRE_LEN:
            self.proposal_hash, pos = _read_bytes(buf, pos)
            return pos
        return None


@dataclass
class CommitMessage(_Decodable):
    """COMMIT payload (reference messages/proto/messages.proto:66-72)."""

    proposal_hash: bytes = b""
    committed_seal: bytes = b""

    def encode(self) -> bytes:
        out = bytearray()
        _emit_bytes(out, 1, self.proposal_hash)
        _emit_bytes(out, 2, self.committed_seal)
        return bytes(out)

    def _merge_field(self, fnum, wtype, buf, pos):
        if fnum == 1 and wtype == _WIRE_LEN:
            self.proposal_hash, pos = _read_bytes(buf, pos)
            return pos
        if fnum == 2 and wtype == _WIRE_LEN:
            self.committed_seal, pos = _read_bytes(buf, pos)
            return pos
        return None


@dataclass
class RoundChangeMessage(_Decodable):
    """ROUND_CHANGE payload (reference messages/proto/messages.proto:75-83)."""

    last_prepared_proposal: Optional[Proposal] = None
    latest_prepared_certificate: Optional["PreparedCertificate"] = None

    def encode(self) -> bytes:
        out = bytearray()
        _emit_msg(
            out,
            1,
            self.last_prepared_proposal.encode()
            if self.last_prepared_proposal is not None
            else None,
        )
        _emit_msg(
            out,
            2,
            self.latest_prepared_certificate.encode()
            if self.latest_prepared_certificate is not None
            else None,
        )
        return bytes(out)

    def _merge_field(self, fnum, wtype, buf, pos):
        if fnum == 1 and wtype == _WIRE_LEN:
            return self._merge_nested("last_prepared_proposal", Proposal, buf, pos)
        if fnum == 2 and wtype == _WIRE_LEN:
            return self._merge_nested(
                "latest_prepared_certificate", PreparedCertificate, buf, pos
            )
        return None


@dataclass
class PreparedCertificate(_Decodable):
    """Proposal + quorum-1 PREPAREs (reference messages/proto/messages.proto:87-94)."""

    proposal_message: Optional["IbftMessage"] = None
    prepare_messages: Optional[list["IbftMessage"]] = None

    def encode(self) -> bytes:
        out = bytearray()
        _emit_msg(
            out,
            1,
            self.proposal_message.encode()
            if self.proposal_message is not None
            else None,
        )
        for msg in self.prepare_messages or ():
            _emit_msg(out, 2, msg.encode())
        return bytes(out)

    def _merge_field(self, fnum, wtype, buf, pos):
        if fnum == 1 and wtype == _WIRE_LEN:
            return self._merge_nested("proposal_message", IbftMessage, buf, pos)
        if fnum == 2 and wtype == _WIRE_LEN:
            raw, pos = _read_bytes(buf, pos)
            if self.prepare_messages is None:
                self.prepare_messages = []
            self.prepare_messages.append(_nested_message(raw))
            return pos
        return None


@dataclass
class RoundChangeCertificate(_Decodable):
    """Quorum of ROUND_CHANGEs (reference messages/proto/messages.proto:98-101)."""

    round_change_messages: list["IbftMessage"] = field(default_factory=list)

    def encode(self) -> bytes:
        out = bytearray()
        for msg in self.round_change_messages:
            _emit_msg(out, 1, msg.encode())
        return bytes(out)

    def _merge_field(self, fnum, wtype, buf, pos):
        if fnum == 1 and wtype == _WIRE_LEN:
            raw, pos = _read_bytes(buf, pos)
            self.round_change_messages.append(_nested_message(raw))
            return pos
        return None


def _nested_message(raw: bytes) -> "IbftMessage":
    """A message carried inside a certificate, decoded within its
    envelope's ``wire.decode`` span."""
    msg = IbftMessage()
    msg.merge_from(raw)
    return msg


_PAYLOAD_ATTRS = {
    5: "preprepare_data",
    6: "prepare_data",
    7: "commit_data",
    8: "round_change_data",
}
_PAYLOAD_TYPES = {
    5: PrePrepareMessage,
    6: PrepareMessage,
    7: CommitMessage,
    8: RoundChangeMessage,
}


@dataclass
class IbftMessage(_Decodable):
    """The oneof envelope (reference messages/proto/messages.proto:24-44).

    Exactly one of ``preprepare_data`` / ``prepare_data`` / ``commit_data`` /
    ``round_change_data`` should be set (the oneof payload); setting more than
    one encodes all of them, matching no valid wire message.

    ``type`` is normally a :class:`MessageType` but may be a plain ``int`` for
    unknown values decoded from foreign bytes (proto3 enums are open).
    """

    view: Optional[View] = None
    sender: bytes = b""  # `from` in the .proto; `from` is reserved in Python
    signature: bytes = b""
    type: Union[MessageType, int] = MessageType.PREPREPARE
    preprepare_data: Optional[PrePrepareMessage] = None
    prepare_data: Optional[PrepareMessage] = None
    commit_data: Optional[CommitMessage] = None
    round_change_data: Optional[RoundChangeMessage] = None

    @classmethod
    def decode(cls, buf: bytes) -> "IbftMessage":
        """One message from its wire bytes: a ``wire.decode`` span while
        tracing (the messages a certificate carries decode inside it)."""
        t0 = trace.now_us()
        msg = super().decode(buf)
        if t0 is not None:
            trace.complete("wire.decode", t0)
        return msg

    def encode(self, *, include_signature: bool = True) -> bytes:
        out = bytearray()
        _emit_msg(out, 1, self.view.encode() if self.view is not None else None)
        _emit_bytes(out, 2, self.sender)
        if include_signature:
            _emit_bytes(out, 3, self.signature)
        _emit_uint(out, 4, int(self.type))
        _emit_msg(
            out,
            5,
            self.preprepare_data.encode() if self.preprepare_data is not None else None,
        )
        _emit_msg(
            out, 6, self.prepare_data.encode() if self.prepare_data is not None else None
        )
        _emit_msg(
            out, 7, self.commit_data.encode() if self.commit_data is not None else None
        )
        _emit_msg(
            out,
            8,
            self.round_change_data.encode()
            if self.round_change_data is not None
            else None,
        )
        return bytes(out)

    def _merge_field(self, fnum, wtype, buf, pos):
        if fnum == 1 and wtype == _WIRE_LEN:
            return self._merge_nested("view", View, buf, pos)
        if fnum == 2 and wtype == _WIRE_LEN:
            self.sender, pos = _read_bytes(buf, pos)
            return pos
        if fnum == 3 and wtype == _WIRE_LEN:
            self.signature, pos = _read_bytes(buf, pos)
            return pos
        if fnum == 4 and wtype == _WIRE_VARINT:
            raw_type, pos = _decode_varint(buf, pos)
            self.type = _open_enum(raw_type)
            return pos
        if fnum in _PAYLOAD_ATTRS and wtype == _WIRE_LEN:
            # oneof semantics: switching members clears the previous member;
            # re-seeing the active member merges into it.
            for other_fnum, attr in _PAYLOAD_ATTRS.items():
                if other_fnum != fnum:
                    setattr(self, attr, None)
            return self._merge_nested(
                _PAYLOAD_ATTRS[fnum], _PAYLOAD_TYPES[fnum], buf, pos
            )
        return None

    def payload_no_sig(self) -> bytes:
        """Canonical signing bytes: the message with the signature nulled.

        Mirrors the reference's PayloadNoSig
        (reference messages/proto/helper.go:13-27).  These are the bytes
        an embedder signs and verifies.
        """
        return self.encode(include_signature=False)


# ---------------------------------------------------------------------------
# trace-context propagation (cross-process telemetry plane)
# ---------------------------------------------------------------------------


@dataclass
class TraceContext(_Decodable):
    """Compact per-message trace context carried OUTSIDE the signed bytes.

    The telemetry plane stamps every outbound consensus message with the
    sender's identity and clock so receivers can record causally-linked
    ``net.recv`` events and estimate per-peer clock offsets
    (the JAX package's ``obs.clock``).  The context rides as a framing layer
    AROUND the message (:func:`encode_traced`), never inside
    ``IbftMessage`` — ``payload_no_sig`` and therefore every signature
    stays byte-identical to the reference, traced or not.

    Fields: ``origin`` is the sender's flight-recorder track (one row per
    node), ``height``/``round`` the message's view, ``sent_us`` the
    sender's monotonic ``perf_counter_ns() // 1000`` at multicast time
    (meaningless across processes except as a clock-offset sample), and
    ``span_id`` a per-process send counter linking the sender's
    ``net.send`` instant to every receiver's ``net.recv``.
    """

    origin: str = ""
    height: int = 0
    round: int = 0
    sent_us: int = 0
    span_id: int = 0
    # Delivery-side bookkeeping, never encoded: a transport that already
    # recorded the net.recv for this context (GrpcTransport does, at the
    # wire boundary) sets this so the engine ingress does not record it a
    # second time.  Loopback dispatch leaves it False — the SAME message
    # object reaches every receiver, and each engine records its own recv.
    recorded: bool = False

    def encode(self) -> bytes:
        out = bytearray()
        _emit_bytes(out, 1, self.origin.encode("utf-8"))
        _emit_uint(out, 2, self.height)
        _emit_uint(out, 3, self.round)
        _emit_uint(out, 4, self.sent_us)
        _emit_uint(out, 5, self.span_id)
        return bytes(out)

    def _merge_field(self, fnum, wtype, buf, pos):
        if fnum == 1 and wtype == _WIRE_LEN:
            raw, pos = _read_bytes(buf, pos)
            self.origin = raw.decode("utf-8", "replace")
            return pos
        if fnum == 2 and wtype == _WIRE_VARINT:
            self.height, pos = _decode_varint(buf, pos)
            return pos
        if fnum == 3 and wtype == _WIRE_VARINT:
            self.round, pos = _decode_varint(buf, pos)
            return pos
        if fnum == 4 and wtype == _WIRE_VARINT:
            self.sent_us, pos = _decode_varint(buf, pos)
            return pos
        if fnum == 5 and wtype == _WIRE_VARINT:
            self.span_id, pos = _decode_varint(buf, pos)
            return pos
        return None


# Framing magic for traced payloads.  The first byte decodes as protobuf
# tag (field 26, wire type 7) — wire type 7 does not exist, so no valid
# ``IbftMessage`` encoding can ever start with it: a receiver can always
# tell a traced frame from a bare message without version negotiation.
TRACED_MAGIC = b"\xd7TCX"


def encode_traced(message_bytes: bytes, ctx: TraceContext) -> bytes:
    """Wrap encoded message bytes with a trace-context frame."""
    ctx_bytes = ctx.encode()
    return (
        TRACED_MAGIC + _encode_varint(len(ctx_bytes)) + ctx_bytes + message_bytes
    )


def decode_traced(data: bytes) -> tuple[bytes, Optional[TraceContext]]:
    """Split a payload into (message bytes, trace context or ``None``).

    Bare (untraced) payloads pass through unchanged — the framing is
    strictly additive, and a malformed trace frame from an untrusted peer
    degrades to ``None`` context rather than an error (telemetry must
    never affect message delivery; the message bytes themselves still go
    through the usual decode-and-verify path).
    """
    if not data.startswith(TRACED_MAGIC):
        return data, None
    try:
        length, pos = _decode_varint(data, len(TRACED_MAGIC))
        end = pos + length
        if end > len(data):
            raise ValueError("truncated trace context")
        ctx = TraceContext.decode(data[pos:end])
        return data[end:], ctx
    except ValueError:
        return data[len(TRACED_MAGIC):], None
