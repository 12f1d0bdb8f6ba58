"""Next-validator-set content commitments (the port of the JAX package's
``lightsync/commitment.py``).

The serve plane's documented fabricated-diff hole (docs/SERVING.md trust
assumption 2, `chain/sync.py`'s height-binding caveat): committed seals
sign only ``(raw_proposal, round)``, so the validator-set diff chain a
proof server hands a light client carries no quorum signature of its
own — a malicious server can invent a rotation to its own keys and seal
every later height itself.  Real chains close this by committing the
NEXT height's validator set inside the block content, so the rotation is
covered by the CURRENT quorum's seals over the proposal bytes.

This module is that commitment as data:

* :func:`set_root` — the canonical 32-byte digest of a voting-power map
  (order-independent: addresses sort first; powers are part of the
  preimage so a power change is a rotation too);
* :func:`embed_next_set` / :func:`extract_next_set` /
  :func:`strip_next_set` — a magic-framed suffix carrying the root on
  the END of the raw proposal bytes.  A suffix (not a prefix) keeps
  every existing consumer of the leading bytes working unchanged —
  ``SimBackend``'s ``b"sim-block-%08d"`` prefix check, the byte-identity
  cluster oracles, and any embedder that parses its own header.

The commitment travels INSIDE the signed bytes (seals cover the whole
``raw_proposal``), which is exactly what makes it enforceable:
``serve/proof.py::walk_sets(..., require_commitments=True)`` checks each
diff hop against the root the PREVIOUS height's quorum sealed, and
``chain/sync.py``-style consumers get the same guarantee through the
embedder's ``is_valid_proposal`` seam (``ECDSABackend`` /
``SimBackend`` with ``commit_next_set=True``).
"""

from __future__ import annotations

from typing import Mapping, Optional

from ..crypto.keccak import keccak256

__all__ = [
    "COMMIT_MAGIC",
    "COMMIT_SUFFIX_BYTES",
    "SET_ROOT_BYTES",
    "embed_next_set",
    "extract_next_set",
    "set_root",
    "strip_next_set",
]

_SET_ROOT_DOMAIN = b"go-ibft-set-root-v1:"
SET_ROOT_BYTES = 32

# Leading NUL keeps the frame from ever being valid UTF-8 text an
# embedder might accidentally produce; the versioned tag makes future
# commitment formats distinguishable without guessing.
COMMIT_MAGIC = b"\x00go-ibft-next-set-v1:"
COMMIT_SUFFIX_BYTES = len(COMMIT_MAGIC) + SET_ROOT_BYTES


def set_root(powers: Mapping[bytes, int]) -> bytes:
    """Canonical digest of a validator voting-power map.

    Deterministic over dict order (addresses sort), length-framed per
    entry (no address/power concatenation ambiguity), and covering the
    POWERS — a stake change with an unchanged member list must produce a
    different root, because it changes every later quorum threshold.
    """
    parts = [_SET_ROOT_DOMAIN]
    for addr in sorted(powers):
        power = powers[addr]
        if not isinstance(power, int) or power <= 0:
            raise ValueError(
                f"set_root over non-positive power {power!r} for "
                f"{bytes(addr).hex()[:16]}"
            )
        a = bytes(addr)
        parts.append(len(a).to_bytes(2, "big"))
        parts.append(a)
        parts.append(power.to_bytes(8, "big"))
    return keccak256(b"".join(parts))


def embed_next_set(raw_proposal: bytes, root: bytes) -> bytes:
    """Append the next-set commitment frame to proposal content."""
    if len(root) != SET_ROOT_BYTES:
        raise ValueError(f"set root must be {SET_ROOT_BYTES} bytes")
    if extract_next_set(raw_proposal) is not None:
        raise ValueError("proposal already carries a next-set commitment")
    return bytes(raw_proposal) + COMMIT_MAGIC + root


def extract_next_set(raw_proposal: bytes) -> Optional[bytes]:
    """The committed next-set root, or None when the frame is absent."""
    raw = bytes(raw_proposal)
    if len(raw) < COMMIT_SUFFIX_BYTES:
        return None
    if raw[-COMMIT_SUFFIX_BYTES:-SET_ROOT_BYTES] != COMMIT_MAGIC:
        return None
    return raw[-SET_ROOT_BYTES:]


def strip_next_set(raw_proposal: bytes) -> bytes:
    """Proposal content without the commitment frame (absent → as-is)."""
    raw = bytes(raw_proposal)
    if extract_next_set(raw) is None:
        return raw
    return raw[:-COMMIT_SUFFIX_BYTES]
