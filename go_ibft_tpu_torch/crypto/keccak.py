"""Keccak-256 (pre-NIST padding, as used by Ethereum) — host implementation.

Pure Python, dependency-free (``hashlib.sha3_256`` is the NIST variant with
different padding and cannot be used).  A copy of ``go_ibft_tpu.crypto.keccak``
without its native fast-path hook; the device-batched counterpart lives in
:mod:`go_ibft_tpu_torch.ops.keccak`.

Used for the canonical digest of ``payload_no_sig`` bytes (the bytes an
embedder signs — reference messages/proto/helper.go:13-27) and for
pubkey -> 20-byte address derivation.
"""

from __future__ import annotations

from typing import List

_RC = [
    0x0000000000000001, 0x0000000000008082, 0x800000000000808A,
    0x8000000080008000, 0x000000000000808B, 0x0000000080000001,
    0x8000000080008081, 0x8000000000008009, 0x000000000000008A,
    0x0000000000000088, 0x0000000080008009, 0x000000008000000A,
    0x000000008000808B, 0x800000000000008B, 0x8000000000008089,
    0x8000000000008003, 0x8000000000008002, 0x8000000000000080,
    0x000000000000800A, 0x800000008000000A, 0x8000000080008081,
    0x8000000000008080, 0x0000000080000001, 0x8000000080008008,
]

# Rotation offsets r[x][y] for lane A[x, y].
_ROT = [
    [0, 36, 3, 41, 18],
    [1, 44, 10, 45, 2],
    [62, 6, 43, 15, 61],
    [28, 55, 25, 21, 56],
    [27, 20, 39, 8, 14],
]

_MASK = (1 << 64) - 1
_RATE = 136  # 1088-bit rate for Keccak-256


def _rotl(v: int, n: int) -> int:
    n &= 63
    return ((v << n) | (v >> (64 - n))) & _MASK


def _keccak_f(a: List[int]) -> None:
    """In-place Keccak-f[1600] on a 25-lane state, lane A[x,y] at a[x+5y]."""
    for rc in _RC:
        # theta
        c = [a[x] ^ a[x + 5] ^ a[x + 10] ^ a[x + 15] ^ a[x + 20] for x in range(5)]
        d = [c[(x - 1) % 5] ^ _rotl(c[(x + 1) % 5], 1) for x in range(5)]
        for x in range(5):
            for y in range(5):
                a[x + 5 * y] ^= d[x]
        # rho + pi: B[y, 2x+3y] = rotl(A[x, y], r[x][y])
        b = [0] * 25
        for x in range(5):
            for y in range(5):
                b[y + 5 * ((2 * x + 3 * y) % 5)] = _rotl(a[x + 5 * y], _ROT[x][y])
        # chi
        for x in range(5):
            for y in range(5):
                a[x + 5 * y] = b[x + 5 * y] ^ (
                    (~b[(x + 1) % 5 + 5 * y]) & b[(x + 2) % 5 + 5 * y]
                ) & _MASK
        # iota
        a[0] ^= rc


def _keccak256_py(data: bytes) -> bytes:
    state = [0] * 25
    # Multi-rate padding 0x01 .. 0x80 (original Keccak, not NIST SHA-3 0x06).
    padded = bytearray(data)
    pad_len = _RATE - (len(padded) % _RATE)
    if pad_len == 1:
        padded += b"\x81"
    else:
        padded += b"\x01" + b"\x00" * (pad_len - 2) + b"\x80"
    for off in range(0, len(padded), _RATE):
        block = padded[off : off + _RATE]
        for i in range(_RATE // 8):
            state[i] ^= int.from_bytes(block[8 * i : 8 * i + 8], "little")
        _keccak_f(state)
    out = b"".join(state[i].to_bytes(8, "little") for i in range(4))
    return out


def keccak256(data: bytes) -> bytes:
    """32-byte Keccak-256 digest (Ethereum flavor)."""
    return _keccak256_py(data)


def keccak256_many(items: List[bytes]) -> List[bytes]:
    """Bulk host digests, ``[keccak256(x) for x in items]``."""
    return [_keccak256_py(data) for data in items]
