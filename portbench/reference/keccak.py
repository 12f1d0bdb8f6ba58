"""Keccak-256 in NumPy, many messages at once: the plain reference's hash.

Written from the Keccak specification (FIPS 202's permutation with the
original Keccak padding 0x01 .. 0x80, as Ethereum uses it), independent of
the program and of the benchmark's signer.  Messages are grouped by their
number of 136-byte blocks and absorbed together, one ``uint64`` lane array
of shape ``(messages, 25)`` a group, so a batch of thousands costs about as
many array operations as one message.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

RATE = 136

_RC = np.array([
    0x0000000000000001, 0x0000000000008082, 0x800000000000808A, 0x8000000080008000,
    0x000000000000808B, 0x0000000080000001, 0x8000000080008081, 0x8000000000008009,
    0x000000000000008A, 0x0000000000000088, 0x0000000080008009, 0x000000008000000A,
    0x000000008000808B, 0x800000000000008B, 0x8000000000008089, 0x8000000000008003,
    0x8000000000008002, 0x8000000000000080, 0x000000000000800A, 0x800000008000000A,
    0x8000000080008081, 0x8000000000008080, 0x0000000080000001, 0x8000000080008008,
], dtype=np.uint64)

# Rotation offsets r[x][y] of lane (x, y); lane (x, y) is column x + 5 * y.
_ROT = [[0, 36, 3, 41, 18], [1, 44, 10, 45, 2], [62, 6, 43, 15, 61],
        [28, 55, 25, 21, 56], [27, 20, 39, 8, 14]]


def _rotl(a: np.ndarray, n: int) -> np.ndarray:
    if n == 0:
        return a
    return (a << np.uint64(n)) | (a >> np.uint64(64 - n))


def keccak_f(state: np.ndarray) -> np.ndarray:
    """The 24-round permutation on ``(m, 25)`` uint64 lanes."""
    a = [state[:, i].copy() for i in range(25)]
    for rc in _RC:
        c = [a[x] ^ a[x + 5] ^ a[x + 10] ^ a[x + 15] ^ a[x + 20] for x in range(5)]
        d = [c[(x - 1) % 5] ^ _rotl(c[(x + 1) % 5], 1) for x in range(5)]
        a = [a[i] ^ d[i % 5] for i in range(25)]
        b = [None] * 25
        for x in range(5):
            for y in range(5):
                b[y + 5 * ((2 * x + 3 * y) % 5)] = _rotl(a[x + 5 * y], _ROT[x][y])
        a = [b[i] ^ (~b[(i % 5 + 1) % 5 + 5 * (i // 5)] & b[(i % 5 + 2) % 5 + 5 * (i // 5)])
             for i in range(25)]
        a[0] = a[0] ^ rc
    return np.stack(a, axis=1)


def _pad(msg: bytes) -> bytes:
    n = RATE - len(msg) % RATE
    if n == 1:
        return msg + b"\x81"
    return msg + b"\x01" + b"\x00" * (n - 2) + b"\x80"


def keccak256_many(messages: Sequence[bytes]) -> List[bytes]:
    """The 32-byte digest of each message, in order."""
    groups: Dict[int, List[int]] = {}
    padded = [_pad(bytes(m)) for m in messages]
    for i, p in enumerate(padded):
        groups.setdefault(len(p) // RATE, []).append(i)
    out: List[bytes] = [b""] * len(messages)
    for blocks, idxs in groups.items():
        data = np.frombuffer(b"".join(padded[i] for i in idxs), dtype="<u8")
        data = data.reshape(len(idxs), blocks, RATE // 8)
        state = np.zeros((len(idxs), 25), dtype=np.uint64)
        for b in range(blocks):
            state[:, : RATE // 8] ^= data[:, b, :]
            state = keccak_f(state)
        digests = state[:, :4].astype("<u8").tobytes()
        for j, i in enumerate(idxs):
            out[i] = digests[32 * j : 32 * (j + 1)]
    return out


def keccak256(message: bytes) -> bytes:
    return keccak256_many([message])[0]
