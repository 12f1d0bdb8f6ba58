"""secp256k1 ECDSA over Python ints — the port's host reference.

A copy of ``go_ibft_tpu.crypto.ecdsa`` (the port imports nothing of the JAX
package), pure Python only: the native hooks of the original are left out.
Three jobs:

1. **Signer** for tests, workloads and the standalone crypto backend.
2. **Oracle** for the device recovery in :mod:`go_ibft_tpu_torch.ops.secp256k1`
   (``chip_smoke.py`` holds the card's masks against :func:`recover`).
3. **Sequential per-message baseline** (one verify at a time).

Signing uses a deterministic keccak-derived nonce (not RFC 6979, but
collision-free and reproducible), so signatures equal the JAX package's.

:func:`scalar_mul` runs in Jacobian coordinates with one inversion at the
end instead of one per affine addition; its affine results are the same
points, a few times faster than the original's affine double-and-add, which
is what lets a 300-validator round be signed in seconds.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import cached_property
from typing import Optional, Tuple

from .keccak import keccak256

P = 0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEFFFFFC2F
N = 0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEBAAEDCE6AF48A03BBFD25E8CD0364141
GX = 0x79BE667EF9DCBBAC55A06295CE870B07029BFCDB2DCE28D959F2815B16F81798
GY = 0x483ADA7726A3C4655DA4FBFC0E1108A8FD17B448A68554199C47D08FFB10D4B8

Point = Optional[Tuple[int, int]]  # None encodes the point at infinity
_Jac = Tuple[int, int, int]  # (X, Y, Z) with x = X/Z^2, y = Y/Z^3; Z == 0 is infinity


def _add(a: Point, b: Point) -> Point:
    if a is None:
        return b
    if b is None:
        return a
    x1, y1 = a
    x2, y2 = b
    if x1 == x2:
        if (y1 + y2) % P == 0:
            return None
        lam = (3 * x1 * x1) * pow(2 * y1, P - 2, P) % P
    else:
        lam = (y2 - y1) * pow(x2 - x1, P - 2, P) % P
    x3 = (lam * lam - x1 - x2) % P
    y3 = (lam * (x1 - x3) - y1) % P
    return (x3, y3)


def _jac_double(p: _Jac) -> _Jac:
    x, y, z = p
    if z == 0 or y == 0:
        return (1, 1, 0)
    yy = y * y % P
    s = 4 * x * yy % P
    m = 3 * x * x % P
    x3 = (m * m - 2 * s) % P
    return (x3, (m * (s - x3) - 8 * yy * yy) % P, 2 * y * z % P)


def _jac_add_affine(p: _Jac, q: Tuple[int, int]) -> _Jac:
    x1, y1, z1 = p
    if z1 == 0:
        return (q[0], q[1], 1)
    zz = z1 * z1 % P
    h = (q[0] * zz - x1) % P
    r = (q[1] * zz * z1 - y1) % P
    if h == 0:
        return _jac_double(p) if r == 0 else (1, 1, 0)
    hh = h * h % P
    hhh = h * hh % P
    v = x1 * hh % P
    x3 = (r * r - hhh - 2 * v) % P
    return (x3, (r * (v - x3) - y1 * hhh) % P, z1 * h % P)


def _to_affine(p: _Jac) -> Point:
    x, y, z = p
    if z == 0:
        return None
    zi = pow(z, P - 2, P)
    zi2 = zi * zi % P
    return (x * zi2 % P, y * zi2 * zi % P)


def scalar_mul(k: int, pt: Point) -> Point:
    k %= N
    if pt is None or k == 0:
        return None
    acc: _Jac = (1, 1, 0)
    for bit in bin(k)[2:]:
        acc = _jac_double(acc)
        if bit == "1":
            acc = _jac_add_affine(acc, pt)
    return _to_affine(acc)


def on_curve(x: int, y: int) -> bool:
    return (y * y - (x * x * x + 7)) % P == 0


def pubkey_to_address(x: int, y: int) -> bytes:
    """Ethereum-style 20-byte address: keccak256(X || Y)[12:]."""
    return keccak256(x.to_bytes(32, "big") + y.to_bytes(32, "big"))[12:]


def digest_to_scalar(digest: bytes) -> int:
    """Map a 32-byte digest to the scalar field (standard truncation mod N)."""
    return int.from_bytes(digest, "big") % N


@dataclass(frozen=True)
class PrivateKey:
    d: int

    @classmethod
    def from_seed(cls, seed: bytes) -> "PrivateKey":
        d = int.from_bytes(keccak256(seed), "big") % N
        return cls(d or 1)

    # cached_property writes straight into __dict__, which a frozen
    # dataclass permits: one scalar multiplication per key, not per access.
    @cached_property
    def pubkey(self) -> Tuple[int, int]:
        pt = scalar_mul(self.d, (GX, GY))
        assert pt is not None
        return pt

    @cached_property
    def address(self) -> bytes:
        return pubkey_to_address(*self.pubkey)


def sign(key: PrivateKey, digest: bytes) -> Tuple[int, int, int]:
    """Deterministic ECDSA; returns ``(r, s, v)`` with low-s normalization.

    ``v`` is the recovery id (y-parity of the nonce point, flipped when s is
    negated), so ``recover(digest, r, s, v)`` round-trips to the pubkey.
    """
    z = digest_to_scalar(digest)
    counter = 0
    while True:
        k = int.from_bytes(
            keccak256(key.d.to_bytes(32, "big") + digest + bytes([counter])), "big"
        ) % N
        counter += 1
        if k == 0:
            continue
        pt = scalar_mul(k, (GX, GY))
        assert pt is not None
        r = pt[0] % N
        if r == 0:
            continue
        s = pow(k, N - 2, N) * (z + r * key.d) % N
        if s == 0:
            continue
        v = pt[1] & 1
        if s > N // 2:
            s = N - s
            v ^= 1
        return r, s, v


def verify(x: int, y: int, digest: bytes, r: int, s: int) -> bool:
    """Textbook sequential verify — one message at a time (the baseline)."""
    if not (0 < r < N and 0 < s < N):
        return False
    if not on_curve(x, y):
        return False
    z = digest_to_scalar(digest)
    w = pow(s, N - 2, N)
    pt = _add(scalar_mul(z * w % N, (GX, GY)), scalar_mul(r * w % N, (x, y)))
    if pt is None:
        return False
    return pt[0] % N == r % N


def recover(digest: bytes, r: int, s: int, v: int) -> Optional[Tuple[int, int]]:
    """Public-key recovery; ``None`` on any invalid input."""
    if not (0 < r < N and 0 < s < N) or v not in (0, 1):
        return None
    x = r
    y2 = (x * x * x + 7) % P
    y = pow(y2, (P + 1) // 4, P)
    if y * y % P != y2:
        return None
    if (y & 1) != v:
        y = P - y
    z = digest_to_scalar(digest)
    rinv = pow(r, N - 2, N)
    return _add(
        scalar_mul((-z) % N * rinv % N, (GX, GY)),
        scalar_mul(s * rinv % N, (x, y)),
    )
