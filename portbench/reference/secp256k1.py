"""secp256k1 public-key recovery over Python integers: the plain reference's
curve arithmetic.

Written from SEC 1 (section 4.1.6, public-key recovery) and the curve's
published constants, independent of the program and of the benchmark's
signer.  ``recover(z, r, s, v)`` returns the affine public key, or ``None``
where the signature is out of range or names no point:

    R = (r, y) with y's parity v,   Q = r^-1 * (s*R - z*G)

Speed is what lets the reference check every distinct signature of a run
after its window: ``z*G`` reads a fixed-base comb table (32 windows of 8
bits, built once per process), and ``s*R`` splits its scalar by the curve's
endomorphism (GLV: two 128-bit halves over R and phi(R) = (beta*x, y)) under
4-bit windows, in Jacobian coordinates with one inversion at the end.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

P = 0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEFFFFFC2F
N = 0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEBAAEDCE6AF48A03BBFD25E8CD0364141
GX = 0x79BE667EF9DCBBAC55A06295CE870B07029BFCDB2DCE28D959F2815B16F81798
GY = 0x483ADA7726A3C4655DA4FBFC0E1108A8FD17B448A68554199C47D08FFB10D4B8
# The endomorphism: phi(x, y) = (BETA * x, y) = LAMBDA * (x, y); the lattice
# basis (A1, B1), (A2, B2) of the scalar split.
LAMBDA = 0x5363AD4CC05C30E0A5261C028812645A122E22EA20816678DF02967C1B23BD72
BETA = 0x7AE96A2B657C07106E64479EAC3434E99CF0497512F58995C1396C28719501EE
A1 = 0x3086D221A7D46BCDE86C90E49284EB15
B1 = -0xE4437ED6010E88286F547FA90ABFE4C3
A2 = 0x114CA50F7A8E2F3F657C1108D9D44CFD8
B2 = A1

Point = Optional[Tuple[int, int]]
_INF = (1, 1, 0)


def _dbl(p):
    x, y, z = p
    if z == 0 or y == 0:
        return _INF
    yy = y * y % P
    s = 4 * x * yy % P
    m = 3 * x * x % P
    x3 = (m * m - 2 * s) % P
    return (x3, (m * (s - x3) - 8 * yy * yy) % P, 2 * y * z % P)


def _add_affine(p, qx: int, qy: int):
    x1, y1, z1 = p
    if z1 == 0:
        return (qx, qy, 1)
    zz = z1 * z1 % P
    h = (qx * zz - x1) % P
    r = (qy * zz * z1 - y1) % P
    if h == 0:
        return _dbl(p) if r == 0 else _INF
    hh = h * h % P
    hhh = h * hh % P
    v = x1 * hh % P
    x3 = (r * r - hhh - 2 * v) % P
    return (x3, (r * (v - x3) - y1 * hhh) % P, z1 * h % P)


def _affine(p) -> Point:
    x, y, z = p
    if z == 0:
        return None
    zi = pow(z, -1, P)
    zi2 = zi * zi % P
    return (x * zi2 % P, y * zi2 * zi % P)


def _batch_affine(points) -> List[Point]:
    """Jacobian points to affine with one inversion (Montgomery's trick);
    infinity stays ``None``."""
    live = [i for i, p in enumerate(points) if p[2] != 0]
    out: List[Point] = [None] * len(points)
    if not live:
        return out
    acc = [1]
    for i in live:
        acc.append(acc[-1] * points[i][2] % P)
    inv = pow(acc[-1], -1, P)
    for k in range(len(live) - 1, -1, -1):
        i = live[k]
        zi = inv * acc[k] % P
        inv = inv * points[i][2] % P
        x, y, _ = points[i]
        zi2 = zi * zi % P
        out[i] = (x * zi2 % P, y * zi2 * zi % P)
    return out


_COMB: List[List[Point]] = []


def _comb() -> List[List[Point]]:
    """``d * 2**(8w) * G`` for windows ``w < 32`` and digits ``d < 256``."""
    if not _COMB:
        base = (GX, GY)
        for _w in range(32):
            row = [_INF]
            for _d in range(1, 256):
                row.append(_add_affine(row[-1], *base))
            _COMB.append(_batch_affine(row))
            nxt = (base[0], base[1], 1)
            for _ in range(8):
                nxt = _dbl(nxt)
            base = _affine(nxt)
    return _COMB


def _split(k: int) -> Tuple[int, int]:
    """``k = k1 + k2 * LAMBDA (mod N)`` with ``|k1|, |k2|`` about 128 bits."""
    c1 = (B2 * k + N // 2) // N
    c2 = (-B1 * k + N // 2) // N
    return k - c1 * A1 - c2 * A2, -c1 * B1 - c2 * B2


def _mul_g(k: int):
    comb = _comb()
    acc = _INF
    for w in range(32):
        d = (k >> (8 * w)) & 255
        if d:
            pt = comb[w][d]
            acc = _add_affine(acc, pt[0], pt[1])
    return acc


def _mul_glv(k: int, x: int, y: int):
    """``k * (x, y)`` by the endomorphism split, 4-bit windows, joint."""
    k1, k2 = _split(k % N)
    y1 = y if k1 >= 0 else P - y
    y2 = y if k2 >= 0 else P - y
    k1, k2 = abs(k1), abs(k2)
    row1 = [(x, y1, 1)]
    for _ in range(14):
        row1.append(_add_affine(row1[-1], x, y1))
    t1 = _batch_affine(row1)
    # phi(d * (x, y)) = (BETA * x_d, y_d): the second table from the first.
    t2 = [None if pt is None else (BETA * pt[0] % P, pt[1] if y2 == y1 else P - pt[1]) for pt in t1]
    acc = _INF
    top = max(k1.bit_length(), k2.bit_length())
    for w in range((top + 3) // 4 - 1, -1, -1):
        if acc[2]:
            for _ in range(4):
                acc = _dbl(acc)
        d1 = (k1 >> (4 * w)) & 15
        d2 = (k2 >> (4 * w)) & 15
        if d1:
            pt = t1[d1 - 1]
            if pt is not None:
                acc = _add_affine(acc, pt[0], pt[1])
        if d2:
            pt = t2[d2 - 1]
            if pt is not None:
                acc = _add_affine(acc, pt[0], pt[1])
    return acc


def _add(p, q):
    if q[2] == 0:
        return p
    qa = _affine(q)
    return _add_affine(p, qa[0], qa[1])


def recover(z: int, r: int, s: int, v: int) -> Point:
    """The public key that signed digest scalar ``z`` (the digest's 256 bits
    mod N) with ``(r, s, v)``, or ``None``."""
    if not (0 < r < N and 0 < s < N) or v not in (0, 1):
        return None
    y2 = (pow(r, 3, P) + 7) % P
    y = pow(y2, (P + 1) // 4, P)
    if y * y % P != y2:
        return None
    if (y & 1) != v:
        y = P - y
    rinv = pow(r, -1, N)
    u1 = (-z) * rinv % N
    u2 = s * rinv % N
    return _affine(_add(_mul_glv(u2, r, y), _mul_g(u1)))


def signature_of(d: int, z: int, k: int) -> Optional[bytes]:
    """The 65-byte signature ``r || s || v`` of digest scalar ``z`` by key
    ``d`` with nonce ``k`` (SEC 1 section 4.1.3), ``s`` made low and ``v``,
    the parity of R's y, flipped with it; ``None`` where ``k``, ``r`` or
    ``s`` is 0."""
    if not 0 < k < N:
        return None
    R = _affine(_mul_g(k))
    r = R[0] % N
    if r == 0:
        return None
    s = pow(k, -1, N) * (z + r * d) % N
    if s == 0:
        return None
    v = R[1] & 1
    if s > N // 2:
        s, v = N - s, v ^ 1
    return r.to_bytes(32, "big") + s.to_bytes(32, "big") + bytes([v])


def digest_scalar(digest: bytes) -> int:
    return int.from_bytes(digest, "big") % N
