"""Host BLS12-381: keys, aggregate commit seals, pairings (pure Python).

A copy of ``go_ibft_tpu.crypto.bls`` (the port imports nothing of the JAX
package), imports rewritten.

The reference injects all cryptography through its Backend seam
(go-ibft core/backend.go:37-56); BASELINE.md config #4 requires the new
build to ALSO support BLS12-381 aggregate COMMIT verification — one
pairing check certifies a whole quorum of seals.  This module is the
exact-arithmetic host oracle: the semantics source of truth the device
path (:mod:`go_ibft_tpu_torch.ops.bls12_381`) must match bit-for-bit, and the
slow-but-sure baseline for the bench denominator.

Scheme (minimal-pubkey-size orientation, eth2-style):

* secret key ``sk`` — scalar mod r;
* public key ``pk = sk * G1`` (48-byte x, on E/Fp: y^2 = x^3 + 4);
* seal over a proposal hash ``m``: ``sigma = sk * H2(m)`` with ``H2`` a
  deterministic try-and-increment hash onto the r-order subgroup of
  E'/Fp2: y^2 = x^3 + 4(u+1) (NOT the RFC 9380 SSWU map — interop with
  other BLS libraries is out of scope, determinism and group-correctness
  are not);
* aggregate verification for one message:
  ``e(G1, sum(sigma_i)) == e(sum(pk_i), H2(m))``.

Everything derivable is DERIVED (cofactors from the curve parameter x,
group orders from the trace) rather than transcribed, so a typo cannot
silently corrupt the math; generators and p/r are the standard published
constants.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

from .keccak import keccak256

# -- parameters -------------------------------------------------------------

# Field modulus, subgroup order, curve parameter (standard constants).
P = 0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFAAAB
R = 0x73EDA753299D7D483339D80809A1D80553BDA402FFFE5BFEFFFFFFFF00000001
BLS_X = 0xD201000000010000  # |x|; the BLS12-381 parameter is -x
B1 = 4  # G1 curve: y^2 = x^3 + 4

G1_GEN = (
    0x17F1D3A73197D7942695638C4FA9AC0FC3688C4F9774B905A14E3A3F171BAC586C55E83FF97A1AEFFB3AF00ADB22C6BB,
    0x08B3F481E3AAA0F1A09E30ED741D8AE4FCF5E095D5D00AF600DB18CB2C04B3EDD03CC744A2888AE40CAA232946C5E7E1,
)
G2_GEN = (
    (
        0x024AA2B2F08F0A91260805272DC51051C6E47AD4FA403B02B4510B647AE3D1770BAC0326A805BBEFD48056C8C121BDB8,
        0x13E02B6052719F607DACD3A088274F65596BD0D09920B61AB5DA61BBDC7F5049334CF11213945D57E5AC7D055D042B7E,
    ),
    (
        0x0CE5D527727D6E118CC9CDC6DA2E351AADFD9BAA8CBDD3A76D429A695160D12C923AC9CC3BACA289E193548608B82801,
        0x0606C4A02EA734CC32ACD2B02BC28B99CB3E287E85A763AF267492AB572E99AB3F370D275CEC1DA1AAA9075FF05F79BE,
    ),
)

# Derived: trace t = x + 1 (x negative: t = 1 - BLS_X), group cardinalities,
# cofactors.  #E(Fp) = p + 1 - t.  The G2 twist E'/Fp2 is a SEXTIC twist, so
# its trace is NOT t2 = t^2 - 2p (that is #E(Fp2)) but one of the CM
# variants (t2 +- 3f)/2 with t2^2 - 4p^2 = -3 f^2; the one divisible by r
# (and verified by annihilating actual twist points in the tests) is
# (t2 - 3f)/2.
_T = 1 - BLS_X
H1_COFACTOR = (P + 1 - _T) // R
_T2 = _T * _T - 2 * P


def _isqrt(n: int) -> int:
    import math

    return math.isqrt(n)


_F2 = _isqrt((4 * P * P - _T2 * _T2) // 3)
assert 3 * _F2 * _F2 == 4 * P * P - _T2 * _T2
G2_ORDER_FULL = P * P + 1 - (_T2 - 3 * _F2) // 2
H2_COFACTOR = G2_ORDER_FULL // R
assert (P + 1 - _T) % R == 0 and G2_ORDER_FULL % R == 0

# -- Fp2 / Fp6 / Fp12 tower -------------------------------------------------
# Fp2 = Fp[u]/(u^2+1); Fp6 = Fp2[v]/(v^3 - xi), xi = 1 + u; Fp12 = Fp6[w]/(w^2 - v)

Fp2T = Tuple[int, int]


def f2_add(a: Fp2T, b: Fp2T) -> Fp2T:
    return ((a[0] + b[0]) % P, (a[1] + b[1]) % P)


def f2_sub(a: Fp2T, b: Fp2T) -> Fp2T:
    return ((a[0] - b[0]) % P, (a[1] - b[1]) % P)


def f2_neg(a: Fp2T) -> Fp2T:
    return (-a[0] % P, -a[1] % P)


def f2_mul(a: Fp2T, b: Fp2T) -> Fp2T:
    t0 = a[0] * b[0]
    t1 = a[1] * b[1]
    t2 = (a[0] + a[1]) * (b[0] + b[1])
    return ((t0 - t1) % P, (t2 - t0 - t1) % P)


def f2_sqr(a: Fp2T) -> Fp2T:
    return f2_mul(a, a)


def f2_muli(a: Fp2T, k: int) -> Fp2T:
    return (a[0] * k % P, a[1] * k % P)


def f2_conj(a: Fp2T) -> Fp2T:
    return (a[0], -a[1] % P)


def f2_inv(a: Fp2T) -> Fp2T:
    norm = (a[0] * a[0] + a[1] * a[1]) % P
    ninv = pow(norm, P - 2, P)
    return (a[0] * ninv % P, -a[1] * ninv % P)


def f2_mul_xi(a: Fp2T) -> Fp2T:
    """Multiply by the Fp6 non-residue xi = 1 + u."""
    return ((a[0] - a[1]) % P, (a[0] + a[1]) % P)


F2_ZERO: Fp2T = (0, 0)
F2_ONE: Fp2T = (1, 0)

Fp6T = Tuple[Fp2T, Fp2T, Fp2T]
F6_ZERO: Fp6T = (F2_ZERO, F2_ZERO, F2_ZERO)
F6_ONE: Fp6T = (F2_ONE, F2_ZERO, F2_ZERO)


def f6_add(a: Fp6T, b: Fp6T) -> Fp6T:
    return (f2_add(a[0], b[0]), f2_add(a[1], b[1]), f2_add(a[2], b[2]))


def f6_sub(a: Fp6T, b: Fp6T) -> Fp6T:
    return (f2_sub(a[0], b[0]), f2_sub(a[1], b[1]), f2_sub(a[2], b[2]))


def f6_neg(a: Fp6T) -> Fp6T:
    return (f2_neg(a[0]), f2_neg(a[1]), f2_neg(a[2]))


def f6_mul(a: Fp6T, b: Fp6T) -> Fp6T:
    a0, a1, a2 = a
    b0, b1, b2 = b
    t0, t1, t2 = f2_mul(a0, b0), f2_mul(a1, b1), f2_mul(a2, b2)
    c0 = f2_add(
        t0,
        f2_mul_xi(
            f2_sub(f2_mul(f2_add(a1, a2), f2_add(b1, b2)), f2_add(t1, t2))
        ),
    )
    c1 = f2_add(
        f2_sub(f2_mul(f2_add(a0, a1), f2_add(b0, b1)), f2_add(t0, t1)),
        f2_mul_xi(t2),
    )
    c2 = f2_add(
        f2_sub(f2_mul(f2_add(a0, a2), f2_add(b0, b2)), f2_add(t0, t2)), t1
    )
    return (c0, c1, c2)


def f6_mul_v(a: Fp6T) -> Fp6T:
    """Multiply by v: (a0, a1, a2) -> (xi*a2, a0, a1)."""
    return (f2_mul_xi(a[2]), a[0], a[1])


def f6_inv(a: Fp6T) -> Fp6T:
    a0, a1, a2 = a
    c0 = f2_sub(f2_sqr(a0), f2_mul_xi(f2_mul(a1, a2)))
    c1 = f2_sub(f2_mul_xi(f2_sqr(a2)), f2_mul(a0, a1))
    c2 = f2_sub(f2_sqr(a1), f2_mul(a0, a2))
    t = f2_add(
        f2_mul(a0, c0),
        f2_mul_xi(f2_add(f2_mul(a1, c2), f2_mul(a2, c1))),
    )
    tinv = f2_inv(t)
    return (f2_mul(c0, tinv), f2_mul(c1, tinv), f2_mul(c2, tinv))


Fp12T = Tuple[Fp6T, Fp6T]
F12_ONE: Fp12T = (F6_ONE, F6_ZERO)


def f12_mul(a: Fp12T, b: Fp12T) -> Fp12T:
    a0, a1 = a
    b0, b1 = b
    t0 = f6_mul(a0, b0)
    t1 = f6_mul(a1, b1)
    c0 = f6_add(t0, f6_mul_v(t1))
    c1 = f6_sub(
        f6_mul(f6_add(a0, a1), f6_add(b0, b1)), f6_add(t0, t1)
    )
    return (c0, c1)


def f12_sqr(a: Fp12T) -> Fp12T:
    return f12_mul(a, a)


def f12_inv(a: Fp12T) -> Fp12T:
    a0, a1 = a
    t = f6_inv(f6_sub(f6_mul(a0, a0), f6_mul_v(f6_mul(a1, a1))))
    return (f6_mul(a0, t), f6_neg(f6_mul(a1, t)))


def f12_pow(a: Fp12T, e: int) -> Fp12T:
    if e < 0:
        return f12_pow(f12_inv(a), -e)
    acc = F12_ONE
    for bit in bin(e)[2:]:
        acc = f12_sqr(acc)
        if bit == "1":
            acc = f12_mul(acc, a)
    return acc


def f12_from_fp(x: int) -> Fp12T:
    return (((x % P, 0), F2_ZERO, F2_ZERO), F6_ZERO)


def f12_from_fp2(x: Fp2T) -> Fp12T:
    return ((x, F2_ZERO, F2_ZERO), F6_ZERO)


# w = (0, 1_Fp6): the Fp12 generator with w^2 = v, w^6 = xi.
F12_W: Fp12T = (F6_ZERO, F6_ONE)
F12_W_INV = f12_inv(F12_W)
_W_INV2 = f12_mul(F12_W_INV, F12_W_INV)
_W_INV3 = f12_mul(_W_INV2, F12_W_INV)

# -- generic affine curve ops over a field given by (mul, add-like) ---------
# Points are None (infinity) or coordinate tuples; two instantiations:
# Fp ints (G1) and Fp2 pairs (G2).

PointG1 = Optional[Tuple[int, int]]
PointG2 = Optional[Tuple[Fp2T, Fp2T]]


def g1_add(a: PointG1, b: PointG1) -> PointG1:
    if a is None:
        return b
    if b is None:
        return a
    x1, y1 = a
    x2, y2 = b
    if x1 == x2:
        if (y1 + y2) % P == 0:
            return None
        m = 3 * x1 * x1 * pow(2 * y1, P - 2, P) % P
    else:
        m = (y2 - y1) * pow(x2 - x1, P - 2, P) % P
    x3 = (m * m - x1 - x2) % P
    return (x3, (m * (x1 - x3) - y1) % P)


class _FieldOps:
    """Tiny field-op record so the Jacobian ladder below serves both Fp
    (G1) and Fp2 (G2) without duplication."""

    def __init__(self, add, sub, mul, inv, muli, zero, one):
        self.add, self.sub, self.mul, self.inv = add, sub, mul, inv
        self.muli, self.zero, self.one = muli, zero, one


_FP_OPS = _FieldOps(
    add=lambda a, b: (a + b) % P,
    sub=lambda a, b: (a - b) % P,
    mul=lambda a, b: a * b % P,
    inv=lambda a: pow(a, P - 2, P),
    muli=lambda a, k: a * k % P,
    zero=0,
    one=1,
)
_FP2_OPS = _FieldOps(f2_add, f2_sub, f2_mul, f2_inv, f2_muli, F2_ZERO, F2_ONE)


def _jac_mul(f: _FieldOps, k: int, pt):
    """Double-and-add in Jacobian coordinates (a = 0 curves): one inversion
    total instead of one per group op — the host workload builders sign
    hundreds of seals, affine ladders would take minutes."""
    if pt is None or k == 0:
        return None
    x0, y0 = pt
    X, Y, Z = None, None, None  # infinity
    ax, ay = x0, y0

    def jdouble(p):
        if p is None:
            return None
        X1, Y1, Z1 = p
        A = f.mul(X1, X1)
        B = f.mul(Y1, Y1)
        C = f.mul(B, B)
        t = f.mul(f.add(X1, B), f.add(X1, B))
        D = f.muli(f.sub(f.sub(t, A), C), 2)
        E = f.muli(A, 3)
        F = f.mul(E, E)
        X3 = f.sub(F, f.muli(D, 2))
        Y3 = f.sub(f.mul(E, f.sub(D, X3)), f.muli(C, 8))
        Z3 = f.muli(f.mul(Y1, Z1), 2)
        return (X3, Y3, Z3)

    def jadd_affine(p):
        """p + (ax, ay), mixed coordinates."""
        if p is None:
            return (ax, ay, f.one)
        X1, Y1, Z1 = p
        Z1Z1 = f.mul(Z1, Z1)
        U2 = f.mul(ax, Z1Z1)
        S2 = f.mul(ay, f.mul(Z1Z1, Z1))
        if U2 == X1:
            if S2 == Y1:
                return jdouble(p)
            return None
        H = f.sub(U2, X1)
        HH = f.mul(H, H)
        HHH = f.mul(HH, H)
        V = f.mul(X1, HH)
        rr = f.sub(S2, Y1)
        X3 = f.sub(f.sub(f.mul(rr, rr), HHH), f.muli(V, 2))
        Y3 = f.sub(f.mul(rr, f.sub(V, X3)), f.mul(Y1, HHH))
        Z3 = f.mul(Z1, H)
        return (X3, Y3, Z3)

    acc = None
    for bit in bin(k)[2:]:
        acc = jdouble(acc)
        if bit == "1":
            acc = jadd_affine(acc)
    if acc is None:
        return None
    X1, Y1, Z1 = acc
    zinv = f.inv(Z1)
    zi2 = f.mul(zinv, zinv)
    return (f.mul(X1, zi2), f.mul(Y1, f.mul(zi2, zinv)))


def g1_mul(k: int, pt: PointG1) -> PointG1:
    return _jac_mul(_FP_OPS, k, pt)


def g1_neg(a: PointG1) -> PointG1:
    return None if a is None else (a[0], -a[1] % P)


def g1_on_curve(pt: PointG1) -> bool:
    if pt is None:
        return True
    x, y = pt
    return (y * y - (x * x * x + B1)) % P == 0


B2: Fp2T = f2_mul_xi((B1, 0))  # 4 * (1 + u): M-type twist constant


def g2_add(a: PointG2, b: PointG2) -> PointG2:
    if a is None:
        return b
    if b is None:
        return a
    x1, y1 = a
    x2, y2 = b
    if x1 == x2:
        if f2_add(y1, y2) == F2_ZERO:
            return None
        m = f2_mul(
            f2_muli(f2_sqr(x1), 3), f2_inv(f2_muli(y1, 2))
        )
    else:
        m = f2_mul(f2_sub(y2, y1), f2_inv(f2_sub(x2, x1)))
    x3 = f2_sub(f2_sub(f2_sqr(m), x1), x2)
    return (x3, f2_sub(f2_mul(m, f2_sub(x1, x3)), y1))


def g2_mul(k: int, pt: PointG2) -> PointG2:
    return _jac_mul(_FP2_OPS, k, pt)


def g2_neg(a: PointG2) -> PointG2:
    return None if a is None else (a[0], f2_neg(a[1]))


def g2_on_curve(pt: PointG2) -> bool:
    if pt is None:
        return True
    x, y = pt
    return f2_sub(f2_sqr(y), f2_add(f2_mul(f2_sqr(x), x), B2)) == F2_ZERO


# -- pairing ----------------------------------------------------------------
# Generic-but-slow construction (the oracle property beats speed here):
# untwist G2 into E(Fp12) and run the ate Miller loop with affine line
# functions; final exponentiation as one big f12_pow.

_FE_EXP = (P**12 - 1) // R

Point12 = Optional[Tuple[Fp12T, Fp12T]]


def _untwist(q: PointG2) -> Point12:
    """E'(Fp2) -> E(Fp12) for the M-type twist: (x, y) -> (x/w^2, y/w^3)."""
    if q is None:
        return None
    return (
        f12_mul(f12_from_fp2(q[0]), _W_INV2),
        f12_mul(f12_from_fp2(q[1]), _W_INV3),
    )


def _f12_eq(a: Fp12T, b: Fp12T) -> bool:
    return a == b


def _f12_add(a: Fp12T, b: Fp12T) -> Fp12T:
    return (f6_add(a[0], b[0]), f6_add(a[1], b[1]))


def _f12_sub(a: Fp12T, b: Fp12T) -> Fp12T:
    return (f6_sub(a[0], b[0]), f6_sub(a[1], b[1]))


F12_ZERO: Fp12T = (F6_ZERO, F6_ZERO)


def _slope(p1: Point12, p2: Point12) -> Optional[Fp12T]:
    """Slope of the line through p1, p2 (tangent when equal); None for a
    vertical line (x1 == x2, y1 == -y2)."""
    assert p1 is not None and p2 is not None
    x1, y1 = p1
    x2, y2 = p2
    if _f12_eq(x1, x2):
        if not _f12_eq(y1, y2):
            return None  # vertical
        return f12_mul(
            f12_mul(f12_sqr(x1), f12_from_fp(3)),
            f12_inv(f12_mul(y1, f12_from_fp(2))),
        )
    return f12_mul(_f12_sub(y2, y1), f12_inv(_f12_sub(x2, x1)))


def _p12_add(a: Point12, b: Point12) -> Point12:
    if a is None:
        return b
    if b is None:
        return a
    x1, y1 = a
    x2, y2 = b
    if _f12_eq(x1, x2) and _f12_eq(_f12_add(y1, y2), F12_ZERO):
        return None
    m = _slope(a, b)
    assert m is not None
    x3 = _f12_sub(_f12_sub(f12_sqr(m), x1), x2)
    y3 = _f12_sub(f12_mul(m, _f12_sub(x1, x3)), y1)
    return (x3, y3)


def _line(p1: Point12, p2: Point12, t: Point12) -> Fp12T:
    """Evaluation at ``t`` of the line through p1, p2 (tangent if equal)."""
    assert t is not None
    x1, y1 = p1  # type: ignore[misc]
    xt, yt = t
    m = _slope(p1, p2)
    if m is None:
        return _f12_sub(xt, x1)  # vertical line
    return _f12_sub(f12_mul(m, _f12_sub(xt, x1)), _f12_sub(yt, y1))


def miller_raw(q: PointG2, p: PointG1) -> Fp12T:
    """The UNREDUCED ate Miller value f_{|x|,q}(p) (pre-inversion, pre-
    final-exponentiation).

    Exposed so batch verification can combine many pairings' Miller
    values and pay ONE final exponentiation for the whole product
    (:mod:`go_ibft_tpu_torch.verify.aggregate`) — the final exponentiation is
    ~90% of a host pairing's cost.  ``pairing`` is exactly
    ``f12_pow(f12_inv(miller_raw(q, p)), (p^12 - 1) / r)``.
    """
    if q is None or p is None:
        return F12_ONE
    q12 = _untwist(q)
    p12: Point12 = (f12_from_fp(p[0]), f12_from_fp(p[1]))
    acc = q12
    f = F12_ONE
    for bit in bin(BLS_X)[3:]:
        f = f12_mul(f12_sqr(f), _line(acc, acc, p12))
        acc = _p12_add(acc, acc)
        if bit == "1":
            f = f12_mul(f, _line(acc, q12, p12))
            acc = _p12_add(acc, q12)
    return f


def pairing(q: PointG2, p: PointG1) -> Fp12T:
    """Reduced ate pairing e(q, p); bilinear, non-degenerate on the r-torsion."""
    if q is None or p is None:
        return F12_ONE
    # the BLS12-381 parameter is negative: f_{-n} = 1/f_n up to verticals
    # (killed by the final exponentiation)
    f = f12_inv(miller_raw(q, p))
    return f12_pow(f, _FE_EXP)


def final_exponentiation(f: Fp12T) -> Fp12T:
    """``f^((p^12 - 1) / r)`` — the batch-verification finish step."""
    return f12_pow(f, _FE_EXP)


# -- hashing to G2 ----------------------------------------------------------


def _fp2_sqrt(a: Fp2T) -> Optional[Fp2T]:
    """Tonelli-Shanks in Fp2 (q = p^2, q - 1 = 2^s * m)."""
    if a == F2_ZERO:
        return F2_ZERO
    q1 = P * P - 1
    s = (q1 & -q1).bit_length() - 1
    m = q1 >> s

    def f2_pow(base: Fp2T, e: int) -> Fp2T:
        acc = F2_ONE
        for bit in bin(e)[2:]:
            acc = f2_sqr(acc)
            if bit == "1":
                acc = f2_mul(acc, base)
        return acc

    if f2_pow(a, q1 // 2) != F2_ONE:
        return None
    # find a quadratic non-residue deterministically
    z = (1, 1)
    while f2_pow(z, q1 // 2) == F2_ONE:
        z = (z[0] + 1, z[1])
    c = f2_pow(z, m)
    t = f2_pow(a, m)
    x = f2_pow(a, (m + 1) // 2)
    while t != F2_ONE:
        # find least i with t^(2^i) == 1
        i, t2 = 0, t
        while t2 != F2_ONE:
            t2 = f2_sqr(t2)
            i += 1
        b = c
        for _ in range(s - i - 1):
            b = f2_sqr(b)
        x = f2_mul(x, b)
        c = f2_sqr(b)
        t = f2_mul(t, c)
        s = i
    return x


from functools import lru_cache


@lru_cache(maxsize=64)
def hash_to_g2(message: bytes) -> PointG2:
    """Deterministic try-and-increment map onto the r-order subgroup.

    Draws an Fp2 x-candidate from keccak256 expansions, solves the twist
    equation, clears the cofactor.  Not RFC 9380; see module docstring.
    Cached: one IBFT round hashes the same proposal hash for every seal.
    """
    ctr = 0
    while True:
        seed = message + ctr.to_bytes(4, "big")
        parts = [
            keccak256(seed + bytes([tag])) for tag in range(4)
        ]
        x0 = int.from_bytes(parts[0] + parts[1], "big") % P
        x1 = int.from_bytes(parts[2] + parts[3], "big") % P
        x: Fp2T = (x0, x1)
        y2 = f2_add(f2_mul(f2_sqr(x), x), B2)
        y = _fp2_sqrt(y2)
        if y is not None:
            # canonical parity choice: lexicographically smaller of (y, -y)
            if (y[1], y[0]) > ((P - y[1]) % P, (P - y[0]) % P):
                y = f2_neg(y)
            pt = g2_mul(H2_COFACTOR, (x, y))
            if pt is not None:
                return pt
        ctr += 1


# -- keys / seals -----------------------------------------------------------


class BLSPrivateKey:
    """BLS secret scalar with its G1 public key."""

    def __init__(self, sk: int):
        if not 0 < sk < R:
            raise ValueError("secret key out of range")
        self.sk = sk
        self.pubkey: PointG1 = g1_mul(sk, G1_GEN)

    @classmethod
    def from_seed(cls, seed: bytes) -> "BLSPrivateKey":
        sk = (
            int.from_bytes(
                keccak256(b"bls-keygen-0" + seed)
                + keccak256(b"bls-keygen-1" + seed),
                "big",
            )
            % (R - 1)
            + 1
        )
        return cls(sk)

    def sign(self, message: bytes) -> PointG2:
        return g2_mul(self.sk, hash_to_g2(message))


def aggregate_signatures(sigs: Sequence[PointG2]) -> PointG2:
    acc: PointG2 = None
    for s in sigs:
        acc = g2_add(acc, s)
    return acc


def aggregate_pubkeys(pks: Sequence[PointG1]) -> PointG1:
    acc: PointG1 = None
    for pk in pks:
        acc = g1_add(acc, pk)
    return acc


def aggregate_verify(
    pubkeys: Sequence[PointG1], message: bytes, signature: PointG2
) -> bool:
    """One-message aggregate verification: e(G1, sig) == e(sum(pk), H2(m))."""
    if signature is None or not pubkeys:
        return False
    pk_agg = aggregate_pubkeys(pubkeys)
    if pk_agg is None:
        return False
    lhs = pairing(signature, G1_GEN)
    rhs = pairing(hash_to_g2(message), pk_agg)
    return lhs == rhs


def verify(pubkey: PointG1, message: bytes, signature: PointG2) -> bool:
    return aggregate_verify([pubkey], message, signature)


# -- proof of possession ----------------------------------------------------
# Aggregation over attacker-chosen pubkeys is rogue-key-attackable: an
# attacker registering pk' = pk_rogue - sum(honest pks) can make the
# AGGREGATE verify for a message no honest party signed.  The standard
# defense (Ristenpart-Yilek; the eth2 "possession" scheme) is to accept a
# public key into the aggregation set only with a signature over the key
# itself under a dedicated domain — producible only by someone holding the
# secret scalar, which a maliciously derived pk' by construction is not.

_POP_DOMAIN = b"go-ibft-bls-pop-v1:"


def pubkey_bytes(pubkey: PointG1) -> bytes:
    """Canonical 96-byte uncompressed encoding of a G1 public key."""
    if pubkey is None:
        raise ValueError("cannot encode the point at infinity as a pubkey")
    x, y = pubkey
    return x.to_bytes(48, "big") + y.to_bytes(48, "big")


def possession_message(pubkey: PointG1) -> bytes:
    """The domain-separated bytes a proof of possession signs.

    Domain separation matters twice over: a PoP must never be confusable
    with a committed seal (seals sign 32-byte proposal hashes; this is
    prefix + 96 bytes), and a seal must never double as a PoP."""
    return _POP_DOMAIN + pubkey_bytes(pubkey)


def prove_possession(key: "BLSPrivateKey") -> PointG2:
    """Sign one's own public key under the PoP domain."""
    return key.sign(possession_message(key.pubkey))


def verify_possession(pubkey: PointG1, proof: PointG2) -> bool:
    """Check that ``proof`` demonstrates knowledge of ``pubkey``'s scalar."""
    if pubkey is None or proof is None:
        return False
    if not g1_on_curve(pubkey) or g1_mul(R, pubkey) is not None:
        return False
    return verify(pubkey, possession_message(pubkey), proof)
