"""secp256k1 curve arithmetic and batched ECDSA recovery in PyTorch.

The port of ``go_ibft_tpu.ops.secp256k1`` (the JAX program behind the
engine's ``IsValidValidator`` / ``IsValidCommittedSeal`` predicates).  Same
algorithms, same limb values:

* field elements are radix-2**13 limb vectors (:mod:`.fields`), batched over
  leading axes; every op is branch-free, exceptional cases resolved with
  selects;
* points are Jacobian ``(X, Y, Z)``, infinity is ``Z == 0``;
* ``k1*G + k2*Q`` is the GLV ladder: both scalars split into signed
  half-scalars, four 4-bit digit streams over 33 windows, four accumulator
  lanes (4 doublings + one complete add per window), combined at the end.

Each ``lax.scan`` of the original is a Python loop over PyTorch ops here,
so one batch of these ops is on the order of 10**5 small kernels whatever
the batch size.  That is the plain version: on a CUDA tensor
:func:`ecdsa_recover` launches the hand-written recovery kernel
(:mod:`.ecrecover`, ``csrc/secp256k1_recover.cu``) instead, and a CPU tensor
takes :func:`ecdsa_recover_plain`.  :func:`ecmul2_base` and
:func:`ecdsa_verify` do the same with the second kernel of that file
(:mod:`.ecverify`), their plain versions being :func:`ecmul2_base_plain` and
:func:`ecdsa_verify_plain`.  The plain versions call one another, never a
dispatching name, so a plain path on the card launches no kernel.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from ..crypto import ecdsa as _host
from . import fields
from .fields import LIMB_BITS, LIMB_MASK, Modulus

__all__ = [
    "P",
    "N",
    "GX",
    "GY",
    "FIELD",
    "ORDER",
    "JacobianPoint",
    "point_infinity",
    "point_double",
    "point_add",
    "to_affine",
    "is_infinity",
    "ecmul2_base",
    "ecmul2_base_plain",
    "glv_split",
    "ecdsa_verify",
    "ecdsa_verify_plain",
    "ecdsa_recover",
    "ecdsa_recover_plain",
]

# Curve constants (SEC 2 v2, "Recommended Parameters secp256k1").
P = _host.P
N = _host.N
GX = _host.GX
GY = _host.GY

FIELD = Modulus(P)
ORDER = Modulus(N)
_L = FIELD.nlimbs  # == ORDER.nlimbs == 20


class JacobianPoint(NamedTuple):
    """Batched Jacobian point; each coordinate is an ``(..., 20)`` limb tensor."""

    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor


def point_infinity(batch_shape: Tuple[int, ...], device) -> JacobianPoint:
    one = FIELD.value(1, device).expand(tuple(batch_shape) + (_L,))
    zero = torch.zeros(tuple(batch_shape) + (_L,), dtype=torch.int32, device=device)
    return JacobianPoint(one, one, zero)


def is_infinity(p: JacobianPoint) -> torch.Tensor:
    return fields.is_zero_fast(FIELD, p.z)


def _sel_pt(cond: torch.Tensor, a: JacobianPoint, b: JacobianPoint) -> JacobianPoint:
    return JacobianPoint(
        fields.select(cond, a.x, b.x),
        fields.select(cond, a.y, b.y),
        fields.select(cond, a.z, b.z),
    )


def point_double(p: JacobianPoint) -> JacobianPoint:
    """Jacobian doubling, a = 0 case ("dbl-2009-l" shape); infinity-safe."""
    f = FIELD
    a = fields.sqr(f, p.x)
    b = fields.sqr(f, p.y)
    c = fields.sqr(f, b)
    t = fields.sqr(f, fields.add(f, p.x, b))
    d = fields.muli(f, fields.sub(f, fields.sub(f, t, a), c), 2)
    e = fields.muli(f, a, 3)
    ff = fields.sqr(f, e)
    x3 = fields.sub(f, ff, fields.muli(f, d, 2))
    y3 = fields.sub(f, fields.mul(f, e, fields.sub(f, d, x3)), fields.muli(f, c, 8))
    z3 = fields.muli(f, fields.mul(f, p.y, p.z), 2)
    return JacobianPoint(x3, y3, z3)


def point_add(p: JacobianPoint, q: JacobianPoint) -> JacobianPoint:
    """Complete Jacobian addition via branchless selects (infinity operands,
    P == Q falls back to doubling, P == -Q gives infinity)."""
    f = FIELD
    z1s = fields.sqr(f, p.z)
    z2s = fields.sqr(f, q.z)
    u1 = fields.mul(f, p.x, z2s)
    u2 = fields.mul(f, q.x, z1s)
    s1 = fields.mul(f, p.y, fields.mul(f, z2s, q.z))
    s2 = fields.mul(f, q.y, fields.mul(f, z1s, p.z))
    h = fields.sub(f, u2, u1)
    r = fields.sub(f, s2, s1)
    hs = fields.sqr(f, h)
    hc = fields.mul(f, hs, h)
    u1hs = fields.mul(f, u1, hs)
    x3 = fields.sub(f, fields.sub(f, fields.sqr(f, r), hc), fields.muli(f, u1hs, 2))
    y3 = fields.sub(f, fields.mul(f, r, fields.sub(f, u1hs, x3)), fields.mul(f, s1, hc))
    z3 = fields.mul(f, fields.mul(f, p.z, q.z), h)
    generic = JacobianPoint(x3, y3, z3)

    same_x = fields.is_zero_fast(f, h)
    same_y = fields.is_zero_fast(f, r)
    out = _sel_pt(same_x & same_y, point_double(p), generic)
    out = _sel_pt(is_infinity(p), q, out)
    out = _sel_pt(is_infinity(q), p, out)
    return out


def _inv_lanes(m: Modulus, a: torch.Tensor) -> torch.Tensor:
    """Product-tree inverse over a single batch axis, else per-lane Fermat."""
    if a.dim() == 2 and a.shape[0] >= 2:
        return fields.batch_inv(m, a)
    return fields.inv(m, a)


def to_affine(p: JacobianPoint) -> Tuple[torch.Tensor, torch.Tensor]:
    """Canonical affine ``(x, y)``; infinity maps to ``(0, 0)``."""
    f = FIELD
    zinv = _inv_lanes(f, p.z)
    zi2 = fields.sqr(f, zinv)
    x = fields.mul(f, p.x, zi2)
    y = fields.mul(f, p.y, fields.mul(f, zi2, zinv))
    return fields.canon(f, x), fields.canon(f, y)


def point_add_mixed(p: JacobianPoint, qx: torch.Tensor, qy: torch.Tensor) -> JacobianPoint:
    """Complete mixed addition (affine addend, Z2 == 1)."""
    f = FIELD
    z1s = fields.sqr(f, p.z)
    u2 = fields.mul(f, qx, z1s)
    s2 = fields.mul(f, qy, fields.mul(f, z1s, p.z))
    h = fields.sub(f, u2, p.x)
    r = fields.sub(f, s2, p.y)
    hs = fields.sqr(f, h)
    hc = fields.mul(f, hs, h)
    u1hs = fields.mul(f, p.x, hs)
    x3 = fields.sub(f, fields.sub(f, fields.sqr(f, r), hc), fields.muli(f, u1hs, 2))
    y3 = fields.sub(f, fields.mul(f, r, fields.sub(f, u1hs, x3)), fields.mul(f, p.y, hc))
    z3 = fields.mul(f, p.z, h)
    generic = JacobianPoint(x3, y3, z3)

    same_x = fields.is_zero_fast(f, h)
    same_y = fields.is_zero_fast(f, r)
    out = _sel_pt(same_x & same_y, point_double(p), generic)
    one = f.value(1, p.z.device).expand(p.z.shape)
    return _sel_pt(is_infinity(p), JacobianPoint(qx, qy, one), out)


def _double4(p: JacobianPoint) -> JacobianPoint:
    for _ in range(4):
        p = point_double(p)
    return p


# ---------------------------------------------------------------------------
# GLV endomorphism: phi(x, y) = (BETA*x, y) acts as multiplication by LAMBDA.
# Constants as in the JAX package (extended Euclid on (N, LAMBDA)).
# ---------------------------------------------------------------------------
_LAMBDA = 0x5363AD4CC05C30E0A5261C028812645A122E22EA20816678DF02967C1B23BD72
_BETA = 0x7AE96A2B657C07106E64479EAC3434E99CF0497512F58995C1396C28719501EE
_GLV_A1 = 0x3086D221A7D46BCDE86C90E49284EB15
_GLV_B1 = -0xE4437ED6010E88286F547FA90ABFE4C3
_GLV_A2 = 0x114CA50F7A8E2F3F657C1108D9D44CFD8
_GLV_B2 = 0x3086D221A7D46BCDE86C90E49284EB15
_GLV_SHIFT = 384
_GLV_G1 = (_GLV_B2 * (1 << _GLV_SHIFT) + N // 2) // N
_GLV_G2 = (-_GLV_B1 * (1 << _GLV_SHIFT) + N // 2) // N

if not (
    pow(_LAMBDA, 3, N) == 1
    and pow(_BETA, 3, P) == 1
    and (_GLV_A1 + _GLV_B1 * _LAMBDA) % N == 0
    and (_GLV_A2 + _GLV_B2 * _LAMBDA) % N == 0
):
    raise ImportError("inconsistent GLV constants")

_GLV_HL = 11  # half-scalar limb count: 143 bits >= 129-bit magnitude + sign
_GLV_NWIN = 33  # 4-bit windows covering 132 bits
_GLV_PROD_LEN = 41  # k*G fits 512 bits; + the 2**383 rounding addend
_GLV_ROUND = np.zeros(_GLV_PROD_LEN, dtype=np.int32)
_GLV_ROUND[_GLV_SHIFT // LIMB_BITS] = 1 << (_GLV_SHIFT % LIMB_BITS - 1)


class _Consts:
    """Numpy constants of the ladder, cached as tensors per device."""

    def __init__(self):
        self.glv_g1 = fields.to_limbs([_GLV_G1], _L)[0]
        self.glv_g2 = fields.to_limbs([_GLV_G2], _L)[0]
        self.glv_a1 = fields.to_limbs([_GLV_A1], _GLV_HL)[0]
        self.glv_a2 = fields.to_limbs([_GLV_A2], _GLV_HL)[0]
        self.glv_nb1 = fields.to_limbs([-_GLV_B1], _GLV_HL)[0]
        self.glv_b2 = fields.to_limbs([_GLV_B2], _GLV_HL)[0]
        self.glv_round = _GLV_ROUND
        self.g_tab_x, self.g_tab_y = _precompute_g_table()
        self.gp_tab_x = _precompute_glv_g_table(self.g_tab_x)
        pos = np.arange(_GLV_NWIN - 1, -1, -1) * 4  # MSB-first window bit positions
        limb = pos // LIMB_BITS
        off = pos % LIMB_BITS
        self.nib_limb = limb.astype(np.int64)
        self.nib_off = off.astype(np.int32)
        self.nib_hi = np.minimum(limb + 1, _GLV_HL - 1).astype(np.int64)
        self.nib_hi_shift = (LIMB_BITS - off).astype(np.int32)
        self.nib_needhi = (off > LIMB_BITS - 4).astype(np.int32)
        self._cache: dict = {}

    def __call__(self, name: str, device) -> torch.Tensor:
        return fields.device_constant(self._cache, name, device, lambda: getattr(self, name))


def _precompute_g_table() -> Tuple[np.ndarray, np.ndarray]:
    """Fixed-base window table: entry [d] = d * G, affine, d in 1..15 (not
    pre-scaled by 16**j: the ladder's shared doublings supply that)."""
    gx_tab = np.zeros((16, _L), dtype=np.int32)
    gy_tab = np.zeros((16, _L), dtype=np.int32)
    pt = None
    for d in range(1, 16):
        pt = _host._add(pt, (GX, GY))
        gx_tab[d] = fields.to_limbs([pt[0]], _L)[0]
        gy_tab[d] = fields.to_limbs([pt[1]], _L)[0]
    return gx_tab, gy_tab


def _precompute_glv_g_table(g_tab_x: np.ndarray) -> np.ndarray:
    """The ``d*phi(G)`` table: the ``d*G`` table with x scaled by BETA."""
    gpx = np.zeros((16, _L), dtype=np.int32)
    xs = fields.from_limbs(g_tab_x)
    for d in range(1, 16):
        gpx[d] = fields.to_limbs([(_BETA * xs[d]) % P], _L)[0]
    return gpx


_C = _Consts()


def _glv_round_shift(k: torch.Tensor, g_name: str) -> torch.Tensor:
    """``round((k * g) / 2**384)`` exactly, as an ``(..., 11)`` limb vector."""
    z = fields._conv(k, _C(g_name, k.device), _GLV_PROD_LEN)
    z = z + _C("glv_round", k.device)
    z = fields._carry(z, 4)
    z = fields._ks_carry(z)
    base = _GLV_SHIFT // LIMB_BITS  # 29, shift-within-limb 7
    lo = z[..., base : base + _GLV_HL] >> 7
    hi = (z[..., base + 1 : base + 1 + _GLV_HL] << 6) & LIMB_MASK
    return lo | hi


def _q_window_table(qx: torch.Tensor, qy: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """Per-batch window table ``T[d] = d*Q`` (Jacobian; T[0] = infinity),
    stacked as ``(16, ..., L)`` coordinate tensors."""
    batch = qx.shape[:-1]
    one = FIELD.value(1, qx.device).expand(qx.shape)
    inf = point_infinity(batch, qx.device)
    rows = [inf, JacobianPoint(qx, qy, one)]
    for _ in range(14):  # 2Q .. 15Q
        rows.append(point_add_mixed(rows[-1], qx, qy))
    return tuple(torch.stack([getattr(p, c) for p in rows]) for c in "xyz")


def _conv_lo(a: torch.Tensor, name: str, n: int) -> torch.Tensor:
    """Low ``n`` limb-columns of the schoolbook product (mod 2**(13n))."""
    return fields._conv(a, _C(name, a.device), n)


def _glv_neg143(r: torch.Tensor) -> torch.Tensor:
    """``2**143 - r`` for ``0 < r < 2**143`` in 11 canonical limbs."""
    flipped = LIMB_MASK - r
    flipped = torch.cat([flipped[..., :1] + 1, flipped[..., 1:]], dim=-1)
    return fields._exact_carry(flipped)


def glv_split(k: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Decompose canonical ``k < N`` into ``k === s1*|k1| + s2*|k2|*LAMBDA``.

    Returns ``(abs1, neg1, abs2, neg2)``: magnitudes as ``(..., 11)`` limb
    vectors < 2**129 and sign flags (True = negative), exact: the signed
    combinations are evaluated mod 2**143 and the sign read off bit 142.
    """
    c1 = _glv_round_shift(k, "glv_g1")
    c2 = _glv_round_shift(k, "glv_g2")

    def signed(parts):
        s = parts[0]
        for term in parts[1:]:
            s = s + term
        r = fields._exact_carry(s)  # >> and & floor correctly on negatives
        neg = (r[..., _GLV_HL - 1] >> 12) == 1
        return fields.select(neg, _glv_neg143(r), r), neg

    t1 = _conv_lo(c1, "glv_a1", _GLV_HL)
    t2 = _conv_lo(c2, "glv_a2", _GLV_HL)
    abs1, neg1 = signed([k[..., :_GLV_HL], -t1, -t2])  # k - c1*a1 - c2*a2
    u1 = _conv_lo(c1, "glv_nb1", _GLV_HL)
    u2 = _conv_lo(c2, "glv_b2", _GLV_HL)
    abs2, neg2 = signed([u1, -u2])  # -c1*b1 - c2*b2
    return abs1, neg1, abs2, neg2


def _glv_nibbles_msb(k: torch.Tensor) -> torch.Tensor:
    """4-bit windows of an 11-limb magnitude, MSB first: ``(33,) + batch``."""
    dev = k.device
    lo = k[..., _C("nib_limb", dev)] >> _C("nib_off", dev)
    hi = k[..., _C("nib_hi", dev)] << _C("nib_hi_shift", dev)
    nib = (lo | hi * _C("nib_needhi", dev)) & 0xF
    return nib.movedim(-1, 0)


def ecmul2_base(
    k1: torch.Tensor, k2: torch.Tensor, qx: torch.Tensor, qy: torch.Tensor
) -> JacobianPoint:
    """``k1*G + k2*Q``: semi-reduced scalars (below 2N), ``Q`` affine.

    A CUDA tensor launches the kernel (:func:`.ecverify.ecmul2`, counted in
    ``ecverify.ecmul2.launches``), which takes the four arguments at one
    batch shape, contiguous, and raises otherwise; its result is canonical
    limbs, equal to the plain version's as a projective point.  A CPU
    tensor takes :func:`ecmul2_base_plain`, which broadcasts.
    """
    if qx.device.type == "cuda":
        from . import ecverify  # imports this module

        return ecverify.ecmul2(k1, k2, qx, qy)
    if qx.device.type != "cpu":
        raise ValueError(f"ecmul2_base runs on cuda or cpu, not {qx.device}")
    return ecmul2_base_plain(k1, k2, qx, qy)


def ecmul2_base_plain(
    k1: torch.Tensor, k2: torch.Tensor, qx: torch.Tensor, qy: torch.Tensor
) -> JacobianPoint:
    """GLV double-scalar multiply: ``k1*G + k2*Q`` in a 33-window ladder.

    Four digit streams (|a|*G, |b|*phi(G), and likewise for Q) accumulate
    into four independent lanes of one ``(4,) + batch`` Jacobian point; a
    window is 4 batched doublings plus one batched complete add over the
    stacked ``(16, 4, ...)`` tables (entry 0 is infinity, so zero digits
    need no select).  Signs are applied at gather time by negating y.
    ``k1``/``k2`` are semi-reduced scalars mod N; ``qx``/``qy`` affine.
    """
    dev = qx.device
    batch = torch.broadcast_shapes(k1.shape[:-1], k2.shape[:-1], qx.shape[:-1])
    qx = qx.expand(batch + (_L,))
    qy = qy.expand(batch + (_L,))
    qtx, qty, qtz = _q_window_table(qx, qy)  # (16, ..., L)
    qptx = fields.mul(FIELD, qtx, FIELD.value(_BETA, dev))

    a1, s1, a2, s2 = glv_split(fields.canon(ORDER, k1))  # G half-scalars
    b1, t1, b2, t2 = glv_split(fields.canon(ORDER, k2))  # Q half-scalars
    digits = torch.stack(
        [_glv_nibbles_msb(a).expand((_GLV_NWIN,) + batch) for a in (a1, a2, b1, b2)],
        dim=1,
    )  # (33, 4) + batch

    nb = len(batch)

    def bc(name):  # (16, L) constant -> (16,) + batch + (L,)
        tab = _C(name, dev)
        return tab.view((16,) + (1,) * nb + (_L,)).expand((16,) + batch + (_L,))

    ones = FIELD.value(1, dev).expand(batch + (_L,))
    g_z = torch.cat([torch.zeros_like(ones)[None], ones.expand((15,) + batch + (_L,))])
    tx = torch.stack([bc("g_tab_x"), bc("gp_tab_x"), qtx, qptx], dim=1)
    ty = torch.stack([bc("g_tab_y"), bc("g_tab_y"), qty, qty], dim=1)
    tz = torch.stack([g_z, g_z, qtz, qtz], dim=1)
    neg = torch.stack([s1, s2, t1, t2], dim=0)  # (4,) + batch

    acc = point_infinity((4,) + batch, dev)
    for w in range(_GLV_NWIN):
        d = digits[w]
        acc = _double4(acc)
        y = fields.select16(d, ty)
        y = fields.select(neg, fields.sub(FIELD, torch.zeros_like(y), y), y)
        acc = point_add(acc, JacobianPoint(fields.select16(d, tx), y, fields.select16(d, tz)))
    # Combine the four lanes: (0 + 1) and (2 + 3), then the two halves.
    half = point_add(
        JacobianPoint(acc.x[0::2], acc.y[0::2], acc.z[0::2]),
        JacobianPoint(acc.x[1::2], acc.y[1::2], acc.z[1::2]),
    )
    out = point_add(
        JacobianPoint(half.x[0], half.y[0], half.z[0]),
        JacobianPoint(half.x[1], half.y[1], half.z[1]),
    )
    return out


def _in_scalar_range(v: torch.Tensor) -> torch.Tensor:
    """``0 < v < N`` for a raw (possibly unreduced 256-bit) limb vector."""
    c = fields.exact_carry(v)
    nonzero = torch.any(c != 0, dim=-1)
    below = ~fields.ge_const(c, ORDER.limbs)
    return nonzero & below


# N mod P as a field constant, and the canonical limbs of P - N, for the
# "second solution" branch of the x == r (mod N) check in verify.
_P_MINUS_N = fields.to_limbs([P - N], _L)[0]


def ecdsa_verify(
    qx: torch.Tensor, qy: torch.Tensor, z: torch.Tensor, r: torch.Tensor, s: torch.Tensor
) -> torch.Tensor:
    """Batched ECDSA verification; returns a boolean mask.

    Affine public key ``(qx, qy)``, digest-as-scalar ``z`` (reduced mod N),
    and signature ``(r, s)`` as raw 256-bit values (range-checked here).
    ``Q`` is not checked to be on the curve.  A CUDA tensor launches the
    kernel (:func:`.ecverify.verify`, counted in
    ``ecverify.verify.launches``; one batch shape, contiguous); a CPU
    tensor takes :func:`ecdsa_verify_plain`.
    """
    if qx.device.type == "cuda":
        from . import ecverify  # imports this module

        return ecverify.verify(qx, qy, z, r, s)
    if qx.device.type != "cpu":
        raise ValueError(f"ecdsa_verify runs on cuda or cpu, not {qx.device}")
    return ecdsa_verify_plain(qx, qy, z, r, s)


def ecdsa_verify_plain(
    qx: torch.Tensor, qy: torch.Tensor, z: torch.Tensor, r: torch.Tensor, s: torch.Tensor
) -> torch.Tensor:
    """:func:`ecdsa_verify` in PyTorch ops on any device, as in the JAX
    package: the range checks, ``w = s^-1``, ``u1 = z*w``, ``u2 = r*w``, the
    GLV ladder, then ``x == r`` or ``x == r + N`` (where ``r < P - N``)."""
    ok_range = _in_scalar_range(r) & _in_scalar_range(s)
    w = _inv_lanes(ORDER, s)
    u1 = fields.mul(ORDER, z, w)
    u2 = fields.mul(ORDER, r, w)
    pt = ecmul2_base_plain(u1, u2, qx, qy)
    not_inf = ~is_infinity(pt)
    zinv = _inv_lanes(FIELD, pt.z)
    x_aff = fields.mul(FIELD, pt.x, fields.sqr(FIELD, zinv))
    r_canon = fields.canon(ORDER, r)
    eq1 = fields.eq_mod(FIELD, x_aff, r_canon)
    r_small = ~fields.ge_const(r_canon, _P_MINUS_N)
    eq2 = fields.eq_mod(FIELD, x_aff, fields.add(FIELD, r_canon, FIELD.value(N, r.device)))
    return ok_range & not_inf & (eq1 | (r_small & eq2))


# (P + 1) // 4: square-root exponent for P === 3 (mod 4).
_SQRT_EXP = (P + 1) // 4


def ecdsa_recover(
    z: torch.Tensor, r: torch.Tensor, s: torch.Tensor, v: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Batched public-key recovery (Ethereum-style ecrecover).

    ``z`` is the digest as a scalar (``(..., 20)`` canonical limbs, taken
    mod N), ``r``, ``s`` raw 20-limb values (range-checked here), ``v`` the
    recovery id (0 or 1; ids 2/3 are rejected).  Returns ``(x, y, ok)`` with
    canonical affine coordinates; lanes with ``ok == False`` have unspecified
    coordinates.  A CUDA tensor launches the recovery kernel (counted in
    ``ecrecover.recover.launches``); a CPU tensor takes
    :func:`ecdsa_recover_plain`.
    """
    if v.device.type == "cuda":
        from . import ecrecover  # imports this module

        x, y, _, ok = ecrecover.recover(z, r, s, v)
        return x, y, ok
    if v.device.type != "cpu":
        raise ValueError(f"ecdsa_recover runs on cuda or cpu, not {v.device}")
    return ecdsa_recover_plain(z, r, s, v)


def ecdsa_recover_plain(
    z: torch.Tensor, r: torch.Tensor, s: torch.Tensor, v: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """:func:`ecdsa_recover` in PyTorch ops on any device: range checks, the
    merged square-root / ``r^-1`` window chain, the GLV ladder and a batch
    inversion, as in the JAX package."""
    ok = _in_scalar_range(r) & _in_scalar_range(s)
    ok = ok & ((v == 0) | (v == 1))

    f = FIELD
    x = fields.canon(ORDER, r)  # r < N < P: also a canonical field element
    y2 = fields.add(f, fields.mul(f, fields.sqr(f, x), x), f.value(7, x.device))
    # The square root mod P and r^-1 mod N share one window loop.
    y, rinv = fields.pow_fixed2(f, y2, _SQRT_EXP, ORDER, x, N - 2)
    ok = ok & fields.eq_mod(f, fields.sqr(f, y), y2)  # r was a valid x-coord
    y_canon = fields.canon(f, y)
    parity = y_canon[..., 0] & 1
    y_neg = fields.canon(f, fields.sub(f, torch.zeros_like(y_canon), y_canon))
    y_sel = fields.select(parity == v.to(torch.int32), y_canon, y_neg)

    # Q = r^-1 * (s*R - z*G)  ==  (-z * r^-1)*G + (s * r^-1)*R
    u1 = fields.mul(ORDER, fields.sub(ORDER, torch.zeros_like(z), z), rinv)
    u2 = fields.mul(ORDER, s, rinv)
    q = ecmul2_base_plain(u1, u2, x, y_sel)
    ok = ok & ~is_infinity(q)
    qx, qy = to_affine(q)
    return qx, qy, ok
