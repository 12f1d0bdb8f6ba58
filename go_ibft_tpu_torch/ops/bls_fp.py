"""Montgomery Fp / Fp2 for BLS12-381 in plain PyTorch (the port of
``go_ibft_tpu/ops/bls_fp.py``).

The port's own layout.  The tensors the kernels and the entry points take
are canonical field elements as 12 little-endian 32-bit words (``int32``
bit views) in the Montgomery domain with ``R = 2**384`` — the CUDA
kernels' form (``csrc/bls12_381.cuh``), not the JAX package's 30 x 13-bit
limbs with ``R = 2**390`` (:mod:`go_ibft_tpu_torch.convert` maps between
the two as integers mod p).  Inside this module an element is an
:class:`FE`: an ``int64`` tensor of 24 limbs of 16 bits, lazily reduced,
with two host-side bounds that every operation keeps exact:

* ``b`` — the represented integer lies in ``[0, b)``;
* ``lb`` — every limb lies in ``[0, lb]``.

A product is one Montgomery multiplication: the column sums of the two
limb vectors (one outer product, summed along its anti-diagonals), then
the parallel REDC ``t = (z + m p) / R`` with ``m = z p' mod R`` taken from
the low columns, and three partial carry rounds.  The carry out of the low
half — a multiple of ``R`` exactly — is read from its top six columns by
rounding, so no sequential carry chain runs per product.  Additions are
lazy; a subtraction adds a multiple of p whose limbs dominate the
subtrahend's (the JAX module's "fat offset"), so no limb goes negative.
Operands whose bounds grow past a product's input range are renormalised
first (a product with one).  Everything is batched over leading axes;
callers stack independent products into one call.

No unsigned dtypes (this torch build has no shifts on them): ``int64``
with masks, and arithmetic right shifts only on non-negative values.
"""

from __future__ import annotations

from typing import Dict, Iterable, Sequence, Tuple

import torch

__all__ = [
    "P",
    "R_MONT",
    "WORDS",
    "L",
    "FE",
    "from_words",
    "to_words",
    "words_of",
    "ints_of",
    "const",
    "add",
    "sub",
    "neg",
    "muli",
    "mul",
    "sqr",
    "renorm",
    "select",
    "stack",
    "take",
    "is_zero",
    "canonical_limbs",
    "inv",
    "pow_fixed",
    "F2",
    "f2_add",
    "f2_sub",
    "f2_neg",
    "f2_conj",
    "f2_mul",
    "f2_sqr",
    "f2_muli",
    "f2_mul_xi",
    "f2_mul_fp",
    "f2_inv",
    "f2_select",
    "f2_is_zero",
]

P = 0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFAAAB
WORDS = 12  # 32-bit words of a field element at the port's boundary
LIMB_BITS = 16
L = 24  # 16-bit limbs inside
MASK = (1 << LIMB_BITS) - 1
R_MONT = 1 << (LIMB_BITS * L)  # 2**384, the kernels' R
_PPRIME = (-pow(P, -1, R_MONT)) % R_MONT  # -p^-1 mod R
ONE_M_INT = R_MONT % P  # one in the Montgomery domain

# Column sums of a product must stay below 2**46: the carry out of the low
# half is then exact when read from its top six columns (see _redc).
_MAX_COLUMN = 1 << 46
# A product's operands are renormalised above these bounds.
_MUL_MAX_VALUE = 16 * P
_MUL_MAX_LIMB = 1 << 20


def _limbs(value: int, n: int = L) -> list:
    return [(value >> (LIMB_BITS * i)) & MASK for i in range(n)]


_consts: Dict[Tuple, torch.Tensor] = {}


def _tensor(key, values: Sequence[int], device: torch.device) -> torch.Tensor:
    """A cached int64 constant on ``device``."""
    k = (key, device)
    t = _consts.get(k)
    if t is None:
        t = torch.tensor(list(values), dtype=torch.int64, device=device)
        _consts[k] = t
    return t


class FE:
    """A batch of field elements: ``t`` is ``(..., 24)`` int64 limbs, ``b``
    and ``lb`` the exact bounds on the value and on every limb."""

    __slots__ = ("t", "b", "lb")

    def __init__(self, t: torch.Tensor, b: int, lb: int):
        self.t = t
        self.b = b
        self.lb = lb

    @property
    def shape(self):
        return self.t.shape[:-1]

    @property
    def device(self):
        return self.t.device

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return f"FE(shape={tuple(self.shape)}, b~2^{self.b.bit_length()}, lb~2^{self.lb.bit_length()})"


# -- the boundary: 12 x 32-bit words <-> 24 x 16-bit limbs --------------------


def from_words(words: torch.Tensor) -> FE:
    """Canonical ``(..., 12)`` int32 words -> an :class:`FE` (the caller
    promises canonical values, below p)."""
    if words.dtype != torch.int32 or words.shape[-1] != WORDS:
        raise ValueError(f"field elements are (..., {WORDS}) int32 words, got {words.dtype} {tuple(words.shape)}")
    w = words.to(torch.int64) & 0xFFFFFFFF
    t = torch.stack([w & MASK, w >> LIMB_BITS], dim=-1).reshape(*w.shape[:-1], L)
    return FE(t, P, MASK)


def to_words(x: FE) -> torch.Tensor:
    """An :class:`FE` -> canonical ``(..., 12)`` int32 words."""
    c = canonical_limbs(x).reshape(*x.shape, WORDS, 2)
    w = c[..., 0] | (c[..., 1] << LIMB_BITS)
    return torch.where(w >= (1 << 31), w - (1 << 32), w).to(torch.int32)


def words_of(values: Iterable[int]) -> list:
    """Host ints (already in the Montgomery domain, below p) -> rows of 12
    words as Python ints in int32 range."""
    out = []
    for v in values:
        row = [(v >> (32 * i)) & 0xFFFFFFFF for i in range(WORDS)]
        out.append([w - (1 << 32) if w >= (1 << 31) else w for w in row])
    return out


def ints_of(words: torch.Tensor) -> list:
    """``(..., 12)`` words -> Python ints (the Montgomery representatives)."""
    rows = words.detach().to("cpu", torch.int64).reshape(-1, WORDS).tolist()
    return [sum((w & 0xFFFFFFFF) << (32 * i) for i, w in enumerate(row)) for row in rows]


def const(values: Sequence[int], device) -> FE:
    """Host ints mod p (plain, not Montgomery) -> an ``(len, 24)`` FE in
    the Montgomery domain (``values`` of one element gives shape ``(24,)``
    when passed as an int)."""
    scalar = isinstance(values, int)
    vals = [values] if scalar else list(values)
    mont = [v % P * R_MONT % P for v in vals]
    t = _tensor(("const", tuple(mont)), [limb for v in mont for limb in _limbs(v)], torch.device(device))
    t = t.reshape(L) if scalar else t.reshape(len(vals), L)
    return FE(t, max(mont) + 1, MASK)


# -- carries --------------------------------------------------------------


def _carry(x: torch.Tensor, rounds: int, keep_top: bool) -> torch.Tensor:
    """Partial carry rounds over the limb axis: each limb keeps its low 16
    bits and passes the rest up one limb.  ``keep_top`` keeps the top
    limb's carry in it; otherwise it is dropped (the value mod R)."""
    for _ in range(rounds):
        hi = x >> LIMB_BITS
        lo = x & MASK
        up = torch.nn.functional.pad(hi[..., :-1], (1, 0))
        x = lo + up
        if keep_top:
            x[..., -1] += hi[..., -1] << LIMB_BITS
    return x


def _conv(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Column sums of the limb product, ``(..., 2L - 1)``: the outer
    product's anti-diagonals, summed after a skew (pad each row to 2L,
    flatten, reshape to rows of 2L - 1)."""
    a, b = torch.broadcast_tensors(a, b)
    n = a.shape[-1]
    lead = a.shape[:-1]
    outer = a.unsqueeze(-1) * b.unsqueeze(-2)
    skew = torch.nn.functional.pad(outer, (0, n)).reshape(*lead, 2 * n * n)
    return skew[..., : n * (2 * n - 1)].reshape(*lead, n, 2 * n - 1).sum(-2)


def _redc(z: torch.Tensor) -> torch.Tensor:
    """``z / R mod p`` for column sums ``z`` (``(..., 2L - 1)``, each in
    ``[0, 2**46)``): ``(z + m p) / R`` with ``m = z p' mod R``, normalised
    by three partial carry rounds."""
    dev = z.device
    pprime = _tensor("pprime", _limbs(_PPRIME), dev)
    plimbs = _tensor("p", _limbs(P), dev)
    zl = _carry(z[..., :L], 3, keep_top=False)
    m = _carry(_conv(zl, pprime)[..., :L], 3, keep_top=False)
    u = torch.nn.functional.pad(z + _conv(m, plimbs), (0, 1))
    # The low half of u is k R exactly, so every partial sum through column
    # j is divisible by 2**(16 (j + 1)): the carry c_j = (u_j + c_{j-1}) /
    # 2**16 is exact, and an estimate of c_{j-1} off by less than 2**15
    # rounds to it.  Six columns down, the estimate u_{L-6} >> 16 is off by
    # at most 2**46 / 2**32.
    c = u[..., L - 6] >> LIMB_BITS
    for j in range(L - 5, L):
        c = (u[..., j] + c + (1 << (LIMB_BITS - 1))) >> LIMB_BITS
    t = u[..., L:].clone()
    t[..., 0] += c
    return _carry(t, 3, keep_top=True)


# -- arithmetic -------------------------------------------------------------


def _fat(bound: int, lb: int) -> Tuple[Tuple[int, ...], int, int]:
    """A multiple of p as limbs, each at least the limb bound of any value
    below ``bound`` with limbs at most ``lb``; returns (limbs, value, max limb)."""
    floors = [min(lb, bound >> (LIMB_BITS * i)) for i in range(L)]
    base = sum(f << (LIMB_BITS * i) for i, f in enumerate(floors))
    value = -(-base // P) * P
    rem = value - base
    limbs = list(floors)
    for i in range(L - 1, -1, -1):
        unit = 1 << (LIMB_BITS * i)
        extra = rem // unit
        limbs[i] += extra
        rem -= extra * unit
    return tuple(limbs), value, max(limbs)


_fat_cache: Dict[Tuple[int, int], Tuple[Tuple[int, ...], int, int]] = {}


def _fat_for(bound: int, lb: int):
    key = (bound, lb)
    hit = _fat_cache.get(key)
    if hit is None:
        hit = _fat(bound, lb)
        _fat_cache[key] = hit
    return hit


def add(a: FE, b: FE) -> FE:
    return FE(a.t + b.t, a.b + b.b, a.lb + b.lb)


def sub(a: FE, b: FE) -> FE:
    limbs, value, top = _fat_for(b.b, b.lb)
    f = _tensor(("fat", limbs), limbs, a.t.device)
    return FE(a.t + f - b.t, a.b + value, a.lb + top)


def neg(a: FE) -> FE:
    limbs, value, top = _fat_for(a.b, a.lb)
    f = _tensor(("fat", limbs), limbs, a.t.device)
    return FE(f - a.t, value, top)


def muli(a: FE, k: int) -> FE:
    return FE(a.t * k, a.b * k, a.lb * k)


def _limbs_ready(a: FE) -> FE:
    """``a`` with its limbs carried down where they grew past a product's
    input range (the value stays)."""
    if a.lb <= _MUL_MAX_LIMB:
        return a
    if a.lb >= _MAX_COLUMN:
        raise AssertionError("limbs out of range")
    return FE(_carry(a.t, 3, keep_top=True), a.b, max(MASK + 1, a.b >> (LIMB_BITS * (L - 1))))


def _mul_ready(a: FE) -> FE:
    a = _limbs_ready(a)
    return renorm(a) if a.b > _MUL_MAX_VALUE else a


def _mont(a: FE, b: FE) -> FE:
    if 24 * a.lb * b.lb + 24 * MASK * MASK >= _MAX_COLUMN:
        raise AssertionError("field product columns out of range: renormalise an operand")
    t = _redc(_conv(a.t, b.t))
    bound = a.b * b.b // R_MONT + P + (P >> 14) + 2
    return FE(t, bound, max(MASK + 1, bound >> (LIMB_BITS * (L - 1))))


def mul(a: FE, b: FE) -> FE:
    """Montgomery product (batched, broadcasting over leading axes)."""
    return _mont(_mul_ready(a), _mul_ready(b))


def sqr(a: FE) -> FE:
    return mul(a, a)


def renorm(a: FE) -> FE:
    """The same element with its bound brought below 2p: products with one
    (each takes the bound b to about b (R mod p) / R + p, R mod p < p / 10)."""
    one = const(1, a.device)
    a = _mont(_limbs_ready(a), one)
    while a.b > 2 * P:
        a = _mont(a, one)
    return a


def select(cond: torch.Tensor, a: FE, b: FE) -> FE:
    """``a`` where ``cond`` (a bool tensor over the leading axes), else ``b``."""
    return FE(torch.where(cond.unsqueeze(-1), a.t, b.t), max(a.b, b.b), max(a.lb, b.lb))


def stack(xs: Sequence[FE], dim: int = -2) -> FE:
    """Stack elements of one shape on a new axis ``dim`` (counted among the
    leading axes, so ``-2`` is just before the limbs)."""
    ts = torch.broadcast_tensors(*[x.t for x in xs])
    return FE(torch.stack(ts, dim=dim), max(x.b for x in xs), max(x.lb for x in xs))


def take(x: FE, i) -> FE:
    """``x[..., i]`` over the last leading axis."""
    return FE(x.t[..., i, :], x.b, x.lb)


def canonical_limbs(x: FE) -> torch.Tensor:
    """Exact canonical limbs in ``[0, 2**16)`` of the value mod p."""
    while x.b > 4 * P:
        x = renorm(x)
    t = _exact(x)
    for k in (2, 1):  # x < 4p: subtract 2p, then p, where they fit
        kp = _tensor(("kp", k), _limbs(k * P), t.device)
        d = t - kp
        cols = []
        borrow = torch.zeros_like(t[..., 0])
        for j in range(L):
            v = d[..., j] - borrow
            cols.append(v & MASK)
            borrow = (v < 0).to(torch.int64)
        t = torch.where((borrow == 0).unsqueeze(-1), torch.stack(cols, dim=-1), t)
    return t


def _exact(x: FE) -> torch.Tensor:
    """The value's exact limbs in ``[0, 2**16)`` (a sequential carry)."""
    cols = []
    c = torch.zeros_like(x.t[..., 0])
    for j in range(L):
        v = x.t[..., j] + c
        cols.append(v & MASK)
        c = v >> LIMB_BITS
    return torch.stack(cols, dim=-1)


def is_zero(x: FE) -> torch.Tensor:
    """``x == 0 mod p``, over the leading axes: the exact limbs equal one of
    the multiples of p below the bound."""
    while x.b > 4 * P:
        x = renorm(x)
    t = _exact(x)
    hit = None
    for k in range(-(-x.b // P)):
        kp = _tensor(("kp", k), _limbs(k * P), t.device)
        eq = (t == kp).all(dim=-1)
        hit = eq if hit is None else hit | eq
    return hit


def pow_fixed(a: FE, exponent: int) -> FE:
    """``a ** exponent`` for a public exponent > 0 (square and multiply)."""
    acc = _mul_ready(a)
    base = acc
    for bit in bin(exponent)[3:]:
        acc = sqr(acc)
        if bit == "1":
            acc = mul(acc, base)
    return acc


def inv(a: FE) -> FE:
    """Fermat inverse; ``inv(0) == 0``, as in the kernels."""
    return pow_fixed(a, P - 2)


# -- Fp2 = Fp[u] / (u^2 + 1) -----------------------------------------------


class F2:
    """An Fp2 batch: ``c0 + c1 u``."""

    __slots__ = ("c0", "c1")

    def __init__(self, c0: FE, c1: FE):
        self.c0 = c0
        self.c1 = c1


def f2_add(a: F2, b: F2) -> F2:
    return F2(add(a.c0, b.c0), add(a.c1, b.c1))


def f2_sub(a: F2, b: F2) -> F2:
    return F2(sub(a.c0, b.c0), sub(a.c1, b.c1))


def f2_neg(a: F2) -> F2:
    return F2(neg(a.c0), neg(a.c1))


def f2_conj(a: F2) -> F2:
    return F2(a.c0, neg(a.c1))


def f2_muli(a: F2, k: int) -> F2:
    return F2(muli(a.c0, k), muli(a.c1, k))


def f2_mul_xi(a: F2) -> F2:
    """Times xi = 1 + u: (c0 - c1) + (c0 + c1) u."""
    return F2(sub(a.c0, a.c1), add(a.c0, a.c1))


def f2_mul(a: F2, b: F2) -> F2:
    """Karatsuba, its three products in one call."""
    t = mul(stack([a.c0, a.c1, add(a.c0, a.c1)]), stack([b.c0, b.c1, add(b.c0, b.c1)]))
    t0, t1, t2 = take(t, 0), take(t, 1), take(t, 2)
    return F2(sub(t0, t1), sub(t2, add(t0, t1)))


def f2_sqr(a: F2) -> F2:
    """(c0 + c1)(c0 - c1) + 2 c0 c1 u, both products in one call."""
    t = mul(stack([add(a.c0, a.c1), a.c0]), stack([sub(a.c0, a.c1), a.c1]))
    return F2(take(t, 0), muli(take(t, 1), 2))


def f2_mul_fp(a: F2, s: FE) -> F2:
    t = mul(stack([a.c0, a.c1]), FE(s.t.unsqueeze(-2), s.b, s.lb))
    return F2(take(t, 0), take(t, 1))


def f2_inv(a: F2) -> F2:
    sq = mul(stack([a.c0, a.c1]), stack([a.c0, a.c1]))
    n = inv(add(take(sq, 0), take(sq, 1)))
    t = mul(stack([a.c0, a.c1]), FE(n.t.unsqueeze(-2), n.b, n.lb))
    return F2(take(t, 0), neg(take(t, 1)))


def f2_select(cond: torch.Tensor, a: F2, b: F2) -> F2:
    return F2(select(cond, a.c0, b.c0), select(cond, a.c1, b.c1))


def f2_is_zero(a: F2) -> torch.Tensor:
    return is_zero(stack([a.c0, a.c1])).all(dim=-1)
