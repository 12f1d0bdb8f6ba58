"""Limbed modular big-integer arithmetic in PyTorch.

The port of ``go_ibft_tpu.ops.fields``.  The limb layout is the JAX
package's, unchanged, so intermediates compare limb for limb: 256-bit field
elements are radix-2**13 limb vectors held in ``int32`` lanes, semi-reduced
(limbs in ``[0, 2**13]``, value in ``[0, 2p)``), with subtraction made
borrow-free by a fat ``K*p`` addend and reduction by a static
pseudo-Mersenne fold schedule derived from Python-int value bounds.

Every op is branch-free and batched by broadcasting over leading axes.  On
the card each op is a handful of small PyTorch kernels; a field ``mul`` is a
few dozen launches.  ``lax.scan`` loops of the original are Python loops
here.  Two PyTorch differences matter: ``torch.sum`` of ``int32`` returns
``int64`` unless ``dtype`` is given (it is, below), and ``>>`` on ``int32``
is an arithmetic shift like ``jnp``'s (the signed GLV combinations in
:mod:`.secp256k1` rely on that floor behaviour).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

LIMB_BITS = 13
LIMB_MASK = (1 << LIMB_BITS) - 1

__all__ = [
    "LIMB_BITS",
    "LIMB_MASK",
    "Modulus",
    "to_limbs",
    "from_limbs",
    "add",
    "sub",
    "mul",
    "sqr",
    "muli",
    "pow_fixed",
    "pow_fixed2",
    "select16",
    "inv",
    "batch_inv",
    "canon",
    "is_zero",
    "is_zero_fast",
    "eq_mod",
    "select",
    "exact_carry",
    "ge_const",
]


def to_limbs(values: Sequence[int], nlimbs: int) -> np.ndarray:
    """Host-side: pack python ints into an ``(N, nlimbs)`` int32 limb array."""
    out = np.zeros((len(values), nlimbs), dtype=np.int32)
    for row, v in enumerate(values):
        if v < 0:
            raise ValueError("limb representation is unsigned")
        for i in range(nlimbs):
            out[row, i] = v & LIMB_MASK
            v >>= LIMB_BITS
        if v:
            raise ValueError(f"value does not fit in {nlimbs} limbs")
    return out


def from_limbs(arr) -> List[int]:
    """Host-side: unpack an ``(..., nlimbs)`` limb array into python ints."""
    if isinstance(arr, torch.Tensor):
        arr = arr.cpu().numpy()
    a = np.asarray(arr, dtype=np.int64)
    flat = a.reshape(-1, a.shape[-1])
    out = []
    for row in flat:
        v = 0
        for i in range(a.shape[-1] - 1, -1, -1):
            v = (v << LIMB_BITS) + int(row[i])
        out.append(v)
    return out


def _single_limbs(value: int, nlimbs: int) -> np.ndarray:
    return to_limbs([value], nlimbs)[0]


def _fat_rep(value: int, nlimbs: int) -> np.ndarray:
    """Limb rep of ``value`` with every limb in [2**13, 3 * 2**13)."""
    lo_floor = LIMB_MASK + 1
    cap = 3 * lo_floor - 1
    rem = value - sum(lo_floor << (LIMB_BITS * i) for i in range(nlimbs))
    if rem < 0:
        raise ValueError("value too small for fat representation")
    out = np.zeros(nlimbs, dtype=np.int32)
    for i in range(nlimbs - 1, -1, -1):
        unit = 1 << (LIMB_BITS * i)
        extra = min(rem // unit, cap - lo_floor)
        out[i] = lo_floor + extra
        rem -= extra * unit
    if rem:
        raise ValueError("fat representation infeasible")
    return out


def device_constant(cache: dict, key, device: torch.device, make) -> torch.Tensor:
    """``make()`` (a numpy array) as a tensor on ``device``, made once per
    key and device: the hot ops upload nothing."""
    hit = cache.get((key, device))
    if hit is None:
        hit = torch.from_numpy(np.asarray(make())).to(device)
        cache[(key, device)] = hit
    return hit


class Modulus:
    """Static per-modulus data: limbs, fold constants, fat K*p rep.

    A copy of the JAX package's class (numpy only), plus :meth:`t` and
    :meth:`value`, its constants as tensors cached per device.
    """

    def __init__(self, p: int):
        if p <= 0:
            raise ValueError("modulus must be positive")
        self.p = p
        self.bits = p.bit_length()
        self.nlimbs = -(-self.bits // LIMB_BITS)
        L = self.nlimbs
        self.limbs = _single_limbs(p, L)
        self.c_fold = (1 << (LIMB_BITS * L)) % p
        self.c_fb = (1 << self.bits) % p  # == 2**bits - p
        if self.c_fb == 0 or 128 * self.c_fb >= p:
            raise ValueError(
                "modulus too far below a power of two for folding; "
                "use the Montgomery path"
            )
        self.c_fold_limbs = _single_limbs(self.c_fold, -(-self.c_fold.bit_length() // LIMB_BITS))
        self.c_fb_limbs = _single_limbs(self.c_fb, -(-max(self.c_fb.bit_length(), 1) // LIMB_BITS))
        self.fb_limb, self.fb_shift = divmod(self.bits, LIMB_BITS)
        k = 3
        while k * p < sum((LIMB_MASK + 1) << (LIMB_BITS * i) for i in range(L)):
            k += 1
        self.fat_kp = _fat_rep(k * p, L)
        self.fat_k = k
        self.sub_bound = 2 * p + k * p  # value bound of a + K p - b
        fbl, fbs = self.fb_limb, self.fb_shift
        self._fb_mask = np.asarray(
            [(1 << fbs) - 1 if i == fbl else LIMB_MASK + 1 for i in range(L)],
            dtype=np.int32,
        )
        self._fb_keep = np.asarray([i < fbl for i in range(L)])
        self._cache: dict = {}

    def const(self, value: int) -> np.ndarray:
        """Limbs of ``value mod p`` as a broadcastable ``(nlimbs,)`` array."""
        return _single_limbs(value % self.p, self.nlimbs)

    def t(self, name: str, device: torch.device) -> torch.Tensor:
        """Named numpy constant (``limbs``, ``fat_kp``, ...) as a tensor."""
        return device_constant(self._cache, name, device, lambda: getattr(self, name))

    def value(self, value: int, device: torch.device) -> torch.Tensor:
        """:meth:`const` as a cached ``(nlimbs,)`` int32 tensor."""
        return device_constant(self._cache, value % self.p, device, lambda: self.const(value))


def _carry(z: torch.Tensor, passes: int) -> torch.Tensor:
    """Lazy parallel carry: each pass moves carries one limb up."""
    for _ in range(passes):
        c = z >> LIMB_BITS
        z = z & LIMB_MASK  # a new tensor, so the in-place add below is safe
        z[..., 1:] += c[..., :-1]
    return z


def _conv(a: torch.Tensor, b: torch.Tensor, out_len: int) -> torch.Tensor:
    """Schoolbook product columns (no carries): ``out[k] = sum_i a_i*b_(k-i)``.

    The JAX package's shear trick, unchanged: one padded outer product,
    re-viewed with rows one element narrower so that row ``i`` shifts right
    by ``i``, then a column sum.  Exact int32 column sums (<= la * 2**26 <
    2**31); the sum is asked for in ``int32`` explicitly.
    """
    la, lb = a.shape[-1], b.shape[-1]
    if out_len < lb - 1:
        raise ValueError(
            f"shear conv requires out_len >= lb - 1 ({out_len} < {lb - 1})"
        )
    w = out_len + la
    outer = a[..., :, None] * b[..., None, :]  # (..., la, lb)
    batch = outer.shape[:-2]
    x = torch.nn.functional.pad(outer, (0, w - lb))
    flat = x.reshape(batch + (la * w,))
    sheared = flat[..., : la * (w - 1)].reshape(batch + (la, w - 1))
    return torch.sum(sheared, dim=-2, dtype=torch.int32)[..., :out_len]


def _pad_to(z: torch.Tensor, n: int) -> torch.Tensor:
    if z.shape[-1] >= n:
        return z
    return torch.nn.functional.pad(z, (0, n - z.shape[-1]))


def _fold_semi(m: Modulus, z: torch.Tensor, bound: int) -> torch.Tensor:
    """Reduce a carried, unsigned limb vector of known value ``bound`` to a
    semi-reduced (< 2p) ``nlimbs`` vector.  Fold schedule is static."""
    L = m.nlimbs
    lw = LIMB_BITS * L
    c_fold = m.t("c_fold_limbs", z.device)
    while bound >= (1 << (lw + 6)):
        lo, hi = z[..., :L], z[..., L:]
        hi_bound = (bound >> lw) + 1
        hi_len = min(hi.shape[-1], -(-hi_bound.bit_length() // LIMB_BITS) + 1)
        hi = hi[..., :hi_len]
        prod_bound = hi_bound * m.c_fold
        out_len = max(L, hi_len + c_fold.shape[-1]) + 1
        prod = _carry(_conv(hi, c_fold, out_len), 4)
        z = _carry(_pad_to(lo, out_len) + prod, 2)
        bound = (1 << lw) + prod_bound
    # Final fold at bit position m.bits: v = lo + hi * 2**bits === lo + hi*c_fb.
    z = _pad_to(z, L + 2)[..., : L + 2]
    fbl, fbs = m.fb_limb, m.fb_shift
    hi = z[..., fbl] >> fbs
    for j in range(fbl + 1, z.shape[-1]):
        hi = hi + (z[..., j] << (LIMB_BITS * (j - fbl) - fbs))
    lo = z[..., :L]
    lo = torch.where(m.t("_fb_keep", z.device), lo, lo & m.t("_fb_mask", z.device))
    prod = hi[..., None] * m.t("c_fb_limbs", z.device)  # < 2**20, int32-safe
    return _carry(lo + _pad_to(prod, L), 3)


def add(m: Modulus, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(a + b) mod-class, semi-reduced output."""
    z = _carry(_pad_to(a + b, m.nlimbs + 1), 2)
    return _fold_semi(m, z, 4 * m.p)


def sub(m: Modulus, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(a - b) mod-class via the borrow-free fat K*p trick."""
    z = _carry(_pad_to(a + m.t("fat_kp", a.device) - b, m.nlimbs + 1), 3)
    return _fold_semi(m, z, m.sub_bound)


def mul(m: Modulus, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(a * b) mod-class: schoolbook conv + static fold schedule."""
    bound = (2 * m.p) ** 2
    out_len = -(-bound.bit_length() // LIMB_BITS) + 1
    z = _carry(_conv(a, b, out_len), 4)
    return _fold_semi(m, z, bound)


def sqr(m: Modulus, a: torch.Tensor) -> torch.Tensor:
    return mul(m, a, a)


def muli(m: Modulus, a: torch.Tensor, k: int) -> torch.Tensor:
    """Multiply by a small constant 1 <= k <= 16."""
    if not 1 <= k <= 16:
        raise ValueError("k out of range")
    z = _carry(_pad_to(a * k, m.nlimbs + 2), 3)
    return _fold_semi(m, z, 2 * m.p * k)


def select(cond: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Branchless limb-vector select; ``cond`` broadcasts over the limb axis."""
    return torch.where(cond[..., None], a, b)


def select16(sel, table: torch.Tensor) -> torch.Tensor:
    """16-way gather: ``table`` is ``(16, ..., L)``, ``sel`` in [0, 16).

    A Python int indexes directly; a tensor gathers over the table axis
    (``torch.gather`` in place of the JAX package's tree of ``where``s —
    the same values, one kernel).  Entry 0 is whatever the caller put there
    (infinity in the ladder's tables, 1 in the power tables).
    """
    if not isinstance(sel, torch.Tensor):
        return table[int(sel)]
    batch = torch.broadcast_shapes(sel.shape, table.shape[1:-1])
    nl = table.shape[-1]
    table = table.expand((16,) + batch + (nl,))
    idx = sel.to(torch.int64).expand(batch)[None, ..., None]
    return torch.gather(table, 0, idx.expand((1,) + batch + (nl,)))[0]


def _pow_digits(exponent: int, nwin: int) -> List[int]:
    return [(exponent >> (4 * j)) & 0xF for j in range(nwin - 1, -1, -1)]


def _pow_table(m: Modulus, a: torch.Tensor) -> torch.Tensor:
    """Window table a^0..a^15 (14 sequential muls)."""
    rows = [m.value(1, a.device).expand(a.shape), a]
    for _ in range(14):
        rows.append(mul(m, rows[-1], a))
    return torch.stack(rows)


def pow_fixed(m: Modulus, a: torch.Tensor, exponent: int) -> torch.Tensor:
    """a**exponent with a fixed public exponent: 4-bit windows, MSB first."""
    if exponent < 0:
        raise ValueError("exponent must be non-negative")
    if exponent == 0:
        return m.value(1, a.device).expand(a.shape)
    nwin = -(-exponent.bit_length() // 4)
    digits = _pow_digits(exponent, nwin)
    table = _pow_table(m, a)
    acc = table[digits[0]]
    for digit in digits[1:]:
        for _ in range(4):
            acc = mul(m, acc, acc)
        acc = mul(m, acc, table[digit])
    return acc


def inv(m: Modulus, a: torch.Tensor) -> torch.Tensor:
    """Modular inverse by Fermat (modulus must be prime); inv(0) == 0."""
    return pow_fixed(m, a, m.p - 2)


def pow_fixed2(
    m1: Modulus,
    a1: torch.Tensor,
    e1: int,
    m2: Modulus,
    a2: torch.Tensor,
    e2: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """TWO independent fixed-exponent powers over one window loop.

    Exponents are padded to a common window count with leading zero digits
    (digit 0 multiplies by table[0] == 1), as in the JAX package, so the
    limbs agree with it exactly.
    """
    if e1 <= 0 or e2 <= 0:
        raise ValueError("pow_fixed2 requires positive exponents")
    nwin = max(-(-e1.bit_length() // 4), -(-e2.bit_length() // 4))
    d1 = _pow_digits(e1, nwin)
    d2 = _pow_digits(e2, nwin)
    t1 = _pow_table(m1, a1)
    t2 = _pow_table(m2, a2)
    acc1, acc2 = t1[d1[0]], t2[d2[0]]
    for g1, g2 in zip(d1[1:], d2[1:]):
        for _ in range(4):
            acc1 = mul(m1, acc1, acc1)
            acc2 = mul(m2, acc2, acc2)
        acc1 = mul(m1, acc1, t1[g1])
        acc2 = mul(m2, acc2, t2[g2])
    return acc1, acc2


def _swap_pairs(x: torch.Tensor) -> torch.Tensor:
    """[x1, x0, x3, x2, ...] along the leading axis."""
    return torch.stack([x[1::2], x[0::2]], dim=1).reshape(x.shape)


def batch_inv(m: Modulus, a: torch.Tensor) -> torch.Tensor:
    """Montgomery product-tree inverse over the LEADING axis.

    One Fermat chain on the root product plus one batched mul per tree
    level each way.  Lanes that are 0 (mod p) are masked to 1 through the
    tree and forced back to 0 on output (``inv(0) == 0``).  The batch is
    padded to a power of two with exact ones, as in the JAX package; its
    fixed-width padded levels only ever multiply ones into lanes past the
    valid prefix, so the shrinking levels here give the same valid limbs.
    """
    n = a.shape[0]
    if n == 1:
        return inv(m, a)
    one = m.value(1, a.device)
    zero = is_zero_fast(m, a)
    base = select(zero, one.expand(a.shape), a)
    if n & (n - 1):  # pad to a power of two with exact ones
        pad = (1 << n.bit_length()) - n
        base = torch.cat([base, one.expand((pad,) + base.shape[1:])])
    levels = [base]
    while levels[-1].shape[0] > 1:
        lvl = levels[-1]
        levels.append(mul(m, lvl[0::2], lvl[1::2]))
    invs = pow_fixed(m, levels[-1], m.p - 2)  # the one Fermat chain
    for lvl in reversed(levels[:-1]):
        invs = mul(m, torch.repeat_interleave(invs, 2, dim=0), _swap_pairs(lvl))
    return select(zero, torch.zeros_like(a), invs[:n])


def _exact_carry(z: torch.Tensor) -> torch.Tensor:
    """Sequential exact carry propagation over the limb axis."""
    carry = torch.zeros_like(z[..., 0])
    out = []
    for i in range(z.shape[-1]):
        t = z[..., i] + carry
        carry = t >> LIMB_BITS
        out.append(t & LIMB_MASK)
    return torch.stack(out, dim=-1)


def _ge_const(a: torch.Tensor, ref: np.ndarray) -> torch.Tensor:
    """a >= ref, both canonical; lexicographic compare from the top."""
    res = torch.zeros(a.shape[:-1], dtype=torch.int32, device=a.device)
    for i in range(a.shape[-1] - 1, -1, -1):
        d = torch.sign(a[..., i] - int(ref[i])).to(torch.int32)
        res = torch.where(res != 0, res, d)
    return res >= 0


def _sub_exact(a: torch.Tensor, ref: np.ndarray) -> torch.Tensor:
    """a - ref for canonical a >= ref: sequential borrow."""
    borrow = torch.zeros_like(a[..., 0])
    out = []
    for i in range(a.shape[-1]):
        t = a[..., i] - int(ref[i]) + borrow
        borrow = t >> LIMB_BITS
        out.append(t - (borrow << LIMB_BITS))
    return torch.stack(out, dim=-1)


def canon(m: Modulus, a: torch.Tensor) -> torch.Tensor:
    """Exact canonical form in [0, p) with limbs < 2**13 (input < 2p)."""
    z = _exact_carry(a)
    ge = _ge_const(z, m.limbs)
    return select(ge, _sub_exact(z, m.limbs), z)


# Public aliases: raw (non-modular) exact carry + lexicographic compare, used
# by curve code for range checks like ``r < n`` on unreduced 256-bit inputs.
exact_carry = _exact_carry
ge_const = _ge_const


def _ks_carry(a: torch.Tensor) -> torch.Tensor:
    """Exact carry for limbs in ``[0, 2**13]`` via Kogge-Stone prefix OR."""
    g0 = a >> LIMB_BITS
    s = a & LIMB_MASK  # a new tensor, so the in-place add below is safe
    s[..., 1:] += g0[..., :-1]
    gen = s >> LIMB_BITS
    prop = (s == LIMB_MASK).to(a.dtype)
    nl = a.shape[-1]
    d = 1
    while d < nl:
        gen = gen | (prop & torch.nn.functional.pad(gen[..., :-d], (d, 0)))
        prop = prop & torch.nn.functional.pad(prop[..., :-d], (d, 0))
        d *= 2
    carry_in = torch.nn.functional.pad(gen[..., :-1], (1, 0))
    return (s + carry_in) & LIMB_MASK


def is_zero_fast(m: Modulus, a: torch.Tensor) -> torch.Tensor:
    """``a === 0 (mod p)`` for semi-reduced ``a`` (< 2p): value 0 or p."""
    c = _ks_carry(a)
    return torch.all(c == 0, dim=-1) | torch.all(c == m.t("limbs", a.device), dim=-1)


def is_zero(m: Modulus, a: torch.Tensor) -> torch.Tensor:
    return torch.all(canon(m, a) == 0, dim=-1)


def eq_mod(m: Modulus, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return is_zero(m, sub(m, a, b))
