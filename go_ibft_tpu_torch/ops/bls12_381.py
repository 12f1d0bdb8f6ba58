"""BLS12-381 aggregate verification in plain PyTorch, and the entry points
that run it on the card (the port of ``go_ibft_tpu/ops/bls12_381.py``).

BASELINE.md config #4: one pairing equation certifies a whole quorum of
COMMIT seals, ``e(G1, sum(sig_i)) == e(sum(pk_i), H2(m))``, checked as
``final_exp(e(G1, S) * e(-PK, H)) == 1``.  Three device programs carry it,
each a hand-written CUDA kernel on the card (``csrc/bls12_381.cu``, bound in
:mod:`go_ibft_tpu_torch.ops.bls_kernels`) with its plain PyTorch version
here, which the CPU route and the tests run:

* :func:`merge_plain` — the masked sum of each group's G1 or G2 points, in
  canonical affine coordinates (y optionally negated) with an infinity flag
  (the JAX package's ``_aggregate_stage``, ``g1_merge_tree``,
  ``g2_merge_tree`` and ``_multi_g1_neg_aggregate_stage``);
* :func:`miller_plain` — per lane, the Miller loops of ``(S_i, G1)`` and
  ``(H_i, -PK_i)`` and their Fp12 product (``_miller_product_stage``,
  ``_multi_miller_stage``);
* :func:`final_exp_plain` — per lane, ``f^(3 (p^12 - 1) / r) == 1`` gated
  on a flag, and the Fp12 result (``_easy_part_stage``,
  ``_hard_part_stage``, ``_finish_stage``, ``f12_eq_one``).

Each plain version computes what its kernel computes, in the same order
where the order shows in the result.  The merge's order does not show: its
output is the sum's canonical affine point, the same in any order and in
any coordinates, so the plain version keeps its own (it folds points ``t,
t + 128, ...`` per "thread", then sums 128 partial sums in a halving tree
of Jacobian additions) while the kernel adds compacted live points in
projective coordinates level by level; the Miller loop uses the
JAX package's Jacobian doubling and line formulas, whose scalings make its
value the same Fp12 element in all three implementations.  The final
exponentiation computes the pairing *cubed*: compare it with the host
oracle as ``final_exp(f) == pairing ** 3``.

Tensors at this module's boundary are the port's layout
(:mod:`go_ibft_tpu_torch.ops.bls_fp`): canonical field elements as
``(..., 12)`` int32 words in the Montgomery domain (R = 2**384); a G1
point is ``(..., 2, 12)`` (x, y), a G2 point ``(..., 4, 12)`` (x0, x1, y0,
y1), an Fp12 element ``(..., 12, 12)`` in the tower's order (c0.c0.c0,
c0.c0.c1, c0.c1.c0, ..., c1.c2.c1).  The point at infinity packs as zeros
and rides a dead lane.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from ..crypto import bls as host
from . import bls_fp as fp
from .bls_fp import F2, FE

__all__ = [
    "BLS_X",
    "MERGE_THREADS",
    "merge_plain",
    "miller_plain",
    "final_exp_plain",
    "f12_mul",
    "f12_inv",
    "f12_frob",
    "f12_conj",
    "pack_g1_points",
    "pack_g2_points",
    "unpack_g1_points",
    "unpack_g2_points",
    "pack_f12",
    "unpack_f12",
    "g1_merge_tree",
    "g2_merge_tree",
    "aggregate_verify_commit",
    "multi_pairing_check",
]

BLS_X = host.BLS_X  # |x|; the parameter is negative
MERGE_THREADS = 128  # merge_plain's fold order (its own: the sum does not depend on order)
_X_BITS = [int(b) for b in bin(BLS_X)[3:]]  # MSB first, the leading 1 skipped

# -- Fp12 as 12 stacked field elements --------------------------------------
# An Fp12 batch is one FE of shape (..., 12, 24), its components in the
# tower's order: k = 6 i + 2 j + l for c{i}.c{j}.c{l}.  Products run as ONE
# batched Montgomery multiplication of the 54 Karatsuba products, whose
# operand sums and output combination are read off the host oracle's own
# formulas (crypto/bls.py f12_mul, f6_mul) run on symbolic linear forms.


class _Sym:
    """A linear form over input components ('a', i), ('b', i) or products
    ('p', k), with integer coefficients; `*` of an a-form and a b-form
    records a product."""

    products: List[Tuple[Dict, Dict]] = []

    def __init__(self, terms: Dict):
        self.terms = terms

    def _combine(self, other, sign: int) -> "_Sym":
        out = dict(self.terms)
        for k, v in other.terms.items():
            out[k] = out.get(k, 0) + sign * v
            if out[k] == 0:
                del out[k]
        return _Sym(out)

    def __add__(self, other):
        return self._combine(other, 1)

    def __sub__(self, other):
        return self._combine(other, -1)

    def __neg__(self):
        return _Sym({k: -v for k, v in self.terms.items()})

    def __mod__(self, _modulus):
        return self

    def __mul__(self, other):
        if isinstance(other, int):
            return _Sym({k: v * other for k, v in self.terms.items()})
        _Sym.products.append((self.terms, other.terms))
        return _Sym({("p", len(_Sym.products) - 1): 1})

    __rmul__ = __mul__


def _bilinear(fn, n: int, shape):
    """Run ``fn`` (a host tower product) on symbolic operands of ``n``
    components; returns (A, B, OUT): the products' operand combinations
    (K x n, non-negative) and the output combination (n x K)."""
    _Sym.products = []

    def operand(side):
        comps = [_Sym({(side, i): 1}) for i in range(n)]
        return shape(comps)

    out = fn(operand("a"), operand("b"))
    flat = []

    def walk(x):
        if isinstance(x, _Sym):
            flat.append(x)
        else:
            for y in x:
                walk(y)

    walk(out)
    prods = _Sym.products
    k = len(prods)
    a = np.zeros((k, n), np.int64)
    b = np.zeros((k, n), np.int64)
    for i, (ta, tb) in enumerate(prods):
        for (side, j), v in ta.items():
            assert side == "a" and v > 0
            a[i, j] = v
        for (side, j), v in tb.items():
            assert side == "b" and v > 0
            b[i, j] = v
    o = np.zeros((n, k), np.int64)
    for r, form in enumerate(flat):
        for (side, j), v in form.terms.items():
            assert side == "p"
            o[r, j] = v
    return a, b, o


def _shape12(c):
    return tuple(tuple((c[6 * i + 2 * j], c[6 * i + 2 * j + 1]) for j in range(3)) for i in range(2))


def _shape6(c):
    return tuple((c[2 * j], c[2 * j + 1]) for j in range(3))


_F12_FORMS = _bilinear(host.f12_mul, 12, _shape12)
_F6_FORMS = _bilinear(host.f6_mul, 6, _shape6)
_forms_on: Dict[Tuple[str, torch.device], Tuple[torch.Tensor, ...]] = {}


def _forms(name: str, device: torch.device):
    key = (name, device)
    hit = _forms_on.get(key)
    if hit is None:
        a, b, o = _F12_FORMS if name == "f12" else _F6_FORMS
        hit = tuple(torch.from_numpy(m).to(device) for m in (a, b, o))
        _forms_on[key] = hit
    return hit


def _lincomb(x: FE, w: torch.Tensor, pos: int, negs: int) -> FE:
    """``w @ x`` over the component axis (-2) for a small integer matrix
    whose rows' positive and negative coefficients sum to at most ``pos``
    and ``negs``; the negative ones are offset by a multiple of p that
    dominates them, so no limb goes negative."""
    out = (w.unsqueeze(-1) * x.t.unsqueeze(-3)).sum(-2)
    b, lb = pos * x.b, pos * x.lb
    if negs:
        limbs, value, top = fp._fat_for(negs * x.b, negs * x.lb)
        out = out + fp._tensor(("fat", limbs), limbs, out.device)
        b, lb = b + value, lb + top
    return FE(out, b, lb)


def _sums(m: np.ndarray) -> Tuple[int, int]:
    """The largest row sums of a matrix's positive and negative parts."""
    return int(np.clip(m, 0, None).sum(1).max()), int(np.clip(-m, 0, None).sum(1).max())


_FORM_SUMS = {name: [_sums(m) for m in forms] for name, forms in (("f12", _F12_FORMS), ("f6", _F6_FORMS))}


def _tower_mul(name: str, a: FE, b: FE) -> FE:
    fa, fb, fo = _forms(name, a.device)
    (pa, na), (pb, nb), (po, no) = _FORM_SUMS[name]
    prods = fp.mul(_lincomb(a, fa, pa, na), _lincomb(b, fb, pb, nb))
    return fp.renorm(_lincomb(prods, fo, po, no))


def f12_mul(a: FE, b: FE) -> FE:
    return _tower_mul("f12", a, b)


def f12_sqr(a: FE) -> FE:
    return f12_mul(a, a)


def _part(x: FE, lo: int, hi: int) -> FE:
    return FE(x.t[..., lo:hi, :], x.b, x.lb)


def _cat(xs: Sequence[FE]) -> FE:
    ts = torch.broadcast_tensors(*[x.t[..., :1, :] for x in xs])
    lead = ts[0].shape[:-2]
    return FE(
        torch.cat([x.t.expand(*lead, *x.t.shape[-2:]) for x in xs], dim=-2),
        max(x.b for x in xs),
        max(x.lb for x in xs),
    )


def _f2_of(x: FE, j: int) -> F2:
    """Component pair (2j, 2j+1) of a stacked element as an F2."""
    return F2(fp.take(x, 2 * j), fp.take(x, 2 * j + 1))


def _stack_f2(parts: Sequence[F2]) -> FE:
    comps = []
    for p in parts:
        comps.extend((p.c0, p.c1))
    return fp.stack(comps)


def f12_conj(a: FE) -> FE:
    """f^(p^6): negates c1, the odd powers of w."""
    return _cat([_part(a, 0, 6), fp.neg(_part(a, 6, 12))])


def _f6_mul_v(a: FE) -> FE:
    """Times v: (a0, a1, a2) -> (xi a2, a0, a1)."""
    x = fp.f2_mul_xi(_f2_of(a, 2))
    return _cat([fp.stack([x.c0, x.c1]), _part(a, 0, 4)])


def _f6_inv(a: FE) -> FE:
    a0, a1, a2 = (_f2_of(a, j) for j in range(3))
    c0 = fp.f2_sub(fp.f2_sqr(a0), fp.f2_mul_xi(fp.f2_mul(a1, a2)))
    c1 = fp.f2_sub(fp.f2_mul_xi(fp.f2_sqr(a2)), fp.f2_mul(a0, a1))
    c2 = fp.f2_sub(fp.f2_sqr(a1), fp.f2_mul(a0, a2))
    t = fp.f2_add(fp.f2_mul(a0, c0), fp.f2_mul_xi(fp.f2_add(fp.f2_mul(a1, c2), fp.f2_mul(a2, c1))))
    ti = fp.f2_inv(t)
    return _stack_f2([fp.f2_mul(c0, ti), fp.f2_mul(c1, ti), fp.f2_mul(c2, ti)])


def f12_inv(a: FE) -> FE:
    a0, a1 = _part(a, 0, 6), _part(a, 6, 12)
    t = _f6_inv(fp.sub(_tower_mul("f6", a0, a0), _f6_mul_v(_tower_mul("f6", a1, a1))))
    return _cat([_tower_mul("f6", a0, t), fp.neg(_tower_mul("f6", a1, t))])


def _gamma(n: int) -> List[Tuple[int, int]]:
    out = []
    for k in range(6):
        e = k * (host.P**n - 1) // 6
        acc = host.F2_ONE
        for bit in bin(e)[2:]:
            acc = host.f2_sqr(acc)
            if bit == "1":
                acc = host.f2_mul(acc, (1, 1))
        out.append(acc)
    return out


_GAMMA = {1: _gamma(1), 2: _gamma(2)}
# w-basis coefficient e_k sits at tower components (2 w_k, 2 w_k + 1) with
# e0 = c0.c0, e1 = c1.c0, e2 = c0.c1, e3 = c1.c1, e4 = c0.c2, e5 = c1.c2.
_W_SLOT = (0, 3, 1, 4, 2, 5)  # e_k -> Fp2 slot (i * 3 + j)


def f12_frob(a: FE, n: int) -> FE:
    """f^(p^n) for n = 1, 2: each w-basis coefficient (conjugated for odd
    n) times xi^(k (p^n - 1) / 6), all six in one Fp2 product."""
    slots = [_f2_of(a, s) for s in range(6)]  # slot s = 3 i + j
    e = [slots[_W_SLOT[k]] for k in range(6)]
    ec = F2(fp.stack([x.c0 for x in e]), fp.stack([x.c1 for x in e]))
    if n % 2:
        ec = fp.f2_conj(ec)
    g = _GAMMA[n]
    gam = F2(fp.const([x[0] for x in g], a.device), fp.const([x[1] for x in g], a.device))
    prod = fp.f2_mul(ec, gam)
    out = [None] * 6
    for k in range(6):
        out[_W_SLOT[k]] = F2(fp.take(prod.c0, k), fp.take(prod.c1, k))
    return _stack_f2(out)


def _f12_one_like(shape, device) -> FE:
    one = fp.const(1, device)
    t = torch.zeros(*shape, 12, fp.L, dtype=torch.int64, device=device)
    t[..., 0, :] = one.t
    return FE(t, one.b, one.lb)


def _f12_words_one(device) -> torch.Tensor:
    return torch.tensor(fp.words_of([fp.ONE_M_INT] + [0] * 11), dtype=torch.int32, device=device)


# -- G1 and G2 in Jacobian coordinates ---------------------------------------


class _FpOps:
    add = staticmethod(fp.add)
    sub = staticmethod(fp.sub)
    mul = staticmethod(fp.mul)
    sqr = staticmethod(fp.sqr)
    muli = staticmethod(fp.muli)
    inv = staticmethod(fp.inv)
    neg = staticmethod(fp.neg)
    select = staticmethod(fp.select)

    @staticmethod
    def parts(x: FE) -> List[FE]:
        return [x]

    @staticmethod
    def one(like: FE) -> FE:
        c = fp.const(1, like.device)
        return FE(c.t.expand_as(like.t), c.b, c.lb)

    @staticmethod
    def zero(like: FE) -> FE:
        return FE(torch.zeros_like(like.t), 1, 0)

    @staticmethod
    def slice(x: FE, lo: int, hi: int) -> FE:
        return FE(x.t[..., lo:hi, :], x.b, x.lb)


class _F2Ops:
    add = staticmethod(fp.f2_add)
    sub = staticmethod(fp.f2_sub)
    mul = staticmethod(fp.f2_mul)
    sqr = staticmethod(fp.f2_sqr)
    muli = staticmethod(fp.f2_muli)
    inv = staticmethod(fp.f2_inv)
    neg = staticmethod(fp.f2_neg)
    select = staticmethod(fp.f2_select)

    @staticmethod
    def parts(x: F2) -> List[FE]:
        return [x.c0, x.c1]

    @staticmethod
    def one(like: F2) -> F2:
        return F2(_FpOps.one(like.c0), _FpOps.zero(like.c0))

    @staticmethod
    def zero(like: F2) -> F2:
        return F2(_FpOps.zero(like.c0), _FpOps.zero(like.c0))

    @staticmethod
    def slice(x: F2, lo: int, hi: int) -> F2:
        return F2(_FpOps.slice(x.c0, lo, hi), _FpOps.slice(x.c1, lo, hi))


def _all_zero(ops, xs) -> List[torch.Tensor]:
    """``x == 0`` for each of ``xs``, in one stacked call."""
    parts = [ops.parts(x) for x in xs]
    flat = fp.is_zero(fp.stack([p for ps in parts for p in ps], dim=0))
    out, at = [], 0
    for ps in parts:
        out.append(flat[at:at + len(ps)].all(dim=0))
        at += len(ps)
    return out


def _renorm(F, xs):
    """``xs`` with their bounds brought back near p, in one stacked call
    (the values stay: the Jacobian representatives are the kernel's)."""
    parts = [F.parts(x) for x in xs]
    flat = fp.renorm(fp.stack([p for ps in parts for p in ps], dim=0))
    out, at = [], 0
    for ps in parts:
        got = [FE(flat.t[at + i], flat.b, flat.lb) for i in range(len(ps))]
        out.append(got[0] if len(got) == 1 else F2(*got))
        at += len(ps)
    return out


def _jac_double(F, p):
    """2P, the JAX package's ``_jac_ops`` double."""
    x, y, z = p
    a = F.sqr(x)
    b = F.sqr(y)
    c = F.sqr(b)
    t = F.sqr(F.add(x, b))
    (d,) = _renorm(F, [F.muli(F.sub(F.sub(t, a), c), 2)])
    e = F.muli(a, 3)
    (x3,) = _renorm(F, [F.sub(F.sqr(e), F.muli(d, 2))])
    y3 = F.sub(F.mul(e, F.sub(d, x3)), F.muli(c, 8))
    z3 = F.muli(F.mul(y, z), 2)
    return tuple(_renorm(F, [x3, y3, z3]))


def _sel_pt(F, cond, a, b):
    return tuple(F.select(cond, u, v) for u, v in zip(a, b))


def _jac_add(F, p, q):
    """P + Q, ``_jac_ops.add_complete``, branch-free: the kernel's early
    returns (infinity on either side, P == Q) as selects in its order."""
    x1, y1, z1 = p
    x2, y2, z2 = q
    z1s = F.sqr(z1)
    z2s = F.sqr(z2)
    u1 = F.mul(x1, z2s)
    u2 = F.mul(x2, z1s)
    s1 = F.mul(y1, F.mul(z2s, z2))
    s2 = F.mul(y2, F.mul(z1s, z1))
    h, r = _renorm(F, [F.sub(u2, u1), F.sub(s2, s1)])
    hs = F.sqr(h)
    hc = F.mul(hs, h)
    u1hs = F.mul(u1, hs)
    x3 = F.sub(F.sub(F.sqr(r), hc), F.muli(u1hs, 2))
    y3 = F.sub(F.mul(r, F.sub(u1hs, x3)), F.mul(s1, hc))
    z3 = F.mul(F.mul(z1, z2), h)
    generic = tuple(_renorm(F, [x3, y3, z3]))
    h0, r0, p_inf, q_inf = _all_zero(F, [h, r, z1, z2])
    same = h0 & r0  # P == Q (or an infinity, which the selects below replace)
    out = _sel_pt(F, same, _jac_double(F, p), generic) if bool(same.any()) else generic
    out = _sel_pt(F, q_inf, p, out)
    return _sel_pt(F, p_inf, q, out)


def _load_points(points: torch.Tensor):
    """``(..., 2, 12)`` words -> (x, y) FEs; ``(..., 4, 12)`` -> F2s."""
    f = fp.from_words(points)
    if points.shape[-2] == 2:
        return _FpOps, (fp.take(f, 0), fp.take(f, 1))
    return _F2Ops, (F2(fp.take(f, 0), fp.take(f, 1)), F2(fp.take(f, 2), fp.take(f, 3)))


def merge_plain(points: torch.Tensor, live: torch.Tensor, neg_y: bool = False):
    """The merge kernel's function: ``points`` ``(G, V, C, 12)`` (C = 2 for
    G1, 4 for G2) with ``live`` ``(G, V)`` -> the affine sum of each group's
    live points ``(G, C, 12)`` (y negated where ``neg_y``; zeros for
    infinity) and its infinity flag ``(G,)``.  Its own order ("thread" t of
    128 folds points t, t + 128, ..., then a halving tree): the sum, and so
    the output, does not depend on it."""
    g, v, c = points.shape[0], points.shape[1], points.shape[2]
    steps = max(1, -(-v // MERGE_THREADS))
    pad = steps * MERGE_THREADS - v
    pts = torch.nn.functional.pad(points, (0, 0, 0, 0, 0, pad)).reshape(g, steps, MERGE_THREADS, c, fp.WORDS)
    alive = torch.nn.functional.pad(live, (0, pad)).reshape(g, steps, MERGE_THREADS)
    F, (x0, y0) = _load_points(pts[:, 0])
    zero = F.zero(x0)
    acc = (zero, zero, zero)
    for s in range(steps):
        _, (x, y) = _load_points(pts[:, s])
        acc = _sel_pt(F, alive[:, s], _jac_add(F, acc, (x, y, F.one(x))), acc)
    half = MERGE_THREADS // 2
    while half:
        lo = tuple(F.slice(u, 0, half) for u in acc)
        hi = tuple(F.slice(u, half, 2 * half) for u in acc)
        acc = _jac_add(F, lo, hi)
        half //= 2
    x, y, z = (F.slice(u, 0, 1) for u in acc)
    zi = F.inv(z)
    zi2 = F.sqr(zi)
    ax = F.mul(x, zi2)
    ay = F.mul(y, F.mul(zi2, zi))
    if neg_y:
        ay = F.neg(ay)
    out = fp.to_words(fp.stack(F.parts(ax) + F.parts(ay)))  # (G, 1, C, 12)
    inf = _all_zero(F, [z])[0]
    return out[:, 0], inf[:, 0]


# -- the Miller loop ---------------------------------------------------------


def _line(e0: F2, e3: F2, e5: F2) -> FE:
    """A line's w-basis slots 0, 3, 5 (c0.c0, c1.c1, c1.c2) as an Fp12."""
    z = _FpOps.zero(e0.c0)
    return fp.stack([e0.c0, e0.c1, z, z, z, z, z, z, e3.c0, e3.c1, e5.c0, e5.c1])


def _miller_side(qx: F2, qy: F2, px: FE, py: FE) -> FE:
    """f_{|x|, Q}(P) conjugated, with ``_dbl_step``'s and ``_add_step``'s
    lines, batched over leading axes."""
    F = _F2Ops
    t = (qx, qy, F.one(qx))
    f = _f12_one_like(qx.c0.shape, qx.c0.device)
    for bit in _X_BITS:
        x, y, z = t
        z2 = F.sqr(z)
        yz3 = F.mul(y, F.mul(z2, z))
        e0 = fp.f2_neg(fp.f2_muli(fp.f2_mul_xi(fp.f2_mul_fp(yz3, py)), 2))
        x2 = F.sqr(x)
        e3 = F.sub(F.muli(F.sqr(y), 2), F.muli(F.mul(x2, x), 3))
        e5 = F.muli(fp.f2_mul_fp(F.mul(x2, z2), px), 3)
        f = f12_mul(f12_sqr(f), _line(e0, e3, e5))
        t = _jac_double(F, t)
        if bit:
            x, y, z = t
            z2 = F.sqr(z)
            z3 = F.mul(z2, z)
            h = F.sub(F.mul(qx, z2), x)
            r = F.sub(F.mul(qy, z3), y)
            zh = F.mul(z, h)
            e0 = fp.f2_neg(fp.f2_mul_xi(fp.f2_mul_fp(zh, py)))
            e3 = F.sub(F.mul(qy, zh), F.mul(r, qx))
            e5 = fp.f2_mul_fp(r, px)
            f = f12_mul(f, _line(e0, e3, e5))
            hs = F.sqr(h)
            hc = F.mul(hs, h)
            v = F.mul(x, hs)
            x3 = F.sub(F.sub(F.sqr(r), hc), F.muli(v, 2))
            y3 = F.sub(F.mul(r, F.sub(v, x3)), F.mul(y, hc))
            t = tuple(_renorm(F, [x3, y3, zh]))
    return f12_conj(f)


def miller_plain(q: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """The Miller kernel's function: ``q`` ``(2, N, 4, 12)`` G2 points and
    ``p`` ``(2, N, 2, 12)`` G1 points (side 0 then side 1) -> ``(N, 12, 12)``
    the product of each lane's two sides' Miller values."""
    _, (qx, qy) = _load_points(q)
    _, (px, py) = _load_points(p)
    f = _miller_side(qx, qy, px, py)
    return fp.to_words(f12_mul(FE(f.t[0], f.b, f.lb), FE(f.t[1], f.b, f.lb)))


# -- the final exponentiation, cubed -----------------------------------------

# The 2020/875 chain computes f^(3 (p^4 - p^2 + 1) / r).
assert (BLS_X + 1) ** 2 * (host.P - BLS_X) * (BLS_X**2 + host.P**2 - 1) + 3 == 3 * (
    (host.P**4 - host.P**2 + 1) // host.R
), "hard-part chain"


def _exp_by_x(g: FE) -> FE:
    """g^x for the negative parameter: conj(g^|x|) (cyclotomic subgroup)."""
    acc = g
    for bit in _X_BITS:
        acc = f12_sqr(acc)
        if bit:
            acc = f12_mul(acc, g)
    return f12_conj(acc)


def _final_exp(f: FE) -> FE:
    f = f12_mul(f12_conj(f), f12_inv(f))
    f = f12_mul(f12_frob(f, 2), f)
    t = f12_mul(_exp_by_x(f), f12_conj(f))
    t = f12_mul(_exp_by_x(t), f12_conj(t))
    t = f12_mul(_exp_by_x(t), f12_frob(t, 1))
    t2 = _exp_by_x(_exp_by_x(t))
    t = f12_mul(f12_mul(t2, f12_frob(t, 2)), f12_conj(t))
    return f12_mul(t, f12_mul(f12_sqr(f), f))


def final_exp_plain(f: torch.Tensor, gate: torch.Tensor):
    """The final-exponentiation kernel's function: ``f`` ``(N, 12, 12)`` and
    ``gate`` ``(N,)`` bool -> (``ok`` ``(N,)``: the result is one and the
    gate is set, the result ``(N, 12, 12)``)."""
    r = fp.to_words(_final_exp(fp.from_words(f)))
    one = _f12_words_one(f.device)
    return gate & (r == one).all(dim=-1).all(dim=-1), r


# -- host packing ------------------------------------------------------------


def _pack(rows: Sequence[Sequence[int]], width: int) -> np.ndarray:
    """Rows of ``width`` host ints mod p -> ``(n, width, 12)`` int32 words
    in the Montgomery domain."""
    flat = fp.words_of([v * fp.R_MONT % fp.P for row in rows for v in row])
    return np.asarray(flat, dtype=np.int64).astype(np.int32).reshape(len(rows), width, fp.WORDS)


def pack_g1_points(points) -> np.ndarray:
    """Affine G1 points -> ``(n, 2, 12)`` int32 words (infinity -> zeros)."""
    return _pack([(0, 0) if pt is None else pt for pt in points], 2)


def pack_g2_points(points) -> np.ndarray:
    """Affine G2 points -> ``(n, 4, 12)`` int32 words (x0, x1, y0, y1)."""
    rows = [(0, 0, 0, 0) if pt is None else (pt[0][0], pt[0][1], pt[1][0], pt[1][1]) for pt in points]
    return _pack(rows, 4)


_R_INV = pow(fp.R_MONT, -1, fp.P)


def _values(words) -> List[int]:
    t = torch.as_tensor(np.asarray(words)) if not isinstance(words, torch.Tensor) else words
    return [v * _R_INV % fp.P for v in fp.ints_of(t)]


def unpack_g1_points(words, inf) -> list:
    """``(..., 2, 12)`` words and infinity flags -> affine host points."""
    vals = _values(words)
    flags = np.asarray(inf.cpu() if isinstance(inf, torch.Tensor) else inf).reshape(-1)
    return [None if flags[i] else (vals[2 * i], vals[2 * i + 1]) for i in range(len(flags))]


def unpack_g2_points(words, inf) -> list:
    """``(..., 4, 12)`` words and infinity flags -> affine G2 host points."""
    vals = _values(words)
    flags = np.asarray(inf.cpu() if isinstance(inf, torch.Tensor) else inf).reshape(-1)
    return [
        None if flags[i] else ((vals[4 * i], vals[4 * i + 1]), (vals[4 * i + 2], vals[4 * i + 3]))
        for i in range(len(flags))
    ]


def pack_f12(values) -> np.ndarray:
    """Host Fp12 tuples (crypto/bls.py's nesting) -> ``(n, 12, 12)`` words."""
    rows = [[v[i][j][k] for i in range(2) for j in range(3) for k in range(2)] for v in values]
    return _pack(rows, 12)


def unpack_f12(words) -> list:
    """``(..., 12, 12)`` words -> host Fp12 tuples."""
    vals = _values(words)
    return [_shape12(vals[12 * i:12 * i + 12]) for i in range(len(vals) // 12)]


_G1_GEN = pack_g1_points([host.G1_GEN])[0]


# -- entry points: the kernels on the card, the plain versions on the CPU ----


def g2_merge_tree(points: torch.Tensor, live: torch.Tensor):
    """Masked G2 sums: ``(..., V, 4, 12)`` points, ``(..., V)`` live ->
    ``(..., 4, 12)`` canonical affine words and a ``(...)`` infinity flag."""
    from . import bls_kernels

    lead = points.shape[:-3]
    out, inf = bls_kernels.merge(points.reshape(-1, *points.shape[-3:]), live.reshape(-1, live.shape[-1]))
    return out.reshape(*lead, 4, fp.WORDS), inf.reshape(lead)


def g1_merge_tree(points: torch.Tensor, live: torch.Tensor):
    """Masked G1 sums: ``(..., V, 2, 12)`` -> ``(..., 2, 12)`` and flags."""
    from . import bls_kernels

    lead = points.shape[:-3]
    out, inf = bls_kernels.merge(points.reshape(-1, *points.shape[-3:]), live.reshape(-1, live.shape[-1]))
    return out.reshape(*lead, 2, fp.WORDS), inf.reshape(lead)


def multi_pairing_check(sig: torch.Tensor, h: torch.Tensor, pk: torch.Tensor, pk_live: torch.Tensor,
                        lane_live: torch.Tensor) -> torch.Tensor:
    """N certificate equations at once: per lane i, ``e(G1, S_i) ==
    e(sum(pk_i), H_i)`` over its live pubkeys.  ``sig`` and ``h`` are
    ``(N, 4, 12)``, ``pk`` ``(N, V, 2, 12)`` with ``pk_live`` ``(N, V)``,
    ``lane_live`` ``(N,)``; returns ``(N,)`` bool.  Three launches on the
    card: the pubkey merge (y negated), the Miller loops, the final
    exponentiation."""
    from . import bls_kernels

    n = sig.shape[0]
    npk, pk_inf = bls_kernels.merge(pk, pk_live, neg_y=True)
    gen = torch.from_numpy(_G1_GEN).to(sig.device).expand(n, 2, fp.WORDS)
    f = bls_kernels.miller(torch.stack([sig, h]), torch.stack([gen, npk]))
    ok, _ = bls_kernels.final_exp(f, ~pk_inf & lane_live)
    return ok


def aggregate_verify_commit(pk: torch.Tensor, sig: torch.Tensor, h: torch.Tensor,
                            live: torch.Tensor, pk_live: torch.Tensor = None) -> torch.Tensor:
    """One aggregate COMMIT check: ``pk`` ``(V, 2, 12)`` pubkeys and ``sig``
    ``(V', 4, 12)`` seals with ``live`` ``(V',)`` (and ``pk_live`` ``(V,)``,
    by default ``live``: a quorum certificate has one aggregate point and
    many pubkeys), ``h`` ``(4, 12)`` = H2(m); returns a 0-d bool:
    ``e(G1, sum(sig)) == e(sum(pk), H)`` over the live lanes (false where
    either sum is infinity).  Four launches on the card: the two merges, the
    Miller loops, the final exponentiation."""
    from . import bls_kernels

    pk_live = live if pk_live is None else pk_live
    npk, pk_inf = bls_kernels.merge(pk.unsqueeze(0), pk_live.unsqueeze(0), neg_y=True)
    s, s_inf = bls_kernels.merge(sig.unsqueeze(0), live.unsqueeze(0))
    gen = torch.from_numpy(_G1_GEN).to(pk.device).unsqueeze(0)
    f = bls_kernels.miller(torch.stack([s, h.unsqueeze(0)]), torch.stack([gen, npk]))
    ok, _ = bls_kernels.final_exp(f, ~pk_inf & ~s_inf)
    return ok[0]
