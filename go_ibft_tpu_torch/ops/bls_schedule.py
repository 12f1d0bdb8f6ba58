"""The schedules of the two pairing kernels, ``bls_miller`` and
``bls_final_exp`` (``csrc/bls12_381.cu``).

A kernel runs one lane on a block of threads.  The lane's values (inputs,
constants, the Fp12 accumulator, the points, the lines) live in shared
memory as *elements*: canonical Fp values of 12 words, Montgomery form.
The lane's work is a fixed sequence of *rounds*, each three phases:

1. every thread takes a slot: it forms the slot's two operands as small
   integer combinations of elements and multiplies them (one Montgomery
   product in registers), writing the product to the product region
   (elements ``0 .. SLOTS - 1``);
2. a barrier;
3. every thread takes a store: it forms a small integer combination of
   products and elements and writes it to the store's element; a barrier.
   A store of more than ``MAX_TERMS`` terms is summed in parts by several
   threads into scratch elements, and a second store phase (and barrier)
   adds up the parts.

Every tower formula is a linear map of independent Fp products, so a round
holds a whole Fp12 product (54 slots), squaring (36), cyclotomic squaring
(18) or Frobenius (10-12), and the independent work beside it: in the
Miller loop the two sides' point doublings and line coefficients run in
the same rounds as the accumulator's squaring and line products.  One more
round kind inverts one element (one thread, ``bls::inv``).

This module is the one description of both schedules.  It builds them from
the tower formulas on symbolic linear forms (products that are zero or
repeat within a round are dropped), checks the rules that make the phases
race-free, runs them on Python integers (:func:`simulate`, which the tests
hold against the host oracle), and writes them as tables for the kernels'
interpreter (``csrc/bls12_381_schedule.cuh``):

    python -m go_ibft_tpu_torch.ops.bls_schedule   # rewrites the header

The Miller value is the JAX package's field element: the same Jacobian
doubling and addition, the same lines (``_dbl_step`` / ``_add_step``) with
the same scalings, and one accumulator for a lane's two sides, which is
exactly the product of the two sides' values.  The final exponentiation's
result is unique, so any correct chain gives the same words.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Sequence, Tuple

from ..crypto import bls as host

P = host.P
MONT_R = 1 << 384
SLOTS = 64  # the product region: the most products a round holds
MAX_TERMS = 8  # a longer store is summed in parts (see Round.phases)
SCRATCH = 64  # elements for the parts
X_BITS = [int(b) for b in bin(host.BLS_X)[3:]]  # |x| after its leading bit, MSB first
HEADER = Path(__file__).resolve().parent.parent / "csrc" / "bls12_381_schedule.cuh"

NORMAL, INVERT = 0, 1  # round kinds

Lin = Dict[int, int]  # element -> integer coefficient


def comb(*pairs) -> Lin:
    """sum(c * form) over (c, form) pairs."""
    out: Lin = {}
    for c, form in pairs:
        for e, k in form.items():
            v = out.get(e, 0) + c * k
            if v:
                out[e] = v
            else:
                out.pop(e, None)
    return out


def add(a: Lin, b: Lin) -> Lin:
    return comb((1, a), (1, b))


def sub(a: Lin, b: Lin) -> Lin:
    return comb((1, a), (-1, b))


def neg(a: Lin) -> Lin:
    return comb((-1, a))


def muli(a: Lin, k: int) -> Lin:
    return comb((k, a))


# -- the tower on symbolic values: Fp2 = (Lin, Lin), Fp6 = 3 x Fp2, Fp12 = 2 x Fp6


def f2_add(a, b):
    return (add(a[0], b[0]), add(a[1], b[1]))


def f2_sub(a, b):
    return (sub(a[0], b[0]), sub(a[1], b[1]))


def f2_neg(a):
    return (neg(a[0]), neg(a[1]))


def f2_muli(a, k):
    return (muli(a[0], k), muli(a[1], k))


def f2_conj(a):
    return (a[0], neg(a[1]))


def f2_mul_xi(a):
    """Times xi = 1 + u."""
    return (sub(a[0], a[1]), add(a[0], a[1]))


F2_ZERO = ({}, {})


def f6_add(a, b):
    return tuple(f2_add(x, y) for x, y in zip(a, b))


def f6_sub(a, b):
    return tuple(f2_sub(x, y) for x, y in zip(a, b))


def f6_neg(a):
    return tuple(f2_neg(x) for x in a)


def f6_mul_v(a):
    """Times v: (a0, a1, a2) -> (xi a2, a0, a1)."""
    return (f2_mul_xi(a[2]), a[0], a[1])


def f12_conj(a):
    return (a[0], f6_neg(a[1]))


def flat12(a) -> List[Lin]:
    """The 12 forms in the tower's order c0.c0.c0, c0.c0.c1, ..., c1.c2.c1."""
    return [x for half in a for pair in half for x in pair]


def shape12(forms: Sequence[Lin]):
    return tuple(tuple((forms[6 * i + 2 * j], forms[6 * i + 2 * j + 1]) for j in range(3)) for i in range(2))


def view(elements: Sequence[int]):
    """Stored elements as symbolic values: one Fp, an Fp2 or an Fp12."""
    forms = [{e: 1} for e in elements]
    if len(forms) == 1:
        return forms[0]
    if len(forms) == 2:
        return (forms[0], forms[1])
    if len(forms) == 6:
        return tuple((forms[2 * j], forms[2 * j + 1]) for j in range(3))
    return shape12(forms)


class Round:
    """One round: products of linear forms over stored elements (slots), then
    linear forms over products and elements written to elements (stores)."""

    def __init__(self, kind: int = NORMAL):
        self.kind = kind
        self.slots: List[Tuple[Lin, Lin]] = []
        self._index: Dict[tuple, int] = {}
        self.stores: List[Tuple[int, Lin]] = []

    # products --------------------------------------------------------------

    def mul(self, a: Lin, b: Lin) -> Lin:
        """The form of the product a * b: a slot of this round, shared with an
        equal product (up to sign and order) already in it; zero if an
        operand is zero."""
        if not a or not b:
            return {}
        (sa, ka), (sb, kb) = _norm(a), _norm(b)
        key = (ka, kb) if ka <= kb else (kb, ka)
        s = self._index.get(key)
        if s is None:
            for form in (a, b):
                assert all(e >= SLOTS for e in form), "an operand reads the product region"
            s = len(self.slots)
            assert s < SLOTS, "a round holds at most SLOTS products"
            self.slots.append((dict(key[0]), dict(key[1])))
            self._index[key] = s
        return {s: sa * sb}

    def f2_mul(self, a, b):
        t0, t1 = self.mul(a[0], b[0]), self.mul(a[1], b[1])
        t2 = self.mul(add(a[0], a[1]), add(b[0], b[1]))
        return (sub(t0, t1), sub(sub(t2, t0), t1))

    def f2_sqr(self, a):
        t = self.mul(a[0], a[1])
        return (self.mul(add(a[0], a[1]), sub(a[0], a[1])), muli(t, 2))

    def f2_mul_fp(self, a, s):
        return (self.mul(a[0], s), self.mul(a[1], s))

    def f6_mul(self, a, b):
        t0, t1, t2 = (self.f2_mul(x, y) for x, y in zip(a, b))
        c0 = f2_add(t0, f2_mul_xi(f2_sub(self.f2_mul(f2_add(a[1], a[2]), f2_add(b[1], b[2])), f2_add(t1, t2))))
        c1 = f2_add(f2_sub(self.f2_mul(f2_add(a[0], a[1]), f2_add(b[0], b[1])), f2_add(t0, t1)), f2_mul_xi(t2))
        c2 = f2_add(f2_sub(self.f2_mul(f2_add(a[0], a[2]), f2_add(b[0], b[2])), f2_add(t0, t2)), t1)
        return (c0, c1, c2)

    def f6_sqr(self, a):
        """Six Fp2 squarings: a_i^2 and (a_i + a_j)^2."""
        s0, s1, s2 = (self.f2_sqr(x) for x in a)
        s12, s01, s02 = (self.f2_sqr(f2_add(a[i], a[j])) for i, j in ((1, 2), (0, 1), (0, 2)))
        c0 = f2_add(s0, f2_mul_xi(f2_sub(s12, f2_add(s1, s2))))
        c1 = f2_add(f2_sub(s01, f2_add(s0, s1)), f2_mul_xi(s2))
        c2 = f2_add(f2_sub(s02, f2_add(s0, s2)), s1)
        return (c0, c1, c2)

    def f12_mul(self, a, b):
        t0, t1 = self.f6_mul(a[0], b[0]), self.f6_mul(a[1], b[1])
        s = self.f6_mul(f6_add(a[0], a[1]), f6_add(b[0], b[1]))
        return (f6_add(t0, f6_mul_v(t1)), f6_sub(s, f6_add(t0, t1)))

    def f12_sqr(self, a):
        """The complex method: t = a0 a1, c0 = (a0 + a1)(a0 + v a1) - t - v t,
        c1 = 2 t (36 products)."""
        t = self.f6_mul(a[0], a[1])
        s = self.f6_mul(f6_add(a[0], a[1]), f6_add(a[0], f6_mul_v(a[1])))
        return (f6_sub(f6_sub(s, t), f6_mul_v(t)), f6_add(t, t))

    def f12_csqr(self, a):
        """Granger-Scott squaring in the cyclotomic subgroup (18 products): the
        three Fp4 = Fp2[y] / (y^2 - xi) squarings of (z0, z1), (z2, z3),
        (z4, z5), three Fp2 squarings each; maps 0 to 0."""
        z0, z4, z3 = a[0]
        z2, z1, z5 = a[1]

        def fp4_sqr(x, y):
            sx, sy = self.f2_sqr(x), self.f2_sqr(y)
            return f2_add(sx, f2_mul_xi(sy)), f2_sub(self.f2_sqr(f2_add(x, y)), f2_add(sx, sy))

        t0, t1 = fp4_sqr(z0, z1)
        t2, t3 = fp4_sqr(z2, z3)
        t4, t5 = fp4_sqr(z4, z5)
        r0 = f2_sub(f2_muli(t0, 3), f2_muli(z0, 2))
        r1 = f2_add(f2_muli(t1, 3), f2_muli(z1, 2))
        r2 = f2_add(f2_muli(f2_mul_xi(t5), 3), f2_muli(z2, 2))
        r3 = f2_sub(f2_muli(t4, 3), f2_muli(z3, 2))
        r4 = f2_sub(f2_muli(t2, 3), f2_muli(z4, 2))
        r5 = f2_add(f2_muli(t3, 3), f2_muli(z5, 2))
        return ((r0, r4, r3), (r2, r1, r5))

    def frob(self, a, n: int, layout: "Layout"):
        """a^(p^n), n = 1, 2: each w-basis coefficient (conjugated for odd n)
        times xi^(k (p^n - 1) / 6)."""
        slots = [a[0][0], a[1][0], a[0][1], a[1][1], a[0][2], a[1][2]]  # e0 .. e5
        out = []
        for k, e in enumerate(slots):
            if n % 2:
                e = f2_conj(e)
            g0, g1 = GAMMA[n][k]
            if (g0, g1) == (1, 0):
                out.append(e)
            elif g1 == 0:
                c = layout.const(g0)
                out.append(self.f2_mul_fp(e, c))
            elif g0 == 0:  # (e0 + e1 u) g u = -g e1 + g e0 u
                c = layout.const(g1)
                out.append((neg(self.mul(e[1], c)), self.mul(e[0], c)))
            elif g0 == g1:  # (e0 + e1 u)(1 + u) g
                c = layout.const(g0)
                out.append((self.mul(sub(e[0], e[1]), c), self.mul(add(e[0], e[1]), c)))
            else:
                out.append(self.f2_mul(e, (layout.const(g0), layout.const(g1))))
        return ((out[0], out[2], out[4]), (out[1], out[3], out[5]))

    # stores ----------------------------------------------------------------

    def store(self, dst: Sequence[int], forms: Sequence[Lin]) -> None:
        assert len(dst) == len(forms)
        for d, f in zip(dst, forms):
            assert d >= SLOTS, "a store writes the product region"
            self.stores.append((d, f))

    def key(self):
        return (self.kind, tuple((tuple(sorted(a.items())), tuple(sorted(b.items()))) for a, b in self.slots),
                tuple((d, tuple(sorted(f.items()))) for d, f in self.stores))

    def check(self) -> None:
        """The rules that make the phases race-free on the card: operands read
        no product; no two stores write one element; no store reads an
        element that another store of the round writes (a store may read its
        own destination: one thread reads it before writing)."""
        dsts = [d for d, _ in self.stores]
        assert len(set(dsts)) == len(dsts), "two stores write one element"
        written = set(dsts)
        for d, f in self.stores:
            assert not (set(f) & (written - {d})), "a store reads an element another store writes"
        if self.kind == INVERT:
            assert not self.slots and len(self.stores) == 1
        a, b = self.phases()
        if b:
            scratch = set(self.scratch)
            a_dsts = {d for d, _ in a}
            for d, f in a:  # the parts read no element the first phase writes
                assert not (set(f) & (a_dsts - {d})), "a part reads an element the first phase writes"
            assert all(set(f) <= scratch for _, f in b), "a sum of parts reads more than its parts"

    def phases(self):
        """The stores as the interpreter runs them: the first phase holds the
        short stores and the parts of the long ones (at most MAX_TERMS terms
        each, equal parts shared, into scratch elements), the second each long
        store as the sum of its parts (empty where no store is long)."""
        first: List[Tuple[int, Lin]] = []
        second: List[Tuple[int, Lin]] = []
        parts: Dict[tuple, int] = {}
        for d, f in self.stores:
            items = sorted(f.items())
            if len(items) <= MAX_TERMS or self.kind == INVERT:
                first.append((d, f))
                continue
            k = -(-len(items) // MAX_TERMS)
            total: Lin = {}
            for i in range(k):
                chunk = tuple(items[i * len(items) // k:(i + 1) * len(items) // k])
                e = parts.get(chunk)
                if e is None:
                    assert len(parts) < len(self.scratch), "a round's parts fill the scratch elements"
                    e = parts[chunk] = self.scratch[len(parts)]
                    first.append((e, dict(chunk)))
                total[e] = 1
            second.append((d, total))
        return first, second


def _norm(form: Lin):
    """(sign, canonical items): the sign makes the first coefficient positive."""
    items = tuple(sorted(form.items()))
    s = 1 if items[0][1] > 0 else -1
    return s, tuple((e, s * c) for e, c in items)


def _gamma(n: int):
    out = []
    for k in range(6):
        acc = host.F2_ONE
        for bit in bin(k * (P**n - 1) // 6)[2:]:
            acc = host.f2_sqr(acc)
            if bit == "1":
                acc = host.f2_mul(acc, (1, 1))
        out.append(acc)
    return out


GAMMA = {1: _gamma(1), 2: _gamma(2)}


class Layout:
    """A kernel's shared elements: the product region, named buffers and
    constants."""

    def __init__(self):
        self.n = SLOTS
        self.bufs: Dict[str, List[int]] = {}
        self.consts: Dict[int, int] = {}  # value -> element
        self.buf("SCRATCH", SCRATCH)

    def buf(self, name: str, n: int) -> List[int]:
        idx = list(range(self.n, self.n + n))
        self.n += n
        self.bufs[name] = idx
        return idx

    def const(self, value: int) -> Lin:
        value %= P
        if value not in self.consts:
            self.consts[value] = self.buf(f"const{len(self.consts)}", 1)[0]
        return {self.consts[value]: 1}


def _finish(rounds: List[Round], layout: "Layout") -> List[Round]:
    for r in rounds:
        r.scratch = layout.bufs["SCRATCH"]
        r.check()
    return rounds


# -- the Miller loop -------------------------------------------------------


def _miller_layout() -> Layout:
    L = Layout()
    L.one = L.const(1)
    for j in range(2):
        for name, n in (("QX", 2), ("QY", 2), ("PX", 1), ("PY", 1), ("X", 2), ("Y", 2), ("Z", 2),
                        ("Z2", 2), ("X2", 2), ("Y2", 2), ("YZ", 2), ("YZ3", 2), ("X2Z2", 2), ("C", 2),
                        ("D", 2), ("E0", 2), ("E3", 2), ("E5", 2), ("AZ3", 2), ("AH", 2), ("AR", 2),
                        ("AHS", 2), ("AHC", 2), ("AV", 2), ("AE0", 2), ("AE3", 2), ("AE5", 2)):
            L.buf(f"{name}{j}", n)
    for name in ("F", "F2", "OUT"):
        L.buf(name, 12)
    # The product of two lines has no c1.c0: 10 stored elements each.
    L.buf("LL", 10)
    L.buf("AA", 10)
    return L


_PAIR_ZERO = (6, 7)  # the tower components a product of two lines leaves zero


def _pair_view(elements: Sequence[int]):
    it = iter(elements)
    return shape12([{} if k in _PAIR_ZERO else {next(it): 1} for k in range(12)])


def _pair_store(r: Round, dst: Sequence[int], value) -> None:
    forms = flat12(value)
    assert all(not forms[k] for k in _PAIR_ZERO)
    r.store(dst, [f for k, f in enumerate(forms) if k not in _PAIR_ZERO])


def _line(L: Layout, prefix: str, j: int):
    """A line's w-basis slots 0, 3, 5 (c0.c0, c1.c1, c1.c2) as an Fp12."""
    e0, e3, e5 = (view(L.bufs[f"{prefix}{k}{j}"]) for k in ("E0", "E3", "E5"))
    return ((e0, F2_ZERO, F2_ZERO), (F2_ZERO, e3, e5))


def _b(L: Layout, name: str):
    return view(L.bufs[name])


def _dbl1(r: Round, L: Layout, j: int) -> None:
    """Doubling, round 1: Z^2, X^2, Y^2, YZ; the new Z = 2 YZ."""
    x, y, z = (_b(L, f"{c}{j}") for c in "XYZ")
    yz = r.f2_mul(y, z)
    r.store(L.bufs[f"Z2{j}"], r.f2_sqr(z))
    r.store(L.bufs[f"X2{j}"], r.f2_sqr(x))
    r.store(L.bufs[f"Y2{j}"], r.f2_sqr(y))
    r.store(L.bufs[f"YZ{j}"], yz)
    r.store(L.bufs[f"Z{j}"], f2_muli(yz, 2))


def _dbl2(r: Round, L: Layout, j: int) -> None:
    """Doubling, round 2: Y Z^3, X^3, X^2 Z^2, c = Y^4, t = (X + Y^2)^2,
    e^2 = (3 X^2)^2; d = 2 (t - X^2 - c), the new X = e^2 - 2 d, the line's
    e3 = 2 Y^2 - 3 X^3."""
    x, x2, y2, z2, yz = (_b(L, f"{c}{j}") for c in ("X", "X2", "Y2", "Z2", "YZ"))
    c = r.f2_sqr(y2)
    t = r.f2_sqr(f2_add(x, y2))
    e2 = r.f2_sqr(f2_muli(x2, 3))
    d = f2_muli(f2_sub(f2_sub(t, x2), c), 2)
    r.store(L.bufs[f"YZ3{j}"], r.f2_mul(yz, z2))
    r.store(L.bufs[f"X2Z2{j}"], r.f2_mul(x2, z2))
    r.store(L.bufs[f"C{j}"], c)
    r.store(L.bufs[f"D{j}"], d)
    r.store(L.bufs[f"X{j}"], f2_sub(e2, f2_muli(d, 2)))
    r.store(L.bufs[f"E3{j}"], f2_sub(f2_muli(y2, 2), f2_muli(r.f2_mul(x2, x), 3)))


def _dbl3(r: Round, L: Layout, j: int) -> None:
    """Doubling, round 3: the new Y = 3 X^2 (d - X_new) - 8 c."""
    x, x2, c, d = (_b(L, f"{n}{j}") for n in ("X", "X2", "C", "D"))
    r.store(L.bufs[f"Y{j}"], f2_sub(r.f2_mul(f2_muli(x2, 3), f2_sub(d, x)), f2_muli(c, 8)))


def _scale(r: Round, L: Layout, j: int) -> None:
    """The doubling line's e0 = -2 xi (Y Z^3 py) and e5 = 3 (X^2 Z^2 px)."""
    yz3, x2z2, px, py = (_b(L, f"{n}{j}") for n in ("YZ3", "X2Z2", "PX", "PY"))
    r.store(L.bufs[f"E0{j}"], f2_muli(f2_mul_xi(r.f2_mul_fp(yz3, py)), -2))
    r.store(L.bufs[f"E5{j}"], f2_muli(r.f2_mul_fp(x2z2, px), 3))


def _add1(r: Round, L: Layout, j: int) -> None:
    """Addition T + Q, round 1: Z^2."""
    r.store(L.bufs[f"Z2{j}"], r.f2_sqr(_b(L, f"Z{j}")))


def _add2(r: Round, L: Layout, j: int) -> None:
    """Round 2: Z^3, h = qx Z^2 - X."""
    z, z2, x, qx = (_b(L, f"{n}{j}") for n in ("Z", "Z2", "X", "QX"))
    r.store(L.bufs[f"AZ3{j}"], r.f2_mul(z2, z))
    r.store(L.bufs[f"AH{j}"], f2_sub(r.f2_mul(qx, z2), x))


def _add3(r: Round, L: Layout, j: int) -> None:
    """Round 3: r = qy Z^3 - Y, the new Z = Z h, h^2."""
    z, z3, h, y, qy = (_b(L, f"{n}{j}") for n in ("Z", "AZ3", "AH", "Y", "QY"))
    r.store(L.bufs[f"AR{j}"], f2_sub(r.f2_mul(qy, z3), y))
    r.store(L.bufs[f"Z{j}"], r.f2_mul(z, h))
    r.store(L.bufs[f"AHS{j}"], r.f2_sqr(h))


def _add4(r: Round, L: Layout, j: int) -> None:
    """Round 4: the line (e0 = -xi (Z h py), e3 = qy Z h - r qx, e5 = r px),
    h^3, v = X h^2, the new X = r^2 - h^3 - 2 v."""
    zh, rr, hs, h, x, qx, qy, px, py = (_b(L, f"{n}{j}") for n in ("Z", "AR", "AHS", "AH", "X", "QX", "QY",
                                                                  "PX", "PY"))
    hc, v = r.f2_mul(hs, h), r.f2_mul(x, hs)
    r.store(L.bufs[f"AE0{j}"], f2_neg(f2_mul_xi(r.f2_mul_fp(zh, py))))
    r.store(L.bufs[f"AE3{j}"], f2_sub(r.f2_mul(qy, zh), r.f2_mul(rr, qx)))
    r.store(L.bufs[f"AE5{j}"], r.f2_mul_fp(rr, px))
    r.store(L.bufs[f"AHC{j}"], hc)
    r.store(L.bufs[f"AV{j}"], v)
    r.store(L.bufs[f"X{j}"], f2_sub(f2_sub(r.f2_sqr(rr), hc), f2_muli(v, 2)))


def _add5(r: Round, L: Layout, j: int) -> None:
    """Round 5: the new Y = r (v - X_new) - Y h^3."""
    rr, v, x, y, hc = (_b(L, f"{n}{j}") for n in ("AR", "AV", "X", "Y", "AHC"))
    r.store(L.bufs[f"Y{j}"], f2_sub(r.f2_mul(rr, f2_sub(v, x)), r.f2_mul(y, hc)))


def miller_rounds() -> Tuple[Layout, List[Round]]:
    """The Miller loop of a lane's two sides into one accumulator F, software
    pipelined: the rounds of doubling step k hold side 0 and 1's point work
    on T_k beside the accumulator's absorption of step k - 1's lines:

        round 1: F^2 (36 products), both doublings' round 1 (18), step k - 1's
                 line scalings (8)
        round 2: step k - 1's line pair l_0 l_1 (18), both doublings' round 2 (30)
        round 3: F^2 (l_0 l_1) (51), both doublings' round 3 (6)

    A set bit adds the two additions T + Q: the first of their five rounds is
    fused into round 3, four follow it, the last with the product of their two
    lines, which the next step absorbs with one more round.  The last step's
    lines take three rounds of their own."""
    L = _miller_layout()
    rounds: List[Round] = []
    init = Round()
    init.store(L.bufs["F"], [L.one] + [{}] * 11)
    for j in range(2):
        init.store(L.bufs[f"X{j}"], list(_b(L, f"QX{j}")))
        init.store(L.bufs[f"Y{j}"], list(_b(L, f"QY{j}")))
        init.store(L.bufs[f"Z{j}"], [L.one, {}])
    rounds.append(init)

    def step(point: bool, absorb: bool, added: bool, add_now: bool) -> None:
        """One doubling step's rounds: ``point`` doubles T (and makes its
        line), ``absorb`` takes the previous step's lines into F (and its
        addition lines where ``added``), ``add_now`` adds Q after doubling."""
        r1, r2, r3 = Round(), Round(), Round()
        if absorb:
            r1.store(L.bufs["F2"], flat12(r1.f12_sqr(_b(L, "F"))))
            for j in range(2):
                _scale(r1, L, j)
        if point:
            for j in range(2):
                _dbl1(r1, L, j)
                _dbl2(r2, L, j)
                _dbl3(r3, L, j)
                if add_now:
                    _add1(r3, L, j)
        if absorb:
            _pair_store(r2, L.bufs["LL"], r2.f12_mul(_line(L, "", 0), _line(L, "", 1)))
            r3.store(L.bufs["F"], flat12(r3.f12_mul(_b(L, "F2"), _pair_view(L.bufs["LL"]))))
        rounds.extend(r for r in (r1, r2, r3) if r.slots or r.stores)
        if absorb and added:
            r4 = Round()
            r4.store(L.bufs["F"], flat12(r4.f12_mul(_b(L, "F"), _pair_view(L.bufs["AA"]))))
            rounds.append(r4)
        if add_now:
            a = [Round() for _ in range(4)]
            for j in range(2):
                for fn, rd in zip((_add2, _add3, _add4, _add5), a):
                    fn(rd, L, j)
            _pair_store(a[3], L.bufs["AA"], a[3].f12_mul(_line(L, "A", 0), _line(L, "A", 1)))
            rounds.extend(a)

    bits = X_BITS
    for k, bit in enumerate(bits):
        step(point=True, absorb=k > 0, added=k > 0 and bits[k - 1] == 1, add_now=bit == 1)
    step(point=False, absorb=True, added=bits[-1] == 1, add_now=False)
    out = Round()
    out.store(L.bufs["OUT"], flat12(f12_conj(_b(L, "F"))))
    rounds.append(out)
    return L, _finish(rounds, L)


# -- the final exponentiation ----------------------------------------------


def _exp_layout() -> Layout:
    L = Layout()
    L.one = L.const(1)
    for name, n in (("IN", 12), ("B", 12), ("OUT", 12), ("T6", 6), ("C6", 6), ("D2", 2), ("N1", 1), ("NI", 1),
                    ("DI", 2), ("TI", 6), ("G", 12), ("E", 12), ("E2", 12), ("FR", 12), ("BASE", 12),
                    ("ACC", 12), ("TT", 12), ("M", 12)):
        L.buf(name, n)
    return L


def _easy_rounds(L: Layout) -> List[Round]:
    """The Fp12 inverse's tower descent, shared by the easy part and the
    inverse test op: T6 = a0^2 - v a1^2 (two Fp6 squarings), the Fp6
    inverse's cofactors C6 (and G = conj(a)^2 beside them), their norm
    D2 in Fp2, its norm N1 in Fp, N1^-1, D2^-1, T6^-1 = C6 D2^-1."""
    a = _b(L, "IN")
    r1 = Round()
    r1.store(L.bufs["T6"], [x for pair in f6_sub(r1.f6_sqr(a[0]), f6_mul_v(r1.f6_sqr(a[1]))) for x in pair])
    r2 = Round()
    t0, t1, t2 = _b(L, "T6")
    c0 = f2_sub(r2.f2_sqr(t0), f2_mul_xi(r2.f2_mul(t1, t2)))
    c1 = f2_sub(f2_mul_xi(r2.f2_sqr(t2)), r2.f2_mul(t0, t1))
    c2 = f2_sub(r2.f2_sqr(t1), r2.f2_mul(t0, t2))
    r2.store(L.bufs["C6"], [*c0, *c1, *c2])
    r2.store(L.bufs["G"], flat12(r2.f12_sqr(f12_conj(a))))
    r3 = Round()
    c0, c1, c2 = _b(L, "C6")
    r3.store(L.bufs["D2"], f2_add(r3.f2_mul(t0, c0), f2_mul_xi(f2_add(r3.f2_mul(t1, c2), r3.f2_mul(t2, c1)))))
    r4 = Round()
    d = _b(L, "D2")
    r4.store(L.bufs["N1"], [add(r4.mul(d[0], d[0]), r4.mul(d[1], d[1]))])
    r5 = Round(INVERT)
    r5.store(L.bufs["NI"], [_b(L, "N1")])
    r6 = Round()
    ni = _b(L, "NI")
    r6.store(L.bufs["DI"], [r6.mul(d[0], ni), neg(r6.mul(d[1], ni))])
    r7 = Round()
    di = _b(L, "DI")
    r7.store(L.bufs["TI"], [x for c in (c0, c1, c2) for x in r7.f2_mul(c, di)])
    return [r1, r2, r3, r4, r5, r6, r7]


def final_exp_rounds() -> Tuple[Layout, List[Round]]:
    """f^(3 (p^12 - 1) / r).  The easy part f^((p^6 - 1)(p^2 + 1)): conj(f)^2
    T6^-1 (T6 = f conj(f), inverted down the tower to one Fp inversion),
    then times its p^2 Frobenius.  The 2020/875 hard part: five x-powers of
    63 cyclotomic squarings (18 products, one round each) and 5 products,
    with the Frobenius maps fused into the squaring rounds beside them."""
    L = _exp_layout()
    rounds = _easy_rounds(L)
    rd = Round()
    g, ti = _b(L, "G"), _b(L, "TI")
    rd.store(L.bufs["E"], flat12((rd.f6_mul(g[0], ti), rd.f6_mul(g[1], ti))))
    rounds.append(rd)
    rd = Round()
    rd.store(L.bufs["FR"], flat12(rd.frob(_b(L, "E"), 2, L)))
    rounds.append(rd)
    rd = Round()
    e = flat12(rd.f12_mul(_b(L, "FR"), _b(L, "E")))
    rd.store(L.bufs["E"], e)
    rd.store(L.bufs["BASE"], e)
    rounds.append(rd)

    def exp_by_x(first_extra=None) -> None:
        """ACC = BASE^|x| (the caller conjugates); the first squaring reads
        BASE, and ``first_extra`` adds work to its round."""
        for k, bit in enumerate(X_BITS):
            rd = Round()
            rd.store(L.bufs["ACC"], flat12(rd.f12_csqr(_b(L, "BASE" if k == 0 else "ACC"))))
            if k == 0 and first_extra:
                first_extra(rd)
            rounds.append(rd)
            if bit:
                rd = Round()
                rd.store(L.bufs["ACC"], flat12(rd.f12_mul(_b(L, "ACC"), _b(L, "BASE"))))
                rounds.append(rd)

    def product(dst: str, a, b) -> Round:
        rd = Round()
        rd.store(L.bufs[dst], flat12(rd.f12_mul(a, b)))
        rounds.append(rd)
        return rd

    def next_base(other) -> None:
        """TT = BASE = conj(ACC) * other."""
        rd = product("TT", f12_conj(_b(L, "ACC")), other)
        rd.store(L.bufs["BASE"], [f for _, f in rd.stores])

    # The first squaring of E is E^2: kept (E2) for the closing E^3.
    exp_by_x(first_extra=lambda rd: rd.store(L.bufs["E2"], [f for _, f in rd.stores]))
    next_base(f12_conj(_b(L, "E")))
    exp_by_x()
    next_base(f12_conj(_b(L, "TT")))
    exp_by_x(first_extra=lambda rd: rd.store(L.bufs["FR"], flat12(rd.frob(_b(L, "TT"), 1, L))))
    next_base(_b(L, "FR"))
    exp_by_x(first_extra=lambda rd: rd.store(L.bufs["FR"], flat12(rd.frob(_b(L, "TT"), 2, L))))
    rd = Round()
    rd.store(L.bufs["BASE"], flat12(f12_conj(_b(L, "ACC"))))
    rounds.append(rd)
    exp_by_x()
    product("M", f12_conj(_b(L, "ACC")), _b(L, "FR"))  # t2 frob2(t)
    product("M", _b(L, "M"), f12_conj(_b(L, "TT")))  # * conj(t)
    product("M", _b(L, "M"), _b(L, "E2"))
    product("OUT", _b(L, "M"), _b(L, "E"))  # * E^3
    return L, _finish(rounds, L)


# Test ops (bls_f12_op_host), on the final exponentiation's layout: IN and B
# in, OUT out.
OP_MUL, OP_SQR, OP_INV, OP_FROB1, OP_FROB2, OP_CONJ, OP_CSQR, OP_LINE_PAIR, OP_MUL_PAIR = range(9)


def op_rounds(L: Layout) -> List[List[Round]]:
    a, b = _b(L, "IN"), _b(L, "B")

    def one(fn) -> List[Round]:
        rd = Round()
        rd.store(L.bufs["OUT"], flat12(fn(rd)))
        return [rd]

    def line(x):
        return ((x[0][0], F2_ZERO, F2_ZERO), (F2_ZERO, x[1][1], x[1][2]))

    def pair(x):
        return (x[0], ((({}, {})), x[1][1], x[1][2]))

    inv = _easy_rounds(L)
    rd = Round()
    ti = _b(L, "TI")
    rd.store(L.bufs["OUT"], flat12((rd.f6_mul(a[0], ti), f6_neg(rd.f6_mul(a[1], ti)))))
    ops = {
        OP_MUL: one(lambda r: r.f12_mul(a, b)),
        OP_SQR: one(lambda r: r.f12_sqr(a)),
        OP_INV: inv + [rd],
        OP_FROB1: one(lambda r: r.frob(a, 1, L)),
        OP_FROB2: one(lambda r: r.frob(a, 2, L)),
        OP_CONJ: one(lambda r: f12_conj(a)),
        OP_CSQR: one(lambda r: r.f12_csqr(a)),
        OP_LINE_PAIR: one(lambda r: r.f12_mul(line(a), line(b))),
        OP_MUL_PAIR: one(lambda r: r.f12_mul(a, pair(b))),
    }
    return [_finish(ops[k], L) for k in range(len(ops))]


# -- running a schedule on Python integers ------------------------------------


def simulate(rounds: Sequence[Round], mem: Dict[int, int]) -> Dict[int, int]:
    """Run rounds on field values (not Montgomery words: every operation is
    linear or a product, so the two agree), as the kernels' interpreter does:
    all slots, then each store phase.  ``mem`` maps elements to values;
    reading an element never written raises."""
    mem = dict(mem)

    def ev(form: Lin) -> int:
        return sum(c * mem[e] for e, c in form.items()) % P

    for r in rounds:
        if r.kind == INVERT:
            (dst, form), = r.stores
            x = ev(form)
            mem[dst] = pow(x, -1, P) if x else 0
            continue
        for e in range(SLOTS):
            mem.pop(e, None)
        for s, (a, b) in enumerate(r.slots):
            mem[s] = ev(a) * ev(b) % P
        for phase in r.phases():
            vals = [(d, ev(f)) for d, f in phase]
            for d, v in vals:
                mem[d] = v
    return mem


def inputs(L: Layout, named: Dict[str, Sequence[int]]) -> Dict[int, int]:
    """Initial memory: the constants and the named buffers' values."""
    mem = {e: v for v, e in L.consts.items()}
    for name, vals in named.items():
        mem.update(zip(L.bufs[name], vals))
    return mem


# -- the tables of csrc/bls12_381_schedule.cuh -------------------------------

COEF_MIN, COEF_MAX = -8, 7  # a term is (element << 4) | (coefficient + 8)
MAX_OFFSET, MAX_STEPS = 6, 7  # the accumulator's offset codes and reduction steps


def _words(v: int) -> List[int]:
    m = v * MONT_R % P
    return [(m >> (32 * i)) & 0xFFFFFFFF for i in range(12)]


class _Tables:
    def __init__(self):
        self.terms: List[int] = []
        self.slots: List[int] = []
        self.stores: List[int] = []
        self.rounds: List[Tuple[int, int, int]] = []
        self._ids: Dict[tuple, int] = {}

    def form(self, f: Lin) -> int:
        """A form's descriptor: (first term << 14) | (terms << 6) | (offset << 3)
        | steps.  The interpreter sums the terms on a 13-word accumulator that
        starts at 2^(offset - 1) p (0 for offset 0: no negative terms), so it
        never goes negative, and stays below 2^steps p, so ``steps``
        conditional subtractions of 2^(steps - 1) p, ..., p make it
        canonical."""
        first = len(self.terms)
        for e, c in sorted(f.items()):
            while c:  # a coefficient out of range splits into terms of one element
                k = max(COEF_MIN, min(COEF_MAX, c))
                self.terms.append((e << 4) | (k + 8))
                c -= k
        count = len(self.terms) - first
        negs = sum(-c for c in f.values() if c < 0)
        pos = sum(c for c in f.values() if c > 0)
        offset = (negs - 1).bit_length() + 1 if negs else 0
        # The sum is below bound * p: with no positive term it reaches the
        # offset itself where every term is zero.
        bound = (1 << (offset - 1)) + max(pos, 1) if offset else pos
        steps = (bound - 1).bit_length() if bound else 0
        assert count < 256 and first < (1 << 18) and offset <= MAX_OFFSET and steps <= MAX_STEPS
        return (first << 14) | (count << 6) | (offset << 3) | steps

    def round_id(self, r: Round) -> int:
        key = r.key()
        rid = self._ids.get(key)
        if rid is None:
            rid = len(self.rounds)
            s0, t0 = len(self.slots) // 2, len(self.stores) // 2
            for a, b in r.slots:
                self.slots += [self.form(a), self.form(b)]
            first, second = r.phases()
            for d, f in first + second:
                self.stores += [d, self.form(f)]
            assert len(r.slots) < 256 and len(first) < 256 and len(second) < 256
            self.rounds.append((s0, t0, len(r.slots) | (len(first) << 8) | (len(second) << 16) | (r.kind << 24)))
            self._ids[key] = rid
        return rid


def _array(ctype: str, name: str, values: Sequence[int], per_line: int = 12, fmt: str = "{}") -> str:
    body = ",\n".join("    " + ", ".join(fmt.format(v) for v in values[i:i + per_line])
                      for i in range(0, len(values), per_line))
    return f"SCHED_TABLE {ctype} {name}[{len(values)}] = {{\n{body}}};\n"


def emit() -> str:
    """The header's text."""
    lm, miller = miller_rounds()
    le, exp = final_exp_rounds()
    ops = op_rounds(le)
    tab = _Tables()
    seqs = {"kMillerSeq": [tab.round_id(r) for r in miller], "kExpSeq": [tab.round_id(r) for r in exp]}
    op_seq, op_first = [], []
    for rounds in ops:
        op_first.append(len(op_seq))
        op_seq += [tab.round_id(r) for r in rounds]
    op_first.append(len(op_seq))
    assert len(tab.rounds) < 256
    out = [
        "// The pairing kernels' schedules: tables for the interpreter in\n"
        "// bls12_381.cuh.  Generated by go_ibft_tpu_torch/ops/bls_schedule.py\n"
        "// (python -m go_ibft_tpu_torch.ops.bls_schedule), which describes them;\n"
        "// do not edit.\n",
        "#pragma once\n\n#include \"lane.cuh\"\n\n"
        "#if defined(__CUDACC__)\n#define SCHED_TABLE __device__ const\n#else\n#define SCHED_TABLE static const\n#endif\n\n"
        "namespace bls {\nnamespace sched {\n\n",
        f"constexpr int kInvert = {INVERT};  // the kind of a round that inverts its one store\n"
        f"constexpr int kMillerElems = {lm.n};\nconstexpr int kExpElems = {le.n};\n"
        f"constexpr int kMillerRounds = {len(miller)};\nconstexpr int kExpRounds = {len(exp)};\n"
        f"constexpr int kMillerConsts = {len(lm.consts)};\nconstexpr int kExpConsts = {len(le.consts)};\n"
        f"constexpr int kOps = {len(ops)};\n"
        f"constexpr int kMaxSteps = {MAX_STEPS};  // a form's most conditional subtractions\n\n",
        "// A term: (element << 4) | (coefficient + 8).  A form: (first term << 14)\n"
        "// | (terms << 6) | (offset << 3) | steps: its sum starts at 2^(offset - 1) p\n"
        "// (0 for offset 0) and is canonical after subtracting 2^(steps - 1) p, ..., p\n"
        "// where it is at least that.  A slot: its two operand forms.  A store: its\n"
        "// element and form.\n"
        "// A round: first slot, first store (the first phase's, then the second's),\n"
        "// slots | first phase's stores << 8 | second phase's << 16 | kind << 24.\n",
        _array("uint16_t", "kTerms", tab.terms, 16),
        _array("uint32_t", "kSlotForms", tab.slots, 8, "0x{:x}u"),
        _array("uint32_t", "kStoreForms", tab.stores, 8, "0x{:x}u"),
        _array("uint32_t", "kRounds", [x for r in tab.rounds for x in r], 8, "0x{:x}u"),
        _array("uint8_t", "kMillerSeq", seqs["kMillerSeq"], 24),
        _array("uint8_t", "kExpSeq", seqs["kExpSeq"], 24),
        _array("uint8_t", "kOpSeq", op_seq, 24),
        _array("uint16_t", "kOpFirst", op_first, 16),
    ]
    for name, lay in (("Miller", lm), ("Exp", le)):
        consts = [x for v, e in sorted(lay.consts.items(), key=lambda kv: kv[1]) for x in [e] + _words(v)]
        out.append(f"// {name}: constants as (element, 12 Montgomery words).\n")
        out.append(_array("uint32_t", f"k{name}ConstWords", consts, 13, "0x{:x}u"))
    q = [lm.bufs[f"{n}{j}"][c] for j in range(2) for n in ("QX", "QY") for c in range(2)]
    p = [lm.bufs[f"{n}{j}"][0] for j in range(2) for n in ("PX", "PY")]
    out += [
        "// Elements of the inputs and outputs: the Miller loop's q (side, x0 x1\n"
        "// y0 y1), p (side, x y) and result; the final exponentiation's input,\n"
        "// second operand (the test ops) and result.\n",
        _array("uint16_t", "kMillerQ", q, 16),
        _array("uint16_t", "kMillerP", p, 16),
        _array("uint16_t", "kMillerOut", lm.bufs["OUT"], 16),
        _array("uint16_t", "kExpIn", le.bufs["IN"], 16),
        _array("uint16_t", "kExpB", le.bufs["B"], 16),
        _array("uint16_t", "kExpOut", le.bufs["OUT"], 16),
        "\n}  // namespace sched\n}  // namespace bls\n",
    ]
    return "".join(out)


if __name__ == "__main__":
    HEADER.write_text(emit())
    print(f"wrote {HEADER}")
