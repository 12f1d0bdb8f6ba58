"""The merge kernel's design on the CPU: its complete addition forms
(``ops/bls_schedule.py::merge_addition``), its host twin (``bls_merge_host``
of ``csrc/bls12_381.cu`` built with g++: the kernel's phases over a host
array that stands for shared memory, a block's threads one after another,
the groups packed per block as on the card), its one addition
(``bls_add_host``) and its safegcd inverse, against the host oracle
(``crypto/bls.py``) and, at small sizes, the plain version
(``ops/bls12_381.py::merge_plain``).

Points are multiples of the generators (seeded), so groups hold duplicates;
the exceptional cases are built on purpose.  Tolerance: exact equality
(integer arithmetic; the merge's output is the sum's canonical affine
coordinates, unique whatever the order of the additions).
"""

import ctypes
import random
import shutil
import subprocess

import numpy as np
import pytest
import torch

from go_ibft_tpu_torch import _build
from go_ibft_tpu_torch.crypto import bls as hbls
from go_ibft_tpu_torch.ops import bls12_381 as ops
from go_ibft_tpu_torch.ops import bls_schedule as sch

torch.set_num_threads(1)
P = hbls.P
RNG = random.Random(10)
CURVE = {
    2: (hbls.G1_GEN, hbls.g1_add, hbls.g1_neg, ops.pack_g1_points, ops.unpack_g1_points),
    4: (hbls.G2_GEN, hbls.g2_add, hbls.g2_neg, ops.pack_g2_points, ops.unpack_g2_points),
}


@pytest.fixture(scope="module")
def lane(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("needs a host C++ compiler to build the merge's host twin")
    lib = tmp_path_factory.mktemp("bls_merge") / "bls12_381_host.so"
    subprocess.run(
        [cxx, "-x", "c++", "-std=c++17", "-O2", "-shared", "-fPIC", "-Wno-unknown-pragmas", "-I",
         str(_build.CSRC), "-o", str(lib), str(_build.CSRC / "bls12_381.cu")],
        check=True, capture_output=True, timeout=300,
    )
    return ctypes.CDLL(str(lib))


@pytest.fixture(scope="module")
def pool():
    """64 multiples of each generator, affine, and their packed words."""
    out = {}
    for coords, (gen, add, neg, pack, _) in CURVE.items():
        pts = [gen]
        for _ in range(63):
            pts.append(add(pts[-1], gen))
        out[coords] = (pts, pack(pts), pack([neg(p) for p in pts]))
    return out


def _ptr(a):
    return a.ctypes.data_as(ctypes.c_void_p)


def _u32(a):
    return np.ascontiguousarray(np.asarray(a).view(np.uint32))


def _merge_host(lane, pts, live, neg_y=False):
    g, v, c = pts.shape[:3]
    out, inf = np.zeros((g, c, 12), np.uint32), np.zeros(g, np.uint8)
    assert lane.bls_merge_host(_ptr(_u32(pts)), _ptr(np.ascontiguousarray(live, dtype=np.uint8)),
                               ctypes.c_longlong(g), v, c, int(neg_y), _ptr(out), _ptr(inf)) == 0
    return out.view(np.int32), inf.astype(bool)


def _oracle(coords, points, live, neg_y=False):
    """The host oracle's sum of each group's live points (None: infinity)."""
    _, add, neg, _, _ = CURVE[coords]
    sums = []
    for row, alive in zip(points, live):
        acc = None
        for p, a in zip(row, alive):
            if a:
                acc = add(acc, p)
        sums.append(neg(acc) if neg_y and acc is not None else acc)
    return sums


def _groups(pool, coords, g, v, dead=0.2, negated=0.1):
    """g groups of v pool points (duplicates), a tenth negated, a fifth dead:
    words, live and the host points."""
    pts, pos, negs = pool[coords]
    neg = CURVE[coords][2]
    idx = np.array([[RNG.randrange(64) for _ in range(v)] for _ in range(g)])
    is_neg = np.array([[RNG.random() < negated for _ in range(v)] for _ in range(g)])
    live = np.array([[RNG.random() >= dead for _ in range(v)] for _ in range(g)])
    words = np.where(is_neg[..., None, None], negs[idx], pos[idx])
    host = [[neg(pts[i]) if n else pts[i] for i, n in zip(ri, rn)] for ri, rn in zip(idx, is_neg)]
    return np.ascontiguousarray(words), live, host


# -- the addition forms --------------------------------------------------------


def _projective(coords, pt, lam=1):
    """A host affine point (None: the identity) as (X, Y, Z) elements scaled
    by lam."""
    if pt is None:
        return [0, 1, 0] if coords == 2 else [0, 0, 1, 0, 0, 0]
    if coords == 2:
        return [pt[0] * lam % P, pt[1] * lam % P, lam % P]
    (x0, x1), (y0, y1) = pt
    return [x0 * lam % P, x1 * lam % P, y0 * lam % P, y1 * lam % P, lam % P, 0]


def _affine(coords, el):
    if coords == 2:
        x, y, z = el
        if z % P == 0:
            return None
        zi = pow(z, -1, P)
        return (x * zi % P, y * zi % P)
    z = (el[4], el[5])
    if z == (0, 0):
        return None
    zi = hbls.f2_inv(z)
    return (hbls.f2_mul((el[0], el[1]), zi), hbls.f2_mul((el[2], el[3]), zi))


def _pairs(coords):
    gen, add, neg, _, _ = CURVE[coords]
    p = add(gen, add(gen, gen))
    q = add(p, add(gen, gen))
    return [(p, q), (p, p), (p, neg(p)), (None, q), (p, None), (None, None), (q, add(p, q))]


@pytest.mark.parametrize("coords", [2, 4])
@pytest.mark.parametrize("mixed", [False, True])
def test_addition_forms_are_complete_on_every_exceptional_pair(coords, mixed):
    """The forms on Python integers: P + Q, P + P, P + (-P) and the identity
    on either side come out of the one formula (the mixed form takes
    affine points only), for any scaling of the projective inputs."""
    r1, r2, outs = sch.merge_addition(coords, mixed)
    assert len(outs) == (3 if coords == 2 else 6)
    # Two rounds of independent products: 6 + 6 on G1, 18 + 18 Fp products on
    # G2 (3 + 6 and 9 + 18 in the mixed form).
    assert (len(r1.slots), len(r2.slots)) == {(2, False): (6, 6), (2, True): (3, 6), (4, False): (18, 18),
                                              (4, True): (9, 18)}[(coords, mixed)]
    add = CURVE[coords][1]
    for a, b in _pairs(coords):
        if mixed and (a is None or b is None):
            continue
        for lam in [(1, 1)] if mixed else [(1, 1), (3, 5), (RNG.randrange(1, P), RNG.randrange(1, P))]:
            got = sch.merge_simulate(coords, mixed, _projective(coords, a, lam[0]), _projective(coords, b, lam[1]))
            assert _affine(coords, got) == add(a, b)


@pytest.mark.parametrize("coords", [2, 4])
@pytest.mark.parametrize("mixed", [False, True])
def test_host_addition_every_exceptional_pair(lane, coords, mixed):
    """``bls_add_host`` (the forms' sums on the accumulator and the register
    product) on the same pairs in Montgomery words, against the oracle."""
    add = CURVE[coords][1]
    rows, want = [], []
    for a, b in _pairs(coords):
        if mixed and (a is None or b is None):
            continue
        for lam in [(1, 1)] if mixed else [(1, 1), (RNG.randrange(1, P), RNG.randrange(1, P))]:
            rows.append(_projective(coords, a, lam[0]) + _projective(coords, b, lam[1]))
            want.append(add(a, b))
    half = 3 if coords == 2 else 6
    words = _u32(ops._pack(rows, 2 * half))
    out = np.zeros((len(rows), half, 12), np.uint32)
    assert lane.bls_add_host(coords, int(mixed), _ptr(words), _ptr(out), ctypes.c_longlong(len(rows))) == 0
    vals = ops._values(out.view(np.int32))
    got = [_affine(coords, vals[half * i:half * (i + 1)]) for i in range(len(rows))]
    assert got == want


def test_host_inverse_is_the_inverse_and_maps_zero_to_zero(lane):
    """The safegcd inverse (1,110 divsteps, then the Montgomery correction)
    against pow(x, -1, p), at the edges and at random."""
    xs = [0, 1, 2, 3, P - 1, P - 2, (P + 1) // 2, (1 << 380) % P, (1 << 384) % P, P >> 1]
    xs += [(1 << k) % P for k in (31, 32, 61, 190, 377)] + [RNG.randrange(1, P) for _ in range(200)]
    w = _u32(ops._pack([[x] for x in xs], 1))
    out = np.zeros_like(w)
    assert lane.bls_fp_inv_host(_ptr(w), _ptr(out), ctypes.c_longlong(len(xs))) == 0
    assert ops._values(out.view(np.int32)) == [pow(x, -1, P) if x else 0 for x in xs]


# -- the merge's host twin -------------------------------------------------------


def test_host_plan_packs_small_groups_and_fits_shared_memory(lane):
    """A block holds as many groups as one wave of the first level serves
    (10 G1 or 3 G2 groups of 8 on 256 threads), a block of one group has
    512 threads; a group of more than 512 points goes through a 512-point
    region; every plan fits a block's 227 KB."""
    def plan(v, coords, groups):
        threads, gpb, capg, words = (ctypes.c_int() for _ in range(4))
        lane.bls_merge_plan_host(v, coords, ctypes.c_longlong(groups), ctypes.byref(threads), ctypes.byref(gpb),
                                 ctypes.byref(capg), ctypes.byref(words))
        return threads.value, gpb.value, capg.value, words.value

    assert plan(8, 2, 1024)[:3] == (256, 10, 8)
    assert plan(8, 4, 1024)[:3] == (256, 3, 8)
    assert plan(8, 2, 7)[:3] == (256, 7, 8)
    assert plan(128, 4, 1)[:3] == (512, 1, 128)
    assert plan(1024, 4, 1)[:3] == (512, 1, 512)
    assert plan(1, 2, 100)[:3] == (256, 32, 1)
    for v in (1, 2, 3, 8, 100, 128, 129, 511, 512, 513, 1024, 5000):
        for coords in (2, 4):
            for groups in (1, 17, 1024):
                assert plan(v, coords, groups)[3] * 4 <= 227 * 1024, (v, coords, groups)


@pytest.mark.parametrize("coords", [2, 4])
@pytest.mark.parametrize("v, live_n", [(1, 1), (2, 2), (3, 3), (8, 8), (128, 100), (129, 129), (1024, 1000)])
def test_host_merge_one_group_matches_the_oracle(lane, pool, coords, v, live_n):
    """One group of v points (live_n live, the rest dead lanes at seeded
    places), duplicates and negated points among them; above 512 points the
    group goes through the region in fills."""
    words, _, host = _groups(pool, coords, 1, v, dead=0.0)
    live = np.zeros((1, v), dtype=bool)
    live[0, RNG.sample(range(v), live_n)] = True
    out, inf = _merge_host(lane, words, live)
    assert CURVE[coords][4](out, inf) == _oracle(coords, host, live)


@pytest.mark.parametrize("coords", [2, 4])
def test_host_merge_sparse_groups_past_the_region_match_the_oracle(lane, pool, coords):
    """Groups larger than a block's 512-point region whose live points are
    too few for a pair in a fill window: P, Q and -(P + Q) at 0, 512 and
    1,023 (infinity), P and Q at 0 and 1,023, one point at 1,029, none."""
    pts, add, neg = pool[coords][0], CURVE[coords][1], CURVE[coords][2]
    v = 1030
    cases = [{0: pts[3], 512: pts[9], 1023: neg(add(pts[3], pts[9]))}, {0: pts[4], 1023: pts[6]},
             {1029: pts[7]}, {}]
    words = np.zeros((len(cases), v, coords, 12), np.int32)
    live = np.zeros((len(cases), v), dtype=bool)
    host = [[None] * v for _ in cases]
    for g, case in enumerate(cases):
        for at, pt in case.items():
            words[g, at] = CURVE[coords][3]([pt])[0]
            live[g, at] = True
            host[g][at] = pt
    out, inf = _merge_host(lane, words, live)
    assert CURVE[coords][4](out, inf) == _oracle(coords, host, live)
    assert inf.tolist() == [True, False, False, True]


@pytest.mark.parametrize("coords", [2, 4])
def test_host_merge_many_groups_of_8_match_plain_and_the_oracle(lane, pool, coords):
    """17 groups of 8 (a partial last block): the cases of the card's merge
    built in: group 0 P and -P side by side, group 1 all dead, group 2 P, Q
    and -(P + Q) apart (infinity without a cancelling pair), group 3 one
    live point, group 4 duplicates only; y negated too.  Bit-exact against
    the plain version (y negated)."""
    pts = pool[coords][0]
    add, neg = CURVE[coords][1], CURVE[coords][2]
    words, live, host = _groups(pool, coords, 17, 8)
    pack = CURVE[coords][3]

    def put(g, i, pt):
        words[g, i] = pack([pt])[0]
        host[g][i] = pt
        live[g, i] = True

    put(0, 0, pts[5])
    put(0, 1, neg(pts[5]))
    live[1] = False
    live[2] = False
    put(2, 0, pts[3])
    put(2, 3, pts[9])
    put(2, 6, neg(add(pts[3], pts[9])))
    live[3] = False
    put(3, 4, pts[7])
    for i in range(8):
        put(4, i, pts[11])
    for neg_y in (False, True):
        out, inf = _merge_host(lane, words, live, neg_y)
        assert CURVE[coords][4](out, inf) == _oracle(coords, host, live, neg_y)
        assert inf[1:4].tolist() == [True, True, False]
    ref, rinf = ops.merge_plain(torch.from_numpy(words), torch.from_numpy(live), True)  # seconds a call
    assert np.array_equal(out, ref.numpy()) and np.array_equal(inf, rinf.numpy())


def test_host_merge_small_shapes_match_plain(lane, pool):
    """G1 and G2 at 1 group of 2 and 7 groups of 3 points against the plain
    version, word for word."""
    for coords in (2, 4):
        for g, v in ((1, 2), (7, 3)):
            words, live, _ = _groups(pool, coords, g, v)
            out, inf = _merge_host(lane, words, live)
            ref, rinf = ops.merge_plain(torch.from_numpy(words), torch.from_numpy(live))
            assert np.array_equal(out, ref.numpy()) and np.array_equal(inf, rinf.numpy()), (coords, g, v)
