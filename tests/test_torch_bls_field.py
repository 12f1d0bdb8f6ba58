"""The BLS12-381 field arithmetic of the port: the plain PyTorch Fp / Fp2 /
Fp12 (``ops/bls_fp.py``, ``ops/bls12_381.py``) and the CUDA kernels' lane
arithmetic (``csrc/bls12_381.cu`` built with g++ for the host), against the
JAX package's ``ops/bls_fp.py`` / ``ops/bls12_381.py`` (run eagerly, no
pairing program compiled) and the host oracle ``crypto/bls.py``.

The port keeps its elements as 12 x 32-bit words with R = 2**384 and the
JAX package as 30 x 13-bit limbs with R = 2**390, so every comparison is of
field elements as integers mod p.  Tolerance: exact equality.
"""

import ctypes
import random
import shutil
import subprocess

import numpy as np
import pytest
import torch

from go_ibft_tpu.crypto import bls as jhost
from go_ibft_tpu.ops import bls12_381 as jdev
from go_ibft_tpu.ops import bls_fp as jfp
from go_ibft_tpu.verify.aggregate import fast_miller
from go_ibft_tpu_torch import _build, convert
from go_ibft_tpu_torch.crypto import bls as hbls
from go_ibft_tpu_torch.ops import bls12_381 as ops
from go_ibft_tpu_torch.ops import bls_fp as fp

torch.set_num_threads(1)
P = hbls.P
RNG = random.Random(8)


def _ints(n):
    return [RNG.randrange(P) for _ in range(n - 3)] + [0, 1, P - 1]


def _fe(values):
    return fp.from_words(torch.from_numpy(ops._pack([[v] for v in values], 1)[:, 0]))


def _vals(x: fp.FE):
    return [v * pow(fp.R_MONT, -1, P) % P for v in fp.ints_of(fp.to_words(x))]


def _jfv(values):
    return jfp.FV(jfp.pack_mont(values), P)


def _jvals(fv):
    return jfp.from_mont_limbs(np.asarray(jfp.canon_mod_p(fv)))


def _rand12(n):
    return [ops._shape12([RNG.randrange(P) for _ in range(12)]) for _ in range(n)]


def _jf12(values):
    comps = [jfp.FV(jfp.pack_mont([v[i][j][k] for v in values]), P)
             for i in range(2) for j in range(3) for k in range(2)]
    f2 = [jfp.F2(comps[2 * m], comps[2 * m + 1]) for m in range(6)]
    return jdev.F12(jdev.F6(*f2[:3]), jdev.F6(*f2[3:]))


def _jf12_vals(f):
    """The JAX Fp12's values: its 12 leaves stacked, renormalised and
    canonicalised in one call each."""
    import jax.numpy as jnp

    leaves = [f.c0.c0.c0, f.c0.c0.c1, f.c0.c1.c0, f.c0.c1.c1, f.c0.c2.c0, f.c0.c2.c1,
              f.c1.c0.c0, f.c1.c0.c1, f.c1.c1.c0, f.c1.c1.c1, f.c1.c2.c0, f.c1.c2.c1]
    stacked = jfp.FV(jnp.stack([x.arr for x in leaves], axis=-2), max(x.bound for x in leaves))
    flat = _jvals(jfp.renorm(stacked))  # (n, 12) row-major
    return [ops._shape12(flat[12 * i:12 * i + 12]) for i in range(len(flat) // 12)]


def test_fp_products_and_inverses_match_jax_and_oracle():
    a, b = _ints(8), _ints(8)
    assert _vals(fp.mul(_fe(a), _fe(b))) == [x * y % P for x, y in zip(a, b)]
    assert _vals(fp.mul(_fe(a), _fe(b))) == _jvals(jfp.mul(_jfv(a), _jfv(b)))
    assert _vals(fp.sqr(_fe(a))) == _jvals(jfp.sqr(_jfv(a)))
    assert _vals(fp.inv(_fe(a))) == [pow(x, P - 2, P) for x in a]
    # lazy sums and differences, then a product: the bounds carry through
    s = fp.sub(fp.add(_fe(a), _fe(b)), fp.muli(_fe(b), 3))
    assert _vals(fp.mul(s, s)) == [(x - 2 * y) ** 2 % P for x, y in zip(a, b)]
    assert fp.is_zero(fp.sub(_fe(a), _fe(a))).all()
    assert fp.is_zero(_fe(a)).tolist() == [x == 0 for x in a]


def test_fp2_products_squares_inverses_match_jax():
    a = [(x, y) for x, y in zip(_ints(6), _ints(6))]
    b = [(x, y) for x, y in zip(_ints(6), _ints(6))]
    pa = fp.F2(_fe([x[0] for x in a]), _fe([x[1] for x in a]))
    pb = fp.F2(_fe([x[0] for x in b]), _fe([x[1] for x in b]))
    ja = jfp.F2(_jfv([x[0] for x in a]), _jfv([x[1] for x in a]))
    jb = jfp.F2(_jfv([x[0] for x in b]), _jfv([x[1] for x in b]))

    def both(x):
        return list(zip(_vals(x.c0), _vals(x.c1)))

    def jboth(x):
        return list(zip(_jvals(jfp.renorm(x.c0)), _jvals(jfp.renorm(x.c1))))

    assert both(fp.f2_mul(pa, pb)) == jboth(jfp.f2_mul(ja, jb)) == [hbls.f2_mul(x, y) for x, y in zip(a, b)]
    assert both(fp.f2_sqr(pa)) == jboth(jfp.f2_sqr(ja))
    assert both(fp.f2_mul_xi(pa)) == [hbls.f2_mul_xi(x) for x in a]
    nz = [x for x in a if x != (0, 0)]
    pz = fp.F2(_fe([x[0] for x in nz]), _fe([x[1] for x in nz]))
    jz = jfp.F2(_jfv([x[0] for x in nz]), _jfv([x[1] for x in nz]))
    assert both(fp.f2_inv(pz)) == jboth(jfp.f2_inv(jz)) == [hbls.f2_inv(x) for x in nz]


def test_f12_products_inverses_frobenius_match_jax_and_oracle():
    xs, ys = _rand12(2), _rand12(2)
    px = fp.from_words(torch.from_numpy(ops.pack_f12(xs)))
    py = fp.from_words(torch.from_numpy(ops.pack_f12(ys)))
    jx, jy = _jf12(xs), _jf12(ys)

    def vals(f):
        return ops.unpack_f12(fp.to_words(f))

    assert vals(ops.f12_mul(px, py)) == _jf12_vals(jdev.f12_mul(jx, jy)) == [
        hbls.f12_mul(x, y) for x, y in zip(xs, ys)]
    assert vals(ops.f12_sqr(px)) == [hbls.f12_sqr(x) for x in xs]
    assert vals(ops.f12_conj(px)) == _jf12_vals(jdev.f12_conj(jx))
    for n in (1, 2):
        assert vals(ops.f12_frob(px, n)) == _jf12_vals(jdev.f12_frob(jx, n))
    assert vals(ops.f12_frob(px, 1))[0] == hbls.f12_pow(xs[0], P)
    assert vals(ops.f12_inv(px)) == [hbls.f12_inv(x) for x in xs]


def test_packers_round_trip_and_convert_to_the_jax_layout():
    g1 = [hbls.g1_mul(k, hbls.G1_GEN) for k in (2, 9)] + [None]
    g2 = [hbls.g2_mul(k, hbls.G2_GEN) for k in (3, 4)] + [None]
    w1, w2 = ops.pack_g1_points(g1), ops.pack_g2_points(g2)
    assert ops.unpack_g1_points(w1, np.array([False, False, True])) == g1
    assert ops.unpack_g2_points(w2, np.array([False, False, True])) == g2
    for words, jarrays in ((w1, jdev.pack_g1_points(g1)), (w2, jdev.pack_g2_points(g2))):
        back = convert.bls_points(*jarrays, device="cpu")
        assert torch.equal(back, torch.from_numpy(words))
        for got, want in zip(convert.bls_point_arrays(back), jarrays):
            assert np.array_equal(got, want)


# ---------------------------------------------------------------------------
# The kernels' lane arithmetic, built for the host
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def lane(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("needs a host C++ compiler to build the lane arithmetic")
    lib = tmp_path_factory.mktemp("bls") / "bls12_381_host.so"
    subprocess.run(
        [cxx, "-x", "c++", "-std=c++17", "-O2", "-shared", "-fPIC", "-Wno-unknown-pragmas", "-I",
         str(_build.CSRC), "-o", str(lib), str(_build.CSRC / "bls12_381.cu")],
        check=True, capture_output=True, timeout=300,
    )
    return ctypes.CDLL(str(lib))


def _ptr(a):
    return a.ctypes.data_as(ctypes.c_void_p)


def _u32(a):
    return np.ascontiguousarray(np.asarray(a).view(np.uint32))


def test_lane_fp_products_and_inverses_match_the_oracle(lane):
    a, b = _ints(12), _ints(12)
    wa, wb = _u32(ops._pack([[v] for v in a], 1)), _u32(ops._pack([[v] for v in b], 1))
    out = np.zeros_like(wa)
    lane.bls_fp_mul_host(_ptr(wa), _ptr(wb), _ptr(out), ctypes.c_longlong(len(a)))
    assert ops._values(out.view(np.int32)) == [x * y % P for x, y in zip(a, b)]
    lane.bls_fp_inv_host(_ptr(wa), _ptr(out), ctypes.c_longlong(len(a)))
    assert ops._values(out.view(np.int32)) == [pow(x, P - 2, P) for x in a]


def test_lane_f12_operations_match_the_oracle(lane):
    xs, ys = _rand12(2), _rand12(2)
    wx, wy = _u32(ops.pack_f12(xs)), _u32(ops.pack_f12(ys))
    out = np.zeros_like(wx)
    ref = {0: lambda x, y: hbls.f12_mul(x, y), 1: lambda x, y: hbls.f12_sqr(x), 2: lambda x, y: hbls.f12_inv(x),
           3: lambda x, y: hbls.f12_pow(x, P), 4: lambda x, y: hbls.f12_pow(x, P * P),
           5: lambda x, y: (x[0], hbls.f6_neg(x[1]))}
    for op, fn in ref.items():
        lane.bls_f12_op_host(op, _ptr(wx), _ptr(wy), _ptr(out), ctypes.c_longlong(2))
        assert ops.unpack_f12(out.view(np.int32)) == [fn(x, y) for x, y in zip(xs, ys)], op


def test_lane_g2_addition_every_exceptional_case(lane):
    p, q = hbls.g2_mul(5, hbls.G2_GEN), hbls.g2_mul(7, hbls.G2_GEN)
    cases = [(p, q), (p, p), (p, hbls.g2_neg(p)), (None, q), (p, None), (None, None)]
    wp = _u32(ops.pack_g2_points([c[0] for c in cases]))
    wq = _u32(ops.pack_g2_points([c[1] for c in cases]))
    pi = np.array([c[0] is None for c in cases], np.uint8)
    qi = np.array([c[1] is None for c in cases], np.uint8)
    out, oi = np.zeros_like(wp), np.zeros(len(cases), np.uint8)
    lane.bls_g2_add_host(_ptr(wp), _ptr(pi), _ptr(wq), _ptr(qi), _ptr(out), _ptr(oi), ctypes.c_longlong(len(cases)))
    assert ops.unpack_g2_points(out.view(np.int32), oi) == [hbls.g2_add(a, b) for a, b in cases]


def test_lane_merge_miller_and_final_exp_match_plain_jax_and_oracle(lane):
    """One group merged, one lane's Miller loops and final exponentiation:
    the host build equals the plain versions bit for bit, the Miller value
    equals the JAX package's (its host twin ``fast_miller``, conjugated),
    and the result equals the host pairing ratio cubed."""
    pts = [hbls.g2_mul(k, hbls.G2_GEN) for k in (3, 5, 8)]
    pts += [hbls.g2_neg(pts[0]), pts[1], None]
    live = np.array([[p is not None for p in pts]])
    wpts = ops.pack_g2_points(pts)[None]
    out, inf = np.zeros((1, 4, 12), np.uint32), np.zeros(1, np.uint8)
    lane.bls_merge_host(_ptr(_u32(wpts)), _ptr(live.astype(np.uint8)), ctypes.c_longlong(1), 6, 4, 0,
                        _ptr(out), _ptr(inf))
    ref, rinf = ops.merge_plain(torch.from_numpy(wpts), torch.from_numpy(live))
    assert np.array_equal(out.view(np.int32), ref.numpy()) and bool(inf[0]) == bool(rinf[0])
    assert ops.unpack_g2_points(out.view(np.int32), inf) == [hbls.aggregate_signatures(pts[:5])]

    msg = b"\x22" * 32
    h = hbls.hash_to_g2(msg)
    keys = [hbls.BLSPrivateKey(k) for k in (11, 12)]
    s = hbls.aggregate_signatures([k.sign(msg) for k in keys])
    pk = hbls.aggregate_pubkeys([k.pubkey for k in keys])
    q = np.stack([ops.pack_g2_points([s]), ops.pack_g2_points([h])])
    p = np.stack([ops.pack_g1_points([hbls.G1_GEN]), ops.pack_g1_points([hbls.g1_neg(pk)])])
    f = np.zeros((1, 12, 12), np.uint32)
    lane.bls_miller_host(_ptr(_u32(q)), _ptr(_u32(p)), ctypes.c_longlong(1), _ptr(f))
    plain = ops.miller_plain(torch.from_numpy(q), torch.from_numpy(p))
    assert np.array_equal(f.view(np.int32), plain.numpy())
    def conj(a):  # f^(p^6)
        return (a[0], jhost.f6_neg(a[1]))

    jax_value = jhost.f12_mul(conj(fast_miller(s, hbls.G1_GEN)), conj(fast_miller(h, hbls.g1_neg(pk))))
    assert ops.unpack_f12(f.view(np.int32))[0] == jax_value

    gate, ok, r = np.ones(1, np.uint8), np.zeros(1, np.uint8), np.zeros_like(f)
    lane.bls_final_exp_host(_ptr(f), _ptr(gate), ctypes.c_longlong(1), _ptr(ok), _ptr(r))
    pok, pr = ops.final_exp_plain(plain, torch.ones(1, dtype=torch.bool))
    assert bool(ok[0]) and bool(pok[0]) and np.array_equal(r.view(np.int32), pr.numpy())
    assert ops.unpack_f12(r.view(np.int32))[0] == hbls.F12_ONE
    # a lane that fails: the result is the host pairing ratio cubed
    bad = hbls.g2_mul(2, s)
    q[0, 0] = ops.pack_g2_points([bad])[0]
    lane.bls_miller_host(_ptr(_u32(q)), _ptr(_u32(p)), ctypes.c_longlong(1), _ptr(f))
    lane.bls_final_exp_host(_ptr(f), _ptr(gate), ctypes.c_longlong(1), _ptr(ok), _ptr(r))
    ratio = hbls.f12_mul(hbls.pairing(bad, hbls.G1_GEN), hbls.pairing(h, hbls.g1_neg(pk)))
    assert not ok[0] and ops.unpack_f12(r.view(np.int32))[0] == hbls.f12_pow(ratio, 3)
