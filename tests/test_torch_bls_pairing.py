"""The pairing kernels' schedules (``ops/bls_schedule.py``) and their host
twins (``csrc/bls12_381.cu`` built with g++): the Miller loop with one
accumulator for a lane's two sides, the final exponentiation with
cyclotomic squarings and a Kaliski inverse, and each tower formula the
schedules use, against the port's plain versions (``ops/bls12_381.py``)
and the host oracle (``crypto/bls.py``).

The host twins run each round as the kernels do: every phase's threads one
after another over a host array that stands for shared memory.  Inputs are
seeded.  Tolerance: exact equality (integer arithmetic).
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
RNG = random.Random(9)
ZERO12 = ((hbls.F2_ZERO,) * 3,) * 2


def _rand12():
    return ops._shape12([RNG.randrange(P) for _ in range(12)])


def _easy(f):
    """f^((p^6 - 1)(p^2 + 1)): an element of the cyclotomic subgroup."""
    e = hbls.f12_mul((f[0], hbls.f6_neg(f[1])), hbls.f12_inv(f))
    return hbls.f12_mul(hbls.f12_pow(e, P * P), e)


def _flat(f):
    return [c for half in f for pair in half for c in pair]


@pytest.fixture(scope="module")
def lane(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("needs a host C++ compiler to build the kernels' host twins")
    lib = tmp_path_factory.mktemp("bls_pairing") / "bls12_381_host.so"
    subprocess.run(
        [cxx, "-x", "c++", "-std=c++17", "-O2", "-shared", "-fPIC", "-Wno-unknown-pragmas", "-I",
         str(_build.CSRC), "-o", str(lib), str(_build.CSRC / "bls12_381.cu")],
        check=True, capture_output=True, timeout=300,
    )
    return ctypes.CDLL(str(lib))


@pytest.fixture(scope="module")
def lanes():
    """Three Miller lanes: a valid 2-signer aggregate, pool points, and a (0, 0)
    G2 point on side 0 (an all-dead merge group)."""
    msg = b"\x33" * 32
    keys = [hbls.BLSPrivateKey(k) for k in (4, 9)]
    s = hbls.aggregate_signatures([k.sign(msg) for k in keys])
    pk = hbls.aggregate_pubkeys([k.pubkey for k in keys])
    g2 = [hbls.g2_mul(k, hbls.G2_GEN) for k in (3, 5, 6)]
    g1 = [hbls.g1_mul(k, hbls.G1_GEN) for k in (2, 7)]
    sides = [[s, g2[0], None], [hbls.hash_to_g2(msg), g2[1], g2[2]]]
    ps = [[hbls.G1_GEN] * 3, [hbls.g1_neg(pk), g1[0], g1[1]]]
    q = np.stack([ops.pack_g2_points(x) for x in sides])
    p = np.stack([ops.pack_g1_points(x) for x in ps])
    return sides, ps, q, p, ops.miller_plain(torch.from_numpy(q), torch.from_numpy(p))


def _ptr(a):
    return a.ctypes.data_as(ctypes.c_void_p)


def _u32(a):
    return np.ascontiguousarray(np.asarray(a).view(np.uint32))


def _f12_op(lane, op, xs, ys=None):
    wx = _u32(ops.pack_f12(xs))
    wy = _u32(ops.pack_f12(ys)) if ys is not None else None
    out = np.zeros_like(wx)
    assert lane.bls_f12_op_host(op, _ptr(wx), _ptr(wy) if wy is not None else None, _ptr(out),
                                ctypes.c_longlong(len(xs))) == 0
    return ops.unpack_f12(out.view(np.int32))


# -- the schedules ------------------------------------------------------------


def test_header_is_the_generators_output():
    """csrc/bls12_381_schedule.cuh is what ops/bls_schedule.py writes."""
    assert sch.HEADER.read_text() == sch.emit()


@pytest.mark.parametrize("build", [sch.miller_rounds, sch.final_exp_rounds])
def test_rounds_keep_the_race_free_rules_and_fit_the_product_region(build):
    layout, rounds = build()
    for r in rounds:
        r.check()
        assert len(r.slots) <= sch.SLOTS
        assert all(d >= sch.SLOTS for d, _ in r.stores)
        assert all(e >= sch.SLOTS for a, b in r.slots for f in (a, b) for e in f)
    assert layout.n * 48 < 48 * 1024  # a lane's elements fit in a block's static shared memory
    products = sum(len(r.slots) for r in rounds)
    # Fp products a lane: 11,266 and 7,617 (the first version's kernels
    # made about 14,000 and 19,600).
    assert products < (11500 if build is sch.miller_rounds else 7700), products


def test_simulated_miller_equals_plain_and_the_product_of_the_sides(lanes):
    """The schedule on Python integers: the shared accumulator's value is
    the plain version's, which is the product of the two sides' values."""
    sides, ps, q, p, plain = lanes
    layout, rounds = sch.miller_rounds()
    want = ops.unpack_f12(plain)
    for i in range(2):
        named = {}
        for j in range(2):
            named.update({f"QX{j}": list(sides[j][i][0]), f"QY{j}": list(sides[j][i][1]),
                          f"PX{j}": [ps[j][i][0]], f"PY{j}": [ps[j][i][1]]})
        mem = sch.simulate(rounds, sch.inputs(layout, named))
        assert sch.shape12([mem[e] for e in layout.bufs["OUT"]]) == want[i]
    one_side = [ops.unpack_f12(ops.fp.to_words(ops._miller_side(*_side(q, p, j))))[0] for j in range(2)]
    assert hbls.f12_mul(*one_side) == want[0]


def _side(q, p, j):
    """Side j of lane 0 as the plain version's inputs."""
    qx = ops.fp.F2(*(ops.fp.take(ops.fp.from_words(torch.from_numpy(q[j, :1])), c) for c in (0, 1)))
    qy = ops.fp.F2(*(ops.fp.take(ops.fp.from_words(torch.from_numpy(q[j, :1])), c) for c in (2, 3)))
    pw = ops.fp.from_words(torch.from_numpy(p[j, :1]))
    return qx, qy, ops.fp.take(pw, 0), ops.fp.take(pw, 1)


def test_simulated_final_exp_equals_the_oracle_cubed():
    layout, rounds = sch.final_exp_rounds()
    for f in (_rand12(), ZERO12):
        mem = sch.simulate(rounds, sch.inputs(layout, {"IN": _flat(f)}))
        got = sch.shape12([mem[e] for e in layout.bufs["OUT"]])
        want = ZERO12 if f == ZERO12 else hbls.f12_pow(hbls.final_exponentiation(f), 3)
        assert got == want


# -- the host twins ------------------------------------------------------------


def test_host_miller_and_final_exp_match_plain_and_the_oracle(lane, lanes):
    """The kernels' schedules on the host: bit-exact against the plain
    versions on a valid lane, a pool lane and a (0, 0) G2 point; the final
    exponentiation of the Miller value is the host pairing ratio cubed."""
    sides, ps, q, p, plain = lanes
    n = q.shape[1]
    f = np.zeros((n, 12, 12), np.uint32)
    lane.bls_miller_host(_ptr(_u32(q)), _ptr(_u32(p)), ctypes.c_longlong(n), _ptr(f))
    assert np.array_equal(f.view(np.int32), plain.numpy())
    gate = np.ones(n, np.uint8)
    ok, r = np.zeros(n, np.uint8), np.zeros_like(f)
    lane.bls_final_exp_host(_ptr(f), _ptr(gate), ctypes.c_longlong(n), _ptr(ok), _ptr(r))
    pok, pres = ops.final_exp_plain(plain, torch.ones(n, dtype=torch.bool))
    assert np.array_equal(r.view(np.int32), pres.numpy()) and ok.tolist() == pok.to(torch.uint8).tolist()
    assert ok.tolist() == [1, 0, 0]
    ratio = hbls.f12_mul(hbls.pairing(sides[0][1], ps[0][1]), hbls.pairing(sides[1][1], ps[1][1]))
    assert ops.unpack_f12(r.view(np.int32))[1] == hbls.f12_pow(ratio, 3)


def test_host_final_exp_on_degenerate_lanes(lane, lanes):
    """A zero Miller value gives zeros (and no verdict); a gate of 0 masks a
    lane whose result is one."""
    plain = lanes[4]
    f = np.ascontiguousarray(np.stack([np.zeros((12, 12), np.int32), plain[0].numpy(), plain[0].numpy()]))
    gate = np.array([1, 0, 1], np.uint8)
    ok, r = np.zeros(3, np.uint8), np.zeros((3, 12, 12), np.uint32)
    lane.bls_final_exp_host(_ptr(_u32(f)), _ptr(gate), ctypes.c_longlong(3), _ptr(ok), _ptr(r))
    pok, pres = ops.final_exp_plain(torch.from_numpy(f), torch.from_numpy(gate.astype(bool)))
    assert np.array_equal(r.view(np.int32), pres.numpy())
    assert ok.tolist() == [0, 0, 1] == pok.to(torch.uint8).tolist()
    assert not r[0].any() and ops.unpack_f12(r[1].view(np.int32))[0] == hbls.F12_ONE


def _line(f):
    """The sparse line of f's w-basis slots 0, 3, 5 (c0.c0, c1.c1, c1.c2)."""
    return ((f[0][0], hbls.F2_ZERO, hbls.F2_ZERO), (hbls.F2_ZERO, f[1][1], f[1][2]))


def _pair(f):
    """f with c1.c0 = 0: the shape of a product of two lines."""
    return (f[0], (hbls.F2_ZERO, f[1][1], f[1][2]))


FORMULAS = {
    "square": (sch.OP_SQR, lambda x, y: hbls.f12_sqr(x)),
    "cyclotomic_square": (sch.OP_CSQR, lambda x, y: hbls.f12_sqr(x)),
    "line_pair": (sch.OP_LINE_PAIR, lambda x, y: hbls.f12_mul(_line(x), _line(y))),
    "times_line_pair": (sch.OP_MUL_PAIR, lambda x, y: hbls.f12_mul(x, _pair(y))),
    "inverse": (sch.OP_INV, lambda x, y: hbls.f12_inv(x)),
}


@pytest.mark.parametrize("name", sorted(FORMULAS))
def test_host_tower_formula_matches_the_oracle(lane, name):
    """Each tower formula of the schedules through bls_f12_op_host; the
    cyclotomic squaring on easy-part outputs (its domain), and zero maps to
    zero under the squarings and the inverse."""
    op, ref = FORMULAS[name]
    xs, ys = [_rand12(), _rand12()], [_rand12(), _rand12()]
    if op == sch.OP_CSQR:
        xs = [_easy(x) for x in xs]
    assert _f12_op(lane, op, xs, ys) == [ref(x, y) for x, y in zip(xs, ys)]
    if op in (sch.OP_SQR, sch.OP_CSQR, sch.OP_INV):
        assert _f12_op(lane, op, [ZERO12], [ZERO12]) == [ZERO12]


def test_host_fp_inverse_is_the_inverse_and_maps_zero_to_zero(lane):
    """Kaliski's inverse in the Montgomery domain against pow(x, -1, p)."""
    xs = [0, 1, 2, P - 1, P - 2, (P + 1) // 2] + [RNG.randrange(1, P) for _ in range(26)]
    w = _u32(ops._pack([[x] for x in xs], 1))
    out = np.zeros_like(w)
    lane.bls_fp_inv_host(_ptr(w), _ptr(out), ctypes.c_longlong(len(xs)))
    assert ops._values(out.view(np.int32)) == [pow(x, -1, P) if x else 0 for x in xs]


def test_host_final_exp_wide_batch_runs_the_32_thread_schedule_to_the_same_words(lane, lanes):
    """From 512 lanes on the kernel (and its twin) runs a lane on 32 threads
    instead of 64: the same words as the narrow launch."""
    plain = lanes[4].numpy()
    narrow = np.ascontiguousarray(plain[:2])
    wide = np.ascontiguousarray(np.tile(narrow, (256, 1, 1)))
    outs = []
    for f in (narrow, wide):
        n = f.shape[0]
        gate, ok, r = np.ones(n, np.uint8), np.zeros(n, np.uint8), np.zeros(f.shape, np.uint32)
        lane.bls_final_exp_host(_ptr(_u32(f)), _ptr(gate), ctypes.c_longlong(n), _ptr(ok), _ptr(r))
        outs.append((ok, r))
    assert np.array_equal(outs[1][1], np.tile(outs[0][1], (256, 1, 1)))
    assert outs[1][0].tolist() == outs[0][0].tolist() * 256 == [1, 0] * 256
