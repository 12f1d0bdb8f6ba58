"""``k1*G + k2*Q`` and ECDSA verification in the port on the CPU.

* ``csrc/secp256k1_ecmul2.cu`` (entries ``secp256k1_ecmul2`` and
  ``secp256k1_verify``) has a portable C++ twin of every PTX chain and of
  the shuffle layer (``csrc/lane.cuh``: a group's four threads run as a
  loop), so a host compiler builds it; the host build
  (``secp256k1_ecmul2_host``, ``secp256k1_verify_host``: a lane's four
  roles one after the other, in the order of the card's barriers) is held
  against the port's plain versions on every lane of
  ``bench/lanes.py::build_verify_lanes``
  (off-curve keys, ``x = r + N``, out-of-range ``r``/``s``, infinity and
  the scalar edges among them), and both against the JAX package's host
  oracle (``go_ibft_tpu.crypto.ecdsa``: ``verify``, and ``scalar_mul`` +
  ``_add``) on the lanes whose key is on the curve (the oracle rejects any
  other key); its products (``secp256k1_fp_mul_host``) against Python's
  integers on operands whose carries cross every word.
* ``ops/ecverify.py``: the wrappers take the plain version for a CPU
  tensor and count no launch, and broadcast by the JAX functions' rules
  (their batch shapes against ``jax.eval_shape`` of the JAX functions);
  the launchers refuse what the kernel does not take; the recovery's plain
  path never reaches the dispatching ``ecmul2_base``.
* Slow tier: the plain versions against the JAX device ``ecmul2_base`` /
  ``ecdsa_verify`` on the off-curve and edge lanes, at the 4- and 6-lane
  shapes ``tests/test_secp256k1.py`` compiles (the XLA:CPU ladder takes
  minutes to compile).  The CUDA build runs only on the card
  (``tests/test_torch_cuda.py``).

Inputs are made from numpy seeds.  Tolerance: exact equality of the
infinity flag, the canonical affine point and the mask.
"""

import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch

from go_ibft_tpu.crypto import ecdsa as jax_ecdsa
from go_ibft_tpu_torch import _build
from go_ibft_tpu_torch.bench import build_verify_lanes
from go_ibft_tpu_torch.crypto import ecdsa
from go_ibft_tpu_torch.ops import ecrecover, ecverify
from go_ibft_tpu_torch.ops import fields as tf
from go_ibft_tpu_torch.ops import secp256k1 as sec

# Tiny tensors: one intra-op thread beats a pool per xdist worker.
torch.set_num_threads(1)

_ECMUL2 = ("k1", "k2", "qx", "qy")
_VERIFY = ("qx", "qy", "z", "r", "s")
_OFF_CURVE = ("Q off the curve (y + 1)", "Q = (0, 0)")


def _tensors(arr, names):
    return [torch.from_numpy(np.ascontiguousarray(arr[k])) for k in names]


def _affine(x, y, z):
    """Per lane, ``None`` at infinity, else the affine point as ints, for
    Jacobian limbs of any form (the port's or the JAX package's)."""
    out = []
    for xi, yi, zi in zip(tf.from_limbs(np.asarray(x)), tf.from_limbs(np.asarray(y)),
                          tf.from_limbs(np.asarray(z))):
        zi %= sec.P
        if zi == 0:
            out.append(None)
            continue
        zinv = pow(zi, -1, sec.P)
        out.append((xi * zinv**2 % sec.P, yi * zinv**3 % sec.P))
    return out


@pytest.fixture(scope="module")
def lanes():
    return build_verify_lanes(4, seed=5)


@pytest.fixture(scope="module")
def plain(lanes):
    """The plain versions through the wrappers, each lane once."""
    arr = lanes.arrays()
    pt = ecverify.ecmul2(*_tensors(arr, _ECMUL2))
    ok = ecverify.verify(*_tensors(arr, _VERIFY))
    return _affine(*pt), ok.numpy()


@pytest.fixture(scope="module")
def host_kernel(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("needs a host C++ compiler to build the lane arithmetic")
    lib = tmp_path_factory.mktemp("lane") / "secp256k1_ecmul2_host.so"
    subprocess.run(
        [cxx, "-x", "c++", "-std=c++17", "-O2", "-shared", "-fPIC", "-I", str(_build.CSRC),
         "-o", str(lib), str(_build.CSRC / "secp256k1_ecmul2.cu")],
        check=True, capture_output=True, timeout=300,
    )
    dll = ctypes.CDLL(str(lib))
    dll.secp256k1_ecmul2_host.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_longlong]
    dll.secp256k1_verify_host.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_longlong]
    dll.secp256k1_fp_mul_host.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                                          ctypes.c_longlong]
    gtab = np.ascontiguousarray(ecrecover.comb_table())

    def ptrs(arr, names):
        return [np.ascontiguousarray(arr[k]).ctypes.data for k in names]

    def ecmul2(arr):
        n = len(arr["lane"])
        out = [np.zeros((n, 20), np.int32) for _ in range(3)]
        assert dll.secp256k1_ecmul2_host(*ptrs(arr, _ECMUL2), gtab.ctypes.data,
                                         *(o.ctypes.data for o in out), n) == 0
        return out

    def verify(arr):
        ok = np.zeros(len(arr["lane"]), np.uint8)
        assert dll.secp256k1_verify_host(*ptrs(arr, _VERIFY), gtab.ctypes.data, ok.ctypes.data,
                                         len(ok)) == 0
        return ok.astype(bool)

    def fp_mul(a, b, form):
        """The kernel's products of the values ``a``, ``b`` (Python ints
        below 2**256) as its point operations run them: four a step of a
        group (``"mul"``, ``"sqr"`` of ``a``), or each spread over a group
        (``"split"``)."""
        words = [np.frombuffer(b"".join(v.to_bytes(32, "little") for v in vals), dtype="<u4").copy()
                 for vals in (a, b)]
        out = np.zeros(8 * len(a), np.uint32)
        assert dll.secp256k1_fp_mul_host(words[0].ctypes.data, words[1].ctypes.data,
                                         ("mul", "sqr", "split").index(form), out.ctypes.data, len(a)) == 0
        return [int.from_bytes(out[8 * i:8 * i + 8].tobytes(), "little") for i in range(len(a))]

    return ecmul2, verify, fp_mul


@pytest.fixture(scope="module")
def jax_oracle(lanes):
    """The JAX package's host oracle on the lanes whose key is on the
    curve: ``k1*G + k2*Q`` (``None``: infinity) and the verification."""
    g = (jax_ecdsa.GX, jax_ecdsa.GY)
    points, masks = {}, {}
    for i, on in enumerate(lanes.on_curve()):
        if on:
            q = (lanes.qx[i], lanes.qy[i])
            points[i] = jax_ecdsa._add(jax_ecdsa.scalar_mul(lanes.k1[i] % sec.N, g),
                                       jax_ecdsa.scalar_mul(lanes.k2[i] % sec.N, q))
            masks[i] = jax_ecdsa.verify(*q, lanes.z[i].to_bytes(32, "big"), lanes.r[i], lanes.s[i])
    return points, masks


def test_verify_lanes_hold_the_cases_they_name(lanes, jax_oracle):
    """The builder's lanes are what their labels say: real signatures
    verify, the ``x = r + N`` lane verifies only through its second branch,
    the infinity lanes are infinity, the off-curve keys are off the curve;
    and the port's host oracle agrees with the JAX package's."""
    points, masks = jax_oracle
    labels = lanes.labels
    assert lanes.expected_points() == points and lanes.expected_masks() == masks
    assert set(_OFF_CURVE) <= set(labels)
    for i, label in enumerate(labels):
        on = ecdsa.on_curve(lanes.qx[i], lanes.qy[i])
        assert on == (label not in _OFF_CURVE), label
        if label in ("valid", "x = r + N"):
            assert masks[i], label
        if label == "x = r + N":
            assert lanes.r[i] < sec.P - sec.N and points[i][0] == lanes.r[i] + sec.N
        if label in ("u1 G + u2 Q = infinity", "k1 = k2 = 0", "Q = G, k1 = N - k2"):
            assert points[i] is None, label
        if label in ("k1 in [N, 2N)", "k2 in [N, 2N)"):
            assert sec.N <= max(lanes.k1[i], lanes.k2[i]) < 2 * sec.N
    assert not any(masks[i] for i, label in enumerate(labels)
                   if label.startswith(("r = ", "s = ", "wrong key", "x = r + N, s")))
    arr = lanes.arrays(7, labels=("valid",))
    assert [labels[i] for i in arr["lane"]] == ["valid"] * 7 and arr["qx"].shape == (7, 20)


def test_ecmul2_host_build_matches_plain_on_every_lane(lanes, plain, host_kernel):
    x, y, z = host_kernel[0](lanes.arrays())
    got = _affine(x, y, z)
    for i, label in enumerate(lanes.labels):
        assert got[i] == plain[0][i], label
        # Canonical limbs; infinity as (1, 1, 0).
        coords = [tf.from_limbs(c[i:i + 1])[0] for c in (x, y, z)]
        assert all(0 <= c < sec.P for c in coords), label
        assert (coords == [1, 1, 0]) == (got[i] is None), label
    assert ((0 <= np.stack([x, y, z])) & (np.stack([x, y, z]) < 8192)).all()


def test_verify_host_build_matches_plain_on_every_lane(lanes, plain, host_kernel):
    got = host_kernel[1](lanes.arrays())
    for i, label in enumerate(lanes.labels):
        assert bool(got[i]) == bool(plain[1][i]), label
    assert plain[1].sum() >= 6  # the valid lanes, x = r + N and the scalar lanes on q0


@pytest.mark.parametrize("entry", ["ecmul2", "verify"])
def test_host_build_and_plain_match_jax_host_oracle_on_the_curve(lanes, plain, host_kernel, jax_oracle, entry):
    arr = lanes.arrays()
    points, masks = jax_oracle
    if entry == "ecmul2":
        got, ref, want = _affine(*host_kernel[0](arr)), plain[0], points
    else:
        got, ref, want = list(host_kernel[1](arr)), list(plain[1]), masks
    assert len(want) == len(lanes) - len(_OFF_CURVE)
    for i, expect in want.items():
        assert got[i] == expect and ref[i] == expect, lanes.labels[i]


def test_host_build_matches_plain_on_repeated_lanes(lanes, plain, host_kernel):
    """A batch of 37 rows (the lanes repeated, two blocks' worth on the
    card) gives each row its lane's result."""
    arr = lanes.arrays(37)
    pts, oks = _affine(*host_kernel[0](arr)), host_kernel[1](arr)
    for row, lane in enumerate(arr["lane"]):
        assert pts[row] == plain[0][lane] and bool(oks[row]) == bool(plain[1][lane])


# Operands whose products carry across every word: all-ones words, P - 1,
# N - 1, 2**255, and the squares of the first three (mod P).
_ONES = 2**256 - 1
_EDGES = (_ONES, sec.P - 1, sec.N - 1, 2**255, _ONES**2 % sec.P, (sec.P - 1) ** 2 % sec.P,
          (sec.N - 1) ** 2 % sec.P)


@pytest.mark.parametrize("form", ["mul", "sqr", "split"])
def test_grouped_products_at_the_carry_edges(host_kernel, form):
    """The kernel's field products (four a step of a group, the square, and
    one product spread over a group's threads, whose partial sums carry
    across every thread's words), on every pair of edge operands (and a
    seeded random tail, so the last step is a partial one) against
    Python's integers mod P."""
    rng = np.random.default_rng(17)
    rand = [int.from_bytes(rng.bytes(32), "little") for _ in range(5)]
    vals = list(_EDGES) + rand
    square = form == "sqr"
    a = [x for x in vals for _ in vals] if not square else vals
    b = [y for _ in vals for y in vals] if not square else vals
    got = host_kernel[2](a, b, form)
    want = [x * x % sec.P for x in a] if square else [x * y % sec.P for x, y in zip(a, b)]
    assert got == want


def test_wrappers_on_cpu_run_plain_and_count_no_launch(lanes):
    arr = lanes.arrays(2)
    before = (ecverify.ecmul2.launches, ecverify.verify.launches)
    pt = sec.ecmul2_base(*_tensors(arr, _ECMUL2))
    ok = sec.ecdsa_verify(*_tensors(arr, _VERIFY))
    assert (ecverify.ecmul2.launches, ecverify.verify.launches) == before
    assert pt.z.shape == (2, 20) and ok.shape == (2,) and ok.dtype == torch.bool
    with pytest.raises(ValueError):
        sec.ecmul2_base(*(t.to("meta") for t in _tensors(arr, _ECMUL2)))
    with pytest.raises(ValueError):
        ecverify.verify(*(t.to("meta") for t in _tensors(arr, _VERIFY)))


def test_launchers_refuse_cpu_and_malformed_inputs(lanes):
    arr = lanes.arrays(3)
    k1, k2, qx, qy = _tensors(arr, _ECMUL2)
    z, r, s = _tensors(arr, ("z", "r", "s"))
    with pytest.raises(ValueError, match="CUDA"):
        ecverify.launch_ecmul2(k1, k2, qx, qy)  # no quiet CPU path behind the kernel
    with pytest.raises(ValueError, match="CUDA"):
        ecverify.launch_verify(qx, qy, z, r, s)
    with pytest.raises(TypeError):
        ecverify.launch_ecmul2(k1, k2.to(torch.int64), qx, qy)
    with pytest.raises(TypeError):
        ecverify.verify(qx, qy, z, r, s.to(torch.int64))
    with pytest.raises(ValueError, match="one shape"):
        ecverify.launch_ecmul2(k1, k2[:1], qx, qy)  # the plain version would broadcast
    with pytest.raises(ValueError, match="one shape"):
        ecverify.launch_verify(qx, qy, z[:, :19], r, s)
    with pytest.raises(ValueError, match="contiguous"):
        ecverify.launch_ecmul2(k1, k2, qx.t().contiguous().t(), qy)
    with pytest.raises(ValueError, match="contiguous"):
        ecverify.launch_verify(qx, qy, z, r, s.t().contiguous().t())


def test_a_broadcast_call_reaches_the_launcher_at_one_contiguous_shape(lanes, monkeypatch):
    """The card route of ``ecverify.ecmul2`` / ``verify`` (its route forced,
    its launcher recording) hands the launcher the inputs expanded to the
    JAX function's batch shape, contiguous, with the values of the
    explicitly expanded call: one ``(20,)`` key against 3 scalar pairs or
    signatures, and a transposed view."""
    arr = lanes.arrays(3)
    t = {k: torch.from_numpy(np.ascontiguousarray(arr[k])) for k in set(_ECMUL2 + _VERIFY)}
    seen = []

    def record(*args):
        seen.append(args)
        return sec.point_infinity((3,), "cpu") if len(args) == 4 else torch.zeros(3, dtype=torch.bool)

    monkeypatch.setattr(ecverify, "_route", lambda wrapper, x: "cuda")
    monkeypatch.setattr(ecverify, "launch_ecmul2", record)
    monkeypatch.setattr(ecverify, "launch_verify", record)
    monkeypatch.setattr(ecverify._build, "count_launch", lambda wrapper: None)
    qx_t = t["qx"].t().contiguous().t()
    ecverify.ecmul2(t["k1"], t["k2"], t["qx"][1], t["qy"][1])
    ecverify.ecmul2(t["k1"], t["k2"], qx_t, t["qy"])
    ecverify.verify(t["qx"][1], t["qy"][1], t["z"], t["r"], t["s"])
    ecverify.verify(t["qx"], t["qy"], t["z"][2], t["r"], t["s"])
    wants = [
        (t["k1"], t["k2"], t["qx"][1].expand(3, 20), t["qy"][1].expand(3, 20)),
        tuple(t[k] for k in _ECMUL2),
        (t["qx"][1].expand(3, 20), t["qy"][1].expand(3, 20), t["z"], t["r"], t["s"]),
        (t["qx"], t["qy"], t["z"][2].expand(3, 20), t["r"], t["s"]),
    ]
    assert len(seen) == len(wants)
    for got, want in zip(seen, wants):
        for g, w in zip(got, want):
            assert g.shape == (3, 20) and g.is_contiguous() and torch.equal(g, w)
    with pytest.raises(ValueError):  # the JAX ecmul2_base refuses a k1 of fewer leading axes
        ecverify.ecmul2(t["k1"][0], t["k2"], t["qx"], t["qy"])
    with pytest.raises(ValueError):
        ecverify.verify(t["qx"], t["qy"], t["z"][:2], t["r"], t["s"])


# Leading shapes of (k1, k2, qx, qy), (qx, qy, z, r, s) and (z, r, s, v):
# where the JAX functions broadcast and where they raise.
_BATCH_CASES = [
    ("ecmul2_base", ((4,), (4,), (), ())),
    ("ecmul2_base", ((), (4,), (4,), (4,))),
    ("ecmul2_base", ((1,), (4,), (4,), (4,))),
    ("ecmul2_base", ((2, 1), (2, 1), (3,), (3,))),
    ("ecmul2_base", ((4,), (4,), (4,), (2, 4))),
    ("ecdsa_verify", ((), (), (4,), (4,), (4,))),
    ("ecdsa_verify", ((4,), (4,), (), (4,), (4,))),
    ("ecdsa_verify", ((4,), (4,), (4,), (), ())),
    ("ecdsa_recover", ((), (4,), (4,), (4,))),
    ("ecdsa_recover", ((4,), (4,), (4,), ())),
    ("ecdsa_recover", ((4,), (), (), (4,))),
]


@pytest.mark.parametrize("fn, leads", _BATCH_CASES)
def test_broadcasting_follows_the_jax_functions(fn, leads):
    """The port's batch shapes (``sec.ecmul2_batch``, ``verify_batch``,
    ``recover_batch``, which the card routes expand to) are the JAX
    functions', and the port raises where they raise (traced shapes only,
    ``jax.eval_shape``: nothing compiles)."""
    import jax
    import jax.numpy as jnp

    from go_ibft_tpu.ops import secp256k1 as jsec

    args = [jax.ShapeDtypeStruct(lead if fn == "ecdsa_recover" and i == 3 else lead + (20,), jnp.int32)
            for i, lead in enumerate(leads)]
    try:
        out = jax.eval_shape(getattr(jsec, fn), *args)
        want = tuple((out[2] if fn == "ecdsa_recover" else out.x if fn == "ecmul2_base" else out).shape)
        want = want[:-1] if fn == "ecmul2_base" else want
    except (ValueError, TypeError):
        want = None
    batch_of = {"ecmul2_base": sec.ecmul2_batch, "ecdsa_verify": sec.verify_batch,
                "ecdsa_recover": sec.recover_batch}[fn]
    try:
        got = batch_of(*leads)
    except ValueError:
        got = None
    assert got == want


def test_the_recovery_plain_path_never_reaches_the_kernel(lanes, monkeypatch):
    """``ecdsa_recover_plain`` (which ``ecrecover.recover_plain`` runs, the
    card's yardstick for the recovery kernel) and ``ecdsa_verify_plain``
    take ``ecmul2_base_plain``, never the dispatching ``ecmul2_base``, so
    on the card one kernel is never held against another.  The ladder is
    stood in for here: the test is about which name is called."""
    calls = []

    def stand_in(k1, k2, qx, qy):
        calls.append(qx.shape)
        return sec.point_infinity(tuple(qx.shape[:-1]), qx.device)

    def refuse(*args):
        raise AssertionError("a plain path reached a dispatching name")

    monkeypatch.setattr(sec, "ecmul2_base_plain", stand_in)
    for name in ("ecmul2_base", "ecdsa_verify"):
        monkeypatch.setattr(sec, name, refuse)
    for name in ("ecmul2", "verify", "launch_ecmul2", "launch_verify"):
        monkeypatch.setattr(ecverify, name, refuse)
    from go_ibft_tpu_torch.bench import build_recovery_lanes

    rec = build_recovery_lanes(2, seed=1).arrays(2)
    x, y, addr, ok = ecrecover.recover_plain(*_tensors(rec, ("zw", "r", "s", "v")))
    assert not ok.any()  # the stand-in's infinity
    arr = lanes.arrays(2)
    assert not sec.ecdsa_verify_plain(*_tensors(arr, _VERIFY)).any()
    assert len(calls) == 2


def test_both_entries_are_bound():
    assert set(_build.SIGNATURES["secp256k1_ecmul2"]) == {"secp256k1_ecmul2", "secp256k1_verify"}
    assert set(_build.SIGNATURES["secp256k1_recover"]) == {"secp256k1_recover"}
    text = (_build.CSRC / "secp256k1_ecmul2.cu").read_text()
    # The kernels' names keep clear of the recovery kernel's, which the
    # profiler's per-kernel split matches by substring.
    for kernel in ("secp256k1_ecmul2_kernel", "secp256k1_verify_kernel"):
        assert f"{kernel}(" in text and "secp256k1_recover" not in kernel


# ---------------------------------------------------------------------------
# The JAX package's device programs (slow tier)
# ---------------------------------------------------------------------------


def _chunks(arr, names, width):
    """The lanes in chunks of ``width`` rows (the last padded with lane 0)."""
    n = len(arr["lane"])
    for at in range(0, n, width):
        rows = [i if i < n else 0 for i in range(at, at + width)]
        yield at, min(width, n - at), [np.ascontiguousarray(arr[k][rows]) for k in names]


@pytest.mark.slow
def test_plain_matches_jax_device_programs_off_the_curve_and_at_the_edges(lanes, plain):
    """The JAX device ``ecmul2_base`` (4 lanes a call) and ``ecdsa_verify``
    (6 lanes a call), the shapes ``tests/test_secp256k1.py`` compiles, on
    every lane: off-curve keys are where the order of the ladder's merges
    and the GLV split are part of the result."""
    import jax.numpy as jnp

    from go_ibft_tpu.ops import secp256k1 as jsec

    arr = lanes.arrays()
    for at, live, ins in _chunks(arr, _ECMUL2, 4):
        out = jsec.ecmul2_base(*(jnp.asarray(a) for a in ins))
        got = _affine(*(np.asarray(c) for c in out))
        for j in range(live):
            assert got[j] == plain[0][at + j], lanes.labels[at + j]
    for at, live, ins in _chunks(arr, _VERIFY, 6):
        ok = np.asarray(jsec.ecdsa_verify(*(jnp.asarray(a) for a in ins)))
        for j in range(live):
            assert bool(ok[j]) == bool(plain[1][at + j]), lanes.labels[at + j]
