"""The recovery-plus-address path of the port on the CPU.

* ``ops/ecrecover.py``: the wrapper takes the plain version for a CPU
  tensor, counts no launch, and broadcasts by the JAX function's rules;
  its launcher refuses what the kernel does not take; the plain version (digest words in, address out) is held
  against the JAX package's host oracle ``go_ibft_tpu.crypto.ecdsa.recover``
  and ``pubkey_to_address`` on the seeded lanes of ``bench/lanes.py``,
  adversarial lanes included.
* ``ops/ecrecover.py::comb_table``, the kernel's fixed-base comb, is held
  against ``crypto.ecdsa.scalar_mul`` on a seeded sample of its entries and
  on every corner.
* ``csrc/secp256k1_recover.cu``: its per-lane arithmetic has a portable
  C++ twin of every PTX chain (``csrc/lane.cuh``), so a host compiler
  builds the same source and runs the same algorithm; the host build is
  held against that oracle and the plain version on the same lanes, against
  the oracle on seeded random lanes (small and sparse scalars among them),
  and its safegcd inversion against ``pow(x, -1, m)``.  The CUDA build runs
  only on the card (``tests/test_torch_cuda.py``).
* ``_build.py``: the build key covers the shared headers, and every C entry
  point it binds exists in its source.

Inputs are made from numpy seeds.  Tolerance: exact equality.
"""

import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch

from go_ibft_tpu.crypto import ecdsa as jax_ecdsa
from go_ibft_tpu_torch import _build
from go_ibft_tpu_torch.bench import RecoveryLanes, build_recovery_lanes, build_sparse_scalar_lanes
from go_ibft_tpu_torch.crypto import ecdsa
from go_ibft_tpu_torch.ops import ecrecover
from go_ibft_tpu_torch.ops import fields as tf
from go_ibft_tpu_torch.ops import keccak as tk

# Tiny tensors: one intra-op thread beats a pool per xdist worker.
torch.set_num_threads(1)


def _inputs(arr, z_kind="zw"):
    return [torch.from_numpy(np.ascontiguousarray(arr[k])) for k in (z_kind, "r", "s", "v")]


def _jax_oracle(lanes):
    """Per lane, the JAX package's host recovery and address (``None`` where
    it fails)."""
    out = []
    for lane in zip(lanes.digests, lanes.r, lanes.s, lanes.v):
        pub = jax_ecdsa.recover(*lane)
        out.append(None if pub is None else (pub, jax_ecdsa.pubkey_to_address(*pub)))
    return out


def _check_against_oracle(lanes, expect, arr, x, y, addr, ok):
    xs, ys = tf.from_limbs(x), tf.from_limbs(y)
    addr = np.asarray(addr).view(np.uint32)
    for i, lane in enumerate(arr["lane"]):
        e = expect[lane]
        assert bool(ok[i]) == (e is not None), lanes.labels[lane]
        if e is not None:
            assert (xs[i], ys[i]) == e[0], lanes.labels[lane]
            assert np.array_equal(addr[i], tk.address_to_words(e[1])), lanes.labels[lane]


@pytest.fixture(scope="module")
def lanes():
    return build_recovery_lanes(4, seed=3)


@pytest.fixture(scope="module")
def oracle(lanes):
    return _jax_oracle(lanes)


@pytest.fixture(scope="module")
def plain(lanes):
    arr = lanes.arrays()
    return arr, [t.numpy() for t in ecrecover.recover(*_inputs(arr))]


def test_recover_plain_from_words_matches_host_oracle(lanes, oracle, plain):
    arr, (x, y, addr, ok) = plain
    _check_against_oracle(lanes, oracle, arr, x, y, addr, ok)
    assert ok.sum() == sum(e is not None for e in oracle)
    # The port's own oracle, which the card tests and chip_smoke.py use,
    # agrees with the JAX package's on every lane.
    assert lanes.expected() == [None if e is None else e[0] for e in oracle]


def test_recover_on_cpu_runs_plain_and_counts_no_launch(lanes):
    arr = lanes.arrays(2)
    before = ecrecover.recover.launches
    x, y, addr, ok = ecrecover.recover(*_inputs(arr))
    assert ecrecover.recover.launches == before
    assert x.shape == (2, 20) and addr.shape == (2, 5) and ok.dtype == torch.bool


def test_recover_broadcasts_by_the_jax_rules(lanes):
    """``recover`` broadcasts as the JAX ``ecdsa_recover`` does: one digest
    against two signatures gives the expanded call's result; a view that is
    not contiguous reaches the launcher contiguous; r and s of fewer leading
    axes than z, which the JAX function refuses, raise."""
    z, r, s, v = _inputs(lanes.arrays(2))
    one = ecrecover.recover(z[0], r, s, v)
    full = ecrecover.recover(z[0].expand(2, 8).contiguous(), r, s, v)
    assert one[0].shape == (2, 20) and all(torch.equal(a, b) for a, b in zip(one, full))
    zb, rb, sb, vb = ecrecover._broadcast(z, r.t().contiguous().t(), s, v[0])
    assert all(t.is_contiguous() for t in (zb, rb, sb, vb)) and vb.shape == (2,) and torch.equal(rb, r)
    with pytest.raises(ValueError):
        ecrecover.recover(z, r[0], s[0], v)


def test_recovery_launch_refuses_cpu_and_malformed_inputs(lanes):
    z, r, s, v = _inputs(lanes.arrays(3))
    with pytest.raises(ValueError):
        ecrecover.launch(z, r, s, v)  # no quiet CPU path behind the kernel
    with pytest.raises(TypeError):
        ecrecover.recover(z, r, s.to(torch.int64), v)
    with pytest.raises(ValueError):
        ecrecover.recover(z[:, :5], r, s, v)
    with pytest.raises(ValueError):
        ecrecover.recover(z, r[:, :19], s, v)
    with pytest.raises(ValueError):
        ecrecover.recover(z, r, s, v[:2])
    with pytest.raises(ValueError):
        ecrecover.recover(z.to("meta"), r.to("meta"), s.to("meta"), v.to("meta"))


# ---------------------------------------------------------------------------
# The kernel's lane arithmetic, built for the host
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def host_kernel(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("needs a host C++ compiler to build the lane arithmetic")
    lib = tmp_path_factory.mktemp("lane") / "secp256k1_recover_host.so"
    subprocess.run(
        [cxx, "-x", "c++", "-std=c++17", "-O2", "-shared", "-fPIC", "-I", str(_build.CSRC),
         "-o", str(lib), str(_build.CSRC / "secp256k1_recover.cu")],
        check=True, capture_output=True, timeout=300,
    )
    fn = ctypes.CDLL(str(lib)).secp256k1_recover_host
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 8 + [ctypes.c_longlong]
    fn.restype = ctypes.c_int
    gtab = np.ascontiguousarray(ecrecover.comb_table())

    def run(arr, z_kind):
        z = np.ascontiguousarray(arr[z_kind])
        n = len(arr["v"])
        x, y = np.zeros((n, 20), np.int32), np.zeros((n, 20), np.int32)
        addr, ok = np.zeros((n, 5), np.int32), np.zeros(n, np.uint8)
        r, s, v = (np.ascontiguousarray(arr[k]) for k in ("r", "s", "v"))
        fn(z.ctypes.data, z.shape[1], r.ctypes.data, s.ctypes.data, v.ctypes.data,
           gtab.ctypes.data, x.ctypes.data, y.ctypes.data, addr.ctypes.data, ok.ctypes.data, n)
        return x, y, addr, ok.astype(bool)

    run.lib = lib
    return run


@pytest.fixture(scope="module")
def host_modinv(host_kernel):
    fn = ctypes.CDLL(str(host_kernel.lib)).secp256k1_modinv_host
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong]
    fn.restype = ctypes.c_int

    def run(values, modulus_is_n):
        x = np.frombuffer(b"".join(v.to_bytes(32, "little") for v in values), dtype="<u4").copy()
        out = np.zeros_like(x)
        fn(x.ctypes.data, int(modulus_is_n), out.ctypes.data, len(values))
        words = out.reshape(-1, 8)
        return [int.from_bytes(row.tobytes(), "little") for row in words]

    return run


def test_comb_table_matches_scalar_mul():
    table = ecrecover.comb_table()
    assert table.shape == (32, 256, 16) and table.dtype == np.uint32
    assert not table[:, 0].any()  # rows d = 0 are unused
    rng = np.random.default_rng(7)
    corners = [(w, d) for w in (0, 31) for d in (1, 255)] + [(0, 2), (31, 128), (15, 1)]
    sample = [(int(w), int(d)) for w, d in zip(rng.integers(0, 32, 24), rng.integers(1, 256, 24))]
    for w, d in corners + sample:
        x, y = ecdsa.scalar_mul(d << (8 * w), (ecdsa.GX, ecdsa.GY))
        words = np.frombuffer(x.to_bytes(32, "little") + y.to_bytes(32, "little"), dtype="<u4")
        assert np.array_equal(table[w, d], words), (w, d)


@pytest.mark.parametrize("modulus_is_n", [True, False])
def test_kernel_modinv_host_build_matches_pow(host_modinv, modulus_is_n):
    """The kernel's safegcd inverse: 0 maps to 0; edges of the divsteps
    (1, M - 1, M - 2, powers of two, long runs of ones and zeros) and
    seeded random values."""
    m = ecdsa.N if modulus_is_n else ecdsa.P
    rng = np.random.default_rng(11 + modulus_is_n)
    values = [0, 1, 2, 3, m - 1, m - 2, (m + 1) // 2, 1 << 200, 1 << 255, (1 << 255) - 1,
              ((1 << 128) - 1) << 128, (1 << 128) - 1]
    values += [int.from_bytes(rng.bytes(32), "big") % m for _ in range(64)]
    got = host_modinv(values, modulus_is_n)
    assert got == [pow(v, -1, m) if v else 0 for v in values]


@pytest.mark.parametrize("z_kind", ["zw", "z_limbs"])
def test_kernel_lanes_host_build_match_oracle_and_plain(host_kernel, lanes, oracle, plain,
                                                       z_kind):
    arr, (px, py, paddr, pok) = plain
    x, y, addr, ok = host_kernel(arr, z_kind)
    _check_against_oracle(lanes, oracle, arr, x, y, addr, ok)
    assert np.array_equal(ok, pok)
    for got, ref in ((x, px), (y, py), (addr, paddr)):
        assert np.array_equal(got[pok], ref[pok])


@pytest.mark.parametrize("seed", [0, 1])
def test_kernel_lanes_host_build_match_oracle_on_random_lanes(host_kernel, seed):
    """Random r (half of them no curve x-coordinate), s, z and v; small
    values now and then, where the ladder's digits are mostly zero."""
    rng = np.random.default_rng(seed)
    lanes = RecoveryLanes()
    for _ in range(48):
        vals = [int.from_bytes(rng.bytes(32), "big") for _ in range(3)]
        if rng.random() < 0.2:
            vals[int(rng.integers(0, 3))] = int(rng.integers(1, 1 << 16))
        r, s = vals[0] % ecdsa.N, vals[1] % ecdsa.N
        lanes.add("random", vals[2].to_bytes(32, "big"), r, s, int(rng.integers(0, 2)))
    arr = lanes.arrays()
    _check_against_oracle(lanes, _jax_oracle(lanes), arr, *host_kernel(arr, "zw"))


@pytest.mark.parametrize("seed", [0, 1])
def test_kernel_lanes_host_build_match_oracle_on_sparse_scalars(host_kernel, seed):
    """Valid lanes whose s and z have low Hamming weight or are small, so
    that u1 and u2 take extreme digits (``bench/lanes.py``)."""
    lanes = build_sparse_scalar_lanes(32, seed=100 + seed)
    arr = lanes.arrays()
    _check_against_oracle(lanes, _jax_oracle(lanes), arr, *host_kernel(arr, "zw"))


# ---------------------------------------------------------------------------
# The build
# ---------------------------------------------------------------------------


def test_build_key_covers_shared_headers(tmp_path, monkeypatch):
    for src in _build.CSRC.iterdir():
        (tmp_path / src.name).write_bytes(src.read_bytes())
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    keys = {name: _build._target(name) for name in _build.SIGNATURES}
    header = tmp_path / "keccak_f1600.cuh"
    header.write_text(header.read_text() + "\n// changed\n")
    for name in _build.SIGNATURES:
        assert _build._target(name) != keys[name], name  # both sources include it
    assert "-I" in _build.NVCC_FLAGS


def test_every_bound_entry_point_is_in_its_source():
    for name, fns in _build.SIGNATURES.items():
        text = (_build.CSRC / f"{name}.cu").read_text()
        for fn, (argtypes, _) in fns.items():
            assert f'extern "C" int {fn}(' in text, fn
            decl = text.split(f'extern "C" int {fn}(', 1)[1].split(")", 1)[0]
            assert decl.count(",") + 1 == len(argtypes), fn
