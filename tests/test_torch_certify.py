"""The ``certify_lanes`` kernel's function against the JAX package's.

``ops/certify_lanes.py::certify_plain`` (the kernel's plain version) is held
against the JAX package's ``membership_eq`` and ``power_reduce`` composed as
its ``_certify_fn`` / ``_round_fn`` compose them after the recovery, and the
port's ``round_certify`` (which now ends in ``certify_lanes``) against the
JAX package's at the 8-lane shape of ``tests/test_torch_quorum.py`` (the
same compiled program).  ``csrc/certify_lanes.cu`` is then built with
``g++`` and its host twin, ``certify_lanes_host`` (the kernel's lane code,
a phase's lanes one after the other), held against ``certify_plain`` on the
same cases.

The cases are made from numpy seeds: tables that repeat an address with a
nonzero power, duplicate-sender spam, all-dead lanes, lanes whose recovery
failed or recovered another address, non-members, 0, 1 and 2 phases,
thresholds at the counted power - 1, the power and + 1, at 0 and with
``thr_hi`` >= 2**15, and tables past one 2,048-row tile.  Tolerance: exact
equality of the mask, the verdicts and both power halves.
"""

import ctypes
import shutil
import subprocess

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from go_ibft_tpu.ops import quorum as jq
from go_ibft_tpu_torch import _build, convert
from go_ibft_tpu_torch.ops import certify_lanes as cl
from go_ibft_tpu_torch.ops import quorum as tq
from tests.test_torch_quorum import _variants

# Small tensors: one intra-op thread beats a pool per xdist worker.
torch.set_num_threads(1)


def _case(seed, n, v, *, dup_rows=2, spam=3, big=False, dead=False, members=0.8):
    """Seeded lanes and a table as numpy (words as uint32, as the JAX
    package keeps them)."""
    rng = np.random.default_rng(seed)
    table = rng.integers(0, 2**32, size=(v, 5), dtype=np.uint32)
    for _ in range(dup_rows if v > 1 else 0):  # an address twice, each row with power
        a, b = rng.integers(0, v, size=2)
        table[a] = table[b]
    top = 2**31 if big else 2**12
    powers = rng.integers(1, top, size=v).astype(np.int64)
    claimed = table[rng.integers(0, v, size=n)].copy()
    outsider = rng.random(n) > members
    claimed[outsider] = rng.integers(0, 2**32, size=(int(outsider.sum()), 5), dtype=np.uint32)
    if spam and n > spam:  # the first lanes repeated: one sender, several lanes
        claimed[n - spam:] = claimed[:spam]
    addr = claimed.copy()
    wrong = rng.random(n) < 0.1  # recovered another address
    addr[wrong, rng.integers(0, 5)] ^= np.uint32(1 << 7)
    ok = rng.random(n) < 0.85
    addr[~ok] = rng.integers(0, 2**32, size=(int((~ok).sum()), 5), dtype=np.uint32)  # unspecified
    live = np.zeros(n, bool) if dead else rng.random(n) < 0.9
    return {"addr": addr, "ok": ok, "claimed": claimed, "live": live, "table": table,
            "plo": (powers & 0xFFFF).astype(np.int32), "phi": (powers >> 16).astype(np.int32),
            "powers": powers}


def _bounds(n, phases, split):
    if phases == 1:
        return [(0, n)]
    split = n // 2 if split is None else split
    return [(0, split), (split, n)][:phases]


def _counted_power(c, a, b):
    """The exact power the JAX package's reduction counts over lanes
    [a, b): every table row equal to a valid lane's claimed address."""
    eq = np.all(c["claimed"][a:b, None, :] == c["table"][None, :, :], axis=-1)
    valid = c["ok"][a:b] & c["live"][a:b] & np.all(c["addr"][a:b] == c["claimed"][a:b], -1) & eq.any(-1)
    return int(c["powers"][np.any(eq & valid[:, None], axis=0)].sum())


def _edges(got):
    """Thresholds at the edges of ``got``, as (lo, hi) halves."""
    return [(t & 0xFFFF, t >> 16) for t in sorted({0, 1, max(got - 1, 0), got, got + 1, got + (1 << 31)})]


CASES = {
    # name: (seed, lanes, table rows, keyword arguments of _case, phases, split)
    "mask_only": (1, 40, 8, {}, 0, None),
    "one_phase": (2, 33, 8, {}, 1, None),
    "two_phases": (3, 64, 128, {}, 2, None),
    "two_phases_uneven_split": (4, 50, 16, {}, 2, 13),
    "duplicate_rows_with_power": (5, 32, 8, {"dup_rows": 4}, 2, None),
    "duplicate_sender_spam": (6, 24, 8, {"spam": 12}, 1, None),
    "all_dead": (7, 16, 8, {"dead": True}, 2, None),
    "big_powers_thr_hi_past_15_bits": (8, 48, 16, {"big": True}, 2, None),
    "no_members": (9, 16, 8, {"members": 0.0}, 1, None),
    "past_one_tile": (10, 96, 2100, {"dup_rows": 8}, 2, None),
    "past_one_tile_mask_only": (11, 96, 2100, {}, 0, None),
}


def _torch_args(c):
    t = {k: torch.from_numpy(c[k].view(np.int32) if c[k].dtype == np.uint32 else c[k])
         for k in ("addr", "ok", "claimed", "live", "table", "plo", "phi")}
    return t["addr"], t["ok"], t["claimed"], t["live"], t["table"], t["plo"], t["phi"]


def _jax_certify(c, thresholds, split):
    """The JAX package's post-recovery composition: ``sig_checks_zw``'s
    tail, ``membership_eq``, the member AND, ``power_reduce`` a phase."""
    claimed, table = jnp.asarray(c["claimed"]), jnp.asarray(c["table"])
    sig = jnp.asarray(c["ok"]) & jnp.all(jnp.asarray(c["addr"]) == claimed, axis=-1) & jnp.asarray(c["live"])
    eq = jq.membership_eq(claimed, table)
    mask = sig & jnp.any(eq, axis=-1)
    out = [
        jq.power_reduce(mask[a:b], eq[a:b], jnp.asarray(c["plo"]), jnp.asarray(c["phi"]),
                        jnp.int32(lo), jnp.int32(hi))
        for (a, b), (lo, hi) in zip(_bounds(len(c["ok"]), len(thresholds), split), thresholds)
    ]
    return np.asarray(mask), [tuple(int(x) for x in p) for p in out]


def _threshold_sets(c, phases, split):
    """Every edge of phase 0 with phase 1's own edges in turn."""
    if phases == 0:
        return [[]]
    gots = [_counted_power(c, a, b) for a, b in _bounds(len(c["ok"]), phases, split)]
    edges = [_edges(g) for g in gots]
    if phases == 1:
        return [[e] for e in edges[0]]
    return [[e0, e1] for e0, e1 in zip(edges[0], edges[1][::-1])]


def _as_lists(out):
    mask, reached, lo, hi = out
    return mask.numpy(), [(bool(r), int(a), int(b)) for r, a, b in zip(reached, lo, hi)]


@pytest.mark.parametrize("name", list(CASES))
def test_certify_plain_matches_jax(name):
    seed, n, v, kw, phases, split = CASES[name]
    c = _case(seed, n, v, **kw)
    for thresholds in _threshold_sets(c, phases, split):
        mask, phases_out = _as_lists(cl.certify_plain(*_torch_args(c), thresholds, split))
        ref_mask, ref = _jax_certify(c, thresholds, split)
        assert np.array_equal(mask, ref_mask)
        assert phases_out == ref
        for (a, b), (reached, lo, hi), (t_lo, t_hi) in zip(_bounds(n, phases, split), phases_out, thresholds):
            got = _counted_power(c, a, b)
            if got < 2**31:  # below the int32 wrap, the halves are the exact power
                assert hi * 65536 + lo == got
                assert reached == (got >= t_hi * 65536 + t_lo)


def test_certify_on_the_cpu_is_the_plain_version_and_counts_nothing():
    c = _case(12, 16, 8)
    before = cl.certify.launches
    ours = cl.certify(*_torch_args(c), [(3, 0)])
    ref = cl.certify_plain(*_torch_args(c), [(3, 0)])
    assert all(torch.equal(a, b) for a, b in zip(ours, ref))
    assert cl.certify.launches == before


def test_certify_takes_threshold_tensors_and_refuses_malformed_inputs():
    c = _case(13, 16, 8)
    args = _torch_args(c)
    as_ints = cl.certify_plain(*args, [(5, 0), (1, 0)], 7)
    as_tensors = cl.certify_plain(*args, [(torch.tensor(5, dtype=torch.int32), torch.tensor(0, dtype=torch.int32)),
                                          (1, 0)], 7)
    assert all(torch.equal(a, b) for a, b in zip(as_ints, as_tensors))
    addr, ok, claimed, live, table, plo, phi = args
    with pytest.raises(TypeError):
        cl.certify_plain(addr, ok.to(torch.uint8), claimed, live, table)
    with pytest.raises(ValueError):
        cl.certify_plain(addr[:, :4], ok, claimed, live, table)
    with pytest.raises(ValueError):
        cl.certify_plain(addr, ok, claimed, live, table, plo, phi, [(1, 0)] * 3)
    with pytest.raises(ValueError):
        cl.certify_plain(addr, ok, claimed, live, table, None, None, [(1, 0)])
    with pytest.raises(ValueError):
        cl.certify_plain(addr, ok, claimed, live, table, plo, phi, [(1, 0)] * 2, split=17)
    with pytest.raises(ValueError):  # the kernel takes CUDA tensors only
        cl.launch(*args, [(1, 0)])


def _round_variants():
    """``tests/test_torch_quorum.py``'s 8-lane rounds, and the clean round
    with row 7 of the table made a copy of row 0 with a power of 5 (both
    rows count for the validator that signs as row 0)."""
    out = dict(_variants())
    dup = [np.array(a) for a in out["clean"]]
    dup[13][7] = dup[13][0]
    dup[14][7] = 5
    out["duplicate_row_with_power"] = tuple(dup)
    return out


@pytest.mark.parametrize("variant", ["clean", "tampered", "duplicate_spam", "duplicate_row_with_power"])
def test_round_certify_matches_jax_at_threshold_edges(monkeypatch, variant):
    """One ``round_certify`` call a variant, then its recovered lanes through
    ``certify`` (the rest of ``round_certify``) at each threshold edge, each
    against the JAX package's ``round_certify`` at that threshold."""
    arrays = _round_variants()[variant]
    port = convert.round_args(arrays, device="cpu")
    recovered = []
    real = tq._recover_address
    monkeypatch.setattr(tq, "_recover_address", lambda *a: recovered.append(real(*a)) or recovered[-1])
    jax_args = [jnp.asarray(a) for a in arrays[:16]]
    ours = tq.round_certify(*port)
    ref = jq.round_certify(*jax_args, jnp.int32(arrays[16]), jnp.int32(arrays[17]))
    for a, b in zip(ours, ref):
        assert np.array_equal(a.numpy(), np.asarray(b))
    (addr, ok), = recovered
    claimed, live = torch.cat([port[5], port[11]]), torch.cat([port[6], port[12]])
    valid = int(ours[0].sum())
    got = valid + (5 if variant == "duplicate_row_with_power" else 0) - (
        3 if variant == "duplicate_spam" else 0)  # spam: lanes 5..7 repeat lanes 0..2
    for thr in (got - 1, got, got + 1, (1 << 31) + got):
        lo, hi = thr & 0xFFFF, thr >> 16
        mask, reached, _, _ = cl.certify(addr, ok, claimed, live, *port[13:16], [(lo, hi)] * 2, split=8)
        ref = jq.round_certify(*jax_args, jnp.int32(lo), jnp.int32(hi))
        for a, b in zip((mask[:8], reached[0], mask[8:], reached[1]), ref):
            assert np.array_equal(a.numpy(), np.asarray(b))
        assert bool(reached[0]) == bool(reached[1]) == (got >= thr)


@pytest.fixture(scope="module")
def host_twin(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("needs a host C++ compiler to build the kernel's lane code")
    lib = tmp_path_factory.mktemp("certify") / "certify_lanes_host.so"
    subprocess.run(
        [cxx, "-x", "c++", "-std=c++17", "-O2", "-shared", "-fPIC", "-I", str(_build.CSRC),
         "-o", str(lib), str(_build.CSRC / "certify_lanes.cu")],
        check=True, capture_output=True, timeout=300,
    )
    fn = ctypes.CDLL(str(lib)).certify_lanes_host
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_longlong] + [ctypes.c_void_p] * 3
                   + [ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong] + [ctypes.c_void_p] * 5)
    fn.restype = ctypes.c_int

    def run(c, thresholds, split):
        n, phases = len(c["ok"]), len(thresholds)
        arrs = {k: np.ascontiguousarray(c[k].view(np.int32) if c[k].dtype == np.uint32 else c[k])
                for k in ("addr", "claimed", "table", "plo", "phi")}
        ok, live = (np.ascontiguousarray(c[k].astype(np.uint8)) for k in ("ok", "live"))
        values = np.array([h for pair in thresholds for h in pair] or [0], dtype=np.int64)
        mask = np.full(n, 7, np.uint8)
        reached = np.zeros(max(phases, 1), np.uint8)
        lo, hi = np.zeros(max(phases, 1), np.int32), np.zeros(max(phases, 1), np.int32)
        first = n if phases < 2 else (n // 2 if split is None else split)
        rc = fn(arrs["addr"].ctypes.data, ok.ctypes.data, arrs["claimed"].ctypes.data, live.ctypes.data, n,
                arrs["table"].ctypes.data, arrs["plo"].ctypes.data, arrs["phi"].ctypes.data,
                len(c["table"]), phases, first, values.ctypes.data, mask.ctypes.data,
                reached.ctypes.data, lo.ctypes.data, hi.ctypes.data)
        assert rc == 0
        return mask.astype(bool), [(bool(r), int(a), int(b)) for r, a, b in
                                   zip(reached[:phases], lo[:phases], hi[:phases])]

    return run


@pytest.mark.parametrize("name", list(CASES))
def test_host_twin_matches_plain(host_twin, name):
    seed, n, v, kw, phases, split = CASES[name]
    c = _case(seed, n, v, **kw)
    for thresholds in _threshold_sets(c, phases, split):
        mask, verdicts = host_twin(c, thresholds, split)
        ref_mask, ref = _as_lists(cl.certify_plain(*_torch_args(c), thresholds, split))
        assert np.array_equal(mask, ref_mask)
        assert verdicts == ref


def test_host_twin_takes_no_lane_and_refuses_a_bad_split(host_twin):
    c = _case(14, 8, 8)
    mask, verdicts = host_twin(c, [(1, 0), (1, 0)], 3)
    assert len(mask) == 8 and len(verdicts) == 2
    empty = {k: a[:0] for k, a in c.items() if k not in ("table", "plo", "phi", "powers")}
    empty.update({k: c[k] for k in ("table", "plo", "phi", "powers")})
    assert host_twin(empty, [], None)[0].shape == (0,)
    with pytest.raises(AssertionError):
        host_twin(c, [(1, 0), (1, 0)], 9)
