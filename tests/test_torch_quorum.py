"""The port's whole-round certification against the JAX package's.

``round_certify`` runs in both packages on the 8-validator round that
``__graft_entry__.entry()`` builds, and on three variants with the same
shapes (so the JAX program compiles once): a tampered round with lanes
from ``corrupt_frac``, duplicate-sender spam, and a round below quorum.
Both packages get the same numpy arrays (``convert.round_args`` makes the
port's tensors).  Tolerance: exact equality of both masks and both quorum
verdicts.  ``power_reduce`` and ``membership_eq`` are compared on seeded
random inputs the same way.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from go_ibft_tpu.bench import build_round_workload as jax_workload
from go_ibft_tpu.ops import quorum as jq
from go_ibft_tpu_torch import convert
from go_ibft_tpu_torch.bench import build_round_workload
from go_ibft_tpu_torch.ops import quorum as tq

# Tiny tensors: one intra-op thread beats a pool per xdist worker.
torch.set_num_threads(1)


def _spam(arrays):
    """Lanes 5..7 replaced by copies of lanes 0..2: every lane's signature
    is valid, but only 5 distinct validators signed (quorum is 6)."""
    arrays = [np.array(a) for a in arrays]
    for i in (0, 1, 2, 3, 4, 5, 7, 8, 9, 10, 11):  # per-lane arrays of both phases
        arrays[i][5:8] = arrays[i][0:3]
    return tuple(arrays)


def _variants():
    clean = build_round_workload(8)
    assert all(
        np.array_equal(a, b)
        for a, b in zip(convert.workload_arrays(clean), convert.workload_arrays(jax_workload(8)))
    )
    return {
        "clean": convert.workload_arrays(clean),
        "tampered": convert.workload_arrays(build_round_workload(8, corrupt_frac=0.25)),
        "duplicate_spam": _spam(convert.workload_arrays(clean)),
        "below_quorum": convert.workload_arrays(build_round_workload(8, corrupt_frac=0.375)),
    }


EXPECTED = {  # (valid lanes per phase, quorum reached)
    "clean": (8, True),
    "tampered": (6, True),
    "duplicate_spam": (8, False),
    "below_quorum": (5, False),
}


@pytest.fixture(scope="module")
def jax_results():
    """The JAX program's outputs for every variant (one compile)."""
    out = {}
    for name, arrays in _variants().items():
        res = jq.round_certify(*(jnp.asarray(a) for a in arrays))
        out[name] = (arrays, tuple(np.asarray(x) for x in jax.block_until_ready(res)))
    return out


@pytest.mark.parametrize("variant", list(EXPECTED))
def test_round_certify_matches_jax(jax_results, variant):
    arrays, ref = jax_results[variant]
    ours = tq.round_certify(*convert.round_args(arrays, device="cpu"))
    for a, b in zip(ours, ref):
        assert a.numpy().dtype == b.dtype
        assert np.array_equal(a.numpy(), b)
    n_valid, reached = EXPECTED[variant]
    assert int(ref[0].sum()) == int(ref[2].sum()) == n_valid
    assert bool(ref[1]) == bool(ref[3]) == reached


def test_power_reduce_and_membership_match_jax():
    rng = np.random.default_rng(17)
    table = rng.integers(0, 2**32, size=(8, 5), dtype=np.uint32)
    claimed = table[rng.integers(0, 8, size=16)]
    claimed[3] ^= np.uint32(1)  # not a member
    eq_t = tq.membership_eq(torch.from_numpy(claimed.view(np.int32)), torch.from_numpy(table.view(np.int32)))
    eq_j = np.asarray(jq.membership_eq(jnp.asarray(claimed), jnp.asarray(table)))
    assert np.array_equal(eq_t.numpy(), eq_j) and not eq_j[3].any()
    ok = rng.random(16) < 0.7
    powers = rng.integers(0, 2**31, size=8)
    plo, phi = (powers & 0xFFFF).astype(np.int32), (powers >> 16).astype(np.int32)
    got = int(powers[np.any(eq_j & ok[:, None], axis=0)].sum())
    for thr in (0, 1, got - 1, got, got + 1, int(powers.sum()) + 1):
        thr = max(thr, 0)
        t = tq.power_reduce(
            torch.from_numpy(ok), eq_t, torch.from_numpy(plo), torch.from_numpy(phi),
            thr & 0xFFFF, thr >> 16,
        )
        j = jq.power_reduce(
            jnp.asarray(ok), jnp.asarray(eq_j), jnp.asarray(plo), jnp.asarray(phi),
            jnp.int32(thr & 0xFFFF), jnp.int32(thr >> 16),
        )
        assert [int(x) for x in t] == [int(x) for x in j]
        assert bool(t[0]) == (got >= thr)
        assert int(t[2]) * 65536 + int(t[1]) == got


def test_split_power_bounds():
    assert tq.split_power((1 << 31) - 1) == jq.split_power((1 << 31) - 1)
    with pytest.raises(ValueError):
        tq.split_power(1 << 31)
