"""The masked G1/G2 merge trees of the port (the ``bls_merge`` kernel's
plain version, ``ops/bls12_381.py::merge_plain``, through the entry points
``g1_merge_tree`` / ``g2_merge_tree`` on CPU tensors) against the JAX
package's ``g1_merge_tree`` / ``g2_merge_tree`` at the 8-point shape its own
tier-1 tests compile (``tests/test_aggregate.py``), and against the host
oracle ``crypto.bls.aggregate_signatures`` at uneven point counts with
identity (dead), negated, duplicated lanes and an all-dead group; plus the
config #4 workload's arrays against the JAX package's through
``convert``.  Tolerance: exact equality (points as integers mod p).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from go_ibft_tpu.bench import bls_workload as jwork
from go_ibft_tpu.ops import bls12_381 as jdev
from go_ibft_tpu.verify import aggregate as jagg
from go_ibft_tpu_torch import convert
from go_ibft_tpu_torch.bench import bls_workload as twork
from go_ibft_tpu_torch.crypto import bls as hbls
from go_ibft_tpu_torch.ops import bls12_381 as ops
from go_ibft_tpu_torch.verify import aggregate as tagg

torch.set_num_threads(1)


def _jax_merge_g2(pts, live):
    x0, x1, y0, y1 = jdev.pack_g2_points(pts)
    limbs, inf = jdev.g2_merge_tree(jnp.asarray(x0), jnp.asarray(x1), jnp.asarray(y0), jnp.asarray(y1),
                                    jnp.asarray(np.array(live)))
    return jdev.unpack_g2_points(np.asarray(limbs)[None], np.asarray(inf)[None])[0]


def _port_merge(pts, live, g1=False):
    pack, unpack = (ops.pack_g1_points, ops.unpack_g1_points) if g1 else (ops.pack_g2_points, ops.unpack_g2_points)
    merge = ops.g1_merge_tree if g1 else ops.g2_merge_tree
    out, inf = merge(torch.from_numpy(pack(pts)), torch.tensor(live))
    return unpack(out, inf)[0]


def test_g2_merge_tree_matches_jax_at_its_8_point_shape():
    """7 live lanes in the 8-bucket with a dead lane and a negated sibling
    (the JAX package's own case), then total cancellation and an all-dead
    mask: the port's affine sum and infinity flag equal the JAX program's."""
    pts = [hbls.g2_mul(k, hbls.G2_GEN) for k in (3, 5, 8, 11, 7, 2)]
    pts.append(hbls.g2_neg(pts[0]))
    pts.append(hbls.g2_mul(9, hbls.G2_GEN))
    for live in ([True] * 7 + [False], [True, True, False, True, True, True, True, False]):
        assert _port_merge(pts, [live]) == _jax_merge_g2(pts, live)
    p = hbls.g2_mul(6, hbls.G2_GEN)
    pts = [p, hbls.g2_neg(p)] + [hbls.g2_mul(4, hbls.G2_GEN)] * 6
    for live in ([True, True] + [False] * 6, [False] * 8, [True] + [False] * 7):
        assert _port_merge(pts, [live]) == _jax_merge_g2(pts, live)


def test_g1_merge_tree_matches_jax_at_its_8_point_shape():
    pks = [hbls.g1_mul(k, hbls.G1_GEN) for k in (2, 3, 5, 7, 11, 13)]
    pks += [hbls.g1_neg(pks[1]), pks[0]]  # a negation and a duplicate
    live = [True, True, True, False, True, True, True, True]
    px, py = jdev.pack_g1_points(pks)
    limbs, inf = jdev.g1_merge_tree(jnp.asarray(px), jnp.asarray(py), jnp.asarray(np.array(live)))
    want = jdev.unpack_g1_points(np.asarray(limbs)[None], np.asarray(inf)[None])[0]
    assert _port_merge(pks, [live], g1=True) == want == hbls.aggregate_pubkeys(
        [p for p, alive in zip(pks, live) if alive])


@pytest.mark.parametrize("v", [3, 5, 130])
def test_grouped_merges_match_the_oracle_at_uneven_sizes(v):
    """Groups of uneven size through the grouped device route (on CPU
    tensors): identity points ride dead lanes, negated and duplicated
    points, a cancelling pair and an empty group, each equal to the host
    fold — the kernel's order (128 strided folds, then a tree) included."""
    rng = np.random.default_rng(v)
    pool = [hbls.g2_mul(k, hbls.G2_GEN) for k in range(1, 9)]
    groups = []
    for gi in range(4):
        grp = [pool[int(i)] for i in rng.integers(0, 8, v)]
        if gi == 1:
            grp = [hbls.g2_neg(p) if j % 3 == 0 else p for j, p in enumerate(grp)]
            grp[1] = None  # an identity point: a dead lane
        if gi == 2:
            grp = [grp[0], hbls.g2_neg(grp[0])][:v] + [None] * (v - 2)
        groups.append(grp)
    groups.append([])
    got = tagg._merge_g2_groups_device(groups, torch.device("cpu"))
    assert got == [hbls.aggregate_signatures([p for p in g if p is not None]) for g in groups]
    pk_groups = [[hbls.g1_mul(k, hbls.G1_GEN) for k in range(1, v + 1)], [None] * v]
    assert tagg._merge_g1_groups_device(pk_groups, torch.device("cpu")) == [
        hbls.aggregate_pubkeys(pk_groups[0]), None]


def test_merge_tree_class_and_drop_ins_match_jax_host_route():
    pts = [hbls.g2_mul(k, hbls.G2_GEN) for k in range(1, 10)]
    tree = tagg.G2MergeTree(torch_device="cpu")
    jtree = jagg.G2MergeTree(device=False)
    groups = [pts[:4], pts[4:], [pts[0], hbls.g2_neg(pts[0])], []]
    assert tree.merge_groups(groups) == jtree.merge_groups(groups)
    assert tree.stats()["device_merges"] == 1 and jtree.stats()["host_merges"] == 1
    assert tagg.aggregate_signatures(pts, device=True, torch_device="cpu") == jagg.aggregate_signatures(pts)
    pks = [hbls.g1_mul(k, hbls.G1_GEN) for k in range(1, 10)]
    assert tagg.aggregate_pubkeys(pks, device=True, torch_device="cpu") == jagg.aggregate_pubkeys(pks)


def test_bls_workload_arrays_equal_the_jax_packages():
    """The port's config #4 workload (4 validators), converted to the JAX
    layout, equals the JAX package's packed arrays."""
    t = twork.build_bls_round_workload(4, seed=3, time_host=False)
    j = jwork.build_bls_round_workload(4, seed=3, time_host=False)
    pk, sig, h, live = t.args
    jpk = j.args[0:2]
    jsig = j.args[2:6]
    jh = j.args[6:10]
    for got, want in zip(convert.bls_point_arrays(torch.from_numpy(pk)), jpk):
        assert np.array_equal(got, want)
    for got, want in zip(convert.bls_point_arrays(torch.from_numpy(sig)), jsig):
        assert np.array_equal(got, want)
    for got, want in zip(convert.bls_point_arrays(torch.from_numpy(h)[None]), jh):
        assert np.array_equal(got[0], want)
    assert np.array_equal(live, j.args[10])
    assert torch.equal(convert.bls_points(*jpk, device="cpu"), torch.from_numpy(pk))
