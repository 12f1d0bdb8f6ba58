"""The mesh's certify against the JAX package's, on CPU device lists.

``parallel/mesh.py::mesh_quorum_certify`` / ``mesh_seal_quorum_certify``
(each lane shard's digest and recovery, then one ``certify_lanes`` over the
gathered lanes and the whole table) are held against the JAX package's
``shard_map`` programs of the same names on the conftest's virtual CPU
devices, at dp 2 and 4 and vp 1 and 2; ``verify/mesh_batch.py::ShardedMask``
(``certify_zw`` for the mask a shard) against the JAX package's ``_mask_fn``
a shard.  Tolerance: exact equality of the masks, the verdicts and both
power halves.

The recovery is the same stand-in on both sides: lane ``i``'s "recovered"
address is ``s[i, :5]`` and it recovers where ``v[i] == 0`` (the JAX
package's ``sig_checks`` functions are patched with that rule, the port's
``ecrecover.recover`` returns it).  The recovery itself is held against the
JAX package elsewhere (``tests/test_torch_ecrecover.py``,
``tests/test_torch_quorum.py``), and the JAX mesh program with the real
ladder inside compiles for tens of minutes; with the stand-in each program
compiles in seconds and everything after the recovery, which is what the
port moved onto the kernel, runs as the JAX package runs it.

Each workload carries one validator's valid message in two lane shards
(counted once), a table row repeated in two table shards (both rows'
powers count), failed and wrong recoveries, dead lanes, outsiders and
powers up to 2**31 - 1; every program runs at its counted power - 1, the
power and + 1.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from go_ibft_tpu.ops import quorum as jq
from go_ibft_tpu.parallel import make_mesh as jax_make_mesh
from go_ibft_tpu.parallel import mesh_quorum_certify as jax_mesh_quorum_certify
from go_ibft_tpu.parallel import mesh_seal_quorum_certify as jax_mesh_seal_quorum_certify
from go_ibft_tpu.verify import mesh_batch as jax_mesh_batch
from go_ibft_tpu_torch.ops import ecrecover
from go_ibft_tpu_torch.parallel import make_mesh, mesh_quorum_certify, mesh_seal_quorum_certify
from go_ibft_tpu_torch.verify.batch import _DigestLanes, _SenderLanes
from go_ibft_tpu_torch.verify.mesh_batch import ShardedMask

torch.set_num_threads(1)

CPU = torch.device("cpu")
LANES, ROWS, WIDTH, BLOCKS = 16, 12, 8, 2


def _jax_sig(s, v, claimed, live):
    return (v == 0) & jnp.all(s[:, :5] == claimed, axis=-1) & live


@pytest.fixture
def stand_in(monkeypatch):
    """The same recovery rule on both sides (see the module docstring)."""
    monkeypatch.setattr(jq, "sender_sig_checks", lambda blocks, nblocks, r, s, v, w, live: _jax_sig(s, v, w, live))
    monkeypatch.setattr(jq, "seal_sig_checks", lambda zw, r, s, v, w, live: _jax_sig(s, v, w, live))
    monkeypatch.setattr(jq, "sig_checks_zw", lambda zw, r, s, v, w, live: _jax_sig(s, v, w, live))
    calls = []

    def recover(z, r, s, v):
        calls.append(int(v.numel()))
        return None, None, s[:, :5].contiguous(), v == 0

    monkeypatch.setattr(ecrecover, "recover", recover)
    return calls


def _workload(seed, dp, vp, big=True):
    """Seeded lanes (numpy, words as uint32) for a ``(dp, vp)`` mesh."""
    rng = np.random.default_rng(seed)
    table = rng.integers(0, 2**32, size=(ROWS, 5), dtype=np.uint32)
    table[ROWS - 1] = table[1]  # the same address in the first and the last table shard
    top = 2**31 if big else 2**12
    powers = rng.integers(1, top, size=ROWS).astype(np.int64)
    powers[[1, ROWS - 1]] = [top - 1, top - 2]
    claimed = table[rng.integers(0, ROWS - 1, size=LANES)].copy()
    claimed[3] = rng.integers(0, 2**32, size=5, dtype=np.uint32)  # an outsider
    claimed[0] = claimed[LANES - 1] = table[1]  # one validator, valid in the first and the last lane shard
    s = rng.integers(0, 2**32, size=(LANES, WIDTH), dtype=np.uint32)
    s[:, :5] = claimed
    s[5, 2] ^= np.uint32(1 << 4)  # recovered another address
    v = np.zeros(LANES, np.int32)
    v[6] = 1  # the recovery failed
    live = np.ones(LANES, bool)
    live[7] = False
    live[0] = live[LANES - 1] = True
    v[0] = v[LANES - 1] = 0
    blocks = rng.integers(0, 2**32, size=(LANES, BLOCKS, 17, 2), dtype=np.uint32)
    nblocks = np.full(LANES, BLOCKS, np.int32)
    zw = rng.integers(0, 2**32, size=(LANES, 8), dtype=np.uint32)
    r = np.zeros((LANES, WIDTH), np.uint32)
    return {"table": table, "powers": powers, "claimed": claimed, "s": s, "v": v, "live": live,
            "blocks": blocks, "nblocks": nblocks, "zw": zw, "r": r, "dp": dp, "vp": vp}


def _expected(w):
    """The exact mask and counted power of the workload, by hand."""
    member = (w["claimed"][:, None, :] == w["table"][None, :, :]).all(-1)
    mask = (w["v"] == 0) & (w["s"][:, :5] == w["claimed"]).all(-1) & w["live"] & member.any(-1)
    counted = (member & mask[:, None]).any(0)
    return mask, int(w["powers"][counted].sum())


def _t(a):
    return torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32 else a)


def _halves(w):
    return (w["powers"] & 0xFFFF).astype(np.int32), (w["powers"] >> 16).astype(np.int32)


def _args(w, kind, jax_side):
    plo, phi = _halves(w)
    conv = jnp.asarray if jax_side else _t
    common = [conv(w[k]) for k in ("r", "s", "v")]
    if kind == "senders":
        lane = [conv(w["blocks"]), conv(w["nblocks"]), *common, conv(w["claimed"])]
    else:
        lane = [conv(w["zw"]), *common, conv(w["claimed"])]
    return [*lane, conv(w["table"]), conv(w["live"]), conv(plo), conv(phi)]


def _jax_program(kind, dp, vp):
    mesh = jax_make_mesh(dp * vp, vp=vp, devices=jax.devices("cpu")[: dp * vp])
    return (jax_mesh_quorum_certify if kind == "senders" else jax_mesh_seal_quorum_certify)(mesh)


def _port_program(kind, dp, vp):
    mesh = make_mesh(dp * vp, vp=vp, devices=[CPU] * (dp * vp))
    assert mesh.shape == {"dp": dp, "vp": vp}
    return (mesh_quorum_certify if kind == "senders" else mesh_seal_quorum_certify)(mesh)


def _as_tuple(out):
    mask, reached, lo, hi = (np.asarray(x) for x in out)
    return mask.astype(bool).tolist(), bool(reached), int(lo), int(hi)


@pytest.mark.parametrize("kind", ["senders", "seals"])
@pytest.mark.parametrize("dp, vp", [(2, 1), (4, 1), (2, 2), (4, 2)])
def test_mesh_certify_matches_jax_at_the_threshold_edges(stand_in, kind, dp, vp):
    w = _workload(10 * dp + vp, dp, vp)
    want_mask, got = _expected(w)
    assert got >= 2**31  # the halves carry past 31 bits
    jax_fn, port_fn = _jax_program(kind, dp, vp), _port_program(kind, dp, vp)
    jax_args, port_args = _args(w, kind, True), _args(w, kind, False)
    for thr in (got - 1, got, got + 1):
        lo, hi = thr & 0xFFFF, thr >> 16
        ours = _as_tuple(port_fn(*port_args, lo, hi))
        ref = _as_tuple(jax_fn(*jax_args, jnp.int32(lo), jnp.int32(hi)))
        assert ours[0] == ref[0] == want_mask.tolist()
        assert ours[1:] == ref[1:]
        assert ours[3] * 65536 + ours[2] == got
        assert ours[1] == (thr <= got)
    assert stand_in == [LANES // dp] * (3 * dp)  # a recovery a lane shard a call


@pytest.mark.parametrize("dp, vp", [(2, 2), (4, 1)])
def test_mesh_certify_counts_a_sender_once_across_lane_shards(stand_in, dp, vp):
    """Lanes 0 and 15 (the first and the last lane shard) carry one
    validator's valid message: its two rows (in the first and the last
    table shard) count once each, so the power is the powers of the
    distinct counted rows, not a sum a shard."""
    w = _workload(7, dp, vp, big=False)
    want_mask, got = _expected(w)
    assert want_mask[0] and want_mask[LANES - 1]
    port = _as_tuple(_port_program("seals", dp, vp)(*_args(w, "seals", False), got & 0xFFFF, got >> 16))
    ref = _as_tuple(_jax_program("seals", dp, vp)(*_args(w, "seals", True), jnp.int32(got & 0xFFFF),
                                                   jnp.int32(got >> 16)))
    assert port == ref and port[1]
    assert port[3] * 65536 + port[2] == got
    per_shard = 0
    for i in range(dp):
        rows = slice(i * LANES // dp, (i + 1) * LANES // dp)
        eq = (w["claimed"][rows, None, :] == w["table"][None, :, :]).all(-1)
        per_shard += int(w["powers"][(eq & want_mask[rows, None]).any(0)].sum())
    assert per_shard > got  # summing a shard's count apart would count the sender twice


def _lanes(w, kind):
    if kind == "senders":
        return _SenderLanes(w["blocks"], w["nblocks"], w["r"], w["s"], w["v"], w["claimed"], w["live"], [], None)
    return _DigestLanes(w["zw"], w["r"], w["s"], w["v"], w["claimed"], w["live"])


@pytest.mark.parametrize("kind", ["senders", "seals"])
@pytest.mark.parametrize("dp", [2, 4])
def test_sharded_mask_matches_jax_mask_fn(stand_in, kind, dp):
    """``ShardedMask`` over ``[cpu] * dp`` against the JAX package's
    ``_mask_fn`` on each shard (the body of its ``shard_map`` program,
    which has no collective), concatenated."""
    w = _workload(30 + dp, dp, 1)
    sharded = ShardedMask(make_mesh(dp, devices=[CPU] * dp))
    ours = sharded(_lanes(w, kind), sharded.tables(w["table"]))
    step = LANES // dp
    zw = w["zw"]  # the stand-in reads no digest: the envelopes' payloads stand aside
    ref = np.concatenate([
        np.asarray(jax_mesh_batch._mask_fn(*(jnp.asarray(a[i * step:(i + 1) * step])
                                             for a in (zw, w["r"], w["s"], w["v"], w["claimed"])),
                                           jnp.asarray(w["table"]), jnp.asarray(w["live"][i * step:(i + 1) * step])))
        for i in range(dp)
    ])
    assert ours.tolist() == ref.tolist() == _expected(w)[0].tolist()
    assert stand_in == [step] * dp
