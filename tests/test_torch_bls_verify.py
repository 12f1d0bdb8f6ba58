"""The port's aggregate pairing check (``verify/bls.py::aggregate_check``,
device route: the pairing kernels' plain versions on CPU tensors) against
the JAX package's host oracle route on the same seals, and the card's
no-demotion rule for the BLS device routes (``G2MergeTree``,
``MultiPairVerifier``, the certifier in ``ChainRunner``), shown with stubs
standing in for a faulting kernel on a CUDA device.  Tolerance: exact
verdicts.
"""

import pytest
import torch

from go_ibft_tpu.crypto import bls as jhost
from go_ibft_tpu.verify import bls as jbls
from go_ibft_tpu_torch.crypto import bls as hbls
from go_ibft_tpu_torch.utils import metrics as tmetrics
from go_ibft_tpu_torch.verify import aggregate as tagg
from go_ibft_tpu_torch.verify import bls as tbls

torch.set_num_threads(1)
MSG = (b"torch bls verify" + b"\x00" * 32)[:32]
KEYS = [hbls.BLSPrivateKey.from_seed(b"torch-bls-%d" % i) for i in range(4)]


def _case(name):
    sigs = [k.sign(MSG) for k in KEYS]
    pubkeys = [k.pubkey for k in KEYS]
    if name == "one_bad_seal":
        sigs[2] = KEYS[2].sign(b"\x01" * 32)
    if name == "empty":
        sigs, pubkeys = [], []
    msg = b"\x02" * 32 if name == "wrong_message" else MSG
    return msg, sigs, pubkeys


@pytest.mark.parametrize("name", ["clean_quorum", "one_bad_seal", "wrong_message", "empty"])
def test_device_route_verdict_matches_the_jax_host_oracle(name):
    msg, sigs, pubkeys = _case(name)
    eq0 = tmetrics.get_counter(tbls.PAIRING_EQS_KEY)
    got = tbls.aggregate_check(msg, sigs, pubkeys, device=True, torch_device="cpu")
    want = jbls.aggregate_check(msg, sigs, pubkeys, device=False)
    assert got == want == (name == "clean_quorum")
    assert tmetrics.get_counter(tbls.PAIRING_EQS_KEY) == eq0 + 1


def test_certificate_lane_pads_points_and_pubkeys_apart():
    """One aggregate point against three pubkeys (a quorum certificate's
    lane): the device route pads each side with its own live mask."""
    agg = hbls.aggregate_signatures([k.sign(MSG) for k in KEYS[:3]])
    pubkeys = [k.pubkey for k in KEYS[:3]]
    assert tbls.aggregate_check(MSG, [agg], pubkeys, device=True, torch_device="cpu")
    assert jhost.aggregate_verify(pubkeys, MSG, agg)


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("this box has a card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tbls.BLSAggregateVerifier(lambda _h: {})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tagg.G2MergeTree()
    assert tbls.BLSAggregateVerifier(lambda _h: {}, device=False).device is None


def _boom(*_a, **_k):
    raise RuntimeError("simulated kernel fault")


def test_merge_tree_fault_on_the_card_propagates(monkeypatch):
    """On a CUDA device a merge fault raises and nothing is demoted; on the
    CPU the JAX package's demotion to the host loop stays."""
    pts = [hbls.g2_mul(k, hbls.G2_GEN) for k in range(1, 10)]
    monkeypatch.setattr(tagg, "_merge_g2_groups_device", _boom)
    card = tagg.G2MergeTree(torch_device="cpu")
    card.device = torch.device("cuda")
    with pytest.raises(RuntimeError, match="simulated kernel fault"):
        card.merge(pts)
    assert not card.demoted and card.stats()["faults"] == 1 and card.stats()["host_merges"] == 0
    cpu = tagg.G2MergeTree(torch_device="cpu")
    assert cpu.merge(pts) == hbls.aggregate_signatures(pts)
    assert cpu.demoted and cpu.stats()["host_merges"] == 1


def test_multipair_fault_on_the_card_propagates(monkeypatch):
    """The device rung's fault on a CUDA device raises through
    ``MultiPairVerifier.check``; on the CPU it demotes to the host batch."""
    original = tagg.multi_aggregate_check

    def faulting(lanes, *, route="host", torch_device=None):
        if route == "device":
            _boom()
        return original(lanes, route=route, torch_device=torch_device)

    monkeypatch.setattr(tagg, "multi_aggregate_check", faulting)
    card = tagg.MultiPairVerifier(device=True, torch_device="cpu")
    card.device = torch.device("cuda")
    with pytest.raises(RuntimeError, match="simulated kernel fault"):
        card.check([(MSG, [], [])])
    assert card.stats()["route"] == "device" and card.stats()["demotions"] == 0
    cpu = tagg.MultiPairVerifier(device=True, torch_device="cpu")
    assert cpu.check([(MSG, [], [])]).tolist() == [False]
    assert cpu.stats()["route"] == "host" and cpu.stats()["demotions"] == 1


def test_certifier_fault_on_the_card_ends_the_finalize(tmp_path):
    """A certifier whose merge tree is on the card and faults: the runner's
    finalize hook raises (``run()`` ends with it) instead of writing the
    JAX package's per-seal fallback record; off the card the fallback
    stays."""
    from go_ibft_tpu_torch.bench.engine import NullLogger, _Silent
    from go_ibft_tpu_torch.chain import ChainRunner, WriteAheadLog
    from go_ibft_tpu_torch.core import IBFT
    from go_ibft_tpu_torch.crypto import PrivateKey
    from go_ibft_tpu_torch.crypto.backend import ECDSABackend
    from go_ibft_tpu_torch.crypto.quorum_cert import BLSCertifier
    from go_ibft_tpu_torch.messages.helpers import CommittedSeal
    from go_ibft_tpu_torch.messages.wire import Proposal

    key = PrivateKey.from_seed(b"torch-bls-runner")
    powers = {key.address: 1}

    class Faulting:
        def __init__(self, dev):
            self.device = torch.device(dev)

        def merge(self, points):
            raise RuntimeError("simulated kernel fault")

    seal = CommittedSeal(key.address, tbls.encode_seal(KEYS[0].sign(MSG)))
    for dev, raises in (("cuda", True), ("cpu", False)):
        certifier = BLSCertifier(lambda _h: powers, lambda _h: {key.address: KEYS[0].pubkey},
                                 aggregator=Faulting(dev))
        engine = IBFT(NullLogger(), ECDSABackend(key, ECDSABackend.static_validators(powers)), _Silent())
        runner = ChainRunner(engine, WriteAheadLog(str(tmp_path / f"{dev}.jsonl")), certifier=certifier,
                             overlap=False)
        try:
            if raises:
                with pytest.raises(RuntimeError, match="simulated kernel fault"):
                    runner._on_finalize(1, Proposal(raw_proposal=b"b1", round=0), [seal])
                assert runner.chain == []
            else:
                runner._on_finalize(1, Proposal(raw_proposal=b"b1", round=0), [seal])
                assert runner.chain[0].cert is None and runner.chain[0].seals == [seal]
        finally:
            engine.messages.close()
            runner.wal.close()


def test_certifier_device_reports_any_route_on_the_card():
    """``BLSCertifier.device`` is what ``on_card`` reads: its own pairing
    route, its merge tree or its multi-pairing verifier on the card makes
    the certifier the card's; all on the host, it is not."""
    from go_ibft_tpu_torch.crypto.quorum_cert import BLSCertifier
    from go_ibft_tpu_torch.verify.batch import on_card

    def certifier(**kw):
        return BLSCertifier(lambda _h: {}, lambda _h: {}, **kw)

    card_merge = tagg.G2MergeTree(device=True, torch_device="cpu")
    card_merge.device = torch.device("cuda")
    card_multi = tagg.MultiPairVerifier(device=True, torch_device="cpu")
    card_multi.device = torch.device("cuda")
    host_merge = tagg.G2MergeTree(device=True, torch_device="cpu")
    assert on_card(certifier(aggregator=card_merge))
    assert on_card(certifier(multipair=card_multi, aggregator=host_merge))
    assert certifier(device=True, torch_device="cpu").device == torch.device("cpu")
    assert not on_card(certifier(device=True, torch_device="cpu", aggregator=host_merge))
    assert not on_card(certifier()) and certifier().device is None


@pytest.mark.slow
def test_aggregate_verify_commit_matches_the_jax_device_program():
    """The JAX package's device ``aggregate_verify_commit`` and the port's
    (plain route) on the same packed arrays, carried across by
    ``convert.bls_points``, at ``tests/test_bls_device.py``'s shapes (3
    seals padded to 4): equal verdicts on a clean quorum, a bad seal, the
    bad lane masked off and a wrong pubkey set; on the clean quorum the
    aggregates, the Miller product and the final exponentiation equal the
    JAX stages' as integers mod p, and the host pairing ratio cubed.  Slow:
    the JAX pairing program's XLA:CPU compile takes minutes."""
    import jax.numpy as jnp
    import numpy as np

    from go_ibft_tpu.ops import bls12_381 as jdev
    from go_ibft_tpu.ops import bls_fp as jfp
    from go_ibft_tpu.ops.fields import from_limbs
    from go_ibft_tpu_torch import convert
    from go_ibft_tpu_torch.ops import bls12_381 as tops
    from go_ibft_tpu_torch.ops import bls_kernels as tk

    rinv = pow(jfp.R_MONT, -1, jfp.P)

    def ints(a):  # JAX Montgomery limbs -> integers mod p
        return [v * rinv % jfp.P for v in from_limbs(np.asarray(a).reshape(-1, np.asarray(a).shape[-1]))]

    def f12_ints(arrs):
        f = jdev._f12_from_arrs(arrs, jdev.F12_ONE)
        return tuple(tuple((ints(e.c0.arr)[0], ints(e.c1.arr)[0]) for e in (h.c0, h.c1, h.c2))
                     for h in (f.c0, f.c1))

    keys = [jhost.BLSPrivateKey.from_seed(b"dv-%d" % i) for i in range(3)]
    msg = b"device aggregate proposal hash\x00\x00"[:32]
    sigs = [k.sign(msg) for k in keys]
    pks = [k.pubkey for k in keys]
    h = jhost.hash_to_g2(msg)
    hx = [a[0] for a in jdev.pack_g2_points([h])]
    h_port = convert.bls_points(*hx, device="cpu")
    assert [np.array_equal(a, b) for a, b in zip(convert.bls_point_arrays(h_port), hx)] == [True] * 4

    def run(sigs, pks, live):
        pad = 4 - len(sigs)
        g1 = jdev.pack_g1_points(pks + [None] * pad)
        g2 = jdev.pack_g2_points(sigs + [None] * pad)
        mask = np.array(live + [False] * pad)
        want = bool(np.asarray(jdev.aggregate_verify_commit(
            *map(jnp.asarray, (*g1, *g2, *hx, mask)))))
        pk, sig = convert.bls_points(*g1, device="cpu"), convert.bls_points(*g2, device="cpu")
        got = bool(tops.aggregate_verify_commit(pk, sig, h_port, torch.from_numpy(mask)))
        assert got == want
        return got, (g1, g2, mask, pk, sig)

    assert run(sigs, pks, [True] * 3)[0]
    bad = [keys[0].sign(b"evil" + b"\x00" * 28)] + sigs[1:]
    ok, (g1, g2, mask, pk, sig) = run(bad, pks, [True] * 3)
    assert not ok
    assert run(bad, pks, [False, True, True])[0]
    other = jhost.BLSPrivateKey.from_seed(b"dv-x").pubkey
    assert not run(sigs, [other] + pks[1:], [True] * 3)[0]

    # The bad seal's lanes stage by stage (the stages aggregate_verify_commit
    # ran): a pairing ratio that is not one.
    pk_ax, npk_ay, sx0, sx1, sy0, sy1, nonempty = jdev._aggregate_stage(*map(jnp.asarray, (*g1, *g2, mask)))
    live = torch.from_numpy(mask)
    npk, pk_inf = tk.merge(pk.unsqueeze(0), live.unsqueeze(0), neg_y=True)
    s, s_inf = tk.merge(sig.unsqueeze(0), live.unsqueeze(0))
    assert tops._values(npk) == ints(pk_ax) + ints(npk_ay)
    assert tops._values(s) == ints(sx0) + ints(sx1) + ints(sy0) + ints(sy1)
    assert bool(nonempty) and not bool(pk_inf[0]) and not bool(s_inf[0])
    prod = jdev._miller_product_stage(
        jnp.stack([sx0, jnp.asarray(hx[0])]), jnp.stack([sx1, jnp.asarray(hx[1])]),
        jnp.stack([sy0, jnp.asarray(hx[2])]), jnp.stack([sy1, jnp.asarray(hx[3])]),
        jnp.stack([jnp.asarray(jdev._G1_GEN_X), pk_ax]), jnp.stack([jnp.asarray(jdev._G1_GEN_Y), npk_ay]))
    gen = torch.from_numpy(tops._G1_GEN).unsqueeze(0)
    f = tk.miller(torch.stack([s, h_port.unsqueeze(0)]), torch.stack([gen, npk]))
    assert tops.unpack_f12(f)[0] == f12_ints(prod)
    easy = jdev._easy_part_stage(prod)
    t2, t = (f12_ints(x) for x in jdev._hard_part_stage(easy))
    e = f12_ints(easy)
    jax_result = jhost.f12_mul(jhost.f12_mul(jhost.f12_mul(t2, jhost.f12_pow(t, jhost.P ** 2)),
                                             jhost.f12_pow(t, jhost.P ** 6)), jhost.f12_pow(e, 3))
    verdict, result = tk.final_exp(f, ~pk_inf & ~s_inf)
    assert not bool(verdict[0]) and tops.unpack_f12(result)[0] == jax_result != jhost.F12_ONE
    ratio = jhost.f12_mul(jhost.pairing(jhost.aggregate_signatures(bad), jhost.G1_GEN),
                          jhost.pairing(h, jhost.g1_neg(jhost.aggregate_pubkeys(pks))))
    assert jax_result == jhost.f12_pow(ratio, 3)
