"""Batched certificate equations and the aggregate verifier's bisection,
held against the JAX package: ``multi_aggregate_check`` on the host-batch
route and on the device route (the multi-pairing kernels' plain versions on
CPU tensors) equals the per-lane oracle, a relabeled and a bit-flipped
certificate included (``bench.py`` config #13's gate); the certifier's
``verify_many`` equals the JAX package's; ``BLSAggregateVerifier``'s masks
and pairing-equation counts on a seeded corrupt mix equal the JAX
package's.  Tolerance: exact verdicts and counts.
"""

import numpy as np
import torch

from go_ibft_tpu.crypto import quorum_cert as jqc
from go_ibft_tpu.utils import metrics as jmetrics
from go_ibft_tpu.verify import aggregate as jagg
from go_ibft_tpu.verify import bls as jbls
from go_ibft_tpu_torch.bench.bls_chain import BLSCommittee, certificate_batch, tamper
from go_ibft_tpu_torch.crypto import bls as hbls
from go_ibft_tpu_torch.messages.helpers import CommittedSeal
from go_ibft_tpu_torch.utils import metrics as tmetrics
from go_ibft_tpu_torch.verify import aggregate as tagg
from go_ibft_tpu_torch.verify import bls as tbls

torch.set_num_threads(1)


def test_multi_aggregate_check_routes_match_the_per_lane_oracle():
    committee = BLSCommittee(4, seed=13)
    certifier = committee.certifier()
    certs = tamper(certificate_batch(committee, certifier, 3))
    # the relabeled certificate reaches the pairing; the bit-flipped seal
    # fails its decode (a structural reject, no lane)
    assert certifier._lane_of(certs[1]) is None
    lanes = [certifier._lane_of(c) for c in certs if certifier._lane_of(c) is not None]
    oracle = [tbls.aggregate_check(*lane) for lane in lanes]
    assert oracle == [False, True]
    empty = (lanes[1][0], [], lanes[1][2])  # a vacuous lane: false on every route
    for route in ("host", "device"):
        got = tagg.multi_aggregate_check(lanes + [empty], route=route, torch_device="cpu")
        assert got.tolist() == oracle + [False], route
    assert jagg.multi_aggregate_check(lanes + [empty], route="host").tolist() == oracle + [False]
    oracle = [False, False, True]

    # the certifier's batch, on both packages: structural rejects first
    jcert = jqc.BLSCertifier(committee.src, committee.bls_src)
    ours = committee.certifier(device=True, torch_device="cpu").verify_many(certs)
    assert ours.tolist() == jcert.verify_many(certs).tolist() == oracle


def _mix(committee, phash, bad, flip):
    seals = []
    for i in range(committee.n):
        msg = (b"wrong" + phash)[:32] if i in bad else phash
        seal = CommittedSeal(committee.keys[i].address, tbls.encode_seal(committee.bls_keys[i].sign(msg)))
        if i == flip:
            sig = bytearray(seal.signature)
            sig[40] ^= 0x01  # an x0 bit: off the curve, rejected at decode
            seal = CommittedSeal(seal.signer, bytes(sig))
        seals.append(seal)
    return seals


def test_bisection_masks_and_pairing_counts_match_jax():
    """Five seals, one over a wrong hash and one bit-flipped: the same
    mask and the same number of pairing equations as the JAX package's
    bisection (both on the host oracle route)."""
    committee = BLSCommittee(5, seed=9)
    phash = (b"bisect" + b"\x00" * 32)[:32]
    seals = _mix(committee, phash, bad={3}, flip=1)
    t0, j0 = tmetrics.get_counter(tbls.PAIRING_EQS_KEY), jmetrics.get_counter(jbls.PAIRING_EQS_KEY)
    ours = tbls.BLSAggregateVerifier(committee.bls_src, device=False).verify_committed_seals(phash, seals, 1)
    theirs = jbls.BLSAggregateVerifier(committee.bls_src, device=False).verify_committed_seals(phash, seals, 1)
    assert ours.tolist() == theirs.tolist() == [True, False, True, False, True]
    t_eqs = tmetrics.get_counter(tbls.PAIRING_EQS_KEY) - t0
    j_eqs = jmetrics.get_counter(jbls.PAIRING_EQS_KEY) - j0
    assert t_eqs == j_eqs and t_eqs > 1
    assert not hbls.verify(committee.bls_keys[3].pubkey, phash, tbls.decode_seal(seals[3].signature))
    np.testing.assert_array_equal(
        tbls.BLSAggregateVerifier(committee.bls_src, device=False).verify_committed_seals(phash, seals[:1], 1),
        [True])
