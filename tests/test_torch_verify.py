"""The port's packers, state conversion and ``DeviceBatchVerifier`` on the CPU.

* The packers give bit-identical arrays to the JAX package's packers.
* ``convert.round_args`` round-trips the 18 ``round_certify`` arrays.
* ``DeviceBatchVerifier(device="cpu")`` — ``certify_round``,
  ``certify_senders``, ``certify_seals`` and the mask-only drains — equals
  the JAX package's sequential ``HostBatchVerifier`` masks and
  ``host_quorum_reached`` on a 16-validator round with 30 % bad
  signatures, malformed lanes and an oversize payload, and keeps the
  reference's answers on degenerate rounds.

Keys and signatures are deterministic (seeded); tolerance is exact
equality of every mask and verdict.
"""

import numpy as np
import pytest
import torch

from go_ibft_tpu.bench import build_signed_round as jax_signed_round
from go_ibft_tpu.crypto.backend import ECDSABackend as JaxBackend
from go_ibft_tpu.messages.helpers import CommittedSeal as JaxSeal
from go_ibft_tpu.messages.wire import IbftMessage as JaxMessage
from go_ibft_tpu.verify import batch as jbatch
from go_ibft_tpu_torch import convert
from go_ibft_tpu_torch.bench import build_round_workload, build_signed_round
from go_ibft_tpu_torch.crypto import PrivateKey
from go_ibft_tpu_torch.crypto.backend import ECDSABackend
from go_ibft_tpu_torch.messages import CommittedSeal, IbftMessage, View
from go_ibft_tpu_torch.verify import DeviceBatchVerifier
from go_ibft_tpu_torch.verify import batch as tbatch

# Tiny tensors: one intra-op thread beats a pool per xdist worker.
torch.set_num_threads(1)

HEIGHT = 1


def _powers(rnd):
    return {bytes(k): 1 for k in _addresses(rnd)}


def _addresses(rnd):
    return [m.sender for m in rnd.prepares]


def _jax_msgs(msgs):
    """The same envelopes as the JAX package's message objects."""
    return [JaxMessage.decode(m.encode()) for m in msgs]


def _jax_seals(seals):
    return [JaxSeal(signer=s.signer, signature=s.signature) for s in seals]


@pytest.fixture(scope="module")
def bad_round():
    """16 validators, 30 % bad signatures, plus malformed and oversize lanes."""
    rnd = build_signed_round(16, height=HEIGHT, corrupt_frac=0.3, seed=3)
    keys = [PrivateKey.from_seed(b"bench-3-%d" % i) for i in range(16)]
    src = ECDSABackend.static_validators(_powers(rnd))
    big = ECDSABackend(keys[0], src).build_preprepare_message(
        b"\x5a" * 5000, None, View(height=HEIGHT, round=0)
    )
    short = ECDSABackend(keys[1], src).build_prepare_message(rnd.proposal_hash, View(HEIGHT, 0))
    short.signature = short.signature[:40]
    msgs = rnd.prepares + [big, short]
    seals = rnd.seals + [CommittedSeal(signer=b"\x01" * 19, signature=rnd.seals[0].signature)]
    return rnd, src, msgs, seals


def _host_oracle(rnd, msgs, seals):
    powers = _powers(rnd)
    src = JaxBackend.static_validators(powers)
    host = jbatch.HostBatchVerifier(src)
    pm = host.verify_senders(_jax_msgs(msgs))
    sm = host.verify_committed_seals(rnd.proposal_hash, _jax_seals(seals), HEIGHT)
    prep_addrs = [m.sender for m, ok in zip(msgs, pm) if ok]
    seal_addrs = [s.signer for s, ok in zip(seals, sm) if ok]
    return (
        pm,
        jbatch.host_quorum_reached(src, prep_addrs, HEIGHT, None),
        sm,
        jbatch.host_quorum_reached(src, seal_addrs, HEIGHT, None),
    )


def test_packers_bit_identical_to_jax():
    ours = build_signed_round(16, height=HEIGHT, corrupt_frac=0.3, seed=3)
    ref = jax_signed_round(16, height=HEIGHT, corrupt_frac=0.3, seed=3)
    assert [m.encode() for m in ours.prepares] == [m.encode() for m in ref.prepares]
    for pad in (0, 64):
        for a, b in zip(
            tbatch.pack_sender_batch(ours.prepares, pad), jbatch.pack_sender_batch(ref.prepares, pad)
        ):
            assert a.dtype == np.asarray(b).dtype and np.array_equal(a, np.asarray(b))
        for a, b in zip(
            tbatch.pack_seal_batch(ours.proposal_hash, ours.seals, pad),
            jbatch.pack_seal_batch(ref.proposal_hash, ref.seals, pad),
        ):
            assert a.dtype == np.asarray(b).dtype and np.array_equal(a, np.asarray(b))
    addrs = _addresses(ours)
    assert np.array_equal(tbatch.pack_validator_table(addrs), jbatch.pack_validator_table(addrs))
    with pytest.raises(tbatch.MalformedLaneError):
        bad = list(ours.prepares)
        bad[2] = IbftMessage.decode(bad[2].encode())
        bad[2].signature = b"\x00" * 64
        tbatch.pack_sender_batch(bad)
    with pytest.raises(ValueError):
        tbatch.pack_seal_batch(b"\x00" * 31, ours.seals)
    dead = tbatch.pack_sender_batch([])
    assert dead[0].shape == (8, 2, 17, 2) and not dead[-1].any()


def test_round_args_round_trip_and_default_device():
    w = build_round_workload(8, corrupt_frac=0.25)
    arrays = convert.workload_arrays(w)
    args = convert.round_args(w, device="cpu")
    assert args[0].dtype == torch.int32 and args[6].dtype == torch.bool
    assert args[16].dim() == 0 and int(args[16]) == w.thr_lo
    back = convert.round_arrays(args)
    for a, b in zip(back, arrays):
        assert a.dtype == np.asarray(b).dtype and np.array_equal(a, np.asarray(b))
    again = convert.round_args(back, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(args, again))
    with pytest.raises(ValueError):
        convert.round_args(arrays[:17], device="cpu")
    if torch.cuda.is_available():
        assert convert.round_args(w)[0].device.type == "cuda"
    else:  # no quiet CPU fallback: the default device is the card
        with pytest.raises(RuntimeError):
            convert.round_args(w)
        with pytest.raises(RuntimeError):
            DeviceBatchVerifier(lambda h: {})


def test_certify_round_matches_host_oracle(bad_round):
    rnd, src, msgs, seals = bad_round
    prepares = msgs[:16] + msgs[17:]  # the round's PREPAREs + the short-signature lane
    ref = _host_oracle(rnd, prepares, seals)
    ours = DeviceBatchVerifier(src, device="cpu").certify_round(
        prepares, rnd.proposal_hash, seals, HEIGHT
    )
    assert np.array_equal(ours[0], ref[0]) and np.array_equal(ours[2], ref[2])
    assert (ours[1], ours[3]) == (ref[1], ref[3])
    assert np.array_equal(ours[0][:16], rnd.expected_prepare_mask)
    assert np.array_equal(ours[2][:16], rnd.expected_seal_mask)
    assert not ours[0][16] and not ours[2][16]
    assert int(ours[0].sum()) == 12 and ours[1]  # 12 of 16 >= quorum 11


def test_certify_senders_and_seals_match_host_oracle(bad_round):
    rnd, src, msgs, seals = bad_round
    ref = _host_oracle(rnd, msgs, seals)
    dev = DeviceBatchVerifier(src, device="cpu")
    mask, reached = dev.certify_senders(msgs, HEIGHT)
    assert np.array_equal(mask, ref[0]) and reached == ref[1]
    assert mask[16]  # the oversize PREPREPARE: digested on the host, recovered on the device
    mask, reached = dev.certify_seals(rnd.proposal_hash, seals, HEIGHT)
    assert np.array_equal(mask, ref[2]) and reached == ref[3]
    _, reached = dev.certify_seals(rnd.proposal_hash, seals, HEIGHT, threshold=13)
    assert not reached  # 12 valid signers < 13


def test_mask_only_drains_match_host_oracle(bad_round):
    rnd, src, msgs, seals = bad_round
    ref = _host_oracle(rnd, msgs, seals)
    dev = DeviceBatchVerifier(src, device="cpu")
    assert np.array_equal(dev.verify_senders(msgs), ref[0])
    assert np.array_equal(dev.verify_committed_seals(rnd.proposal_hash, seals, HEIGHT), ref[2])


def test_degenerate_rounds_keep_reference_answers():
    rnd = build_signed_round(4, height=HEIGHT, seed=5)
    src = ECDSABackend.static_validators(_powers(rnd))
    dev = DeviceBatchVerifier(src, device="cpu")
    ones = np.ones(4, dtype=bool)
    # No seals: the PREPARE half alone, through certify_senders.
    pm, pr, sm, sr = dev.certify_round(rnd.prepares, rnd.proposal_hash, [], HEIGHT)
    assert np.array_equal(pm, ones) and pr and sm.shape == (0,) and not sr
    # A malformed proposal hash: no seal can verify against it.
    pm, pr, sm, sr = dev.certify_round(rnd.prepares[:3], b"\x00" * 31, rnd.seals, HEIGHT)
    assert pm.all() and pr and not sm.any() and not sr
    # No well-formed PREPARE (wrong height): only the seal half runs.
    wrong = rnd.prepares
    for m in wrong:
        m.view = View(height=HEIGHT + 1, round=0)
    pm, pr, sm, sr = dev.certify_round(wrong, rnd.proposal_hash, rnd.seals, HEIGHT)
    assert not pm.any() and not pr and np.array_equal(sm, ones) and sr
    # Nothing to verify: quorum only where the threshold is already met.
    assert dev.certify_round([], rnd.proposal_hash, [], HEIGHT, prepare_threshold=0)[1]
    mask, reached = dev.certify_senders([], HEIGHT)
    assert mask.shape == (0,) and not reached
    assert not DeviceBatchVerifier(lambda h: {b"\x01" * 20: 1 << 31}, device="cpu").supports_fused(HEIGHT)
