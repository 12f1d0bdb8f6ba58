"""The traffic the benchmark signs is the program's own wire format: its
frozen encoder and signer give the bytes the port's ECDSA backend builds."""

import pytest

from portbench.harness import pool as pools
from portbench.harness import wire


@pytest.fixture(scope="module")
def traffic():
    from go_ibft_tpu_torch.bench.engine import Committee

    return pools.live_pool(10, 2, 5, 3, 600, 2), Committee(10, 5)


def test_keys_match_the_program(traffic):
    pool, committee = traffic
    assert [k.address for k in committee.keys] == pool.committee.addresses


@pytest.mark.parametrize("k", range(3))
def test_messages_match_the_program(traffic, k):
    from go_ibft_tpu_torch.crypto.backend import proposal_hash_of
    from go_ibft_tpu_torch.messages.wire import IbftMessage

    pool, committee = traffic
    hp = pool.heights[k]
    pp = IbftMessage.decode(hp.preprepare)
    assert proposal_hash_of(pp.preprepare_data.proposal) == hp.proposal_hash
    built = committee.backends[hp.proposer].build_preprepare_message(hp.raw, None, pp.view)
    assert built.encode() == hp.preprepare
    others = pools.arrival_order([i for i in range(10) if i != hp.proposer], set(pool.bad))
    for j, i in enumerate(others):
        prep = committee.backends[i].build_prepare_message(hp.proposal_hash, pp.view)
        commit = committee.backends[i].build_commit_message(hp.proposal_hash, pp.view)
        if i in pool.bad:
            assert prep.encode() != hp.prepares[j] and commit.encode() != hp.commits[j]
        else:
            assert prep.encode() == hp.prepares[j] and commit.encode() == hp.commits[j]


def test_byzantine_arrivals_are_the_same_for_every_seed():
    for seed in (1, 2, 3_300_000_019):
        pool = pools.live_pool(13, 3, seed, 2, 600, 2)
        bad = {pool.committee.addresses[i] for i in pool.bad}
        from go_ibft_tpu_torch.messages.wire import IbftMessage

        places = [j for j, raw in enumerate(pool.heights[0].prepares) if IbftMessage.decode(raw).sender in bad]
        assert places == [3, 7, 11]


def test_every_lane_is_indexed(traffic):
    pool, _ = traffic
    per_height = 1 + 3 * 9
    assert len(pool.lanes) == 3 * per_height
    assert wire.proposal(b"x", 0) == b"\n\x01x"
