"""The reference's engine suites on the port's ``core/``.

The cases of ``tests/test_ibft_unit.py``, ``test_byzantine.py``,
``test_round_timeout.py``, ``test_state.py`` and
``test_validator_manager.py`` run here against ``go_ibft_tpu_torch.core``
and ``.messages`` (each file executed with its imports rewritten, the
cluster harness too, ``tests/port_copy.py``; the files are not edited).

Then both packages' engines run the same clusters of the harness (mock
backends, loopback gossip, round-robin proposers): every node's inserted
proposals, their rounds and committed seals, and every gossiped message's
bytes must be identical, on the happy path and with the first height's
round-0 proposer offline (that height finalizes at round 1).  Tolerance:
equality.
"""

import sys

import pytest

import tests.harness as jax_harness
from go_ibft_tpu_torch.core import IBFT as PortIBFT
from tests.port_copy import HARNESS, expose, port_module

COPIED = []
for _file in ("test_ibft_unit.py", "test_byzantine.py", "test_round_timeout.py", "test_state.py",
              "test_validator_manager.py"):
    COPIED += expose(port_module(_file, "torch_" + _file[:-3]), globals())
port_harness = sys.modules[HARNESS]


def test_the_copied_cases_run_the_port():
    assert len(COPIED) == 74
    assert port_harness.IBFT is PortIBFT
    assert globals()["test_states_prepare_commit_fin"].__globals__["IBFT"] is PortIBFT


async def _cluster_outcome(harness, heights, offline=0):
    """Run ``heights`` heights on a 4-node cluster of ``harness``; returns
    each node's inserted (raw proposal, round, seals) and the bytes of every
    gossiped message, sorted."""
    cluster = harness.Cluster(4)
    cluster.set_base_timeout(1.0)  # round 0 expires only without its proposer
    gossiped = []
    gossip = cluster.gossip

    def recording(sender, message):
        gossiped.append(message.encode())
        gossip(sender, message)

    cluster.gossip = recording
    cluster.stop_n(offline)
    try:
        for h in range(heights):
            await cluster.run_height(h, nodes=cluster.nodes[offline:], timeout=20.0)
    finally:
        cluster.shutdown()
    inserted = [
        [(p.raw_proposal, p.round, sorted((s.signer, s.signature) for s in seals))
         for p, seals in node.inserted_blocks]
        for node in cluster.nodes
    ]
    return inserted, sorted(gossiped)


@pytest.mark.parametrize("offline", [0, 1])
async def test_cluster_outcomes_identical_to_jax(offline):
    heights = 3
    ref = await _cluster_outcome(jax_harness, heights, offline)
    ours = await _cluster_outcome(port_harness, heights, offline)
    assert ours == ref
    inserted = ours[0]
    assert all(len(node) == heights for node in inserted[offline:])
    rounds = [round_ for _, round_, _ in inserted[offline][:heights]]
    assert rounds == ([1, 0, 0] if offline else [0, 0, 0])
    assert len(ours[1]) > 0
