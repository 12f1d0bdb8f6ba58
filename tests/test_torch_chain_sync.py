"""The port's block sync (``SyncClient``, ``LoopbackSyncNetwork``) and crash
recovery against the JAX package's, on the CPU.

The same seeded block ranges (real secp256k1 seals, some corrupted, a
validator-set change mid-range) go through both packages: the seal-lane
masks, the blocks a catch-up returns, its drain count and every
``SyncError`` text must be identical.  The cluster cases mirror
``tests/test_chain_sync.py`` in virtual time (``test_torch_chain``'s
harness): a stranded node catches up through one batched drain, and a node
killed right after its WAL lock append restarts through ``recover()`` with
the lock and rejoins the same chain as in the JAX package.  The hooks whose
modules the port does not have yet raise ``NotPortedError`` with the slice
they wait for.
"""

import asyncio
import json

import numpy as np
import pytest
import torch
from test_torch_chain import PACKAGES, Cluster, pkg, run_virtual, virtual_clocks  # noqa: F401

torch.set_num_threads(1)

SYNC_DRAINS_KEY = ("go-ibft", "chain", "sync_drains")


def _signed_range(m, n_validators=6, heights=(1, 2, 3), corrupt=(), seed=b"torch-sync"):
    """Finalized blocks with real seals over a height range; ``corrupt``
    holds the ``(height, validator)`` seals whose signature byte 5 flips."""
    keys = [m.crypto.PrivateKey.from_seed(seed + b"-%d" % i) for i in range(n_validators)]
    src = m.cb.ECDSABackend.static_validators({k.address: 1 for k in keys})
    ecdsa = __import__(f"{m.name}.crypto.ecdsa", fromlist=["sign"])
    blocks = []
    for h in heights:
        proposal = m.wire.Proposal(raw_proposal=b"sync block %d" % h, round=0)
        phash = m.cb.proposal_hash_of(proposal)
        seals = []
        for i, key in enumerate(keys):
            sig = m.cb.encode_signature(*ecdsa.sign(key, phash))
            if (h, i) in corrupt:
                sig = sig[:5] + bytes([sig[5] ^ 0xFF]) + sig[6:]
            seals.append(m.helpers.CommittedSeal(signer=key.address, signature=sig))
        blocks.append(m.chain.FinalizedBlock(h, proposal, seals))
    return blocks, keys, src


def _lanes(m, blocks):
    return [(m.cb.proposal_hash_of(b.proposal), seal) for b in blocks for seal in b.seals]


def _both(fn):
    """``fn(m)`` for the port, then the JAX package."""
    return [fn(pkg(name)) for name in PACKAGES]


# -- verify_seal_lanes ---------------------------------------------------------


def test_seal_lane_masks_match_jax_and_the_oracle():
    def masks(m):
        blocks, keys, src = _signed_range(m, corrupt={(2, 1), (3, 4)})
        lanes = _lanes(m, blocks)
        backend = m.cb.ECDSABackend(keys[0], src)
        oracle = [backend.is_valid_committed_seal(m.cb.proposal_hash_of(b.proposal), s, b.height)
                  for b in blocks for s in b.seals]
        host = m.verify.HostBatchVerifier(src).verify_seal_lanes(lanes, blocks[-1].height)
        resilient = m.verify.ResilientBatchVerifier(m.verify.HostBatchVerifier(src), validators_for_height=src)

        class BareRung:
            """A rung without the per-lane entry point (the grouped fallback)."""

            def __init__(self, inner):
                self.verify_committed_seals = inner.verify_committed_seals
                self.verify_senders = inner.verify_senders

        bare = m.verify.ResilientBatchVerifier(BareRung(m.verify.HostBatchVerifier(src)), validators_for_height=src)
        return [list(map(bool, x)) for x in (
            oracle, host, resilient.verify_seal_lanes(lanes, 3), bare.verify_seal_lanes(lanes, 3))]

    ours, ref = _both(masks)
    assert ours == ref
    assert all(x == ours[0] for x in ours) and ours[0].count(False) == 2


def test_device_verifier_seal_lanes_match_jax_host():
    from go_ibft_tpu_torch.verify import DeviceBatchVerifier

    def host_mask(m):
        blocks, _, src = _signed_range(m, corrupt={(1, 0), (3, 5)})
        return list(map(bool, m.verify.HostBatchVerifier(src).verify_seal_lanes(_lanes(m, blocks), 3)))

    port = pkg(PACKAGES[0])
    blocks, _, src = _signed_range(port, corrupt={(1, 0), (3, 5)})
    card = DeviceBatchVerifier(src, device="cpu").verify_seal_lanes(_lanes(port, blocks), 3)
    assert list(map(bool, card)) == host_mask(pkg(PACKAGES[1]))


def test_malformed_lanes_quarantined_like_jax():
    def mask(m):
        blocks, keys, src = _signed_range(m, heights=(1, 2))
        lanes = _lanes(m, blocks)
        lanes[3] = (lanes[3][0], m.helpers.CommittedSeal(signer=keys[0].address, signature=b"\x01" * 30))
        lanes[7] = (b"\x22" * 16, lanes[7][1])
        resilient = m.verify.ResilientBatchVerifier(m.verify.HostBatchVerifier(src), validators_for_height=src)
        return list(map(bool, resilient.verify_seal_lanes(lanes, 2)))

    ours, ref = _both(mask)
    assert ours == ref and not ours[3] and not ours[7] and ours.count(False) == 2


# -- SyncClient ------------------------------------------------------------------


class _StaticSource:
    def __init__(self, blocks):
        self.blocks = blocks

    def latest_height(self):
        return self.blocks[-1].height if self.blocks else 0

    def get_blocks(self, start, end):
        return [b for b in self.blocks if start <= b.height <= end]


def _catch_up(m, blocks, src, start=1, target=3, serve=True):
    """Catch up ``[start, target]`` from one static peer: the blocks (as
    bytes) and the sync drain count, or the ``SyncError`` text."""
    m.metrics.reset()
    net = m.chain.LoopbackSyncNetwork()
    if serve:
        net.register(b"server", _StaticSource(blocks))
    client = m.chain.SyncClient(b"me", net, m.verify.HostBatchVerifier(src), src)
    try:
        got = client.catch_up(start, target)
    except m.chain.SyncError as err:
        return ("SyncError", str(err))
    return (
        [(b.height, b.proposal.encode(), [(s.signer, s.signature) for s in b.seals]) for b in got],
        client.best_peer_height(),
        m.metrics.get_counter(SYNC_DRAINS_KEY),
    )


CATCH_UPS = {
    "whole_range_one_drain": dict(),
    "corrupted_seals_still_quorum": dict(corrupt={(1, 2), (3, 0)}),
    "subquorum_height_rejected": dict(corrupt={(2, 0), (2, 1), (2, 2)}),
    "gapped_range_rejected": dict(gap=True),
    "no_peer_serves": dict(serve=False),
    "certificate_block_rejected": dict(cert=True),
}


@pytest.mark.parametrize("case", sorted(CATCH_UPS))
def test_catch_up_matches_jax(case):
    kw = dict(CATCH_UPS[case])

    def run(m):
        blocks, _, src = _signed_range(m, corrupt=kw.get("corrupt", ()))
        if kw.get("gap"):
            del blocks[1]
        if kw.get("cert"):
            blocks[2].cert = object()  # any certificate: no client here can check one
            blocks[2].seals = []
        return _catch_up(m, blocks, src, serve=kw.get("serve", True))

    ours, ref = _both(run)
    assert ours == ref
    if case.endswith("one_drain") or case.startswith("corrupted"):
        assert [b[0] for b in ours[0]] == [1, 2, 3] and ours[2] == 1
    else:
        assert ours[0] == "SyncError"


@pytest.mark.parametrize("rotated_quorum_fails", [False, True])
def test_validator_set_change_mid_range_matches_jax(rotated_quorum_fails):
    """Heights 1-2 under six validators, 3-4 under the first four: two
    snapshots, so two drains; a rotated set whose quorum the height-3 seals
    miss is rejected with the same text."""

    def run(m):
        blocks, keys, _ = _signed_range(m, heights=(1, 2, 3, 4),
                                        corrupt={(3, 0), (3, 1)} if rotated_quorum_fails else ())
        full = {k.address: 1 for k in keys}
        rotated = {k.address: 1 for k in keys[:4]}
        src = lambda h: full if h < 3 else rotated  # noqa: E731
        return _catch_up(m, blocks, src, target=4)

    ours, ref = _both(run)
    assert ours == ref
    if rotated_quorum_fails:
        assert ours[0] == "SyncError" and "height 3" in ours[1]
    else:
        assert [b[0] for b in ours[0]] == [1, 2, 3, 4] and ours[2] == 2


# -- the hooks that wait for their slices ----------------------------------------


class _Stub:
    """Stands in for a certificate or checkpoint record of the JAX package."""

    epoch, height = 1, 8

    def encode(self):
        return b"\x01\x02"


def test_certificate_hooks_raise_not_ported(tmp_path):
    from go_ibft_tpu_torch.chain import NotPortedError

    m = pkg(PACKAGES[0])
    blocks, _, src = _signed_range(m, heights=(1,))
    with pytest.raises(NotPortedError, match="crypto.quorum_cert.*BLS slice"):
        m.chain.SyncClient(b"me", m.chain.LoopbackSyncNetwork(), m.verify.HostBatchVerifier(src), src,
                           cert_verifier=object())
    wal = m.chain.WriteAheadLog(str(tmp_path / "port.jsonl"))
    with pytest.raises(NotPortedError, match="BLS slice"):
        wal.append_finalize(1, blocks[0].proposal, [], cert=_Stub())
    # A WAL the JAX package wrote with a certificate record: replay raises
    # and never takes the record for a torn tail.
    jax = pkg(PACKAGES[1])
    path = str(tmp_path / "jax.jsonl")
    jwal = jax.chain.WriteAheadLog(path)
    jwal.append_finalize(1, jax.wire.Proposal(raw_proposal=b"b1", round=0), [])
    jwal.append_finalize(2, jax.wire.Proposal(raw_proposal=b"b2", round=0), [], cert=_Stub())
    jwal.close()
    with open(path, "rb") as fh:
        before = fh.read()
    assert json.loads(before.splitlines()[-1])["cert"] == "0102"
    with pytest.raises(NotPortedError, match="crypto.quorum_cert"):
        m.chain.WriteAheadLog(path).replay()
    with open(path, "rb") as fh:
        assert fh.read() == before


def test_checkpoint_and_boot_hooks_raise_not_ported(tmp_path):
    from go_ibft_tpu_torch.chain import NotPortedError

    m = pkg(PACKAGES[0])
    wal = m.chain.WriteAheadLog(str(tmp_path / "port.jsonl"))
    with pytest.raises(NotPortedError, match="lightsync.*serving slice"):
        wal.append_checkpoint(_Stub())
    jax = pkg(PACKAGES[1])
    path = str(tmp_path / "jax.jsonl")
    jwal = jax.chain.WriteAheadLog(path)
    jwal.append_checkpoint(_Stub())
    jwal.close()
    with pytest.raises(NotPortedError, match="lightsync"):
        m.chain.WriteAheadLog(path).replay()

    keys = [m.crypto.PrivateKey.from_seed(b"torch-hooks-%d" % i) for i in range(4)]
    src = m.cb.ECDSABackend.static_validators({k.address: 1 for k in keys})

    def engine():
        return m.core.IBFT(None, m.cb.ECDSABackend(keys[0], src), None)

    runner = m.chain.ChainRunner(engine(), wal)
    with pytest.raises(NotPortedError, match="boot.warmstart.*boot slice"):
        runner.warm_start()
    with pytest.raises(NotPortedError, match="BLS slice"):
        m.chain.ChainRunner(engine(), wal, certifier=object())
    with pytest.raises(NotPortedError, match="serving slice"):
        m.chain.ChainRunner(engine(), wal, checkpointer=object())


# -- clusters (mirror tests/test_chain_sync.py) ---------------------------------


def test_stranded_node_catches_up_in_one_drain_like_jax(tmp_path, virtual_clocks):
    """A node offline for 3 finalized heights rejoins through block sync:
    one batched seal drain for the whole range, the same chain as its peers
    and as the JAX package's run."""

    def run(m):
        m.metrics.reset()

        async def body():
            cluster = Cluster(m.name, tmp_path / m.name, seed=b"torch-strand", sync=True, timeout=2.0)
            cluster.offline.add(3)
            try:
                await asyncio.wait_for(asyncio.gather(
                    *(cluster.runners[i].run(until_height=3) for i in range(3))), 60)
                cluster.offline.discard(3)
                before = m.metrics.get_counter(SYNC_DRAINS_KEY)
                await asyncio.wait_for(cluster.runners[3].run(until_height=3), 30)
                drains = m.metrics.get_counter(SYNC_DRAINS_KEY) - before
            finally:
                cluster.close()
            stranded = cluster.runners[3]
            return ([cluster.chain(i) for i in range(4)], stranded.synced_heights, drains,
                    cluster.wal_bytes(3))

        return run_virtual(body())

    ours, ref = _both(run)
    assert ours == ref
    chains, synced, drains, _ = ours
    assert synced == 3 and drains == 1
    assert [b[:2] for b in chains[3]] == [b[:2] for b in chains[0]]


def test_crash_restart_rejoins_with_lock_like_jax(tmp_path, virtual_clocks):
    """Five validators, one offline (quorum 4 of 5: all four load-bearing).
    A seeded kill point fires on node 0's lock hook right after the WAL lock
    append, before its COMMIT leaves; ``recover()`` restores the lock, and
    the cluster reconverges on one chain whose height 1 is the proposal node
    0 was locked on — the same chain, lock and WALs in both packages."""

    def run(m):
        injector = m.chaos.FaultInjector(21)

        async def body():
            cluster = Cluster(m.name, tmp_path / m.name, n=5, seed=b"torch-crash", sync=True, timeout=1.0,
                              latency=lambda r, s: 0.0005 if r != s else 0.0, sync_stall_s=0.6)
            cluster.offline.add(4)
            crash = m.chaos.CrashRestart(injector, "crash:node-0", lo=1, hi=1)
            engine0 = cluster.runners[0].engine
            engine0.on_lock = crash.wrap(engine0.on_lock)
            crashed = asyncio.Event()

            async def run_node0():
                try:
                    await cluster.runners[0].run(until_height=2)
                except m.chaos.SimulatedCrash:
                    crashed.set()

            peers = [asyncio.create_task(cluster.runners[i].run(until_height=2)) for i in (1, 2, 3)]
            node0 = asyncio.create_task(run_node0())
            try:
                await asyncio.wait_for(crashed.wait(), 30)
                await asyncio.gather(node0, return_exceptions=True)
                cluster.kill(0)
                lock = m.chain.WriteAheadLog(cluster.wal_path(0)).replay().lock
                await asyncio.sleep(0.8)
                stalled = [cluster.runners[i].latest_height() for i in (1, 2, 3)]
                restarted = cluster.restart(0)
                restored = (restarted.height, restarted._restore.certificate.encode())
                node0 = asyncio.create_task(restarted.run(until_height=2))
                await asyncio.wait_for(asyncio.gather(*peers, node0), 60)
            finally:
                for task in peers + [node0]:
                    task.cancel()
                await asyncio.gather(*peers, node0, return_exceptions=True)
                cluster.close()
            locked_raw = lock.certificate.proposal_message.preprepare_data.proposal.raw_proposal
            return {
                "lock": (lock.height, lock.round, lock.certificate.encode()),
                "stalled": stalled,
                "restored": restored,
                "chains": [[b[1] for b in cluster.chain(i)] for i in range(4)],
                "raw": [[b.proposal.raw_proposal for b in cluster.runners[i].chain] for i in range(4)],
                "locked_raw": locked_raw,
            }

        return run_virtual(body())

    ours, ref = _both(run)
    assert ours == ref
    assert ours["lock"][0] == 1 and ours["stalled"] == [0, 0, 0]
    assert ours["restored"] == (1, ours["lock"][2])
    assert all(c == ours["chains"][0] for c in ours["chains"]) and len(ours["chains"][0]) == 2
    assert ours["raw"][0][0] == ours["locked_raw"]  # no equivocation
    assert np.all([len(c) == 2 for c in ours["raw"]])
