"""The port's aggregation-tree gossip (``net/aggtree.py``) against the JAX
package's, with sink callbacks (no engines): the same COMMITs produce the
same certificate bytes and the same per-node wire accounting, and a
Byzantine seal is quarantined.  The port's hub merges each sweep level
through a ``G2MergeTree`` (the merge kernel's plain version on CPU
tensors); the JAX hub through its host fold.  Tolerance: exact (bytes,
counters).
"""

import importlib
from types import SimpleNamespace

import pytest
import torch

torch.set_num_threads(1)
N = 8
PACKAGES = ("go_ibft_tpu_torch", "go_ibft_tpu")


def pkg(name):
    return SimpleNamespace(**{key: importlib.import_module(f"{name}.{mod}") for key, mod in (
        ("crypto", "crypto"), ("bls", "crypto.bls"), ("qc", "crypto.quorum_cert"), ("wire", "messages.wire"),
        ("net", "net"), ("vbls", "verify.bls"), ("agg", "verify.aggregate"))})


@pytest.fixture(scope="module")
def committee():
    m = pkg(PACKAGES[0])
    eck = [m.crypto.PrivateKey.from_seed(b"agt-%d" % i) for i in range(N)]
    blk = [m.bls.BLSPrivateKey.from_seed(b"agt-%d" % i) for i in range(N)]
    powers = {k.address: 1 for k in eck}
    keys = {e.address: b.pubkey for e, b in zip(eck, blk)}
    seals = {}
    return eck, blk, powers, keys, seals


def _commit(m, committee, i, phash, signed=None):
    eck, blk, _, _, seals = committee
    msg = signed or phash
    key = (i, msg)
    if key not in seals:  # both packages' hubs get the same seal bytes
        seals[key] = blk[i].sign(msg)
    return m.wire.IbftMessage(
        view=m.wire.View(height=1, round=0), sender=eck[i].address, type=m.wire.MessageType.COMMIT,
        commit_data=m.wire.CommitMessage(proposal_hash=phash, committed_seal=m.vbls.encode_seal(seals[key])))


def _hub(name, committee, **kw):
    m = pkg(name)
    eck, _, powers, keys, _ = committee
    certifier = m.qc.BLSCertifier(lambda _h: powers, lambda _h: keys)
    if name == PACKAGES[0]:
        kw["merger"] = m.agg.G2MergeTree(torch_device="cpu", cutover_points=1)
    hub = m.net.AggregationTreeGossip(certifier, **kw)
    delivered = [[] for _ in range(N)]
    certs = [[] for _ in range(N)]
    ports = [hub.register(e.address, delivered[i].append, certs[i].append) for i, e in enumerate(eck)]
    return m, hub, ports, delivered, certs


def test_tree_builds_the_jax_packages_certificate_with_the_merge_kernel(committee):
    """Periodic mode: all COMMITs buffered, then one sweep: one
    certificate, byte-identical across the packages, every node holding it,
    the same per-node wire bytes and messages; the port's levels merged on
    the merge kernel's route."""
    got = {}
    for name in PACKAGES:
        m, hub, ports, delivered, certs = _hub(name, committee, auto_pump=False)
        phash = b"t" * 32
        for i in range(N):
            ports[i].multicast(_commit(m, committee, i, phash))
        assert hub.certs_built == 0
        hub.pump()
        assert hub.certs_built == 1 and all(len(c) == 1 for c in certs)
        assert all([msg.sender for msg in d] == [committee[0][i].address] for i, d in enumerate(delivered))
        stats = hub.stats()
        got[name] = (certs[0][0].encode(), stats["commit_bytes_per_node"], stats["commit_msgs_per_node"])
        if name == PACKAGES[0]:
            assert hub.merger.stats()["device_merges"] >= 1 and hub.merger.stats()["faults"] == 0
    assert got[PACKAGES[0]] == got[PACKAGES[1]]


def test_byzantine_seal_quarantined(committee):
    """A decodable seal over the wrong message (the JAX package's own case,
    ``tests/test_aggtree.py``): the root's verify catches it, the
    quarantine evicts exactly that leaf, and the port's hub certifies an
    honest quorum that verifies."""
    m, hub, ports, _, certs = _hub(PACKAGES[0], committee, auto_pump=False)
    phash = b"z" * 32
    for i in range(N):
        ports[i].multicast(_commit(m, committee, i, phash, signed=b"not the hash" if i == 1 else None))
    hub.pump()
    assert hub.certs_built == 1 and hub.rejected_partials == 1
    cert = certs[0][0]
    signers = cert.signers(sorted(committee[2]))
    assert committee[0][1].address not in signers and len(signers) >= (2 * N) // 3 + 1
    assert hub.certifier.verify(cert)
