"""Aggregate quorum certificates in the port and the chain's certificate
records, held against the JAX package (the cases of
``tests/test_quorum_cert.py``): certificate encodings and WAL files
byte-identical, each package replaying the other's WAL, the runner
compressing a finalized height into a certificate, and block-sync checking
a certificate range in ONE ``verify_many`` (the port's on the multi-pairing
kernels' plain versions), relabeled and smuggled blocks refused.
Tolerance: exact (bytes, verdicts).
"""

import importlib
from types import SimpleNamespace

import pytest
import torch

torch.set_num_threads(1)


def pkg(name):
    m = SimpleNamespace()
    m.qc = importlib.import_module(f"{name}.crypto.quorum_cert")
    m.bls = importlib.import_module(f"{name}.crypto.bls")
    m.chain = importlib.import_module(f"{name}.chain")
    m.sync = importlib.import_module(f"{name}.chain.sync")
    m.wire = importlib.import_module(f"{name}.messages.wire")
    m.helpers = importlib.import_module(f"{name}.messages.helpers")
    m.backend = importlib.import_module(f"{name}.crypto.backend")
    m.crypto = importlib.import_module(f"{name}.crypto")
    m.core = importlib.import_module(f"{name}.core")
    m.verify = importlib.import_module(f"{name}.verify")
    m.vbls = importlib.import_module(f"{name}.verify.bls")
    m.metrics = importlib.import_module(f"{name}.utils.metrics")
    m.agg = importlib.import_module(f"{name}.verify.aggregate")
    return m


PORT, JAX = pkg("go_ibft_tpu_torch"), pkg("go_ibft_tpu")
N = 4


@pytest.fixture(scope="module")
def committee():
    eck = [PORT.crypto.PrivateKey.from_seed(b"agg-%d" % i) for i in range(N)]
    blk = [PORT.bls.BLSPrivateKey.from_seed(b"agg-%d" % i) for i in range(N)]
    powers = {k.address: 1 for k in eck}
    keys = {e.address: b.pubkey for e, b in zip(eck, blk)}
    return eck, blk, powers, keys


def _seals(m, committee, phash, k=3):
    eck, blk, _, _ = committee
    return [m.helpers.CommittedSeal(e.address, m.vbls.encode_seal(b.sign(phash))) for e, b in zip(eck[:k], blk[:k])]


def _certifier(m, committee, **kw):
    _, _, powers, keys = committee
    return m.qc.BLSCertifier(lambda _h: powers, lambda _h: keys, **kw)


def _proposal(m, h):
    return m.wire.Proposal(raw_proposal=b"block %d" % h, round=0)


def test_certificate_bytes_equal_the_jax_packages(committee):
    for h in (1, 2):
        phash = PORT.backend.proposal_hash_of(_proposal(PORT, h))
        ours = _certifier(PORT, committee).build(h, 0, phash, _seals(PORT, committee, phash))
        theirs = _certifier(JAX, committee).build(h, 0, phash, _seals(JAX, committee, phash))
        assert ours.encode() == theirs.encode()
        assert PORT.qc.AggregateQuorumCertificate.decode(theirs.encode()) == ours
        assert ours.signer_indices() == theirs.signer_indices()
    with pytest.raises(ValueError):
        PORT.qc.AggregateQuorumCertificate.decode(ours.encode()[:-1])


def test_wal_files_with_certificates_are_byte_identical_and_cross_replay(tmp_path, committee):
    paths = {}
    for name, m in (("port", PORT), ("jax", JAX)):
        p1, p2 = _proposal(m, 1), _proposal(m, 2)
        h1 = m.backend.proposal_hash_of(p1)
        cert = _certifier(m, committee).build(1, 0, h1, _seals(m, committee, h1))
        path = str(tmp_path / f"{name}.jsonl")
        wal = m.chain.WriteAheadLog(path)
        wal.append_finalize(1, p1, [], cert=cert)
        wal.append_finalize(2, p2, _seals(m, committee, m.backend.proposal_hash_of(p2)))
        wal.close()
        paths[name] = path
    with open(paths["port"], "rb") as a, open(paths["jax"], "rb") as b:
        assert a.read() == b.read()
    for reader, writer in ((PORT, "jax"), (JAX, "port")):
        state = reader.chain.WriteAheadLog(paths[writer]).replay()
        assert state.blocks[0].cert is not None and state.blocks[0].seals == []
        assert state.blocks[1].cert is None and len(state.blocks[1].seals) == 3
    ours = PORT.chain.WriteAheadLog(paths["jax"]).replay().blocks[0].cert
    theirs = JAX.chain.WriteAheadLog(paths["port"]).replay().blocks[0].cert
    assert ours.encode() == theirs.encode()


def _runner(m, committee, wal_path, certifier):
    eck, _, powers, _ = committee
    src = m.backend.ECDSABackend.static_validators(powers)

    class _T:
        def multicast(self, message):
            pass

    class _Log:
        def info(self, *a):
            pass

        debug = error = info

    engine = m.core.IBFT(_Log(), m.backend.ECDSABackend(eck[0], src), _T())
    return m.chain.ChainRunner(engine, m.chain.WriteAheadLog(wal_path), certifier=certifier, overlap=False)


def test_runner_compresses_finalized_heights_like_jax(tmp_path, committee):
    """``ChainRunner(certifier=...)`` turns a per-seal finalize into a
    certificate record: both packages write the same WAL bytes."""
    files = {}
    for name, m in (("port", PORT), ("jax", JAX)):
        path = str(tmp_path / f"{name}.jsonl")
        runner = _runner(m, committee, path, _certifier(m, committee))
        try:
            for h in (1, 2):
                proposal = _proposal(m, h)
                runner._on_finalize(h, proposal, _seals(m, committee, m.backend.proposal_hash_of(proposal)))
        finally:
            runner.engine.messages.close()
            runner.wal.close()
        assert all(b.cert is not None and b.seals == [] for b in runner.chain)
        files[name] = open(path, "rb").read()
    assert files["port"] == files["jax"]


class _Source:
    def __init__(self, blocks):
        self._blocks = blocks

    def latest_height(self):
        return self._blocks[-1].height if self._blocks else 0

    def get_blocks(self, start, end):
        return [b for b in self._blocks if start <= b.height <= end]


def _cert_blocks(m, committee, heights):
    out = []
    for h in heights:
        proposal = _proposal(m, h)
        phash = m.backend.proposal_hash_of(proposal)
        cert = _certifier(m, committee).build(h, 0, phash, _seals(m, committee, phash))
        out.append(m.chain.FinalizedBlock(h, proposal, [], cert=cert))
    return out


def _client(m, committee, blocks, cert_verifier):
    eck, _, powers, _ = committee
    net = m.chain.LoopbackSyncNetwork()
    net.register(b"peer", _Source(blocks))
    return m.chain.SyncClient(eck[1].address, net, m.verify.HostBatchVerifier(lambda _h: powers),
                              lambda _h: powers, cert_verifier=cert_verifier)


def test_sync_verifies_a_certificate_range_in_one_verify_many(committee):
    """Three certificate heights sync through ONE multi-pairing (the port's
    on the kernels' plain versions, the JAX package's on its host batch);
    both accept the same blocks, and a relabeled, a smuggled-seal and an
    unverifiable block are refused by both."""
    key = PORT.agg.MULTIPAIR_DISPATCHES_KEY
    before = PORT.metrics.get_counter(key)
    ours = _client(PORT, committee, _cert_blocks(PORT, committee, (1, 2, 3)),
                   _certifier(PORT, committee, device=True, torch_device="cpu")).catch_up(1, 3)
    assert PORT.metrics.get_counter(key) == before + 1
    theirs = _client(JAX, committee, _cert_blocks(JAX, committee, (1, 2, 3)),
                     _certifier(JAX, committee)).catch_up(1, 3)
    assert [(b.height, b.cert.encode()) for b in ours] == [(b.height, b.cert.encode()) for b in theirs]
    assert PORT.metrics.get_counter(PORT.sync.SYNC_CERT_HEIGHTS_KEY) >= 3

    for m in (PORT, JAX):
        good = _cert_blocks(m, committee, (1,))[0]
        forged = m.chain.FinalizedBlock(1, m.wire.Proposal(raw_proposal=b"evil", round=0), [], cert=good.cert)
        smuggled = m.chain.FinalizedBlock(1, good.proposal, [m.helpers.CommittedSeal(b"\x66" * 20, b"\x00" * 65)],
                                          cert=good.cert)
        for blocks, verifier in (([forged], _certifier(m, committee)), ([smuggled], _certifier(m, committee)),
                                 ([good], None)):
            with pytest.raises(m.chain.SyncError):
                _client(m, committee, blocks, verifier).catch_up(1, 1)


def test_sync_refuses_a_range_whose_certificate_fails(committee):
    """A certificate whose aggregate seal was swapped for another height's:
    the one batched verify rejects the range in both packages."""
    for m, kw in ((PORT, {"device": True, "torch_device": "cpu"}), (JAX, {})):
        blocks = _cert_blocks(m, committee, (1, 2))
        cert = m.qc.AggregateQuorumCertificate.decode(blocks[1].cert.encode())
        cert.agg_seal = blocks[0].cert.agg_seal
        blocks[1] = m.chain.FinalizedBlock(2, blocks[1].proposal, [], cert=cert)
        with pytest.raises(m.chain.SyncError, match="height 2"):
            _client(m, committee, blocks, _certifier(m, committee, **kw)).catch_up(1, 2)
