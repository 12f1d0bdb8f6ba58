"""The port's proof serving (``serve/``) against the JAX package's, on the CPU.

The cases of ``tests/test_serve.py`` run on both packages over the same
finalized blocks (real secp256k1 seals, made from the same seeds in each
package; a chain with one rotation, one with two, and a 4-validator BLS
committee whose height 2 carries an aggregate quorum certificate):

* ``FinalityProof`` wire records are identical, byte for byte after JSON
  encoding, and each package decodes the other's;
* every verification outcome is identical: the accepted report, or the
  error class and its text, for honest proofs, tampered seals, quorum-short
  heights, stale-set splices, truncated diff chains, relabeled and
  power-short certificates and smuggled seal lists;
* the fresh drains' signature masks are identical lane for lane and equal
  the sequential ``HostBatchVerifier``; a tampered proof is rejected by
  both;
* the cache, the stampede coalescing, the scheduler read tier and the QoS
  bound behave as in the JAX package; certificate entries also go through
  the port's ``BLSCertifier.verify_many`` on its device route
  (``torch_device="cpu"``: the pairing kernels' plain versions).
"""

import asyncio
import importlib
import json
import threading
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from harness import NullLogger

torch.set_num_threads(1)

PORT, JAX = "go_ibft_tpu_torch", "go_ibft_tpu"
PACKAGES = (PORT, JAX)


def P(pkg: str) -> SimpleNamespace:
    """The modules of one package these tests use."""
    mod = lambda name: importlib.import_module(f"{pkg}.{name}")  # noqa: E731
    return SimpleNamespace(
        name=pkg, crypto=mod("crypto"), ec=mod("crypto.ecdsa"), backend=mod("crypto.backend"),
        bls=mod("crypto.bls"), qc=mod("crypto.quorum_cert"), vbls=mod("verify.bls"),
        helpers=mod("messages.helpers"), wire=mod("messages.wire"), wal=mod("chain.wal"),
        chain=mod("chain"), core=mod("core"), serve=mod("serve"), sched=mod("sched"),
        sched_mod=mod("sched.scheduler"), verify=mod("verify"),
    )


ROT_H, SECOND_ROT = 5, 7


class Chains:
    """One package's fixtures: keys, chains and the BLS committee."""

    def __init__(self, pkg: str):
        p = self.p = P(pkg)
        # The port's read plane runs on the card unless asked for its host
        # route, which is the JAX package's.
        self.host = {"device": False} if pkg == PORT else {}
        self.keys = [p.crypto.PrivateKey.from_seed(b"serve-%d" % i) for i in range(4)]
        self.rot = [p.crypto.PrivateKey.from_seed(b"serve-rot-%d" % i) for i in range(4)]
        # A backend registers the package's native signing and recovery
        # (bit-identical to the Python ints; only the time changes).
        p.backend.ECDSABackend(self.keys[0], self.static_validators)
        self.static = self.make_chain(8, lambda _h: self.keys)
        self.rotating = self.make_chain(8, self.rotating_keys)
        self.two_rotation = self.make_chain(8, self.two_rotation_keys)
        blk = [p.bls.BLSPrivateKey.from_seed(b"serve-bls-%d" % i) for i in range(4)]
        powers = {k.address: 1 for k in self.keys}
        bls_keys = {e.address: b.pubkey for e, b in zip(self.keys, blk)}
        blocks = self.make_chain(2, lambda _h: self.keys)
        certifier = p.qc.BLSCertifier(lambda _h: powers, lambda _h: bls_keys)
        phash = p.backend.proposal_hash_of(blocks[1].proposal)
        seals = [p.helpers.CommittedSeal(e.address, p.vbls.encode_seal(b.sign(phash)))
                 for e, b in zip(self.keys[:3], blk[:3])]
        self.cert = certifier.build(2, 0, phash, seals)
        assert self.cert is not None
        blocks[1] = p.wal.FinalizedBlock(2, blocks[1].proposal, [], cert=self.cert)
        self.bls_blocks = blocks
        self.bls_keys = lambda _h: bls_keys

    def static_validators(self, _h):
        return {k.address: 1 for k in self.keys}

    def rotating_keys(self, h):
        return self.keys if h < ROT_H else [self.keys[0], self.keys[1], self.rot[0], self.rot[1]]

    def rotating_validators(self, h):
        return {k.address: 1 for k in self.rotating_keys(h)}

    def two_rotation_keys(self, h):
        return list(self.rot) if h >= SECOND_ROT else self.rotating_keys(h)

    def two_rotation_validators(self, h):
        return {k.address: 1 for k in self.two_rotation_keys(h)}

    def make_chain(self, heights, keys_for_height):
        p, blocks = self.p, []
        for h in range(1, heights + 1):
            proposal = p.wire.Proposal(raw_proposal=b"serve block %d" % h, round=0)
            phash = p.backend.proposal_hash_of(proposal)
            seals = [p.helpers.CommittedSeal(signer=k.address, signature=p.backend.encode_signature(*p.ec.sign(k, phash)))
                     for k in keys_for_height(h)]
            blocks.append(p.wal.FinalizedBlock(h, proposal, seals))
        return blocks

    def tampered(self, blocks, corrupt):
        """Copies of honest blocks with a flipped byte in the seals at the
        given (height, signer index) sites."""
        p, out = self.p, []
        for block in blocks:
            seals = []
            for i, seal in enumerate(block.seals):
                sig = seal.signature
                if (block.height, i) in corrupt:
                    sig = sig[:5] + bytes([sig[5] ^ 0xFF]) + sig[6:]
                seals.append(p.helpers.CommittedSeal(signer=seal.signer, signature=sig))
            out.append(p.wal.FinalizedBlock(block.height, block.proposal, seals, cert=block.cert))
        return out

    def builder(self, blocks, validators):
        return self.p.serve.ProofBuilder(ListSource(blocks), validators)


class ListSource:
    """Static SyncSource over a prebuilt chain, counting range fetches."""

    def __init__(self, blocks):
        self.blocks = blocks
        self.calls = 0

    def latest_height(self):
        return self.blocks[-1].height if self.blocks else 0

    def get_blocks(self, start, end):
        self.calls += 1
        return [b for b in self.blocks if start <= b.height <= end]


class CountingLanes:
    """A package's HostBatchVerifier over the any-signer source, recording
    every fresh drain's lanes and masks."""

    def __init__(self, p):
        self._inner = p.verify.HostBatchVerifier(p.serve.any_signer_source)
        self.drains = []

    def verify_seal_lanes(self, lanes, height):
        mask = self._inner.verify_seal_lanes(lanes, height)
        self.drains.append((list(lanes), np.asarray(mask, dtype=bool)))
        return mask


@pytest.fixture(scope="module")
def chains():
    return {pkg: Chains(pkg) for pkg in PACKAGES}


def outcome(fn):
    """A call's result, or its error's class name and text."""
    try:
        return ("ok", fn())
    except Exception as err:  # noqa: BLE001 - compared across packages
        return ("err", type(err).__name__, str(err))


def both(chains, scenario):
    """Run ``scenario(c)`` for each package; their outcomes must agree."""
    got = {pkg: outcome(lambda c=c: scenario(c)) for pkg, c in chains.items()}
    assert got[PORT] == got[JAX], got
    return got[PORT]


def wire_json(proof) -> str:
    return json.dumps(proof.to_wire(), sort_keys=True)


# -- wire bytes -------------------------------------------------------------------

WIRE_CASES = {
    "static_2_7": lambda c: c.builder(c.static, c.static_validators).build(2, 7),
    "static_0_8": lambda c: c.builder(c.static, c.static_validators).build(0, 8),
    "rotation_0_8": lambda c: c.builder(c.rotating, c.rotating_validators).build(0, 8),
    "two_rotations_0_8": lambda c: c.builder(c.two_rotation, c.two_rotation_validators).build(0, 8),
    "inside_rotated_5_8": lambda c: c.builder(c.rotating, c.rotating_validators).build(ROT_H, 8),
    "cert_0_2": lambda c: c.builder(c.bls_blocks, c.static_validators).build(0, 2),
}


@pytest.mark.parametrize("case", sorted(WIRE_CASES))
def test_proof_wire_bytes_identical(chains, case):
    """Both packages build the same proof, and each decodes the other's."""
    wires = {pkg: wire_json(WIRE_CASES[case](c)) for pkg, c in chains.items()}
    assert wires[PORT] == wires[JAX]
    for reader in PACKAGES:
        proof = P(reader).serve.FinalityProof.from_wire(json.loads(wires[JAX]))
        assert wire_json(proof) == wires[JAX]


def test_build_shape(chains):
    def scenario(c):
        proof = c.builder(c.static, c.static_validators).build(2, 7)
        restored = c.p.serve.FinalityProof.from_wire(proof.to_wire())
        assert restored.entries[0].seals == proof.entries[0].seals
        return ([e.height for e in proof.entries], proof.diffs, proof.checkpoint_height, proof.target,
                restored.entries[0].proposal.raw_proposal)

    assert both(chains, scenario) == ("ok", ([3, 4, 5, 6, 7], [], 2, 7, b"serve block 3"))


MALFORMED = {
    "no_version": lambda w: {},
    "not_a_record": lambda w: "not a record",
    "no_checkpoint": lambda w: {k: v for k, v in w.items() if k != "checkpoint"},
    "bad_hex": lambda w: dict(w, entries=[dict(w["entries"][0], proposal="zz-not-hex")]),
    "bad_height": lambda w: dict(w, diffs=[{"height": "NaNity", "added": {}, "removed": []}]),
}


@pytest.mark.parametrize("case", sorted(MALFORMED))
def test_malformed_wire_records_raise_proof_error(chains, case):
    def scenario(c):
        wire = c.builder(c.static, c.static_validators).build(0, 4).to_wire()
        c.p.serve.FinalityProof.from_wire(MALFORMED[case](wire))

    result = both(chains, scenario)
    assert result[:2] == ("err", "ProofError")


# -- verification outcomes ----------------------------------------------------------


def _verify(c, blocks, validators, start, end, trusted_at, **kw):
    proof = c.builder(blocks, validators).build(start, end)
    return c.p.serve.ProofVerifier(**c.host, **kw).verify(proof, validators(trusted_at))


def _forged_sealless(c):
    proof = c.builder(c.static, c.static_validators).build(0, 4)
    poison = c.p.serve.SetDiff(height=2, added={c.keys[0].address: -100})
    forged = c.p.serve.FinalityProof(0, [proof.entries[0]] + [
        c.p.serve.ProofEntry(e.height, c.p.wire.Proposal(b"forged %d" % e.height, 0), []) for e in proof.entries[1:]
    ], [poison])
    return c.p.serve.ProofVerifier(**c.host).verify(forged, c.static_validators(1))


def _walk(c, mutate):
    proof = c.builder(c.static, c.static_validators).build(0, 4)
    s = c.p.serve
    return s.walk_sets(c.static_validators(1), mutate(c, s, proof))


def _short_bitmap(c):
    cert = c.cert
    short = c.p.qc.AggregateQuorumCertificate(
        height=cert.height, round=cert.round, proposal_hash=cert.proposal_hash, agg_seal=cert.agg_seal,
        bitmap=c.p.qc.AggregateQuorumCertificate.bitmap_of(cert.signer_indices()[:1], 4),
    )
    blocks = [c.bls_blocks[0], c.p.wal.FinalizedBlock(2, c.bls_blocks[1].proposal, [], cert=short)]
    verifier = c.p.serve.ProofVerifier(**c.host, bls_keys_for_height=c.bls_keys)
    return outcome(lambda: verifier.verify(c.builder(blocks, c.static_validators).build(0, 2), c.static_validators(1))), verifier.pairings


def _relabeled(c):
    other = c.p.wire.Proposal(raw_proposal=b"forged block 2", round=0)
    blocks = [c.bls_blocks[0], c.p.wal.FinalizedBlock(2, other, [], cert=c.cert)]
    verifier = c.p.serve.ProofVerifier(**c.host, bls_keys_for_height=c.bls_keys)
    return outcome(lambda: verifier.verify(c.builder(blocks, c.static_validators).build(0, 2), c.static_validators(1))), verifier.pairings


def _smuggled(c):
    blocks = [c.bls_blocks[0], c.p.wal.FinalizedBlock(2, c.bls_blocks[1].proposal, list(c.bls_blocks[0].seals), cert=c.cert)]
    verifier = c.p.serve.ProofVerifier(**c.host, bls_keys_for_height=c.bls_keys)
    result = outcome(lambda: verifier.verify(c.builder(blocks, c.static_validators).build(0, 2), c.static_validators(1)))
    return result, verifier.pairings, verifier.lanes_verified


def _duplicates(c):
    blocks = c.tampered(c.static[:2], {(2, 2), (2, 3)})
    blocks[1].seals.extend([blocks[1].seals[0]] * 4)
    return _verify(c, blocks, c.static_validators, 0, 2, 1)


def _truncated(c):
    proof = c.builder(c.two_rotation, c.two_rotation_validators).build(0, 8)
    verifier = c.p.serve.ProofVerifier(**c.host)
    trusted = c.static_validators(1)
    verifier.verify(proof, trusted)
    return verifier.verify(c.p.serve.FinalityProof(0, list(proof.entries), [proof.diffs[0]]), trusted)


OUTCOMES = {
    "honest_static": lambda c: _verify(c, c.static, c.static_validators, 0, 8, 1),
    "one_bad_seal_a_height": lambda c: _verify(c, c.tampered(c.static[:4], {(h, 3) for h in range(1, 5)}), c.static_validators, 0, 4, 1),
    "quorum_short": lambda c: _verify(c, c.tampered(c.static[:3], {(2, 2), (2, 3)}), c.static_validators, 0, 3, 1),
    "duplicate_seal": _duplicates,
    "rotation": lambda c: _verify(c, c.rotating, c.rotating_validators, 0, 8, 1),
    "stale_set_splice": lambda c: c.p.serve.ProofVerifier(**c.host).verify(
        c.p.serve.FinalityProof(0, list(c.builder(c.rotating, c.rotating_validators).build(0, 8).entries), diffs=[]),
        c.rotating_validators(1)),
    "truncated_diffs": _truncated,
    "inside_rotated": lambda c: _verify(c, c.rotating, c.rotating_validators, ROT_H, 8, ROT_H + 1),
    "non_positive_diff": lambda c: _walk(c, lambda c, s, p: s.FinalityProof(0, list(p.entries), [s.SetDiff(height=2, added={c.keys[0].address: -100})])),
    "zero_power_diff": lambda c: _walk(c, lambda c, s, p: s.FinalityProof(0, list(p.entries), [s.SetDiff(height=2, added={b"z" * 20: 0})])),
    "holed_entries": lambda c: _walk(c, lambda c, s, p: s.FinalityProof(0, [p.entries[0], p.entries[2]], [])),
    "anchor_gap": lambda c: _walk(c, lambda c, s, p: s.FinalityProof(1, list(p.entries), [])),
    "diff_on_anchor": lambda c: _walk(c, lambda c, s, p: s.FinalityProof(0, list(p.entries), [s.SetDiff(height=1, added={b"x" * 20: 1})])),
    "duplicate_diffs": lambda c: _walk(c, lambda c, s, p: s.FinalityProof(0, list(p.entries), [s.SetDiff(height=3, added={b"x" * 20: 1})] * 2)),
    "wiping_diff": lambda c: _walk(c, lambda c, s, p: s.FinalityProof(0, list(p.entries), [s.SetDiff(height=3, removed=tuple(c.static_validators(1)))])),
    "forged_sealless": _forged_sealless,
    "past_head": lambda c: c.builder(c.static, c.static_validators).build(7, 12),
    "zero_height_range": lambda c: c.builder(c.static, c.static_validators).build_range(0, 3),
    "cert_one_pairing": lambda c: _verify(c, c.bls_blocks, c.static_validators, 0, 2, 1, bls_keys_for_height=c.bls_keys),
    "cert_without_keys": lambda c: _verify(c, c.bls_blocks, c.static_validators, 0, 2, 1),
    "cert_relabeled": _relabeled,
    "cert_short_bitmap": _short_bitmap,
    "cert_beside_seals": _smuggled,
}


@pytest.mark.parametrize("case", sorted(OUTCOMES))
def test_verification_outcome_identical(chains, case):
    """The report of an accepted proof, or the error class and text of a
    rejected one, is the JAX package's."""
    both(chains, OUTCOMES[case])


def test_outcomes_are_the_documented_ones(chains):
    """Spot checks of the shared outcomes against tests/test_serve.py."""
    c = chains[PORT]
    assert OUTCOMES["cert_one_pairing"](c)["pairings"] == 1
    assert outcome(lambda: OUTCOMES["quorum_short"](c))[1:2] == ("ProofError",)
    assert "height 2" in outcome(lambda: OUTCOMES["duplicate_seal"](c))[2]
    assert f"height {ROT_H}" in outcome(lambda: OUTCOMES["stale_set_splice"](c))[2]
    assert f"height {SECOND_ROT}" in outcome(lambda: _truncated(c))[2]
    assert "does not bind" in _relabeled(c)[0][2] and _relabeled(c)[1] == 0
    assert "failed verification" in _short_bitmap(c)[0][2] and _short_bitmap(c)[1] == 0
    assert "evidence mix" in _smuggled(c)[0][2] and _smuggled(c)[1:] == (0, 0)
    assert "non-positive" in outcome(lambda: OUTCOMES["non_positive_diff"](c))[2]
    assert "no BLS key source" in outcome(lambda: OUTCOMES["cert_without_keys"](c))[2]


def test_masks_identical_lane_for_lane_and_equal_the_oracle(chains):
    """One corrupted seal a height: every fresh drain's mask is the same in
    both packages and equals the sequential HostBatchVerifier over the
    real validator set; a proof with every quorum seal flipped is rejected
    by both planes and by the oracle."""
    drains = {}
    for pkg, c in chains.items():
        counting = CountingLanes(c.p)
        blocks = c.tampered(c.static[:4], {(h, 3) for h in range(1, 5)})
        report = c.p.serve.ProofVerifier(**c.host, lane_verifier=counting).verify(
            c.builder(blocks, c.static_validators).build(0, 4), c.static_validators(1))
        assert report["heights"] == 4 and report["lanes"] == 16
        oracle = c.p.verify.HostBatchVerifier(c.static_validators)
        for lanes, mask in counting.drains:
            np.testing.assert_array_equal(mask, np.asarray(oracle.verify_seal_lanes(lanes, 1), dtype=bool))
        drains[pkg] = [mask.tolist() for _lanes, mask in counting.drains]
        assert not counting.drains[0][1].all()
        bad = c.tampered(c.static[:4], {(1, i) for i in range(4)})
        with pytest.raises(c.p.serve.ProofError, match="height 1"):
            c.p.serve.ProofVerifier(**c.host).verify(c.builder(bad, c.static_validators).build(0, 4), c.static_validators(1))
        phash = c.p.backend.proposal_hash_of(bad[0].proposal)
        assert not oracle.verify_seal_lanes([(phash, s) for s in bad[0].seals], 1).any()
    assert drains[PORT] == drains[JAX]


@pytest.mark.parametrize("case", ["cert_one_pairing", "cert_short_bitmap_forged_seal"])
def test_cert_entries_through_the_ports_device_route(chains, case):
    """Certificate entries through ``BLSCertifier.verify_many`` on the
    port's device route (the pairing kernels' plain versions on the CPU):
    the host route's outcome, the JAX package's."""
    c = chains[PORT]
    blocks = c.bls_blocks
    if case != "cert_one_pairing":  # a certificate whose aggregate seal is another height's
        cert = c.cert
        forged = c.p.qc.AggregateQuorumCertificate(
            height=cert.height, round=cert.round, proposal_hash=cert.proposal_hash,
            agg_seal=c.p.vbls.encode_seal(c.p.bls.BLSPrivateKey.from_seed(b"serve-bls-0").sign(b"\x01" * 32)),
            bitmap=cert.bitmap,
        )
        blocks = [blocks[0], c.p.wal.FinalizedBlock(2, blocks[1].proposal, [], cert=forged)]

    def run(**kw):
        verifier = c.p.serve.ProofVerifier(bls_keys_for_height=c.bls_keys, **kw)
        return outcome(lambda: verifier.verify(c.builder(blocks, c.static_validators).build(0, 2), c.static_validators(1)))

    device = run(device=True, torch_device="cpu")
    assert device == run(device=False)
    if case == "cert_one_pairing":
        assert device[0] == "ok" and device[1]["pairings"] == 1
    else:
        assert device[:2] == ("err", "ProofError") and "failed verification" in device[2]


def test_device_route_drains_through_the_dispatcher(chains):
    """With no scheduler and no lane verifier, the port's device route
    drains a proof's fresh seal lanes through a ``DispatcherLanes`` (the
    digest and recovery kernels' plain versions on the CPU): the host
    route's verdicts, a tampered proof rejected at the same height."""
    c = chains[PORT]
    blocks = c.tampered(c.static[:3], {(h, 3) for h in range(1, 4)})
    bad = c.tampered(c.static[:3], {(2, i) for i in range(4)})
    device = c.p.serve.ProofVerifier(device=True, torch_device="cpu")
    assert isinstance(device._verifier, c.p.serve.DispatcherLanes)
    assert device._verifier.device == torch.device("cpu")
    results = {}
    for label, verifier in (("device", device), ("host", c.p.serve.ProofVerifier(device=False))):
        results[label] = (
            outcome(lambda v=verifier: v.verify(c.builder(blocks, c.static_validators).build(0, 3), c.static_validators(1))),
            outcome(lambda v=verifier: v.verify(c.builder(bad, c.static_validators).build(0, 3), c.static_validators(1))),
        )
    assert results["device"] == results["host"]
    assert results["device"][0][0] == "ok" and results["device"][1][:2] == ("err", "ProofError")
    assert "height 2" in results["device"][1][2]
    assert device._verifier.dispatcher.routes == {"host": 0, "device": 2}


# -- cache and server ----------------------------------------------------------------


def _server(c, blocks=None, validators=None, **kw):
    source = ListSource(blocks or c.static)
    return c.p.serve.ProofServer(c.p.serve.ProofBuilder(source, validators or c.static_validators), **c.host, **kw), source


SERVER_CASES = {}


def _server_case(fn):
    SERVER_CASES[fn.__name__] = fn
    return fn


@_server_case
def overlapping_chunks(c):
    server, source = _server(c, cache=c.p.serve.ProofCache(chunk_heights=4))
    p1 = server.get_proof(0, 4)
    calls = source.calls
    p2 = server.get_proof(1, 4)
    assert source.calls == calls and p2.entries[0] is p1.entries[1]
    c.p.serve.ProofVerifier(**c.host).verify(p2, c.static_validators(2))
    return wire_json(p2), server.cache.stats()["hits"]


@_server_case
def tail_never_cached(c):
    server, _ = _server(c, cache=c.p.serve.ProofCache(chunk_heights=16))
    server.get_proof(0)
    server.get_proof(0)
    return len(server.cache), server.chunks_built


@_server_case
def lru_bounded(c):
    server, _ = _server(c, cache=c.p.serve.ProofCache(chunk_heights=2, max_chunks=2))
    server.get_proof(0, 8)
    stats = server.cache.stats()
    return stats["chunks"], stats["evictions"]


@_server_case
def clamps_and_empty_ranges(c):
    server, _ = _server(c)
    return server.get_proof(6, 99).target, outcome(lambda: server.get_proof(8)), outcome(lambda: server.get_proof(-1))


@_server_case
def self_check_refuses_corrupt_chain(c):
    server, _ = _server(c, blocks=c.tampered(c.static[:4], {(2, 2), (2, 3)}), cache=c.p.serve.ProofCache(chunk_heights=4))
    return outcome(lambda: server.get_proof(0, 4)), len(server.cache)


@_server_case
def sig_cache_dedupes_across_clients(c):
    counting = CountingLanes(c.p)
    shared = c.p.serve.SigVerdictCache()
    proof = c.builder(c.static, c.static_validators).build(0, 4)
    for _ in range(2):
        c.p.serve.ProofVerifier(**c.host, lane_verifier=counting, sig_cache=shared).verify(proof, c.static_validators(1))
    return sum(len(lanes) for lanes, _ in counting.drains), shared.stats()["hits"]


@_server_case
def sig_cache_bounded(c):
    cache = c.p.serve.SigVerdictCache(cap=8)
    keys = [(b"h%031d" % i, b"s" * 20, b"g" * 65) for i in range(32)]
    cache.store_batch(keys, [True] * len(keys))
    return cache.stats()


@_server_case
def cold_stampede_builds_each_chunk_once(c):
    server, source = _server(c, cache=c.p.serve.ProofCache(chunk_heights=4))
    results, errors = [], []

    def client():
        try:
            results.append(server.verify_proof(server.get_proof(0, 8), c.static_validators(1)))
        except BaseException as err:  # noqa: BLE001 - surfaced below
            errors.append(err)

    threads = [threading.Thread(target=client) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60.0)
    assert not errors, errors
    return len(results), server.chunks_built, source.calls


@pytest.mark.parametrize("case", sorted(SERVER_CASES))
def test_server_and_cache_behave_as_jax(chains, case):
    result = both(chains, SERVER_CASES[case])
    assert result[0] == "ok"


# -- scheduler coalescing and read-tier QoS --------------------------------------------


def _coalesce(c, route):
    kw = {"torch_device": "cpu"} if c.p.name == PORT else {}
    sched = c.p.sched.TenantScheduler(window_s=0.002, route=route, **kw)
    with sched:
        server, _ = _server(c, cache=c.p.serve.ProofCache(chunk_heights=4), scheduler=sched, tenant_id="serve-server")
        results, errors = [], []

        def client():
            try:
                results.append(server.verify_proof(server.get_proof(0, 8), c.static_validators(1)))
            except BaseException as err:  # noqa: BLE001 - surfaced below
                errors.append(err)

        threads = [threading.Thread(target=client) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120.0)
        assert not errors, errors
        stats = sched.stats()
        server.close()
    row = stats["tenants"]["serve-server"]
    return len(results), row["priority"], row["lanes"], stats["flush_faults"], stats["dispatches"] >= 1, results[0]


@pytest.mark.parametrize("route", ["host", "device"])
def test_concurrent_verifies_coalesce_through_scheduler(chains, route):
    """Eight clients over two chunks: the self-check's 32 fresh lanes go
    through the read-tier tenant (the port on ``route``), every client is
    then served from the shared verdict cache, as in the JAX package."""
    ours = _coalesce(chains[PORT], route)
    assert ours == _coalesce(chains[JAX], "host")
    assert ours[:5] == (8, "read", 32, 0, True)


@pytest.mark.parametrize("pkg", PACKAGES)
def test_read_priority_never_selected_ahead_of_consensus(chains, pkg):
    c = chains[pkg]
    sched = c.p.sched.TenantScheduler(window_s=0.001, route="host")
    sched.register("chain", c.static_validators, priority="consensus")
    sched.register("serve", c.p.serve.any_signer_source, priority="read")

    def enqueue(tenant, lanes, age):
        req = c.p.sched_mod._Request(tenant, "seals", [(b"h" * 32, None)] * lanes, 1,
                                     np.zeros(lanes, dtype=bool), list(range(lanes)))
        req.submitted_at = age
        tenant.queue.append(req)
        tenant.queued_lanes += req.lanes
        sched._pending_reqs += 1
        sched._pending_lanes += req.lanes
        return req

    old_read = enqueue(sched._tenants["serve"], 64, age=1.0)
    young_consensus = enqueue(sched._tenants["chain"], 8, age=2.0)
    batch = sched._select_locked()
    assert batch[0] is young_consensus and old_read in batch


@pytest.mark.parametrize("pkg", PACKAGES)
def test_register_rejects_unknown_priority(chains, pkg):
    c = chains[pkg]
    with pytest.raises(ValueError, match="priority"):
        c.p.sched.TenantScheduler(route="host").register("x", c.static_validators, priority="bulk")


@pytest.mark.parametrize("pkg", PACKAGES)
def test_proof_flood_cannot_starve_live_chain(chains, pkg):
    """A proof-verify flood on the read tier beside a live 4-validator
    chain on the consensus tier of the same scheduler: the chain finalizes
    every height and the flood makes progress."""
    c, heights = chains[pkg], 2
    p = c.p
    sched = p.sched.TenantScheduler(window_s=0.001, route="host")
    stop, proofs, errors = threading.Event(), [], []

    def flood():
        server, _ = _server(c, blocks=c.static[:6], cache=p.serve.ProofCache(chunk_heights=2), scheduler=sched)
        try:
            while not stop.is_set():
                server.verifier.sig_cache.clear()
                proofs.append(server.verify_proof(server.get_proof(0, 6), c.static_validators(1)))
        except BaseException as err:  # noqa: BLE001 - surfaced below
            errors.append(err)
        finally:
            server.close()

    async def drive_chain():
        keys = [p.crypto.PrivateKey.from_seed(b"qos-%d" % i) for i in range(4)]
        src = p.backend.ECDSABackend.static_validators({k.address: 1 for k in keys})
        nodes, runners = [], []

        class _T:
            def multicast(self, message):
                for ingress in nodes:
                    ingress.submit(message)

        for i, key in enumerate(keys):
            handle = sched.register(f"qos-chain/n{i}", src, chain_id="qos-chain")
            engine = p.core.IBFT(NullLogger(), p.backend.ECDSABackend(key, src), _T(), batch_verifier=handle)
            engine.set_base_round_timeout(30.0)
            nodes.append(p.core.BatchingIngress(engine.add_messages))
            runners.append(p.chain.ChainRunner(engine, overlap=False))
        try:
            await asyncio.wait_for(asyncio.gather(*(r.run(until_height=heights) for r in runners)), 120.0)
        finally:
            for runner, ingress in zip(runners, nodes):
                ingress.close()
                runner.engine.messages.close()
        return [r.latest_height() for r in runners]

    with sched:
        thread = threading.Thread(target=flood, daemon=True)
        thread.start()
        try:
            finalized = asyncio.run(drive_chain())
        finally:
            stop.set()
            thread.join(60.0)
    assert not thread.is_alive() and not errors, errors
    assert finalized == [heights] * 4 and proofs
    rows = sched.stats()["tenants"]
    assert all(rows[f"qos-chain/n{i}"]["priority"] == "consensus" for i in range(4))
