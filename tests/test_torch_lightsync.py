"""The port's light-client plane (``lightsync/``, the checkpoint WAL records,
``node/proof_api.py`` and ``commit_next_set``) against the JAX package's, on
the CPU.

Both packages build the same chains from the same seeds (a 5-key pool,
set A = keys 0..3, set B = keys 1..4 from height 10, proposals carrying
next-set commitments, a checkpoint every 4 heights with BLS quorum seals;
a static 4-epoch chain at spacing 2), and:

* ``set_root``, the commitment frames and ``CheckpointRecord`` bytes are
  identical, and each package decodes the other's records;
* ``verify_chain`` gives equal anchors, and for each rejection case of
  ``tests/test_lightsync.py`` the same failing epoch, error class, text and
  pairing-dispatch count; ``CheckpointVerifier(device=True)`` on the port's
  device route (``torch_device="cpu"``) agrees with ``device=False``;
* WAL checkpoint records are byte-identical and replay across packages, a
  torn checkpoint tail recovers, and ``recover()`` restores the runner's
  checkpointer;
* an HTTP cold sync through the port's ``ProofApiServer`` anchors across
  the rotation, for the port's ``CheckpointClient`` and the JAX package's
  alike, and the spliced-diff attack dies at the commitment check;
* ``ECDSABackend(commit_next_set=True)`` builds and accepts what the JAX
  backend does.
"""

import importlib
import json
from dataclasses import replace
from types import SimpleNamespace

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

PORT, JAX = "go_ibft_tpu_torch", "go_ibft_tpu"
PACKAGES = (PORT, JAX)
ROTATE_AT, HEIGHTS, SPACING = 10, 16, 4


def P(pkg: str) -> SimpleNamespace:
    mod = lambda name: importlib.import_module(f"{pkg}.{name}")  # noqa: E731
    return SimpleNamespace(
        name=pkg, crypto=mod("crypto"), ec=mod("crypto.ecdsa"), backend=mod("crypto.backend"),
        bls=mod("crypto.bls"), keccak=mod("crypto.keccak"), helpers=mod("messages.helpers"),
        wire=mod("messages.wire"), wal=mod("chain.wal"), chain=mod("chain"), core=mod("core"),
        ls=mod("lightsync"), serve=mod("serve"), api=mod("node.proof_api"), metrics=mod("utils.metrics"),
        agg=mod("verify.aggregate"), vbls=mod("verify.bls"),
    )


class World:
    """One package's keys, chains and checkpointers."""

    def __init__(self, pkg: str):
        p = self.p = P(pkg)
        # The port's ProofVerifier runs on the card unless asked for its
        # host route, the JAX package's (whose ProofVerifier has no switch).
        self.host = {"device": False} if pkg == PORT else {}
        self.keys = [p.crypto.PrivateKey.from_seed(b"lightsync-%d" % i) for i in range(5)]
        self.by_addr = {k.address: k for k in self.keys}
        self.bls = {k.address: p.bls.BLSPrivateKey.from_seed(b"lightsync-bls-%d" % i) for i, k in enumerate(self.keys)}
        self.set_a, self.set_b = self.powers(self.keys[:4]), self.powers(self.keys[1:5])
        p.backend.ECDSABackend(self.keys[0], self.validators)  # the native fast paths
        self.rot_chain = [self.committed_block(h) for h in range(1, HEIGHTS + 1)]
        self.rot_ckpt = p.ls.Checkpointer(SPACING, self.validators, signers=self.bls)
        for block in self.rot_chain:
            self.rot_ckpt.on_finalize(block.height, p.backend.proposal_hash_of(block.proposal))
        self.static_ckpt = p.ls.Checkpointer(2, lambda _h: self.set_a, signers=self.bls)
        for h in range(1, 9):
            self.static_ckpt.on_finalize(h, p.keccak.keccak256(b"ls static blk %d" % h))

    @staticmethod
    def powers(keys):
        return {k.address: 1 for k in keys}

    def validators(self, height):
        return dict(self.set_b if height >= ROTATE_AT else self.set_a)

    def pubkeys(self, _height):
        return {addr: key.pubkey for addr, key in self.bls.items()}

    def committed_block(self, height):
        p = self.p
        raw = p.ls.embed_next_set(b"ls block %d" % height, p.ls.set_root(self.validators(height + 1)))
        proposal = p.wire.Proposal(raw_proposal=raw, round=0)
        phash = p.backend.proposal_hash_of(proposal)
        seals = [p.helpers.CommittedSeal(signer=a, signature=p.backend.encode_signature(*p.ec.sign(self.by_addr[a], phash)))
                 for a in sorted(self.validators(height))[:3]]
        return p.wal.FinalizedBlock(height, proposal, seals)

    def dispatches(self):
        return self.p.metrics.get_counter(self.p.agg.MULTIPAIR_DISPATCHES_KEY)

    def decoded(self, payload):
        return [self.p.ls.CheckpointRecord.decode(bytes.fromhex(r)) for r in payload["checkpoints"]]


@pytest.fixture(scope="module")
def worlds():
    return {pkg: World(pkg) for pkg in PACKAGES}


def outcome(fn):
    try:
        return ("ok", fn())
    except Exception as err:  # noqa: BLE001 - compared across packages
        return ("err", type(err).__name__, str(err))


def both(worlds, scenario):
    got = {pkg: outcome(lambda w=w: scenario(w)) for pkg, w in worlds.items()}
    assert got[PORT] == got[JAX], got
    return got[PORT]


# -- commitments and records ------------------------------------------------------

POWER_MAPS = [{b"x": 1, b"y": 2}, {b"y": 2, b"x": 1}, {b"x": 1, b"y": 3}, {b"x": 1}, {bytes([i]) * 20: i + 1 for i in range(7)}]


@pytest.mark.parametrize("i", range(len(POWER_MAPS)))
def test_set_root_identical(i):
    roots = [P(pkg).ls.set_root(POWER_MAPS[i]) for pkg in PACKAGES]
    assert roots[0] == roots[1] and len(roots[0]) == 32


def test_set_root_canonical_and_rejects_non_positive():
    ls = P(PORT).ls
    assert ls.set_root(POWER_MAPS[0]) == ls.set_root(POWER_MAPS[1]) != ls.set_root(POWER_MAPS[2])
    for pkg in PACKAGES:
        with pytest.raises(ValueError, match="non-positive"):
            P(pkg).ls.set_root({b"x": 0})


@pytest.mark.parametrize("payload", [b"", b"payload", b"\x00" * 40, bytes(range(256))])
def test_commitment_frames_identical(payload):
    frames = {}
    for pkg in PACKAGES:
        ls = P(pkg).ls
        root = ls.set_root(POWER_MAPS[4])
        raw = ls.embed_next_set(payload, root)
        assert len(raw) == len(payload) + ls.COMMIT_SUFFIX_BYTES
        assert ls.extract_next_set(raw) == root and ls.strip_next_set(raw) == payload
        assert ls.extract_next_set(payload) is None and ls.strip_next_set(payload) == payload
        with pytest.raises(ValueError, match="already carries"):
            ls.embed_next_set(raw, root)
        with pytest.raises(ValueError, match="32 bytes"):
            ls.embed_next_set(payload, b"short")
        frames[pkg] = raw
    assert frames[PORT] == frames[JAX]


@pytest.mark.parametrize("epoch", [1, 2, 3, 7, 13, 64, 1000, 1 << 20])
def test_skip_structure_identical(epoch):
    ours, ref = P(PORT).ls, P(JAX).ls
    assert ours.skip_path(epoch) == ref.skip_path(epoch)
    assert ours.skip_epochs(epoch) == ref.skip_epochs(epoch)


@pytest.mark.parametrize("which", ["static", "rotation"])
def test_checkpoint_record_bytes_identical(worlds, which):
    """Every record (signed, with its skip links and set root) encodes to
    the same bytes, and each package decodes the other's."""
    blobs = {}
    for pkg, w in worlds.items():
        ck = w.static_ckpt if which == "static" else w.rot_ckpt
        blobs[pkg] = [ck.record(e).encode() for e in range(1, ck.latest_epoch + 1)]
        assert all(ck.record(e).signed for e in range(1, ck.latest_epoch + 1))
    assert blobs[PORT] == blobs[JAX] and len(blobs[PORT]) == 4
    for pkg in PACKAGES:
        for blob in blobs[JAX]:
            rec = P(pkg).ls.CheckpointRecord.decode(blob)
            assert rec.encode() == blob
            unsigned = replace(rec, agg_seal=b"", bitmap=b"")
            assert P(pkg).ls.CheckpointRecord.decode(unsigned.encode()) == unsigned and unsigned.digest() == rec.digest()


MALFORMED_RECORDS = {
    "version": lambda b: bytes([b[0] ^ 1]) + b[1:],
    "too_short": lambda b: b[:10],
    "length": lambda b: b + b"\x00",
    "seal_length": lambda b: b[:20] + (191).to_bytes(2, "big") + b[22:],
}


@pytest.mark.parametrize("case", sorted(MALFORMED_RECORDS))
def test_checkpoint_record_decode_rejections_identical(worlds, case):
    result = both(worlds, lambda w: w.p.ls.CheckpointRecord.decode(MALFORMED_RECORDS[case](w.static_ckpt.record(1).encode())))
    assert result[:2] == ("err", "ValueError")


def test_checkpointer_boundaries_and_lazy_signing(worlds):
    def scenario(w):
        ls, keccak = w.p.ls, w.p.keccak.keccak256
        ck = ls.Checkpointer(4, lambda _h: w.set_a)
        first = [ck.on_finalize(3, b"\x11" * 32), ck.on_finalize(4, b"\x11" * 32), ck.on_finalize(4, b"\x22" * 32)]
        rec2 = ck.on_finalize(8, b"\x33" * 32)
        gap = outcome(lambda: ls.Checkpointer(4, lambda _h: w.set_a).on_finalize(8, b"\x33" * 32))
        lazy = ls.Checkpointer(1, lambda _h: w.set_a, signers=w.bls, lazy_sign=True)
        for e in range(1, 33):
            lazy.on_finalize(e, keccak(b"lazy %d" % e))
        served = [r.encode().hex() for r in w.decoded(lazy.wire_payload())]
        signed = [e for e in range(1, 33) if lazy.record(e).signed]
        return ([r and r.encode().hex() for r in first], rec2.encode().hex(), gap, served, signed,
                lazy.wire_payload(target_epoch=5), outcome(lambda: lazy.wire_payload(target_epoch=33)),
                ls.Checkpointer(4, lambda _h: w.set_a).wire_payload())

    result = both(worlds, scenario)
    assert result[0] == "ok"
    assert result[1][2][:2] == ("err", "CheckpointError") and result[1][4] == P(PORT).ls.skip_path(32)


# -- verify_chain: anchors and rejections ---------------------------------------------


def _doctor_head(w, payload, **changes):
    records = w.decoded(payload)
    head = replace(records[-1], **changes)
    return dict(payload, checkpoints=payload["checkpoints"][:-1] + [head.encode().hex()])


def _lying_bridge(w):
    return w.p.ls.CheckpointVerifier(w.pubkeys, device=False).verify_chain(
        w.rot_ckpt.wire_payload(), w.set_a, bridge=lambda *_a: {b"evil-validator-addr": 4})


def _honest_bridge(w):
    calls = []

    def bridge(from_h, to_h, _powers):
        calls.append((from_h, to_h))
        return w.set_b

    anchor = w.p.ls.CheckpointVerifier(w.pubkeys, device=False).verify_chain(w.rot_ckpt.wire_payload(), w.set_a, bridge=bridge)
    return anchor, calls


def _multipair_parity(w):
    lanes, _records, _anchor = w.p.ls.CheckpointVerifier(w.pubkeys, device=False).build_lanes(
        w.static_ckpt.wire_payload(include_all=True), w.set_a)
    msg, points, pubkeys = lanes[2]
    lanes = lanes[:2] + [(w.p.keccak.keccak256(b"not the digest"), points, pubkeys)] + lanes[3:]
    batched = np.asarray(w.p.agg.multi_aggregate_check(lanes, route="host"), dtype=bool).tolist()
    if w.p.name == PORT:  # the sequential oracle, once
        assert batched == [bool(w.p.vbls.aggregate_check(m, pts, pks)) for m, pts, pks in lanes]
    return batched


def _structural(w, epochs=1000):
    ck = w.p.ls.Checkpointer(1000, lambda _h: w.set_a, signers=w.bls, lazy_sign=True)
    for e in range(1, epochs + 1):
        ck.on_finalize(e * 1000, w.p.keccak.keccak256(b"1m blk %d" % e))
    return w.p.ls.CheckpointVerifier(w.pubkeys, device=False).verify_chain(ck.wire_payload(), w.set_a)


CHAIN_CASES = {
    "static_skip_path": lambda w: w.p.ls.CheckpointVerifier(w.pubkeys, device=False).verify_chain(w.static_ckpt.wire_payload(), w.set_a),
    "static_linear": lambda w: w.p.ls.CheckpointVerifier(w.pubkeys, device=False).verify_chain(w.static_ckpt.wire_payload(include_all=True), w.set_a),
    "structural_million": _structural,
    "multipair_oracle_parity": _multipair_parity,
    "short_power_bitmap": lambda w: w.p.ls.CheckpointVerifier(w.pubkeys, device=False).verify_chain(
        _doctor_head(w, w.static_ckpt.wire_payload(), bitmap=bytes([0b0011])), w.set_a),
    "bitmap_bit_outside_set": lambda w: w.p.ls.CheckpointVerifier(w.pubkeys, device=False).verify_chain(
        _doctor_head(w, w.static_ckpt.wire_payload(), bitmap=bytes([0b10111])), w.set_a),
    "unregistered_signer": lambda w: w.p.ls.CheckpointVerifier(lambda _h: {}, device=False).verify_chain(w.static_ckpt.wire_payload(), w.set_a),
    "replayed_record": lambda w: w.p.ls.CheckpointVerifier(w.pubkeys, device=False).verify_chain(
        dict(w.static_ckpt.wire_payload(), checkpoints=w.static_ckpt.wire_payload()["checkpoints"][:-1]
             + [w.static_ckpt.wire_payload()["checkpoints"][1]]), w.set_a),
    "mislabeled_height": lambda w: w.p.ls.CheckpointVerifier(w.pubkeys, device=False).verify_chain(
        _doctor_head(w, w.static_ckpt.wire_payload(), height=6), w.set_a),
    "forged_head": lambda w: w.p.ls.CheckpointVerifier(w.pubkeys, device=False).verify_chain(
        _doctor_head(w, w.static_ckpt.wire_payload(), chain_commitment=w.p.keccak.keccak256(b"forked chain")), w.set_a),
    "rotation_without_bridge": lambda w: w.p.ls.CheckpointVerifier(w.pubkeys, device=False).verify_chain(w.rot_ckpt.wire_payload(), w.set_a),
    "honest_bridge": _honest_bridge,
    "lying_bridge": _lying_bridge,
    "bad_version": lambda w: w.p.ls.CheckpointVerifier(w.pubkeys, device=False).verify_chain(dict(w.static_ckpt.wire_payload(), version=99), w.set_a),
    "bad_spacing": lambda w: w.p.ls.CheckpointVerifier(w.pubkeys, device=False).verify_chain(dict(w.static_ckpt.wire_payload(), spacing=0), w.set_a),
    "no_records": lambda w: w.p.ls.CheckpointVerifier(w.pubkeys, device=False).verify_chain(dict(w.static_ckpt.wire_payload(), checkpoints=[]), w.set_a),
    "not_genesis_first": lambda w: w.p.ls.CheckpointVerifier(w.pubkeys, device=False).verify_chain(
        dict(w.static_ckpt.wire_payload(), checkpoints=w.static_ckpt.wire_payload()["checkpoints"][1:]), w.set_a),
    "empty_trust": lambda w: w.p.ls.CheckpointVerifier(w.pubkeys, device=False).verify_chain(w.static_ckpt.wire_payload(), {}),
}


def _anchor_view(result):
    """An anchor's fields (its class differs by package)."""
    if hasattr(result, "powers"):
        return (result.height, result.epoch, result.powers, result.spacing, result.lanes)
    if isinstance(result, tuple):
        return tuple(_anchor_view(r) for r in result)
    return result


def _rejected(text, pairings):
    def check(result, w):
        (kind, cls, msg), spent = result
        assert (kind, cls, spent) == ("err", "CheckpointError", pairings) and text in msg
    return check


def _bridged(result, w):
    (kind, (anchor, calls)), spent = result
    assert kind == "ok" and calls == [(8, 16)] and anchor[0] == 16 and anchor[2] == w.set_b and spent == 1


# What tests/test_lightsync.py documents for each case (beside the parity).
CHAIN_EXPECTED = {
    "static_skip_path": lambda r, w: r == (("ok", (8, 4, w.set_a, 2, 3)), 1),
    "static_linear": lambda r, w: r[0][1][1] == 4 and r[0][1][4] == 4,
    "structural_million": lambda r, w: r[0][1][:2] == (1_000_000, 1000) and r[1] == 1,
    "multipair_oracle_parity": lambda r, w: r[0] == ("ok", [True, True, False, True]),
    "short_power_bitmap": _rejected("below quorum", 0),
    "bitmap_bit_outside_set": _rejected("outside", 0),
    "unregistered_signer": _rejected("no registered BLS key", 0),
    "replayed_record": _rejected("power-of-2", 0),
    "mislabeled_height": _rejected("height", 0),
    "forged_head": _rejected("pairing", 1),
    "rotation_without_bridge": _rejected("no bridge", 0),
    "lying_bridge": _rejected("committed set root", 0),
    "honest_bridge": _bridged,
}


@pytest.mark.parametrize("case", sorted(CHAIN_CASES))
def test_verify_chain_outcome_identical(worlds, case):
    """The same anchor, or the same failing epoch, error class and text,
    and the same number of batched pairing dispatches; and the outcome
    ``tests/test_lightsync.py`` documents."""
    def scenario(w):
        before = w.dispatches()
        result = outcome(lambda: _anchor_view(CHAIN_CASES[case](w)))
        return result, w.dispatches() - before

    result = both(worlds, scenario)
    assert result[0] == "ok"
    expected = CHAIN_EXPECTED.get(case)
    if expected is not None:
        assert expected(result[1], worlds[PORT]) is not False, result


def test_verify_chain_rejects_before_any_pairing(worlds):
    """Every structural rejection costs zero pairing dispatches."""
    for case in ("bad_version", "bad_spacing", "no_records", "not_genesis_first", "empty_trust"):
        w = worlds[PORT]
        before = w.dispatches()
        assert outcome(lambda: CHAIN_CASES[case](w))[:2] == ("err", "CheckpointError"), case
        assert w.dispatches() == before


@pytest.mark.parametrize("case", ["forged_head"])
def test_checkpoint_verifier_device_route_agrees(worlds, case):
    """``CheckpointVerifier(device=True)`` runs the batched check through
    the port's multi-pairing kernels (their plain versions on the CPU): the
    same anchor or rejection as ``device=False``."""
    w = worlds[PORT]
    payload = w.static_ckpt.wire_payload()
    if case == "forged_head":
        payload = _doctor_head(w, payload, chain_commitment=w.p.keccak.keccak256(b"forked chain"))
    results = {}
    for device in (False, True):
        kw = {"torch_device": "cpu"} if device else {}
        verifier = w.p.ls.CheckpointVerifier(w.pubkeys, device=device, **kw)
        results[device] = outcome(lambda v=verifier: _anchor_view(v.verify_chain(payload, w.set_a)))
    assert results[True] == results[False]
    assert (results[True][0] == "ok") == (case == "static_skip_path")


# -- durability -----------------------------------------------------------------------


def test_wal_checkpoint_records_identical_and_replay_across_packages(worlds, tmp_path):
    files = {}
    for pkg, w in worlds.items():
        wal = w.p.wal.WriteAheadLog(str(tmp_path / f"{pkg}.jsonl"))
        for e in range(1, 5):
            wal.append_checkpoint(w.static_ckpt.record(e))
            wal.append_checkpoint(w.static_ckpt.record(e))  # first write wins
        wal.close()
        files[pkg] = (tmp_path / f"{pkg}.jsonl").read_bytes()
    assert files[PORT] == files[JAX]
    for reader, w in worlds.items():
        for writer in PACKAGES:
            state = w.p.wal.WriteAheadLog(str(tmp_path / f"{writer}.jsonl")).replay()
            assert [r.epoch for r in state.checkpoints] == [1, 2, 3, 4]
            assert [r.encode() for r in state.checkpoints] == [w.static_ckpt.record(e).encode() for e in range(1, 5)]
            restarted = w.p.ls.Checkpointer(2, lambda _h: w.set_a)  # no signing keys at all
            restarted.restore(state.checkpoints)
            assert restarted.latest_epoch == 4
            assert w.p.ls.CheckpointVerifier(w.pubkeys, device=False).verify_chain(restarted.wire_payload(), w.set_a).epoch == 4


def test_wal_torn_checkpoint_tail_recovers_and_rebuilds(worlds, tmp_path):
    def scenario(w):
        p, keccak = w.p, w.p.keccak.keccak256
        ck = p.ls.Checkpointer(2, lambda _h: w.set_a, signers=w.bls, lazy_sign=True)
        wal = p.wal.WriteAheadLog(str(tmp_path / f"torn-{p.name}.jsonl"))
        for h in range(1, 5):
            wal.append_finalize(h, p.wire.Proposal(raw_proposal=b"t%d" % h, round=0), [])
            rec = ck.on_finalize(h, keccak(b"t%d" % h))
            if rec is not None:
                wal.append_checkpoint(rec)
        wal.close()
        with open(wal.path, "ab") as fh:  # crash mid-append at the next boundary
            fh.write(b'{"kind":"checkpoint","epoch":3,"rec":"01')
        state = p.wal.WriteAheadLog(wal.path).replay()
        restarted = p.ls.Checkpointer(2, lambda _h: w.set_a, signers=w.bls, lazy_sign=True)
        restarted.restore(state.checkpoints)
        rebuilt = restarted.on_finalize(6, keccak(b"t6"))
        assert rebuilt.skip_digests == (state.checkpoints[1].digest(), state.checkpoints[0].digest())
        with open(wal.path, "rb") as fh:
            tail = fh.read()
        return (state.dropped_tail, [b.height for b in state.blocks], [r.epoch for r in state.checkpoints],
                rebuilt.encode().hex(), tail)

    result = both(worlds, scenario)
    assert result[0] == "ok" and result[1][:3] == (True, [1, 2, 3, 4], [1, 2])


class _NullTransport:
    def multicast(self, message):
        pass


def test_runner_recover_restores_checkpointer(worlds, tmp_path):
    """``recover()`` on a WAL the JAX package wrote restores the port
    runner's checkpointer, which serves the records without re-signing."""
    jw, w = worlds[JAX], worlds[PORT]
    jwal = jw.p.wal.WriteAheadLog(str(tmp_path / "jax.jsonl"))
    for h in range(1, 5):
        jwal.append_finalize(h, jw.p.wire.Proposal(raw_proposal=b"r%d" % h, round=0), [])
    for e in (1, 2):
        jwal.append_checkpoint(jw.static_ckpt.record(e))
    jwal.close()
    p = w.p
    engine = p.core.IBFT(None, p.backend.ECDSABackend(w.keys[0], lambda _h: w.set_a), _NullTransport())
    ck = p.ls.Checkpointer(2, lambda _h: w.set_a)
    runner = p.chain.ChainRunner(engine, p.wal.WriteAheadLog(jwal.path), checkpointer=ck)
    try:
        assert runner.checkpointer is ck
        assert runner.recover() == 5
        assert ck.latest_epoch == 2
        assert [ck.record(e).encode() for e in (1, 2)] == [jw.static_ckpt.record(e).encode() for e in (1, 2)]
        assert [r.epoch for r in w.decoded(ck.wire_payload())] == [1, 2]
    finally:
        engine.messages.close()
        runner.wal.close()


def test_runner_writes_checkpoints_at_epoch_boundaries(worlds, tmp_path):
    """``_on_finalize`` appends a checkpoint record after the finalize
    record at each boundary, as the JAX runner does (the same WAL bytes)."""
    files = {}
    for pkg, w in worlds.items():
        p = w.p
        engine = p.core.IBFT(None, p.backend.ECDSABackend(w.keys[0], w.validators), _NullTransport())
        ck = p.ls.Checkpointer(SPACING, w.validators)
        runner = p.chain.ChainRunner(engine, p.wal.WriteAheadLog(str(tmp_path / f"{pkg}.jsonl")), checkpointer=ck)
        for block in w.rot_chain[:8]:
            runner._on_finalize(block.height, block.proposal, block.seals)
        runner.wal.close()
        engine.messages.close()
        files[pkg] = (tmp_path / f"{pkg}.jsonl").read_bytes()
        kinds = [json.loads(line)["kind"] for line in files[pkg].splitlines()]
        assert kinds.count("checkpoint") == 2 and kinds[4] == "checkpoint"
    assert files[PORT] == files[JAX]


# -- the wire path: GET /checkpoints through the port's ProofApiServer -----------------


@pytest.fixture(scope="module")
def checkpoint_api(worlds):
    w = worlds[PORT]
    p = w.p

    class _ListSource:
        def latest_height(self):
            return w.rot_chain[-1].height

        def get_blocks(self, start, end):
            return [b for b in w.rot_chain if start <= b.height <= end]

    source = _ListSource()
    proofs = p.serve.ProofServer(p.serve.ProofBuilder(source, w.validators), p.serve.ProofCache(chunk_heights=4), **w.host)
    api = p.api.ProofApiServer(proofs, source.latest_height, port=0, checkpoints_fn=w.rot_ckpt.wire_payload)
    api.start()
    yield api
    api.stop()
    proofs.close()


def _report_view(report):
    return {k: getattr(report, k) for k in (
        "head", "target", "anchor_height", "anchor_epoch", "spacing", "checkpoint_bytes", "bridge_bytes",
        "tail_bytes", "tail_heights", "checkpoint_lanes", "pairing_dispatches", "powers")}


@pytest.mark.parametrize("target", [None, 14, 3])
def test_http_cold_sync_through_the_ports_api(worlds, checkpoint_api, target):
    """Both packages' ``CheckpointClient`` cold-sync over the port's
    socket: the same report (wire bytes included), anchored across the
    rotation by a commitment-enforced bridge proof."""
    reports = {}
    for pkg, w in worlds.items():
        client = w.p.ls.CheckpointClient(checkpoint_api.url, w.pubkeys, device=False)
        reports[pkg] = _report_view(client.cold_sync(w.set_a, target=target))
    assert reports[PORT] == reports[JAX]
    r = reports[PORT]
    if target is None:
        assert (r["anchor_height"], r["anchor_epoch"], r["tail_bytes"], r["checkpoint_lanes"]) == (16, 4, 0, 3)
        assert r["bridge_bytes"] > 0 and r["pairing_dispatches"] == 1 and r["powers"] == worlds[PORT].set_b
    elif target == 14:
        assert (r["anchor_height"], r["anchor_epoch"], r["tail_heights"]) == (12, 3, 2) and r["tail_bytes"] > 0
    else:
        assert (r["anchor_height"], r["pairing_dispatches"], r["powers"]) == (0, 0, worlds[PORT].set_a)


def test_http_cold_sync_device_route(worlds, checkpoint_api, monkeypatch):
    """The cold sync with ``device=True`` on the port's device route
    (``torch_device="cpu"``) gives the host route's report, and its bridge
    and tail proofs' seal lanes go through the dispatcher's device route
    (the digest and recovery kernels' plain versions here)."""
    w = worlds[PORT]
    dispatch = importlib.import_module(f"{PORT}.sched.dispatch")
    seal_lanes = []
    real = dispatch.CoalescedDispatcher._device

    def counting(self, msgs, lanes, owners):
        seal_lanes.append(len(lanes))
        return real(self, msgs, lanes, owners)

    monkeypatch.setattr(dispatch.CoalescedDispatcher, "_device", counting)
    device = w.p.ls.CheckpointClient(checkpoint_api.url, w.pubkeys, device=True, torch_device="cpu")
    host = w.p.ls.CheckpointClient(checkpoint_api.url, w.pubkeys, device=False)
    got = _report_view(device.cold_sync(w.set_a, target=14))
    on_device = sum(seal_lanes)
    assert got == _report_view(host.cold_sync(w.set_a, target=14))
    assert sum(seal_lanes) == on_device > 0  # the host route dispatched nothing


def test_read_plane_entry_points_default_to_the_card(worlds):
    """``CheckpointClient``, ``CheckpointVerifier``, ``ProofVerifier`` and
    ``ProofServer`` run on the card unless asked for the host: without one
    they raise, and nothing drops quietly to the CPU."""
    w = worlds[PORT]
    for make in (
        lambda: w.p.ls.CheckpointClient("http://127.0.0.1:1", w.pubkeys),
        lambda: w.p.ls.CheckpointVerifier(w.pubkeys),
        lambda: w.p.serve.ProofVerifier(),
        lambda: w.p.serve.ProofServer(None),
    ):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()


def test_wire_splice_attack_dies_at_commitment_check(worlds, checkpoint_api):
    for pkg, w in worlds.items():
        client = w.p.ls.CheckpointClient(checkpoint_api.url, w.pubkeys, device=False)
        payload, _n = client.fetch_proof(8, 16)
        spliced = json.loads(json.dumps(payload["proof"]))
        spliced["diffs"].append({"height": 15, "added": {"ab" * 20: 1000}, "removed": []})
        verifier = w.p.serve.ProofVerifier(require_commitments=True, **w.host)
        with pytest.raises(w.p.serve.ProofError, match="next-set root"):
            verifier.verify(w.p.serve.FinalityProof.from_wire(spliced), w.set_a)
        verifier.verify(w.p.serve.FinalityProof.from_wire(payload["proof"]), w.set_a)


def test_checkpoints_endpoint_wire_behaviors(worlds, checkpoint_api):
    w = worlds[PORT]
    client = w.p.ls.CheckpointClient(checkpoint_api.url, w.pubkeys, device=False)
    payload, _n = client.fetch_checkpoints(target_epoch=2)
    assert [r.epoch for r in w.decoded(payload)] == [1, 2]
    assert payload["latest_epoch"] == 4 and payload["head"] == 16
    assert payload["checkpoints"] == worlds[JAX].rot_ckpt.wire_payload(target_epoch=2)["checkpoints"]
    full, _n = client.fetch_checkpoints(include_all=True)
    assert len(full["checkpoints"]) == 4
    with pytest.raises(w.p.ls.CheckpointError, match="416"):
        client.fetch_checkpoints(target_epoch=99)
    with pytest.raises(w.p.ls.CheckpointError, match="400"):
        w.p.ls.http_fetcher(checkpoint_api.url)("/checkpoints?epoch=nope")
    head, _n = client.head()
    assert head == 16


def test_checkpoints_endpoint_404_when_not_wired(worlds):
    w = worlds[PORT]

    class _NoProofs:
        def get_proof(self, checkpoint, target=None):
            raise AssertionError("never called")

    api = w.p.api.ProofApiServer(_NoProofs(), lambda: 5, port=0)
    api.start()
    try:
        with pytest.raises(w.p.ls.CheckpointError, match="404"):
            w.p.ls.http_fetcher(api.url)("/checkpoints")
    finally:
        api.stop()


# -- commit_next_set ---------------------------------------------------------------------


@pytest.mark.parametrize("height", [1, 8, 9, 15])
def test_commit_next_set_encodes_what_jax_encodes(worlds, height):
    built = {}
    for pkg, w in worlds.items():
        p = w.p
        b = p.backend.ECDSABackend(w.keys[0], w.validators, commit_next_set=True)
        raw = b.build_proposal(p.wire.View(height=height, round=0))
        assert p.ls.extract_next_set(raw) == p.ls.set_root(w.validators(height + 1))
        assert b.is_valid_proposal(raw) and not b.is_valid_proposal(b"no frame") and not b.is_valid_proposal(b"")
        plain = p.backend.ECDSABackend(w.keys[0], w.validators)
        assert plain.is_valid_proposal(b"no frame") and p.ls.extract_next_set(plain.build_proposal(p.wire.View(height, 0))) is None
        built[pkg] = raw
    assert built[PORT] == built[JAX]
