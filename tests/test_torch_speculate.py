"""The port's speculative verifier against the JAX package's, on the CPU.

Each case of ``tests/test_speculate.py`` runs in both packages on the same
seeded keys: the ``SpeculationCache`` binding, scoping and eviction, and an
engine with a ``SpeculativeVerifier`` (ingress speculation, a drain of pure
cache hits, the early-exit remainder resolved off the critical path, the
Byzantine hash binding) must give identical verdicts, counters and seal
sets.  The fault rule differs on purpose: off the card a worker fault is
counted and the batch dropped, as in the JAX package; with the verifier's
device on the card, ``drain()`` and ``stop()`` raise the first fault.
"""

import threading

import numpy as np
import pytest
import torch
from test_torch_chain import PACKAGES, pkg

torch.set_num_threads(1)

SEAL = ("g" * 65).encode()
SENDER = ("s" * 20).encode()


def _both(fn):
    return [fn(pkg(name)) for name in PACKAGES]


def _phase(m):
    return __import__(f"{m.name}.verify.speculate", fromlist=["PHASE_COMMIT_SEAL"]).PHASE_COMMIT_SEAL


# -- the cache ---------------------------------------------------------------


def _binding(m):
    cache = m.verify.SpeculationCache()
    args = (1, 0, b"\xaa" * 32, _phase(m), SENDER, SEAL)
    cache.store(*args, True)
    out = [cache.lookup(*args)]
    for i, other in enumerate((2, 1, b"\xbb" * 32, "envelope", b"t" * 20, b"h" * 65)):
        key = list(args)
        key[i] = other  # every field of the binding perturbed in turn
        out.append(cache.lookup(*key))
    out.append(cache.lookup(*args, owner="tenant-b"))
    return out, cache.hits, cache.misses


def _owner_scoping(m):
    cache = m.verify.SpeculationCache()
    args = (5, 0, b"\xcc" * 32, _phase(m), SENDER, SEAL)
    cache.store(*args, True, owner="a")
    cache.store(*args, False, owner="b")
    out = [cache.lookup(*args, owner="a"), cache.lookup(*args, owner="b")]
    cache.clear(owner="a")
    return out + [cache.lookup(*args, owner="a"), cache.lookup(*args, owner="b"), len(cache)]


def _stale_heights(m):
    cache = m.verify.SpeculationCache()
    for h in (1, 2, 3):
        cache.store(h, 0, b"\xdd" * 32, _phase(m), SENDER, SEAL, True)
    cache.note_view(2, 0)
    return [cache.lookup(h, 0, b"\xdd" * 32, _phase(m), SENDER, SEAL) for h in (1, 2, 3)]


def _cap_eviction(m):
    cache = m.verify.SpeculationCache(cap=4)
    cache.note_view(9, 3)
    for i in range(3):
        cache.store(9, 3, b"%02d" % i * 16, _phase(m), SENDER, SEAL, True)
    for i in range(4):
        cache.store(9, 1, b"%02d" % i * 16, _phase(m), SENDER, SEAL, True)
    return len(cache), [cache.lookup(9, r, b"%02d" % i * 16, _phase(m), SENDER, SEAL)
                        for r in (3, 1) for i in range(4)]


def _random_churn(m):
    """A seeded sequence of stores, views, lookups and evictions."""
    rng = np.random.default_rng(7)
    cache = m.verify.SpeculationCache(cap=24)
    out = []
    for _ in range(400):
        op = int(rng.integers(0, 4))
        h, r, owner = int(rng.integers(1, 6)), int(rng.integers(0, 3)), "ab"[int(rng.integers(0, 2))]
        phash, sender = bytes([int(rng.integers(0, 4))]) * 32, bytes([int(rng.integers(0, 6))]) * 20
        if op == 0:
            cache.store(h, r, phash, _phase(m), sender, SEAL, bool(rng.integers(0, 2)), owner=owner)
        elif op == 1:
            cache.note_view(h, r, owner=owner)
        elif op == 2:
            out.append(cache.lookup(h, r, phash, _phase(m), sender, SEAL, owner=owner))
        else:
            cache.evict_seal(h, r, phash, sender, SEAL, owner=owner)
        out.append(len(cache))
    return out, cache.hits, cache.misses


@pytest.mark.parametrize("case", [_binding, _owner_scoping, _stale_heights, _cap_eviction, _random_churn],
                         ids=lambda f: f.__name__.strip("_"))
def test_cache_matches_jax(case):
    ours, ref = _both(case)
    assert ours == ref


def test_cache_binding_has_no_partial_match():
    out, hits, misses = _binding(pkg(PACKAGES[0]))
    assert out[0] is True and all(x is None for x in out[1:]) and (hits, misses) == (1, 7)


# -- an engine with a speculator --------------------------------------------------


def _engine(m, speculate=True):
    keys = [m.crypto.PrivateKey.from_seed(b"spec-%d" % i) for i in range(4)]
    src = m.cb.ECDSABackend.static_validators({k.address: 1 for k in keys})
    backends = [m.cb.ECDSABackend(k, src) for k in keys]

    class Counting(m.verify.HostBatchVerifier):
        seal_lanes = 0

        def verify_committed_seals(self, proposal_hash, seals, height):
            self.seal_lanes += len(seals)
            return super().verify_committed_seals(proposal_hash, seals, height)

        def verify_seals_early_exit(self, proposal_hash, seals, height, threshold=None):
            report = super().verify_seals_early_exit(proposal_hash, seals, height, threshold=threshold)
            self.seal_lanes += int(report.verified.sum())
            return report

    class Silent:
        def multicast(self, message):
            pass

    verifier = Counting(src)
    engine = m.core.IBFT(_Null(), backends[1], Silent(), batch_verifier=verifier,
                         speculator=m.verify.SpeculativeVerifier(verifier) if speculate else None)
    engine.state.reset(1)
    engine.validator_manager.init(1)
    return engine, verifier, backends


class _Null:
    def info(self, *args):
        pass

    debug = error = info


def _accept(m, engine, backends, block=b"block 1"):
    view = m.wire.View(height=1, round=0)
    proposer = next(b for b in backends if b.is_proposer(b.address, 1, 0))
    pmsg = proposer.build_preprepare_message(block, None, view)
    engine._accept_proposal(pmsg)
    return view, proposer, pmsg.preprepare_data.proposal_hash


def _seals(engine):
    return sorted((s.signer, s.signature) for s in engine.state.committed_seals)


def _ingress_drain(m):
    engine, verifier, backends = _engine(m)
    view, proposer, phash = _accept(m, engine, backends)
    others = [b for b in backends if b is not proposer]
    engine.add_messages([b.build_commit_message(phash, view) for b in others])
    assert engine.speculator.drain(10.0)
    speculated = verifier.seal_lanes
    finalized = engine._handle_commit(view)
    out = (speculated, verifier.seal_lanes, finalized, _seals(engine), engine.speculator.stats())
    engine.speculator.stop()
    return out


def _byzantine_hash(m):
    """COMMITs speculated for proposal H never certify H' (same height and
    round); accepting H afterwards finalizes from the cached verdicts."""
    engine, verifier, backends = _engine(m)
    view = m.wire.View(height=1, round=0)
    proposer = next(b for b in backends if b.is_proposer(b.address, 1, 0))
    others = [b for b in backends if b is not proposer]
    pmsg_h = proposer.build_preprepare_message(b"block H", None, view)
    phash_h = pmsg_h.preprepare_data.proposal_hash
    engine.add_messages([b.build_commit_message(phash_h, view) for b in others])
    assert engine.speculator.drain(10.0)
    pmsg_hp = proposer.build_preprepare_message(b"block H'", None, view)
    engine._accept_proposal(pmsg_hp)
    out = [engine._handle_commit(view), _seals(engine)]
    seal = m.helpers.extract_committed_seal(others[0].build_commit_message(phash_h, view))
    out.append(engine.speculator.lookup_seal(1, 0, pmsg_hp.preprepare_data.proposal_hash,
                                             others[0].address, seal.signature))
    engine._accept_proposal(pmsg_h)
    engine.add_messages([b.build_commit_message(phash_h, view) for b in others])
    assert engine.speculator.drain(10.0)
    before = verifier.seal_lanes
    out += [engine._handle_commit(view), verifier.seal_lanes - before, _seals(engine)]
    engine.speculator.stop()
    return out


def _early_exit_remainder(m):
    engine, verifier, backends = _engine(m)
    speculator, engine.speculator = engine.speculator, None
    view, _, phash = _accept(m, engine, backends)
    engine.add_messages([b.build_commit_message(phash, view) for b in backends])
    engine.speculator = speculator
    out = [engine._handle_commit(view), len(engine.state.committed_seals)]
    assert speculator.drain(10.0)
    out += [speculator.speculated_lanes, verifier.seal_lanes,
            sorted(x.encode() for x in engine._drain_valid_commits(view)), verifier.seal_lanes]
    speculator.stop()
    return out


def _quarantine_and_dedup(m):
    engine, _, backends = _engine(m)
    view, proposer, phash = _accept(m, engine, backends)
    other = next(b for b in backends if b is not proposer)
    commit = other.build_commit_message(phash, view)
    seal = m.helpers.extract_committed_seal(commit)
    spec = engine.speculator
    out = [spec.submit_commit_messages([commit])]
    assert spec.drain(10.0)
    out += [spec.submit_commit_messages([commit]), spec.lookup_seal(1, 0, phash, other.address, seal.signature)]
    spec.quarantine_seals(1, 0, phash, [(other.address, seal)])
    out.append(spec.lookup_seal(1, 0, phash, other.address, seal.signature))
    spec.cache.store(7, 0, b"\xee" * 32, _phase(m), SENDER, SEAL, True)
    spec.note_view(5, 0)
    out += [spec.lookup_seal(1, 0, phash, other.address, seal.signature),
            spec.lookup_seal(7, 0, b"\xee" * 32, SENDER, SEAL)]
    spec.stop()
    return out


@pytest.mark.parametrize("case", [_ingress_drain, _byzantine_hash, _early_exit_remainder, _quarantine_and_dedup],
                         ids=lambda f: f.__name__.strip("_"))
def test_engine_with_speculator_matches_jax(case):
    ours, ref = _both(case)
    assert ours == ref


def test_speculated_drain_is_pure_cache_hits():
    speculated, after, finalized, seals, stats = _ingress_drain(pkg(PACKAGES[0]))
    assert speculated == 3 and after == 3 and finalized and len(seals) == 3
    assert stats["speculated_lanes"] == 3 and stats["faults"] == 0


def test_engines_insert_the_same_seal_sets_with_and_without_speculation():
    """One height of a committee, fed PREPREPARE, PREPAREs and COMMITs, with
    a speculator and without, in both packages: the same inserted proposal
    and seal set."""
    import asyncio

    def run(m, speculate):
        engine, _, backends = _engine(m, speculate)
        view = m.wire.View(height=1, round=0)
        proposer = next(b for b in backends if b.is_proposer(b.address, 1, 0))
        pmsg = proposer.build_preprepare_message(b"block 1", None, view)
        phash = pmsg.preprepare_data.proposal_hash
        others = [b for b in backends if b is not proposer]

        async def body():
            seq = asyncio.create_task(engine.run_sequence(1))
            await asyncio.sleep(0)
            engine.add_messages([b.build_commit_message(phash, view) for b in others])
            if engine.speculator is not None:
                await asyncio.get_running_loop().run_in_executor(None, engine.speculator.drain, 10.0)
            engine.add_message(pmsg)
            engine.add_messages([b.build_prepare_message(phash, view) for b in others])
            await asyncio.wait_for(seq, 30)

        asyncio.run(body())
        if engine.speculator is not None:
            engine.speculator.stop()
        engine.messages.close()
        return [(p.encode(), sorted((s.signer, s.signature) for s in seals))
                for p, seals in engine.backend.inserted]

    results = [run(pkg(name), speculate) for name in PACKAGES for speculate in (True, False)]
    assert all(r == results[0] for r in results) and len(results[0]) == 1


# -- worker faults ------------------------------------------------------------------


class _Faulting:
    def __init__(self, device=None):
        if device is not None:
            self.device = torch.device(device)
        self.calls = 0

    def verify_committed_seals(self, proposal_hash, seals, height):
        self.calls += 1
        raise RuntimeError("kernel fault")


def _one_commit(m):
    keys = [m.crypto.PrivateKey.from_seed(b"f-%d" % i) for i in range(2)]
    src = m.cb.ECDSABackend.static_validators({k.address: 1 for k in keys})
    return m.cb.ECDSABackend(keys[0], src).build_commit_message(b"\xab" * 32, m.wire.View(height=1, round=0))


def test_worker_fault_off_the_card_is_counted_like_jax():
    def run(m):
        spec = m.verify.SpeculativeVerifier(_Faulting())
        queued = spec.submit_commit_messages([_one_commit(m)])
        drained = spec.drain(10.0)
        spec.stop()
        return queued, drained, spec.faults, len(spec.cache)

    ours, ref = _both(run)
    assert ours == ref == (1, True, 1, 0)


@pytest.mark.parametrize("device", ["cpu", "cuda"])
def test_worker_fault_on_the_card_raises_from_drain_and_stop(device):
    """A device rung on the card (a stub: its ``device`` says cuda) whose
    seal drain faults: ``drain()`` and ``stop()`` raise the fault.  The same
    stub on the CPU keeps the JAX behaviour."""
    from go_ibft_tpu_torch.verify import ResilientBatchVerifier, SpeculativeVerifier

    m = pkg(PACKAGES[0])
    rung = _Faulting(device)
    ladder = ResilientBatchVerifier(rung, validators_for_height=lambda h: {})
    for verifier in (rung, ladder):
        spec = SpeculativeVerifier(verifier)
        assert spec.on_card == (device == "cuda")
        spec.submit_commit_messages([_one_commit(m)])
        if device == "cuda":
            with pytest.raises(RuntimeError, match="kernel fault"):
                spec.drain(10.0)
            with pytest.raises(RuntimeError, match="kernel fault"):
                spec.stop()
            assert spec.faults == 1 and len(spec.cache) == 0
        else:
            assert spec.drain(10.0)
            spec.stop()


def test_bounded_queue_drops_overflow_like_jax():
    def run(m):
        gate = threading.Event()

        class Blocking:
            def verify_committed_seals(self, proposal_hash, seals, height):
                gate.wait(10.0)
                return np.ones(len(seals), dtype=bool)

        spec = m.verify.SpeculativeVerifier(Blocking(), max_queue_lanes=2)
        keys = [m.crypto.PrivateKey.from_seed(b"q-%d" % i) for i in range(4)]
        src = m.cb.ECDSABackend.static_validators({k.address: 1 for k in keys})
        view = m.wire.View(height=1, round=0)
        sent = 0
        for k in keys:
            b = m.cb.ECDSABackend(k, src)
            seal = m.helpers.extract_committed_seal(b.build_commit_message(b"\xcd" * 32, view))
            sent += spec.submit_seal_lanes(1, 0, b"\xcd" * 32, [(b.address, seal)])
        dropped = spec.dropped_lanes
        gate.set()
        spec.drain(10.0)
        spec.stop()
        return sent, dropped

    ours, ref = _both(run)
    assert ours == ref == (2, 2)
