"""The port's multi-tenant scheduler (``sched/``) against the JAX package's,
on the CPU.

The cases of ``tests/test_sched.py`` and ``tests/test_sched_consensus.py``
run on both packages from the same seeds: the JAX side on its host route
(so nothing compiles the XLA ladder), the port on its host route and, for
the verdict-parity cases, on its device route with ``torch_device="cpu"``
(the kernels' plain PyTorch versions, ~2 s a flush).  Masks and verdicts
must be identical, exactly, across the packages and equal to each tenant's
sequential ``HostBatchVerifier``.

Beside them: the dispatcher's kernels are the single-tenant plane's own
functions, ``build_seal_lane_workload`` builds the JAX builder's lanes, a
dispatcher over two devices raises ``NotPortedError``, the shared
``pack_sender_digest_rows`` (the digest kernel's plain version and the host
digest of an oversize payload), and the card's rule: a dispatcher whose
launch raises while ``on_card`` is true makes the handle raise instead of
filling from the oracle, and off the card the oracle fill stays.
"""

import asyncio
import importlib
import os
import threading
import time

import numpy as np
import pytest
import torch

from harness import NullLogger

torch.set_num_threads(1)

PORT, JAX = "go_ibft_tpu_torch", "go_ibft_tpu"
PACKAGES = (PORT, JAX)


def m(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.{name}")


def _src(pkg: str, seed: int, n: int):
    """The validator source matching build_signed_round's key space."""
    crypto, backend = m(pkg, "crypto"), m(pkg, "crypto.backend")
    keys = [crypto.PrivateKey.from_seed(b"bench-%d-%d" % (seed, i)) for i in range(n)]
    return backend.ECDSABackend.static_validators({k.address: 1 for k in keys})


def _sched(pkg: str, route: str = "host", **kw):
    """A scheduler of ``pkg``; the port's device route on the CPU."""
    if pkg == PORT:
        kw.setdefault("torch_device", "cpu")
    return m(pkg, "sched").TenantScheduler(route=route, **kw)


def _round(pkg: str, n: int, seed: int, corrupt_frac: float = 0.0):
    return m(pkg, "bench.workload").build_signed_round(n, seed=seed, corrupt_frac=corrupt_frac)


def _drain_threads(fns):
    threads = [threading.Thread(target=fn) for fn in fns]
    for t in threads:
        t.start()
    for t in threads:
        t.join()


# -- verdict parity (tests/test_sched.py's two parity cases) -------------------


def _mixed_tenants(pkg: str, route: str):
    rounds = {
        "a": (_round(pkg, 4, 101), _src(pkg, 101, 4)),
        "b": (_round(pkg, 8, 202, 0.5), _src(pkg, 202, 8)),
        "c": (_round(pkg, 6, 303, 0.2), _src(pkg, 303, 6)),
    }
    sched = _sched(pkg, route, window_s=0.05)
    handles = {tid: sched.register(tid, src) for tid, (_r, src) in rounds.items()}
    results = {}

    def run(tid):
        r, h = rounds[tid][0], handles[tid]
        results[tid] = (
            h.verify_senders(r.prepares),
            h.verify_committed_seals(r.proposal_hash, r.seals, 1),
            h.verify_seal_lanes([(r.proposal_hash, s) for s in r.seals], 1),
        )

    with sched:
        _drain_threads([lambda tid=tid: run(tid) for tid in rounds])
    oracle = {}
    for tid, (r, src) in rounds.items():
        host = m(pkg, "verify").HostBatchVerifier(src)
        oracle[tid] = (
            host.verify_senders(r.prepares),
            host.verify_committed_seals(r.proposal_hash, r.seals, 1),
            r.expected_seal_mask,
        )
    return results, oracle, sched.stats()


@pytest.mark.parametrize("route", ["host", "device"])
def test_oracle_parity_mixed_tenants(route):
    """Three chains with different validator sets, one flooding corrupt
    seals, drain concurrently through one scheduler: every tenant's
    verdicts equal its own sequential oracle, and the port's (on ``route``)
    equal the JAX package's host route's, lane for lane."""
    ours, oracle, stats = _mixed_tenants(PORT, route)
    ref, _, ref_stats = _mixed_tenants(JAX, "host")
    for tid in ours:
        senders, seals, lanes = ours[tid]
        np.testing.assert_array_equal(senders, oracle[tid][0])
        np.testing.assert_array_equal(seals, oracle[tid][1])
        np.testing.assert_array_equal(seals, oracle[tid][2])
        np.testing.assert_array_equal(lanes, oracle[tid][2])
        for a, b in zip(ours[tid], ref[tid]):
            np.testing.assert_array_equal(a, b)
    assert stats["flush_faults"] == ref_stats["flush_faults"] == 0
    assert stats["dispatcher"]["route"] == route


def _shared_hash(pkg: str, route: str):
    ra, rb = _round(pkg, 4, 11), _round(pkg, 4, 22, 0.5)
    assert ra.proposal_hash == rb.proposal_hash  # same height, same block
    sched = _sched(pkg, route, window_s=0.05)
    ha, hb = sched.register("a", _src(pkg, 11, 4)), sched.register("b", _src(pkg, 22, 4))
    out = {}

    def run(tid, h, r):
        out[tid] = (h.verify_senders(r.prepares), h.verify_committed_seals(r.proposal_hash, r.seals, 1))

    with sched:
        _drain_threads([lambda: run("a", ha, ra), lambda: run("b", hb, rb)])
    return out, {"a": (ra, 11), "b": (rb, 22)}, sched


@pytest.mark.parametrize("route", ["host", "device"])
def test_device_route_parity_small(route):
    """The device route (the single-tenant plane's kernels and a
    claimed-address table) gives the host oracle's verdicts for a
    mixed-tenant flush with cross-chain lanes sharing a proposal hash, as
    the JAX package's host route does."""
    ours, rounds, sched = _shared_hash(PORT, route)
    ref, _, _ = _shared_hash(JAX, "host")
    for tid, (r, seed) in rounds.items():
        oracle = m(PORT, "verify").HostBatchVerifier(_src(PORT, seed, 4))
        np.testing.assert_array_equal(ours[tid][0], oracle.verify_senders(r.prepares))
        np.testing.assert_array_equal(ours[tid][1], r.expected_seal_mask)
        for a, b in zip(ours[tid], ref[tid]):
            np.testing.assert_array_equal(a, b)
    routes = sched._dispatcher.routes
    assert routes[route] >= 1 and routes["host" if route == "device" else "device"] == 0


# -- coalescing, caches, fairness, backpressure (per package) -------------------


@pytest.mark.parametrize("pkg", PACKAGES)
def test_coalescing_shares_dispatches(pkg):
    ra, rb = _round(pkg, 4, 11), _round(pkg, 8, 22)
    sched = _sched(pkg, window_s=0.05)
    ha, hb = sched.register("a", _src(pkg, 11, 4)), sched.register("b", _src(pkg, 22, 8))
    with sched:
        _drain_threads([lambda: ha.verify_senders(ra.prepares), lambda: hb.verify_senders(rb.prepares)])
    stats = sched.stats()
    assert stats["dispatches"] == 1, stats
    assert stats["coalesced_requests"] == 2, stats
    assert stats["coalesce_ratio"] > 1.0, stats


@pytest.mark.parametrize("pkg", PACKAGES)
def test_demand_aware_flush_single_hot_tenant(pkg):
    r = _round(pkg, 4, 11)
    sched = _sched(pkg, window_s=0.002)
    hot = sched.register("hot", _src(pkg, 11, 4))
    sched.register("idle", _src(pkg, 22, 8))  # registered, never submits
    with sched:
        t0 = time.monotonic()
        mask = hot.verify_senders(r.prepares)
        elapsed = time.monotonic() - t0
    assert mask.all()
    assert elapsed < 0.5, f"flush waited {elapsed:.3f}s for an idle tenant"


@pytest.mark.parametrize("pkg", PACKAGES)
def test_seal_verdict_cache_namespaced_by_tenant(pkg):
    ra, rb = _round(pkg, 4, 11), _round(pkg, 4, 22)
    assert ra.proposal_hash == rb.proposal_hash
    sched = _sched(pkg, window_s=0.001)
    ha, hb = sched.register("chain-a", _src(pkg, 11, 4)), sched.register("chain-b", _src(pkg, 22, 4))
    with sched:
        assert ha.verify_committed_seals(ra.proposal_hash, ra.seals, 1).all()
        mask_b = hb.verify_committed_seals(rb.proposal_hash, ra.seals, 1)
        assert not mask_b.any(), "chain B served chain A's cached verdicts"
        assert hb.verify_committed_seals(rb.proposal_hash, rb.seals, 1).all()


@pytest.mark.parametrize("pkg", PACKAGES)
def test_note_round_and_reset_are_tenant_scoped(pkg):
    sched = _sched(pkg)
    ha = sched.register("a", _src(pkg, 11, 4))
    sched.register("b", _src(pkg, 22, 4))
    ta, tb = sched._tenants["a"], sched._tenants["b"]
    ha.note_round(7)
    assert ta.pack_cache._round == 7
    assert tb.pack_cache._round == 0, "tenant A's round rotated tenant B"
    rb = _round(pkg, 4, 22)
    key_b = (b"s" * 20, b"h" * 32, b"sig", 1)
    ta.verdicts.store((b"x" * 20, b"h" * 32, b"sig", 1), True)
    tb.verdicts.store(key_b, True)
    pack = m(pkg, "verify.pipeline").SenderPack(
        payload=b"p", r_limbs=np.zeros(20, np.int32), s_limbs=np.zeros(20, np.int32),
        v=0, sender_words=np.zeros(5, np.uint32),
    )
    ta.pack_cache.store(rb.prepares[0], pack)
    tb.pack_cache.store(rb.prepares[1], pack)
    ha.reset_pack_cache()
    assert len(ta.pack_cache) == 0
    assert len(tb.pack_cache) == 1, "tenant A's reset evicted tenant B"
    assert tb.verdicts.lookup(key_b) is True


def _selection_trace(pkg: str):
    """Drive selection directly (no thread): the flushes a cold tenant's
    request waits, and every flush's (tenant, lanes) list."""
    sched = _sched(pkg, window_s=0.001, max_dispatch_lanes=1024, quantum_lanes=64)
    sched.register("hot", _src(pkg, 11, 4))
    sched.register("cold", _src(pkg, 22, 4))
    hot, cold = sched._tenants["hot"], sched._tenants["cold"]
    sched._running = True
    out = np.zeros(4096, dtype=bool)
    for _ in range(8):
        sched.submit(hot, "seals", [("h", None)] * 512, 1, out, list(range(512)))
    cold_req = sched.submit(cold, "seals", [("h", None)] * 8, 1, out, list(range(8)))
    served_in, flushes = None, []
    for flush_no in range(1, 10):
        with sched._cv:
            batch = sched._select_locked()
        assert sum(r.lanes for r in batch) <= 1024
        flushes.append([(r.tenant.tid, r.lanes) for r in batch])
        if cold_req in batch and served_in is None:
            served_in = flush_no
    return served_in, flushes


def test_starvation_bound_oldest_request_always_ships():
    """A small tenant's request queued behind a flooding tenant ships
    within two flushes, and the port selects exactly the JAX package's
    flushes (oldest first, then deficit round robin)."""
    served_in, flushes = _selection_trace(PORT)
    ref_served, ref_flushes = _selection_trace(JAX)
    assert served_in is not None and served_in <= 2, f"cold tenant served in flush {served_in}"
    assert (served_in, flushes) == (ref_served, ref_flushes)


@pytest.mark.parametrize("pkg", PACKAGES)
def test_backpressure_sheds_to_oracle_without_blocking(pkg):
    gate = threading.Event()
    inner = m(pkg, "sched").CoalescedDispatcher(route="host")

    class _GatedDispatcher:
        def dispatch(self, msgs, lanes, owners):
            gate.wait(5.0)
            return inner.dispatch(msgs, lanes, owners)

        def warmup(self, **kw):
            pass

    r = _round(pkg, 4, 11)
    sched = m(pkg, "sched").TenantScheduler(window_s=0.001, max_queue_lanes=8, dispatcher=_GatedDispatcher())
    h = sched.register("a", _src(pkg, 11, 4))
    done = []
    with sched:
        def drain():
            assert h.verify_senders(r.prepares).all()  # shed or scheduled, exact
            done.append(time.monotonic())

        threads = [threading.Thread(target=drain) for _ in range(5)]
        for t in threads:
            t.start()
            time.sleep(0.02)
        deadline = time.monotonic() + 5.0
        while sched.stats()["tenants"]["a"]["sheds"] == 0 and time.monotonic() < deadline:
            time.sleep(0.005)
        assert sched.stats()["tenants"]["a"]["sheds"] >= 1
        assert done, "no shed drain completed while the dispatcher was gated"
        gate.set()
        for t in threads:
            t.join(5.0)
            assert not t.is_alive()
    assert sched.stats()["tenants"]["a"]["shed_lanes"] >= 4


@pytest.mark.parametrize("pkg", PACKAGES)
def test_stopped_scheduler_degrades_to_oracle(pkg):
    r = _round(pkg, 4, 11, 0.25)
    sched = _sched(pkg)
    h = sched.register("a", _src(pkg, 11, 4))
    np.testing.assert_array_equal(h.verify_committed_seals(r.proposal_hash, r.seals, 1), r.expected_seal_mask)
    assert sched.stats()["tenants"]["a"]["sheds"] >= 1


@pytest.mark.parametrize("pkg", PACKAGES)
def test_large_request_chunks_to_dispatch_cap(pkg):
    w = m(pkg, "bench.workload").build_seal_lane_workload(96, n_validators=8, heights=3, corrupt_frac=0.2, seed=7)
    sched = _sched(pkg, window_s=0.001, max_dispatch_lanes=32)
    h = sched.register("a", w.validators)
    with sched:
        mask = h.verify_seal_lanes(w.lanes, w.height)
    np.testing.assert_array_equal(mask, w.expected_mask)
    assert sched.stats()["dispatches"] >= 3


@pytest.mark.parametrize("pkg", PACKAGES)
def test_malformed_lanes_masked_false_not_crashing(pkg):
    r = _round(pkg, 4, 11)
    sched = _sched(pkg, window_s=0.001)
    h = sched.register("a", _src(pkg, 11, 4))
    bad_seal = m(pkg, "messages.helpers").CommittedSeal(signer=b"\x01" * 3, signature=b"\x02" * 10)
    with sched:
        lanes = [(r.proposal_hash, r.seals[0]), (b"short", r.seals[1]), (r.proposal_hash, bad_seal)]
        mask = h.verify_seal_lanes(lanes, 1)
        short_hash = h.verify_committed_seals(b"nope", r.seals, 1)
    np.testing.assert_array_equal(mask, [True, False, False])
    assert not short_hash.any()


@pytest.mark.parametrize("pkg", PACKAGES)
def test_queue_full_exception_surface(pkg):
    sched = _sched(pkg, max_queue_lanes=4)
    sched.register("a", _src(pkg, 11, 4))
    tenant = sched._tenants["a"]
    sched._running = True
    out = np.zeros(8, dtype=bool)
    sched.submit(tenant, "seals", [("h", None)] * 4, 1, out, list(range(4)))
    with pytest.raises(m(pkg, "sched.scheduler").SchedQueueFull):
        sched.submit(tenant, "seals", [("h", None)] * 4, 1, out, list(range(4)))


@pytest.mark.parametrize("pkg", PACKAGES)
def test_pack_cache_owner_scoped_lifecycle(pkg):
    pipeline = m(pkg, "verify.pipeline")

    def pack():
        return pipeline.SenderPack(
            payload=b"p", r_limbs=np.zeros(20, np.int32), s_limbs=np.zeros(20, np.int32),
            v=0, sender_words=np.zeros(5, np.uint32),
        )

    class _Msg:  # weak-referenceable stand-in with the token fields
        sender = b"s" * 20
        signature = b"g" * 65

    cache = pipeline.PackCache(cap=4)
    a_msgs, b_msgs = [_Msg() for _ in range(2)], [_Msg() for _ in range(2)]
    cache.note_round(3, owner="a")
    cache.note_round(8, owner="b")
    with cache.owned("a"):
        for msg in a_msgs:
            cache.store(msg, pack())
    with cache.owned("b"):
        for msg in b_msgs:
            cache.store(msg, pack())
    assert len(cache) == 4
    cache.note_round(4, owner="a")
    extra = _Msg()
    with cache.owned("b"):
        cache.store(extra, pack())
    assert all(cache.lookup(msg) is None for msg in a_msgs)
    assert all(cache.lookup(msg) is not None for msg in b_msgs)
    with cache.owned("a"):
        cache.store(_Msg(), pack())
    cache.clear(owner="a")
    assert all(cache.lookup(msg) is not None for msg in b_msgs)
    assert cache.lookup(extra) is not None


def test_engine_scope_shared_ladder_isolates_lifecycle():
    """Two engines share one port ``DeviceBatchVerifier(device="cpu")``
    through ``scoped()`` facades: engine A's reset cannot evict engine B's
    live packs, and both scopes' verdicts match the oracle.  (The JAX
    package's side would compile the XLA ladder, so it runs here alone.)"""
    ra, rb = _round(PORT, 4, 11), _round(PORT, 4, 22, 0.25)
    verify = m(PORT, "verify")
    shared = verify.DeviceBatchVerifier(_src(PORT, 11, 4), device="cpu")
    scope_a, scope_b = shared.scoped("chain-a"), shared.scoped("chain-b")
    cache = shared._pack_cache
    assert scope_a.verify_senders(ra.prepares).all()
    oracle = verify.HostBatchVerifier(_src(PORT, 11, 4))
    np.testing.assert_array_equal(scope_b.verify_senders(rb.prepares), oracle.verify_senders(rb.prepares))
    packed_b = [msg for msg in rb.prepares if cache.lookup(msg) is not None]
    assert packed_b, "scope B stored no packs"
    scope_a.note_round(5)
    scope_a.reset_pack_cache()
    assert all(cache.lookup(msg) is not None for msg in packed_b)
    assert all(cache.lookup(msg) is None for msg in ra.prepares)
    scope_b.quarantine(packed_b[:1])
    assert cache.lookup(packed_b[0]) is None


@pytest.mark.parametrize("pkg", PACKAGES)
def test_speculation_cache_owner_scoped_per_tenant(pkg):
    verify, crypto, backend = m(pkg, "verify"), m(pkg, "crypto"), m(pkg, "crypto.backend")
    View = m(pkg, "messages.wire").View
    extract = m(pkg, "messages.helpers").extract_committed_seal
    r = _round(pkg, 4, 11)
    keys = [crypto.PrivateKey.from_seed(b"bench-%d-%d" % (11, i)) for i in range(4)]
    src_full = _src(pkg, 11, 4)
    src_partial = backend.ECDSABackend.static_validators({k.address: 1 for k in keys[:2]})
    sched = _sched(pkg, window_s=0.001)
    ha, hb = sched.register("a", src_full), sched.register("b", src_partial)
    shared_cache = verify.SpeculationCache()
    spec_a = verify.SpeculativeVerifier(ha, cache=shared_cache, owner="a")
    spec_b = verify.SpeculativeVerifier(hb, cache=shared_cache, owner="b")
    commits = [
        backend.ECDSABackend(k, src_full).build_commit_message(r.proposal_hash, View(height=1, round=0))
        for k in keys
    ]
    with sched:
        assert spec_a.submit_commit_messages(commits) == 4
        assert spec_b.submit_commit_messages(commits) == 4
        assert spec_a.drain(10.0) and spec_b.drain(10.0)
    for i, commit in enumerate(commits):
        sig = extract(commit).signature
        assert spec_a.lookup_seal(1, 0, r.proposal_hash, commit.sender, sig) is True
        assert spec_b.lookup_seal(1, 0, r.proposal_hash, commit.sender, sig) is (i < 2), i
    spec_a.reset()
    sig0 = extract(commits[0]).signature
    assert spec_a.lookup_seal(1, 0, r.proposal_hash, commits[0].sender, sig0) is None
    assert spec_b.lookup_seal(1, 0, r.proposal_hash, commits[0].sender, sig0) is True
    spec_a.stop()
    spec_b.stop()


# -- tests/test_sched_consensus.py: chains under chaos through one scheduler ----

_CHAOS = dict(drop_rate=0.02, delay_rate=0.2, max_delay_s=0.01, duplicate_rate=0.05, reorder_rate=0.05)
_HOT_CHAOS = dict(drop_rate=0.02, delay_rate=0.2, max_delay_s=0.005, duplicate_rate=0.25, reorder_rate=0.1)


class _SchedChainCluster:
    """N ``ChainRunner`` nodes of ``pkg`` whose engines verify through
    scheduler handles, their deliveries through a chaos gate."""

    def __init__(self, pkg, tmp_path, chain_id, n, injector, sched, timeout=1.0):
        chain, chaos, core = m(pkg, "chain"), m(pkg, "chaos"), m(pkg, "core")
        crypto, backend = m(pkg, "crypto"), m(pkg, "crypto.backend")
        keys = [crypto.PrivateKey.from_seed(b"mt-%s-%d" % (chain_id.encode(), i)) for i in range(n)]
        src = backend.ECDSABackend.static_validators({k.address: 1 for k in keys})
        self.net = chain.LoopbackSyncNetwork()
        self.nodes, self.runners, gates = [], [], []

        class _T:
            def multicast(self, message):
                for gate in gates:
                    gate(message)

        for i, key in enumerate(keys):
            handle = sched.register(f"{chain_id}/n{i}", src, chain_id=chain_id)
            engine = core.IBFT(NullLogger(), backend.ECDSABackend(key, src), _T(), batch_verifier=handle)
            engine.set_base_round_timeout(timeout)
            ingress = core.BatchingIngress(engine.add_messages)
            gates.append(chaos.ChaoticDeliver(ingress.submit, injector, f"{chain_id}-deliver:{i}"))
            self.nodes.append((engine, ingress))
            runner = chain.ChainRunner(
                engine,
                chain.WriteAheadLog(os.path.join(str(tmp_path), f"{pkg}-{chain_id}-wal-{i}.jsonl")),
                sync=chain.SyncClient(key.address, self.net, handle, src),
            )
            self.net.register(key.address, runner)
            self.runners.append(runner)

    def close(self):
        for engine, ingress in self.nodes:
            ingress.close()
            engine.messages.close()


async def _drive_chain(pkg, tmp_path, chain_id, n, heights, injector, sched, deadline):
    cluster = _SchedChainCluster(pkg, tmp_path, chain_id, n, injector, sched)
    try:
        await asyncio.wait_for(asyncio.gather(*(r.run(until_height=heights) for r in cluster.runners)), deadline)
        chains = [[b.proposal.raw_proposal for b in r.chain] for r in cluster.runners]
        assert all(len(c) == heights for c in chains), [len(c) for c in chains]
        assert all(c == chains[0] for c in chains), "chains diverged"
        return chains[0]
    finally:
        cluster.close()
        await asyncio.sleep(0.03)  # let chaotic call_later deliveries land


class _HotFlood:
    """Hot tenant: 100-validator seal-lane drains from a worker thread."""

    def __init__(self, pkg, sched, lanes=256):
        self.workload = m(pkg, "bench.workload").build_seal_lane_workload(
            lanes, n_validators=100, heights=2, corrupt_frac=0.1, seed=5
        )
        self.handle = sched.register("hot100", self.workload.validators, chain_id="hot100")
        self.stop = threading.Event()
        self.drains = self.mismatches = 0
        self.thread = threading.Thread(target=self._run, daemon=True)

    def _run(self):
        w = self.workload
        while not self.stop.is_set():
            mask = self.handle.verify_seal_lanes(w.lanes, w.height)
            self.drains += 1
            self.mismatches += int(not (mask == w.expected_mask).all())

    def __enter__(self):
        self.thread.start()
        return self

    def __exit__(self, *exc):
        self.stop.set()
        self.thread.join(30.0)
        assert not self.thread.is_alive()


@pytest.mark.parametrize("pkg", PACKAGES)
def test_sched_chaos_smoke_hot_and_slow_tenant(pkg, tmp_path):
    """Hot 100-validator drains and a chaotic 4-validator chain share one
    scheduler: both make progress, the hot verdicts stay oracle-exact, the
    loads coalesce, and no flush faults."""
    chaos = m(pkg, "chaos")
    injector = chaos.FaultInjector(1337, chaos.FaultConfig(**_CHAOS))
    sched = _sched(pkg, window_s=0.001)
    with chaos.replay_on_failure(injector):
        with sched:
            with _HotFlood(pkg, sched) as flood:
                asyncio.run(_drive_chain(pkg, tmp_path, "slow4", 4, 3, injector, sched, 60.0))
            assert flood.drains > 0 and flood.mismatches == 0
    stats = sched.stats()
    assert stats["flush_faults"] == 0, stats
    assert stats["coalesce_ratio"] is not None and stats["coalesce_ratio"] >= 1.0
    assert stats["tenants"]["hot100"]["drain_p99_ms"] is not None
    assert sum(t["lanes"] + t["shed_lanes"] for t in stats["tenants"].values() if t["chain"] == "slow4") > 0


@pytest.mark.slow
def test_sched_soak_two_chains_plus_flood(tmp_path):
    """Slow soak (slow in the JAX package too): a duplicate-heavy 7-node hot
    chain and a 4-node slow chain in their own event-loop threads plus the
    100-validator flood, on the port's scheduler: every chain finalizes
    every height."""
    chaos = m(PORT, "chaos")
    sched = _sched(PORT, window_s=0.001)
    hot_inj = chaos.FaultInjector(2024, chaos.FaultConfig(**_HOT_CHAOS))
    slow_inj = chaos.FaultInjector(4099, chaos.FaultConfig(**_CHAOS))
    errors = []

    def chain_thread(chain_id, n, injector):
        try:
            asyncio.run(_drive_chain(PORT, tmp_path, chain_id, n, 6, injector, sched, 180.0))
        except BaseException as err:  # noqa: BLE001 - surfaced below
            errors.append((chain_id, err))

    with chaos.replay_on_failure(hot_inj), chaos.replay_on_failure(slow_inj):
        with sched:
            with _HotFlood(PORT, sched) as flood:
                threads = [
                    threading.Thread(target=chain_thread, args=("hot7", 7, hot_inj)),
                    threading.Thread(target=chain_thread, args=("slow4", 4, slow_inj)),
                ]
                for t in threads:
                    t.start()
                for t in threads:
                    t.join(200.0)
                    assert not t.is_alive(), "chain thread wedged"
            assert not errors, errors
            assert flood.mismatches == 0 and flood.drains > 0
    stats = sched.stats()
    assert stats["flush_faults"] == 0, stats
    assert {"hot7", "slow4", "hot100"} <= {t["chain"] for t in stats["tenants"].values()}


# -- the port's own checks ------------------------------------------------------


def test_dispatch_kernels_are_the_single_tenant_planes():
    """The coalesced plane launches the very functions the single-tenant
    plane launches: the digest kernel's wrapper and DeviceBatchVerifier's
    mask (the JAX package asserts the same of its jit objects)."""
    dispatch = m(PORT, "sched.dispatch")
    assert dispatch.DIGEST_KERNEL is m(PORT, "ops.quorum").digest_words
    assert dispatch.RECOVER_KERNEL is m(PORT, "verify.batch").DeviceBatchVerifier._mask
    assert m(JAX, "sched.dispatch").DIGEST_KERNEL is m(JAX, "verify.batch")._digest_kernel


@pytest.mark.parametrize(
    "n_lanes, n_validators, heights, corrupt_frac, seed",
    [(96, 8, 3, 0.2, 7), (40, 4, 4, 0.0, 0), (7, 6, 2, 0.5, 3)],
)
def test_seal_lane_workload_matches_jax(n_lanes, n_validators, heights, corrupt_frac, seed):
    kw = dict(n_validators=n_validators, heights=heights, corrupt_frac=corrupt_frac, seed=seed)
    ours = m(PORT, "bench.workload").build_seal_lane_workload(n_lanes, **kw)
    ref = m(JAX, "bench.workload").build_seal_lane_workload(n_lanes, **kw)
    assert [(h, s.signer, s.signature) for h, s in ours.lanes] == [(h, s.signer, s.signature) for h, s in ref.lanes]
    assert ours.height == ref.height
    assert ours.expected_mask.dtype == ref.expected_mask.dtype
    np.testing.assert_array_equal(ours.expected_mask, ref.expected_mask)
    assert dict(ours.validators(1)) == dict(ref.validators(1))
    for a, b in zip(m(PORT, "verify.batch").pack_seal_lanes(ours.lanes), m(JAX, "verify.batch").pack_seal_lanes(ref.lanes)):
        assert np.array_equal(a, np.asarray(b))


class _Mesh:
    def __init__(self, n):
        self.devices = np.array([f"dev{i}" for i in range(n)], dtype=object).reshape(n, 1)


@pytest.mark.parametrize(
    "kw",
    [dict(mesh=_Mesh(2)), dict(mesh=_Mesh(4)), dict(devices=["cuda:0", "cuda:1"]), dict(dp=2, devices=["a", "b", "c"])],
    ids=["mesh2", "mesh4", "devices2", "dp2"],
)
def test_mesh_of_two_devices_raises_not_ported(kw):
    sched_mod, chain = m(PORT, "sched"), m(PORT, "chain")
    with pytest.raises(chain.NotPortedError, match="mesh slice"):
        sched_mod.CoalescedDispatcher("device", torch_device="cpu", **kw)
    with pytest.raises(chain.NotPortedError, match="mesh slice"):
        _sched(PORT).reconfigure(route="device", dp=2, devices=["a", "b"])


@pytest.mark.parametrize("kw", [dict(mesh=_Mesh(1)), dict(devices=["cpu"]), dict(dp=1, devices=["a", "b"])], ids=["mesh1", "devices1", "dp1"])
def test_mesh_of_one_device_keeps_the_single_device_route(kw):
    d = m(PORT, "sched").CoalescedDispatcher("device", torch_device="cpu", **kw)
    assert d.describe()["sharded"] is False and d.device == torch.device("cpu")


def test_host_route_resolves_no_device_and_device_route_defaults_to_the_card():
    assert m(PORT, "sched").CoalescedDispatcher("host").device is None
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            m(PORT, "sched").CoalescedDispatcher("device")


def test_pack_sender_digest_rows_digests_and_oversize_payload():
    """The one sender pack sequence both planes call: digests from the
    digest kernel's plain version on the CPU, an oversize PREPREPARE's from
    the host keccak, and the same limb rows as the host packer."""
    tb = m(PORT, "verify.batch")
    r = _round(PORT, 4, 11)
    keys = [m(PORT, "crypto").PrivateKey.from_seed(b"bench-11-%d" % i) for i in range(4)]
    View = m(PORT, "messages.wire").View
    big = m(PORT, "crypto.backend").ECDSABackend(keys[0], _src(PORT, 11, 4)).build_preprepare_message(
        b"\x5a" * 5000, None, View(height=1, round=0)
    )
    msgs = r.prepares + [big]
    cache = m(PORT, "verify.pipeline").PackCache()

    def upload(_name, a):
        return torch.from_numpy(tb._as_signed(a))

    zw, rr, ss, vv, claimed, live = tb.pack_sender_digest_rows(tb.pack_sender_lanes(msgs, cache=cache), upload)
    digests = m(PORT, "crypto.keccak").keccak256_many([msg.encode(include_signature=False) for msg in msgs])
    want = np.stack([np.frombuffer(d, ">u4")[::-1].astype(np.uint32) for d in digests]).view(np.int32)
    np.testing.assert_array_equal(zw[: len(msgs)].numpy(), want)
    assert live.numpy().tolist() == [True] * len(msgs) + [False] * (live.numel() - len(msgs))
    ref = m(JAX, "verify.batch").pack_sender_batch(
        [m(JAX, "messages.wire").IbftMessage.decode(msg.encode()) for msg in msgs],
        payloads=[b""] * len(msgs),  # the limb rows do not depend on the payloads
    )
    for got, want_arr in zip((rr, ss, vv, claimed), ref[2:6]):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want_arr).view(got.numpy().dtype))
    assert all(cache.lookup(msg) is not None for msg in msgs)  # fresh packs stored
    # A second call serves every lane from the cache, with the same rows.
    again = tb.pack_sender_digest_rows(tb.pack_sender_lanes(msgs, cache=cache), upload)
    for a, b in zip(again, (zw, rr, ss, vv, claimed, live)):
        assert torch.equal(a, b)


def test_device_verifier_upload_goes_through_pack_sender_digest_rows(monkeypatch):
    """``DeviceBatchVerifier._upload`` takes its envelope chunks through the
    shared function (one call a chunk), the seal chunks not."""
    tb = m(PORT, "verify.batch")
    calls = []
    real = tb.pack_sender_digest_rows

    def counting(lanes, upload):
        calls.append(lanes)
        return real(lanes, upload)

    monkeypatch.setattr(tb, "pack_sender_digest_rows", counting)
    r = _round(PORT, 4, 11)
    verifier = tb.DeviceBatchVerifier(_src(PORT, 11, 4), device="cpu")
    lanes = verifier._sender_inputs(r.prepares)
    slot = verifier._staging.begin()
    try:
        zw = verifier._upload(slot, lanes)[0]
        verifier._upload(slot, verifier._seal_inputs(r.proposal_hash, r.seals), tag="seal-")
    finally:
        verifier._staging.finish(slot)
    assert calls == [lanes]
    digests = m(PORT, "crypto.keccak").keccak256_many([msg.encode(include_signature=False) for msg in r.prepares])
    np.testing.assert_array_equal(
        zw[:4].numpy(), np.stack([np.frombuffer(d, ">u4")[::-1].astype(np.uint32) for d in digests]).view(np.int32)
    )


class _FaultyDispatcher:
    """A dispatcher whose launch raises; ``device`` makes ``on_card`` true
    (a CUDA device) or false (the CPU)."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.route = "device"
        self.calls = 0

    def dispatch(self, msgs, lanes, owners):
        self.calls += 1
        raise RuntimeError("injected kernel fault")

    def warmup(self, **kw):
        pass


def _faulty_drains(h, r):
    return {
        "verify_senders": lambda: h.verify_senders(r.prepares),
        "verify_seal_lanes": lambda: h.verify_seal_lanes([(r.proposal_hash, s) for s in r.seals], 1),
        "verify_committed_seals": lambda: h.verify_committed_seals(r.proposal_hash, r.seals, 1),
    }


@pytest.mark.parametrize("call", ["verify_senders", "verify_seal_lanes", "verify_committed_seals"])
def test_card_fault_propagates_to_the_caller(call):
    """On the card a flush's fault is raised in the caller's thread and
    counted, never filled from the host oracle."""
    r = _round(PORT, 4, 11, 0.25)
    dispatcher = _FaultyDispatcher("cuda")
    sched = m(PORT, "sched").TenantScheduler(window_s=0.001, dispatcher=dispatcher)
    h = sched.register("a", _src(PORT, 11, 4))
    assert sched.on_card and m(PORT, "verify.batch").on_card(h)
    with sched:
        with pytest.raises(RuntimeError, match="injected kernel fault"):
            _faulty_drains(h, r)[call]()
    stats = sched.stats()
    assert stats["flush_faults"] == dispatcher.calls == 1
    assert stats["tenants"]["a"]["sheds"] == 0 and stats["dispatches"] == 0


@pytest.mark.parametrize("call", ["verify_senders", "verify_seal_lanes", "verify_committed_seals"])
def test_off_card_fault_fills_from_the_oracle(call):
    """Off the card the JAX behaviour stays: the faulted flush's callers
    get the host oracle's exact verdicts."""
    r = _round(PORT, 4, 11, 0.25)
    src = _src(PORT, 11, 4)
    dispatcher = _FaultyDispatcher("cpu")
    sched = m(PORT, "sched").TenantScheduler(window_s=0.001, dispatcher=dispatcher)
    h = sched.register("a", src)
    assert not sched.on_card and not m(PORT, "verify.batch").on_card(h)
    with sched:
        got = _faulty_drains(h, r)[call]()
    oracle = m(PORT, "verify").HostBatchVerifier(src)
    want = oracle.verify_senders(r.prepares) if call == "verify_senders" else r.expected_seal_mask
    np.testing.assert_array_equal(got, want)
    assert sched.stats()["flush_faults"] == 1


@pytest.mark.parametrize("device", ["cuda", "cpu"])
def test_timed_out_request_raises_on_the_card_only(device):
    """A request no flush answers: on the card it raises and counts as a
    flush fault; off the card it is shed to the oracle, as in the JAX
    package."""
    sched_mod = m(PORT, "sched")
    r = _round(PORT, 4, 11)
    gate = threading.Event()

    class _Wedged(_FaultyDispatcher):
        def dispatch(self, msgs, lanes, owners):
            gate.wait(5.0)
            return np.ones(len(msgs), bool), np.ones(len(lanes), bool)

    sched = sched_mod.TenantScheduler(window_s=0.001, dispatcher=_Wedged(device), request_timeout_s=0.2)
    h = sched.register("a", _src(PORT, 11, 4))
    with sched:
        try:
            if device == "cuda":
                with pytest.raises(sched_mod.SchedFlushTimeout):
                    h.verify_senders(r.prepares)
            else:
                assert h.verify_senders(r.prepares).all()
        finally:
            gate.set()
    stats = sched.stats()
    assert stats["flush_faults"] == (1 if device == "cuda" else 0)
    assert stats["tenants"]["a"]["sheds"] == (0 if device == "cuda" else 1)


def test_shed_under_backpressure_stays_on_the_card():
    """Shedding is a load policy: a full queue is served by the oracle on
    the card too, and counted."""
    r = _round(PORT, 4, 11)
    sched = m(PORT, "sched").TenantScheduler(window_s=0.001, dispatcher=_FaultyDispatcher("cuda"), max_queue_lanes=2)
    h = sched.register("a", _src(PORT, 11, 4))
    with sched:
        assert h.verify_senders(r.prepares).all()
    assert sched.stats()["tenants"]["a"]["shed_lanes"] == 4 and sched.stats()["flush_faults"] == 0


@pytest.mark.parametrize("device", ["cuda", "cpu"])
def test_unregistered_tenant_in_flight_raises_on_the_card_only(device):
    """A request queued when its tenant is unregistered is a refusal, not
    a shed: on the card it raises in the caller's thread; off the card the
    oracle serves it, as in the JAX package.  Both count it."""
    sched_mod = m(PORT, "sched")
    r = _round(PORT, 4, 11, 0.25)
    src = _src(PORT, 11, 4)
    sched = sched_mod.TenantScheduler(window_s=0.001, dispatcher=_FaultyDispatcher(device))
    h = sched.register("a", src)
    assert sched.on_card == (device == "cuda")
    sched._running = True  # accepts submissions; no flush thread selects them
    got = {}

    def call():
        try:
            got["mask"] = h.verify_committed_seals(r.proposal_hash, r.seals, 1)
        except BaseException as err:  # noqa: BLE001 - read below
            got["error"] = err

    t = threading.Thread(target=call)
    t.start()
    deadline = time.monotonic() + 5.0
    while not sched._tenants["a"].queue and time.monotonic() < deadline:
        time.sleep(0.005)
    assert sched._tenants["a"].queue, "the request never queued"
    sched.unregister("a")
    t.join(5.0)
    assert not t.is_alive()
    sched._running = False
    if device == "cuda":
        assert isinstance(got.get("error"), sched_mod.SchedRefused), got
    else:
        np.testing.assert_array_equal(got["mask"], r.expected_seal_mask)
    stats = sched.stats()
    assert stats["refusals"] == 1 and stats["flush_faults"] == 0 and stats["dispatches"] == 0


@pytest.mark.parametrize("device", ["cuda", "cpu"])
@pytest.mark.parametrize("closed", ["stopped_scheduler", "draining_tenant"])
def test_refused_submission_raises_on_the_card_only(device, closed):
    """A submission refused for the lifecycle (a stopped scheduler, a
    draining tenant): on the card it raises, off the card the oracle
    serves it and it counts as a shed, as in the JAX package."""
    sched_mod = m(PORT, "sched")
    r = _round(PORT, 4, 11, 0.25)
    sched = sched_mod.TenantScheduler(window_s=0.001, dispatcher=_FaultyDispatcher(device))
    h = sched.register("a", _src(PORT, 11, 4))
    if closed == "draining_tenant":
        sched._running = True
        sched._tenants["a"].draining = True
    try:
        if device == "cuda":
            with pytest.raises(sched_mod.SchedRefused):
                h.verify_seal_lanes([(r.proposal_hash, s) for s in r.seals], 1)
        else:
            mask = h.verify_seal_lanes([(r.proposal_hash, s) for s in r.seals], 1)
            np.testing.assert_array_equal(mask, r.expected_seal_mask)
    finally:
        sched._running = False
    stats = sched.stats()
    assert stats["refusals"] == 1 and stats["flush_faults"] == 0
    assert stats["tenants"]["a"]["sheds"] == (0 if device == "cuda" else 1)
