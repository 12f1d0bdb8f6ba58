"""The port's chain layer (``ChainRunner``, the WAL, crash recovery) against
the JAX package's, on the CPU.

Every cluster here runs in virtual time: a selector event loop whose clock
jumps to the next timer when nothing is ready, with a default executor that
runs its call inline, so that the overlap worker's ``run_in_executor``
drains finish at a fixed point of the schedule.  A run is then a function of
its seed alone, and the same schedule through both packages must give
byte-identical results: finalized chains (proposal bytes, seal signers and
signatures) and WAL files.  The links are config #7's (``bench.py``
``config7_chain``): node 3 hears node 0 over a fast link and nodes 1 and 2
over slow ones, so its COMMIT quorum for height H waits while H+1's early
traffic lands in its future buffer, and the overlap worker fires.

The WAL cases mirror ``tests/test_chain.py``; each runs in both packages and
compares the files and replay results.  One node with the port's
``DeviceBatchVerifier(device="cpu")`` (plain PyTorch kernels, ~3 s a drain)
runs one height: the same proposal, the other nodes' WALs byte-identical to
the host run's, and its seals a superset of the host run's (the device
drain's early exit verifies a whole lane bucket).
"""

import asyncio
import concurrent.futures
import importlib
import os
import time
from types import SimpleNamespace

import pytest
import torch

torch.set_num_threads(1)

PACKAGES = ("go_ibft_tpu_torch", "go_ibft_tpu")
EAGER = 1 << 30  # every ingress flushes at the end of its event-loop tick
# config #7's links (seconds): node 3 is "in another region".
LINK_SLOW, LINK_FAST, LINK_LOCAL = 0.025, 0.002, 0.0005
HEIGHTS = 6


def link_latency(receiver: int, sender: int) -> float:
    if receiver == sender:
        return 0.0
    if receiver == 3:
        return LINK_FAST if sender == 0 else LINK_SLOW
    return LINK_LOCAL


# -- virtual time ---------------------------------------------------------


class InlineExecutor(concurrent.futures.ThreadPoolExecutor):
    """``run_in_executor`` without a thread: the call runs at submit."""

    def submit(self, fn, *args, **kwargs):
        future = concurrent.futures.Future()
        try:
            future.set_result(fn(*args, **kwargs))
        except BaseException as err:  # noqa: BLE001 - handed to the awaiter
            future.set_exception(err)
        return future


class VirtualLoop(asyncio.SelectorEventLoop):
    """An event loop whose clock advances only by the timers it waits on."""

    def __init__(self):
        super().__init__()
        self._now = 0.0
        real_select = self._selector.select

        def select(timeout=None):
            events = real_select(0)
            if not events and timeout is not None and timeout > 0:
                self._now += timeout
            elif not events and timeout is None:
                events = real_select(0.01)
            return events

        self._selector.select = select
        self.set_default_executor(InlineExecutor(max_workers=1))

    def time(self):
        return self._now


def run_virtual(coro):
    loop = VirtualLoop()
    asyncio.set_event_loop(loop)
    try:
        return loop.run_until_complete(coro)
    finally:
        tasks = asyncio.all_tasks(loop)
        for task in tasks:
            task.cancel()
        if tasks:
            loop.run_until_complete(asyncio.gather(*tasks, return_exceptions=True))
        asyncio.set_event_loop(None)
        loop.close()


class LoopClock:
    """Stands in for the ``time`` module of a module under test: its clocks
    read the running loop's virtual time (the real clock outside a loop)."""

    @staticmethod
    def monotonic():
        try:
            return asyncio.get_running_loop().time()
        except RuntimeError:
            return time.monotonic()

    perf_counter = monotonic

    @staticmethod
    def perf_counter_ns():
        return int(LoopClock.monotonic() * 1e9)


@pytest.fixture
def virtual_clocks(monkeypatch):
    """The runners' stall and height clocks on virtual time, both packages."""
    for name in PACKAGES:
        monkeypatch.setattr(importlib.import_module(f"{name}.chain.runner"), "time", LoopClock)


class _NullLogger:
    def info(self, *args):
        pass

    debug = error = info


def pkg(name):
    """One package's modules, by their names in both packages."""
    mods = {
        key: importlib.import_module(f"{name}.{mod}")
        for key, mod in (
            ("core", "core"), ("ibft", "core.ibft"), ("crypto", "crypto"), ("cb", "crypto.backend"),
            ("verify", "verify"), ("chain", "chain"), ("chaos", "chaos"), ("wire", "messages.wire"),
            ("helpers", "messages.helpers"), ("trace", "obs.trace"), ("metrics", "utils.metrics"),
        )
    }
    return SimpleNamespace(name=name, **mods)


# -- a ChainRunner cluster --------------------------------------------------


class Cluster:
    """``n`` real-key validators of one package, each an ``IBFT`` behind a
    ``BatchingIngress`` driven by a ``ChainRunner`` with a WAL under
    ``tmp``, gossiping over loopback with ``latency(receiver, sender)``
    delays.  ``verifier(i, src)`` makes node i's verifier (default: the
    package's ``HostBatchVerifier``); ``sync`` gives every runner a
    ``SyncClient`` over one ``LoopbackSyncNetwork``.  Build it inside the
    running loop."""

    def __init__(self, name, tmp, n=4, *, seed=b"torch-chain", latency=link_latency, verifier=None,
                 sync=False, timeout=30.0, **runner_kw):
        self.m = pkg(name)
        self.keys = [self.m.crypto.PrivateKey.from_seed(seed + b"-%d" % i) for i in range(n)]
        self.src = self.m.cb.ECDSABackend.static_validators({k.address: 1 for k in self.keys})
        self.tmp, self.latency, self.verifier, self.sync = str(tmp), latency, verifier, sync
        os.makedirs(self.tmp, exist_ok=True)
        self.timeout, self.runner_kw = timeout, {"overlap_poll_s": 0.0005, **runner_kw}
        self.net = self.m.chain.LoopbackSyncNetwork()
        self.nodes, self.runners, self.offline = {}, {}, set()
        for i in range(n):
            self.build_node(i)

    def gossip(self, sender, message):
        loop = asyncio.get_running_loop()
        for j, (_, ingress) in list(self.nodes.items()):
            if j not in self.offline:
                loop.call_later(self.latency(j, sender), ingress.submit, message)

    def wal_path(self, i):
        return os.path.join(self.tmp, f"wal-{i}.jsonl")

    def build_node(self, i):
        m, cluster = self.m, self

        class Transport:
            def multicast(self, message):
                cluster.gossip(i, message)

        make = self.verifier or (lambda _i, src: m.verify.HostBatchVerifier(src))
        engine = m.core.IBFT(_NullLogger(), m.cb.ECDSABackend(self.keys[i], self.src), Transport(),
                             batch_verifier=make(i, self.src))
        engine.set_base_round_timeout(self.timeout)
        self.nodes[i] = (engine, m.core.BatchingIngress(engine.add_messages, eager_cutover=EAGER))
        sync = (m.chain.SyncClient(self.keys[i].address, self.net, m.verify.HostBatchVerifier(self.src), self.src)
                if self.sync else None)
        runner = m.chain.ChainRunner(engine, m.chain.WriteAheadLog(self.wal_path(i)), sync=sync,
                                     **self.runner_kw)
        self.net.register(self.keys[i].address, runner)
        self.runners[i] = runner
        return runner

    def kill(self, i):
        """kill -9: drop the node's in-memory state, keep its WAL."""
        engine, ingress = self.nodes[i]
        ingress.close()
        engine.messages.close()
        self.runners[i].wal.close()
        self.offline.add(i)

    def restart(self, i):
        self.offline.discard(i)
        runner = self.build_node(i)
        runner.recover()
        return runner

    def close(self):
        for engine, ingress in self.nodes.values():
            ingress.close()
            engine.messages.close()
        for runner in self.runners.values():
            runner.wal.close()

    def chain(self, i):
        """Node i's finalized chain, package-neutral."""
        return [
            (b.height, b.proposal.encode(), [(s.signer, s.signature) for s in b.seals])
            for b in self.runners[i].chain
        ]

    def wal_bytes(self, i):
        with open(self.wal_path(i), "rb") as fh:
            return fh.read()

    async def run(self, until_height, nodes=None, deadline=600.0):
        nodes = sorted(self.runners) if nodes is None else nodes
        try:
            await asyncio.wait_for(
                asyncio.gather(*(self.runners[i].run(until_height=until_height) for i in nodes)), deadline
            )
        finally:
            self.close()


def chain_run(name, tmp, heights=HEIGHTS, **kw):
    """Run a 4-node chain for ``heights``; returns per node its chain, WAL
    bytes and overlap evidence."""

    async def body():
        cluster = Cluster(name, tmp, **kw)
        await cluster.run(heights)
        return [
            {
                "chain": cluster.chain(i),
                "wal": cluster.wal_bytes(i),
                "overlap": (r.overlapped_lanes, r.overlap_batches, r.heights_run),
            }
            for i, r in sorted(cluster.runners.items())
        ]

    return run_virtual(body())


# -- the chain ---------------------------------------------------------------


def test_chain_and_wal_byte_identical_to_jax(tmp_path, virtual_clocks):
    ours = chain_run(PACKAGES[0], tmp_path / "port")
    ref = chain_run(PACKAGES[1], tmp_path / "jax")
    assert ours == ref
    for node in ours:
        assert [h for h, _, _ in node["chain"]] == list(range(1, HEIGHTS + 1))
        assert all(len(seals) >= 3 for _, _, seals in node["chain"])  # quorum 3 of 4
        assert node["overlap"][2] == HEIGHTS
    # The far node's overlap worker pre-verified next-height traffic.
    assert ours[3]["overlap"][0] > 0 and ours[3]["overlap"][1] > 0


def test_device_verifier_node_gives_the_same_chain(tmp_path, virtual_clocks):
    from go_ibft_tpu_torch.crypto.backend import proposal_hash_of
    from go_ibft_tpu_torch.crypto.ecdsa import recover_pure
    from go_ibft_tpu_torch.messages import CommittedSeal
    from go_ibft_tpu_torch.messages.wire import Proposal
    from go_ibft_tpu_torch.verify import DeviceBatchVerifier, HostBatchVerifier

    dispatched = []

    class Spy(DeviceBatchVerifier):
        def _dispatch_async(self, lanes, table, quorum_args):
            dispatched.append(int(lanes.live.sum()))
            return super()._dispatch_async(lanes, table, quorum_args)

    def card_on_3(i, src):
        return Spy(src, device="cpu") if i == 3 else HostBatchVerifier(src)

    host = chain_run(PACKAGES[0], tmp_path / "host", heights=1)
    card = chain_run(PACKAGES[0], tmp_path / "card", heights=1, verifier=card_on_3)
    assert [n["wal"] for n in card[:3]] == [n["wal"] for n in host[:3]]
    ((height, proposal, seals),) = card[3]["chain"]
    ((_, host_proposal, host_seals),) = host[3]["chain"]
    assert height == 1 and proposal == host_proposal
    assert set(host_seals) <= set(seals)
    phash = proposal_hash_of(Proposal.decode(proposal))
    for signer, sig in seals:  # every finalized seal passes the Python-int oracle
        pub = recover_pure(phash, int.from_bytes(sig[:32], "big"), int.from_bytes(sig[32:64], "big"), sig[64])
        assert pub is not None
    assert dispatched and sum(dispatched) >= 7  # envelopes and seals went through the device path
    assert HostBatchVerifier(lambda h: {s: 1 for s, _ in seals}).verify_committed_seals(
        phash, [CommittedSeal(*s) for s in seals], 1
    ).all()


# -- the WAL (mirrors tests/test_chain.py) ------------------------------------


def _signers(m, n=3):
    return [m.helpers.CommittedSeal(signer=b"node-%d" % i, signature=b"\x05" * 65) for i in range(n)]


def _pc(m, height=1, round_=2):
    """A prepared certificate of real signed messages (deterministic)."""
    keys = [m.crypto.PrivateKey.from_seed(b"torch-wal-%d" % i) for i in range(4)]
    src = m.cb.ECDSABackend.static_validators({k.address: 1 for k in keys})
    backends = [m.cb.ECDSABackend(k, src) for k in keys]
    view = m.wire.View(height=height, round=round_)
    pmsg = backends[0].build_preprepare_message(b"locked block", None, view)
    phash = pmsg.preprepare_data.proposal_hash
    return m.wire.PreparedCertificate(
        proposal_message=pmsg, prepare_messages=[b.build_prepare_message(phash, view) for b in backends[1:]]
    )


def _replay_summary(m, path):
    state = m.chain.WriteAheadLog(path).replay()
    lock = state.lock
    return {
        "blocks": [(b.height, b.proposal.encode(), [(s.signer, s.signature) for s in b.seals]) for b in state.blocks],
        "next_height": state.next_height,
        "dropped_tail": state.dropped_tail,
        "lock": None if lock is None else (lock.height, lock.round, lock.certificate.encode()),
    }


def _proposal(m, raw, round_=0):
    return m.wire.Proposal(raw_proposal=raw, round=round_)


def _wal_round_trip(m, path):
    wal = m.chain.WriteAheadLog(path)
    for h in (1, 2, 3):
        wal.append_finalize(h, _proposal(m, b"block %d" % h), _signers(m))
    wal.close()
    return [_replay_summary(m, path)]


def _wal_lock_superseded(m, path):
    wal = m.chain.WriteAheadLog(path)
    wal.append_lock(1, 2, _pc(m))
    before = _replay_summary(m, path)
    wal.append_finalize(1, _proposal(m, b"locked block", 2), _signers(m))
    wal.close()
    return [before, _replay_summary(m, path)]


def _torn(m, path, tail):
    wal = m.chain.WriteAheadLog(path)
    wal.append_finalize(1, _proposal(m, b"b1"), [])
    wal.append_finalize(2, _proposal(m, b"b2"), [])
    wal.close()
    with open(path, "ab") as fh:  # crash mid-append: a partial last line
        fh.write(tail)


def _wal_torn_tail(m, path):
    _torn(m, path, b'{"kind":"finalize","height":3,"proposal":"6')
    return [_replay_summary(m, path)]


def _wal_torn_tail_then_append(m, path):
    _torn(m, path, b'{"kind":"finalize","height":3,"pro')
    recovered = m.chain.WriteAheadLog(path)
    first = _replay_summary(m, path)
    recovered.append_finalize(3, _proposal(m, b"b3"), [])
    recovered.close()
    return [first, _replay_summary(m, path)]


def _wal_append_without_replay(m, path):
    _torn(m, path, b'{"kind":"finalize","height":3,"pro')
    fresh = m.chain.WriteAheadLog(path)
    fresh.append_finalize(4, _proposal(m, b"b4"), [])
    fresh.close()
    return [_replay_summary(m, path)]


def _wal_interior_corruption(m, path):
    _torn(m, path, b"")
    with open(path, "rb") as fh:
        lines = fh.read().splitlines(keepends=True)
    with open(path, "wb") as fh:
        fh.write(b"garbage not json\n" + lines[1])
    with pytest.raises(m.chain.WalCorruptionError) as err:
        m.chain.WriteAheadLog(path).replay()
    return [str(err.value).replace(path, "<wal>")]


def _wal_duplicate_finalize(m, path):
    wal = m.chain.WriteAheadLog(path)
    wal.append_finalize(1, _proposal(m, b"first"), [])
    wal.append_finalize(1, _proposal(m, b"second", 1), [])
    wal.close()
    return [_replay_summary(m, path)]


WAL_CASES = {
    "round_trip": _wal_round_trip,
    "lock_superseded_by_finalize": _wal_lock_superseded,
    "torn_tail_tolerated": _wal_torn_tail,
    "torn_tail_truncated_so_next_append_is_clean": _wal_torn_tail_then_append,
    "append_without_replay_sanitizes_torn_tail": _wal_append_without_replay,
    "interior_corruption_refused": _wal_interior_corruption,
    "duplicate_finalize_keeps_first": _wal_duplicate_finalize,
}


@pytest.mark.parametrize("case", sorted(WAL_CASES))
def test_wal_case_matches_jax(tmp_path, case):
    results = []
    for name in PACKAGES:
        path = str(tmp_path / f"{name}.jsonl")
        out = WAL_CASES[case](pkg(name), path)
        with open(path, "rb") as fh:
            results.append((out, fh.read()))
    assert results[0] == results[1]


# -- crash-consistent finalize ordering, through CrashRestart ----------------


def _height_messages(m, height=1, round_=0, block=b"crash block"):
    """A finalizable height for validator 3 of 4 (proposer: validator 0)."""
    keys = [m.crypto.PrivateKey.from_seed(b"torch-crash-%d" % i) for i in range(4)]
    src = m.cb.ECDSABackend.static_validators({k.address: 1 for k in keys})
    backends = [m.cb.ECDSABackend(k, src) for k in keys]
    view = m.wire.View(height=height, round=round_)
    proposer = next(b for b in backends if b.is_proposer(b.address, height, round_))
    others = [b for b in backends if b is not proposer]
    pmsg = proposer.build_preprepare_message(block, None, view)
    phash = pmsg.preprepare_data.proposal_hash
    msgs = [pmsg] + [b.build_prepare_message(phash, view) for b in others]
    msgs += [b.build_commit_message(phash, view) for b in others]
    me = next(b for b in others)
    return keys, src, me, msgs, view


class _Sent:
    def __init__(self):
        self.sent = []

    def multicast(self, message):
        self.sent.append(message)


@pytest.mark.parametrize("before", [True, False], ids=["crash_before_wal_append", "crash_after_wal_append"])
def test_crash_around_wal_append_matches_jax(tmp_path, before):
    """Seeded kill-points on either side of the WAL append never lose a
    finalized height: before it, the un-pruned store still holds the commit
    quorum; after it, the height is durable.  Both packages agree."""
    results = []
    for name in PACKAGES:
        m = pkg(name)
        path = str(tmp_path / f"{name}.jsonl")
        wal = m.chain.WriteAheadLog(path)
        crash = m.chaos.CrashRestart(m.chaos.FaultInjector(11), "crash:finalize", lo=1, hi=1)
        keys, src, me, msgs, view = _height_messages(m)
        engine = m.core.IBFT(_NullLogger(), me, _Sent(), batch_verifier=m.verify.HostBatchVerifier(src))
        engine.set_base_round_timeout(5.0)
        engine.on_finalize = crash.wrap(lambda h, p, s: wal.append_finalize(h, p, s), before=before)
        for message in msgs:
            engine.add_message(message)

        async def body():
            with pytest.raises(m.chaos.SimulatedCrash):
                await asyncio.wait_for(engine.run_sequence(1), 5)

        run_virtual(body())
        wal.close()
        commits = engine.messages.num_messages(view, m.wire.MessageType.COMMIT)
        engine.messages.close()
        results.append((_replay_summary(m, path), commits))
    assert results[0] == results[1]
    summary, commits = results[0]
    assert summary["next_height"] == (1 if before else 2)
    if before:
        assert commits == 3  # the quorum evidence survives in the store


def test_restored_lock_resumes_commit_without_reproposing_like_jax():
    """A restored proposer re-enters COMMIT with the certificate's proposal
    pinned and re-announces its COMMIT for it; it never builds a proposal."""
    results = []
    for name in PACKAGES:
        m = pkg(name)
        keys, src, _, msgs, view = _height_messages(m)
        backends = [m.cb.ECDSABackend(k, src) for k in keys]
        proposer = next(b for b in backends if b.is_proposer(b.address, 1, 0))
        built = []
        proposer._build_proposal_fn = lambda v: built.append(v) or b"fresh block"
        transport = _Sent()
        engine = m.core.IBFT(_NullLogger(), proposer, transport, batch_verifier=m.verify.HostBatchVerifier(src))
        engine.set_base_round_timeout(5.0)
        pc = m.wire.PreparedCertificate(proposal_message=msgs[0], prepare_messages=msgs[1:4])
        for message in msgs[4:]:  # the others' COMMITs complete the height
            engine.add_message(message)

        async def body():
            await asyncio.wait_for(
                engine.run_sequence(1, restore=m.ibft.RestoredState(height=1, round=0, certificate=pc)), 5
            )

        run_virtual(body())
        engine.messages.close()
        commits = [x.encode() for x in transport.sent if x.type == m.wire.MessageType.COMMIT]
        results.append((built, [(p.encode(), len(s)) for p, s in proposer.inserted], commits))
    assert results[0] == results[1]
    built, inserted, commits = results[0]
    assert built == [] and len(inserted) == 1 and commits


def test_lock_append_failure_withholds_commit_like_jax():
    """A COMMIT never goes out without its durable lock: when the lock hook
    raises, the engine sends no COMMIT and still finalizes from its peers'."""
    results = []
    for name in PACKAGES:
        m = pkg(name)
        _, src, me, msgs, _ = _height_messages(m)
        transport = _Sent()
        engine = m.core.IBFT(_NullLogger(), me, transport, batch_verifier=m.verify.HostBatchVerifier(src))
        engine.set_base_round_timeout(5.0)

        def failing_lock(*_args):
            raise OSError("disk full")

        engine.on_lock = failing_lock
        for message in msgs:
            engine.add_message(message)
        run_virtual(asyncio.wait_for(engine.run_sequence(1), 5))
        engine.messages.close()
        results.append(([p.encode() for p, _ in me.inserted],
                        [x.type for x in transport.sent]))
    assert results[0][0] == results[1][0] and len(results[0][0]) == 1
    assert [int(t) for t in results[0][1]] == [int(t) for t in results[1][1]]
    assert all(int(t) != int(pkg(PACKAGES[0]).wire.MessageType.COMMIT) for t in results[0][1])


# -- runner lifecycle ----------------------------------------------------------


def test_runner_spans_handoffs_and_recovery_like_jax(tmp_path, virtual_clocks):
    """Back-to-back heights with per-height ``chain.height`` and
    ``chain.handoff`` spans, a bounded in-memory tail with deep history
    served from the WAL, and ``recover()`` resuming at the next height."""
    results = []
    for name in PACKAGES:
        m = pkg(name)
        recorder = m.trace.enable()
        try:
            async def body():
                cluster = Cluster(name, tmp_path / name)
                cluster.runners[0].max_chain_blocks = 2
                await cluster.run(4)
                return cluster

            cluster = run_virtual(body())
            names = [record[1] for record in recorder.snapshot()]
        finally:
            m.trace.disable()
        runner = cluster.runners[0]
        tail = [b.height for b in runner.chain]
        served = [[b.height for b in runner.get_blocks(lo, hi)] for lo, hi in ((3, 4), (1, 4))]
        fresh_backend = m.cb.ECDSABackend(cluster.keys[0], cluster.src)
        fresh = m.chain.ChainRunner(
            m.core.IBFT(_NullLogger(), fresh_backend, _Sent()), m.chain.WriteAheadLog(cluster.wal_path(0))
        )
        resumed = fresh.recover()
        fresh.engine.messages.close()
        results.append({
            "spans": (names.count("chain.height"), names.count("chain.handoff")),
            "handoffs": [len(r.handoff_ms) for _, r in sorted(cluster.runners.items())],
            "tail": tail,
            "served": served,
            "resumed": resumed,
            "reinserted": [p.encode() for p, _ in fresh_backend.inserted],
        })
    assert results[0] == results[1]
    ours = results[0]
    assert ours["spans"] == (16, 16)  # 4 nodes x 4 heights
    assert ours["tail"] == [3, 4] and ours["served"] == [[3, 4], [1, 2, 3, 4]]
    assert ours["resumed"] == 5 and len(ours["reinserted"]) == 4


def test_runner_rejects_concurrent_run(tmp_path):
    m = pkg(PACKAGES[0])

    async def body():
        cluster = Cluster(m.name, tmp_path)
        task = asyncio.create_task(cluster.runners[0].run(until_height=99))
        await asyncio.sleep(0.05)
        with pytest.raises(RuntimeError, match="already active"):
            await cluster.runners[0].run(until_height=99)
        task.cancel()
        await asyncio.gather(task, return_exceptions=True)
        cluster.close()

    run_virtual(body())


# -- the overlap worker's faults: the JAX rule off the card, none on it ------


class _FaultOnFuture:
    """A verifier whose drains of next-height envelopes raise (the overlap
    worker's), on a device that says where its kernels would run."""

    def __init__(self, inner, device):
        self.inner, self.device, self.faults = inner, torch.device(device), 0

    def __getattr__(self, name):
        return getattr(self.inner, name)

    def verify_senders(self, msgs):
        if any(m.view.height == 2 for m in msgs):
            self.faults += 1
            raise RuntimeError("kernel fault")
        return self.inner.verify_senders(msgs)


def _overlap_fault_run(device):
    """Validator 3 reaches height 1's COMMIT with height 2's PREPAREs in its
    future buffer; its overlap worker's drain of them faults."""
    m = pkg(PACKAGES[0])
    _, src, me, msgs, _ = _height_messages(m)
    _, _, _, next_msgs, _ = _height_messages(m, height=2, block=b"next block")
    verifier = _FaultOnFuture(m.verify.HostBatchVerifier(src), device)
    engine = m.core.IBFT(_NullLogger(), me, _Sent(), batch_verifier=verifier)
    engine.set_base_round_timeout(30.0)
    runner = m.chain.ChainRunner(engine, None, overlap=True, overlap_poll_s=0.001)

    async def body():
        task = asyncio.create_task(runner.run(until_height=1))
        await asyncio.sleep(0.001)  # the engine enters height 1
        engine.add_messages(msgs[:4])  # the proposal and the PREPAREs: COMMIT phase
        await asyncio.sleep(0.001)
        assert engine.state.name == m.core.StateName.COMMIT
        engine.add_messages(next_msgs[1:4])  # height 2's PREPAREs: buffered
        assert engine.future_buffered == 3
        await asyncio.sleep(0.05)  # the overlap worker polls and drains
        engine.add_messages(msgs[4:])  # height 1's COMMITs
        try:
            await asyncio.wait_for(task, 10)
        finally:
            engine.messages.close()
        return me.inserted

    return verifier, run_virtual(body())


def test_overlap_fault_off_the_card_is_served_like_jax():
    verifier, inserted = _overlap_fault_run("cpu")
    assert verifier.faults >= 1 and len(inserted) == 1  # the height finalized regardless


def test_overlap_fault_on_the_card_ends_run():
    with pytest.raises(RuntimeError, match="kernel fault"):
        _overlap_fault_run("cuda")
