"""The port's spans where a validator's host work happens, on the CPU.

A tiny live height: the four validators of ``test_torch_chain``'s cluster,
every gossiped message delivered as wire bytes (each decoded by
``IbftMessage.decode``, as the gRPC transport decodes a peer's), every
ingress on its timed window, and node 0 verifying through a
``TenantScheduler`` on its device route with a CPU ``torch_device`` (the
recovery served by the host oracle, as ``test_torch_mesh`` serves it: the
plain version costs seconds a drain here).  Then a tiny ``SyncClient``
catch-up of that height from the cluster.  Run once with tracing on and once
with it off.

One card test (``cuda``) holds the recorder's clock against the card's: a
few flushes under the benchmark's profiler, every recovery kernel inside the
``sched.card`` span of its flush.  The file imports neither JAX nor the JAX
package, so on the machine with the card it runs without the repository's
conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_trace_spans.py -q -k on_card -s
"""

import asyncio
import itertools

import numpy as np
import pytest
import torch
from test_torch_chain import Cluster

from go_ibft_tpu_torch.chain import SyncClient
from go_ibft_tpu_torch.messages.wire import IbftMessage
from go_ibft_tpu_torch.obs import trace
from go_ibft_tpu_torch.ops import ecrecover
from go_ibft_tpu_torch.sched import TenantScheduler
from go_ibft_tpu_torch.verify import HostBatchVerifier

torch.set_num_threads(1)

PORT = "go_ibft_tpu_torch"
HEIGHTS = 1

# Each new span, with the args it carries.
LIVE_SPANS = {
    "ingress.window": {"lanes", "window_us"},
    "sched.window": {"requests", "lanes", "window_us", "rate_per_s", "why"},
    "sched.pack": {"senders", "seals"},
    "sched.card": {"lanes", "padded"},
    "engine.send": {"type"},
    "wal.fsync": {"kind"},
    "wire.decode": set(),
}
SYNC_SPANS = {
    "sync.group": {"heights"},
    "sync.lanes": {"heights", "lanes"},
    "sync.quorum": {"heights"},
}


def _host_recovery(z, r, s, v):
    from test_torch_mesh import _host_recover

    return _host_recover(z, r, s, v)


class _WireCluster(Cluster):
    """The cluster with every delivery decoded from the sender's bytes."""

    def gossip(self, sender, message):
        raw = message.encode()
        loop = asyncio.get_running_loop()
        for j, (_, ingress) in list(self.nodes.items()):
            if j not in self.offline:
                loop.call_later(self.latency(j, sender), lambda ingress=ingress: ingress.submit(IbftMessage.decode(raw)))


class _CountingClock:
    """The trace module's ``time``: counts the clock reads it serves."""

    def __init__(self):
        import time

        self.reads = 0
        self._real = time

    def perf_counter_ns(self):
        self.reads += 1
        return self._real.perf_counter_ns()


def _run(tmp_path, traced: bool):
    """One live height and one catch-up of it; returns the records and the
    trace module's clock reads."""
    clock = _CountingClock()
    sched = TenantScheduler(route="device", torch_device="cpu").start()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ecrecover, "recover", _host_recovery)
        mp.setattr(trace, "time", clock)
        rec = trace.enable(1 << 16) if traced else None
        try:
            async def body():
                def verifier(i, src):
                    return sched.register("node0", src) if i == 0 else HostBatchVerifier(src)

                cluster = _WireCluster(PORT, tmp_path, verifier=verifier)
                for _, ingress in cluster.nodes.values():
                    ingress.eager_cutover = 1  # every flow takes the timed window
                await cluster.run(HEIGHTS)
                return cluster

            cluster = asyncio.run(body())
            client = SyncClient(b"\xee" * 20, cluster.net, HostBatchVerifier(cluster.src), cluster.src)
            blocks = client.catch_up(1, HEIGHTS)
            assert [b.height for b in blocks] == list(range(1, HEIGHTS + 1))
        finally:
            trace.disable()
            sched.stop()
    assert sched.dispatches > 0 and sched._dispatcher.routes["device"] == sched.dispatches
    return (rec.snapshot() if rec is not None else None), clock.reads


@pytest.fixture(scope="module")
def traced(tmp_path_factory):
    records, _ = _run(tmp_path_factory.mktemp("traced"), True)
    return records


@pytest.mark.parametrize("name", sorted({**LIVE_SPANS, **SYNC_SPANS}))
def test_each_new_span_is_recorded_with_its_args(traced, name):
    want = {**LIVE_SPANS, **SYNC_SPANS}[name]
    spans = [r for r in traced if r[1] == name]
    assert spans and all(r[0] == "X" and r[4] >= 0 for r in spans)
    for r in spans:
        assert set(r[5] or ()) == want, r
    if name == "engine.send":
        assert {r[5]["type"] for r in spans} >= {"PREPREPARE", "PREPARE", "COMMIT"}
    if name == "wal.fsync":
        assert {r[5]["kind"] for r in spans} == {"lock", "finalize"}
    if name == "sched.window":
        assert {r[5]["why"] for r in spans} <= {"full", "aged", "stop"}


def test_the_windows_carry_what_the_calibrate_instants_carried(traced):
    """No ``ingress.calibrate`` instant is left; the window spans carry its
    chosen window and the scheduler's measured rate."""
    assert not [r for r in traced if r[1] == "ingress.calibrate"]
    windows = [r[5] for r in traced if r[1] in ("ingress.window", "sched.window")]
    assert windows and all("window_us" in a for a in windows)
    sched = [a for a in windows if "why" in a]
    assert any(a["window_us"] is not None and a["rate_per_s"] is not None for a in sched)


def test_the_pack_and_card_spans_nest_in_their_dispatch(traced):
    """Each flush's ``sched.pack`` ends where its ``sched.card`` starts, both
    inside the ``sched.dispatch`` span, which keeps its args."""
    dispatches = [r for r in traced if r[1] == "sched.dispatch"]
    assert dispatches and all(set(r[5]) == {"route", "lanes", "senders", "seals"} for r in dispatches)
    packs = sorted((r[3], r[3] + r[4]) for r in traced if r[1] == "sched.pack")
    cards = sorted((r[3], r[3] + r[4]) for r in traced if r[1] == "sched.card")
    assert len(packs) == len(cards) and [p[1] for p in packs] == [c[0] for c in cards]
    for a, b in itertools.chain(packs, cards):
        assert any(d[3] <= a and b <= d[3] + d[4] for d in dispatches)


def test_tracing_off_records_nothing_and_reads_no_clock(tmp_path):
    records, reads = _run(tmp_path, False)
    assert records is None and trace.recorder() is None and reads == 0


def test_complete_keeps_its_start_on_the_spans_clock(monkeypatch):
    """``complete`` records the start it was handed and ends on the clock
    ``span`` reads; its end is returned for a span that follows."""

    class Ticks:
        def __init__(self):
            self._t = itertools.count(5_000_000, 3_000)

        def perf_counter_ns(self):
            return next(self._t)

    monkeypatch.setattr(trace, "time", Ticks())
    rec = trace.enable()
    try:
        t0 = trace.now_us()
        with trace.span("inner"):
            pass
        end = trace.complete("outer", t0, track="node", k=1)
    finally:
        trace.disable()
    assert rec.snapshot() == [("X", "inner", "MainThread", 5_003, 3, None), ("X", "outer", "node", 5_000, 9, {"k": 1})]
    assert (t0, end) == (5_000, 5_009)


def test_complete_and_now_us_do_nothing_while_tracing_is_off(monkeypatch):
    class NoClock:
        def perf_counter_ns(self):
            raise AssertionError("the clock was read with tracing off")

    monkeypatch.setattr(trace, "time", NoClock())
    trace.disable()
    assert trace.now_us() is None
    assert trace.complete("x", 1, lanes=2) is None
    assert trace.recorder() is None


@pytest.mark.parametrize("traced", [False, True], ids=["untraced", "traced"])
def test_wal_fsync_span_leaves_the_append_histogram_whole(tmp_path, traced):
    """The ``wal.fsync`` span beside the ``/metrics`` histogram of the whole
    append: each fsynced append (lock, finalize) is one sample of
    ``wal_append_ms`` in milliseconds, whether tracing is on or off."""
    from go_ibft_tpu_torch.chain.wal import WAL_APPEND_MS_KEY, WriteAheadLog
    from go_ibft_tpu_torch.messages.wire import Proposal
    from go_ibft_tpu_torch.utils import metrics

    metrics.reset()
    metrics.enable_fixed_histograms()
    rec = trace.enable() if traced else None
    try:
        wal = WriteAheadLog(str(tmp_path / "wal.jsonl"))
        wal.append_lock(1, 0, None)
        wal.append_finalize(1, Proposal(raw_proposal=b"block", round=0), [])
        wal.close()
        hist = metrics.fixed_histograms_snapshot()[tuple(WAL_APPEND_MS_KEY)]
    finally:
        trace.disable()
        metrics.disable_fixed_histograms()
        metrics.reset()
    assert hist["count"] == 2 and sum(hist["counts"]) == 2
    assert 0 <= hist["sum"] < 60_000
    if traced:
        assert [r[5]["kind"] for r in rec.snapshot() if r[1] == "wal.fsync"] == ["lock", "finalize"]


def test_sender_uploads_all_precede_the_digest_launch(monkeypatch):
    """The split the dispatcher's ``sched.pack`` ends at: every upload of
    ``upload_sender_lanes`` (an oversize PREPREPARE's host digest included)
    before ``launch_sender_digest_rows``' digest launch, and the same device
    tensors as ``pack_sender_digest_rows`` in one sequence."""
    from go_ibft_tpu_torch.bench.workload import build_signed_round
    from go_ibft_tpu_torch.crypto import PrivateKey
    from go_ibft_tpu_torch.crypto.backend import ECDSABackend
    from go_ibft_tpu_torch.messages.wire import View
    from go_ibft_tpu_torch.ops import quorum
    from go_ibft_tpu_torch.verify import batch as tb

    keys = [PrivateKey.from_seed(b"bench-11-%d" % i) for i in range(4)]
    src = ECDSABackend.static_validators({k.address: 1 for k in keys})
    big = ECDSABackend(keys[0], src).build_preprepare_message(b"\x5a" * 5000, None, View(height=1, round=0))
    msgs = build_signed_round(4, seed=11).prepares + [big]
    packed = tb.pack_sender_lanes(msgs)
    assert packed.big
    events = []
    digest_words = quorum.digest_words

    def launch(*a, **kw):
        events.append("launch")
        return digest_words(*a, **kw)

    def upload(name, a):
        events.append(name)
        return torch.from_numpy(tb._as_signed(a))

    monkeypatch.setattr(quorum, "digest_words", launch)
    split = tb.launch_sender_digest_rows(packed, tb.upload_sender_lanes(packed, upload))
    assert events[-1] == "launch" and sorted(events[:-1]) == sorted(tb._SENDER_UPLOADS + ("big_zw",))
    whole = tb.pack_sender_digest_rows(packed, upload)
    assert len(split) == len(whole) == 6 and all(torch.equal(a, b) for a, b in zip(split, whole))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_recoveries_on_card_lie_inside_their_flush_card_span(cuda_device):
    """A few flushes of the card's dispatcher (envelopes, seals, both) under
    ``portbench.harness.devtrace.DeviceProfile``: every ``secp256k1_recover``
    kernel starts and ends inside the ``sched.card`` span of its flush,
    within 50 µs, on the recorder's clock."""
    from go_ibft_tpu_torch.bench.workload import build_signed_round
    from go_ibft_tpu_torch.sched.dispatch import CoalescedDispatcher
    from portbench.harness.devtrace import DeviceProfile

    dispatcher = CoalescedDispatcher("device", torch_device=cuda_device)
    dispatcher.warmup(lanes=(128,), table_rows=128)
    w = build_signed_round(100, seed=20, corrupt_frac=0.1)
    lanes = [(w.proposal_hash, seal) for seal in w.seals]
    flushes = [(w.prepares, []), ([], lanes), (w.prepares, lanes)] * 2
    dispatcher.dispatch(*flushes[2])
    # The profile puts the card's times on the host's clock by its first
    # kernel, a ``torch.cuda._sleep``: the first such launch in a process
    # loads its module and starts some 0.3 ms late, which would show every
    # kernel that much early.  Launched once here, the mark starts on time.
    torch.cuda._sleep(1000)
    torch.cuda.synchronize()
    rec = trace.enable()
    profile = DeviceProfile()
    profile.start()
    try:
        for msgs, seal_lanes in flushes:
            dispatcher.dispatch(msgs, seal_lanes)
    finally:
        profile.stop()
        trace.disable()
    cards = [(r[3], r[3] + r[4]) for r in rec.snapshot() if r[1] == "sched.card"]
    kernels = [(a, b) for name, a, b in profile.events() if "secp256k1_recover" in name]
    offsets = []  # how far each kernel reaches outside the nearest sched.card span
    for a, b in kernels:
        lo, hi = min(cards, key=lambda c: max(c[0] - a, 0) + max(b - c[1], 0))
        offsets.append(max(lo - a, b - hi))
    print(f"{len(kernels)} recovery kernels, {len(cards)} sched.card spans; the farthest kernel lies "
          f"{max(offsets, default=float('nan')):.3f} us outside its span (negative: inside by that margin); "
          f"offsets {np.round(offsets, 3).tolist()}")
    assert len(cards) == 8 and 0 < len(kernels) <= len(cards)
    assert max(offsets) <= 50.0
