"""The ``live`` generator: one validator's stack finalizing heights back to back.

The stack is what ``go_ibft_tpu_torch/node/node.py`` builds with its
defaults, gossip delivered in-process instead of over gRPC:

* a ``TenantScheduler`` on the card (``route="device"``) with the consensus
  tenant registered, its kernels built and launched at boot (``warmup``);
* ``IBFT`` with the tenant's verifier, fed through a ``BatchingIngress``;
* a ``ChainRunner`` over a ``WriteAheadLog`` (fsync on finalize), with
  ``overlap=False``, recovered before its first height.

The validator under test proposes no height of the pool.  Each height's
messages arrive as wire bytes, decoded by the program's codec as its gRPC
transport decodes a peer's, in go-ibft's order: the PREPREPARE, every
PREPARE, every COMMIT, the validator's own included (signing is
deterministic, so they are the bytes its engine signs; what the engine
multicasts is dropped).  The loop is closed: a height's PREPREPARE is
delivered once the runner has started the height, which it does after it
persisted the last one.

The pool is replayed: each pass over it gets a fresh engine, runner, log and
tenant registration, so no verdict carries from one pass to the next; the
restarts are timed inside the window.  The window closes at the first height
finalized after ``seconds``.

What a crash would keep is recorded too: while a cell lives, ``os.fsync``
and ``os.fdatasync`` are wrapped (:class:`_Synced`) so that the bytes of the
log made durable are known when the runner hands a height on and when the
engine sends its COMMIT; the judgement reads the log as a crash of the
machine would leave it.
"""

from __future__ import annotations

import asyncio
import os
import shutil
import tempfile
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from ..harness import pool as pools
from ..harness import proxies

# The node's default base round timeout, and how long a height may take
# before the run counts it stalled; a mix may set either.
ROUND_TIMEOUT_S = 10.0
HEIGHT_TIMEOUT_S = 60.0


class _Log:
    """The engine's logger: errors are kept and shown on stderr."""

    def __init__(self) -> None:
        self.errors: List[str] = []

    def info(self, *args) -> None:
        pass

    debug = info

    def error(self, msg, *args) -> None:
        self.errors.append(f"{msg} {args}")


class _Dropped:
    """The engine's transport: its own messages come with the traffic, and
    are only shown to ``on_send``."""

    def __init__(self) -> None:
        self.on_send = None

    def multicast(self, message) -> None:
        if self.on_send is not None:
            self.on_send(message)


class _Synced:
    """The bytes of each file that an ``os.fsync`` or ``os.fdatasync`` made
    durable, by (device, inode), while installed: what a crash of the
    machine would keep of it."""

    def __init__(self) -> None:
        self.bytes: Dict[tuple, int] = {}
        self._real = None

    def _wrap(self, real):
        def synced(fd):
            real(fd)
            st = os.fstat(fd)
            self.bytes[(st.st_dev, st.st_ino)] = st.st_size

        return synced

    def install(self) -> None:
        self._real = (os.fsync, os.fdatasync)
        os.fsync, os.fdatasync = self._wrap(self._real[0]), self._wrap(self._real[1])

    def uninstall(self) -> None:
        if self._real is not None:
            os.fsync, os.fdatasync = self._real
            self._real = None

    def of(self, path: str) -> int:
        st = os.stat(path)
        return self.bytes.get((st.st_dev, st.st_ino), 0)


@dataclass
class Height:
    height: int
    pass_no: int
    submitted_us: float
    finalized_us: float


@dataclass
class Finalized:
    pass_no: int
    height: int
    raw: bytes
    round: int
    seals: List[tuple]
    synced: int  # the log's durable bytes when the runner handed the height on


@dataclass
class LiveWindow:
    start_us: float
    end_us: float
    heights: List[Height] = field(default_factory=list)
    attempted: int = 0
    stalled: int = 0
    passes: int = 0
    finalized: List[Finalized] = field(default_factory=list)
    wal_paths: Dict[int, str] = field(default_factory=dict)
    # (pass, height) -> the log's durable bytes when the engine sent its COMMIT
    commit_synced: Dict[tuple, int] = field(default_factory=dict)
    errors: List[str] = field(default_factory=list)


class LiveCell:
    """Set-up, window and teardown of one live run."""

    def __init__(self, config: dict, mix: dict, seed: int, device, fault: Optional[str] = None,
                 threads: int = 8) -> None:
        self.config, self.mix, self.seed, self.device, self.fault = config, mix, seed, device, fault
        n = int(config["validators"])
        self.pool = pools.live_pool(
            n, int(config.get("byzantine", 0)), seed, int(mix["pool_heights"]),
            int(config["proposal_bytes"]), threads)
        self._tmp = tempfile.mkdtemp(prefix="portbench-wal-")
        self._synced = _Synced()
        self._build_stack()
        self._synced.install()

    # -- the validator's stack -------------------------------------------

    def _build_stack(self) -> None:
        from go_ibft_tpu_torch.crypto import PrivateKey
        from go_ibft_tpu_torch.crypto.backend import ECDSABackend
        from go_ibft_tpu_torch.sched import TenantScheduler
        from go_ibft_tpu_torch.sched.dispatch import CoalescedDispatcher

        committee = self.pool.committee
        self.key = PrivateKey.from_seed(b"bench-%d-%d" % (self.seed, self.pool.me))
        if self.key.address != committee.addresses[self.pool.me]:
            raise RuntimeError("the program's key for the validator under test differs from the traffic's")
        self.src = ECDSABackend.static_validators(committee.powers)
        # The node's scheduler: TenantScheduler(route, torch_device), whose
        # dispatcher is CoalescedDispatcher(route, torch_device=...); built
        # here so that the benchmark can record its flushes.
        self.dispatcher = proxies.RecordingDispatcher(
            CoalescedDispatcher("device", torch_device=self.device), self.fault)
        self.scheduler = TenantScheduler(route="device", torch_device=self.device, dispatcher=self.dispatcher)
        self.scheduler.start()
        self.scheduler.warmup()
        self.verifiers: List[proxies.RecordingVerifier] = []

    def _stack(self, pass_no: int):
        from go_ibft_tpu_torch.chain import ChainRunner, WriteAheadLog
        from go_ibft_tpu_torch.core import IBFT, BatchingIngress
        from go_ibft_tpu_torch.crypto.backend import ECDSABackend

        tid = f"node0/consensus/{pass_no}"
        handle = self.scheduler.register(tid, self.src, chain_id="node0")
        verifier = proxies.RecordingVerifier(handle, pass_no=pass_no, skip_seals=self.fault == "skip_verify")
        self.verifiers.append(verifier)
        log = _Log()
        backend = ECDSABackend(self.key, self.src, build_proposal_fn=lambda view: b"")
        transport = _Dropped()
        engine = IBFT(log, backend, transport, batch_verifier=verifier)
        engine.set_base_round_timeout(float(self.mix.get("round_timeout_s", ROUND_TIMEOUT_S)))
        ingress = BatchingIngress(engine.add_messages)
        path = os.path.join(self._tmp, f"wal-{pass_no}.jsonl")
        wal = WriteAheadLog(path)
        if self.fault == "skip_wal":
            wal.append_finalize = lambda *a, **k: None
        if self.fault == "no_fsync":
            append = wal._append
            wal._append = lambda record, fsync: append(record, fsync and record.get("kind") != "finalize")
        runner = ChainRunner(engine, wal, overlap=False)
        runner.recover()
        return tid, verifier, engine, ingress, wal, runner, log, path, transport

    # -- driving ------------------------------------------------------------

    async def _run_pass(self, pass_no: int, deadline_us: Optional[float], out: LiveWindow,
                        count: Optional[int] = None) -> bool:
        """Drive the pool's heights through a fresh stack; returns whether the
        pass ran to the pool's end (the window goes on)."""
        from go_ibft_tpu_torch.messages.wire import IbftMessage, MessageType

        tid, verifier, engine, ingress, wal, runner, log, path, transport = self._stack(pass_no)
        verifier.on = out is not None
        self.dispatcher.tag = pass_no
        if out is not None:
            out.wal_paths[pass_no] = path
            out.passes += 1
        loop = asyncio.get_running_loop()
        finals: Dict[int, asyncio.Future] = {}
        persist = engine.on_finalize  # the runner's: the log's fsynced append

        def on_send(message):
            if out is not None and message.type == MessageType.COMMIT and message.view is not None:
                out.commit_synced.setdefault((pass_no, message.view.height), self._synced.of(path))

        transport.on_send = on_send

        def on_finalize(height, proposal, seals):
            if self.fault == "alter_block":
                raw = proposal.raw_proposal
                proposal = type(proposal)(raw_proposal=raw[:-1] + bytes([raw[-1] ^ 1]), round=proposal.round)
            persist(height, proposal, seals)
            t = time.perf_counter_ns() / 1e3
            if out is not None:
                out.finalized.append(Finalized(pass_no, height, proposal.raw_proposal, proposal.round,
                                               [(s.signer, s.signature) for s in seals], self._synced.of(path)))
            fut = finals.get(height)
            if fut is not None and not fut.done():
                fut.set_result(t)

        engine.on_finalize = on_finalize
        errors: List[BaseException] = []

        def on_error(_loop, context):
            errors.append(context.get("exception") or RuntimeError(context["message"]))
            for fut in finals.values():
                if not fut.done():
                    fut.cancel()

        loop.set_exception_handler(on_error)
        runner_task = asyncio.create_task(runner.run())
        height_timeout = float(self.mix.get("height_timeout_s", HEIGHT_TIMEOUT_S))
        completed = True
        try:
            for k, hp in enumerate(self.pool.heights):
                if count is not None and k >= count:
                    break
                h = hp.height
                spins = 0
                while engine.state.height != h and not runner_task.done():
                    spins += 1
                    await asyncio.sleep(0 if spins < 1000 else 1e-4)
                if runner_task.done():
                    runner_task.result()
                    raise RuntimeError(f"the runner stopped before height {h}")
                finals[h] = loop.create_future()
                if out is not None:
                    out.attempted += 1
                t0 = time.perf_counter_ns() / 1e3
                ingress.submit(IbftMessage.decode(hp.preprepare))
                await asyncio.sleep(0)
                for raw in hp.prepares:
                    ingress.submit(IbftMessage.decode(raw))
                await asyncio.sleep(0)
                for raw in hp.commits:
                    ingress.submit(IbftMessage.decode(raw))
                done, _ = await asyncio.wait({finals[h], runner_task}, timeout=height_timeout,
                                             return_when=asyncio.FIRST_COMPLETED)
                if errors:
                    raise errors[0]
                if finals[h] not in done or finals[h].cancelled():
                    if runner_task in done:
                        runner_task.result()
                    if out is not None:
                        out.stalled += 1
                        out.errors.append(f"pass {pass_no} height {h} did not finalize "
                                          f"within {height_timeout} s; engine log: {log.errors[-3:]}")
                    return False
                t1 = finals[h].result()
                if out is not None:
                    out.heights.append(Height(h, pass_no, t0, t1))
                if deadline_us is not None and t1 >= deadline_us:
                    completed = False
                    break
            return completed
        finally:
            runner_task.cancel()
            results = await asyncio.gather(runner_task, return_exceptions=True)
            loop.set_exception_handler(None)
            ingress.close()
            wal.close()
            verifier.on = False
            self.scheduler.unregister(tid)
            if out is not None:
                out.errors.extend(log.errors)
            fault = results[0]
            if isinstance(fault, BaseException) and not isinstance(fault, asyncio.CancelledError):
                raise fault

    def warm(self) -> None:
        """The cell's own shapes, before the window: the mix's
        ``warm_heights`` heights of the pool through a stack of their own."""
        asyncio.run(self._run_pass(-1, None, None, count=int(self.mix["warm_heights"])))

    def window(self, seconds: float, on_start=None) -> LiveWindow:
        async def drive() -> LiveWindow:
            if on_start is not None:
                on_start()
            self.dispatcher.on = True
            start = time.perf_counter_ns() / 1e3
            out = LiveWindow(start, start)
            deadline = start + seconds * 1e6
            pass_no = 0
            try:
                while await self._run_pass(pass_no, deadline, out):
                    pass_no += 1
                    if time.perf_counter_ns() / 1e3 >= deadline:
                        break
            finally:
                self.dispatcher.on = False
                out.end_us = time.perf_counter_ns() / 1e3
            return out

        return asyncio.run(drive())

    def close(self) -> None:
        self._synced.uninstall()
        self.scheduler.stop()

    def cleanup(self) -> None:
        shutil.rmtree(self._tmp, ignore_errors=True)

    # -- the judgement ---------------------------------------------------------

    def host_routes(self) -> int:
        return int(self.dispatcher.routes.get("host", 0))

    def window_lanes(self) -> List[tuple]:
        """``(signed bytes, signature)`` of every lane that the window's
        flushes took to the card (``None`` for bytes the traffic never
        signed)."""
        lanes = self.pool.lanes
        return [(lanes[s].signed if s in lanes else None, s)
                for _tag, senders, seals in self.dispatcher.log for s in (*senders, *seals)]

    def judge(self, win: LiveWindow, workers: int, on_card: bool):
        from ..harness.judge import judge_live

        return judge_live(self, win, workers)

    def describe(self, win: LiveWindow) -> str:
        restarts = [b.submitted_us - a.finalized_us for a, b in zip(win.heights, win.heights[1:])
                    if b.pass_no != a.pass_no]
        from go_ibft_tpu_torch.sched.dispatch import DISPATCH_MS_KEY
        from go_ibft_tpu_torch.sched.scheduler import DRAIN_MS_KEY
        from go_ibft_tpu_torch.utils import metrics

        def med(key):
            xs = sorted(metrics.get_histogram(key)[-1000:])
            return xs[len(xs) // 2] if xs else float("nan")

        took = sorted((h.finalized_us - h.submitted_us) / 1e3 for h in win.heights)
        q = [took[int(f * (len(took) - 1))] for f in (0.1, 0.5, 0.9, 1.0)] if took else []
        return (f"{len(win.heights)} heights in {win.passes} passes; restart between passes "
                f"{sum(restarts) / len(restarts) / 1e3 if restarts else 0:.2f} ms on average; "
                f"height ms p10/p50/p90/max {'/'.join(f'{x:.1f}' for x in q)}; "
                f"scheduler drain p50 {med(DRAIN_MS_KEY):.2f} ms, dispatch p50 {med(DISPATCH_MS_KEY):.2f} ms; "
                f"heights a 5 s: {self._buckets(win)}")

    @staticmethod
    def _buckets(win: LiveWindow) -> list:
        counts: Dict[int, int] = {}
        for h in win.heights:
            k = int((h.finalized_us - win.start_us) // 5e6)
            counts[k] = counts.get(k, 0) + 1
        return [counts.get(k, 0) for k in range(max(counts) + 1)] if counts else []

    def tally(self, win: LiveWindow, checks: dict):
        return win.attempted, min(win.attempted, win.stalled + checks["finalized_wrong"])


Cell = LiveCell


def read_wal(path: str):
    """The finalized blocks the log at ``path`` replays, as ``(height, raw,
    round, seals)``."""
    from go_ibft_tpu_torch.chain import WriteAheadLog

    state = WriteAheadLog(path).replay()
    return [(b.height, b.proposal.raw_proposal, b.proposal.round,
             [(s.signer, s.signature) for s in b.seals]) for b in state.blocks]

