"""The deployable validator process (the port of the JAX package's
``node/node.py``).

:class:`ValidatorNode` composes every layer this repo has grown into ONE
process behind ONE config file:

* consensus   — ``core.IBFT`` + ``crypto.ECDSABackend`` gossiping over
  real TCP sockets (``net.GrpcTransport`` with peer reconnect), ingress
  batched through ``core.BatchingIngress``;
* persistence — ``chain.ChainRunner`` + ``chain.WriteAheadLog`` in
  ``data_dir``; boot always runs ``recover()`` (an empty WAL replays to
  genesis), so a restart resumes mid-round locks instead of
  double-signing;
* QoS         — one ``sched.TenantScheduler`` with the chain on the
  ``consensus`` tier and proof serving on the ``read`` tier, so client
  floods shed before a live round starves;
* serving     — ``serve.ProofServer`` exposed to untrusted clients over
  the :mod:`proof_api` wire transport;
* telemetry   — ``obs.httpd.TelemetryServer`` with /metrics, /healthz
  (liveness), /readyz (readiness: recovered + first height finalized),
  /statusz (scheduler + proof-API stats mounted);
* drain       — SIGTERM/SIGINT runs one graceful shutdown: stop taking
  proof clients, stop the height loop, stop the scheduler, fsync+close
  the WAL, export the per-node trace file, close the gossip listener.
  The trace export is what ``scripts/consensus_timeline.py`` merges
  into the cross-process timeline.

Lifecycle (the __main__ entry drives this)::

    node = ValidatorNode(load_config("node.toml"))
    report = asyncio.run(node.run())   # returns the drain report dict

Differences from the JAX file.  Verification runs where ``[sched] route``
and ``[sched] device`` say, by default the card (the JAX package's default
was the host route): the scheduler's device route, warmed (kernels built
and launched once) before ``/readyz``; with ``[sched] enabled = false`` a
:class:`~go_ibft_tpu_torch.verify.DeviceBatchVerifier` on that device,
unless the route is ``"host"``; and the proof server's own verifier on the
same device.  On the card a fault propagates (the scheduler's card rule):
it ends the height loop and the process, and nothing falls back to the
host.  ``/statusz``'s scheduler block and the drain report's also carry the
dispatcher's ``routes`` (flushes served by the host and by the device), and
``/profilez`` profiles the configured device.  The drain drops gossip
arriving once the height loop is cancelled, before the scheduler stops (on
the card a verify after the stop would be a refusal).  Before its first
round the node waits until every peer's gossip port accepts a connection (at
most three round-0 timeouts): building and launching the kernels at boot
spreads the processes' start over seconds, and a node that starts two
heights behind its peers never catches up (the node runs no block sync, in
either package; the JAX package's host-route nodes boot close enough
together not to meet it).
"""

from __future__ import annotations

import asyncio
import os
import signal
import time
from typing import Optional

from ..chain import ChainRunner, WriteAheadLog
from ..core import IBFT, BatchingIngress
from ..crypto import PrivateKey
from ..crypto.backend import ECDSABackend
from ..net import GrpcTransport
from ..obs import trace
from ..utils import metrics
from ..verify import HostBatchVerifier
from ..verify.batch import on_card
from .config import NodeConfig, NodeConfigError
from .proof_api import ProofApiServer

__all__ = ["ValidatorNode", "build_block_fn"]


class _NullLogger:
    def info(self, *a):
        pass

    debug = info

    def error(self, msg, *args):
        import sys

        print(f"[node error] {msg} {args}", file=sys.stderr, flush=True)


def build_block_fn(node_id: int):
    """The node's block builder: deterministic bytes per height.

    Every validator must build the IDENTICAL proposal for a height (the
    reference's ``Backend.BuildProposal`` determinism assumption in this
    payload-free reproduction), so the builder keys on the height alone —
    ``node_id`` rides along only for error messages."""
    del node_id

    def build(view) -> bytes:
        return b"fleet block %d" % view.height

    return build


class ValidatorNode:
    """One validator process: see the module docstring.

    Construction wires everything but opens no sockets; :meth:`run`
    owns the lifecycle.  ``install_signal_handlers=False`` lets tests
    embed a node in a process that keeps its own handlers.
    """

    def __init__(
        self,
        config: NodeConfig,
        *,
        logger=None,
        install_signal_handlers: bool = True,
    ) -> None:
        config.validate()
        self.config = config
        self._log = logger or _NullLogger()
        self._install_signals = install_signal_handlers
        os.makedirs(config.data_dir, exist_ok=True)

        if config.trace.enabled:
            trace.enable(config.trace.ring)

        # -- identity + validator set --------------------------------
        self.key = PrivateKey.from_seed(config.key_seed_bytes)
        powers = config.validator_powers()
        if self.key.address not in powers:
            raise NodeConfigError(
                f"node address {self.key.address.hex()} (from key_seed) is "
                f"not in [validators] — this process would gossip into a "
                f"committee that never counts it"
            )
        self.validators_src = ECDSABackend.static_validators(powers)

        # -- QoS scheduler -------------------------------------------
        self.scheduler = None
        self._verifier = None
        on_device = config.sched_route != "host"
        if config.sched_enabled:
            from ..sched import TenantScheduler

            # Route per config (the card by default).  The device route's
            # kernels are built and launched once at boot (below), never
            # on a first flush mid-round.
            self.scheduler = TenantScheduler(
                route=config.sched_route, torch_device=config.torch_device
            )
            batch_verifier = self.scheduler.register(
                f"node{config.node_id}/consensus",
                self.validators_src,
                chain_id=f"node{config.node_id}",
            )
        elif on_device:
            from ..verify import DeviceBatchVerifier

            batch_verifier = self._verifier = DeviceBatchVerifier(
                self.validators_src, device=config.torch_device
            )
        else:
            batch_verifier = HostBatchVerifier(self.validators_src)

        # -- engine + transport --------------------------------------
        backend = ECDSABackend(
            self.key,
            self.validators_src,
            build_proposal_fn=build_block_fn(config.node_id),
        )
        self.engine = IBFT(
            self._log, backend, None, batch_verifier=batch_verifier
        )
        self.engine.set_base_round_timeout(config.consensus.base_round_timeout_s)
        self.ingress = BatchingIngress(self.engine.add_messages)
        self.transport = GrpcTransport(
            config.consensus.listen,
            config.consensus.peers,
            self._deliver_gossip,
            logger=self._log,
            node=self.engine._obs_track,
            reconnect_after=config.consensus.reconnect_after,
        )
        self.engine.transport = self.transport

        # -- chain + WAL ---------------------------------------------
        self.wal_path = os.path.join(config.data_dir, "wal.jsonl")
        self.runner = ChainRunner(
            self.engine,
            WriteAheadLog(self.wal_path),
            overlap=False,  # single-chain node: overlap buys nothing here
        )

        # -- serve plane ---------------------------------------------
        self.proof_api: Optional[ProofApiServer] = None
        self._proof_server = None
        if config.proof_api.listen:
            from ..serve import ProofBuilder, ProofCache, ProofServer

            host, _, port = config.proof_api.listen.rpartition(":")
            self._proof_server = ProofServer(
                ProofBuilder(self.runner, self.runner.validators_for_height),
                ProofCache(),
                scheduler=self.scheduler,
                max_proof_heights=config.proof_api.max_proof_heights,
                device=on_device,
                torch_device=config.torch_device,
            )
            self.proof_api = ProofApiServer(
                self._proof_server,
                self.runner.latest_height,
                host=host or "127.0.0.1",
                port=int(port),
                max_connections=config.proof_api.max_connections,
                max_request_bytes=config.proof_api.max_request_bytes,
                header_timeout_s=config.proof_api.header_timeout_s,
                idle_timeout_s=config.proof_api.idle_timeout_s,
                workers=config.proof_api.workers,
                ready_fn=self.runner.telemetry_ready,
            )

        self.telemetry = None
        self._drained = False
        self._started_at = time.monotonic()

    # -- lifecycle ------------------------------------------------------

    async def run(self) -> dict:
        """Boot, serve, run the chain, drain; returns the drain report."""
        cfg = self.config
        loop = asyncio.get_running_loop()
        stop_requested = asyncio.Event()
        if self._install_signals:
            for sig in (signal.SIGTERM, signal.SIGINT):
                loop.add_signal_handler(sig, stop_requested.set)

        if self.scheduler is not None:
            self.scheduler.start()
            if cfg.sched_route != "host":
                # Build and launch the device kernels NOW, while /readyz
                # is still 503 — never on the first flush mid-round.
                self.scheduler.warmup()
        elif self._verifier is not None:
            self._verifier.warmup()
        await self.transport.start()
        bound_consensus = self.transport.bound_port

        # Recover BEFORE anything is routable: /readyz stays 503 until
        # this returns (the supervisor contract).
        resumed_at = self.runner.recover()

        if cfg.telemetry.listen:
            host, _, port = cfg.telemetry.listen.rpartition(":")
            extra = {}
            if self.scheduler is not None:
                extra["sched"] = self._sched_status
            if self.proof_api is not None:
                extra["proof_api"] = self.proof_api.stats
            self.telemetry = self.runner.start_telemetry(
                port=int(port),
                host=host or "127.0.0.1",
                wedged_after_s=cfg.telemetry.wedged_after_s or None,
                extra_status=extra,
                profile_device=cfg.torch_device,
            )
        if self.proof_api is not None:
            self.proof_api.start()

        self._emit_boot_line(bound_consensus, resumed_at)
        await self._wait_for_peers(3 * cfg.consensus.base_round_timeout_s)

        # On the card a drain's fault raised in a loop callback (an ingress
        # flush) ends the node with it; asyncio would only log it, and the
        # height would wait out its round timeouts for ever.  Only a
        # callback's exception while the chain runs counts (a task's
        # unretrieved exception at shutdown is the transport's, and is
        # logged as before).
        faults: list = []
        running = [True]
        if on_card(self.engine.batch_verifier):

            def on_error(_loop, context):
                err = context.get("exception")
                if err is None or "handle" not in context or not running[0]:
                    _loop.default_exception_handler(context)
                    return
                faults.append(err)
                stop_requested.set()

            loop.set_exception_handler(on_error)

        chain_task = asyncio.create_task(
            self.runner.run(
                until_height=cfg.heights if cfg.heights > 0 else None
            ),
            name="node-chain",
        )
        stop_task = asyncio.create_task(
            stop_requested.wait(), name="node-stop"
        )
        try:
            done, _pending = await asyncio.wait(
                {chain_task, stop_task},
                return_when=asyncio.FIRST_COMPLETED,
            )
            if chain_task in done:
                chain_task.result()  # surface a crashed height loop
        finally:
            running[0] = False
            stop_task.cancel()
            report = await self._drain(chain_task)
            loop.set_exception_handler(None)
        if faults:
            raise faults[0]
        return report

    def _deliver_gossip(self, message) -> None:
        """Inbound gossip (and self-delivery) to the ingress, until the drain
        starts."""
        if not self._drained:
            self.ingress.submit(message)

    async def _wait_for_peers(self, timeout_s: float) -> None:
        """Hold the first round until every peer's gossip port accepts a
        connection, for at most ``timeout_s`` (see the module docstring)."""
        loop = asyncio.get_running_loop()
        t0 = loop.time()
        pending = dict(self.config.consensus.peers)
        while pending and loop.time() - t0 < timeout_s:
            for name, target in list(pending.items()):
                host, _, port = target.rpartition(":")
                try:
                    _reader, writer = await asyncio.wait_for(
                        asyncio.open_connection(host or "127.0.0.1", int(port)), 1.0
                    )
                except (OSError, asyncio.TimeoutError):
                    continue
                writer.close()
                del pending[name]
            if pending:
                await asyncio.sleep(0.05)
        trace.instant(
            "node.peers_up",
            waited_ms=round((loop.time() - t0) * 1e3, 1),
            missing=sorted(pending),
        )

    async def _drain(self, chain_task: Optional[asyncio.Task]) -> dict:
        """Graceful shutdown, in dependency order (see module docstring)."""
        if self._drained:
            return {}
        self._drained = True
        cfg = self.config
        # 1. Stop taking new proof clients (drop the fleet first: nothing
        # downstream depends on them).
        if self.proof_api is not None:
            self.proof_api.stop()
        # 2. Stop the height loop; in-flight WAL appends complete under
        # the WAL lock before close().
        if chain_task is not None and not chain_task.done():
            chain_task.cancel()
            await asyncio.gather(chain_task, return_exceptions=True)
        # Gossip that still arrives has no height loop to serve: drop it
        # before the scheduler stops (on the card a verify after the stop is
        # a refusal that raises).
        self.ingress.close()
        # 3. Scheduler: drain queued verification, stop the loop thread.
        if self.scheduler is not None:
            self.scheduler.stop()
        if self._proof_server is not None:
            self._proof_server.close()
        # 4. WAL: fsync + close — after this a SIGKILL loses nothing.
        if self.runner.wal is not None:
            self.runner.wal.close()
        # 5. Trace export for the cross-process timeline.
        trace_path = None
        trace_events = 0
        if cfg.trace.enabled:
            trace_path = os.path.join(
                cfg.data_dir, f"trace-node{cfg.node_id}.json"
            )
            try:
                trace_events = self.runner.export_trace(trace_path)
            except Exception as err:  # noqa: BLE001 - drain must finish
                self._log.error("trace export failed", err)
                trace_path = None
        # 6. Close listeners: gossip + telemetry go last so peers see our
        # final COMMITs and a supervisor can scrape the drain.
        await self.transport.stop()
        if self.telemetry is not None:
            self.runner.stop_telemetry()
        self.ingress.close()
        self.engine.messages.close()
        speculator = getattr(self.engine, "speculator", None)
        if speculator is not None:
            speculator.stop()
        report = self._report(trace_path, trace_events)
        return report

    # -- evidence -------------------------------------------------------

    def _sched_status(self) -> dict:
        """The scheduler's stats plus its dispatcher's route counts."""
        stats = self.scheduler.stats()
        stats["routes"] = dict(self.scheduler._dispatcher.routes)
        return stats

    def _emit_boot_line(self, consensus_port, resumed_at: int) -> None:
        """One JSON line on stdout the harness parses for bound ports."""
        import json

        line = {
            "node_boot": self.config.node_id,
            "address": self.key.address.hex(),
            "consensus_port": consensus_port,
            "proof_api_port": (
                self.proof_api.port if self.proof_api is not None else None
            ),
            "telemetry_port": (
                self.telemetry.port if self.telemetry is not None else None
            ),
            "resumed_at_height": resumed_at,
        }
        print(json.dumps(line), flush=True)

    def _report(self, trace_path, trace_events: int) -> dict:
        stats = self.runner.stats()
        return {
            "node": self.config.node_id,
            "address": self.key.address.hex(),
            "chain_height": self.runner.latest_height(),
            "heights_run": stats["heights_run"],
            "wal_path": self.wal_path,
            "trace_path": trace_path,
            "trace_events": trace_events,
            "proof_api": (
                self.proof_api.stats() if self.proof_api is not None else None
            ),
            "sched": (
                self._sched_status() if self.scheduler is not None else None
            ),
            "send_failures": metrics.get_counter(
                ("go-ibft", "transport", "send_failures")
            ),
            "peer_reconnects": metrics.get_counter(
                ("go-ibft", "transport", "peer_reconnects")
            ),
            "uptime_s": round(time.monotonic() - self._started_at, 3),
        }
