"""gRPC multicast transport (the port of the JAX package's
``net/grpc_transport.py``).

Implements the reference's one-method ``Transport`` seam
(go-ibft core/transport.go:7-10) across hosts: ``multicast`` encodes the
message once with the framework's canonical wire codec
(:mod:`go_ibft_tpu_torch.messages.wire`) and fire-and-forgets it to every peer
over async gRPC; inbound bytes decode and land in the local engine's
ingress (``add_message`` or a :class:`~go_ibft_tpu_torch.core.transport.
BatchingIngress` for the batched device path).

No protoc codegen: the service is registered with generic bytes handlers
(the payload already IS a canonical protobuf-compatible encoding, so a
second serialization layer would only add bytes).  Self-delivery is
local (the reference expects nodes to receive their own messages,
core/transport.go:8-9) and never touches the network.

Fire-and-forget semantics match the reference: delivery failures are
logged and dropped — consensus liveness is the protocol's job (round
changes), not the transport's.  A failed send is retried
with jittered exponential backoff inside a bounded send deadline: a
transiently lossy link recovers without waiting a whole round change,
while the deadline keeps every retry sequence strictly shorter than the
round-0 timeout so the transport can never outlive the round semantics it
serves (``core/ibft.py::get_round_timeout``).

Differences from the JAX file: ``grpc`` is imported when a transport
starts (or adds a peer), not when this module is imported, so the node
and everything that imports :mod:`go_ibft_tpu_torch.net` load on a host
without the ``grpcio`` package; :meth:`GrpcTransport.start` raises there.
The bytes on the wire are the JAX package's (the same codec), so the two
packages' transports interoperate.
"""

from __future__ import annotations

import asyncio
import random
import time
from typing import Callable, Dict, Optional, Sequence

from ..core.ibft import DEFAULT_BASE_ROUND_TIMEOUT
from ..obs import clock, trace
from ..utils import metrics

from ..messages.wire import IbftMessage, decode_traced, encode_traced

_SERVICE = "goibft.Transport"
_METHOD = "Multicast"
_FULL_METHOD = f"/{_SERVICE}/{_METHOD}"

RETRY_KEY = ("go-ibft", "transport", "retries")
SEND_FAILURE_KEY = ("go-ibft", "transport", "send_failures")
PEER_RECONNECT_KEY = ("go-ibft", "transport", "peer_reconnects")


def _identity(b: bytes) -> bytes:
    return b


def _grpc():
    """The ``grpc`` module, imported at first use (see the module docstring)."""
    import grpc

    return grpc


class GrpcTransport:
    """Asyncio gRPC multicast between validator hosts.

    ``deliver`` receives decoded inbound messages (self-delivered ones
    included).  Call :meth:`start` before use and :meth:`stop` on
    shutdown.  ``peers`` maps peer name -> ``host:port`` target.
    """

    # Retry policy: total budget per (message, peer) send.  The deadline is
    # clamped strictly below the round-0 timeout — a send retried past the
    # round it belongs to is pure waste (the round change already
    # superseded it) and must never keep the event loop busy into the next
    # round's budget.
    MAX_SEND_DEADLINE_S = DEFAULT_BASE_ROUND_TIMEOUT * 0.5

    def __init__(
        self,
        listen_addr: str,
        peers: Dict[str, str],
        deliver: Callable[[IbftMessage], None],
        logger=None,
        *,
        send_deadline_s: float = 3.0,
        base_backoff_s: float = 0.05,
        per_attempt_timeout_s: float = 2.0,
        retry_seed: Optional[int] = None,
        node: Optional[str] = None,
        reconnect_after: int = 2,
    ) -> None:
        # Telemetry identity: the flight-recorder track inbound wire
        # events land on.  Pass the engine's node track (``node-<id>``)
        # for per-node timeline rows that match; without it, wire events
        # land on a ``net-<addr>`` diagnostics track AND the context is
        # left unmarked so the ENGINE still records the canonical
        # ``net.recv`` on its own track — the timeline tool only counts
        # recvs on consensus tracks, so the default never poisons the
        # quorum reconstruction.
        self._node_explicit = node is not None
        self.node = node or f"net-{listen_addr}"
        self._listen_addr = listen_addr
        self._peers = dict(peers)
        self._deliver = deliver
        self._log = logger
        self._server = None  # grpc.aio.Server once started
        self._channels: Dict[str, object] = {}  # name -> grpc.aio.Channel
        self._stubs: Dict[str, object] = {}  # name -> UnaryUnaryMultiCallable
        self._tasks: set = set()
        self.bound_port: Optional[int] = None
        self.send_deadline_s = min(send_deadline_s, self.MAX_SEND_DEADLINE_S)
        self.base_backoff_s = base_backoff_s
        self.per_attempt_timeout_s = per_attempt_timeout_s
        # Jitter stream: seedable so chaos tests replay exact backoff
        # sequences; unseeded production transports de-synchronize
        # naturally.
        self._jitter = random.Random(retry_seed)
        # Peer reconnect: a gRPC channel that watched its peer
        # restart can sit in TRANSIENT_FAILURE holding a dead subchannel
        # while the peer is already back on the same address.  After
        # ``reconnect_after`` consecutive exhausted send deadlines to one
        # peer the channel is torn down and recreated, so a restarted
        # validator rejoins the mesh within one send deadline instead of
        # riding gRPC's internal reconnect backoff ladder.
        self.reconnect_after = max(1, reconnect_after)
        self._fail_streak: Dict[str, int] = {}

    # -- lifecycle ------------------------------------------------------

    async def start(self) -> None:
        grpc = _grpc()
        server = grpc.aio.server()

        async def _handle(request: bytes, context) -> bytes:
            raw, ctx = decode_traced(request)
            try:
                message = IbftMessage.decode(raw)
            except Exception as err:  # noqa: BLE001 - malformed peer input
                if self._log:
                    self._log.error("grpc transport: undecodable message", err)
                return b""
            if ctx is not None:
                # Cross-process delivery: record the recv at the wire
                # boundary (the engine ingress skips contexts marked
                # recorded), attach the context for downstream consumers,
                # and feed the clock-offset estimator — send/recv pairs
                # are the only cross-host clock evidence that exists.
                recv_us = time.perf_counter_ns() // 1000
                clock.observe(ctx.origin, ctx.sent_us, recv_us)
                message.trace_ctx = ctx
                if trace.enabled():
                    trace.instant(
                        "net.recv",
                        track=self.node,
                        origin=ctx.origin,
                        height=ctx.height,
                        round=ctx.round,
                        type=int(message.type),
                        span=ctx.span_id,
                        sent_us=ctx.sent_us,
                        transport="grpc",
                    )
                    # Only suppress the engine's own record when this
                    # transport carries the engine's track: otherwise the
                    # canonical per-node recv would land on a ``net-*``
                    # diagnostics row and the timeline would see no
                    # arrivals at the node.
                    if self._node_explicit:
                        ctx.recorded = True
            self._deliver(message)
            return b""

        handler = grpc.method_handlers_generic_handler(
            _SERVICE,
            {
                _METHOD: grpc.unary_unary_rpc_method_handler(
                    _handle,
                    request_deserializer=_identity,
                    response_serializer=_identity,
                )
            },
        )
        server.add_generic_rpc_handlers((handler,))
        self.bound_port = server.add_insecure_port(self._listen_addr)
        await server.start()
        self._server = server
        for name, target in self._peers.items():
            channel = grpc.aio.insecure_channel(target)
            self._channels[name] = channel
            self._stubs[name] = channel.unary_unary(
                _FULL_METHOD,
                request_serializer=_identity,
                response_deserializer=_identity,
            )

    async def stop(self) -> None:
        for task in list(self._tasks):
            task.cancel()
        await asyncio.gather(*self._tasks, return_exceptions=True)
        for channel in self._channels.values():
            await channel.close()
        self._channels.clear()
        self._stubs.clear()
        if self._server is not None:
            await self._server.stop(grace=0.2)
            self._server = None

    def add_peer(self, name: str, target: str) -> None:
        grpc = _grpc()
        self._peers[name] = target
        channel = grpc.aio.insecure_channel(target)
        self._channels[name] = channel
        self._stubs[name] = channel.unary_unary(
            _FULL_METHOD,
            request_serializer=_identity,
            response_deserializer=_identity,
        )

    def _reconnect_peer(self, name: str) -> None:
        """Tear down and recreate one peer's channel (see ``reconnect_after``).

        The old channel closes asynchronously (its in-flight RPCs were
        already written off by the send deadline); the fresh channel picks
        up the SAME target, so a peer that restarted on its address gets a
        clean TCP connect on the very next multicast.
        """
        target = self._peers.get(name)
        old = self._channels.pop(name, None)
        self._stubs.pop(name, None)
        if old is not None:
            try:
                task = asyncio.get_running_loop().create_task(old.close())
                self._tasks.add(task)
                task.add_done_callback(self._tasks.discard)
            except RuntimeError:  # no running loop (unit tests)
                pass
        if target is None:
            return
        self.add_peer(name, target)
        self._fail_streak[name] = 0
        metrics.inc_counter(PEER_RECONNECT_KEY)
        trace.instant("net.reconnect", peer=name, target=target)
        if self._log:
            self._log.info("grpc transport: reconnected peer", name, target)

    # -- Transport seam -------------------------------------------------

    def multicast(self, message: IbftMessage) -> None:
        """Encode once, self-deliver locally, fan out to all peers."""
        with trace.span(
            "net.multicast", peers=len(self._stubs), type=int(message.type)
        ):
            payload = message.encode()
            # Trace-context frame AROUND the signed bytes (never inside:
            # payload_no_sig must stay byte-identical to the reference).
            ctx = getattr(message, "trace_ctx", None)
            if ctx is not None:
                payload = encode_traced(payload, ctx)
            self._deliver(message)
        for name, stub in self._stubs.items():
            task = asyncio.get_running_loop().create_task(
                self._send(name, stub, payload)
            )
            self._tasks.add(task)
            task.add_done_callback(self._tasks.discard)

    async def _send(self, name: str, stub, payload: bytes) -> None:
        """One peer send: retry with jittered exponential backoff inside
        ``send_deadline_s``.

        Attempt k sleeps ``base_backoff_s * 2^k * uniform(0.5, 1.5)``
        before retrying; the loop stops as soon as the remaining deadline
        cannot cover the next backoff.  Failures stay fire-and-forget
        (logged + counted, never raised): liveness is the protocol's job,
        the retries only spare it a round change for a transient blip.
        """
        grpc = _grpc()
        loop = asyncio.get_running_loop()
        deadline = loop.time() + self.send_deadline_s
        attempt = 0
        while True:
            remaining = deadline - loop.time()
            if remaining <= 0:
                break
            try:
                with trace.span("net.send", peer=name, attempt=attempt):
                    await stub(
                        payload,
                        timeout=min(self.per_attempt_timeout_s, remaining),
                    )
                self._fail_streak.pop(name, None)
                return
            except asyncio.CancelledError:
                return  # transport stopping: drop silently, never retry
            except (grpc.aio.AioRpcError, grpc.RpcError) as err:
                if self._log:
                    self._log.debug(
                        "grpc multicast attempt failed", name, attempt, err
                    )
            backoff = (
                self.base_backoff_s
                * (2.0**attempt)
                * self._jitter.uniform(0.5, 1.5)
            )
            attempt += 1
            if loop.time() + backoff >= deadline:
                break
            metrics.inc_counter(RETRY_KEY)
            trace.instant("net.retry", peer=name, attempt=attempt)
            await asyncio.sleep(backoff)
        metrics.inc_counter(SEND_FAILURE_KEY)
        trace.instant("net.send_failed", peer=name, attempts=attempt)
        if self._log:
            self._log.debug("grpc multicast gave up", name, attempt)
        # Consecutive exhausted deadlines to one peer: assume the channel
        # went bad (peer restart), not just the link — rebuild it.
        streak = self._fail_streak.get(name, 0) + 1
        self._fail_streak[name] = streak
        if streak >= self.reconnect_after and name in self._peers:
            self._reconnect_peer(name)


def local_cluster_addresses(n: int) -> Sequence[str]:
    """Convenience: n distinct localhost listen addresses (ephemeral)."""
    return ["127.0.0.1:0"] * n
