"""Transport seam: multicast out, add_message in.

The reference's entire comm layer is a one-method interface
(core/transport.go:7-10); gossip lives in the embedder.  This build keeps the
seam; :class:`LoopbackTransport` below is the in-process fan-out for tests and
single-host clusters (the reference's test harness pattern,
core/helpers_test.go:227-231).  Further backends per SURVEY.md §5 — a
gRPC/DCN transport for multi-host deployments and the ICI lock-step
collective transport (multicast as an all_gather of fixed-size message
tensors) — plug into the same ``Transport`` protocol.
"""

from __future__ import annotations

import asyncio
import time
from collections import deque
from typing import Callable, Optional, Protocol, Sequence

from ..messages.wire import IbftMessage
from ..obs import trace


class Transport(Protocol):
    """Fire-and-forget multicast (reference core/transport.go:7-10).

    Self-delivery is expected: nodes receive their own messages through the
    same path as everyone else's.
    """

    def multicast(self, message: IbftMessage) -> None: ...


class LoopbackTransport:
    """In-process multicast: deliver to every registered node, self included.

    Mirrors the reference test clusters' gossip closure
    (core/mock_test.go:546-550, core/helpers_test.go:227-231).  Delivery is
    synchronous and in registration order; a delivery hook lets fault tests
    drop or mutate messages per (sender, receiver).

    Telemetry: loopback dispatch hands the SAME stamped message object to
    every receiver, and each receiving engine records its own ``net.recv``
    instant at ingress (``IBFT._record_recv``) — the loopback delivery
    callback IS the engine ingress, so the trace context needs no wire
    framing here and the shared process clock makes every clock offset
    exactly zero.
    """

    def __init__(self) -> None:
        self._receivers: list[Callable[[IbftMessage], None]] = []
        # Optional fault hook: (message, receiver_index) -> deliver?
        self.should_deliver: Callable[[IbftMessage, int], bool] = lambda m, i: True

    def register(self, add_message: Callable[[IbftMessage], None]) -> None:
        self._receivers.append(add_message)

    def multicast(self, message: IbftMessage) -> None:
        for idx, deliver in enumerate(self._receivers):
            if self.should_deliver(message, idx):
                deliver(message)


class BatchingIngress:
    """Inbound micro-batcher: the device-batched ingress shape.

    Gossip delivers messages one at a time; verifying each eagerly costs one
    device launch (or one host recover) per message — the reference's
    sequential AddMessage shape (core/ibft.go:1101-1123).  This collects a
    burst and flushes it through :meth:`IBFT.add_messages`, so sender
    signatures for the whole burst are verified in ONE device batch.

    Flushes when ``max_batch`` messages accumulate or at the end of the
    current event-loop tick / after ``max_delay`` seconds, whichever the
    adaptive window picks (below).  Event-loop affine (call :meth:`submit`
    from the loop thread); ``flush`` may be called directly for
    deterministic tests.

    **Adaptive window.**  The wall-clock window only earns its latency when
    the resulting batch is big enough to take the device route; below the
    adaptive verifier's cutover the batch is host-verified one message at a
    time anyway, so waiting ``max_delay`` for company is pure added latency
    — it put the 4-validator happy path ~2 ms/phase behind the sequential
    baseline.  Small flows therefore flush with
    ``call_soon``: every message delivered in the same event-loop tick (a
    loopback multicast, a burst drained from one socket read) still lands
    in ONE batch, but the flush costs zero wall-clock.  The timed window
    engages when the flow is device-sized: either one flush carried
    ``>= eager_cutover`` messages, or the flushes of the last ``max_delay``
    of wall-clock add up to that many (a sustained flood arriving a few
    messages per tick — without the accumulation signal, sub-cutover eager
    flushes could never bootstrap into batching).  The window is a true
    sliding window: counts older than ``max_delay`` fall out, so a steady
    sub-cutover trickle never chains itself over the threshold, and any
    idle gap drops straight back to eager.

    **Arrival calibration.**  When the timed window engages it
    is no longer the fixed ``max_delay``: an
    :class:`~go_ibft_tpu_torch.utils.calibration.ArrivalCalibrator` tracks the
    stream's EWMA inter-arrival gap and the wait becomes the PROJECTED
    time for the remaining ``max_batch`` lanes to arrive — a flood pays
    microseconds instead of the full 2 ms tail, and a stream measured too
    slow to fill the batch inside the ceiling flushes eagerly instead of
    idling.  ``max_delay`` stays the hard ceiling; pass
    ``calibrate=False`` for the fixed legacy window.
    """

    def __init__(
        self,
        add_messages: Callable[[Sequence[IbftMessage]], None],
        *,
        max_batch: int = 256,
        max_delay: float = 0.002,
        eager_cutover: Optional[int] = None,
        calibrate: bool = True,
    ) -> None:
        from ..utils import calibration

        if eager_cutover is None:
            eager_cutover = (
                calibration.measured_cutover() or calibration.DEFAULT_CUTOVER_LANES
            )
        self._add_messages = add_messages
        self._buffer: list[IbftMessage] = []
        self._handle: Optional[asyncio.Handle] = None
        self.max_batch = max_batch
        self.max_delay = max_delay
        self.eager_cutover = eager_cutover
        self.calibrator = (
            calibration.ArrivalCalibrator(max_window_s=max_delay)
            if calibrate
            else None
        )
        # Sliding window of recent flushes [(monotonic t, n), ...] whose
        # total within the trailing ``max_delay`` is the device-sized-flow
        # detector.  A true window, not a chained sum: flushes spaced just
        # under ``max_delay`` apart must NOT accumulate forever (a slow
        # steady trickle would eventually cross the cutover and pay the
        # timed window for nothing).
        self._recent: deque = deque()
        self._recent_n = 0
        # While tracing: (start µs, window s) of the wait the buffered
        # messages make for their flush (window 0: the end of the event
        # loop's tick), for the flush's ``ingress.window``.
        self._opened: Optional[tuple] = None

    def _trim_recent(self, now: float) -> None:
        while self._recent and now - self._recent[0][0] > self.max_delay:
            self._recent_n -= self._recent.popleft()[1]

    def _window(self) -> float:
        """The timed-window wait: calibrated projection, ceiling-clamped."""
        if self.calibrator is None:
            return self.max_delay
        return self.calibrator.window(len(self._buffer), self.max_batch)

    def submit(self, message: IbftMessage) -> None:
        self._buffer.append(message)
        if self.calibrator is not None:
            self.calibrator.observe()
        if len(self._buffer) >= self.max_batch:
            self.flush()
        elif self._handle is None:
            t0 = trace.now_us()
            loop = asyncio.get_running_loop()
            self._trim_recent(time.monotonic())
            window = 0.0
            if self._recent_n + len(self._buffer) >= self.eager_cutover:
                window = self._window()
            if window > 0:
                self._handle = loop.call_later(window, self.flush)
            else:
                self._handle = loop.call_soon(self.flush)
            if t0 is not None:
                self._opened = (t0, window)

    def flush(self) -> None:
        if self._handle is not None:
            self._handle.cancel()
            self._handle = None
        if not self._buffer:
            return
        batch, self._buffer = self._buffer, []
        opened, self._opened = self._opened, None
        if opened is not None:
            trace.complete(
                "ingress.window",
                opened[0],
                lanes=len(batch),
                window_us=round(opened[1] * 1e6, 1),
            )
        now = time.monotonic()
        self._recent.append((now, len(batch)))
        self._recent_n += len(batch)
        self._trim_recent(now)
        self._add_messages(batch)

    def close(self) -> None:
        """Drop buffered messages and cancel the pending flush timer."""
        if self._handle is not None:
            self._handle.cancel()
            self._handle = None
        self._buffer.clear()
        self._opened = None
