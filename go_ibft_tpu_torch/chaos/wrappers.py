"""Chaos wrappers: transports, verifiers, backends, pipeline dispatches (a
copy of the JAX package's ``chaos/wrappers.py``).

Each wrapper interposes a :class:`~go_ibft_tpu_torch.chaos.injector.FaultInjector`
between a real component and its caller, applying that site's deterministic
fault stream.  Wrappers forward everything they do not fault-gate, so they
are drop-in at the same seams the engine already has: ``Transport``
(one-method multicast), per-receiver deliver callables,
``BatchVerifier``/crypto backends, and
:class:`~go_ibft_tpu_torch.verify.pipeline.VerifyPipeline` dispatch callables.

Every injected fault is counted under ``("go-ibft", "chaos", <kind>)`` so
soak tests can assert that chaos actually happened (a soak that injected
nothing proves nothing).
"""

from __future__ import annotations

import asyncio
import time
from typing import Callable, List, Optional

from ..messages.wire import IbftMessage
from ..obs import trace
from ..utils import metrics
from .injector import FaultInjector

_CHAOS = "chaos"


def _count(kind: str, n: int = 1, site: Optional[str] = None) -> None:
    metrics.inc_counter(("go-ibft", _CHAOS, kind), n)
    # Injection sites land on the flight-recorder timeline: a chaotic soak
    # trace shows WHERE each fault hit relative to the round phases.
    trace.instant("chaos." + kind, site=site)


def corrupt_message(message: IbftMessage, bit: int) -> Optional[IbftMessage]:
    """Flip one bit of the message's wire encoding and re-decode.

    Returns the mutated COPY (never touches the original — a loopback
    multicast shares one object across receivers), or ``None`` when the
    flip produced undecodable bytes (a lossy link eating the frame).
    """
    data = bytearray(message.encode())
    if not data:
        return None
    data[(bit // 8) % len(data)] ^= 1 << (bit % 8)
    try:
        return IbftMessage.decode(bytes(data))
    except Exception:  # noqa: BLE001 - garbage frames drop, like real links
        return None


class ChaoticDeliver:
    """Wrap one receiver's deliver callable with transport faults.

    Drop/delay/duplicate/reorder/bit-flip per delivery, drawn from the
    injector's ``site`` stream.  Delay and reorder need a running asyncio
    loop (``loop.call_later``); without one they degrade to in-order
    synchronous delivery (drop/duplicate/corrupt still apply), so the
    wrapper is safe in plain synchronous tests too.

    Reordering holds the message back and releases it after the NEXT
    delivery at this site (a held message is also flushed by a timer so a
    reordered tail message cannot be starved forever).
    """

    def __init__(
        self,
        deliver: Callable[[IbftMessage], None],
        injector: FaultInjector,
        site: str,
        *,
        flush_after_s: float = 0.02,
    ) -> None:
        self._deliver = deliver
        self._injector = injector
        self.site = site
        self._held: List[IbftMessage] = []
        self._flush_after_s = flush_after_s

    @staticmethod
    def _loop() -> Optional[asyncio.AbstractEventLoop]:
        try:
            return asyncio.get_running_loop()
        except RuntimeError:
            return None

    def _flush_held(self) -> None:
        held, self._held = self._held, []
        for m in held:
            self._deliver(m)

    def __call__(self, message: IbftMessage) -> None:
        fault = self._injector.transport_fault(self.site)
        if fault.drop:
            _count("dropped", site=self.site)
            return
        if fault.corrupt_bit >= 0:
            _count("corrupted", site=self.site)
            message = corrupt_message(message, fault.corrupt_bit)
            if message is None:  # undecodable frame: the link ate it
                return
        copies = [message, message] if fault.duplicate else [message]
        if fault.duplicate:
            _count("duplicated", site=self.site)
        loop = self._loop()
        if loop is None:
            self._flush_held()
            for m in copies:
                self._deliver(m)
            return
        if fault.reorder:
            _count("reordered", site=self.site)
            self._held.extend(copies)
            loop.call_later(self._flush_after_s, self._flush_held)
            return
        if fault.delay_s > 0:
            _count("delayed", site=self.site)
            for m in copies:
                loop.call_later(fault.delay_s, self._deliver, m)
        else:
            for m in copies:
                self._deliver(m)
        # Release anything held back by an earlier reorder AFTER this
        # delivery — the swap that actually reorders.
        if self._held:
            self._flush_held()


class ChaoticTransport:
    """Wrap a whole ``Transport`` (the reference's one-method seam): every
    ``multicast`` passes through one :class:`ChaoticDeliver` gate before
    reaching the inner transport."""

    def __init__(
        self, inner, injector: FaultInjector, site: str = "transport"
    ) -> None:
        self.inner = inner
        self._gate = ChaoticDeliver(inner.multicast, injector, site)

    def multicast(self, message: IbftMessage) -> None:
        self._gate(message)

    def __getattr__(self, name):
        return getattr(self.inner, name)


class ChaoticVerifier:
    """Wrap a ``BatchVerifier`` (or crypto-path verifier) with device
    faults: each drain may run slow (``slow_verify_s``) or raise the
    injector's simulated device dispatch ``RuntimeError``.

    This is what a dead/flaky accelerator looks like to the engine — the
    exact input :class:`~go_ibft_tpu_torch.verify.ResilientBatchVerifier` and the
    circuit breaker are built to absorb.  Everything not fault-gated
    (``note_round``, ``warmup``, ``supports_fused``, ``quarantine``, the
    certify entry points, ...) forwards to the inner verifier untouched.
    """

    def __init__(self, inner, injector: FaultInjector, site: str = "verify") -> None:
        self.inner = inner
        self._injector = injector
        self.site = site

    def _gate(self) -> None:
        fault = self._injector.verify_fault(self.site)
        if fault.slow_s > 0:
            _count("slow_verifies", site=self.site)
            time.sleep(fault.slow_s)
        if fault.device_error:
            _count("device_errors", site=self.site)
            raise self._injector.device_error(self.site)

    def verify_senders(self, msgs):
        self._gate()
        return self.inner.verify_senders(msgs)

    def verify_committed_seals(self, proposal_hash, seals, height):
        self._gate()
        return self.inner.verify_committed_seals(proposal_hash, seals, height)

    def verify_seal_lanes(self, lanes, height):
        # The cross-height sync drain passes the same device-fault gate as
        # every other dispatch (without this explicit hop, __getattr__
        # would forward it to the inner verifier chaos-free).
        self._gate()
        return self.inner.verify_seal_lanes(lanes, height)

    def certify_senders(self, msgs, height, threshold=None):
        self._gate()
        return self.inner.certify_senders(msgs, height, threshold)

    def certify_seals(self, proposal_hash, seals, height, threshold=None):
        self._gate()
        return self.inner.certify_seals(proposal_hash, seals, height, threshold)

    def certify_round(self, msgs, proposal_hash, seals, height, prepare_threshold=None):
        self._gate()
        return self.inner.certify_round(
            msgs, proposal_hash, seals, height, prepare_threshold
        )

    def __getattr__(self, name):
        return getattr(self.inner, name)


class ChaoticBackend:
    """Wrap an embedder crypto backend: the per-message verification
    predicates (``is_valid_validator``, ``is_valid_committed_seal``) pass
    the same slow/error gate as the batched drains; every other backend
    method forwards untouched."""

    def __init__(self, inner, injector: FaultInjector, site: str = "backend") -> None:
        self.inner = inner
        self._injector = injector
        self.site = site

    def _gate(self) -> None:
        fault = self._injector.verify_fault(self.site)
        if fault.slow_s > 0:
            _count("slow_verifies", site=self.site)
            time.sleep(fault.slow_s)
        if fault.device_error:
            _count("device_errors", site=self.site)
            raise self._injector.device_error(self.site)

    def is_valid_validator(self, msg):
        self._gate()
        return self.inner.is_valid_validator(msg)

    def is_valid_committed_seal(self, proposal_hash, committed_seal, height=None):
        self._gate()
        return self.inner.is_valid_committed_seal(
            proposal_hash, committed_seal, height
        )

    def __getattr__(self, name):
        return getattr(self.inner, name)


class SimulatedCrash(BaseException):
    """The kill -9 stand-in a :class:`CrashRestart` raises at its seeded
    point.  A ``BaseException`` deliberately — a real kill is not
    catchable by the engine's advisory ``except Exception`` guards, so
    neither is its simulation; it unwinds straight to the test harness.
    Carries the seed + site so a crash-test failure is replayable like
    every other chaos artifact."""


class CrashRestart:
    """Seeded kill-point injection for crash/restart suites.

    Arms a deterministic crash at the Nth hit of a named site (N drawn
    once from the injector's per-site stream, so the schedule is
    byte-stable per seed).  Typical wiring: wrap a chain-layer hook —
    ``IBFT.on_lock`` (die mid-round holding a fresh PC) or ``on_finalize``
    (die between the WAL append and the store prune) — with
    :meth:`wrap`; when the crash fires the wrapper raises
    :class:`SimulatedCrash` AFTER forwarding to the real hook (the process
    died after the durable step, the kill -9 shape) or BEFORE it
    (``before=True`` — died short of durability), and the harness treats
    the node as dead: cancel its tasks, drop its in-memory state, rebuild
    from the WAL via ``ChainRunner.recover()``.
    """

    def __init__(
        self,
        injector: FaultInjector,
        site: str,
        *,
        lo: int = 1,
        hi: int = 4,
    ) -> None:
        self._injector = injector
        self.site = site
        self.crash_at = injector.crash_after(site, lo, hi)
        self.hits = 0
        self.fired = False

    def check(self) -> None:
        """Count one event; raise :class:`SimulatedCrash` at the kill
        point (exactly once — a restarted node re-arming the same object
        keeps running)."""
        self.hits += 1
        if not self.fired and self.hits >= self.crash_at:
            self.fired = True
            _count("crashes", site=self.site)
            raise SimulatedCrash(
                f"chaos: injected crash at event {self.hits} "
                f"(seed={self._injector.seed}, site={self.site})"
            )

    def wrap(self, hook: Optional[Callable], *, before: bool = False):
        """Wrap a hook callable with this kill point.

        ``before=False`` (default): the real hook runs first, THEN the
        crash fires — the durable step completed, the process died on the
        way out.  ``before=True``: the crash pre-empts the hook — death
        short of durability.  A ``None`` hook is allowed (the crash point
        alone is the wrapped behavior).
        """

        def wrapped(*args, **kwargs):
            if before:
                self.check()
            result = hook(*args, **kwargs) if hook is not None else None
            if not before:
                self.check()
            return result

        return wrapped


def chaotic_dispatch(
    dispatch: Callable, injector: FaultInjector, site: str = "pipeline"
) -> Callable:
    """Wrap a :class:`~go_ibft_tpu_torch.verify.pipeline.VerifyPipeline` dispatch
    callable: each dispatched item may stall or raise the simulated device
    error, exactly where a real kernel launch would."""

    def wrapped(packed):
        fault = injector.verify_fault(site)
        if fault.slow_s > 0:
            _count("slow_verifies", site=site)
            time.sleep(fault.slow_s)
        if fault.device_error:
            _count("device_errors", site=site)
            raise injector.device_error(site)
        return dispatch(packed)

    return wrapped
