"""Chaos-injection harness: deterministic faults at the engine's seams (the
port of the JAX package's ``chaos`` package, without its serve-plane
clients, which come with the serving slice).

A seed-driven :class:`FaultInjector` produces a replayable fault schedule
(same seed => byte-identical decisions, the same bytes as the JAX
package's) and a family of wrappers applies it at the seams the engine
already exposes:

* transports / deliver callables — drops, delays, reordering, duplication,
  wire-encoding bit-flips (:class:`ChaoticDeliver`/:class:`ChaoticTransport`);
* batch verifiers and crypto backends — slow verifies and a simulated
  device ``RuntimeError`` on dispatch (:class:`ChaoticVerifier`/
  :class:`ChaoticBackend`);
* pipeline dispatch callables (:func:`chaotic_dispatch`);
* chain-layer hooks — seeded kill -9 points for crash/restart suites
  (:class:`CrashRestart` raising :class:`SimulatedCrash`), recovered via
  ``ChainRunner.recover()`` WAL replay.

Any chaos-test failure prints a ``CHAOS-REPLAY`` line with the seed and
schedule digest (:func:`replay_on_failure`).  The degraded-mode machinery
these faults exercise lives in :mod:`go_ibft_tpu_torch.verify` (quarantine
bisection and the circuit breaker, on a device rung off the card).
"""

from .injector import (
    FaultConfig,
    FaultInjector,
    InjectedDeviceError,
    TransportFault,
    VerifyFault,
    replay_on_failure,
)
from .wrappers import (
    ChaoticBackend,
    ChaoticDeliver,
    ChaoticTransport,
    ChaoticVerifier,
    CrashRestart,
    SimulatedCrash,
    chaotic_dispatch,
    corrupt_message,
)

__all__ = [
    "CrashRestart",
    "SimulatedCrash",
    "FaultConfig",
    "FaultInjector",
    "InjectedDeviceError",
    "TransportFault",
    "VerifyFault",
    "replay_on_failure",
    "ChaoticBackend",
    "ChaoticDeliver",
    "ChaoticTransport",
    "ChaoticVerifier",
    "chaotic_dispatch",
    "corrupt_message",
]
