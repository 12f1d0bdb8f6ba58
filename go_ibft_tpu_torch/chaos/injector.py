"""Deterministic, seed-driven fault injection (a copy of the JAX package's
``chaos/injector.py``: the same seed gives the same schedule bytes in both).

A :class:`FaultInjector` is the single source of every chaos decision in a
run.  Decisions are drawn from **per-site** PRNG streams — each site (a
named injection point like ``deliver:node-3`` or ``verify:node-0``) gets
its own ``random.Random`` seeded from ``(seed, site)`` — so the decision
sequence at any site is a pure function of the seed, independent of how
other sites interleave.  Every event consumes a FIXED number of draws,
which makes the schedule **byte-identical across runs**:
:meth:`FaultInjector.schedule_bytes` re-derives a site's first N decisions
from scratch and two injectors with the same seed produce the same bytes
(the determinism contract pinned by tests/test_chaos.py).

Reproduction: a failing chaos test prints one ``CHAOS-REPLAY`` artifact
line carrying the seed, config, and schedule digest
(:func:`replay_on_failure`), enough to re-run the scenario under exactly
that schedule.
"""

from __future__ import annotations

import hashlib
import json
import random
from contextlib import contextmanager
from dataclasses import asdict, dataclass, field
from typing import Dict, Iterator, NamedTuple


@dataclass(frozen=True)
class FaultConfig:
    """Per-event fault probabilities and magnitudes (all default off).

    Rates are independent per event: one delivery may be dropped, another
    delayed AND duplicated.  ``device_error_burst`` is deterministic-first:
    when > 0, the first N device dispatches at a site fail regardless of
    ``device_error_rate`` — the shape the circuit-breaker suites need (a
    dead device that comes back) without tuning rates.
    """

    drop_rate: float = 0.0
    delay_rate: float = 0.0
    max_delay_s: float = 0.0
    reorder_rate: float = 0.0
    duplicate_rate: float = 0.0
    corrupt_rate: float = 0.0
    slow_verify_rate: float = 0.0
    slow_verify_s: float = 0.0
    device_error_rate: float = 0.0
    device_error_burst: int = 0


class TransportFault(NamedTuple):
    """One delivery's fate (fixed draw count: 6 uniforms per event)."""

    drop: bool
    delay_s: float  # 0.0 = deliver now
    duplicate: bool
    reorder: bool
    corrupt_bit: int  # -1 = intact; else the bit index to flip (mod size)


class VerifyFault(NamedTuple):
    """One verify dispatch's fate (fixed draw count: 2 uniforms)."""

    device_error: bool
    slow_s: float  # 0.0 = full speed


class FaultInjector:
    """Replayable fault oracle: seed + config -> every chaos decision.

    Thread-safe per site is NOT promised — chaos runs are single event
    loop by design (determinism would die with racing draws).
    """

    def __init__(self, seed: int, config: FaultConfig = FaultConfig()):
        self.seed = int(seed)
        self.config = config
        self._streams: Dict[str, random.Random] = {}
        self._device_calls: Dict[str, int] = {}

    # -- per-site streams ----------------------------------------------

    def _stream(self, site: str) -> random.Random:
        rng = self._streams.get(site)
        if rng is None:
            # Seeding with a string hashes it through sha512 (random's
            # version-2 str seeding) — stable across processes, unlike
            # hash().
            rng = random.Random(f"{self.seed}:{site}")
            self._streams[site] = rng
        return rng

    # -- decision draws (fixed draw count per event) --------------------

    def transport_fault(self, site: str) -> TransportFault:
        """Fate of one delivery at ``site``.  Always 6 draws."""
        rng = self._stream(site)
        c = self.config
        u_drop, u_delay, u_amount, u_dup, u_reorder, u_corrupt = (
            rng.random() for _ in range(6)
        )
        return TransportFault(
            drop=u_drop < c.drop_rate,
            delay_s=(u_amount * c.max_delay_s) if u_delay < c.delay_rate else 0.0,
            duplicate=u_dup < c.duplicate_rate,
            reorder=u_reorder < c.reorder_rate,
            corrupt_bit=(
                int(u_amount * (1 << 16)) if u_corrupt < c.corrupt_rate else -1
            ),
        )

    def verify_fault(self, site: str) -> VerifyFault:
        """Fate of one verify dispatch at ``site``.  Always 2 draws, plus
        the deterministic ``device_error_burst`` prefix."""
        rng = self._stream(site)
        c = self.config
        u_err, u_slow = rng.random(), rng.random()
        calls = self._device_calls.get(site, 0)
        self._device_calls[site] = calls + 1
        burst = calls < c.device_error_burst
        return VerifyFault(
            device_error=burst or u_err < c.device_error_rate,
            slow_s=c.slow_verify_s if u_slow < c.slow_verify_rate else 0.0,
        )

    def crash_after(self, site: str, lo: int = 1, hi: int = 8) -> int:
        """Seeded kill-point: the 1-based event count at which a
        :class:`~go_ibft_tpu_torch.chaos.wrappers.CrashRestart` armed at ``site``
        fires.  One draw, so schedules stay byte-stable."""
        return self._stream(site).randint(lo, hi)

    def device_error(self, site: str) -> "InjectedDeviceError":
        """The exception a chaotic dispatch raises — mimics the
        ``RuntimeError`` a failed CUDA launch surfaces, and names the seed
        so any traceback is replayable on its own."""
        return InjectedDeviceError(
            f"chaos: injected device error on dispatch "
            f"(seed={self.seed}, site={site})"
        )

    # -- replayable schedule -------------------------------------------

    def schedule_bytes(self, site: str, n: int, kind: str = "transport") -> bytes:
        """The first ``n`` decisions at ``site``, serialized — derived from
        a FRESH stream, so the result is independent of live draws already
        made.  Same seed + config + site => byte-identical output (the
        chaos determinism contract)."""
        saved_stream = self._streams.pop(site, None)
        saved_calls = self._device_calls.pop(site, None)
        out = bytearray()
        try:
            for _ in range(n):
                if kind == "transport":
                    f = self.transport_fault(site)
                    out.append(
                        (f.drop << 0)
                        | (f.duplicate << 1)
                        | (f.reorder << 2)
                        | ((f.corrupt_bit >= 0) << 3)
                        | ((f.delay_s > 0) << 4)
                    )
                    out += int(f.delay_s * 1e6).to_bytes(4, "big")
                    out += (f.corrupt_bit & 0xFFFF).to_bytes(2, "big")
                else:
                    f = self.verify_fault(site)
                    out.append((f.device_error << 0) | ((f.slow_s > 0) << 1))
        finally:
            if saved_stream is not None:
                self._streams[site] = saved_stream
            else:
                self._streams.pop(site, None)
            if saved_calls is not None:
                self._device_calls[site] = saved_calls
            else:
                self._device_calls.pop(site, None)
        return bytes(out)

    def schedule_digest(self, sites: Iterator[str] = ("transport", "verify"), n: int = 256) -> str:
        """Short hex digest of the first ``n`` decisions at each site —
        the schedule fingerprint carried on CHAOS-REPLAY lines."""
        h = hashlib.sha256()
        for site in sites:
            kind = "verify" if site.startswith("verify") else "transport"
            h.update(site.encode())
            h.update(self.schedule_bytes(site, n, kind=kind))
        return h.hexdigest()[:16]

    def describe(self) -> dict:
        return {
            "seed": self.seed,
            "config": asdict(self.config),
            "schedule_digest": self.schedule_digest(),
        }

    def replay_line(self) -> str:
        """The one-line replay artifact printed on chaos-test failure."""
        d = self.describe()
        return (
            f"CHAOS-REPLAY seed={d['seed']} "
            f"schedule={d['schedule_digest']} "
            f"config={json.dumps(d['config'], sort_keys=True)}"
        )


class InjectedDeviceError(RuntimeError):
    """The simulated device dispatch failure (a RuntimeError subclass, as
    PyTorch raises for a failed CUDA launch)."""


@contextmanager
def replay_on_failure(injector: FaultInjector):
    """Print the injector's CHAOS-REPLAY artifact line when the body
    raises (assertion or crash), then re-raise.

    pytest captures stdout and replays it for failing tests, so the seed
    and schedule digest land in the failure report — the flake is
    replayable from the seed."""
    try:
        yield injector
    except BaseException:
        print(injector.replay_line(), flush=True)
        raise
