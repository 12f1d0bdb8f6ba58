"""Zero-dependency span API — the flight recorder's instrumentation face.

Usage at a hot seam::

    from go_ibft_tpu_torch.obs import trace

    with trace.span("verify.pack", lanes=n):
        ...pack...

    trace.instant("round.timeout", round=r)

    t0 = trace.now_us()          # None while tracing is off
    ...work whose args are known only at its end...
    if t0 is not None:
        trace.complete("sched.pack", t0, senders=n)

Design rules:

* **Disabled mode is one predicate check.**  ``span()`` and ``instant()``
  read one module global; when no recorder is installed they return a
  shared no-op context manager / return immediately.  No clock reads, no
  contextvar touches, no allocation beyond the caller's kwargs dict.
  The bench contract pins the resulting overhead at < 5% of the config #1
  happy path (``tests/test_bench_contract.py``).  ``now_us()`` is the same
  one check, and returns None without reading the clock; a site guards its
  ``complete()`` call on that None, so that it evaluates no argument
  either.
* **Thread-safe.**  The recorder is a lock-guarded ring
  (:class:`~go_ibft_tpu_torch.obs.recorder.RingRecorder`); spans may open and
  close on transport threads, worker pools, and the engine loop
  concurrently.
* **Tracks.**  Every record carries a track name — the timeline row it
  renders on (one per consensus node, plus one per auxiliary thread).
  Resolution order: explicit ``track=`` argument, then the inherited
  track (a ``contextvars.ContextVar`` set by the nearest enclosing span
  that passed ``track=`` — drains instrumented inside the engine inherit
  the node's track automatically, including across ``create_task``
  boundaries), then the current thread name.
"""

from __future__ import annotations

import contextvars
import itertools
import threading
import time
from typing import Optional

from .recorder import DEFAULT_CAPACITY, RingRecorder

__all__ = [
    "enable",
    "disable",
    "enabled",
    "recorder",
    "span",
    "instant",
    "now_us",
    "complete",
    "set_track",
    "next_span_id",
]

# THE predicate: every instrumentation site checks this one global.
_recorder: Optional[RingRecorder] = None

_track_var: contextvars.ContextVar[Optional[str]] = contextvars.ContextVar(
    "go_ibft_obs_track", default=None
)


def enable(capacity: int = DEFAULT_CAPACITY) -> RingRecorder:
    """Install (and return) a fresh ring recorder; spans start recording."""
    global _recorder
    _recorder = RingRecorder(capacity)
    return _recorder


def disable() -> None:
    """Remove the recorder; every span site reverts to the no-op path."""
    global _recorder
    _recorder = None


def enabled() -> bool:
    return _recorder is not None


def recorder() -> Optional[RingRecorder]:
    return _recorder


_span_id_counter = itertools.count(1)


def next_span_id() -> int:
    """Fresh per-process span id (links a ``net.send`` to its ``net.recv``
    records across nodes; ``itertools.count.__next__`` is atomic under the
    GIL, so transport threads need no lock)."""
    return next(_span_id_counter)


def set_track(name: str) -> contextvars.Token:
    """Set the inherited track for the current context; returns the reset
    token.  Rarely needed directly — passing ``track=`` to the outermost
    span of a scope does the same and resets itself."""
    return _track_var.set(name)


def _resolve_track(explicit: Optional[str]) -> str:
    if explicit is not None:
        return explicit
    inherited = _track_var.get()
    if inherited is not None:
        return inherited
    return threading.current_thread().name


class _NullSpan:
    """Shared no-op context manager returned while tracing is disabled."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL = _NullSpan()


class _Span:
    __slots__ = ("_rec", "name", "track", "args", "_t0", "_tok")

    def __init__(self, rec, name, track, args):
        self._rec = rec
        self.name = name
        self.track = _resolve_track(track)
        self.args = args
        self._tok = _track_var.set(self.track) if track is not None else None
        self._t0 = 0

    def __enter__(self):
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, exc_type, exc, tb):
        now = time.perf_counter_ns()
        if exc_type is not None:
            # Record the failure on the span itself: a drain that died
            # mid-flight is exactly what a flight recorder must show.
            args = dict(self.args) if self.args else {}
            args["error"] = exc_type.__name__
            self.args = args
        self._rec.append(
            (
                "X",
                self.name,
                self.track,
                self._t0 // 1000,
                (now - self._t0) // 1000,
                self.args or None,
            )
        )
        if self._tok is not None:
            _track_var.reset(self._tok)
        return False


def span(name: str, track: Optional[str] = None, **args):
    """Open a span context manager (no-op unless tracing is enabled).

    ``track`` pins the timeline row and is inherited by spans opened
    within this one (contextvar scope); ``**args`` become the span's
    attributes in the exported trace.
    """
    rec = _recorder
    if rec is None:
        return _NULL
    return _Span(rec, name, track, args)


def instant(name: str, track: Optional[str] = None, **args) -> None:
    """Record a point event (no-op unless tracing is enabled)."""
    rec = _recorder
    if rec is None:
        return
    rec.append(
        (
            "i",
            name,
            _resolve_track(track),
            time.perf_counter_ns() // 1000,
            0,
            args or None,
        )
    )


def now_us() -> Optional[int]:
    """The recorder's clock (``perf_counter_ns() // 1000``, the clock of
    every record), or None while tracing is off: a span's start for
    :func:`complete`, read only while tracing is on."""
    if _recorder is None:
        return None
    return time.perf_counter_ns() // 1000


def complete(name: str, start_us: int, track: Optional[str] = None, **args) -> Optional[int]:
    """Record a span from ``start_us`` (a :func:`now_us` reading) to now,
    for a site whose start or args are known only when the work is done.
    Returns the span's end, the start of a span that follows it, or None
    while tracing is off (nothing is recorded)."""
    rec = _recorder
    if rec is None:
        return None
    end = time.perf_counter_ns() // 1000
    rec.append(("X", name, _resolve_track(track), start_us, end - start_us, args or None))
    return end
