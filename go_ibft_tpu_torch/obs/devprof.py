"""On-demand device profiling: ``torch.profiler`` windows for the ledger (the
port of the JAX package's ``obs/devprof.py``).

The cost ledger (:mod:`go_ibft_tpu_torch.obs.ledger`) attributes *wall*
time per program; this module captures what the device itself was doing —
a ``torch.profiler`` window over the CPU and the card, written as a Chrome
trace (``*.trace.json``) that
:func:`go_ibft_tpu_torch.obs.timeline.merge_device_trace` merges into the
flight recorder's Perfetto document, so ONE file shows consensus phases over
host spans over kernels.

Two entry points:

* :func:`capture` — a fixed-length window (the ``/profilez`` endpoint:
  ``GET /profilez?seconds=0.5`` on a live
  :class:`~go_ibft_tpu_torch.obs.httpd.TelemetryServer`);
* :func:`window` — a context manager wrapping a whole run.

Both stamp ``host_anchor_us`` — the flight recorder's monotonic microsecond
clock read right after the profiler starts — so the merge can rebase the
trace's timestamps onto the exported host trace's clock (to within the
start call's overhead).

The profiler is one per process: windows serialize on a module lock, and a
second concurrent request reports ``busy`` instead of corrupting the open
session.  Every failure path returns a dict with ``ok: False`` and a reason
— a profiling request must never take down a telemetry endpoint or a run.

Differences from the JAX file.  ``device`` picks what is profiled (``None``:
the card, with the CPU beside it; ``"cpu"`` only when asked for: the CPU
alone, whose operators are then the device's events).  A window in which
the device recorded nothing returns ``ok: False`` with an error saying so,
never an empty trace as a success: ``torch.profiler`` in a long-lived
process can stop recording the card after its first sessions, and an empty
window must read as that, not as an idle card.  The result also carries
``device_events`` (the count) and ``kernels`` (each device event name's
count).
"""

from __future__ import annotations

import glob
import json
import os
import shutil
import tempfile
import threading
import time
from contextlib import contextmanager
from typing import Optional

from ..utils.device import DeviceLike

__all__ = ["capture", "window", "newest_trace"]

_lock = threading.Lock()

# Anchored capture dir for parameterless captures (the /profilez
# endpoint): ONE per-process directory, pruned before each new window so
# a scraper polling /profilez forever holds at most one trace on disk.
# Callers that pass their own out_dir own its lifecycle.
_default_dir: Optional[str] = None

MIN_SECONDS = 0.05
MAX_SECONDS = 30.0

# Chrome-trace categories of work on the card, and of operators on the CPU
# (the device's events when the CPU is the device asked for).
_CARD_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
_CPU_CATEGORIES = ("cpu_op",)


def _default_capture_dir() -> str:
    global _default_dir
    if _default_dir is None or not os.path.isdir(_default_dir):
        _default_dir = tempfile.mkdtemp(prefix="go-ibft-profilez-")
    else:
        for entry in os.listdir(_default_dir):
            path = os.path.join(_default_dir, entry)
            if os.path.isdir(path):
                shutil.rmtree(path, ignore_errors=True)
            else:
                try:
                    os.remove(path)
                except OSError:
                    pass
    return _default_dir


def newest_trace(out_dir: str) -> Optional[str]:
    """The most recent ``*.trace.json`` (or ``.json.gz``) under ``out_dir``."""
    paths = glob.glob(os.path.join(out_dir, "**", "*.trace.json"), recursive=True)
    paths += glob.glob(os.path.join(out_dir, "**", "*.trace.json.gz"), recursive=True)
    if not paths:
        return None
    return max(paths, key=os.path.getmtime)


def _all_threads():
    """A profiler config that records the operators of every thread (the
    node's flushes run on the scheduler's thread, not the one that opens
    the window), where this torch has the option.  Only for a window on
    the CPU, whose operators are the device's events: on the card the
    kernels are recorded process-wide anyway, and every thread's operators
    add seconds to a busy node's window there."""
    try:
        from torch._C._profiler import _ExperimentalConfig

        return _ExperimentalConfig(profile_all_threads=True)
    except (ImportError, TypeError):
        return None


class _Session:
    """One profiler session on ``device`` (resolved when started)."""

    def __init__(self, device: DeviceLike) -> None:
        self.device = device
        self.prof = None
        self.card = False

    def start(self) -> Optional[str]:
        """Start the profiler; returns an error string or None."""
        try:
            import torch
            from torch.profiler import ProfilerActivity, profile

            from ..utils.device import resolve_device

            dev = resolve_device(self.device)
            self.card = dev.type == "cuda"
            activities = [ProfilerActivity.CPU]
            if self.card:
                activities.append(ProfilerActivity.CUDA)
                torch.cuda.synchronize(dev)
            self.prof = profile(activities=activities, experimental_config=None if self.card else _all_threads())
            self.prof.start()
        except Exception as err:  # noqa: BLE001 - report, never raise
            self.prof = None
            return f"{type(err).__name__}: {err}"
        return None

    def stop(self, out_dir: str) -> dict:
        """Stop, write the Chrome trace, count the device's events."""
        out: dict = {"path": None}
        try:
            if self.card:
                import torch

                torch.cuda.synchronize()
            self.prof.stop()
            path = os.path.join(out_dir, f"profilez-{time.time_ns()}.trace.json")
            self.prof.export_chrome_trace(path)
        except Exception as err:  # noqa: BLE001
            out["error"] = f"{type(err).__name__}: {err}"
            return out
        finally:
            self.prof = None
        cats = _CARD_CATEGORIES if self.card else _CPU_CATEGORIES
        kernels: dict = {}
        try:
            with open(path) as fh:
                events = json.load(fh).get("traceEvents", [])
        except (OSError, ValueError) as err:
            out["error"] = f"unreadable trace {path}: {err}"
            return out
        for evt in events:
            if evt.get("ph") == "X" and evt.get("cat") in cats:
                name = str(evt.get("name", ""))
                kernels[name] = kernels.get(name, 0) + 1
        out.update(
            path=path,
            device="cuda" if self.card else "cpu",
            device_events=sum(kernels.values()),
            kernels=kernels,
        )
        if not kernels:
            out["error"] = (
                "the profiler recorded no "
                + ("kernel on the card" if self.card else "CPU operator")
                + " in the window (an idle device, or a profiler that stopped recording)"
            )
        return out


def capture(
    seconds: float = 0.5, out_dir: Optional[str] = None, *, device: DeviceLike = None
) -> dict:
    """Capture one fixed-length profiler window.

    Returns ``{"ok", "dir", "path", "host_anchor_us", "seconds",
    "device", "device_events", "kernels"}`` — ``path`` is the Chrome trace
    the window produced; ``ok`` is False, with an ``error``, when the
    profiler is unavailable, already busy, or recorded nothing on the
    device.

    Without ``out_dir`` the capture lands in one per-process directory
    that is PRUNED before each new window — copy the file before
    requesting another.  An explicit ``out_dir`` is never pruned.
    """
    seconds = min(MAX_SECONDS, max(MIN_SECONDS, float(seconds)))
    if not _lock.acquire(blocking=False):
        return {"ok": False, "error": "busy: a profiler window is already open"}
    try:
        out_dir = out_dir or _default_capture_dir()
        os.makedirs(out_dir, exist_ok=True)
        session = _Session(device)
        err = session.start()
        if err is not None:
            return {"ok": False, "error": err, "dir": out_dir}
        anchor_us = time.perf_counter_ns() // 1000
        time.sleep(seconds)
        meta = {"dir": out_dir, "host_anchor_us": anchor_us, "seconds": seconds}
        meta.update(session.stop(out_dir))
        meta["ok"] = "error" not in meta
        return meta
    finally:
        _lock.release()


@contextmanager
def window(out_dir: str, *, device: DeviceLike = None):
    """Profile everything inside the block.

    Yields the capture metadata dict; ``path`` / ``ok`` are filled in when
    the block exits (read them AFTER the with-statement).  A profiler that
    fails to start yields ``ok: False`` and the block runs unprofiled.
    """
    meta: dict = {"ok": False, "dir": out_dir, "path": None}
    if not _lock.acquire(blocking=False):
        meta["error"] = "busy: a profiler window is already open"
        yield meta
        return
    session = None
    try:
        try:
            os.makedirs(out_dir, exist_ok=True)
        except OSError as mkdir_err:
            meta["error"] = f"{type(mkdir_err).__name__}: {mkdir_err}"
            yield meta
            return
        session = _Session(device)
        err = session.start()
        if err is None:
            meta["host_anchor_us"] = time.perf_counter_ns() // 1000
        else:
            meta["error"] = err
            session = None
        yield meta
    finally:
        if session is not None:
            meta.update(session.stop(out_dir))
            meta["ok"] = "error" not in meta
        _lock.release()
