"""Hang-proof evidence capture: cached card fingerprint + JSONL writer (the
port of the JAX package's ``obs/evidence.py``).

**1. The card fingerprint.**  A CUDA driver can hang its first call
indefinitely, so a measuring process must never touch the card itself
before a subprocess proved it alive: :func:`probe_fingerprint` runs the
shared subprocess probe (:mod:`go_ibft_tpu_torch.utils.probe` — hard
wall-clock deadline, the parent decides) and memoizes the verdict to
``~/.cache/go_ibft_tpu_torch/probe.json`` (``GO_IBFT_TORCH_PROBE_CACHE``)
with a TTL, so repeated probe points within a TTL window cost one file read
instead of one timeout each.  ``reprobe=True`` bypasses the cache.  The
fingerprint records *how* the verdict was obtained — ``probe:
ok|timeout|error|cached`` — and every evidence line carries it.

**2. The evidence writer.**  Append-only JSONL, one line per record,
flushed (and fsync'd) per record, so a run killed mid-config still leaves
every completed config's evidence on disk.  Each line carries the required
schema fields (``config``, ``metric``, ``backend``, ``probe``, ``ts``) on
top of whatever the caller measured.

Differences from the JAX file: the fingerprint names the card (``platform``
``gpu``, ``kind`` the card's name, ``device_count``) and is pinned to
``CUDA_VISIBLE_DEVICES`` (where the JAX file pinned ``JAX_PLATFORMS``);
the backend label is ``gpu`` for a live card and ``no-card`` otherwise —
it says what ran and offers no CPU route (the JAX file's
``cpu-fallback``); :func:`reprobe_and_capture` runs the given bench script
when the card came alive, into ``evidence_gpu.jsonl``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time
from dataclasses import asdict, dataclass
from typing import List, Optional, Sequence, Tuple

from ..utils.probe import GPU_PLATFORM, probe_default_backend_full

__all__ = [
    "Fingerprint",
    "probe_fingerprint",
    "EvidenceWriter",
    "REQUIRED_EVIDENCE_FIELDS",
    "EVIDENCE_PATH",
    "reprobe_and_capture",
]

# The label of a run without a live card: nothing ran on the device.
NO_CARD = "no-card"

DEFAULT_TTL_S = 900.0

REQUIRED_EVIDENCE_FIELDS = ("config", "metric", "backend", "probe", "ts")


def _cache_path() -> str:
    override = os.environ.get("GO_IBFT_TORCH_PROBE_CACHE")
    if override:
        return override
    return os.path.join(os.path.expanduser("~"), ".cache", "go_ibft_tpu_torch", "probe.json")


@dataclass
class Fingerprint:
    """One probe verdict: what the card looked like, when, and how we
    found out."""

    platform: Optional[str]  # "gpu" for a live card, None when dead/absent
    probe: str  # "ok" | "timeout" | "error" | "cached"
    detail: str  # one-line reason for the log
    probed_at: float  # epoch seconds of the underlying probe
    # Environment pin: a fingerprint probed under one CUDA_VISIBLE_DEVICES
    # must not serve a process that sees other cards.
    env_visible_devices: str = ""
    device_count: Optional[int] = None
    kind: Optional[str] = None  # torch.cuda.get_device_name(0)

    def is_gpu(self) -> bool:
        return self.platform == GPU_PLATFORM

    def backend_label(self) -> str:
        """The evidence-schema backend field: ``gpu`` or ``no-card``."""
        return GPU_PLATFORM if self.is_gpu() else NO_CARD


def _env_pin() -> str:
    return os.environ.get("CUDA_VISIBLE_DEVICES", "")


def _load_cached(path: str, ttl_s: float) -> Optional[Fingerprint]:
    try:
        with open(path) as fh:
            raw = json.load(fh)
        fp = Fingerprint(**raw)
    except (OSError, ValueError, TypeError):
        return None
    if time.time() - fp.probed_at > ttl_s:
        return None
    if fp.env_visible_devices != _env_pin():
        return None
    return fp


def _store_cached(path: str, fp: Fingerprint) -> None:
    # Best-effort atomic write: a read-only $HOME must never cost the
    # caller its probe verdict, and a concurrent reader must never see a
    # torn file.
    try:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path))
        with os.fdopen(fd, "w") as fh:
            json.dump(asdict(fp), fh)
        os.replace(tmp, path)
    except OSError:
        pass


def probe_fingerprint(
    timeout_s: Optional[float] = None,
    *,
    ttl_s: Optional[float] = None,
    reprobe: bool = False,
    cache_path: Optional[str] = None,
) -> Fingerprint:
    """Probe the card, via the TTL'd on-disk cache.

    A fresh cached verdict (younger than ``ttl_s``, same
    ``CUDA_VISIBLE_DEVICES`` pin) is returned with ``probe="cached"``
    without spawning anything; otherwise the subprocess probe runs under
    its hard deadline and the verdict — alive, dead, or hung past the
    deadline — is cached for the next probe point.  This function can
    never block past ``timeout_s``.
    """
    path = cache_path if cache_path is not None else _cache_path()
    if ttl_s is None:
        ttl_s = float(os.environ.get("GO_IBFT_PROBE_TTL", DEFAULT_TTL_S))
    if not reprobe:
        cached = _load_cached(path, ttl_s)
        if cached is not None:
            cached.probe = "cached"
            return cached
    platform, detail, device_count, kind = probe_default_backend_full(timeout_s)
    if platform is not None:
        status = "ok"
    elif detail.startswith("probe timeout"):
        status = "timeout"
    else:
        status = "error"
    fp = Fingerprint(
        platform=platform,
        probe=status,
        detail=detail,
        probed_at=time.time(),
        env_visible_devices=_env_pin(),
        device_count=device_count,
        kind=kind,
    )
    _store_cached(path, fp)
    return fp


class EvidenceWriter:
    """Append-only, per-record-flushed JSONL evidence file.

    The file handle opens in append mode and every :meth:`record` call
    writes exactly one line, flushes, and fsyncs — a crash after config N
    loses nothing before N+1.  ``backend`` and ``probe`` (the schema's
    provenance fields) are stamped on every line from the fingerprint the
    run started with; callers may override per record.
    """

    def __init__(
        self,
        path: str,
        *,
        backend: str = NO_CARD,
        probe: str = "error",
        devices: Optional[int] = None,
        truncate: bool = False,
    ) -> None:
        self.path = path
        self.backend = backend
        self.probe = probe
        self.devices = devices
        self._fh = open(path, "w" if truncate else "a")
        self._configs: List[str] = []
        # Cost-ledger totals at the previous record: each line carries the
        # DELTA since the line before it.
        self._ledger_last: Optional[dict] = None

    def set_provenance(self, backend: str, probe: str, devices: Optional[int] = None) -> None:
        self.backend = backend
        self.probe = probe
        if devices is not None:
            self.devices = devices

    def record(self, config: str, line: Optional[dict] = None, **fields) -> dict:
        """Append one evidence line for ``config``; returns the full record."""
        rec = dict(line or {})
        rec.update(fields)
        rec.setdefault("metric", config)
        rec["config"] = config
        rec.setdefault("backend", self.backend)
        rec.setdefault("probe", self.probe)
        rec.setdefault("devices", self.devices)
        block = self._ledger_block()
        if block is not None:
            rec.setdefault("ledger", block)
        rec["ts"] = time.time()
        self._fh.write(json.dumps(rec) + "\n")
        self._fh.flush()
        try:
            os.fsync(self._fh.fileno())
        except OSError:
            pass
        self._configs.append(config)
        return rec

    def _ledger_block(self) -> Optional[dict]:
        """Cost-ledger delta since the previous record (None when the
        ledger is off)."""
        from . import ledger as cost_ledger

        cur = cost_ledger.totals()
        if cur is None:
            self._ledger_last = None
            return None
        prev = self._ledger_last or {}
        self._ledger_last = cur
        block = {
            key: round(cur[key] - prev.get(key, 0), 3)
            for key in ("dispatches", "live_lanes", "padded_lanes", "device_ms", "compiles", "compile_ms")
        }
        block["occupancy"] = (
            round(block["live_lanes"] / block["padded_lanes"], 4) if block["padded_lanes"] else None
        )
        return block

    def covered(self) -> List[str]:
        """Configs recorded so far, in order."""
        return list(self._configs)

    def missing(self, expected: Sequence[str]) -> List[str]:
        seen = set(self._configs)
        return [c for c in expected if c not in seen]

    def close(self) -> None:
        try:
            self._fh.close()
        except OSError:
            pass

    def __enter__(self) -> "EvidenceWriter":
        return self

    def __exit__(self, *exc) -> bool:
        self.close()
        return False


# ---------------------------------------------------------------------------
# Opportunistic card capture
# ---------------------------------------------------------------------------

EVIDENCE_PATH = "evidence_gpu.jsonl"


def reprobe_and_capture(
    remaining_s: float,
    bench_path: str,
    evidence_path: str = EVIDENCE_PATH,
) -> Tuple[Optional[str], str]:
    """Late re-probe; on a live card, run ``bench_path`` in a subprocess.

    A run that started without a card re-probes near its end (bypassing
    the fingerprint cache) and, when the card came alive, runs the bench
    in a FRESH subprocess, appending the child's output to
    ``evidence_path``.  Returns ``(platform_or_None, detail)``.  The probe
    is clamped well under ``remaining_s`` and the child gets what is left
    minus a reserve, so the parent always finishes its own report.
    """
    if remaining_s < 240.0:
        return None, f"skipped: {remaining_s:.0f}s of budget left"
    fp = probe_fingerprint(min(45.0, remaining_s * 0.15), reprobe=True)
    if not fp.is_gpu():
        return None, (fp.detail if fp.platform is None else f"backend is {fp.platform!r}")
    child_budget = max(120.0, remaining_s - 90.0)
    env = dict(os.environ, GO_IBFT_BENCH_BUDGET_S=str(int(child_budget)))
    # The child gets its OWN per-config evidence file: it would otherwise
    # truncate the parent's, which still has configs left to record.
    env["GO_IBFT_EVIDENCE_PATH"] = evidence_path + ".configs.jsonl"
    try:
        with open(evidence_path, "a") as fh:
            subprocess.run(
                [sys.executable, bench_path],
                stdout=fh,
                stderr=subprocess.DEVNULL,
                timeout=child_budget + 30.0,
                env=env,
                cwd=os.path.dirname(os.path.abspath(bench_path)) or ".",
                check=False,
            )
    except (OSError, subprocess.TimeoutExpired) as err:
        return None, f"evidence run failed: {type(err).__name__}"
    return fp.platform, evidence_path
