"""Spawn one real boot leg (``python -m go_ibft_tpu_torch.boot``) and parse
it (the port of the JAX package's ``boot/restart.py``).

Restart-to-first-finalized is measured by restarting FOR REAL: a fresh
interpreter, a fresh torch, one shared kernel build cache.  This module
must stay import-light: the PARENT imports it, and pulling torch in here
would distort the very spawn cost the legs measure.

Differences from the JAX file: the child is the port's boot module, keyed
off ``GO_IBFT_TORCH_CACHE_DIR`` (the kernel build cache and the sidecars),
and takes ``--device`` (``None``: the card) and ``--no-chain``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from typing import Optional

__all__ = ["BootLegTimeout", "run_boot_leg"]


class BootLegTimeout(RuntimeError):
    """A boot leg exceeded its wall budget (the child was killed)."""

    def __init__(self, tag: str, timeout_s: float):
        super().__init__(f"boot leg {tag!r} exceeded {timeout_s:.0f}s")
        self.tag = tag
        self.timeout_s = timeout_s


def run_boot_leg(
    tag: str,
    family: str,
    cache_dir: str,
    ledger_path: str,
    *,
    timeout_s: float,
    cwd: Optional[str] = None,
    device: Optional[str] = None,
    chain: bool = True,
) -> dict:
    """Run one restart leg; return ``{spawn_ms, report, events}``.

    ``family`` is the comma-separated registry keys to restore (``""``:
    all).  The child keys its kernel build cache off ``cache_dir`` alone
    and writes its compile ledger to ``ledger_path`` so the caller can
    assert a cached leg recorded ZERO compile events.  Raises
    :class:`BootLegTimeout` when the wall budget runs out and
    ``RuntimeError`` on a nonzero child exit.
    """
    env = dict(os.environ)
    env["GO_IBFT_TORCH_CACHE_DIR"] = cache_dir
    env["GO_IBFT_COMPILE_LEDGER"] = ledger_path
    cmd = [sys.executable, "-m", "go_ibft_tpu_torch.boot", "--programs", family]
    if device:
        cmd += ["--device", device]
    if not chain:
        cmd.append("--no-chain")
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, env=env, cwd=cwd, timeout=timeout_s)
    except subprocess.TimeoutExpired:
        raise BootLegTimeout(tag, timeout_s) from None
    spawn_ms = (time.perf_counter() - t0) * 1e3
    if proc.returncode != 0:
        raise RuntimeError(f"boot leg {tag} rc={proc.returncode}: " + proc.stderr.strip()[-300:])
    report = json.loads(proc.stdout.strip().splitlines()[-1])
    events = []
    if os.path.exists(ledger_path):
        with open(ledger_path) as fh:
            events = [json.loads(ln) for ln in fh if ln.strip()]
    return {"spawn_ms": spawn_ms, "report": report, "events": events}
