"""The kernel build cache (the port's counterpart of the JAX package's
``utils/jaxcache.py``).

In the JAX package a cold program costs an XLA compile and the persistent
compilation cache turns it into a load.  Here a cold program costs an
``nvcc`` build of its CUDA source (:mod:`go_ibft_tpu_torch._build`, seconds
to tens of seconds a source) and a warm one a ``ctypes`` load of the
library a build left behind.  One directory holds both the libraries and
the boot store's sidecars (``<dir>/aot/``, :mod:`go_ibft_tpu_torch.boot.aot`),
so a restart that finds one finds the other.

The directory resolves ``path`` argument > ``GO_IBFT_TORCH_CACHE_DIR`` (the
counterpart of the JAX package's ``GO_IBFT_CACHE_DIR``) > the default
``build/torch_kernels/`` at the root of the checkout.  Growth is bounded as
in the JAX package: entries older than ``GO_IBFT_CACHE_TTL_S`` are dropped
and, past ``GO_IBFT_CACHE_MAX_BYTES``, the oldest go first.  A library's
file name carries the hash of its source, headers and flags
(``_build._target``), so a stale library can never load as a wrong kernel.

Differences from the JAX file: no JAX configuration is touched;
:func:`enable_persistent_cache` points ``_build.BUILD_DIR`` at the directory
instead, and ``GO_IBFT_CACHE_MIN_COMPILE_S`` has no counterpart (every
build is kept).
"""

from __future__ import annotations

import os
import time
from pathlib import Path
from typing import Optional, Tuple

__all__ = ["DEFAULT_DIR", "enable_persistent_cache", "prune_cache", "resolve_cache_dir"]

DEFAULT_DIR = str(Path(__file__).resolve().parent.parent.parent / "build" / "torch_kernels")

DEFAULT_MAX_BYTES = 4 << 30  # 4 GiB
DEFAULT_TTL_S = 30 * 24 * 3600.0  # 30 days

_enabled: Optional[str] = None


def resolve_cache_dir(path: Optional[str] = None) -> str:
    """The directory :func:`enable_persistent_cache` would select."""
    if _enabled is not None and path is None:
        return _enabled
    return path or os.environ.get("GO_IBFT_TORCH_CACHE_DIR") or DEFAULT_DIR


def enable_persistent_cache(path: Optional[str] = None) -> str:
    """Point the kernel builds at the resolved directory; prune it once a
    process.  Returns the effective directory.  Idempotent: once enabled,
    a call without ``path`` returns the same directory."""
    global _enabled
    target = resolve_cache_dir(path)
    if _enabled == target:
        return target
    from .. import _build

    os.makedirs(target, exist_ok=True)
    prune_cache(target)
    _build.BUILD_DIR = Path(target)
    _enabled = target
    return target


def prune_cache(
    path: Optional[str] = None,
    *,
    max_bytes: Optional[int] = None,
    max_age_s: Optional[float] = None,
    now: Optional[float] = None,
) -> Tuple[int, int]:
    """Bound the cache: drop stale entries, evict oldest-first.

    Never raises — a concurrently-pruning sibling process or a read-only
    cache degrades to a no-op.  Returns ``(files_removed, bytes_removed)``.
    """
    target = path or resolve_cache_dir()
    if max_bytes is None:
        max_bytes = int(os.environ.get("GO_IBFT_CACHE_MAX_BYTES", DEFAULT_MAX_BYTES))
    if max_age_s is None:
        max_age_s = float(os.environ.get("GO_IBFT_CACHE_TTL_S", DEFAULT_TTL_S))
    ts = time.time() if now is None else now
    entries = []  # (mtime, size, path)
    try:
        for root, _dirs, files in os.walk(target):
            for name in files:
                p = os.path.join(root, name)
                try:
                    st = os.stat(p)
                except OSError:
                    continue
                entries.append((st.st_mtime, st.st_size, p))
    except OSError:
        return (0, 0)
    removed = freed = 0

    def _rm(size: int, p: str) -> None:
        nonlocal removed, freed
        try:
            os.remove(p)
        except OSError:
            return
        removed += 1
        freed += size

    live = []
    for mtime, size, p in entries:
        if max_age_s > 0 and ts - mtime > max_age_s:
            _rm(size, p)
        else:
            live.append((mtime, size, p))
    if max_bytes > 0:
        total = sum(size for _m, size, _p in live)
        for mtime, size, p in sorted(live):  # oldest first
            if total <= max_bytes:
                break
            _rm(size, p)
            total -= size
    return (removed, freed)
