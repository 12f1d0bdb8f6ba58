"""The AOT program store: restore every program before the first round (the
port of the JAX package's ``boot/aot.py``).

What a restart pays here is not an XLA compile but, per program, the
``nvcc`` build of the CUDA sources its kernels come from
(:func:`go_ibft_tpu_torch._build.build_all`, into the kernel build cache of
:mod:`go_ibft_tpu_torch.utils.buildcache`) and the first launch of its
kernels on the card (the ``ctypes`` load of the library included).
Artifacts live in two layers under the cache directory
(``GO_IBFT_TORCH_CACHE_DIR``):

* **the built libraries** — one ``<source>-<key>.so`` a CUDA source, the
  key a hash of the source, its headers and the flags, so a stale library
  can never load as a wrong kernel; at worst the key misses and the build
  runs cold;
* **``<cache_dir>/aot/``** — this store's sidecars: one JSON per pinned
  program recording the :func:`fingerprint` (torch and CUDA versions, the
  card, the device count, the ``nvcc`` release, the source key) and the
  measured times.  A sidecar minted under another fingerprint marks the
  program stale: it never counts as cached.

Cold vs cached is read off the build, not off a clock: :meth:`AOTStore.ensure`
builds every source its programs need in one :func:`~go_ibft_tpu_torch.
_build.build_all` call (one ``nvcc`` a source, all at once), and a program
is ``"cold"`` when one of its sources was compiled in that call, ``"cached"``
when all its libraries were there already.  Cold restores are recorded to
the cost ledger (``compile_ledger.jsonl`` when enabled), which is how the
second-boot zero-cold proof reads its evidence.

Differences from the JAX file: ``device`` (``None``: the card) is where the
programs run; on the CPU (asked for: the tests) nothing is built, each
program runs its plain path once, and its status is ``"cached"`` with
``compile_ms`` 0 and a ``reason`` saying no build is needed there; there is
no ``cold_threshold_s``; ``export=True`` records the program's library
files in its sidecar (there is no serialized program to write).  A fault
on the card (a failed build or launch) propagates.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import os
import re
import subprocess
import tempfile
import time
from typing import Dict, Iterable, Optional, Sequence, Tuple

from ..obs import ledger as cost_ledger
from ..utils.buildcache import enable_persistent_cache, resolve_cache_dir
from ..utils.device import DeviceLike
from .registry import ProgramUnavailable, program_registry, program_sources

__all__ = [
    "AOTStore",
    "ProgramStatus",
    "family_of",
    "fingerprint",
    "load_manifest",
    "write_manifest",
]

# Registry keys are ``<family>_<shape suffix>`` (``_8l``, ``_128v``,
# ``_dp4``); ledger events carry bare family names.
_SHAPE_SUFFIX = re.compile(r"(_dp\d+|_\d+[lv])$")

CPU_REASON = "no build is needed on the CPU: the program ran its plain path"


def family_of(program: str) -> str:
    """Strip shape suffixes iteratively (``mesh_verify_mask_8l_dp4`` ->
    ``mesh_verify_mask``)."""
    while True:
        stripped = _SHAPE_SUFFIX.sub("", program)
        if stripped == program:
            return program
        program = stripped


@functools.lru_cache(maxsize=1)
def _nvcc_release() -> Optional[str]:
    """``nvcc --version``'s release (``"12.4, V12.4.131"``), or None where
    there is no CUDA toolkit."""
    from .. import _build

    try:
        out = subprocess.run(
            [_build.find_nvcc(), "--version"], capture_output=True, text=True, timeout=60
        ).stdout
    except (RuntimeError, OSError, subprocess.SubprocessError):
        return None
    m = re.search(r"release ([^\n]+)", out)
    return m.group(1).strip() if m else None


def fingerprint() -> dict:
    """The artifact-validity key of this process: the torch and CUDA
    versions, the card and the device count, the ``nvcc`` release and the
    kernel source key.  Program family and shape suffix join it per
    sidecar (the sidecar file name IS the registry key)."""
    import torch

    from .. import _build

    if torch.cuda.is_available():
        device, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    else:
        device, count = "none", 0
    return {
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "device": device,
        "device_count": count,
        "nvcc": _nvcc_release(),
        "sources": _build.source_key(),
    }


@dataclasses.dataclass
class ProgramStatus:
    """One program's restore outcome."""

    program: str
    family: str
    status: str  # "cold" | "cached" | "skipped"
    compile_ms: float = 0.0
    lower_ms: float = 0.0
    reason: Optional[str] = None
    exported: bool = False


class AOTStore:
    """Build and warm pinned program families through the kernel build
    cache, with sidecar bookkeeping for skip/report decisions.

    ``cache_dir=None`` resolves through :mod:`~go_ibft_tpu_torch.utils.
    buildcache` (explicit > ``GO_IBFT_TORCH_CACHE_DIR`` > default);
    :meth:`ensure` points the kernel builds at it.  ``device`` is where the
    programs run (``None``: the card).
    """

    def __init__(
        self,
        cache_dir: Optional[str] = None,
        *,
        device: DeviceLike = None,
        site: str = "boot/aot.py",
    ) -> None:
        self.cache_dir = cache_dir or resolve_cache_dir()
        self.store_dir = os.path.join(self.cache_dir, "aot")
        self.device = device
        self.site = site

    # -- sidecars --------------------------------------------------------

    def _sidecar_path(self, program: str) -> str:
        return os.path.join(self.store_dir, f"{program}.json")

    def read_sidecar(self, program: str) -> Optional[dict]:
        try:
            with open(self._sidecar_path(program)) as fh:
                return json.load(fh)
        except (OSError, ValueError):
            return None

    def _write_sidecar(self, program: str, payload: dict) -> None:
        """Atomic write, never raising (a read-only store degrades to no
        bookkeeping, not a boot fault)."""
        try:
            os.makedirs(self.store_dir, exist_ok=True)
            fd, tmp = tempfile.mkstemp(dir=self.store_dir, prefix=f".{program}.", suffix=".tmp")
            with os.fdopen(fd, "w") as fh:
                json.dump(payload, fh)
            os.replace(tmp, self._sidecar_path(program))
        except OSError:
            pass

    def cached_programs(self) -> set:
        """Registry keys whose sidecar fingerprint matches THIS process —
        programs a prior boot warmed into the same cache under the same
        toolchain and card.  A mismatched sidecar is stale: the caller
        rebuilds (recorded cold), never trusts it."""
        fp = fingerprint()
        out = set()
        for program in program_registry():
            side = self.read_sidecar(program)
            if side is not None and side.get("fingerprint") == fp and side.get("status") in ("cold", "cached"):
                out.add(program)
        return out

    # -- restore ---------------------------------------------------------

    def pinned_programs(self) -> Tuple[str, ...]:
        return tuple(program_registry())

    def ensure(
        self,
        programs: Optional[Sequence[str]] = None,
        *,
        record: bool = True,
        export: bool = False,
    ) -> Dict[str, ProgramStatus]:
        """Restore ``programs`` (default: every pinned family).

        On the card: build every source the programs need (one
        ``build_all``), then run each program once at its registry shape
        and synchronize.  A program one of whose sources the build
        compiled is ``"cold"`` (its ``compile_ms`` the build's wall plus its
        first run) and is recorded to the cost ledger when ``record``; one
        whose libraries were all built already is ``"cached"`` (its
        ``compile_ms`` its first run: the library load and the launches).
        On the CPU every program runs its plain path once and is
        ``"cached"`` with ``compile_ms`` 0.
        """
        import torch

        from .. import _build
        from ..utils.device import resolve_device

        dev = resolve_device(self.device)
        card = dev.type == "cuda"
        registry = program_registry(programs, device=dev)
        compiled: set = set()
        build_ms = 0.0
        if card:
            enable_persistent_cache(self.cache_dir)
            needed = sorted({src for p in registry for src in program_sources(p)})
            if needed:
                built = _build.build_all(needed)
                compiled = set(built.compiled)
                build_ms = built.build_s * 1e3
        fp = fingerprint()
        out: Dict[str, ProgramStatus] = {}
        for program, build in registry.items():
            family = family_of(program)
            sources = program_sources(program)
            try:
                t0 = time.perf_counter()
                fn, args = build()
            except ProgramUnavailable as exc:
                out[program] = ProgramStatus(program, family, "skipped", reason=str(exc))
                continue
            t1 = time.perf_counter()
            fn(*args)
            if card:
                torch.cuda.synchronize(dev)
            run_ms = (time.perf_counter() - t1) * 1e3
            if not card:
                status = ProgramStatus(program, family, "cached", lower_ms=(t1 - t0) * 1e3, reason=CPU_REASON)
            elif compiled.intersection(sources):
                status = ProgramStatus(program, family, "cold", compile_ms=build_ms + run_ms,
                                       lower_ms=(t1 - t0) * 1e3)
            else:
                status = ProgramStatus(program, family, "cached", compile_ms=run_ms, lower_ms=(t1 - t0) * 1e3)
            if status.status == "cold" and record:
                cost_ledger.record_compile(family, status.compile_ms, site=self.site)
            libraries = [_build._target(src).name for src in sources] if card else []
            status.exported = export and bool(libraries)
            out[program] = status
            self._write_sidecar(
                program,
                {
                    "program": program,
                    "family": family,
                    "fingerprint": fp,
                    "device": str(dev),
                    "status": status.status,
                    "compile_ms": round(status.compile_ms, 3),
                    "lower_ms": round(status.lower_ms, 3),
                    "sources": list(sources),
                    "compiled": sorted(compiled.intersection(sources)),
                    "exported": status.exported,
                    **({"libraries": libraries} if status.exported else {}),
                    "ts": time.time(),
                },
            )
        return out


# -- the machine-readable AOT manifest -----------------------------------


def write_manifest(
    path: str,
    programs: Dict[str, dict],
    *,
    sizes: Iterable[int] = (),
) -> dict:
    """Write the AOT manifest: measured per-family compile cost under a
    fingerprint.  ``programs`` maps family -> ``{"compile_ms": float,
    "events": int}`` (the cost-ledger snapshot's compile table)."""
    doc = {
        "fingerprint": fingerprint(),
        "generated_ts": time.time(),
        "sizes": sorted(int(s) for s in sizes),
        "programs": {
            name: {
                "compile_ms": round(float(acc.get("compile_ms", 0.0)), 3),
                "events": int(acc.get("events", 0)),
            }
            for name, acc in sorted(programs.items())
        },
    }
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, prefix=".aot_manifest.", suffix=".tmp")
    with os.fdopen(fd, "w") as fh:
        json.dump(doc, fh, indent=1)
        fh.write("\n")
    os.replace(tmp, path)
    return doc


def load_manifest(path: str) -> Optional[dict]:
    """Read a manifest; adds ``"stale"`` (fingerprint mismatch with THIS
    process — consumers must treat every family as a cold candidate)."""
    try:
        with open(path) as fh:
            doc = json.load(fh)
    except (OSError, ValueError):
        return None
    doc["stale"] = doc.get("fingerprint") != fingerprint()
    return doc
