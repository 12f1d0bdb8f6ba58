"""Build and load the port's CUDA kernels.

Each source in ``csrc/`` is compiled by ``nvcc`` into a shared library with
a plain C interface, loaded with ``ctypes``:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -Xptxas -v -I csrc \
         -o build/torch_kernels/<name>-<key>.so csrc/<name>.cu

The build happens at first use, into the kernel build cache
(:mod:`go_ibft_tpu_torch.utils.buildcache`: ``GO_IBFT_TORCH_CACHE_DIR``, by
default ``build/torch_kernels/`` at the root of the checkout), keyed by a
hash of the source, of every shared header (``csrc/*.cuh``) and of the
flags, so a changed source or header rebuilds and an unchanged one loads.
:func:`build_all` starts one ``nvcc`` per source, all at once, and reports
which sources it compiled and which it found built.  Processes that build
at once stay safe: each compiles to a file of its own and renames it into
place.  A failed build raises with the compiler's output; nothing falls
back.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, Tuple

from .utils.buildcache import resolve_cache_dir

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(resolve_cache_dir())
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ARCH_FLAGS + (
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-I", str(CSRC),
)

# The C entry points of each source: name -> (argtypes, restype).
_P = ctypes.c_void_p
SIGNATURES = {
    "keccak_f1600": {
        "keccak_f1600": ([_P, _P, ctypes.c_longlong, _P], ctypes.c_int),
        "keccak256_digest": (
            [_P, _P, _P, ctypes.c_longlong, ctypes.c_int, ctypes.c_int, _P], ctypes.c_int
        ),
    },
    "bls12_381": {
        "bls_merge": (
            [_P, _P, ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int, _P, _P, _P],
            ctypes.c_int,
        ),
        "bls_miller": ([_P, _P, ctypes.c_longlong, _P, _P], ctypes.c_int),
        "bls_final_exp": ([_P, _P, ctypes.c_longlong, _P, _P, _P], ctypes.c_int),
    },
    "secp256k1_recover": {
        "secp256k1_recover": (
            [_P, ctypes.c_int, _P, _P, _P, _P, _P, _P, _P, _P, ctypes.c_longlong, _P],
            ctypes.c_int,
        ),
    },
    "secp256k1_ecmul2": {
        "secp256k1_ecmul2": ([_P] * 8 + [ctypes.c_longlong, _P], ctypes.c_int),
        "secp256k1_verify": ([_P] * 7 + [ctypes.c_longlong, _P], ctypes.c_int),
    },
    "certify_lanes": {
        "certify_lanes": (
            [_P, _P, _P, _P, ctypes.c_longlong, _P, _P, _P, ctypes.c_longlong, ctypes.c_int,
             ctypes.c_longlong] + [ctypes.c_longlong] * 4 + [_P] * 4 + [_P, _P],
            ctypes.c_int,
        ),
    },
}

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}
build_logs: Dict[str, str] = {}  # nvcc output per source (-Xptxas -v report)


_count_lock = threading.Lock()


def count_launch(wrapper) -> None:
    """Add one to ``wrapper.launches``, the count of its kernel's launches
    (locked: the chain's worker threads launch beside the event loop)."""
    with _count_lock:
        wrapper.launches += 1


def find_nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is")


def _target(name: str) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def source_key() -> str:
    """One hash over every source's build key (the boot store's
    fingerprint: a changed source, header or flag makes old sidecars
    stale)."""
    h = hashlib.sha256()
    for name in sorted(SIGNATURES):
        h.update(_target(name).name.encode())
    return h.hexdigest()[:16]


class BuildResult(dict):
    """The paths of :func:`build_all`'s libraries (``name -> path``), and
    what the call did: ``compiled``, the sources it ran ``nvcc`` on, and
    ``ready``, those whose library it found already built."""

    compiled: Tuple[str, ...] = ()
    ready: Tuple[str, ...] = ()
    build_s: float = 0.0


def build_all(names: Iterable[str] = tuple(SIGNATURES)) -> BuildResult:
    """Compile every missing library of ``names`` in parallel; return their
    paths and what was compiled (:class:`BuildResult`)."""
    t0 = time.perf_counter()
    names = list(names)
    targets = BuildResult((n, _target(n)) for n in names)
    todo = [n for n in names if not targets[n].exists()]
    targets.compiled = tuple(todo)
    targets.ready = tuple(n for n in names if n not in todo)
    if todo:
        nvcc = find_nvcc()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        procs = {}
        for n in todo:
            tmp = targets[n].with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
            procs[n] = (tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
            ))
        failed = []
        for n, (tmp, proc) in procs.items():
            out, _ = proc.communicate()
            build_logs[n] = out
            if proc.returncode != 0:
                failed.append(f"{n}.cu (exit {proc.returncode}):\n{out}")
                tmp.unlink(missing_ok=True)
            else:
                os.replace(tmp, targets[n])  # atomic: readers never see half a file
        if failed:
            raise RuntimeError("nvcc failed for " + "\n".join(failed))
    targets.build_s = time.perf_counter() - t0
    return targets


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build_all([name])[name]))
            for fn, (argtypes, restype) in SIGNATURES[name].items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = restype
            _loaded[name] = lib
        return lib
