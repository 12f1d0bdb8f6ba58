"""The benchmark's host signer: ``portbench/native/signer.cc`` built with
``g++`` and loaded with ``ctypes``.

The source is a frozen copy of the port's native runtime, so the traffic a
seed makes stays the same whatever a later change does to the program.  The
library is built once into ``build/portbench/`` at the root of the checkout,
under a name keyed by a hash of the source, and later runs load it.

Keys come from seeds as the port's ``PrivateKey.from_seed`` makes them:
``d = keccak256(seed) mod N``, or 1 where that is 0.  Signing is the
deterministic ECDSA of the source (low ``s``, ``v`` the recovery id), and a
call releases the interpreter lock, so :func:`sign_many` signs on threads.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from concurrent.futures import ThreadPoolExecutor
from typing import List, Sequence, Tuple

from . import paths

N = 0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEBAAEDCE6AF48A03BBFD25E8CD0364141
SOURCE = os.path.join(paths.BENCH_DIR, "native", "signer.cc")

_lib = None


def _library_path() -> str:
    with open(SOURCE, "rb") as fh:
        key = hashlib.sha256(fh.read()).hexdigest()[:16]
    return os.path.join(paths.build_dir(), f"libportbench_signer-{key}.so")


def load() -> ctypes.CDLL:
    """Build (once per source) and load the signer library."""
    global _lib
    if _lib is not None:
        return _lib
    lib_path = _library_path()
    if not os.path.exists(lib_path):
        tmp = f"{lib_path}.{os.getpid()}.tmp"
        proc = subprocess.run(
            ["g++", "-O2", "-shared", "-fPIC", "-o", tmp, SOURCE],
            capture_output=True, text=True, timeout=300,
        )
        if proc.returncode != 0:
            raise RuntimeError(f"building the signer failed:\n{proc.stderr[-4000:]}")
        os.replace(tmp, lib_path)
    lib = ctypes.CDLL(lib_path)
    lib.ibft_keccak256.argtypes = [ctypes.c_char_p, ctypes.c_size_t, ctypes.c_char_p]
    lib.ibft_keccak256.restype = None
    lib.ibft_ecdsa_sign.argtypes = [ctypes.c_char_p] * 3
    lib.ibft_ecdsa_sign.restype = ctypes.c_int
    lib.ibft_ecdsa_pubkey.argtypes = [ctypes.c_char_p] * 2
    lib.ibft_ecdsa_pubkey.restype = ctypes.c_int
    _lib = lib
    return lib


def keccak256(data: bytes) -> bytes:
    out = ctypes.create_string_buffer(32)
    load().ibft_keccak256(data, len(data), out)
    return out.raw


def key_from_seed(seed: bytes) -> bytes:
    """The 32-byte big-endian private scalar of ``seed``."""
    d = int.from_bytes(keccak256(seed), "big") % N
    return (d or 1).to_bytes(32, "big")


def pubkey(d_be: bytes) -> Tuple[int, int]:
    out = ctypes.create_string_buffer(64)
    if not load().ibft_ecdsa_pubkey(d_be, out):
        raise ValueError("private key out of range")
    raw = out.raw
    return int.from_bytes(raw[:32], "big"), int.from_bytes(raw[32:], "big")


def address(pub: Tuple[int, int]) -> bytes:
    """Ethereum-style address: the last 20 bytes of keccak256(X || Y)."""
    return keccak256(pub[0].to_bytes(32, "big") + pub[1].to_bytes(32, "big"))[12:]


def sign(d_be: bytes, digest: bytes) -> bytes:
    """``r || s || v`` (65 bytes) over a 32-byte digest."""
    out = ctypes.create_string_buffer(65)
    if not load().ibft_ecdsa_sign(d_be, digest, out):
        raise ValueError("private key out of range")
    return out.raw


def sign_many(jobs: Sequence[Tuple[bytes, bytes]], threads: int) -> List[bytes]:
    """Sign ``(private key, digest)`` pairs in order, on ``threads`` threads."""
    load()
    if threads <= 1 or len(jobs) < 64:
        return [sign(d, z) for d, z in jobs]
    step = (len(jobs) + threads - 1) // threads
    parts = [jobs[i : i + step] for i in range(0, len(jobs), step)]
    with ThreadPoolExecutor(max_workers=len(parts)) as pool:
        signed = list(pool.map(lambda part: [sign(d, z) for d, z in part], parts))
    return [sig for part in signed for sig in part]
