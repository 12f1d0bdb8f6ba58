"""The plain reference's verdict on a signature: does it recover, from the
keccak-256 of the bytes that were signed, to the address it claims, and is
that address a member of the committee?

That is the predicate go-ibft's ``IsValidValidator`` and
``IsValidCommittedSeal`` state (an envelope's signature over its
``PayloadNoSig``, a committed seal's over the proposal hash), worked out here
from the signed bytes alone with :mod:`.keccak` and :mod:`.secp256k1`.

Where the caller knows the private key of a claimed member (the benchmark
made every key from the seed), a signature is first compared with the one
that key makes deterministically, with the benchmark signer's nonce
``keccak256(d || digest || 0) mod N``: equal bytes are a valid signature of
that key, at about a sixth of a recovery's cost.  Every other signature, and any
the comparison does not settle, is recovered.  The work runs on worker
processes (``spawn``), which import nothing but this package.
"""

from __future__ import annotations

import multiprocessing
from concurrent.futures import ProcessPoolExecutor
from typing import Dict, List, Optional, Sequence, Tuple

from . import secp256k1
from .keccak import keccak256_many


def _pmap(fn, jobs: list, workers: int) -> list:
    """``fn`` over chunks of ``jobs`` on ``workers`` processes, in order."""
    if workers <= 1 or len(jobs) < 256:
        return fn(jobs)
    step = (len(jobs) + 4 * workers - 1) // (4 * workers)
    chunks = [jobs[i : i + step] for i in range(0, len(jobs), step)]
    ctx = multiprocessing.get_context("spawn")
    with ProcessPoolExecutor(max_workers=workers, mp_context=ctx) as pool:
        parts = list(pool.map(fn, chunks))
    return [x for part in parts for x in part]


def _recover_chunk(jobs: List[Tuple[int, int, int, int]]) -> List[Optional[Tuple[int, int]]]:
    return [secp256k1.recover(z, r, s, v) for z, r, s, v in jobs]


def _resign_chunk(jobs: List[Tuple[int, bytes, bytes]]) -> List[bool]:
    nonces = keccak256_many([d.to_bytes(32, "big") + digest + b"\x00" for d, digest, _sig in jobs])
    return [secp256k1.signature_of(d, secp256k1.digest_scalar(digest), int.from_bytes(k, "big") % secp256k1.N) == sig
            for (d, digest, sig), k in zip(jobs, nonces)]


def recover_many(jobs: Sequence[Tuple[int, int, int, int]], workers: int) -> List[Optional[Tuple[int, int]]]:
    """``recover(z, r, s, v)`` of each job, in order, on ``workers`` processes."""
    return _pmap(_recover_chunk, list(jobs), workers)


def signer_addresses(items: Sequence[Tuple[bytes, bytes]], workers: int) -> List[Optional[bytes]]:
    """The address each ``(digest, 65-byte signature)`` recovers to, or
    ``None``."""
    jobs = []
    for digest, sig in items:
        jobs.append((secp256k1.digest_scalar(digest), int.from_bytes(sig[:32], "big"),
                     int.from_bytes(sig[32:64], "big"), sig[64] if len(sig) == 65 else -1))
    points = recover_many(jobs, workers)
    live = [i for i, pt in enumerate(points) if pt is not None]
    hashes = keccak256_many([points[i][0].to_bytes(32, "big") + points[i][1].to_bytes(32, "big") for i in live])
    out: List[Optional[bytes]] = [None] * len(items)
    for i, h in zip(live, hashes):
        out[i] = h[12:]
    return out


def verdicts(items: Sequence[Tuple[bytes, bytes, bytes]], members, workers: int,
             keys: Optional[Dict[bytes, bytes]] = None) -> List[bool]:
    """For each ``(signed bytes, signature, claimed address)``: whether the
    signature recovers to the claimed address and that address is a member.
    ``keys`` maps a member's address to its 32-byte private key, where the
    caller knows it."""
    items = list(items)
    keys = keys or {}
    signed = sorted({m for m, _sig, _claimed in items})
    digest_of = dict(zip(signed, keccak256_many(signed)))
    out: List[Optional[bool]] = [None] * len(items)
    known = [i for i, (_m, _sig, claimed) in enumerate(items) if claimed in members and claimed in keys]
    same = _pmap(_resign_chunk, [(int.from_bytes(keys[items[i][2]], "big"), digest_of[items[i][0]], items[i][1])
                                 for i in known], workers)
    for i, ok in zip(known, same):
        if ok:
            out[i] = True
    rest = [i for i, v in enumerate(out) if v is None]
    addrs = signer_addresses([(digest_of[items[i][0]], items[i][1]) for i in rest], workers)
    for i, a in zip(rest, addrs):
        claimed = items[i][2]
        out[i] = a is not None and a == claimed and claimed in members
    return out
