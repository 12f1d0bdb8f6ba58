"""Pre-signed traffic: the pools that a run replays.

Signing on the fly cannot keep up with a validator (a 100-validator height
carries about 300 signatures), so a run signs a pool at set-up and replays
it.  The shapes are frozen copies of the port's generators:

* :func:`live_pool`, ``go_ibft_tpu_torch/bench/engine.py``'s
  ``Committee.schedule``: each height's PREPREPARE from its proposer, then a
  PREPARE and a COMMIT from every other validator; a Byzantine validator's
  PREPARE carries a corrupt envelope signature and its COMMIT a corrupt
  committed seal inside a validly signed envelope (byte 5 of the signature
  flipped, which recovers another key or none).  The seed picks which
  validators are Byzantine; where their messages arrive is the same for
  every seed (:func:`arrival_order`), so that every seed offers the same
  batches;
* :func:`sync_pool`, ``go_ibft_tpu_torch/bench/chain.py``'s finalized blocks
  and ``corrupt_seals``: proposals with the committed seals of a quorum,
  which a peer relabels to any height (a seal signs the proposal hash,
  ``keccak(Proposal{raw, round})``, and not the height).

Every signed item is also kept as a :class:`Lane` (what was signed, the
signature, the address it claims), which is what the plain reference checks.
The signatures of a pool are cached under ``build/portbench/pools`` by a hash
of everything that made them, so a later run with the same seed only loads
them; the rest is rebuilt, which is cheap.
"""

from __future__ import annotations

import hashlib
import multiprocessing
import os
from concurrent.futures import ProcessPoolExecutor
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

import numpy as np

from . import paths, signer, wire
from .committee import Committee


@dataclass(frozen=True)
class Lane:
    """One signature the traffic offers: ``signed`` is hashed to the digest
    (an envelope without its signature, or an encoded ``Proposal`` for a
    committed seal), ``claimed`` the address it claims."""

    kind: str  # "envelope" or "seal"
    height: int
    claimed: bytes
    signed: bytes
    signature: bytes


@dataclass
class LiveHeight:
    height: int
    proposer: int
    raw: bytes
    proposal_hash: bytes
    preprepare: bytes
    prepares: List[bytes]
    commits: List[bytes]
    seals: Dict[bytes, bytes]  # signer address -> committed seal
    carriers: Dict[bytes, bytes]  # committed seal -> the signature of the COMMIT envelope carrying it


@dataclass
class LivePool:
    committee: Committee
    me: int
    bad: List[int]
    heights: List[LiveHeight]
    lanes: Dict[bytes, Lane] = field(default_factory=dict)  # by signature


@dataclass
class SyncPool:
    committee: Committee
    proposals: List[Tuple[bytes, bytes]]  # (raw, proposal hash)
    seals: List[List[Tuple[bytes, bytes]]]  # per proposal: (signer, seal)
    tampered: List[Tuple[int, int, bytes]]  # (proposal, seal index, bad seal)
    lanes: Dict[bytes, Lane] = field(default_factory=dict)


def _corrupt(sig: bytes) -> bytes:
    return sig[:5] + bytes([sig[5] ^ 0xFF]) + sig[6:]


def arrival_order(others: List[int], bad: set) -> List[int]:
    """``others`` in arrival order: the Byzantine ones at evenly spread
    places (place ``j`` of ``m`` holds one where ``(j + 1) * b // m``
    steps up), each group in index order."""
    honest = iter([i for i in others if i not in bad])
    byz = [i for i in others if i in bad]
    b, m = len(byz), len(others)
    byz_iter = iter(byz)
    return [next(byz_iter) if (j + 1) * b // m > j * b // m else next(honest) for j in range(m)]


def proposal_bytes(seed: int, height: int, size: int) -> bytes:
    return np.random.default_rng([seed, height]).bytes(size)


def _sign_to(path: str, jobs: np.ndarray, threads: int) -> None:
    """Sign each row of ``jobs`` (a 32-byte key, then a 32-byte digest) and
    save the signatures, one 65-byte row each, at ``path``."""
    sigs = signer.sign_many([(bytes(row[:32]), bytes(row[32:])) for row in jobs], threads)
    tmp = f"{path}.{os.getpid()}.tmp.npy"
    np.save(tmp, np.frombuffer(b"".join(sigs), dtype=np.uint8).reshape(len(sigs), 65))
    os.replace(tmp, path)


def _cached_signatures(key: str, jobs_fn, threads: int) -> List[bytes]:
    """The signatures of ``jobs_fn()``'s ``(key, digest)`` pairs, from the
    cache file named by ``key``.  A missing file is signed by a process of
    its own and then loaded like any other, so that a run that signs and a
    run that loads hold the same objects, made alike, when their windows
    open (on an H100's host, a catch-up window read 12-15 % slower where the
    run had signed in its own process)."""
    name = hashlib.sha256(key.encode()).hexdigest()[:24]
    path = os.path.join(paths.build_dir("pools"), f"{name}.npy")
    jobs = jobs_fn()
    arr = np.load(path) if os.path.exists(path) else None
    if arr is None or arr.shape != (len(jobs), 65):
        rows = np.frombuffer(b"".join(d + z for d, z in jobs), dtype=np.uint8).reshape(len(jobs), 64)
        with ProcessPoolExecutor(max_workers=1, mp_context=multiprocessing.get_context("spawn")) as ex:
            ex.submit(_sign_to, path, rows, threads).result()
        arr = np.load(path)
    return [bytes(row) for row in arr]


def live_pool(n: int, bad_count: int, seed: int, heights: int, size: int, threads: int) -> LivePool:
    """``heights`` consecutive heights from 1 of a ``n``-validator committee
    with ``bad_count`` Byzantine validators, ``size``-byte proposals."""
    committee = Committee(n, seed)
    me = committee.engine_index()
    proposers = [committee.proposer(h) for h in range(1, heights + 1)]
    if me in proposers:
        raise ValueError(f"{heights} heights make the engine under test a proposer (n = {n})")
    bad = committee.choose_bad(bad_count, [me] + proposers)
    bad_set = set(bad)
    plan = []
    for h, p in zip(range(1, heights + 1), proposers):
        raw = proposal_bytes(seed, h, size)
        phash = signer.keccak256(wire.proposal(raw, 0))
        plan.append((h, p, raw, phash, arrival_order([i for i in range(n) if i != p], bad_set)))
    key = f"live|{n}|{bad}|{seed}|{heights}|{size}|spread|" + signer._library_path()

    # Seals first: a COMMIT envelope carries its seal.
    def seal_jobs():
        return [(committee.keys[i], phash) for (_h, _p, _raw, phash, others) in plan for i in others]

    seal_sigs = iter(_cached_signatures(key + "|seals", seal_jobs, threads))
    # (height, signer, kind, payload, unsigned envelope), in arrival order.
    unsigned: List[Tuple[int, int, int, bytes, bytes]] = []
    seals_by_height = []
    for h, p, raw, phash, others in plan:
        items = [(p, wire.PREPREPARE, wire.preprepare_payload(raw, 0, phash))]
        items += [(i, wire.PREPARE, wire.prepare_payload(phash)) for i in others]
        seals = {}
        for i in others:
            seal = next(seal_sigs)
            seals[committee.addresses[i]] = _corrupt(seal) if i in bad_set else seal
        items += [(i, wire.COMMIT, wire.commit_payload(phash, seals[committee.addresses[i]])) for i in others]
        for i, kind, payload in items:
            unsigned.append((h, i, kind, payload, wire.envelope(h, 0, committee.addresses[i], kind, payload)))
        seals_by_height.append(seals)

    def envelope_jobs():
        return [(committee.keys[i], signer.keccak256(body)) for _h, i, _k, _p, body in unsigned]

    env_sigs = iter(_cached_signatures(key + "|envelopes", envelope_jobs, threads))
    pool = LivePool(committee, me, bad, [])
    items = iter(unsigned)
    for (h, p, raw, phash, others), seals in zip(plan, seals_by_height):
        wires = []
        carriers = {}
        for _ in range(1 + 2 * len(others)):
            _h, i, kind, payload, body = next(items)
            sig = next(env_sigs)
            if kind == wire.PREPARE and i in bad_set:
                sig = _corrupt(sig)
            addr = committee.addresses[i]
            pool.lanes[sig] = Lane("envelope", h, addr, body, sig)
            wires.append(wire.envelope(h, 0, addr, kind, payload, sig))
            if kind == wire.COMMIT:
                carriers[seals[addr]] = sig
        for addr, seal in seals.items():
            pool.lanes[seal] = Lane("seal", h, addr, wire.proposal(raw, 0), seal)
        pool.heights.append(LiveHeight(h, p, raw, phash, wires[0], wires[1 : 1 + len(others)],
                                       wires[1 + len(others):], seals, carriers))
    return pool


def sync_pool(n: int, proposals: int, size: int, tampered: int, seed: int, threads: int) -> SyncPool:
    """``proposals`` finalized proposals of a ``n``-validator committee, each
    with the committed seals of a quorum of signers drawn from the seed, and
    ``tampered`` seals with a flipped byte, each at a seeded place."""
    committee = Committee(n, seed)
    rng = np.random.default_rng([seed, 1])
    plan = []
    for k in range(proposals):
        raw = proposal_bytes(seed, k + 1, size)
        phash = signer.keccak256(wire.proposal(raw, 0))
        signers = sorted(rng.choice(n, size=committee.quorum, replace=False).tolist())
        plan.append((raw, phash, signers))
    key = f"sync|{n}|{seed}|{proposals}|{size}|" + signer._library_path()
    sigs = iter(_cached_signatures(
        key, lambda: [(committee.keys[i], phash) for _raw, phash, signers in plan for i in signers], threads))
    pool = SyncPool(committee, [], [], [])
    for raw, phash, signers in plan:
        seals = [(committee.addresses[i], next(sigs)) for i in signers]
        pool.proposals.append((raw, phash))
        pool.seals.append(seals)
        for addr, seal in seals:
            pool.lanes[seal] = Lane("seal", 0, addr, wire.proposal(raw, 0), seal)
    for _ in range(tampered):
        k = int(rng.integers(proposals))
        j = int(rng.integers(committee.quorum))
        addr, seal = pool.seals[k][j]
        bad = _corrupt(seal)
        pool.tampered.append((k, j, bad))
        pool.lanes[bad] = Lane("seal", 0, addr, wire.proposal(pool.proposals[k][0], 0), bad)
    return pool
