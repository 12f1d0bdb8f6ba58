"""Drive the port's multi-tenant and read planes: the shapes of the JAX
package's ``bench.py`` configs #10, #12 and #18 (``chip_smoke.py`` phase 11).

* :func:`build_tenants` and :func:`coalesced_drains` — config #10's oracle
  gate as a load: tenants of the given committee sizes (real secp256k1
  rounds, a quarter of the signatures corrupted, every tenant's round at
  height 1 so that all of them share one proposal hash, one oversize
  PREPREPARE among the envelopes) submit a round's PREPARE senders and
  COMMIT seal lanes from a thread each, all released together, through
  one :class:`~go_ibft_tpu_torch.sched.TenantScheduler`;
  :func:`oracle_masks` is each tenant's sequential ``HostBatchVerifier``
  over Python ints;
* :func:`run_chains` — config #10's chains: one ``ChainRunner`` cluster of
  each committee size, each in an event-loop thread of its own (or one
  after another), every engine a tenant of one scheduler, over config
  #10's asymmetric links;
* :func:`serving_chain`, :func:`schedule`, :class:`RecordingLanes` and
  :func:`proof_flood_qos` — config #12: a finalized chain with
  exactly-quorum seal sets, the overlapping request schedule, a recording
  lane verifier, and a live 4-validator chain on the consensus tier beside
  a proof flood on the read tier;
* :func:`checkpoint_chain` and :func:`structural_checkpointer` — config
  #18: a 16-height chain carrying next-set commitments with a rotation at
  height 10, checkpointed every 4 heights with BLS quorum seals, and the
  lazily signed skip chain of a million heights.
"""

from __future__ import annotations

import asyncio
import threading
import time
from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

import numpy as np

from ..chain import ChainRunner
from ..chain.wal import FinalizedBlock
from ..core import IBFT, BatchingIngress
from ..core.validator_manager import calculate_quorum
from ..crypto import PrivateKey
from ..crypto import bls as hbls
from ..crypto import ecdsa
from ..crypto.backend import ECDSABackend, encode_signature, proposal_hash_of
from ..crypto.keccak import keccak256
from ..crypto.quorum_cert import BLSKeyRegistry
from ..lightsync import Checkpointer, embed_next_set, set_root
from ..messages.helpers import CommittedSeal
from ..messages.wire import Proposal, View
from ..verify import HostBatchVerifier
from .engine import NullLogger
from .workload import _keys, build_signed_round

# config #10's committees and links (seconds): the last node of a chain
# sits "in another region", so its quorum waits on slow links.
CONFIG10_SIZES = (4, 4, 4, 4, 6, 6, 8, 8)
LAT_SLOW, LAT_FAST, LAT_LOCAL = 0.010, 0.002, 0.0005
# An oversize PREPREPARE: its payload exceeds the largest block bucket, so
# its digest comes from the host keccak.
BIG_PROPOSAL = b"\x5a" * 5000


@dataclass
class Tenant:
    """One tenant's lanes: a round's PREPARE senders (and maybe one oversize
    PREPREPARE) and its COMMIT seal lanes, at ``height``."""

    tid: str
    src: object
    senders: list
    lanes: list
    height: int = 1


def build_tenants(sizes: Sequence[int], *, seed0: int = 900, corrupt_frac: float = 0.25,
                  big_at: int = 0) -> List[Tenant]:
    """Config #10's gate tenants (``bench.py`` ``_oracle_gate``: seeds 900,
    901, ..., a quarter of the signatures corrupted); tenant ``big_at``
    also sends an oversize PREPREPARE."""
    out = []
    for i, n in enumerate(sizes):
        seed = seed0 + i
        rnd = build_signed_round(n, seed=seed, corrupt_frac=corrupt_frac)
        keys = _keys(n, seed)
        src = ECDSABackend.static_validators({k.address: 1 for k in keys})
        senders = list(rnd.prepares)
        if i == big_at:
            senders.append(ECDSABackend(keys[0], src).build_preprepare_message(
                BIG_PROPOSAL, None, View(height=rnd.height, round=0)))
        out.append(Tenant(f"t{i}-{n}v", src, senders, [(rnd.proposal_hash, s) for s in rnd.seals], rnd.height))
    return out


def oracle_masks(tenant: Tenant) -> Tuple[np.ndarray, np.ndarray]:
    """The tenant's sequential host oracle over Python ints
    (``recover_pure``, never the native library)."""
    host = HostBatchVerifier(tenant.src, recover_fn=ecdsa.recover_pure)
    return (np.asarray(host.verify_senders(tenant.senders), dtype=bool),
            np.asarray(host.verify_seal_lanes(tenant.lanes, tenant.height), dtype=bool))


def coalesced_drains(sched, tenants: Sequence[Tenant], rounds: int) -> Dict[str, list]:
    """Each tenant registers once; every round all tenants' threads are
    released together and each submits its senders and its seal lanes.
    Returns each tenant's ``(sender mask, seal mask)`` per round."""
    handles = {t.tid: sched.register(t.tid, t.src, chain_id=t.tid) for t in tenants}
    out: Dict[str, list] = {t.tid: [] for t in tenants}
    errors: list = []
    for _ in range(rounds):
        gate = threading.Barrier(len(tenants))

        def drain(t: Tenant):
            try:
                gate.wait()
                h = handles[t.tid]
                out[t.tid].append((h.verify_senders(t.senders), h.verify_seal_lanes(t.lanes, t.height)))
            except BaseException as err:  # noqa: BLE001 - surfaced below
                errors.append(err)

        threads = [threading.Thread(target=drain, args=(t,)) for t in tenants]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        if errors:
            raise errors[0]
    return out


def _link_latency(n: int, receiver: int, sender: int) -> float:
    if receiver == sender:
        return 0.0
    if receiver == n - 1:
        return LAT_FAST if sender == 0 else LAT_SLOW
    return LAT_LOCAL


async def _chain_main(chain: int, n: int, sched, tag: str, heights: int) -> dict:
    keys = [PrivateKey.from_seed(b"bench-c10-%s-%d-%d" % (tag.encode(), chain, i)) for i in range(n)]
    src = ECDSABackend.static_validators({k.address: 1 for k in keys})
    nodes: list = []

    class _Gossip:
        def __init__(self, index):
            self.index = index

        def multicast(self, message):
            loop = asyncio.get_running_loop()
            for j, (_engine, ingress) in enumerate(nodes):
                loop.call_later(_link_latency(n, j, self.index), ingress.submit, message)

    runners = []
    for i, key in enumerate(keys):
        handle = sched.register(f"{tag}-c{chain}/n{i}", src, chain_id=f"c{chain}")
        engine = IBFT(NullLogger(), ECDSABackend(key, src), _Gossip(i), batch_verifier=handle)
        engine.set_base_round_timeout(30.0)
        nodes.append((engine, BatchingIngress(engine.add_messages)))
        runners.append(ChainRunner(engine, overlap=False))
    try:
        await asyncio.wait_for(asyncio.gather(*(r.run(until_height=heights) for r in runners)), 240)
    finally:
        for engine, ingress in nodes:
            ingress.close()
            engine.messages.close()
    return {"chain": chain, "finalized": min(len(engine.backend.inserted) for engine, _ in nodes)}


def run_chains(sched, sizes: Sequence[int], heights: int, *, concurrent: bool, tag: str) -> dict:
    """Config #10's chains through ``sched`` (already started): all at once,
    each in its own event-loop thread, or one after another.  ``starved``
    counts chains that finalized fewer than ``heights``."""
    results: list = []
    errors: list = []

    def one(chain: int, n: int) -> None:
        try:
            results.append(asyncio.run(_chain_main(chain, n, sched, tag, heights)))
        except BaseException as err:  # noqa: BLE001 - surfaced below
            errors.append(f"chain {chain}: {type(err).__name__}: {err}")

    t0 = time.perf_counter()
    if concurrent:
        threads = [threading.Thread(target=one, args=(c, n)) for c, n in enumerate(sizes)]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
    else:
        for c, n in enumerate(sizes):
            one(c, n)
    elapsed = time.perf_counter() - t0
    if errors:
        raise RuntimeError("; ".join(errors[:3]))
    return {
        "elapsed_s": elapsed,
        "blocks_per_s": len(sizes) * heights / elapsed,
        "starved": sum(1 for r in results if r["finalized"] < heights),
        "finalized": sorted((r["chain"], r["finalized"]) for r in results),
    }


# -- config #12: proof serving -------------------------------------------------


class ListSource:
    """A list-backed ``SyncSource`` over a finalized chain."""

    def __init__(self, blocks):
        self.blocks = blocks

    def latest_height(self) -> int:
        return self.blocks[-1].height

    def get_blocks(self, start: int, end: int):
        return [b for b in self.blocks if start <= b.height <= end]


def serving_chain(n: int = 100, heights: int = 4, seed: int = 77):
    """Config #12's finalized chain: exactly-quorum seal sets (the
    steady-state WAL shape).  Returns ``(blocks, validator source, keys)``."""
    keys = _keys(n, seed)
    src = ECDSABackend.static_validators({k.address: 1 for k in keys})
    quorum = calculate_quorum(n)
    blocks = []
    for h in range(1, heights + 1):
        proposal = Proposal(raw_proposal=b"serve bench block %d" % h, round=0)
        phash = proposal_hash_of(proposal)
        blocks.append(FinalizedBlock(h, proposal, [
            CommittedSeal(signer=k.address, signature=encode_signature(*ecdsa.sign(k, phash)))
            for k in keys[:quorum]
        ]))
    return blocks, src, keys


def schedule(heights: int = 4, chunk: int = 2) -> List[Tuple[int, int]]:
    """Config #12's request schedule: overlapping checkpoints over the chain."""
    return [(0, heights), (0, heights), (1, heights), (2, heights), (0, chunk), (1, heights - 1),
            (chunk, heights), (0, heights)]


def tamper(proof, quorum: int):
    """The proof with every quorum seal of its first entry flipped: the
    height falls short of its quorum."""
    bad = []
    for i, seal in enumerate(proof.entries[0].seals):
        sig = seal.signature
        if i < quorum:
            sig = sig[:5] + bytes([sig[5] ^ 0xFF]) + sig[6:]
        bad.append(CommittedSeal(seal.signer, sig))
    proof.entries[0].seals[:] = bad
    return proof, bad


class RecordingLanes:
    """A lane verifier recording every fresh drain's lanes and masks (the
    per-lane oracle gate's surface) on top of ``inner``."""

    def __init__(self, inner):
        self.inner = inner
        self.lanes: list = []
        self.masks: list = []

    def verify_seal_lanes(self, lanes, height):
        mask = np.asarray(self.inner.verify_seal_lanes(lanes, height), dtype=bool)
        self.lanes.extend(lanes)
        self.masks.extend(mask.tolist())
        return mask


def proof_flood_qos(sched, flood_blocks, flood_src, heights: int = 2, torch_device=None) -> dict:
    """Config #12's QoS bound: a 4-validator chain on the consensus tier
    finalizes ``heights`` while a proof flood hammers the read tier of the
    same scheduler (its server's device route on ``torch_device``, ``None``:
    the card).  Returns the evidence; ``missed`` must be 0."""
    from ..serve import ProofBuilder, ProofCache, ProofServer

    stop = threading.Event()
    proofs = [0]
    errors: list = []

    def flood():
        server = ProofServer(ProofBuilder(ListSource(flood_blocks), flood_src), ProofCache(chunk_heights=2),
                             scheduler=sched, torch_device=torch_device)
        try:
            while not stop.is_set():
                # A fresh verdict cache each pass: real lanes through the
                # read tier, not cache hits.
                server.verifier.sig_cache.clear()
                server.verify_proof(server.get_proof(0), flood_src(1))
                proofs[0] += 1
        except BaseException as err:  # noqa: BLE001 - surfaced below
            errors.append(err)
        finally:
            server.close()

    async def drive_chain() -> list:
        keys = [PrivateKey.from_seed(b"c12-qos-%d" % i) for i in range(4)]
        src = ECDSABackend.static_validators({k.address: 1 for k in keys})
        nodes, runners = [], []

        class _Loopback:
            def multicast(self, message):
                for ingress in nodes:
                    ingress.submit(message)

        for i, key in enumerate(keys):
            handle = sched.register(f"c12-qos/n{i}", src, chain_id="c12-qos")
            engine = IBFT(NullLogger(), ECDSABackend(key, src), _Loopback(), batch_verifier=handle)
            engine.set_base_round_timeout(30.0)
            nodes.append(BatchingIngress(engine.add_messages))
            runners.append(ChainRunner(engine, overlap=False))
        try:
            await asyncio.wait_for(asyncio.gather(*(r.run(until_height=heights) for r in runners)), 180.0)
        finally:
            for runner, ingress in zip(runners, nodes):
                ingress.close()
                runner.engine.messages.close()
        return [r.latest_height() for r in runners]

    thread = threading.Thread(target=flood, daemon=True)
    thread.start()
    t0 = time.perf_counter()
    try:
        finalized = asyncio.run(drive_chain())
    finally:
        stop.set()
        thread.join(60.0)
    if errors:
        raise RuntimeError(f"proof flood failed: {errors[0]!r}")
    return {"chain_heights": heights, "finalized": finalized, "missed": sum(heights - f for f in finalized),
            "flood_proofs": proofs[0], "chain_s": time.perf_counter() - t0}


# -- config #18: checkpoint-anchored cold sync -----------------------------------


def checkpoint_chain(heights: int = 16, spacing: int = 4, rotate_at: int = 10):
    """Config #18's real-crypto chain: proposals committing the next
    height's validator set, set A = keys 0..3 before ``rotate_at`` and set B
    = keys 1..4 from it, exactly-quorum ECDSA seals, and an eagerly signed
    checkpoint every ``spacing`` heights (BLS quorum seals).  Returns
    ``(blocks, validators_for_height, registry, checkpointer, set_a, set_b)``."""
    keys = _keys(5, seed=31)
    set_a = {k.address: 1 for k in keys[:4]}
    set_b = {k.address: 1 for k in keys[1:5]}

    def validators_for_height(h: int) -> dict:
        return dict(set_b if h >= rotate_at else set_a)

    by_addr = {k.address: k for k in keys}
    quorum = calculate_quorum(4)
    blocks = []
    for h in range(1, heights + 1):
        raw = embed_next_set(b"ckpt bench block %d" % h, set_root(validators_for_height(h + 1)))
        proposal = Proposal(raw_proposal=raw, round=0)
        phash = proposal_hash_of(proposal)
        blocks.append(FinalizedBlock(h, proposal, [
            CommittedSeal(signer=a, signature=encode_signature(*ecdsa.sign(by_addr[a], phash)))
            for a in sorted(validators_for_height(h))[:quorum]
        ]))
    real_bls = {k.address: hbls.BLSPrivateKey.from_seed(b"bench-ckpt-real-%d" % i) for i, k in enumerate(keys)}
    registry = BLSKeyRegistry()
    for a, k in real_bls.items():
        registry.register_key(a, k)
    ckpt = Checkpointer(spacing, validators_for_height, signers=real_bls)
    for block in blocks:
        ckpt.on_finalize(block.height, proposal_hash_of(block.proposal))
    return blocks, validators_for_height, registry, ckpt, set_a, set_b


def structural_checkpointer(heights: int = 1_000_000, spacing: int = 1000):
    """Config #18's structural chain: ``heights // spacing`` epochs of a
    static 4-validator set, lazily signed (only the served skip path signs).
    Returns ``(checkpointer, registry, powers, heights)``."""
    epochs = max(1, heights // spacing)
    vaddrs = [b"ckpt-val-%02d" % i for i in range(4)]
    bls_keys = {a: hbls.BLSPrivateKey.from_seed(b"bench-ckpt-bls-%d" % i) for i, a in enumerate(vaddrs)}
    powers = {a: 1 for a in vaddrs}
    registry = BLSKeyRegistry()
    for a, k in bls_keys.items():
        registry.register_key(a, k)
    ckpt = Checkpointer(spacing, lambda _h: powers, signers=bls_keys, lazy_sign=True)
    for e in range(1, epochs + 1):
        ckpt.on_finalize(e * spacing, keccak256(b"ckpt blk %d" % (e * spacing)))
    return ckpt, registry, powers, epochs * spacing
