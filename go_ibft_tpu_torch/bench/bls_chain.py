"""Seeded BLS workloads above the pairing kernels: a committee whose COMMIT
seals are BLS (``crypto/bls_backend.py``), a batch of quorum certificates
(the JAX package's ``bench.py`` config #13) with its tampered pair, and a
chain that finalizes, persists and syncs certificates.  ``chip_smoke.py`` phase 10 drives them on the card;
the CPU tests drive them at small sizes.

Keys come from the JAX package's seeds (``bench/workload.py::_keys``,
``bench/bls_workload.py::_bls_keys``).  The BLS key source is a plain
address -> pubkey map: registering through
:class:`~go_ibft_tpu_torch.crypto.quorum_cert.BLSKeyRegistry` costs a host
pairing per key, which the workloads leave out.
"""

from __future__ import annotations

import asyncio
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

from ..chain import ChainRunner, FinalizedBlock, LoopbackSyncNetwork, SyncClient, WriteAheadLog
from ..core import IBFT
from ..crypto import bls as hbls
from ..crypto.backend import proposal_hash_of
from ..crypto.bls_backend import HybridBatchVerifier, HybridBLSBackend
from ..crypto.quorum_cert import AggregateQuorumCertificate, BLSCertifier
from ..messages.helpers import CommittedSeal
from ..messages.wire import View
from ..verify.bls import encode_seal
from .bls_workload import _bls_keys
from .engine import NullLogger, _Silent
from .workload import _keys

__all__ = ["BLSChain", "BLSCommittee", "certificate_batch", "relabel_block", "tamper"]

TIMEOUT_S = 120.0


@dataclass
class BLSCommittee:
    """``n`` validators, one vote each, ECDSA envelopes and BLS seals."""

    n: int
    seed: int = 0
    keys: list = field(init=False)
    bls_keys: list = field(init=False)

    def __post_init__(self):
        self.keys = _keys(self.n, self.seed)
        self.bls_keys = _bls_keys(self.n, self.seed)
        self.powers = {k.address: 1 for k in self.keys}
        self.bls_pubkeys = {k.address: b.pubkey for k, b in zip(self.keys, self.bls_keys)}
        self.quorum = (2 * self.n) // 3 + 1
        self.backends = [
            HybridBLSBackend(k, b, self.src, self.bls_src) for k, b in zip(self.keys, self.bls_keys)
        ]

    def src(self, _height: int) -> Dict[bytes, int]:
        return self.powers

    def bls_src(self, _height: int) -> Dict[bytes, "hbls.PointG1"]:
        return self.bls_pubkeys

    def certifier(self, **kw) -> BLSCertifier:
        return BLSCertifier(self.src, self.bls_src, **kw)

    def seals(self, phash: bytes, signers: Sequence[int]) -> List[CommittedSeal]:
        return [
            CommittedSeal(self.keys[i].address, encode_seal(self.bls_keys[i].sign(phash))) for i in signers
        ]

    def proposer(self, height: int) -> int:
        return next(i for i, b in enumerate(self.backends) if b.is_proposer(b.address, height, 0))

    def schedule(self, height: int):
        """The height's messages in arrival order: PREPREPARE, PREPAREs,
        COMMITs (every validator but the proposer)."""
        view = View(height=height, round=0)
        p = self.proposer(height)
        pmsg = self.backends[p].build_preprepare_message(b"bls block %d" % height, None, view)
        phash = pmsg.preprepare_data.proposal_hash
        prepares = [b.build_prepare_message(phash, view) for i, b in enumerate(self.backends) if i != p]
        commits = [b.build_commit_message(phash, view) for i, b in enumerate(self.backends) if i != p]
        return pmsg, prepares, commits


def certificate_batch(committee: BLSCommittee, certifier: BLSCertifier, count: int) -> List[AggregateQuorumCertificate]:
    """Config #13's certificates: height h's quorum seals over its own hash."""
    out = []
    for height in range(1, count + 1):
        phash = (b"mp bench h%d" % height + b"\x00" * 32)[:32]
        cert = certifier.build(height, 0, phash, committee.seals(phash, range(committee.quorum)))
        assert cert is not None
        out.append(cert)
    return out


def tamper(certs: Sequence[AggregateQuorumCertificate]) -> List[AggregateQuorumCertificate]:
    """``certs`` with the first relabeled onto another proposal hash and the
    second's aggregate seal bit-flipped (bench.py's config #13 gate)."""
    relabeled = AggregateQuorumCertificate.decode(certs[0].encode())
    relabeled.proposal_hash = b"\x66" * 32
    flipped_seal = bytearray(certs[1].agg_seal)
    flipped_seal[7] ^= 0x10
    flipped = AggregateQuorumCertificate.decode(certs[1].encode())
    flipped.agg_seal = bytes(flipped_seal)
    return [relabeled, flipped] + list(certs[2:])


async def _until(cond, what: str) -> None:
    for _ in range(int(TIMEOUT_S / 0.001)):
        if cond():
            return
        await asyncio.sleep(0.001)
    raise TimeoutError(f"timed out waiting for {what}")


class BLSChain:
    """One :class:`ChainRunner` for validator ``me`` with a BLS certifier:
    its engine drains envelopes through ``sender_verifier`` and COMMIT
    seals through ``seal_verifier`` (a ``BLSAggregateVerifier``), and every
    finalized height persists as a certificate record in a WAL at
    ``wal_path`` (fsync on)."""

    def __init__(self, committee: BLSCommittee, me: int, sender_verifier, seal_verifier,
                 certifier: BLSCertifier, wal_path: str):
        self.committee = committee
        self.me = me
        self.verifier = HybridBatchVerifier(sender_verifier, seal_verifier)
        self.certifier = certifier
        self.wal_path = wal_path

    def _runner(self) -> ChainRunner:
        c = self.committee
        backend = HybridBLSBackend(c.keys[self.me], c.bls_keys[self.me], c.src, c.bls_src)
        engine = IBFT(NullLogger(), backend, _Silent(), batch_verifier=self.verifier)
        engine.set_base_round_timeout(TIMEOUT_S)
        return ChainRunner(engine, WriteAheadLog(self.wal_path), certifier=self.certifier, overlap=False)

    def run(self, heights: int, schedules: Optional[dict] = None) -> ChainRunner:
        """Finalize heights ``1..heights``, each fed as PREPREPARE, PREPAREs,
        COMMITs once the runner reaches it."""
        schedules = schedules or {h: self.committee.schedule(h) for h in range(1, heights + 1)}
        runner = self._runner()
        engine = runner.engine

        async def feed() -> None:
            for h in range(1, heights + 1):
                await _until(lambda: engine.state.height == h, f"height {h}")
                for batch in schedules[h]:
                    engine.add_messages(batch if isinstance(batch, list) else [batch])
                await _until(lambda: runner.height > h, f"height {h} to finalize")

        async def main() -> None:
            await asyncio.wait_for(asyncio.gather(runner.run(until_height=heights), feed()), TIMEOUT_S)

        try:
            asyncio.run(main())
        finally:
            engine.messages.close()
            runner.wal.close()
        return runner

    def recover(self) -> tuple:
        """A fresh runner's ``recover()`` from the WAL: (resumed height,
        the blocks it re-inserted)."""
        runner = self._runner()
        try:
            resumed = runner.recover()
        finally:
            runner.engine.messages.close()
            runner.wal.close()
        return resumed, list(runner.chain)

    def sync(self, peer_blocks: Sequence[FinalizedBlock], sender_verifier) -> List[FinalizedBlock]:
        """A fresh client catches up the peer's blocks through the
        certificate route (one ``verify_many``); raises ``SyncError`` on a
        block that fails."""
        from .chain import StaticSource

        net = LoopbackSyncNetwork()
        net.register(b"peer", StaticSource(peer_blocks))
        c = self.committee
        client = SyncClient(c.keys[self.me].address, net, sender_verifier, c.src, cert_verifier=self.certifier)
        return client.catch_up(1, peer_blocks[-1].height)


def relabel_block(block: FinalizedBlock) -> FinalizedBlock:
    """``block``'s certificate rebuilt for another proposal hash (its
    signers and aggregate seal kept): the binding check must refuse it."""
    cert = AggregateQuorumCertificate.decode(block.cert.encode())
    cert.proposal_hash = proposal_hash_of(block.proposal)[::-1]
    return FinalizedBlock(block.height, block.proposal, [], cert=cert)
