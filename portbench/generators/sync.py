"""The ``sync`` generator: a node that restarted behind the chain catches up.

Each request is one ``SyncClient.catch_up`` over ``range_heights`` heights,
driven as ``chip_smoke.py`` drives it: a fresh ``SyncClient`` a request, the
node's ``DeviceBatchVerifier`` on the card, and one static peer on a
``LoopbackSyncNetwork`` (``StaticSource``, a frozen copy of
``go_ibft_tpu_torch/bench/chain.py``'s).  The node's own ``ECDSABackend``
is built first, which installs the program's native host paths as a node's
boot does.

Blocks come from the pool's proposals, relabelled to consecutive heights
(height ``h`` carries proposal ``(h - 1) mod proposals``), each with the
committed seals of a quorum.  A mix gives at least as many proposals as a
request has heights, so that no request carries a signature twice.  Every ``tamper_every``-th request, the first
of the window among them, carries one tampered seal, which leaves its
height one seal short of the quorum: the program must refuse that range.
Its heights do not count; its time does.  The window closes at the first
request that ends after ``seconds``, and holds two requests at least.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import List, Optional, Sequence

from ..harness import pool as pools
from ..harness import proxies


class StaticSource:
    """A ``SyncSource`` serving a fixed list of blocks."""

    def __init__(self, blocks: Sequence) -> None:
        self.blocks = list(blocks)

    def latest_height(self) -> int:
        return self.blocks[-1].height if self.blocks else 0

    def get_blocks(self, start: int, end: int) -> list:
        return [b for b in self.blocks if start <= b.height <= end]


@dataclass
class Request:
    start: int
    heights: int
    tampered: Optional[tuple]  # (height, seal index, tampered seal) or None
    accepted: bool
    error: str
    t0_us: float
    t1_us: float


@dataclass
class SyncWindow:
    start_us: float
    end_us: float
    requests: List[Request] = field(default_factory=list)
    launches: int = 0
    errors: List[str] = field(default_factory=list)


class SyncCell:
    def __init__(self, config: dict, mix: dict, seed: int, device, fault: Optional[str] = None,
                 threads: int = 8) -> None:
        from go_ibft_tpu_torch.crypto import PrivateKey
        from go_ibft_tpu_torch.crypto.backend import ECDSABackend
        from go_ibft_tpu_torch.messages.helpers import CommittedSeal
        from go_ibft_tpu_torch.messages.wire import Proposal
        from go_ibft_tpu_torch.verify import DeviceBatchVerifier

        self.config, self.mix, self.seed, self.device = config, mix, seed, device
        n = int(config["validators"])
        self.range_heights = int(mix["range_heights"])
        self.tamper_every = int(mix["tamper_every"])
        if int(mix["pool_proposals"]) < self.range_heights:
            raise ValueError("a sync mix needs at least as many proposals as a request has heights")
        self.pool = pools.sync_pool(n, int(mix["pool_proposals"]), int(config["proposal_bytes"]),
                                    int(mix["tampered_seals"]), seed, threads)
        committee = self.pool.committee
        me = committee.engine_index()
        self.node_key = PrivateKey.from_seed(b"bench-%d-%d" % (seed, me))
        self.src = ECDSABackend.static_validators(committee.powers)
        self.backend = ECDSABackend(self.node_key, self.src)
        self.verifier = proxies.RecordingVerifier(DeviceBatchVerifier(self.src, device=device), fault)
        self._proposals = [Proposal(raw_proposal=raw, round=0) for raw, _h in self.pool.proposals]
        self._seals = [[CommittedSeal(signer=a, signature=s) for a, s in seals] for seals in self.pool.seals]
        self._tampered_seals = [CommittedSeal(signer=self.pool.seals[k][j][0], signature=bad)
                                for k, j, bad in self.pool.tampered]
        self._next = 1

    def _blocks(self, start: int, tamper: Optional[int]):
        from go_ibft_tpu_torch.chain.wal import FinalizedBlock

        q = len(self._proposals)
        blocks = [FinalizedBlock(h, self._proposals[(h - 1) % q], self._seals[(h - 1) % q])
                  for h in range(start, start + self.range_heights)]
        where = None
        if tamper is not None:
            k, j, _bad = self.pool.tampered[tamper % len(self.pool.tampered)]
            i = next(i for i, b in enumerate(blocks) if (b.height - 1) % q == k)
            seals = list(blocks[i].seals)
            seals[j] = self._tampered_seals[tamper % len(self.pool.tampered)]
            blocks[i] = FinalizedBlock(blocks[i].height, blocks[i].proposal, seals)
            where = (blocks[i].height, j, seals[j].signature)
        return blocks, where

    def _request(self, tamper: Optional[int]) -> Request:
        from go_ibft_tpu_torch.chain.sync import LoopbackSyncNetwork, SyncClient, SyncError

        start = self._next
        self._next += self.range_heights
        blocks, where = self._blocks(start, tamper)
        net = LoopbackSyncNetwork()
        net.register(b"peer", StaticSource(blocks))
        client = SyncClient(self.node_key.address, net, self.verifier, self.src)
        t0 = time.perf_counter_ns() / 1e3
        accepted, error = True, ""
        try:
            got = client.catch_up(start, start + self.range_heights - 1)
            if len(got) != self.range_heights:
                accepted, error = False, f"caught up {len(got)} of {self.range_heights} heights"
        except SyncError as err:
            accepted, error = False, str(err)
        t1 = time.perf_counter_ns() / 1e3
        return Request(start, self.range_heights, where, accepted, error, t0, t1)

    def warm(self) -> None:
        """One clean range through the verifier: the cell's own shapes."""
        self._request(None)

    def window(self, seconds: float, on_start=None) -> SyncWindow:
        from go_ibft_tpu_torch.ops import ecrecover

        if on_start is not None:
            on_start()
        launches0 = ecrecover.recover.launches
        self.verifier.on = True
        start = time.perf_counter_ns() / 1e3
        out = SyncWindow(start, start)
        deadline = start + seconds * 1e6
        k = 0
        try:
            while True:
                tamper = k // self.tamper_every if k % self.tamper_every == 0 else None
                req = self._request(tamper)
                out.requests.append(req)
                k += 1
                if req.t1_us >= deadline and k >= 2:
                    break
        finally:
            self.verifier.on = False
            out.end_us = time.perf_counter_ns() / 1e3
            out.launches = ecrecover.recover.launches - launches0
        return out

    def window_lanes(self) -> List[tuple]:
        """``(signed bytes, signature)`` of every seal lane that the window's
        requests took to the verifier (``None`` for bytes the traffic never
        signed)."""
        lanes = self.pool.lanes
        return [(lanes[s].signed if s in lanes else None, s)
                for _kind, _h, _probes, sigs, _c, _m in self.verifier.log for s in sigs]

    def close(self) -> None:
        pass

    def cleanup(self) -> None:
        pass

    def judge(self, win: SyncWindow, workers: int, on_card: bool):
        from go_ibft_tpu_torch.verify.batch import _BATCH_BUCKETS

        from ..harness.judge import judge_sync

        return judge_sync(self, win, workers, on_card, _BATCH_BUCKETS[-1])

    def describe(self, win: SyncWindow) -> str:
        times = [(r.t1_us - r.t0_us) / 1e3 for r in win.requests]
        return (f"{len(win.requests)} requests, {win.launches} recovery launches, "
                f"request ms min {min(times):.1f} max {max(times):.1f}")

    def tally(self, win: SyncWindow, checks: dict):
        attempted = sum(r.heights for r in win.requests)
        return attempted, min(attempted, checks["ranges_wrong"] * self.range_heights)


Cell = SyncCell
