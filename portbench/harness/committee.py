"""A configuration's committee, made from the seed.

A frozen copy of the committee half of ``go_ibft_tpu_torch/bench/engine.py``
(``Committee``): ``n`` validators whose keys come from the seeds
``bench-<seed>-<i>``, one vote each, proposers round-robin over the sorted
addresses (go-ibft's test clusters: the proposer of ``(height, round)`` is
``sorted[(height + round) % n]``), and a seeded Byzantine set that spares the
engine under test and every driven height's proposer.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Sequence

import numpy as np

from . import signer


@dataclass
class Committee:
    n: int
    seed: int
    keys: List[bytes] = field(init=False)
    pubkeys: List[tuple] = field(init=False)
    addresses: List[bytes] = field(init=False)

    def __post_init__(self) -> None:
        self.keys = [signer.key_from_seed(b"bench-%d-%d" % (self.seed, i)) for i in range(self.n)]
        self.pubkeys = [signer.pubkey(k) for k in self.keys]
        self.addresses = [signer.address(p) for p in self.pubkeys]
        self.sorted_idx = sorted(range(self.n), key=lambda i: self.addresses[i])
        self.index_of: Dict[bytes, int] = {a: i for i, a in enumerate(self.addresses)}
        self.powers = {a: 1 for a in self.addresses}
        self.quorum = (2 * self.n) // 3 + 1

    def proposer(self, height: int, round_: int = 0) -> int:
        return self.sorted_idx[(height + round_) % self.n]

    def engine_index(self) -> int:
        """The validator under test: the one that proposes no height below
        ``n`` at round 0."""
        return self.sorted_idx[0]

    def choose_bad(self, count: int, spare: Sequence[int]) -> List[int]:
        pool = [i for i in range(self.n) if i not in set(spare)]
        rng = np.random.default_rng(self.seed)
        return sorted(rng.choice(pool, size=count, replace=False).tolist())
