"""Chain layer: multi-height sequencing, WAL durability, block-sync (the port
of the JAX package's ``chain`` package).

The subsystem that turns the per-height consensus engine
(:mod:`go_ibft_tpu_torch.core`) into a continuously-running validator node:

* :class:`ChainRunner` — persistent height loop with no inter-height
  barrier, measured handoffs, cross-height verify overlap, and
  fall-behind detection (docs/CHAIN.md).
* :class:`WriteAheadLog` — fsync-on-finalize durability for finalized
  heights and the mid-round prepared-certificate lock; crash recovery via
  :meth:`ChainRunner.recover`.
* :class:`SyncClient` / :class:`LoopbackSyncNetwork` — batched
  catch-up: all committed seals of a fetched height range verified in one
  ``verify_seal_lanes`` drain per validator-set snapshot.
"""

from .runner import (
    ChainRunner,
    HANDOFF_MS_KEY,
    HEIGHT_MS_KEY,
    OVERLAP_LANES_KEY,
)
from .sync import LoopbackSyncNetwork, SyncClient, SyncError, SyncSource
from .wal import (
    FinalizedBlock,
    NotPortedError,
    WalCorruptionError,
    WalLock,
    WalState,
    WriteAheadLog,
)

__all__ = [
    "ChainRunner",
    "FinalizedBlock",
    "HANDOFF_MS_KEY",
    "HEIGHT_MS_KEY",
    "LoopbackSyncNetwork",
    "NotPortedError",
    "OVERLAP_LANES_KEY",
    "SyncClient",
    "SyncError",
    "SyncSource",
    "WalCorruptionError",
    "WalLock",
    "WalState",
    "WriteAheadLog",
]
