"""Long-chain light clients: quorum-sealed next-set
commitments + epoch checkpoint certificates with O(log n) skip sync (the
port of the JAX package's ``lightsync``).

Three pieces close the serve plane's two documented production blockers
(the fabricated-diff hole and linear cold sync — docs/SERVING.md):

* :mod:`~go_ibft_tpu_torch.lightsync.commitment` — the next validator set's
  root committed INSIDE proposal content (covered by the current
  quorum's seals), enforced per diff hop by ``serve/proof.py::walk_sets``;
* :mod:`~go_ibft_tpu_torch.lightsync.checkpoint` — epoch-boundary aggregate-
  BLS certificates chained with power-of-2 skip links; the whole path
  verifies in ONE batched pairing dispatch;
* :mod:`~go_ibft_tpu_torch.lightsync.client` — the HTTP light client that
  anchors a ``ProofVerifier`` at the nearest verified checkpoint.
"""

from .checkpoint import (
    CHECKPOINT_WIRE_VERSION,
    CheckpointAnchor,
    CheckpointError,
    CheckpointRecord,
    CheckpointVerifier,
    Checkpointer,
    skip_epochs,
    skip_path,
)
from .client import CheckpointClient, ColdSyncReport, http_fetcher
from .commitment import (
    COMMIT_MAGIC,
    COMMIT_SUFFIX_BYTES,
    SET_ROOT_BYTES,
    embed_next_set,
    extract_next_set,
    set_root,
    strip_next_set,
)

__all__ = [
    "CHECKPOINT_WIRE_VERSION",
    "COMMIT_MAGIC",
    "COMMIT_SUFFIX_BYTES",
    "CheckpointAnchor",
    "CheckpointClient",
    "CheckpointError",
    "CheckpointRecord",
    "CheckpointVerifier",
    "Checkpointer",
    "ColdSyncReport",
    "SET_ROOT_BYTES",
    "embed_next_set",
    "extract_next_set",
    "http_fetcher",
    "set_root",
    "skip_epochs",
    "skip_path",
    "strip_next_set",
]
