"""Light-client proof serving: the read-heavy front end over ChainRunner (the
port of the JAX package's ``serve``).

Layer map (docs/SERVING.md):

* :mod:`go_ibft_tpu_torch.serve.proof` — proof data model + builder
  (:class:`FinalityProof` = headers + quorum evidence + validator-set
  diff chain from a trusted checkpoint);
* :mod:`go_ibft_tpu_torch.serve.cache` — canonical height-range chunk cache
  (:class:`ProofCache`: irreversible finality makes hot proofs a
  lookup);
* :mod:`go_ibft_tpu_torch.serve.server` — :class:`ProofServer` (cache +
  stampede coalescing + pre-serve self-check) and
  :class:`ProofVerifier` (client-side verification with a shared
  signature-verdict cache and scheduler-coalesced fresh drains).
"""

from .cache import CachedChunk, ProofCache
from .proof import (
    FinalityProof,
    ProofBuilder,
    ProofEntry,
    ProofError,
    SetDiff,
    diff_chain,
    walk_sets,
)
from .server import (
    DispatcherLanes,
    ProofServer,
    ProofVerifier,
    SigVerdictCache,
    any_signer_source,
)

__all__ = [
    "CachedChunk",
    "DispatcherLanes",
    "FinalityProof",
    "ProofBuilder",
    "ProofCache",
    "ProofEntry",
    "ProofError",
    "ProofServer",
    "ProofVerifier",
    "SetDiff",
    "SigVerdictCache",
    "any_signer_source",
    "diff_chain",
    "walk_sets",
]
