"""The production boot layer (the port of the JAX package's ``boot``).

A restarted node pays, before its first round, for every kernel it will
launch: on the card an ``nvcc`` build of each CUDA source and the first
launch of each program.  This package makes restart cost a library load
instead:

* :mod:`~go_ibft_tpu_torch.boot.registry` — the pinned program registry:
  one ``(fn, args)`` per family, keyed as the JAX package's;
* :mod:`~go_ibft_tpu_torch.boot.aot` — the AOT program store: builds every
  source the families need into the kernel build cache
  (``GO_IBFT_TORCH_CACHE_DIR``), classifies each restore cold vs cached by
  what the build compiled, and records cold builds to the cost ledger;
* :mod:`~go_ibft_tpu_torch.boot.warmstart` — warm-start: program restore +
  WAL replay + verdict-cache seeding, all *before* the first round opens;
* ``python -m go_ibft_tpu_torch.boot`` — the restart-to-first-finalized
  harness (one full boot in a child process, :mod:`.restart` spawns it).
"""

from .aot import AOTStore, ProgramStatus, fingerprint, load_manifest, write_manifest
from .registry import ProgramUnavailable, program_registry
from .warmstart import WarmStartReport, seed_verdict_caches, warm_start

__all__ = [
    "AOTStore",
    "ProgramStatus",
    "ProgramUnavailable",
    "WarmStartReport",
    "fingerprint",
    "load_manifest",
    "program_registry",
    "seed_verdict_caches",
    "warm_start",
    "write_manifest",
]
