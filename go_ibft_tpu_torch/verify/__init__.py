"""Batched signature verification backends (the PyTorch port of
``go_ibft_tpu.verify``): interchangeable implementations of the
:class:`go_ibft_tpu_torch.core.backend.BatchVerifier` protocol.

* :class:`HostBatchVerifier` — sequential per-message verification (native
  C++ ecrecover when available, pure Python otherwise); the semantics
  oracle and the in-process baseline.
* :class:`DeviceBatchVerifier` — the card's batches: the digest and
  recovery kernels, membership and the power reduction, chunked drains
  through the double-buffered :class:`VerifyPipeline`.
* :class:`AdaptiveBatchVerifier` — tiny batches on the host, the rest on
  the card.
* :class:`ResilientBatchVerifier` — quarantines poison lanes by bisection;
  a device rung off the card that faults is demoted down the
  ``device -> host -> pure Python`` ladder through a :class:`CircuitBreaker`.
  On the card nothing is demoted: a kernel fault propagates to the caller,
  and only the lanes the packer names malformed are quarantined.
* :class:`SpeculativeVerifier` — verifies COMMIT seals on a worker thread
  as they arrive, into a :class:`SpeculationCache` the engine's drains read;
  on the card the worker's first fault is raised by ``drain()`` and
  ``stop()``.

All return identical boolean masks for identical inputs, and every one
serves ``verify_seals_early_exit``, a seal drain that stops at the exact
voting-power quorum (:class:`EarlyExitReport`).  The JAX package's mesh
verifier and BLS aggregation are not ported yet.
"""

from .batch import (
    SIG_BYTES,
    AdaptiveBatchVerifier,
    DeviceBatchVerifier,
    EarlyExitReport,
    EngineScope,
    HostBatchVerifier,
    MalformedLaneError,
    ResilientBatchVerifier,
    pack_seal_batch,
    pack_sender_batch,
    pack_validator_table,
    split_signature,
)
from .pipeline import CircuitBreaker, PackCache, VerifyPipeline
from .speculate import SpeculationCache, SpeculativeVerifier

__all__ = [
    "AdaptiveBatchVerifier",
    "CircuitBreaker",
    "DeviceBatchVerifier",
    "EarlyExitReport",
    "EngineScope",
    "HostBatchVerifier",
    "MalformedLaneError",
    "PackCache",
    "ResilientBatchVerifier",
    "SIG_BYTES",
    "SpeculationCache",
    "SpeculativeVerifier",
    "VerifyPipeline",
    "pack_seal_batch",
    "pack_sender_batch",
    "pack_validator_table",
    "split_signature",
]
