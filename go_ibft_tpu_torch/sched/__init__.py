"""Multi-tenant consensus: a process-wide verify scheduler (the port of the
JAX package's ``sched``).

Many independent chains/validator sets multiplexed onto shared hardware:
:class:`TenantScheduler` owns the device (or host-native) verify plane
and coalesces lanes from N concurrent ``ChainRunner``s into shared
batched dispatches, with deficit-round-robin fairness, per-chain
backpressure, and per-tenant latency SLO evidence.  See docs/TENANCY.md.
"""

from .dispatch import CoalescedDispatcher
from .scheduler import (
    COALESCED_REQUESTS_KEY,
    DISPATCHES_KEY,
    DRAIN_MS_KEY,
    FLUSH_FAULTS_KEY,
    PRIORITY_RANK,
    QUEUE_LANES_KEY,
    SHED_LANES_KEY,
    SchedFlushTimeout,
    SchedQueueFull,
    SchedRefused,
    TenantScheduler,
    TenantVerifierHandle,
)

__all__ = [
    "CoalescedDispatcher",
    "PRIORITY_RANK",
    "SchedFlushTimeout",
    "SchedQueueFull",
    "SchedRefused",
    "TenantScheduler",
    "TenantVerifierHandle",
    "QUEUE_LANES_KEY",
    "SHED_LANES_KEY",
    "DISPATCHES_KEY",
    "COALESCED_REQUESTS_KEY",
    "DRAIN_MS_KEY",
    "FLUSH_FAULTS_KEY",
]
