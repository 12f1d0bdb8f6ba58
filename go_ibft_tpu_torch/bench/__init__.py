"""Deterministic signed-round workloads (port of ``go_ibft_tpu.bench``) and
the seeded recovery lanes the tests and ``chip_smoke.py`` share."""

from .lanes import RecoveryLanes, build_recovery_lanes, build_sparse_scalar_lanes
from .workload import RoundWorkload, SignedRound, build_round_workload, build_signed_round

__all__ = [
    "RecoveryLanes",
    "RoundWorkload",
    "SignedRound",
    "build_recovery_lanes",
    "build_round_workload",
    "build_signed_round",
    "build_sparse_scalar_lanes",
]
