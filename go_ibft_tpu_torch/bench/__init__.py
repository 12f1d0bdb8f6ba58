"""Deterministic signed-round workloads (port of ``go_ibft_tpu.bench``) and
the seeded recovery lanes the tests and ``chip_smoke.py`` share, and the
BLS aggregate-COMMIT workload (config #4)."""

from .bls_workload import BLSRoundWorkload, build_bls_round_workload
from .lanes import (
    RecoveryLanes,
    VerifyLanes,
    build_recovery_lanes,
    build_sparse_scalar_lanes,
    build_verify_lanes,
)
from .workload import (
    RoundWorkload,
    SealLaneWorkload,
    SignedRound,
    build_round_workload,
    build_seal_lane_workload,
    build_signed_round,
)

__all__ = [
    "BLSRoundWorkload",
    "RecoveryLanes",
    "RoundWorkload",
    "SealLaneWorkload",
    "SignedRound",
    "VerifyLanes",
    "build_bls_round_workload",
    "build_recovery_lanes",
    "build_round_workload",
    "build_seal_lane_workload",
    "build_signed_round",
    "build_sparse_scalar_lanes",
    "build_verify_lanes",
]
