"""Deterministic signed-round workloads (port of ``go_ibft_tpu.bench``)."""

from .workload import RoundWorkload, SignedRound, build_round_workload, build_signed_round

__all__ = ["RoundWorkload", "SignedRound", "build_round_workload", "build_signed_round"]
