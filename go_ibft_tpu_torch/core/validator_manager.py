"""Voting-power quorum math (from ``go_ibft_tpu.core.validator_manager``)."""

from __future__ import annotations


def calculate_quorum(total_voting_power: int) -> int:
    """floor(2·total/3) + 1 (reference core/validator_manager.go:129-135)."""
    return (2 * total_voting_power) // 3 + 1
