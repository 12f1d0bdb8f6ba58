"""Batch verification on the device (PyTorch port of ``go_ibft_tpu.verify``)."""

from .batch import (
    DeviceBatchVerifier,
    MalformedLaneError,
    pack_seal_batch,
    pack_sender_batch,
    pack_validator_table,
    split_signature,
)

__all__ = [
    "DeviceBatchVerifier",
    "MalformedLaneError",
    "pack_seal_batch",
    "pack_sender_batch",
    "pack_validator_table",
    "split_signature",
]
