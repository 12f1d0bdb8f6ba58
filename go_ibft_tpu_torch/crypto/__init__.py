"""Host-side cryptography (pure Python copies of ``go_ibft_tpu.crypto``)."""

from .ecdsa import PrivateKey, pubkey_to_address, recover, sign, verify
from .keccak import keccak256

__all__ = ["keccak256", "PrivateKey", "pubkey_to_address", "sign", "verify", "recover"]
