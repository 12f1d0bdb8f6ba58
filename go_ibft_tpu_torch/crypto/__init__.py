"""Host-side cryptography (pure Python copies of ``go_ibft_tpu.crypto``):
Keccak-256, secp256k1 ECDSA and the BLS12-381 host oracle (:mod:`.bls`), with
the hybrid ECDSA/BLS backend (:mod:`.bls_backend`) and aggregate quorum
certificates (:mod:`.quorum_cert`) beside them."""

from .bls import BLSPrivateKey
from .ecdsa import PrivateKey, pubkey_to_address, recover, sign, verify
from .keccak import keccak256

__all__ = ["BLSPrivateKey", "keccak256", "PrivateKey", "pubkey_to_address", "sign", "verify", "recover"]
