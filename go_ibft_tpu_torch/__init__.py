"""PyTorch/CUDA port of ``go_ibft_tpu`` for one NVIDIA H100.

The JAX package beside it stays the reference.  This package ports its
main path — whole-round PREPARE+COMMIT certification
(:func:`go_ibft_tpu_torch.ops.quorum.round_certify` and
:meth:`go_ibft_tpu_torch.verify.DeviceBatchVerifier.certify_round`) — with
hand-written CUDA kernels for the hashing and the recovery
(``csrc/keccak_f1600.cu``: Keccak-f[1600] and the keccak-256 payload digest;
``csrc/secp256k1_recover.cu``: ecrecover plus the address hash) and the
glue around them as PyTorch; and the BLS12-381 aggregate path
(:mod:`go_ibft_tpu_torch.ops.bls12_381`, ``csrc/bls12_381.cu``: the
masked point sums, the Miller loops and the final exponentiation).  It
imports ``torch`` and ``numpy``, never ``jax`` and nothing of
``go_ibft_tpu``.  Entry points run on the card unless the caller passes
``device="cpu"`` (``torch_device="cpu"`` for the BLS device routes).
"""
