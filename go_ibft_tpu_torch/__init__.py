"""PyTorch/CUDA port of ``go_ibft_tpu`` for one NVIDIA H100.

The JAX package beside it stays the reference.  This package ports its
main path — whole-round PREPARE+COMMIT certification
(:func:`go_ibft_tpu_torch.ops.quorum.round_certify` and
:meth:`go_ibft_tpu_torch.verify.DeviceBatchVerifier.certify_round`) — with
Keccak-f[1600] as a hand-written CUDA kernel (``csrc/keccak_f1600.cu``) and
the rest as PyTorch.  It imports ``torch`` and ``numpy``, never ``jax`` and
nothing of ``go_ibft_tpu``.  Entry points run on the card unless the caller
passes ``device="cpu"``.
"""
