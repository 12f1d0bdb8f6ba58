"""Device ops in PyTorch: limb fields, Keccak (with the CUDA Keccak-f and
payload-digest kernels), secp256k1 recovery (with the CUDA recovery-plus-address
kernel), the fused quorum reduction, and BLS12-381 (the plain Fp/Fp2
tower, the aggregate and multi-pairing checks, with the CUDA merge, Miller
and final-exponentiation kernels)."""
