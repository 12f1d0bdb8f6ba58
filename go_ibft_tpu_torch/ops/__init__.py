"""Device ops in PyTorch: limb fields, Keccak (with the CUDA Keccak-f and
payload-digest kernels), secp256k1 recovery (with the CUDA recovery-plus-address
kernel) and the fused quorum reduction."""
