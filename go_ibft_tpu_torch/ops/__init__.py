"""Device ops in PyTorch: limb fields, Keccak (with the CUDA Keccak-f and
sponge kernels), secp256k1 recovery (with the CUDA recovery-plus-address
kernel) and the fused quorum reduction."""
