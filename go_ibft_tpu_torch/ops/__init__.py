"""Device ops in PyTorch: limb fields, Keccak (with the CUDA Keccak-f
kernel), secp256k1 recovery and the fused quorum reduction."""
