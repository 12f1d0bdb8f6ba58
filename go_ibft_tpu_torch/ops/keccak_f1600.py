"""Keccak-f[1600]: the CUDA kernel's launcher and its plain PyTorch version.

The port of ``go_ibft_tpu/ops/pallas_keccak.py`` (kernel body
``_keccak_f_kernel``, launched by ``_keccak_f_rows``' ``pl.pallas_call``).
The kernel itself is ``csrc/keccak_f1600.cu``; :func:`launch` runs it on a
CUDA tensor, :func:`keccak_f_plain` computes the same function with PyTorch
ops on any device.  :func:`go_ibft_tpu_torch.ops.keccak.keccak_f` is the
wrapper the main path calls: it takes the kernel for a CUDA tensor and the
plain version for a CPU tensor, and counts its launches.

A state is a contiguous ``(..., 25, 2)`` int32 tensor of uint32 halves (low
half first) — byte for byte the little-endian ``(..., 25)`` uint64 lanes.
"""

from __future__ import annotations

import torch

from .. import _build

__all__ = ["RC", "ROT", "launch", "keccak_f_plain"]

RC = [
    0x0000000000000001, 0x0000000000008082, 0x800000000000808A,
    0x8000000080008000, 0x000000000000808B, 0x0000000080000001,
    0x8000000080008081, 0x8000000000008009, 0x000000000000008A,
    0x0000000000000088, 0x0000000080008009, 0x000000008000000A,
    0x000000008000808B, 0x800000000000008B, 0x8000000000008089,
    0x8000000000008003, 0x8000000000008002, 0x8000000000000080,
    0x000000000000800A, 0x800000008000000A, 0x8000000080008081,
    0x8000000000008080, 0x0000000080000001, 0x8000000080008008,
]

ROT = [
    [0, 36, 3, 41, 18],
    [1, 44, 10, 45, 2],
    [62, 6, 43, 15, 61],
    [28, 55, 25, 21, 56],
    [27, 20, 39, 8, 14],
]


def _check_state(state: torch.Tensor) -> None:
    if state.dtype != torch.int32:
        raise TypeError(f"keccak state must be int32, got {state.dtype}")
    if state.dim() < 2 or tuple(state.shape[-2:]) != (25, 2):
        raise ValueError(f"keccak state must be (..., 25, 2), got {tuple(state.shape)}")
    if not state.is_contiguous():
        raise ValueError("keccak state must be contiguous")


def launch(state: torch.Tensor) -> torch.Tensor:
    """Run ``csrc/keccak_f1600.cu`` on a CUDA state; raises on any fault.

    Allocates the output with ``torch.empty`` and launches on PyTorch's
    current stream without synchronising.
    """
    _check_state(state)
    if state.device.type != "cuda":
        raise ValueError(f"the keccak kernel takes a CUDA tensor, got {state.device}")
    lib = _build.load("keccak_f1600")
    out = torch.empty_like(state)
    n = state.numel() // 50
    if n:
        stream = torch.cuda.current_stream(state.device).cuda_stream
        rc = lib.keccak_f1600(state.data_ptr(), out.data_ptr(), n, stream)
        if rc != 0:
            raise RuntimeError(f"keccak_f1600 launch failed: cudaError {rc}")
    return out


def _signed64(v: int) -> int:
    return v - (1 << 64) if v >> 63 else v


# Per-lane index tables of one round, lane index i = x + 5*y.
_PI_SRC = [0] * 25  # B[y, 2x+3y] = rotl(A[x, y], ROT[x][y])
_PI_ROT = [0] * 25
for _x in range(5):
    for _y in range(5):
        _PI_SRC[_y + 5 * ((2 * _x + 3 * _y) % 5)] = _x + 5 * _y
        _PI_ROT[_y + 5 * ((2 * _x + 3 * _y) % 5)] = ROT[_x][_y]
_CHI_1 = [(i % 5 + 1) % 5 + 5 * (i // 5) for i in range(25)]
_CHI_2 = [(i % 5 + 2) % 5 + 5 * (i // 5) for i in range(25)]
_RC_ROWS = [[_signed64(rc)] + [0] * 24 for rc in RC]


def _rotl(x: torch.Tensor, n) -> torch.Tensor:
    """64-bit rotate-left of int64 bit patterns; ``>>`` is arithmetic, so
    the bits shifted in from the sign are masked off."""
    return (x << n) | ((x >> ((64 - n) % 64)) & ((1 << n) - 1))


def keccak_f_plain(state: torch.Tensor) -> torch.Tensor:
    """Keccak-f[1600] in PyTorch ops, vectorised over the 25 lanes.

    Any device.  The tests compare it with the JAX package's keccak, and
    ``chip_smoke.py`` holds the CUDA kernel against it on the card.
    """
    _check_state(state)
    dev = state.device
    a = state.view(torch.int64).squeeze(-1)  # (..., 25) uint64 bit patterns
    src = torch.tensor(_PI_SRC, device=dev)
    rot = torch.tensor(_PI_ROT, dtype=torch.int64, device=dev)
    chi1 = torch.tensor(_CHI_1, device=dev)
    chi2 = torch.tensor(_CHI_2, device=dev)
    rcs = torch.tensor(_RC_ROWS, dtype=torch.int64, device=dev)
    for r in range(24):
        c = a[..., 0:5] ^ a[..., 5:10] ^ a[..., 10:15] ^ a[..., 15:20] ^ a[..., 20:25]
        d = c.roll(1, dims=-1) ^ _rotl(c.roll(-1, dims=-1), 1)
        a = a ^ d.repeat((1,) * (d.dim() - 1) + (5,))
        b = _rotl(a[..., src], rot)
        a = b ^ (~b[..., chi1] & b[..., chi2]) ^ rcs[r]
    return a.unsqueeze(-1).view(torch.int32)
