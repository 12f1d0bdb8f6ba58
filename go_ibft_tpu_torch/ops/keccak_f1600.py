"""Keccak on the card: the CUDA kernels' launchers and their plain versions.

Two kernels of ``csrc/keccak_f1600.cu``:

* ``keccak_f1600``, the port of ``go_ibft_tpu/ops/pallas_keccak.py``
  (kernel body ``_keccak_f_kernel``, launched by ``_keccak_f_rows``'
  ``pl.pallas_call``), on the permutation of ``csrc/keccak_f1600.cuh``:
  :func:`launch` runs it, :func:`keccak_f_plain` is its plain PyTorch
  version;
* ``keccak256_digest``, the port of the payload digests
  ``go_ibft_tpu/ops/quorum.py::digest_words`` (the absorb loop
  ``go_ibft_tpu/ops/keccak.py::keccak256_blocks`` and the byte-order
  epilogue), each message's state split over five threads:
  :func:`launch_digest` runs it, returning either stream words (the plain
  version is :func:`keccak256_sponge_plain`) or value words (plain:
  :func:`digest_words_plain`).

The launchers take CUDA tensors only and raise on any fault; the plain
versions run on any device.  :func:`go_ibft_tpu_torch.ops.keccak.keccak_f`,
:func:`~go_ibft_tpu_torch.ops.keccak.keccak256_blocks` and
:func:`go_ibft_tpu_torch.ops.quorum.digest_words` are the wrappers the port
calls: the kernel for a CUDA tensor, the plain version for a CPU tensor,
and a count of launches.

A state is a contiguous ``(..., 25, 2)`` int32 tensor of uint32 halves (low
half first) — byte for byte the little-endian ``(..., 25)`` uint64 lanes.
"""

from __future__ import annotations

import torch

from .. import _build

__all__ = [
    "RC",
    "ROT",
    "launch",
    "launch_digest",
    "keccak_f_plain",
    "keccak256_sponge_plain",
    "digest_words_plain",
    "bswap32",
]

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


def _check_blocks(blocks: torch.Tensor, num_blocks: torch.Tensor) -> None:
    if blocks.dtype != torch.int32 or num_blocks.dtype != torch.int32:
        raise TypeError(
            f"digest inputs must be int32, got {blocks.dtype} and {num_blocks.dtype}"
        )
    if blocks.dim() < 3 or tuple(blocks.shape[-2:]) != (17, 2):
        raise ValueError(f"rate blocks must be (..., nb, 17, 2), got {tuple(blocks.shape)}")
    if tuple(num_blocks.shape) != tuple(blocks.shape[:-3]):
        raise ValueError(
            f"num_blocks {tuple(num_blocks.shape)} does not match blocks {tuple(blocks.shape)}"
        )


def launch_digest(
    blocks: torch.Tensor, num_blocks: torch.Tensor, value_words: bool
) -> torch.Tensor:
    """Run the ``keccak256_digest`` kernel; returns ``(..., 8)`` int32 words.

    ``blocks`` is a contiguous ``(..., nb, 17, 2)`` int32 CUDA tensor of
    padded rate blocks, ``num_blocks`` the ``(...)`` int32 block counts on the
    same card; a message absorbs its first ``clamp(count, 0, nb)`` blocks.
    The digest comes back as little-endian value words (``digest_words``)
    if ``value_words``, else as stream words (``keccak256_blocks``).  One
    launch on PyTorch's current stream, no synchronisation; raises on any
    fault.
    """
    _check_blocks(blocks, num_blocks)
    if blocks.device.type != "cuda" or num_blocks.device != blocks.device:
        raise ValueError(
            f"the digest kernel takes CUDA tensors on one card, got {blocks.device} "
            f"and {num_blocks.device}"
        )
    if not (blocks.is_contiguous() and num_blocks.is_contiguous()):
        raise ValueError("digest inputs must be contiguous")
    lib = _build.load("keccak_f1600")
    batch = tuple(blocks.shape[:-3])
    out = torch.empty(batch + (8,), dtype=torch.int32, device=blocks.device)
    n = num_blocks.numel()
    if n:
        stream = torch.cuda.current_stream(blocks.device).cuda_stream
        rc = lib.keccak256_digest(
            blocks.data_ptr(), num_blocks.data_ptr(), out.data_ptr(), n, blocks.shape[-3],
            int(value_words), stream,
        )
        if rc != 0:
            raise RuntimeError(f"keccak256_digest launch failed: cudaError {rc}")
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


def keccak256_sponge_plain(blocks: torch.Tensor, num_blocks: torch.Tensor) -> torch.Tensor:
    """The sponge in PyTorch ops: every message runs all ``nb`` blocks
    through :func:`keccak_f_plain`; blocks past its count are dropped by a
    select, as in the JAX package.  Returns ``(..., 8)`` stream words."""
    _check_blocks(blocks, num_blocks)
    bmax = blocks.shape[-3]
    batch = blocks.shape[:-3]
    state = torch.zeros(batch + (25, 2), dtype=torch.int32, device=blocks.device)
    for i in range(bmax):
        absorbed = torch.cat([state[..., :17, :] ^ blocks[..., i, :, :], state[..., 17:, :]], dim=-2)
        nxt = keccak_f_plain(absorbed)
        live = (i < num_blocks)[..., None, None]
        state = torch.where(live, nxt, state)
    # Digest = first 4 lanes, little-endian => stream words interleave lo/hi.
    return state[..., :4, :].reshape(batch + (8,))


def bswap32(w: torch.Tensor) -> torch.Tensor:
    """Byte-swap each 32-bit word (big-endian <-> little-endian) of int32
    bit patterns; ``>>`` is arithmetic, so the bits it brings in are masked."""
    return ((w >> 24) & 0xFF) | ((w >> 8) & 0xFF00) | ((w << 8) & 0xFF0000) | (w << 24)


def digest_words_plain(blocks: torch.Tensor, num_blocks: torch.Tensor) -> torch.Tensor:
    """``digest_words`` in PyTorch ops: :func:`keccak256_sponge_plain`, then
    the stream words reversed and each byte-swapped, which reads the digest
    as a big-endian integer in little-endian ``(..., 8)`` value words."""
    return bswap32(keccak256_sponge_plain(blocks, num_blocks).flip(-1))
