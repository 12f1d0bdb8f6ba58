"""Batched Keccak-256 in PyTorch, 64-bit lanes as int32 pairs.

The port of ``go_ibft_tpu.ops.keccak``.  A Keccak-f[1600] state is a
``(..., 25, 2)`` tensor — ``[..., 0]`` the low half, ``[..., 1]`` the high
half of each lane — held as ``int32`` bit patterns of the JAX package's
``uint32`` words: PyTorch's ``uint32`` has no shifts, additions or ``~``.
``>>`` on ``int32`` is arithmetic, so every right shift of a word whose top
bit may be set is masked afterwards.

Two consumers, as in the JAX package: **payload digests** (``payload_no_sig``
bytes packed on the host into padded rate blocks and absorbed block by
block) and **address derivation** (recovered public keys hashed to 20-byte
addresses on the device).  Both go through :func:`keccak_f`, which launches
the CUDA kernel ``csrc/keccak_f1600.cu`` on a CUDA tensor.

Byte conventions: Keccak absorbs bytes into lanes little-endian.  A
"stream word" is a 32-bit word whose LSB is the earliest byte of the byte
stream; digests and addresses come back as stream words.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from . import keccak_f1600
from .fields import LIMB_BITS, LIMB_MASK

__all__ = [
    "RATE_BYTES",
    "keccak_f",
    "keccak256_blocks",
    "limbs_to_words_le",
    "words_le_to_limbs",
    "pubkey_to_address_words",
    "pack_messages",
    "bswap32",
    "digest_words_to_bytes",
    "address_to_words",
    "addresses_to_words",
]

RATE_BYTES = 136  # Keccak-256 rate (17 lanes)


def keccak_f(state: torch.Tensor) -> torch.Tensor:
    """Keccak-f[1600] on a contiguous ``(..., 25, 2)`` int32 state.

    A CUDA tensor launches the kernel (and counts the launch in
    ``keccak_f.launches``); a CPU tensor takes the plain PyTorch version.
    There is no fallback between the two: a failed build or launch raises.
    """
    if state.device.type == "cuda":
        out = keccak_f1600.launch(state)
        if state.numel():  # an empty batch launches nothing
            keccak_f.launches += 1
        return out
    if state.device.type == "cpu":
        return keccak_f1600.keccak_f_plain(state)
    raise ValueError(f"keccak_f runs on cuda or cpu, not {state.device}")


keccak_f.launches = 0


def keccak256_blocks(blocks: torch.Tensor, num_blocks: torch.Tensor) -> torch.Tensor:
    """Digest pre-padded rate blocks; returns ``(..., 8)`` stream words.

    ``blocks`` is ``(..., B, 17, 2)`` int32 (17 lanes per 136-byte rate
    block, padded by :func:`pack_messages`); ``num_blocks`` is ``(...,)``
    in ``[1, B]``.  Every lane runs all ``B`` blocks; blocks past
    ``num_blocks`` are dropped by a select, as in the JAX package.
    """
    bmax = blocks.shape[-3]
    batch = blocks.shape[:-3]
    state = torch.zeros(batch + (25, 2), dtype=torch.int32, device=blocks.device)
    for i in range(bmax):
        absorbed = torch.cat([state[..., :17, :] ^ blocks[..., i, :, :], state[..., 17:, :]], dim=-2)
        nxt = keccak_f(absorbed)
        live = (i < num_blocks)[..., None, None]
        state = torch.where(live, nxt, state)
    # Digest = first 4 lanes, little-endian => stream words interleave lo/hi.
    return state[..., :4, :].reshape(batch + (8,))


def _srl(w: torch.Tensor, n: int) -> torch.Tensor:
    """Logical right shift of int32 bit patterns."""
    return (w >> n) & ((1 << (32 - n)) - 1) if n else w


def bswap32(w: torch.Tensor) -> torch.Tensor:
    """Byte-swap each 32-bit word (big-endian <-> little-endian)."""
    return _srl(w, 24) | ((w >> 8) & 0xFF00) | ((w << 8) & 0xFF0000) | (w << 24)


def limbs_to_words_le(limbs: torch.Tensor, nwords: int = 8) -> torch.Tensor:
    """Canonical 13-bit limbs -> little-endian 32-bit words of the integer."""
    words = []
    nl = limbs.shape[-1]
    for j in range(nwords):
        acc = torch.zeros(limbs.shape[:-1], dtype=torch.int32, device=limbs.device)
        for k in range(nl):
            lo_bit = LIMB_BITS * k
            if lo_bit + LIMB_BITS <= 32 * j or lo_bit >= 32 * (j + 1):
                continue
            sh = lo_bit - 32 * j
            if sh >= 0:
                acc = acc | (limbs[..., k] << sh)  # int32 << wraps = truncation
            else:
                acc = acc | (limbs[..., k] >> (-sh))  # limbs are non-negative
        words.append(acc)
    return torch.stack(words, dim=-1)


def words_le_to_limbs(words: torch.Tensor, nlimbs: int) -> torch.Tensor:
    """Little-endian 32-bit words -> canonical 13-bit int32 limbs."""
    limbs = []
    nw = words.shape[-1]
    for k in range(nlimbs):
        lo_bit = LIMB_BITS * k
        j = lo_bit // 32
        sh = lo_bit - 32 * j
        acc = torch.zeros(words.shape[:-1], dtype=torch.int32, device=words.device)
        if j < nw:
            acc = _srl(words[..., j], sh)
            if sh + LIMB_BITS > 32 and j + 1 < nw:
                acc = acc | (words[..., j + 1] << (32 - sh))
        limbs.append(acc & LIMB_MASK)
    return torch.stack(limbs, dim=-1)


def pubkey_to_address_words(qx_limbs: torch.Tensor, qy_limbs: torch.Tensor) -> torch.Tensor:
    """keccak256(X32 || Y32)[12:] on the device; ``(..., 5)`` stream words.

    Input limbs must be canonical (:func:`go_ibft_tpu_torch.ops.fields.canon`).
    """
    xw = limbs_to_words_le(qx_limbs)
    yw = limbs_to_words_le(qy_limbs)
    # Big-endian serialization: stream word j of X = bswap(value word 7-j).
    stream = [bswap32(xw[..., 7 - j]) for j in range(8)]
    stream += [bswap32(yw[..., 7 - j]) for j in range(8)]
    batch = qx_limbs.shape[:-1]
    zero = torch.zeros(batch, dtype=torch.int32, device=qx_limbs.device)
    lanes = [torch.stack([stream[2 * t], stream[2 * t + 1]], dim=-1) for t in range(8)]
    # padding: byte 64 = 0x01 (lane 8 lo), byte 135 = 0x80 (lane 16 hi, top byte)
    lanes.append(torch.stack([zero + 0x01, zero], dim=-1))
    lanes += [torch.stack([zero, zero], dim=-1)] * 7
    lanes.append(torch.stack([zero, zero - (1 << 31)], dim=-1))
    block = torch.stack(lanes, dim=-2)  # (..., 17, 2)
    digest = keccak256_blocks(
        block[..., None, :, :], torch.ones(batch, dtype=torch.int32, device=block.device)
    )
    # Address = digest bytes 12..31 = stream words 3..7
    return digest[..., 3:]


# ---------------------------------------------------------------------------
# Host-side packing helpers (numpy, copied from the JAX package)
# ---------------------------------------------------------------------------


def pack_messages(payloads: Sequence[bytes], max_blocks: int) -> Tuple[np.ndarray, np.ndarray]:
    """Pad byte strings to Keccak rate blocks as uint32 lane pairs.

    Returns ``(blocks, num_blocks)`` with ``blocks`` of shape
    ``(N, max_blocks, 17, 2)`` uint32 and ``num_blocks`` int32, bit-identical
    to the JAX package's packer.  Raises if a payload exceeds the bucket.
    """
    n = len(payloads)
    if n == 0:
        return (
            np.zeros((0, max_blocks, 17, 2), dtype=np.uint32),
            np.zeros((0,), dtype=np.int32),
        )
    lens = np.fromiter((len(p) for p in payloads), dtype=np.int64, count=n)
    nbs = lens // RATE_BYTES + 1  # padding always adds [1, RATE] bytes
    if (nbs > max_blocks).any():
        i = int(np.argmax(nbs))
        raise ValueError(
            f"payload of {int(lens[i])} bytes needs {int(nbs[i])} blocks "
            f"> bucket {max_blocks}"
        )
    buf = np.zeros((n, max_blocks * RATE_BYTES), dtype=np.uint8)
    width = int(lens[0])
    if width and (lens == width).all():
        flat = np.frombuffer(b"".join(payloads), dtype=np.uint8)
        buf[:, :width] = flat.reshape(n, width)
    else:
        for i, data in enumerate(payloads):
            if data:
                buf[i, : len(data)] = np.frombuffer(data, dtype=np.uint8)
    rows = np.arange(n)
    buf[rows, lens] ^= 0x01
    buf[rows, nbs * RATE_BYTES - 1] ^= 0x80
    lanes = buf.view("<u4").reshape(n, max_blocks, 34)
    blocks = np.empty((n, max_blocks, 17, 2), dtype=np.uint32)
    blocks[..., 0] = lanes[:, :, 0::2]
    blocks[..., 1] = lanes[:, :, 1::2]
    return blocks, nbs.astype(np.int32)


def digest_words_to_bytes(words) -> bytes:
    """``(8,)`` stream words (uint32 or int32 bit patterns) -> 32 digest bytes."""
    if isinstance(words, torch.Tensor):
        words = words.cpu().numpy()
    return np.asarray(words).astype("<u4").tobytes()


def address_to_words(address: bytes) -> np.ndarray:
    """20-byte address -> ``(5,)`` uint32 stream words."""
    if len(address) != 20:
        raise ValueError("address must be 20 bytes")
    return np.frombuffer(address, dtype="<u4").copy()


def addresses_to_words(addresses: Sequence[bytes]) -> np.ndarray:
    """Bulk :func:`address_to_words`: ``N`` addresses -> ``(N, 5)`` uint32."""
    for i, a in enumerate(addresses):
        if len(a) != 20:
            raise ValueError(f"address {i} must be 20 bytes, got {len(a)}")
    n = len(addresses)
    if n == 0:
        return np.zeros((0, 5), dtype=np.uint32)
    return np.frombuffer(b"".join(addresses), dtype="<u4").reshape(n, 5).copy()
