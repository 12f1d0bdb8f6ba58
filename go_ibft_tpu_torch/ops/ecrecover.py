"""secp256k1 recovery plus the address hash: the CUDA kernel's launcher and
its plain PyTorch version.

The kernel ``csrc/secp256k1_recover.cu`` replaces the JAX package's XLA
programs ``go_ibft_tpu/ops/secp256k1.py::ecdsa_recover`` and, in its
epilogue, ``go_ibft_tpu/ops/keccak.py::pubkey_to_address_words``: two warps
per block of 32 lanes, from the signed value to the 20-byte address, one
launch per batch.  It adds u1*G from a fixed-base comb table,
:func:`comb_table`, built here once from ``crypto.ecdsa``'s integers and
uploaded once per card.

* :func:`launch` runs the kernel on CUDA tensors and raises on any fault;
* :func:`recover_plain` is the same function in PyTorch ops on any device:
  :func:`~go_ibft_tpu_torch.ops.keccak.words_le_to_limbs`, then
  :func:`~go_ibft_tpu_torch.ops.secp256k1.ecdsa_recover_plain`, then
  :func:`~go_ibft_tpu_torch.ops.keccak.pubkey_to_address_words`;
* :func:`recover` is the wrapper the port calls: the kernel for a CUDA
  tensor (counted in ``recover.launches``), the plain version for a CPU
  tensor.

Inputs, per lane: ``z`` as ``(..., 8)`` int32 little-endian value words (a
digest or the proposal hash) or ``(..., 20)`` canonical 13-bit limbs; ``r``,
``s`` as ``(..., 20)`` canonical 13-bit limbs; ``v`` as ``(...)`` int32.
Outputs: ``x``, ``y`` ``(..., 20)`` canonical limbs, ``addr`` ``(..., 5)``
stream words, ``ok`` ``(...)`` bool.  Where ``ok`` is false, ``x``, ``y`` and
``addr`` are unspecified.
"""

from __future__ import annotations

import functools
from typing import Dict, Tuple

import numpy as np
import torch

from .. import _build
from ..crypto import ecdsa
from . import keccak as dk
from . import secp256k1 as sec

__all__ = ["comb_table", "launch", "recover_plain", "recover"]

_L = 20  # limbs per scalar / coordinate
_Out = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]
COMB_WINDOWS = 32  # 8-bit windows of a 256-bit scalar
COMB_DIGITS = 256
_comb_on_card: Dict[torch.device, torch.Tensor] = {}


@functools.lru_cache(maxsize=1)
def comb_table() -> np.ndarray:
    """The kernel's fixed-base comb: ``d * 2**(8*w) * G`` for ``w < 32``,
    ``d < 256``, affine, as a ``(32, 256, 16)`` uint32 array of
    little-endian words, x then y; the rows ``d = 0`` are zero and unused."""
    rows = bytearray(COMB_WINDOWS * COMB_DIGITS * 64)
    base: ecdsa.Point = (ecdsa.GX, ecdsa.GY)
    for w in range(COMB_WINDOWS):
        pt: ecdsa.Point = None
        for d in range(1, COMB_DIGITS):
            pt = ecdsa._add(pt, base)
            at = (w * COMB_DIGITS + d) * 64
            rows[at:at + 32] = pt[0].to_bytes(32, "little")
            rows[at + 32:at + 64] = pt[1].to_bytes(32, "little")
        base = ecdsa._add(pt, base)  # 256 * 2**(8*w) * G
    return np.frombuffer(bytes(rows), dtype="<u4").reshape(COMB_WINDOWS, COMB_DIGITS, 16)


def _comb_on(dev: torch.device) -> torch.Tensor:
    """:func:`comb_table` on the card ``dev``, uploaded at its first use."""
    table = _comb_on_card.get(dev)
    if table is None:
        table = torch.from_numpy(comb_table().view(np.int32).copy()).to(dev)
        _comb_on_card[dev] = table
    return table


def _check(z: torch.Tensor, r: torch.Tensor, s: torch.Tensor, v: torch.Tensor) -> None:
    for name, t in (("z", z), ("r", r), ("s", s), ("v", v)):
        if t.dtype != torch.int32:
            raise TypeError(f"recovery input {name} must be int32, got {t.dtype}")
    batch = tuple(v.shape)
    if tuple(r.shape) != batch + (_L,) or tuple(s.shape) != batch + (_L,):
        raise ValueError(
            f"r and s must be {batch + (_L,)}, got {tuple(r.shape)} and {tuple(s.shape)}"
        )
    if z.dim() != len(batch) + 1 or tuple(z.shape[:-1]) != batch or z.shape[-1] not in (8, _L):
        raise ValueError(f"z must be {batch} + (8,) words or (20,) limbs, got {tuple(z.shape)}")


def launch(z: torch.Tensor, r: torch.Tensor, s: torch.Tensor, v: torch.Tensor) -> _Out:
    """Run ``csrc/secp256k1_recover.cu``; returns ``(x, y, addr, ok)``.

    All four inputs are contiguous int32 CUDA tensors on one card.  Outputs
    are allocated with ``torch.empty``; one launch on PyTorch's current
    stream, no synchronisation.  Raises on any fault, a CPU tensor included.
    """
    _check(z, r, s, v)
    dev = v.device
    if dev.type != "cuda" or any(t.device != dev for t in (z, r, s)):
        raise ValueError(
            "the recovery kernel takes CUDA tensors on one card, got "
            f"{[str(t.device) for t in (z, r, s, v)]}"
        )
    if not all(t.is_contiguous() for t in (z, r, s, v)):
        raise ValueError("recovery inputs must be contiguous")
    lib = _build.load("secp256k1_recover")
    gtab = _comb_on(dev)
    batch = tuple(v.shape)
    x = torch.empty(batch + (_L,), dtype=torch.int32, device=dev)
    y = torch.empty_like(x)
    addr = torch.empty(batch + (5,), dtype=torch.int32, device=dev)
    ok = torch.empty(batch, dtype=torch.bool, device=dev)
    n = v.numel()
    if n:
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.secp256k1_recover(
            z.data_ptr(), z.shape[-1], r.data_ptr(), s.data_ptr(), v.data_ptr(),
            gtab.data_ptr(), x.data_ptr(), y.data_ptr(), addr.data_ptr(), ok.data_ptr(), n, stream,
        )
        if rc != 0:
            raise RuntimeError(f"secp256k1_recover launch failed: cudaError {rc}")
    return x, y, addr, ok


def recover_plain(z: torch.Tensor, r: torch.Tensor, s: torch.Tensor, v: torch.Tensor) -> _Out:
    """The kernel's function in PyTorch ops, on any device."""
    _check(z, r, s, v)
    z_limbs = dk.words_le_to_limbs(z, _L) if z.shape[-1] == 8 else z
    x, y, ok = sec.ecdsa_recover_plain(z_limbs, r, s, v)
    addr = dk.pubkey_to_address_words(x, y)
    return x, y, addr, ok


def recover(z: torch.Tensor, r: torch.Tensor, s: torch.Tensor, v: torch.Tensor) -> _Out:
    """Recovery plus address: the kernel on a CUDA tensor, the plain version
    on a CPU tensor.  No fallback between the two: a failed build or launch
    raises."""
    if v.device.type == "cuda":
        out = launch(z, r, s, v)
        if v.numel():  # an empty batch launches nothing
            recover.launches += 1
        return out
    if v.device.type == "cpu":
        return recover_plain(z, r, s, v)
    raise ValueError(f"recover runs on cuda or cpu, not {v.device}")


recover.launches = 0
