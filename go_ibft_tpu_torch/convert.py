"""State carried across: the JAX package's round arrays and BLS point
arrays as the port's tensors.

``round_certify`` takes 18 positional arrays (the shapes and dtypes that
``__graft_entry__.entry()`` builds): packed PREPARE envelopes, packed
COMMIT seals, the validator table and the split voting powers — this
system's "weights".  :func:`round_args` turns them, as numpy or as a
workload object, into tensors on the port's device; :func:`round_arrays`
is the inverse.

``uint32`` words become ``int32`` bit views (PyTorch's ``uint32`` has no
shifts or additions); booleans stay ``bool``; the two threshold halves
become 0-d ``int32`` tensors.

The BLS12-381 point arrays (the JAX package's ``ops/bls12_381.py``
``pack_g1_points`` / ``pack_g2_points``: per coordinate a ``(..., 30)``
int32 array of 13-bit limbs, Montgomery form with R = 2**390) are the BLS
path's weights; :func:`bls_points` turns them into the port's ``(..., C,
12)`` int32 words (Montgomery form with R = 2**384, the kernels' layout,
:mod:`go_ibft_tpu_torch.ops.bls_fp`) and :func:`bls_point_arrays` back.
The two agree as integers mod p, not as limbs.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from .utils.device import DeviceLike, resolve_device

# round_certify's arguments, in order; the uint32 word arrays by position.
ROUND_ARG_NAMES = (
    "blocks", "nblocks", "pr", "ps", "pv", "sender_w", "plive",
    "hash_zw", "sr", "ss", "sv", "signer_w", "slive",
    "table_w", "powers_lo", "powers_hi", "thr_lo", "thr_hi",
)
_WORD_ARGS = frozenset({0, 5, 7, 11, 13})


def workload_arrays(workload) -> Tuple:
    """The 18 numpy arguments of a round workload (either package's)."""
    blocks, counts, pr, ps, pv, senders, plive = workload.prepare
    hz, sr, ss, sv, signers, slive = workload.seals
    return (
        blocks, counts, pr, ps, pv, senders, plive,
        hz, sr, ss, sv, signers, slive,
        workload.table, workload.powers_lo, workload.powers_hi,
        np.int32(workload.thr_lo), np.int32(workload.thr_hi),
    )


def _to_tensor(i: int, a, device: torch.device) -> torch.Tensor:
    arr = np.asarray(a)
    if i in _WORD_ARGS:
        if arr.dtype != np.uint32:
            raise TypeError(f"{ROUND_ARG_NAMES[i]} must be uint32, got {arr.dtype}")
        arr = arr.view(np.int32)
    elif arr.dtype != np.bool_:
        arr = arr.astype(np.int32, copy=False)
    return torch.from_numpy(np.require(arr, requirements="C")).to(device)


def round_args(workload_or_arrays, device: DeviceLike = None) -> Tuple[torch.Tensor, ...]:
    """The 18 ``round_certify`` arguments as tensors on ``device``.

    Takes a workload (anything with ``prepare``, ``seals``, ``table``,
    ``powers_lo``, ``powers_hi``, ``thr_lo``, ``thr_hi``, as both packages'
    ``build_round_workload`` return) or the 18 numpy arrays themselves.
    ``device=None`` means the card.
    """
    dev = resolve_device(device)
    if hasattr(workload_or_arrays, "prepare"):
        arrays: Sequence = workload_arrays(workload_or_arrays)
    else:
        arrays = tuple(workload_or_arrays)
    if len(arrays) != len(ROUND_ARG_NAMES):
        raise ValueError(f"round_certify takes {len(ROUND_ARG_NAMES)} arrays, got {len(arrays)}")
    return tuple(_to_tensor(i, a, dev) for i, a in enumerate(arrays))


def round_arrays(args: Sequence[torch.Tensor]) -> Tuple[np.ndarray, ...]:
    """Inverse of :func:`round_args`: numpy arrays in the JAX package's dtypes."""
    out = []
    for i, t in enumerate(args):
        arr = t.detach().cpu().numpy()
        out.append(arr.view(np.uint32) if i in _WORD_ARGS else arr)
    return tuple(out)


# -- BLS12-381 points ----------------------------------------------------------

_BLS_P = 0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFAAAB
_JAX_LIMB_BITS, _JAX_LIMBS = 13, 30
# x R_jax -> x R_port: times 2**384 / 2**390 mod p.
_JAX_TO_PORT = pow(2, -6, _BLS_P)
_PORT_TO_JAX = 64


def _jax_ints(arr: np.ndarray) -> list:
    rows = np.asarray(arr, dtype=np.int64).reshape(-1, _JAX_LIMBS).tolist()
    return [sum(int(v) << (_JAX_LIMB_BITS * i) for i, v in enumerate(row)) for row in rows]


def bls_points(*coords, device: DeviceLike = None) -> torch.Tensor:
    """The JAX package's packed BLS point arrays — 2 coordinate arrays (G1
    x, y) or 4 (G2 x0, x1, y0, y1), each ``(..., 30)`` — as the port's
    ``(..., C, 12)`` int32 words on ``device`` (``None`` means the card)."""
    from .ops import bls_fp

    dev = resolve_device(device)
    if len(coords) not in (2, 4):
        raise ValueError(f"a BLS point has 2 (G1) or 4 (G2) coordinate arrays, got {len(coords)}")
    lead = np.asarray(coords[0]).shape[:-1]
    cols = [[v * _JAX_TO_PORT % _BLS_P for v in _jax_ints(c)] for c in coords]
    flat = [v for row in zip(*cols) for v in row]
    words = np.asarray(bls_fp.words_of(flat), dtype=np.int64).astype(np.int32)
    return torch.from_numpy(words.reshape(*lead, len(coords), bls_fp.WORDS)).to(dev)


def bls_point_arrays(points: torch.Tensor) -> Tuple[np.ndarray, ...]:
    """Inverse of :func:`bls_points`: the JAX package's ``(..., 30)`` int32
    coordinate arrays."""
    from .ops import bls_fp

    lead = tuple(points.shape[:-2])
    ncoords = points.shape[-2]
    vals = bls_fp.ints_of(points)
    out = []
    for c in range(ncoords):
        limbs = np.zeros((len(vals) // ncoords, _JAX_LIMBS), dtype=np.int32)
        for i, v in enumerate(vals[c::ncoords]):
            v = v * _PORT_TO_JAX % _BLS_P
            for j in range(_JAX_LIMBS):
                limbs[i, j] = (v >> (_JAX_LIMB_BITS * j)) & ((1 << _JAX_LIMB_BITS) - 1)
        out.append(limbs.reshape(*lead, _JAX_LIMBS))
    return tuple(out)
