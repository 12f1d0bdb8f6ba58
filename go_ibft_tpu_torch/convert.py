"""State carried across: the JAX package's round arrays as the port's tensors.

``round_certify`` takes 18 positional arrays (the shapes and dtypes that
``__graft_entry__.entry()`` builds): packed PREPARE envelopes, packed
COMMIT seals, the validator table and the split voting powers — this
system's "weights".  :func:`round_args` turns them, as numpy or as a
workload object, into tensors on the port's device; :func:`round_arrays`
is the inverse.

``uint32`` words become ``int32`` bit views (PyTorch's ``uint32`` has no
shifts or additions); booleans stay ``bool``; the two threshold halves
become 0-d ``int32`` tensors.
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
