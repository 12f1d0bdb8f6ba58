"""The certification after the recovery: the CUDA kernel's launcher and its
plain PyTorch version.

The kernel ``csrc/certify_lanes.cu`` replaces what the JAX package's
programs ``go_ibft_tpu/verify/batch.py::_certify_fn``, ``_recover_fn`` and
``_round_fn`` (and ``go_ibft_tpu/ops/quorum.py::round_certify``) compute
after the recovery ladder: the tail of ``sig_checks_zw``, ``membership_eq``
and ``power_reduce``, in one launch with no ``(B, V)`` matrix in device
memory.

* :func:`launch` runs the kernel on CUDA tensors and raises on any fault;
* :func:`certify_plain` is the same function composed of
  :func:`~go_ibft_tpu_torch.ops.quorum.claimed_checks`,
  :func:`~go_ibft_tpu_torch.ops.quorum.membership_eq` and
  :func:`~go_ibft_tpu_torch.ops.quorum.power_reduce`, on any device;
* :func:`certify` is the wrapper the port calls: the kernel for a CUDA
  tensor (counted in ``certify.launches``), the plain version for a CPU
  tensor.

Inputs: ``addr`` ``(n, 5)`` int32 and ``ok`` ``(n,)`` bool from the
recovery (``addr`` is unspecified where ``ok`` is false), ``claimed``
``(n, 5)`` int32, ``live`` ``(n,)`` bool, the validator ``table`` ``(V, 5)``
int32 and its power halves ``plo``, ``phi`` ``(V,)`` int32.  ``thresholds``
holds one ``(thr_lo, thr_hi)`` pair a phase, zero to two of them: no phase
is the mask alone; one phase is every lane; with two, the first ``split``
lanes (``n // 2`` by default, as ``_round_fn`` splits) are phase 0.  A
threshold half is an int, or a 0-d int32 tensor on the lanes' device,
which the kernel reads on the card (no copy to the host).  Outputs:
``mask`` ``(n,)`` bool, and ``reached`` bool, ``lo``, ``hi`` int32, ``(P,)``
each, with ``got = hi * 2**16 + lo`` a phase's counted power.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import torch

from .. import _build

__all__ = ["launch", "certify_plain", "certify"]

_Half = Union[int, torch.Tensor]
_Out = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]
_MAX_PHASES = 2


def _check(addr, ok, claimed, live, table, plo, phi, thresholds, split) -> int:
    """Validate the inputs; returns the first phase's lane count."""
    lanes = ok.shape
    if len(lanes) != 1 or live.shape != lanes:
        raise ValueError(f"ok and live must be (n,), got {tuple(ok.shape)} and {tuple(live.shape)}")
    if ok.dtype != torch.bool or live.dtype != torch.bool:
        raise TypeError(f"ok and live must be bool, got {ok.dtype} and {live.dtype}")
    n = lanes[0]
    for name, t in (("addr", addr), ("claimed", claimed)):
        if t.shape != (n, 5) or t.dtype != torch.int32:
            raise ValueError(f"{name} must be an int32 {(n, 5)}, got {t.dtype} {tuple(t.shape)}")
    rows = table.shape
    if len(rows) != 2 or rows[1] != 5 or table.dtype != torch.int32:
        raise ValueError(f"table must be an int32 (V, 5), got {table.dtype} {tuple(rows)}")
    phases = len(thresholds)
    if phases > _MAX_PHASES:
        raise ValueError(f"at most {_MAX_PHASES} phases, got {phases}")
    if phases:
        for name, t in (("plo", plo), ("phi", phi)):
            if t is None or t.shape != rows[:1] or t.dtype != torch.int32:
                raise ValueError(f"{name} must be an int32 {(rows[0],)}, got {None if t is None else tuple(t.shape)}")
        for pair in thresholds:
            for half in pair:
                if isinstance(half, torch.Tensor) and (half.numel() != 1 or half.dtype != torch.int32):
                    raise ValueError(f"a threshold tensor must be one int32, got {half.dtype} {tuple(half.shape)}")
    first = n if phases < 2 else (n // 2 if split is None else split)
    if not 0 <= first <= n:
        raise ValueError(f"split {split} outside 0..{n}")
    return first


# The kernel's entry point, bound at its first launch.
_entry = None


def _kernel():
    global _entry
    if _entry is None:
        _entry = _build.load("certify_lanes").certify_lanes
    return _entry


def launch(
    addr: torch.Tensor,
    ok: torch.Tensor,
    claimed: torch.Tensor,
    live: torch.Tensor,
    table: torch.Tensor,
    plo: Optional[torch.Tensor] = None,
    phi: Optional[torch.Tensor] = None,
    thresholds: Sequence[Tuple[_Half, _Half]] = (),
    split: Optional[int] = None,
) -> _Out:
    """Run ``csrc/certify_lanes.cu``; returns ``(mask, reached, lo, hi)``.

    Every tensor is a contiguous CUDA tensor on one card.  The outputs are
    views of one ``torch.empty`` buffer; one launch on PyTorch's current
    stream, no synchronisation.  No lane launches nothing: the phases' sums
    are then 0 against their thresholds.  Raises on any fault, a CPU tensor
    included.
    """
    first = _check(addr, ok, claimed, live, table, plo, phi, thresholds, split)
    dev = ok.device
    phases = len(thresholds)
    tensors = (addr, ok, claimed, live, table, plo, phi) if phases else (addr, ok, claimed, live, table)
    values, pointers, k = [0, 0, 0, 0], [None, None, None, None], 0
    for pair in thresholds:
        for half in pair:
            if isinstance(half, torch.Tensor):
                tensors += (half,)
                pointers[k] = half.data_ptr()
            else:
                values[k] = int(half)
            k += 1
    if not ok.is_cuda or any(t.device != dev for t in tensors):
        raise ValueError(f"the certify kernel takes CUDA tensors on one card, got {[str(t.device) for t in tensors]}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("certify inputs must be contiguous")
    n = ok.shape[0]
    # One buffer in the kernel's layout: lo, hi (int32 a phase), reached, mask.
    out = torch.empty((9 * phases + n,), dtype=torch.bool, device=dev)
    lo, hi, reached, mask = out.split_with_sizes((4 * phases, 4 * phases, phases, n))
    lo, hi = lo.view(torch.int32), hi.view(torch.int32)
    if n == 0:
        pairs = [(int(h_lo), int(h_hi)) for h_lo, h_hi in thresholds]
        reached = torch.tensor([t_hi < 0 or (t_hi == 0 and t_lo <= 0) for t_lo, t_hi in pairs],
                               dtype=torch.bool, device=dev)
        return mask, reached, torch.zeros_like(lo), torch.zeros_like(hi)
    args = (
        addr.data_ptr(), ok.data_ptr(), claimed.data_ptr(), live.data_ptr(), n,
        table.data_ptr(), plo.data_ptr() if phases else None, phi.data_ptr() if phases else None,
        table.shape[0], phases, first, *values, *pointers, out.data_ptr(),
    )
    fn = _kernel()
    # The card's current stream as a raw pointer (no Stream object made).
    # It and the kernel's module belong to the tensors' card, which is made
    # current for the launch where the caller's card is another.
    stream = torch._C._cuda_getCurrentRawStream(dev.index)
    if dev.index == torch.cuda.current_device():
        rc = fn(*args, stream)
    else:
        with torch.cuda.device(dev):
            rc = fn(*args, stream)
    if rc != 0:
        raise RuntimeError(f"certify_lanes launch failed: cudaError {rc}")
    return mask, reached, lo, hi


def certify_plain(
    addr: torch.Tensor,
    ok: torch.Tensor,
    claimed: torch.Tensor,
    live: torch.Tensor,
    table: torch.Tensor,
    plo: Optional[torch.Tensor] = None,
    phi: Optional[torch.Tensor] = None,
    thresholds: Sequence[Tuple[_Half, _Half]] = (),
    split: Optional[int] = None,
) -> _Out:
    """The kernel's function in PyTorch ops, on any device: the composition
    the JAX package's ``_certify_fn`` / ``_round_fn`` make of
    ``sig_checks_zw``'s tail, ``membership_eq`` and ``power_reduce``."""
    from . import quorum

    first = _check(addr, ok, claimed, live, table, plo, phi, thresholds, split)
    eq = quorum.membership_eq(claimed, table)
    mask = quorum.claimed_checks(addr, ok, claimed, live) & torch.any(eq, dim=-1)
    n = ok.shape[0]
    bounds = [(0, n)] if len(thresholds) == 1 else [(0, first), (first, n)]
    out = [
        quorum.power_reduce(mask[a:b], eq[a:b], plo, phi, thr_lo, thr_hi)
        for (a, b), (thr_lo, thr_hi) in zip(bounds, thresholds)
    ]
    dev = ok.device
    if not out:
        empty = torch.empty((0,), dtype=torch.int32, device=dev)
        return mask, empty.bool(), empty, empty.clone()
    reached, lo, hi = (torch.stack([torch.as_tensor(p[k], device=dev) for p in out]) for k in range(3))
    return mask, reached, lo.to(torch.int32), hi.to(torch.int32)


def certify(
    addr: torch.Tensor,
    ok: torch.Tensor,
    claimed: torch.Tensor,
    live: torch.Tensor,
    table: torch.Tensor,
    plo: Optional[torch.Tensor] = None,
    phi: Optional[torch.Tensor] = None,
    thresholds: Sequence[Tuple[_Half, _Half]] = (),
    split: Optional[int] = None,
) -> _Out:
    """Mask and quorum: the kernel on a CUDA tensor, the plain version on a
    CPU tensor.  No fallback between the two: a failed build or launch
    raises."""
    if ok.is_cuda:
        out = launch(addr, ok, claimed, live, table, plo, phi, thresholds, split)
        if ok.numel():  # no lane launches nothing
            _build.count_launch(certify)
        return out
    if ok.device.type == "cpu":
        return certify_plain(addr, ok, claimed, live, table, plo, phi, thresholds, split)
    raise ValueError(f"certify runs on cuda or cpu, not {ok.device}")


certify.launches = 0
