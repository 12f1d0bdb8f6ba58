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

import ctypes
from typing import Optional, Sequence, Tuple, Union

import torch

from .. import _build

__all__ = ["launch", "certify_plain", "certify"]

_Half = Union[int, torch.Tensor]
_Out = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]
_MAX_PHASES = 2


def _check(addr, ok, claimed, live, table, plo, phi, thresholds, split) -> int:
    """Validate the inputs; returns the first phase's lane count."""
    n = ok.shape[0] if ok.dim() == 1 else -1
    if ok.dim() != 1 or live.shape != ok.shape:
        raise ValueError(f"ok and live must be (n,), got {tuple(ok.shape)} and {tuple(live.shape)}")
    if ok.dtype != torch.bool or live.dtype != torch.bool:
        raise TypeError(f"ok and live must be bool, got {ok.dtype} and {live.dtype}")
    for name, t, shape in (("addr", addr, (n, 5)), ("claimed", claimed, (n, 5))):
        if tuple(t.shape) != shape or t.dtype != torch.int32:
            raise ValueError(f"{name} must be an int32 {shape}, got {t.dtype} {tuple(t.shape)}")
    if table.dim() != 2 or table.shape[1] != 5 or table.dtype != torch.int32:
        raise ValueError(f"table must be an int32 (V, 5), got {table.dtype} {tuple(table.shape)}")
    if len(thresholds) > _MAX_PHASES:
        raise ValueError(f"at most {_MAX_PHASES} phases, got {len(thresholds)}")
    if thresholds:
        rows = (table.shape[0],)
        for name, t in (("plo", plo), ("phi", phi)):
            if t is None or tuple(t.shape) != rows or t.dtype != torch.int32:
                raise ValueError(f"{name} must be an int32 {rows}, got {None if t is None else tuple(t.shape)}")
        for half in (h for pair in thresholds for h in pair):
            if isinstance(half, torch.Tensor) and (half.numel() != 1 or half.dtype != torch.int32):
                raise ValueError(f"a threshold tensor must be one int32, got {half.dtype} {tuple(half.shape)}")
    first = n if len(thresholds) < 2 else (n // 2 if split is None else split)
    if not 0 <= first <= n:
        raise ValueError(f"split {split} outside 0..{n}")
    return first


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

    Every tensor is a contiguous CUDA tensor on one card.  Outputs are
    allocated with ``torch.empty``; one launch on PyTorch's current stream,
    no synchronisation.  No lane launches nothing: the phases' sums are then
    0 against their thresholds.  Raises on any fault, a CPU tensor included.
    """
    first = _check(addr, ok, claimed, live, table, plo, phi, thresholds, split)
    dev = ok.device
    tensors = [addr, ok, claimed, live, table] + ([plo, phi] if thresholds else [])
    halves = [h for pair in thresholds for h in pair]
    tensors += [h for h in halves if isinstance(h, torch.Tensor)]
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError(
            f"the certify kernel takes CUDA tensors on one card, got {[str(t.device) for t in tensors]}"
        )
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("certify inputs must be contiguous")
    n, phases = ok.shape[0], len(thresholds)
    mask = torch.empty((n,), dtype=torch.bool, device=dev)
    reached = torch.empty((phases,), dtype=torch.bool, device=dev)
    lo = torch.empty((phases,), dtype=torch.int32, device=dev)
    hi = torch.empty((phases,), dtype=torch.int32, device=dev)
    if n == 0:
        pairs = [(int(h_lo), int(h_hi)) for h_lo, h_hi in thresholds]
        reached = torch.tensor([t_hi < 0 or (t_hi == 0 and t_lo <= 0) for t_lo, t_hi in pairs],
                               dtype=torch.bool, device=dev)
        return mask, reached, torch.zeros_like(lo), torch.zeros_like(hi)
    lib = _build.load("certify_lanes")
    values = (ctypes.c_longlong * (2 * _MAX_PHASES))(
        *[0 if isinstance(h, torch.Tensor) else int(h) for h in halves]
    )
    at = (ctypes.c_void_p * (2 * _MAX_PHASES))(
        *[h.data_ptr() if isinstance(h, torch.Tensor) else None for h in halves]
    )
    # The tensors' card is made current for the launch: the stream and the
    # kernel's module belong to it, whichever card the caller's is.
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.certify_lanes(
            addr.data_ptr(), ok.data_ptr(), claimed.data_ptr(), live.data_ptr(), n,
            table.data_ptr(), plo.data_ptr() if phases else None, phi.data_ptr() if phases else None,
            table.shape[0], phases, first, ctypes.addressof(values), ctypes.addressof(at),
            mask.data_ptr(), reached.data_ptr(), lo.data_ptr(), hi.data_ptr(), stream,
        )
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
    if ok.device.type == "cuda":
        out = launch(addr, ok, claimed, live, table, plo, phi, thresholds, split)
        if ok.numel():  # no lane launches nothing
            _build.count_launch(certify)
        return out
    if ok.device.type == "cpu":
        return certify_plain(addr, ok, claimed, live, table, plo, phi, thresholds, split)
    raise ValueError(f"certify runs on cuda or cpu, not {ok.device}")


certify.launches = 0
