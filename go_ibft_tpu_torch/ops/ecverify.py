"""``k1*G + k2*Q`` and ECDSA verification: the CUDA kernel's launchers and
their plain PyTorch versions.

The kernel, ``csrc/secp256k1_ecmul2.cu`` (on the lane arithmetic it shares
with the recovery kernel, ``csrc/secp256k1.cuh``), replaces the JAX
package's XLA programs ``go_ibft_tpu/ops/secp256k1.py::ecmul2_base`` (entry
``secp256k1_ecmul2``) and ``::ecdsa_verify`` (entry ``secp256k1_verify``):
four warps a block of 8 lanes, a lane's independent field products four at
a time over a group of four threads, one launch per batch.  It adds
``k1*G`` from the recovery's fixed-base comb
(:func:`~go_ibft_tpu_torch.ops.ecrecover.comb_table`, uploaded once per
card).

* :func:`launch_ecmul2` and :func:`launch_verify` run the kernel on CUDA
  tensors and raise on any fault;
* :func:`ecmul2_plain` and :func:`verify_plain` are the same functions in
  PyTorch ops on any device
  (:func:`~go_ibft_tpu_torch.ops.secp256k1.ecmul2_base_plain`,
  :func:`~go_ibft_tpu_torch.ops.secp256k1.ecdsa_verify_plain`);
* :func:`ecmul2` and :func:`verify` are the wrappers the port calls: the
  kernel for a CUDA tensor (counted in ``ecmul2.launches`` and
  ``verify.launches``), the plain version for a CPU tensor.

Inputs, per lane, ``(..., 20)`` int32 13-bit limbs: ``k1``, ``k2`` below
``2N``; ``qx``, ``qy`` canonical affine; ``z`` (taken mod N), ``r``, ``s``
as raw values, range-checked.  The wrappers and the plain versions
broadcast the inputs over their leading axes by the JAX functions' rules
(one key against many scalars or signatures:
:func:`~go_ibft_tpu_torch.ops.secp256k1.ecmul2_batch`, ``verify_batch``);
the launchers take one batch shape, contiguous.
Outputs: ``k1*G + k2*Q`` as a Jacobian point of canonical limbs, ``Z == 0``
at infinity (the kernel's equals the plain version's as a projective
point, not limb for limb), or the verification mask ``(...)`` bool.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from .. import _build
from . import ecrecover
from . import secp256k1 as sec

__all__ = ["launch_ecmul2", "launch_verify", "ecmul2_plain", "verify_plain", "ecmul2", "verify"]

_L = 20  # limbs per scalar / coordinate


def _dtypes(named: Sequence[Tuple[str, torch.Tensor]]) -> None:
    for name, t in named:
        if t.dtype != torch.int32:
            raise TypeError(f"input {name} must be int32, got {t.dtype}")


def _check(named: Sequence[Tuple[str, torch.Tensor]]) -> Tuple[int, ...]:
    """Every input int32 ``(..., 20)`` of one batch shape; returns it."""
    _dtypes(named)
    shape = tuple(named[0][1].shape)
    if not shape or shape[-1] != _L or any(tuple(t.shape) != shape for _, t in named):
        raise ValueError(
            f"inputs must share one shape (..., {_L}), got "
            f"{ {name: tuple(t.shape) for name, t in named} }"
        )
    return shape[:-1]


def _broadcast(named: Sequence[Tuple[str, torch.Tensor]], batch_of) -> Tuple[torch.Tensor, ...]:
    """The int32 inputs, each ending in its 20 limbs, expanded to the batch
    shape ``batch_of`` gives their leading shapes (the JAX function's
    broadcasting) and made contiguous: what the launchers take."""
    _dtypes(named)
    for name, t in named:
        if t.dim() == 0 or t.shape[-1] != _L:
            raise ValueError(f"input {name} must be (..., {_L}) limbs, got {tuple(t.shape)}")
    shape = named[0][1].shape
    if all(t.shape == shape and t.is_contiguous() for _, t in named):
        return tuple(t for _, t in named)
    full = batch_of(*(t.shape[:-1] for _, t in named)) + (_L,)
    return tuple(t if t.shape == full and t.is_contiguous() else t.expand(full).contiguous()
                 for _, t in named)


def _on_card(named: Sequence[Tuple[str, torch.Tensor]]) -> torch.device:
    if not all(t.is_contiguous() for _, t in named):
        raise ValueError("kernel inputs must be contiguous")
    dev = named[0][1].device
    if dev.type != "cuda" or any(t.device != dev for _, t in named):
        raise ValueError(
            f"the kernel takes CUDA tensors on one card, got {[str(t.device) for _, t in named]}"
        )
    return dev


# The two entry points, bound at their first launch.
_entries = {}


def _run(entry: str, dev: torch.device, *args) -> None:
    """Launch ``entry`` on ``dev``'s current stream; raise on a fault."""
    fn = _entries.get(entry)
    if fn is None:
        fn = _entries[entry] = getattr(_build.load("secp256k1_ecmul2"), entry)
    # The card's current stream as a raw pointer.  It and the kernel's
    # module belong to the tensors' card, which is made current for the
    # launch where the caller's card is another.
    stream = torch._C._cuda_getCurrentRawStream(dev.index)
    if dev.index == torch.cuda.current_device():
        rc = fn(*args, stream)
    else:
        with torch.cuda.device(dev):
            rc = fn(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{entry} launch failed: cudaError {rc}")


def launch_ecmul2(
    k1: torch.Tensor, k2: torch.Tensor, qx: torch.Tensor, qy: torch.Tensor
) -> sec.JacobianPoint:
    """Run the ``secp256k1_ecmul2`` entry; returns ``k1*G + k2*Q``.

    All four inputs are contiguous int32 CUDA tensors of one shape on one
    card.  Outputs are allocated with ``torch.empty``; one launch on
    PyTorch's current stream, no synchronisation.  Raises on any fault, a
    CPU tensor included."""
    named = (("k1", k1), ("k2", k2), ("qx", qx), ("qy", qy))
    batch = _check(named)
    dev = _on_card(named)
    x = torch.empty(batch + (_L,), dtype=torch.int32, device=dev)
    y = torch.empty_like(x)
    z = torch.empty_like(x)
    n = x.numel() // _L
    if n:
        gtab = ecrecover._comb_on(dev)
        _run("secp256k1_ecmul2", dev, k1.data_ptr(), k2.data_ptr(), qx.data_ptr(), qy.data_ptr(),
             gtab.data_ptr(), x.data_ptr(), y.data_ptr(), z.data_ptr(), n)
    return sec.JacobianPoint(x, y, z)


def launch_verify(
    qx: torch.Tensor, qy: torch.Tensor, z: torch.Tensor, r: torch.Tensor, s: torch.Tensor
) -> torch.Tensor:
    """Run the ``secp256k1_verify`` entry; returns the mask.  The inputs and
    the launch as in :func:`launch_ecmul2`."""
    named = (("qx", qx), ("qy", qy), ("z", z), ("r", r), ("s", s))
    batch = _check(named)
    dev = _on_card(named)
    ok = torch.empty(batch, dtype=torch.bool, device=dev)
    n = ok.numel()
    if n:
        gtab = ecrecover._comb_on(dev)
        _run("secp256k1_verify", dev, qx.data_ptr(), qy.data_ptr(), z.data_ptr(), r.data_ptr(),
             s.data_ptr(), gtab.data_ptr(), ok.data_ptr(), n)
    return ok


# The plain versions: the same functions in PyTorch ops, on any device,
# broadcasting as the JAX functions do.
ecmul2_plain = sec.ecmul2_base_plain
verify_plain = sec.ecdsa_verify_plain


def _route(wrapper, t: torch.Tensor) -> str:
    if t.device.type not in ("cuda", "cpu"):
        raise ValueError(f"{wrapper.__name__} runs on cuda or cpu, not {t.device}")
    return t.device.type


def ecmul2(
    k1: torch.Tensor, k2: torch.Tensor, qx: torch.Tensor, qy: torch.Tensor
) -> sec.JacobianPoint:
    """``k1*G + k2*Q``, the inputs broadcast first: the kernel on a CUDA
    tensor, the plain version on a CPU tensor.  No fallback between the
    two: a failed build or launch raises."""
    route = _route(ecmul2, qx)
    args = _broadcast((("k1", k1), ("k2", k2), ("qx", qx), ("qy", qy)), sec.ecmul2_batch)
    if route == "cpu":
        return ecmul2_plain(*args)
    out = launch_ecmul2(*args)
    if out.z.numel():  # an empty batch launches nothing
        _build.count_launch(ecmul2)
    return out


def verify(
    qx: torch.Tensor, qy: torch.Tensor, z: torch.Tensor, r: torch.Tensor, s: torch.Tensor
) -> torch.Tensor:
    """The verification mask, as :func:`ecmul2`."""
    route = _route(verify, qx)
    args = _broadcast((("qx", qx), ("qy", qy), ("z", z), ("r", r), ("s", s)), sec.verify_batch)
    if route == "cpu":
        return verify_plain(*args)
    ok = launch_verify(*args)
    if ok.numel():
        _build.count_launch(verify)
    return ok


ecmul2.launches = 0
verify.launches = 0
