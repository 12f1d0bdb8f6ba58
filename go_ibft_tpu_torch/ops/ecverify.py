"""``k1*G + k2*Q`` and ECDSA verification: the CUDA kernel's launchers and
their plain PyTorch versions.

The kernel, in ``csrc/secp256k1_recover.cu`` beside the recovery kernel
whose lane arithmetic it shares, replaces the JAX package's XLA programs
``go_ibft_tpu/ops/secp256k1.py::ecmul2_base`` (entry ``secp256k1_ecmul2``)
and ``::ecdsa_verify`` (entry ``secp256k1_verify``): two warps per block of
32 lanes, one launch per batch.  It adds ``k1*G`` from the recovery's
fixed-base comb (:func:`~go_ibft_tpu_torch.ops.ecrecover.comb_table`,
uploaded once per card).

* :func:`launch_ecmul2` and :func:`launch_verify` run the kernel on CUDA
  tensors and raise on any fault;
* :func:`ecmul2_plain` and :func:`verify_plain` are the same functions in
  PyTorch ops on any device
  (:func:`~go_ibft_tpu_torch.ops.secp256k1.ecmul2_base_plain`,
  :func:`~go_ibft_tpu_torch.ops.secp256k1.ecdsa_verify_plain`);
* :func:`ecmul2` and :func:`verify` are the wrappers the port calls: the
  kernel for a CUDA tensor (counted in ``ecmul2.launches`` and
  ``verify.launches``), the plain version for a CPU tensor.

Inputs, per lane, all ``(..., 20)`` int32 13-bit limbs of one batch shape
(no broadcasting): ``k1``, ``k2`` below ``2N``; ``qx``, ``qy`` canonical
affine; ``z`` (taken mod N), ``r``, ``s`` as raw values, range-checked.
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


def _check(named: Sequence[Tuple[str, torch.Tensor]]) -> Tuple[int, ...]:
    """Every input int32 ``(..., 20)`` of one batch shape; returns it."""
    for name, t in named:
        if t.dtype != torch.int32:
            raise TypeError(f"input {name} must be int32, got {t.dtype}")
    shape = tuple(named[0][1].shape)
    if not shape or shape[-1] != _L or any(tuple(t.shape) != shape for _, t in named):
        raise ValueError(
            f"inputs must share one shape (..., {_L}), got "
            f"{ {name: tuple(t.shape) for name, t in named} }"
        )
    return shape[:-1]


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
        fn = _entries[entry] = getattr(_build.load("secp256k1_recover"), entry)
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


def ecmul2_plain(
    k1: torch.Tensor, k2: torch.Tensor, qx: torch.Tensor, qy: torch.Tensor
) -> sec.JacobianPoint:
    """The ``ecmul2`` entry's function in PyTorch ops, on any device."""
    _check((("k1", k1), ("k2", k2), ("qx", qx), ("qy", qy)))
    return sec.ecmul2_base_plain(k1, k2, qx, qy)


def verify_plain(
    qx: torch.Tensor, qy: torch.Tensor, z: torch.Tensor, r: torch.Tensor, s: torch.Tensor
) -> torch.Tensor:
    """The ``verify`` entry's function in PyTorch ops, on any device."""
    _check((("qx", qx), ("qy", qy), ("z", z), ("r", r), ("s", s)))
    return sec.ecdsa_verify_plain(qx, qy, z, r, s)


def ecmul2(
    k1: torch.Tensor, k2: torch.Tensor, qx: torch.Tensor, qy: torch.Tensor
) -> sec.JacobianPoint:
    """``k1*G + k2*Q``: the kernel on a CUDA tensor, the plain version on a
    CPU tensor.  No fallback between the two: a failed build or launch
    raises."""
    if qx.device.type == "cuda":
        out = launch_ecmul2(k1, k2, qx, qy)
        if out.z.numel():  # an empty batch launches nothing
            _build.count_launch(ecmul2)
        return out
    if qx.device.type == "cpu":
        return ecmul2_plain(k1, k2, qx, qy)
    raise ValueError(f"ecmul2 runs on cuda or cpu, not {qx.device}")


def verify(
    qx: torch.Tensor, qy: torch.Tensor, z: torch.Tensor, r: torch.Tensor, s: torch.Tensor
) -> torch.Tensor:
    """The verification mask: the kernel on a CUDA tensor, the plain
    version on a CPU tensor, as :func:`ecmul2`."""
    if qx.device.type == "cuda":
        ok = launch_verify(qx, qy, z, r, s)
        if ok.numel():
            _build.count_launch(verify)
        return ok
    if qx.device.type == "cpu":
        return verify_plain(qx, qy, z, r, s)
    raise ValueError(f"verify runs on cuda or cpu, not {qx.device}")


ecmul2.launches = 0
verify.launches = 0
