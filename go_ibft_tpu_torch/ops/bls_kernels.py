"""The BLS12-381 pairing kernels' launchers and wrappers.

``csrc/bls12_381.cu`` holds three kernels (design and bounds in its
header): ``bls_merge`` (the masked G1/G2 sums), ``bls_miller`` (a lane's
two Miller loops and their product) and ``bls_final_exp`` (the final
exponentiation, cubed, and the ``== 1`` check).  Each has

* a launcher (:func:`launch_merge`, :func:`launch_miller`,
  :func:`launch_final_exp`) that runs the kernel on CUDA tensors and
  raises on any fault, a CPU tensor included;
* a wrapper (:func:`merge`, :func:`miller`, :func:`final_exp`), which the
  port calls: the kernel for a CUDA tensor, counted in the wrapper's
  ``launches``, and the plain PyTorch version
  (:mod:`go_ibft_tpu_torch.ops.bls12_381`) for a CPU tensor.  No fallback
  between the two.

Tensors are the port's layout (:mod:`go_ibft_tpu_torch.ops.bls_fp`):
canonical field elements as ``(..., 12)`` int32 words, Montgomery form
with R = 2**384; the kernels take canonical values only.
"""

from __future__ import annotations

from typing import Tuple

import torch

from .. import _build
from . import bls12_381 as plain

__all__ = ["launch_merge", "launch_miller", "launch_final_exp", "merge", "miller", "final_exp"]

_W = 12  # words a field element


def _on_one_card(what: str, *ts: torch.Tensor) -> torch.device:
    dev = ts[0].device
    if dev.type != "cuda" or any(t.device != dev for t in ts):
        raise ValueError(f"{what} takes CUDA tensors on one card, got {[str(t.device) for t in ts]}")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError(f"{what} inputs must be contiguous")
    return dev


def _check_merge(points: torch.Tensor, live: torch.Tensor) -> None:
    if points.dtype != torch.int32 or points.dim() != 4 or points.shape[2] not in (2, 4) or points.shape[3] != _W:
        raise ValueError(f"merge points must be (G, V, 2 or 4, 12) int32, got {points.dtype} {tuple(points.shape)}")
    if live.dtype != torch.bool or tuple(live.shape) != tuple(points.shape[:2]):
        raise ValueError(f"merge live must be {tuple(points.shape[:2])} bool, got {live.dtype} {tuple(live.shape)}")


def _check_miller(q: torch.Tensor, p: torch.Tensor) -> None:
    if q.dtype != torch.int32 or q.dim() != 4 or q.shape[0] != 2 or tuple(q.shape[2:]) != (4, _W):
        raise ValueError(f"miller q must be (2, N, 4, 12) int32, got {q.dtype} {tuple(q.shape)}")
    if p.dtype != torch.int32 or tuple(p.shape) != (2, q.shape[1], 2, _W):
        raise ValueError(f"miller p must be (2, {q.shape[1]}, 2, 12) int32, got {p.dtype} {tuple(p.shape)}")


def _check_final_exp(f: torch.Tensor, gate: torch.Tensor) -> None:
    if f.dtype != torch.int32 or f.dim() != 3 or tuple(f.shape[1:]) != (12, _W):
        raise ValueError(f"final_exp f must be (N, 12, 12) int32, got {f.dtype} {tuple(f.shape)}")
    if gate.dtype != torch.bool or tuple(gate.shape) != (f.shape[0],):
        raise ValueError(f"final_exp gate must be ({f.shape[0]},) bool, got {gate.dtype} {tuple(gate.shape)}")


def _stream(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def _raise_on(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {rc}")


def launch_merge(points: torch.Tensor, live: torch.Tensor, neg_y: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """Run ``bls_merge``: ``(G, V, C, 12)`` points (C = 2: G1, 4: G2) and
    ``(G, V)`` live -> ``(G, C, 12)`` affine sums (y negated where
    ``neg_y``; zeros for infinity) and ``(G,)`` infinity flags."""
    _check_merge(points, live)
    dev = _on_one_card("bls_merge", points, live)
    g, v, c = points.shape[:3]
    out = torch.empty((g, c, _W), dtype=torch.int32, device=dev)
    inf = torch.empty((g,), dtype=torch.bool, device=dev)
    if g and v:
        lib = _build.load("bls12_381")
        _raise_on(lib.bls_merge(points.data_ptr(), live.data_ptr(), g, v, c, int(neg_y), out.data_ptr(),
                                inf.data_ptr(), _stream(dev)), "bls_merge")
    elif g:
        out.zero_()
        inf.fill_(True)
    return out, inf


def launch_miller(q: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Run ``bls_miller``: ``(2, N, 4, 12)`` G2 points and ``(2, N, 2, 12)``
    G1 points -> ``(N, 12, 12)``, each lane's two Miller values' product."""
    _check_miller(q, p)
    dev = _on_one_card("bls_miller", q, p)
    n = q.shape[1]
    out = torch.empty((n, 12, _W), dtype=torch.int32, device=dev)
    if n:
        lib = _build.load("bls12_381")
        _raise_on(lib.bls_miller(q.data_ptr(), p.data_ptr(), n, out.data_ptr(), _stream(dev)), "bls_miller")
    return out


def launch_final_exp(f: torch.Tensor, gate: torch.Tensor):
    """Run ``bls_final_exp``: ``(N, 12, 12)`` and ``(N,)`` gates -> ``(N,)``
    verdicts and the ``(N, 12, 12)`` results."""
    _check_final_exp(f, gate)
    dev = _on_one_card("bls_final_exp", f, gate)
    n = f.shape[0]
    ok = torch.empty((n,), dtype=torch.bool, device=dev)
    out = torch.empty((n, 12, _W), dtype=torch.int32, device=dev)
    if n:
        lib = _build.load("bls12_381")
        _raise_on(lib.bls_final_exp(f.data_ptr(), gate.data_ptr(), n, ok.data_ptr(), out.data_ptr(), _stream(dev)),
                  "bls_final_exp")
    return ok, out


def _route(what: str, t: torch.Tensor) -> bool:
    """True for the card, False for the CPU; raises for anything else."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"{what} runs on cuda or cpu, not {t.device}")


def merge(points: torch.Tensor, live: torch.Tensor, neg_y: bool = False):
    """The masked group sums: the kernel on a CUDA tensor, the plain version
    on a CPU tensor (see :func:`launch_merge`)."""
    if _route("merge", points):
        out = launch_merge(points, live, neg_y)
        if points.shape[0] and points.shape[1]:
            _build.count_launch(merge)
        return out
    _check_merge(points, live)
    return plain.merge_plain(points, live, neg_y)


def miller(q: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Each lane's two Miller loops and their product (see
    :func:`launch_miller`)."""
    if _route("miller", q):
        out = launch_miller(q, p)
        if q.shape[1]:
            _build.count_launch(miller)
        return out
    _check_miller(q, p)
    return plain.miller_plain(q, p)


def final_exp(f: torch.Tensor, gate: torch.Tensor):
    """``(ok, result)``: each lane's final exponentiation (cubed) is one and
    its gate is set (see :func:`launch_final_exp`)."""
    if _route("final_exp", f):
        out = launch_final_exp(f, gate)
        if f.shape[0]:
            _build.count_launch(final_exp)
        return out
    _check_final_exp(f, gate)
    return plain.final_exp_plain(f, gate)


merge.launches = 0
miller.launches = 0
final_exp.launches = 0
