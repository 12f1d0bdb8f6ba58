"""Sharded fused quorum certification over a device mesh, as per-device
lane shards in one process (the port of the JAX package's
``parallel/mesh.py``).

The JAX package runs one ``shard_map`` program over a ``(dp, vp)`` mesh:
each device verifies its slice of the message lanes (``dp``) against its
slice of the validator table (``vp``), and three ``psum``s assemble the
answer.  Here the same work is laid out by hand, in one process (the JAX
package is single-controller too; no ``torch.distributed``):

* lane shard ``i`` runs the single-device per-lane work of
  :mod:`go_ibft_tpu_torch.ops.quorum` on device ``(i, 0)`` -- the digest
  (envelopes) and the recovery, each one kernel launch on the card, their
  plain versions on the CPU;
* the ``psum`` s become one launch of the ``certify_lanes`` kernel
  (:mod:`go_ibft_tpu_torch.ops.certify_lanes`) on the first device, over
  every shard's recovered addresses and the whole table: a sender is a
  member if any row of any table shard is its address (the OR over
  ``vp``), a validator is counted once if any lane shard carried its valid
  message (the OR over ``dp``), every equal row counts, also across table
  shards, and the 16/15-bit power halves are summed with the carry fold of
  :func:`~go_ibft_tpu_torch.ops.quorum.power_reduce`.  The count needs
  every valid lane against every row in one place anyway, so that launch
  also gives the mask; a launch a shard would repeat its work.  On the CPU
  it is the kernel's plain version.

Every shard's kernels are launched before any result is read, so the
devices overlap; nothing on the card runs an eager compare, ``any``,
``where`` or sum.  The results are bit-identical to the JAX package's
``mesh_quorum_certify`` / ``mesh_seal_quorum_certify`` and to
:func:`~go_ibft_tpu_torch.ops.quorum.quorum_certify` /
:func:`~go_ibft_tpu_torch.ops.quorum.seal_quorum_certify` on one device,
for voting powers < 2**31 (the split-halves exactness bound).

A :class:`Mesh` may name one device several times: each entry is one
shard.  That is how the CPU tests (``[torch.device("cpu")] * k``) and a
one-card run (``[cuda:0] * 4``) drive the sharded code, as the JAX tests
do with virtual CPU devices.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch

from ..ops import certify_lanes, quorum
from ..utils.device import resolve_device

__all__ = [
    "Mesh",
    "make_mesh",
    "mesh_context",
    "mesh_quorum_certify",
    "mesh_seal_quorum_certify",
    "visible_devices",
]


class Mesh:
    """A device mesh: an object array of :class:`torch.device` s and its
    axis names, as the JAX ``Mesh`` holds them (``devices``,
    ``axis_names``, ``shape[name]``).  Hashable and comparable by value, so
    callers can key caches on it."""

    def __init__(self, devices, axis_names: Tuple[str, ...]):
        arr = np.asarray(devices, dtype=object).copy()
        for idx in np.ndindex(arr.shape):
            dev = torch.device(arr[idx])
            if dev.type == "cuda" and dev.index is None:
                dev = torch.device("cuda", torch.cuda.current_device())
            arr[idx] = dev
        if arr.ndim != len(axis_names):
            raise ValueError(f"{arr.ndim}-d devices for axes {axis_names}")
        self.devices = arr
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, arr.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def flat(self) -> list:
        """The devices in row-major order (one entry a shard)."""
        return list(self.devices.flat)

    def _key(self):
        return (tuple(str(d) for d in self.devices.flat), self.devices.shape, self.axis_names)

    def __eq__(self, other) -> bool:
        return isinstance(other, Mesh) and self._key() == other._key()

    def __hash__(self) -> int:
        return hash(self._key())

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, {[str(d) for d in self.devices.flat]})"


def visible_devices() -> list:
    """Every visible CUDA device (none without a card: the port never puts
    CPU devices in the card's place)."""
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_mesh(n_devices: Optional[int] = None, *, vp: int = 1, devices=None) -> Mesh:
    """A ``(dp, vp)`` mesh over ``n_devices`` devices.

    ``vp`` shards the validator table; the rest of the devices go to ``dp``
    (message lanes).  ``devices=None`` takes every visible CUDA device and
    raises without one.  Unlike the JAX package, which falls back to the
    host CPU devices when the platform has too few, the port never puts
    CPU devices in the card's place: that would hide which device ran.  A
    caller that wants the CPU passes ``devices=[torch.device("cpu")] * k``.
    """
    if devices is None:
        resolve_device(None)  # raises without a card
        devices = visible_devices()
    devices = list(devices)
    if n_devices is not None:
        if len(devices) < n_devices:
            raise ValueError(f"need {n_devices} devices, have {len(devices)}")
        devices = devices[:n_devices]
    n = len(devices)
    if vp < 1 or n % vp:
        raise ValueError(f"{n} devices not divisible by vp={vp}")
    return Mesh(np.asarray(devices, dtype=object).reshape(n // vp, vp), ("dp", "vp"))


def mesh_context(dp: Optional[int] = None, *, vp: int = 1, devices=None) -> Optional[Mesh]:
    """Best-effort ``(dp, vp)`` mesh over the devices given, or every
    visible CUDA device.

    The one mesh-construction path of
    :class:`~go_ibft_tpu_torch.verify.mesh_batch.MeshBatchVerifier`, the
    coalesced dispatcher and the tests.  ``dp=None`` takes every device
    (after reserving ``vp``); an explicit ``dp`` is clamped to what exists.
    Returns ``None`` when no layout with more than one device exists —
    callers then keep their single-device path.  Unlike the JAX package,
    too few cards never brings in CPU devices (see :func:`make_mesh`).
    """
    if devices is None:
        devices = visible_devices()
    devices = list(devices)
    want = None if dp is None else dp * vp
    n = len(devices) if want is None else min(want, len(devices))
    n -= n % max(vp, 1)
    if n // max(vp, 1) < 2:
        return None
    return make_mesh(n, vp=vp, devices=devices[:n])


def _split(t: torch.Tensor, k: int, what: str) -> list:
    if t.shape[0] % k:
        raise ValueError(f"{what}: {t.shape[0]} rows do not split into {k} shards")
    return list(torch.chunk(t, k, dim=0)) if k > 1 else [t]


def _certify(mesh: Mesh, zw_of: Callable, lane_args, claimed, table_w, live, powers_lo, powers_hi,
             thr_lo, thr_hi):
    """Shared body of the two sharded certify programs: on each lane shard's
    device ``zw_of(*lane shard args but r, s, v)`` (the digest, or the
    proposal hash as it is) and the recovery; then ``certify_lanes`` on the
    first device over the gathered lanes (see the module docstring)."""
    dp, vp = mesh.devices.shape
    first = mesh.devices[0, 0]
    for t, k, what in ((claimed, dp, "lanes"), (live, dp, "lanes"), (table_w, vp, "table"),
                       (powers_lo, vp, "powers_lo"), (powers_hi, vp, "powers_hi")):
        _split(t, k, what)  # the JAX program's shard shapes, checked
    shards = [_split(a, dp, "lanes") for a in lane_args]
    # Launch every lane shard's kernels first; read nothing until all are queued.
    recovered = []
    for i in range(dp):
        dev = mesh.devices[i, 0]
        *zw_args, r, s, v = (a[i].to(dev) for a in shards)
        recovered.append(quorum._recover_address(zw_of(*zw_args), r, s, v))
    addr, ok = ([part[k].to(first) for part in recovered] for k in (0, 1))
    addr, ok = (parts[0] if dp == 1 else torch.cat(parts) for parts in (addr, ok))
    thr = tuple(t.to(first) if torch.is_tensor(t) else t for t in (thr_lo, thr_hi))
    mask, reached, lo, hi = certify_lanes.certify(
        addr, ok, claimed.to(first), live.to(first), table_w.to(first), powers_lo.to(first),
        powers_hi.to(first), [thr],
    )
    return mask, reached[0], lo[0], hi[0]


def mesh_quorum_certify(mesh: Mesh):
    """Sharded :func:`~go_ibft_tpu_torch.ops.quorum.quorum_certify` (same
    arguments and outputs, bit-identical results; the outputs on the
    mesh's first device).  On the card: a digest and a recovery launch a
    lane shard, then one ``certify_lanes`` launch."""

    def step(blocks, nblocks, r, s, v, sender_w, table_w, live, powers_lo, powers_hi, thr_lo, thr_hi):
        return _certify(mesh, quorum.digest_words, (blocks, nblocks, r, s, v), sender_w, table_w, live,
                        powers_lo, powers_hi, thr_lo, thr_hi)

    return step


def mesh_seal_quorum_certify(mesh: Mesh):
    """Sharded :func:`~go_ibft_tpu_torch.ops.quorum.seal_quorum_certify`."""

    def step(hash_zw, r, s, v, signer_w, table_w, live, powers_lo, powers_hi, thr_lo, thr_hi):
        return _certify(mesh, lambda zw: zw, (hash_zw, r, s, v), signer_w, table_w, live,
                        powers_lo, powers_hi, thr_lo, thr_hi)

    return step

