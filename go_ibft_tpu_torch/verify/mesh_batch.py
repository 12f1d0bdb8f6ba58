"""MeshBatchVerifier: the verify data plane split across a device mesh (the
port of the JAX package's ``verify/mesh_batch.py``).

:class:`MeshBatchVerifier` is a
:class:`~go_ibft_tpu_torch.verify.batch.DeviceBatchVerifier` whose
dispatches place packed lanes across the devices of a
:class:`~go_ibft_tpu_torch.parallel.mesh.Mesh`, in one process:

* **lane-parallel shards** — the lane axis splits evenly over the mesh's
  devices (every entry of the mesh, row-major; the table is copied to each
  device); each shard runs the UNCHANGED single-device work on its own
  device — one launch of the digest kernel for an envelope chunk and one
  of the recovery kernel, then the membership compare — so a drain makes
  one recovery launch per shard.  Every shard's inputs are uploaded, then
  every shard's kernels launched, and only then is any result read, so
  the devices overlap;
* **masked dummy-lane padding** — lane counts pad to ``bucket x dp`` so
  every shard has the same local shape; pad lanes are dead (``live``
  False) end to end, and their verdicts are sliced off before any caller
  sees them;
* **coalesced multi-drain dispatch** — the chunk capacity rises to
  ``largest bucket x dp``, so a multi-height sync range that would cost
  several single-device dispatches is one sharded dispatch, still riding
  the double-buffered :class:`~go_ibft_tpu_torch.verify.pipeline.VerifyPipeline`;
* **host-side quorum reduce** — the certify entry points compute the
  voting-power quorum from the sharded mask on exact host ints
  (:func:`~go_ibft_tpu_torch.verify.batch.host_quorum_reached`), exact for
  any power range;
* **one-device degradation** — when
  :func:`~go_ibft_tpu_torch.parallel.mesh.mesh_context` finds fewer than
  two devices the instance behaves exactly as its ``DeviceBatchVerifier``
  base.

On the card nothing falls back: a fault of any shard's kernels propagates.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..messages.helpers import CommittedSeal
from ..messages.wire import IbftMessage
from ..obs import ledger as cost_ledger
from ..obs import trace
from ..ops import quorum
from ..parallel.mesh import Mesh, mesh_context
from ..utils import metrics
from .batch import (
    _BATCH_BUCKETS,
    DeviceBatchVerifier,
    ValidatorSource,
    _as_signed,
    _bucket,
    _DigestLanes,
    _SenderLanes,
    host_quorum_reached,
    pack_sender_digest_rows,
)

__all__ = ["MeshBatchVerifier", "ShardedMask", "mesh_verify_mask", "REDUCE_MS_KEY"]

# Host-side quorum-reduce cost per sharded certify (the "reduce" leg).
REDUCE_MS_KEY = ("go-ibft", "mesh", "reduce_ms")

_DIGEST_FIELDS = ("zw", "r", "s", "v", "claimed", "live")
_SENDER_FIELDS = ("blocks", "counts", "r", "s", "v", "claimed", "live")


def _shard(lanes, lo: int, hi: int):
    """Lanes ``lo:hi`` of a packed host chunk, of the same kind."""
    if isinstance(lanes, _SenderLanes):
        rows = [(j, b - lo) for j, b in enumerate(lanes.big) if lo <= b < hi]
        return _SenderLanes(
            *(getattr(lanes, f)[lo:hi] for f in _SENDER_FIELDS),
            [b for _, b in rows],
            lanes.big_zw[[j for j, _ in rows]] if rows else None,
        )
    return _DigestLanes(*(getattr(lanes, f)[lo:hi] for f in _DIGEST_FIELDS))


def _fields(lanes) -> Dict[str, np.ndarray]:
    if isinstance(lanes, _SenderLanes):
        out = {f: getattr(lanes, f) for f in _SENDER_FIELDS}
        if lanes.big:
            out["big_zw"] = lanes.big_zw
        return out
    return {f: getattr(lanes, f) for f in _DIGEST_FIELDS}


class ShardedMask:
    """The lane-sharded verification mask over one mesh: signature validity
    AND membership in the table, per lane, the function
    :meth:`DeviceBatchVerifier._mask` computes on one device; each shard
    still computes it with eager ops after its recovery launch (not the
    ``certify_lanes`` kernel).

    :meth:`dispatch` takes a packed host chunk (:class:`_SenderLanes` or
    :class:`_DigestLanes`, numpy, a multiple of ``dp`` lanes) and the
    table on each shard's device (:meth:`tables`), and returns a handle
    without waiting for any device; :meth:`readback` waits and returns the
    ``(n,)`` bool mask.
    """

    def __init__(self, mesh: Mesh):
        self.mesh = mesh
        self.devices = mesh.flat()
        self.dp = len(self.devices)

    def tables(self, table: np.ndarray) -> Tuple[torch.Tensor, ...]:
        """``table`` copied once to each distinct device, one entry a shard."""
        host = torch.from_numpy(_as_signed(table))
        per_dev: Dict[torch.device, torch.Tensor] = {}
        for dev in self.devices:
            if dev not in per_dev:
                per_dev[dev] = host.to(dev)
        return tuple(per_dev[dev] for dev in self.devices)

    def dispatch(self, lanes, tables: Sequence[torch.Tensor]):
        n = int(lanes.live.shape[0])
        if n % self.dp:
            raise ValueError(f"{n} lanes do not split into {self.dp} shards")
        step = n // self.dp
        shards = [_shard(lanes, i * step, (i + 1) * step) for i in range(self.dp)]
        # 1. Every shard's inputs to its device (a blocking copy waits for
        #    the device's stream, so none is made once kernels are queued).
        ups = [
            {name: torch.from_numpy(_as_signed(a)).to(dev) for name, a in _fields(sh).items()}
            for sh, dev in zip(shards, self.devices)
        ]
        # 2. Every shard's kernels: the digest (envelopes), the recovery and
        #    the membership compare.
        oks = []
        for sh, up, table in zip(shards, ups, tables):
            if isinstance(sh, _SenderLanes):
                inputs = pack_sender_digest_rows(sh, lambda name, a, up=up: up[name])
            else:
                inputs = tuple(up[f] for f in _DIGEST_FIELDS)
            zw, r, s, v, claimed, live = inputs
            member = torch.any(quorum.membership_eq(claimed, table), dim=-1)
            oks.append(quorum.sig_checks_zw(zw, r, s, v, claimed, live) & member)
        # 3. The copies back, each ordered after its shard's kernels.
        handle = []
        for ok, dev in zip(oks, self.devices):
            if dev.type == "cuda":
                host = torch.empty(ok.shape, dtype=ok.dtype, pin_memory=True)
                host.copy_(ok, non_blocking=True)
                done = torch.cuda.Event()
                done.record(torch.cuda.current_stream(dev))
                handle.append((host, done))
            else:
                handle.append((ok, None))
        return handle

    @staticmethod
    def readback(handle) -> np.ndarray:
        for _, done in handle:
            if done is not None:
                done.synchronize()
        return np.concatenate([ok.numpy() for ok, _ in handle]).astype(bool)

    def __call__(self, lanes, tables) -> np.ndarray:
        return self.readback(self.dispatch(lanes, tables))


def mesh_verify_mask(mesh: Mesh) -> ShardedMask:
    """The lane-sharded verification mask over ``mesh`` (the JAX package's
    ``shard_map`` program of the same name; here there is nothing to
    compile, so nothing is cached)."""
    return ShardedMask(mesh)


class MeshBatchVerifier(DeviceBatchVerifier):
    """Lane-parallel sharded drains over a device mesh.

    Drop-in wherever a :class:`DeviceBatchVerifier` goes: the
    ``BatchVerifier`` entry points inherit the parent's chunking and
    pipeline, and only the dispatch seam changes; the fused certify entry
    points compute their quorum on host ints from the sharded mask.

    ``mesh`` wins when given; otherwise :func:`mesh_context` builds one
    from ``dp`` / ``devices`` (default: every visible card).  With fewer
    than two devices the instance IS a ``DeviceBatchVerifier`` in behaviour
    (``self.mesh`` is ``None``, ``sharded`` False) on ``device`` (default:
    the single device given, else the card).
    """

    def __init__(
        self,
        validators_for_height: ValidatorSource,
        *,
        mesh: Optional[Mesh] = None,
        dp: Optional[int] = None,
        devices=None,
        cache_heights: int = 4,
        device=None,
    ):
        if mesh is None:
            mesh = mesh_context(dp, devices=devices)
        if mesh is not None and mesh.size < 2:
            mesh = None
        if device is None:
            if mesh is not None:
                device = mesh.flat()[0]
            elif devices:
                device = list(devices)[0]
        super().__init__(validators_for_height, cache_heights=cache_heights, device=device)
        self.mesh = mesh
        self.dp = mesh.size if mesh is not None else 1
        if mesh is not None:
            self._mask_kernel = mesh_verify_mask(mesh)
            self._dispatch_cap = _BATCH_BUCKETS[-1] * self.dp
            self._route = "mesh"

    @property
    def sharded(self) -> bool:
        return self.mesh is not None

    # -- pad/placement seams --------------------------------------------

    def _pad_lanes(self, n: int) -> int:
        """Smallest ``bucket x dp`` lane count holding ``n`` lanes: each
        shard's shape is the bucket of ``ceil(n / dp)``."""
        if self.mesh is None or n == 0:
            return 0
        return _bucket((n + self.dp - 1) // self.dp, _BATCH_BUCKETS) * self.dp

    def _table_dev(self, height: int):
        """The validator table on every shard's device (copied once per
        height, like the parent's single-device copy, in the same cache)."""
        if self.mesh is None:
            return super()._table_dev(height)
        with self._cache_lock:
            hit = self._tables_dev.get(height)
            if hit is not None:
                return hit
            table = self._table_and_addrs(height)[0]
        up = self._mask_kernel.tables(table)
        with self._cache_lock:
            hit = self._tables_dev.setdefault(height, up)
            self._bounded(self._tables_dev)
        return hit

    # -- dispatch -------------------------------------------------------

    def _program_of(self, quorum_args) -> str:
        if self.mesh is not None and quorum_args is None:
            return "mesh_verify_mask"
        return super()._program_of(quorum_args)

    def _dispatch_async(self, lanes, table, quorum_args):
        """Queue one sharded mask dispatch (mask only: the certify
        overrides below reduce the quorum on the host)."""
        if self.mesh is None or quorum_args is not None:
            return super()._dispatch_async(lanes, table, quorum_args)
        n = int(lanes.live.shape[0])
        with cost_ledger.dispatch_span(
            "mesh_verify_mask",
            route=self._route,
            live_mask=lanes.live,
            block=False,
            site="verify/mesh_batch.py:_dispatch_async",
        ):
            with trace.span("verify.shard", devices=self.dp, lanes=n, lanes_per_device=n // self.dp):
                with trace.span("verify.dispatch", route="mesh"):
                    return ("mesh", self._mask_kernel.dispatch(lanes, table))

    def _readback(self, handle) -> Tuple[np.ndarray, Optional[bool]]:
        if handle[0] != "mesh":
            return super()._readback(handle)
        with trace.span("verify.device_wait", route="mesh"):
            return ShardedMask.readback(handle[1]), None

    def warmup(self, lanes: Sequence[int] = (8,), blocks: Sequence[int] = (2, 8), table_rows: int = 8) -> None:
        """Build the kernels and run one dead-lane sharded dispatch per
        ``(lanes, blocks)`` bucket on every shard's device (nothing runs on
        the CPU)."""
        if self.mesh is None:
            return super().warmup(lanes=lanes, blocks=blocks, table_rows=table_rows)
        if not any(d.type == "cuda" for d in self._mask_kernel.devices):
            return None
        from .. import _build
        from ..ops import secp256k1 as sec

        _build.build_all()
        tables = self._mask_kernel.tables(np.zeros((table_rows, 5), np.uint32))
        nl = sec.FIELD.nlimbs
        for bb in lanes:
            g = self._pad_lanes(bb)
            for nb in blocks:
                with cost_ledger.dispatch_span(
                    "mesh_verify_mask", route="warmup", padded=g, site="verify/mesh_batch.py:warmup"
                ):
                    dead = _SenderLanes(
                        np.zeros((g, nb, 17, 2), np.uint32), np.ones((g,), np.int32),
                        np.zeros((g, nl), np.int32), np.zeros((g, nl), np.int32),
                        np.zeros((g,), np.int32), np.zeros((g, 5), np.uint32),
                        np.zeros((g,), bool), [], None,
                    )
                    self._mask_kernel(dead, tables)
        return None

    # -- fused certify: sharded mask + host-int quorum reduce ------------

    def supports_fused(self, height: int) -> bool:
        """Always true on the sharded route: the quorum reduction runs on
        exact host ints, so there is no representability gate."""
        if self.mesh is None:
            return super().supports_fused(height)
        return True

    def _reduce(self, valid_addrs, height: int, threshold: Optional[int]) -> bool:
        t0 = time.perf_counter()
        with trace.span("verify.quorum", route="host-int", shard="reduce"):
            reached = host_quorum_reached(self._validators, valid_addrs, height, threshold)
        metrics.observe(REDUCE_MS_KEY, (time.perf_counter() - t0) * 1e3)
        return reached

    def certify_senders(
        self, msgs: Sequence[IbftMessage], height: int, threshold: Optional[int] = None
    ) -> Tuple[np.ndarray, bool]:
        if self.mesh is None:
            return super().certify_senders(msgs, height, threshold)
        out = np.zeros(len(msgs), dtype=bool)
        idxs = [i for i, m in enumerate(msgs) if self._well_formed_sender(m, height)]
        if not idxs:
            return out, self._reduce((), height, threshold)
        sub: List[IbftMessage] = [msgs[i] for i in idxs]
        mask = self.verify_senders(sub)
        out[np.asarray(idxs)] = mask[: len(idxs)]
        return out, self._reduce([m.sender for m, ok in zip(sub, mask) if ok], height, threshold)

    def certify_seals(
        self,
        proposal_hash: bytes,
        seals: Sequence[CommittedSeal],
        height: int,
        threshold: Optional[int] = None,
    ) -> Tuple[np.ndarray, bool]:
        if self.mesh is None:
            return super().certify_seals(proposal_hash, seals, height, threshold)
        mask = self.verify_committed_seals(proposal_hash, seals, height)
        return mask, self._reduce([s.signer for s, ok in zip(seals, mask) if ok], height, threshold)

    def certify_round(
        self,
        msgs: Sequence[IbftMessage],
        proposal_hash: bytes,
        seals: Sequence[CommittedSeal],
        height: int,
        prepare_threshold: Optional[int] = None,
    ) -> Tuple[np.ndarray, bool, np.ndarray, bool]:
        if self.mesh is None:
            return super().certify_round(msgs, proposal_hash, seals, height, prepare_threshold)
        # Both phases drain through ONE pipeline of sharded dispatches; each
        # phase's quorum reduces on host ints.
        sender_mask, seal_mask = self.verify_round_chunked(msgs, proposal_hash, seals, height)
        p_ok = self._reduce([m.sender for m, ok in zip(msgs, sender_mask) if ok], height, prepare_threshold)
        s_ok = self._reduce([s.signer for s, ok in zip(seals, seal_mask) if ok], height, None)
        return sender_mask, p_ok, seal_mask, s_ok
