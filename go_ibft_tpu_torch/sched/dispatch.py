"""The multi-tenant coalesced verify data plane (the port of the JAX
package's ``sched/dispatch.py``).

One flush of the :class:`~go_ibft_tpu_torch.sched.scheduler.TenantScheduler`
carries lanes from MANY chains — different validator sets, different
proposal hashes, different heights — and must still land on the card as
ONE batched dispatch.  The trick that makes cross-tenant coalescing exact
is splitting the verification predicate at the membership check:

* **signature validity is chain-agnostic** — ``recover(digest, sig) ==
  claimed address`` does not mention a validator set, so lanes from any
  number of chains share one launch of the recovery kernel;
* **membership is a host dict lookup** — ``claimed in
  tenant.validators(height)`` is exact Python over the tenant's own
  voting-power map, applied per lane after the shared mask returns.

The device route therefore launches the single-tenant plane's own kernels
(:data:`DIGEST_KERNEL` / :data:`RECOVER_KERNEL` are the very functions
:class:`~go_ibft_tpu_torch.verify.batch.DeviceBatchVerifier` calls, so the
shared plane can never fork a kernel of its own) with the membership table
packed from the lanes' own claimed addresses: every live lane's claimed
address is trivially a table member, which reduces the mask to pure
signature validity.  The per-tenant membership AND happens on the host, so
the final verdict per lane is bit-identical to that tenant's sequential
:class:`~go_ibft_tpu_torch.verify.batch.HostBatchVerifier` oracle.

The host route does the same split over the native bulk verifier (one
GIL-releasing C call for the whole coalesced flush) or, without the
native library, the pure-Python recover loop — the scheduler picks per
flush exactly like :class:`~go_ibft_tpu_torch.verify.batch.AdaptiveBatchVerifier`
picks per drain (measured cutover, small flushes stay on the host).

The device route runs on ``torch_device`` (``None``: the card, through
:func:`~go_ibft_tpu_torch.utils.device.resolve_device`).  A ``mesh`` /
``dp`` / ``devices`` that resolves to two devices or more makes it the
lane-sharded mesh route: the flush's lanes split over the mesh's devices
(:func:`~go_ibft_tpu_torch.verify.mesh_batch.mesh_verify_mask`, a launch of
each kernel per shard); one device keeps the single-device route.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..crypto import ecdsa as host_ecdsa
from ..crypto.keccak import keccak256_many
from ..messages.helpers import CommittedSeal
from ..messages.wire import IbftMessage
from ..obs import ledger as cost_ledger
from ..obs import trace
from ..ops import quorum
from ..ops import secp256k1 as sec
from ..parallel.mesh import mesh_context
from ..utils import metrics
from ..utils.device import DeviceLike, resolve_device
from ..verify import batch as vbatch
from ..verify.batch import (
    _BATCH_BUCKETS,
    ADDRESS_BYTES,
    SIG_BYTES,
    _as_signed,
    _bucket,
    _DigestLanes,
    launch_sender_digest_rows,
    pack_seal_lanes,
    pack_sender_lanes,
    pack_validator_table,
    upload_sender_lanes,
)
from ..verify.mesh_batch import mesh_verify_mask
from ..verify.pipeline import PackCache, SenderPack

__all__ = [
    "CoalescedDispatcher",
    "DIGEST_KERNEL",
    "RECOVER_KERNEL",
    "DISPATCH_LANES_KEY",
    "DISPATCH_MS_KEY",
]

# The shared dispatch MUST reuse the single-tenant plane's kernels: these
# are the same function objects DeviceBatchVerifier calls, not copies
# (tests/test_torch_sched.py asserts the identity).
DIGEST_KERNEL = quorum.digest_words
RECOVER_KERNEL = vbatch.DeviceBatchVerifier._mask

DISPATCH_LANES_KEY = ("go-ibft", "sched", "dispatch_lanes")
DISPATCH_MS_KEY = ("go-ibft", "sched", "dispatch_ms")


class _RoutingPackCache:
    """Store-side shim routing ``pack_sender_batch`` cache stores to each
    message's OWN tenant cache.

    A coalesced sender pack mixes messages from many tenants, but
    ``pack_sender_batch`` takes one ``cache`` to store fresh packs into.
    Lookups are supplied pre-routed (``cache_hits``); this shim routes the
    stores by message identity so one tenant's packs can never land in —
    or later be served from — another tenant's cache (the namespacing
    contract of docs/TENANCY.md)."""

    def __init__(self, owners: Dict[int, PackCache]):
        self._owners = owners

    def store(self, msg, pack: SenderPack) -> None:
        owner = self._owners.get(id(msg))
        if owner is not None:
            owner.store(msg, pack)


def well_formed_sender(msg: IbftMessage) -> bool:
    """The oracle's sender-lane admission predicate
    (:meth:`HostBatchVerifier.verify_senders` skip conditions)."""
    return (
        msg.view is not None
        and len(msg.sender) == ADDRESS_BYTES
        and len(msg.signature) == SIG_BYTES
    )


def well_formed_seal_lane(proposal_hash: bytes, seal: CommittedSeal) -> bool:
    """The oracle's seal-lane admission predicate (hash + signer + sig)."""
    return (
        len(proposal_hash) == 32
        and len(seal.signer) == ADDRESS_BYTES
        and len(seal.signature) == SIG_BYTES
    )


class CoalescedDispatcher:
    """One shared pack/dispatch engine for mixed-tenant lane batches.

    :meth:`dispatch` takes pre-filtered (well-formed) sender messages and
    ``(proposal_hash, seal)`` lanes from any mix of tenants and returns
    one *signature-validity* mask per kind — ``recover(digest) ==
    claimed``; membership is the caller's (per-tenant, host-exact).

    ``route``:

    * ``"auto"`` — host below the measured adaptive cutover (the same
      calibration the :class:`AdaptiveBatchVerifier` uses: a handful of
      lanes never pays a device dispatch floor), device at or above it;
    * ``"host"`` / ``"device"`` — forced (bench variants, tests).

    ``torch_device`` is where the device route runs (``None``: the card;
    the tests pass ``"cpu"``, where each kernel takes its plain version).
    ``device`` is that device, or None on the ``"host"`` route: what
    :func:`~go_ibft_tpu_torch.verify.batch.on_card` reads.  ``routes``
    counts the flushes each route served.

    ``mesh`` / ``dp`` / ``devices``: a resolution of two devices or more
    (``mesh`` wins; else :func:`~go_ibft_tpu_torch.parallel.mesh.mesh_context`
    over ``devices``, default every visible card, clamped to ``dp``) makes
    the device route lane-sharded over the mesh, with ``device`` its first
    device; one device keeps the single-device route on ``torch_device``.
    The scheduler swaps whole dispatchers
    (:meth:`TenantScheduler.reconfigure`), so this state is immutable.
    """

    def __init__(
        self,
        route: str = "auto",
        cutover_lanes: Optional[int] = None,
        *,
        mesh=None,
        dp: Optional[int] = None,
        devices=None,
        torch_device: DeviceLike = None,
    ):
        if route not in ("auto", "host", "device"):
            raise ValueError(f"unknown route {route!r}")
        self.route = route
        if cutover_lanes is None:
            from ..utils import calibration

            cutover_lanes = (
                calibration.measured_cutover()
                or calibration.DEFAULT_CUTOVER_LANES
            )
        self.cutover = cutover_lanes
        self.mesh = None
        self.dp = 1
        self._mask_kernel = None
        if mesh is None and (dp is not None or devices is not None):
            mesh = mesh_context(dp, devices=devices)
        if mesh is not None and np.asarray(mesh.devices).size >= 2:
            self.mesh = mesh
            self.dp = mesh.size
            self._mask_kernel = mesh_verify_mask(mesh)
        if route == "host":
            self.device = None
        elif self.mesh is not None:
            self.device = self.mesh.flat()[0]
        else:
            self.device = resolve_device(torch_device)
        self.routes = {"host": 0, "device": 0}
        self._routes_lock = threading.Lock()
        # The kernels build once per process; serialize warmup.
        self._warm_lock = threading.Lock()

    def describe(self) -> dict:
        """Shape of this dispatcher (scheduler stats / resize evidence)."""
        return {
            "route": self.route,
            "dp": self.dp,
            "sharded": self.mesh is not None,
            "cutover": self.cutover,
            "device": None if self.device is None else str(self.device),
        }

    def _pad_lanes(self, n: int) -> int:
        """Mesh dispatches pin the lane count to ``bucket(ceil(n/dp)) x dp``
        (every shard the same local shape; pad lanes are dead);
        single-device dispatches keep the packers' own bucketing (0)."""
        if self.mesh is None or n == 0:
            return 0
        return _bucket((n + self.dp - 1) // self.dp, _BATCH_BUCKETS) * self.dp

    # -- public ----------------------------------------------------------

    def warmup(self, lanes: Sequence[int] = (8,), table_rows: int = 8) -> None:
        """Build the shared kernels and launch each once per lane bucket
        (node startup; never mid-round), on every shard's device on the
        mesh route.  On the CPU or the host route there is nothing to
        build, and nothing runs."""
        if self.device is None or self.device.type != "cuda":
            return
        from .. import _build

        if self.mesh is not None:
            with self._warm_lock:
                _build.build_all()
                nl = sec.FIELD.nlimbs
                tables = self._mask_kernel.tables(np.zeros((table_rows, 5), np.uint32))
                for bb in lanes:
                    g = self._pad_lanes(bb)
                    with cost_ledger.dispatch_span(
                        "mesh_verify_mask", route="warmup", padded=g, site="sched/dispatch.py:warmup",
                    ):
                        self._mask_kernel(
                            _DigestLanes(
                                np.zeros((g, 8), np.uint32), np.zeros((g, nl), np.int32),
                                np.zeros((g, nl), np.int32), np.zeros((g,), np.int32),
                                np.zeros((g, 5), np.uint32), np.zeros((g,), bool),
                            ),
                            tables,
                        )
            return
        with self._warm_lock:
            _build.build_all()
            dev = self.device
            nl = sec.FIELD.nlimbs
            table = torch.zeros((table_rows, 5), dtype=torch.int32, device=dev)
            for bb in lanes:
                with cost_ledger.dispatch_span(
                    "ecdsa_recover", route="warmup", padded=bb,
                    site="sched/dispatch.py:warmup",
                ):
                    dead = (
                        torch.zeros((bb, 8), dtype=torch.int32, device=dev),
                        torch.zeros((bb, nl), dtype=torch.int32, device=dev),
                        torch.zeros((bb, nl), dtype=torch.int32, device=dev),
                        torch.zeros((bb,), dtype=torch.int32, device=dev),
                        torch.zeros((bb, 5), dtype=torch.int32, device=dev),
                        torch.zeros((bb,), dtype=torch.bool, device=dev),
                    )
                    RECOVER_KERNEL(dead, table).cpu()
                with cost_ledger.dispatch_span(
                    "digest_words", route="warmup", padded=bb,
                    site="sched/dispatch.py:warmup",
                ):
                    DIGEST_KERNEL(
                        torch.zeros((bb, 2, 17, 2), dtype=torch.int32, device=dev),
                        torch.ones((bb,), dtype=torch.int32, device=dev),
                    ).cpu()

    def dispatch(
        self,
        sender_msgs: Sequence[IbftMessage],
        seal_lanes: Sequence[Tuple[bytes, CommittedSeal]],
        pack_caches: Optional[Dict[int, PackCache]] = None,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Coalesced signature-validity masks for one flush.

        ``pack_caches`` maps ``id(msg)`` to the owning tenant's
        :class:`PackCache` (lookups AND stores are routed per message).
        Returns ``(sender_sig_ok, seal_sig_ok)``; membership is NOT
        included — the scheduler ANDs each lane with its own tenant's
        validator set.
        """
        total = len(sender_msgs) + len(seal_lanes)
        route = self.route
        if route == "auto":
            route = "device" if total >= self.cutover else "host"
        with self._routes_lock:
            self.routes[route] += 1
        import time as _time

        t0 = _time.perf_counter()
        with trace.span(
            "sched.dispatch",
            route=route,
            lanes=total,
            senders=len(sender_msgs),
            seals=len(seal_lanes),
        ):
            if route == "device":
                out = self._device(sender_msgs, seal_lanes, pack_caches or {})
            else:
                # Host flushes pad nothing (occupancy 1.0); the device
                # route records per kernel launch inside _device where
                # the padded bucket shapes are known.
                with cost_ledger.dispatch_span(
                    "ecdsa_recover",
                    route="host",
                    live=total,
                    padded=total,
                    site="sched/dispatch.py:dispatch",
                ):
                    out = self._host(
                        sender_msgs, seal_lanes, pack_caches or {}
                    )
        metrics.observe(DISPATCH_MS_KEY, (_time.perf_counter() - t0) * 1e3)
        metrics.observe(DISPATCH_LANES_KEY, float(total))
        return out

    # -- device route ----------------------------------------------------

    def _upload(self, _name: str, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(_as_signed(a)).to(self.device)

    def _device(self, msgs, lanes, owners) -> Tuple[np.ndarray, np.ndarray]:
        sender_ok = np.zeros(len(msgs), dtype=bool)
        seal_ok = np.zeros(len(lanes), dtype=bool)
        if msgs:
            t0 = trace.now_us()
            # Lookups are pre-routed per tenant; stores route back through
            # the owners shim.  The digest sequence (the digest kernel,
            # oversize payloads digested on the host) is the single-tenant
            # plane's own function — shared, not forked, so a fix there
            # can never miss this route.
            packed = pack_sender_lanes(
                msgs,
                cache=_RoutingPackCache(owners),
                hits=[
                    (owners[id(m)].lookup(m) if id(m) in owners else None)
                    for m in msgs
                ],
                pad_lanes=self._pad_lanes(len(msgs)),
            )
            # Claimed-address table: every live lane's claimed sender is a
            # member by construction, so the kernel's (sig & member) mask
            # reduces to signature validity — tenant membership stays on
            # the host where each chain's own set applies.
            table = pack_validator_table(
                list(dict.fromkeys(m.sender for m in msgs))
            )
            if self.mesh is not None:
                sender_ok = self._mesh_sig_mask(packed, table)[: len(msgs)]
            else:
                # Every field goes up before the digest launch, so that
                # ``sched.pack`` ends where the card's work begins.
                up = upload_sender_lanes(packed, self._upload)
                table = self._upload("table", table)
                if t0 is not None:
                    t0 = trace.complete("sched.pack", t0, senders=len(msgs), seals=0)
                inputs = launch_sender_digest_rows(packed, up)
                sender_ok = self._sig_mask(inputs, table)[: len(msgs)]
                if t0 is not None:
                    trace.complete("sched.card", t0, lanes=len(msgs), padded=len(packed.live))
        if lanes:
            t0 = trace.now_us()
            packed = pack_seal_lanes(list(lanes), pad_lanes=self._pad_lanes(len(lanes)))
            table = pack_validator_table(
                list(dict.fromkeys(seal.signer for _h, seal in lanes))
            )
            if self.mesh is not None:
                seal_ok = self._mesh_sig_mask(_DigestLanes(*packed), table)[: len(lanes)]
            else:
                inputs = tuple(
                    self._upload(name, a)
                    for name, a in zip(("zw", "r", "s", "v", "claimed", "live"), packed)
                )
                table = self._upload("table", table)
                if t0 is not None:
                    t0 = trace.complete("sched.pack", t0, senders=0, seals=len(lanes))
                seal_ok = self._sig_mask(inputs, table)[: len(lanes)]
                if t0 is not None:
                    trace.complete("sched.card", t0, lanes=len(lanes), padded=len(packed[-1]))
        return sender_ok, seal_ok

    def _sig_mask(self, inputs, table: torch.Tensor) -> np.ndarray:
        """One signature-validity launch of the recovery kernel and one of
        ``certify_lanes`` (the membership, no phase) over uploaded lanes
        and table, and the mask read back."""
        with cost_ledger.dispatch_span(
            "ecdsa_recover",
            route="device",
            live_mask=inputs[-1].cpu().numpy() if cost_ledger.enabled() else None,
            site="sched/dispatch.py:_device",
        ):
            mask = RECOVER_KERNEL(inputs, table)
            return mask.cpu().numpy()

    def _mesh_sig_mask(self, lanes, table: np.ndarray) -> np.ndarray:
        """The mesh route's signature-validity mask over a packed host chunk
        (a multiple of ``dp`` lanes): each shard's digest (envelopes) and
        recovery launches on its own device, the same kernels as
        :data:`DIGEST_KERNEL` / :data:`RECOVER_KERNEL`."""
        with cost_ledger.dispatch_span(
            "mesh_verify_mask",
            route="mesh",
            live_mask=lanes.live,
            site="sched/dispatch.py:_device",
        ):
            return self._mask_kernel(lanes, self._mask_kernel.tables(table))

    # -- host route ------------------------------------------------------

    def _host(self, msgs, lanes, owners) -> Tuple[np.ndarray, np.ndarray]:
        digests: List[bytes] = []
        sigs: List[bytes] = []
        claimed: List[bytes] = []
        if msgs:
            payloads = []
            for m in msgs:
                owner = owners.get(id(m))
                hit = owner.lookup(m) if owner is not None else None
                payloads.append(
                    hit.payload
                    if hit is not None
                    else m.encode(include_signature=False)
                )
            digests.extend(keccak256_many(payloads))
            sigs.extend(m.signature for m in msgs)
            claimed.extend(m.sender for m in msgs)
        for proposal_hash, seal in lanes:
            digests.append(proposal_hash)
            sigs.append(seal.signature)
            claimed.append(seal.signer)
        mask = self._host_sig_ok(digests, sigs, claimed)
        return mask[: len(msgs)], mask[len(msgs) :]

    @staticmethod
    def _host_sig_ok(
        digests: List[bytes], sigs: List[bytes], claimed: List[bytes]
    ) -> np.ndarray:
        if not digests:
            return np.zeros(0, dtype=bool)
        from .. import native

        if native.load() is not None:
            # One bulk GIL-releasing call; the claimed-set table makes the
            # native membership check vacuous (recovered == claimed[i]
            # implies membership), leaving exactly signature validity.
            return native.verify_batch_sequential(
                digests, sigs, claimed, list(dict.fromkeys(claimed))
            )
        out = np.zeros(len(digests), dtype=bool)
        for i, (digest, sig, addr) in enumerate(zip(digests, sigs, claimed)):
            r = int.from_bytes(sig[:32], "big")
            s = int.from_bytes(sig[32:64], "big")
            pub = host_ecdsa.recover(digest, r, s, sig[64])
            out[i] = (
                pub is not None and host_ecdsa.pubkey_to_address(*pub) == addr
            )
        return out
