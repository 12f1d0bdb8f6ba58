"""Device-resident BLS aggregation + batched multi-pairing verification
(the port of ``go_ibft_tpu/verify/aggregate.py``, without its mesh leg).

* **Merge trees** (:class:`G2MergeTree`, :func:`aggregate_signatures`,
  :func:`aggregate_pubkeys`): point aggregation through the merge kernel
  (:func:`go_ibft_tpu_torch.ops.bls12_381.g2_merge_tree` /
  ``g1_merge_tree``): one launch merges a whole committee, and the grouped
  form merges MANY disjoint groups per launch (the aggregation-tree pump's
  per-sweep combine).  The host loop
  (:func:`go_ibft_tpu_torch.crypto.bls.aggregate_signatures`) remains the
  bit-parity oracle and the small-input route.

* **Batched multi-pairing** (:func:`multi_aggregate_check`,
  :class:`MultiPairVerifier`): MANY aggregate equations
  ``e(G1, S_i) == e(sum(pk), H_i)`` verify together instead of one
  pairing per call.  Three routes, every verdict pinned to the per-lane
  :func:`~go_ibft_tpu_torch.verify.bls.aggregate_check` oracle:

  - ``device``: :func:`go_ibft_tpu_torch.ops.bls12_381.multi_pairing_check`
    — the pubkey merge, all 2N Miller loops and one final exponentiation
    per lane, three kernel launches on the card (their plain versions on
    a CPU ``torch_device``);
  - ``host``: the small-exponents batch test (Bellare-Garay-Rabin) on
    the pure-Python oracle tower — each lane's ratio
    ``miller(S_i, G1) * miller(H_i, -PK_i)`` is raised to a 64-bit
    exponent derived from verifier-private fresh randomness plus the
    whole lane set, the products combine, and ONE final exponentiation
    covers the whole batch.  A failing batch bisects down to per-lane
    oracle checks, so k bad lanes cost O(k log n) product equations and
    verdicts stay EXACT;
  - ``python``: the per-lane oracle loop.

  Batch-soundness note (host route): the exponents mix per-batch
  ``os.urandom`` with a hash of the ENTIRE lane set.  The device route
  checks every lane's equation individually and needs no randomization.

Degradation (:class:`MultiPairVerifier`): device -> host-batch -> per-lane
python, demoting on faults with the transition counted — off the card.  On
the card (the device rung's ``torch_device`` is CUDA) a kernel fault
propagates to the caller, as in :class:`G2MergeTree`: nothing is served
from the host in its place.  The JAX package's mesh rung (``route="mesh"``,
a dp-sharded multi-pairing) is not ported; it comes with the multi-device
slice.
"""

from __future__ import annotations

import threading
from typing import List, Sequence, Tuple

import numpy as np

from ..crypto import bls as hbls
from ..crypto.keccak import keccak256
from ..obs import ledger as cost_ledger
from ..obs import trace
from ..utils import metrics
from ..utils.device import DeviceLike, resolve_device
from .bls import PAIRING_EQS_KEY, aggregate_check, encode_seal

__all__ = [
    "G2MergeTree",
    "MultiPairVerifier",
    "aggregate_pubkeys",
    "aggregate_signatures",
    "multi_aggregate_check",
    "MERGE_DISPATCHES_KEY",
    "MERGE_POINTS_KEY",
    "MULTIPAIR_DISPATCHES_KEY",
    "MULTIPAIR_LANES_KEY",
]

# One count per batched merge dispatch / merged point (device route).
MERGE_DISPATCHES_KEY = ("go-ibft", "verify", "merge_dispatches")
MERGE_POINTS_KEY = ("go-ibft", "verify", "merge_points")
# One count per multi-pairing entry call + its lane total: the
# lanes-per-dispatch evidence obs/gates.py regression-gates (a batching
# regression shows up as dispatches growing against lanes).
MULTIPAIR_DISPATCHES_KEY = ("go-ibft", "verify", "multipair_dispatches")
MULTIPAIR_LANES_KEY = ("go-ibft", "verify", "multipair_lanes")

# Pad-to buckets: point-axis buckets for the merge trees (committee
# sizes), lane buckets for the multi-pairing kernel, group buckets for
# the batched pump combine.  Power-of-two ladders keep the compiled-shape
# set small across the mega-committee sweep (100 -> 128, 300 -> 512,
# 1000 -> 1024 validators; 8/64/256-lane multi-pairings).
MERGE_BUCKETS = (2, 8, 32, 128, 512, 1024)
MULTIPAIR_BUCKETS = (2, 8, 64, 256, 1024)
GROUP_BUCKETS = (1, 2, 4, 8, 16, 32, 64, 128, 256)

# Below this many points a device merge dispatch costs more than the host
# adds it replaces (a g2_add is ~0.5 ms host; a dispatch floor is ~1 ms).
DEVICE_MERGE_CUTOVER = 8

# Lane type shared with verify.bls.aggregate_check: (proposal_hash,
# seal points, pubkeys).  A lane verifies True iff the aggregate of its
# points passes the ONE-equation check against the aggregate of its
# pubkeys over H2(proposal_hash).
Lane = Tuple[bytes, Sequence["hbls.PointG2"], Sequence["hbls.PointG1"]]


def _bucket(n: int, ladder: Sequence[int]) -> int:
    """Smallest ladder bucket >= n; beyond the ladder, the next power of
    two (no silent truncation — a 2000-lane call pads to 2048, it never
    drops lanes)."""
    for b in ladder:
        if n <= b:
            return b
    b = ladder[-1]
    while b < n:
        b *= 2
    return b


# -- merge trees ------------------------------------------------------------


def aggregate_signatures(
    points: Sequence["hbls.PointG2"], *, device: bool = False, torch_device: DeviceLike = None
) -> "hbls.PointG2":
    """Drop-in for :func:`crypto.bls.aggregate_signatures` with a device
    merge-tree route (``device=True``, above the dispatch cutover)."""
    if not device or len(points) < DEVICE_MERGE_CUTOVER:
        return hbls.aggregate_signatures(points)
    return _merge_g2_groups_device([list(points)], resolve_device(torch_device))[0]


def aggregate_pubkeys(
    pks: Sequence["hbls.PointG1"], *, device: bool = False, torch_device: DeviceLike = None
) -> "hbls.PointG1":
    """Drop-in for :func:`crypto.bls.aggregate_pubkeys`, device-routable."""
    if not device or len(pks) < DEVICE_MERGE_CUTOVER:
        return hbls.aggregate_pubkeys(pks)
    return _merge_g1_groups_device([list(pks)], resolve_device(torch_device))[0]


def _pack_groups(groups: List[list], pack, ncoords: int):
    """Groups of host points -> ``(g, v, C, 12)`` words and a ``(g, v)``
    live mask, padded to the group and point buckets (None points dead)."""
    from ..ops import bls_fp

    g = _bucket(len(groups), GROUP_BUCKETS)
    v = _bucket(max((len(grp) for grp in groups), default=1), MERGE_BUCKETS)
    pts = np.zeros((g, v, ncoords, bls_fp.WORDS), dtype=np.int32)
    live = np.zeros((g, v), dtype=bool)
    for gi, grp in enumerate(groups):
        if grp:
            pts[gi, : len(grp)] = pack(list(grp))
            live[gi, : len(grp)] = [p is not None for p in grp]
    return pts, live


def _merge_g2_groups_device(groups: List[list], dev) -> list:
    """One merge-kernel launch over many disjoint G2 groups."""
    import torch

    from ..ops import bls12_381 as ops

    pts, live = _pack_groups(groups, ops.pack_g2_points, 4)
    metrics.inc_counter(MERGE_DISPATCHES_KEY)
    metrics.inc_counter(MERGE_POINTS_KEY, int(live.sum()))
    # Ledger occupancy over point SLOTS (g x v): merge padding wastes
    # both dead groups and dead points within a group.
    with cost_ledger.dispatch_span(
        "bls_g2_merge_tree",
        route="device",
        live_mask=live,
        site="verify/aggregate.py:_merge_g2_groups_device",
    ):
        out, inf = ops.g2_merge_tree(torch.from_numpy(pts).to(dev), torch.from_numpy(live).to(dev))
        return ops.unpack_g2_points(out.cpu(), inf.cpu())[: len(groups)]


def _merge_g1_groups_device(groups: List[list], dev) -> list:
    import torch

    from ..ops import bls12_381 as ops

    pts, live = _pack_groups(groups, ops.pack_g1_points, 2)
    metrics.inc_counter(MERGE_DISPATCHES_KEY)
    metrics.inc_counter(MERGE_POINTS_KEY, int(live.sum()))
    with cost_ledger.dispatch_span(
        "bls_g1_merge_tree",
        route="device",
        live_mask=live,
        site="verify/aggregate.py:_merge_g1_groups_device",
    ):
        out, inf = ops.g1_merge_tree(torch.from_numpy(pts).to(dev), torch.from_numpy(live).to(dev))
        return ops.unpack_g1_points(out.cpu(), inf.cpu())[: len(groups)]


class G2MergeTree:
    """Batched G2 aggregation.

    ``merge_groups`` merges MANY disjoint point sets in ONE merge-kernel
    launch (the aggregation-tree pump seam: every node's per-sweep slot
    merge becomes one combine per tree level instead of per-child Python
    adds).  Below ``cutover_points`` total points groups merge through the
    host oracle loop, bit-identically.  ``torch_device`` (``None``: the
    card) is where the device route runs.  On the card a kernel fault
    propagates; off it (a CPU ``torch_device``) a device fault demotes the
    tree to the host for good, as in the JAX package.
    """

    def __init__(
        self,
        *,
        device: bool = True,
        cutover_points: int = DEVICE_MERGE_CUTOVER,
        logger=None,
        torch_device: DeviceLike = None,
    ) -> None:
        self._device = device
        self.device = resolve_device(torch_device) if device else None
        self.cutover_points = cutover_points
        self._log = logger
        self._lock = threading.Lock()
        self.device_merges = 0
        self.host_merges = 0
        self.faults = 0

    @property
    def demoted(self) -> bool:
        return not self._device

    def merge(self, points: Sequence["hbls.PointG2"]) -> "hbls.PointG2":
        return self.merge_groups([list(points)])[0]

    def merge_groups(self, groups: Sequence[Sequence["hbls.PointG2"]]) -> list:
        """One merged point (or None for an empty/cancelled group) per
        group; device route when live and worth a launch."""
        groups = [list(g) for g in groups]
        total = sum(len(g) for g in groups)
        if not groups:
            return []
        with trace.span(
            "verify.merge", groups=len(groups), points=total
        ):
            if self._device and total >= self.cutover_points:
                try:
                    out = _merge_g2_groups_device(groups, self.device)
                    with self._lock:
                        self.device_merges += 1
                    return out
                except Exception as err:  # noqa: BLE001 - demote off the card
                    with self._lock:
                        self.faults += 1
                    if self.device.type == "cuda":
                        raise  # the card's fault: no host route hides it
                    with self._lock:
                        self._device = False
                    if self._log:
                        self._log.error(
                            "G2 merge tree demoted to host", err
                        )
                    trace.instant("verify.merge_demoted")
            with self._lock:
                self.host_merges += 1
            return [hbls.aggregate_signatures(g) for g in groups]

    def stats(self) -> dict:
        with self._lock:
            return {
                "device": self._device,
                "device_merges": self.device_merges,
                "host_merges": self.host_merges,
                "faults": self.faults,
            }


# -- batched multi-pairing --------------------------------------------------


def _lane_aggregates(lane: Lane):
    """(agg signature point, agg pubkey point) or None when the lane is
    vacuously False under the oracle semantics (no points / no pubkeys /
    cancelled-to-infinity aggregate).  Deliberately NO proposal-hash
    length gate: the python oracle (``aggregate_check`` ->
    ``hash_to_g2``) accepts any message bytes, and route verdicts must
    not diverge — 32-byte enforcement is the certifier's job
    (``BLSCertifier._lane_of``)."""
    phash, points, pubkeys = lane
    if not points or not pubkeys:
        return None
    agg = hbls.aggregate_signatures(list(points))
    if agg is None:
        return None
    pk = hbls.aggregate_pubkeys(list(pubkeys))
    if pk is None:
        return None
    return agg, pk


def _fs_exponents(
    lanes: Sequence[Lane], aggs: Sequence[tuple], salt: bytes
) -> List[int]:
    """64-bit batch exponents: verifier-private ``salt`` + whole-lane-set
    binding.

    The small-exponents test is only sound when the adversary cannot
    predict the exponents while crafting the statements.  ``salt`` is
    fresh ``os.urandom`` per batch (drawn by the caller), so every
    forgery attempt is an online 2^-64 gamble — content-only derivation
    would let an attacker grind lane tweaks offline until the per-lane
    errors cancel in the product.  The lane content still feeds the
    digest (belt and braces: even a compromised RNG degrades to the
    Fiat-Shamir bound, not to a fixed exponent set; ``None`` pubkeys are
    identity elements and contribute nothing, matching the oracle
    fold)."""
    digest = keccak256(
        b"go-ibft-multipair-fs-v2"
        + salt
        + b"".join(
            bytes(lane[0])
            + encode_seal(agg)
            + b"".join(
                hbls.pubkey_bytes(pk) for pk in lane[2] if pk is not None
            )
            for lane, (agg, _pk) in zip(lanes, aggs)
        )
    )
    out = []
    for i in range(len(lanes)):
        r = int.from_bytes(
            keccak256(digest + i.to_bytes(4, "big"))[:8], "big"
        )
        out.append(r | 1)  # never zero
    return out


# -- fast host Miller loop --------------------------------------------------
# The oracle Miller (crypto/bls.py::miller_raw) untwists into Fp12 and
# pays a full Fp12 inversion per line — deliberately slow-but-sure.  The
# batch route runs MANY Millers against ONE shared final exponentiation,
# so the Miller becomes the bottleneck; this is the device kernel's
# sparse-line Jacobian formulas (the JAX package's ops/bls12_381.py::
# _dbl_step/_add_step, which the port's Miller kernel and plain version share)
# ported to exact host ints: no inversions, lines land in w-basis slots
# (0, 3, 5), values differ from the oracle Miller only by Fp2-subfield
# scalings that the final exponentiation kills — pinned by
# tests/test_torch_bls_verify.py (final_exp(fast) == final_exp(oracle raw)).

_X_BITS_HOST = [int(b) for b in bin(hbls.BLS_X)[3:]]


def _f2_smul(a, k: int):
    """Fp2 element times an Fp integer scalar."""
    return (a[0] * k % hbls.P, a[1] * k % hbls.P)


def _line12(e0, e3, e5) -> "hbls.Fp12T":
    """Sparse w-basis line (slots 0, 3, 5) as a host Fp12 tuple."""
    return ((e0, hbls.F2_ZERO, hbls.F2_ZERO), (hbls.F2_ZERO, e3, e5))


def _host_dbl_step(T, px: int, py: int):
    """Tangent line at Jacobian T evaluated at (px, py), plus 2T."""
    X, Y, Z = T
    z2 = hbls.f2_sqr(Z)
    z3 = hbls.f2_mul(z2, Z)
    yz3 = hbls.f2_mul(Y, z3)
    e0 = hbls.f2_neg(hbls.f2_muli(hbls.f2_mul_xi(_f2_smul(yz3, py)), 2))
    y2 = hbls.f2_sqr(Y)
    x2 = hbls.f2_sqr(X)
    x3 = hbls.f2_mul(x2, X)
    e3 = hbls.f2_sub(hbls.f2_muli(y2, 2), hbls.f2_muli(x3, 3))
    e5 = hbls.f2_muli(_f2_smul(hbls.f2_mul(x2, z2), px), 3)
    a = x2
    b = y2
    c = hbls.f2_sqr(b)
    t = hbls.f2_sqr(hbls.f2_add(X, b))
    d = hbls.f2_muli(hbls.f2_sub(hbls.f2_sub(t, a), c), 2)
    e = hbls.f2_muli(a, 3)
    ff = hbls.f2_sqr(e)
    x3n = hbls.f2_sub(ff, hbls.f2_muli(d, 2))
    y3n = hbls.f2_sub(
        hbls.f2_mul(e, hbls.f2_sub(d, x3n)), hbls.f2_muli(c, 8)
    )
    z3n = hbls.f2_muli(hbls.f2_mul(Y, Z), 2)
    return _line12(e0, e3, e5), (x3n, y3n, z3n)


def _host_add_step(T, qx, qy, px: int, py: int):
    """Chord line through T and the affine twist point Q at (px, py),
    plus T + Q (mixed addition)."""
    X, Y, Z = T
    z2 = hbls.f2_sqr(Z)
    z3 = hbls.f2_mul(z2, Z)
    hh = hbls.f2_sub(hbls.f2_mul(qx, z2), X)
    r = hbls.f2_sub(hbls.f2_mul(qy, z3), Y)
    zh = hbls.f2_mul(Z, hh)
    e0 = hbls.f2_neg(hbls.f2_mul_xi(_f2_smul(zh, py)))
    e3 = hbls.f2_sub(hbls.f2_mul(qy, zh), hbls.f2_mul(r, qx))
    e5 = _f2_smul(r, px)
    hs = hbls.f2_sqr(hh)
    hc = hbls.f2_mul(hs, hh)
    v = hbls.f2_mul(X, hs)
    x3n = hbls.f2_sub(
        hbls.f2_sub(hbls.f2_sqr(r), hc), hbls.f2_muli(v, 2)
    )
    y3n = hbls.f2_sub(
        hbls.f2_mul(r, hbls.f2_sub(v, x3n)), hbls.f2_mul(Y, hc)
    )
    z3n = hbls.f2_mul(Z, hh)
    return _line12(e0, e3, e5), (x3n, y3n, z3n)


def fast_miller(q: "hbls.PointG2", p: "hbls.PointG1") -> "hbls.Fp12T":
    """f_{|x|, q}(p) up to Fp2-subfield line scalings (final-exp-legal).

    ~20x the oracle Miller's speed (no per-line Fp12 inversion); only
    valid for r-torsion ``q`` (the ate ladder then never meets an
    exceptional case), which every caller guarantees via decode_seal /
    hash_to_g2.
    """
    qx, qy = q
    T = (qx, qy, hbls.F2_ONE)
    f = hbls.F12_ONE
    for bit in _X_BITS_HOST:
        line, T = _host_dbl_step(T, p[0], p[1])
        f = hbls.f12_mul(hbls.f12_sqr(f), line)
        if bit:
            line, T = _host_add_step(T, qx, qy, p[0], p[1])
            f = hbls.f12_mul(f, line)
    return f


def _host_ratio(agg, pk, phash) -> "hbls.Fp12T":
    """miller(S, G1) * miller(H, -PK): the lane's pre-final-exp ratio
    (line-scaled; the scalings die under the shared final exp)."""
    h = hbls.hash_to_g2(bytes(phash))
    return hbls.f12_mul(
        fast_miller(agg, hbls.G1_GEN),
        fast_miller(h, hbls.g1_neg(pk)),
    )


def _host_batch_group(
    entries: List[Tuple[int, "hbls.Fp12T"]],
    exps: List[int],
    lanes: Sequence[Lane],
    out: np.ndarray,
) -> None:
    """Check one product equation over ``entries``; bisect on failure.

    ``entries`` carries (lane index, precomputed ratio); singletons fall
    through to the per-lane oracle (exact verdicts, same as
    BLSAggregateVerifier's bisect floor)."""
    if not entries:
        return
    if len(entries) == 1:
        i, _ratio = entries[0]
        phash, points, pubkeys = lanes[i]
        out[i] = aggregate_check(phash, points, pubkeys)
        return
    acc = hbls.F12_ONE
    for (i, ratio), r in zip(entries, exps):
        acc = hbls.f12_mul(acc, hbls.f12_pow(ratio, r))
    metrics.inc_counter(PAIRING_EQS_KEY)
    # fe(x) == 1 iff fe(inv(x)) == 1, so the negative-parameter
    # inversion the oracle pairing performs is unnecessary here.
    if hbls.final_exponentiation(acc) == hbls.F12_ONE:
        for i, _ratio in entries:
            out[i] = True
        return
    mid = len(entries) // 2
    _host_batch_group(entries[:mid], exps[:mid], lanes, out)
    _host_batch_group(entries[mid:], exps[mid:], lanes, out)


def _host_batch_check(lanes: Sequence[Lane]) -> np.ndarray:
    """Shared-final-exponentiation batch verification on the host tower."""
    out = np.zeros(len(lanes), dtype=bool)
    entries: List[Tuple[int, "hbls.Fp12T"]] = []
    aggs = []
    live_lanes = []
    for i, lane in enumerate(lanes):
        pair = _lane_aggregates(lane)
        if pair is None:
            continue  # oracle semantics: vacuous lane -> False
        aggs.append(pair)
        live_lanes.append(lane)
        entries.append((i, _host_ratio(pair[0], pair[1], lane[0])))
    if not entries:
        return out
    import os

    exps = _fs_exponents(live_lanes, aggs, os.urandom(32))
    _host_batch_group(entries, exps, lanes, out)
    return out


def _pack_lanes_device(lanes: Sequence[Lane], dev):
    """Pack live lanes for the multi-pairing kernels; returns (args, live
    index list) — vacuous lanes are excluded (verdict False host-side)."""
    import torch

    from ..ops import bls12_381 as ops
    from ..ops import bls_fp

    live_idx = []
    sig_pts = []
    h_pts = []
    pk_lists = []
    for i, lane in enumerate(lanes):
        phash, points, pubkeys = lane
        # Vacuity gates only (no hash-length gate — the oracle accepts any
        # message bytes); the per-lane PUBKEY fold is the merge kernel's
        # job (it also flags the cancelled-to-infinity aggregate, which
        # masks the verdict False exactly like the oracle's pk_agg-is-None
        # case).
        if not points or not pubkeys:
            continue
        pks = [pk for pk in pubkeys if pk is not None]
        if not pks:
            continue
        agg = hbls.aggregate_signatures(list(points))
        if agg is None:
            continue
        live_idx.append(i)
        sig_pts.append(agg)
        h_pts.append(hbls.hash_to_g2(bytes(phash)))
        pk_lists.append(pks)
    if not live_idx:
        return None, []
    b = _bucket(len(live_idx), MULTIPAIR_BUCKETS)
    v = _bucket(max(len(p) for p in pk_lists), MERGE_BUCKETS)
    pad = b - len(live_idx)
    sig = ops.pack_g2_points(sig_pts + [None] * pad)
    h = ops.pack_g2_points(h_pts + [None] * pad)
    pk = np.zeros((b, v, 2, bls_fp.WORDS), dtype=np.int32)
    pk_live = np.zeros((b, v), dtype=bool)
    for li, pks in enumerate(pk_lists):
        pk[li, : len(pks)] = ops.pack_g1_points(pks)
        pk_live[li, : len(pks)] = True
    lane_live = np.zeros(b, dtype=bool)
    lane_live[: len(live_idx)] = True
    args = tuple(torch.from_numpy(a).to(dev) for a in (sig, h, pk, pk_live, lane_live))
    return args, live_idx


def _device_batch_check(lanes: Sequence[Lane], dev) -> np.ndarray:
    """ONE batched multi-pairing: three kernel launches on the card."""
    from ..ops import bls12_381 as ops

    out = np.zeros(len(lanes), dtype=bool)
    args, live_idx = _pack_lanes_device(lanes, dev)
    if not live_idx:
        return out
    # args[-1] is the padded lane-live mask — its length is the bucket
    # the launches ran at (occupancy denominator).
    with cost_ledger.dispatch_span(
        "bls_multipair_miller",
        route="device",
        live=len(live_idx),
        padded=int(args[-1].shape[0]),
        site="verify/aggregate.py:_device_batch_check",
    ):
        ok = ops.multi_pairing_check(*args)
        metrics.inc_counter(PAIRING_EQS_KEY, len(live_idx))
        mask = ok.cpu().numpy().astype(bool)
    for j, i in enumerate(live_idx):
        out[i] = mask[j]
    return out


def multi_aggregate_check(
    lanes: Sequence[Lane], *, route: str = "host", torch_device: DeviceLike = None
) -> np.ndarray:
    """Verify MANY aggregate equations as one batched operation.

    One logical multi-pairing dispatch per call (the dispatch-count
    contract block-sync pins: a whole catch-up range is ONE call);
    ``route`` picks the engine:

    * ``"python"`` — the per-lane :func:`aggregate_check` oracle loop
      (the semantics source of truth, one pairing equation per lane);
    * ``"host"`` — small-exponents batch on the host tower: ONE final
      exponentiation per batch, bisect-to-oracle on failure;
    * ``"device"`` — the multi-pairing kernels on ``torch_device``
      (``None``: the card), one verdict per lane.

    Returns per-lane verdicts bit-identical to the python oracle (the
    host route's 2^-64 batch term resolves through the oracle on any
    rejection — see the module docstring).
    """
    lanes = list(lanes)
    metrics.inc_counter(MULTIPAIR_DISPATCHES_KEY)
    metrics.inc_counter(MULTIPAIR_LANES_KEY, len(lanes))
    with trace.span("verify.multipair", lanes=len(lanes), route=route):
        if not lanes:
            return np.zeros(0, dtype=bool)
        if route == "python":
            with cost_ledger.dispatch_span(
                "bls_multipair_miller",
                route="python",
                live=len(lanes),
                padded=len(lanes),
                site="verify/aggregate.py:multi_aggregate_check",
            ):
                return np.asarray(
                    [
                        aggregate_check(phash, points, pubkeys)
                        for phash, points, pubkeys in lanes
                    ],
                    dtype=bool,
                )
        if route == "host":
            with cost_ledger.dispatch_span(
                "bls_multipair_miller",
                route="host",
                live=len(lanes),
                padded=len(lanes),
                site="verify/aggregate.py:multi_aggregate_check",
            ):
                return _host_batch_check(lanes)
        if route == "device":
            return _device_batch_check(lanes, resolve_device(torch_device))
        raise ValueError(f"unknown multi-pairing route {route!r}")


class MultiPairVerifier:
    """Route-laddered multi-pairing.

    Preference order: ``device`` (when ``device=True``, on
    ``torch_device``; ``None`` is the card) -> ``host`` (batched) ->
    ``python`` (the per-lane oracle).  Off the card a fault on any rung
    demotes PAST it for the rest of the verifier's life (verdicts never
    change across rungs, only cost does), with the transition counted and
    traced.  On the card the device rung's fault propagates: nothing is
    demoted.  The JAX package's mesh rung is not ported.
    """

    def __init__(
        self,
        *,
        device: bool = False,
        host_batch: bool = True,
        logger=None,
        torch_device: DeviceLike = None,
    ) -> None:
        self._log = logger
        self._lock = threading.Lock()
        self.device = resolve_device(torch_device) if device else None
        rungs = []
        if device:
            rungs.append("device")
        if host_batch:
            rungs.append("host")
        rungs.append("python")
        self._rungs = tuple(rungs)
        self._level = 0
        self.dispatches = 0
        self.lanes = 0
        self.demotions = 0

    @property
    def route(self) -> str:
        return self._rungs[self._level]

    def check(self, lanes: Sequence[Lane]) -> np.ndarray:
        """Per-lane verdicts through the highest live rung; off the card a
        rung fault demotes and re-verifies on the next one (never raises
        past the python oracle, which cannot fault)."""
        lanes = list(lanes)
        with self._lock:
            self.dispatches += 1
            self.lanes += len(lanes)
            level = self._level
        while True:
            route = self._rungs[level]
            try:
                return multi_aggregate_check(
                    lanes, route=route, torch_device=self.device
                )
            except Exception as err:  # noqa: BLE001 - demote, retry below
                if route == "python":
                    raise
                if route == "device" and self.device.type == "cuda":
                    raise  # the card's fault: no host route hides it
                with self._lock:
                    level = max(level + 1, self._level + 1)
                    level = min(level, len(self._rungs) - 1)
                    self._level = level
                    self.demotions += 1
                if self._log:
                    self._log.error(
                        f"multi-pairing rung {route!r} demoted to "
                        f"{self._rungs[level]!r}",
                        err,
                    )
                trace.instant(
                    "verify.multipair_demoted", to=self._rungs[level]
                )

    def stats(self) -> dict:
        with self._lock:
            return {
                "route": self._rungs[self._level],
                "rungs": self._rungs,
                "dispatches": self.dispatches,
                "lanes": self.lanes,
                "demotions": self.demotions,
                "lanes_per_dispatch": (
                    round(self.lanes / self.dispatches, 2)
                    if self.dispatches
                    else None
                ),
            }
