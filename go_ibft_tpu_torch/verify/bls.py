"""BLS12-381 aggregate committed-seal verification (BatchVerifier-shaped);
the port of ``go_ibft_tpu/verify/bls.py``.

BASELINE.md config #4: instead of one ECDSA recovery per COMMIT seal, the
whole quorum is certified with ONE pairing equation —
``e(G1, sum(sig_i)) == e(sum(pk_i), H2(proposal_hash))`` — so the COMMIT
phase cost is two masked point aggregations plus a validator-count-
independent pairing check.

Shape of the integration (same seam as the ECDSA path,
:class:`go_ibft_tpu_torch.core.backend.BatchVerifier`): ``verify_committed_seals``
returns a per-seal boolean mask.  Aggregate verification is all-or-nothing,
so the fast path answers "all valid"; on failure the batch is BISECTED —
halves re-aggregate-verify independently, so ``k`` Byzantine seals in an
``n``-seal quorum cost ``O(k log n)`` pairing equations instead of ``n``
(the same quarantine posture as
:class:`~go_ibft_tpu_torch.verify.batch.ResilientBatchVerifier`'s poison-batch
bisection, applied to cryptographic rather than operational faults).

Seal wire format: 192 bytes ``x0 || x1 || y0 || y1`` (uncompressed G2,
48-byte big-endian field elements).  Validator registry maps the 20-byte
consensus address to the BLS G1 public key.

Security posture: :func:`decode_seal` rejects G2
points outside the r-torsion subgroup — the twist's full group order is
``r * h2`` with a composite cofactor, so an on-curve check alone admits
small-subgroup points whose contribution to an aggregate is confined to a
tiny group (a classic malleability / key-leak primitive).  The check is
``[r]P == O`` (the subgroup definition), LRU-cached by seal bytes because
the same 192 bytes recur across drains and rounds.

The device route (``device=True``) runs
:func:`go_ibft_tpu_torch.ops.bls12_381.aggregate_verify_commit`: on the
card its three kernels (two merges, the Miller loops, the final
exponentiation), on the CPU their plain versions where the caller passes
``torch_device="cpu"``.  ``device`` keeps the JAX package's switch and
default; the torch device is a separate keyword, ``None`` meaning the card.
A fault on the card propagates: nothing falls back to the host oracle.
"""

from __future__ import annotations

import time
from functools import lru_cache
from typing import Callable, List, Mapping, Optional, Sequence, Tuple

import numpy as np

from ..crypto import bls as hbls
from ..messages.helpers import CommittedSeal
from ..obs import ledger as cost_ledger
from ..utils import metrics
from ..utils.device import DeviceLike, resolve_device

BLS_SEAL_BYTES = 192
_FE = 48  # bytes per Fp element

# One count per aggregate pairing EQUATION checked (host or device route);
# the bench's config #9 reads this to report what a drain actually cost.
PAIRING_EQS_KEY = ("go-ibft", "bls", "pairing_equations")

BLSKeySource = Callable[[int], Mapping[bytes, "hbls.PointG1"]]


def encode_seal(point: "hbls.PointG2") -> bytes:
    """G2 point -> 192-byte seal (x0 || x1 || y0 || y1, big-endian)."""
    if point is None:
        raise ValueError("cannot encode the point at infinity as a seal")
    (x0, x1), (y0, y1) = point
    return b"".join(v.to_bytes(_FE, "big") for v in (x0, x1, y0, y1))


@lru_cache(maxsize=8192)
def _decode_seal_cached(blob: bytes) -> Optional["hbls.PointG2"]:
    x0, x1, y0, y1 = (
        int.from_bytes(blob[i * _FE : (i + 1) * _FE], "big") for i in range(4)
    )
    if max(x0, x1, y0, y1) >= hbls.P:
        return None
    pt = ((x0, x1), (y0, y1))
    if not hbls.g2_on_curve(pt):
        return None
    # r-torsion membership: the on-curve check admits points of any order
    # dividing #E'(Fp2) = r * h2; a seal living in the h2 part would pass
    # curve validation yet aggregate maliciously.  [r]P == O is the
    # definition of membership (a ~255-bit ladder, ~10 ms host — absorbed
    # by this cache since seal bytes recur across drains).
    if hbls.g2_mul(hbls.R, pt) is not None:
        return None
    return pt


def decode_seal(blob: bytes) -> Optional["hbls.PointG2"]:
    """192-byte seal -> G2 point in the r-torsion subgroup, else None.

    Rejects: wrong length, non-canonical field elements, off-curve
    points, and on-curve points outside the r-order subgroup.
    """
    if len(blob) != BLS_SEAL_BYTES:
        return None
    return _decode_seal_cached(bytes(blob))


def aggregate_check(
    proposal_hash: bytes,
    points: Sequence["hbls.PointG2"],
    pubkeys: Sequence["hbls.PointG1"],
    *,
    device: bool = False,
    torch_device: DeviceLike = None,
) -> bool:
    """ONE pairing equation over a seal set (host oracle or device route).

    Shared by :class:`BLSAggregateVerifier`, the quorum-certificate
    verifier (:mod:`go_ibft_tpu_torch.crypto.quorum_cert`) and the bench, so
    every aggregate consumer counts pairings through the same metric and
    can never drift in accept-set semantics.  The device route runs on
    ``torch_device`` (``None``: the card).
    """
    metrics.inc_counter(PAIRING_EQS_KEY)
    if device:
        return _aggregate_check_device(proposal_hash, points, pubkeys, resolve_device(torch_device))
    agg = hbls.aggregate_signatures(points)
    return hbls.aggregate_verify(list(pubkeys), proposal_hash, agg)


def _pow2(n: int) -> int:
    v = 2
    while v < n:
        v *= 2
    return v


def _pack_commit_check(proposal_hash: bytes, points, pubkeys, dev) -> tuple:
    """The arguments of ``aggregate_verify_commit`` for one seal set, as
    tensors on ``dev``: each side padded to a power of two (at least 2)
    with its own live mask.  (The JAX package pads both sides to the seal
    count, which fails for a quorum certificate's one point and many
    pubkeys.)"""
    import torch

    from ..ops import bls12_381 as ops

    v, vk = _pow2(len(points)), _pow2(len(pubkeys))
    pk = ops.pack_g1_points(list(pubkeys) + [None] * (vk - len(pubkeys)))
    sig = ops.pack_g2_points(list(points) + [None] * (v - len(points)))
    h = ops.pack_g2_points([hbls.hash_to_g2(proposal_hash)])[0]
    live = np.arange(v) < len(points)
    pk_live = np.arange(vk) < len(pubkeys)
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in (pk, sig, h, live, pk_live))


def _aggregate_check_device(proposal_hash, points, pubkeys, dev) -> bool:
    from ..ops import bls12_381 as ops

    args = _pack_commit_check(proposal_hash, points, pubkeys, dev)
    t0 = time.perf_counter()
    with cost_ledger.dispatch_span(
        "bls_aggregate_verify",
        route="device",
        live=len(points),
        padded=int(args[3].shape[0]),
        block=False,
        site="verify/bls.py:_aggregate_check_device",
    ):
        ok = ops.aggregate_verify_commit(*args)
        out = bool(ok)  # the readback ends the call
    dt_ms = (time.perf_counter() - t0) * 1e3
    metrics.observe(("go-ibft", "device", "bls_aggregate_ms"), dt_ms)
    cost_ledger.add_device_ms("bls_aggregate_verify", "device", dt_ms)
    return out


class BLSAggregateVerifier:
    """Aggregate-first committed-seal verifier.

    ``bls_keys_for_height`` maps height -> {consensus address: G1 pubkey}.
    The device path (:func:`go_ibft_tpu_torch.ops.bls12_381.aggregate_verify_commit`)
    runs when ``device=True``, on ``torch_device`` (``None``: the card;
    ``self.device`` is then that torch device, which
    :func:`~go_ibft_tpu_torch.verify.batch.on_card` reads); the host oracle
    pairing runs otherwise — identical accept-sets either way (conformance
    tests assert it).

    Unhappy path: aggregate-then-bisect.  A failing aggregate splits in
    half and each half re-verifies as its own aggregate; a single seal
    that still fails is condemned.  ``k`` bad seals therefore cost
    ``O(k log n)`` pairing equations — the byzantine-free round stays ONE.
    """

    def __init__(
        self,
        bls_keys_for_height: BLSKeySource,
        device: bool = True,
        *,
        torch_device: DeviceLike = None,
    ):
        self._keys = bls_keys_for_height
        self._device = device
        self.device = resolve_device(torch_device) if device else None

    # -- the one-pairing happy path ------------------------------------

    def _aggregate_check(
        self,
        proposal_hash: bytes,
        points: Sequence["hbls.PointG2"],
        pubkeys: Sequence["hbls.PointG1"],
    ) -> bool:
        return aggregate_check(
            proposal_hash, points, pubkeys, device=self._device, torch_device=self.device
        )

    # -- the bisect unhappy path ---------------------------------------

    def _bisect(
        self,
        proposal_hash: bytes,
        decoded: List[Tuple[int, "hbls.PointG2", "hbls.PointG1"]],
        out: np.ndarray,
    ) -> None:
        """Pinpoint bad seals by recursive aggregate halving.

        Called AFTER the whole-set aggregate failed, so the set is known
        to contain at least one bad seal.  Verdicts land in ``out``;
        sub-aggregates that pass mark their whole half True in one
        equation.

        Soundness note: "True" means *member of a verifying aggregate* —
        the same statement the happy path proves for the full set.  Two
        colluding signers whose seal errors cancel verify jointly at
        EVERY granularity their seals share a sub-aggregate (including
        the happy path itself); this is inherent to aggregate signatures
        and quorum-sound, because each claimed signer's registered (PoP-
        checked) pubkey participates in the equation.  For non-colluding
        corruption (bit flips, wrong-hash seals) the verdicts are
        bit-identical to the per-seal oracle, which the conformance
        tests pin.
        """
        if len(decoded) == 1:
            i, pt, pk = decoded[0]
            out[i] = aggregate_check(
                proposal_hash, [pt], [pk], device=self._device, torch_device=self.device
            )
            return
        mid = len(decoded) // 2
        for half in (decoded[:mid], decoded[mid:]):
            if len(half) == 1:
                # one equation suffices; a failed pre-check would only be
                # re-checked by the recursion
                self._bisect(proposal_hash, half, out)
            elif self._aggregate_check(
                proposal_hash, [p for _, p, _ in half], [k for _, _, k in half]
            ):
                out[np.asarray([i for i, _, _ in half])] = True
            else:
                self._bisect(proposal_hash, half, out)

    # -- BatchVerifier-shaped seal interface ---------------------------

    def verify_committed_seals(
        self, proposal_hash: bytes, seals: Sequence[CommittedSeal], height: int
    ) -> np.ndarray:
        out = np.zeros(len(seals), dtype=bool)
        if not seals or len(proposal_hash) != 32:
            return out
        keys = self._keys(height)
        decoded: list[Tuple[int, "hbls.PointG2", "hbls.PointG1"]] = []
        for i, seal in enumerate(seals):
            pk = keys.get(seal.signer)
            if pk is None:
                continue  # not a validator at this height
            pt = decode_seal(seal.signature)
            if pt is None:
                continue  # malformed / off-curve / small-subgroup
            decoded.append((i, pt, pk))
        if not decoded:
            return out
        idxs = [i for i, _, _ in decoded]
        points = [p for _, p, _ in decoded]
        pks = [k for _, _, k in decoded]
        if self._aggregate_check(proposal_hash, points, pks):
            out[np.asarray(idxs)] = True
            return out
        # Unhappy path (requires an actively byzantine signer inside the
        # candidate set): aggregate-then-bisect — O(k log n) equations for
        # k bad seals instead of n per-seal pairings.
        self._bisect(proposal_hash, decoded, out)
        return out
