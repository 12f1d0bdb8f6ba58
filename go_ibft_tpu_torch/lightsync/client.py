"""Checkpoint-anchored cold sync: the light-client side of lightsync (the
port of the JAX package's ``lightsync/client.py``).

:class:`CheckpointClient` speaks the proof API's wire surface
(``GET /head``, ``GET /proof``, and the new ``GET /checkpoints`` —
``node/proof_api.py``) over plain stdlib HTTP, trusting NOTHING from
the server:

1. fetch the O(log n) checkpoint skip path and verify every hop through
   :class:`~go_ibft_tpu_torch.lightsync.checkpoint.CheckpointVerifier` — one
   batched pairing dispatch for the whole chain, rotations bridged with
   commitment-enforced finality proofs fetched from the same server;
2. anchor at the verified checkpoint nearest the target height;
3. fetch + verify ONLY the tail ``(anchor, target]`` as an ordinary
   finality proof (``ProofVerifier`` with ``require_commitments`` on, so
   a fabricated rotation diff in the tail dies at the commitment check).

A client checkpointed at genesis of a million-height chain therefore
transfers a handful of ~100-byte certificates plus one short tail proof
instead of a million diff hops — the bench (config #18,
``checkpoint_sync_1m``) measures the ratio and pins the dispatch count.

``device`` (default on) / ``torch_device`` (``None``: the card) run every
check of a sync on the card: the batched pairing checks (the checkpoint
chain's and the proofs' certificate entries) through the multi-pairing
kernels, and the tail and bridge proofs' seal lanes through the digest
and recovery kernels (:class:`~go_ibft_tpu_torch.serve.server.
DispatcherLanes`).  ``device=False`` asks for the host route, the JAX
package's default.

``fetch`` may be a base URL (``"http://127.0.0.1:9090"``) or any
callable ``path -> (json_payload, wire_bytes)`` (tests and in-process
embedders skip the socket).
"""

from __future__ import annotations

import http.client
import json
import urllib.parse
from dataclasses import dataclass
from typing import Callable, Dict, Mapping, Optional, Tuple

from ..utils import metrics
from ..utils.device import DeviceLike, resolve_device
from .checkpoint import CheckpointAnchor, CheckpointError, CheckpointVerifier

__all__ = [
    "CheckpointClient",
    "ColdSyncReport",
    "http_fetcher",
]

Fetch = Callable[[str], Tuple[dict, int]]


def http_fetcher(base_url: str, *, timeout_s: float = 10.0) -> Fetch:
    """A ``path -> (payload, bytes)`` fetcher over stdlib HTTP/1.1.

    One connection per call (the proof API's keep-alive is an
    optimization, not a contract); non-200 statuses raise
    :class:`CheckpointError` with the status and path.
    """
    parsed = urllib.parse.urlparse(base_url)
    if parsed.scheme not in ("http", ""):
        raise ValueError(f"unsupported scheme {parsed.scheme!r}")
    netloc = parsed.netloc or parsed.path

    def fetch(path: str) -> Tuple[dict, int]:
        conn = http.client.HTTPConnection(netloc, timeout=timeout_s)
        try:
            conn.request("GET", path)
            resp = conn.getresponse()
            body = resp.read()
            if resp.status != 200:
                raise CheckpointError(
                    f"GET {path} -> {resp.status} {body[:120]!r}"
                )
            return json.loads(body), len(body)
        finally:
            conn.close()

    return fetch


@dataclass
class ColdSyncReport:
    """What a checkpoint-anchored cold sync cost and verified."""

    head: int
    target: int
    anchor_height: int
    anchor_epoch: int
    spacing: int
    checkpoint_bytes: int
    bridge_bytes: int
    tail_bytes: int
    tail_heights: int
    checkpoint_lanes: int
    pairing_dispatches: int
    powers: Dict[bytes, int]

    @property
    def total_bytes(self) -> int:
        return self.checkpoint_bytes + self.bridge_bytes + self.tail_bytes

    @property
    def heights_skipped(self) -> int:
        return self.anchor_height


class CheckpointClient:
    """Anchors a proof-API client at the nearest verified checkpoint."""

    def __init__(
        self,
        fetch,
        bls_keys_for_height: Optional[Callable[[int], Mapping]] = None,
        *,
        device: bool = True,
        require_commitments: bool = True,
        timeout_s: float = 10.0,
        torch_device: DeviceLike = None,
    ) -> None:
        self._fetch: Fetch = (
            http_fetcher(fetch, timeout_s=timeout_s)
            if isinstance(fetch, str)
            else fetch
        )
        self._bls_keys = bls_keys_for_height
        self._device = device
        self._torch_device = resolve_device(torch_device) if device else None
        self._require_commitments = require_commitments

    # -- wire ------------------------------------------------------------

    def head(self) -> Tuple[int, int]:
        payload, n = self._fetch("/head")
        return int(payload["head"]), n

    def fetch_checkpoints(
        self,
        *,
        target_epoch: Optional[int] = None,
        include_all: bool = False,
    ) -> Tuple[dict, int]:
        query = []
        if target_epoch is not None:
            query.append(f"epoch={int(target_epoch)}")
        if include_all:
            query.append("all=1")
        path = "/checkpoints" + ("?" + "&".join(query) if query else "")
        return self._fetch(path)

    def fetch_proof(self, checkpoint: int, target: int) -> Tuple[dict, int]:
        return self._fetch(
            f"/proof?checkpoint={int(checkpoint)}&target={int(target)}"
        )

    # -- verification ----------------------------------------------------

    def _proof_verifier(self):
        from ..serve.server import ProofVerifier

        return ProofVerifier(
            bls_keys_for_height=self._bls_keys,
            require_commitments=self._require_commitments,
            device=self._device,
            torch_device=self._torch_device,
        )

    def _verify_tail(
        self,
        checkpoint: int,
        target: int,
        powers: Mapping[bytes, int],
    ) -> Tuple[Dict[bytes, int], int]:
        """Fetch + verify the tail range; returns (powers at ``target``,
        wire bytes).  Also the rotation bridge for checkpoint hops."""
        from ..serve.proof import FinalityProof, walk_sets

        payload, n = self.fetch_proof(checkpoint, target)
        proof = FinalityProof.from_wire(payload["proof"])
        if proof.checkpoint_height != checkpoint or proof.target != target:
            raise CheckpointError(
                f"served proof covers ({proof.checkpoint_height}, "
                f"{proof.target}], requested ({checkpoint}, {target}]"
            )
        self._proof_verifier().verify(proof, powers)
        # The walk is pure dict arithmetic over an already-verified
        # proof; re-running it extracts the derived set at the target.
        sets = walk_sets(
            powers, proof, require_commitments=self._require_commitments
        )
        return dict(sets[target]), n

    def sync(
        self,
        trusted_powers: Mapping[bytes, int],
        *,
        target_epoch: Optional[int] = None,
    ) -> Tuple[CheckpointAnchor, int]:
        """Verify the checkpoint chain to ``target_epoch`` (default:
        latest); returns the anchor + checkpoint wire bytes."""
        payload, n = self.fetch_checkpoints(target_epoch=target_epoch)
        bridge_bytes = 0

        def bridge(from_h, to_h, powers):
            nonlocal bridge_bytes
            new_powers, nb = self._verify_tail(from_h, to_h, powers)
            bridge_bytes += nb
            return new_powers

        verifier = CheckpointVerifier(
            self._bls_keys, device=self._device, torch_device=self._torch_device
        )
        anchor = verifier.verify_chain(payload, trusted_powers, bridge=bridge)
        return anchor, n + bridge_bytes

    def cold_sync(
        self,
        trusted_powers: Mapping[bytes, int],
        target: Optional[int] = None,
    ) -> ColdSyncReport:
        """Full cold sync from a genesis trust anchor to ``target``
        (default: the served head): checkpoint skip chain + tail proof,
        every byte verified.  Raises :class:`CheckpointError` /
        ``ProofError`` on any rejection."""
        from ..verify.aggregate import MULTIPAIR_DISPATCHES_KEY

        dispatches0 = metrics.get_counter(MULTIPAIR_DISPATCHES_KEY)
        head, head_bytes = self.head()
        target = head if target is None else int(target)
        if not 1 <= target <= head:
            raise CheckpointError(f"target {target} outside [1, {head}]")

        payload, ckpt_bytes = self.fetch_checkpoints()
        ckpt_bytes += head_bytes
        spacing = int(payload.get("spacing", 0) or 0)
        latest_epoch = int(payload.get("latest_epoch", 0) or 0)
        want_epoch = min(target // spacing, latest_epoch) if spacing else 0
        bridge_bytes = 0
        if want_epoch >= 1:
            if want_epoch != latest_epoch:
                # Re-fetch the skip path ENDING at the epoch we anchor
                # on (the server descends from any epoch ≤ latest).
                payload, n = self.fetch_checkpoints(target_epoch=want_epoch)
                ckpt_bytes += n

            def bridge(from_h, to_h, powers):
                nonlocal bridge_bytes
                new_powers, nb = self._verify_tail(from_h, to_h, powers)
                bridge_bytes += nb
                return new_powers

            verifier = CheckpointVerifier(
                self._bls_keys, device=self._device, torch_device=self._torch_device
            )
            anchor = verifier.verify_chain(
                payload, trusted_powers, bridge=bridge
            )
        else:
            anchor = CheckpointAnchor(
                height=0,
                epoch=0,
                powers=dict(trusted_powers),
                spacing=spacing,
                lanes=0,
            )

        tail_bytes = 0
        powers = dict(anchor.powers)
        if target > anchor.height:
            powers, tail_bytes = self._verify_tail(
                anchor.height, target, powers
            )
        return ColdSyncReport(
            head=head,
            target=target,
            anchor_height=anchor.height,
            anchor_epoch=anchor.epoch,
            spacing=spacing,
            checkpoint_bytes=ckpt_bytes,
            bridge_bytes=bridge_bytes,
            tail_bytes=tail_bytes,
            tail_heights=target - anchor.height,
            checkpoint_lanes=anchor.lanes,
            pairing_dispatches=metrics.get_counter(MULTIPAIR_DISPATCHES_KEY)
            - dispatches0,
            powers=powers,
        )
