"""Batch verification on the device: packers + a PyTorch ``DeviceBatchVerifier``.

The port of the device half of ``go_ibft_tpu.verify.batch``.  The same
observable semantics — a validity mask over a message set, and the fused
voting-power quorum — come from one batch of PyTorch ops on the card:

    payload bytes --pack--> keccak blocks --digest--> ecrecover ladder
                 --> pubkey --keccak--> address --compare--> mask

The packers are copies of the JAX package's (numpy, bit-identical outputs,
same lane/block/table buckets).  The verifier keeps the reference's
semantics for malformed lanes (filtered before packing, ``False`` in the
output) and for degenerate rounds (per-phase fallbacks).  The pipeline,
pack cache, adaptive and resilient verifiers and the observability
plumbing of the original are not ported yet.

Signature format: 65 bytes ``r(32, big-endian) || s(32, big-endian) || v(1)``,
signing ``keccak256(payload_no_sig)`` for envelopes and the proposal hash
directly for committed seals.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.validator_manager import calculate_quorum
from ..crypto.keccak import keccak256_many
from ..messages.helpers import CommittedSeal
from ..messages.wire import IbftMessage
from ..ops import keccak as dk
from ..ops import quorum
from ..ops import secp256k1 as sec
from ..ops.fields import LIMB_BITS, LIMB_MASK
from ..utils.device import DeviceLike, resolve_device

SIG_BYTES = 65  # r(32) || s(32) || v(1)
ADDRESS_BYTES = 20

# Pad-to buckets (the JAX package's): batch lanes, keccak blocks per
# message, validator-set size.
_BATCH_BUCKETS = (8, 32, 128, 512, 1024, 2048)
_BLOCK_BUCKETS = (2, 8, 32)
_TABLE_BUCKETS = (8, 128, 512, 2048)

# One batch's lane capacity: larger drains run in chunks of this size.
_DISPATCH_CAP = _BATCH_BUCKETS[-1]

# Largest payload the device digest path can absorb; one byte is reserved
# for keccak padding in the last block.
MAX_DEVICE_PAYLOAD = _BLOCK_BUCKETS[-1] * dk.RATE_BYTES - 1

ValidatorSource = Callable[[int], Mapping[bytes, int]]


class MalformedLaneError(ValueError):
    """A packer input lane has an invalid length, named by index."""

    def __init__(self, lane: int, field: str, expected: int, got: int):
        self.lane = lane
        self.field = field
        self.expected = expected
        self.got = got
        super().__init__(f"lane {lane}: {field} must be {expected} bytes, got {got}")


def _bucket(n: int, buckets: Sequence[int]) -> int:
    for b in buckets:
        if n <= b:
            return b
    raise ValueError(f"size {n} exceeds largest bucket {buckets[-1]}")


def _lane_count(n: int, pad_lanes: int = 0) -> int:
    """Static lane dimension for an ``n``-lane pack: an explicit
    ``pad_lanes >= n`` pins it, otherwise the next bucket."""
    if pad_lanes >= max(n, 1):
        return pad_lanes
    return max(_bucket(n, _BATCH_BUCKETS), pad_lanes)


def split_signature(sig: bytes) -> Tuple[int, int, int]:
    """65-byte ``r || s || v`` -> ints; raises on wrong length."""
    if len(sig) != SIG_BYTES:
        raise ValueError(f"signature must be {SIG_BYTES} bytes, got {len(sig)}")
    return (
        int.from_bytes(sig[:32], "big"),
        int.from_bytes(sig[32:64], "big"),
        sig[64],
    )


def _split_signatures(sigs: Sequence[bytes]) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """N sigs -> ``(r_words, s_words, v)``: ``(N, 8)`` uint32 little-endian
    value words and ``(N,)`` int32 recovery ids."""
    for i, sig in enumerate(sigs):
        if len(sig) != SIG_BYTES:
            raise MalformedLaneError(i, "signature", SIG_BYTES, len(sig))
    n = len(sigs)
    if n == 0:
        z = np.zeros((0, 8), dtype=np.uint32)
        return z, z.copy(), np.zeros((0,), dtype=np.int32)
    flat = np.frombuffer(b"".join(sigs), dtype=np.uint8).reshape(n, SIG_BYTES)
    r_words = np.ascontiguousarray(flat[:, 31::-1]).view("<u4")
    s_words = np.ascontiguousarray(flat[:, 63:31:-1]).view("<u4")
    return r_words, s_words, flat[:, 64].astype(np.int32)


def _words_to_limbs(words: np.ndarray, nlimbs: int) -> np.ndarray:
    """``(N, nw)`` uint32 LE value words -> ``(N, nlimbs)`` int32 limbs."""
    nw = words.shape[-1]
    out = np.zeros(words.shape[:-1] + (nlimbs,), dtype=np.int32)
    for k in range(nlimbs):
        j, sh = divmod(LIMB_BITS * k, 32)
        if j >= nw:
            break
        acc = words[..., j] >> np.uint32(sh)
        if sh + LIMB_BITS > 32 and j + 1 < nw:
            acc = acc | (words[..., j + 1] << np.uint32(32 - sh))
        out[..., k] = (acc & np.uint32(LIMB_MASK)).astype(np.int32)
    return out


def pack_validator_table(addresses: Sequence[bytes], bucket: bool = True) -> np.ndarray:
    """Addresses -> ``(V, 5)`` uint32 words, padded by repeating row 0."""
    addresses = [a for a in addresses if len(a) == ADDRESS_BYTES]
    if not addresses:
        raise ValueError("empty validator set")
    v = _bucket(len(addresses), _TABLE_BUCKETS) if bucket else len(addresses)
    table = np.zeros((v, 5), dtype=np.uint32)
    table[: len(addresses)] = dk.addresses_to_words(addresses)
    table[len(addresses) :] = table[0]  # padding adds no new member
    return table


def pack_sender_batch(
    msgs: Sequence[IbftMessage],
    pad_lanes: int = 0,
    payloads: Optional[List[bytes]] = None,
):
    """Messages -> ``(blocks, counts, r, s, v, senders, live)`` numpy arrays
    padded to bucketed shapes (the JAX package's packer without its pack
    cache).  ``payloads`` overrides the per-message signed bytes.  A
    wrong-length sender or signature raises :class:`MalformedLaneError`;
    an empty input gives a fully dead batch."""
    n = len(msgs)
    for i, m in enumerate(msgs):
        if len(m.signature) != SIG_BYTES:
            raise MalformedLaneError(i, "signature", SIG_BYTES, len(m.signature))
        if len(m.sender) != ADDRESS_BYTES:
            raise MalformedLaneError(i, "sender", ADDRESS_BYTES, len(m.sender))
    bb = _lane_count(n, pad_lanes)
    nl = sec.FIELD.nlimbs
    r_limbs = np.zeros((bb, nl), dtype=np.int32)
    s_limbs = np.zeros((bb, nl), dtype=np.int32)
    v = np.zeros((bb,), dtype=np.int32)
    senders = np.zeros((bb, 5), dtype=np.uint32)
    live = np.zeros((bb,), dtype=bool)
    if n == 0:
        blocks = np.zeros((bb, _BLOCK_BUCKETS[0], 17, 2), dtype=np.uint32)
        return blocks, np.ones((bb,), np.int32), r_limbs, s_limbs, v, senders, live
    if payloads is None:
        payloads = [m.encode(include_signature=False) for m in msgs]
    max_len = max(len(p) for p in payloads)
    nb = _bucket((max_len + 1 + dk.RATE_BYTES - 1) // dk.RATE_BYTES, _BLOCK_BUCKETS)
    blocks = np.zeros((bb, nb, 17, 2), dtype=np.uint32)
    counts = np.ones((bb,), dtype=np.int32)
    pb, pc = dk.pack_messages(payloads, nb)
    blocks[:n] = pb
    counts[:n] = pc
    rw, sw, vv = _split_signatures([m.signature for m in msgs])
    r_limbs[:n] = _words_to_limbs(rw, nl)
    s_limbs[:n] = _words_to_limbs(sw, nl)
    v[:n] = vv
    senders[:n] = dk.addresses_to_words([m.sender for m in msgs])
    live[:n] = True
    return blocks, counts, r_limbs, s_limbs, v, senders, live


def pack_seal_batch(proposal_hash: bytes, seals: Sequence[CommittedSeal], pad_lanes: int = 0):
    """Seals -> ``(hash_words, r, s, v, signers, live)`` numpy arrays; the
    proposal hash is broadcast to every lane as little-endian value words.
    A non-32-byte hash is a plain ``ValueError`` (batch-wide)."""
    if len(proposal_hash) != 32:
        raise ValueError(f"proposal hash must be 32 bytes, got {len(proposal_hash)}")
    for i, s in enumerate(seals):
        if len(s.signature) != SIG_BYTES:
            raise MalformedLaneError(i, "signature", SIG_BYTES, len(s.signature))
        if len(s.signer) != ADDRESS_BYTES:
            raise MalformedLaneError(i, "signer", ADDRESS_BYTES, len(s.signer))
    n = len(seals)
    bb = _lane_count(n, pad_lanes)
    hw = np.frombuffer(proposal_hash, ">u4")[::-1].astype(np.uint32)  # LE words
    hash_zw = np.broadcast_to(hw, (bb, 8)).copy()
    nl = sec.FIELD.nlimbs
    r_limbs = np.zeros((bb, nl), dtype=np.int32)
    s_limbs = np.zeros((bb, nl), dtype=np.int32)
    v = np.zeros((bb,), dtype=np.int32)
    signers = np.zeros((bb, 5), dtype=np.uint32)
    live = np.zeros((bb,), dtype=bool)
    if n:
        rw, sw, vv = _split_signatures([s.signature for s in seals])
        r_limbs[:n] = _words_to_limbs(rw, nl)
        s_limbs[:n] = _words_to_limbs(sw, nl)
        v[:n] = vv
        signers[:n] = dk.addresses_to_words([s.signer for s in seals])
        live[:n] = True
    return hash_zw, r_limbs, s_limbs, v, signers, live


def _words(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """uint32 word array -> int32 bit-pattern tensor on ``device``."""
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32)).to(device)


def _tensor(a: np.ndarray, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def _threshold(thr: int) -> Tuple[int, int]:
    thr = max(thr, 0)
    return thr & 0xFFFF, thr >> 16


class DeviceBatchVerifier:
    """Batch verification and fused quorum on one device (the card by default).

    ``validators_for_height`` supplies the voting-power map; the packed
    address table and power halves are built once per height and kept on
    the device.  ``device=None`` means ``cuda`` and raises where there is
    none; the tests pass ``device="cpu"``.
    """

    def __init__(
        self,
        validators_for_height: ValidatorSource,
        device: DeviceLike = None,
        cache_heights: int = 4,
    ):
        self.device = resolve_device(device)
        self._validators = validators_for_height
        self._cache_heights = cache_heights
        self._tables: Dict[int, Tuple[torch.Tensor, List[bytes]]] = {}
        self._quorum_packs: Dict[int, Optional[Tuple[torch.Tensor, torch.Tensor, int]]] = {}

    # -- validator table management ------------------------------------

    def _table_and_addrs(self, height: int) -> Tuple[torch.Tensor, List[bytes]]:
        hit = self._tables.get(height)
        if hit is None:
            addrs = [a for a in self._validators(height) if len(a) == ADDRESS_BYTES]
            hit = (_words(pack_validator_table(addrs), self.device), addrs)
            self._tables[height] = hit
            if len(self._tables) > self._cache_heights:
                self._tables.pop(min(self._tables))
        return hit

    def _quorum_pack(self, height: int) -> Optional[Tuple[torch.Tensor, torch.Tensor, int]]:
        """Per-height ``(powers_lo, powers_hi, quorum)``, or None when the
        split-int32 path cannot represent the set exactly (a power or the
        total >= 2**31, or an empty set)."""
        if height in self._quorum_packs:
            return self._quorum_packs[height]
        powers_map = self._validators(height)
        pack = None
        try:
            table, addrs = self._table_and_addrs(height)
        except ValueError:  # empty validator set
            addrs = []
        # The total is over the FULL map, like the host ValidatorManager.
        total = sum(powers_map.values())
        if addrs and 0 < total < (1 << 31) and all(0 <= p < (1 << 31) for p in powers_map.values()):
            v = table.shape[0]
            plo = np.zeros(v, dtype=np.int32)
            phi = np.zeros(v, dtype=np.int32)
            for i, a in enumerate(addrs):
                plo[i], phi[i] = quorum.split_power(powers_map[a])
            pack = (_tensor(plo, self.device), _tensor(phi, self.device), calculate_quorum(total))
        self._quorum_packs[height] = pack
        if len(self._quorum_packs) > self._cache_heights:
            self._quorum_packs.pop(min(self._quorum_packs))
        return pack

    def supports_fused(self, height: int) -> bool:
        """True when the fused mask+quorum path is exact for this height."""
        return self._quorum_pack(height) is not None

    # -- packing ---------------------------------------------------------

    @staticmethod
    def _well_formed_sender(m: IbftMessage, height: Optional[int]) -> bool:
        return (
            m.view is not None
            and (height is None or m.view.height == height)
            and len(m.sender) == ADDRESS_BYTES
            and len(m.signature) == SIG_BYTES
        )

    @staticmethod
    def _well_formed_seal(seal: CommittedSeal) -> bool:
        return len(seal.signer) == ADDRESS_BYTES and len(seal.signature) == SIG_BYTES

    def _sender_inputs(self, msgs: List[IbftMessage], pad_lanes: int = 0):
        """Pack envelopes and digest them on the device; a payload above
        the largest block bucket is digested on the host instead and its
        digest written into the ``zw`` rows.  Returns device tensors
        ``(zw, r, s, v, senders, live)``."""
        payloads = [m.encode(include_signature=False) for m in msgs]
        big = [i for i, p in enumerate(payloads) if len(p) > MAX_DEVICE_PAYLOAD]
        device_payloads = list(payloads)
        for i in big:
            device_payloads[i] = b""
        blocks, counts, r, s, v, senders, live = pack_sender_batch(
            msgs, pad_lanes=pad_lanes, payloads=device_payloads
        )
        dev = self.device
        zw = quorum.digest_words(_words(blocks, dev), _tensor(counts, dev))
        if big:
            rows = np.stack(
                [np.frombuffer(d, ">u4")[::-1].astype(np.uint32)
                 for d in keccak256_many([payloads[i] for i in big])]
            )
            zw[torch.as_tensor(big, device=dev)] = _words(rows, dev)
        return zw, _tensor(r, dev), _tensor(s, dev), _tensor(v, dev), _words(senders, dev), _tensor(live, dev)

    def _seal_inputs(self, proposal_hash: bytes, seals: List[CommittedSeal], pad_lanes: int = 0):
        hz, r, s, v, signers, live = pack_seal_batch(proposal_hash, seals, pad_lanes=pad_lanes)
        dev = self.device
        return _words(hz, dev), _tensor(r, dev), _tensor(s, dev), _tensor(v, dev), _words(signers, dev), _tensor(live, dev)

    def _mask(self, inputs, table: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """Validity mask (signature + membership) and the equality matrix."""
        zw, r, s, v, claimed, live = inputs
        ok = quorum.sig_checks_zw(zw, r, s, v, claimed, live)
        eq = quorum.membership_eq(claimed, table)
        return ok & torch.any(eq, dim=-1), eq

    # -- fused mask + quorum (the engine's phase hot path) --------------

    def _fused_pack(self, height: int):
        pack = self._quorum_pack(height)
        if pack is None:
            raise ValueError(f"fused quorum unsupported for height {height}")
        return self._table_and_addrs(height)[0], pack

    def _certify(self, inputs, table, plo, phi, thr: int) -> Tuple[np.ndarray, bool]:
        ok, eq = self._mask(inputs, table)
        reached, _, _ = quorum.power_reduce(ok, eq, plo, phi, *_threshold(thr))
        return ok.cpu().numpy(), bool(reached)

    def certify_senders(
        self, msgs: Sequence[IbftMessage], height: int, threshold: Optional[int] = None
    ) -> Tuple[np.ndarray, bool]:
        """Envelope recovery + membership + voting-power quorum in one batch.

        All messages must share ``height``; ``threshold`` overrides the
        quorum size (``None`` means the height's quorum).  Returns
        ``(mask, reached)``; requires :meth:`supports_fused`.
        """
        table, (plo, phi, quorum_size) = self._fused_pack(height)
        thr = quorum_size if threshold is None else threshold
        out = np.zeros(len(msgs), dtype=bool)
        idxs = [i for i, m in enumerate(msgs) if self._well_formed_sender(m, height)]
        if not idxs:
            return out, thr <= 0
        mask, reached = self._certify(
            self._sender_inputs([msgs[i] for i in idxs]), table, plo, phi, thr
        )
        out[np.asarray(idxs)] = mask[: len(idxs)]
        return out, reached

    def certify_seals(
        self,
        proposal_hash: bytes,
        seals: Sequence[CommittedSeal],
        height: int,
        threshold: Optional[int] = None,
    ) -> Tuple[np.ndarray, bool]:
        """COMMIT-phase check: seal recovery + membership + quorum.
        Returns ``(mask, reached)``."""
        table, (plo, phi, quorum_size) = self._fused_pack(height)
        thr = quorum_size if threshold is None else threshold
        out = np.zeros(len(seals), dtype=bool)
        idxs = [i for i, s in enumerate(seals) if self._well_formed_seal(s)]
        if not idxs or len(proposal_hash) != 32:
            return out, thr <= 0
        mask, reached = self._certify(
            self._seal_inputs(proposal_hash, [seals[i] for i in idxs]), table, plo, phi, thr
        )
        out[np.asarray(idxs)] = mask[: len(idxs)]
        return out, reached

    def certify_round(
        self,
        msgs: Sequence[IbftMessage],
        proposal_hash: bytes,
        seals: Sequence[CommittedSeal],
        height: int,
        prepare_threshold: Optional[int] = None,
    ) -> Tuple[np.ndarray, bool, np.ndarray, bool]:
        """Certify BOTH phases of a round in one batch.

        PREPARE envelopes and COMMIT seals are packed to one common lane
        bucket, concatenated and run through one recovery ladder with two
        quorum reductions.  Returns ``(sender_mask, prepare_reached,
        seal_mask, commit_reached)``.  Requires :meth:`supports_fused`.
        """
        table, (plo, phi, seal_thr) = self._fused_pack(height)
        p_thr = seal_thr if prepare_threshold is None else prepare_threshold
        sender_mask = np.zeros(len(msgs), dtype=bool)
        seal_mask = np.zeros(len(seals), dtype=bool)
        midx = [i for i, m in enumerate(msgs) if self._well_formed_sender(m, height)]
        sidx = [i for i, s in enumerate(seals) if self._well_formed_seal(s)]
        if not midx or not sidx or len(proposal_hash) != 32:
            # Degenerate rounds fall back to the per-phase paths (an empty
            # half would break the split-at-half contract).
            if midx:
                sender_mask, p_ok = self.certify_senders(msgs, height, threshold=prepare_threshold)
            else:
                p_ok = p_thr <= 0
            if sidx:
                seal_mask, s_ok = self.certify_seals(proposal_hash, seals, height)
            else:
                s_ok = seal_thr <= 0
            return sender_mask, p_ok, seal_mask, s_ok

        lanes = max(_bucket(len(midx), _BATCH_BUCKETS), _bucket(len(sidx), _BATCH_BUCKETS))
        prep = self._sender_inputs([msgs[i] for i in midx], pad_lanes=lanes)
        seal = self._seal_inputs(proposal_hash, [seals[i] for i in sidx], pad_lanes=lanes)
        ok, eq = self._mask(tuple(torch.cat([a, b]) for a, b in zip(prep, seal)), table)
        p_reached, _, _ = quorum.power_reduce(ok[:lanes], eq[:lanes], plo, phi, *_threshold(p_thr))
        s_reached, _, _ = quorum.power_reduce(ok[lanes:], eq[lanes:], plo, phi, *_threshold(seal_thr))
        mask = ok.cpu().numpy()
        sender_mask[np.asarray(midx)] = mask[: len(midx)]
        seal_mask[np.asarray(sidx)] = mask[lanes : lanes + len(sidx)]
        return sender_mask, bool(p_reached), seal_mask, bool(s_reached)

    # -- mask-only drains (the BatchVerifier protocol) -----------------

    def verify_senders(self, msgs: Sequence[IbftMessage]) -> np.ndarray:
        """Per-message sender validity, grouped by height, in chunks of at
        most the largest lane bucket."""
        out = np.zeros(len(msgs), dtype=bool)
        by_height: Dict[int, List[int]] = {}
        for i, m in enumerate(msgs):
            if self._well_formed_sender(m, None):
                by_height.setdefault(m.view.height, []).append(i)
        for height, idxs in by_height.items():
            table = self._table_and_addrs(height)[0]
            for start in range(0, len(idxs), _DISPATCH_CAP):
                chunk = idxs[start : start + _DISPATCH_CAP]
                mask, _ = self._mask(self._sender_inputs([msgs[i] for i in chunk]), table)
                out[np.asarray(chunk)] = mask.cpu().numpy()[: len(chunk)]
        return out

    def verify_committed_seals(
        self, proposal_hash: bytes, seals: Sequence[CommittedSeal], height: int
    ) -> np.ndarray:
        """Per-seal validity against ``height``'s validator set."""
        out = np.zeros(len(seals), dtype=bool)
        idxs = [i for i, s in enumerate(seals) if self._well_formed_seal(s)]
        if not idxs or len(proposal_hash) != 32:
            return out
        table = self._table_and_addrs(height)[0]
        for start in range(0, len(idxs), _DISPATCH_CAP):
            chunk = idxs[start : start + _DISPATCH_CAP]
            mask, _ = self._mask(self._seal_inputs(proposal_hash, [seals[i] for i in chunk]), table)
            out[np.asarray(chunk)] = mask.cpu().numpy()[: len(chunk)]
        return out
