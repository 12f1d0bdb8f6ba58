"""Fused batch-verify + voting-power quorum certification in PyTorch.

The port of ``go_ibft_tpu.ops.quorum``: one call takes a round's packed
messages and answers both questions the engine asks — which messages are
valid (the signature recovers to the claimed sender, and the sender is a
validator), and does the valid set reach the voting-power quorum
``floor(2*total/3) + 1``.

Voting powers are split into 16-bit low / 15-bit high int32 halves and
summed separately — exact for per-validator powers < 2**31.  Each validator
counts at most once however many lanes carry it: the reduction runs over
the validator axis, not the message axis.

Word tensors (digests, addresses, the validator table) are ``int32`` bit
patterns of the JAX package's ``uint32`` words (:mod:`go_ibft_tpu_torch.convert`).
"""

from __future__ import annotations

from typing import Tuple

import torch

from .. import _build
from . import ecrecover, keccak_f1600

__all__ = [
    "digest_words",
    "sig_checks_zw",
    "sender_sig_checks",
    "seal_sig_checks",
    "membership_eq",
    "sender_validity",
    "seal_validity",
    "power_reduce",
    "quorum_certify",
    "seal_quorum_certify",
    "round_certify",
    "split_power",
]


def split_power(power: int) -> Tuple[int, int]:
    """Host-side: split a voting power < 2**31 into (lo16, hi15) ints."""
    if not 0 <= power < (1 << 31):
        raise ValueError("device quorum path requires powers < 2**31")
    return power & 0xFFFF, power >> 16


def _recover_address(zw, r, s, v):
    """Recovered address words and ``ok``: one launch of the recovery
    kernel on a CUDA tensor, the plain composition on a CPU tensor."""
    _, _, addr, ok = ecrecover.recover(zw, r, s, v)
    return addr, ok


def digest_words(blocks: torch.Tensor, nblocks: torch.Tensor) -> torch.Tensor:
    """Batched payload digests as little-endian value words ``(B, 8)``.

    A CUDA tensor makes one launch of the ``keccak256_digest`` kernel, which
    writes the value words itself (counted in ``digest_words.launches``); a
    CPU tensor takes the plain version, the sponge then the stream words
    reversed and byte-swapped, as in the JAX package.  No fallback between
    the two: a failed build or launch raises.
    """
    if blocks.device.type == "cuda":
        out = keccak_f1600.launch_digest(blocks, nblocks, value_words=True)
        if nblocks.numel():  # an empty batch launches nothing
            _build.count_launch(digest_words)
        return out
    if blocks.device.type == "cpu":
        return keccak_f1600.digest_words_plain(blocks, nblocks)
    raise ValueError(f"digest_words runs on cuda or cpu, not {blocks.device}")


digest_words.launches = 0


def sig_checks_zw(zw, r, s, v, claimed_w, live):
    """Recovery succeeds AND the recovered address equals the claimed one
    AND the lane is live.  Serves envelope senders (``zw`` = payload
    digests) and committed seals (``zw`` = the proposal hash) alike."""
    addr, ok = _recover_address(zw, r, s, v)
    match = torch.all(addr == claimed_w, dim=-1)
    return ok & match & live


def sender_sig_checks(blocks, nblocks, r, s, v, sender_w, live):
    """Envelope checks from raw blocks (digest + recovery)."""
    return sig_checks_zw(digest_words(blocks, nblocks), r, s, v, sender_w, live)


def seal_sig_checks(hash_zw, r, s, v, signer_w, live):
    """Committed-seal checks: the signed digest is the proposal hash."""
    return sig_checks_zw(hash_zw, r, s, v, signer_w, live)


def membership_eq(sender_w: torch.Tensor, table_w: torch.Tensor) -> torch.Tensor:
    """``(B, V)`` sender-to-validator-row equality matrix."""
    return torch.all(sender_w[:, None, :] == table_w[None, :, :], dim=-1)


def sender_validity(blocks, nblocks, r, s, v, sender_w, table_w, live):
    """Envelope validity mask + the ``(B, V)`` equality matrix."""
    sig_ok = sender_sig_checks(blocks, nblocks, r, s, v, sender_w, live)
    eq = membership_eq(sender_w, table_w)
    return sig_ok & torch.any(eq, dim=-1), eq


def seal_validity(hash_zw, r, s, v, signer_w, table_w, live):
    """Committed-seal validity mask + equality matrix."""
    sig_ok = seal_sig_checks(hash_zw, r, s, v, signer_w, live)
    eq = membership_eq(signer_w, table_w)
    return sig_ok & torch.any(eq, dim=-1), eq


def power_reduce(ok, eq, powers_lo, powers_hi, thr_lo, thr_hi):
    """Exact fused quorum reduction.

    ``ok``: (B,) validity mask; ``eq``: (B, V) sender equality; powers as
    (V,) int32 split halves; the threshold as split halves (ints or 0-d
    tensors; hi may exceed 15 bits).  int32 sums: lo-halves < 2**16 and
    hi-halves < 2**15 over V <= 2**14 validators stay < 2**30; the lo
    carry folds into hi before the compare.  Returns ``(reached, got_lo,
    got_hi)`` with ``got = got_hi*2**16 + got_lo``.
    """
    counted = torch.any(eq & ok[:, None], dim=0)  # (V,) validator counted once
    zero = torch.zeros_like(powers_lo)
    lo = torch.sum(torch.where(counted, powers_lo, zero), dtype=torch.int32)
    hi = torch.sum(torch.where(counted, powers_hi, zero), dtype=torch.int32)
    carry = lo >> 16
    lo = lo & 0xFFFF
    hi = hi + carry
    reached = (hi > thr_hi) | ((hi == thr_hi) & (lo >= thr_lo))
    return reached, lo, hi


def quorum_certify(
    blocks, nblocks, r, s, v, sender_w, table_w, live, powers_lo, powers_hi, thr_lo, thr_hi
):
    """Verify a PREPARE envelope batch AND certify quorum.

    Returns ``(mask, reached, power_lo, power_hi)``.
    """
    ok, eq = sender_validity(blocks, nblocks, r, s, v, sender_w, table_w, live)
    reached, lo, hi = power_reduce(ok, eq, powers_lo, powers_hi, thr_lo, thr_hi)
    return ok, reached, lo, hi


def seal_quorum_certify(
    hash_zw, r, s, v, signer_w, table_w, live, powers_lo, powers_hi, thr_lo, thr_hi
):
    """COMMIT-phase check: seal batch validity + quorum reduction."""
    ok, eq = seal_validity(hash_zw, r, s, v, signer_w, table_w, live)
    reached, lo, hi = power_reduce(ok, eq, powers_lo, powers_hi, thr_lo, thr_hi)
    return ok, reached, lo, hi


def round_certify(
    blocks,
    nblocks,
    pr,
    ps,
    pv,
    sender_w,
    plive,
    hash_zw,
    sr,
    ss,
    sv,
    signer_w,
    slive,
    table_w,
    powers_lo,
    powers_hi,
    thr_lo,
    thr_hi,
):
    """BOTH phases of a round in one batch — the port's main path.

    PREPARE envelopes and COMMIT seals share the recovery ladder, so their
    lanes are concatenated and verified together, then quorum-reduced per
    phase.  The 18 arguments are those of the JAX package's
    ``round_certify`` (:func:`go_ibft_tpu_torch.convert.round_args` builds
    them).  Returns ``(prep_mask, prep_reached, seal_mask, seal_reached)``.
    """
    zw1 = digest_words(blocks, nblocks)
    zw = torch.cat([zw1, hash_zw], dim=0)
    r = torch.cat([pr, sr], dim=0)
    s = torch.cat([ps, ss], dim=0)
    v = torch.cat([pv, sv], dim=0)
    claimed = torch.cat([sender_w, signer_w], dim=0)
    live = torch.cat([plive, slive], dim=0)
    sig_ok = sig_checks_zw(zw, r, s, v, claimed, live)
    eq = membership_eq(claimed, table_w)
    ok = sig_ok & torch.any(eq, dim=-1)
    b = zw1.shape[0]
    prep_ok, seal_ok = ok[:b], ok[b:]
    prep_reached, _, _ = power_reduce(prep_ok, eq[:b], powers_lo, powers_hi, thr_lo, thr_hi)
    seal_reached, _, _ = power_reduce(seal_ok, eq[b:], powers_lo, powers_hi, thr_lo, thr_hi)
    return prep_ok, prep_reached, seal_ok, seal_reached
