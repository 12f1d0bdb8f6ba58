"""The yardstick of the recovery kernel: the least time one H100 could take
for a batch's recoveries, and its share of the time the kernel took.

Frozen from ``chip_smoke.py`` (``recover_ops`` and its constants, the
peaks) and ``go_ibft_tpu_torch/bench/lanes.py`` (``glv_halves``).  The
count is the recovery kernel's first version's, kept on purpose as a fixed
measure of the work: whatever kernel later computes the recovery is read
against the same bound.  Lanes that fail the range checks count zero, and
so do padded lanes (a batch's bound is over the lanes' own inputs).

Peaks of one H100 SXM (NVIDIA's data sheet, at its 700 W limit): HBM at
3.35e12 bytes a second, and 32-bit integer operations at 64 results a clock
an SM (NVIDIA's arithmetic-instruction throughput table for compute
capability 9.0) x 132 SMs x 1.98 GHz = 16.7e12 a second.
"""

from __future__ import annotations

from typing import Iterable, Tuple

HBM_BYTES_PER_S = 3.35e12
OPS_PER_S_32BIT = 64 * 132 * 1.98e9

N = 0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEBAAEDCE6AF48A03BBFD25E8CD0364141
_GLV_A1 = 0x3086D221A7D46BCDE86C90E49284EB15
_GLV_B1 = -0xE4437ED6010E88286F547FA90ABFE4C3
_GLV_A2 = 0x114CA50F7A8E2F3F657C1108D9D44CFD8
_GLV_B2 = 0x3086D221A7D46BCDE86C90E49284EB15
_GLV_G1 = (_GLV_B2 * (1 << 384) + N // 2) // N
_GLV_G2 = (-_GLV_B1 * (1 << 384) + N // 2) // N

# 64-bit operations in one Keccak-f round, each two 32-bit operations.
KECCAK_OPS_PER_STATE = 24 * 2 * (20 + 5 + 5 + 25 + 24 + 75 + 1)
# A 256 x 256-bit product: 64 multiply-adds of 32 x 32 -> 64 bits (4 ops
# each); the fold mod P about 64 more; a Montgomery product two passes.
OPS_WIDE_PRODUCT = 64 * 4
OPS_FIELD_MUL = OPS_WIDE_PRODUCT + 64
OPS_MONT_MUL = 2 * OPS_WIDE_PRODUCT
# Field products of a lane that passes the range checks, fixed part, and per
# nonzero window digit of the G, phi(G), R and phi(R) streams.
RECOVER_FIXED_FIELD_MULS = 2 + 329 + 1 + (7 + 13 * 11) + 128 * 7 + 330 + 4
RECOVER_DIGIT_FIELD_MULS = (11, 11, 16, 17)
RECOVER_MONT_MULS = 1 + 328 + 2
RECOVER_WIDE_PRODUCTS = 2 * (2 + 4)
RECOVER_BYTES_PER_LANE = (8 + 20 + 20 + 1) * 4 + (20 + 20 + 5) * 4 + 1  # in + out


def glv_halves(k: int) -> Tuple[int, int]:
    c1 = (k * _GLV_G1 + (1 << 383)) >> 384
    c2 = (k * _GLV_G2 + (1 << 383)) >> 384
    return k - c1 * _GLV_A1 - c2 * _GLV_A2, -c1 * _GLV_B1 - c2 * _GLV_B2


def _ladder_field_muls(halves, costs) -> int:
    return sum(cost * sum(1 for w in range(33) if (abs(h) >> (4 * w)) & 15)
               for h, cost in zip(halves, costs))


def recover_lane_ops(z: int, r: int, s: int, v: int) -> int:
    """32-bit operations one lane's recovery needs (0 where it fails the
    range checks); ``z`` is the digest as a 256-bit integer."""
    if not (0 < r < N and 0 < s < N and v in (0, 1)):
        return 0
    rinv = pow(r, -1, N)
    u1, u2 = (-z) * rinv % N, s * rinv % N
    field_muls = RECOVER_FIXED_FIELD_MULS + _ladder_field_muls(
        glv_halves(u1) + glv_halves(u2), RECOVER_DIGIT_FIELD_MULS)
    return (field_muls * OPS_FIELD_MUL + RECOVER_MONT_MULS * OPS_MONT_MUL
            + RECOVER_WIDE_PRODUCTS * OPS_WIDE_PRODUCT + KECCAK_OPS_PER_STATE)


def bound_s(lane_ops: Iterable[int]) -> float:
    """Least seconds for lanes of these operation counts: the larger of the
    operations at the integer peak and the bytes at HBM bandwidth."""
    ops, lanes = 0, 0
    for o in lane_ops:
        if o:
            ops += o
            lanes += 1
    return max(ops / OPS_PER_S_32BIT, lanes * RECOVER_BYTES_PER_LANE / HBM_BYTES_PER_S)


def lane_ops_of(digest: bytes, sig: bytes) -> int:
    if len(sig) != 65:
        return 0
    return recover_lane_ops(int.from_bytes(digest, "big"), int.from_bytes(sig[:32], "big"),
                            int.from_bytes(sig[32:64], "big"), sig[64])
