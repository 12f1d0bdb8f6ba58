"""BLS aggregate-COMMIT workload builder (BASELINE.md config #4); the port
of ``go_ibft_tpu/bench/bls_workload.py``.

Produces the packed arrays for
:func:`go_ibft_tpu_torch.ops.bls12_381.aggregate_verify_commit`, in the
port's layout (numpy int32 words, :mod:`go_ibft_tpu_torch.ops.bls_fp`),
plus a host baseline timing (the pure-python oracle pairing).  The keys
come from the same seeds as the JAX package's, so
:func:`go_ibft_tpu_torch.convert.bls_point_arrays` of these arrays equals
its packed arrays.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, Tuple

import numpy as np

from ..crypto import bls as hbls
from ..ops import bls12_381 as ops

_key_cache: Dict[Tuple[int, int], list] = {}


def _bls_keys(n: int, seed: int) -> list:
    hit = _key_cache.get((n, seed))
    if hit is None:
        hit = [
            hbls.BLSPrivateKey.from_seed(b"bls-bench-%d-%d" % (seed, i))
            for i in range(n)
        ]
        _key_cache[(n, seed)] = hit
    return hit


@dataclass
class BLSRoundWorkload:
    n_validators: int
    args: tuple  # (pk (V, 2, 12), sig (V, 4, 12), h (4, 12), live (V,)) for aggregate_verify_commit
    host_ms: float  # host oracle single aggregate-verify wall time
    message: bytes = b""  # the 32-byte proposal hash the seals sign
    sigs: tuple = ()  # the seals as host points
    pubkeys: tuple = ()  # the validators' G1 keys as host points


def build_bls_round_workload(
    n_validators: int, *, seed: int = 0, time_host: bool = True
) -> BLSRoundWorkload:
    keys = _bls_keys(n_validators, seed)
    message = b"bls bench proposal hash %d" % seed
    # pad the message to a 32-byte "proposal hash" shape
    message = (message + b"\x00" * 32)[:32]
    sigs = [k.sign(message) for k in keys]
    pubkeys = [k.pubkey for k in keys]

    host_ms = 0.0
    if time_host:
        t0 = time.perf_counter()
        assert hbls.aggregate_verify(
            pubkeys, message, hbls.aggregate_signatures(sigs)
        )
        host_ms = (time.perf_counter() - t0) * 1e3

    v = 1
    while v < n_validators:
        v *= 2
    v = max(v, 2)
    pad = v - n_validators
    pk = ops.pack_g1_points(pubkeys + [None] * pad)
    sig = ops.pack_g2_points(sigs + [None] * pad)
    h = ops.pack_g2_points([hbls.hash_to_g2(message)])[0]
    live = np.zeros(v, dtype=bool)
    live[:n_validators] = True
    return BLSRoundWorkload(
        n_validators=n_validators, args=(pk, sig, h, live), host_ms=host_ms,
        message=message, sigs=tuple(sigs), pubkeys=tuple(pubkeys),
    )
