"""Drive the PyTorch port's main path on one NVIDIA card and check it.

    python3 chip_smoke.py [--json PATH]

Phases, in order (any failure exits non-zero and prints no result):

1. the card's name and power limit (``nvidia-smi``), torch/CUDA/nvcc versions;
2. build every CUDA kernel from ``go_ibft_tpu_torch/csrc`` (one ``nvcc``
   per source, all at once) and print ptxas' registers and spills;
3. build the signed 100- and 300-validator rounds, then hold each kernel,
   through the wrapper the main path calls, against its plain PyTorch
   version on the card, bit-exact: ``keccak_f1600`` on random states,
   ``keccak256_digest`` in both output forms (value words through
   ``ops.quorum.digest_words``, stream words through
   ``ops.keccak.keccak256_blocks``) at 1, 2, 3, 8 and 32 blocks with ragged
   block counts (0, negative and above the block count among them),
   ``secp256k1_recover`` on the seeded recovery lanes (real signatures plus
   every adversarial lane of ``bench/lanes.py``), each at the batch sizes
   the path uses and beyond, the recovery also against the host oracle;
   then the digest and the recovery on the two rounds' own inputs;
   ``secp256k1_ecmul2`` and ``secp256k1_verify`` (the ``k1*G + k2*Q``
   kernel's two entries) once on ``bench/lanes.py::build_verify_lanes``
   (off-curve keys, ``x = r + N``, out-of-range ``r``/``s``, infinity and
   the scalar edges among them), then ``ops.secp256k1.ecmul2_base`` and
   ``ecdsa_verify`` at 1,024 of those lanes (one launch each, counted from
   0): every row equal to its lane's plain result and, on the curve, to
   the host oracle; and both with one ``(20,)`` key against the 1,024 rows
   (broadcast, as the JAX functions take it) equal to the plain versions;
   ``certify_lanes`` on the three rounds' recovered lanes (phases 4-6's;
   the mask alone, one phase, two, and thresholds at each phase's counted
   power - 1, the power and + 1) and on seeded lanes at every lane bucket
   (two phases of 8 to 2,048 lanes) and table bucket (8 to 2,048 rows):
   duplicate table rows with power, duplicate-sender spam, ``thr_hi`` >=
   2**15; and at the edges of a phase spread over a cluster of 8 blocks
   (``CERTIFY_EDGES``: fewer lanes than blocks, one lane, an empty phase,
   2,049 rows, more lanes a block than threads);
4. certify the 100-validator round (seed 0) through both entry points,
   ``ops.quorum.round_certify`` and ``DeviceBatchVerifier.certify_round``:
   every mask true, both quorums reached, masks equal to the host oracle
   (``crypto.ecdsa.recover_pure``, Python ints); the kernels' launch counts are set to 0
   before these two calls and read after them, and each call made exactly
   one digest launch and one ``certify_lanes`` launch;
5. the 300-validator round with 30 % bad signatures: masks equal the
   expected masks, quorum reached (210 >= 201);
6. a 100-validator round with 34 bad signatures: no quorum;
7. time each kernel at the main path's own inputs (CUDA events) beside its
   plain version and its bound, the digest also at 128 messages of 8 and of
   32 blocks (and its time on the card per launch, profiler), and the
   recovery at 1 to 16,384 lanes;
   ``certify_lanes`` at the two rounds' lanes and at 2 x 2,048 lanes x
   2,048 rows, and its launcher's host time back to back; both entries of
   the ``k1*G + k2*Q`` kernel at 8, 256, 1,024 and 16,384 lanes (the plain
   versions at 8), and the registry's ``ecmul2_base_8l`` call profiled: one
   kernel, no eager ladder; time phases 4-5 with CUDA events and the host clock (median
   of 20 calls after warm-up), and profile one 100-validator call: device
   kernels (fewer than 10,000), launch calls (at most 5), device busy time,
   idle share, and one engine height among 100 validators (the profiler's
   numbers from a process of its own, ``--main-profile``);
8. the engine phase (:func:`engine_phase`): the port's ``IBFT`` finalizing
   real heights with its drains on the card — A: one engine among 100
   validators, 5 heights through ``DeviceBatchVerifier`` (and the same
   schedule through the native ``HostBatchVerifier``, the in-process
   baseline), one more height profiled; B: one engine among 300 validators
   with 30 % Byzantine, 2 heights; C: a 4-validator cluster of port engines
   on loopback gossip, 5 heights with ``AdaptiveBatchVerifier`` at its
   default cutover and 5 with every drain on the card; D: a 4,096-envelope
   ``verify_senders`` in two pipeline chunks against one-chunk calls.
   Every drain's mask equals the committee's honest set, and both kernels
   are held bit-exact against their plain versions on the first inputs of
   each shape the engine gave them.  Any host fallback, breaker trip or
   missing native library fails the run;
9. the chain phase (:func:`chain_phase`), every drain through a
   ``DeviceBatchVerifier`` on the card — E: the commit critical path of one
   engine among 100 validators (``bench/chain.py::commit_critical_path``),
   5 heights without a speculator or the COMMIT early exit, then 5 with
   both; F: a ``ChainRunner`` for one of 100 validators, 32 back-to-back
   heights with a WAL (fsync on), the overlap worker and a speculator, its
   Chrome trace split by span and by ``obs/timeline.py``'s phases, then a
   fresh runner's ``recover()`` from the WAL (height 33, the same blocks)
   and another's catch-up of all 32 heights through ``SyncClient`` in one
   seal drain, and a peer's block with 34 corrupted seals rejected; three
   threads through one verifier, every mask equal to the host oracle; both
   kernels held bit-exact against their plain versions on the first inputs
   of each shape these runs uploaded.  Any fallback, fault, dropped
   speculation lane or finalized seal the oracle rejects fails the run;
10. BLS12-381 on the card (:func:`bls_phase`): the three pairing kernels
   (``bls_merge``, ``bls_miller``, ``bls_final_exp``,
   ``csrc/bls12_381.cu``) held bit-exact against their plain versions (the
   merge launched on G1 and G2 at 1, 2, 3, 8, 128, 129 and 1,024 points x
   1, 7 and 64 groups and at 17 groups of 8, with cancelling, duplicated,
   negated and dead lanes, a sum of infinity with no cancelling pair and a
   single live point, each shape's first four groups against the plain
   version and every group of up to 8 points against the host oracle; the
   Miller loops at 2 and 64 lanes; the final exponentiation at 1 and 64), a
   few lanes also against
   ``crypto.bls`` (the pairing ratio cubed); config #4 (one
   100-validator aggregate COMMIT check: verdict, median of 20 calls, one
   host-oracle call, a profiled call in a process of its own,
   ``--bls-profile``); config #9's Byzantine mix (100
   seals, 1 and 5 corrupted) through ``BLSAggregateVerifier``; config
   #13's 64 certificates through ``BLSCertifier.verify_many`` against the
   per-certificate loop, a relabeled and a bit-flipped one rejected, and
   the kernels at 64 and 1,024 lanes; a chain of ``HybridBLSBackend``
   engines (16 validators, 8 heights) whose ``ChainRunner`` writes a
   certificate record a height (WAL fsync on), then ``recover()``, a sync
   of the 8 heights in one ``verify_many`` and a relabeled certificate
   rejected.  Any fallback or verdict that differs from the oracle fails;
11. the multi-tenant and read planes on the card (:func:`serving_phase`),
   every scheduler flush on the device route: (a) config #10's 8
   committees of 4-8 validators and one of 100 drain a round's PREPARE
   senders (an oversize PREPREPARE among them) and COMMIT seal lanes from a
   thread each through one ``TenantScheduler``, every mask against the
   tenant's host oracle, then config #10's 8 ``ChainRunner`` chains of 3
   heights, concurrently and serially; (b) config #12's proof serving (a
   finalized 100-validator chain, 24 clients): every served verdict against
   ``HostBatchVerifier`` lane for lane, a tampered proof rejected, cold
   against warm cache, coalesced against per-client sequential, and a live
   4-validator chain missing no height under a proof flood; (c) config
   #18: an HTTP cold sync (``ProofApiServer`` to ``CheckpointClient``) of a
   16-height chain with a rotation, ``CheckpointVerifier(device=True)`` on
   the card, in at most 4 pairing dispatches, the spliced-diff attack
   rejected, and the million-height structural sync.  Any flush fault, shed
   lane, host-routed flush, fallback, breaker trip, mask that differs from
   its oracle or missed height fails the run; the digest and recovery
   kernels are held bit-exact against their plain versions on the first
   coalesced inputs of each shape;
12. the mesh and the lock-step cluster on the card (:func:`cluster_phase`):
   (a) the 100- and 300-validator rounds through the sharded certify
   (``parallel.mesh_quorum_certify`` / ``mesh_seal_quorum_certify`` at vp 1
   and 2) and a ``MeshBatchVerifier`` over 4 shards of the card (and over
   every card when there are two or more): masks, verdicts and lo/hi equal
   one device's and the host oracle's, a drain makes a recovery and a
   ``certify_lanes`` launch a shard, a sharded certify one ``certify_lanes``
   launch, a mesh ``certify_round`` one a shard a phase, ``certify_round``
   timed beside the single device's (and one profiled in the
   ``--main-profile`` process, its device events in order); a
   ``CoalescedDispatcher`` on the mesh route; (b) config #15: 100
   sim-crypto validators x 5 heights lock-step against loopback on one card
   and on 4 shards, every chain ``sim_block(h)``, the 1,000-validator tick
   in one ``ici_tick`` dispatch; (c) 100 real-ECDSA validators x 3 heights
   on a hub whose ``DeviceBatchVerifier`` drains every tick's gathered rows
   (one shard, then 4), chains equal to a loopback run on the host
   verifier, digest and recovery launches a tick and a height; (d) config
   #16: 100 validators over ``wan3`` clean and with the 30 %-power
   adversary mix, 2 heights each, invariants, liveness and the SLO gate,
   and its CHAOS-REPLAY line.  Any fallback, mask or chain that differs,
   or failing gate fails the run; the digest and recovery kernels are held
   bit-exact against their plain versions at a mesh shard's and a tick
   shard's shapes;
13. the validator process on the card (:func:`validator_phase`): (a) two
   real restarts (``python -m go_ibft_tpu_torch.boot`` children on one
   fresh kernel build cache, every registry family restored on the card,
   then one height of a 3-validator cluster verifying on the card): the cold
   leg pays the ``nvcc`` builds, the cached leg reports zero cold programs
   and zero compile events, and each leg's ``ecmul2_base_8l`` time and
   status is printed; (b) ``ChainRunner.warm_start`` over a WAL of 8
   finalized 100-validator heights with a scheduler handle on the card: the
   main path's four families and ``ecmul2_base_8l`` restored (one
   ``secp256k1_ecmul2`` launch), height 8 recovered, a verdict seeded
   a WAL seal, those seals re-verified with no launch, the kernels held at
   the registry's inputs; (c) where ``grpc`` imports, 4 ``python -m
   go_ibft_tpu_torch.node`` processes on the card under ``sim/fleet.py``'s
   client flood and adversaries: no missed height or diverged chain, every
   slowloris socket cut, every node's scheduler on the device route with
   no host-routed flush, fault, refusal or shed, and one ``/profilez``
   window a node holding recovery or digest kernels; (d) the card probe
   names this card and its count;
14. print the ``kernels`` line (each kernel's ``ms`` is CUDA events over
   back-to-back launches; ``device_ms_per_launch`` its time on the card per
   launch, from the profiler; ``launches`` phase 4's count (config #4's for
   the BLS kernels), ``engine_launches`` engine run A's over its 5 heights,
   ``chain_launches`` chain run F's over its 32, ``bls_launches`` one
   config-#4 call's, ``bls_chain_launches_per_height`` phase 10's chain's,
   ``serving_launches`` phase 11's, ``mesh_launches`` phase 12 (a)'s,
   ``cluster_launches`` phase 12 (c)'s and ``boot_launches`` phase 13
   (b)'s; the ``k1*G + k2*Q`` kernel's entries are on none of those paths
   but their own, so their ``launches`` is ``secp256k1_ecmul2``'s boot
   count, phase 13 (b)'s, and ``secp256k1_verify``'s count of phase 3's
   ``ecdsa_verify`` at 1,024 lanes), then the result line.

``--digest-only`` runs none of this: it times ``ops.quorum.digest_words``
and the recovery kernel of whichever ``go_ibft_tpu_torch`` comes first on
the import path, so that two checkouts are timed by the same code in one
call (``digest_only`` below); ``--bls-kernels-only`` does the same for the
BLS kernels (``bls_kernels_only``), ``--ecmul2-only`` for both entries of
the ``k1*G + k2*Q`` kernel (``ecmul2_only``), and ``--main-path-ab`` for phase 4's
``certify_round`` and engine run A (``main_path_ab``).  ``--main-profile`` and
``--bls-profile`` only profile phase 7's kernels and calls (``main_profile``)
and config #4's BLS kernels and one check (``bls_profile``); phases 7 and
10 run them.  ``--main-profile`` also times ``certify_lanes``' launcher and
profiles a mesh ``certify_round``, and like ``--main-path-ab`` takes the
package first on the import path, so two checkouts can be compared in turn.

It imports nothing of JAX or of the JAX package.  It needs one card and
exits non-zero where ``torch.cuda.is_available()`` is false.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import statistics
import subprocess
import sys
import time

import torch

# H100 SXM peaks: HBM bandwidth (NVIDIA data sheet), and the rate of 32-bit
# integer operations, which every kernel here is made of: 64 results per
# clock per SM for a 32-bit integer add, multiply-add, shift or logic
# operation on compute capability 9.0 (the CUDA C++ Programming Guide's
# arithmetic-instruction throughput table; FP32 has 128, which with an FMA
# counted as two is the data sheet's 67 TFLOP/s), x 132 SMs x 1.98 GHz (the
# data sheet's boost clock): 16.7e12 a second.
HBM_BYTES_PER_S = 3.35e12
OPS_PER_S_32BIT = 64 * 132 * 1.98e9

# Batch sizes held bit-exact: the main path's (payload digests of the 100-
# and 300-validator rounds: 128 and 512 messages; recovery: 256 and 1024
# lanes; the engine's drains: 8, 128 and 512 lanes) and ragged ones.  Phase 8
# also holds both kernels on the engine's own inputs.
KECCAK_BATCHES = (1, 128, 129, 256, 512, 1024, 4096)
DIGEST_BATCHES = (1, 8, 33, 128, 129, 512, 1024)
# The verifier's block buckets are 2, 8 and 32; 1 and 3 are ragged.
DIGEST_BLOCKS = (1, 2, 3, 8, 32)
# Digest shapes timed beyond the rounds' own (128 and 512 messages of 2
# blocks): a payload of 8 and of 32 blocks, such as a PREPREPARE carrying a
# round-change certificate.
DIGEST_LONG = ((128, 8), (128, 32))
DIGEST_TIMED = ((128, 2), (512, 2)) + DIGEST_LONG
RECOVER_BATCHES = (1, 8, 33, 128, 256, 512, 1024)
TIMED_BATCHES = (128, 256, 1024, 4096)
# Lane counts of the recovery sweep in phase 7: where the kernel stops being
# bound by one lane's chain.
SWEEP_LANES = (1, 256, 1024, 4096, 16384)
# 64-bit operations in one Keccak-f round: theta (20 xor + 5 rot + 5 xor +
# 25 xor), rho (24 rot), chi (25 x not/and/xor), iota (1 xor); each is two
# 32-bit operations.
KECCAK_OPS_PER_STATE = 24 * 2 * (20 + 5 + 5 + 25 + 24 + 75 + 1)
KECCAK_BYTES_PER_STATE = 2 * 25 * 8  # read once, written once
# 32-bit integer operations of one recovery, counted from the source of the
# recovery kernel's first version (Fermat powers, one 4-bit Straus ladder
# over G, phi(G), R and phi(R)), smaller terms (field additions, selects)
# left out.  The count stays as it was on purpose: it is a fixed yardstick
# of the work, so that an older kernel and a redesigned one (which does less
# of it) are read against the same bound.  A 256 x 256-bit product is 64
# multiply-adds of 32 x 32 -> 64 bits, each a multiply (2 ops) and a 64-bit
# add (2 ops); the fold mod P adds about 64 more; a Montgomery product mod N
# is two such product passes.
OPS_WIDE_PRODUCT = 64 * 4
OPS_FIELD_MUL = OPS_WIDE_PRODUCT + 64
OPS_MONT_MUL = 2 * OPS_WIDE_PRODUCT
# Field multiplications of a lane that passes the range checks, fixed part:
# y^2 (2), the square root (14 table + 252 squarings + 63 window products),
# its check (1), d*R for d <= 15 (a doubling of 7 and 13 mixed additions of
# 11), 128 ladder doublings of 7, the inversion of Z (14 + 252 + 64) and the
# affine map (4).  Each nonzero window digit adds a mixed addition (11) for
# the G and phi(G) streams, a Jacobian addition (16) for R and 17 for phi(R).
RECOVER_FIXED_FIELD_MULS = 2 + 329 + 1 + (7 + 13 * 11) + 128 * 7 + 330 + 4
RECOVER_DIGIT_FIELD_MULS = (11, 11, 16, 17)
# r to Montgomery form (1), r^-1 (14 + 252 + 62), u1 and u2 (2); two GLV
# splits of 2 wide products and 4 low products each.
RECOVER_MONT_MULS = 1 + 328 + 2
RECOVER_WIDE_PRODUCTS = 2 * (2 + 4)
RECOVER_BYTES_PER_LANE = (8 + 20 + 20 + 1) * 4 + (20 + 20 + 5) * 4 + 1  # in + out
# The k1*G + k2*Q kernel, counted in the same units by what its entries
# need, not by the recovery's first version: k1*G by the comb, a mixed
# addition (11) for each nonzero byte of k1 after the first (which lands on
# infinity) and no doubling; k2's one GLV split (2 wide products and 4 low
# products); d*Q for d <= 15 (a doubling of 7 and 13 mixed additions of 11);
# one Straus ladder over Q and phi(Q) sharing 128 doublings of 7, each
# nonzero window digit of k2's halves a Jacobian addition (16 for Q, 17 for
# phi(Q)); the two merges (16 each).  The verification adds s^-1 by safegcd,
# s^-1 to Montgomery form, u1 and u2 (3 Montgomery products), Z^-1 by
# safegcd and x (2 field products); a lane that fails its range checks needs
# none of it.  One safegcd inversion is 20 rounds of 30 branch-free divsteps
# (27 operations each) and the updates of (d, e) mod M and of (f, g), 9
# signed 30-bit limbs each of 6 and of 4 multiply-adds (4 operations) and
# two masked 64-bit shifts (3); its normalisation is left out.  Bytes: 4
# inputs and 3 outputs of 20 limbs (verify: 5 inputs and a byte).
OPS_SAFEGCD = 20 * (30 * 27 + 9 * (6 * 4 + 2 * 3) + 9 * (4 * 4 + 2 * 3))
ECMUL2_FIXED_FIELD_MULS = (7 + 13 * 11) + 128 * 7 + 2 * 16
ECMUL2_COMB_FIELD_MULS = 11
ECMUL2_DIGIT_FIELD_MULS = (16, 17)
ECMUL2_WIDE_PRODUCTS = 2 + 4
VERIFY_FIELD_MULS = 2
VERIFY_MONT_MULS = 3
VERIFY_SAFEGCDS = 2
ECMUL2_BYTES_PER_LANE = (4 + 3) * 20 * 4
VERIFY_BYTES_PER_LANE = 5 * 20 * 4 + 1
# Lane counts at which both entries are timed: the boot registry's 8, the
# recovery's main-path sizes, and 16,384, where the card's throughput and
# not one lane's chain sets the time.
ECMUL2_LANES = (8, 256, 1024, 16384)
ECMUL2_ARGS = ("k1", "k2", "qx", "qy")
VERIFY_ARGS = ("qx", "qy", "z", "r", "s")
# certify_lanes: the verifier's lane buckets (a phase's lanes) and table
# buckets (verify/batch.py), each held with seeded lanes in two phases; the
# worst, 2 x 2,048 lanes against 2,048 rows, is also timed.
CERTIFY_LANES = (8, 32, 128, 512, 1024, 2048)
CERTIFY_ROWS = (8, 128, 512, 2048)
CERTIFY_WORST = (2048, 2048)
# certify_lanes runs a phase on a cluster of 8 blocks: its edges, as (lanes,
# rows, split) with two phases split there (None: one phase), each also held
# as the mask alone.  A phase with fewer lanes than blocks, one lane, an
# empty phase (split at 0 and at n), a second table tile of one row, and
# more lanes a block than a block has threads.
CERTIFY_EDGES = ((10, 64, 3), (1, 8, None), (1, 8, 1), (40, 128, 0), (40, 128, 40), (96, 2049, 48),
                 (8400, 8, 4200))


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


_T0 = time.perf_counter()


def log(msg: str) -> None:
    print(f"{msg}  (+{time.perf_counter() - _T0:.0f}s)", flush=True)


def gpu_identity() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    return out.splitlines()[0]


def cuda_time_ms(fn, reps: int) -> float:
    """Mean time of ``fn()`` on the card over ``reps`` back-to-back calls."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def once_ms(fn) -> float:
    """CUDA-event time of one ``fn()`` (already warmed up)."""
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def median_ms(fn, calls: int, warmup: int = 1):
    """Median host-clock and CUDA-event time of ``fn()`` (which syncs)."""
    for _ in range(warmup):
        fn()
    host, dev = [], []
    for _ in range(calls):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        start.record()
        fn()
        end.record()
        end.synchronize()
        host.append((time.perf_counter() - t0) * 1e3)
        dev.append(start.elapsed_time(end))
    return statistics.median(host), statistics.median(dev)


def profile_call(fn, ordered: bool = False) -> dict:
    """Device kernels, runtime launch calls and device busy time of one
    ``fn()`` under ``torch.profiler``, and each kernel name's device time
    (and, where ``ordered``, every device event's name and time in launch
    order).  The session opens with a ``torch.cuda._sleep`` kernel, waited
    for, so that the card's activity is being collected before ``fn()``
    launches its first kernel.  Every event that starts before the later
    of its end and the end of the session's first ``cudaDeviceSynchronize``
    (its own wait) is left out of the counts; ``warmup_recorded`` says
    whether the profiler recorded the kernel itself."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels, launches, by_name, count_by_name, events = 0, 0, {}, {}, []
    evts = list(prof.events())
    spin = [evt.time_range.end for evt in evts if "spin_kernel" in evt.name]
    syncs = sorted(evt.time_range.end for evt in evts if evt.name == "cudaDeviceSynchronize")
    warm_end = max(spin + syncs[:1], default=None)
    for evt in evts:
        if warm_end is not None and evt.time_range.start <= warm_end:
            continue
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            kernels += 1
            by_name[evt.name] = by_name.get(evt.name, 0.0) + evt.time_range.elapsed_us() / 1e3
            count_by_name[evt.name] = count_by_name.get(evt.name, 0) + 1
            events.append((evt.time_range.start, evt.name, evt.time_range.elapsed_us() / 1e3))
        elif evt.name in ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC"):
            launches += 1
    extra = {"events": [(name, ms) for _, name, ms in sorted(events)]} if ordered else {}
    return {
        **extra,
        "device_kernels": kernels,
        "launch_calls": launches,
        "device_busy_ms": sum(by_name.values()),
        "profiled_wall_ms": wall_ms,
        "by_name_ms": by_name,
        "count_by_name": count_by_name,
        "warmup_recorded": bool(spin),
    }


def per_launch_ms(prof: dict, kernel: str) -> float:
    """Mean time on the card of the profiled kernels whose name holds
    ``kernel``, over the launches the profiler recorded."""
    names = [name for name in prof["by_name_ms"] if kernel in name]
    count = sum(prof["count_by_name"][name] for name in names)
    check(count > 0, f"the profiler recorded {kernel}")
    return sum(prof["by_name_ms"][name] for name in names) / count


def bound(nbytes: int, ops: int) -> dict:
    """The least time for ``nbytes`` moved and ``ops`` 32-bit operations."""
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / OPS_PER_S_32BIT * 1e3
    return {"bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}


def ladder_field_muls(halves, costs) -> int:
    """Field products of a 4-bit ladder's additions over the signed GLV
    ``halves``: one a nonzero window digit of each, at its stream's cost."""
    return sum(cost * sum(1 for w in range(33) if (abs(h) >> (4 * w)) & 15)
               for h, cost in zip(halves, costs))


def digit_field_muls(u1: int, u2: int, glv_halves) -> int:
    """Field products of the recovery ladder's additions for scalars ``u1``
    (of G) and ``u2`` (of R)."""
    return ladder_field_muls(glv_halves(u1) + glv_halves(u2), RECOVER_DIGIT_FIELD_MULS)


def comb_field_muls(k: int) -> int:
    """Field products of ``k*G`` by the comb: a mixed addition for each
    nonzero byte of ``k`` after the first."""
    nonzero = sum(1 for w in range(32) if (k >> (8 * w)) & 255)
    return ECMUL2_COMB_FIELD_MULS * max(nonzero - 1, 0)


def recover_ops(z, r, s, v, n_order, glv_halves) -> int:
    """32-bit operations the recovery of these lanes needs (Python ints):
    lanes that fail the range checks need none; the ladder's additions
    follow each lane's own window digits."""
    field_muls = mont_muls = wide = perms = 0
    for zi, ri, si, vi in zip(z, r, s, v):
        if not (0 < ri < n_order and 0 < si < n_order and vi in (0, 1)):
            continue
        rinv = pow(ri, -1, n_order)
        u1, u2 = (-zi) * rinv % n_order, si * rinv % n_order
        field_muls += RECOVER_FIXED_FIELD_MULS + digit_field_muls(u1, u2, glv_halves)
        mont_muls += RECOVER_MONT_MULS
        wide += RECOVER_WIDE_PRODUCTS
        perms += 1
    return (field_muls * OPS_FIELD_MUL + mont_muls * OPS_MONT_MUL + wide * OPS_WIDE_PRODUCT
            + perms * KECCAK_OPS_PER_STATE)


def ecmul2_work(lanes, rows, verify: bool, n_order, glv_halves) -> dict:
    """The bound of one ``secp256k1_ecmul2`` (or, ``verify``,
    ``secp256k1_verify``) launch over ``rows`` of ``lanes`` (a
    ``bench/lanes.py::VerifyLanes``): bytes and 32-bit operations, the
    comb's and the ladder's additions following each row's own bytes and
    window digits."""
    field_muls = mont_muls = wide = inversions = 0
    for i in rows:
        if verify:
            r, s = lanes.r[i], lanes.s[i]
            if not (0 < r < n_order and 0 < s < n_order):
                continue
            w = pow(s, -1, n_order)
            k1, k2 = lanes.z[i] * w % n_order, r * w % n_order
            field_muls += VERIFY_FIELD_MULS
            mont_muls += VERIFY_MONT_MULS
            inversions += VERIFY_SAFEGCDS
        else:
            k1, k2 = lanes.k1[i] % n_order, lanes.k2[i] % n_order
        field_muls += (ECMUL2_FIXED_FIELD_MULS + comb_field_muls(k1)
                       + ladder_field_muls(glv_halves(k2), ECMUL2_DIGIT_FIELD_MULS))
        wide += ECMUL2_WIDE_PRODUCTS
    nbytes = len(rows) * (VERIFY_BYTES_PER_LANE if verify else ECMUL2_BYTES_PER_LANE)
    return bound(nbytes, field_muls * OPS_FIELD_MUL + mont_muls * OPS_MONT_MUL
                 + wide * OPS_WIDE_PRODUCT + inversions * OPS_SAFEGCD)


def verify_inputs(lanes, batch, dev, labels=None) -> dict:
    """``lanes.arrays(batch, labels)`` as contiguous int32 tensors on
    ``dev``, and ``lane``, each row's lane."""
    import numpy as np

    arr = lanes.arrays(batch, labels)
    out = {k: torch.from_numpy(np.ascontiguousarray(arr[k])).to(dev) for k in set(ECMUL2_ARGS + VERIFY_ARGS)}
    out["lane"] = arr["lane"]
    return out


def ecmul2_holds(report: dict, err: dict, dev, rows: int = 1024):
    """Phase 3's holds of the k1*G + k2*Q kernel: both entries against their
    plain versions on ``bench/lanes.py::build_verify_lanes``' lanes once
    (the plain ladder is eager: slow on the card), then the port's entry
    points ``ops.secp256k1.ecmul2_base`` and ``ecdsa_verify`` at ``rows``
    rows of the same lanes, their launches counted from 0 (one each), every
    row against its lane's plain result and, on the curve, the host oracle.
    Updates ``err``; returns the lanes and the counts.  On the CPU (``dev``)
    the wrappers take the plain versions and no count is checked."""
    from go_ibft_tpu_torch.bench import build_verify_lanes
    from go_ibft_tpu_torch.ops import ecverify
    from go_ibft_tpu_torch.ops import fields as tf
    from go_ibft_tpu_torch.ops import secp256k1 as sec

    def points(pt):
        """Per lane ``None`` at infinity, else the affine point as ints;
        and the canonical affine limbs and the infinity flag."""
        x, y = sec.to_affine(pt)
        inf = sec.is_infinity(pt)
        return [None if i else xy for i, xy in zip(inf.tolist(), zip(tf.from_limbs(x), tf.from_limbs(y)))], (x, y, inf)

    def exact(out, ref, what):
        check(torch.equal(out, ref), what)
        return int((out.to(torch.int64) - ref.to(torch.int64)).abs().max()) if out.numel() else 0

    t0 = time.perf_counter()
    lanes = build_verify_lanes(8, seed=0)
    ins = verify_inputs(lanes, None, dev)
    got = points(ecverify.ecmul2(*(ins[k] for k in ECMUL2_ARGS)))[1]
    plain_points, ref = points(ecverify.ecmul2_plain(*(ins[k] for k in ECMUL2_ARGS)))
    exact(got[2], ref[2], "secp256k1_ecmul2 kernel == plain: infinity")
    for part in (0, 1):
        err["secp256k1_ecmul2"] = max(err["secp256k1_ecmul2"], exact(
            got[part][~ref[2]], ref[part][~ref[2]], f"secp256k1_ecmul2 kernel == plain: {'xy'[part]}"))
    plain_masks = ecverify.verify_plain(*(ins[k] for k in VERIFY_ARGS))
    err["secp256k1_verify"] = max(err["secp256k1_verify"], exact(
        ecverify.verify(*(ins[k] for k in VERIFY_ARGS)), plain_masks, "secp256k1_verify kernel == plain"))
    plain_masks = plain_masks.tolist()
    hold_s = time.perf_counter() - t0
    oracle_points, oracle_masks = lanes.expected_points(), lanes.expected_masks()
    big = verify_inputs(lanes, rows, dev)
    ecverify.ecmul2.launches = ecverify.verify.launches = 0
    masks = sec.ecdsa_verify(*(big[k] for k in VERIFY_ARGS)).tolist()
    pts = points(sec.ecmul2_base(*(big[k] for k in ECMUL2_ARGS)))[0]
    path = {"secp256k1_ecmul2": ecverify.ecmul2.launches, "secp256k1_verify": ecverify.verify.launches}
    if dev.type == "cuda":
        check(path == {"secp256k1_ecmul2": 1, "secp256k1_verify": 1},
              f"ecmul2_base and ecdsa_verify at {rows} lanes: one launch each ({path})")
    for row, lane in enumerate(big["lane"]):
        what = f"lane {lanes.labels[lane]!r}, row {row} of {rows}"
        check(pts[row] == plain_points[lane] and masks[row] == plain_masks[lane],
              f"ecmul2_base and ecdsa_verify on {dev} == plain, {what}")
        if lane in oracle_masks:
            check(pts[row] == oracle_points[lane] and masks[row] == oracle_masks[lane],
                  f"ecmul2_base and ecdsa_verify on {dev} == host oracle, {what}")
    report["verify_path_launches"] = path
    # A broadcast call, as the JAX functions take one: row 0's key against
    # every row's scalars and signature, against the plain versions of the
    # same key on each lane.
    k0 = big["lane"][0]
    key = (ins["qx"][k0], ins["qy"][k0])
    ref_masks = ecverify.verify_plain(*key, ins["z"], ins["r"], ins["s"]).tolist()
    ref_points = points(ecverify.ecmul2_plain(ins["k1"], ins["k2"], *key))[0]
    b_masks = sec.ecdsa_verify(*key, big["z"], big["r"], big["s"]).tolist()
    b_points = points(sec.ecmul2_base(big["k1"], big["k2"], *key))[0]
    for row, lane in enumerate(big["lane"]):
        check(b_masks[row] == ref_masks[lane] and b_points[row] == ref_points[lane],
              f"ecdsa_verify and ecmul2_base with one (20,) key on {dev} == plain, lane "
              f"{lanes.labels[lane]!r}, row {row}")
    log(f"[3] secp256k1_ecmul2 and secp256k1_verify bit-exact against plain on {len(lanes)} lanes "
        f"({', '.join(sorted(set(lanes.labels)))}; plain on {dev} {hold_s:.1f} s), and "
        f"ecmul2_base/ecdsa_verify at {rows} rows == plain and the host oracle ({sum(masks)} verify); "
        f"launches {path}; one (20,) key against the {rows} rows == plain ({sum(b_masks)} verify)")
    return lanes, path


def host_masks(rnd, ecdsa, keccak256, height):
    """The host oracle's masks: recover each lane with Python ints
    (``recover_pure``, never the native library)."""
    members = {bytes(m.sender) for m in rnd.prepares}
    prep = []
    for m in rnd.prepares:
        sig = m.signature
        pub = ecdsa.recover_pure(
            keccak256(m.encode(include_signature=False)),
            int.from_bytes(sig[:32], "big"), int.from_bytes(sig[32:64], "big"), sig[64],
        )
        prep.append(pub is not None and ecdsa.pubkey_to_address(*pub) == m.sender
                    and m.sender in members and m.view.height == height)
    seal = []
    for s in rnd.seals:
        sig = s.signature
        pub = ecdsa.recover_pure(
            rnd.proposal_hash, int.from_bytes(sig[:32], "big"),
            int.from_bytes(sig[32:64], "big"), sig[64],
        )
        seal.append(pub is not None and ecdsa.pubkey_to_address(*pub) == s.signer
                    and s.signer in members)
    return prep, seal


def main_path_inputs(rargs, quorum):
    """The inputs the main path gives the kernels in ``round_certify(*rargs)``:
    the payload blocks and block counts, and the recovery lanes of both
    phases (digest words, then the proposal hash)."""
    blocks, counts = rargs[0], rargs[1]
    zw = torch.cat([quorum.digest_words(blocks, counts), rargs[7]])
    r, s, v = (torch.cat([rargs[i], rargs[i + 6]]) for i in (2, 3, 4))
    return blocks, counts, zw, r, s, v


def certify_case(n: int, rows: int, seed: int, dev):
    """Seeded ``certify_lanes`` inputs on ``dev``: members, outsiders,
    failed and wrong recoveries, dead lanes, duplicate-sender spam (the last
    quarter of the lanes repeat the first), table rows 1..4 copies of row 0
    (each with its own power) and powers up to 2**31 - 1, so that a phase's
    power passes 2**31 and thresholds near it have ``thr_hi`` >= 2**15."""
    import numpy as np

    rng = np.random.default_rng(seed)
    table = rng.integers(0, 2**32, size=(rows, 5), dtype=np.uint32)
    table[1:5] = table[0]
    powers = rng.integers(1, 2**31, size=rows)
    claimed = table[rng.integers(0, rows, size=n)]
    outsider = rng.random(n) < 0.1
    claimed[outsider] = rng.integers(0, 2**32, size=(int(outsider.sum()), 5), dtype=np.uint32)
    claimed[n - n // 4:] = claimed[:n // 4]
    addr = claimed.copy()
    addr[rng.random(n) < 0.05, 2] ^= np.uint32(1)
    ok, live = rng.random(n) < 0.9, rng.random(n) < 0.95
    words = [torch.from_numpy(a.view(np.int32)).to(dev) for a in (addr, claimed, table)]
    halves = [torch.from_numpy(a.astype(np.int32)).to(dev) for a in (powers & 0xFFFF, powers >> 16)]
    return (words[0], torch.from_numpy(ok).to(dev), words[1], torch.from_numpy(live).to(dev), words[2], *halves)


def certify_inputs(rargs, quorum, ecrecover):
    """The inputs ``round_certify(*rargs)`` gives ``certify_lanes``: the
    recovery kernel's addresses and ``ok`` over both phases' lanes, the
    claimed addresses, the live lanes, the table and the powers; and its
    thresholds (both phases the round's) and split."""
    zw, r, s, v = main_path_inputs(rargs, quorum)[2:]
    _, _, addr, ok = ecrecover.recover(zw, r, s, v)
    claimed, live = torch.cat([rargs[5], rargs[11]]), torch.cat([rargs[6], rargs[12]])
    return (addr, ok, claimed, live, *rargs[13:16]), [(rargs[16], rargs[17])] * 2, rargs[5].shape[0]


def edge_thresholds(plain_out):
    """Each phase's thresholds at its counted power - 1, the power and + 1,
    as (lo, hi) halves, from the plain version's ``(mask, reached, lo,
    hi)``."""
    gots = [int(h) * 65536 + int(low) for low, h in zip(plain_out[2].tolist(), plain_out[3].tolist())]
    return [[((g + d) & 0xFFFF, (g + d) >> 16) for g in gots] for d in (-1, 0, 1)]


def certify_work(args, phases: int) -> tuple:
    """Bytes ``certify_lanes`` must move (each input read once, each output
    written once) and the 32-bit operations these inputs need: 5 word
    compares a recovered live lane, then each signed lane's first word
    against every row and 4 more words on the rows whose first word is
    equal (all rows: every equal row counts), 2 adds a counted row."""
    import numpy as np

    addr, ok, claimed, live, table = (t.cpu().numpy() for t in args[:5])
    n, rows = ok.shape[0], table.shape[0]
    signed = ok & live & (addr == claimed).all(-1)
    first = claimed[signed, None, 0] == table[None, :, 0]
    counted = (claimed[signed, None, :] == table[None, :, :]).all(-1).any(0).sum()
    ops = 5 * int((ok & live).sum()) + int(signed.sum()) * rows + 4 * int(first.sum()) + 2 * int(counted)
    nbytes = n * (2 * 5 * 4 + 2) + rows * (5 * 4 + 2 * 4) + n + phases * (1 + 4 + 4)
    return nbytes, ops


def no_host_fallback(what: str) -> None:
    """Fail if anything fell back to the host or tripped the breaker."""
    from go_ibft_tpu_torch.utils import metrics

    bad = {k: metrics.get_counter(("go-ibft",) + k) for k in (
        ("resilient", "certify_fallback"), ("resilient", "drain_faults"),
        ("resilient", "quarantined_lanes"), ("breaker", "demote"), ("breaker", "probe"))}
    check(not any(bad.values()), f"{what}: no host fallback and no breaker trip ({bad})")


def drain_counts() -> dict:
    """The card's drains so far: envelope drains and early-exit seal drains."""
    from go_ibft_tpu_torch.utils import metrics
    from go_ibft_tpu_torch.verify.batch import EARLY_EXIT_DRAINS_KEY

    return {"verify_senders": len(metrics.get_histogram(("go-ibft", "device", "verify_senders_ms"))),
            "verify_seals_early_exit": metrics.get_counter(EARLY_EXIT_DRAINS_KEY)}


def checked_verifier(kept: dict):
    """The card's verifier as the engine and the chain drive it: each
    drain's mask against the signatures the committee corrupted
    (``corrupted``), and the first inputs with live lanes of each shape that
    a dispatch gives the two kernels kept in ``kept``.  The drains upload
    one packed chunk per dispatch, so ``dispatches`` counts uploads."""
    import numpy as np

    from go_ibft_tpu_torch.verify import DeviceBatchVerifier
    from go_ibft_tpu_torch.verify.batch import _as_signed

    class Checked(DeviceBatchVerifier):
        def __init__(self, src, corrupted=None):
            super().__init__(src)
            # The committee's own set: its schedules add to it as they sign.
            self.corrupted = corrupted if corrupted is not None else set()
            self.dispatches = 0

        def _upload(self, slot, lanes, tag=""):
            ins = super()._upload(slot, lanes, tag)
            self.dispatches += 1
            if lanes.live.any():  # not a warm-up's dead lanes
                key = ("secp256k1_recover", tuple(ins[3].shape))
                if key not in kept:
                    kept[key] = tuple(t.clone() for t in ins[:4])
                key = ("keccak256_digest", lanes.blocks.shape) if hasattr(lanes, "blocks") else None
                if key is not None and key not in kept:
                    kept[key] = tuple(torch.from_numpy(_as_signed(a)).to(self.device)
                                      for a in (lanes.blocks, lanes.counts))
            return ins

        def _honest(self, items):
            return np.array([x.signature not in self.corrupted for x in items], dtype=bool)

        def verify_senders(self, msgs):
            mask = super().verify_senders(msgs)
            check(np.array_equal(mask, self._honest(msgs)),
                  f"a {len(msgs)}-envelope drain's mask == the honest set")
            return mask

        def verify_committed_seals(self, proposal_hash, seals, height):
            mask = super().verify_committed_seals(proposal_hash, seals, height)
            check(np.array_equal(mask, self._honest(seals)),
                  f"a {len(seals)}-seal drain's mask == the honest set")
            return mask

        def verify_seal_lanes(self, lanes, height):
            mask = super().verify_seal_lanes(lanes, height)
            check(np.array_equal(mask, self._honest([seal for _, seal in lanes])),
                  f"a {len(lanes)}-lane seal drain's mask == the honest set")
            return mask

        def verify_seals_early_exit(self, proposal_hash, seals, height, threshold=None):
            rep = super().verify_seals_early_exit(proposal_hash, seals, height, threshold)
            check(np.array_equal(rep.mask, rep.verified & self._honest(seals)),
                  f"a {len(seals)}-seal early exit's mask == the honest set")
            return rep

    return Checked


def engine_phase(report: dict, ident: str, counts, holds) -> dict:
    """Phase 8: the consensus engine on the card (see the module docstring).

    ``counts`` is main()'s ``(reset_counts, read_counts)``, ``holds`` its
    ``(hold_digest, hold_recovery)``.  Every time printed is host clock
    (``time.perf_counter``) on this card, whose name and power limit
    ``ident`` carries.  Returns the launch counts of run A's 5 heights, per
    kernel, and the ``(kernel, shape)`` keys of the inputs it held."""
    import numpy as np

    from go_ibft_tpu_torch import native
    from go_ibft_tpu_torch.bench.engine import Committee, EngineRunner, check_height, run_cluster
    from go_ibft_tpu_torch.crypto import ecdsa
    from go_ibft_tpu_torch.crypto.backend import proposal_hash_of
    from go_ibft_tpu_torch.utils import metrics
    from go_ibft_tpu_torch.verify import AdaptiveBatchVerifier, HostBatchVerifier
    from go_ibft_tpu_torch.verify.pipeline import observe_overlap_efficiency

    reset_counts, read_counts = counts
    hold_digest, hold_recovery = holds
    check(native.load() is not None, f"the native host library loads ({native.build_error()})")
    out: dict = {"gpu": ident}
    # The first inputs with live lanes of each shape that a dispatch gives
    # the two kernels, across every run; held against the plain versions at
    # the end, once no count is read any more.
    kept: dict = {}

    no_fallback, drains = no_host_fallback, drain_counts
    Checked = checked_verifier(kept)

    def drive(committee, me, verifier, heights, what, per_height=None):
        runner = EngineRunner(committee, me, verifier)
        runs = []
        for h in heights:
            schedule = committee.schedule(h)  # signed off the clock
            before = read_counts()
            run = runner.run_height(h, schedule)
            check_height(committee, run)
            if per_height is not None:
                per_height(h, before, read_counts())
            runs.append(run)
        log(f"[8] {what}: {len(runs)} heights finalized the proposals sent; every seal passes the "
            f"host oracle and reaches quorum {committee.quorum}")
        return runner, runs

    def summary(runs):
        return {"accept_to_finalize_ms": statistics.median(r.accept_to_finalize_ms for r in runs),
                "run_sequence_ms": statistics.median(r.run_sequence_ms for r in runs),
                "accept_to_finalize_all_ms": [r.accept_to_finalize_ms for r in runs],
                "run_sequence_all_ms": [r.run_sequence_ms for r in runs]}

    def launched_every_height(h, before, after):
        for name in ("keccak256_digest", "secp256k1_recover"):
            check(after[name] > before[name], f"height {h}: {name} launched")

    # -- A: one engine among 100 validators --------------------------------
    committee = Committee(100, seed=0)
    me = 1
    heights = committee.heights(me, 6)
    card = Checked(committee.src)
    card.warmup(lanes=(8, 128), blocks=(2, 8))
    card.dispatches = 0
    metrics.reset()
    reset_counts()
    _, runs = drive(committee, me, card, heights[:5], "A, 100 validators, DeviceBatchVerifier",
                    launched_every_height)
    engine_launches = read_counts()
    no_fallback("A")
    # DeviceBatchVerifier has no host route: every drain is served on the card.
    check(card.dispatches > 0, f"A: drains dispatched to the card ({drains()})")
    a = summary(runs)
    a["drains_per_height"] = {k: v / 5 for k, v in drains().items()}
    a["dispatches_per_height"] = card.dispatches / 5
    a["launches_per_height"] = {k: v / 5 for k, v in engine_launches.items()}
    # One more height under the profiler: kernels, launch calls, busy, idle.
    drv = EngineRunner(committee, me, card)
    schedule = committee.schedule(heights[5])
    ran = []
    prof = profile_call(lambda: ran.append(drv.run_height(heights[5], schedule)))
    check_height(committee, ran[0])
    busy = prof["device_busy_ms"]
    prof.pop("count_by_name")
    prof["top_kernels_ms"] = sorted(prof.pop("by_name_ms").items(), key=lambda kv: -kv[1])[:5]
    prof["idle_share"] = 1 - busy / prof["profiled_wall_ms"]
    a["profiled_height"] = prof
    host = HostBatchVerifier(committee.src)
    _, hruns = drive(committee, me, host, heights[:5], "A, 100 validators, HostBatchVerifier (native)")
    a["host_baseline"] = summary(hruns)
    out["A_100v"] = a
    log(f"[8] A 100v on {ident}: accept->finalize median {a['accept_to_finalize_ms']:.3f} ms, "
        f"run_sequence median {a['run_sequence_ms']:.3f} ms; host verifier (native) "
        f"{a['host_baseline']['accept_to_finalize_ms']:.3f} / {a['host_baseline']['run_sequence_ms']:.3f} ms")
    prof["idle_share_vs_median"] = 1 - busy / a["run_sequence_ms"]
    log(f"[8] A per height: drains {a['drains_per_height']}, launches {a['launches_per_height']}; "
        f"profiled height: {prof['device_kernels']} kernels, {prof['launch_calls']} launch calls, "
        f"busy {busy:.3f} ms of {prof['profiled_wall_ms']:.3f} ms, idle share {prof['idle_share']:.3f} "
        f"({prof['idle_share_vs_median']:.3f} of the median run_sequence)")

    # -- B: 300 validators, 30 % Byzantine ----------------------------------
    committee = Committee(300, seed=0, bad_frac=0.3)
    heights = committee.heights(me, 2)
    committee.choose_bad(me, heights)
    metrics.reset()
    card = Checked(committee.src, committee.corrupted)
    _, runs = drive(committee, me, card, heights, "B, 300 validators, 30 % Byzantine",
                    launched_every_height)
    no_fallback("B")
    check(card.dispatches > 0, "B: drains dispatched to the card")
    check(len(committee.corrupted) == 2 * 2 * len(committee.bad), "B: every Byzantine message corrupt")
    for run in runs:
        check(len({s.signer for s in run.seals}) >= committee.quorum,
              f"B height {run.height}: {len(run.seals)} honest seals >= {committee.quorum}")
    out["B_300v_30bad"] = {**summary(runs), "bad": len(committee.bad),
                           "seals": [len(r.seals) for r in runs], "drains": drains()}
    log(f"[8] B 300v, {len(committee.bad)} Byzantine: every drain's mask == the honest set; seals "
        f"{[len(r.seals) for r in runs]} (none Byzantine), accept->finalize median "
        f"{out['B_300v_30bad']['accept_to_finalize_ms']:.3f} ms, drains {drains()}")

    # -- C: a 4-validator cluster, host route and card route --------------
    blocks = {}
    for label, cutover in (("default_cutover", None), ("cutover_1", 1)):
        metrics.reset()
        cards = []

        def factory(src, cutover=cutover):
            dev = Checked(src)
            cards.append(dev)
            return AdaptiveBatchVerifier(src, cutover_lanes=cutover, device=dev)

        reset_counts()
        t0 = time.perf_counter()
        committee, nodes = run_cluster(factory, range(1, 6))
        wall = (time.perf_counter() - t0) * 1e3
        counts_c = read_counts()
        no_fallback(f"C {label}")
        inserted = [[p.encode() for p, _ in b.inserted] for b, _ in nodes]
        check(all(len(x) == 5 and x == inserted[0] for x in inserted),
              f"C {label}: every node inserted the same 5 proposals")
        oracle = HostBatchVerifier(committee.src, recover_fn=ecdsa.recover_pure)
        for b, v in nodes:
            check(v.breaker.level == 0, f"C {label}: breaker at the card rung")
            for p, seals in b.inserted:
                check(oracle.verify_committed_seals(proposal_hash_of(p), seals, 1).all()
                      and len({s.signer for s in seals}) >= committee.quorum,
                      f"C {label}: seals oracle-valid at quorum")
        seal_sets = {tuple(tuple(s.signature for s in seals) for _, seals in b.inserted) for b, _ in nodes}
        dispatches = sum(c.dispatches for c in cards)
        if cutover == 1:
            check(dispatches > 0 and counts_c["secp256k1_recover"] > 0, "C cutover 1: the card served")
        else:
            check(dispatches == 0, "C default cutover: the host served every 4-lane drain")
        blocks[label] = inserted[0]
        out[f"C_4v_{label}"] = {"wall_ms": wall, "dispatches": dispatches, "launches": counts_c,
                                "identical_seal_sets_across_nodes": len(seal_sets) == 1}
        log(f"[8] C 4v {label}: 5 heights in {wall:.1f} ms, {dispatches} card dispatches, "
            f"launches {counts_c}, seal sets identical on every node: {len(seal_sets) == 1}")
    check(blocks["default_cutover"] == blocks["cutover_1"], "C: the same proposals on both routes")

    # -- D: a chunked drain -------------------------------------------------
    committee = Committee(300, seed=0, bad_frac=0.3)
    committee.choose_bad(me, [1])
    _, prepares, _ = committee.schedule(1)
    msgs = [prepares[i % len(prepares)] for i in range(4096)]
    card = Checked(committee.src, committee.corrupted)
    whole = card.verify_senders(msgs)  # warm: tables, pack cache
    halves = [card.verify_senders(msgs[:2048]), card.verify_senders(msgs[2048:])]
    check(np.array_equal(whole, np.concatenate(halves)), "D: chunked mask == one-chunk masks")
    bad_addrs = {committee.keys[i].address for i in committee.bad}
    expect = np.array([m.sender not in bad_addrs for m in msgs])
    check(np.array_equal(whole, expect), "D: mask == the Byzantine set")
    pipelined, serial = [], []
    for _ in range(5):
        t0 = time.perf_counter()
        card.verify_senders(msgs)
        pipelined.append(time.perf_counter() - t0)
        check(len(card.last_pipeline.results) == 2, "D: two pipeline chunks")
        t0 = time.perf_counter()
        card.verify_senders(msgs[:2048])
        card.verify_senders(msgs[2048:])
        serial.append(time.perf_counter() - t0)
    p_s, s_s = statistics.median(pipelined), statistics.median(serial)
    eff = observe_overlap_efficiency(s_s, p_s)
    out["D_4096"] = {"pipelined_ms": p_s * 1e3, "serial_ms": s_s * 1e3, "overlap_efficiency": eff}
    log(f"[8] D 4,096 envelopes: two chunks == one-chunk masks; pipelined {p_s * 1e3:.3f} ms, "
        f"serial {s_s * 1e3:.3f} ms (medians of 5), overlap efficiency {eff:.3f}")

    # -- the kernels at the engine's own inputs, against the plain versions
    for (name, shape), ins in sorted(kept.items(), key=str):
        if name == "keccak256_digest":
            hold_digest(*ins, f"the engine's dispatch at {shape}")
        else:
            hold_recovery(ins, f"secp256k1_recover kernel == plain on the engine's {shape[0]} lanes")
    out["held_shapes"] = sorted(f"{name} {shape}" for name, shape in kept)
    for name in ("keccak256_digest", "secp256k1_recover"):
        check(any(k == name for k, _ in kept), f"the engine's {name} inputs held")
    log(f"[8] the kernels bit-exact against plain at the engine's own inputs: {out['held_shapes']}")
    report["engine"] = out
    return engine_launches, set(kept)


def chain_phase(report: dict, ident: str, counts, holds, held_before: set) -> dict:
    """Phase 9: the chain on the card (see the module docstring).

    ``counts`` and ``holds`` are main()'s, ``held_before`` the kernel input
    shapes phase 8 held (reported beside the chain's own).  Every drain goes through a
    ``DeviceBatchVerifier`` on the card; each run's launch counts are set to
    0 just before it and read just after.  Times are host clock on the card
    ``ident`` names.  Returns run F's launch counts over its 32 heights."""
    import tempfile

    import numpy as np

    from go_ibft_tpu_torch.bench import build_signed_round
    from go_ibft_tpu_torch.bench import chain as bc
    from go_ibft_tpu_torch.bench.engine import Committee
    from go_ibft_tpu_torch.chain import LoopbackSyncNetwork, SyncClient, SyncError
    from go_ibft_tpu_torch.chain.sync import SYNC_DRAINS_KEY
    from go_ibft_tpu_torch.crypto import ecdsa
    from go_ibft_tpu_torch.crypto.backend import proposal_hash_of
    from go_ibft_tpu_torch.obs import trace
    from go_ibft_tpu_torch.utils import metrics
    from go_ibft_tpu_torch.verify import DeviceBatchVerifier, HostBatchVerifier

    reset_counts, read_counts = counts
    hold_digest, hold_recovery = holds
    kept: dict = {}
    Checked = checked_verifier(kept)
    out: dict = {"gpu": ident}
    committee = Committee(100, seed=0)
    oracle: dict = {}

    def oracle_valid(proposal, seals, what):
        """Every seal recovers to its signer with Python ints
        (``recover_pure``), and their power reaches the quorum."""
        phash = proposal_hash_of(proposal)
        for seal in seals:
            key = (phash, seal.signature)
            if key not in oracle:
                sig = seal.signature
                pub = ecdsa.recover_pure(phash, int.from_bytes(sig[:32], "big"),
                                         int.from_bytes(sig[32:64], "big"), sig[64])
                oracle[key] = pub is not None and ecdsa.pubkey_to_address(*pub) == seal.signer
            check(oracle[key], f"{what}: a finalized seal passes the host oracle")
        check(len({s.signer for s in seals}) >= committee.quorum, f"{what}: seals reach the quorum")

    def per_height(launches, n):
        return {k: v / n for k, v in launches.items()}

    # -- E: the commit critical path, variant OFF then ON ------------------
    me = 1
    heights = committee.heights(me, 5)
    e = {}
    for variant, speculate in (("off", False), ("on", True)):
        card = Checked(committee.src)
        card.warmup(lanes=(8, 128), blocks=(2, 8))
        card.dispatches = 0
        metrics.reset()
        reset_counts()
        run = bc.commit_critical_path(committee, me, card, heights, speculate=speculate)
        launches = read_counts()
        no_host_fallback(f"E {variant}")
        for h, (proposal, seals) in zip(heights, run["inserted"]):
            oracle_valid(proposal, seals, f"E {variant} height {h}")
        check(len(run["inserted"]) == 5, f"E {variant}: 5 heights finalized")
        spec = run.pop("speculation")
        run.pop("inserted")
        if speculate:
            check(spec["speculated_lanes"] > 0, f"E on: speculated lanes ({spec})")
            check(spec["faults"] == 0 and spec["dropped_lanes"] == 0, f"E on: no fault, no dropped lane ({spec})")
        e[variant] = {**run, "speculation": spec, "launches_per_height": per_height(launches, 5),
                      "dispatches_per_height": card.dispatches / 5}
        log(f"[9] E {variant} on {ident}: accept->finalize median {run['median_ms']:.3f} ms of "
            f"{[round(x, 3) for x in run['accept_to_finalize_ms']]}, speculation {spec}, early-exit lanes "
            f"skipped {run['early_exit_lanes_skipped']}, launches a height {e[variant]['launches_per_height']}")
    out["E_commit_critical_path"] = e

    # -- F: a 32-height chain, crash and recovery, sync -------------------
    n_heights = 32
    me = bc.proposer_free_validator(committee, n_heights)
    f: dict = {"validator": me, "heights": n_heights}
    with tempfile.TemporaryDirectory() as tmp:
        wal = os.path.join(tmp, "wal.jsonl")
        card = Checked(committee.src)
        card.warmup(lanes=(8, 128), blocks=(2, 8))
        card.dispatches = 0
        drv = bc.ChainFeeder(committee, me, card, wal)
        metrics.reset()
        trace.enable(1 << 18)
        reset_counts()
        try:
            stats = drv.run(n_heights)
            chain_launches = read_counts()
            trace_path = os.path.join(tmp, "chain_trace.json")
            drv.runner.export_trace(trace_path)
        finally:
            trace.disable()
        no_host_fallback("F chain")
        spec = stats["speculation"]
        check(stats["heights_run"] == n_heights, f"F: {n_heights} heights finalized ({stats})")
        check(stats["overlapped_lanes"] > 0, f"F: the overlap worker verified next-height lanes ({stats})")
        check(spec["speculated_lanes"] > 0 and spec["faults"] == 0 and spec["dropped_lanes"] == 0,
              f"F: speculated lanes, no fault, no dropped lane ({spec})")
        chain = list(drv.runner.chain)
        for block in chain:
            oracle_valid(block.proposal, block.seals, f"F height {block.height}")
        f["chain"] = {**stats, "launches_per_height": per_height(chain_launches, n_heights),
                      "drains_per_height": per_height(drain_counts(), n_heights),
                      "dispatches_per_height": card.dispatches / n_heights}
        f["host_split_ms_per_height"] = bc.span_split(trace_path, n_heights)
        f["phase_split_ms"] = bc.phase_split(trace_path, drv.engine._obs_track, committee.quorum)
        log(f"[9] F chain on {ident}: {n_heights} heights at {stats['blocks_per_s']:.2f} blocks/s (traced), "
            f"handoff mean {stats['handoff_ms_mean']:.4f} ms max {stats['handoff_ms_max']:.4f} ms, overlapped "
            f"{stats['overlapped_lanes']} lanes in {stats['overlap_batches']} batches, speculation {spec}, "
            f"launches a height {f['chain']['launches_per_height']}, drains a height {f['chain']['drains_per_height']}")
        print("[9] F per-layer split of a height's host time (ms a height, runner trace): "
              + json.dumps({k: round(v, 4) for k, v in f["host_split_ms_per_height"].items()}), flush=True)
        print("[9] F phase split (obs/timeline.py reconstruct + _phase_split, mean ms a height): "
              + json.dumps({k: round(v, 4) for k, v in f["phase_split_ms"].items()}), flush=True)

        # Crash and recovery: a fresh runner on the same WAL.
        _, resumed, reinserted = bc.recover_runner(committee, me, card, wal)
        check(resumed == n_heights + 1, f"F recovery resumes at {n_heights + 1} (got {resumed})")
        check([(p.encode(), [(s.signer, s.signature) for s in seals]) for p, seals in reinserted]
              == [(b.proposal.encode(), [(s.signer, s.signature) for s in b.seals]) for b in chain],
              "F recovery: the same 32 blocks byte for byte")
        log(f"[9] F recovery: resumes at height {resumed} with the same {len(reinserted)} blocks")

        # Sync: a fresh runner with an empty WAL catches up from the first.
        metrics.reset()
        reset_counts()
        t0 = time.perf_counter()
        synced = bc.sync_runner(committee, me, card, os.path.join(tmp, "wal-sync.jsonl"), drv.runner, n_heights)
        sync_s = time.perf_counter() - t0
        sync_launches = read_counts()
        no_host_fallback("F sync")
        lanes = sum(len(b.seals) for b in chain)
        drains = metrics.get_counter(SYNC_DRAINS_KEY)
        check(synced.synced_heights == n_heights and drains == 1,
              f"F sync: {n_heights} heights in one drain (got {synced.synced_heights}, {drains} drains)")
        check([(b.height, b.proposal.encode(), [(s.signer, s.signature) for s in b.seals]) for b in synced.chain]
              == [(b.height, b.proposal.encode(), [(s.signer, s.signature) for s in b.seals]) for b in chain],
              "F sync: the synced chain equals the first")
        f["sync"] = {"lanes": lanes, "drains": drains, "wall_s": sync_s, "launches": sync_launches}
        log(f"[9] F sync: {n_heights} heights, {lanes} seal lanes in {drains} drain, {sync_s * 1e3:.1f} ms "
            f"(the watcher's polls included), launches {sync_launches}")

        # A peer serving one block with 34 corrupted seals.
        blocks = list(chain)
        blocks[n_heights // 2] = bc.corrupt_seals(blocks[n_heights // 2], 34)
        card.corrupted |= {s.signature for s in blocks[n_heights // 2].seals[:34]}
        net = LoopbackSyncNetwork()
        net.register(b"peer", bc.StaticSource(blocks))
        try:
            SyncClient(b"me", net, card, committee.src).catch_up(1, n_heights)
            check(False, "F: the corrupted block was accepted")
        except SyncError as err:
            check(f"height {n_heights // 2 + 1}" in str(err) and "< quorum" in str(err),
                  f"F: SyncError with power below the quorum ({err})")
            f["corrupted_block_error"] = str(err)
            log(f"[9] F corrupted block rejected: SyncError: {err}")
    out["F_chain"] = f

    # -- concurrency: three threads through one verifier --------------------
    rounds = [build_signed_round(100, height=h, corrupt_frac=0.3, seed=h) for h in (1, 2, 3)]
    powers = {rnd.height: {m.sender: 1 for m in rnd.prepares} for rnd in rounds}
    for rnd in rounds:
        host = HostBatchVerifier(lambda h: powers[h], recover_fn=ecdsa.recover_pure)
        check(np.array_equal(host.verify_senders(rnd.prepares), rnd.expected_prepare_mask)
              and np.array_equal(host.verify_seal_lanes([(rnd.proposal_hash, s) for s in rnd.seals], rnd.height),
                                 rnd.expected_seal_mask), f"height {rnd.height}: expected masks == host oracle")
    shared = DeviceBatchVerifier(lambda h: powers[h], cache_heights=2)
    t0 = time.perf_counter()
    calls = bc.concurrent_drains(shared, rounds)
    out["threads"] = {"threads": 3, "calls": calls, "wall_s": time.perf_counter() - t0}
    log(f"[9] three threads x 50 x (verify_senders + verify_seal_lanes) through one DeviceBatchVerifier "
        f"(cache_heights 2, 3 heights): {calls} masks == the host oracle in {out['threads']['wall_s']:.2f} s")

    # -- the kernels at the chain's own inputs -------------------------------
    # Every shape the chain's dispatches uploaded, phase 8's shapes too: the
    # chain's inputs differ (the sync drain's per-lane proposal hashes, the
    # speculator's and the overlap worker's batches).
    for (name, shape), ins in sorted(kept.items(), key=str):
        if name == "keccak256_digest":
            hold_digest(*ins, f"the chain's dispatch at {shape}")
        else:
            hold_recovery(ins, f"secp256k1_recover kernel == plain on the chain's {shape[0]} lanes")
    out["held_shapes"] = sorted(f"{name} {shape}" for name, shape in kept)
    out["held_shapes_new"] = sorted(f"{name} {shape}" for name, shape in kept if (name, shape) not in held_before)
    log(f"[9] the kernels bit-exact against plain at the chain's own inputs: {out['held_shapes']} "
        f"(not held in phase 8: {out['held_shapes_new']})")
    report["chain"] = out
    return chain_launches


# -- phase 10: BLS12-381 aggregate verification on the card --------------------

# 32-bit integer operations of one Fp product in the BLS kernels: a 12 x 12
# word Montgomery product (CIOS) is 144 multiply-adds for the product and
# 144 for the reduction, each 32 x 32 -> 64 bits, two 32-bit multiply-adds
# (the low and the high word).
OPS_BLS_FP_MUL = 2 * 2 * 144
# An Fp inversion by the binary extended Euclid needs no product: about
# 2 x 381 steps, each about four 12-word adds or shifts.
OPS_BLS_FP_INV = 2 * 381 * 4 * 12
# The least work of each function in Fp products (a squaring counts as a
# product), with the cheapest published formulas, not the kernels' own
# (which square by multiplying, multiply lines in as full Fp12 elements and
# run each side's Miller loop on its own): an Fp2 product is 3, a squaring
# 2; an Fp6 product 18, a squaring 12; an Fp12 product 54, a squaring 36, a
# cyclotomic squaring 18 (Granger-Scott: 9 Fp2 squarings); the product of
# two sparse lines 18 (6 Fp2 products), and an Fp12 times such a product 51
# (its c1.c0 is zero), which takes a step's two lines for 69 where two
# sparse-line products (39 each, 13 Fp2 products) take 78.
# Miller, a lane's two pairs sharing one accumulator: 62 Fp12 squarings (the
# first is of 1); 2 x 63 doubling steps with their lines (3 Fp2 products, 6
# squarings, 4 Fp products: 25; Aranha et al., Eurocrypt 2011), each step's
# two lines multiplied in (69); 2 x 5 addition steps (11 Fp2 products, 2
# squarings, 4 Fp products: 41), each set bit's two lines multiplied in (69).
BLS_MILLER_MULS = 62 * 36 + 2 * 63 * 25 + 63 * 69 + 2 * 5 * 41 + 5 * 69
# Final exponentiation (cubed), besides one Fp inversion: the easy part's
# Fp12 inverse (2 Fp6 squarings, 2 Fp6 products, an Fp6 inverse of 37),
# two Fp12 products and a p^2 Frobenius (10); the hard part's five x-powers
# (63 cyclotomic squarings and 5 products each), 7 more products, one
# cyclotomic squaring, a p Frobenius (15) and a p^2 one (10).
BLS_FINAL_EXP_MULS = (2 * 12 + 2 * 18 + 37) + 2 * 54 + 10 + 5 * (63 * 18 + 5 * 54) + 7 * 54 + 18 + 15 + 10
# The merge, a group of n live points: n - 1 affine additions with the
# inversions batched (Montgomery's trick, 3 products an element) over each
# tree level of the launch: 6 products in the coordinates' field (G1: 6 Fp;
# G2: 5 Fp2 products and a squaring, 17), and one inversion a level (G2: an
# Fp inversion and 4 products).  The affine inputs need no map back.
BLS_ADD_MULS = {2: 6, 4: 17}
BLS_INV_MULS = {2: 0, 4: 4}
BLS_MERGE_V = (1, 2, 3, 8, 128, 129, 1024)
BLS_MERGE_G = (1, 7, 64)
BLS_MERGE_EXTRA = ((17, 8),)  # (groups, points): a partial last block of small groups
BLS_WHERE = {
    "bls_merge": ("go_ibft_tpu_torch/csrc/bls12_381.cu", "go_ibft_tpu/ops/bls12_381.py:759"),
    "bls_miller": ("go_ibft_tpu_torch/csrc/bls12_381.cu", "go_ibft_tpu/ops/bls12_381.py:789"),
    "bls_final_exp": ("go_ibft_tpu_torch/csrc/bls12_381.cu", "go_ibft_tpu/ops/bls12_381.py:809"),
}


def merge_ops(live, coords: int) -> int:
    """32-bit operations a merge of these groups needs: (live points - 1)
    affine additions a group and one inversion a tree level."""
    n = live.sum(dim=-1).flatten().tolist()
    levels = (max(n, default=1) - 1).bit_length()
    adds = sum(max(int(k) - 1, 0) for k in n)
    return (adds * BLS_ADD_MULS[coords] + levels * BLS_INV_MULS[coords]) * OPS_BLS_FP_MUL + levels * OPS_BLS_FP_INV


def final_exp_ops(n: int) -> int:
    """32-bit operations of n lanes' final exponentiations."""
    return n * (BLS_FINAL_EXP_MULS * OPS_BLS_FP_MUL + OPS_BLS_FP_INV)


def bls_phase(report: dict, ident: str, counts, dev=None, small: bool = False) -> dict:
    """Phase 10: BLS12-381 aggregate verification on the card.

    Holds the three pairing kernels bit-exact against their plain versions
    (and a few lanes against the host oracle, the pairing cubed), then
    drives config #4 (one 100-validator aggregate COMMIT check), config #9's
    Byzantine mix through ``BLSAggregateVerifier``, config #13's batch of
    certificates through ``BLSCertifier.verify_many``, and a chain of
    ``HybridBLSBackend`` engines whose ``ChainRunner`` finalizes, persists,
    recovers and syncs certificates.  Launch counts are set to 0 just
    before each run and read just after.  ``dev``/``small`` let the
    orchestration run on the CPU at a small size (plain versions, no counts
    checked).  Returns the kernels line's entries for the three kernels and
    each kernel's counts per config-#4 call and per chain height."""
    import shutil
    import tempfile

    import numpy as np

    from go_ibft_tpu_torch.bench import build_bls_round_workload
    from go_ibft_tpu_torch.bench.bls_workload import _bls_keys
    from go_ibft_tpu_torch.bench.bls_chain import (
        BLSChain, BLSCommittee, certificate_batch, relabel_block, tamper,
    )
    from go_ibft_tpu_torch.chain import SyncError
    from go_ibft_tpu_torch.crypto import bls as hbls
    from go_ibft_tpu_torch.messages.helpers import CommittedSeal
    from go_ibft_tpu_torch.ops import bls12_381 as ops
    from go_ibft_tpu_torch.ops import bls_kernels as bk
    from go_ibft_tpu_torch.utils import metrics
    from go_ibft_tpu_torch.verify import BLSAggregateVerifier, DeviceBatchVerifier, G2MergeTree, HostBatchVerifier
    from go_ibft_tpu_torch.verify import aggregate as vagg
    from go_ibft_tpu_torch.verify.bls import PAIRING_EQS_KEY, encode_seal

    dev = torch.device("cuda") if dev is None else dev
    card = dev.type == "cuda"
    reset_counts, read_counts = counts
    out: dict = {"gpu": ident}
    err = {"bls_merge": 0, "bls_miller": 0, "bls_final_exp": 0}
    rng = np.random.default_rng(10)
    t_phase = time.perf_counter()

    def sync():
        if card:
            torch.cuda.synchronize()

    def same(got, ref, name, what):
        """Hold a kernel's output against its plain version's; fold the
        largest absolute difference into the kernels line's max_abs_err."""
        got, ref = got.cpu(), ref.cpu()
        check(torch.equal(got, ref), f"{name} kernel == plain, {what}")
        if got.numel():
            err[name] = max(err[name], int((got.to(torch.int64) - ref.to(torch.int64)).abs().max()))

    # -- 1. each kernel against its plain version ----------------------------
    pool = {2: [hbls.G1_GEN], 4: [hbls.G2_GEN]}
    for _ in range(63):
        pool[2].append(hbls.g1_add(pool[2][-1], hbls.G1_GEN))
        pool[4].append(hbls.g2_add(pool[4][-1], hbls.G2_GEN))
    packed = {2: (ops.pack_g1_points(pool[2]), ops.pack_g1_points([hbls.g1_neg(p) for p in pool[2]])),
              4: (ops.pack_g2_points(pool[4]), ops.pack_g2_points([hbls.g2_neg(p) for p in pool[4]]))}

    def merge_case(coords, g, v):
        """g groups of v points drawn from the pool (duplicates), a tenth
        negated, a fifth dead; group 1 all dead, group 0's first two lanes
        P and -P; group 2's only live points P, Q and -(P + Q), apart (a sum
        of infinity with no cancelling pair); group 3 one live point."""
        idx = rng.integers(0, 64, size=(g, v))
        neg = rng.random((g, v)) < 0.1
        live = rng.random((g, v)) >= 0.2
        if v >= 2:
            idx[0, :2] = idx[0, 0]
            neg[0, :2] = (False, True)
            live[0, :2] = True
        if g > 1:
            live[1] = False
        pos, negs = packed[coords]
        pts = np.where(neg[..., None, None], negs[idx], pos[idx])
        add, negate = (hbls.g1_add, hbls.g1_neg) if coords == 2 else (hbls.g2_add, hbls.g2_neg)
        hosts = [[negate(pool[coords][i]) if n else pool[coords][i]
                  for i, n in zip(idx[gi], neg[gi])] for gi in range(g)]
        if g > 2 and v >= 3:
            a, b = (int(i) for i in rng.integers(0, 64, size=2))
            trio = (pool[coords][a], pool[coords][b], negate(add(pool[coords][a], pool[coords][b])))
            live[2] = False
            pack = ops.pack_g1_points if coords == 2 else ops.pack_g2_points
            for at, pt in zip((0, v // 2, v - 1), trio):
                pts[2, at] = pack([pt])[0]
                hosts[2][at] = pt
                live[2, at] = True
        if g > 3:
            live[3] = False
            live[3, v // 2] = True
        return torch.from_numpy(np.ascontiguousarray(pts)), torch.from_numpy(live), hosts

    vs = (1, 2, 3, 8, 128) if small else BLS_MERGE_V
    gs = (1, 7) if small else BLS_MERGE_G
    shapes = [(g, v) for v in vs for g in gs] + list(BLS_MERGE_EXTRA)
    t0 = time.perf_counter()
    for coords in (2, 4):
        # The kernel at every (groups, points) shape.  Its plain version
        # costs seconds a call and grows with groups x points, so it runs on
        # the first four groups of each shape (the special ones), batched
        # per point count up to 128 and each above (padded with dead lanes
        # to the batch's width: dead lanes change neither the sum nor the
        # plain version's order of additions); the host oracle takes every
        # group of up to 8 points and single groups.
        held = {}
        for g, v in shapes:
            pts, live, hosts = merge_case(coords, g, v)
            for neg_y in (False, True) if g == 7 else (False,):
                got, inf = bk.merge(pts.to(dev), live.to(dev), neg_y)
                width = 128 if v <= 128 else v
                held.setdefault((width, neg_y), []).append((g, v, got, inf, pts[:4], live[:4]))
                if neg_y:
                    continue
                if v <= 8 or g == 1:  # the host oracle
                    unpack = ops.unpack_g1_points if coords == 2 else ops.unpack_g2_points
                    add = hbls.g1_add if coords == 2 else hbls.g2_add
                    got_pts = unpack(got.cpu(), inf.cpu())
                    for gi in range(g):
                        acc = None
                        for p, alive in zip(hosts[gi], live[gi].tolist()):
                            if alive:
                                acc = add(acc, p)
                        check(got_pts[gi] == acc, f"bls_merge == host oracle, group {gi} of {g} x {v}")
                if g > 3 and v >= 3:
                    check(bool(inf[2]) and not bool(inf[3]), f"bls_merge: P + Q - (P + Q) is infinity and one "
                          f"live point is not, {g} x {v}")
        sync()
        for (width, neg_y), cases in held.items():
            ref, rinf = ops.merge_plain(
                torch.cat([torch.nn.functional.pad(pt, (0, 0, 0, 0, 0, width - v)) for _, v, _, _, pt, _ in cases]),
                torch.cat([torch.nn.functional.pad(lv, (0, width - v)) for _, v, _, _, _, lv in cases]), neg_y)
            at = 0
            for g, v, got, inf, pt, _ in cases:
                k = pt.shape[0]
                what = f"{'G1' if coords == 2 else 'G2'} {g} x {v}, neg_y {neg_y}, first {k} groups"
                same(got[:k], ref[at:at + k], "bls_merge", what)
                same(inf[:k], rinf[at:at + k], "bls_merge", f"infinity flags, {what}")
                at += k
    log(f"[10] bls_merge at V={vs} x groups {gs} and (groups, V) {BLS_MERGE_EXTRA} on G1 and G2 (P + -P, "
        f"duplicates, negated and dead lanes, an all-dead group, P, Q and -(P + Q) apart, one live point; y "
        f"negated at 7 groups): bit-exact against plain on each shape's first 4 groups, every group of up to 8 "
        f"points and single groups against the host oracle ({time.perf_counter() - t0:.1f}s)")

    # Miller lanes: lanes 0 and 3 a valid aggregate, the rest pool points, the
    # last with a (0, 0) G2 point on side 0 (the merge of an all-dead group).
    # The final exponentiation takes their Miller values with lane 1's zeroed
    # (a lane of dead or garbage inputs) and lane 3's gate 0.
    msg = b"\x11" * 32
    hmsg = hbls.hash_to_g2(msg)
    signers = [hbls.BLSPrivateKey(k) for k in (3, 5, 7)]
    s_valid = hbls.aggregate_signatures([k.sign(msg) for k in signers])
    pk_valid = hbls.aggregate_pubkeys([k.pubkey for k in signers])
    n_lanes = 8 if small else 64
    lane_s = [s_valid] + [pool[4][int(i)] for i in rng.integers(0, 64, n_lanes - 1)]
    lane_h = [hmsg] + [pool[4][int(i)] for i in rng.integers(0, 64, n_lanes - 1)]
    lane_pk = [pk_valid] + [pool[2][int(i)] for i in rng.integers(0, 64, n_lanes - 1)]
    lane_s[3], lane_h[3], lane_pk[3] = s_valid, hmsg, pk_valid
    lane_s[-1] = None
    q64 = torch.from_numpy(np.stack([ops.pack_g2_points(lane_s), ops.pack_g2_points(lane_h)]))
    p64 = torch.from_numpy(np.stack([ops.pack_g1_points([hbls.G1_GEN] * n_lanes),
                                     ops.pack_g1_points([hbls.g1_neg(p) for p in lane_pk])]))
    t0 = time.perf_counter()
    # The plain versions once at the widest batch; lanes are independent, so
    # the kernel's narrower launches hold against its leading lanes, and a
    # launch of the lanes repeated 16 times against the plain result repeated.
    f_plain = ops.miller_plain(q64, p64)
    f_in = f_plain.clone()
    f_in[1] = 0
    gate = torch.ones(n_lanes, dtype=torch.bool)
    gate[3] = False
    pok, pres = ops.final_exp_plain(f_in, gate)
    widths = (1, 2, 5, 8) if small else (1, 2, 33, 64)
    for n in widths:
        f = bk.miller(q64[:, :n].contiguous().to(dev), p64[:, :n].contiguous().to(dev))
        ok, res = bk.final_exp(f_in[:n].contiguous().to(dev), gate[:n].contiguous().to(dev))
        sync()
        same(f, f_plain[:n], "bls_miller", f"N={n}")
        same(ok, pok[:n], "bls_final_exp", f"verdicts, N={n}")
        same(res, pres[:n], "bls_final_exp", f"results, N={n}")
    tiles = 16
    f = bk.miller(q64.repeat(1, tiles, 1, 1).to(dev), p64.repeat(1, tiles, 1, 1).to(dev))
    okt, rest = bk.final_exp(f_in.repeat(tiles, 1, 1).to(dev), gate.repeat(tiles).to(dev))
    sync()
    same(f, f_plain.repeat(tiles, 1, 1), "bls_miller", f"N={tiles * n_lanes} (the lanes {tiles} times)")
    same(okt, pok.repeat(tiles), "bls_final_exp", f"verdicts, N={tiles * n_lanes} (the lanes {tiles} times)")
    same(rest, pres.repeat(tiles, 1, 1), "bls_final_exp", f"results, N={tiles * n_lanes} (the lanes {tiles} times)")
    oks = ok.cpu().tolist()
    check(oks[0] and not any(oks[1:]), "the valid lane verifies; pool lanes, the zero lane and the gated lane do not")
    results = ops.unpack_f12(res.cpu())
    check(results[3] == hbls.F12_ONE and not res[1].any(), "the gated lane's result is one, the zero lane's is zero")
    for i in (0, 2):
        e = hbls.f12_mul(hbls.pairing(lane_s[i], hbls.G1_GEN), hbls.pairing(lane_h[i], hbls.g1_neg(lane_pk[i])))
        check(results[i] == hbls.f12_pow(e, 3), f"lane {i}: final_exp(miller) == the host pairing ratio cubed")
    log(f"[10] bls_miller and bls_final_exp at N={widths} and {tiles * n_lanes} (tiled) bit-exact against plain, "
        f"with a (0, 0) G2 point, a zero Miller value and a gate of 0; 2 lanes == crypto.bls pairing ratio cubed "
        f"({time.perf_counter() - t0:.1f}s)")

    # -- 2. config #4: one 100-validator aggregate COMMIT check --------------
    n_val = 8 if small else 100
    t0 = time.perf_counter()
    w = build_bls_round_workload(n_val, seed=0, time_host=True)
    args = tuple(torch.from_numpy(a).to(dev) for a in w.args)
    log(f"[10] config #4 workload: {n_val} seals signed, host oracle aggregate_verify {w.host_ms:.1f} ms "
        f"({time.perf_counter() - t0:.1f}s)")
    reset_counts()
    verdict = bool(ops.aggregate_verify_commit(*args))
    c4 = read_counts()
    check(verdict, "config #4: the aggregate check on the card is true")
    if card:
        check(c4["bls_merge"] == 2 and c4["bls_miller"] == 1 and c4["bls_final_exp"] == 1,
              f"config #4: two merges, one Miller, one final exponentiation launch ({c4})")
    bad_sig = w.args[1].copy()
    bad_sig[0] = bad_sig[1]  # validator 0's seal replaced by validator 1's: false
    check(not bool(ops.aggregate_verify_commit(args[0], torch.from_numpy(bad_sig).to(dev), args[2], args[3])),
          "config #4 with one seal replaced by another validator's: false")
    c4_out = {"verdict": verdict, "launches": c4, "host_oracle_ms": w.host_ms}

    # The kernels at config #4's shapes: events, profiler, plain, bound.
    pk, sig, h, live = args
    timing = {}
    if card:
        npk, pk_inf = bk.launch_merge(pk.unsqueeze(0), live.unsqueeze(0), True)
        s, s_inf = bk.launch_merge(sig.unsqueeze(0), live.unsqueeze(0))
        gen = torch.from_numpy(ops._G1_GEN).to(dev).unsqueeze(0)
        q1 = torch.stack([s, h.unsqueeze(0)]).contiguous()
        p1 = torch.stack([gen, npk]).contiguous()
        f1 = bk.launch_miller(q1, p1)
        g1 = ~pk_inf & ~s_inf
        lv = live.unsqueeze(0).cpu()
        timing["bls_merge"] = {
            "shape": f"G2 1 x {sig.shape[0]}",
            "ms": cuda_time_ms(lambda: bk.launch_merge(sig.unsqueeze(0), live.unsqueeze(0)), 10),
            "plain_ms": cuda_time_ms(lambda: ops.merge_plain(sig.unsqueeze(0), live.unsqueeze(0)), 1),
            "g1_ms": cuda_time_ms(lambda: bk.launch_merge(pk.unsqueeze(0), live.unsqueeze(0), True), 10),
            **bound(sig.numel() * 4 + live.numel() + 4 * 12 * 4 + 1, merge_ops(lv, 4)),
        }
        timing["bls_miller"] = {
            "shape": "N=1",
            "ms": cuda_time_ms(lambda: bk.launch_miller(q1, p1), 5),
            "plain_ms": cuda_time_ms(lambda: ops.miller_plain(q1, p1), 1),
            **bound(q1.numel() * 4 + p1.numel() * 4 + 144 * 4, BLS_MILLER_MULS * OPS_BLS_FP_MUL),
        }
        timing["bls_final_exp"] = {
            "shape": "N=1",
            "ms": cuda_time_ms(lambda: bk.launch_final_exp(f1, g1), 5),
            "plain_ms": cuda_time_ms(lambda: ops.final_exp_plain(f1, g1), 1),
            **bound(144 * 4 + 1 + 1 + 144 * 4, final_exp_ops(1)),
        }
        # torch.profiler stops recording the card's activity once some tens
        # of seconds pass after its last session in a process (PERF.md §7),
        # so the profiled calls run in a process of their own.
        child = subprocess.run([sys.executable, os.path.abspath(__file__), "--bls-profile"],
                               capture_output=True, text=True, timeout=600)
        check(child.returncode == 0, f"the --bls-profile process exited 0 ({child.stderr[-2000:]})")
        profiled = json.loads(child.stdout.strip().splitlines()[-1])
        for name, t in timing.items():
            t["device_ms_per_launch"] = profiled["device_ms_per_launch"][name]
            log(f"[10] {name} at config #4's {t['shape']}: kernel {t['ms']:.4f} ms "
                f"({t['device_ms_per_launch'] * 1e3:.1f} us on the card), plain {t['plain_ms']:.1f} ms, "
                f"bound {t['bound_ms']:.3g} ms ({t['bound_by']})")

        host_ms, event_ms = median_ms(lambda: bool(ops.aggregate_verify_commit(*args)), calls=20)
        prof = profiled["config4"]
        busy = prof["device_busy_ms"]
        prof["idle_share_vs_median"] = 1 - busy / host_ms
        c4_out.update(median_host_ms=host_ms, median_event_ms=event_ms, profile=prof)
        log(f"[10] config #4 (100 validators): verdict true; median of 20 {host_ms:.3f} ms host / {event_ms:.3f} ms "
            f"events vs the host oracle's {w.host_ms:.1f} ms; profile: {prof['device_kernels']} kernels, "
            f"{prof['launch_calls']} launch calls, device busy {busy:.3f} ms (profiler, profiled sessions "
            f"{prof['sessions']}), idle {prof['idle_share_vs_median']:.3f}")
        for name, ms in prof["top_kernels_ms"]:
            log(f"    {ms:9.4f} ms  {name[:90]}")
    out["config4"] = c4_out
    out["kernel_timing"] = timing

    # -- 3. config #9: the Byzantine mix through BLSAggregateVerifier --------
    addrs = [i.to_bytes(20, "big") for i in range(n_val)]
    keys = {a: pkey for a, pkey in zip(addrs, w.pubkeys)}
    verifier = BLSAggregateVerifier(lambda _h: keys, torch_device=dev)
    bls_keys = _bls_keys(n_val, 0)
    wrong = (b"byzantine" + w.message)[:32]
    c9 = {}
    for nbad in (1, 5):
        bad_set = set(list(dict.fromkeys(i % n_val for i in (17, 3, 42, 66, 91)))[:nbad])
        seals = [CommittedSeal(addrs[i], encode_seal(w.sigs[i])) for i in range(n_val)]
        for i in bad_set:
            seals[i] = CommittedSeal(addrs[i], encode_seal(bls_keys[i].sign(wrong)))
        eq0 = metrics.get_counter(PAIRING_EQS_KEY)
        t0 = time.perf_counter()
        mask = verifier.verify_committed_seals(w.message, seals, 1)
        dt = time.perf_counter() - t0
        eqs = metrics.get_counter(PAIRING_EQS_KEY) - eq0
        expected = np.array([i not in bad_set for i in range(n_val)])
        check(np.array_equal(mask, expected), f"config #9, {nbad} corrupted: the mask == the construction's")
        c9[nbad] = {"pairing_equations": eqs, "wall_ms": dt * 1e3}
    for i in sorted(bad_set)[:2]:  # the host oracle on corrupted lanes
        check(not hbls.verify(w.pubkeys[i], w.message, bls_keys[i].sign(wrong)),
              f"config #9: corrupted seal {i} fails the host oracle")
    out["config9"] = c9
    log(f"[10] config #9 ({n_val} seals): masks == construction with 1 and 5 corrupted; pairing equations "
        f"{c9[1]['pairing_equations']} and {c9[5]['pairing_equations']} ({c9[1]['wall_ms']:.0f} and "
        f"{c9[5]['wall_ms']:.0f} ms)")

    # -- 4. config #13: 64 certificates of a 4-validator committee -----------
    n_certs = 8 if small else 64
    c13 = BLSCommittee(4, seed=13)
    certifier = c13.certifier(device=True, torch_device=dev)
    t0 = time.perf_counter()
    certs = tamper(certificate_batch(c13, c13.certifier(), n_certs))
    log(f"[10] config #13: {n_certs} certificates built ({time.perf_counter() - t0:.1f}s)")
    reset_counts()
    t0 = time.perf_counter()
    batched = certifier.verify_many(certs)
    batched_ms = (time.perf_counter() - t0) * 1e3
    c13_counts = read_counts()
    t0 = time.perf_counter()
    loop = np.array([certifier.verify(c) for c in certs])
    loop_ms = (time.perf_counter() - t0) * 1e3
    expected = np.array([False, False] + [True] * (n_certs - 2))
    check(np.array_equal(batched, expected) and np.array_equal(loop, expected),
          "config #13: batched and per-certificate verdicts == expected (relabeled and bit-flipped rejected)")
    if card:
        check(c13_counts["bls_merge"] == 1 and c13_counts["bls_miller"] == 1 and c13_counts["bls_final_exp"] == 1,
              f"config #13: one launch of each kernel for the batch ({c13_counts})")
    c13_out = {"batched_ms": batched_ms, "per_cert_loop_ms": loop_ms, "launches": c13_counts}
    lanes = [certifier._lane_of(c) for c in certs[2:]]
    if card:
        for reps in (1, 16):
            many = lanes * reps
            vargs, live_idx = vagg._pack_lanes_device(many, dev)
            sg, hh, pkk, pkl, ll = vargs
            npk, pinf = bk.launch_merge(pkk, pkl, True)
            n = sg.shape[0]
            genn = torch.from_numpy(ops._G1_GEN).to(dev).expand(n, 2, 12)
            qn = torch.stack([sg, hh]).contiguous()
            pn = torch.stack([genn, npk]).contiguous()
            fn = bk.launch_miller(qn, pn)
            gn = ~pinf & ll
            row = {
                "lanes": n,
                "multi_aggregate_check_ms": median_ms(
                    lambda many=many: vagg.multi_aggregate_check(many, route="device", torch_device=dev), 3)[0],
                "bls_merge_ms": cuda_time_ms(lambda: bk.launch_merge(pkk, pkl, True), 5),
                "bls_miller_ms": cuda_time_ms(lambda: bk.launch_miller(qn, pn), 3),
                "bls_final_exp_ms": cuda_time_ms(lambda: bk.launch_final_exp(fn, gn), 3),
                "bls_miller_bound": bound(qn.numel() * 4 + pn.numel() * 4 + n * 144 * 4,
                                          n * BLS_MILLER_MULS * OPS_BLS_FP_MUL),
                "bls_final_exp_bound": bound(n * (144 * 4 * 2 + 2), final_exp_ops(n)),
            }
            c13_out[f"lanes_{n}"] = row
            log(f"[10] config #13 at {n} lanes: multi_aggregate_check {row['multi_aggregate_check_ms']:.2f} ms; "
                f"merge {row['bls_merge_ms']:.3f}, miller {row['bls_miller_ms']:.3f}, final_exp "
                f"{row['bls_final_exp_ms']:.3f} ms (events)")
    out["config13"] = c13_out
    log(f"[10] config #13: verify_many {batched_ms:.1f} ms in one batch ({c13_counts}) against the "
        f"per-certificate loop's {loop_ms:.1f} ms, verdicts equal")

    # -- 5. a chain with certificates ------------------------------------------
    n_chain, heights = (4, 2) if small else (16, 8)
    committee = BLSCommittee(n_chain, seed=0)
    me = next(i for i in range(n_chain) if all(committee.proposer(hh) != i for hh in range(1, heights + 1)))
    t0 = time.perf_counter()
    schedules = {hh: committee.schedule(hh) for hh in range(1, heights + 1)}
    log(f"[10] chain: {n_chain} validators x {heights} heights signed ({time.perf_counter() - t0:.1f}s)")
    tmp = tempfile.mkdtemp(prefix="bls_chain_")
    merger = G2MergeTree(torch_device=dev, cutover_points=1)
    chain_certifier = committee.certifier(device=True, aggregator=merger, torch_device=dev)
    senders = DeviceBatchVerifier(committee.src, device=dev)
    seal_verifier = BLSAggregateVerifier(committee.bls_src, torch_device=dev)
    chain = BLSChain(committee, me, senders, seal_verifier, chain_certifier, os.path.join(tmp, "wal.jsonl"))
    reset_counts()
    t0 = time.perf_counter()
    runner = chain.run(heights, schedules)
    chain_s = time.perf_counter() - t0
    chain_counts = read_counts()
    blocks = list(runner.chain)
    check(runner.height == heights + 1 and len(blocks) == heights, f"the chain finalized {heights} heights")
    check(all(b.cert is not None and not b.seals for b in blocks), "every finalized height carries a certificate")
    with open(os.path.join(tmp, "wal.jsonl")) as fh:
        recs = [json.loads(line) for line in fh if '"finalize"' in line]
    check(len(recs) == heights and all("cert" in r for r in recs), "the WAL holds a certificate record a height")
    check(merger.faults == 0 and merger.device_merges >= heights, f"certificates merged on the card ({merger.stats()})")
    if card:
        for name in ("bls_merge", "bls_miller", "bls_final_exp"):
            check(chain_counts[name] > 0, f"the chain launched {name}")
    resumed, replayed = chain.recover()
    check(resumed == heights + 1 and [b.cert for b in replayed] == [b.cert for b in blocks],
          "a fresh runner's recover() reads the certificates back")
    reset_counts()
    t0 = time.perf_counter()
    synced = chain.sync(blocks, HostBatchVerifier(committee.src))
    sync_ms = (time.perf_counter() - t0) * 1e3
    sync_counts = read_counts()
    check([b.height for b in synced] == list(range(1, heights + 1)), "a fresh node synced every height")
    if card:
        check(sync_counts["bls_miller"] == 1 and sync_counts["bls_final_exp"] == 1,
              f"the sync verified the range in one verify_many ({sync_counts})")
    try:
        chain.sync(blocks[:-1] + [relabel_block(blocks[-1])], HostBatchVerifier(committee.src))
        check(False, "a certificate for another proposal hash is rejected")
    except SyncError as e:
        rejected = str(e)
    shutil.rmtree(tmp, ignore_errors=True)
    out["chain"] = {"validators": n_chain, "heights": heights, "wall_s": chain_s,
                    "launches_per_height": {k: v / heights for k, v in chain_counts.items()},
                    "sync_ms": sync_ms, "sync_launches": sync_counts, "rejected": rejected}
    log(f"[10] chain: {heights} heights of {n_chain} validators in {chain_s:.2f} s, a certificate record "
        f"each (WAL fsync on); recover() resumes at {resumed}; sync of {heights} heights in one verify_many "
        f"({sync_ms:.1f} ms, {sync_counts}); relabeled certificate rejected: {rejected!r}")
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"[10] phase 10 took {out['phase_s']:.1f}s")
    report["bls"] = out
    kernels = []
    for name in ("bls_merge", "bls_miller", "bls_final_exp"):
        t = timing.get(name, {})
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": BLS_WHERE[name][0],
            "replaces": BLS_WHERE[name][1],
            "launches": c4[name],
            "chain_launches_per_height": chain_counts[name] / heights,
            "config13_launches": c13_counts[name],
            "max_abs_err": err[name],
            "ms": t.get("ms"),
            "device_ms_per_launch": t.get("device_ms_per_launch"),
            "plain_ms": t.get("plain_ms"),
            "bound_ms": t.get("bound_ms"),
            "bound_by": t.get("bound_by"),
            "library_ms": None,
        })
    return {"kernels": kernels, "config4": c4, "chain_per_height": {k: v / heights for k, v in chain_counts.items()}}


# -- phase 11: the multi-tenant and read planes on the card --------------------

# Config #10's drains: rounds of every tenant at once, and the chains' heights.
SERVING_ROUNDS = 10
SERVING_CHAIN_HEIGHTS = 3
# Config #12: the served chain, its chunks and clients.
SERVING_VALIDATORS, SERVING_HEIGHTS, SERVING_CHUNK, SERVING_CLIENTS = 100, 4, 2, 24
# Config #18's structural sync (its defaults) and the pairing dispatch bound.
CKPT_HEIGHTS, CKPT_SPACING, CKPT_MAX_DISPATCHES = 1_000_000, 1000, 4


def drain_split(records, drain_ms, sig_ms) -> dict:
    """Phase 11a's drain time split by the scheduler's own spans (host
    clock): a request's mean drain (submit to verdicts, ``drain_ms``); the
    mean flush it rode in (``sched.coalesce``, each flush weighted by its
    requests); the dispatcher's share of a flush (``sched.dispatch``); and
    in it the recovery kernel's launches to their verdicts on the host
    (``sig_ms``, the tapped ``_sig_mask``).  The rest of a drain is the wait
    before its flush starts (the coalescing window, a flush in progress)
    and the delivery after it."""
    spans = [(name, dur / 1e3, args or {}) for kind, name, _track, _t0, dur, args in records if kind == "X"]
    flushes = [(ms, args.get("requests", 0)) for name, ms, args in spans if name == "sched.coalesce"]
    dispatches = [ms for name, ms, _args in spans if name == "sched.dispatch"]
    requests = sum(r for _ms, r in flushes)
    per_request = sum(ms * r for ms, r in flushes) / requests
    drain = statistics.mean(drain_ms)
    return {
        "requests": len(drain_ms), "flushes": len(flushes), "recovery_launches": len(sig_ms),
        "drain_mean_ms": drain, "drain_p50_ms": statistics.median(drain_ms),
        "flush_mean_ms": statistics.mean(ms for ms, _r in flushes),
        "flush_per_request_ms": per_request,
        "dispatch_mean_ms": statistics.mean(dispatches),
        "recovery_to_host_per_flush_ms": sum(sig_ms) / len(flushes),
        "outside_flush_per_request_ms": drain - per_request,
    }


def serving_phase(report: dict, ident: str, counts, holds, dev=None, small: bool = False) -> dict:
    """Phase 11: the multi-tenant and read planes on the card.

    Every scheduler here has its route set to ``"device"`` and one tapped
    :class:`~go_ibft_tpu_torch.sched.CoalescedDispatcher` on ``dev``, which
    keeps the first inputs of each shape it gives the two kernels (held
    against the plain versions at the end, once no count is read any more).
    (a) config #10: 8 committees of 4-8 validators and one of 100 drain a
    round's PREPARE senders (one oversize PREPREPARE among them) and COMMIT
    seal lanes from a thread each, ``SERVING_ROUNDS`` times, every mask
    against the tenant's host oracle over Python ints; then config #10's
    chains, concurrently and serially.  (b) config #12: a finalized
    100-validator chain of 4 heights served in chunks of 2 through a
    read-tier tenant; the per-lane oracle gate, a tampered proof, cold
    against warm cache, 24 coalesced clients against 24 per-client
    sequential ones, and the QoS bound.  (c) config #18: an HTTP cold sync
    over ``ProofApiServer`` with ``CheckpointVerifier(device=True)``, the
    spliced-diff attack, and the million-height structural sync.  Any
    flush fault, shed lane, host-routed flush, fallback, breaker trip,
    mask that differs from its oracle or missed height fails the run.
    Times are host clock on the card ``ident`` names.  ``dev``/``small``
    run the orchestration on the CPU at a small size (plain versions, no
    counts checked).  Returns the phase's launch counts per kernel."""
    import json as _json
    import threading

    import numpy as np

    from go_ibft_tpu_torch.bench import serving as sv
    from go_ibft_tpu_torch.crypto import ecdsa
    from go_ibft_tpu_torch.crypto.backend import proposal_hash_of
    from go_ibft_tpu_torch.lightsync import CheckpointClient, skip_path
    from go_ibft_tpu_torch.node import ProofApiServer
    from go_ibft_tpu_torch.obs import trace
    from go_ibft_tpu_torch.sched import DRAIN_MS_KEY, CoalescedDispatcher, TenantScheduler
    from go_ibft_tpu_torch.serve import (
        FinalityProof, ProofBuilder, ProofCache, ProofError, ProofServer, ProofVerifier, SigVerdictCache,
        any_signer_source,
    )
    from go_ibft_tpu_torch.utils import metrics
    from go_ibft_tpu_torch.verify import HostBatchVerifier

    dev = torch.device("cuda") if dev is None else dev
    card = dev.type == "cuda"
    reset_counts, read_counts = counts
    hold_digest, hold_recovery = holds
    out: dict = {"gpu": ident}
    t_phase = time.perf_counter()
    kept: dict = {}

    class Tapped(CoalescedDispatcher):
        """The device route, keeping the first live inputs of each shape,
        and the host time of each launch of the recovery kernel to its
        verdicts on the host (``sig_ms``)."""

        sig_ms: list = []

        def _upload(self, name, a):
            t = super()._upload(name, a)
            if name == "blocks":
                self._blocks = t
            elif name == "counts":
                key = ("keccak256_digest", tuple(self._blocks.shape))
                if key not in kept:
                    kept[key] = (self._blocks.clone(), t.clone())
            return t

        def _sig_mask(self, inputs, table):
            key = ("secp256k1_recover", tuple(inputs[3].shape))
            if key not in kept:
                kept[key] = tuple(x.clone() for x in inputs[:4])
            t0 = time.perf_counter()
            try:
                return super()._sig_mask(inputs, table)
            finally:
                self.sig_ms.append((time.perf_counter() - t0) * 1e3)

    dispatcher = Tapped("device", torch_device=dev)
    dispatcher.warmup(lanes=(8, 32, 128, 512))

    def scheduler(**kw):
        return TenantScheduler(route="device", dispatcher=dispatcher, **kw)

    def clean(sched, what):
        stats = sched.stats()
        sheds = sum(t["shed_lanes"] for t in stats["tenants"].values())
        check(stats["flush_faults"] == 0 and sheds == 0,
              f"{what}: no flush fault and no shed lane ({stats['flush_faults']}, {sheds})")
        check(dispatcher.routes["host"] == 0, f"{what}: every flush on the device route ({dispatcher.routes})")
        no_host_fallback(what)
        return stats

    metrics.reset()
    reset_counts()

    # -- (a) config #10: coalesced multi-tenant drains ----------------------
    sizes = sv.CONFIG10_SIZES + (SERVING_VALIDATORS,) if not small else (4, 6, 8)
    tenants = sv.build_tenants(sizes)
    oracle = {t.tid: sv.oracle_masks(t) for t in tenants}
    rounds = SERVING_ROUNDS if not small else 1
    sched = scheduler(window_s=0.002)
    before = read_counts()
    rec = trace.enable()
    t0 = time.perf_counter()
    with sched:
        masks = sv.coalesced_drains(sched, tenants, rounds)
    a_wall = time.perf_counter() - t0
    trace.disable()
    split = drain_split(rec.snapshot(), metrics.get_histogram(DRAIN_MS_KEY), dispatcher.sig_ms)
    a_counts = {k: v - before[k] for k, v in read_counts().items()}
    stats = clean(sched, "11a drains")
    for t in tenants:
        for senders, seals in masks[t.tid]:
            check(np.array_equal(senders, oracle[t.tid][0]) and np.array_equal(seals, oracle[t.tid][1]),
                  f"11a {t.tid}: masks == the tenant's HostBatchVerifier")
    dispatches = stats["dispatches"]
    a = {
        "tenants": {t.tid: {"senders": len(t.senders), "seal_lanes": len(t.lanes),
                            "drain_p50_ms": stats["tenants"][t.tid]["drain_p50_ms"],
                            "drain_p99_ms": stats["tenants"][t.tid]["drain_p99_ms"]} for t in tenants},
        "rounds": rounds, "wall_s": a_wall, "dispatches": dispatches,
        "requests_per_dispatch": stats["coalesce_ratio"], "lanes": stats["coalesced_lanes"],
        "digest_launches_per_dispatch": a_counts["keccak256_digest"] / max(dispatches, 1),
        "recovery_launches_per_dispatch": a_counts["secp256k1_recover"] / max(dispatches, 1),
    }
    if card:
        check(a_counts["keccak256_digest"] > 0 and a_counts["secp256k1_recover"] > 0,
              "11a: the digest and recovery kernels launched")
    log(f"[11] a {len(tenants)} tenants ({', '.join(str(n) for n in sizes)} validators) x {rounds} rounds, "
        f"{stats['coalesced_lanes']} lanes: every mask == its tenant's host oracle (an oversize PREPREPARE and "
        f"one shared proposal hash among them); {dispatches} dispatches, {stats['coalesce_ratio']} requests a "
        f"dispatch, {a['digest_launches_per_dispatch']:.2f} digest and {a['recovery_launches_per_dispatch']:.2f} "
        f"recovery launches a dispatch, {a_wall:.3f} s ({ident})")
    for tid, row in a["tenants"].items():
        log(f"    {tid}: drain p50 {row['drain_p50_ms']:.3f} ms, p99 {row['drain_p99_ms']:.3f} ms")
    a["drain_split"] = split
    log(f"[11] a drain split (spans sched.coalesce and sched.dispatch, host clock, {ident}): "
        + _json.dumps({k: round(v, 4) if isinstance(v, float) else v for k, v in split.items()}))
    chain_sizes = sv.CONFIG10_SIZES if not small else (4,)
    chain_heights = SERVING_CHAIN_HEIGHTS if not small else 1
    runs = {}
    for variant, concurrent in (("concurrent", True), ("serial", False)):
        csched = scheduler(window_s=0.001)
        with csched:
            runs[variant] = sv.run_chains(csched, chain_sizes, chain_heights, concurrent=concurrent, tag=variant[:2])
        runs[variant]["stats"] = {k: v for k, v in clean(csched, f"11a {variant} chains").items() if k != "tenants"}
        check(runs[variant]["starved"] == 0, f"11a {variant}: every chain finalized every height "
                                             f"({runs[variant]['finalized']})")
    a["chains"] = runs
    log(f"[11] a {len(chain_sizes)} ChainRunner chains x {chain_heights} heights through one scheduler: "
        f"{runs['concurrent']['blocks_per_s']:.2f} blocks/s concurrently ({runs['concurrent']['elapsed_s']:.3f} s, "
        f"{runs['concurrent']['stats']['coalesce_ratio']} requests a dispatch) against "
        f"{runs['serial']['blocks_per_s']:.2f} serially ({runs['serial']['elapsed_s']:.3f} s); no height missed")
    out["a"] = a

    # -- (b) config #12: proof serving --------------------------------------
    n = SERVING_VALIDATORS if not small else 8
    blocks, src, _keys = sv.serving_chain(n, SERVING_HEIGHTS)
    quorum = len(blocks[0].seals)
    reqs = sv.schedule(SERVING_HEIGHTS, SERVING_CHUNK)
    host = HostBatchVerifier(src, recover_fn=ecdsa.recover_pure)
    clients = SERVING_CLIENTS if not small else 3
    b: dict = {"validators": n, "heights": SERVING_HEIGHTS, "quorum": quorum, "clients": clients}
    rsched = scheduler(window_s=0.002)
    with rsched:
        builder = ProofBuilder(sv.ListSource(blocks), src)
        recording = sv.RecordingLanes(rsched.register("c12-gate", any_signer_source, priority="read"))
        gate = ProofVerifier(lane_verifier=recording, torch_device=dev)
        for checkpoint, target in reqs:
            gate.verify(builder.build(checkpoint, target), src(checkpoint + 1))
        check(bool(recording.lanes), "11b: the oracle gate drained lanes")
        want = np.asarray(host.verify_seal_lanes(recording.lanes, 1), dtype=bool)
        check(np.array_equal(np.asarray(recording.masks, dtype=bool), want),
              f"11b: {len(recording.lanes)} served lanes' verdicts == HostBatchVerifier lane for lane")
        tampered, bad = sv.tamper(builder.build(0, SERVING_HEIGHTS), quorum)
        try:
            ProofVerifier(lane_verifier=recording, torch_device=dev).verify(tampered, src(1))
        except ProofError as err:
            b["tampered_error"] = str(err)
        else:
            check(False, "11b: a tampered proof is rejected")
        phash = proposal_hash_of(tampered.entries[0].proposal)
        check(not host.verify_seal_lanes([(phash, s) for s in bad], 1).any(),
              "11b: the oracle rejects every tampered seal")
        server = ProofServer(ProofBuilder(sv.ListSource(blocks), src), ProofCache(chunk_heights=SERVING_CHUNK),
                             scheduler=rsched, torch_device=dev)
        passes = []
        for _ in range(2):
            t0 = time.perf_counter()
            for checkpoint, target in reqs:
                server.get_proof(checkpoint, target)
            passes.append(time.perf_counter() - t0)
        b["cold_proofs_per_s"], b["warm_proofs_per_s"] = (len(reqs) / s for s in passes)
        proof = server.get_proof(0, SERVING_HEIGHTS)
        errors: list = []

        def client():
            try:
                server.verify_proof(proof, src(1))
            except BaseException as e:  # noqa: BLE001 - surfaced below
                errors.append(e)

        t0 = time.perf_counter()
        threads = [threading.Thread(target=client) for _ in range(clients)]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        coalesced_s = time.perf_counter() - t0
        check(not errors, f"11b: every coalesced client verified ({errors[:1]})")
        serve_stats = server.stats()
        t0 = time.perf_counter()
        for _ in range(clients):
            # No scheduler: its own DispatcherLanes on the card.
            ProofVerifier(torch_device=dev, sig_cache=SigVerdictCache()).verify(proof, src(1))
        per_client_s = time.perf_counter() - t0
        b.update(coalesced_proofs_per_s=clients / coalesced_s, per_client_proofs_per_s=clients / per_client_s,
                 sig_cache=serve_stats["verify"]["sig_cache"], cache=serve_stats["cache"])
        qos = sv.proof_flood_qos(rsched, blocks[:SERVING_HEIGHTS], src, torch_device=dev)
        server.close()
    check(qos["missed"] == 0, f"11b: the live chain missed no height under the proof flood ({qos})")
    b["qos"] = qos
    b["stats"] = {k: v for k, v in clean(rsched, "11b serving").items() if k != "tenants"}
    log(f"[11] b config #12, {n} validators x {SERVING_HEIGHTS} heights, chunks of {SERVING_CHUNK}: every "
        f"served verdict == HostBatchVerifier, a tampered proof rejected; cold {b['cold_proofs_per_s']:.2f} "
        f"against warm {b['warm_proofs_per_s']:.2f} proofs/s; {clients} clients coalesced "
        f"{b['coalesced_proofs_per_s']:.2f} against per-client sequential {b['per_client_proofs_per_s']:.2f} "
        f"proofs/s; QoS: a 4-validator chain finalized {qos['finalized']} beside {qos['flood_proofs']} flood "
        f"proofs; {b['stats']['dispatches']} dispatches ({ident})")
    out["b"] = b
    ab_counts = read_counts()

    # -- (c) config #18: checkpoint-anchored cold sync ------------------------
    c: dict = {}
    blocks18, validators, registry, ckpt, set_a, set_b = sv.checkpoint_chain()
    csched = scheduler(window_s=0.002)
    with csched:
        source = sv.ListSource(blocks18)
        server = ProofServer(ProofBuilder(source, validators), ProofCache(chunk_heights=4), scheduler=csched,
                             torch_device=dev)
        api = ProofApiServer(server, source.latest_height, checkpoints_fn=ckpt.wire_payload)
        api.start()
        try:
            # The client's own checks on the card: the pairings and its
            # bridge proof's seal lanes (a DispatcherLanes of its own; the
            # server's self-check drains through csched).
            client = CheckpointClient(api.url, registry, torch_device=dev)
            before, server_sigs = read_counts(), len(dispatcher.sig_ms)
            t0 = time.perf_counter()
            rep = client.cold_sync(set_a)
            c["real_sync_s"] = time.perf_counter() - t0
            c["client_recovery_launches"] = (read_counts()["secp256k1_recover"] - before["secp256k1_recover"]
                                             - (len(dispatcher.sig_ms) - server_sigs))
            if card:
                check(c["client_recovery_launches"] > 0,
                      f"11c: the client's bridge seals launched secp256k1_recover ({c['client_recovery_launches']})")
            check(rep.anchor_height == len(blocks18) and rep.bridge_bytes > 0 and rep.powers == set_b,
                  f"11c: the cold sync anchors at the head across the rotation ({rep})")
            check(rep.pairing_dispatches <= CKPT_MAX_DISPATCHES,
                  f"11c: at most {CKPT_MAX_DISPATCHES} batched pairing dispatches ({rep.pairing_dispatches})")
            payload, _nb = client.fetch_proof(8, len(blocks18))
            payload["proof"]["diffs"].append({"height": len(blocks18) - 1, "added": {"ab" * 20: 1000},
                                              "removed": []})
            try:
                ProofVerifier(require_commitments=True, torch_device=dev).verify(
                    FinalityProof.from_wire(_json.loads(_json.dumps(payload["proof"]))), validators(8))
            except ProofError as err:
                check("next-set root" in str(err), f"11c: the splice dies at the commitment check ({err})")
                c["splice_error"] = str(err)
            else:
                check(False, "11c: the spliced-diff attack is rejected")
        finally:
            api.stop()
            server.close()
    clean(csched, "11c checkpoint sync")
    c["real"] = {"anchor_height": rep.anchor_height, "total_bytes": rep.total_bytes,
                 "bridge_bytes": rep.bridge_bytes, "pairing_dispatches": rep.pairing_dispatches}
    heights = CKPT_HEIGHTS if not small else 8 * CKPT_SPACING
    t0 = time.perf_counter()
    ck2, registry2, powers2, heights = sv.structural_checkpointer(heights, CKPT_SPACING)
    c["structural_build_s"] = time.perf_counter() - t0
    api2 = ProofApiServer(None, lambda: heights, checkpoints_fn=ck2.wire_payload)
    api2.start()
    try:
        t0 = time.perf_counter()
        rep2 = CheckpointClient(api2.url, registry2, torch_device=dev).cold_sync(powers2)
        c["structural_sync_s"] = time.perf_counter() - t0
    finally:
        api2.stop()
    epochs = heights // CKPT_SPACING
    check(rep2.anchor_height == heights and rep2.tail_bytes == 0 and rep2.checkpoint_lanes == len(skip_path(epochs)),
          f"11c: the structural sync anchors at {heights} on {len(skip_path(epochs))} records ({rep2})")
    check(rep2.pairing_dispatches <= CKPT_MAX_DISPATCHES,
          f"11c structural: at most {CKPT_MAX_DISPATCHES} pairing dispatches ({rep2.pairing_dispatches})")
    c["structural"] = {"heights": heights, "spacing": CKPT_SPACING, "records": rep2.checkpoint_lanes,
                       "checkpoint_bytes": rep2.total_bytes, "pairing_dispatches": rep2.pairing_dispatches}
    launches = read_counts()
    c_counts = {k: v - ab_counts[k] for k, v in launches.items()}
    if card:
        for name in ("bls_merge", "bls_miller", "bls_final_exp"):
            check(c_counts[name] > 0, f"11c: {name} launched")
    out["c"] = c
    log(f"[11] c config #18: a {len(blocks18)}-height chain (rotation at 10, a checkpoint every 4, BLS quorum "
        f"seals) cold-synced over HTTP in {c['real_sync_s']:.3f} s, {rep.pairing_dispatches} pairing "
        f"dispatch(es), {rep.total_bytes} B; the splice died at the commitment check; {heights:,} heights at "
        f"spacing {CKPT_SPACING}: {rep2.checkpoint_lanes} records, {rep2.total_bytes} B, "
        f"{rep2.pairing_dispatches} dispatch(es), built in {c['structural_build_s']:.2f} s (lazy BLS signing on "
        f"the host), synced in {c['structural_sync_s']:.3f} s; launches {c_counts}")

    # -- the kernels at the phase's own inputs -------------------------------
    for (name, shape), ins in sorted(kept.items(), key=str):
        if name == "keccak256_digest":
            hold_digest(*ins, f"the coalesced dispatch at {shape}")
        else:
            hold_recovery(ins, f"secp256k1_recover kernel == plain on the coalesced {shape[0]} lanes")
    out["held_shapes"] = sorted(f"{name} {shape}" for name, shape in kept)
    for name in ("keccak256_digest", "secp256k1_recover"):
        check(any(k == name for k, _ in kept), f"11: the coalesced {name} inputs held")
    out["launches"] = launches
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"[11] the kernels bit-exact against plain at the phase's inputs: {out['held_shapes']}; "
        f"phase launches {launches}; phase 11 took {out['phase_s']:.1f} s ({ident})")
    report["serving"] = out
    return launches


# -- phase 12: the mesh and the lock-step cluster on the card ------------------

# The mesh's shards on one card, and the real-ECDSA cluster's size (bench/'s
# seeded keys) and heights; config #16's heights a run (bench.py's default
# is 3: 2 keep the phase near its budget).
CLUSTER_MESH_SHARDS = 4
CLUSTER_REAL_VALIDATORS, CLUSTER_REAL_HEIGHTS = 100, 3
CLUSTER16_HEIGHTS = 2


def cluster_phase(report: dict, ident: str, counts, holds, rounds: dict, dev=None, small: bool = False) -> dict:
    """Phase 12: the mesh and the lock-step cluster on the card.

    (a) the mesh: for each round of ``rounds`` (label -> ``(round, source,
    single-device verifier)``) and each layout (``[card] * 4``, and every
    card when there are two or more), ``mesh_quorum_certify`` and
    ``mesh_seal_quorum_certify`` against one device's ``quorum_certify`` /
    ``seal_quorum_certify`` (mask, verdict, lo, hi), a ``MeshBatchVerifier``
    drain (a recovery launch a shard) and ``certify_round`` against the
    single-device verifier and the host oracle, both timed (median of 20);
    then a ``CoalescedDispatcher`` on the mesh route against the
    single-device one.  (b) config #15: 100 sim-crypto validators x 5
    heights lock-step against loopback, every chain ``sim_block(h)``, and
    the 1,000-validator structural tick in one ``ici_tick`` dispatch, on one
    card and on its 4 shards.  (c) 100 real-ECDSA validators (bench/'s
    seeded keys), ``CLUSTER_REAL_HEIGHTS`` heights on a hub whose
    ``DeviceBatchVerifier`` drains each tick's gathered rows and serves
    every engine through ``hub.tick_verifier()``, on one shard and on 4:
    chains equal a loopback run of the same keys on ``HostBatchVerifier``,
    no host fallback.  (d) config #16: 100 validators over ``wan3`` (seed
    2026), clean then with the 30 %-power adversary mix, monitor on:
    invariants, honest liveness and the SLO gate.  The digest and recovery
    kernels are held bit-exact against their plain versions at the mesh
    shard's and the tick shard's shapes.  Times are host clock on the card
    ``ident`` names.  ``dev``/``small`` run the orchestration on the CPU at
    a small size (plain versions, no counts checked).  Returns
    ``{"mesh": launches, "cluster": launches}`` per kernel."""
    import asyncio

    import numpy as np

    from go_ibft_tpu_torch import convert
    from go_ibft_tpu_torch.bench import cluster as bc
    from go_ibft_tpu_torch.bench.workload import _keys
    from go_ibft_tpu_torch.crypto import ecdsa
    from go_ibft_tpu_torch.crypto.backend import ECDSABackend
    from go_ibft_tpu_torch.crypto.keccak import keccak256
    from go_ibft_tpu_torch.net import IciLockstepTransport
    from go_ibft_tpu_torch.obs import ledger as cost_ledger
    from go_ibft_tpu_torch.ops import ecrecover, quorum
    from go_ibft_tpu_torch.parallel import make_mesh, mesh_quorum_certify, mesh_seal_quorum_certify
    from go_ibft_tpu_torch.sched import CoalescedDispatcher
    from go_ibft_tpu_torch.utils import metrics
    from go_ibft_tpu_torch.verify import DeviceBatchVerifier, HostBatchVerifier, MeshBatchVerifier
    from go_ibft_tpu_torch.verify.batch import _as_signed, pack_sender_lanes

    dev = torch.device("cuda", torch.cuda.current_device()) if dev is None else dev
    card = dev.type == "cuda"
    reset_counts, read_counts = counts
    hold_digest, hold_recovery = holds
    out: dict = {"gpu": ident}
    t_phase = time.perf_counter()
    metrics.reset()
    ledger_was_on = cost_ledger.enabled()
    cost_ledger.enable()
    shards = CLUSTER_MESH_SHARDS if not small else 2

    def host_ms(fn, calls=20):
        if card:
            return median_ms(fn, calls=calls)[0]
        t0 = time.perf_counter()
        fn()
        return (time.perf_counter() - t0) * 1e3

    launched = {"mesh": {}, "cluster": {}}

    def certified(fn):
        """``tally("mesh", fn)`` and the ``certify_lanes`` launches it made."""
        before = read_counts()["certify_lanes"]
        got = tally("mesh", fn)
        return got, read_counts()["certify_lanes"] - before

    def tally(kind, fn):
        """``fn()``, its kernel launches added to ``launched[kind]``."""
        before = read_counts()
        try:
            return fn()
        finally:
            after = read_counts()
            for name in after:
                launched[kind][name] = launched[kind].get(name, 0) + after[name] - before[name]

    layouts = [(f"{shards} shards of one card" if card else f"{shards} CPU shards", [dev] * shards)]
    if card and torch.cuda.device_count() >= 2:
        layouts.append(("every card", [torch.device("cuda", i) for i in range(torch.cuda.device_count())]))
    reset_counts()

    # -- (a) the mesh ----------------------------------------------------------
    mesh_out = {}
    for label, (rnd, src, single) in rounds.items():
        hp, hs = host_masks(rnd, ecdsa, keccak256, rnd.height)
        a = convert.round_args(rnd.pack(), device=dev)
        tail = (a[14], a[15], int(a[16]), int(a[17]))
        q_args = (a[0], a[1], a[2], a[3], a[4], a[5], a[13], a[6]) + tail
        s_args = (a[7], a[8], a[9], a[10], a[11], a[13], a[12]) + tail
        want_q = [x.cpu() for x in quorum.quorum_certify(*q_args)]
        want_s = [x.cpu() for x in quorum.seal_quorum_certify(*s_args)]
        one = single.certify_round(rnd.prepares, rnd.proposal_hash, rnd.seals, rnd.height)
        check(list(one[0]) == hp and list(one[2]) == hs, f"12a {label}: the single device's masks == host oracle")
        one_ms = host_ms(lambda: single.certify_round(rnd.prepares, rnd.proposal_hash, rnd.seals, rnd.height))
        for name, devices in layouts:
            for vp in (1, 2):
                mesh = make_mesh(devices=devices, vp=vp)
                got_q, n_q = certified(lambda: [x.cpu() for x in mesh_quorum_certify(mesh)(*q_args)])
                got_s, n_s = certified(lambda: [x.cpu() for x in mesh_seal_quorum_certify(mesh)(*s_args)])
                check(all(torch.equal(x, y) for x, y in zip(got_q + got_s, want_q + want_s)),
                      f"12a {label}, {name}, vp={vp}: sharded certify == one device's (mask, reached, lo, hi)")
                check(not card or n_q == n_s == 1,
                      f"12a {label}, {name}, vp={vp}: one certify_lanes launch a sharded certify ({n_q}, {n_s})")
            mv = MeshBatchVerifier(src, devices=devices)
            before = read_counts()["secp256k1_recover"]
            mask, n_drain = certified(lambda: mv.verify_senders(rnd.prepares))
            rec = read_counts()["secp256k1_recover"] - before
            check(not card or rec == n_drain == mv.dp,
                  f"12a {label}, {name}: a drain's recovery and certify_lanes launches == dp ({rec}, {n_drain}, {mv.dp})")
            check(list(mask) == hp, f"12a {label}, {name}: the mesh drain's mask == host oracle")
            res, n_round = certified(lambda: mv.certify_round(rnd.prepares, rnd.proposal_hash, rnd.seals, rnd.height))
            check(list(res[0]) == hp and list(res[2]) == hs and res[1] == one[1] and res[3] == one[3],
                  f"12a {label}, {name}: mesh certify_round == single device and host oracle")
            check(not card or n_round == 2 * mv.dp,
                  f"12a {label}, {name}: a mesh certify_round's certify_lanes launches == 2 dp ({n_round})")
            ms = tally("mesh", lambda: host_ms(
                lambda: mv.certify_round(rnd.prepares, rnd.proposal_hash, rnd.seals, rnd.height)))
            mesh_out[f"{label}, {name}"] = {"mesh_certify_round_ms": ms, "single_certify_round_ms": one_ms,
                                            "recovery_launches_a_drain": rec, "dp": mv.dp,
                                            "lo_hi": [int(want_q[2]), int(want_q[3])]}
            mesh_out[f"{label}, {name}"]["certify_lanes_launches"] = {
                "sharded_certify": n_q, "drain": n_drain, "certify_round": n_round}
            log(f"[12a] {label}, {name}: masks, verdicts and lo/hi == one device and the host oracle; "
                f"a drain {rec} recovery and {n_drain} certify_lanes launches (dp {mv.dp}), a sharded certify "
                f"{n_q} certify_lanes launch, a certify_round {n_round}; certify_round median of 20 {ms:.3f} ms "
                f"on the mesh, {one_ms:.3f} ms on one device")
    rnd, _, _ = next(iter(rounds.values()))
    lanes = [(rnd.proposal_hash, s) for s in rnd.seals]
    sharded = CoalescedDispatcher("device", devices=layouts[0][1])
    got = tally("mesh", lambda: sharded.dispatch(rnd.prepares, lanes))
    want = CoalescedDispatcher("device", torch_device=dev).dispatch(rnd.prepares, lanes)
    check(sharded.describe()["sharded"] and all(np.array_equal(x, y) for x, y in zip(got, want)),
          "12a: the dispatcher's mesh route == its single-device route")
    no_host_fallback("12a")
    prof = report.get("mesh_certify_round_profile")
    if prof is not None:
        out["mesh_certify_round_profile"] = prof
        log(f"[12a] a profiled 100-validator mesh certify_round over {CLUSTER_MESH_SHARDS} shards (the "
            f"--main-profile process): {prof['device_kernels']} device events, {prof['launch_calls']} launch "
            f"calls, busy {prof['device_busy_ms']:.3f} ms: {[(n[:40], round(ms, 5)) for n, ms in prof['events']]}")
    out["mesh"] = mesh_out
    log(f"[12a] the dispatcher's mesh route ({sharded.dp} shards) == single device; "
        f"mesh launches {launched['mesh']}")

    # -- (b) config #15: sim crypto, lock-step against loopback -------------------
    c15_kw = {} if not small else dict(nodes=16, heights=2, struct_nodes=64)
    out["config15"] = {}
    for name, devices in (("one card" if card else "one CPU", None if card else [dev]), (layouts[0][0], layouts[0][1])):
        try:
            c15 = bc.config15(devices, **c15_kw)
        except AssertionError as err:
            check(False, f"12b config #15 on {name}: {err}")
        check(c15["structural"]["dispatches"] == 1, f"12b config #15 on {name}: the structural tick is one dispatch")
        out["config15"][name] = c15
        st = c15["structural"]
        log(f"[12b] config #15 on {name} ({c15['route']}, {c15['devices']} devices): {c15['nodes']} validators x "
            f"{c15['heights']} heights, every chain == sim_block(h); lock-step {c15['lock_heights_per_s']:.3f} "
            f"heights/s, loopback {c15['loop_heights_per_s']:.3f}, {c15['messages_per_tick']:.1f} messages a "
            f"tick over {c15['ticks']} ticks; {st['nodes']}-validator tick: {st['dispatches']} dispatch, "
            f"{st['tick_s'] * 1e3:.1f} ms, {st['delivered']} deliveries, occupancy {st['occupancy']:.3f}")

    # -- (c) real ECDSA on the card: tick-fused rows ------------------------------
    n_real, heights = (CLUSTER_REAL_VALIDATORS, CLUSTER_REAL_HEIGHTS) if not small else (4, 1)
    keys = _keys(n_real, 0)
    src = ECDSABackend.static_validators({k.address: 1 for k in keys})
    verifier = DeviceBatchVerifier(src, device=dev)
    verifier.warmup(lanes=(8, 32, 128))
    loop_chains, loop_s = asyncio.run(bc.loopback_real_crypto(
        keys, range(1, heights + 1), batch_verifier_for=HostBatchVerifier))
    out["real_crypto"] = {"loopback_s": loop_s}
    for name, devices in (("one shard", [dev]), (f"{shards} shards", [dev] * shards)):
        before_ticks = bc.tick_dispatches()
        c0 = read_counts()
        hub, chains, lock_s = tally("cluster", lambda: asyncio.run(bc.lockstep_real_crypto(
            keys, range(1, heights + 1), devices=devices, verifier=verifier)))
        used = {k: read_counts()[k] - c0[k] for k in c0}
        live_ticks = bc.tick_dispatches() - before_ticks
        check(chains == loop_chains and all(len(c) == heights for c in chains),
              f"12c {name}: {n_real} real-ECDSA chains == the loopback run's on the host verifier")
        check(hub.stats()["bad_slots"] == 0, f"12c {name}: no bad slot")
        no_host_fallback(f"12c {name}")
        if card:
            check(0 < used["keccak256_digest"] <= live_ticks * hub.devices and used["secp256k1_recover"] > 0,
                  f"12c {name}: the digest launched on the tick's shards and the recovery on the drains ({used})")
        per = {k: {"per_tick": used[k] / max(live_ticks, 1), "per_height": used[k] / heights}
               for k in ("keccak256_digest", "secp256k1_recover")}
        out["real_crypto"][name] = {"lock_s": lock_s, "ticks": hub.stats()["ticks"], "live_ticks": live_ticks,
                                    "launches": used, "per": per, "route": hub.stats()["route"]}
        log(f"[12c] {name} ({hub.stats()['route']}): {n_real} real-ECDSA validators x {heights} heights in "
            f"{lock_s:.2f} s (loopback on the host verifier {loop_s:.2f} s), chains == loopback; {live_ticks} "
            f"live ticks of {hub.stats()['ticks']}; digest {per['keccak256_digest']['per_tick']:.2f} a live tick, "
            f"{per['keccak256_digest']['per_height']:.1f} a height; recovery "
            f"{per['secp256k1_recover']['per_tick']:.2f} a live tick, {per['secp256k1_recover']['per_height']:.1f} "
            f"a height")

    # -- (d) config #16: the Byzantine soak ---------------------------------------
    c16_kw = dict(heights=CLUSTER16_HEIGHTS) if not small else dict(nodes=16, heights=1)
    try:
        c16 = bc.config16([dev] * shards, **c16_kw)
    except AssertionError as err:
        check(False, f"12d config #16: {err}")
    out["config16"] = c16
    print(c16["replay"], flush=True)
    log(f"[12d] config #16: {c16['nodes']} validators, {c16['preset']}, seed {c16['seed']}, "
        f"{len(c16['adversaries'])} adversaries, {c16['heights']} heights a run; invariants {c16['invariants']}; "
        f"clean {c16['clean_heights_per_s']:.3f} heights/s, degraded {c16['degraded_heights_per_s']:.3f}, "
        f"ratio {c16['overhead_x']:.3f}; SLO {sorted(set(s for _, s in c16['slo']))}")

    # -- the kernels at the phase's own shapes ---------------------------------------
    rnd, _, _ = next(iter(rounds.values()))
    step = MeshBatchVerifier(src, devices=[dev] * shards)._pad_lanes(len(rnd.prepares)) // shards
    packed = pack_sender_lanes(rnd.prepares, pad_lanes=step * shards)
    blocks = torch.from_numpy(_as_signed(packed.blocks[:step])).to(dev)
    counts_ = torch.from_numpy(packed.counts[:step]).to(dev)
    hold_digest(blocks, counts_, f"a mesh shard's {step} envelopes")
    zw = quorum.digest_words(blocks, counts_)
    ins = (zw,) + tuple(torch.from_numpy(_as_signed(getattr(packed, k)[:step])).to(dev) for k in ("r", "s", "v"))
    hold_recovery(ins, f"secp256k1_recover kernel == plain on a mesh shard's {step} lanes")
    hub = IciLockstepTransport(len(rnd.prepares), devices=[dev] * shards, max_bytes=4096, verifier=object())
    for i, msg in enumerate(rnd.prepares):
        hub.port(i).multicast(msg)
    hub._pack()
    _, _, arrays = hub._pack_rows()
    tick_step = arrays[0].shape[0] // shards
    hold_digest(torch.from_numpy(_as_signed(arrays[0][:tick_step])).to(dev),
                torch.from_numpy(arrays[1][:tick_step]).to(dev), f"a tick shard's {tick_step} rows")
    out["held_shapes"] = [f"keccak256_digest {tuple(blocks.shape)}", f"secp256k1_recover ({step},)",
                          f"keccak256_digest ({tick_step}, {arrays[0].shape[1]}, 17, 2)"]
    if not ledger_was_on:
        cost_ledger.disable()
    out["launches"] = launched
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"[12] the kernels bit-exact against plain at the phase's shapes: {out['held_shapes']}; mesh launches "
        f"{launched['mesh']}, cluster launches {launched['cluster']}; phase 12 took {out['phase_s']:.1f} s ({ident})")
    report["cluster"] = out
    return launched


# -- phase 13: the validator process on the card -------------------------------

# The main path's four registry families (the restriction the boot legs fall
# back to if their nvcc builds ever push the script near its limit; the legs
# restore every family today), the in-process warm start's WAL (100
# validators x 8 finalized heights) and the fleet (4 node processes, 3 gated
# heights, 64 held client connections: sim/fleet.py's defaults).
BOOT_MAIN_FAMILIES = ("digest_words_8l", "ecdsa_recover_8l", "round_certify_8l", "quorum_certify_8l")
WARM_VALIDATORS, WARM_HEIGHTS = 100, 8
FLEET_NODES, FLEET_HEIGHTS, FLEET_CONNECTIONS = 4, 3, 64
CARD_KERNELS = ("secp256k1_recover", "keccak256_digest")


def validator_phase(report: dict, ident: str, counts, holds, dev=None, small: bool = False) -> dict:
    """Phase 13: the validator process on the card.

    (a) restart to first finalized, two real restarts: two
    ``python -m go_ibft_tpu_torch.boot`` children (``boot/restart.py``) on
    one fresh kernel build cache, each restoring every registry family on
    the card and then finalizing one height of a 3-validator cluster whose
    engines verify on the card; the cold leg must report a cold program
    (its ``nvcc`` builds), the cached leg none and no compile event in its
    own ledger.  (b) ``ChainRunner.warm_start`` in process: a runner over a
    WAL of 8 finalized 100-validator heights with a ``TenantScheduler``
    handle on the card restores the main path's four families, recovers to
    height 8 and seeds one verdict a WAL seal; those seals then verify with
    no recovery launch; the digest and recovery kernels are held bit-exact
    against their plain versions at the registry's inputs.  (c) where
    ``grpc`` imports: ``sim/fleet.py`` with 4 ``python -m
    go_ibft_tpu_torch.node`` processes on the card under the client flood
    and adversaries: no missed height, no diverged chain, every slowloris
    socket cut, and on every node (its ``/statusz``, then its drain report)
    device flushes, no host-routed flush, no flush fault, refusal or shed;
    one ``/profilez`` window per node holds recovery or digest kernels.
    (d) the card probe (``obs/evidence.py::probe_fingerprint``) names this
    card and its count.  Times are host clock on the card ``ident`` names.
    ``dev``/``small`` run the orchestration on the CPU at a small size (the
    CPU asked for, one family, no chain in the legs, 4 validators, the
    fleet on the auto route; no count or card gate).  Returns the launch
    counts of (b)'s warm start per kernel."""
    import tempfile

    from go_ibft_tpu_torch.bench.workload import _keys
    from go_ibft_tpu_torch.boot import program_registry
    from go_ibft_tpu_torch.boot.restart import run_boot_leg
    from go_ibft_tpu_torch.chain import ChainRunner, WriteAheadLog
    from go_ibft_tpu_torch.core import IBFT
    from go_ibft_tpu_torch.crypto import ecdsa
    from go_ibft_tpu_torch.crypto.backend import ECDSABackend, encode_signature, proposal_hash_of
    from go_ibft_tpu_torch.messages.helpers import CommittedSeal
    from go_ibft_tpu_torch.messages.wire import Proposal
    from go_ibft_tpu_torch.obs.evidence import probe_fingerprint
    from go_ibft_tpu_torch.ops import quorum
    from go_ibft_tpu_torch.ops import secp256k1 as sec
    from go_ibft_tpu_torch.sched import TenantScheduler
    from go_ibft_tpu_torch.sim.fleet import FleetSpec, _http_get, run_fleet

    dev = torch.device("cuda", torch.cuda.current_device()) if dev is None else dev
    card = dev.type == "cuda"
    reset_counts, read_counts = counts
    hold_digest, hold_recovery = holds
    out: dict = {"gpu": ident}
    t_phase = time.perf_counter()
    root = os.path.dirname(os.path.abspath(__file__))

    # -- (a) two real restarts on one fresh build cache -----------------------
    with tempfile.TemporaryDirectory(prefix="boot-legs-") as tmp:
        legs = {}
        for tag in ("cold", "cached"):
            legs[tag] = run_boot_leg(
                tag, "" if card else BOOT_MAIN_FAMILIES[0], os.path.join(tmp, "kernels"),
                os.path.join(tmp, f"ledger_{tag}.jsonl"), timeout_s=600, cwd=root,
                device=None if card else "cpu", chain=card,
            )
    for tag, leg in legs.items():
        rep = leg["report"]
        log(f"[13] a {tag} leg: entry to first finalized {rep['entry_to_first_finalized_ms']:.1f} ms, warm "
            f"{rep['warm_ms']:.1f} ms, chain {rep['chain_ms']:.1f} ms, spawn to exit {leg['spawn_ms']:.1f} ms; "
            f"{rep['cold']} cold, {rep['cached']} cached, {rep['skipped']} skipped, {len(leg['events'])} compile "
            f"events ({rep['platform']}, {ident})")
        for program, st in rep["programs"].items():
            log(f"    {program:32s} {st['status']:7s} {st['compile_ms']:10.1f} ms")
    cold, cached = legs["cold"], legs["cached"]
    # The k1*G + k2*Q kernel's family: a cold restore is the shared nvcc
    # build's wall plus its first launch, a cached one its first launch.
    family = {tag: leg["report"]["programs"].get("ecmul2_base_8l") for tag, leg in legs.items()}
    if card:
        log("[13] a ecmul2_base_8l: " + "; ".join(f"{tag} leg {st['status']} in {st['compile_ms']:.1f} ms"
                                                  for tag, st in family.items()) + f" ({ident})")
        check(family["cold"]["status"] == "cold" and family["cached"]["status"] == "cached",
              "13a: ecmul2_base_8l cold in the cold leg (secp256k1_ecmul2 built there), cached in the cached leg")
    out["ecmul2_base_8l"] = family
    if card:
        check(cold["report"]["platform"] == "gpu" and cold["report"]["skipped"] == 0, "13a: every family on the card")
        check(cold["report"]["cold"] >= 1 and len(cold["events"]) >= 1,
              "13a: the cold leg built its kernels (a cold program, a compile event)")
        check(cold["report"]["chain_ms"] > 0 and cached["report"]["chain_ms"] > 0,
              "13a: both legs finalized their first height")
    check(cached["report"]["cold"] == 0 and cached["events"] == [],
          "13a: the cached leg: zero cold programs and zero compile events")
    out["boot_legs"] = {tag: {"spawn_ms": leg["spawn_ms"], "events": len(leg["events"]), **leg["report"]}
                        for tag, leg in legs.items()}

    # -- (b) ChainRunner.warm_start in process -------------------------------
    n_val = WARM_VALIDATORS if not small else 4
    keys = _keys(n_val, 13)
    src = ECDSABackend.static_validators({k.address: 1 for k in keys})
    t0 = time.perf_counter()
    blocks = []
    with tempfile.TemporaryDirectory(prefix="warm-wal-") as tmp:
        path = os.path.join(tmp, "wal.jsonl")
        wal = WriteAheadLog(path)
        for h in range(1, WARM_HEIGHTS + 1):
            proposal = Proposal(raw_proposal=b"warm block %d" % h, round=0)
            phash = proposal_hash_of(proposal)
            seals = [CommittedSeal(signer=k.address, signature=encode_signature(*ecdsa.sign(k, phash)))
                     for k in keys]
            wal.append_finalize(h, proposal, seals)
            blocks.append((h, phash, seals))
        wal.close()
        sign_s = time.perf_counter() - t0
        sched = TenantScheduler(route="device", torch_device=dev)
        handle = sched.register("warm", src)
        runner = ChainRunner(IBFT(None, ECDSABackend(keys[0], src), None, batch_verifier=handle),
                             WriteAheadLog(path))
        reset_counts()
        t0 = time.perf_counter()
        rep = runner.warm_start(programs=[*BOOT_MAIN_FAMILIES, "ecmul2_base_8l"], handle=handle, device=dev)
        warm_ms = (time.perf_counter() - t0) * 1e3
        boot_launches = read_counts()
        runner.wal.close()
        reset_counts()
        with sched:
            for h, phash, seals in blocks:
                check(bool(handle.verify_committed_seals(phash, seals, h).all()),
                      f"13b: height {h}'s seeded seals verify")
        seeded_launches = read_counts()
    n_seals = WARM_HEIGHTS * n_val
    log(f"[13] b warm_start: {WARM_HEIGHTS} heights x {n_val} seals signed in {sign_s:.1f} s; restored "
        f"{ {p: s.status for p, s in rep.programs.items()} } in {warm_ms:.1f} ms, height {rep.height} "
        f"(chain {runner.latest_height()}), {rep.seeded_seal_verdicts} seal verdicts seeded; launches "
        f"{boot_launches}; the seeded seals' re-verification launches {seeded_launches} ({ident})")
    check(runner.latest_height() == WARM_HEIGHTS and rep.height == WARM_HEIGHTS + 1,
          f"13b: recovered {WARM_HEIGHTS} heights, the next is {WARM_HEIGHTS + 1}")
    check(rep.seeded_seal_verdicts == n_seals, f"13b: {n_seals} seal verdicts seeded (the WAL's seals)")
    check(seeded_launches["secp256k1_recover"] == 0 and seeded_launches["keccak256_digest"] == 0,
          "13b: the seeded seals verify with no recovery or digest launch")
    if card:
        check(boot_launches["keccak256_digest"] == 3 and boot_launches["secp256k1_recover"] == 3
              and boot_launches["certify_lanes"] == 2,
              "13b: the four main families: 3 digest, 3 recovery and 2 certify_lanes launches")
        check(boot_launches["secp256k1_ecmul2"] == 1 and boot_launches["secp256k1_verify"] == 0,
              "13b: ecmul2_base_8l: one secp256k1_ecmul2 launch")
        check(all(s.status == "cached" for s in rep.programs.values()), "13b: phase 2's libraries: all cached")
    rargs = program_registry(["round_certify_8l"], device=dev)["round_certify_8l"]()[1]
    b_blocks, b_counts, zw, r, s, v = main_path_inputs(rargs, quorum)
    hold_digest(b_blocks, b_counts, "the boot registry's round_certify_8l payloads")
    hold_recovery((zw, r, s, v), "secp256k1_recover kernel == plain at the boot registry's 16 lanes")
    z_limbs = program_registry(["ecdsa_recover_8l"], device=dev)["ecdsa_recover_8l"]()[1]
    hold_recovery(z_limbs, "secp256k1_recover kernel == plain at the boot registry's ecdsa_recover_8l")
    fn, args = program_registry(["ecmul2_base_8l"], device=dev)["ecmul2_base_8l"]()
    out_pt = fn(*args)
    check(bool(sec.is_infinity(out_pt).all()) and bool(sec.is_infinity(sec.ecmul2_base_plain(*args)).all()),
          "ecmul2_base_8l's all-zero lanes: the kernel and the plain ladder give infinity")
    out["warm_start"] = {"height": rep.height, "seeded": rep.seeded_seal_verdicts, "warm_ms": warm_ms,
                         "launches": boot_launches, "seeded_launches": seeded_launches}

    # -- (c) the fleet of node processes on the card ---------------------------
    try:
        import grpc  # noqa: F401 - the nodes' gossip transport needs it
    except ImportError as err:
        out["fleet"] = None
        log(f"[13] c the fleet did not run: grpc does not import on this machine ({err}); the node's gossip "
            f"transport (net/grpc_transport.py) needs it")
    else:
        def probe_live(infos):
            """Each node's /statusz, then one /profilez window a node, all
            at once: a process's first window spends ≈ 12 s starting the
            profiler on the card (PERF.md §6)."""
            from concurrent.futures import ThreadPoolExecutor

            status = [_http_get("127.0.0.1", i["telemetry_port"], "/statusz", 60.0) for i in infos]
            with ThreadPoolExecutor(len(infos)) as pool:
                profiles = list(pool.map(
                    lambda i: _http_get("127.0.0.1", i["telemetry_port"], "/profilez?seconds=1.0", 120.0), infos))
            return [{"status": st, "profile": pr} for st, pr in zip(status, profiles)]

        spec = (FleetSpec(nodes=FLEET_NODES, heights=FLEET_HEIGHTS, connections=FLEET_CONNECTIONS) if card else
                FleetSpec(nodes=FLEET_NODES, heights=2, connections=8, device="cpu", route="auto",
                          env={"OMP_NUM_THREADS": "1"}))
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory(prefix="fleet-") as run_dir:
            res = run_fleet(spec, run_dir, on_live=probe_live)
            tails = {}
            for name in sorted(os.listdir(run_dir)):
                if name.endswith(".log"):
                    with open(os.path.join(run_dir, name), "rb") as fh:
                        tails[name] = fh.read()[-1500:].decode("utf-8", "replace")
        fleet_s = time.perf_counter() - t0
        summary = res.summary()
        log(f"[13] c fleet of {spec.nodes} node processes ({'the card' if card else 'cpu'}) in {fleet_s:.1f} s: "
            f"{summary}")
        print(res.replay_line, flush=True)
        nodes = []
        for i, live in enumerate(res.live or []):
            code, status = live["status"]
            pcode, prof = live["profile"]
            sched_block = status.get("sched") or {}
            kernels = {k: n for k, n in (prof.get("kernels") or {}).items()
                       if any(name in k for name in CARD_KERNELS)}
            row = {"statusz": sched_block.get("routes"), "profilez": pcode, "kernels": sum(kernels.values()),
                   "events": prof.get("device_events")}
            nodes.append(row)
            tenants = {t: (v["requests"], v["sheds"], v["drain_p99_ms"]) for t, v in
                       sched_block.get("tenants", {}).items()}
            log(f"[13] c node {i}: height {status.get('height')} round {status.get('round')} "
                f"{status.get('state')}; /statusz routes {row['statusz']}, flush faults "
                f"{sched_block.get('flush_faults')}, refusals {sched_block.get('refusals')}, tenants (requests, "
                f"sheds, drain p99 ms) {tenants}; /profilez {pcode}, {row['events']} device events, "
                f"{row['kernels']} recovery/digest kernels {prof.get('error', '')}")

        def gates():
            check(res.missed_heights == 0 and res.diverged_chains == 0, "13c: no missed height, no diverged chain")
            check(res.slowloris["opened"] > 0 and res.slowloris["cut_by_server"] == res.slowloris["opened"],
                  "13c: every slowloris socket cut")
            check(res.verified_proofs == spec.nodes, "13c: one full-range proof a node verified client-side")
            check(res.live is not None and len(res.live) == spec.nodes, "13c: every node probed live")
            for i, (live, drained) in enumerate(zip(res.live, res.reports)):
                check(bool(drained.get("sched")), f"13c node {i}: a drain report")
                nodes[i]["drained"] = drained["sched"]["routes"]
                for sched_block in (live["status"][1]["sched"], drained["sched"]):
                    check(sched_block.get("flush_faults") == 0 and sched_block.get("refusals") == 0,
                          f"13c node {i}: no flush fault, no refusal")
                    check(all(t["shed_lanes"] == 0 for t in sched_block.get("tenants", {}).values()),
                          f"13c node {i}: no shed lane (no oracle fallback)")
                    if card:
                        check(sched_block["routes"]["device"] > 0 and sched_block["routes"]["host"] == 0,
                              f"13c node {i}: device flushes, no host-routed flush")
                if card:
                    check(live["status"][0] == 200 and live["profile"][0] == 200 and nodes[i]["kernels"] > 0,
                          f"13c node {i}: /profilez holds recovery or digest kernels")

        try:
            gates()
        except RuntimeError:
            for name, text in tails.items():  # the nodes' own account of the failure
                log(f"[13] c {name}: ...{text}")
            raise
        out["fleet"] = {"summary": summary, "nodes": nodes, "replay": res.replay_line, "fleet_s": fleet_s}

    # -- (d) the card probe ----------------------------------------------------
    with tempfile.TemporaryDirectory(prefix="probe-") as tmp:
        fp = probe_fingerprint(120.0, reprobe=True, cache_path=os.path.join(tmp, "probe.json"))
    log(f"[13] d probe: platform {fp.platform}, kind {fp.kind}, {fp.device_count} device(s), probe {fp.probe}, "
        f"backend {fp.backend_label()}")
    if card:
        check(fp.platform == "gpu" and fp.kind == torch.cuda.get_device_name(0)
              and fp.device_count == torch.cuda.device_count(), "13d: the probe names this card and its count")
    out["probe"] = {"platform": fp.platform, "kind": fp.kind, "device_count": fp.device_count}
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"[13] phase 13 took {out['phase_s']:.1f} s ({ident})")
    report["validator"] = out
    return boot_launches


def digest_only() -> int:
    """Time ``ops.quorum.digest_words`` and the recovery kernel of the
    ``go_ibft_tpu_torch`` first on the import path.  To compare checkouts,
    run this file of one checkout against each in turn (A B B A):

        PYTHONSAFEPATH=1 PYTHONPATH=<checkout> python3 chip_smoke.py --digest-only

    ``digest_words`` at DIGEST_TIMED, seeded, every message absorbing all
    its blocks: CUDA events over 200 back-to-back calls; the kernels of one
    call and their time on the card (profiler, 20 calls); a SHA-256 of the
    digests, equal across checkouts.  The recovery kernel on the lanes of
    the 100- and 300-validator rounds: CUDA events over 20 launches, and its
    ptxas report.  Prints the card's identity, then one JSON line."""
    import go_ibft_tpu_torch
    from go_ibft_tpu_torch import _build, convert
    from go_ibft_tpu_torch.bench import build_signed_round
    from go_ibft_tpu_torch.ops import ecrecover, quorum

    print(gpu_identity(), flush=True)
    _build.build_all()
    dev = torch.device("cuda")
    gen = torch.Generator(device="cpu").manual_seed(4)
    out = {"package": os.path.dirname(os.path.abspath(go_ibft_tpu_torch.__file__)),
           "digest": {}, "recover": {}}
    for b, nb in DIGEST_TIMED:
        blocks = torch.randint(-(2**31), 2**31, (b, nb, 17, 2), dtype=torch.int32,
                               generator=gen).to(dev)
        counts = torch.full((b,), nb, dtype=torch.int32, device=dev)
        words = quorum.digest_words(blocks, counts).cpu().numpy()
        prof = profile_call(lambda: [quorum.digest_words(blocks, counts) for _ in range(20)])
        out["digest"][f"{b}x{nb}"] = {
            "events_ms": cuda_time_ms(lambda: quorum.digest_words(blocks, counts), 200),
            "on_card_ms": prof["device_busy_ms"] / 20,
            "kernels_per_call": prof["device_kernels"] / 20,
            "sha256": hashlib.sha256(words.tobytes()).hexdigest(),
        }
    for n in (100, 300):
        rargs = convert.round_args(build_signed_round(n, seed=0).pack())
        zw, r, s, v = main_path_inputs(rargs, quorum)[2:]
        out["recover"][v.numel()] = cuda_time_ms(lambda: ecrecover.launch(zw, r, s, v), 20)
    out["ptxas"] = [line.strip() for line in _build.build_logs.get("secp256k1_recover", "").splitlines()
                    if "registers" in line or "stack frame" in line]
    print(json.dumps(out), flush=True)
    return 0


def ecmul2_only() -> int:
    """Time both entries of the ``k1*G + k2*Q`` kernel of the
    ``go_ibft_tpu_torch`` first on the import path at ECMUL2_LANES lanes
    (phase 3's valid verification lanes, repeated), so that two checkouts
    are timed by the same code in one call; run it against each in turn
    (A B B A):

        PYTHONSAFEPATH=1 PYTHONPATH=<checkout> python3 chip_smoke.py --ecmul2-only

    Builds only the source that holds the two entries.  Per entry and lane
    count: CUDA events over back-to-back launches (20, or 5 at 16,384
    lanes) and the time on the card a launch (the profiler, one session
    over every launch, split by name in launch order); a SHA-256 of the
    affine points and of the masks at 1,024 lanes, equal across
    checkouts; the source's ptxas report.  Prints the card's identity, then
    one JSON line."""
    import go_ibft_tpu_torch
    from go_ibft_tpu_torch import _build
    from go_ibft_tpu_torch.bench import build_verify_lanes
    from go_ibft_tpu_torch.ops import ecverify
    from go_ibft_tpu_torch.ops import fields as tf
    from go_ibft_tpu_torch.ops import secp256k1 as sec

    print(gpu_identity(), flush=True)
    source = next(name for name, fns in _build.SIGNATURES.items() if "secp256k1_ecmul2" in fns)
    built = _build.build_all([source])
    dev = torch.device("cuda")
    vlanes = build_verify_lanes(8, seed=0)
    work = []  # (entry, lanes, launches, fn)
    for b in ECMUL2_LANES:
        ins = verify_inputs(vlanes, b, dev, labels=("valid",))
        reps = 5 if b > 4096 else 20
        work.append(("secp256k1_ecmul2", b, reps,
                     lambda a=[ins[k] for k in ECMUL2_ARGS]: ecverify.launch_ecmul2(*a)))
        work.append(("secp256k1_verify", b, reps,
                     lambda a=[ins[k] for k in VERIFY_ARGS]: ecverify.launch_verify(*a)))
    out = {"package": os.path.dirname(os.path.abspath(go_ibft_tpu_torch.__file__)), "source": source,
           "build_s": built.build_s, "events_ms": {}, "device_ms_per_launch": {}, "sha256": {}}
    for entry, b, reps, fn in work:
        out["events_ms"].setdefault(entry, {})[str(b)] = cuda_time_ms(fn, reps)

    def run_all():
        for _, _, reps, fn in work:
            for _ in range(reps):
                fn()
        torch.cuda.synchronize()

    for _ in range(3):  # again where the session lost a device event
        events = [(name, ms) for name, ms in profile_call(run_all, ordered=True)["events"]
                  if "secp256k1_" in name]
        if len(events) == sum(reps for _, _, reps, _ in work):
            break
    check(len(events) == sum(reps for _, _, reps, _ in work), "the profiler recorded every launch")
    for entry, b, reps, _ in work:
        times, events = events[:reps], events[reps:]
        check(all(entry in name for name, _ in times), f"{entry} at {b} lanes in launch order")
        out["device_ms_per_launch"].setdefault(entry, {})[str(b)] = sum(ms for _, ms in times) / reps
    ins = verify_inputs(vlanes, 1024, dev)
    pt = ecverify.launch_ecmul2(*(ins[k] for k in ECMUL2_ARGS))
    x, y = sec.to_affine(sec.JacobianPoint(*(c.cpu() for c in pt)))
    inf = sec.is_infinity(sec.JacobianPoint(*(c.cpu() for c in pt)))
    points = [None if i else xy for i, xy in zip(inf.tolist(), zip(tf.from_limbs(x), tf.from_limbs(y)))]
    masks = ecverify.launch_verify(*(ins[k] for k in VERIFY_ARGS)).cpu().tolist()
    out["sha256"] = {"points": hashlib.sha256(repr(points).encode()).hexdigest(),
                     "masks": hashlib.sha256(repr(masks).encode()).hexdigest()}
    out["ptxas"] = [line.strip() for line in _build.build_logs.get(source, "").splitlines()
                    if "registers" in line or "stack frame" in line or "Compiling entry" in line]
    print(json.dumps(out), flush=True)
    return 0


def main_path_ab() -> int:
    """Time the main path of the ``go_ibft_tpu_torch`` first on the import
    path, as phases 7 and 8 do, so that two checkouts are timed by the same
    code in one call: ``certify_round`` on phase 3's 100-validator round and
    300-validator round with 30 % bad signatures (median of 20 calls after
    one warm-up, host clock and CUDA events, and the launches of one call),
    then engine run A (one engine among 100 validators, 5 heights through a
    ``DeviceBatchVerifier``; the medians of accept -> finalize and
    ``run_sequence``, and the launches of the 5 heights).  Run it against
    each checkout in turn, alternating (A B B A A B), in one call:

        PYTHONSAFEPATH=1 PYTHONPATH=<checkout> python3 chip_smoke.py --main-path-ab

    Prints the card's identity, then one JSON line."""
    import go_ibft_tpu_torch
    from go_ibft_tpu_torch import _build
    from go_ibft_tpu_torch.bench import build_signed_round
    from go_ibft_tpu_torch.bench.engine import Committee, EngineRunner, check_height
    from go_ibft_tpu_torch.crypto.backend import ECDSABackend
    from go_ibft_tpu_torch.ops import ecrecover, quorum
    from go_ibft_tpu_torch.verify import DeviceBatchVerifier

    print(gpu_identity(), flush=True)
    _build.build_all()
    fns = {"keccak256_digest": quorum.digest_words, "secp256k1_recover": ecrecover.recover}

    def counts():
        return {name: fn.launches for name, fn in fns.items()}

    out = {"package": os.path.dirname(os.path.abspath(go_ibft_tpu_torch.__file__)), "certify_round": {}}
    for label, n, bad in (("100v", 100, 0.0), ("300v_30bad", 300, 0.3)):
        rnd = build_signed_round(n, corrupt_frac=bad, seed=0)
        verifier = DeviceBatchVerifier(ECDSABackend.static_validators({m.sender: 1 for m in rnd.prepares}))

        def call(verifier=verifier, rnd=rnd):
            return verifier.certify_round(rnd.prepares, rnd.proposal_hash, rnd.seals, rnd.height)

        before = counts()
        masks = call()
        host_ms, event_ms = median_ms(call, calls=20)
        out["certify_round"][label] = {
            "host_ms": host_ms, "event_ms": event_ms,
            "launches": {k: v - before[k] for k, v in counts().items()},
            "valid": [int(masks[0].sum()), bool(masks[1]), int(masks[2].sum()), bool(masks[3])],
        }
    committee = Committee(100, seed=0)
    heights = committee.heights(1, 5)
    card = DeviceBatchVerifier(committee.src)
    card.warmup(lanes=(8, 128), blocks=(2, 8))
    runner = EngineRunner(committee, 1, card)
    before, runs = counts(), []
    for h in heights:
        schedule = committee.schedule(h)
        run = runner.run_height(h, schedule)
        check_height(committee, run)
        runs.append(run)
    out["run_A"] = {
        "accept_to_finalize_ms": statistics.median(r.accept_to_finalize_ms for r in runs),
        "run_sequence_ms": statistics.median(r.run_sequence_ms for r in runs),
        "accept_to_finalize_all_ms": [r.accept_to_finalize_ms for r in runs],
        "launches": {k: v - before[k] for k, v in counts().items()},
    }
    print(json.dumps(out), flush=True)
    return 0


def bls_profile() -> int:
    """Profile config #4 on the card in a process of its own (phase 10 runs
    this file with ``--bls-profile``): the three BLS kernels at config #4's
    shapes, three launches each, and one ``aggregate_verify_commit`` call.
    Prints one JSON line: each kernel's time on the card per launch, and
    the call's kernels, launch calls and device busy time."""
    from go_ibft_tpu_torch.bench import build_bls_round_workload
    from go_ibft_tpu_torch.ops import bls12_381 as ops
    from go_ibft_tpu_torch.ops import bls_kernels as bk

    dev = torch.device("cuda")
    pk, sig, h, live = (torch.from_numpy(a).to(dev) for a in build_bls_round_workload(100, seed=0).args)
    check(bool(ops.aggregate_verify_commit(pk, sig, h, live)), "config #4: the aggregate check is true")
    npk, pk_inf = bk.launch_merge(pk.unsqueeze(0), live.unsqueeze(0), True)
    s, s_inf = bk.launch_merge(sig.unsqueeze(0), live.unsqueeze(0))
    gen = torch.from_numpy(ops._G1_GEN).to(dev).unsqueeze(0)
    q1 = torch.stack([s, h.unsqueeze(0)]).contiguous()
    p1 = torch.stack([gen, npk]).contiguous()
    f1 = bk.launch_miller(q1, p1)
    g1 = ~pk_inf & ~s_inf
    kern = profile_call(lambda: [(bk.launch_merge(sig.unsqueeze(0), live.unsqueeze(0)), bk.launch_miller(q1, p1),
                                  bk.launch_final_exp(f1, g1)) for _ in range(3)])
    # The trace must hold the call's four BLS kernels.  A session that
    # records fewer lost device events (the launch counters, not the
    # profiler, hold the path's launches), so up to three are taken and
    # the number taken is reported.
    for sessions in range(1, 4):
        call = profile_call(lambda: bool(ops.aggregate_verify_commit(pk, sig, h, live)))
        bls = sum(n for name, n in call.pop("count_by_name").items() if "bls_" in name)
        if bls == 4:
            break
    check(bls == 4, f"the profiler recorded config #4's four BLS kernels in one of {sessions} sessions ({bls})")
    call["sessions"] = sessions
    call["top_kernels_ms"] = sorted(call.pop("by_name_ms").items(), key=lambda kv: -kv[1])[:6]
    print(json.dumps({"device_ms_per_launch": {name: per_launch_ms(kern, name)
                                               for name in ("bls_merge", "bls_miller", "bls_final_exp")},
                      "config4": call}), flush=True)
    return 0


def main_profile() -> int:
    """Profile phase 7's kernels in a process of its own (phase 7 runs this
    file with ``--main-profile``): torch.profiler records the card only in
    a process's first sessions (PERF.md §7), so every kernel is profiled in
    one session, launch after launch, and split by name in launch order --
    the digest at the two rounds' payloads and at 128 x 8 and 128 x 32
    blocks (20 launches each), the recovery at the two rounds' lanes (5
    each), keccak_f1600 at 256 states (50) -- and each round's
    ``certify_round`` in a session right after, after one ``certify_round``
    of a ``MeshBatchVerifier`` over 4 shards of the card (its device events
    in launch order), and the boot registry's ``ecmul2_base_8l`` call in a
    session of its own (its device kernels by name).  Both entries of the
    ``k1*G + k2*Q`` kernel are profiled at 8, 256, 1,024 and 16,384 lanes
    (5 launches each) on phase 3's valid verification lanes.  The rounds are
    phase 3's (the same seeds); the 128 x 8
    and 128 x 32 blocks and the states are seeded here.  The kernels'
    session is taken again, up to three times, where the profiler lost a
    device event.  Before the sessions, ``certify_lanes``' launcher is
    timed back to back at each of its three shapes (CUDA events over 200
    launches, and the host clock of the 200 calls).  Run it against two checkouts in turn, alternating (A B
    B A A B), in one call, to compare their kernels and launchers:

        PYTHONSAFEPATH=1 PYTHONPATH=<checkout> python3 chip_smoke.py --main-profile

    Prints the card's identity, then one JSON line."""
    from go_ibft_tpu_torch import convert
    from go_ibft_tpu_torch.bench import build_signed_round, build_verify_lanes
    from go_ibft_tpu_torch.bench.engine import Committee, EngineRunner, check_height
    from go_ibft_tpu_torch.boot import program_registry
    from go_ibft_tpu_torch.crypto.backend import ECDSABackend
    from go_ibft_tpu_torch.ops import certify_lanes, ecrecover, ecverify, keccak_f1600, quorum
    from go_ibft_tpu_torch.verify import DeviceBatchVerifier, MeshBatchVerifier

    print(gpu_identity(), flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device="cpu").manual_seed(7)
    rounds = {"100v": build_signed_round(100, seed=0), "300v_30bad": build_signed_round(300, corrupt_frac=0.3, seed=0)}
    work = []  # (kernel, label, launches, fn)
    for label, rnd in rounds.items():
        blocks, counts, zw, r, s, v = main_path_inputs(convert.round_args(rnd.pack()), quorum)
        work.append(("keccak256_digest", label, 20,
                     lambda blocks=blocks, counts=counts: keccak_f1600.launch_digest(blocks, counts, True)))
        work.append(("secp256k1_recover", label, 5, lambda ins=(zw, r, s, v): ecrecover.launch(*ins)))
        c_args, c_thr, c_split = certify_inputs(convert.round_args(rnd.pack()), quorum, ecrecover)
        work.append(("certify_lanes", label, 20,
                     lambda a=c_args, t=c_thr, p=c_split: certify_lanes.launch(*a, t, p)))
    worst = certify_case(2 * CERTIFY_WORST[0], CERTIFY_WORST[1], 1, dev)
    work.append(("certify_lanes", "2x2048x2048", 20,
                 lambda: certify_lanes.launch(*worst, [(1, 0), (1, 0)], CERTIFY_WORST[0])))
    for b, nb in DIGEST_LONG:
        blocks = torch.randint(-(2**31), 2**31, (b, nb, 17, 2), dtype=torch.int32, generator=gen).to(dev)
        counts = torch.full((b,), nb, dtype=torch.int32, device=dev)
        work.append(("keccak256_digest", f"{b}x{nb}", 20,
                     lambda blocks=blocks, counts=counts: keccak_f1600.launch_digest(blocks, counts, True)))
    st = torch.randint(-(2**31), 2**31, (256, 25, 2), dtype=torch.int32, generator=gen).to(dev)
    work.append(("keccak_f1600", 256, 50, lambda: keccak_f1600.launch(st)))
    vlanes = build_verify_lanes(8, seed=0)
    for b in ECMUL2_LANES:
        ins = verify_inputs(vlanes, b, dev, labels=("valid",))
        work.append(("secp256k1_ecmul2", b, 5,
                     lambda a=[ins[k] for k in ECMUL2_ARGS]: ecverify.launch_ecmul2(*a)))
        work.append(("secp256k1_verify", b, 5,
                     lambda a=[ins[k] for k in VERIFY_ARGS]: ecverify.launch_verify(*a)))
    family_fn, family_args = program_registry(["ecmul2_base_8l"], device=dev)["ecmul2_base_8l"]()
    verifiers = {label: DeviceBatchVerifier(ECDSABackend.static_validators({m.sender: 1 for m in rnd.prepares}))
                 for label, rnd in rounds.items()}

    def certify(label):
        rnd = rounds[label]
        return verifiers[label].certify_round(rnd.prepares, rnd.proposal_hash, rnd.seals, rnd.height)

    # One engine among 100 validators (phase 8's run A), a height to warm
    # up and the next one profiled.
    committee = Committee(100, seed=0)
    heights = committee.heights(1, 2)
    runner = EngineRunner(committee, 1, DeviceBatchVerifier(committee.src))
    schedules = [committee.schedule(h) for h in heights]
    check_height(committee, runner.run_height(heights[0], schedules[0]))

    mesh = MeshBatchVerifier(verifiers["100v"]._validators, devices=[dev] * CLUSTER_MESH_SHARDS)

    def mesh_certify():
        rnd = rounds["100v"]
        return mesh.certify_round(rnd.prepares, rnd.proposal_hash, rnd.seals, rnd.height)

    for _, _, _, fn in work:  # warm-up: builds, loads, first launches
        fn()
    family_fn(*family_args)
    for label in rounds:
        certify(label)
    check(list(mesh_certify()[0]) == list(certify("100v")[0]), "the mesh certify_round's mask == one device's")
    torch.cuda.synchronize()
    launcher = {}
    for kernel, label, _, fn in work:
        if kernel == "certify_lanes":
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(200):
                fn()
            host_us = (time.perf_counter() - t0) / 200 * 1e6
            torch.cuda.synchronize()
            launcher[label] = {"events_ms": cuda_time_ms(fn, 200), "host_us": host_us}

    def run_all():
        for _, _, n, fn in work:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()

    def split(prof):
        """Each work item's mean time on the card a launch, or None where
        the session lost a device event (the launch counters, not the
        profiler, hold the path's launches)."""
        queues, per_launch = {}, {}
        for name, ms in prof["events"]:
            queues.setdefault(next((k for k in ("keccak256_digest", "secp256k1_recover", "keccak_f1600",
                                                "certify_lanes", "secp256k1_ecmul2", "secp256k1_verify")
                                    if k in name), None), []).append(ms)
        for kernel, label, n, _ in work:
            times = queues.get(kernel, [])[:n]
            queues[kernel] = queues.get(kernel, [])[n:]
            if len(times) != n:
                return None
            per_launch.setdefault(kernel, {})[str(label)] = sum(times) / n
        return per_launch

    for sessions in range(1, 4):
        per_launch = split(profile_call(run_all, ordered=True))
        if per_launch is not None:
            break
    check(per_launch is not None, f"the profiler recorded every kernel launch of one of {sessions} sessions")
    for _ in range(3):  # again where the session lost the kernel's event
        family = profile_call(lambda: family_fn(*family_args))
        if any("secp256k1_ecmul2" in name for name in family["count_by_name"]):
            break
    meshed = profile_call(mesh_certify, ordered=True)
    certified = {label: profile_call(lambda label=label: certify(label)) for label in rounds}
    ran = []
    height = profile_call(lambda: ran.append(runner.run_height(heights[1], schedules[1])))
    check_height(committee, ran[0])
    for call in (*certified.values(), height, meshed):
        call["top_kernels_ms"] = sorted(call.pop("by_name_ms").items(), key=lambda kv: -kv[1])[:5]
        call.pop("count_by_name")
    family.pop("by_name_ms")
    print(json.dumps({"device_ms_per_launch": per_launch, "sessions": sessions, "certify_round": certified,
                      "height": height, "certify_lanes_launcher": launcher, "mesh_certify_round": meshed,
                      "ecmul2_base_8l": family}),
          flush=True)
    return 0


def bls_kernels_only() -> int:
    """Time ``bls_miller``, ``bls_final_exp`` and, for the record,
    ``bls_merge`` of the ``go_ibft_tpu_torch`` first on the import path, so
    that two checkouts are timed by the same code in one call (run OLD NEW
    NEW OLD):

        PYTHONSAFEPATH=1 PYTHONPATH=<checkout> python3 chip_smoke.py --bls-kernels-only

    Eight seeded lanes of pool points (multiples of the generators), tiled to
    N = 1, 64 and 1,024 lanes: CUDA events over back-to-back launches through
    the launchers, and a SHA-256 of each output, equal across checkouts.  The
    merge at config #4's G2 1 x 128 (100 live) and G1 1 x 128, at G2 1 x
    1,024 (1,000 live) and at config #13's G1 64 x 8 and 1,024 x 8, with
    each shape's least-work bound.  Prints the card's identity, the build's
    ptxas lines, then one JSON line."""
    import numpy as np

    import go_ibft_tpu_torch
    from go_ibft_tpu_torch import _build
    from go_ibft_tpu_torch.crypto import bls as hbls
    from go_ibft_tpu_torch.ops import bls12_381 as ops
    from go_ibft_tpu_torch.ops import bls_kernels as bk

    print(gpu_identity(), flush=True)
    _build.build_all(["bls12_381"])
    ptxas = [line.strip() for line in _build.build_logs.get("bls12_381", "").splitlines()
             if "registers" in line or "stack frame" in line or "Compiling entry" in line]
    print(json.dumps({"ptxas": ptxas}), flush=True)
    dev = torch.device("cuda")
    g2, g1 = [hbls.G2_GEN], [hbls.G1_GEN]
    for _ in range(15):
        g2.append(hbls.g2_add(g2[-1], hbls.G2_GEN))
        g1.append(hbls.g1_add(g1[-1], hbls.G1_GEN))
    idx = np.random.default_rng(9).integers(0, 16, size=(4, 8))
    q8 = torch.from_numpy(np.stack([ops.pack_g2_points([g2[i] for i in idx[k]]) for k in (0, 1)])).to(dev)
    p8 = torch.from_numpy(np.stack([ops.pack_g1_points([g1[i] for i in idx[2]]),
                                    ops.pack_g1_points([hbls.g1_neg(g1[i]) for i in idx[3]])])).to(dev)
    f8 = bk.launch_miller(q8, p8)

    def sha(*ts) -> str:
        torch.cuda.synchronize()
        return hashlib.sha256(b"".join(t.cpu().numpy().tobytes() for t in ts)).hexdigest()

    out = {"package": os.path.dirname(os.path.abspath(go_ibft_tpu_torch.__file__)), "gpu": gpu_identity(),
           "miller": {}, "final_exp": {}, "merge": {}}
    for n in (1, 64, 1024):
        tiles = -(-n // 8)
        q = q8.repeat(1, tiles, 1, 1)[:, :n].contiguous()
        p = p8.repeat(1, tiles, 1, 1)[:, :n].contiguous()
        f = f8.repeat(tiles, 1, 1)[:n].contiguous()
        gate = torch.ones(n, dtype=torch.bool, device=dev)
        out["miller"][n] = {"ms": cuda_time_ms(lambda: bk.launch_miller(q, p), 10),
                            "sha256": sha(bk.launch_miller(q, p))}
        out["final_exp"][n] = {"ms": cuda_time_ms(lambda: bk.launch_final_exp(f, gate), 10),
                               "sha256": sha(*bk.launch_final_exp(f, gate))}
    # (name, coordinates, groups, points a group, live points a group)
    for name, c, g, v, n_live in (("G2 1x128", 4, 1, 128, 100), ("G1 1x128", 2, 1, 128, 100),
                                  ("G2 1x1024", 4, 1, 1024, 1000), ("G1 64x8", 2, 64, 8, 8),
                                  ("G1 1024x8", 2, 1024, 8, 8)):
        pack, pool = (ops.pack_g1_points, g1) if c == 2 else (ops.pack_g2_points, g2)
        pts = torch.from_numpy(pack([pool[i % 16] for i in range(g * v)])).to(dev).reshape(g, v, c, 12).contiguous()
        live = (torch.arange(v, device=dev) < n_live).expand(g, v).contiguous()
        out["merge"][name] = {"ms": cuda_time_ms(lambda: bk.launch_merge(pts, live), 10),
                              "sha256": sha(*bk.launch_merge(pts, live)),
                              **bound(pts.numel() * 4 + live.numel() + g * (c * 12 * 4 + 1), merge_ops(live.cpu(), c))}
    print(json.dumps(out), flush=True)
    return 0


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--json", help="also write every measurement to this file")
    parser.add_argument("--digest-only", action="store_true",
                        help="only time digest_words and the recovery kernel (see digest_only)")
    parser.add_argument("--bls-profile", action="store_true",
                        help="only profile config #4's BLS kernels and one check (see bls_profile)")
    parser.add_argument("--main-profile", action="store_true",
                        help="only profile phase 7's kernels and certify_round calls (see main_profile)")
    parser.add_argument("--ecmul2-only", action="store_true",
                        help="only time the k1*G + k2*Q kernel's entries (see ecmul2_only)")
    parser.add_argument("--main-path-ab", action="store_true",
                        help="only time certify_round and engine run A (see main_path_ab)")
    parser.add_argument("--bls-kernels-only", action="store_true",
                        help="only time the BLS kernels at 1, 64 and 1,024 lanes (see bls_kernels_only)")
    args = parser.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card", file=sys.stderr)
        return 2
    if args.digest_only:
        return digest_only()
    if args.bls_profile:
        return bls_profile()
    if args.bls_kernels_only:
        return bls_kernels_only()
    if args.ecmul2_only:
        return ecmul2_only()
    if args.main_path_ab:
        return main_path_ab()
    if args.main_profile:
        return main_profile()

    import numpy as np

    from go_ibft_tpu_torch import _build, convert
    from go_ibft_tpu_torch.bench import build_recovery_lanes, build_signed_round
    from go_ibft_tpu_torch.bench.lanes import glv_halves
    from go_ibft_tpu_torch.crypto import ecdsa
    from go_ibft_tpu_torch.crypto.backend import ECDSABackend
    from go_ibft_tpu_torch.crypto.keccak import keccak256
    from go_ibft_tpu_torch.ops import bls_kernels, certify_lanes, ecrecover, ecverify, keccak_f1600, quorum
    from go_ibft_tpu_torch.ops import fields as tf
    from go_ibft_tpu_torch.ops import keccak as tk
    from go_ibft_tpu_torch.verify import DeviceBatchVerifier

    report: dict = {}
    t_start = time.perf_counter()
    dev = torch.device("cuda")

    # -- 1. identity ---------------------------------------------------
    ident = gpu_identity()
    print(ident, flush=True)
    nvcc = subprocess.run([_build.find_nvcc(), "--version"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip().splitlines()[-1]
    log(f"[1] torch {torch.__version__} cuda {torch.version.cuda} | {nvcc} | "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    report["gpu"] = ident

    # -- 2. build ------------------------------------------------------
    t0 = time.perf_counter()
    paths = _build.build_all()
    report["build_s"] = time.perf_counter() - t0
    log(f"[2] built {sorted(paths)} in {report['build_s']:.1f}s")
    report["ptxas"] = []
    for name, text in _build.build_logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                report["ptxas"].append(f"{name}: {line.strip()}")
                log(f"    {name}: {line.strip()}")

    # -- 3. the rounds; kernel vs plain --------------------------------
    t0 = time.perf_counter()
    rnd100 = build_signed_round(100, seed=0)
    src100 = ECDSABackend.static_validators({m.sender: 1 for m in rnd100.prepares})
    args100 = convert.round_args(rnd100.pack())
    verifier100 = DeviceBatchVerifier(src100)
    rnd300 = build_signed_round(300, corrupt_frac=0.3, seed=0)
    src300 = ECDSABackend.static_validators({m.sender: 1 for m in rnd300.prepares})
    args300 = convert.round_args(rnd300.pack())
    verifier300 = DeviceBatchVerifier(src300)
    rnd34 = build_signed_round(100, corrupt_frac=0.34, seed=0)
    args34 = convert.round_args(rnd34.pack())
    log(f"[3] built the signed 100- and 300-validator rounds and the 34-bad one in "
        f"{time.perf_counter() - t0:.1f}s")

    def exact(out, ref, what):
        check(torch.equal(out, ref), what)
        return int((out.to(torch.int64) - ref.to(torch.int64)).abs().max()) if out.numel() else 0

    def hold_recovery(ins, what):
        """``ecrecover.recover`` against ``recover_plain`` on ``ins``: ``ok``
        everywhere, ``x``, ``y``, ``addr`` on the lanes that recover."""
        x, y, addr, ok = ecrecover.recover(*ins)
        torch.cuda.synchronize()
        px, py, paddr, pok = ecrecover.recover_plain(*ins)
        exact(ok, pok, what + ": ok")
        for got, ref, part in ((x, px, "x"), (y, py, "y"), (addr, paddr, "addr")):
            err["secp256k1_recover"] = max(err["secp256k1_recover"],
                                           exact(got[pok], ref[pok], f"{what}: {part}"))
        return x, y, ok

    gen = torch.Generator(device="cpu").manual_seed(0)
    err = {"keccak_f1600": 0, "keccak256_digest": 0, "secp256k1_recover": 0, "certify_lanes": 0,
           "secp256k1_ecmul2": 0, "secp256k1_verify": 0}

    def hold_certify(ins, thresholds, split, what):
        """``certify_lanes.certify`` against ``certify_plain`` on ``ins``:
        the mask, the verdicts and both power halves; returns the plain
        version's output."""
        out = certify_lanes.certify(*ins, thresholds, split)
        torch.cuda.synchronize()
        ref = certify_lanes.certify_plain(*ins, thresholds, split)
        for got, want, part in zip(out, ref, ("mask", "reached", "lo", "hi")):
            err["certify_lanes"] = max(err["certify_lanes"], exact(got, want, f"{what}: {part}"))
        return ref

    def hold_digest(blocks, counts, what):
        """The digest kernel in both forms against its plain versions."""
        value = quorum.digest_words(blocks, counts)
        stream = tk.keccak256_blocks(blocks, counts)
        torch.cuda.synchronize()
        for got, ref, form in ((value, keccak_f1600.digest_words_plain(blocks, counts), "value"),
                               (stream, keccak_f1600.keccak256_sponge_plain(blocks, counts),
                                "stream")):
            err["keccak256_digest"] = max(err["keccak256_digest"], exact(
                got, ref, f"keccak256_digest kernel == plain, {form} words, {what}"))

    for b in KECCAK_BATCHES:
        st = torch.randint(-(2**31), 2**31, (b, 25, 2), dtype=torch.int32, generator=gen).to(dev)
        out = tk.keccak_f(st)
        torch.cuda.synchronize()
        err["keccak_f1600"] = max(err["keccak_f1600"], exact(
            out, keccak_f1600.keccak_f_plain(st), f"keccak_f1600 kernel == plain at B={b}"))
    log(f"[3] keccak_f1600 bit-exact against plain at B={KECCAK_BATCHES}")
    for nb in DIGEST_BLOCKS:
        for b in DIGEST_BATCHES:
            blocks = torch.randint(-(2**31), 2**31, (b, nb, 17, 2), dtype=torch.int32,
                                   generator=gen).to(dev)
            # Ragged: -1 .. nb + 1, with 0 and nb + 1 always present for B > 2.
            counts = torch.randint(-1, nb + 2, (b,), dtype=torch.int32, generator=gen)
            if b > 2:
                counts[:2] = torch.tensor([0, nb + 1], dtype=torch.int32)
            hold_digest(blocks, counts.to(dev), f"nb={nb}, B={b}")
    log(f"[3] keccak256_digest bit-exact against plain in both forms at nb={DIGEST_BLOCKS}, "
        f"B={DIGEST_BATCHES}, ragged block counts")
    lanes = build_recovery_lanes(8, seed=0)
    expect = lanes.expected()
    for b in RECOVER_BATCHES:
        arr = lanes.arrays(b)
        for zname in ("zw", "z_limbs"):
            ins = [torch.from_numpy(np.ascontiguousarray(arr[k])).to(dev)
                   for k in (zname, "r", "s", "v")]
            x, y, ok = hold_recovery(ins, f"secp256k1_recover kernel == plain at B={b}, "
                                          f"z as {zname}")
            oks = ok.cpu().numpy()
            xs, ys = tf.from_limbs(x), tf.from_limbs(y)
            for i, lane in enumerate(arr["lane"]):
                e = expect[lane]
                check(bool(oks[i]) == (e is not None) and (e is None or (xs[i], ys[i]) == e),
                      f"secp256k1_recover == host oracle, lane {lanes.labels[lane]!r}, B={b}")
    log(f"[3] secp256k1_recover bit-exact against plain and the host oracle at "
        f"B={RECOVER_BATCHES} ({len(lanes)} lanes: {', '.join(sorted(set(lanes.labels)))})")
    for label, rargs in (("100v", args100), ("300v_30bad", args300)):
        blocks, counts, zw, r, s, v = main_path_inputs(rargs, quorum)
        hold_digest(blocks, counts, f"on the {label} round's payloads")
        _, _, ok = hold_recovery((zw, r, s, v),
                                 f"secp256k1_recover kernel == plain on the {label} round's lanes")
        log(f"[3] {label} round: digest at {tuple(blocks.shape)} and recovery at "
            f"{v.numel()} lanes ({int(ok.sum())} recover) bit-exact against plain")
    vlanes, verify_path = ecmul2_holds(report, err, dev)
    t0 = time.perf_counter()
    for label, rargs in (("100v", args100), ("300v_30bad", args300), ("100v_34bad", args34)):
        c_args, thresholds, split = certify_inputs(rargs, quorum, ecrecover)
        hold_certify(c_args, [], None, f"certify_lanes, mask alone, {label} round")
        hold_certify(c_args, thresholds[:1], None, f"certify_lanes, one phase, {label} round")
        ref = hold_certify(c_args, thresholds, split, f"certify_lanes, two phases, {label} round")
        for edges in edge_thresholds(ref):
            hold_certify(c_args, edges, split, f"certify_lanes at the {label} round's power {edges}")
    for lanes in CERTIFY_LANES:
        for rows in CERTIFY_ROWS:
            c_args = certify_case(2 * lanes, rows, lanes + rows, dev)
            ref = hold_certify(c_args, [(1, 0), (1, 0)], lanes, f"certify_lanes at 2 x {lanes} lanes, {rows} rows")
            for edges in edge_thresholds(ref):
                hold_certify(c_args, edges, lanes, f"certify_lanes at 2 x {lanes} x {rows}, thresholds {edges}")
            hold_certify(c_args, [], None, f"certify_lanes mask alone at {2 * lanes} lanes, {rows} rows")
    for lanes, rows, split in CERTIFY_EDGES:
        c_args = certify_case(lanes, rows, lanes + rows + 1, dev)
        phases = 1 if split is None else 2
        ref = hold_certify(c_args, [(1, 0)] * phases, split, f"certify_lanes at the edge {lanes} x {rows}, {split}")
        for edges in edge_thresholds(ref):
            hold_certify(c_args, edges, split, f"certify_lanes at the edge {lanes} x {rows}, {split}, {edges}")
        hold_certify(c_args, [], None, f"certify_lanes mask alone at the edge {lanes} x {rows}")
    log(f"[3] certify_lanes bit-exact against plain on the three rounds' lanes (no phase, one, two; "
        f"thresholds at each phase's power - 1, the power, + 1) and on seeded lanes at 2 x "
        f"{CERTIFY_LANES} lanes x {CERTIFY_ROWS} rows (duplicate rows with power, sender spam, "
        f"thr_hi >= 2**15) and at the cluster's edges (lanes, rows, split) {CERTIFY_EDGES} in "
        f"{time.perf_counter() - t0:.1f}s")
    report["max_abs_err"] = err

    # -- 4. the 100-validator round through both entry points ----------
    # Each kernel's wrappers: the digest kernel has two, one per output form.
    counters = {
        "keccak_f1600": (tk.keccak_f,),
        "keccak256_digest": (quorum.digest_words, tk.keccak256_blocks),
        "secp256k1_recover": (ecrecover.recover,),
        "certify_lanes": (certify_lanes.certify,),
        "secp256k1_ecmul2": (ecverify.ecmul2,),
        "secp256k1_verify": (ecverify.verify,),
        "bls_merge": (bls_kernels.merge,),
        "bls_miller": (bls_kernels.miller,),
        "bls_final_exp": (bls_kernels.final_exp,),
    }

    def reset_counts():
        for fns in counters.values():
            for fn in fns:
                fn.launches = 0

    def read_counts():
        return {name: sum(fn.launches for fn in fns) for name, fns in counters.items()}

    reset_counts()
    out = quorum.round_certify(*args100)
    check(quorum.digest_words.launches == 1, "round_certify: exactly one digest launch")
    check(certify_lanes.certify.launches == 1, "round_certify: exactly one certify_lanes launch")
    pm, pr, sm, sr = verifier100.certify_round(
        rnd100.prepares, rnd100.proposal_hash, rnd100.seals, rnd100.height
    )
    check(quorum.digest_words.launches == 2, "certify_round: exactly one digest launch")
    check(certify_lanes.certify.launches == 2, "certify_round: exactly one certify_lanes launch")
    launches = read_counts()
    check(launches["keccak256_digest"] == 2 and tk.keccak256_blocks.launches == 0,
          "keccak256_digest launched once per entry point, in its value-word form")
    check(launches["secp256k1_recover"] > 0, "secp256k1_recover launched on the main path")
    n = rnd100.n_validators
    rc = [x.cpu().numpy() for x in out]
    check(bool(rc[0][:n].all() and rc[2][:n].all()), "round_certify: every 100-validator lane valid")
    check(not rc[0][n:].any() and not rc[2][n:].any(), "round_certify: padding lanes dead")
    check(bool(rc[1]) and bool(rc[3]), "round_certify: both quorums reached")
    check(bool(pm.all() and sm.all() and pr and sr), "certify_round: all valid, both quorums")
    hp, hs = host_masks(rnd100, ecdsa, keccak256, rnd100.height)
    check(list(pm) == hp and list(sm) == hs, "certify_round masks == host oracle")
    check(list(rc[0][:n]) == hp and list(rc[2][:n]) == hs, "round_certify masks == host oracle")
    log(f"[4] 100 validators: masks == host oracle, quorum reached; launches {launches}")
    report["launches_main_path"] = launches

    # -- 5. 300 validators, 30 % bad -----------------------------------
    reset_counts()
    out = [x.cpu().numpy() for x in quorum.round_certify(*args300)]
    pm, pr, sm, sr = verifier300.certify_round(
        rnd300.prepares, rnd300.proposal_hash, rnd300.seals, rnd300.height
    )
    check(quorum.digest_words.launches == 2 and ecrecover.recover.launches > 0
          and certify_lanes.certify.launches == 2,
          "300 validators: the digest and certify_lanes (once per call) and recovery kernels launched")
    n = 300
    for name, got in (("round_certify", (out[0][:n], out[2][:n])), ("certify_round", (pm, sm))):
        check(list(got[0]) == list(rnd300.expected_prepare_mask), f"{name}: prepare mask == expected")
        check(list(got[1]) == list(rnd300.expected_seal_mask), f"{name}: seal mask == expected")
    check(int(pm.sum()) == 210 and int(sm.sum()) == 210, "210 valid lanes per phase")
    check(bool(out[1]) and bool(out[3]) and pr and sr, "300 validators: 210 >= 201, quorum reached")
    log("[5] 300 validators, 30% bad: masks == expected, 210 >= 201 reached")

    # -- 6. 34 bad of 100: no quorum -----------------------------------
    reset_counts()
    out = [x.cpu().numpy() for x in quorum.round_certify(*args34)]
    pm, pr, sm, sr = verifier100.certify_round(
        rnd34.prepares, rnd34.proposal_hash, rnd34.seals, rnd34.height
    )
    check(quorum.digest_words.launches == 2 and ecrecover.recover.launches > 0
          and certify_lanes.certify.launches == 2,
          "34 bad: the digest and certify_lanes (once per call) and recovery kernels launched")
    check(list(pm) == list(rnd34.expected_prepare_mask) and int(pm.sum()) == 66, "34-bad prepare mask")
    check(list(sm) == list(rnd34.expected_seal_mask), "34-bad seal mask")
    check(not (pr or sr or bool(out[1]) or bool(out[3])), "66 < 67: neither quorum reached")
    log("[6] 100 validators, 34 bad: 66 < 67, neither quorum reached")

    # -- 7. timing and launch counts -----------------------------------
    # Each kernel at the main path's own inputs: the payload digests of the
    # 100- and 300-validator rounds (128 and 512 messages of 2 blocks) and
    # their recovery lanes (PREPARE + COMMIT: 256 and 1024).
    timing = {"keccak_f1600": {}, "keccak256_digest": {}, "secp256k1_recover": {}, "certify_lanes": {},
              "secp256k1_ecmul2": {}, "secp256k1_verify": {}}
    # The profiler's numbers come from a process of its own: it records the
    # card only in a process's first sessions (PERF.md §7).
    child = subprocess.run([sys.executable, os.path.abspath(__file__), "--main-profile"],
                           capture_output=True, text=True, timeout=600)
    check(child.returncode == 0, f"the --main-profile process exited 0 ({child.stderr[-2000:]})")
    profiled = json.loads(child.stdout.strip().splitlines()[-1])
    per_launch = profiled["device_ms_per_launch"]

    def time_digest(blocks, counts, label):
        """The digest kernel (value words, as the main path calls it): CUDA
        events over back-to-back launches, and its time on the card per
        launch from the profiler; the plain version; the bound, counting
        the blocks these counts absorb and Keccak-f's op count per block."""
        b, nb = blocks.shape[0], blocks.shape[1]
        absorbed = int(counts.clamp(0, nb).sum())
        return {
            "batch": b, "blocks": nb,
            "ms": cuda_time_ms(lambda: keccak_f1600.launch_digest(blocks, counts, True), 200),
            "device_ms_per_launch": per_launch["keccak256_digest"][label],
            "plain_ms": cuda_time_ms(lambda: keccak_f1600.digest_words_plain(blocks, counts),
                                     5 if nb <= 8 else 2),
            **bound(absorbed * 136 + b * 4 + b * 32,  # blocks absorbed, counts, digests
                    absorbed * (KECCAK_OPS_PER_STATE + 17 * 2)),
        }

    for b in TIMED_BATCHES:
        st = torch.randint(-(2**31), 2**31, (b, 25, 2), dtype=torch.int32, generator=gen).to(dev)
        timing["keccak_f1600"][b] = {
            "ms": cuda_time_ms(lambda st=st: keccak_f1600.launch(st), 200),
            "plain_ms": cuda_time_ms(lambda st=st: keccak_f1600.keccak_f_plain(st), 5),
            **bound(b * KECCAK_BYTES_PER_STATE, b * KECCAK_OPS_PER_STATE),
        }
    for label, rargs in (("100v", args100), ("300v_30bad", args300)):
        blocks, counts, zw, r, s, v = main_path_inputs(rargs, quorum)
        timing["keccak256_digest"][label] = time_digest(blocks, counts, label)
        ints = [tf.from_limbs(t) for t in (r, s)]
        zs = [int.from_bytes(np.ascontiguousarray(row).astype("<u4").tobytes(), "little")
              for row in zw.cpu().numpy()]
        ops = recover_ops(zs, ints[0], ints[1], [int(t) for t in v.cpu()], ecdsa.N, glv_halves)
        timing["secp256k1_recover"][label] = {
            "batch": v.numel(),
            "ms": cuda_time_ms(lambda: ecrecover.launch(zw, r, s, v), 20),
            "device_ms_per_launch": per_launch["secp256k1_recover"][label],
            "plain_ms": cuda_time_ms(lambda: ecrecover.recover_plain(zw, r, s, v), 1),
            **bound(v.numel() * RECOVER_BYTES_PER_LANE, ops),
        }
    for b, nb in DIGEST_LONG:
        blocks = torch.randint(-(2**31), 2**31, (b, nb, 17, 2), dtype=torch.int32,
                               generator=gen).to(dev)
        counts = torch.full((b,), nb, dtype=torch.int32, device=dev)
        timing["keccak256_digest"][f"{b}x{nb}"] = time_digest(blocks, counts, f"{b}x{nb}")
    # certify_lanes at the two rounds' inputs (two phases, as round_certify
    # and certify_round launch it) and at the worst bucket.
    worst = certify_case(2 * CERTIFY_WORST[0], CERTIFY_WORST[1], 1, dev)
    certify_timed = {label: certify_inputs(rargs, quorum, ecrecover)
                     for label, rargs in (("100v", args100), ("300v_30bad", args300))}
    certify_timed["2x2048x2048"] = (worst, [(1, 0), (1, 0)], CERTIFY_WORST[0])
    for label, (c_args, thresholds, split) in certify_timed.items():
        nbytes, ops = certify_work(c_args, len(thresholds))
        timing["certify_lanes"][label] = {
            "batch": c_args[1].numel(), "rows": c_args[4].shape[0],
            "ms": cuda_time_ms(lambda a=c_args, t=thresholds, p=split: certify_lanes.launch(*a, t, p), 200),
            "device_ms_per_launch": per_launch["certify_lanes"][label],
            "plain_ms": cuda_time_ms(lambda a=c_args, t=thresholds, p=split: certify_lanes.certify_plain(*a, t, p), 20),
            "launcher_host_us": profiled["certify_lanes_launcher"][label]["host_us"],
            **bound(nbytes, ops),
        }
    # The recovery at growing lane counts: the 300-validator round's 1,024
    # lanes repeated.
    zw, r, s, v = main_path_inputs(args300, quorum)[2:]
    sweep = {}
    for b in SWEEP_LANES:
        idx = torch.arange(b, device=dev) % v.numel()
        ins = [t[idx].contiguous() for t in (zw, r, s, v)]
        sweep[b] = cuda_time_ms(lambda ins=ins: ecrecover.launch(*ins), 20 if b <= 4096 else 5)
        log(f"[7] secp256k1_recover at {b} lanes: {sweep[b]:.5f} ms "
            f"({b / sweep[b] * 1e3:.0f} lanes/s)")
    report["recover_sweep_ms"] = sweep
    # Both entries of the k1*G + k2*Q kernel on the valid lanes of phase 3
    # (u1, u2 of real signatures as k1, k2), repeated; the plain versions
    # at the boot registry's 8 lanes, one call each (phase 3 warmed them).
    for b in ECMUL2_LANES:
        ins = verify_inputs(vlanes, b, dev, labels=("valid",))
        for name, launcher, plain_fn, names, is_verify in (
                ("secp256k1_ecmul2", ecverify.launch_ecmul2, ecverify.ecmul2_plain, ECMUL2_ARGS, False),
                ("secp256k1_verify", ecverify.launch_verify, ecverify.verify_plain, VERIFY_ARGS, True)):
            args_b = [ins[k] for k in names]
            timing[name][b] = {
                "batch": b,
                "ms": cuda_time_ms(lambda f=launcher, a=args_b: f(*a), 20),
                "device_ms_per_launch": per_launch[name][str(b)],
                "plain_ms": once_ms(lambda f=plain_fn, a=args_b: f(*a)) if b == 8 else None,
                **ecmul2_work(vlanes, ins["lane"], is_verify, ecdsa.N, glv_halves),
            }
    for name, rows in timing.items():
        for key, t in rows.items():
            on_card = (f", {t['device_ms_per_launch'] * 1e3:.2f} us on the card"
                       if "device_ms_per_launch" in t else "")
            plain = "not timed" if t["plain_ms"] is None else f"{t['plain_ms']:.3f} ms"
            log(f"[7] {name} at {key}: kernel {t['ms']:.5f} ms{on_card}, plain "
                f"{plain}, bound {t['bound_ms']:.3g} ms ({t['bound_by']})")
    report["kernel_timing"] = timing

    medians = {}
    for label, rnd, verifier, rargs in (
        ("100v", rnd100, verifier100, args100),
        ("300v_30bad", rnd300, verifier300, args300),
    ):
        def call_round(verifier=verifier, rnd=rnd):
            return verifier.certify_round(rnd.prepares, rnd.proposal_hash, rnd.seals, rnd.height)

        def call_program(rargs=rargs):
            return [bool(x) if x.dim() == 0 else x.cpu() for x in quorum.round_certify(*rargs)]

        host_ms, dev_ms = median_ms(call_round, calls=20)
        prog_host_ms, prog_dev_ms = median_ms(call_program, calls=20)
        medians[label] = {
            "certify_round_host_ms": host_ms, "certify_round_event_ms": dev_ms,
            "round_certify_host_ms": prog_host_ms, "round_certify_event_ms": prog_dev_ms,
        }
        log(f"[7] {label}: certify_round median of 20 {host_ms:.3f} ms host / {dev_ms:.3f} ms "
            f"events; round_certify median of 20 {prog_host_ms:.3f} / {prog_dev_ms:.3f} ms")
    for label in ("100v", "300v_30bad"):
        prof = profiled["certify_round"][label]
        busy = prof["device_busy_ms"]
        prof["idle_share_vs_median"] = 1 - busy / medians[label]["certify_round_host_ms"]
        medians[label]["profile"] = prof
        log(f"[7] {label} profile (the --main-profile process): {prof['device_kernels']} kernels, "
            f"{prof['launch_calls']} launch calls, device busy {busy:.3f} ms (idle "
            f"{prof['idle_share_vs_median']:.3f} of the median call)")
        for name, ms in prof["top_kernels_ms"]:
            log(f"    {ms:9.4f} ms  {name[:90]}")
    check(medians["100v"]["profile"]["device_kernels"] < 10_000,
          "fewer than 10,000 kernels per 100-validator certify_round")
    check(medians["100v"]["profile"]["launch_calls"] <= 5,
          "at most 5 launch calls per 100-validator certify_round")
    height = profiled["height"]
    log(f"[7] a height (one engine among 100 validators, the --main-profile process): "
        f"{height['device_kernels']} kernels, {height['launch_calls']} launch calls, device busy "
        f"{height['device_busy_ms']:.3f} ms of {height['profiled_wall_ms']:.3f} ms")
    report["height_profile"] = height
    report["mesh_certify_round_profile"] = profiled["mesh_certify_round"]
    for label, t in profiled["certify_lanes_launcher"].items():
        log(f"[7] certify_lanes' launcher at {label}, back to back: {t['host_us']:.2f} us of host a call, "
            f"{t['events_ms'] * 1e3:.2f} us a launch (events)")
    family = profiled["ecmul2_base_8l"]
    log(f"[7] the boot registry's ecmul2_base_8l call on the card (the --main-profile process): "
        f"{family['count_by_name']}")
    kernels_seen = {name: n for name, n in family["count_by_name"].items() if "Memcpy" not in name
                    and "Memset" not in name}
    check(len(kernels_seen) == 1 and "secp256k1_ecmul2_kernel" in next(iter(kernels_seen))
          and next(iter(kernels_seen.values())) == 1,
          f"ecmul2_base_8l on the card is one secp256k1_ecmul2 launch, no eager ladder ({kernels_seen})")
    report["ecmul2_base_8l_profile"] = family
    kern_dev_ms = per_launch["keccak_f1600"]["256"]
    timing["keccak_f1600"][256]["device_ms_per_launch"] = kern_dev_ms
    log(f"[7] keccak_f1600 at B=256: {kern_dev_ms * 1e3:.2f} us on the card per launch (profiler)")
    report["medians"] = medians

    # -- 8. the consensus engine on the card --------------------------
    engine_launches, held = engine_phase(report, ident, (reset_counts, read_counts),
                                         (hold_digest, hold_recovery))

    # -- 9. the chain on the card --------------------------------------
    chain_launches = chain_phase(report, ident, (reset_counts, read_counts),
                                 (hold_digest, hold_recovery), held)

    # -- 10. BLS12-381 aggregate verification on the card -------------
    bls = bls_phase(report, ident, (reset_counts, read_counts))

    # -- 11. the multi-tenant and read planes on the card --------------
    serving_launches = serving_phase(report, ident, (reset_counts, read_counts), (hold_digest, hold_recovery))

    # -- 12. the mesh and the lock-step cluster on the card ------------
    cluster = cluster_phase(report, ident, (reset_counts, read_counts), (hold_digest, hold_recovery),
                            {"100v": (rnd100, src100, verifier100), "300v_30bad": (rnd300, src300, verifier300)})

    # -- 13. the validator process on the card --------------------------
    boot_launches = validator_phase(report, ident, (reset_counts, read_counts), (hold_digest, hold_recovery))

    # -- 14. the kernels line and the result ---------------------------
    main = {"keccak_f1600": timing["keccak_f1600"][256],  # PR 1's main-path size
            "keccak256_digest": timing["keccak256_digest"]["100v"],
            "secp256k1_recover": timing["secp256k1_recover"]["100v"],
            "certify_lanes": timing["certify_lanes"]["100v"],
            "secp256k1_ecmul2": timing["secp256k1_ecmul2"][8],  # the boot registry's lanes
            "secp256k1_verify": timing["secp256k1_verify"][8]}
    where = {
        "keccak_f1600": ("go_ibft_tpu_torch/csrc/keccak_f1600.cu",
                         "go_ibft_tpu/ops/pallas_keccak.py:131"),
        "keccak256_digest": ("go_ibft_tpu_torch/csrc/keccak_f1600.cu",
                             "go_ibft_tpu/ops/quorum.py:65"),
        "secp256k1_recover": ("go_ibft_tpu_torch/csrc/secp256k1_recover.cu",
                              "go_ibft_tpu/ops/secp256k1.py:665"),
        "certify_lanes": ("go_ibft_tpu_torch/csrc/certify_lanes.cu",
                          "go_ibft_tpu/verify/batch.py:491"),
        "secp256k1_ecmul2": ("go_ibft_tpu_torch/csrc/secp256k1_ecmul2.cu",
                             "go_ibft_tpu/ops/secp256k1.py:512"),
        "secp256k1_verify": ("go_ibft_tpu_torch/csrc/secp256k1_ecmul2.cu",
                             "go_ibft_tpu/ops/secp256k1.py:625"),
    }
    # The k1*G + k2*Q kernel's entries run on their own paths only: the boot
    # (phase 13 (b)) and phase 3's ecdsa_verify at 1,024 lanes.
    own_path = {"secp256k1_ecmul2": boot_launches["secp256k1_ecmul2"],
                "secp256k1_verify": verify_path["secp256k1_verify"]}
    # "ms" is CUDA events over back-to-back launches, which the wrapper's
    # Python bounds for the short Keccak kernels; "device_ms_per_launch" is
    # the kernel's own time on the card (profiler).
    kernels = [{
        "name": name,
        "route": "cuda",
        "source": where[name][0],
        "replaces": where[name][1],
        "launches": own_path.get(name, launches[name]),
        "engine_launches": engine_launches[name],
        "chain_launches": chain_launches[name],
        "bls_launches": bls["config4"][name],
        "bls_chain_launches_per_height": bls["chain_per_height"][name],
        "serving_launches": serving_launches[name],
        "cluster_launches": cluster["cluster"].get(name, 0),
        "mesh_launches": cluster["mesh"].get(name, 0),
        "boot_launches": boot_launches[name],
        "max_abs_err": err[name],
        "ms": main[name]["ms"],
        "device_ms_per_launch": main[name]["device_ms_per_launch"],
        "plain_ms": main[name]["plain_ms"],
        "bound_ms": main[name]["bound_ms"],
        "bound_by": main[name]["bound_by"],
        "library_ms": None,
    } for name in main]
    for entry in bls["kernels"]:
        entry.update(engine_launches=engine_launches[entry["name"]], chain_launches=chain_launches[entry["name"]],
                     bls_launches=entry["launches"],
                     bls_chain_launches_per_height=entry.pop("chain_launches_per_height"),
                     serving_launches=serving_launches[entry["name"]],
                     cluster_launches=cluster["cluster"].get(entry["name"], 0),
                     mesh_launches=cluster["mesh"].get(entry["name"], 0),
                     boot_launches=boot_launches[entry["name"]])
        kernels.append(entry)
    report["kernels"] = kernels
    report["total_s"] = time.perf_counter() - t_start
    if args.json:
        with open(args.json, "w") as fh:
            json.dump(report, fh, indent=1, default=str)
    log(f"total {report['total_s']:.1f}s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
