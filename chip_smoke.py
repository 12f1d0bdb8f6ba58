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
4. certify the 100-validator round (seed 0) through both entry points,
   ``ops.quorum.round_certify`` and ``DeviceBatchVerifier.certify_round``:
   every mask true, both quorums reached, masks equal to the host oracle
   (``crypto.ecdsa.recover``); the kernels' launch counts are set to 0
   before these two calls and read after them, and each call made exactly
   one digest launch;
5. the 300-validator round with 30 % bad signatures: masks equal the
   expected masks, quorum reached (210 >= 201);
6. a 100-validator round with 34 bad signatures: no quorum;
7. time each kernel at the main path's own inputs (CUDA events) beside its
   plain version and its bound, the digest also at 128 messages of 8 and of
   32 blocks (and its time on the card per launch, profiler), and the
   recovery at 1 to 16,384 lanes;
   time phases 4-5 with CUDA events and the host clock (median of 20 calls
   after warm-up), and profile one 100-validator call: device kernels
   (fewer than 10,000), device busy time, idle share;
8. print the ``kernels`` line (each kernel's ``ms`` is CUDA events over
   back-to-back launches; ``device_ms_per_launch`` its time on the card per
   launch, from the profiler), then the result line.

``--digest-only`` runs none of this: it times ``ops.quorum.digest_words``
and the recovery kernel of whichever ``go_ibft_tpu_torch`` comes first on
the import path, so that two checkouts are timed by the same code in one
call (``digest_only`` below).

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

# H100 SXM peaks (NVIDIA data sheet): HBM bandwidth, and the 32-bit rate
# outside the tensor cores, used here for the kernel's 32-bit integer ops.
HBM_BYTES_PER_S = 3.35e12
OPS_PER_S_32BIT = 67e12

# Batch sizes held bit-exact: the main path's (payload digests of the 100-
# and 300-validator rounds: 128 and 512 messages; recovery: 256 and 1024
# lanes) and ragged ones.
KECCAK_BATCHES = (1, 128, 129, 256, 512, 1024, 4096)
DIGEST_BATCHES = (1, 33, 128, 129, 512, 1024)
# The verifier's block buckets are 2, 8 and 32; 1 and 3 are ragged.
DIGEST_BLOCKS = (1, 2, 3, 8, 32)
# Digest shapes timed beyond the rounds' own (128 and 512 messages of 2
# blocks): a payload of 8 and of 32 blocks, such as a PREPREPARE carrying a
# round-change certificate.
DIGEST_LONG = ((128, 8), (128, 32))
DIGEST_TIMED = ((128, 2), (512, 2)) + DIGEST_LONG
RECOVER_BATCHES = (1, 33, 256, 1024)
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


def profile_call(fn) -> dict:
    """Device kernels, runtime launch calls and device busy time of one
    ``fn()`` under ``torch.profiler``, and each kernel name's device time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    kernels, launches, by_name, count_by_name = 0, 0, {}, {}
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            kernels += 1
            by_name[evt.name] = by_name.get(evt.name, 0.0) + evt.time_range.elapsed_us() / 1e3
            count_by_name[evt.name] = count_by_name.get(evt.name, 0) + 1
        elif evt.name in ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC"):
            launches += 1
    return {
        "device_kernels": kernels,
        "launch_calls": launches,
        "device_busy_ms": sum(by_name.values()),
        "profiled_wall_ms": wall_ms,
        "by_name_ms": by_name,
        "count_by_name": count_by_name,
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
        halves = [abs(h) for u in (u1, u2) for h in glv_halves(u)]
        field_muls += RECOVER_FIXED_FIELD_MULS
        for h, cost in zip(halves, RECOVER_DIGIT_FIELD_MULS):
            field_muls += cost * sum(1 for w in range(33) if (h >> (4 * w)) & 15)
        mont_muls += RECOVER_MONT_MULS
        wide += RECOVER_WIDE_PRODUCTS
        perms += 1
    return (field_muls * OPS_FIELD_MUL + mont_muls * OPS_MONT_MUL + wide * OPS_WIDE_PRODUCT
            + perms * KECCAK_OPS_PER_STATE)


def host_masks(rnd, ecdsa, keccak256, height):
    """The host oracle's masks: recover each lane with Python ints."""
    members = {bytes(m.sender) for m in rnd.prepares}
    prep = []
    for m in rnd.prepares:
        sig = m.signature
        pub = ecdsa.recover(
            keccak256(m.encode(include_signature=False)),
            int.from_bytes(sig[:32], "big"), int.from_bytes(sig[32:64], "big"), sig[64],
        )
        prep.append(pub is not None and ecdsa.pubkey_to_address(*pub) == m.sender
                    and m.sender in members and m.view.height == height)
    seal = []
    for s in rnd.seals:
        sig = s.signature
        pub = ecdsa.recover(
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


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--json", help="also write every measurement to this file")
    parser.add_argument("--digest-only", action="store_true",
                        help="only time digest_words and the recovery kernel (see digest_only)")
    args = parser.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card", file=sys.stderr)
        return 2
    if args.digest_only:
        return digest_only()

    import numpy as np

    from go_ibft_tpu_torch import _build, convert
    from go_ibft_tpu_torch.bench import build_recovery_lanes, build_signed_round
    from go_ibft_tpu_torch.bench.lanes import glv_halves
    from go_ibft_tpu_torch.crypto import ecdsa
    from go_ibft_tpu_torch.crypto.backend import ECDSABackend
    from go_ibft_tpu_torch.crypto.keccak import keccak256
    from go_ibft_tpu_torch.ops import ecrecover, keccak_f1600, quorum
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
    log(f"[3] built the signed 100- and 300-validator rounds in {time.perf_counter() - t0:.1f}s")

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
    err = {"keccak_f1600": 0, "keccak256_digest": 0, "secp256k1_recover": 0}

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
    report["max_abs_err"] = err

    # -- 4. the 100-validator round through both entry points ----------
    # Each kernel's wrappers: the digest kernel has two, one per output form.
    counters = {
        "keccak_f1600": (tk.keccak_f,),
        "keccak256_digest": (quorum.digest_words, tk.keccak256_blocks),
        "secp256k1_recover": (ecrecover.recover,),
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
    pm, pr, sm, sr = verifier100.certify_round(
        rnd100.prepares, rnd100.proposal_hash, rnd100.seals, rnd100.height
    )
    check(quorum.digest_words.launches == 2, "certify_round: exactly one digest launch")
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
    check(quorum.digest_words.launches == 2 and ecrecover.recover.launches > 0,
          "300 validators: the digest (once per call) and recovery kernels launched")
    n = 300
    for name, got in (("round_certify", (out[0][:n], out[2][:n])), ("certify_round", (pm, sm))):
        check(list(got[0]) == list(rnd300.expected_prepare_mask), f"{name}: prepare mask == expected")
        check(list(got[1]) == list(rnd300.expected_seal_mask), f"{name}: seal mask == expected")
    check(int(pm.sum()) == 210 and int(sm.sum()) == 210, "210 valid lanes per phase")
    check(bool(out[1]) and bool(out[3]) and pr and sr, "300 validators: 210 >= 201, quorum reached")
    log("[5] 300 validators, 30% bad: masks == expected, 210 >= 201 reached")

    # -- 6. 34 bad of 100: no quorum -----------------------------------
    reset_counts()
    rnd34 = build_signed_round(100, corrupt_frac=0.34, seed=0)
    out = [x.cpu().numpy() for x in quorum.round_certify(*convert.round_args(rnd34.pack()))]
    pm, pr, sm, sr = verifier100.certify_round(
        rnd34.prepares, rnd34.proposal_hash, rnd34.seals, rnd34.height
    )
    check(quorum.digest_words.launches == 2 and ecrecover.recover.launches > 0,
          "34 bad: the digest (once per call) and recovery kernels launched")
    check(list(pm) == list(rnd34.expected_prepare_mask) and int(pm.sum()) == 66, "34-bad prepare mask")
    check(list(sm) == list(rnd34.expected_seal_mask), "34-bad seal mask")
    check(not (pr or sr or bool(out[1]) or bool(out[3])), "66 < 67: neither quorum reached")
    log("[6] 100 validators, 34 bad: 66 < 67, neither quorum reached")

    # -- 7. timing and launch counts -----------------------------------
    # Each kernel at the main path's own inputs: the payload digests of the
    # 100- and 300-validator rounds (128 and 512 messages of 2 blocks) and
    # their recovery lanes (PREPARE + COMMIT: 256 and 1024).
    timing = {"keccak_f1600": {}, "keccak256_digest": {}, "secp256k1_recover": {}}

    def time_digest(blocks, counts):
        """The digest kernel (value words, as the main path calls it): CUDA
        events over back-to-back launches, and its time on the card per
        launch from the profiler; the plain version; the bound, counting
        the blocks these counts absorb and Keccak-f's op count per block."""
        b, nb = blocks.shape[0], blocks.shape[1]
        absorbed = int(counts.clamp(0, nb).sum())
        prof = profile_call(lambda: [keccak_f1600.launch_digest(blocks, counts, True)
                                     for _ in range(20)])
        return {
            "batch": b, "blocks": nb,
            "ms": cuda_time_ms(lambda: keccak_f1600.launch_digest(blocks, counts, True), 200),
            "device_ms_per_launch": per_launch_ms(prof, "keccak256_digest"),
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
        timing["keccak256_digest"][label] = time_digest(blocks, counts)
        ints = [tf.from_limbs(t) for t in (r, s)]
        zs = [int.from_bytes(np.ascontiguousarray(row).astype("<u4").tobytes(), "little")
              for row in zw.cpu().numpy()]
        ops = recover_ops(zs, ints[0], ints[1], [int(t) for t in v.cpu()], ecdsa.N, glv_halves)
        prof = profile_call(lambda: [ecrecover.launch(zw, r, s, v) for _ in range(5)])
        timing["secp256k1_recover"][label] = {
            "batch": v.numel(),
            "ms": cuda_time_ms(lambda: ecrecover.launch(zw, r, s, v), 20),
            "device_ms_per_launch": per_launch_ms(prof, "secp256k1_recover"),
            "plain_ms": cuda_time_ms(lambda: ecrecover.recover_plain(zw, r, s, v), 1),
            **bound(v.numel() * RECOVER_BYTES_PER_LANE, ops),
        }
    for b, nb in DIGEST_LONG:
        blocks = torch.randint(-(2**31), 2**31, (b, nb, 17, 2), dtype=torch.int32,
                               generator=gen).to(dev)
        counts = torch.full((b,), nb, dtype=torch.int32, device=dev)
        timing["keccak256_digest"][f"{b}x{nb}"] = time_digest(blocks, counts)
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
    for name, rows in timing.items():
        for key, t in rows.items():
            on_card = (f", {t['device_ms_per_launch'] * 1e3:.2f} us on the card"
                       if "device_ms_per_launch" in t else "")
            log(f"[7] {name} at {key}: kernel {t['ms']:.5f} ms{on_card}, plain "
                f"{t['plain_ms']:.3f} ms, bound {t['bound_ms']:.3g} ms ({t['bound_by']})")
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
    for label, rnd, verifier in (("100v", rnd100, verifier100), ("300v_30bad", rnd300, verifier300)):
        t0 = time.perf_counter()
        prof = profile_call(lambda rnd=rnd, verifier=verifier: verifier.certify_round(
            rnd.prepares, rnd.proposal_hash, rnd.seals, rnd.height))
        busy = prof["device_busy_ms"]
        top = sorted(prof.pop("by_name_ms").items(), key=lambda kv: -kv[1])[:5]
        prof.pop("count_by_name")
        prof["idle_share_vs_median"] = 1 - busy / medians[label]["certify_round_host_ms"]
        prof["top_kernels_ms"] = top
        medians[label]["profile"] = prof
        log(f"[7] {label} profile: {prof['device_kernels']} kernels, {prof['launch_calls']} launch "
            f"calls, device busy {busy:.3f} ms (idle {prof['idle_share_vs_median']:.3f} of the "
            f"median call); profiling took {time.perf_counter() - t0:.0f}s")
        for name, ms in top:
            log(f"    {ms:9.4f} ms  {name[:90]}")
    check(medians["100v"]["profile"]["device_kernels"] < 10_000,
          "fewer than 10,000 kernels per 100-validator certify_round")
    st = torch.randint(-(2**31), 2**31, (256, 25, 2), dtype=torch.int32, generator=gen).to(dev)
    kprof = profile_call(lambda: [keccak_f1600.launch(st) for _ in range(50)])
    kern_dev_ms = per_launch_ms(kprof, "keccak_f1600")
    timing["keccak_f1600"][256]["device_ms_per_launch"] = kern_dev_ms
    log(f"[7] keccak_f1600 at B=256: {kern_dev_ms * 1e3:.2f} us on the card per launch (profiler)")
    report["medians"] = medians

    # -- 8. the kernels line and the result ----------------------------
    main = {"keccak_f1600": timing["keccak_f1600"][256],  # PR 1's main-path size
            "keccak256_digest": timing["keccak256_digest"]["100v"],
            "secp256k1_recover": timing["secp256k1_recover"]["100v"]}
    where = {
        "keccak_f1600": ("go_ibft_tpu_torch/csrc/keccak_f1600.cu",
                         "go_ibft_tpu/ops/pallas_keccak.py:131"),
        "keccak256_digest": ("go_ibft_tpu_torch/csrc/keccak_f1600.cu",
                             "go_ibft_tpu/ops/quorum.py:65"),
        "secp256k1_recover": ("go_ibft_tpu_torch/csrc/secp256k1_recover.cu",
                              "go_ibft_tpu/ops/secp256k1.py:665"),
    }
    # "ms" is CUDA events over back-to-back launches, which the wrapper's
    # Python bounds for the short Keccak kernels; "device_ms_per_launch" is
    # the kernel's own time on the card (profiler).
    kernels = [{
        "name": name,
        "route": "cuda",
        "source": where[name][0],
        "replaces": where[name][1],
        "launches": launches[name],
        "max_abs_err": err[name],
        "ms": main[name]["ms"],
        "device_ms_per_launch": main[name]["device_ms_per_launch"],
        "plain_ms": main[name]["plain_ms"],
        "bound_ms": main[name]["bound_ms"],
        "bound_by": main[name]["bound_by"],
        "library_ms": None,
    } for name in counters]
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
