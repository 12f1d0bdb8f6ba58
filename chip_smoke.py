"""Drive the PyTorch port's main path on one NVIDIA card and check it.

    python3 chip_smoke.py [--json PATH]

Phases, in order (any failure exits non-zero and prints no result):

1. the card's name and power limit (``nvidia-smi``), torch/CUDA/nvcc versions;
2. build every CUDA kernel of the path from ``go_ibft_tpu_torch/csrc``;
3. hold each kernel against its plain PyTorch version on the card,
   bit-exact, at the batch sizes the path uses and beyond;
4. certify a 100-validator round (seed 0) through both entry points,
   ``ops.quorum.round_certify`` and ``DeviceBatchVerifier.certify_round``:
   every mask true, both quorums reached, masks equal to the host oracle
   (``crypto.ecdsa.recover``); the kernels' launch counts are read here;
5. the 300-validator round with 30 % bad signatures: masks equal the
   expected masks, quorum reached (210 >= 201);
6. a 100-validator round with 34 bad signatures: no quorum;
7. time phases 4-5 with CUDA events and the host clock (median of 10
   calls after warm-up), and profile one 100-validator call: device
   kernels, device busy time, idle share;
8. print the ``kernels`` line, then the result line.

It imports nothing of JAX or of the JAX package.  It needs one card and
exits non-zero where ``torch.cuda.is_available()`` is false.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time

import torch

# H100 SXM peaks (NVIDIA data sheet): HBM bandwidth, and the 32-bit rate
# outside the tensor cores, used here for the kernel's 32-bit integer ops.
HBM_BYTES_PER_S = 3.35e12
OPS_PER_S_32BIT = 67e12

# The main path's shapes (payload digests and address hashes of the 100-
# and 300-validator rounds: 128, 256, 512, 1024 states) and ragged ones.
KECCAK_BATCHES = (1, 128, 129, 256, 512, 1024, 4096)
TIMED_BATCHES = (128, 256, 1024, 4096)
# 64-bit operations in one Keccak-f round: theta (20 xor + 5 rot + 5 xor +
# 25 xor), rho (24 rot), chi (25 x not/and/xor), iota (1 xor); each is two
# 32-bit operations.
KECCAK_OPS_PER_STATE = 24 * 2 * (20 + 5 + 5 + 25 + 24 + 75 + 1)
KECCAK_BYTES_PER_STATE = 2 * 25 * 8  # read once, written once


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
    kernels, launches, by_name = 0, 0, {}
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            kernels += 1
            by_name[evt.name] = by_name.get(evt.name, 0.0) + evt.time_range.elapsed_us() / 1e3
        elif evt.name in ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC"):
            launches += 1
    return {
        "device_kernels": kernels,
        "launch_calls": launches,
        "device_busy_ms": sum(by_name.values()),
        "profiled_wall_ms": wall_ms,
        "by_name_ms": by_name,
    }


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


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--json", help="also write every measurement to this file")
    args = parser.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card", file=sys.stderr)
        return 2

    from go_ibft_tpu_torch import _build, convert
    from go_ibft_tpu_torch.bench import build_signed_round
    from go_ibft_tpu_torch.crypto import ecdsa
    from go_ibft_tpu_torch.crypto.backend import ECDSABackend
    from go_ibft_tpu_torch.crypto.keccak import keccak256
    from go_ibft_tpu_torch.ops import keccak as tk
    from go_ibft_tpu_torch.ops import keccak_f1600, quorum
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
    for name, text in _build.build_logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"    {name}: {line.strip()}")

    # -- 3. kernel vs plain --------------------------------------------
    gen = torch.Generator(device="cpu").manual_seed(0)
    max_err = 0
    for b in KECCAK_BATCHES:
        st = torch.randint(-(2**31), 2**31, (b, 25, 2), dtype=torch.int32, generator=gen).to(dev)
        out = keccak_f1600.launch(st)
        torch.cuda.synchronize()
        ref = keccak_f1600.keccak_f_plain(st)
        err = int((out.to(torch.int64) - ref.to(torch.int64)).abs().max())
        max_err = max(max_err, err)
        check(torch.equal(out, ref), f"keccak_f1600 kernel == plain at B={b}")
    log(f"[3] keccak_f1600 bit-exact against plain at B={KECCAK_BATCHES}")
    timing = {}
    for b in TIMED_BATCHES:
        st = torch.randint(-(2**31), 2**31, (b, 25, 2), dtype=torch.int32, generator=gen).to(dev)
        kern = cuda_time_ms(lambda st=st: keccak_f1600.launch(st), 200)
        plain = cuda_time_ms(lambda st=st: keccak_f1600.keccak_f_plain(st), 5)
        bytes_ms = b * KECCAK_BYTES_PER_STATE / HBM_BYTES_PER_S * 1e3
        ops_ms = b * KECCAK_OPS_PER_STATE / OPS_PER_S_32BIT * 1e3
        timing[b] = {
            "ms": kern, "plain_ms": plain, "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        }
        log(f"    B={b}: kernel {kern:.5f} ms, plain {plain:.3f} ms, "
            f"bound {timing[b]['bound_ms']:.3g} ms ({timing[b]['bound_by']})")
    report["keccak_timing"] = timing

    # -- 4. the 100-validator round through both entry points ----------
    t0 = time.perf_counter()
    rnd100 = build_signed_round(100, seed=0)
    w100 = rnd100.pack()
    src100 = ECDSABackend.static_validators({m.sender: 1 for m in rnd100.prepares})
    args100 = convert.round_args(w100)
    verifier100 = DeviceBatchVerifier(src100)
    log(f"[4] built the signed 100-validator round in {time.perf_counter() - t0:.1f}s")

    tk.keccak_f.launches = 0
    out = quorum.round_certify(*args100)
    pm, pr, sm, sr = verifier100.certify_round(
        rnd100.prepares, rnd100.proposal_hash, rnd100.seals, rnd100.height
    )
    launches = tk.keccak_f.launches
    check(launches > 0, "keccak_f1600 launched on the main path")
    n = rnd100.n_validators
    rc = [x.cpu().numpy() for x in out]
    check(bool(rc[0][:n].all() and rc[2][:n].all()), "round_certify: every 100-validator lane valid")
    check(not rc[0][n:].any() and not rc[2][n:].any(), "round_certify: padding lanes dead")
    check(bool(rc[1]) and bool(rc[3]), "round_certify: both quorums reached")
    check(bool(pm.all() and sm.all() and pr and sr), "certify_round: all valid, both quorums")
    hp, hs = host_masks(rnd100, ecdsa, keccak256, rnd100.height)
    check(list(pm) == hp and list(sm) == hs, "certify_round masks == host oracle")
    check(list(rc[0][:n]) == hp and list(rc[2][:n]) == hs, "round_certify masks == host oracle")
    log(f"[4] 100 validators: masks == host oracle, quorum reached; keccak_f launches {launches}")
    report["keccak_launches_main_path"] = launches

    # -- 5. 300 validators, 30 % bad -----------------------------------
    t0 = time.perf_counter()
    rnd300 = build_signed_round(300, corrupt_frac=0.3, seed=0)
    w300 = rnd300.pack()
    src300 = ECDSABackend.static_validators({m.sender: 1 for m in rnd300.prepares})
    args300 = convert.round_args(w300)
    verifier300 = DeviceBatchVerifier(src300)
    log(f"[5] built the signed 300-validator round in {time.perf_counter() - t0:.1f}s")
    out = [x.cpu().numpy() for x in quorum.round_certify(*args300)]
    pm, pr, sm, sr = verifier300.certify_round(
        rnd300.prepares, rnd300.proposal_hash, rnd300.seals, rnd300.height
    )
    n = 300
    for name, got in (("round_certify", (out[0][:n], out[2][:n])), ("certify_round", (pm, sm))):
        check(list(got[0]) == list(rnd300.expected_prepare_mask), f"{name}: prepare mask == expected")
        check(list(got[1]) == list(rnd300.expected_seal_mask), f"{name}: seal mask == expected")
    check(int(pm.sum()) == 210 and int(sm.sum()) == 210, "210 valid lanes per phase")
    check(bool(out[1]) and bool(out[3]) and pr and sr, "300 validators: 210 >= 201, quorum reached")
    log("[5] 300 validators, 30% bad: masks == expected, 210 >= 201 reached")

    # -- 6. 34 bad of 100: no quorum -----------------------------------
    rnd34 = build_signed_round(100, corrupt_frac=0.34, seed=0)
    out = [x.cpu().numpy() for x in quorum.round_certify(*convert.round_args(rnd34.pack()))]
    pm, pr, sm, sr = verifier100.certify_round(
        rnd34.prepares, rnd34.proposal_hash, rnd34.seals, rnd34.height
    )
    check(list(pm) == list(rnd34.expected_prepare_mask) and int(pm.sum()) == 66, "34-bad prepare mask")
    check(list(sm) == list(rnd34.expected_seal_mask), "34-bad seal mask")
    check(not (pr or sr or bool(out[1]) or bool(out[3])), "66 < 67: neither quorum reached")
    log("[6] 100 validators, 34 bad: 66 < 67, neither quorum reached")

    # -- 7. timing and launch counts -----------------------------------
    medians = {}
    for label, rnd, verifier, rargs in (
        ("100v", rnd100, verifier100, args100),
        ("300v_30bad", rnd300, verifier300, args300),
    ):
        def call_round(verifier=verifier, rnd=rnd):
            return verifier.certify_round(rnd.prepares, rnd.proposal_hash, rnd.seals, rnd.height)

        def call_program(rargs=rargs):
            return [bool(x) if x.dim() == 0 else x.cpu() for x in quorum.round_certify(*rargs)]

        host_ms, dev_ms = median_ms(call_round, calls=10)
        prog_host_ms, prog_dev_ms = median_ms(call_program, calls=3)
        medians[label] = {
            "certify_round_host_ms": host_ms, "certify_round_event_ms": dev_ms,
            "round_certify_host_ms": prog_host_ms, "round_certify_event_ms": prog_dev_ms,
        }
        log(f"[7] {label}: certify_round median of 10 {host_ms:.1f} ms host / {dev_ms:.1f} ms "
            f"events; round_certify median of 3 {prog_host_ms:.1f} / {prog_dev_ms:.1f} ms")
    # The kernel count does not depend on the batch; profile the 100v round once.
    t0 = time.perf_counter()
    prof = profile_call(lambda: verifier100.certify_round(
        rnd100.prepares, rnd100.proposal_hash, rnd100.seals, rnd100.height))
    busy = prof["device_busy_ms"]
    top = sorted(prof.pop("by_name_ms").items(), key=lambda kv: -kv[1])[:5]
    prof["idle_share_vs_median"] = 1 - busy / medians["100v"]["certify_round_host_ms"]
    prof["top_kernels_ms"] = top
    medians["100v"]["profile"] = prof
    log(f"[7] 100v profile: {prof['device_kernels']} kernels, {prof['launch_calls']} launch calls, "
        f"device busy {busy:.1f} ms (idle {prof['idle_share_vs_median']:.3f} of the median call); "
        f"profiling took {time.perf_counter() - t0:.0f}s")
    for name, ms in top:
        log(f"    {ms:9.2f} ms  {name[:90]}")
    st = torch.randint(-(2**31), 2**31, (256, 25, 2), dtype=torch.int32, generator=gen).to(dev)
    kprof = profile_call(lambda: [keccak_f1600.launch(st) for _ in range(50)])
    kern_dev_ms = sum(ms for name, ms in kprof["by_name_ms"].items() if "keccak" in name) / 50
    timing[256]["device_ms_per_launch"] = kern_dev_ms
    log(f"[7] keccak_f1600 at B=256: {kern_dev_ms * 1e3:.2f} us on the card per launch (profiler)")
    report["medians"] = medians

    # -- 8. the kernels line and the result ----------------------------
    main_b = 256  # the address hash of the 100-validator round: 2 x 128 lanes
    kernels = [{
        "name": "keccak_f1600",
        "route": "cuda",
        "source": "go_ibft_tpu_torch/csrc/keccak_f1600.cu",
        "replaces": "go_ibft_tpu/ops/pallas_keccak.py:131",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": timing[main_b]["ms"],
        "plain_ms": timing[main_b]["plain_ms"],
        "bound_ms": timing[main_b]["bound_ms"],
        "bound_by": timing[main_b]["bound_by"],
        "library_ms": None,
    }]
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
