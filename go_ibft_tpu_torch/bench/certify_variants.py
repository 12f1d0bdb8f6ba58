"""Time variants of the ``certify_lanes`` kernel on the card: the
measurements behind the design choices of ``csrc/certify_lanes.cu``.

    python3 -m go_ibft_tpu_torch.bench.certify_variants [--variants NAME,...]
        [--csrc DIR] [--json PATH]

Builds patched copies of ``csrc/`` (or of ``--csrc``; one ``nvcc`` each, all
started together) into ``build/certify_variants/<name>/`` and launches each
through its C entry point (no Python launcher in the way) at the three
shapes of the main path, two phases each: 2 x 128 lanes against 128 rows
(a 100-validator round), 2 x 512 against 512 (300 validators) and the
worst bucket, 2 x 2,048 against 2,048 (seeded lanes: members, outsiders,
failed recoveries, dead lanes, repeated senders and rows).  Every launch of
every variant runs in one profiler session (the profiler records the card
only in a process's first sessions), split by launch order; a variant's
time is its mean time on the card a launch.

* ``shipped``: the source as it is;
* ``threads256`` / ``threads1024``: a phase's blocks on 256 or 1,024
  threads (shipped: 512);
* ``cluster4``: a phase on a cluster of 4 blocks (shipped: 8);
* ``unroll4``: the row-group loop of a stripe unrolled by 4;
* ``no_scan``: the lanes' table scan skipped, ``no_reduce``: the counted
  set ORed over the block's own bytes only (no distributed shared memory):
  their outputs are wrong and they are timed only; the shipped time less
  theirs is that part's share.

Each variant whose output should be exact is checked against the shipped
build's bytes.  Prints the card's identity, then one JSON line.  Needs one
card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
from pathlib import Path

import numpy as np
import torch

from .. import _build

SHAPES = ((128, 128), (512, 512), (2048, 2048))  # (lanes a phase, table rows)
LAUNCHES = 20
_CU = "certify_lanes.cu"
# name -> (patches as (old, new) of the source, whether its outputs are exact).
VARIANTS = {
    "shipped": ((), True),
    "threads256": ((("constexpr int kPhaseThreads = 512;", "constexpr int kPhaseThreads = 256;"),), True),
    "threads1024": ((("constexpr int kPhaseThreads = 512;", "constexpr int kPhaseThreads = 1024;"),), True),
    "cluster4": ((("constexpr int kCluster = 8; ", "constexpr int kCluster = 4; "),), True),
    "unroll4": ((("  for (int g = stripe; g < groups; g += stripes) {",
                  "#pragma unroll 4\n  for (int g = stripe; g < groups; g += stripes) {"),), True),
    "no_scan": ((("int member = have && lane_stripe(l, i, tile, rows, stripe, stripes, counted);",
                  "int member = 0;"),), False),
    "no_reduce": ((("any |= cluster.map_shared_rank(counted, q)[r] != 0;", "any |= counted[r] != 0;"),), False),
}


def _build_variants(root: Path, csrc: Path, variants: dict) -> dict:
    """Start one nvcc a variant; return name -> (process, library path)."""
    flags = list(_build.NVCC_FLAGS)
    at = flags.index(str(_build.CSRC))
    procs = {}
    for name, (patches, _) in variants.items():
        src = root / name
        src.mkdir(parents=True, exist_ok=True)
        for f in csrc.glob("*.cu*"):
            text = f.read_text()
            if f.name == _CU:
                for old, new in patches:
                    assert old in text, f"variant {name}: {old!r} is not in {f}"
                    text = text.replace(old, new)
            (src / f.name).write_text(text)
        lib = src / "certify_lanes.so"
        cmd = [_build.find_nvcc(), *flags[:at], str(src), *flags[at + 1:], "-o", str(lib), str(src / _CU)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), lib)
    return procs


def _load(lib: Path):
    fn = ctypes.CDLL(str(lib)).certify_lanes
    fn.argtypes, fn.restype = _build.SIGNATURES["certify_lanes"]["certify_lanes"]
    return fn


def _case(lanes: int, rows: int, seed: int, dev: torch.device):
    """Two phases of ``lanes`` seeded lanes against ``rows`` rows, as tensors
    on ``dev``: a tenth outsiders, a twentieth recovering another address,
    the last quarter repeating the first, rows 1..4 copies of row 0."""
    rng = np.random.default_rng(seed)
    n = 2 * lanes
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


def _launcher(fn, case, out: torch.Tensor):
    """A launch of ``fn`` on ``case`` (two phases split in the middle,
    thresholds 1) into ``out``, on the current stream; raises on a fault."""
    addr, ok, claimed, live, table, plo, phi = case
    n = ok.shape[0]
    args = (addr.data_ptr(), ok.data_ptr(), claimed.data_ptr(), live.data_ptr(), n, table.data_ptr(),
            plo.data_ptr(), phi.data_ptr(), table.shape[0], 2, n // 2, 1, 0, 1, 0, None, None, None, None,
            out.data_ptr())

    def launch():
        rc = fn(*args, torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"certify_lanes launch failed: cudaError {rc}")

    return launch


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--csrc", default=str(_build.CSRC), help="the kernel sources to patch")
    parser.add_argument("--variants", help="only these variants (comma-separated names)")
    parser.add_argument("--json", help="also write the result to this file")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("certify_variants: no CUDA device; this script runs only on the card")
    from torch.profiler import ProfilerActivity, profile

    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(gpu, flush=True)
    named = dict(VARIANTS)
    if args.variants:
        named = {name: VARIANTS[name] for name in ["shipped", *args.variants.split(",")]}
    procs = _build_variants(_build.BUILD_DIR.parent / "certify_variants", Path(args.csrc), named)
    fns, ptxas = {}, {}
    for name, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed for variant {name}:\n{log[-3000:]}")
        fns[name] = _load(lib)
        ptxas[name] = [line.strip() for line in log.splitlines() if "registers" in line or "stack frame" in line]
    dev = torch.device("cuda")
    cases = [_case(lanes, rows, lanes + rows, dev) for lanes, rows in SHAPES]
    outs = {(name, k): torch.zeros((18 + 2 * lanes,), dtype=torch.uint8, device=dev)
            for name in fns for k, (lanes, _) in enumerate(SHAPES)}
    launches = [(name, k, _launcher(fns[name], cases[k], outs[name, k])) for name in fns for k in range(len(SHAPES))]
    for _, _, launch in launches:  # loads the modules, first launches
        launch()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        for _, _, launch in launches:
            for _ in range(LAUNCHES):
                launch()
            torch.cuda.synchronize()
    times = sorted((evt.time_range.start, evt.time_range.elapsed_us() / 1e3) for evt in prof.events()
                   if evt.device_type == torch.autograd.DeviceType.CUDA and "certify_lanes" in evt.name)
    if len(times) != LAUNCHES * len(launches):
        raise SystemExit(f"the profiler recorded {len(times)} launches of {LAUNCHES * len(launches)}")
    out = {"gpu": gpu, "csrc": args.csrc, "shapes": [f"2x{lanes}x{rows}" for lanes, rows in SHAPES],
           "ptxas": ptxas, "variants": {}}
    for j, (name, k, _) in enumerate(launches):
        row = out["variants"].setdefault(name, {"device_ms": [], "exact": None})
        row["device_ms"].append(sum(ms for _, ms in times[j * LAUNCHES:(j + 1) * LAUNCHES]) / LAUNCHES)
    for name, row in out["variants"].items():
        if named[name][1] and name != "shipped":
            row["exact"] = all(torch.equal(outs[name, k], outs["shipped", k]) for k in range(len(SHAPES)))
        print(f"{name}: {row['device_ms']} ms a launch on the card, exact {row['exact']}", flush=True)
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)), exist_ok=True)
        with open(args.json, "w") as fh:
            json.dump(out, fh, indent=1)
    print(json.dumps(out), flush=True)
    return 1 if any(row["exact"] is False for row in out["variants"].values()) else 0


if __name__ == "__main__":
    raise SystemExit(main())
