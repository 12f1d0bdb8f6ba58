"""Time variants of the pairing kernels on the card: the measurements behind
the design choices of ``csrc/bls12_381.cu``.

    python3 -m go_ibft_tpu_torch.bench.bls_variants [--json PATH]

Builds patched copies of ``csrc/`` (one ``nvcc`` each, all started
together) into ``build/bls_variants/<name>/`` and times ``bls_miller`` and
``bls_final_exp`` through their C entry points with CUDA events, at 1, 64,
256, 512 and 1,024 lanes (eight seeded lanes of pool points, tiled):

* ``shipped``: the source as it is;
* ``threads32`` / ``threads64``: every lane on 32 threads, or on 64 at any
  lane count (the shipped final exponentiation takes 64 below 512 lanes and
  32 from there; the Miller loop 64 always);
* ``batch1`` / ``batch8``: the interpreter issues its loads 1 or 8 terms at a
  time (shipped: 4);
* ``no_products`` / ``no_operands`` / ``no_stores``: builds that skip a
  round's Fp products, its operand sums or its store sums, whose outputs
  are wrong and are timed only: the shipped time less theirs is that part's
  share.

Each variant whose output should be exact is checked against the shipped
build's words.  Prints the card's identity, then one JSON line.  Needs one
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
from ..crypto import bls as hbls
from ..ops import bls12_381 as ops

LANES = (1, 64, 256, 512, 1024)
_CU, _CUH = "bls12_381.cu", "bls12_381.cuh"
_OPERAND_A = "const Fp a = eval(sched::kSlotForms[2 * (first + s)], elems);"
_OPERAND_B = "const Fp b = eval(sched::kSlotForms[2 * (first + s) + 1], elems);"
# name -> (file, old, new) patches, and whether its outputs are exact.
VARIANTS = {
    "shipped": ((), True),
    "threads32": (((_CU, "constexpr int kMillerThreads = 64;", "constexpr int kMillerThreads = 32;"),
                   (_CU, "constexpr int kExpThreads = 64;", "constexpr int kExpThreads = 32;")), True),
    "threads64": (((_CU, "constexpr long long kExpWideLanes = 512;",
                    "constexpr long long kExpWideLanes = 1LL << 40;"),), True),
    "batch1": (((_CUH, "constexpr int kBatch = 4;", "constexpr int kBatch = 1;"),), True),
    "batch8": (((_CUH, "constexpr int kBatch = 4;", "constexpr int kBatch = 8;"),), True),
    "no_products": (((_CUH, "store(elems + s * kWords, mul(a, b));", "store(elems + s * kWords, add(a, b));"),),
                    False),
    "no_operands": (((_CUH, _OPERAND_A, "const Fp a = load(elems + ((s + 1) % 64) * kWords);"),
                     (_CUH, _OPERAND_B, "const Fp b = load(elems + ((s + 2) % 64) * kWords);")), False),
    "no_stores": (((_CUH, "const Fp v = eval(sched::kStoreForms[2 * (first + s) + 1], elems);",
                    "const Fp v = load(elems + (s % 64) * kWords);"),), False),
}


def _build_variants(root: Path) -> dict:
    """Start one nvcc a variant; return name -> (process, library path)."""
    flags = list(_build.NVCC_FLAGS)
    procs = {}
    for name, (patches, _) in VARIANTS.items():
        src = root / name
        src.mkdir(parents=True, exist_ok=True)
        for f in _build.CSRC.glob("*.cu*"):
            text = f.read_text()
            for file, old, new in patches:
                if file == f.name:
                    assert text.count(old) == 1, (name, old)
                    text = text.replace(old, new)
            (src / f.name).write_text(text)
        lib = src / "bls12_381.so"
        cmd = [_build.find_nvcc(), *flags[:flags.index(str(_build.CSRC))], str(src),
               *flags[flags.index(str(_build.CSRC)) + 1:], "-o", str(lib), str(src / _CU)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), lib)
    return procs


def _load(lib: Path) -> ctypes.CDLL:
    cdll = ctypes.CDLL(str(lib))
    for fn, (argtypes, restype) in _build.SIGNATURES["bls12_381"].items():
        getattr(cdll, fn).argtypes = argtypes
        getattr(cdll, fn).restype = restype
    return cdll


def _lanes(dev: torch.device):
    """Eight seeded lanes: G2 points (2, 8, 4, 12) and G1 points (2, 8, 2, 12)."""
    g2, g1 = [hbls.G2_GEN], [hbls.G1_GEN]
    for _ in range(15):
        g2.append(hbls.g2_add(g2[-1], hbls.G2_GEN))
        g1.append(hbls.g1_add(g1[-1], hbls.G1_GEN))
    idx = np.random.default_rng(9).integers(0, 16, size=(4, 8))
    q = np.stack([ops.pack_g2_points([g2[i] for i in idx[k]]) for k in (0, 1)])
    p = np.stack([ops.pack_g1_points([g1[i] for i in idx[2]]),
                  ops.pack_g1_points([hbls.g1_neg(g1[i]) for i in idx[3]])])
    return torch.from_numpy(q).to(dev), torch.from_numpy(p).to(dev)


def _event_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--json", help="also write the result to this file")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("bls_variants: no CUDA device; this script runs only on the card")
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(gpu, flush=True)
    procs = _build_variants(_build.BUILD_DIR.parent / "bls_variants")
    libs, ptxas = {}, {}
    for name, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed for variant {name}:\n{log[-3000:]}")
        libs[name] = _load(lib)
        ptxas[name] = [line.strip() for line in log.splitlines() if "registers" in line or "stack frame" in line]
    dev = torch.device("cuda")
    stream = torch.cuda.current_stream(dev).cuda_stream
    q8, p8 = _lanes(dev)
    out = {"gpu": gpu, "lanes": list(LANES), "ptxas": ptxas, "variants": {}}
    shipped = {}
    for name, lib in libs.items():
        row = {"miller_ms": {}, "final_exp_ms": {}, "exact": None}
        exact = True
        for n in LANES:
            tiles = -(-n // 8)
            q = q8.repeat(1, tiles, 1, 1)[:, :n].contiguous()
            p = p8.repeat(1, tiles, 1, 1)[:, :n].contiguous()
            f = torch.empty((n, 12, 12), dtype=torch.int32, device=dev)
            ok = torch.empty(n, dtype=torch.bool, device=dev)
            r = torch.empty((n, 12, 12), dtype=torch.int32, device=dev)
            gate = torch.ones(n, dtype=torch.bool, device=dev)

            def miller():
                assert lib.bls_miller(q.data_ptr(), p.data_ptr(), n, f.data_ptr(), stream) == 0

            def final_exp():
                assert lib.bls_final_exp(f.data_ptr(), gate.data_ptr(), n, ok.data_ptr(), r.data_ptr(), stream) == 0

            miller()
            final_exp()
            torch.cuda.synchronize()
            words = (f.cpu(), r.cpu(), ok.cpu())
            if name == "shipped":
                shipped[n] = words
            elif VARIANTS[name][1]:
                exact = exact and all(torch.equal(a, b) for a, b in zip(words, shipped[n]))
            row["miller_ms"][n] = _event_ms(miller, 5)
            row["final_exp_ms"][n] = _event_ms(final_exp, 5)
        if VARIANTS[name][1] and name != "shipped":
            row["exact"] = exact
        out["variants"][name] = row
        print(f"{name}: miller {row['miller_ms']}, final_exp {row['final_exp_ms']}, exact {row['exact']}",
              flush=True)
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)), exist_ok=True)
        with open(args.json, "w") as fh:
            json.dump(out, fh, indent=1)
    print(json.dumps(out), flush=True)
    bad = [name for name, row in out["variants"].items() if row["exact"] is False]
    return 1 if bad else 0


if __name__ == "__main__":
    raise SystemExit(main())
