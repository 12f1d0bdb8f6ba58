"""Time variants of the BLS kernels on the card: the measurements behind
the design choices of ``csrc/bls12_381.cu``.

    python3 -m go_ibft_tpu_torch.bench.bls_variants [--kernels pairing|merge|all]
        [--variants NAME,...] [--csrc DIR] [--json PATH]

Builds patched copies of ``csrc/`` (or of ``--csrc``, e.g. another
checkout's; one ``nvcc`` each, all started together) into
``build/bls_variants/<name>/`` and times the kernels through their C entry
points with CUDA events.  A variant's patch whose text the source does not
hold is skipped, so one variant can name the anchors of two versions of
the source; each variant applies at least one.

The pairing kernels, ``bls_miller`` and ``bls_final_exp``, at 1, 64, 256,
512 and 1,024 lanes (eight seeded lanes of pool points, tiled):

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

The merge, ``bls_merge``, on G1 and G2 at 1 x 128 (100 live), 1 x 1,024,
64 x 8 and 1,024 x 8 (seeded pool points, duplicates, a few dead lanes):

* ``merge_no_inverse``: the affine map without its field inversion (the
  inverse taken as its input);
* ``merge_no_tree``: the additions skipped (the first version: the halving
  tree; the redesign: every level);
* ``merge_inv_no_de`` / ``merge_inv_no_fg``: the safegcd inverse without
  its (d, e) or its (f, g) update (the latter runs all 37 batches): with
  ``merge_no_inverse``, the split of a batch into divsteps and updates;
* ``merge_inv_var``: the inverse's divsteps in runs of even g and 8-bit
  clears (libsecp256k1's variable-time form) instead of the shipped 30
  branch-free steps a batch;
* ``merge_threads128`` / ``256`` / ``512``: the redesign on that many
  threads a block at every shape (shipped: 256 where a block holds several
  groups, 512 where it holds one).

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
# (name, coordinates, groups, points a group, live points a group)
MERGE_SHAPES = (("G2 1x128", 4, 1, 128, 100), ("G1 1x128", 2, 1, 128, 100), ("G2 1x1024", 4, 1, 1024, 1000),
                ("G1 1x1024", 2, 1, 1024, 1000), ("G2 64x8", 4, 64, 8, 8), ("G1 64x8", 2, 64, 8, 8),
                ("G2 1024x8", 4, 1024, 8, 8), ("G1 1024x8", 2, 1024, 8, 8))
_CU, _CUH = "bls12_381.cu", "bls12_381.cuh"
_OPERAND_A = "const Fp a = eval(sched::kSlotForms[2 * (first + s)], elems);"
_OPERAND_B = "const Fp b = eval(sched::kSlotForms[2 * (first + s) + 1], elems);"
# name -> (file, old, new) patches, and whether its outputs are exact.
PAIRING_VARIANTS = {
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
# The inverse's divsteps in the form of libsecp256k1's
# modinv32_divsteps_30_var (runs of even g at once, then up to 8 low bits of
# g cleared by one multiple of f) in place of the shipped 30 branch-free
# steps a batch.
_VAR_DIVSTEPS = """// -(2 i + 1)^-1 mod 256: the multiple of f that clears g's low bits.
LANE_TABLE uint8_t kInv256[128] = {
    0xff, 0x55, 0x33, 0x49, 0xc7, 0x5d, 0x3b, 0x11, 0x0f, 0xe5, 0xc3, 0x59, 0xd7, 0xed, 0xcb, 0x21,
    0x1f, 0x75, 0x53, 0x69, 0xe7, 0x7d, 0x5b, 0x31, 0x2f, 0x05, 0xe3, 0x79, 0xf7, 0x0d, 0xeb, 0x41,
    0x3f, 0x95, 0x73, 0x89, 0x07, 0x9d, 0x7b, 0x51, 0x4f, 0x25, 0x03, 0x99, 0x17, 0x2d, 0x0b, 0x61,
    0x5f, 0xb5, 0x93, 0xa9, 0x27, 0xbd, 0x9b, 0x71, 0x6f, 0x45, 0x23, 0xb9, 0x37, 0x4d, 0x2b, 0x81,
    0x7f, 0xd5, 0xb3, 0xc9, 0x47, 0xdd, 0xbb, 0x91, 0x8f, 0x65, 0x43, 0xd9, 0x57, 0x6d, 0x4b, 0xa1,
    0x9f, 0xf5, 0xd3, 0xe9, 0x67, 0xfd, 0xdb, 0xb1, 0xaf, 0x85, 0x63, 0xf9, 0x77, 0x8d, 0x6b, 0xc1,
    0xbf, 0x15, 0xf3, 0x09, 0x87, 0x1d, 0xfb, 0xd1, 0xcf, 0xa5, 0x83, 0x19, 0x97, 0xad, 0x8b, 0xe1,
    0xdf, 0x35, 0x13, 0x29, 0xa7, 0x3d, 0x1b, 0xf1, 0xef, 0xc5, 0xa3, 0x39, 0xb7, 0xcd, 0xab, 0x01};

LANE_FN int ctz32(uint32_t x) {
#if defined(__CUDA_ARCH__)
  return __ffs(static_cast<int>(x)) - 1;
#else
  return __builtin_ctz(x);
#endif
}

// 30 divsteps on the low bits of f (odd) and g; eta = -delta.  Returns the
// new eta and the transition matrix t = (u, v, q, r), scaled by 2^30.  The
// divsteps of libsecp256k1's modinv32_divsteps_30_var: a run of even g at
// once, then up to 8 low bits of g cleared by one multiple of f, so a batch
// takes a few branches instead of 30 branch-free steps (the inputs are
// public).
LANE_FN int32_t divsteps_30_var(int32_t eta, uint32_t f, uint32_t g, int32_t t[4]) {
  uint32_t u = 1, v = 0, q = 0, r = 1;
  int i = 30;
#pragma unroll 1
  for (;;) {
    const int zeros = ctz32(g | (0xffffffffu << i));  // a sentinel bit: at most i
    g >>= zeros;
    u <<= zeros;
    v <<= zeros;
    eta -= zeros;
    i -= zeros;
    if (i == 0) {
      break;
    }
    if (eta < 0) {  // delta > 0 and g odd: (f, g) <- (g, -f)
      uint32_t tmp;
      eta = -eta;
      tmp = f;
      f = g;
      g = 0u - tmp;
      tmp = u;
      u = q;
      q = 0u - tmp;
      tmp = v;
      v = r;
      r = 0u - tmp;
    }
    // Clear g's low min(eta + 1, i, 8) bits: no more than i are left, and
    // delta's sign flips after eta + 1.
    const int limit = eta + 1 > i ? i : eta + 1;
    const uint32_t m = (0xffffffffu >> (32 - limit)) & 255u;
    const uint32_t w = (g * kInv256[(f >> 1) & 127u]) & m;
    g += f * w;
    q += u * w;
    r += v * w;
  }
  t[0] = static_cast<int32_t>(u);
  t[1] = static_cast<int32_t>(v);
  t[2] = static_cast<int32_t>(q);
  t[3] = static_cast<int32_t>(r);
  return eta;
}

"""
_DIVSTEPS = "LANE_FN int32_t divsteps_30(int32_t eta, uint32_t f, uint32_t g, int32_t t[4]) {"
# The merge's variants; the first version's anchors beside the redesign's.
MERGE_VARIANTS = {
    "shipped": ((), True),
    "merge_no_inverse": (((_CUH, "const F zi = inv(p.z);", "const F zi = p.z;"),
                          (_CU, "bls::store(tinv, bls::inv(", "bls::store(tinv, (")), False),
    "merge_no_tree": (((_CU, "for (int s = kMergeThreads / 2; s > 0; s >>= 1) {", "for (int s = 0; s > 0; s >>= 1) {"),
                       (_CU, "for (int level = 0;;) {", "for (int level = 0; false;) {")),
                      False),
    # The inverse's split (its outputs wrong): without the (d, e) update;
    # without the (f, g) update, so that g never reaches 0 and all
    # kInvBatches batches run.
    "merge_inv_no_de": (((_CUH, "    update_de_30(d, e, t);\n", ""),), False),
    "merge_inv_no_fg": (((_CUH, "    update_fg_30(f, g, t);\n", ""),), False),
    "merge_inv_var": (((_CUH, _DIVSTEPS, _VAR_DIVSTEPS + _DIVSTEPS),
                       (_CUH, "eta = divsteps_30(eta, ", "eta = divsteps_30_var(eta, ")), True),
    **{f"merge_threads{n}": (((_CU, "constexpr int kMergeThreads = ", f"constexpr int kMergeThreads = {n}; //"),
                              (_CU, "constexpr int kMergeWideThreads = ", f"constexpr int kMergeWideThreads = {n}; //")),
                             True) for n in (128, 256, 512)},
}


def _build_variants(root: Path, csrc: Path, variants: dict) -> dict:
    """Start one nvcc a variant; return name -> (process, library path)."""
    flags = list(_build.NVCC_FLAGS)
    procs = {}
    for name, (patches, _) in variants.items():
        src = root / name
        src.mkdir(parents=True, exist_ok=True)
        applied = 0
        for f in csrc.glob("*.cu*"):
            text = f.read_text()
            for file, old, new in patches:
                if file == f.name and old in text:
                    text = text.replace(old, new)
                    applied += 1
            (src / f.name).write_text(text)
        assert applied or not patches, f"variant {name}: no patch matches the source in {csrc}"
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


def _merge_inputs(dev: torch.device) -> dict:
    """The merge shapes' inputs: name -> (points, live), seeded pool points
    (multiples of the generators, so duplicates occur), the dead lanes at
    seeded places."""
    pool = {2: [hbls.G1_GEN], 4: [hbls.G2_GEN]}
    for _ in range(63):
        pool[2].append(hbls.g1_add(pool[2][-1], hbls.G1_GEN))
        pool[4].append(hbls.g2_add(pool[4][-1], hbls.G2_GEN))
    packed = {2: ops.pack_g1_points(pool[2]), 4: ops.pack_g2_points(pool[4])}
    rng = np.random.default_rng(11)
    out = {}
    for name, c, g, v, n_live in MERGE_SHAPES:
        idx = rng.integers(0, 64, size=(g, v))
        live = np.zeros((g, v), dtype=bool)
        for row in live:
            row[rng.permutation(v)[:n_live]] = True
        out[name] = (torch.from_numpy(np.ascontiguousarray(packed[c][idx])).to(dev), torch.from_numpy(live).to(dev))
    return out


def _time_pairing(lib, name: str, dev: torch.device, shipped: dict) -> dict:
    stream = torch.cuda.current_stream(dev).cuda_stream
    q8, p8 = _lanes(dev)
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
        elif PAIRING_VARIANTS[name][1]:
            exact = exact and all(torch.equal(a, b) for a, b in zip(words, shipped[n]))
        row["miller_ms"][n] = _event_ms(miller, 5)
        row["final_exp_ms"][n] = _event_ms(final_exp, 5)
    if PAIRING_VARIANTS[name][1] and name != "shipped":
        row["exact"] = exact
    return row


def _time_merge(lib, name: str, inputs: dict, shipped: dict) -> dict:
    row = {"ms": {}, "exact": None}
    exact = True
    for shape, (pts, live) in inputs.items():
        dev = pts.device
        stream = torch.cuda.current_stream(dev).cuda_stream
        g, v, c = pts.shape[:3]
        out = torch.empty((g, c, 12), dtype=torch.int32, device=dev)
        inf = torch.empty((g,), dtype=torch.bool, device=dev)

        def merge():
            assert lib.bls_merge(pts.data_ptr(), live.data_ptr(), g, v, c, 0, out.data_ptr(), inf.data_ptr(),
                                 stream) == 0

        merge()
        torch.cuda.synchronize()
        words = (out.cpu(), inf.cpu())
        if name == "shipped":
            shipped[shape] = words
        elif MERGE_VARIANTS[name][1]:
            exact = exact and all(torch.equal(a, b) for a, b in zip(words, shipped[shape]))
        row["ms"][shape] = _event_ms(merge, 10)
    if MERGE_VARIANTS[name][1] and name != "shipped":
        row["exact"] = exact
    return row


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--kernels", choices=("pairing", "merge", "all"), default="all")
    parser.add_argument("--csrc", default=str(_build.CSRC), help="the kernel sources to patch")
    parser.add_argument("--variants", help="only these variants (comma-separated names)")
    parser.add_argument("--json", help="also write the result to this file")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("bls_variants: no CUDA device; this script runs only on the card")
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(gpu, flush=True)
    families = {"pairing": PAIRING_VARIANTS, "merge": MERGE_VARIANTS}
    if args.kernels != "all":
        families = {args.kernels: families[args.kernels]}
    named = {}  # "shipped" is in both tables, with no patch
    for table in families.values():
        named.update(table)
    if args.variants:
        named = {name: named[name] for name in args.variants.split(",")}
    procs = _build_variants(_build.BUILD_DIR.parent / "bls_variants", Path(args.csrc), named)
    libs, ptxas = {}, {}
    for name, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed for variant {name}:\n{log[-3000:]}")
        libs[name] = _load(lib)
        ptxas[name] = [line.strip() for line in log.splitlines()
                       if "registers" in line or "stack frame" in line or "Compiling entry" in line]
    dev = torch.device("cuda")
    out = {"gpu": gpu, "csrc": args.csrc, "lanes": list(LANES), "merge_shapes": [s[0] for s in MERGE_SHAPES],
           "ptxas": ptxas, "variants": {}, "merge_variants": {}}
    shipped_pairing, shipped_merge = {}, {}
    merge_inputs = _merge_inputs(dev) if "merge" in families else {}
    for name, lib in libs.items():
        if "pairing" in families and name in PAIRING_VARIANTS:
            row = _time_pairing(lib, name, dev, shipped_pairing)
            out["variants"][name] = row
            print(f"{name}: miller {row['miller_ms']}, final_exp {row['final_exp_ms']}, exact {row['exact']}",
                  flush=True)
        if "merge" in families and name in MERGE_VARIANTS:
            row = _time_merge(lib, name, merge_inputs, shipped_merge)
            out["merge_variants"][name] = row
            print(f"{name}: merge {row['ms']}, exact {row['exact']}", flush=True)
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)), exist_ok=True)
        with open(args.json, "w") as fh:
            json.dump(out, fh, indent=1)
    print(json.dumps(out), flush=True)
    bad = [name for table in ("variants", "merge_variants") for name, row in out[table].items()
           if row["exact"] is False]
    return 1 if bad else 0


if __name__ == "__main__":
    raise SystemExit(main())
