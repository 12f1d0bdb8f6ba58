"""Time the parts of the ``k1*G + k2*Q`` kernel on the card: the
measurements behind the design of ``csrc/secp256k1_ecmul2.cu``.

    python3 -m go_ibft_tpu_torch.bench.ecmul2_variants [--csrc DIR] [--json PATH]

Builds one probe library (``nvcc``, the kernel's source included whole, into
``build/ecmul2_variants/``) whose kernels run one operation of the kernel in
a dependent chain, ``REPS`` times, and read the SM's clock (``clock64``)
around the chain: one warp of 8 lanes of 4 threads (the kernel's block of
one role), or 32 lanes of one thread each for the one-thread forms.  A
probe's number is cycles an operation, the median over its lanes' groups.

* ``fp_mul`` / ``fp_sqr`` / ``fp_add`` / ``fp_sub``: the field operations,
  one thread;
* ``step4_sqr`` / ``step4_mul``: one step of a group, four products (one a
  thread) and the shuffles that give every thread all four;
* ``quad_double``, ``quad_add``, ``quad_add_affine``: the point
  operations as the kernel runs them;
* ``split_mul``: the other way to spread a product over a group
  (``quad_mul1``), one product at a time, thread t taking words 2t and
  2t + 1 of one operand (16 of the 64 partial products), the four partial
  sums gathered by shuffles and added: checked against ``fp_mul``;
* ``sqr_wide``, ``mul_wide``, ``fp_reduce``: the parts of a product alone
  (the 512-bit square or product; the reduction mod P);
* dropped candidates, the products checked against ``fp_mul`` /
  ``fp_sqr`` on edge operands: ``mul_lookahead`` and ``reduce_lookahead``
  (a reduction whose carries resolve at once from generate and propagate
  bits rather than word after word), ``mulcol_reduce2`` /
  ``sqrcol_reduce2`` and ``reduce2`` (one on 64-bit word sums with serial
  carry passes), ``mul16_reduce2`` (the product by 16-bit halves of one
  operand, all multiply-adds), ``mulhl`` / ``sqrhl`` (each partial
  product as two 32-bit multiplies in place of one 64-bit one),
  ``step4_sqr_smem`` (``step4_sqr`` with the results exchanged through
  shared memory in place of shuffles).

Prints the card's identity, then one JSON line.  Needs one card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import statistics
import subprocess
from pathlib import Path

import torch

from .. import _build

REPS = 256
# name -> (probe op, threads a lane)
PROBES = {
    "fp_mul": (0, 1),
    "fp_sqr": (1, 1),
    "fp_add": (2, 1),
    "fp_sub": (3, 1),
    "step4_sqr": (4, 4),
    "step4_mul": (5, 4),
    "quad_double": (6, 4),
    "quad_add": (7, 4),
    "quad_add_affine": (8, 4),
    "split_mul": (9, 4),
    "mul16_reduce2": (10, 1),
    "mulcol_reduce2": (11, 1),
    "sqrcol_reduce2": (12, 1),
    "mul_lookahead": (13, 1),
    "reduce_lookahead": (21, 1),
    "mulhl": (22, 1),
    "sqrhl": (14, 1),
    "step4_sqr_smem": (15, 4),
    "sqr_wide": (16, 1),
    "fp_reduce": (17, 1),
    "reduce2": (18, 1),
    "mul_wide": (19, 1),
}

PROBE_SOURCE = r"""
#include "secp256k1_ecmul2.cu"

namespace {

using secp::U256;
using secp::Jac;

// The carries into the words of a sum whose words generate a carry (bits
// of g) or pass one on (p: the word is all ones), as bits of one integer:
// bit k is the carry into word k.  g and p share no bit.
__device__ __forceinline__ uint32_t carries_in(uint32_t g, uint32_t p) { return ((g << 1) + p) ^ p; }

// Candidate reduction: t mod P as fp_reduce computes it but with a shorter
// dependency chain: the fold by 2^256 = 2^32 + 977 as eight independent
// 64-bit word sums, their carries resolved at once (carries_in) rather
// than word after word, the top folded once more, and the canonical step
// a test of the top words.
__device__ __forceinline__ U256 reduce_lookahead(const uint32_t t[16]) {
  uint32_t w[8], hi[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    uint64_t s = static_cast<uint64_t>(t[8 + k]) * 977u + t[k];  // L + 977 H
    if (k > 0) {
      s += t[7 + k];  // + 2^32 H
    }
    if (k == 0) {
      s += static_cast<uint64_t>(t[15]) * 977u;  // 2^32 H's top word, at 2^256
    }
    if (k == 1) {
      s += t[15];
    }
    w[k] = static_cast<uint32_t>(s);
    hi[k] = static_cast<uint32_t>(s >> 32);  // below 2^11
  }
  uint32_t g = 0, p = 0;
#pragma unroll
  for (int k = 1; k < 8; ++k) {
    const uint32_t u = w[k] + hi[k - 1];
    g |= static_cast<uint32_t>(u < w[k]) << k;
    w[k] = u;
  }
#pragma unroll
  for (int k = 1; k < 8; ++k) {
    p |= static_cast<uint32_t>(w[k] == 0xFFFFFFFFu) << k;
  }
  uint32_t cin = carries_in(g, p);
#pragma unroll
  for (int k = 1; k < 8; ++k) {
    w[k] += (cin >> k) & 1u;
  }
  const uint32_t top = hi[7] + ((cin >> 8) & 1u);  // the value is w + top 2^256
  const uint64_t s0 = static_cast<uint64_t>(w[0]) + static_cast<uint64_t>(top) * 977u;
  w[0] = static_cast<uint32_t>(s0);
  const uint64_t s1 = static_cast<uint64_t>(w[1]) + top + (s0 >> 32);
  w[1] = static_cast<uint32_t>(s1);
  p = 0;
#pragma unroll
  for (int k = 2; k < 8; ++k) {
    p |= static_cast<uint32_t>(w[k] == 0xFFFFFFFFu) << k;
  }
  cin = carries_in(static_cast<uint32_t>(s1 >> 32) << 1, p);
#pragma unroll
  for (int k = 2; k < 8; ++k) {
    w[k] += (cin >> k) & 1u;
  }
  // Past 2^256: the rest is below 2^45; + 2^32 + 977 stays in two words.
  const uint32_t wrap = (cin >> 8) & 1u;
  const uint64_t f0 = static_cast<uint64_t>(w[0]) + (wrap ? 977u : 0u);
  w[0] = static_cast<uint32_t>(f0);
  w[1] += static_cast<uint32_t>(f0 >> 32) + wrap;
  // >= P = 2^256 - 2^32 - 977: the top six words all ones and the low two
  // at least 2^64 - 2^32 - 977; then r - P = r + 2^32 + 977 - 2^256 fits
  // in the low two words.
  bool high = true;
#pragma unroll
  for (int k = 2; k < 8; ++k) {
    high = high && w[k] == 0xFFFFFFFFu;
  }
  const uint64_t low = (static_cast<uint64_t>(w[1]) << 32) | w[0];
  const bool ge = high && low >= 0xFFFFFFFEFFFFFC2Full;
  const uint64_t sub = low + 0x1000003D1ull;
  U256 r;
  r.w[0] = ge ? static_cast<uint32_t>(sub) : w[0];
  r.w[1] = ge ? static_cast<uint32_t>(sub >> 32) : w[1];
#pragma unroll
  for (int k = 2; k < 8; ++k) {
    r.w[k] = ge ? 0u : w[k];
  }
  return r;
}

// Candidate product: the 512-bit product by 16-bit halves of b, 128
// multiply-adds into 64-bit column sums at 16-bit steps (no separate adds),
// then one carry pass.
__device__ __forceinline__ void mul_wide16(uint32_t t[16], const U256& a, const U256& b) {
  uint64_t col[30];
#pragma unroll
  for (int k = 0; k < 30; ++k) {
    col[k] = 0;
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const uint32_t lo = b.w[j] & 0xFFFFu, hi = b.w[j] >> 16;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      col[2 * (i + j)] += static_cast<uint64_t>(a.w[i]) * lo;
      col[2 * (i + j) + 1] += static_cast<uint64_t>(a.w[i]) * hi;
    }
  }
  uint64_t c = 0;
#pragma unroll
  for (int m = 0; m < 16; ++m) {
    uint64_t s = 0;
    if (m < 15) {
      s = col[2 * m] + ((col[2 * m + 1] & 0xFFFFu) << 16);
    }
    if (m > 0) {
      s += col[2 * m - 1] >> 16;
    }
    c += s;
    t[m] = static_cast<uint32_t>(c);
    c >>= 32;
  }
}

// Candidate reduction: t mod P by 2^256 = 2^32 + 977 with 64-bit word sums
// (no carry flag), one carry pass, the top folded once more, and the
// canonical step as a test of the top words.
__device__ __forceinline__ U256 reduce2(const uint32_t t[16]) {
  uint64_t s[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    s[k] = static_cast<uint64_t>(t[8 + k]) * 977u + t[k] + (k ? t[7 + k] : 0u);
  }
  s[0] += static_cast<uint64_t>(t[15]) * 977u;
  s[1] += t[15];
  U256 r;
  uint64_t c = 0;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    c += s[k];
    r.w[k] = static_cast<uint32_t>(c);
    c >>= 32;
  }
  const uint64_t top = c;
  c = top * 977u + r.w[0];
  r.w[0] = static_cast<uint32_t>(c);
  c = (c >> 32) + r.w[1] + top;
  r.w[1] = static_cast<uint32_t>(c);
  c >>= 32;
#pragma unroll
  for (int k = 2; k < 8; ++k) {
    c += r.w[k];
    r.w[k] = static_cast<uint32_t>(c);
    c >>= 32;
  }
  const uint32_t wrap = static_cast<uint32_t>(c);  // the sum passed 2^256: + 2^32 + 977
  c = static_cast<uint64_t>(r.w[0]) + (wrap ? 977u : 0u);
  r.w[0] = static_cast<uint32_t>(c);
  r.w[1] += static_cast<uint32_t>(c >> 32) + wrap;
  bool high = true;
#pragma unroll
  for (int k = 2; k < 8; ++k) {
    high = high && r.w[k] == 0xFFFFFFFFu;
  }
  const uint64_t low = (static_cast<uint64_t>(r.w[1]) << 32) | r.w[0];
  const bool ge = high && low >= 0xFFFFFFFEFFFFFC2Full;
  const uint64_t sub = low + 0x1000003D1ull;  // r - P where r >= P
  r.w[0] = ge ? static_cast<uint32_t>(sub) : r.w[0];
  r.w[1] = ge ? static_cast<uint32_t>(sub >> 32) : r.w[1];
#pragma unroll
  for (int k = 2; k < 8; ++k) {
    r.w[k] = ge ? 0u : r.w[k];
  }
  return r;
}

// Candidates: the column sums of fp_mul / fp_sqr with each partial product
// as two 32-bit multiplies (mul.lo, mul.hi) in place of one 64-bit one.
__device__ __forceinline__ void mul_wide_hl(uint32_t t[17], const U256& a, const U256& b) {
  uint64_t col[16];
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    col[k] = 0;
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      col[i + j] += secp::mul_lo32(a.w[i], b.w[j]);
      col[i + j + 1] += secp::mul_hi32(a.w[i], b.w[j]);
    }
  }
  uint64_t c = 0;
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    c += col[k];
    t[k] = static_cast<uint32_t>(c);
    c >>= 32;
  }
  t[16] = static_cast<uint32_t>(c);
}

__device__ __forceinline__ void sqr_wide_hl(uint32_t t[17], const U256& a) {
  uint64_t col[16];
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    col[k] = 0;
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int j = i + 1; j < 8; ++j) {
      col[i + j] += secp::mul_lo32(a.w[i], a.w[j]);
      col[i + j + 1] += secp::mul_hi32(a.w[i], a.w[j]);
    }
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    col[2 * i] = (col[2 * i] << 1) + secp::mul_lo32(a.w[i], a.w[i]);
    col[2 * i + 1] = (col[2 * i + 1] << 1) + secp::mul_hi32(a.w[i], a.w[i]);
  }
  uint64_t c = 0;
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    c += col[k];
    t[k] = static_cast<uint32_t>(c);
    c >>= 32;
  }
  t[16] = static_cast<uint32_t>(c);
}

__device__ __noinline__ U256 mulhl_reduce(U256 a, U256 b) {
  uint32_t t[17];
  mul_wide_hl(t, a, b);
  return secp::fp_reduce(t);
}

__device__ __noinline__ U256 sqrhl_reduce(U256 a) {
  uint32_t t[17];
  sqr_wide_hl(t, a);
  return secp::fp_reduce(t);
}

__device__ __noinline__ U256 mul16_reduce2(U256 a, U256 b) {
  uint32_t t[16];
  mul_wide16(t, a, b);
  return reduce2(t);
}

__device__ __noinline__ U256 mulcol_reduce2(U256 a, U256 b) {
  uint32_t t[17];
  secp::mul_wide(t, a, b);
  return reduce2(t);
}

__device__ __noinline__ U256 sqrcol_reduce2(U256 a) {
  uint32_t t[17];
  secp::sqr_wide(t, a);
  return reduce2(t);
}

// The dropped candidate product or square of probe `op`.
__device__ U256 candidate(int op, const U256& x, const U256& y) {
  uint32_t t[17];
  switch (op) {
    case 10: return mul16_reduce2(x, y);
    case 11: return mulcol_reduce2(x, y);
    case 12: return sqrcol_reduce2(x);
    case 13: secp::mul_wide(t, x, y); return reduce_lookahead(t);
    case 14: return sqrhl_reduce(x);
    default: return mulhl_reduce(x, y);
  }
}

__device__ U256 seed_value(unsigned lane, uint32_t salt) {
  U256 r;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    r.w[i] = (lane + 1) * 0x9E3779B9u ^ (salt + 0x85EBCA6Bu * (i + 1));
  }
  r.w[7] &= 0x7FFFFFFFu;
  return r;
}

__global__ void __launch_bounds__(32) probe(int op, int reps, long long* cycles, uint32_t* sink,
                                           int* mismatches) {
  const secp::Quad g = secp::Quad::of_thread(threadIdx.x);
  const unsigned lane = op >= 4 ? threadIdx.x / 4 : threadIdx.x;
  U256 a = seed_value(lane, 1), b = seed_value(lane, 2), c = seed_value(lane, 3), d = seed_value(lane, 4);
  Jac p{a, b, c};
  const Jac q{c, d, b};
  __syncwarp();
  const long long t0 = clock64();
#pragma unroll 1
  for (int r = 0; r < reps; ++r) {
    switch (op) {
      case 0: a = secp::fp_mul(a, b); break;
      case 1: a = secp::fp_sqr(a); break;
      case 2: a = secp::fp_add(a, b); break;
      case 3: a = secp::fp_sub(a, b); break;
      case 4: {
        U256 o[4];
        g.step(o, [&](int t) { return secp::fp_sqr(secp::pick(t, a, b, c, d)); });
        a = o[1]; b = o[2]; c = o[3]; d = o[0];
        break;
      }
      case 5: {
        U256 o[4];
        g.step(o, [&](int t) { return secp::fp_mul(secp::pick(t, a, b, c, d), secp::pick(t, b, c, d, a)); });
        a = o[1]; b = o[2]; c = o[3]; d = o[0];
        break;
      }
      case 6: p = secp::quad_double(g, p); break;
      case 7: p = secp::quad_add(g, p, q); break;
      case 8: p = secp::quad_add_affine(g, p, c, d); break;
      case 10: a = mul16_reduce2(a, b); break;
      case 11: a = mulcol_reduce2(a, b); break;
      case 12: a = sqrcol_reduce2(a); break;
      case 13: {  // the product with the candidate reduction
        uint32_t t[17];
        secp::mul_wide(t, a, b);
        a = reduce_lookahead(t);
        break;
      }
      case 14: a = sqrhl_reduce(a); break;
      case 16: {  // the squaring's 512-bit product alone (its low half carried on)
        uint32_t t[17];
        secp::sqr_wide(t, a);
        a = secp::from_table(t + 4);
        break;
      }
      case 17: {  // the shipped reduction alone
        uint32_t t[16];
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          t[i] = a.w[i];
          t[8 + i] = a.w[7 - i] ^ b.w[i];
        }
        a = secp::fp_reduce(t);
        break;
      }
      case 18: {  // the candidate reduction alone
        uint32_t t[16];
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          t[i] = a.w[i];
          t[8 + i] = a.w[7 - i] ^ b.w[i];
        }
        a = reduce2(t);
        break;
      }
      case 19: {  // the product's 512-bit product alone
        uint32_t t[17];
        secp::mul_wide(t, a, b);
        a = secp::from_table(t + 4);
        break;
      }
      case 21: {  // the candidate reduction alone
        uint32_t t[16];
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          t[i] = a.w[i];
          t[8 + i] = a.w[7 - i] ^ b.w[i];
        }
        a = reduce_lookahead(t);
        break;
      }
      case 22: a = mulhl_reduce(a, b); break;
      case 15: {  // a step of four squares whose results go through shared memory
        __shared__ U256 xch[8][4];
        const U256 mine = secp::fp_sqr(secp::pick(g.rank, a, b, c, d));
        g.sync();
        xch[lane][g.rank] = mine;
        g.sync();
        a = xch[lane][1]; b = xch[lane][2]; c = xch[lane][3]; d = xch[lane][0];
        break;
      }
    }
  }
  const long long t1 = clock64();
  cycles[threadIdx.x] = t1 - t0;
  sink[threadIdx.x] = a.w[0] ^ b.w[1] ^ p.x.w[0] ^ p.y.w[1] ^ p.z.w[2];
  // The candidate products against fp_mul / fp_sqr on this lane's values,
  // the edges among them: all-ones words, P - 1, N - 1, their squares.
  int bad = 0;
  if ((op >= 10 && op <= 14) || op == 22) {
    U256 e[5] = {seed_value(lane, 5), secp::from_table(secp::kP), secp::from_table(secp::kN), a, b};
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      e[0].w[i] = 0xFFFFFFFFu;
    }
    e[1].w[0] -= 1;
    e[2].w[0] -= 1;
    const bool square = op == 12 || op == 14;
#pragma unroll 1
    for (int i = 0; i < 5; ++i) {
#pragma unroll 1
      for (int j = 0; j < 5; ++j) {
        const U256 sq = secp::fp_mul(e[i], e[i]);
#pragma unroll 1
        for (int k = 0; k < 2; ++k) {
          const U256 x = k ? sq : e[i];
          const U256 want = square ? secp::fp_sqr(x) : secp::fp_mul(x, e[j]);
          bad += !secp::equal(want, candidate(op, x, e[j]));
        }
      }
    }
  }
  mismatches[threadIdx.x] = bad;
}

// split_mul in a dependent chain, then fp_mul on the same values to check it.
__global__ void __launch_bounds__(32) probe_split(int reps, long long* cycles, uint32_t* sink,
                                                  int* mismatches) {
  const secp::Quad g = secp::Quad::of_thread(threadIdx.x);
  U256 a = seed_value(threadIdx.x / 4, 1);
  const U256 b = seed_value(threadIdx.x / 4, 2);
  U256 check = a;
  __syncwarp();
  const long long t0 = clock64();
#pragma unroll 1
  for (int r = 0; r < reps; ++r) {
    a = secp::quad_mul1(g, a, b);
  }
  const long long t1 = clock64();
#pragma unroll 1
  for (int r = 0; r < reps; ++r) {
    check = secp::fp_mul(check, b);
  }
  cycles[threadIdx.x] = t1 - t0;
  sink[threadIdx.x] = a.w[0];
  mismatches[threadIdx.x] = !secp::equal(a, check);
}

}  // namespace

extern "C" int ecmul2_probe(int op, int reps, void* cycles, void* sink, void* mismatches) {
  if (op == 9) {
    probe_split<<<1, 32>>>(reps, static_cast<long long*>(cycles), static_cast<uint32_t*>(sink),
                           static_cast<int*>(mismatches));
  } else {
    probe<<<1, 32>>>(op, reps, static_cast<long long*>(cycles), static_cast<uint32_t*>(sink),
                     static_cast<int*>(mismatches));
  }
  return static_cast<int>(cudaDeviceSynchronize());
}
"""


def build_probe(csrc: Path, root: Path) -> tuple:
    """Compile the probe library against ``csrc``; returns (path, ptxas lines)."""
    root.mkdir(parents=True, exist_ok=True)
    src = root / "ecmul2_probe.cu"
    src.write_text(PROBE_SOURCE)
    lib = root / "ecmul2_probe.so"
    flags = list(_build.NVCC_FLAGS)
    at = flags.index(str(_build.CSRC))
    cmd = [_build.find_nvcc(), *flags[:at], str(csrc), *flags[at + 1:], "-o", str(lib), str(src)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise SystemExit(f"nvcc failed for the probe:\n{(proc.stdout + proc.stderr)[-3000:]}")
    log = proc.stdout + proc.stderr
    return lib, [line.strip() for line in log.splitlines() if "registers" in line or "stack frame" in line]


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--csrc", default=str(_build.CSRC), help="the kernel sources to include")
    parser.add_argument("--json", help="also write the result to this file")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("ecmul2_variants: no CUDA device; this script runs only on the card")
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(gpu, flush=True)
    lib, ptxas = build_probe(Path(args.csrc), _build.BUILD_DIR.parent / "ecmul2_variants")
    fn = ctypes.CDLL(str(lib)).ecmul2_probe
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    dev = torch.device("cuda")
    cycles = torch.zeros(32, dtype=torch.int64, device=dev)
    sink = torch.zeros(32, dtype=torch.int32, device=dev)
    bad = torch.zeros(32, dtype=torch.int32, device=dev)
    out = {"gpu": gpu, "csrc": args.csrc, "reps": REPS, "ptxas": ptxas, "cycles": {}, "mismatches": {}}
    for name, (op, group) in PROBES.items():
        for _ in range(2):  # the first launch loads the module and warms the caches
            rc = fn(op, REPS, cycles.data_ptr(), sink.data_ptr(), bad.data_ptr())
            if rc != 0:
                raise SystemExit(f"probe {name}: cudaError {rc}")
        per_group = cycles.cpu().tolist()[::group]
        out["cycles"][name] = statistics.median(per_group) / REPS
        out["mismatches"][name] = int(bad.sum())
        print(f"{name}: {out['cycles'][name]:.1f} cycles an operation", flush=True)
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)), exist_ok=True)
        with open(args.json, "w") as fh:
            json.dump(out, fh, indent=1)
    print(json.dumps(out), flush=True)
    return 1 if any(out["mismatches"].values()) else 0


if __name__ == "__main__":
    raise SystemExit(main())
