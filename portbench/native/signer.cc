// The benchmark's host signer: a frozen copy of the port's native runtime
// source, go_ibft_tpu_torch/native/src/ibft_native.cc, byte for byte below
// this comment.  The benchmark signs its traffic with it (keccak-256, the
// deterministic ECDSA signature and the public key of a seed's key); it is
// kept here so that a later change to the program cannot change the traffic.
// Plain C ABI, loaded with ctypes by portbench/harness/signer.py, which
// builds it with: g++ -O2 -shared -fPIC -o libportbench_signer.so signer.cc
//
// The original's header follows.
//
// Native runtime components for go_ibft_tpu.
//
// 1. keccak256 — fast host hashing for the wire layer (payload_no_sig
//    digests, proposal hashes, addresses).  The Python fallback is ~100x
//    slower; message ingress hashes on every add_message.
// 2. Sequential secp256k1 ECDSA verify/recover — the per-message host
//    verification path.  This is the honest stand-in for the reference
//    embedder's Go crypto/ecdsa loop (go-ibft calls Verifier once per
//    message, messages/messages.go:183-198): it is the baseline
//    DENOMINATOR for BASELINE.md's >=30x target, and the engine's
//    fallback verifier when no accelerator is attached.
//
// Plain C ABI; loaded from Python via ctypes (go_ibft_tpu/native/__init__.py).
// Build: g++ -O2 -shared -fPIC -o libibft_native.so ibft_native.cc

#include <cstdint>
#include <cstring>
#include <cstddef>

namespace {

// ---------------------------------------------------------------------------
// Keccak-256 (Ethereum flavor: multi-rate padding 0x01 .. 0x80)
// ---------------------------------------------------------------------------

constexpr uint64_t kRC[24] = {
    0x0000000000000001ULL, 0x0000000000008082ULL, 0x800000000000808AULL,
    0x8000000080008000ULL, 0x000000000000808BULL, 0x0000000080000001ULL,
    0x8000000080008081ULL, 0x8000000000008009ULL, 0x000000000000008AULL,
    0x0000000000000088ULL, 0x0000000080008009ULL, 0x000000008000000AULL,
    0x000000008000808BULL, 0x800000000000008BULL, 0x8000000000008089ULL,
    0x8000000000008003ULL, 0x8000000000008002ULL, 0x8000000000000080ULL,
    0x000000000000800AULL, 0x800000008000000AULL, 0x8000000080008081ULL,
    0x8000000000008080ULL, 0x0000000080000001ULL, 0x8000000080008008ULL,
};

constexpr int kRot[5][5] = {
    {0, 36, 3, 41, 18},
    {1, 44, 10, 45, 2},
    {62, 6, 43, 15, 61},
    {28, 55, 25, 21, 56},
    {27, 20, 39, 8, 14},
};

inline uint64_t rotl64(uint64_t v, int n) {
  n &= 63;
  if (n == 0) return v;
  return (v << n) | (v >> (64 - n));
}

void keccak_f(uint64_t a[25]) {
  for (int round = 0; round < 24; ++round) {
    uint64_t c[5], d[5];
    for (int x = 0; x < 5; ++x)
      c[x] = a[x] ^ a[x + 5] ^ a[x + 10] ^ a[x + 15] ^ a[x + 20];
    for (int x = 0; x < 5; ++x)
      d[x] = c[(x + 4) % 5] ^ rotl64(c[(x + 1) % 5], 1);
    for (int y = 0; y < 5; ++y)
      for (int x = 0; x < 5; ++x) a[x + 5 * y] ^= d[x];
    uint64_t b[25];
    for (int x = 0; x < 5; ++x)
      for (int y = 0; y < 5; ++y)
        b[y + 5 * ((2 * x + 3 * y) % 5)] = rotl64(a[x + 5 * y], kRot[x][y]);
    for (int y = 0; y < 5; ++y)
      for (int x = 0; x < 5; ++x)
        a[x + 5 * y] = b[x + 5 * y] ^ (~b[(x + 1) % 5 + 5 * y] & b[(x + 2) % 5 + 5 * y]);
    a[0] ^= kRC[round];
  }
}

void keccak256(const uint8_t* data, size_t len, uint8_t out[32]) {
  constexpr size_t kRate = 136;
  uint64_t state[25] = {0};
  // absorb full blocks
  while (len >= kRate) {
    for (size_t i = 0; i < kRate / 8; ++i) {
      uint64_t lane;
      std::memcpy(&lane, data + 8 * i, 8);
      state[i] ^= lane;  // little-endian host assumed (x86/arm64)
    }
    keccak_f(state);
    data += kRate;
    len -= kRate;
  }
  // final padded block
  uint8_t block[kRate] = {0};
  std::memcpy(block, data, len);
  block[len] ^= 0x01;
  block[kRate - 1] ^= 0x80;
  for (size_t i = 0; i < kRate / 8; ++i) {
    uint64_t lane;
    std::memcpy(&lane, block + 8 * i, 8);
    state[i] ^= lane;
  }
  keccak_f(state);
  std::memcpy(out, state, 32);
}

// ---------------------------------------------------------------------------
// 256-bit arithmetic (4 x 64-bit little-endian words, __int128 carries)
// ---------------------------------------------------------------------------

struct U256 {
  uint64_t w[4];
};

const U256 kZero = {{0, 0, 0, 0}};

// secp256k1 field prime p = 2^256 - 2^32 - 977 and group order n.
const U256 kP = {{0xFFFFFFFEFFFFFC2FULL, 0xFFFFFFFFFFFFFFFFULL,
                  0xFFFFFFFFFFFFFFFFULL, 0xFFFFFFFFFFFFFFFFULL}};
const U256 kN = {{0xBFD25E8CD0364141ULL, 0xBAAEDCE6AF48A03BULL,
                  0xFFFFFFFFFFFFFFFEULL, 0xFFFFFFFFFFFFFFFFULL}};
// 2^256 mod p = 2^32 + 977; 2^256 mod n (129 bits).
const U256 kCP = {{0x00000001000003D1ULL, 0, 0, 0}};
const U256 kCN = {{0x402DA1732FC9BEBFULL, 0x4551231950B75FC4ULL, 1, 0}};

const U256 kGx = {{0x59F2815B16F81798ULL, 0x029BFCDB2DCE28D9ULL,
                   0x55A06295CE870B07ULL, 0x79BE667EF9DCBBACULL}};
const U256 kGy = {{0x9C47D08FFB10D4B8ULL, 0xFD17B448A6855419ULL,
                   0x5DA4FBFC0E1108A8ULL, 0x483ADA7726A3C465ULL}};

inline int cmp(const U256& a, const U256& b) {
  for (int i = 3; i >= 0; --i) {
    if (a.w[i] != b.w[i]) return a.w[i] < b.w[i] ? -1 : 1;
  }
  return 0;
}

inline bool is_zero(const U256& a) {
  return (a.w[0] | a.w[1] | a.w[2] | a.w[3]) == 0;
}

// returns carry
inline uint64_t add_u(const U256& a, const U256& b, U256* out) {
  unsigned __int128 carry = 0;
  for (int i = 0; i < 4; ++i) {
    carry += (unsigned __int128)a.w[i] + b.w[i];
    out->w[i] = (uint64_t)carry;
    carry >>= 64;
  }
  return (uint64_t)carry;
}

// returns borrow
inline uint64_t sub_u(const U256& a, const U256& b, U256* out) {
  unsigned __int128 borrow = 0;
  for (int i = 0; i < 4; ++i) {
    unsigned __int128 d = (unsigned __int128)a.w[i] - b.w[i] - (uint64_t)borrow;
    out->w[i] = (uint64_t)d;
    borrow = (d >> 64) ? 1 : 0;
  }
  return (uint64_t)borrow;
}

struct U512 {
  uint64_t w[8];
};

void mul_full(const U256& a, const U256& b, U512* out) {
  std::memset(out->w, 0, sizeof(out->w));
  for (int i = 0; i < 4; ++i) {
    unsigned __int128 carry = 0;
    for (int j = 0; j < 4; ++j) {
      carry += (unsigned __int128)a.w[i] * b.w[j] + out->w[i + j];
      out->w[i + j] = (uint64_t)carry;
      carry >>= 64;
    }
    out->w[i + 4] += (uint64_t)carry;
  }
}

// 5-word product of a 4-word value and kCP (fits: kCP < 2^33).
void fold_mul_cp(const uint64_t hi[4], uint64_t out[5]) {
  unsigned __int128 carry = 0;
  for (int i = 0; i < 4; ++i) {
    carry += (unsigned __int128)hi[i] * kCP.w[0];
    out[i] = (uint64_t)carry;
    carry >>= 64;
  }
  out[4] = (uint64_t)carry;
}

// v mod p for a 512-bit v: two pseudo-Mersenne folds + conditional subtracts.
void reduce_p(const U512& v, U256* out) {
  // fold 1: lo + hi * kCP  (<= 2^256 + 2^289)
  uint64_t prod[5];
  fold_mul_cp(v.w + 4, prod);
  U256 lo = {{v.w[0], v.w[1], v.w[2], v.w[3]}};
  U256 p1 = {{prod[0], prod[1], prod[2], prod[3]}};
  U256 acc;
  uint64_t hi2 = prod[4] + add_u(lo, p1, &acc);  // value = acc + hi2 * 2^256
  // fold 2: hi2 <= 2^34ish
  unsigned __int128 c = (unsigned __int128)hi2 * kCP.w[0];
  unsigned __int128 t = (unsigned __int128)acc.w[0] + (uint64_t)c;
  acc.w[0] = (uint64_t)t;
  unsigned __int128 carry = (t >> 64) + (uint64_t)(c >> 64);
  for (int i = 1; i < 4 && carry; ++i) {
    t = (unsigned __int128)acc.w[i] + (uint64_t)carry;
    acc.w[i] = (uint64_t)t;
    carry = t >> 64;
  }
  if (carry) {  // one more tiny fold
    U256 cp = kCP;
    add_u(acc, cp, &acc);
  }
  while (cmp(acc, kP) >= 0) sub_u(acc, kP, &acc);
  *out = acc;
}

// 7-word product of a 4-word value and kCN (kCN < 2^129 -> 3 words).
void fold_mul_cn(const uint64_t hi[4], uint64_t out[7]) {
  std::memset(out, 0, 7 * sizeof(uint64_t));
  for (int i = 0; i < 4; ++i) {
    unsigned __int128 carry = 0;
    for (int j = 0; j < 3; ++j) {
      carry += (unsigned __int128)hi[i] * kCN.w[j] + out[i + j];
      out[i + j] = (uint64_t)carry;
      carry >>= 64;
    }
    out[i + 3] += (uint64_t)carry;
  }
}

void reduce_n(const U512& v, U256* out) {
  // fold 1: 512 -> ~385 bits
  uint64_t prod[7];
  fold_mul_cn(v.w + 4, prod);
  U512 t1 = {{v.w[0], v.w[1], v.w[2], v.w[3], 0, 0, 0, 0}};
  unsigned __int128 carry = 0;
  for (int i = 0; i < 7; ++i) {
    carry += (unsigned __int128)t1.w[i] + prod[i];
    t1.w[i] = (uint64_t)carry;
    carry >>= 64;
  }
  t1.w[7] = (uint64_t)carry;
  // fold 2: hi is now <= 2^130ish -> product < 2^259
  uint64_t prod2[7];
  fold_mul_cn(t1.w + 4, prod2);
  U512 t2 = {{t1.w[0], t1.w[1], t1.w[2], t1.w[3], 0, 0, 0, 0}};
  carry = 0;
  for (int i = 0; i < 7; ++i) {
    carry += (unsigned __int128)t2.w[i] + prod2[i];
    t2.w[i] = (uint64_t)carry;
    carry >>= 64;
  }
  // fold 3: hi <= small
  uint64_t prod3[7];
  fold_mul_cn(t2.w + 4, prod3);
  U256 acc = {{t2.w[0], t2.w[1], t2.w[2], t2.w[3]}};
  U256 p3 = {{prod3[0], prod3[1], prod3[2], prod3[3]}};
  uint64_t c2 = add_u(acc, p3, &acc);
  if (c2) {
    U256 cn = kCN;
    add_u(acc, cn, &acc);
  }
  while (cmp(acc, kN) >= 0) sub_u(acc, kN, &acc);
  *out = acc;
}

enum Mod { MOD_P, MOD_N };

inline void mulmod(const U256& a, const U256& b, Mod m, U256* out) {
  U512 t;
  mul_full(a, b, &t);
  if (m == MOD_P)
    reduce_p(t, out);
  else
    reduce_n(t, out);
}

inline void addmod(const U256& a, const U256& b, const U256& mod, U256* out) {
  uint64_t carry = add_u(a, b, out);
  if (carry || cmp(*out, mod) >= 0) sub_u(*out, mod, out);
}

inline void submod(const U256& a, const U256& b, const U256& mod, U256* out) {
  if (sub_u(a, b, out)) add_u(*out, mod, out);
}

void powmod(const U256& base, const U256& exp, Mod m, U256* out) {
  U256 acc = {{1, 0, 0, 0}};
  U256 b = base;
  for (int i = 0; i < 256; ++i) {
    int word = i / 64, bit = i % 64;
    if ((exp.w[word] >> bit) & 1) mulmod(acc, b, m, &acc);
    mulmod(b, b, m, &b);
  }
  *out = acc;
}

void invmod(const U256& a, Mod m, U256* out) {
  // Fermat: a^(mod-2)
  U256 e = (m == MOD_P) ? kP : kN;
  U256 two = {{2, 0, 0, 0}};
  sub_u(e, two, &e);
  powmod(a, e, m, out);
}

// ---------------------------------------------------------------------------
// Curve (Jacobian, a = 0)
// ---------------------------------------------------------------------------

struct Jac {
  U256 x, y, z;  // z == 0 => infinity
};

inline bool jac_inf(const Jac& p) { return is_zero(p.z); }

void jac_double(const Jac& p, Jac* out) {
  if (jac_inf(p)) {
    *out = p;
    return;
  }
  U256 a, b, c, d, e, f, t, x3, y3, z3;
  mulmod(p.x, p.x, MOD_P, &a);
  mulmod(p.y, p.y, MOD_P, &b);
  mulmod(b, b, MOD_P, &c);
  addmod(p.x, b, kP, &t);
  mulmod(t, t, MOD_P, &t);
  submod(t, a, kP, &t);
  submod(t, c, kP, &t);
  addmod(t, t, kP, &d);  // D = 2((X+B)^2 - A - C)
  addmod(a, a, kP, &e);
  addmod(e, a, kP, &e);  // E = 3A
  mulmod(e, e, MOD_P, &f);
  submod(f, d, kP, &x3);
  submod(x3, d, kP, &x3);  // X3 = F - 2D
  submod(d, x3, kP, &t);
  mulmod(e, t, MOD_P, &y3);
  U256 c8;
  addmod(c, c, kP, &c8);
  addmod(c8, c8, kP, &c8);
  addmod(c8, c8, kP, &c8);
  submod(y3, c8, kP, &y3);
  mulmod(p.y, p.z, MOD_P, &z3);
  addmod(z3, z3, kP, &z3);
  out->x = x3;
  out->y = y3;
  out->z = z3;
}

void jac_add(const Jac& p, const Jac& q, Jac* out) {
  if (jac_inf(p)) {
    *out = q;
    return;
  }
  if (jac_inf(q)) {
    *out = p;
    return;
  }
  U256 z1s, z2s, u1, u2, s1, s2, t;
  mulmod(p.z, p.z, MOD_P, &z1s);
  mulmod(q.z, q.z, MOD_P, &z2s);
  mulmod(p.x, z2s, MOD_P, &u1);
  mulmod(q.x, z1s, MOD_P, &u2);
  mulmod(z2s, q.z, MOD_P, &t);
  mulmod(p.y, t, MOD_P, &s1);
  mulmod(z1s, p.z, MOD_P, &t);
  mulmod(q.y, t, MOD_P, &s2);
  U256 h, r;
  submod(u2, u1, kP, &h);
  submod(s2, s1, kP, &r);
  if (is_zero(h)) {
    if (is_zero(r)) {
      jac_double(p, out);
      return;
    }
    *out = {kZero, {{1, 0, 0, 0}}, kZero};  // P + (-P) = infinity
    return;
  }
  U256 hs, hc, u1hs, x3, y3, z3;
  mulmod(h, h, MOD_P, &hs);
  mulmod(hs, h, MOD_P, &hc);
  mulmod(u1, hs, MOD_P, &u1hs);
  mulmod(r, r, MOD_P, &x3);
  submod(x3, hc, kP, &x3);
  submod(x3, u1hs, kP, &x3);
  submod(x3, u1hs, kP, &x3);
  submod(u1hs, x3, kP, &t);
  mulmod(r, t, MOD_P, &y3);
  mulmod(s1, hc, MOD_P, &t);
  submod(y3, t, kP, &y3);
  mulmod(p.z, q.z, MOD_P, &z3);
  mulmod(z3, h, MOD_P, &z3);
  out->x = x3;
  out->y = y3;
  out->z = z3;
}

// 4-bit windowed double-scalar multiply: k1*G + k2*Q.
void ecmul2(const U256& k1, const U256& k2, const Jac& q, Jac* out) {
  Jac tg[16], tq[16];
  tg[0] = {kZero, {{1, 0, 0, 0}}, kZero};
  tq[0] = tg[0];
  Jac g = {kGx, kGy, {{1, 0, 0, 0}}};
  tg[1] = g;
  tq[1] = q;
  for (int i = 2; i < 16; ++i) {
    jac_add(tg[i - 1], g, &tg[i]);
    jac_add(tq[i - 1], q, &tq[i]);
  }
  Jac acc = tg[0];
  for (int nib = 63; nib >= 0; --nib) {
    if (nib != 63) {
      jac_double(acc, &acc);
      jac_double(acc, &acc);
      jac_double(acc, &acc);
      jac_double(acc, &acc);
    }
    int word = nib / 16, off = (nib % 16) * 4;
    int d1 = (int)((k1.w[word] >> off) & 0xF);
    int d2 = (int)((k2.w[word] >> off) & 0xF);
    if (d1) jac_add(acc, tg[d1], &acc);
    if (d2) jac_add(acc, tq[d2], &acc);
  }
  *out = acc;
}

void to_affine(const Jac& p, U256* x, U256* y) {
  if (jac_inf(p)) {
    *x = kZero;
    *y = kZero;
    return;
  }
  U256 zi, zi2;
  invmod(p.z, MOD_P, &zi);
  mulmod(zi, zi, MOD_P, &zi2);
  mulmod(p.x, zi2, MOD_P, x);
  mulmod(zi2, zi, MOD_P, &zi2);
  mulmod(p.y, zi2, MOD_P, y);
}

void load_be(const uint8_t* in, U256* out) {
  for (int i = 0; i < 4; ++i) {
    uint64_t w = 0;
    for (int j = 0; j < 8; ++j) w = (w << 8) | in[i * 8 + j];
    out->w[3 - i] = w;
  }
}

void store_be(const U256& in, uint8_t* out) {
  for (int i = 0; i < 4; ++i) {
    uint64_t w = in.w[3 - i];
    for (int j = 7; j >= 0; --j) {
      out[i * 8 + j] = (uint8_t)w;
      w >>= 8;
    }
  }
}

bool on_curve(const U256& x, const U256& y) {
  U256 lhs, rhs, seven = {{7, 0, 0, 0}};
  mulmod(y, y, MOD_P, &lhs);
  mulmod(x, x, MOD_P, &rhs);
  mulmod(rhs, x, MOD_P, &rhs);
  addmod(rhs, seven, kP, &rhs);
  return cmp(lhs, rhs) == 0;
}

bool in_scalar_range(const U256& v) {
  return !is_zero(v) && cmp(v, kN) < 0;
}

bool ecdsa_verify_impl(const U256& qx, const U256& qy, const U256& z,
                       const U256& r, const U256& s) {
  if (!in_scalar_range(r) || !in_scalar_range(s)) return false;
  if (!on_curve(qx, qy)) return false;
  U256 w, u1, u2;
  invmod(s, MOD_N, &w);
  mulmod(z, w, MOD_N, &u1);
  mulmod(r, w, MOD_N, &u2);
  Jac q = {qx, qy, {{1, 0, 0, 0}}}, res;
  ecmul2(u1, u2, q, &res);
  if (jac_inf(res)) return false;
  U256 x, y;
  to_affine(res, &x, &y);
  // x mod n == r  (x < p < 2n: check x == r or x == r + n when r + n < p)
  if (cmp(x, r) == 0) return true;
  U256 rn;
  if (!add_u(r, kN, &rn) && cmp(rn, kP) < 0 && cmp(x, rn) == 0) return true;
  return false;
}

bool ecdsa_recover_impl(const U256& z, const U256& r, const U256& s, int v,
                        U256* qx, U256* qy) {
  if (!in_scalar_range(r) || !in_scalar_range(s)) return false;
  if (v != 0 && v != 1) return false;
  // y^2 = x^3 + 7; y = (x^3+7)^((p+1)/4)
  U256 y2, y, seven = {{7, 0, 0, 0}};
  mulmod(r, r, MOD_P, &y2);
  mulmod(y2, r, MOD_P, &y2);
  addmod(y2, seven, kP, &y2);
  U256 e = kP;  // (p+1)/4: p+1 overflows, but p+1 = p with low bits... compute via shift
  // p + 1 = 2^256 - 2^32 - 976; (p+1)/4 = (p >> 2) + 1 ... derive exactly:
  // p = ...FC2F; p+1 = ...FC30; (p+1)/4 = p/4 rounded: implement as (p+1)>>2
  // with the +1 carried manually (p+1 fits since p < 2^256-1).
  {
    U256 one = {{1, 0, 0, 0}};
    add_u(e, one, &e);  // no carry: p < 2^256 - 1
    // shift right by 2
    for (int i = 0; i < 4; ++i) {
      e.w[i] >>= 2;
      if (i < 3) e.w[i] |= e.w[i + 1] << 62;
    }
  }
  powmod(y2, e, MOD_P, &y);
  U256 chk;
  mulmod(y, y, MOD_P, &chk);
  if (cmp(chk, y2) != 0) return false;
  if ((int)(y.w[0] & 1) != v) submod(kP, y, kP, &y);
  U256 rinv, u1, u2, zneg;
  invmod(r, MOD_N, &rinv);
  submod(kN, z, kN, &zneg);  // -z mod n (z < n)
  mulmod(zneg, rinv, MOD_N, &u1);
  mulmod(s, rinv, MOD_N, &u2);
  Jac rp = {r, y, {{1, 0, 0, 0}}}, res;
  ecmul2(u1, u2, rp, &res);
  if (jac_inf(res)) return false;
  to_affine(res, qx, qy);
  return true;
}

void pubkey_address(const U256& x, const U256& y, uint8_t out[20]) {
  uint8_t buf[64], digest[32];
  store_be(x, buf);
  store_be(y, buf + 32);
  keccak256(buf, 64, digest);
  std::memcpy(out, digest + 12, 20);
}

void digest_to_scalar(const uint8_t digest[32], U256* out) {
  load_be(digest, out);
  if (cmp(*out, kN) >= 0) sub_u(*out, kN, out);
}

// Deterministic ECDSA sign, bit-identical to the Python reference path
// (crypto/ecdsa.py::sign): nonce k = keccak256(d || digest || counter) mod n,
// low-s normalization with the recovery id flipped alongside s.
bool ecdsa_sign_impl(const U256& d, const uint8_t digest[32], U256* r_out,
                     U256* s_out, int* v_out) {
  U256 z;
  digest_to_scalar(digest, &z);
  uint8_t buf[65];
  store_be(d, buf);
  std::memcpy(buf + 32, digest, 32);
  U256 half = kN;  // n >> 1 == n // 2 (n is odd)
  for (int i = 0; i < 4; ++i) {
    half.w[i] >>= 1;
    if (i < 3) half.w[i] |= kN.w[i + 1] << 63;
  }
  // The Python loop is unbounded; 256 nonce retries is unreachable in
  // practice (each retry needs k==0, r==0, or s==0).
  for (int counter = 0; counter < 256; ++counter) {
    buf[64] = (uint8_t)counter;
    uint8_t kd[32];
    keccak256(buf, 65, kd);
    U256 k;
    load_be(kd, &k);
    if (cmp(k, kN) >= 0) sub_u(k, kN, &k);  // k_raw < 2^256 < 2n
    if (is_zero(k)) continue;
    Jac g = {kGx, kGy, {{1, 0, 0, 0}}}, pt;
    ecmul2(k, kZero, g, &pt);
    U256 x, y;
    to_affine(pt, &x, &y);
    U256 r = x;
    if (cmp(r, kN) >= 0) sub_u(r, kN, &r);  // x < p < 2n
    if (is_zero(r)) continue;
    U256 kinv, rd, t, s;
    invmod(k, MOD_N, &kinv);
    mulmod(r, d, MOD_N, &rd);
    addmod(z, rd, kN, &t);
    mulmod(kinv, t, MOD_N, &s);
    if (is_zero(s)) continue;
    int v = (int)(y.w[0] & 1);
    if (cmp(s, half) > 0) {
      submod(kN, s, kN, &s);
      v ^= 1;
    }
    *r_out = r;
    *s_out = s;
    *v_out = v;
    return true;
  }
  return false;
}

}  // namespace

// ---------------------------------------------------------------------------
// C ABI
// ---------------------------------------------------------------------------

extern "C" {

void ibft_keccak256(const uint8_t* data, size_t len, uint8_t* out) {
  keccak256(data, len, out);
}

// sig = r(32, BE) || s(32, BE); pub = x(32, BE) || y(32, BE)
int ibft_ecdsa_verify(const uint8_t* pub, const uint8_t* digest,
                      const uint8_t* sig) {
  U256 qx, qy, z, r, s;
  load_be(pub, &qx);
  load_be(pub + 32, &qy);
  digest_to_scalar(digest, &z);
  load_be(sig, &r);
  load_be(sig + 32, &s);
  return ecdsa_verify_impl(qx, qy, z, r, s) ? 1 : 0;
}

// recovers pubkey; returns 1 on success
int ibft_ecdsa_recover(const uint8_t* digest, const uint8_t* sig, int v,
                       uint8_t* pub_out) {
  U256 z, r, s, qx, qy;
  digest_to_scalar(digest, &z);
  load_be(sig, &r);
  load_be(sig + 32, &s);
  if (!ecdsa_recover_impl(z, r, s, v, &qx, &qy)) return 0;
  store_be(qx, pub_out);
  store_be(qy, pub_out + 32);
  return 1;
}

// The sequential baseline loop (the reference's per-message verify shape):
// for each message i: recover(digest_i, sig_i) -> address -> compare with
// claimed address and membership in the validator table.
// digests: n*32, sigs: n*65 (r||s||v), claimed: n*20,
// table: n_validators*20, out: n bytes (0/1)
void ibft_verify_batch_sequential(size_t n, const uint8_t* digests,
                                  const uint8_t* sigs, const uint8_t* claimed,
                                  size_t n_validators, const uint8_t* table,
                                  uint8_t* out) {
  for (size_t i = 0; i < n; ++i) {
    out[i] = 0;
    U256 z, r, s, qx, qy;
    digest_to_scalar(digests + 32 * i, &z);
    load_be(sigs + 65 * i, &r);
    load_be(sigs + 65 * i + 32, &s);
    int v = sigs[65 * i + 64];
    if (!ecdsa_recover_impl(z, r, s, v, &qx, &qy)) continue;
    uint8_t addr[20];
    pubkey_address(qx, qy, addr);
    if (std::memcmp(addr, claimed + 20 * i, 20) != 0) continue;
    bool member = false;
    for (size_t j = 0; j < n_validators && !member; ++j)
      member = std::memcmp(addr, table + 20 * j, 20) == 0;
    out[i] = member ? 1 : 0;
  }
}

// Deterministic sign: d (32B BE) + digest (32B) -> sig r||s||v (65B).
// Returns 1 on success, 0 for an out-of-range private key.
int ibft_ecdsa_sign(const uint8_t* d, const uint8_t* digest,
                    uint8_t* sig_out) {
  U256 dd;
  load_be(d, &dd);
  if (!in_scalar_range(dd)) return 0;
  U256 r, s;
  int v;
  if (!ecdsa_sign_impl(dd, digest, &r, &s, &v)) return 0;
  store_be(r, sig_out);
  store_be(s, sig_out + 32);
  sig_out[64] = (uint8_t)v;
  return 1;
}

// Public-key derivation: d (32B BE) -> x||y (64B BE). Returns 1 on success.
int ibft_ecdsa_pubkey(const uint8_t* d, uint8_t* pub_out) {
  U256 dd;
  load_be(d, &dd);
  if (!in_scalar_range(dd)) return 0;
  Jac g = {kGx, kGy, {{1, 0, 0, 0}}}, pt;
  ecmul2(dd, kZero, g, &pt);
  if (jac_inf(pt)) return 0;
  U256 x, y;
  to_affine(pt, &x, &y);
  store_be(x, pub_out);
  store_be(y, pub_out + 32);
  return 1;
}

}  // extern "C"
