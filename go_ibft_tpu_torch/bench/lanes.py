"""Seeded batches of recovery lanes (and, :func:`build_verify_lanes`, of
verification and ``k1*G + k2*Q`` lanes): real signatures plus the
adversarial lanes a hand-written kernel is likely to get wrong.

The CPU tests, the card tests and ``chip_smoke.py`` all hold the recovery
(the plain version and the CUDA kernel) against the host oracle
``crypto.ecdsa.recover`` on this batch.  Lanes, in order:

* ``n_valid`` genuine signatures of seeded digests by seeded keys;
* rejected: ``r = 0``, ``r = N``, ``s = 0``, ``s = N + 5``, ``v = 2``, an
  ``r`` that is no curve x-coordinate;
* valid but recovering another key: the wrong parity, and the digest
  replaced by ``2**256 - 1``, ``N`` and ``0`` (``z`` is taken mod N; the
  last two give ``u1 = 0``, so the kernel's comb sum for ``u1*G`` is empty
  and the merge adds infinity);
* ``Q = infinity``: ``R = k*G`` for a seeded ``k``, ``r = R.x``, ``v`` its
  y-parity, a seeded ``s`` and ``z = s*k mod N``, so ``s*R == z*G``: the
  kernel's merge of ``u1*G`` and ``u2*R`` meets ``P == -Q``;
* ``R = G`` with ``s = -z``: the scalars of ``G`` and ``R`` are equal.  In
  a ladder that adds both into one accumulator (the kernel's first
  version, the plain version) the accumulator meets the same point from ``R``'s table, ``P ==
  Q`` inside an addition; in the comb design the merge is a doubling;
* ``r`` and ``s`` as 20-limb values ``>= 2**256`` (rejected: the range
  check covers all 260 bits);
* the all-zero dead lane;
* ``u1*G == u2*R`` for ``R = k*G`` of a seeded ``k``: ``z = -s*k mod N``,
  the doubling of a design that merges ``u1*G`` and ``u2*R`` directly;
* the kernel's two merges made doublings: it sums
  ``Q = k1*R + (k2*phi(R) + u1*G)`` over u2's GLV halves ``(k1, k2)``, and
  ``z`` is chosen so that ``k2*phi(R) == u1*G``, or
  ``k1*R == k2*phi(R) + u1*G``;
* ``r = 1``, ``r`` the largest x-coordinate below ``N`` and ``r = 2**200``
  (200 trailing zero bits): inverses mod N at the edges of the safegcd's
  divsteps;
* ``u1 = 2**248 - 1`` (every comb digit 255 but the top one) and a ``u1``
  whose bytes are all 0 or 255: the comb's first and last rows.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..crypto import ecdsa
from ..ops import secp256k1 as sec
from ..ops.fields import to_limbs

__all__ = ["RecoveryLanes", "VerifyLanes", "build_recovery_lanes", "build_sparse_scalar_lanes",
           "build_verify_lanes", "glv_halves"]


@dataclass
class RecoveryLanes:
    """Per-lane raw values; :meth:`arrays` packs them as the port's inputs."""

    digests: List[bytes] = field(default_factory=list)  # 32 bytes, big-endian z
    r: List[int] = field(default_factory=list)
    s: List[int] = field(default_factory=list)
    v: List[int] = field(default_factory=list)
    labels: List[str] = field(default_factory=list)

    def add(self, label: str, digest: bytes, r: int, s: int, v: int) -> None:
        self.labels.append(label)
        self.digests.append(digest)
        self.r.append(r)
        self.s.append(s)
        self.v.append(v)

    def __len__(self) -> int:
        return len(self.r)

    def expected(self) -> List[Optional[Tuple[int, int]]]:
        """The host oracle's public key per lane, ``None`` where it fails:
        Python ints (``recover_pure``), never the native library."""
        return [ecdsa.recover_pure(*lane) for lane in zip(self.digests, self.r, self.s, self.v)]

    def arrays(self, batch: Optional[int] = None) -> Dict[str, np.ndarray]:
        """int32 arrays of ``batch`` lanes (the lanes repeated cyclically;
        default: each lane once): ``zw`` ``(B, 8)`` little-endian value
        words of the digest, ``z_limbs`` ``(B, 20)`` limbs of the digest mod
        N, ``r``, ``s`` ``(B, 20)`` limbs, ``v`` ``(B,)``, and ``lane``, the
        index of each row's lane."""
        n = len(self) if batch is None else batch
        lane = np.arange(n) % len(self)
        zw = np.frombuffer(b"".join(d[::-1] for d in self.digests), dtype="<u4")
        zw = zw.reshape(len(self), 8).view(np.int32)
        z_mod = [ecdsa.digest_to_scalar(d) for d in self.digests]
        return {
            "zw": np.ascontiguousarray(zw[lane]),
            "z_limbs": to_limbs(z_mod, 20)[lane],
            "r": to_limbs(self.r, 20)[lane],
            "s": to_limbs(self.s, 20)[lane],
            "v": np.asarray(self.v, dtype=np.int32)[lane],
            "lane": lane,
        }


def _non_residue_x() -> int:
    """Smallest x in (0, N) with x^3 + 7 a non-residue mod P."""
    x = 1
    while pow((x**3 + 7) % ecdsa.P, (ecdsa.P - 1) // 2, ecdsa.P) == 1:
        x += 1
    return x


def _x_coordinate_at_or_below(x: int) -> int:
    """Largest x' <= x with x'^3 + 7 a quadratic residue mod P."""
    while pow((x**3 + 7) % ecdsa.P, (ecdsa.P - 1) // 2, ecdsa.P) != 1:
        x -= 1
    return x


def glv_halves(k: int) -> Tuple[int, int]:
    """The signed GLV half-scalars ``(k1, k2)`` of ``0 <= k < N``, with
    ``k == k1 + k2*LAMBDA (mod N)``: the split the recovery ladder runs."""
    c1 = (k * sec._GLV_G1 + (1 << 383)) >> 384
    c2 = (k * sec._GLV_G2 + (1 << 383)) >> 384
    k1 = k - c1 * sec._GLV_A1 - c2 * sec._GLV_A2
    k2 = -c1 * sec._GLV_B1 - c2 * sec._GLV_B2
    return k1, k2


def build_recovery_lanes(n_valid: int = 8, seed: int = 0) -> RecoveryLanes:
    """The batch described in the module docstring, from ``seed``."""
    n = ecdsa.N
    rng = np.random.default_rng(seed)
    lanes = RecoveryLanes()
    for i in range(n_valid):
        key = ecdsa.PrivateKey.from_seed(b"recovery-lanes-%d-%d" % (seed, i))
        digest = rng.bytes(32)
        lanes.add("valid", digest, *ecdsa.sign(key, digest))
    d0, r0, s0, v0 = lanes.digests[0], lanes.r[0], lanes.s[0], lanes.v[0]
    lanes.add("r = 0", d0, 0, s0, 0)
    lanes.add("r = N", d0, n, s0, 0)
    lanes.add("s = 0", d0, r0, 0, 0)
    lanes.add("s = N + 5", d0, r0, n + 5, 0)
    lanes.add("v = 2", d0, r0, s0, 2)
    lanes.add("r not an x-coordinate", d0, _non_residue_x(), s0, 1)
    lanes.add("wrong parity", d0, r0, s0, 1 - v0)
    lanes.add("z = 2^256 - 1", b"\xff" * 32, r0, s0, v0)
    lanes.add("z = N", n.to_bytes(32, "big"), r0, s0, v0)
    lanes.add("z = 0", bytes(32), r0, s0, v0)
    k = int.from_bytes(rng.bytes(32), "big") % n or 1
    rx, ry = ecdsa.scalar_mul(k, (ecdsa.GX, ecdsa.GY))
    s_inf = int.from_bytes(rng.bytes(32), "big") % n or 1
    lanes.add("Q = infinity", (s_inf * k % n).to_bytes(32, "big"), rx, s_inf, ry & 1)
    # u1 == u2 == s / GX: the doubling happens where one half-scalar's top
    # window is above the other's (else both add in that window).
    while True:
        s_dbl = int.from_bytes(rng.bytes(32), "big") % n or 1
        k1, k2 = glv_halves(s_dbl * pow(ecdsa.GX, -1, n) % n)
        if (abs(k1).bit_length() + 3) // 4 != (abs(k2).bit_length() + 3) // 4:
            break
    lanes.add("P == Q in the ladder", (n - s_dbl).to_bytes(32, "big"), ecdsa.GX, s_dbl,
              ecdsa.GY & 1)
    lanes.add("r >= 2^256", d0, r0 + (1 << 256), s0, v0)
    lanes.add("s >= 2^256", d0, r0, s0 + (1 << 256), v0)
    lanes.add("dead lane", bytes(32), 0, 0, 0)
    k = int.from_bytes(rng.bytes(32), "big") % n or 1
    rx, ry = ecdsa.scalar_mul(k, (ecdsa.GX, ecdsa.GY))
    s_dbl = int.from_bytes(rng.bytes(32), "big") % n or 1
    lanes.add("u1 G == u2 R at the merge", (-s_dbl * k % n).to_bytes(32, "big"), rx, s_dbl, ry & 1)
    # u1 = -z / r: z = -u1 r (mod N) for the u1 each merge needs.
    h1, h2 = glv_halves(s_dbl * pow(rx, -1, n) % n)
    for label, u1 in (("k2 phi(R) == u1 G", h2 * sec._LAMBDA * k % n),
                      ("k1 R == k2 phi(R) + u1 G", (h1 - h2 * sec._LAMBDA) * k % n)):
        lanes.add(label, (-u1 * rx % n).to_bytes(32, "big"), rx, s_dbl, ry & 1)
    for label, r_edge in (("r = 1", 1), ("r = largest x below N", _x_coordinate_at_or_below(n - 1)),
                          ("r = 2^200", 1 << 200)):
        lanes.add(label, d0, r_edge, s0, 0)
    # z = -u1 r0 (mod N) gives the wanted u1 = -z / r0.
    bytes_0_255 = bytes(255 if b else 0 for b in rng.integers(0, 2, 32))
    for label, u1 in (("u1 = 2^248 - 1", (1 << 248) - 1),
                      ("u1 bytes 0 or 255", int.from_bytes(bytes_0_255, "big") % n)):
        lanes.add(label, (-u1 * r0 % n).to_bytes(32, "big"), r0, s0, v0)
    return lanes


def _sparse(rng: np.random.Generator, ones: int) -> int:
    """A 256-bit value with ``ones`` seeded bits set."""
    return sum(1 << int(b) for b in rng.choice(256, size=ones, replace=False))


def build_sparse_scalar_lanes(n: int = 32, seed: int = 0) -> RecoveryLanes:
    """``n`` valid lanes (``r`` the x of a seeded multiple of ``G``) whose
    ``s`` and ``z`` have low Hamming weight or are small, so that u1 and u2
    take extreme digits; the first four are exact small scalars."""
    rng = np.random.default_rng(seed)
    lanes = RecoveryLanes()
    for i in range(n):
        k = int.from_bytes(rng.bytes(32), "big") % ecdsa.N or 1
        rx, ry = ecdsa.scalar_mul(k, (ecdsa.GX, ecdsa.GY))
        if i < 4:
            s, z = i + 1, 3 - i
        else:
            s = _sparse(rng, int(rng.integers(1, 6))) % ecdsa.N or 1
            if rng.random() < 0.5:
                z = _sparse(rng, int(rng.integers(0, 6)))
            else:
                z = int(rng.integers(0, 1 << 20))
        lanes.add("sparse", z.to_bytes(32, "big"), rx, s, ry & 1)
    return lanes


@dataclass
class VerifyLanes:
    """Lanes of both entries of the ``k1*G + k2*Q`` kernel: each lane holds
    a key ``Q = (qx, qy)``, a verification's ``(z, r, s)`` and a pair of
    scalars ``(k1, k2)``, so that every lane runs through both
    ``ecdsa_verify`` and ``ecmul2_base``; :meth:`arrays` packs them."""

    qx: List[int] = field(default_factory=list)
    qy: List[int] = field(default_factory=list)
    z: List[int] = field(default_factory=list)  # reduced mod N
    r: List[int] = field(default_factory=list)
    s: List[int] = field(default_factory=list)
    k1: List[int] = field(default_factory=list)  # below 2N
    k2: List[int] = field(default_factory=list)
    labels: List[str] = field(default_factory=list)

    def add(self, label: str, q: Tuple[int, int], z: int, r: int, s: int,
            k: Optional[Tuple[int, int]] = None) -> None:
        """One lane; ``k`` defaults to the verification's ``(u1, u2)``
        (``(z, r mod N)`` where ``s`` has no inverse mod N)."""
        n = ecdsa.N
        if k is None:
            w = pow(s, -1, n) if s % n else 1
            k = (z * w % n, r * w % n)
        self.labels.append(label)
        for name, value in zip(("qx", "qy", "z", "r", "s", "k1", "k2"), (*q, z, r, s, *k)):
            getattr(self, name).append(value)

    def __len__(self) -> int:
        return len(self.r)

    def on_curve(self) -> List[bool]:
        return [ecdsa.on_curve(x, y) for x, y in zip(self.qx, self.qy)]

    def expected_masks(self) -> Dict[int, bool]:
        """The host oracle's verification, on the lanes whose key is on the
        curve (the oracle rejects any other key, which the kernel and the
        plain version never check): Python ints."""
        return {i: ecdsa.verify(self.qx[i], self.qy[i], self.z[i].to_bytes(32, "big"), self.r[i],
                                self.s[i])
                for i, on in enumerate(self.on_curve()) if on}

    def expected_points(self) -> Dict[int, ecdsa.Point]:
        """``k1*G + k2*Q`` by the host oracle (``None``: infinity), on the
        lanes whose key is on the curve."""
        g = (ecdsa.GX, ecdsa.GY)
        return {i: ecdsa._add(ecdsa.scalar_mul(self.k1[i], g),
                              ecdsa.scalar_mul(self.k2[i], (self.qx[i], self.qy[i])))
                for i, on in enumerate(self.on_curve()) if on}

    def arrays(self, batch: Optional[int] = None, labels: Optional[Tuple[str, ...]] = None
               ) -> Dict[str, np.ndarray]:
        """``(B, 20)`` int32 limbs of ``qx``, ``qy``, ``z``, ``r``, ``s``,
        ``k1``, ``k2`` for ``batch`` lanes (the lanes, or those whose label
        is in ``labels``, repeated cyclically; default: each once), and
        ``lane``, the index of each row's lane."""
        pick = [i for i, lab in enumerate(self.labels) if labels is None or lab in labels]
        n = len(pick) if batch is None else batch
        lane = np.asarray(pick)[np.arange(n) % len(pick)]
        out = {name: to_limbs(getattr(self, name), 20)[lane]
               for name in ("qx", "qy", "z", "r", "s", "k1", "k2")}
        out["lane"] = lane
        return out


def _neg(pt: Tuple[int, int]) -> Tuple[int, int]:
    return pt[0], (-pt[1]) % ecdsa.P


def build_verify_lanes(n_valid: int = 8, seed: int = 0) -> VerifyLanes:
    """Lanes, in order: ``n_valid`` genuine signatures of seeded digests by
    seeded keys; ``r`` and ``s`` at 0, ``N`` and ``2**256 - 1``; a valid
    signature under the wrong key; ``Q`` off the curve (``y + 1``) and
    ``Q = (0, 0)``; ``Q = -(z/r)*G``, whose ``u1*G + u2*Q`` is infinity;
    ``x = r + N``: a point ``T`` with ``N <= x_T < P``, ``r = x_T - N`` and
    ``Q = u2**-1 * (T - u1*G)``, valid, then with ``s`` changed.  Then the
    ``k1*G + k2*Q`` lanes (on the first key, with the first signature's
    ``(z, r, s)``): ``k1``, ``k2`` or both 0, ``N - 1``, in ``[N, 2N)``,
    the one-window scalars 16, ``2**8`` and ``2**252`` on either side;
    ``Q = G`` with ``k1 = N - k2`` (infinity) and with ``k1 = k2`` (the
    merge doubles)."""
    n, p = ecdsa.N, ecdsa.P
    g = (ecdsa.GX, ecdsa.GY)
    rng = np.random.default_rng(seed)

    def scalar() -> int:
        return int.from_bytes(rng.bytes(32), "big") % n or 1

    lanes = VerifyLanes()
    keys = [ecdsa.PrivateKey.from_seed(b"verify-lanes-%d-%d" % (seed, i)) for i in range(max(n_valid, 2))]
    for key in keys[:n_valid]:
        digest = rng.bytes(32)
        r, s, _ = ecdsa.sign(key, digest)
        lanes.add("valid", key.pubkey, ecdsa.digest_to_scalar(digest), r, s)
    q0 = keys[0].pubkey
    digest = rng.bytes(32)
    r0, s0, _ = ecdsa.sign(keys[0], digest)
    z0 = ecdsa.digest_to_scalar(digest)
    for label, r, s in (("r = 0", 0, s0), ("r = N", n, s0), ("r = 2^256 - 1", (1 << 256) - 1, s0),
                        ("s = 0", r0, 0), ("s = N", r0, n), ("s = 2^256 - 1", r0, (1 << 256) - 1)):
        lanes.add(label, q0, z0, r, s)
    lanes.add("wrong key", keys[1].pubkey, z0, r0, s0)
    lanes.add("Q off the curve (y + 1)", (q0[0], (q0[1] + 1) % p), z0, r0, s0)
    lanes.add("Q = (0, 0)", (0, 0), z0, r0, s0)
    lanes.add("u1 G + u2 Q = infinity", ecdsa.scalar_mul(-z0 * pow(r0, -1, n), g), z0, r0, s0)
    # x = r + N: the smallest x_T >= N + a seeded offset that is a curve x.
    x_t = n + int(rng.integers(1, 1 << 62))
    while pow((x_t**3 + 7) % p, (p - 1) // 2, p) != 1:
        x_t += 1
    t = (x_t, pow((x_t**3 + 7) % p, (p + 1) // 4, p))
    z, s = scalar(), scalar()
    r = x_t - n
    w = pow(s, -1, n)
    q = ecdsa.scalar_mul(pow(r * w, -1, n), ecdsa._add(t, _neg(ecdsa.scalar_mul(z * w, g))))
    lanes.add("x = r + N", q, z, r, s)
    lanes.add("x = r + N, s changed", q, z, r, s + 1)
    ka, kb = scalar(), scalar()
    for label, k in (("k1 = 0", (0, kb)), ("k2 = 0", (ka, 0)), ("k1 = k2 = 0", (0, 0)),
                     ("k1 = N - 1", (n - 1, kb)), ("k2 = N - 1", (ka, n - 1)),
                     ("k1 in [N, 2N)", (n + ka, kb)), ("k2 in [N, 2N)", (ka, n + kb))):
        lanes.add(label, q0, z0, r0, s0, k)
    for name, one in (("16", 16), ("2^8", 1 << 8), ("2^252", 1 << 252)):
        lanes.add(f"k1 = {name}", q0, z0, r0, s0, (one, 0))
        lanes.add(f"k2 = {name}", q0, z0, r0, s0, (0, one))
    lanes.add("Q = G, k1 = N - k2", g, z0, r0, s0, (n - kb, kb))
    lanes.add("Q = G, k1 = k2", g, z0, r0, s0, (kb, kb))
    return lanes
