"""The port's batched ECDSA recovery and verification against host oracles.

Keys, digests and signatures come from fixed seeds; the lanes include the
adversarial cases the device path must reject (r = 0, r >= N, s = 0,
s >= N, v not in {0, 1}, an r that is no curve x-coordinate, a zero-padded
dead lane).  Oracle: the JAX package's host ``crypto.ecdsa.recover`` /
``verify`` (Python ints).  Tolerance: exact equality of the validity mask
and of every recovered coordinate.  The JAX device ``ecdsa_recover``
comparison is slow-tier (its ladder takes minutes to compile here).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from go_ibft_tpu.crypto import ecdsa as jhost
from go_ibft_tpu.ops import fields as jf
from go_ibft_tpu.ops import secp256k1 as jsec
from go_ibft_tpu_torch.crypto import ecdsa as host
from go_ibft_tpu_torch.ops import fields as tf
from go_ibft_tpu_torch.ops import secp256k1 as sec

# Tiny tensors: one intra-op thread beats a pool per xdist worker.
torch.set_num_threads(1)

N, P = sec.N, sec.P


def _limbs(values):
    return torch.from_numpy(tf.to_limbs(values, 20))


def _non_residue_x():
    """Smallest x in (0, N) with x^3 + 7 a non-residue mod P."""
    x = 1
    while pow((x**3 + 7) % P, (P - 1) // 2, P) == 1:
        x += 1
    return x


@pytest.fixture(scope="module")
def lanes():
    """16 lanes: 8 valid signatures, then the adversarial ones."""
    rng = np.random.default_rng(21)
    keys = [host.PrivateKey.from_seed(b"torch-sec-%d" % i) for i in range(8)]
    z, r, s, v, expect = [], [], [], [], []
    for k in keys:
        d = rng.bytes(32)
        rr, ss, vv = host.sign(k, d)
        assert (rr, ss, vv) == jhost.sign(jhost.PrivateKey(k.d), d)
        z.append(d)
        r.append(rr)
        s.append(ss)
        v.append(vv)
    good_r, good_s = r[0], s[0]
    bad = [
        (0, good_s, 0),  # r = 0
        (N, good_s, 0),  # r >= N
        (good_r, 0, 0),  # s = 0
        (good_r, N + 5, 0),  # s >= N
        (good_r, good_s, 2),  # v not in {0, 1}
        (_non_residue_x(), good_s, 1),  # r is no curve x-coordinate
        (good_r, good_s, 1 - v[0]),  # wrong parity: recovers another key
    ]
    for rr, ss, vv in bad:
        z.append(z[0])
        r.append(rr)
        s.append(ss)
        v.append(vv)
    z.append(bytes(32))  # the dead lane: all zero
    r.append(0)
    s.append(0)
    v.append(0)
    for d, rr, ss, vv in zip(z, r, s, v):
        expect.append(jhost.recover(d, rr, ss, vv))
    return keys, z, r, s, v, expect


def test_ecdsa_recover_matches_host_oracle(lanes):
    keys, z, r, s, v, expect = lanes
    zl = _limbs([jhost.digest_to_scalar(d) for d in z])
    qx, qy, ok = sec.ecdsa_recover(zl, _limbs(r), _limbs(s), torch.tensor(v, dtype=torch.int32))
    ok = ok.numpy()
    assert list(ok) == [e is not None for e in expect]
    assert ok[:8].all() and not ok[8:14].any() and ok[14] and not ok[15]
    xs, ys = tf.from_limbs(qx), tf.from_limbs(qy)
    for i, e in enumerate(expect):
        if e is not None:
            assert (xs[i], ys[i]) == e
            assert host.recover(z[i], r[i], s[i], v[i]) == e
    for i, k in enumerate(keys):
        assert (xs[i], ys[i]) == k.pubkey


def test_ecdsa_verify_matches_host_oracle(lanes):
    keys, z, r, s, v, _ = lanes
    pubs = [keys[i % 8].pubkey for i in range(16)]
    pubs[3] = keys[4].pubkey  # valid signature, wrong key
    expect = [jhost.verify(*pubs[i], z[i], r[i], s[i]) for i in range(16)]
    ok = sec.ecdsa_verify(
        _limbs([p[0] for p in pubs]),
        _limbs([p[1] for p in pubs]),
        _limbs([jhost.digest_to_scalar(d) for d in z]),
        _limbs(r),
        _limbs(s),
    ).numpy()
    assert list(ok) == expect
    assert sum(expect) == 7


def test_glv_split_matches_jax_and_recombines():
    rng = np.random.default_rng(4)
    ks = [0, 1, N - 1, sec._LAMBDA] + [int.from_bytes(rng.bytes(32), "big") % N for _ in range(4)]
    kl = tf.to_limbs(ks, 20)
    ours = sec.glv_split(torch.from_numpy(kl))
    ref = jsec.glv_split(jnp.asarray(kl))
    for a, b in zip(ours, ref):
        assert np.array_equal(a.numpy(), np.asarray(b))
    a1, n1, a2, n2 = (x.numpy() for x in ours)
    for i, k in enumerate(ks):
        k1 = jf.from_limbs(a1[i : i + 1])[0] * (-1 if n1[i] else 1)
        k2 = jf.from_limbs(a2[i : i + 1])[0] * (-1 if n2[i] else 1)
        assert (k1 + k2 * sec._LAMBDA) % N == k
        assert abs(k1) < 2**129 and abs(k2) < 2**129


def test_point_ops_match_host_arithmetic():
    pts = [host.scalar_mul(k, (sec.GX, sec.GY)) for k in (1, 2, 7, 12345)]
    one = sec.FIELD.const(1)
    p = sec.JacobianPoint(
        _limbs([q[0] for q in pts]), _limbs([q[1] for q in pts]), torch.from_numpy(np.stack([one] * 4))
    )
    q = sec.JacobianPoint(p.x.flip(0), p.y.flip(0), p.z)  # lane 1 and 2: P + Q generic
    dx, dy = sec.to_affine(sec.point_double(p))
    sx, sy = sec.to_affine(sec.point_add(p, q))
    for i in range(4):
        assert (tf.from_limbs(dx[i])[0], tf.from_limbs(dy[i])[0]) == jhost._add(pts[i], pts[i])
        assert (tf.from_limbs(sx[i])[0], tf.from_limbs(sy[i])[0]) == jhost._add(pts[i], pts[3 - i])
    inf = sec.point_infinity((4,), torch.device("cpu"))
    ix, iy = sec.to_affine(sec.point_add(p, inf))
    assert torch.equal(ix, sec.to_affine(p)[0]) and torch.equal(iy, sec.to_affine(p)[1])


@pytest.mark.slow
def test_ecdsa_recover_matches_jax_device_path(lanes):
    _, z, r, s, v, _ = lanes
    zl = tf.to_limbs([jhost.digest_to_scalar(d) for d in z], 20)
    rl, sl = tf.to_limbs(r, 20), tf.to_limbs(s, 20)
    va = np.asarray(v, dtype=np.int32)
    ours = sec.ecdsa_recover(*(torch.from_numpy(a) for a in (zl, rl, sl, va)))
    ref = jsec.ecdsa_recover(*(jnp.asarray(a) for a in (zl, rl, sl, va)))
    ok = np.asarray(ref[2])
    assert np.array_equal(ours[2].numpy(), ok)
    for a, b in zip(ours[:2], ref[:2]):
        assert np.array_equal(a.numpy()[ok], np.asarray(b)[ok])
