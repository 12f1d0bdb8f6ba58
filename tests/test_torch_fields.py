"""The port's limb arithmetic against the JAX package's, limb for limb.

Every ported op of ``ops/fields.py`` runs on the same seeded inputs (numpy,
B = 8 lanes) in both packages, for both secp256k1 moduli.  The lanes hold
the edge values 0, 1, p-1 and 2p-1 (semi-reduced), random values, and a
lane with a limb at exactly 2**13.  Tolerance: exact equality of every
limb — the fold schedules are static, so any drift in the port shows.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from go_ibft_tpu.ops import fields as jf
from go_ibft_tpu.ops import secp256k1 as jsec
from go_ibft_tpu_torch.ops import fields as tf
from go_ibft_tpu_torch.ops import secp256k1 as tsec

# Tiny tensors: one intra-op thread beats a pool per xdist worker.
torch.set_num_threads(1)

MODULI = [pytest.param("field", id="P"), pytest.param("order", id="N")]


def _moduli(name):
    if name == "field":
        return jsec.FIELD, tsec.FIELD
    return jsec.ORDER, tsec.ORDER


def _limbs(values):
    return jf.to_limbs(values, 20)


def _inputs(p, seed):
    """(8, 20) int32 limbs of semi-reduced values (< 2p, limbs <= 2**13)."""
    rng = np.random.default_rng(seed)
    rand = [int.from_bytes(rng.bytes(32), "big") % p for _ in range(4)]
    limbs = _limbs([0, 1, p - 1, 2 * p - 1] + rand)
    # Same value as lane 7, re-limbed with limb 3 at exactly 2**13.
    v = (rand[3] & ~(0x1FFF << 39)) | (1 << 52)  # limb 3 == 0, limb 4 >= 1
    lane = _limbs([v])[0]
    lane[3] += 1 << 13
    lane[4] -= 1
    limbs[7] = lane
    assert jf.from_limbs(limbs[7:8]) == [v]
    return limbs


def _same(t_out, j_out):
    ours, ref = t_out.numpy(), np.asarray(j_out)
    assert ours.dtype == ref.dtype
    assert np.array_equal(ours, ref)


@pytest.mark.parametrize("mod", MODULI)
def test_add_sub_mul_sqr_match_jax(mod):
    jm, tm = _moduli(mod)
    a, b = _inputs(jm.p, 1), _inputs(jm.p, 2)[::-1].copy()
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    _same(tf.add(tm, ta, tb), jf.add(jm, ja, jb))
    _same(tf.sub(tm, ta, tb), jf.sub(jm, ja, jb))
    _same(tf.mul(tm, ta, tb), jf.mul(jm, ja, jb))
    _same(tf.sqr(tm, ta), jf.sqr(jm, ja))
    for k in (1, 2, 3, 8, 16):
        _same(tf.muli(tm, ta, k), jf.muli(jm, ja, k))
    with pytest.raises(ValueError):
        tf.muli(tm, ta, 17)


@pytest.mark.parametrize("mod", MODULI)
def test_conv_carry_fold_match_jax(mod):
    jm, tm = _moduli(mod)
    a, b = _inputs(jm.p, 3), _inputs(jm.p, 4)
    for out_len in (19, 20, 41):
        conv = tf._conv(torch.from_numpy(a), torch.from_numpy(b), out_len)
        assert conv.dtype == torch.int32
        _same(conv, jf._conv(jnp.asarray(a), jnp.asarray(b), out_len))
    z = tf._conv(torch.from_numpy(a), torch.from_numpy(b), 41)
    _same(tf._carry(z, 4), jf._carry(jnp.asarray(z.numpy()), 4))
    carried = tf._carry(z, 4)
    bound = (2 * jm.p) ** 2
    _same(tf._fold_semi(tm, carried, bound), jf._fold_semi(jm, jnp.asarray(carried.numpy()), bound))
    with pytest.raises(ValueError):
        tf._conv(torch.from_numpy(a), torch.from_numpy(b), 10)


@pytest.mark.parametrize("mod", MODULI)
def test_select_and_select16_match_jax(mod):
    jm, _ = _moduli(mod)
    a, b = _inputs(jm.p, 5), _inputs(jm.p, 6)
    cond = np.array([True, False] * 4)
    _same(
        tf.select(torch.from_numpy(cond), torch.from_numpy(a), torch.from_numpy(b)),
        jf.select(jnp.asarray(cond), jnp.asarray(a), jnp.asarray(b)),
    )
    rng = np.random.default_rng(8)
    table = rng.integers(0, 1 << 13, size=(16, 8, 20), dtype=np.int32)
    sel = rng.integers(0, 16, size=(8,), dtype=np.int32)
    sel[:2] = [0, 15]
    _same(
        tf.select16(torch.from_numpy(sel), torch.from_numpy(table)),
        jf.select16(jnp.asarray(sel), jnp.asarray(table)),
    )
    _same(tf.select16(9, torch.from_numpy(table)), jf.select16(jnp.asarray(9), jnp.asarray(table)))


@pytest.mark.parametrize("mod", MODULI)
def test_pow_fixed_and_pow_fixed2_match_jax(mod):
    jm, tm = _moduli(mod)
    a, b = _inputs(jm.p, 9), _inputs(jm.p, 10)
    ta, ja = torch.from_numpy(a), jnp.asarray(a)
    for e in (0, 5, 0x1234567, jm.p - 2):
        _same(tf.pow_fixed(tm, ta, e), jf.pow_fixed(jm, ja, e))
    e1, e2 = (jm.p + 1) // 4, jm.p - 2
    t1, t2 = tf.pow_fixed2(tm, ta, e1, tm, torch.from_numpy(b), e2)
    j1, j2 = jf.pow_fixed2(jm, ja, e1, jm, jnp.asarray(b), e2)
    _same(t1, j1)
    _same(t2, j2)


@pytest.mark.parametrize("mod", MODULI)
@pytest.mark.parametrize("n", [1, 2, 3, 8])
def test_batch_inv_matches_jax(mod, n):
    jm, tm = _moduli(mod)
    a = _inputs(jm.p, 11 + n)[::-1][:n].copy()  # includes 2p-1, p-1, 1, 0 lanes
    if n >= 3:
        a[1] = jm.limbs  # value p: zero mod p
    _same(tf.batch_inv(tm, torch.from_numpy(a)), jf.batch_inv(jm, jnp.asarray(a)))


@pytest.mark.parametrize("mod", MODULI)
def test_canon_and_predicates_match_jax(mod):
    jm, tm = _moduli(mod)
    a, b = _inputs(jm.p, 13), _inputs(jm.p, 14)
    b[:4] = a[:4]
    b[4] = _limbs([(jf.from_limbs(a[4:5])[0] + jm.p)])[0]  # same class, other rep
    ta, tb, ja, jb = torch.from_numpy(a), torch.from_numpy(b), jnp.asarray(a), jnp.asarray(b)
    _same(tf.canon(tm, ta), jf.canon(jm, ja))
    _same(tf.exact_carry(ta), jf.exact_carry(ja))
    _same(tf.ge_const(tf.canon(tm, ta), jm.limbs), jf.ge_const(jf.canon(jm, ja), jm.limbs))
    _same(tf.is_zero(tm, ta), jf.is_zero(jm, ja))
    _same(tf.is_zero_fast(tm, ta), jf.is_zero_fast(jm, ja))
    _same(tf.eq_mod(tm, ta, tb), jf.eq_mod(jm, ja, jb))
    assert tf.eq_mod(tm, ta, tb).numpy()[:5].all()
    # Signed limbs: exact_carry floors negatives like jnp (the GLV split's use).
    neg = a.copy()
    neg[:, 2] -= 1 << 13
    _same(tf.exact_carry(torch.from_numpy(neg)), jf.exact_carry(jnp.asarray(neg)))


def test_modulus_constants_equal_jax():
    for jm, tm in ((jsec.FIELD, tsec.FIELD), (jsec.ORDER, tsec.ORDER)):
        for name in ("limbs", "c_fold_limbs", "c_fb_limbs", "fat_kp"):
            assert np.array_equal(getattr(tm, name), getattr(jm, name))
        assert (tm.fat_k, tm.sub_bound, tm.fb_limb, tm.fb_shift) == (
            jm.fat_k, jm.sub_bound, jm.fb_limb, jm.fb_shift,
        )
