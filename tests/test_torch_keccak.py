"""The port's Keccak against the JAX package's and the host's.

Inputs come from numpy seeds and reach both packages as numpy.  Tolerance:
exact equality everywhere (integer arithmetic).  The plain PyTorch
Keccak-f is compared with the JAX XLA ``keccak_f`` and with the numpy
uint64 oracle of ``ops/pallas_keccak.py``; the CUDA kernel is compared with
the plain version on the card in ``test_torch_cuda.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from go_ibft_tpu.crypto import ecdsa as jhost
from go_ibft_tpu.ops import fields as jfields
from go_ibft_tpu.ops import keccak as jk
from go_ibft_tpu.ops import quorum as jquorum
from go_ibft_tpu.ops.pallas_keccak import keccak_f_reference
from go_ibft_tpu_torch.crypto import ecdsa as host
from go_ibft_tpu_torch.crypto.keccak import keccak256
from go_ibft_tpu_torch.ops import fields as tfields
from go_ibft_tpu_torch.ops import keccak as tk
from go_ibft_tpu_torch.ops import keccak_f1600
from go_ibft_tpu_torch.ops import quorum as tquorum

# Tiny tensors: one intra-op thread beats a pool per xdist worker.
torch.set_num_threads(1)


def _states(b, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 2**32, size=(b, 25, 2), dtype=np.uint32)


def _t(a: np.ndarray) -> torch.Tensor:
    """uint32 numpy -> int32 bit-pattern tensor on the CPU."""
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32))


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


@pytest.mark.parametrize("b", [1, 7, 130])
def test_keccak_f_plain_matches_jax_and_numpy_oracle(b):
    st = _states(b, seed=b)
    ours = _u32(tk.keccak_f(_t(st)))
    assert np.array_equal(ours, np.asarray(jk.keccak_f(jnp.asarray(st))))
    assert np.array_equal(ours, keccak_f_reference(st))


def test_keccak_f_cpu_runs_plain_and_counts_no_launch():
    before = tk.keccak_f.launches
    st = _states(3, seed=11)
    assert np.array_equal(_u32(tk.keccak_f(_t(st))), keccak_f_reference(st))
    assert tk.keccak_f.launches == before


def test_kernel_launch_refuses_cpu_and_malformed_states():
    st = _t(_states(2, seed=5))
    with pytest.raises(ValueError):
        keccak_f1600.launch(st)  # no quiet CPU path behind the kernel
    with pytest.raises(TypeError):
        tk.keccak_f(st.to(torch.int64))
    with pytest.raises(ValueError):
        tk.keccak_f(st[:, :24])
    with pytest.raises(ValueError):
        tk.keccak_f(st.transpose(0, 1))


_PAYLOAD_LENS = [0, 1, 31, 64, 135, 136, 137, 200, 271, 272, 273, 400]


def _payloads(seed=7):
    rng = np.random.default_rng(seed)
    return [rng.bytes(n) for n in _PAYLOAD_LENS]


def test_pack_messages_bit_identical_to_jax():
    payloads = _payloads()
    ours, counts = tk.pack_messages(payloads, 4)
    ref, ref_counts = jk.pack_messages(payloads, 4)
    assert ours.dtype == ref.dtype == np.uint32
    assert np.array_equal(ours, ref) and np.array_equal(counts, ref_counts)
    with pytest.raises(ValueError):
        tk.pack_messages([b"x" * 500], max_blocks=2)


def test_keccak256_blocks_and_digest_words_match_jax_and_host():
    payloads = _payloads()
    blocks, counts = tk.pack_messages(payloads, 4)
    ours = tk.keccak256_blocks(_t(blocks), torch.from_numpy(counts))
    ref = jk.keccak256_blocks(jnp.asarray(blocks), jnp.asarray(counts))
    assert np.array_equal(_u32(ours), np.asarray(ref))
    for i, p in enumerate(payloads):
        assert tk.digest_words_to_bytes(ours[i]) == keccak256(p)
    zw = tquorum.digest_words(_t(blocks), torch.from_numpy(counts))
    ref_zw = jquorum.digest_words(jnp.asarray(blocks), jnp.asarray(counts))
    assert np.array_equal(_u32(zw), np.asarray(ref_zw))


def test_pubkey_to_address_words_matches_host():
    keys = [host.PrivateKey.from_seed(b"torch-addr-%d" % i) for i in range(5)]
    qx = torch.from_numpy(tfields.to_limbs([k.pubkey[0] for k in keys], 20))
    qy = torch.from_numpy(tfields.to_limbs([k.pubkey[1] for k in keys], 20))
    words = _u32(tk.pubkey_to_address_words(qx, qy))
    for i, k in enumerate(keys):
        assert k.pubkey == jhost.PrivateKey.from_seed(b"torch-addr-%d" % i).pubkey
        assert np.array_equal(words[i], tk.address_to_words(jhost.pubkey_to_address(*k.pubkey)))
    assert np.array_equal(
        tk.addresses_to_words([k.address for k in keys]),
        jk.addresses_to_words([k.address for k in keys]),
    )


def test_word_limb_converters_and_bswap_match_jax():
    rng = np.random.default_rng(3)
    vals = [int.from_bytes(rng.bytes(32), "big") for _ in range(8)]
    vals[0] = 2**256 - 1  # every word's top bit set: the arithmetic-shift hazard
    limbs = jfields.to_limbs(vals, 20)
    words = tk.limbs_to_words_le(torch.from_numpy(limbs))
    ref_words = np.asarray(jk.limbs_to_words_le(jnp.asarray(limbs)))
    assert np.array_equal(_u32(words), ref_words)
    back = tk.words_le_to_limbs(words, 20).numpy()
    assert np.array_equal(back, np.asarray(jk.words_le_to_limbs(jnp.asarray(ref_words), 20)))
    assert tfields.from_limbs(back) == vals
    w = rng.integers(0, 2**32, size=(16,), dtype=np.uint32)
    assert np.array_equal(_u32(tk.bswap32(_t(w))), np.asarray(jk.bswap32(jnp.asarray(w))))
