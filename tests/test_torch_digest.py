"""The payload-digest kernel's lane code and the digest's CPU path against
the JAX package.

* ``csrc/keccak_f1600.cu`` also compiles with a host C++ compiler
  (``csrc/lane.cuh``): ``keccak256_digest_host`` runs the kernel's step
  functions, a message's five threads one after the other, each shuffle a
  read of another thread's registers.  It is held, in both output forms,
  against the JAX package's ``go_ibft_tpu.ops.quorum.digest_words`` (value
  words) and ``go_ibft_tpu.ops.keccak.keccak256_blocks`` (stream words).
* ``ops/quorum.py::digest_words`` and ``ops/keccak.py::keccak256_blocks`` on
  CPU tensors take the plain version (``digest_words_plain``,
  ``keccak256_sponge_plain``) and count no launch; held against the same.

Inputs are made from numpy seeds: random rate blocks at 1, 2, 3 and 32
blocks with ragged counts (0, negative and above ``nb`` among them), and
real payloads packed by ``pack_messages``.  The CUDA build runs only on the
card (``tests/test_torch_cuda.py``).  Tolerance: exact equality.
"""

import ctypes
import shutil
import subprocess

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from go_ibft_tpu.crypto.keccak import keccak256 as jax_keccak256
from go_ibft_tpu.ops import keccak as jk
from go_ibft_tpu.ops import quorum as jquorum
from go_ibft_tpu_torch import _build
from go_ibft_tpu_torch.ops import keccak as tk
from go_ibft_tpu_torch.ops import keccak_f1600
from go_ibft_tpu_torch.ops import quorum as tquorum

# Tiny tensors: one intra-op thread beats a pool per xdist worker.
torch.set_num_threads(1)

BLOCKS = [1, 2, 3, 32]


def _case(nb):
    """Seeded rate blocks and ragged counts for ``nb`` blocks: 7 messages,
    counts from -1 to nb + 1, so that 0, negative and too-large counts
    all occur."""
    rng = np.random.default_rng(40 + nb)
    blocks = rng.integers(0, 2**32, size=(7, nb, 17, 2), dtype=np.uint32)
    counts = np.array([-1, 0, 1, nb, nb + 1, rng.integers(1, nb + 1), nb], dtype=np.int32)
    return blocks, counts


def _jax_reference(blocks, counts):
    """The JAX package's value words and stream words, as uint32.  Its
    sponge takes counts in ``[1, nb]``; a message absorbs ``clamp(count, 0,
    nb)`` blocks either way, so the counts are clamped for it."""
    nb = blocks.shape[1]
    jcounts = jnp.asarray(np.clip(counts, 0, nb))
    value = np.asarray(jquorum.digest_words(jnp.asarray(blocks), jcounts))
    stream = np.asarray(jk.keccak256_blocks(jnp.asarray(blocks), jcounts))
    return value, stream


@pytest.fixture(scope="module")
def references():
    return {nb: (*_case(nb), *_jax_reference(*_case(nb))) for nb in BLOCKS}


@pytest.fixture(scope="module")
def host_digest(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("needs a host C++ compiler to build the digest's lane code")
    lib = tmp_path_factory.mktemp("digest") / "keccak_f1600_host.so"
    subprocess.run(
        [cxx, "-x", "c++", "-std=c++17", "-O2", "-shared", "-fPIC", "-Wno-unknown-pragmas",
         "-I", str(_build.CSRC), "-o", str(lib), str(_build.CSRC / "keccak_f1600.cu")],
        check=True, capture_output=True, timeout=300,
    )
    fn = ctypes.CDLL(str(lib)).keccak256_digest_host
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int]
    fn.restype = ctypes.c_int

    def run(blocks, counts, value_words):
        blocks = np.ascontiguousarray(blocks, dtype=np.uint32)
        counts = np.ascontiguousarray(counts, dtype=np.int32)
        out = np.zeros((len(counts), 8), dtype=np.uint32)
        assert fn(blocks.ctypes.data, counts.ctypes.data, out.ctypes.data, len(counts),
                  blocks.shape[1], int(value_words)) == 0
        return out

    return run


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32))


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


@pytest.mark.parametrize("nb", BLOCKS)
def test_digest_host_build_matches_jax(host_digest, references, nb):
    blocks, counts, value, stream = references[nb]
    assert np.array_equal(host_digest(blocks, counts, value_words=True), value)
    assert np.array_equal(host_digest(blocks, counts, value_words=False), stream)


@pytest.mark.parametrize("nb", BLOCKS)
def test_digest_cpu_path_matches_jax_and_counts_no_launch(references, nb):
    blocks, counts, value, stream = references[nb]
    before = (tquorum.digest_words.launches, tk.keccak256_blocks.launches)
    zw = tquorum.digest_words(_t(blocks), torch.from_numpy(counts))
    sw = tk.keccak256_blocks(_t(blocks), torch.from_numpy(counts))
    assert (tquorum.digest_words.launches, tk.keccak256_blocks.launches) == before
    assert np.array_equal(_u32(zw), value)
    assert np.array_equal(_u32(sw), stream)
    assert np.array_equal(
        _u32(keccak_f1600.digest_words_plain(_t(blocks), torch.from_numpy(counts))), value
    )


@pytest.mark.parametrize("seed", [0, 1])
def test_digest_host_build_matches_jax_on_payloads(host_digest, seed):
    """Real payloads of every length class up to the 32-block bucket, packed
    by the port's packer: the host build against the JAX package's
    ``digest_words`` and its host keccak-256."""
    rng = np.random.default_rng(seed)
    lens = [0, 1, 135, 136, 137, 271, 272, 1000, 4351] + list(rng.integers(0, 4352, 7))
    payloads = [rng.bytes(int(n)) for n in lens]
    blocks, counts = tk.pack_messages(payloads, 32)
    value = host_digest(blocks, counts, value_words=True)
    stream = host_digest(blocks, counts, value_words=False)
    assert np.array_equal(
        value, np.asarray(jquorum.digest_words(jnp.asarray(blocks), jnp.asarray(counts)))
    )
    for i, p in enumerate(payloads):
        assert tk.digest_words_to_bytes(stream[i]) == jax_keccak256(p)


def test_digest_host_build_empty_and_single_message(host_digest, references):
    blocks, counts, value, stream = references[3]
    assert host_digest(blocks[:0], counts[:0], value_words=True).shape == (0, 8)
    for i in range(len(counts)):
        assert np.array_equal(host_digest(blocks[i : i + 1], counts[i : i + 1], True)[0], value[i])
