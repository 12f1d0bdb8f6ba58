"""The port on the card: each CUDA kernel against its plain version, and the
main path on CUDA tensors against the same path on the CPU.

Every test here is marked ``cuda`` and skips with a reason where
``torch.cuda.is_available()`` is false (the decision is made in a fixture,
never at import).  The file imports neither JAX nor the JAX package, so on
the machine with the card it runs without the repository's conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q

Tolerance: bit-exact equality (integer arithmetic).
"""

import numpy as np
import pytest
import torch

from go_ibft_tpu_torch import convert
from go_ibft_tpu_torch.bench import (
    build_recovery_lanes,
    build_round_workload,
    build_signed_round,
    build_sparse_scalar_lanes,
)
from go_ibft_tpu_torch.crypto.backend import ECDSABackend
from go_ibft_tpu_torch.ops import ecrecover, keccak_f1600
from go_ibft_tpu_torch.ops import fields as tf
from go_ibft_tpu_torch.ops import keccak as tk
from go_ibft_tpu_torch.ops import quorum as tq
from go_ibft_tpu_torch.ops import secp256k1 as sec
from go_ibft_tpu_torch.verify import DeviceBatchVerifier

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _states(b, seed, device):
    rng = np.random.default_rng(seed)
    st = rng.integers(0, 2**32, size=(b, 25, 2), dtype=np.uint32)
    return torch.from_numpy(st.view(np.int32)).to(device)


@pytest.mark.parametrize("b", [1, 129, 256, 4096])
def test_kernel_matches_plain(cuda_device, b):
    st = _states(b, b, cuda_device)
    before = tk.keccak_f.launches
    out = tk.keccak_f(st)
    torch.cuda.synchronize()
    assert tk.keccak_f.launches == before + 1
    assert torch.equal(out, keccak_f1600.keccak_f_plain(st))
    assert torch.equal(out.cpu(), keccak_f1600.keccak_f_plain(st.cpu()))


def test_kernel_refuses_what_it_does_not_take(cuda_device):
    st = _states(4, 1, cuda_device)
    with pytest.raises(ValueError):
        tk.keccak_f(st.transpose(0, 1))
    with pytest.raises(TypeError):
        tk.keccak_f(st.to(torch.int64))
    empty = tk.keccak_f(st[:0])
    assert empty.shape == (0, 25, 2)


def _digest_case(b, nb, device):
    """Seeded rate blocks and ragged counts (0, negative and above nb
    among them) on the card."""
    rng = np.random.default_rng(100 * nb + b)
    blocks = rng.integers(0, 2**32, size=(b, nb, 17, 2), dtype=np.uint32).view(np.int32)
    counts = rng.integers(-1, nb + 2, size=(b,), dtype=np.int32)
    return torch.from_numpy(blocks).to(device), torch.from_numpy(counts).to(device)


@pytest.mark.parametrize("nb", [1, 2, 3, 8, 32])
@pytest.mark.parametrize("b", [1, 129, 256, 1024])
def test_sponge_kernel_matches_plain(cuda_device, b, nb):
    """The digest kernel's stream-word form, through ``keccak256_blocks``."""
    blocks, counts = _digest_case(b, nb, cuda_device)
    before = tk.keccak256_blocks.launches
    out = tk.keccak256_blocks(blocks, counts)
    torch.cuda.synchronize()
    assert tk.keccak256_blocks.launches == before + 1
    assert torch.equal(out, keccak_f1600.keccak256_sponge_plain(blocks, counts))
    assert torch.equal(out.cpu(), tk.keccak256_blocks(blocks.cpu(), counts.cpu()))


@pytest.mark.parametrize("nb", [1, 2, 3, 8, 32])
@pytest.mark.parametrize("b", [1, 33, 128, 1024])
def test_digest_kernel_value_words_match_plain(cuda_device, b, nb):
    """The digest kernel's value-word form: ``digest_words`` makes exactly
    one launch and no other kernel touches the words."""
    blocks, counts = _digest_case(b, nb, cuda_device)
    before = tq.digest_words.launches
    out = tq.digest_words(blocks, counts)
    torch.cuda.synchronize()
    assert tq.digest_words.launches == before + 1
    assert torch.equal(out, keccak_f1600.digest_words_plain(blocks, counts))
    assert torch.equal(out.cpu(), tq.digest_words(blocks.cpu(), counts.cpu()))


def test_digest_words_is_one_kernel_on_the_card(cuda_device):
    from torch.profiler import ProfilerActivity, profile

    blocks, counts = _digest_case(128, 2, cuda_device)
    tq.digest_words(blocks, counts)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        tq.digest_words(blocks, counts)
        torch.cuda.synchronize()
    kernels = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    assert len(kernels) == 1 and "keccak256_digest" in kernels[0], kernels


@pytest.fixture(scope="module")
def recovery_lanes():
    lanes = build_recovery_lanes(8, seed=0)
    return lanes, lanes.expected()


@pytest.mark.parametrize("z_kind", ["zw", "z_limbs"])
@pytest.mark.parametrize("b", [1, 33, 256, 1024])
def test_recovery_kernel_matches_plain_and_oracle(cuda_device, recovery_lanes, b, z_kind):
    lanes, expect = recovery_lanes
    arr = lanes.arrays(b)
    ins = [torch.from_numpy(np.ascontiguousarray(arr[k])).to(cuda_device)
           for k in (z_kind, "r", "s", "v")]
    before = ecrecover.recover.launches
    x, y, addr, ok = ecrecover.recover(*ins)
    torch.cuda.synchronize()
    assert ecrecover.recover.launches == before + 1
    px, py, paddr, pok = ecrecover.recover_plain(*ins)
    assert torch.equal(ok, pok)
    for got, ref in ((x, px), (y, py), (addr, paddr)):
        assert torch.equal(got[pok], ref[pok])
    xs, ys, oks = tf.from_limbs(x), tf.from_limbs(y), ok.cpu().numpy()
    for i, lane in enumerate(arr["lane"]):
        assert bool(oks[i]) == (expect[lane] is not None), lanes.labels[lane]
        if expect[lane] is not None:
            assert (xs[i], ys[i]) == expect[lane], lanes.labels[lane]


def test_recovery_kernel_matches_oracle_on_sparse_scalars(cuda_device):
    lanes = build_sparse_scalar_lanes(64, seed=7)
    arr = lanes.arrays()
    ins = [torch.from_numpy(np.ascontiguousarray(arr[k])).to(cuda_device)
           for k in ("zw", "r", "s", "v")]
    x, y, addr, ok = ecrecover.recover(*ins)
    xs, ys, oks = tf.from_limbs(x), tf.from_limbs(y), ok.cpu().numpy()
    for i, e in enumerate(lanes.expected()):
        assert bool(oks[i]) == (e is not None)
        if e is not None:
            assert (xs[i], ys[i]) == e
    px, py, paddr, pok = ecrecover.recover_plain(*(t.cpu() for t in ins))
    assert torch.equal(ok.cpu(), pok)
    assert torch.equal(addr.cpu()[pok], paddr[pok])


def test_ecdsa_recover_on_card_reaches_the_kernel(cuda_device, recovery_lanes):
    lanes, _ = recovery_lanes
    arr = lanes.arrays()
    ins = [torch.from_numpy(arr[k]) for k in ("z_limbs", "r", "s", "v")]
    ref = sec.ecdsa_recover(*ins)
    before = ecrecover.recover.launches
    ours = sec.ecdsa_recover(*(t.to(cuda_device) for t in ins))
    assert ecrecover.recover.launches == before + 1
    assert torch.equal(ours[2].cpu(), ref[2])
    for a, b in zip(ours[:2], ref[:2]):
        assert torch.equal(a.cpu()[ref[2]], b[ref[2]])


def test_launchers_refuse_cpu_and_malformed_tensors(cuda_device, recovery_lanes):
    arr = recovery_lanes[0].arrays(4)
    z, r, s, v = (torch.from_numpy(np.ascontiguousarray(arr[k])).to(cuda_device)
                  for k in ("zw", "r", "s", "v"))
    with pytest.raises(ValueError):
        ecrecover.launch(z.cpu(), r.cpu(), s.cpu(), v.cpu())
    with pytest.raises(ValueError):
        ecrecover.launch(z, r.cpu(), s, v)  # two devices
    with pytest.raises(TypeError):
        ecrecover.launch(z, r.to(torch.int64), s, v)
    with pytest.raises(ValueError):
        ecrecover.launch(z[:, :7], r, s, v)
    with pytest.raises(ValueError):
        ecrecover.launch(z, r.t().contiguous().t(), s, v)  # not contiguous
    blocks = torch.zeros((4, 2, 17, 2), dtype=torch.int32, device=cuda_device)
    counts = torch.ones(4, dtype=torch.int32, device=cuda_device)
    for value_words in (False, True):
        with pytest.raises(ValueError):
            keccak_f1600.launch_digest(blocks.cpu(), counts.cpu(), value_words)
        with pytest.raises(ValueError):
            keccak_f1600.launch_digest(blocks, counts.cpu(), value_words)  # two devices
        with pytest.raises(ValueError):
            keccak_f1600.launch_digest(blocks, counts[:3], value_words)
        with pytest.raises(TypeError):
            keccak_f1600.launch_digest(blocks, counts.to(torch.int64), value_words)
        with pytest.raises(ValueError):
            keccak_f1600.launch_digest(blocks.transpose(0, 1), counts[:2], value_words)
        assert keccak_f1600.launch_digest(blocks[:0], counts[:0], value_words).shape == (0, 8)
    empty = ecrecover.launch(z[:0], r[:0], s[:0], v[:0])
    assert empty[0].shape == (0, 20) and empty[3].shape == (0,)


def test_round_certify_on_card_matches_cpu(cuda_device):
    arrays = convert.workload_arrays(build_round_workload(8, corrupt_frac=0.25))
    ref = tq.round_certify(*convert.round_args(arrays, device="cpu"))
    counts = (tk.keccak_f, tk.keccak256_blocks, tq.digest_words, ecrecover.recover)
    before = [fn.launches for fn in counts]
    ours = tq.round_certify(*convert.round_args(arrays))  # the default device is the card
    # One digest launch for the payload digests (value words, no glue), one
    # recovery launch (the address hash runs inside it); the bare
    # permutation and the stream-word form are off the path.
    assert [fn.launches - b for fn, b in zip(counts, before)] == [0, 0, 1, 1]
    for a, b in zip(ours, ref):
        assert torch.equal(a.cpu(), b)


def test_certify_round_on_card_matches_cpu(cuda_device):
    rnd = build_signed_round(16, corrupt_frac=0.3, seed=2)
    src = ECDSABackend.static_validators({m.sender: 1 for m in rnd.prepares})
    card = DeviceBatchVerifier(src)
    assert card.device.type == "cuda"
    before = tq.digest_words.launches
    ours = card.certify_round(rnd.prepares, rnd.proposal_hash, rnd.seals, rnd.height)
    assert tq.digest_words.launches == before + 1
    ref = DeviceBatchVerifier(src, device="cpu").certify_round(
        rnd.prepares, rnd.proposal_hash, rnd.seals, rnd.height
    )
    assert np.array_equal(ours[0], ref[0]) and np.array_equal(ours[2], ref[2])
    assert (ours[1], ours[3]) == (ref[1], ref[3])
    assert np.array_equal(ours[0], rnd.expected_prepare_mask)


def test_verifier_phase_paths_on_card_give_expected_masks(cuda_device):
    rnd = build_signed_round(16, corrupt_frac=0.3, seed=3)
    src = ECDSABackend.static_validators({m.sender: 1 for m in rnd.prepares})
    card = DeviceBatchVerifier(src)
    before = ecrecover.recover.launches
    sender_mask, _ = card.certify_senders(rnd.prepares, rnd.height)
    seal_mask, _ = card.certify_seals(rnd.proposal_hash, rnd.seals, rnd.height)
    assert np.array_equal(sender_mask, rnd.expected_prepare_mask)
    assert np.array_equal(seal_mask, rnd.expected_seal_mask)
    assert np.array_equal(card.verify_senders(rnd.prepares), rnd.expected_prepare_mask)
    assert np.array_equal(
        card.verify_committed_seals(rnd.proposal_hash, rnd.seals, rnd.height),
        rnd.expected_seal_mask,
    )
    assert ecrecover.recover.launches - before == 4  # one recovery launch per call
