"""The port on the card: the CUDA kernel against its plain version, and the
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
from go_ibft_tpu_torch.bench import build_round_workload, build_signed_round
from go_ibft_tpu_torch.crypto.backend import ECDSABackend
from go_ibft_tpu_torch.ops import keccak as tk
from go_ibft_tpu_torch.ops import keccak_f1600
from go_ibft_tpu_torch.ops import quorum as tq
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


def test_round_certify_on_card_matches_cpu(cuda_device):
    arrays = convert.workload_arrays(build_round_workload(8, corrupt_frac=0.25))
    ref = tq.round_certify(*convert.round_args(arrays, device="cpu"))
    before = tk.keccak_f.launches
    ours = tq.round_certify(*convert.round_args(arrays))  # the default device is the card
    assert tk.keccak_f.launches - before == 3  # 2 payload blocks + the address hash
    for a, b in zip(ours, ref):
        assert torch.equal(a.cpu(), b)


def test_certify_round_on_card_matches_cpu(cuda_device):
    rnd = build_signed_round(16, corrupt_frac=0.3, seed=2)
    src = ECDSABackend.static_validators({m.sender: 1 for m in rnd.prepares})
    card = DeviceBatchVerifier(src)
    assert card.device.type == "cuda"
    ours = card.certify_round(rnd.prepares, rnd.proposal_hash, rnd.seals, rnd.height)
    ref = DeviceBatchVerifier(src, device="cpu").certify_round(
        rnd.prepares, rnd.proposal_hash, rnd.seals, rnd.height
    )
    assert np.array_equal(ours[0], ref[0]) and np.array_equal(ours[2], ref[2])
    assert (ours[1], ours[3]) == (ref[1], ref[3])
    assert np.array_equal(ours[0], rnd.expected_prepare_mask)
