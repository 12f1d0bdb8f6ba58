"""The port on the card: each CUDA kernel against its plain version, and the
main path on CUDA tensors against the same path on the CPU.

Every test that needs the card is marked ``cuda`` and skips with a reason
where ``torch.cuda.is_available()`` is false (the decision is made in a
fixture, never at import); the import-hygiene check runs everywhere.  The
file imports neither JAX nor the JAX package, so on the machine with the
card it runs without the repository's conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q

Tolerance: bit-exact equality (integer arithmetic).
"""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from go_ibft_tpu_torch import convert
from go_ibft_tpu_torch.bench import (
    build_recovery_lanes,
    build_round_workload,
    build_signed_round,
    build_sparse_scalar_lanes,
    build_verify_lanes,
)
from go_ibft_tpu_torch.crypto.backend import ECDSABackend
from go_ibft_tpu_torch.ops import certify_lanes, ecrecover, ecverify, keccak_f1600
from go_ibft_tpu_torch.ops import fields as tf
from go_ibft_tpu_torch.ops import keccak as tk
from go_ibft_tpu_torch.ops import quorum as tq
from go_ibft_tpu_torch.ops import secp256k1 as sec
from go_ibft_tpu_torch.verify import DeviceBatchVerifier

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _states(b, seed, device):
    rng = np.random.default_rng(seed)
    st = rng.integers(0, 2**32, size=(b, 25, 2), dtype=np.uint32)
    return torch.from_numpy(st.view(np.int32)).to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("b", [1, 129, 256, 4096])
def test_kernel_matches_plain(cuda_device, b):
    st = _states(b, b, cuda_device)
    before = tk.keccak_f.launches
    out = tk.keccak_f(st)
    torch.cuda.synchronize()
    assert tk.keccak_f.launches == before + 1
    assert torch.equal(out, keccak_f1600.keccak_f_plain(st))
    assert torch.equal(out.cpu(), keccak_f1600.keccak_f_plain(st.cpu()))


@pytest.mark.cuda
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


@pytest.mark.cuda
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


@pytest.mark.cuda
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


@pytest.mark.cuda
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


@pytest.mark.cuda
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


@pytest.mark.cuda
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


@pytest.mark.cuda
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


@pytest.mark.cuda
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


_ECMUL2 = ("k1", "k2", "qx", "qy")
_VERIFY = ("qx", "qy", "z", "r", "s")


def _affine_ints(pt):
    """Per lane, ``None`` at infinity, else the affine point as ints."""
    x, y = sec.to_affine(sec.JacobianPoint(*(c.cpu() for c in pt)))
    inf = sec.is_infinity(sec.JacobianPoint(*(c.cpu() for c in pt))).numpy()
    return [None if i else p for i, p in zip(inf, zip(tf.from_limbs(x), tf.from_limbs(y)))]


@pytest.fixture(scope="module")
def verify_lanes():
    """``bench/lanes.py``'s verification and ``k1*G + k2*Q`` lanes, the
    plain versions' results on the card (each lane once) and the host
    oracle's on the lanes whose key is on the curve."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    lanes = build_verify_lanes(8, seed=0)
    arr = lanes.arrays()
    dev = torch.device("cuda")
    ins = {k: torch.from_numpy(np.ascontiguousarray(arr[k])).to(dev) for k in set(_ECMUL2 + _VERIFY)}
    points = _affine_ints(ecverify.ecmul2_plain(*(ins[k] for k in _ECMUL2)))
    masks = ecverify.verify_plain(*(ins[k] for k in _VERIFY)).cpu().numpy()
    return lanes, points, masks, lanes.expected_points(), lanes.expected_masks()


@pytest.mark.cuda
@pytest.mark.parametrize("b", [None, 33, 1024])
def test_ecmul2_and_verify_kernel_match_plain_and_oracle(cuda_device, verify_lanes, b):
    """Both entries of the k1*G + k2*Q kernel against their plain versions
    on the card, lane for lane (off-curve keys and ``x = r + N`` among the
    lanes), and against the host oracle on the curve."""
    lanes, points, masks, oracle_points, oracle_masks = verify_lanes
    arr = lanes.arrays(b)
    ins = {k: torch.from_numpy(np.ascontiguousarray(arr[k])).to(cuda_device) for k in set(_ECMUL2 + _VERIFY)}
    before = (ecverify.ecmul2.launches, ecverify.verify.launches)
    pt = ecverify.ecmul2(*(ins[k] for k in _ECMUL2))
    ok = ecverify.verify(*(ins[k] for k in _VERIFY))
    torch.cuda.synchronize()
    assert (ecverify.ecmul2.launches, ecverify.verify.launches) == (before[0] + 1, before[1] + 1)
    assert all(int(c.min()) >= 0 and int(c.max()) < 8192 for c in pt)  # canonical limbs
    got, oks = _affine_ints(pt), ok.cpu().numpy()
    for row, lane in enumerate(arr["lane"]):
        label = lanes.labels[lane]
        assert got[row] == points[lane] and bool(oks[row]) == bool(masks[lane]), label
        if lane in oracle_points:
            assert got[row] == oracle_points[lane] and bool(oks[row]) == oracle_masks[lane], label


@pytest.mark.cuda
def test_ecmul2_base_and_ecdsa_verify_on_card_reach_the_kernel(cuda_device, verify_lanes):
    """The port's ``ecmul2_base`` and ``ecdsa_verify`` on CUDA tensors: one
    launch each, the same points and mask as the CPU's plain versions."""
    lanes = verify_lanes[0]
    arr = lanes.arrays(6)
    cpu = {k: torch.from_numpy(np.ascontiguousarray(arr[k])) for k in set(_ECMUL2 + _VERIFY)}
    card = {k: t.to(cuda_device) for k, t in cpu.items()}
    before = (ecverify.ecmul2.launches, ecverify.verify.launches)
    pt = sec.ecmul2_base(*(card[k] for k in _ECMUL2))
    ok = sec.ecdsa_verify(*(card[k] for k in _VERIFY))
    assert (ecverify.ecmul2.launches, ecverify.verify.launches) == (before[0] + 1, before[1] + 1)
    assert _affine_ints(pt) == _affine_ints(sec.ecmul2_base(*(cpu[k] for k in _ECMUL2)))
    assert torch.equal(ok.cpu(), sec.ecdsa_verify(*(cpu[k] for k in _VERIFY)))


@pytest.mark.cuda
def test_ecmul2_base_and_ecdsa_verify_broadcast_on_card(cuda_device, verify_lanes):
    """The card route broadcasts by the JAX functions' rules: one ``(20,)``
    key against 64 signatures through ``sec.ecdsa_verify`` and against 64
    scalar pairs through ``sec.ecmul2_base``, and a transposed (not
    contiguous) view, each equal to the explicitly expanded call and to the
    plain version; a ``(20,)`` k1 against 64 k2, which the JAX
    ``ecmul2_base`` refuses (its digit streams are stacked at the scalars'
    own shape), raises."""
    lanes = verify_lanes[0]
    arr = lanes.arrays(64)
    card = {k: torch.from_numpy(np.ascontiguousarray(arr[k])).to(cuda_device) for k in set(_ECMUL2 + _VERIFY)}
    row = [lanes.labels[i] for i in arr["lane"]].index("valid")

    def full(t):
        return t.expand(64, 20).contiguous()

    qx, qy = card["qx"][row], card["qy"][row]
    ok = sec.ecdsa_verify(qx, qy, card["z"], card["r"], card["s"])
    assert ok.shape == (64,) and bool(ok[row])
    assert torch.equal(ok, sec.ecdsa_verify(full(qx), full(qy), card["z"], card["r"], card["s"]))
    assert torch.equal(ok, ecverify.verify_plain(qx, qy, card["z"], card["r"], card["s"]))
    pt = sec.ecmul2_base(card["k1"], card["k2"], qx, qy)
    assert pt.x.shape == (64, 20)
    assert _affine_ints(pt) == _affine_ints(sec.ecmul2_base(card["k1"], card["k2"], full(qx), full(qy)))
    assert _affine_ints(pt) == _affine_ints(ecverify.ecmul2_plain(card["k1"], card["k2"], qx, qy))
    with pytest.raises(ValueError):
        sec.ecmul2_base(card["k1"][row], card["k2"], card["qx"], card["qy"])
    qx_t = card["qx"].t().contiguous().t()  # the same values, column-major
    assert not qx_t.is_contiguous()
    before = ecverify.ecmul2.launches
    pt_t = sec.ecmul2_base(card["k1"], card["k2"], qx_t, card["qy"])
    assert ecverify.ecmul2.launches == before + 1
    assert _affine_ints(pt_t) == _affine_ints(sec.ecmul2_base(*(card[k] for k in _ECMUL2)))


@pytest.mark.cuda
def test_ecdsa_recover_broadcasts_on_card(cuda_device, recovery_lanes):
    """``sec.ecdsa_recover`` and ``ecrecover.recover`` on the card take one
    ``(20,)`` digest against many signatures, and a view that is not
    contiguous, as the JAX ``ecdsa_recover`` broadcasts: the same as the
    expanded call."""
    arr = recovery_lanes[0].arrays(33)
    z, r, s, v = (torch.from_numpy(np.ascontiguousarray(arr[k])).to(cuda_device)
                  for k in ("z_limbs", "r", "s", "v"))
    one = z[0]
    x, y, ok = sec.ecdsa_recover(one, r, s, v)
    xe, ye, oke = sec.ecdsa_recover(one.expand(33, 20).contiguous(), r, s, v)
    assert x.shape == (33, 20) and torch.equal(ok, oke)
    assert torch.equal(x[ok], xe[oke]) and torch.equal(y[ok], ye[oke])
    r_t = r.t().contiguous().t()
    got = ecrecover.recover(z, r_t, s, v)
    want = ecrecover.recover(z, r, s, v)
    assert torch.equal(got[3], want[3]) and torch.equal(got[2][want[3]], want[2][want[3]])


_BOOT_FAMILY_PROFILE = """
import json, torch
from torch.profiler import ProfilerActivity, profile
from go_ibft_tpu_torch.boot import program_registry
from go_ibft_tpu_torch.ops import ecverify
fn, args = program_registry(["ecmul2_base_8l"], device=torch.device("cuda"))["ecmul2_base_8l"]()
fn(*args)  # build, load, comb upload
torch.cuda.synchronize()
before = ecverify.ecmul2.launches
with profile(activities=[ProfilerActivity.CUDA]) as prof:
    torch.cuda._sleep(1000)  # a session's first kernel can go unrecorded
    out = fn(*args)
    torch.cuda.synchronize()
kernels = [e.name for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA and "spin_kernel" not in e.name]
print(json.dumps({"launches": ecverify.ecmul2.launches - before, "kernels": kernels,
                  "point": [c.cpu().tolist() for c in out]}))
"""


@pytest.mark.cuda
def test_boot_family_ecmul2_base_is_one_kernel_launch(cuda_device):
    """The registry's ``ecmul2_base_8l`` warm call on the card: one launch
    of the ``secp256k1_ecmul2`` entry and, under the profiler, no device
    kernel beside it but copies (the eager ladder is gone); all-zero
    scalars give infinity, as (1, 1, 0).  The profiler records the card
    only in a process's first sessions, so the call runs in a process of
    its own."""
    root = Path(__file__).resolve().parent.parent
    out = subprocess.run([sys.executable, "-c", _BOOT_FAMILY_PROFILE], cwd=root, capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    kernels = got["kernels"]
    assert got["launches"] == 1
    assert sum("secp256k1_ecmul2_kernel" in k for k in kernels) == 1, kernels
    assert all("secp256k1_ecmul2_kernel" in k or "Memcpy" in k or "Memset" in k for k in kernels), kernels
    one = [[1] + [0] * 19] * 8
    assert got["point"] == [one, one, [[0] * 20] * 8]


@pytest.mark.cuda
def test_ecverify_launchers_refuse_and_an_empty_batch_launches_nothing(cuda_device, verify_lanes):
    arr = verify_lanes[0].arrays(4)
    k1, k2, qx, qy = (torch.from_numpy(np.ascontiguousarray(arr[k])).to(cuda_device) for k in _ECMUL2)
    z, r, s = (torch.from_numpy(np.ascontiguousarray(arr[k])).to(cuda_device) for k in ("z", "r", "s"))
    with pytest.raises(ValueError):
        ecverify.launch_ecmul2(k1, k2.cpu(), qx, qy)  # two devices
    with pytest.raises(ValueError):
        ecverify.launch_ecmul2(k1, k2, qx.t().contiguous().t(), qy)  # not contiguous
    with pytest.raises(ValueError):
        ecverify.launch_verify(qx, qy, z, r[:3], s)
    with pytest.raises(TypeError):
        ecverify.launch_verify(qx, qy, z.to(torch.int64), r, s)
    before = (ecverify.ecmul2.launches, ecverify.verify.launches)
    pt = ecverify.ecmul2(k1[:0], k2[:0], qx[:0], qy[:0])
    ok = ecverify.verify(qx[:0], qy[:0], z[:0], r[:0], s[:0])
    torch.cuda.synchronize()
    assert pt.x.shape == (0, 20) and ok.shape == (0,) and ok.dtype == torch.bool
    assert (ecverify.ecmul2.launches, ecverify.verify.launches) == before


@pytest.mark.cuda
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


@pytest.mark.cuda
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


@pytest.mark.cuda
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


@pytest.mark.cuda
def test_engine_finalizes_heights_on_card_without_fallback(cuda_device):
    """One engine among 16 validators, its drains through the adaptive
    router with every drain on the card (cutover 1): 2 heights finalize the
    proposal sent, every seal passes the host oracle, both kernels launch on
    every height, and nothing falls back to the host."""
    from go_ibft_tpu_torch.bench.engine import Committee, EngineRunner, check_height
    from go_ibft_tpu_torch.utils import metrics
    from go_ibft_tpu_torch.verify import AdaptiveBatchVerifier

    metrics.reset()
    committee = Committee(16, seed=0)
    me = 1
    heights = committee.heights(me, 2)
    device = DeviceBatchVerifier(committee.src)
    verifier = AdaptiveBatchVerifier(committee.src, cutover_lanes=1, device=device)
    runner = EngineRunner(committee, me, verifier)
    for h in heights:
        schedule = committee.schedule(h)
        before = (tq.digest_words.launches, ecrecover.recover.launches)
        run = runner.run_height(h, schedule)
        check_height(committee, run)
        assert tq.digest_words.launches > before[0] and ecrecover.recover.launches > before[1]
    assert metrics.get_counter(("go-ibft", "resilient", "certify_fallback")) == 0
    assert metrics.get_counter(("go-ibft", "resilient", "drain_faults")) == 0
    assert metrics.get_counter(("go-ibft", "breaker", "demote")) == 0
    assert verifier.breaker.level == 0


def _certify_case(n, v, seed, device):
    """Seeded certify inputs on ``device``: members, outsiders, failed and
    wrong recoveries, dead lanes, spam (the last 16 lanes repeat the first
    16), a table whose rows 1..4 copy row 0 (each with its own power) and
    powers up to 2**31 - 1, so a phase's power passes 2**31."""
    rng = np.random.default_rng(seed)
    table = rng.integers(0, 2**32, size=(v, 5), dtype=np.uint32)
    table[1:5] = table[0]
    powers = rng.integers(1, 2**31, size=v)
    claimed = table[rng.integers(0, v, size=n)]
    outsider = rng.random(n) < 0.1
    claimed[outsider] = rng.integers(0, 2**32, size=(int(outsider.sum()), 5), dtype=np.uint32)
    claimed[n - 16:] = claimed[:16]
    addr = claimed.copy()
    addr[rng.random(n) < 0.05, 2] ^= np.uint32(1)
    ok, live = rng.random(n) < 0.9, rng.random(n) < 0.95
    words = [torch.from_numpy(a.view(np.int32)).to(device) for a in (addr, claimed, table)]
    flags = [torch.from_numpy(a).to(device) for a in (ok, live)]
    halves = [torch.from_numpy(a.astype(np.int32)).to(device) for a in (powers & 0xFFFF, powers >> 16)]
    return (words[0], flags[0], words[1], flags[1], words[2], *halves), int(powers[:v].sum())


@pytest.mark.cuda
@pytest.mark.parametrize("lanes", [8, 128, 2048])
@pytest.mark.parametrize("rows", [8, 128, 512, 2048])
def test_certify_lanes_matches_plain_at_every_bucket(cuda_device, lanes, rows):
    """``certify_lanes`` at every lane and table bucket of the verifier
    (two phases of ``lanes`` each, as ``certify_round`` packs them; one
    phase; the mask alone), the worst bucket 2 x 2,048 x 2,048 included,
    against its plain version on the same card; thresholds at 0, 1, the
    whole table's power and past it, some with ``thr_hi`` >= 2**15, one as
    0-d tensors on the card."""
    args, total = _certify_case(2 * lanes, rows, lanes + rows, cuda_device)
    on_card = (torch.tensor(7, dtype=torch.int32, device=cuda_device),
               torch.tensor(1, dtype=torch.int32, device=cuda_device))
    cases = [([], None), ([(1, 0)], None), ([(total & 0xFFFF, total >> 16), on_card], lanes),
             ([(0, 0), ((total + 1) & 0xFFFF, (total + 1) >> 16)], lanes - 3)]
    for thresholds, split in cases:
        before = certify_lanes.certify.launches
        ours = certify_lanes.certify(*args, thresholds, split)
        torch.cuda.synchronize()
        assert certify_lanes.certify.launches == before + 1
        ref = certify_lanes.certify_plain(*args, thresholds, split)
        for a, b in zip(ours, ref):
            assert torch.equal(a, b), (thresholds, split)


@pytest.mark.cuda
def test_certify_round_on_card_launches_each_kernel_once(cuda_device):
    rnd = build_signed_round(16, corrupt_frac=0.25, seed=4)
    src = ECDSABackend.static_validators({m.sender: 1 for m in rnd.prepares})
    card = DeviceBatchVerifier(src)
    card.certify_round(rnd.prepares, rnd.proposal_hash, rnd.seals, rnd.height)  # tables uploaded
    counts = (tq.digest_words, ecrecover.recover, certify_lanes.certify, tk.keccak_f, tk.keccak256_blocks)
    before = [fn.launches for fn in counts]
    ours = card.certify_round(rnd.prepares, rnd.proposal_hash, rnd.seals, rnd.height)
    assert [fn.launches - b for fn, b in zip(counts, before)] == [1, 1, 1, 0, 0]
    assert np.array_equal(ours[0], rnd.expected_prepare_mask)
    assert np.array_equal(ours[2], rnd.expected_seal_mask)


@pytest.mark.cuda
def test_certify_launcher_refuses_what_it_does_not_take(cuda_device):
    args, _ = _certify_case(32, 8, 1, cuda_device)
    addr, ok, claimed, live, table, plo, phi = args
    with pytest.raises(ValueError):
        certify_lanes.launch(*(t.cpu() for t in args), [(1, 0)])
    with pytest.raises(ValueError):
        certify_lanes.launch(addr, ok, claimed, live.cpu(), table)  # two devices
    with pytest.raises(ValueError):
        certify_lanes.launch(addr, ok, claimed, live, table, plo, phi,
                             [(torch.tensor(1, dtype=torch.int32), 0)])  # a threshold on the CPU
    with pytest.raises(ValueError):
        certify_lanes.launch(addr.t().contiguous().t(), ok, claimed, live, table)  # not contiguous
    with pytest.raises(TypeError):
        certify_lanes.launch(addr, ok.to(torch.uint8), claimed, live, table)
    with pytest.raises(ValueError):
        certify_lanes.launch(addr, ok, claimed[:31], live, table)
    with pytest.raises(ValueError):
        certify_lanes.launch(addr, ok, claimed, live, table, plo[:7], phi, [(1, 0)])
    before = certify_lanes.certify.launches
    mask, reached, lo, hi = certify_lanes.certify(addr[:0], ok[:0], claimed[:0], live[:0], table, plo, phi,
                                                  [(0, 0), (1, 0)])
    assert certify_lanes.certify.launches == before  # no lane, no launch
    assert mask.shape == (0,) and reached.tolist() == [True, False] and lo.tolist() == hi.tolist() == [0, 0]


def _edge_case(n, v, seed, device, dup=(0, 1)):
    """Seeded certify inputs of any size (``_certify_case`` needs 16 lanes
    or more): members, outsiders, failed recoveries, dead lanes, the first
    lane repeated last, table rows ``dup`` equal, each with its own power,
    powers up to 2**31 - 1."""
    rng = np.random.default_rng(seed)
    table = rng.integers(0, 2**32, size=(v, 5), dtype=np.uint32)
    if v > max(dup):
        table[list(dup)] = table[dup[0]]
    powers = rng.integers(1, 2**31, size=v)
    claimed = table[rng.integers(0, v, size=n)]
    claimed[rng.random(n) < 0.1] ^= np.uint32(1 << 9)
    if n > 1:
        claimed[-1] = claimed[0]
    addr = claimed.copy()
    addr[rng.random(n) < 0.05, 4] ^= np.uint32(1)
    ok, live = rng.random(n) < 0.9, rng.random(n) < 0.95
    words = [torch.from_numpy(a.view(np.int32)).to(device) for a in (addr, claimed, table)]
    flags = [torch.from_numpy(a).to(device) for a in (ok, live)]
    halves = [torch.from_numpy(a.astype(np.int32)).to(device) for a in (powers & 0xFFFF, powers >> 16)]
    return (words[0], flags[0], words[1], flags[1], words[2], *halves)


# The cluster's edges: (lanes, rows, split) with two phases split there, or
# None for one phase.  A phase with fewer lanes than the cluster's 8 blocks,
# one lane, a split at 0 and at n (an empty phase), a table past one
# 2,048-row tile, and a row repeated with power across the table.
CLUSTER_EDGES = {
    "fewer_lanes_than_blocks": (10, 64, 3),
    "one_lane": (1, 8, None),
    "one_lane_two_phases": (1, 8, 1),
    "split_at_zero": (40, 128, 0),
    "split_at_n": (40, 128, 40),
    "rows_2049": (96, 2049, 48),
    "row_repeated_with_power": (64, 512, 30),
}


@pytest.mark.cuda
@pytest.mark.parametrize("edge", list(CLUSTER_EDGES))
def test_certify_lanes_matches_plain_at_the_cluster_edges(cuda_device, edge):
    n, rows, split = CLUSTER_EDGES[edge]
    dup = (0, rows - 1) if edge == "row_repeated_with_power" else (0, 1)
    args = _edge_case(n, rows, n + rows, cuda_device, dup=dup)
    plain = certify_lanes.certify_plain(*args, [(1, 0)] * (1 if split is None else 2), split)
    gots = [int(h) * 65536 + int(lo) for lo, h in zip(plain[2].tolist(), plain[3].tolist())]
    cases = [([], None)] + [([((g + d) & 0xFFFF, (g + d) >> 16) for g in gots], split) for d in (-1, 0, 1)]
    for thresholds, at in cases:
        before = certify_lanes.certify.launches
        ours = certify_lanes.certify(*args, thresholds, at)
        torch.cuda.synchronize()
        assert certify_lanes.certify.launches == before + 1
        ref = certify_lanes.certify_plain(*args, thresholds, at)
        for a, b in zip(ours, ref):
            assert torch.equal(a, b), (edge, thresholds, at)


@pytest.mark.cuda
def test_mesh_certify_on_the_card_launches_only_the_kernels(cuda_device, monkeypatch):
    """``mesh_quorum_certify`` / ``mesh_seal_quorum_certify`` over ``[cuda:0]
    * 4`` (vp 1 and 2) and a ``MeshBatchVerifier`` drain: on a card tensor
    neither reaches ``membership_eq``, ``claimed_checks``, ``power_reduce``,
    ``torch.any`` or ``torch.where`` (each patched to record such a call);
    a sharded certify is a digest (envelopes) and a recovery launch a shard
    and one ``certify_lanes`` launch, a drain one ``certify_lanes`` launch a
    shard; the results equal one device's."""
    from go_ibft_tpu_torch.parallel import make_mesh, mesh_quorum_certify, mesh_seal_quorum_certify
    from go_ibft_tpu_torch.verify import MeshBatchVerifier

    w = build_round_workload(100, corrupt_frac=0.3, seed=5, pad_lanes=128)
    a = convert.round_args(w, device=cuda_device)
    tail = (a[14], a[15], int(a[16]), int(a[17]))
    q_args = (a[0], a[1], a[2], a[3], a[4], a[5], a[13], a[6]) + tail
    s_args = (a[7], a[8], a[9], a[10], a[11], a[13], a[12]) + tail
    want = [[x.cpu() for x in tq.quorum_certify(*q_args)], [x.cpu() for x in tq.seal_quorum_certify(*s_args)]]
    on_card = []

    def watch(name, fn):
        def wrapped(*args, **kw):
            if any(isinstance(t, torch.Tensor) and t.is_cuda for t in (*args, *kw.values())):
                on_card.append(name)
            return fn(*args, **kw)
        return wrapped

    for name in ("membership_eq", "claimed_checks", "power_reduce"):
        monkeypatch.setattr(tq, name, watch(name, getattr(tq, name)))
    monkeypatch.setattr(torch, "any", watch("torch.any", torch.any))
    monkeypatch.setattr(torch, "where", watch("torch.where", torch.where))
    monkeypatch.setattr(torch.Tensor, "any", watch("Tensor.any", torch.Tensor.any))
    counters = (tq.digest_words, ecrecover.recover, certify_lanes.certify)
    for vp in (1, 2):
        mesh = make_mesh(4, vp=vp, devices=[cuda_device] * 4)
        dp = mesh.shape["dp"]
        for fn, args, ref, digests in ((mesh_quorum_certify, q_args, want[0], dp),
                                       (mesh_seal_quorum_certify, s_args, want[1], 0)):
            before = [c.launches for c in counters]
            got = [x.cpu() for x in fn(mesh)(*args)]
            assert [c.launches - b for c, b in zip(counters, before)] == [digests, dp, 1]
            for g, x in zip(got, ref):
                assert torch.equal(g, x)
    rnd = build_signed_round(100, corrupt_frac=0.3, seed=0)
    src = ECDSABackend.static_validators({m.sender: 1 for m in rnd.prepares})
    mesh_v = MeshBatchVerifier(src, devices=[cuda_device] * 4)
    before = [c.launches for c in counters]
    mask = mesh_v.verify_senders(rnd.prepares)
    assert [c.launches - b for c, b in zip(counters, before)] == [4, 4, 4]
    assert on_card == []
    np.testing.assert_array_equal(mask, rnd.expected_prepare_mask)


# Modules the walk below must reach: the chain layer, the chaos tools, the
# host tracing tools and the speculator, besides everything else.
CHAIN_SLICE_MODULES = (
    "go_ibft_tpu_torch.chain", "go_ibft_tpu_torch.chain.runner", "go_ibft_tpu_torch.chain.sync",
    "go_ibft_tpu_torch.chain.wal", "go_ibft_tpu_torch.chaos", "go_ibft_tpu_torch.chaos.injector",
    "go_ibft_tpu_torch.chaos.wrappers", "go_ibft_tpu_torch.obs.clock", "go_ibft_tpu_torch.obs.export",
    "go_ibft_tpu_torch.obs.timeline", "go_ibft_tpu_torch.obs.metrics_export", "go_ibft_tpu_torch.obs.httpd",
    "go_ibft_tpu_torch.verify.speculate", "go_ibft_tpu_torch.bench.chain",
)


# The BLS slice's modules.
BLS_SLICE_MODULES = (
    "go_ibft_tpu_torch.crypto.bls", "go_ibft_tpu_torch.crypto.bls_backend",
    "go_ibft_tpu_torch.crypto.quorum_cert", "go_ibft_tpu_torch.ops.bls_fp", "go_ibft_tpu_torch.ops.bls12_381",
    "go_ibft_tpu_torch.ops.bls_kernels", "go_ibft_tpu_torch.verify.bls", "go_ibft_tpu_torch.verify.aggregate",
    "go_ibft_tpu_torch.bench.bls_workload", "go_ibft_tpu_torch.bench.bls_chain", "go_ibft_tpu_torch.net",
    "go_ibft_tpu_torch.net.aggtree", "go_ibft_tpu_torch.ops.bls_schedule", "go_ibft_tpu_torch.bench.bls_variants",
)


# The serving slice's modules: the multi-tenant scheduler, proof serving,
# the light client and the proof API.
SERVING_SLICE_MODULES = (
    "go_ibft_tpu_torch.sched", "go_ibft_tpu_torch.sched.dispatch", "go_ibft_tpu_torch.sched.scheduler",
    "go_ibft_tpu_torch.serve", "go_ibft_tpu_torch.serve.proof", "go_ibft_tpu_torch.serve.cache",
    "go_ibft_tpu_torch.serve.server", "go_ibft_tpu_torch.lightsync", "go_ibft_tpu_torch.lightsync.commitment",
    "go_ibft_tpu_torch.lightsync.checkpoint", "go_ibft_tpu_torch.lightsync.client", "go_ibft_tpu_torch.node",
    "go_ibft_tpu_torch.node.proof_api", "go_ibft_tpu_torch.bench.serving",
)


# The cluster slice's modules: the device mesh, the lock-step transport,
# the cluster simulation and the gates.
CLUSTER_SLICE_MODULES = (
    "go_ibft_tpu_torch.parallel", "go_ibft_tpu_torch.parallel.mesh", "go_ibft_tpu_torch.verify.mesh_batch",
    "go_ibft_tpu_torch.net.ici", "go_ibft_tpu_torch.sim", "go_ibft_tpu_torch.sim.backend",
    "go_ibft_tpu_torch.sim.chaos", "go_ibft_tpu_torch.sim.invariants", "go_ibft_tpu_torch.sim.adversary",
    "go_ibft_tpu_torch.sim.cluster", "go_ibft_tpu_torch.obs.gates", "go_ibft_tpu_torch.bench.cluster",
)


# The deployment slice's modules: the boot layer, the validator process,
# its gossip transport, the fleet harness with its chaos clients, the
# device profiler, the evidence capture and the card probe.
DEPLOY_SLICE_MODULES = (
    "go_ibft_tpu_torch.boot", "go_ibft_tpu_torch.boot.__main__", "go_ibft_tpu_torch.boot.aot",
    "go_ibft_tpu_torch.boot.registry", "go_ibft_tpu_torch.boot.restart", "go_ibft_tpu_torch.boot.warmstart",
    "go_ibft_tpu_torch.node.node", "go_ibft_tpu_torch.node.config", "go_ibft_tpu_torch.node.__main__",
    "go_ibft_tpu_torch.net.grpc_transport", "go_ibft_tpu_torch.sim.fleet", "go_ibft_tpu_torch.chaos.clients",
    "go_ibft_tpu_torch.obs.devprof", "go_ibft_tpu_torch.obs.evidence", "go_ibft_tpu_torch.utils.probe",
    "go_ibft_tpu_torch.utils.buildcache", "go_ibft_tpu_torch.bench.evidence",
)


# The certify slice's module: the kernel's launcher and its plain version.
CERTIFY_SLICE_MODULES = ("go_ibft_tpu_torch.ops.certify_lanes", "go_ibft_tpu_torch.ops.quorum")


# The verification slice's modules: the k1*G + k2*Q kernel's launchers and
# their plain versions, its lane builder and its parts timed on the card.
ECVERIFY_SLICE_MODULES = ("go_ibft_tpu_torch.ops.ecverify", "go_ibft_tpu_torch.ops.secp256k1",
                          "go_ibft_tpu_torch.bench.lanes", "go_ibft_tpu_torch.bench.ecmul2_variants")


def test_port_imports_nothing_of_jax():
    """A fresh interpreter where ``import jax`` fails imports every module
    of ``go_ibft_tpu_torch``, the chain, BLS, serving, cluster, deployment,
    certify and verification slices' among them; no ``go_ibft_tpu`` module
    gets loaded."""
    root = Path(__file__).resolve().parent.parent
    code = """
import importlib, pkgutil, sys
sys.modules["jax"] = None
import go_ibft_tpu_torch
names = [m.name for m in pkgutil.walk_packages(go_ibft_tpu_torch.__path__, "go_ibft_tpu_torch.")]
for name in names:
    importlib.import_module(name)
leaked = sorted(k for k in sys.modules if k == "go_ibft_tpu" or k.startswith("go_ibft_tpu."))
assert not leaked, leaked
assert sys.modules["jax"] is None
print(" ".join(names))
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    names = set(out.stdout.split())
    assert len(names) >= 50
    assert set(CHAIN_SLICE_MODULES) <= names, set(CHAIN_SLICE_MODULES) - names
    assert set(BLS_SLICE_MODULES) <= names, set(BLS_SLICE_MODULES) - names
    assert set(SERVING_SLICE_MODULES) <= names, set(SERVING_SLICE_MODULES) - names
    assert set(CLUSTER_SLICE_MODULES) <= names, set(CLUSTER_SLICE_MODULES) - names
    assert set(DEPLOY_SLICE_MODULES) <= names, set(DEPLOY_SLICE_MODULES) - names
    assert set(CERTIFY_SLICE_MODULES) <= names, set(CERTIFY_SLICE_MODULES) - names
    assert set(ECVERIFY_SLICE_MODULES) <= names, set(ECVERIFY_SLICE_MODULES) - names


def test_every_bound_entry_point_is_in_its_source():
    """Each C entry point ``_build.SIGNATURES`` binds is defined as an
    ``extern "C"`` function in its ``csrc/<name>.cu`` with as many
    parameters as it binds (the kernels' launchers, not the ``_host``
    twins the CPU tests build)."""
    import re

    from go_ibft_tpu_torch import _build

    for name, fns in _build.SIGNATURES.items():
        src = (_build.CSRC / f"{name}.cu").read_text()
        defined = {fn for fn in re.findall(r'extern "C" int (\w+)\(', src) if not fn.endswith("_host")}
        assert set(fns) <= defined, (name, set(fns) - defined)
        for fn, (argtypes, _) in fns.items():
            params = re.search(r'extern "C" int ' + fn + r"\(([^)]*)\)", src).group(1)
            assert len([p for p in params.split(",") if p.strip()]) == len(argtypes), fn


@pytest.fixture(scope="module")
def bls_inputs():
    """Seeded BLS inputs: a 3-signer aggregate lane (valid), a lane of
    pool points (invalid), and 7 groups of pool points with a cancelling
    pair, duplicates, negations and dead lanes."""
    from go_ibft_tpu_torch.crypto import bls as hbls
    from go_ibft_tpu_torch.ops import bls12_381 as ops

    rng = np.random.default_rng(3)
    pool2 = [hbls.g2_mul(k, hbls.G2_GEN) for k in range(1, 9)]
    pool1 = [hbls.g1_mul(k, hbls.G1_GEN) for k in range(1, 9)]
    msg = b"\x11" * 32
    keys = [hbls.BLSPrivateKey(k) for k in (3, 5, 7)]
    s = hbls.aggregate_signatures([k.sign(msg) for k in keys])
    pk = hbls.aggregate_pubkeys([k.pubkey for k in keys])
    lanes_s, lanes_h, lanes_pk = [s, pool2[1]], [hbls.hash_to_g2(msg), pool2[2]], [pk, pool1[3]]
    q = torch.from_numpy(np.stack([ops.pack_g2_points(lanes_s), ops.pack_g2_points(lanes_h)]))
    p = torch.from_numpy(np.stack([ops.pack_g1_points([hbls.G1_GEN] * 2),
                                   ops.pack_g1_points([hbls.g1_neg(x) for x in lanes_pk])]))
    idx = rng.integers(0, 8, (7, 9))
    g2 = ops.pack_g2_points(pool2)[idx]
    g2[0, 1] = ops.pack_g2_points([hbls.g2_neg(pool2[int(idx[0, 0])])])[0]
    live = torch.from_numpy(rng.random((7, 9)) > 0.2)
    live[0, :2] = True
    live[1] = False
    g1 = ops.pack_g1_points(pool1)[idx]
    return q, p, torch.from_numpy(np.ascontiguousarray(g2)), torch.from_numpy(np.ascontiguousarray(g1)), live


@pytest.mark.cuda
def test_bls_kernels_match_plain_and_the_oracle(cuda_device, bls_inputs):
    """The three pairing kernels, bit-exact against their plain versions;
    the valid lane verifies, the pool lane does not."""
    from go_ibft_tpu_torch.ops import bls12_381 as ops
    from go_ibft_tpu_torch.ops import bls_kernels as bk

    q, p, g2, g1, live = bls_inputs
    before = (bk.merge.launches, bk.miller.launches, bk.final_exp.launches)
    for pts in (g2, g1):
        for neg_y in (False, True):
            out, inf = bk.merge(pts.to(cuda_device), live.to(cuda_device), neg_y)
            torch.cuda.synchronize()
            ref, rinf = ops.merge_plain(pts, live, neg_y)
            assert torch.equal(out.cpu(), ref) and torch.equal(inf.cpu(), rinf)
    f = bk.miller(q.to(cuda_device), p.to(cuda_device))
    torch.cuda.synchronize()
    assert torch.equal(f.cpu(), ops.miller_plain(q, p))
    gate = torch.ones(2, dtype=torch.bool)
    ok, res = bk.final_exp(f, gate.to(cuda_device))
    torch.cuda.synchronize()
    pok, pres = ops.final_exp_plain(f.cpu(), gate)
    assert torch.equal(ok.cpu(), pok) and torch.equal(res.cpu(), pres)
    assert ok.cpu().tolist() == [True, False]
    assert (bk.merge.launches, bk.miller.launches, bk.final_exp.launches) == (
        before[0] + 4, before[1] + 1, before[2] + 1)


@pytest.fixture(scope="module")
def bls_pairing_lanes():
    """64 seeded pairing lanes and their plain values, computed once on the
    card: lanes 0 and 3 a valid aggregate, pool points elsewhere, lane 63 a
    (0, 0) G2 point on side 0 (the merge of an all-dead group).  The final
    exponentiation's input is the Miller values with lane 1 zeroed, lane 3's
    gate 0."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    from go_ibft_tpu_torch.crypto import bls as hbls
    from go_ibft_tpu_torch.ops import bls12_381 as ops

    dev = torch.device("cuda")
    rng = np.random.default_rng(9)
    pool2 = [hbls.g2_mul(k, hbls.G2_GEN) for k in range(1, 9)]
    pool1 = [hbls.g1_mul(k, hbls.G1_GEN) for k in range(1, 9)]
    msg = b"\x44" * 32
    keys = [hbls.BLSPrivateKey(k) for k in (2, 6)]
    s = hbls.aggregate_signatures([k.sign(msg) for k in keys])
    pk = hbls.aggregate_pubkeys([k.pubkey for k in keys])
    lanes_s = [pool2[int(i)] for i in rng.integers(0, 8, 64)]
    lanes_h = [pool2[int(i)] for i in rng.integers(0, 8, 64)]
    lanes_pk = [pool1[int(i)] for i in rng.integers(0, 8, 64)]
    for i in (0, 3):
        lanes_s[i], lanes_h[i], lanes_pk[i] = s, hbls.hash_to_g2(msg), pk
    lanes_s[63] = None
    q = torch.from_numpy(np.stack([ops.pack_g2_points(lanes_s), ops.pack_g2_points(lanes_h)])).to(dev)
    p = torch.from_numpy(np.stack([ops.pack_g1_points([hbls.G1_GEN] * 64),
                                   ops.pack_g1_points([hbls.g1_neg(x) for x in lanes_pk])])).to(dev)
    f = ops.miller_plain(q, p)
    f_in = f.clone()
    f_in[1] = 0
    gate = torch.ones(64, dtype=torch.bool, device=dev)
    gate[3] = False
    ok, res = ops.final_exp_plain(f_in, gate)
    return q, p, f, f_in, gate, ok, res


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 2, 33, 64])
def test_bls_pairing_kernels_match_plain_at_lane_counts(cuda_device, bls_pairing_lanes, n):
    """``bls_miller`` and ``bls_final_exp`` (a block a lane) bit-exact against
    their plain versions on the leading n lanes, one launch each."""
    from go_ibft_tpu_torch.ops import bls_kernels as bk

    q, p, f_plain, f_in, gate, pok, pres = bls_pairing_lanes
    before = (bk.miller.launches, bk.final_exp.launches)
    f = bk.miller(q[:, :n].contiguous(), p[:, :n].contiguous())
    ok, res = bk.final_exp(f_in[:n].contiguous(), gate[:n].contiguous())
    torch.cuda.synchronize()
    assert torch.equal(f, f_plain[:n])
    assert torch.equal(ok, pok[:n]) and torch.equal(res, pres[:n])
    assert (bk.miller.launches, bk.final_exp.launches) == (before[0] + 1, before[1] + 1)


@pytest.mark.cuda
def test_bls_pairing_kernels_on_degenerate_lanes(cuda_device, bls_pairing_lanes):
    """A zero Miller value gives zeros and no verdict, a gate of 0 masks a
    lane whose result is one, a (0, 0) G2 point gives the plain version's
    words; the verdicts are the plain version's, the valid lane's true.
    (Pool lanes a G2, b G2, c G1 verify where a = b c, as lane 11 does.)"""
    from go_ibft_tpu_torch.crypto import bls as hbls
    from go_ibft_tpu_torch.ops import bls12_381 as ops
    from go_ibft_tpu_torch.ops import bls_kernels as bk

    q, p, f_plain, f_in, gate, pok, pres = bls_pairing_lanes
    f = bk.miller(q, p)
    ok, res = bk.final_exp(f_in, gate)
    torch.cuda.synchronize()
    assert torch.equal(f[63], f_plain[63])
    assert not res[1].any() and torch.equal(res, pres)
    one = torch.from_numpy(ops.pack_f12([hbls.F12_ONE])[0]).to(cuda_device)
    assert torch.equal(res[3], one) and torch.equal(res[0], one)
    assert torch.equal(ok, pok) and bool(ok[0]) and not bool(ok[1]) and not bool(ok[3])


@pytest.mark.cuda
def test_bls_aggregate_check_on_card_without_fallback(cuda_device):
    """``aggregate_check``'s device route on the card: four kernel launches
    and the host oracle's verdicts, a bad seal included."""
    from go_ibft_tpu_torch.bench import build_bls_round_workload
    from go_ibft_tpu_torch.ops import bls_kernels as bk
    from go_ibft_tpu_torch.verify.bls import aggregate_check

    w = build_bls_round_workload(8, seed=1, time_host=False)
    before = bk.final_exp.launches
    assert aggregate_check(w.message, list(w.sigs), list(w.pubkeys), device=True)
    sigs = list(w.sigs)
    sigs[3] = sigs[4]
    assert not aggregate_check(w.message, sigs, list(w.pubkeys), device=True)
    assert bk.final_exp.launches == before + 2


@pytest.mark.cuda
@pytest.mark.parametrize("coords", [2, 4])
@pytest.mark.parametrize("groups, v", [(1, 1), (7, 3), (1, 129), (3, 129), (17, 8), (2, 1024)])
def test_bls_merge_odd_sizes_and_partial_blocks_match_plain(cuda_device, coords, groups, v):
    """The merge at sizes off the powers of two (one past a region's or a
    block's edge), 17 groups of 8 (a partial last block of small groups),
    a group whose live points P, Q and -(P + Q) lie apart, a group with one
    live point, dead lanes and duplicates: bit-exact against the plain
    version, y negated too."""
    from go_ibft_tpu_torch.crypto import bls as hbls
    from go_ibft_tpu_torch.ops import bls12_381 as ops
    from go_ibft_tpu_torch.ops import bls_kernels as bk

    rng = np.random.default_rng(groups * 1000 + v + coords)
    gen, add, neg = ((hbls.G1_GEN, hbls.g1_add, hbls.g1_neg) if coords == 2
                     else (hbls.G2_GEN, hbls.g2_add, hbls.g2_neg))
    pack = ops.pack_g1_points if coords == 2 else ops.pack_g2_points
    pool = [gen]
    for _ in range(15):
        pool.append(add(pool[-1], gen))
    pts = pack(pool + [neg(p) for p in pool])[rng.integers(0, 32, (groups, v))]
    live = rng.random((groups, v)) > 0.2
    if groups > 2 and v >= 3:
        trio = [pool[3], pool[9], neg(add(pool[3], pool[9]))]
        live[1] = False
        for at, pt in zip((0, v // 2, v - 1), trio):
            pts[1, at] = pack([pt])[0]
            live[1, at] = True
        live[2] = False
        live[2, v - 1] = True
    pts, live = torch.from_numpy(np.ascontiguousarray(pts)), torch.from_numpy(live)
    for neg_y in (False, True):
        out, inf = bk.merge(pts.to(cuda_device), live.to(cuda_device), neg_y)
        torch.cuda.synchronize()
        ref, rinf = ops.merge_plain(pts, live, neg_y)
        assert torch.equal(out.cpu(), ref) and torch.equal(inf.cpu(), rinf)
        if groups > 2 and v >= 3:
            assert bool(inf[1]) and not bool(inf[2])


@pytest.mark.cuda
@pytest.mark.parametrize("coords", [2, 4])
def test_bls_merge_sparse_groups_past_the_region_match_plain(cuda_device, coords):
    """Groups of 1,030 points (more than a block's 512-point region) whose
    live points are too few for a pair in a fill window: P, Q and -(P + Q)
    at 0, 512 and 1,023, two points at 0 and 1,023, one at 1,029, none."""
    from go_ibft_tpu_torch.crypto import bls as hbls
    from go_ibft_tpu_torch.ops import bls12_381 as ops
    from go_ibft_tpu_torch.ops import bls_kernels as bk

    gen, add, neg = ((hbls.G1_GEN, hbls.g1_add, hbls.g1_neg) if coords == 2
                     else (hbls.G2_GEN, hbls.g2_add, hbls.g2_neg))
    pack = ops.pack_g1_points if coords == 2 else ops.pack_g2_points
    p, q = add(gen, gen), add(gen, add(gen, gen))
    cases = [{0: p, 512: q, 1023: neg(add(p, q))}, {0: p, 1023: q}, {1029: q}, {}]
    pts = torch.zeros((len(cases), 1030, coords, 12), dtype=torch.int32)
    live = torch.zeros((len(cases), 1030), dtype=torch.bool)
    for g, case in enumerate(cases):
        for at, pt in case.items():
            pts[g, at] = torch.from_numpy(pack([pt])[0])
            live[g, at] = True
    out, inf = bk.merge(pts.to(cuda_device), live.to(cuda_device))
    torch.cuda.synchronize()
    ref, rinf = ops.merge_plain(pts, live)
    assert torch.equal(out.cpu(), ref) and torch.equal(inf.cpu(), rinf)
    assert inf.cpu().tolist() == [True, False, False, True]


@pytest.mark.cuda
def test_bls_merge_entry_refuses_a_bad_launch_and_the_wrapper_raises(cuda_device):
    """The C entry returns the CUDA error of a launch it refuses (here a
    coordinate count that is neither G1's nor G2's), and the launchers'
    check raises on it: nothing runs, nothing falls back."""
    from go_ibft_tpu_torch import _build
    from go_ibft_tpu_torch.ops import bls_kernels as bk

    lib = _build.load("bls12_381")
    pts = torch.zeros((1, 2, 3, 12), dtype=torch.int32, device=cuda_device)
    live = torch.ones((1, 2), dtype=torch.bool, device=cuda_device)
    out = torch.zeros((1, 3, 12), dtype=torch.int32, device=cuda_device)
    inf = torch.zeros(1, dtype=torch.bool, device=cuda_device)
    rc = lib.bls_merge(pts.data_ptr(), live.data_ptr(), 1, 2, 3, 0, out.data_ptr(), inf.data_ptr(),
                       torch.cuda.current_stream(cuda_device).cuda_stream)
    assert rc != 0
    with pytest.raises(RuntimeError, match="bls_merge launch failed"):
        bk._raise_on(rc, "bls_merge")


@pytest.mark.cuda
def test_bls_launchers_refuse_cpu_and_malformed_tensors(cuda_device, bls_inputs):
    from go_ibft_tpu_torch.ops import bls_kernels as bk

    q, p, g2, _, live = bls_inputs
    with pytest.raises(ValueError):
        bk.launch_merge(g2, live)  # CPU tensors
    with pytest.raises(ValueError):
        bk.launch_merge(g2.to(cuda_device), live[:, :3].to(cuda_device))
    with pytest.raises(ValueError):
        bk.launch_miller(q.to(cuda_device), p[:, :1].to(cuda_device))
    with pytest.raises(ValueError):
        bk.launch_final_exp(torch.zeros(2, 12, 11, dtype=torch.int32, device=cuda_device),
                            torch.ones(2, dtype=torch.bool, device=cuda_device))


def test_port_chaos_loads_no_clients_module():
    """``go_ibft_tpu_torch.chaos`` loads no ``clients`` module but its own
    (the name is from before the port had one): importing it, with JAX
    blocked, loads the port's serve-plane clients and no other."""
    root = Path(__file__).resolve().parent.parent
    code = """
import sys
sys.modules["jax"] = None
import go_ibft_tpu_torch.chaos
print(sorted(k for k in sys.modules if k.endswith(".clients") or k.endswith("chaos.clients")))
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "['go_ibft_tpu_torch.chaos.clients']"
    assert (root / "go_ibft_tpu_torch" / "chaos" / "clients.py").exists()


@pytest.mark.cuda
def test_three_threads_through_one_verifier_on_card(cuda_device):
    """Three threads, each with its own height's 16-validator round (30 %
    corrupted), call ``verify_senders`` and ``verify_seal_lanes`` 50 times
    through one ``DeviceBatchVerifier`` whose per-height caches hold two
    heights: every mask equals the expected mask, and the masks equal the
    host verifier's."""
    from go_ibft_tpu_torch.bench.chain import concurrent_drains
    from go_ibft_tpu_torch.verify import HostBatchVerifier

    rounds = [build_signed_round(16, height=h, corrupt_frac=0.3, seed=h) for h in (1, 2, 3)]
    powers = {rnd.height: {m.sender: 1 for m in rnd.prepares} for rnd in rounds}
    host = HostBatchVerifier(lambda h: powers[h])
    for rnd in rounds:
        assert np.array_equal(host.verify_senders(rnd.prepares), rnd.expected_prepare_mask)
        lanes = [(rnd.proposal_hash, seal) for seal in rnd.seals]
        assert np.array_equal(host.verify_seal_lanes(lanes, rnd.height), rnd.expected_seal_mask)
    card = DeviceBatchVerifier(lambda h: powers[h], cache_heights=2)
    before = ecrecover.recover.launches
    assert concurrent_drains(card, rounds) == 300
    assert ecrecover.recover.launches - before == 300  # one recovery launch a call


def _sched_drains(route_device):
    """Three tenants (one flooding corrupt seals, two sharing a proposal
    hash) drain concurrently through one scheduler on ``route_device``'s
    device route: every verdict, and the dispatcher's route counts."""
    import threading

    from go_ibft_tpu_torch.crypto import PrivateKey
    from go_ibft_tpu_torch.sched import TenantScheduler

    def src(seed, n):
        keys = [PrivateKey.from_seed(b"bench-%d-%d" % (seed, i)) for i in range(n)]
        return ECDSABackend.static_validators({k.address: 1 for k in keys})

    rounds = {"a": (build_signed_round(4, seed=11), src(11, 4)),
              "b": (build_signed_round(4, seed=22, corrupt_frac=0.5), src(22, 4)),
              "c": (build_signed_round(8, seed=202, corrupt_frac=0.5), src(202, 8))}
    sched = TenantScheduler(window_s=0.05, route="device", torch_device=route_device)
    handles = {tid: sched.register(tid, s) for tid, (_r, s) in rounds.items()}
    out = {}

    def run(tid):
        r = rounds[tid][0]
        h = handles[tid]
        out[tid] = (h.verify_senders(r.prepares), h.verify_seal_lanes([(r.proposal_hash, x) for x in r.seals], 1))

    with sched:
        threads = [threading.Thread(target=run, args=(tid,)) for tid in rounds]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    stats = sched.stats()
    assert stats["flush_faults"] == 0 and sched._dispatcher.routes["host"] == 0
    return out, rounds


@pytest.mark.cuda
def test_scheduler_device_route_on_card_matches_its_cpu_run(cuda_device):
    """The coalesced dispatcher's device route on the card gives its CPU
    run's verdicts (the plain kernels) and the host oracle's, and launches
    the digest and recovery kernels."""
    from go_ibft_tpu_torch.verify import HostBatchVerifier

    before = (tq.digest_words.launches, ecrecover.recover.launches)
    card, rounds = _sched_drains(cuda_device)
    assert tq.digest_words.launches > before[0] and ecrecover.recover.launches > before[1]
    cpu, _ = _sched_drains("cpu")
    for tid, (r, s) in rounds.items():
        for a, b in zip(card[tid], cpu[tid]):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(card[tid][0], HostBatchVerifier(s).verify_senders(r.prepares))
        np.testing.assert_array_equal(card[tid][1], r.expected_seal_mask)


@pytest.mark.cuda
def test_checkpoint_verifier_on_card_matches_host_route(cuda_device):
    """``CheckpointVerifier(device=True)`` on the card: the host route's
    anchor for an honest skip chain, its rejection for a forged head, and
    one launch of each pairing kernel a chain."""
    from dataclasses import replace

    from go_ibft_tpu_torch.crypto import PrivateKey
    from go_ibft_tpu_torch.crypto.bls import BLSPrivateKey
    from go_ibft_tpu_torch.crypto.keccak import keccak256
    from go_ibft_tpu_torch.lightsync import CheckpointError, CheckpointRecord, Checkpointer, CheckpointVerifier
    from go_ibft_tpu_torch.ops import bls_kernels

    keys = [PrivateKey.from_seed(b"lightsync-%d" % i) for i in range(4)]
    bls = {k.address: BLSPrivateKey.from_seed(b"lightsync-bls-%d" % i) for i, k in enumerate(keys)}
    powers = {k.address: 1 for k in keys}
    ck = Checkpointer(2, lambda _h: powers, signers=bls)
    for h in range(1, 9):
        ck.on_finalize(h, keccak256(b"ls static blk %d" % h))
    pubkeys = lambda _h: {a: k.pubkey for a, k in bls.items()}  # noqa: E731
    payload = ck.wire_payload()
    before = bls_kernels.miller.launches
    card = CheckpointVerifier(pubkeys, device=True, torch_device=cuda_device).verify_chain(payload, powers)
    assert bls_kernels.miller.launches == before + 1
    host = CheckpointVerifier(pubkeys, device=False).verify_chain(payload, powers)
    assert (card.height, card.epoch, card.powers, card.lanes) == (host.height, host.epoch, host.powers, host.lanes)
    head = replace(CheckpointRecord.decode(bytes.fromhex(payload["checkpoints"][-1])),
                   chain_commitment=keccak256(b"forked chain"))
    forged = dict(payload, checkpoints=payload["checkpoints"][:-1] + [head.encode().hex()])
    for verifier in (CheckpointVerifier(pubkeys, device=True, torch_device=cuda_device),
                     CheckpointVerifier(pubkeys, device=False)):
        with pytest.raises(CheckpointError, match="epoch 4: aggregate checkpoint seal fails"):
            verifier.verify_chain(forged, powers)


@pytest.mark.cuda
def test_proof_verifier_cert_entries_on_card_match_host(cuda_device):
    """A proof whose height 2 carries an aggregate quorum certificate:
    ``ProofVerifier(device=True)`` checks it through ``verify_many`` on the
    card with the host route's report, and rejects a certificate whose seal
    signs another message, as the host route does."""
    from go_ibft_tpu_torch.chain.wal import FinalizedBlock
    from go_ibft_tpu_torch.crypto import PrivateKey
    from go_ibft_tpu_torch.crypto import ecdsa as ec
    from go_ibft_tpu_torch.crypto.backend import encode_signature, proposal_hash_of
    from go_ibft_tpu_torch.crypto.bls import BLSPrivateKey
    from go_ibft_tpu_torch.crypto.quorum_cert import AggregateQuorumCertificate, BLSCertifier
    from go_ibft_tpu_torch.messages.helpers import CommittedSeal
    from go_ibft_tpu_torch.messages.wire import Proposal
    from go_ibft_tpu_torch.ops import bls_kernels
    from go_ibft_tpu_torch.serve import ProofBuilder, ProofError, ProofVerifier
    from go_ibft_tpu_torch.verify.bls import encode_seal

    keys = [PrivateKey.from_seed(b"serve-%d" % i) for i in range(4)]
    blk = [BLSPrivateKey.from_seed(b"serve-bls-%d" % i) for i in range(4)]
    powers = {k.address: 1 for k in keys}
    pubkeys = {k.address: b.pubkey for k, b in zip(keys, blk)}
    blocks = []
    for h in (1, 2):
        proposal = Proposal(raw_proposal=b"serve block %d" % h, round=0)
        phash = proposal_hash_of(proposal)
        blocks.append(FinalizedBlock(h, proposal, [
            CommittedSeal(k.address, encode_signature(*ec.sign(k, phash))) for k in keys]))
    phash = proposal_hash_of(blocks[1].proposal)
    cert = BLSCertifier(lambda _h: powers, lambda _h: pubkeys).build(
        2, 0, phash, [CommittedSeal(k.address, encode_seal(b.sign(phash))) for k, b in zip(keys[:3], blk[:3])])
    forged = AggregateQuorumCertificate(height=2, round=0, proposal_hash=phash,
                                        agg_seal=encode_seal(blk[0].sign(b"\x01" * 32)), bitmap=cert.bitmap)

    class _Source:
        def __init__(self, chain):
            self.chain = chain

        def latest_height(self):
            return 2

        def get_blocks(self, start, end):
            return [b for b in self.chain if start <= b.height <= end]

    for c, ok in ((cert, True), (forged, False)):
        chain = [blocks[0], FinalizedBlock(2, blocks[1].proposal, [], cert=c)]
        proof = ProofBuilder(_Source(chain), lambda _h: powers).build(0, 2)
        outcomes = []
        for kw in ({"device": True, "torch_device": cuda_device}, {"device": False}):
            before = bls_kernels.miller.launches
            try:
                outcomes.append(("ok", ProofVerifier(bls_keys_for_height=lambda _h: pubkeys, **kw).verify(proof, powers)))
            except ProofError as err:
                outcomes.append(("err", str(err)))
            if kw["device"]:
                assert bls_kernels.miller.launches == before + 1
        assert outcomes[0] == outcomes[1] and (outcomes[0][0] == "ok") == ok


@pytest.mark.cuda
def test_cold_sync_on_card_launches_recovery_for_its_bridge_and_tail_seals(cuda_device):
    """``CheckpointClient`` on the card, its default: config #18's chain
    cold-synced over HTTP to height 14 (anchor 12, a bridge proof across the
    rotation at 10, a 2-height tail) launches ``secp256k1_recover`` for the
    proofs' seal lanes and one of each pairing kernel, with the host
    route's report.  The server runs on the host, so every launch is the
    client's."""
    from go_ibft_tpu_torch.bench import serving as sv
    from go_ibft_tpu_torch.lightsync import CheckpointClient
    from go_ibft_tpu_torch.node import ProofApiServer
    from go_ibft_tpu_torch.ops import bls_kernels
    from go_ibft_tpu_torch.serve import ProofBuilder, ProofCache, ProofServer

    blocks, validators, registry, ckpt, set_a, set_b = sv.checkpoint_chain()
    source = sv.ListSource(blocks)
    server = ProofServer(ProofBuilder(source, validators), ProofCache(chunk_heights=4), device=False)
    api = ProofApiServer(server, source.latest_height, checkpoints_fn=ckpt.wire_payload)
    api.start()
    try:
        before = (ecrecover.recover.launches, bls_kernels.miller.launches)
        card = CheckpointClient(api.url, registry).cold_sync(set_a, target=14)
        launched = (ecrecover.recover.launches - before[0], bls_kernels.miller.launches - before[1])
        host = CheckpointClient(api.url, registry, device=False).cold_sync(set_a, target=14)
    finally:
        api.stop()
        server.close()
    assert launched[0] >= 2 and launched[1] == 1, launched  # the bridge's and the tail's drains
    assert (card.anchor_height, card.tail_heights, card.powers) == (12, 2, set_b)
    assert card.bridge_bytes > 0 and card.tail_bytes > 0
    assert {k: v for k, v in vars(card).items()} == {k: v for k, v in vars(host).items()}


# -- the cluster slice: launches on a tensor's own card, the mesh, the tick ----


@pytest.mark.cuda
def test_launch_leaves_the_current_device_and_runs_on_the_tensors_card(cuda_device):
    """Each launcher makes its tensors' card current for the launch and
    restores the caller's: the current device is unchanged after a launch,
    and with two cards a launch on ``cuda:1`` from ``cuda:0`` (and back)
    matches the plain version."""
    from go_ibft_tpu_torch.ops import bls_kernels

    cards = [torch.device("cuda", i) for i in range(min(torch.cuda.device_count(), 2))]
    arr = build_recovery_lanes(8, seed=3).arrays(8)
    lanes = [np.ascontiguousarray(arr[k]) for k in ("zw", "r", "s", "v")]
    blocks, counts = _digest_case(8, 2, "cpu")
    for current in cards:
        for target in cards:
            with torch.cuda.device(current):
                st = _states(4, 1, target)
                assert torch.equal(keccak_f1600.launch(st).cpu(), keccak_f1600.keccak_f_plain(st.cpu()))
                got = keccak_f1600.launch_digest(blocks.to(target), counts.to(target), True)
                assert torch.equal(got.cpu(), keccak_f1600.digest_words_plain(blocks, counts))
                z, r, s, v = (torch.from_numpy(a).to(target) for a in lanes)
                out = ecrecover.launch(z, r, s, v)
                assert out[3].device == target
                pts = torch.zeros((1, 1, 2, 12), dtype=torch.int32, device=target)
                live = torch.zeros((1, 1), dtype=torch.bool, device=target)
                assert bls_kernels.launch_merge(pts, live)[1].cpu().tolist() == [True]
                torch.cuda.synchronize(target)
                assert torch.cuda.current_device() == current.index
    plain = ecrecover.recover_plain(*(torch.from_numpy(a) for a in lanes))
    assert torch.equal(out[3].cpu(), plain[3]) and torch.equal(out[2].cpu()[plain[3]], plain[2][plain[3]])


@pytest.mark.cuda
def test_mesh_over_four_shards_of_the_card_is_bit_identical_to_one_device(cuda_device):
    """``mesh_quorum_certify`` over ``[cuda:0] * 4`` (and over every card)
    gives one device's ``quorum_certify`` bit for bit, and a
    ``MeshBatchVerifier`` drain makes one recovery launch a shard with the
    single device's masks."""
    from go_ibft_tpu_torch.parallel import make_mesh, mesh_quorum_certify
    from go_ibft_tpu_torch.verify import MeshBatchVerifier

    w = build_round_workload(100, corrupt_frac=0.3, seed=5, pad_lanes=128)
    a = convert.round_args(w, device=cuda_device)
    args = (a[0], a[1], a[2], a[3], a[4], a[5], a[13], a[6], a[14], a[15], int(a[16]), int(a[17]))
    want = [x.cpu() for x in tq.quorum_certify(*args)]
    layouts = [make_mesh(4, devices=[cuda_device] * 4), make_mesh(4, vp=2, devices=[cuda_device] * 4)]
    if torch.cuda.device_count() >= 2:
        layouts.append(make_mesh(devices=[torch.device("cuda", i) for i in range(torch.cuda.device_count())]))
    for mesh in layouts:
        got = [x.cpu() for x in mesh_quorum_certify(mesh)(*args)]
        for g, x in zip(got, want):
            assert torch.equal(g, x)
    rnd = build_signed_round(100, corrupt_frac=0.3, seed=0)
    src = ECDSABackend.static_validators({m.sender: 1 for m in rnd.prepares})
    mesh_v = MeshBatchVerifier(src, devices=[cuda_device] * 4)
    before = ecrecover.recover.launches
    mask = mesh_v.verify_senders(rnd.prepares)
    assert ecrecover.recover.launches - before == 4
    np.testing.assert_array_equal(mask, DeviceBatchVerifier(src).verify_senders(rnd.prepares))


@pytest.mark.cuda
def test_hub_shard_route_launches_one_digest_per_shard_a_tick(cuda_device):
    """An ``IciLockstepTransport`` over ``[cuda:0] * 4`` in rows mode: one
    tick launches the digest kernel once a shard and hands the verifier
    the rows the host passthrough hands it."""
    from go_ibft_tpu_torch.crypto import PrivateKey
    from go_ibft_tpu_torch.messages import View
    from go_ibft_tpu_torch.net import IciLockstepTransport

    keys = [PrivateKey.from_seed(b"ici-crypto-%d" % i) for i in range(4)]
    src = ECDSABackend.static_validators({k.address: 1 for k in keys})
    rows = {}
    for label, devices in (("shards", [cuda_device] * 4), ("host", [cuda_device])):
        seen = []

        class Recording(DeviceBatchVerifier):
            def verify_sender_rows(self, height, zw, *rest):
                seen.append((height, zw.copy()))
                return super().verify_sender_rows(height, zw, *rest)

        hub = IciLockstepTransport(4, devices=devices, max_bytes=4096, verifier=Recording(src))
        for _ in range(4):
            hub.register(lambda batch: None)
        for i, k in enumerate(keys):
            hub.port(i).multicast(ECDSABackend(k, src).build_prepare_message(b"\x05" * 32, View(height=1, round=0)))
        before = tq.digest_words.launches
        hub.step()
        rows[label] = (tq.digest_words.launches - before, seen)
    assert rows["shards"][0] == 4 and rows["host"][0] == 1
    assert [h for h, _ in rows["shards"][1]] == [h for h, _ in rows["host"][1]] == [1]
    np.testing.assert_array_equal(rows["shards"][1][0][1], rows["host"][1][0][1])
    assert all(verdict for _msg, verdict in hub._verdicts.values())


@pytest.mark.cuda
def test_mesh_rung_fault_on_the_card_propagates(cuda_device, monkeypatch):
    """A fault of the mesh rung on the card reaches the caller through the
    resilient and adaptive ladders: no single-device or host rung serves
    it."""
    from go_ibft_tpu_torch.verify import AdaptiveBatchVerifier, MeshBatchVerifier, ResilientBatchVerifier
    from go_ibft_tpu_torch.verify import mesh_batch

    rnd = build_signed_round(16, seed=4)
    src = ECDSABackend.static_validators({m.sender: 1 for m in rnd.prepares})
    mesh_v = MeshBatchVerifier(src, devices=[cuda_device] * 2)

    def broken(self, lanes, tables):
        raise RuntimeError("simulated mesh launch failure")

    monkeypatch.setattr(mesh_batch.ShardedMask, "dispatch", broken)
    single = DeviceBatchVerifier(src)
    before = ecrecover.recover.launches
    ladder = ResilientBatchVerifier(single, mesh=mesh_v, mesh_cutover_lanes=1, validators_for_height=src)
    with pytest.raises(RuntimeError, match="simulated mesh"):
        ladder.verify_senders(rnd.prepares)
    adaptive = AdaptiveBatchVerifier(src, device=single, mesh=mesh_v, mesh_cutover_lanes=1)
    with pytest.raises(RuntimeError, match="simulated mesh"):
        adaptive.certify_senders(rnd.prepares, rnd.height)
    assert ecrecover.recover.launches == before


@pytest.mark.cuda
def test_boot_store_on_the_card_builds_cold_then_loads_cached(cuda_device, tmp_path):
    """The AOT store on the card: a fresh build cache compiles the digest and
    recovery sources (their programs cold, recorded to the ledger;
    ``ecmul2_base_8l`` too, whose kernel is built from the recovery's
    source), a second store on it compiles nothing (every program cached);
    each program ran its kernels, and a failed build propagates."""
    from go_ibft_tpu_torch import _build
    from go_ibft_tpu_torch.boot import aot
    from go_ibft_tpu_torch.obs import ledger
    from go_ibft_tpu_torch.utils import buildcache

    programs = ["digest_words_8l", "ecdsa_recover_8l", "round_certify_8l", "ecmul2_base_8l"]
    saved = (_build.BUILD_DIR, buildcache._enabled)
    led = ledger.enable()
    try:
        before = (tq.digest_words.launches, ecrecover.recover.launches, ecverify.ecmul2.launches)
        cold = aot.AOTStore(str(tmp_path / "cache")).ensure(programs)
        assert {p: s.status for p, s in cold.items()} == {
            "digest_words_8l": "cold", "ecdsa_recover_8l": "cold", "round_certify_8l": "cold",
            "ecmul2_base_8l": "cold"}
        assert tq.digest_words.launches - before[0] == 2 and ecrecover.recover.launches - before[1] == 2
        assert ecverify.ecmul2.launches - before[2] == 1
        events = led.snapshot()["compiles"]
        assert set(events) == {"digest_words", "ecdsa_recover", "round_certify", "ecmul2_base"}, events
        cached = aot.AOTStore(str(tmp_path / "cache")).ensure(programs)
        assert {s.status for s in cached.values()} == {"cached"}
        assert led.snapshot()["compiles"] == events
        side = aot.AOTStore(str(tmp_path / "cache")).read_sidecar("digest_words_8l")
        assert side["fingerprint"] == aot.fingerprint() and side["fingerprint"]["device_count"] >= 1
        assert aot.AOTStore(str(tmp_path / "cache")).cached_programs() == set(programs)

        def broken(names=()):
            raise RuntimeError("nvcc failed for keccak_f1600.cu")

        _build.build_all, real = broken, _build.build_all
        try:
            with pytest.raises(RuntimeError, match="nvcc failed"):
                aot.AOTStore(str(tmp_path / "other")).ensure(["digest_words_8l"])
        finally:
            _build.build_all = real
    finally:
        ledger.disable()
        _build.BUILD_DIR, buildcache._enabled = saved


class _SoloTransport:
    """A one-validator node's gossip without sockets: its multicast is its
    own delivery."""

    def __init__(self, deliver):
        self._deliver = deliver
        self.bound_port = None

    async def start(self):
        pass

    async def stop(self):
        pass

    def multicast(self, message):
        self._deliver(message)


@pytest.mark.cuda
def test_node_scheduler_on_the_device_route_on_the_card(cuda_device, tmp_path):
    """A solo validator with the node's defaults (the device route on the
    card) finalizes its heights with every flush on the card: no host-routed
    flush, no fault, the digest and recovery kernels launched."""
    import asyncio

    from go_ibft_tpu_torch.crypto import PrivateKey
    from go_ibft_tpu_torch.node import NodeConfig, ValidatorNode

    key = PrivateKey.from_seed(b"card-node")
    cfg = NodeConfig(node_id=0, key_seed="card-node", data_dir=str(tmp_path), validators={key.address.hex(): 1},
                     heights=3)
    assert (cfg.sched_route, cfg.torch_device) == ("device", None)
    node = ValidatorNode(cfg, install_signal_handlers=False)
    node.transport = node.engine.transport = _SoloTransport(node.ingress.submit)
    before = (tq.digest_words.launches, ecrecover.recover.launches)
    report = asyncio.run(asyncio.wait_for(node.run(), 300))
    assert report["chain_height"] >= 3
    routes = node.scheduler._dispatcher.routes
    assert routes["host"] == 0 and routes["device"] > 0
    assert report["sched"]["flush_faults"] == 0 and report["sched"]["dispatcher"]["device"].startswith("cuda")
    assert tq.digest_words.launches > before[0] and ecrecover.recover.launches > before[1]
