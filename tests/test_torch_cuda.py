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
)
from go_ibft_tpu_torch.crypto.backend import ECDSABackend
from go_ibft_tpu_torch.ops import ecrecover, keccak_f1600
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


def test_port_imports_nothing_of_jax():
    """A fresh interpreter where ``import jax`` fails imports every module
    of ``go_ibft_tpu_torch``, the chain and BLS slices' among them; no
    ``go_ibft_tpu`` module gets loaded."""
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
    """``go_ibft_tpu_torch.chaos`` leaves out the JAX package's serve-plane
    ``clients``: importing it, with JAX blocked, loads no such module."""
    root = Path(__file__).resolve().parent.parent
    code = """
import sys
sys.modules["jax"] = None
import go_ibft_tpu_torch.chaos
print(sorted(k for k in sys.modules if k.endswith(".clients") or k.endswith("chaos.clients")))
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
    assert not (root / "go_ibft_tpu_torch" / "chaos" / "clients.py").exists()


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
