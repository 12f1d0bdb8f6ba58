"""The plain reference: keccak-256 on known vectors and against the
benchmark's signer, recovery against known-bad lanes, and its modules'
independence from the program."""

import os
import subprocess
import sys

import pytest

from portbench.harness import paths, signer
from portbench.reference import keccak, secp256k1, verdicts


def test_keccak_vectors():
    assert keccak.keccak256(b"").hex() == "c5d2460186f7233c927e7db2dcc703c0e500b653ca82273b7bfad8045d85a470"
    assert keccak.keccak256(b"abc").hex() == "4e03657aea45a94fc7d47ba826c8d667c0d1e6e33a64a036ec44f58fa12d6c45"


@pytest.mark.parametrize("size", [0, 1, 135, 136, 137, 271, 272, 600, 1000])
def test_keccak_matches_signer(size):
    msgs = [os.urandom(size) for _ in range(5)]
    assert keccak.keccak256_many(msgs) == [signer.keccak256(m) for m in msgs]


def _signed(i=0):
    d = signer.key_from_seed(b"reference-%d" % i)
    digest = signer.keccak256(b"message %d" % i)
    sig = signer.sign(d, digest)
    return d, digest, sig


def _parts(sig):
    return int.from_bytes(sig[:32], "big"), int.from_bytes(sig[32:64], "big"), sig[64]


@pytest.mark.parametrize("i", range(4))
def test_recovers_the_signer(i):
    d, digest, sig = _signed(i)
    assert secp256k1.recover(secp256k1.digest_scalar(digest), *_parts(sig)) == signer.pubkey(d)


def _non_residue_x():
    x = 5
    while True:
        y2 = (pow(x, 3, secp256k1.P) + 7) % secp256k1.P
        if pow(y2, (secp256k1.P - 1) // 2, secp256k1.P) != 1:
            return x
        x += 1


@pytest.mark.parametrize("case", ["r=0", "r=N", "s=0", "s=N+5", "v=2", "r not an x", "flipped byte", "other digest"])
def test_known_bad_lanes(case):
    d, digest, sig = _signed(7)
    r, s, v = _parts(sig)
    z = secp256k1.digest_scalar(digest)
    n = secp256k1.N
    if case == "flipped byte":
        flipped = sig[:5] + bytes([sig[5] ^ 0xFF]) + sig[6:]
        pub = secp256k1.recover(z, *_parts(flipped))
        assert pub != signer.pubkey(d)
        return
    if case == "other digest":
        assert secp256k1.recover(z ^ 1, r, s, v) != signer.pubkey(d)
        return
    r, s, v = {"r=0": (0, s, v), "r=N": (n, s, v), "s=0": (r, 0, v), "s=N+5": (r, n + 5, v),
               "v=2": (r, s, 2), "r not an x": (_non_residue_x(), s, 1)}[case]
    assert secp256k1.recover(z, r, s, v) is None


def test_verdicts_on_member_claim_and_corruption():
    d, digest, sig = _signed(3)
    addr = signer.address(signer.pubkey(d))
    msg = b"message 3"
    bad = sig[:5] + bytes([sig[5] ^ 0xFF]) + sig[6:]
    items = [(msg, sig, addr), (msg, bad, addr), (msg, sig, b"\x01" * 20), (msg, sig[:64], addr)]
    assert verdicts.verdicts(items, {addr}, 1) == [True, False, False, False]
    assert verdicts.verdicts(items[:1], set(), 1) == [False]


@pytest.mark.parametrize("workers", [1, 2])
def test_resigning_agrees_with_recovery(workers):
    """Given the members' keys, a signature equal to its key's deterministic
    one is settled without a recovery, and every verdict stays the one that
    recovery gives: a corrupt signature, a malleated (high s) one and a
    claim of another member's address included."""
    items, members, keys, expect = [], set(), {}, []
    for i in range(260):
        d, digest, sig = _signed(i)
        addr = signer.address(signer.pubkey(d))
        members.add(addr)
        keys[addr] = d
        assert verdicts._resign_chunk([(int.from_bytes(d, "big"), digest, sig)]) == [True]
        r, s, v = _parts(sig)
        kind = i % 4
        if kind == 1:
            sig = sig[:5] + bytes([sig[5] ^ 0xFF]) + sig[6:]
        elif kind == 2:
            sig = r.to_bytes(32, "big") + (secp256k1.N - s).to_bytes(32, "big") + bytes([v ^ 1])
        elif kind == 3:
            addr = signer.address(signer.pubkey(_signed(i + 1)[0]))
        items.append((b"message %d" % i, sig, addr))
        expect.append(kind in (0, 2))
    assert verdicts.verdicts(items, members, workers, keys) == expect
    assert verdicts.verdicts(items[:8], members, 1) == expect[:8]


def test_parallel_recovery_matches_serial():
    jobs = []
    for i in range(300):
        _d, digest, sig = _signed(i)
        jobs.append((secp256k1.digest_scalar(digest), *_parts(sig)))
    assert verdicts.recover_many(jobs, 2) == verdicts.recover_many(jobs, 1)


def test_reference_imports_nothing_of_the_program():
    code = ("import sys; import portbench.reference.verdicts, portbench.reference.keccak, "
            "portbench.reference.secp256k1; "
            "bad = sorted({m.split('.')[0] for m in sys.modules} & {'go_ibft_tpu_torch', 'go_ibft_tpu', 'jax', "
            "'jaxlib', 'torch'}); print(bad); sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=paths.REPO_ROOT, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
