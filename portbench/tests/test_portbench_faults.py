"""Each fault a cell can have, planted underneath the timed path, turns
``correct`` false; the controls (a guarantee the configuration states,
broken) do too.  On the CPU at a tiny size; ``test_control_on_the_card``
runs the controls at the cells' own size where a card is present."""

import json
import os
import subprocess
import sys

import pytest

from portbench.harness import paths

from .tiny import TINY_MIXES, run_tiny, tiny_manifest

# Each cell's faults, and the check that each is expected to fail.
CASES = [
    ("ecdsa-100v.live", "flip"),
    ("ecdsa-100v.live", "half"),
    ("ecdsa-100v.live", "stale"),
    ("ecdsa-100v.live", "alter_block"),
    ("ecdsa-100v.live", "skip_wal"),
    ("ecdsa-100v.live", "no_fsync"),
    ("ecdsa-100v.live", "skip_verify"),
    ("ecdsa-300v-byz.live", "accept_all"),
    ("ecdsa-300v-byz.live", "half"),
    ("ecdsa-300v-byz.live", "reject_all"),
    ("ecdsa-100v.sync", "flip"),
    ("ecdsa-100v.sync", "half"),
    ("ecdsa-100v.sync", "stale"),
    ("ecdsa-100v.sync", "accept_all"),
]


# The check that alone stands for a guarantee, where a fault is planted for it.
CAUGHT_BY = {"no_fsync": "wal_unsynced", "skip_verify": "counted_off_card"}


@pytest.mark.parametrize("workload,fault", CASES)
def test_fault_turns_correct_false(tmp_path, workload, fault):
    manifest = None
    if fault == "reject_all":
        # Every verdict false: no quorum forms, and the height stalls.
        manifest = tiny_manifest(str(tmp_path), extra_mixes={"live": {**TINY_MIXES["live"], "height_timeout_s": 60}})
    res = run_tiny(str(tmp_path), workload, fault=fault, manifest=manifest)
    assert not res["correct"], res
    assert any(c["value"] > c["limit"] for c in res["checks"].values())
    if fault in CAUGHT_BY:
        assert res["checks"][CAUGHT_BY[fault]]["value"] > 0, res["checks"]


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the controls run at the cells' own size")
    return torch.device("cuda")


CONTROLS = [("ecdsa-100v.live", "skip_wal"), ("ecdsa-100v.live", "no_fsync"), ("ecdsa-100v.live", "skip_verify"),
            ("ecdsa-100v.sync", "accept_all")]


@pytest.mark.cuda
@pytest.mark.parametrize("workload,fault", CONTROLS)
@pytest.mark.parametrize("seed", [2_147_483_659, 3_000_000_019, 4_000_000_007])
def test_control_on_the_card(card, workload, fault, seed):
    proc = subprocess.run([sys.executable, "portbench/run.py", "--workload", workload, "--seed", str(seed),
                           "--seconds", "5", "--trace", "0", "--fault", fault],
                          cwd=paths.REPO_ROOT, capture_output=True, text=True, timeout=900,
                          env={**os.environ})
    assert proc.returncode == 0, proc.stderr[-3000:]
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    assert not res["correct"]
