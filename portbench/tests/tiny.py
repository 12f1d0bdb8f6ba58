"""Tiny cells for the benchmark's CPU tests: the manifest's own cells cut to 7
validators (10 with one Byzantine), a pool of two heights, catch-up ranges of
four heights, run on the CPU with the program's plain PyTorch kernels.  The
traffic leaves out the proposer's PREPARE and COMMIT, so a committee keeps a
quorum (2n/3 + 1) only where n - 1 - Byzantine reaches it, with one honest
lane to spare for the faults that drop one.

The CPU's plain recovery takes seconds a drain, so the mixes here give the
engine a round timeout long enough for a height (the cells' mixes keep the
node's 10 s), and a run keeps PyTorch to one thread: on cores shared by
several test workers a flush could otherwise outlast the scheduler's 30 s
request timeout, and its lanes would be answered off the device path (which
``lanes_off_card`` rightly counts).
"""

from __future__ import annotations

import copy
import json
import os
import time
from typing import Optional

from portbench.harness import paths, runner

TINY_CONFIGS = {
    "ecdsa-100v": {"validators": 7, "byzantine": 0, "proposal_bytes": 600},
    "ecdsa-300v-byz": {"validators": 10, "byzantine": 1, "proposal_bytes": 600},
}
TINY_MIXES = {
    "live": {"generator": "live", "pool_heights": 2, "warm_heights": 0, "round_timeout_s": 600,
             "height_timeout_s": 240},
    "sync": {"generator": "sync", "range_heights": 4, "tamper_every": 2, "pool_proposals": 4,
             "tampered_seals": 2},
}


# A cell that its configuration's file describes but the manifest leaves
# out (PERF.md says why); the tests keep its generator and faults working.
LEFT_OUT = {"config": {"name": "ecdsa-300v-byz", "source": "portbench/configs/ecdsa-300v-byz.json",
                       "file": "portbench/configs/ecdsa-300v-byz.json", "reduced": [], "why": "left out"},
            "cell": {"name": "ecdsa-300v-byz.live", "config": "ecdsa-300v-byz", "traffic": "live", "chips": 1,
                     "why": "left out"},
            "like": "ecdsa-100v.live"}


def tiny_manifest(tmp: str, extra_mixes: Optional[dict] = None) -> dict:
    """The repo's manifest with each configuration's file and each mix
    replaced by a tiny one written under ``tmp``, and the left-out cell put
    back; ``extra_mixes`` adds mixes (by file alone: the cells that use them
    are added by the caller)."""
    manifest = copy.deepcopy(runner.load_manifest())
    if LEFT_OUT["cell"]["name"] not in {w["name"] for w in manifest["workloads"]}:
        manifest["configs"].append(dict(LEFT_OUT["config"]))
        manifest["workloads"].append(dict(LEFT_OUT["cell"]))
        for m in manifest["end_to_end"] + manifest["per_layer"]:
            if LEFT_OUT["like"] in m.get("workloads", ()):
                m["workloads"].append(LEFT_OUT["cell"]["name"])
    for conf in manifest["configs"]:
        path = os.path.join(tmp, conf["name"] + ".json")
        with open(path, "w") as fh:
            json.dump(TINY_CONFIGS[conf["name"]], fh)
        conf["file"] = path
    for name, mix in {**TINY_MIXES, **(extra_mixes or {})}.items():
        with open(os.path.join(tmp, name + ".json"), "w") as fh:
            json.dump(mix, fh)
    return manifest


def run_tiny(tmp: str, workload: str, *, seed: int = 4_294_967_311, fault: Optional[str] = None,
             trace: bool = False, manifest: Optional[dict] = None) -> dict:
    import torch

    torch.set_num_threads(1)
    manifest = manifest or tiny_manifest(tmp)
    os.environ.update(paths.program_environment())
    return runner.run_cell(workload, seed, 0.5, trace, "cpu", process_start=time.monotonic(),
                           fault=fault, manifest=manifest, workers=2, mixes_dir=tmp)
