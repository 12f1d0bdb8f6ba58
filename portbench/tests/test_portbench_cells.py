"""Each cell end to end at a tiny size on the CPU (the program's plain
kernels): set-up, a window, the judgement and the metrics; a mix added by
files alone; and no JAX in a run's process."""

import copy
import json
import subprocess
import sys

import pytest

from portbench.harness import paths

from .tiny import run_tiny, tiny_manifest

CELLS = ["ecdsa-100v.live", "ecdsa-300v-byz.live", "ecdsa-100v.sync"]


@pytest.mark.parametrize("workload", CELLS)
def test_cell_runs_correct(tmp_path, workload):
    res = run_tiny(str(tmp_path), workload)
    assert res["correct"], res
    assert res["attempted"] > 0 and res["failed"] == 0
    if workload.endswith(".sync"):
        assert res["metrics"]["sync_heights_per_s"]["value"] > 0
    else:
        # The live cells' end-to-end metric besides setup_s is read from the
        # card's trace: with no card it finds nothing and is left out.
        assert "card_ms_per_height" not in res["metrics"]
    assert res["metrics"]["setup_s"]["value"] > 0
    assert list(res)[-2:] == ["checks", "notes"]
    assert all(c["limit"] == 0 for c in res["checks"].values())


@pytest.mark.parametrize("workload", ["ecdsa-300v-byz.live", "ecdsa-100v.sync"])
def test_traced_run_reads_its_spans(tmp_path, workload):
    res = run_tiny(str(tmp_path), workload, trace=True)
    assert res["correct"], res
    if workload.endswith(".live"):
        for name in ("heights_per_s.live", "finality_p95_ms.live", "engine_host_ms.live",
                     "dispatches_per_height.live", "dispatch_ms.live"):
            assert res["metrics"][name]["value"] > 0, name
    else:
        assert res["metrics"]["pack_ms.sync"]["value"] > 0
    # No card: the device's metrics find nothing to read and are left out.
    assert not any("roofline" in m or "idle" in m for m in res["metrics"])


def test_a_mix_added_by_files_alone(tmp_path):
    """A new traffic mix is a data file and a manifest entry: no code."""
    mix = {"generator": "live", "pool_heights": 1, "warm_heights": 0, "round_timeout_s": 600,
           "height_timeout_s": 900}
    manifest = tiny_manifest(str(tmp_path), extra_mixes={"dummy": mix})
    manifest = copy.deepcopy(manifest)
    manifest["workloads"].append({"name": "ecdsa-100v.dummy", "config": "ecdsa-100v", "traffic": "dummy",
                                  "chips": 1, "why": "a mix added by files alone"})
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        if "ecdsa-100v.live" in m.get("workloads", ()):
            m["workloads"].append("ecdsa-100v.dummy")
    res = run_tiny(str(tmp_path), "ecdsa-100v.dummy", manifest=manifest, trace=True)
    assert res["correct"], res
    assert res["metrics"]["heights_per_s.live"]["value"] > 0


def test_a_run_loads_no_jax(tmp_path):
    code = f"""
import json, sys
sys.path.insert(0, {paths.REPO_ROOT!r})
from portbench.tests.tiny import run_tiny
from portbench.harness.runner import forbidden_modules
res = run_tiny({str(tmp_path)!r}, "ecdsa-100v.sync")
tops = sorted({{m.split('.')[0] for m in sys.modules}})
print(json.dumps({{"correct": res["correct"], "forbidden": forbidden_modules(),
                  "jaxlike": [t for t in tops if t in ("jax", "jaxlib", "flax", "go_ibft_tpu")],
                  "port": "go_ibft_tpu_torch" in tops}}))
"""
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path), capture_output=True, text=True,
                          timeout=1500)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out == {"correct": True, "forbidden": [], "jaxlike": [], "port": True}


def test_no_result_without_the_program(tmp_path):
    """In a directory that holds only BENCHMARK.json and portbench/, a run
    exits with another code than 0 and prints no result."""
    import shutil

    shutil.copy(f"{paths.REPO_ROOT}/BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(paths.BENCH_DIR, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    proc = subprocess.run([sys.executable, "portbench/run.py", "--workload", "ecdsa-100v.live", "--seed", "7",
                           "--seconds", "1", "--trace", "0"], cwd=str(tmp_path), capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode != 0
    assert not proc.stdout.strip()
