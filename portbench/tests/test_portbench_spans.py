"""The per-layer metrics read from the program's host spans: a traced tiny
run of each cell reads every one of its cell's, each above 0."""

import pytest

from portbench.harness import runner

from .tiny import run_tiny

NEW = {
    "ecdsa-100v.live": ["ingress_window_ms.live", "sched_window_ms.live", "sched_pack_ms.live", "send_ms.live",
                        "wal_fsync_ms.live", "decode_ms.live"],
    "ecdsa-100v.sync": ["sync_lanes_ms.sync", "sync_quorum_ms.sync"],
}


def test_the_manifest_lists_each_in_its_cell():
    layer = {m["name"]: m for m in runner.load_manifest()["per_layer"]}
    for cell, names in NEW.items():
        for name in names:
            assert layer[name]["workloads"] == [cell] and layer[name]["source"] == "program_span", name


@pytest.mark.parametrize("workload", sorted(NEW))
def test_traced_run_reads_each_span_metric(tmp_path, workload):
    res = run_tiny(str(tmp_path), workload, trace=True)
    assert res["correct"], res
    for name in NEW[workload]:
        assert res["metrics"][name]["value"] > 0, name
        assert res["metrics"][name]["unit"] == "ms"
