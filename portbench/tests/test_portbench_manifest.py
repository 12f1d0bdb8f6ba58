"""``BENCHMARK.json`` against the contract it is written to, and the files it
names: every name and unit in its alphabet, every per-layer metric moving one
end-to-end metric that each of its cells reports, and every piece a cell is
found by (configuration, mix, generator, metric readers) present."""

import json
import os
import re

import pytest

from portbench.harness import paths, runner

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")


@pytest.fixture(scope="module")
def manifest():
    return runner.load_manifest()


def test_top_level_keys(manifest):
    assert set(manifest) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert manifest["command"] == ["python3", "portbench/run.py"]
    assert manifest["paths"] == ["portbench"]
    assert all(PATH.match(p) and ".." not in p and not p.startswith("/") for p in manifest["paths"])
    assert isinstance(manifest["run_seconds"], int) and 1 <= manifest["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(paths.REPO_ROOT, "BENCHMARK.json")) <= 64 * 1024


def test_budget_fits_twenty_four_cells(manifest):
    cells = 24
    runs = 2 + 14 * cells
    assert runs * (manifest["run_seconds"] + 60) + cells * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("section", ["configs", "workloads", "end_to_end", "per_layer"])
def test_names_unique_and_in_alphabet(manifest, section):
    names = [e["name"] for e in manifest[section]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)


def test_entry_keys(manifest):
    for c in manifest["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert 1 <= len(c["source"]) <= 200 and 1 <= len(c["why"]) <= 200
        assert c["file"].startswith("portbench/") and os.path.exists(os.path.join(paths.REPO_ROOT, c["file"]))
        assert all(NAME.match(k) for k in c["reduced"])
    for w in manifest["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and 1 <= len(w["why"]) <= 200 and "\t" not in w["why"]
    for m in manifest["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in manifest["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert 1 <= len(m["layer"]) <= 200


def test_units_and_directions(manifest):
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
        if m["name"].endswith("_roofline") or "_roofline" in m["name"]:
            assert m["unit"] == "%"


def test_every_cell_reports_what_it_must(manifest):
    cells = {w["name"] for w in manifest["workloads"]}
    e2e = {m["name"]: set(m.get("workloads", cells)) for m in manifest["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"] == cells
    for cell in cells:
        assert any(cell in ws for name, ws in e2e.items() if name != "setup_s")
        assert any(cell in m["workloads"] for m in manifest["per_layer"])
    for m in manifest["per_layer"]:
        assert m["moves"] in e2e and m["moves"] != "setup_s"
        assert set(m["workloads"]) <= e2e[m["moves"]], m["name"]


def test_layers_named_alike(manifest):
    layers = {m["layer"] for m in manifest["per_layer"]}
    assert layers == {"chain", "engine", "scheduler", "verifier", "kernels", "device"}


def test_every_piece_is_found_by_name(manifest):
    for w in manifest["workloads"]:
        cell, config, mix, e2e, layer = runner.cell_parts(manifest, w["name"])
        assert os.path.exists(os.path.join(paths.BENCH_DIR, "generators", mix["generator"] + ".py"))
        for m in e2e + layer:
            assert os.path.exists(runner.reader_path(m["name"])), m["name"]
        assert config["validators"] >= 4


def test_a_reader_serves_every_suffix_of_its_quantity():
    """``<quantity>.<suffix>`` without a file of its own is read by
    ``<quantity>.py``; a name with a file of its own keeps it."""
    assert runner.reader_path("device_idle_pct.tenants").endswith("metrics/device_idle_pct.py")
    assert runner.reader_path("recover_roofline_pct.live").endswith("metrics/recover_roofline_pct.py")
    assert runner.reader_path("dispatch_ms.live").endswith("metrics/dispatch_ms.live.py")


def test_configs_state_source_guarantees_and_assumed(manifest):
    for c in manifest["configs"]:
        with open(os.path.join(paths.REPO_ROOT, c["file"])) as fh:
            config = json.load(fh)
        assert config["name"] == c["name"]
        assert config["guarantees"] and config["assumed"] and config["source"]
        assert config["byzantine"] * 3 < config["validators"]
