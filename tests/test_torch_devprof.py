"""The port's card probe (``utils/probe.py``), evidence capture
(``obs/evidence.py``, ``bench/evidence.py``), device profiler
(``obs/devprof.py``) and ``/profilez`` (``obs/httpd.py``), on the CPU.

Mirrors ``tests/test_obs.py``'s probe and evidence cases: the probe child
runs under a hard deadline (a stub that sleeps stands in for a hung driver)
and a timeout is classified and cached; the fingerprint cache honours its
TTL, ``reprobe`` and the ``CUDA_VISIBLE_DEVICES`` pin; a host without a card
is reported dead, never as a CPU route; the evidence writer's lines carry
the JAX schema.  A ``torch.profiler`` window on the CPU asked for returns a
Chrome trace that ``obs/timeline.py::merge_device_trace`` reads, and a
window in which the device recorded nothing is a failure, not an empty
success; ``/profilez`` answers 200, then 409 while a window is open, 400 on
a bad ``seconds`` and 503 on an empty window.
"""

import json
import threading
import time
import urllib.error
import urllib.request

import pytest
import torch

from go_ibft_tpu.obs import evidence as jax_evidence
from go_ibft_tpu_torch.bench import evidence as bench_evidence
from go_ibft_tpu_torch.obs import devprof, evidence, ledger, timeline
from go_ibft_tpu_torch.obs.httpd import TelemetryServer
from go_ibft_tpu_torch.utils import probe

torch.set_num_threads(1)

_SLEEPY_PROBE = "import time; time.sleep(60)"
_STUB_CARD = "print('PLATFORM=gpu'); print('KIND=NVIDIA H100 80GB HBM3'); print('DEVICES=1')"


# -- the probe ------------------------------------------------------------------


def test_probe_timeout_classified_and_deadline_enforced(tmp_path, monkeypatch):
    monkeypatch.setenv("GO_IBFT_PROBE_SRC", _SLEEPY_PROBE)
    cache = tmp_path / "probe.json"
    t0 = time.monotonic()
    fp = evidence.probe_fingerprint(1.0, cache_path=str(cache))
    assert time.monotonic() - t0 < 10.0  # hard deadline, not the stub's 60 s
    assert fp.probe == "timeout" and fp.platform is None
    assert fp.backend_label() == "no-card" and not fp.is_gpu()
    fp2 = evidence.probe_fingerprint(1.0, cache_path=str(cache))
    assert fp2.probe == "cached" and fp2.platform is None


def test_probe_cache_ttl_reprobe_and_env_pin(tmp_path, monkeypatch):
    cache = tmp_path / "probe.json"
    monkeypatch.delenv("CUDA_VISIBLE_DEVICES", raising=False)
    monkeypatch.setenv("GO_IBFT_PROBE_SRC", "print('PLATFORM=stubgpu')")
    fp = evidence.probe_fingerprint(30.0, cache_path=str(cache))
    assert fp.probe == "ok" and fp.platform == "stubgpu"
    monkeypatch.setenv("GO_IBFT_PROBE_SRC", _SLEEPY_PROBE)
    fp2 = evidence.probe_fingerprint(1.0, cache_path=str(cache))
    assert fp2.probe == "cached" and fp2.platform == "stubgpu"
    assert evidence.probe_fingerprint(1.0, cache_path=str(cache), reprobe=True).probe == "timeout"
    assert evidence.probe_fingerprint(1.0, cache_path=str(cache), ttl_s=0.0).probe == "timeout"
    # Another CUDA_VISIBLE_DEVICES pin invalidates the cached verdict.
    monkeypatch.setenv("GO_IBFT_PROBE_SRC", "print('PLATFORM=other')")
    evidence.probe_fingerprint(30.0, cache_path=str(cache))
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "1")
    monkeypatch.setenv("GO_IBFT_PROBE_SRC", "print('PLATFORM=pinned')")
    fp5 = evidence.probe_fingerprint(30.0, cache_path=str(cache))
    assert fp5.probe == "ok" and fp5.platform == "pinned" and fp5.env_visible_devices == "1"


def test_probe_names_the_card(tmp_path, monkeypatch):
    monkeypatch.setenv("GO_IBFT_PROBE_SRC", _STUB_CARD)
    assert probe.probe_default_backend_full(30.0) == ("gpu", "ok", 1, "NVIDIA H100 80GB HBM3")
    assert probe.probe_default_backend(30.0) == ("gpu", "ok")
    fp = evidence.probe_fingerprint(30.0, cache_path=str(tmp_path / "p.json"))
    assert (fp.platform, fp.kind, fp.device_count) == ("gpu", "NVIDIA H100 80GB HBM3", 1)
    assert fp.is_gpu() and fp.backend_label() == "gpu"
    cached = evidence.probe_fingerprint(30.0, cache_path=str(tmp_path / "p.json"))
    assert (cached.probe, cached.kind, cached.device_count) == ("cached", "NVIDIA H100 80GB HBM3", 1)


def test_the_real_probe_reports_a_host_without_a_card_dead(tmp_path, monkeypatch):
    """The probe's own child on this host: no card is a dead verdict with
    the reason, never a CPU platform."""
    monkeypatch.delenv("GO_IBFT_PROBE_SRC", raising=False)
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the dead-card verdict needs a host without one")
    platform, detail, devices, kind = probe.probe_default_backend_full(120.0)
    assert (platform, devices, kind) == (None, None, None)
    assert detail == "no CUDA device is available"
    fp = evidence.probe_fingerprint(120.0, cache_path=str(tmp_path / "p.json"))
    assert fp.probe == "error" and fp.backend_label() == "no-card"


def test_probe_timeout_knob(monkeypatch):
    monkeypatch.setenv("GO_IBFT_PROBE_TIMEOUT", "7")
    assert probe.probe_timeout_s() == 7.0
    monkeypatch.setenv("GO_IBFT_PROBE_SRC", _SLEEPY_PROBE)
    platform, detail, devices, kind = probe.probe_default_backend_full(0.5)
    assert (platform, devices, kind) == (None, None, None) and detail == "probe timeout after 0s"


# -- the evidence writer -----------------------------------------------------------


def test_evidence_writer_appends_flushes_and_stamps(tmp_path):
    path = tmp_path / "ev.jsonl"
    with evidence.EvidenceWriter(str(path), backend="no-card", probe="timeout") as writer:
        writer.record("config_a", {"metric": "config_a", "value": 1.5})
        assert len(path.read_text().splitlines()) == 1  # flushed per record
        writer.record("config_b", {"metric": "config_b", "value": None})
        assert writer.missing(["config_a", "config_b", "config_c"]) == ["config_c"]
        assert writer.covered() == ["config_a", "config_b"]
    lines = [json.loads(line) for line in path.read_text().splitlines()]
    assert [line["config"] for line in lines] == ["config_a", "config_b"]
    assert evidence.REQUIRED_EVIDENCE_FIELDS == jax_evidence.REQUIRED_EVIDENCE_FIELDS
    for line in lines:
        for field in evidence.REQUIRED_EVIDENCE_FIELDS:
            assert field in line, (field, line)
        assert (line["backend"], line["probe"], line["devices"]) == ("no-card", "timeout", None)
    with evidence.EvidenceWriter(str(path), backend="gpu", probe="ok", devices=1) as w2:
        w2.record("config_c", {"value": 2.0})
    assert len(path.read_text().splitlines()) == 3
    assert json.loads(path.read_text().splitlines()[-1])["devices"] == 1


def test_evidence_lines_match_the_jax_writer_schema(tmp_path):
    """The same records through both writers: the same keys and values,
    but for the timestamp and the backend label the run stamps."""
    rows = {}
    for name, mod in (("port", evidence), ("jax", jax_evidence)):
        path = tmp_path / f"{name}.jsonl"
        with mod.EvidenceWriter(str(path), backend="X", probe="ok", devices=2) as w:
            w.record("c1", {"value": 3}, extra="y")
            w.set_provenance("Y", "cached")
            w.record("c2", metric="m2")
        rows[name] = [{k: v for k, v in json.loads(line).items() if k != "ts"} for line in path.read_text().splitlines()]
    assert rows["port"] == rows["jax"]


def test_evidence_lines_carry_the_ledger_delta(tmp_path):
    ledger.enable()
    try:
        path = tmp_path / "ev.jsonl"
        with evidence.EvidenceWriter(str(path)) as w:
            ledger.record_dispatch("digest_words", "device", live=6, padded=8, ms=1.0)
            first = w.record("a")
            second = w.record("b")
        assert first["ledger"]["dispatches"] == 1 and first["ledger"]["occupancy"] == 0.75
        assert second["ledger"]["dispatches"] == 0 and second["ledger"]["occupancy"] is None
        assert first["backend"] == "no-card"
    finally:
        ledger.disable()


def test_reprobe_and_capture_runs_the_bench_on_a_live_card(tmp_path, monkeypatch):
    assert bench_evidence.reprobe_and_capture is evidence.reprobe_and_capture
    assert evidence.reprobe_and_capture(100.0, "bench.py")[0] is None  # too little budget
    monkeypatch.setattr(evidence, "probe_fingerprint", lambda *a, **k: evidence.Fingerprint(
        platform=None, probe="error", detail="no CUDA device is available", probed_at=0.0))
    assert evidence.reprobe_and_capture(600.0, "bench.py") == (None, "no CUDA device is available")
    seen = {}

    def fake_run(cmd, **kw):
        seen.update(cmd=cmd, env=kw["env"])

    monkeypatch.setattr(evidence.subprocess, "run", fake_run)
    monkeypatch.setattr(evidence, "probe_fingerprint", lambda *a, **k: evidence.Fingerprint(
        platform="gpu", probe="ok", detail="ok", probed_at=0.0, device_count=1, kind="card"))
    out = str(tmp_path / "gpu.jsonl")
    assert evidence.reprobe_and_capture(600.0, str(tmp_path / "bench.py"), evidence_path=out) == ("gpu", out)
    assert seen["cmd"][-1].endswith("bench.py") and seen["env"]["GO_IBFT_EVIDENCE_PATH"] == out + ".configs.jsonl"
    assert evidence.EVIDENCE_PATH == "evidence_gpu.jsonl"


# -- the profiler ----------------------------------------------------------------


class _Busy:
    """Torch operators on a thread of their own, as a node's flushes run
    on its scheduler's thread."""

    def __enter__(self):
        self.stop = threading.Event()

        def work():
            x = torch.ones(32, 32)
            while not self.stop.is_set():
                (x @ x).sum()
                time.sleep(0.002)

        self.thread = threading.Thread(target=work, daemon=True)
        self.thread.start()
        return self

    def __exit__(self, *exc):
        self.stop.set()
        self.thread.join()


def test_capture_on_the_cpu_returns_a_chrome_trace(tmp_path):
    with _Busy():
        meta = devprof.capture(0.3, str(tmp_path), device="cpu")
    assert meta["ok"], meta
    assert meta["device"] == "cpu" and meta["device_events"] > 0 and meta["kernels"].get("aten::mm", 0) > 0
    assert meta["path"] == devprof.newest_trace(str(tmp_path)) and meta["path"].endswith(".trace.json")
    doc = timeline.merge_device_trace(
        {"traceEvents": [], "otherData": {"clockBaseUs": meta["host_anchor_us"] - 5}},
        meta["path"], host_anchor_us=meta["host_anchor_us"],
    )
    assert doc["otherData"]["deviceTraceAligned"] and doc["otherData"]["deviceTraceEvents"] > 0


def test_an_empty_window_is_a_failure_not_an_empty_trace(tmp_path):
    meta = devprof.capture(0.05, str(tmp_path), device="cpu")
    assert meta["ok"] is False and meta["device_events"] == 0
    assert "recorded no CPU operator" in meta["error"]


def test_capture_without_a_card_reports_it(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    meta = devprof.capture(0.05, str(tmp_path))
    assert meta["ok"] is False and "no CUDA device" in meta["error"]


def test_window_profiles_a_block_and_busy_is_reported(tmp_path):
    with devprof.window(str(tmp_path / "w"), device="cpu") as meta:
        assert devprof.capture(0.05, device="cpu")["error"].startswith("busy")
        with devprof.window(str(tmp_path / "w2"), device="cpu") as inner:
            assert inner["error"].startswith("busy")
        x = torch.ones(16, 16)
        for _ in range(10):
            x @ x
    assert meta["ok"] and meta["device_events"] > 0 and meta["path"]


def test_default_capture_dir_keeps_one_window(tmp_path):
    with _Busy():
        first = devprof.capture(0.1, device="cpu")
        second = devprof.capture(0.1, device="cpu")
    assert first["dir"] == second["dir"]
    assert devprof.newest_trace(second["dir"]) == second["path"]
    import os

    assert os.listdir(second["dir"]) == [os.path.basename(second["path"])]


# -- /profilez ---------------------------------------------------------------------


def _get(url: str):
    try:
        with urllib.request.urlopen(url, timeout=30) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as err:
        return err.code, json.loads(err.read())


def test_profilez_answers_200_then_409_while_a_window_is_open():
    server = TelemetryServer(profile_device="cpu")
    port = server.start()
    url = f"http://127.0.0.1:{port}/profilez"
    try:
        with _Busy():
            got = {}
            t = threading.Thread(target=lambda: got.update(first=_get(url + "?seconds=1.5")))
            t.start()
            deadline = time.monotonic() + 10
            while not devprof._lock.locked() and time.monotonic() < deadline:
                time.sleep(0.01)
            busy = _get(url + "?seconds=0.1")
            t.join()
        code, body = got["first"]
        assert code == 200 and body["ok"] and body["device_events"] > 0 and body["path"]
        assert busy[0] == 409 and busy[1]["error"].startswith("busy")
        assert _get(url + "?seconds=zap")[0] == 400
        code, body = _get(url + "?seconds=0.05")  # nothing ran on the device
        assert code == 503 and "recorded no" in body["error"]
    finally:
        server.stop()
