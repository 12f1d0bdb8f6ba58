"""The port's multi-process fleet (``sim/fleet.py``, ``chaos/clients.py``):
real ``python -m go_ibft_tpu_torch.node`` processes over real sockets,
against the JAX package's contracts (``tests/test_fleet.py``), on the CPU.

One module-scoped fleet of 4 port validators with ``device="cpu"`` (every
node's scheduler on the CPU asked for) under a proof-client flood plus
churn and slowloris adversaries: every node finalizes every gated height,
serves the same chain over the untrusted-client wire, its full-range proof
verifies client-side, every node drains with a report, and the per-node
traces merge into one cross-process timeline (read by the port's timeline
and by the JAX package's ``scripts/consensus_timeline.py``).  The fleet's
``CHAOS-REPLAY`` line, its client schedule digests and the adversaries'
byte plans are byte-identical to the JAX package's for the same seeds.
The proof API's untrusted-client bounds hold against the port's clients.

The fleet's nodes take the ``auto`` route: with 4 validators every flush
is below the cutover and is served by the host, since on this CPU a
device-route flush runs the plain recovery (seconds a flush) and four such
processes do not finalize a height in minutes.  The device route of a node
is held on the CPU by ``tests/test_torch_node.py`` and the fleet's on the
card by ``chip_smoke.py``.
"""

import json
import os
import pathlib
import socket
import subprocess
import sys
import threading
import time

import pytest
import torch

from go_ibft_tpu.chaos import clients as jax_clients
from go_ibft_tpu.sim.fleet import FleetSpec as JaxFleetSpec
from go_ibft_tpu_torch.chaos import SlowlorisClient, client_schedule_digest, fleet_replay_line
from go_ibft_tpu_torch.chaos import clients
from go_ibft_tpu_torch.node.proof_api import ProofApiServer
from go_ibft_tpu_torch.obs import timeline
from go_ibft_tpu_torch.sim import parse_replay_line
from go_ibft_tpu_torch.sim.fleet import FleetSpec, _http_get, run_fleet

torch.set_num_threads(1)

_REPO = pathlib.Path(__file__).resolve().parent.parent

_SPEC = dict(
    nodes=4,
    heights=2,
    connections=8,
    churn_clients=1,
    slowloris_clients=1,
    seed=11,
    think_s=0.2,
    header_timeout_s=0.5,
    min_flood_s=3.0,  # the JAX test's 1.0 left no answered proof once in a loaded xdist run
)


@pytest.fixture(scope="module")
def fleet_run(tmp_path_factory):
    """4 real port validator processes, small flood, adversaries attached."""
    run_dir = tmp_path_factory.mktemp("fleet")
    spec = FleetSpec(**_SPEC, device="cpu", route="auto", env={"OMP_NUM_THREADS": "1"})
    result = run_fleet(spec, str(run_dir), on_live=_probe_live)
    return spec, result, run_dir


def _probe_live(infos):
    """Each live node's /statusz and one /profilez window."""
    out = []
    for info in infos:
        port = info["telemetry_port"]
        out.append({path: _http_get("127.0.0.1", port, path, 30.0) for path in ("/statusz", "/profilez?seconds=0.2")})
    return out


def test_fleet_finalizes_every_height_under_flood(fleet_run):
    spec, result, _ = fleet_run
    assert result.missed_heights == 0, result.summary()
    assert len(result.heads) == spec.nodes
    assert all(h >= spec.heights for h in result.heads)
    assert result.diverged_chains == 0
    assert result.proofs_total > 0, result.summary()
    assert result.peak_connections >= spec.connections
    assert result.proof_p99_ms is not None and result.proof_p99_ms > 0


def test_fleet_proofs_verify_client_side(fleet_run):
    spec, result, _ = fleet_run
    assert result.verified_proofs == spec.nodes


def test_fleet_adversaries_contained(fleet_run):
    _, result, _ = fleet_run
    slow = result.slowloris
    assert slow["opened"] > 0
    assert slow["cut_by_server"] == slow["opened"]
    assert result.churn["churns"] > 0 and result.churn["responses"] > 0


def test_fleet_drain_reports(fleet_run):
    spec, result, _ = fleet_run
    assert len(result.reports) == spec.nodes
    for i, report in enumerate(result.reports):
        assert report, f"node {i} emitted no drain report"
        assert report["chain_height"] >= spec.heights
        assert report["trace_events"] > 0
        assert os.path.exists(report["wal_path"])
        sched = report["sched"]
        assert sched["dispatcher"]["device"] == "cpu" and sched["dispatcher"]["route"] == "auto"
        # The drain drops late gossip before the scheduler stops: no refusal.
        assert sched["flush_faults"] == 0 and sched["refusals"] == 0
    total_requests = sum(r["proof_api"]["requests"] for r in result.reports)
    assert total_requests >= result.proofs_total


def test_live_nodes_serve_statusz_and_profilez(fleet_run):
    """The ``on_live`` hook's probe: every node's /statusz scheduler block
    names the CPU asked for and carries the dispatcher's route counts, and
    /profilez answers with a profiler window (a trace, or 503 when the
    window recorded no operator on the device), never 501."""
    spec, result, _ = fleet_run
    assert len(result.live) == spec.nodes
    for node in result.live:
        code, status = node["/statusz"]
        sched = status["sched"]
        assert code == 200 and sched["dispatcher"]["device"] == "cpu" and set(sched["routes"]) == {"host", "device"}
        assert sched["routes"]["host"] > 0 and sched["flush_faults"] == 0
        code, prof = node["/profilez?seconds=0.2"]
        assert (code, prof["ok"]) in ((200, True), (503, False)) and prof.get("device") == "cpu"


def test_fleet_nodes_wrote_the_device_into_their_configs(fleet_run):
    spec, _, run_dir = fleet_run
    for i in range(spec.nodes):
        text = (run_dir / f"node-{i}.toml").read_text()
        assert 'route = "auto"\ndevice = "cpu"\n' in text


def test_fleet_cross_process_timeline(fleet_run):
    spec, result, _ = fleet_run
    assert len(result.trace_paths) == spec.nodes
    assert result.timeline_heights > 0
    files = [timeline.load_trace_file(p) for p in result.trace_paths]
    by_height = {tl.height: tl for tl in timeline.reconstruct(timeline.merge_events(files))}
    for h in range(1, spec.heights + 1):
        assert h in by_height, f"height {h} missing from merged timeline"
    crits = [
        by_height[h].to_dict()["critical_path"]
        for h in range(1, spec.heights + 1)
        if by_height[h].to_dict()["critical_path"] is not None
    ]
    assert crits and all(c["total_us"] > 0 for c in crits)


def test_consensus_timeline_cli_reads_the_port_traces(fleet_run, tmp_path):
    """The JAX package's operator CLI over the port's per-node trace files
    (one trace format): exit 0, a per-height report, a merged Perfetto."""
    _, result, _ = fleet_run
    perfetto = tmp_path / "merged.json"
    proc = subprocess.run(
        [sys.executable, str(_REPO / "scripts" / "consensus_timeline.py"), *result.trace_paths,
         "--perfetto", str(perfetto)],
        capture_output=True, text=True, timeout=120, env={**os.environ, "JAX_PLATFORMS": "cpu"},
    )
    assert proc.returncode == 0, proc.stderr
    assert "height 1" in proc.stdout and "critical node" in proc.stdout
    doc = json.loads(perfetto.read_text())
    assert len({e.get("pid") for e in doc["traceEvents"] if "pid" in e}) >= 2


def test_fleet_replay_line_is_the_jax_line(fleet_run):
    spec, result, _ = fleet_run
    assert result.replay_line == jax_clients.fleet_replay_line(spec.seed, JaxFleetSpec(**_SPEC).fleet_config())
    parsed = parse_replay_line(result.replay_line)
    assert parsed["seed"] == spec.seed and parsed["config"]["fleet"]["nodes"] == spec.nodes
    assert parsed["schedule"] == client_schedule_digest(spec.seed, spec.churn_clients, spec.slowloris_clients)


# -- the replay contract, byte for byte -------------------------------------------


@pytest.mark.parametrize("seed,churn,slow", [(0, 0, 0), (7, 2, 2), (11, 1, 1), (2026, 5, 3)])
def test_client_plans_and_lines_equal_jax(seed, churn, slow):
    assert client_schedule_digest(seed, churn, slow) == jax_clients.client_schedule_digest(seed, churn, slow)
    spec = dict(_SPEC, seed=seed, churn_clients=churn, slowloris_clients=slow)
    port_cfg = FleetSpec(**spec, device="cpu", route="host").fleet_config()
    assert port_cfg == JaxFleetSpec(**spec).fleet_config()
    assert fleet_replay_line(seed, port_cfg) == jax_clients.fleet_replay_line(seed, port_cfg)
    for kind in ("churn", "slowloris"):
        for cid in range(3):
            mine, ref = clients._stream(seed, cid, kind), jax_clients._stream(seed, cid, kind)
            assert [mine.random() for _ in range(16)] == [ref.random() for _ in range(16)]


# -- proof API bounds against the port's clients -------------------------------------


class _NoProofs:
    def get_proof(self, checkpoint, target=None):
        raise AssertionError("bounds tests never build a proof")


@pytest.fixture()
def api():
    server = ProofApiServer(_NoProofs(), lambda: 5, port=0, max_connections=4, max_request_bytes=512,
                            header_timeout_s=0.4, idle_timeout_s=5.0)
    port = server.start()
    yield server, port
    server.stop()


def _roundtrip(port: int, payload: bytes, timeout: float = 5.0) -> bytes:
    with socket.create_connection(("127.0.0.1", port), timeout) as s:
        s.settimeout(timeout)
        s.sendall(payload)
        data = b""
        try:
            while chunk := s.recv(4096):
                data += chunk
        except socket.timeout:
            pass
    return data


def test_proof_api_oversized_request_431(api):
    _, port = api
    huge = b"GET /head HTTP/1.1\r\nHost: t\r\n" + b"X-Filler: " + b"a" * 600 + b"\r\n\r\n"
    assert b" 431 " in _roundtrip(port, huge).split(b"\r\n", 1)[0]


def test_proof_api_bad_target_400(api):
    _, port = api
    data = _roundtrip(port, b"GET /proof?checkpoint=zap HTTP/1.1\r\nHost: t\r\nConnection: close\r\n\r\n")
    assert b" 400 " in data.split(b"\r\n", 1)[0]


def test_proof_api_connection_cap_503(api):
    _, port = api
    held = [socket.create_connection(("127.0.0.1", port), 5.0) for _ in range(4)]
    try:
        time.sleep(0.05)
        with socket.create_connection(("127.0.0.1", port), 5.0) as s:
            s.settimeout(5.0)
            data = b""
            try:
                while chunk := s.recv(4096):
                    data += chunk
            except socket.timeout:
                pass
        assert data.split(b"\r\n", 1)[0].endswith(b"503 Service Unavailable")
    finally:
        for s in held:
            s.close()


def test_proof_api_cuts_slowloris(api):
    server, port = api
    client = SlowlorisClient("127.0.0.1", port, seed=3, conns=2)
    stop = threading.Event()
    t = threading.Thread(target=client.run, args=(stop,), daemon=True)
    t.start()
    deadline = time.monotonic() + 10.0
    while client.stats["cut_by_server"] < client.stats["opened"] or client.stats["opened"] < 2:
        assert time.monotonic() < deadline, client.stats
        time.sleep(0.1)
    stop.set()
    t.join(timeout=10.0)
    assert client.stats["cut_by_server"] == client.stats["opened"] == 2
    assert server.stats()["slow_client_closes"] >= 2
