"""The port's validator process (``node/config.py``, ``node/node.py``,
``python -m go_ibft_tpu_torch.node``) and gossip transport
(``net/grpc_transport.py``) against the JAX package's, on the CPU.

* ``NodeConfig``: the TOML round trip, the rendered text (the JAX text
  plus the port's ``[sched] device`` line), the card default, and every
  rejection text equal to the JAX package's;
* the 11 cases of ``tests/test_grpc_unit.py`` and the 2 gRPC cases of
  ``tests/test_net_transports.py``, run on the port's transport: their
  source with the JAX package's imports rewritten to the port's
  (``tests/harness.py`` likewise);
* a JAX ``GrpcTransport`` and a port one exchanging messages both ways,
  with the trace context that frames the signed bytes;
* two JAX and two port ``ValidatorNode`` s in one process gossiping over
  gRPC, finalizing byte-identical chains;
* a solo port node on the device route with the CPU asked for (every flush
  on the device route, none on the host), a card fault in its scheduler
  ending ``run()``, and the SIGTERM drain of ``python -m
  go_ibft_tpu_torch.node`` (``route = "host"``) leaving a parseable WAL
  that a restart resumes from; ``--check`` validates a config.
"""

import asyncio
import json
import os
import pathlib
import re
import signal
import socket
import subprocess
import sys
import time
import types

import pytest
import torch

from go_ibft_tpu.messages import wire as jax_wire
from go_ibft_tpu.net import GrpcTransport as JaxGrpcTransport
from go_ibft_tpu.node import config as jax_config
from go_ibft_tpu.node import node as jax_node
from go_ibft_tpu_torch.crypto import PrivateKey
from go_ibft_tpu_torch.messages import wire
from go_ibft_tpu_torch.net import GrpcTransport
from go_ibft_tpu_torch.node import config
from go_ibft_tpu_torch.node import node as port_node
from go_ibft_tpu_torch.sim.fleet import FleetSpec, alloc_ports, build_fleet_configs, launch_fleet, wait_ready

torch.set_num_threads(1)

TESTS = pathlib.Path(__file__).resolve().parent
REPO = TESTS.parent


# -- the JAX test sources, on the port --------------------------------------------


def _port_module(filename: str, name: str) -> types.ModuleType:
    """``tests/<filename>`` with every import of the JAX package rewritten
    to the port (and ``harness`` to its port copy), as module ``name``."""
    src = re.sub(r"\bgo_ibft_tpu\b", "go_ibft_tpu_torch", (TESTS / filename).read_text())
    src = src.replace("from harness import", "from harness_torch import")
    mod = types.ModuleType(name)
    mod.__file__ = str(TESTS / filename)
    sys.modules[name] = mod
    exec(compile(src, mod.__file__, "exec"), mod.__dict__)
    return mod


_port_module("harness.py", "harness_torch")
_GRPC_UNIT = _port_module("test_grpc_unit.py", "torch_grpc_unit")
_NET = _port_module("test_net_transports.py", "torch_net_transports")

# The 11 failure-path cases and the 2 gRPC cluster cases, on the port.
for _name, _fn in list(vars(_GRPC_UNIT).items()):
    if _name.startswith("test_"):
        globals()[_name] = _fn
test_grpc_transport_cluster = _NET.test_grpc_transport_cluster
test_grpc_transport_propagates_trace_context = _NET.test_grpc_transport_propagates_trace_context
del _name, _fn


def test_the_copied_cases_run_the_port():
    assert _GRPC_UNIT.GrpcTransport is GrpcTransport and _NET.GrpcTransport is GrpcTransport
    assert sys.modules["harness_torch"].IBFT.__module__.startswith("go_ibft_tpu_torch.")
    assert len([n for n in vars(_GRPC_UNIT) if n.startswith("test_")]) == 11


# -- NodeConfig -------------------------------------------------------------------


def _cfg(pkg_config, **kw):
    base = dict(node_id=3, key_seed="hex:00ff", data_dir="/tmp/x", validators={"ab" * 20: 2}, heights=7)
    base.update(kw)
    return pkg_config.NodeConfig(**base)


def test_node_config_toml_round_trip():
    cfg = _cfg(config, sched_route="auto", sched_device="cpu")
    cfg.consensus.peers = {"node0": "127.0.0.1:9000"}
    back = config.NodeConfig.from_dict(config.parse_toml_subset(cfg.to_toml()))
    assert back == cfg and back.key_seed_bytes == b"\x00\xff" and back.torch_device == "cpu"


@pytest.mark.parametrize("route", ["host", "auto", "device"])
def test_node_config_text_is_the_jax_text_plus_the_device_line(route):
    port = _cfg(config, sched_route=route)
    ref = _cfg(jax_config, sched_route=route)
    for c in (port, ref):
        c.consensus.peers = {"node1": "127.0.0.1:9001", "node0": "127.0.0.1:9000"}
        c.proof_api.listen = "127.0.0.1:8440"
    text = port.to_toml()
    assert text.replace(f'route = "{route}"\ndevice = ""\n', f'route = "{route}"\n') == ref.to_toml()
    # The JAX loader reads the port's file (it ignores the device key).
    assert jax_config.NodeConfig.from_dict(jax_config.parse_toml_subset(text)) == ref


def test_node_config_defaults_to_the_card():
    cfg = _cfg(config)
    assert (cfg.sched_route, cfg.sched_device, cfg.torch_device) == ("device", "", None)
    assert _cfg(jax_config).sched_route == "host"  # the JAX package's default
    data = config.parse_toml_subset('[node]\nkey_seed = "s"\ndata_dir = "/d"\n[validators]\n"ab" = 1\n')
    loaded = config.NodeConfig.from_dict(data)
    assert (loaded.sched_route, loaded.torch_device) == ("device", None)
    for dev in ("cpu", "cuda", "cuda:1"):
        assert _cfg(config, sched_device=dev).validate().torch_device == dev
    with pytest.raises(config.NodeConfigError, match=r"\[sched\] device 'gpu'"):
        _cfg(config, sched_device="gpu").validate()


_BAD_DICTS = [
    {"node": {}, "typo_section": {}},
    {"node": {"key_seed": "s", "data_dir": "/d"}, "validators": {}},
    {"node": {"data_dir": "/d"}, "validators": {"ab": 1}},
    {"node": {"key_seed": "s"}, "validators": {"ab": 1}},
    {"node": {"key_seed": "s", "data_dir": "/d"}, "validators": {"zz": 1}},
    {"node": {"key_seed": "s", "data_dir": "/d"}, "validators": {"ab": 0}},
    {"node": {"key_seed": "s", "data_dir": "/d", "heights": -1}, "validators": {"ab": 1}},
    {"node": {"key_seed": "s", "data_dir": "/d"}, "validators": {"ab": 1}, "consensus": {"listen": "nohost"}},
    {"node": {"key_seed": "s", "data_dir": "/d"}, "validators": {"ab": 1}, "consensus": {"base_round_timeout_s": 0}},
    {"node": {"key_seed": "s", "data_dir": "/d"}, "validators": {"ab": 1}, "proof_api": {"max_connections": 0}},
    {"node": {"key_seed": "s", "data_dir": "/d"}, "validators": {"ab": 1}, "proof_api": {"max_request_bytes": 8}},
    {"node": {"key_seed": "s", "data_dir": "/d"}, "validators": {"ab": 1}, "proof_api": {"typo": 1}},
    {"node": {"key_seed": "s", "data_dir": "/d"}, "validators": {"ab": 1}, "telemetry": {"listen": "x"}},
    {"node": {"key_seed": "s", "data_dir": "/d"}, "validators": {"ab": 1}, "sched": {"route": "gpu"}},
]

_BAD_TEXTS = [
    '[node]\nkey_seed = "unterminated\n',
    "[node]\nid = 1\nid = 2\n",
    "[node]\njust a line\n",
    "[node]\nid = {1}\n",
    "[node]\nbad key! = 1\n",
    "[node]\nid = [1, 2\n",
    "[node.]\n",
    "[node]\nid = \n",
    '[node]\nx = "a"b"\n',
    "x = 1\n[x]\n",
]


def _error(fn):
    try:
        fn()
    except ValueError as err:
        return type(err).__name__, str(err)
    return None


@pytest.mark.parametrize("data", _BAD_DICTS)
def test_node_config_rejection_texts_match_jax(data):
    got = _error(lambda: config.NodeConfig.from_dict(data))
    assert got is not None and got == _error(lambda: jax_config.NodeConfig.from_dict(data))


@pytest.mark.parametrize("text", _BAD_TEXTS)
def test_toml_subset_rejection_texts_match_jax(text):
    got = _error(lambda: config.parse_toml_subset(text))
    assert got is not None and got == _error(lambda: jax_config.parse_toml_subset(text))


def test_load_config_names_the_file(tmp_path):
    path = tmp_path / "node.toml"
    path.write_text("[node]\nid = 1\nid = 2\n")
    for pkg_config in (config, jax_config):
        with pytest.raises(pkg_config.NodeConfigError, match=re.escape(str(path)) + ": line 3: duplicate key"):
            pkg_config.load_config(str(path))


# -- gRPC interop: the JAX package's transport and the port's -----------------------


def _prepare(w, height: int, sender: bytes):
    return w.IbftMessage(
        view=w.View(height=height, round=0),
        sender=sender,
        signature=b"\x01" * 65,
        type=w.MessageType.PREPARE,
        prepare_data=w.PrepareMessage(proposal_hash=b"\x22" * 32),
    )


async def test_jax_and_port_transports_exchange_messages_both_ways():
    got = {"port": [], "jax": []}
    port = GrpcTransport("127.0.0.1:0", {}, got["port"].append)
    ref = JaxGrpcTransport("127.0.0.1:0", {}, got["jax"].append)
    await port.start()
    await ref.start()
    try:
        port.add_peer("jax", f"127.0.0.1:{ref.bound_port}")
        ref.add_peer("port", f"127.0.0.1:{port.bound_port}")
        out_port = _prepare(wire, 5, b"p" * 20)
        out_port.trace_ctx = wire.TraceContext(origin="node-port", span_id=11, sent_us=1, height=5, round=0)
        out_jax = _prepare(jax_wire, 6, b"j" * 20)
        port.multicast(out_port)
        ref.multicast(out_jax)
        for _ in range(200):
            if len(got["port"]) == 2 and len(got["jax"]) == 2:
                break
            await asyncio.sleep(0.02)
        # Each side self-delivers its own message and receives the other's.
        by_sender = {side: {m.sender: m for m in msgs} for side, msgs in got.items()}
        assert by_sender["jax"][b"p" * 20].encode() == out_port.encode()
        assert by_sender["port"][b"j" * 20].encode() == out_jax.encode()
        ctx = by_sender["jax"][b"p" * 20].trace_ctx
        assert (ctx.origin, ctx.span_id, ctx.height) == ("node-port", 11, 5)
    finally:
        await port.stop()
        await ref.stop()


# -- ValidatorNode -----------------------------------------------------------------


class _Quiet:
    def info(self, *a):
        pass

    debug = error = info


def _node_configs(pkg_configs, tmp_path, heights: int, route: str = "host", device: str = ""):
    """One config a validator: seeded keys, every other node a gRPC peer,
    no proof API, no telemetry, no trace."""
    n = len(pkg_configs)
    seeds = [f"mixed-node-{i}" for i in range(n)]
    validators = {PrivateKey.from_seed(s.encode()).address.hex(): 1 for s in seeds}
    ports = alloc_ports(n)
    out = []
    for i, pc in enumerate(pkg_configs):
        cfg = pc.NodeConfig(
            node_id=i,
            key_seed=seeds[i],
            data_dir=str(tmp_path / f"node-{i}"),
            validators=validators,
            heights=heights,
            consensus=pc.ConsensusConfig(
                listen=f"127.0.0.1:{ports[i]}",
                peers={f"node{j}": f"127.0.0.1:{ports[j]}" for j in range(n) if j != i},
                base_round_timeout_s=10.0,
            ),
            trace=pc.TraceConfig(enabled=False),
            sched_route=route,
        )
        if pc is config:
            cfg.sched_device = device
        out.append(cfg)
    return out


def test_two_jax_and_two_port_nodes_finalize_one_chain(tmp_path):
    """Four validators in one process, two of each package, gossiping over
    real gRPC sockets: every node finalizes the same proposals, byte for
    byte, and drains with the JAX report's keys."""
    heights = 3
    cfgs = _node_configs([config, jax_config, config, jax_config], tmp_path, heights)
    nodes = [
        (port_node if c.__class__ is config.NodeConfig else jax_node).ValidatorNode(
            c, logger=_Quiet(), install_signal_handlers=False
        )
        for c in cfgs
    ]

    async def main():
        return await asyncio.wait_for(asyncio.gather(*(n.run() for n in nodes)), 120)

    reports = asyncio.run(main())
    chains = [[b.proposal.encode() for b in n.runner.chain][:heights] for n in nodes]
    assert all(len(c) == heights for c in chains)
    assert all(c == chains[0] for c in chains)
    assert [r["chain_height"] >= heights for r in reports] == [True] * 4
    assert set(reports[0]) == set(reports[1])
    for i, report in enumerate(reports):
        lines = pathlib.Path(report["wal_path"]).read_text().splitlines()
        assert lines and all(json.loads(line) for line in lines), i


def test_solo_node_on_the_device_route_with_the_cpu_asked_for(tmp_path):
    """The port's default route with ``[sched] device = "cpu"``: every
    flush the node makes goes to the device route (plain versions on the
    CPU), none to the host."""
    (cfg,) = _node_configs([config], tmp_path, heights=1, route="device", device="cpu")
    node = port_node.ValidatorNode(cfg, logger=_Quiet(), install_signal_handlers=False)
    assert node.scheduler._dispatcher.device == torch.device("cpu")
    report = asyncio.run(asyncio.wait_for(node.run(), 300))
    assert report["chain_height"] >= 1
    routes = node.scheduler._dispatcher.routes
    assert routes["device"] > 0 and routes["host"] == 0
    assert report["sched"]["dispatcher"]["device"] == "cpu" and report["sched"]["flush_faults"] == 0


class _FaultyDispatcher:
    """A dispatcher on the card whose launch raises."""

    def __init__(self):
        self.device = torch.device("cuda", 0)
        self.route = "device"
        self.routes = {"host": 0, "device": 0}

    def dispatch(self, msgs, lanes, owners):
        self.routes["device"] += 1
        raise RuntimeError("injected kernel fault")

    def warmup(self, **kw):
        pass

    def describe(self):
        return {"route": "device", "device": str(self.device)}


def test_a_card_fault_in_the_node_scheduler_ends_run(tmp_path):
    """On the card a flush's fault propagates: the node's height loop ends
    with it, and the verdict is never filled from the host oracle."""
    (cfg,) = _node_configs([config], tmp_path, heights=2, route="device", device="cpu")
    node = port_node.ValidatorNode(cfg, logger=_Quiet(), install_signal_handlers=False)
    node.scheduler.reconfigure(dispatcher=_FaultyDispatcher())
    with pytest.raises(RuntimeError, match="injected kernel fault"):
        asyncio.run(asyncio.wait_for(node.run(), 120))
    stats = node.scheduler.stats()
    assert stats["flush_faults"] >= 1 and all(t["sheds"] == 0 for t in stats["tenants"].values())
    assert node.runner.latest_height() == 0


def test_node_without_scheduler_takes_a_device_verifier(tmp_path):
    from go_ibft_tpu_torch.verify import DeviceBatchVerifier, HostBatchVerifier

    (cfg,) = _node_configs([config], tmp_path, heights=1, route="device", device="cpu")
    cfg.sched_enabled = False
    node = port_node.ValidatorNode(cfg, logger=_Quiet(), install_signal_handlers=False)
    assert isinstance(node.engine.batch_verifier, DeviceBatchVerifier)
    assert node.engine.batch_verifier.device == torch.device("cpu")
    cfg.sched_route = "host"
    host = port_node.ValidatorNode(cfg, logger=_Quiet(), install_signal_handlers=False)
    assert isinstance(host.engine.batch_verifier, HostBatchVerifier)


# -- the process -----------------------------------------------------------------


def test_check_validates_a_config(tmp_path):
    paths, _infos = build_fleet_configs(str(tmp_path), FleetSpec(nodes=2, device="cpu"))
    proc = subprocess.run([sys.executable, "-m", "go_ibft_tpu_torch.node", "--check", "--config", paths[0]],
                          capture_output=True, text=True, cwd=str(REPO), timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert json.loads(proc.stdout) == {"config_ok": True, "node": 0, "validators": 2, "peers": 1}
    assert 'device = "cpu"' in pathlib.Path(paths[0]).read_text()
    bad = tmp_path / "bad.toml"
    bad.write_text(pathlib.Path(paths[0]).read_text().replace('device = "cpu"', 'device = "gpu"'))
    proc = subprocess.run([sys.executable, "-m", "go_ibft_tpu_torch.node", "--check", "--config", str(bad)],
                          capture_output=True, text=True, cwd=str(REPO), timeout=120)
    assert proc.returncode == 2 and "[sched] device 'gpu'" in json.loads(proc.stdout)["config_error"]


def _boot_line(out_log: pathlib.Path) -> dict:
    deadline = time.monotonic() + 120.0
    while time.monotonic() < deadline:
        for line in out_log.read_text().splitlines():
            try:
                obj = json.loads(line)
            except ValueError:
                continue
            if "node_boot" in obj:
                return obj
        time.sleep(0.1)
    raise TimeoutError(f"no boot line in {out_log}")


def _drain_report(out_log: pathlib.Path) -> dict:
    for line in out_log.read_text().splitlines():
        try:
            obj = json.loads(line)
        except ValueError:
            continue
        if "chain_height" in obj:
            return obj
    raise AssertionError(f"no drain report in {out_log}")


def _head(port: int) -> int:
    try:
        with socket.create_connection(("127.0.0.1", port), 2.0) as s:
            s.settimeout(2.0)
            s.sendall(b"GET /head HTTP/1.1\r\nHost: t\r\nConnection: close\r\n\r\n")
            data = b""
            while chunk := s.recv(4096):
                data += chunk
        return json.loads(data.split(b"\r\n\r\n", 1)[1])["head"]
    except (OSError, ValueError, IndexError):
        return 0


def _stop(procs) -> None:
    for p in procs:
        if p.poll() is None:
            p.send_signal(signal.SIGTERM)
    for p in procs:
        try:
            p.wait(timeout=60.0)
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait(timeout=10.0)


def test_sigterm_drain_preserves_wal(tmp_path):
    """A solo port validator on the host route finalizing flat out;
    SIGTERM lands mid-run: rc 0, a drain report, every WAL record parses,
    and a restart on the same data_dir resumes at the drained height."""
    spec = FleetSpec(nodes=1, heights=0, route="host")
    paths, infos = build_fleet_configs(str(tmp_path), spec)
    procs = launch_fleet(paths, str(tmp_path))
    out_log = tmp_path / "node-0.out.log"
    try:
        wait_ready(infos, procs, 120.0)
        deadline = time.monotonic() + 60.0
        while _head(infos[0]["proof_port"]) < 3:
            assert time.monotonic() < deadline, "node never reached height 3"
            time.sleep(0.05)
        procs[0].send_signal(signal.SIGTERM)
        rc = procs[0].wait(timeout=60.0)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=10.0)
    assert rc == 0
    report = _drain_report(out_log)
    drained_height = report["chain_height"]
    assert drained_height >= 3 and report["sched"]["dispatcher"]["route"] == "host"
    wal_lines = pathlib.Path(report["wal_path"]).read_text().strip().splitlines()
    assert wal_lines and all(json.loads(line) for line in wal_lines)

    procs2 = launch_fleet(paths, str(tmp_path))
    try:
        assert _boot_line(out_log)["resumed_at_height"] >= drained_height
    finally:
        _stop(procs2)
    assert os.path.exists(report["trace_path"])
