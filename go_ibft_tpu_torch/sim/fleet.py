"""Multi-process fleet harness: N real validator processes + a client fleet
(the port of the JAX package's ``sim/fleet.py``).

Everything else in :mod:`go_ibft_tpu_torch.sim` simulates scale inside one
process; this module leaves the process.
:func:`run_fleet` launches ``spec.nodes`` REAL ``python -m
go_ibft_tpu_torch.node`` subprocesses gossiping IBFT over real TCP/gRPC
sockets, waits for every /readyz, then aims a client fleet at the proof
APIs:

* a :class:`ConnectionFleet` — ONE selectors thread holding
  ``spec.connections`` concurrent keep-alive sockets, each pulling
  ``GET /proof`` on a seeded think-time loop (p50/p99 + proofs/s
  evidence comes from here);
* seeded adversaries from the chaos matrix
  (:class:`~go_ibft_tpu_torch.chaos.ChurningClient` connection churn,
  :class:`~go_ibft_tpu_torch.chaos.SlowlorisClient` partial-request
  tricklers — the harness asserts every slowloris socket got cut);

while the chain finalizes underneath.  The run then performs the
cross-process acceptance checks over the WIRE (no process introspection):

* liveness — every node's ``/head`` reaches ``spec.heights`` within the
  window (``missed_heights`` counts the shortfall);
* agreement — the full-range proof fetched from EVERY node is
  byte-identical (``diverged_chains`` counts mismatches): one chain,
  proven through the untrusted-client API itself;
* spot verification — one fetched proof per node is cryptographically
  verified against the genesis validator set.

Finally each node gets SIGTERM (the graceful-drain path: fsync WAL,
export per-node trace, close listeners), the drain reports are parsed
off stdout, and the per-node trace files are merged into ONE
cross-process consensus timeline (:mod:`go_ibft_tpu_torch.obs.timeline` —
the flight recorder's intended endgame).  Every knob lives on
:class:`FleetSpec`; the whole run replays from the CHAOS-REPLAY line
(:func:`go_ibft_tpu_torch.chaos.fleet_replay_line`).

Differences from the JAX file: the nodes are the port's, verifying on the
card by default; :class:`FleetSpec` gains ``device`` (each node's
``[sched] device``: ``""`` the card, ``"cpu"`` when asked for) and
``route`` (each node's ``[sched] route``, ``"device"`` by default, the
JAX package's nodes' ``"host"`` when asked for), neither of which enters
the replay line, so seeded client plans, schedule digests and replay lines
are byte-identical to the JAX package's; the spot verification of the
fetched proofs runs on the same device; the nodes' environment is not
pinned to any platform; :func:`run_fleet` takes an ``on_live`` hook that
probes the live nodes (the chip smoke reads each node's ``/statusz`` and
``/profilez`` through it).
"""

from __future__ import annotations

import json
import os
import selectors
import signal
import socket
import subprocess
import sys
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

from ..chaos.clients import ChurningClient, SlowlorisClient, fleet_replay_line

__all__ = [
    "ConnectionFleet",
    "FleetResult",
    "FleetSpec",
    "alloc_ports",
    "build_fleet_configs",
    "run_fleet",
]

_REPO_ROOT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)


@dataclass
class FleetSpec:
    nodes: int = 4
    heights: int = 3  # liveness bound: every node must reach this
    connections: int = 64  # concurrent held client connections
    churn_clients: int = 2
    slowloris_clients: int = 2
    slowloris_conns: int = 4  # sockets per slowloris client
    seed: int = 7
    think_s: float = 0.5  # per-connection gap between proof pulls
    base_round_timeout_s: float = 10.0
    header_timeout_s: float = 1.0  # node-side slowloris cutoff
    max_connections: int = 2048  # node-side connection cap
    boot_timeout_s: float = 120.0
    run_timeout_s: float = 180.0
    drain_timeout_s: float = 60.0
    min_flood_s: float = 2.0  # flood at least this long before checks
    env: Dict[str, str] = field(default_factory=dict)
    device: str = ""  # each node's [sched] device: "" = the card
    route: str = "device"  # each node's [sched] route

    def fleet_config(self) -> dict:
        """The CHAOS-REPLAY config blob (shape + digest inputs)."""
        return {
            "nodes": self.nodes,
            "heights": self.heights,
            "connections": self.connections,
            "churn_clients": self.churn_clients,
            "slowloris_clients": self.slowloris_clients,
            "slowloris_conns": self.slowloris_conns,
            "think_s": self.think_s,
        }


@dataclass
class FleetResult:
    missed_heights: int
    diverged_chains: int
    heads: List[int]
    proofs_total: int
    proofs_s: float
    proof_p50_ms: Optional[float]
    proof_p99_ms: Optional[float]
    peak_connections: int
    client_errors: int
    verified_proofs: int
    churn: Dict[str, int]
    slowloris: Dict[str, int]
    reports: List[dict]
    trace_paths: List[str]
    timeline_heights: int
    finalize_p99_ms: Optional[float]
    replay_line: str
    elapsed_s: float
    live: object = None  # what run_fleet's on_live hook returned

    def summary(self) -> dict:
        return {
            "missed_heights": self.missed_heights,
            "diverged_chains": self.diverged_chains,
            "heads": self.heads,
            "proofs_total": self.proofs_total,
            "proofs_s": round(self.proofs_s, 2),
            "proof_p50_ms": self.proof_p50_ms,
            "proof_p99_ms": self.proof_p99_ms,
            "peak_connections": self.peak_connections,
            "client_errors": self.client_errors,
            "verified_proofs": self.verified_proofs,
            "churn": self.churn,
            "slowloris": self.slowloris,
            "timeline_heights": self.timeline_heights,
            "finalize_p99_ms": self.finalize_p99_ms,
            "elapsed_s": round(self.elapsed_s, 2),
        }


def alloc_ports(n: int) -> List[int]:
    """n distinct free TCP ports: bind-0, read, close.

    The classic small race (another process grabbing a port between
    close and the node's bind) is accepted — the node would fail its
    boot line and the harness reports it; retries belong to the caller.
    All sockets stay open until every port is read so the SAME port is
    never handed out twice.
    """
    socks, ports = [], []
    try:
        for _ in range(n):
            s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            s.bind(("127.0.0.1", 0))
            socks.append(s)
            ports.append(s.getsockname()[1])
    finally:
        for s in socks:
            s.close()
    return ports


def build_fleet_configs(
    root: str, spec: FleetSpec
) -> Tuple[List[str], List[dict]]:
    """Write one ``node-<i>.toml`` per validator under ``root``.

    Key material is derived per node (``fleet-node-<i>`` seeds); the
    shared ``[validators]`` table carries every derived address, so the
    processes agree on the committee without any shared state but the
    config files — exactly how a real deployment ships them.
    """
    from ..crypto import PrivateKey
    from ..node.config import (
        ConsensusConfig,
        NodeConfig,
        ProofApiConfig,
        TelemetryConfig,
        TraceConfig,
    )

    n = spec.nodes
    seeds = [f"fleet-node-{i}" for i in range(n)]
    keys = [PrivateKey.from_seed(s.encode()) for s in seeds]
    validators = {k.address.hex(): 1 for k in keys}
    # 3 ports per node: consensus gossip, proof API, telemetry.
    ports = alloc_ports(3 * n)
    infos, paths = [], []
    for i in range(n):
        consensus_port = ports[3 * i]
        proof_port = ports[3 * i + 1]
        telemetry_port = ports[3 * i + 2]
        peers = {
            f"node{j}": f"127.0.0.1:{ports[3 * j]}"
            for j in range(n)
            if j != i
        }
        cfg = NodeConfig(
            node_id=i,
            key_seed=seeds[i],
            data_dir=os.path.join(root, f"node-{i}"),
            validators=validators,
            heights=0,  # run until drained: the harness owns the window
            consensus=ConsensusConfig(
                listen=f"127.0.0.1:{consensus_port}",
                peers=peers,
                base_round_timeout_s=spec.base_round_timeout_s,
            ),
            proof_api=ProofApiConfig(
                listen=f"127.0.0.1:{proof_port}",
                max_connections=spec.max_connections,
                header_timeout_s=spec.header_timeout_s,
                idle_timeout_s=max(30.0, spec.think_s * 4),
            ),
            telemetry=TelemetryConfig(listen=f"127.0.0.1:{telemetry_port}"),
            trace=TraceConfig(enabled=True),
            sched_route=spec.route,
            sched_device=spec.device,
        )
        path = os.path.join(root, f"node-{i}.toml")
        with open(path, "w", encoding="utf-8") as fh:
            fh.write(cfg.to_toml())
        paths.append(path)
        infos.append(
            {
                "node": i,
                "address": keys[i].address.hex(),
                "consensus_port": consensus_port,
                "proof_port": proof_port,
                "telemetry_port": telemetry_port,
                "data_dir": cfg.data_dir,
            }
        )
    return paths, infos


# ---------------------------------------------------------------------------
# the honest client fleet
# ---------------------------------------------------------------------------

_REQUEST = (
    b"GET /proof?checkpoint=0 HTTP/1.1\r\nHost: fleet\r\n"
    b"User-Agent: fleet-client/0.1\r\n\r\n"
)


class _FleetConn:
    __slots__ = (
        "sock",
        "target",
        "buf",
        "sent_at",
        "next_at",
        "need",
        "head_done",
    )

    def __init__(self, sock, target) -> None:
        self.sock = sock
        self.target = target
        self.buf = b""
        self.sent_at: Optional[float] = None
        self.next_at = 0.0
        self.need: Optional[int] = None  # body bytes outstanding
        self.head_done = False


class ConnectionFleet:
    """``connections`` concurrent keep-alive proof pullers, one thread.

    Every connection loops send-request -> read-full-response -> think;
    think times come off a seeded stream so the load is replayable.
    Latency samples cover request-write to last-body-byte.  Connections
    the server closes (idle cutoff, drain) reconnect — sustained
    concurrency is the point, not socket identity.
    """

    def __init__(
        self,
        targets: List[Tuple[str, int]],
        *,
        connections: int,
        think_s: float,
        seed: int,
        request: bytes = _REQUEST,
        request_timeout_s: float = 30.0,
    ) -> None:
        import random

        self.targets = targets
        self.connections = connections
        self.think_s = think_s
        self.request = request
        self.request_timeout_s = request_timeout_s
        self._rng = random.Random(seed ^ 0xF1EE7)
        self.latencies_ms: List[float] = []
        self.proofs = 0
        self.errors = 0
        self.reconnects = 0
        self.peak_open = 0
        self.last_body: Dict[Tuple[str, int], bytes] = {}
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._lock = threading.Lock()

    def start(self) -> None:
        self._thread = threading.Thread(
            target=self._loop, name="fleet-clients", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=30.0)
            self._thread = None

    def snapshot(self) -> dict:
        with self._lock:
            lat = sorted(self.latencies_ms)
        out = {
            "proofs": self.proofs,
            "errors": self.errors,
            "reconnects": self.reconnects,
            "peak_open": self.peak_open,
            "p50_ms": _pct(lat, 0.50),
            "p99_ms": _pct(lat, 0.99),
        }
        return out

    # -- internals ------------------------------------------------------

    def _connect_one(self, sel, idx: int) -> bool:
        target = self.targets[idx % len(self.targets)]
        try:
            sock = socket.create_connection(target, timeout=5.0)
        except OSError:
            self.errors += 1
            return False
        sock.setblocking(False)
        conn = _FleetConn(sock, target)
        # Stagger first requests so N connections do not fire one
        # synchronized volley per think period.
        conn.next_at = time.monotonic() + self._rng.uniform(
            0.0, max(self.think_s, 0.05)
        )
        sel.register(sock, selectors.EVENT_READ, conn)
        return True

    def _loop(self) -> None:
        sel = selectors.DefaultSelector()
        want = self.connections
        opened = 0
        try:
            while not self._stop.is_set():
                # Build toward the target concurrency in slices — the
                # accept queue sees a ramp, not a SYN avalanche.
                while opened < want and not self._stop.is_set():
                    batch = min(64, want - opened)
                    done = sum(
                        1
                        for k in range(batch)
                        if self._connect_one(sel, opened + k)
                    )
                    opened += batch
                    if done == 0:
                        break
                open_now = len(sel.get_map())
                self.peak_open = max(self.peak_open, open_now)
                now = time.monotonic()
                for key in list(sel.get_map().values()):
                    conn = key.data
                    if not isinstance(conn, _FleetConn):
                        continue
                    if conn.sent_at is None and now >= conn.next_at:
                        try:
                            conn.sock.send(self.request)
                            conn.sent_at = time.monotonic()
                        except OSError:
                            self._recycle(sel, conn)
                    elif (
                        conn.sent_at is not None
                        and now - conn.sent_at > self.request_timeout_s
                    ):
                        self.errors += 1
                        self._recycle(sel, conn)
                for key, _mask in sel.select(timeout=0.05):
                    conn = key.data
                    if isinstance(conn, _FleetConn):
                        self._readable(sel, conn)
        finally:
            for key in list(sel.get_map().values()):
                if isinstance(key.data, _FleetConn):
                    try:
                        key.data.sock.close()
                    except OSError:
                        pass
            sel.close()

    def _recycle(self, sel, conn: _FleetConn) -> None:
        try:
            sel.unregister(conn.sock)
        except (KeyError, ValueError):
            pass
        try:
            conn.sock.close()
        except OSError:
            pass
        self.reconnects += 1
        # Reconnect to the same target to hold concurrency steady.
        try:
            sock = socket.create_connection(conn.target, timeout=5.0)
            sock.setblocking(False)
            fresh = _FleetConn(sock, conn.target)
            fresh.next_at = time.monotonic() + self._rng.uniform(
                0.0, max(self.think_s, 0.05)
            )
            sel.register(sock, selectors.EVENT_READ, fresh)
        except OSError:
            self.errors += 1

    def _readable(self, sel, conn: _FleetConn) -> None:
        try:
            chunk = conn.sock.recv(65536)
        except (BlockingIOError, InterruptedError):
            return
        except OSError:
            self._recycle(sel, conn)
            return
        if not chunk:
            self._recycle(sel, conn)
            return
        conn.buf += chunk
        if not conn.head_done:
            head, sep, rest = conn.buf.partition(b"\r\n\r\n")
            if not sep:
                return
            conn.head_done = True
            conn.buf = rest
            conn.need = 0
            for line in head.split(b"\r\n"):
                if line.lower().startswith(b"content-length:"):
                    try:
                        conn.need = int(line.split(b":", 1)[1].strip())
                    except ValueError:
                        pass
            ok = head.startswith(b"HTTP/1.1 200")
            if not ok:
                self.errors += 1
        if conn.need is not None and len(conn.buf) >= conn.need:
            body, conn.buf = conn.buf[: conn.need], conn.buf[conn.need :]
            if conn.sent_at is not None:
                sample = (time.monotonic() - conn.sent_at) * 1e3
                with self._lock:
                    self.latencies_ms.append(sample)
                self.proofs += 1
                self.last_body[conn.target] = body
            conn.sent_at = None
            conn.head_done = False
            conn.need = None
            conn.next_at = time.monotonic() + self.think_s * self._rng.uniform(
                0.5, 1.5
            )


def _pct(sorted_samples: List[float], q: float) -> Optional[float]:
    if not sorted_samples:
        return None
    idx = min(
        len(sorted_samples) - 1, int(round(q * (len(sorted_samples) - 1)))
    )
    return round(sorted_samples[idx], 3)


# ---------------------------------------------------------------------------
# orchestration
# ---------------------------------------------------------------------------


def _http_get(host: str, port: int, path: str, timeout: float = 5.0):
    """Tiny raw-socket GET -> (status, parsed json | None)."""
    try:
        with socket.create_connection((host, port), timeout=timeout) as s:
            s.settimeout(timeout)
            s.send(
                b"GET %s HTTP/1.1\r\nHost: fleet\r\nConnection: close\r\n\r\n"
                % path.encode()
            )
            data = b""
            while len(data) < (1 << 22):
                chunk = s.recv(65536)
                if not chunk:
                    break
                data += chunk
    except OSError:
        return None, None
    head, sep, body = data.partition(b"\r\n\r\n")
    # The proof API speaks HTTP/1.1; TelemetryServer (stdlib handler)
    # answers HTTP/1.0 — accept both.
    if not sep or not head.startswith(b"HTTP/1."):
        return None, None
    try:
        status = int(head.split(b" ", 2)[1])
    except (ValueError, IndexError):
        return None, None
    try:
        return status, json.loads(body.decode("utf-8"))
    except (ValueError, UnicodeDecodeError):
        return status, None


def launch_fleet(
    config_paths: List[str], run_dir: str, env: Optional[Dict[str, str]] = None
) -> List[subprocess.Popen]:
    """Spawn one ``python -m go_ibft_tpu_torch.node`` per config.

    stdout/stderr land in ``node-<i>.{out,err}.log`` under ``run_dir``
    (the boot line + drain report are parsed off the .out file — the
    ``boot/restart.py`` subprocess idiom)."""
    base_env = dict(os.environ)
    base_env.update(env or {})
    procs = []
    for i, path in enumerate(config_paths):
        out = open(os.path.join(run_dir, f"node-{i}.out.log"), "wb")
        err = open(os.path.join(run_dir, f"node-{i}.err.log"), "wb")
        procs.append(
            subprocess.Popen(
                [sys.executable, "-m", "go_ibft_tpu_torch.node", "--config", path],
                stdout=out,
                stderr=err,
                cwd=_REPO_ROOT,
                env=base_env,
            )
        )
        out.close()
        err.close()
    return procs


def wait_ready(
    infos: List[dict],
    procs: List[subprocess.Popen],
    timeout_s: float,
) -> None:
    """Block until every node's /readyz is 200 (or raise)."""
    deadline = time.monotonic() + timeout_s
    pending = {info["node"]: info for info in infos}
    while pending:
        for node_id, info in list(pending.items()):
            proc = procs[node_id]
            if proc.poll() is not None:
                raise RuntimeError(
                    f"node {node_id} exited rc={proc.returncode} before ready"
                )
            status, _payload = _http_get(
                "127.0.0.1", info["telemetry_port"], "/readyz", timeout=2.0
            )
            if status == 200:
                del pending[node_id]
        if pending:
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"nodes never ready: {sorted(pending)} "
                    f"(boot_timeout_s={timeout_s})"
                )
            time.sleep(0.1)


def _parse_reports(run_dir: str, n: int) -> List[dict]:
    reports = []
    for i in range(n):
        path = os.path.join(run_dir, f"node-{i}.out.log")
        report = {}
        try:
            with open(path, "rb") as fh:
                for raw in fh.read().splitlines():
                    try:
                        line = json.loads(raw.decode("utf-8"))
                    except (ValueError, UnicodeDecodeError):
                        continue
                    if "chain_height" in line:
                        report = line
        except OSError:
            pass
        reports.append(report)
    return reports


def _spot_verify(bodies: Dict[Tuple[str, int], bytes], validators, spec: FleetSpec) -> int:
    """Cryptographically verify one fetched proof per node (client side:
    exactly what an untrusted light client runs), on the fleet's device."""
    from ..serve import FinalityProof, ProofVerifier

    verified = 0
    verifier = ProofVerifier(device=spec.route != "host", torch_device=spec.device or None)
    try:
        for body in bodies.values():
            payload = json.loads(body.decode("utf-8"))
            proof = FinalityProof.from_wire(payload["proof"])
            verifier.verify(proof, validators)  # raises on a bad proof
            verified += 1
    finally:
        verifier.close()
    return verified


def run_fleet(
    spec: FleetSpec, run_dir: str, *, on_live: Optional[Callable[[List[dict]], object]] = None
) -> FleetResult:
    """The whole story; see the module docstring.  Blocking.

    ``on_live(infos)`` (the port's addition) runs while the nodes are up,
    once the liveness wait (met or timed out) and the flood window are
    over, with each node's ports (``build_fleet_configs``' infos); what it
    returns lands in :attr:`FleetResult.live` (a probe of ``/statusz`` or
    ``/profilez``)."""
    from ..crypto import PrivateKey
    from ..obs import timeline

    os.makedirs(run_dir, exist_ok=True)
    t0 = time.monotonic()
    config_paths, infos = build_fleet_configs(run_dir, spec)
    procs = launch_fleet(config_paths, run_dir, env=spec.env)
    fleet = None
    adversary_threads: List[threading.Thread] = []
    adversary_stop = threading.Event()
    churn_stats: List[Dict[str, int]] = []
    slow_clients: List[SlowlorisClient] = []
    snap: dict = {}
    flood_elapsed = 0.0
    live = None
    try:
        wait_ready(infos, procs, spec.boot_timeout_s)

        proof_targets = [
            ("127.0.0.1", info["proof_port"]) for info in infos
        ]
        fleet = ConnectionFleet(
            proof_targets,
            connections=spec.connections,
            think_s=spec.think_s,
            seed=spec.seed,
        )
        flood_t0 = time.monotonic()
        fleet.start()

        # Adversaries: churn + slowloris, round-robin over the nodes.
        def _run_churn(client: ChurningClient):
            churn_stats.append(client.run(adversary_stop))

        for cid in range(spec.churn_clients):
            host, port = proof_targets[cid % len(proof_targets)]
            client = ChurningClient(
                host, port, seed=spec.seed, client_id=cid
            )
            thread = threading.Thread(
                target=_run_churn, args=(client,), daemon=True
            )
            thread.start()
            adversary_threads.append(thread)
        for cid in range(spec.slowloris_clients):
            host, port = proof_targets[cid % len(proof_targets)]
            client = SlowlorisClient(
                host,
                port,
                seed=spec.seed,
                client_id=cid,
                conns=spec.slowloris_conns,
            )
            slow_clients.append(client)
            thread = threading.Thread(
                target=client.run, args=(adversary_stop,), daemon=True
            )
            thread.start()
            adversary_threads.append(thread)

        # Liveness: every head reaches spec.heights under the flood.
        deadline = time.monotonic() + spec.run_timeout_s
        heads = [0] * spec.nodes
        while time.monotonic() < deadline:
            for i, info in enumerate(infos):
                status, payload = _http_get(
                    "127.0.0.1", info["proof_port"], "/head", timeout=2.0
                )
                if status == 200 and payload:
                    heads[i] = max(heads[i], int(payload.get("head", 0)))
            if min(heads) >= spec.heights:
                break
            time.sleep(0.2)
        missed = sum(max(0, spec.heights - h) for h in heads)

        # Keep the flood up long enough to mean something even when the
        # chain finished instantly.
        remaining = spec.min_flood_s - (time.monotonic() - flood_t0)
        if remaining > 0:
            time.sleep(remaining)
        # Throughput evidence closes HERE — the agreement fetches below
        # are the harness's own (serial, long-range) requests and would
        # skew the concurrent fleet's proofs/s window.
        snap = fleet.snapshot()
        flood_elapsed = time.monotonic() - flood_t0
        if on_live is not None:
            live = on_live(infos)

        # Agreement, over the wire: fetch the full height range from
        # EVERY node and compare the per-height PROPOSALS (one chain).
        # Seal lists legitimately differ per node — each stores the
        # commit quorum it observed — so the comparison is proposal
        # bytes, not whole-proof bytes.  (Fetch AFTER liveness so the
        # range exists everywhere.)
        diverged = 0
        canonical = None
        proof_bodies: Dict[Tuple[str, int], bytes] = {}
        if missed == 0:
            for info in infos:
                status, payload = _http_get(
                    "127.0.0.1",
                    info["proof_port"],
                    f"/proof?checkpoint=0&target={spec.heights}",
                    timeout=30.0,
                )
                if status != 200 or not payload:
                    diverged += 1
                    continue
                proposals = [
                    (e["height"], e["proposal"])
                    for e in payload["proof"]["entries"]
                ]
                proof_bodies[
                    ("127.0.0.1", info["proof_port"])
                ] = json.dumps(payload).encode()
                if canonical is None:
                    canonical = proposals
                elif proposals != canonical:
                    diverged += 1
        else:
            diverged = spec.nodes  # liveness failed: agreement unproven

        verified = 0
        if proof_bodies:
            keys = [
                PrivateKey.from_seed(b"fleet-node-%d" % i)
                for i in range(spec.nodes)
            ]
            verified = _spot_verify(
                proof_bodies, {k.address: 1 for k in keys}, spec
            )

        # The server cuts a trickler at header_timeout_s, but the CLIENT
        # only observes the cut on its next trickle iteration — up to
        # ~0.5s of recv timeout per still-open socket, which a loaded
        # box can stretch past the flood window.  Hold the adversaries
        # open until every opened slowloris socket's cut has been
        # observed (sockets are opened once, so uncut only decreases);
        # on deadline, fall through and let the gate report it.
        cut_deadline = time.monotonic() + max(
            10.0, 8.0 * spec.header_timeout_s
        )
        while time.monotonic() < cut_deadline:
            if all(
                c.stats["cut_by_server"] >= c.stats["opened"]
                for c in slow_clients
            ):
                break
            time.sleep(0.2)
    finally:
        adversary_stop.set()
        if fleet is not None:
            fleet.stop()
        for thread in adversary_threads:
            thread.join(timeout=15.0)
        # Graceful drain: SIGTERM, wait, escalate only on a hang.
        for proc in procs:
            if proc.poll() is None:
                proc.send_signal(signal.SIGTERM)
        drain_deadline = time.monotonic() + spec.drain_timeout_s
        for proc in procs:
            try:
                proc.wait(timeout=max(0.1, drain_deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait(timeout=10.0)

    reports = _parse_reports(run_dir, spec.nodes)
    trace_paths = [
        r.get("trace_path")
        for r in reports
        if r.get("trace_path") and os.path.exists(r["trace_path"])
    ]

    # One cross-process timeline from N real processes' trace files.
    timeline_heights = 0
    finalize_p99_ms = None
    if trace_paths:
        files = [timeline.load_trace_file(p) for p in trace_paths]
        merged = timeline.merge_events(files)
        timelines = timeline.reconstruct(merged)
        spans = []
        for tl in timelines:
            crit = tl.to_dict().get("critical_path")
            if crit is None:
                continue
            timeline_heights += 1
            # Latency evidence covers the GATED window only: the chain
            # runs until SIGTERM, and heights past spec.heights finalize
            # at whatever pace the flood leaves them — including an
            # in-flight height whose finalize lands during drain.
            if (
                tl.height <= spec.heights
                and crit.get("total_us") is not None
            ):
                spans.append(crit["total_us"] / 1000.0)
        finalize_p99_ms = _pct(sorted(spans), 0.99)

    slow_stats = {
        "opened": sum(c.stats["opened"] for c in slow_clients),
        "cut_by_server": sum(c.stats["cut_by_server"] for c in slow_clients),
        "bytes_sent": sum(c.stats["bytes_sent"] for c in slow_clients),
        "connect_failures": sum(
            c.stats["connect_failures"] for c in slow_clients
        ),
    }
    churn_merged: Dict[str, int] = {}
    for stats in churn_stats:
        for key, value in stats.items():
            churn_merged[key] = churn_merged.get(key, 0) + value

    return FleetResult(
        missed_heights=missed,
        diverged_chains=diverged,
        heads=heads,
        proofs_total=snap.get("proofs", 0),
        proofs_s=(
            snap.get("proofs", 0) / flood_elapsed if flood_elapsed else 0.0
        ),
        proof_p50_ms=snap.get("p50_ms"),
        proof_p99_ms=snap.get("p99_ms"),
        peak_connections=snap.get("peak_open", 0),
        client_errors=snap.get("errors", 0),
        verified_proofs=verified,
        churn=churn_merged,
        slowloris=slow_stats,
        reports=reports,
        trace_paths=trace_paths,
        timeline_heights=timeline_heights,
        finalize_p99_ms=finalize_p99_ms,
        replay_line=fleet_replay_line(spec.seed, spec.fleet_config()),
        elapsed_s=time.monotonic() - t0,
        live=live,
    )
