"""Client-side chaos: adversarial HTTP clients for the proof-API fleet (a
copy of the JAX package's ``chaos/clients.py``; its client plans, schedule
digests and replay lines are byte-identical to the JAX package's).

The transport/verify wrappers in this package attack the consensus
plane; these attack the SERVE plane the way the open internet does —
from outside the process, over real sockets, against the node's proof
API (:mod:`go_ibft_tpu_torch.node.proof_api`).  Two shapes, both seeded and
replayable:

* :class:`SlowlorisClient` — opens connections and trickles a partial
  HTTP request a few bytes at a time, forever.  A correct server cuts
  each one off at its header timeout; a thread-per-connection server
  without one would bleed capacity until the honest fleet starves.
  The wrapper counts how many of its sockets the server cut — the
  fleet harness asserts it was ALL of them.
* :class:`ChurningClient` — connect / one request / close in a tight
  loop, the connection-churn load pattern (mobile clients, NAT
  timeouts, crash-looping SDKs).  Exercises accept-path overhead and
  the connection cap's 503 shedding.

Counting rides the package convention — ``("go-ibft", "chaos", kind)``
counters + ``chaos.<kind>`` trace instants — and every decision stream
derives from one seed, so :func:`fleet_replay_line` emits the standard
``CHAOS-REPLAY`` artifact (``scripts/chaos_replay.py --line`` replays
the client plan against a fresh in-process server and re-verifies the
schedule digest).
"""

from __future__ import annotations

import hashlib
import json
import random
import socket
import threading
from typing import Dict, List

from ..obs import trace
from ..utils import metrics

__all__ = [
    "ChurningClient",
    "SlowlorisClient",
    "client_schedule_digest",
    "fleet_replay_line",
]

SLOWLORIS_KEY = ("go-ibft", "chaos", "client_slowloris_bytes")
CHURN_KEY = ("go-ibft", "chaos", "client_churn_conns")

# One partial request, fed byte-by-byte: a legitimate-looking prefix so
# the server cannot tell it from a slow phone until the timeout trips.
_SLOWLORIS_PREFIX = (
    b"GET /proof?checkpoint=0 HTTP/1.1\r\n"
    b"Host: fleet\r\n"
    b"User-Agent: slow-client/0.1\r\n"
    b"X-Padding: "
)


def _stream(seed: int, client_id: int, kind: str) -> random.Random:
    """Per-client decision stream: one seed fans out deterministically."""
    digest = hashlib.sha256(
        b"%d|%s|%d" % (seed, kind.encode(), client_id)
    ).digest()
    return random.Random(int.from_bytes(digest[:8], "big"))


class SlowlorisClient:
    """``conns`` sockets trickling partial requests at a target.

    ``run(stop)`` blocks until ``stop`` is set (the harness drives it on
    a thread); :attr:`stats` reports opened/cut counts.  Every sleep and
    chunk size comes from the seeded stream — two runs with one seed
    produce the identical byte schedule.
    """

    def __init__(
        self,
        host: str,
        port: int,
        *,
        seed: int,
        client_id: int = 0,
        conns: int = 4,
        trickle_interval_s: float = 0.25,
    ) -> None:
        self.host = host
        self.port = port
        self.conns = conns
        self.trickle_interval_s = trickle_interval_s
        self._rng = _stream(seed, client_id, "slowloris")
        self.stats: Dict[str, int] = {
            "opened": 0,
            "cut_by_server": 0,
            "bytes_sent": 0,
            "connect_failures": 0,
        }

    def run(self, stop: threading.Event) -> Dict[str, int]:
        socks: List[socket.socket] = []
        sent: List[int] = []
        for _ in range(self.conns):
            try:
                s = socket.create_connection(
                    (self.host, self.port), timeout=5.0
                )
                s.setblocking(True)
                s.settimeout(0.5)
                socks.append(s)
                sent.append(0)
                self.stats["opened"] += 1
            except OSError:
                self.stats["connect_failures"] += 1
        trace.instant("chaos.client_slowloris", conns=len(socks))
        alive = list(range(len(socks)))
        while alive and not stop.is_set():
            for idx in list(alive):
                s = socks[idx]
                # 1-3 bytes per tick: far below any byte-rate heuristic,
                # exactly the pathology the header timeout exists for.
                n = self._rng.randint(1, 3)
                offset = sent[idx]
                chunk = (_SLOWLORIS_PREFIX * 64)[offset : offset + n]
                try:
                    s.send(chunk)
                    sent[idx] += n
                    self.stats["bytes_sent"] += n
                    metrics.inc_counter(SLOWLORIS_KEY, n)
                except OSError:
                    # Server cut us off — the defense worked.
                    self.stats["cut_by_server"] += 1
                    alive.remove(idx)
                    continue
                # A FIN from the server also means we were cut.
                try:
                    if s.recv(4096) == b"":
                        self.stats["cut_by_server"] += 1
                        alive.remove(idx)
                except socket.timeout:
                    pass
                except OSError:
                    self.stats["cut_by_server"] += 1
                    alive.remove(idx)
            stop.wait(
                self.trickle_interval_s * self._rng.uniform(0.5, 1.5)
            )
        for s in socks:
            try:
                s.close()
            except OSError:
                pass
        return dict(self.stats)


class ChurningClient:
    """Connect / one ``GET /head`` / close, in a seeded tight loop."""

    def __init__(
        self,
        host: str,
        port: int,
        *,
        seed: int,
        client_id: int = 0,
        interval_s: float = 0.05,
    ) -> None:
        self.host = host
        self.port = port
        self.interval_s = interval_s
        self._rng = _stream(seed, client_id, "churn")
        self.stats: Dict[str, int] = {
            "churns": 0,
            "responses": 0,
            "rejected_503": 0,
            "errors": 0,
        }

    def run(self, stop: threading.Event) -> Dict[str, int]:
        trace.instant("chaos.client_churn")
        while not stop.is_set():
            try:
                s = socket.create_connection(
                    (self.host, self.port), timeout=5.0
                )
                s.settimeout(5.0)
                s.send(
                    b"GET /head HTTP/1.1\r\nHost: fleet\r\n"
                    b"Connection: close\r\n\r\n"
                )
                data = b""
                while b"\r\n\r\n" not in data and len(data) < 65536:
                    chunk = s.recv(4096)
                    if not chunk:
                        break
                    data += chunk
                s.close()
                self.stats["churns"] += 1
                metrics.inc_counter(CHURN_KEY)
                if data.startswith(b"HTTP/1.1 200"):
                    self.stats["responses"] += 1
                elif data.startswith(b"HTTP/1.1 503"):
                    self.stats["rejected_503"] += 1
                elif not data:
                    self.stats["errors"] += 1
            except OSError:
                self.stats["errors"] += 1
            stop.wait(self.interval_s * self._rng.uniform(0.5, 1.5))
        return dict(self.stats)


# ---------------------------------------------------------------------------
# replay contract
# ---------------------------------------------------------------------------


def client_schedule_digest(
    seed: int, churn_clients: int, slowloris_clients: int, n: int = 64
) -> str:
    """Fingerprint of every client's first ``n`` decisions — the
    schedule half of the fleet CHAOS-REPLAY line.  Mirrors
    ``FaultInjector.schedule_digest``: replaying with the same seed MUST
    rebuild the same digest or the replay is not the same scenario."""
    h = hashlib.sha256()
    for kind, count in (
        ("churn", churn_clients),
        ("slowloris", slowloris_clients),
    ):
        for client_id in range(count):
            rng = _stream(seed, client_id, kind)
            h.update(kind.encode())
            h.update(client_id.to_bytes(2, "big"))
            for _ in range(n):
                if kind == "slowloris":
                    h.update(rng.randint(1, 3).to_bytes(1, "big"))
                h.update(int(rng.uniform(0.5, 1.5) * 1e6).to_bytes(4, "big"))
    return h.hexdigest()[:16]


def fleet_replay_line(seed: int, fleet_config: dict) -> str:
    """The fleet run's ``CHAOS-REPLAY`` artifact line.

    ``fleet_config`` must carry ``churn_clients``/``slowloris_clients``
    (the digest inputs) plus whatever shape fields the harness wants
    reproduced (nodes/heights/connections).  Parsed back by
    ``go_ibft_tpu_torch.sim.parse_replay_line``; dispatched by
    ``scripts/chaos_replay.py --line`` on the ``fleet`` key.
    """
    digest = client_schedule_digest(
        seed,
        int(fleet_config.get("churn_clients", 0)),
        int(fleet_config.get("slowloris_clients", 0)),
    )
    blob = json.dumps({"fleet": fleet_config}, sort_keys=True)
    return f"CHAOS-REPLAY seed={seed} schedule={digest} config={blob}"
