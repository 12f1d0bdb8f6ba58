"""The proof API: the serve plane's first wire transport (the port of the
JAX package's ``node/proof_api.py``).

Serves :class:`~go_ibft_tpu_torch.serve.ProofServer` finality proofs to
**untrusted** clients over plain HTTP/1.1 + JSON — the wire format is
``serve/proof.py``'s existing codec (``FinalityProof.to_wire()``,
``PROOF_WIRE_VERSION``), so any light client that already speaks the
in-process codec speaks the socket one for free (docs/SERVING.md).

Endpoints::

    GET /head                          -> {"head": H}
    GET /proof?checkpoint=C[&target=T] -> {"version": 1, "head": H,
                                           "proof": <FinalityProof wire>}

Hostile-client posture — the reason this is NOT another
``ThreadingHTTPServer`` mount like :mod:`go_ibft_tpu_torch.obs.httpd`:

* **one IO thread, N sockets**: a ``selectors`` event loop owns every
  connection, so 1k-10k concurrent clients cost file descriptors, not
  threads — the fleet-harness acceptance shape (and the reason a
  slowloris army cannot exhaust a thread pool that does not exist);
* **bounded requests**: request line + headers are capped at
  ``max_request_bytes`` (431 + close past it) and only ``GET`` with no
  body is accepted (request smuggling surface: zero);
* **per-connection limits**: at ``max_connections`` open sockets new
  arrivals get an immediate 503 + close; a connection holding an
  INCOMPLETE request past ``header_timeout_s`` (the slowloris
  signature: bytes trickling forever) is cut; an idle keep-alive
  connection past ``idle_timeout_s`` is closed like any production
  front-end would;
* **isolated proof builds**: ``get_proof`` (chain reads + self-check
  crypto) runs on a small worker pool, never on the IO thread — a slow
  build delays its own client, not accepts/reads/timeout sweeps.

The consensus plane is untouched: this server only reads through the
``ProofServer``'s coalesced read tier (QoS: the TenantScheduler's
``read`` class), so a proof flood cannot starve a live round.
"""

from __future__ import annotations

import collections
import json
import selectors
import socket
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, Optional, Tuple

from ..obs import trace
from ..serve.proof import PROOF_WIRE_VERSION, ProofError
from ..utils import metrics

__all__ = ["ProofApiServer"]

REQUESTS_KEY = ("go-ibft", "node", "proof_api_requests")
REJECTED_CONN_KEY = ("go-ibft", "node", "proof_api_rejected_conns")
SLOW_CLOSE_KEY = ("go-ibft", "node", "proof_api_slow_closes")
IDLE_CLOSE_KEY = ("go-ibft", "node", "proof_api_idle_closes")
OVERSIZE_KEY = ("go-ibft", "node", "proof_api_oversize")

_MAX_HEADER_LINES = 64


class _Conn:
    """Per-socket state owned by the IO thread."""

    __slots__ = (
        "sock",
        "addr",
        "buf",
        "out",
        "last_activity",
        "request_started",
        "close_after_write",
        "inflight",
    )

    def __init__(self, sock: socket.socket, addr) -> None:
        self.sock = sock
        self.addr = addr
        self.buf = b""
        self.out = b""
        self.last_activity = time.monotonic()
        # Set while a PARTIAL request sits in ``buf`` (the slowloris
        # clock); cleared when a full request parses or the buf drains.
        self.request_started: Optional[float] = None
        self.close_after_write = False
        # A request is being built on the worker pool: reads pause (one
        # request in flight per connection; no pipelining).
        self.inflight = False


class ProofApiServer:
    """Bounded HTTP/1.1 JSON front-end over a :class:`ProofServer`.

    ``head_fn`` returns the latest finalized height (the runner's
    ``latest_height``); ``ready_fn``, when given, gates ``/proof`` with
    503 until the node is routable (the /readyz condition) so a
    warm-starting node never serves a stale chain to a client that
    found it before the load balancer did.

    ``checkpoints_fn`` serves ``GET /checkpoints`` — the
    epoch skip-chain payload a
    :class:`~go_ibft_tpu_torch.lightsync.client.CheckpointClient` anchors on.
    Wire a :class:`~go_ibft_tpu_torch.lightsync.checkpoint.Checkpointer`'s
    ``wire_payload`` here; without one the route answers 404.  Query
    params: ``epoch=<N>`` descends the skip path to epoch N instead of
    the latest, ``all=1`` serves the full linear epoch list (the
    measured baseline shape).  Builds run on the worker pool — lazy
    signing may pay pure-Python G2 work, never on the IO thread.
    """

    def __init__(
        self,
        proof_server,
        head_fn: Callable[[], int],
        *,
        host: str = "127.0.0.1",
        port: int = 0,
        max_connections: int = 1024,
        max_request_bytes: int = 8192,
        header_timeout_s: float = 5.0,
        idle_timeout_s: float = 30.0,
        workers: int = 2,
        ready_fn: Optional[Callable[[], Tuple[bool, dict]]] = None,
        checkpoints_fn: Optional[Callable[..., dict]] = None,
    ) -> None:
        self._proofs = proof_server
        self._head_fn = head_fn
        self._ready_fn = ready_fn
        self._checkpoints_fn = checkpoints_fn
        self._host = host
        self._want_port = port
        self.max_connections = max_connections
        self.max_request_bytes = max_request_bytes
        self.header_timeout_s = header_timeout_s
        self.idle_timeout_s = idle_timeout_s
        self._n_workers = max(1, workers)
        self.port: Optional[int] = None
        self._listener: Optional[socket.socket] = None
        self._selector: Optional[selectors.BaseSelector] = None
        self._thread: Optional[threading.Thread] = None
        self._pool: Optional[ThreadPoolExecutor] = None
        self._conns: Dict[socket.socket, _Conn] = {}
        # Worker -> IO thread handoff: finished responses queue here and
        # the socketpair write wakes the selector.
        self._done: collections.deque = collections.deque()
        self._wake_r: Optional[socket.socket] = None
        self._wake_w: Optional[socket.socket] = None
        self._stopping = threading.Event()
        self._stats_lock = threading.Lock()
        self.stats_counters = {
            "connections_total": 0,
            "requests": 0,
            "proofs_served": 0,
            "rejected_connections": 0,
            "slow_client_closes": 0,
            "idle_closes": 0,
            "oversize_requests": 0,
            "bad_requests": 0,
            "not_ready": 0,
            "checkpoints_served": 0,
        }

    # -- lifecycle ------------------------------------------------------

    def start(self) -> int:
        if self._thread is not None:
            raise RuntimeError("ProofApiServer already started")
        listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        listener.bind((self._host, self._want_port))
        listener.listen(min(1024, socket.SOMAXCONN * 4))
        listener.setblocking(False)
        self.port = listener.getsockname()[1]
        self._listener = listener
        self._wake_r, self._wake_w = socket.socketpair()
        self._wake_r.setblocking(False)
        self._selector = selectors.DefaultSelector()
        self._selector.register(listener, selectors.EVENT_READ, "accept")
        self._selector.register(self._wake_r, selectors.EVENT_READ, "wake")
        self._pool = ThreadPoolExecutor(
            max_workers=self._n_workers, thread_name_prefix="proof-api"
        )
        self._stopping.clear()
        self._thread = threading.Thread(
            target=self._loop, name=f"proof-api-{self.port}", daemon=True
        )
        self._thread.start()
        return self.port

    @property
    def url(self) -> str:
        return f"http://{self._host}:{self.port}"

    def stop(self) -> None:
        """Close the listener first (no new clients), then drain out."""
        if self._thread is None:
            return
        self._stopping.set()
        try:
            self._wake_w.send(b"x")
        except OSError:
            pass
        self._thread.join(timeout=10.0)
        self._thread = None
        if self._pool is not None:
            self._pool.shutdown(wait=False)
            self._pool = None

    def stats(self) -> dict:
        with self._stats_lock:
            out = dict(self.stats_counters)
        out["open_connections"] = len(self._conns)
        out["max_connections"] = self.max_connections
        return out

    def _count(self, key: str, n: int = 1) -> None:
        with self._stats_lock:
            self.stats_counters[key] += n

    # -- IO loop --------------------------------------------------------

    def _loop(self) -> None:
        try:
            while not self._stopping.is_set():
                events = self._selector.select(timeout=0.05)
                for key, mask in events:
                    what = key.data
                    if what == "accept":
                        self._accept()
                    elif what == "wake":
                        try:
                            self._wake_r.recv(4096)
                        except OSError:
                            pass
                    else:  # a connection
                        conn = what
                        if mask & selectors.EVENT_READ:
                            self._readable(conn)
                        if (
                            mask & selectors.EVENT_WRITE
                            and conn.sock in self._conns
                        ):
                            self._writable(conn)
                self._drain_done()
                self._sweep_timeouts()
        finally:
            for conn in list(self._conns.values()):
                self._close(conn)
            for sock in (self._listener, self._wake_r, self._wake_w):
                if sock is not None:
                    try:
                        sock.close()
                    except OSError:
                        pass
            self._selector.close()

    def _accept(self) -> None:
        for _ in range(64):  # accept in batches, never starve the loop
            try:
                sock, addr = self._listener.accept()
            except (BlockingIOError, OSError):
                return
            self._count("connections_total")
            if len(self._conns) >= self.max_connections:
                # Over the cap: tell the client it is load, not protocol.
                self._count("rejected_connections")
                metrics.inc_counter(REJECTED_CONN_KEY)
                try:
                    sock.send(
                        b"HTTP/1.1 503 Service Unavailable\r\n"
                        b"Content-Length: 0\r\nConnection: close\r\n\r\n"
                    )
                except OSError:
                    pass
                # Drain whatever request bytes already arrived: closing
                # with unread data RSTs the connection, and the RST can
                # destroy the 503 in the client's receive buffer before
                # it is read.
                try:
                    sock.setblocking(False)
                    while sock.recv(4096):
                        pass
                except OSError:
                    pass
                try:
                    sock.close()
                except OSError:
                    pass
                continue
            sock.setblocking(False)
            conn = _Conn(sock, addr)
            self._conns[sock] = conn
            self._selector.register(sock, selectors.EVENT_READ, conn)

    def _close(self, conn: _Conn) -> None:
        if conn.sock in self._conns:
            del self._conns[conn.sock]
            try:
                self._selector.unregister(conn.sock)
            except (KeyError, ValueError):
                pass
        try:
            conn.sock.close()
        except OSError:
            pass

    def _readable(self, conn: _Conn) -> None:
        try:
            chunk = conn.sock.recv(65536)
        except (BlockingIOError, InterruptedError):
            return
        except OSError:
            self._close(conn)
            return
        if not chunk:
            self._close(conn)
            return
        now = time.monotonic()
        conn.last_activity = now
        conn.buf += chunk
        if conn.inflight:
            # One request at a time; extra bytes wait in buf — but a
            # client that floods while we build is shedding, not waiting.
            if len(conn.buf) > self.max_request_bytes:
                self._count("oversize_requests")
                metrics.inc_counter(OVERSIZE_KEY)
                self._close(conn)
            return
        if len(conn.buf) > self.max_request_bytes:
            self._count("oversize_requests")
            metrics.inc_counter(OVERSIZE_KEY)
            self._respond(
                conn,
                431,
                {"error": "request too large"},
                close=True,
            )
            return
        if conn.request_started is None:
            conn.request_started = now
        head, sep, rest = conn.buf.partition(b"\r\n\r\n")
        if not sep:
            return  # incomplete: the slowloris clock is running
        conn.buf = rest
        conn.request_started = None
        self._dispatch(conn, head)

    def _writable(self, conn: _Conn) -> None:
        try:
            sent = conn.sock.send(conn.out)
        except (BlockingIOError, InterruptedError):
            return
        except OSError:
            self._close(conn)
            return
        conn.out = conn.out[sent:]
        conn.last_activity = time.monotonic()
        if conn.out:
            return
        if conn.close_after_write:
            self._close(conn)
            return
        self._selector.modify(conn.sock, selectors.EVENT_READ, conn)
        if conn.buf:
            # A pipelined follow-up arrived while we served: handle it.
            self._readable_buffered(conn)

    def _readable_buffered(self, conn: _Conn) -> None:
        head, sep, rest = conn.buf.partition(b"\r\n\r\n")
        if not sep:
            if conn.buf:
                conn.request_started = time.monotonic()
            return
        conn.buf = rest
        conn.request_started = None
        self._dispatch(conn, head)

    def _sweep_timeouts(self) -> None:
        now = time.monotonic()
        for conn in list(self._conns.values()):
            if conn.inflight:
                continue
            if conn.out:
                # Slow-read mirror of slowloris: a client that never
                # drains its response holds a socket hostage.
                if now - conn.last_activity > self.idle_timeout_s:
                    self._count("idle_closes")
                    metrics.inc_counter(IDLE_CLOSE_KEY)
                    self._close(conn)
                continue
            if (
                conn.request_started is not None
                and now - conn.request_started > self.header_timeout_s
            ):
                # Slowloris: a request that trickles header bytes forever.
                self._count("slow_client_closes")
                metrics.inc_counter(SLOW_CLOSE_KEY)
                trace.instant("node.proof_api.slow_close")
                self._respond(
                    conn, 408, {"error": "request header timeout"}, close=True
                )
            elif (
                conn.request_started is None
                and now - conn.last_activity > self.idle_timeout_s
            ):
                self._count("idle_closes")
                metrics.inc_counter(IDLE_CLOSE_KEY)
                self._close(conn)

    # -- request handling ------------------------------------------------

    def _dispatch(self, conn: _Conn, head: bytes) -> None:
        self._count("requests")
        metrics.inc_counter(REQUESTS_KEY)
        lines = head.split(b"\r\n")
        if len(lines) > _MAX_HEADER_LINES:
            self._count("bad_requests")
            self._respond(conn, 431, {"error": "too many headers"}, close=True)
            return
        parts = lines[0].split()
        if len(parts) != 3:
            self._count("bad_requests")
            self._respond(conn, 400, {"error": "bad request line"}, close=True)
            return
        method, target, _version = parts
        keep_alive = True
        has_body = False
        for line in lines[1:]:
            lowered = line.lower()
            if lowered.startswith(b"connection:") and b"close" in lowered:
                keep_alive = False
            if lowered.startswith((b"content-length:", b"transfer-encoding:")):
                has_body = True
        if method != b"GET":
            self._count("bad_requests")
            self._respond(
                conn, 405, {"error": "only GET"}, close=not keep_alive
            )
            return
        if has_body:
            # GET with a body is a smuggling vector, not a client.
            self._count("bad_requests")
            self._respond(conn, 400, {"error": "GET takes no body"}, close=True)
            return
        conn.close_after_write = not keep_alive
        try:
            path, _, query = target.decode("ascii").partition("?")
        except UnicodeDecodeError:
            self._count("bad_requests")
            self._respond(conn, 400, {"error": "bad target"}, close=True)
            return
        if path == "/head":
            self._respond(conn, 200, {"head": self._head_fn()})
            return
        if path == "/checkpoints":
            if self._checkpoints_fn is None:
                self._respond(conn, 404, {"error": "not found", "path": path})
                return
            if self._ready_fn is not None:
                ready, _payload = self._ready_fn()
                if not ready:
                    self._count("not_ready")
                    self._respond(conn, 503, {"error": "not ready"})
                    return
            params = {}
            for pair in query.split("&"):
                name, _, value = pair.partition("=")
                if name:
                    params[name] = value
            try:
                epoch = (
                    int(params["epoch"]) if params.get("epoch") else None
                )
            except ValueError:
                self._respond(conn, 400, {"error": "epoch must be an integer"})
                return
            include_all = params.get("all") in ("1", "true")
            # Lazy-signing checkpointers pay pure-Python G2 work building
            # the payload — that belongs on the pool, not the IO thread.
            conn.inflight = True
            self._pool.submit(self._build_checkpoints, conn, epoch, include_all)
            return
        if path != "/proof":
            self._respond(conn, 404, {"error": "not found", "path": path})
            return
        if self._ready_fn is not None:
            ready, _payload = self._ready_fn()
            if not ready:
                self._count("not_ready")
                self._respond(conn, 503, {"error": "not ready"})
                return
        params = {}
        for pair in query.split("&"):
            name, _, value = pair.partition("=")
            if name:
                params[name] = value
        try:
            checkpoint = int(params.get("checkpoint", ""))
            target_h = (
                int(params["target"]) if params.get("target") else None
            )
        except ValueError:
            self._respond(
                conn,
                400,
                {"error": "checkpoint/target must be integers"},
            )
            return
        # The expensive part leaves the IO thread here.
        conn.inflight = True
        self._pool.submit(self._build_proof, conn, checkpoint, target_h)

    def _build_proof(
        self, conn: _Conn, checkpoint: int, target: Optional[int]
    ) -> None:
        """Worker-pool side: build + encode, then hand bytes back."""
        try:
            with trace.span(
                "node.proof_api", checkpoint=checkpoint, target=target or -1
            ):
                proof = self._proofs.get_proof(checkpoint, target)
            payload = {
                "version": PROOF_WIRE_VERSION,
                "head": self._head_fn(),
                "proof": proof.to_wire(),
            }
            code = 200
            self._count("proofs_served")
        except ProofError as err:
            code, payload = 416, {"error": str(err)}
        except Exception as err:  # noqa: BLE001 - a client must get an
            # answer, and the IO loop must never die for one request
            code, payload = 500, {"error": repr(err)}
        self._done.append((conn, code, payload))
        try:
            self._wake_w.send(b"x")
        except OSError:
            pass

    def _build_checkpoints(
        self, conn: _Conn, epoch: Optional[int], include_all: bool
    ) -> None:
        """Worker-pool side of ``GET /checkpoints``."""
        try:
            from ..lightsync.checkpoint import CheckpointError
        except Exception:  # pragma: no cover - lightsync always present
            CheckpointError = ValueError  # noqa: N806
        try:
            with trace.span(
                "node.checkpoint_api",
                epoch=-1 if epoch is None else epoch,
                all=int(include_all),
            ):
                payload = self._checkpoints_fn(
                    target_epoch=epoch, include_all=include_all
                )
            payload = dict(payload)
            payload["head"] = self._head_fn()
            code = 200
            self._count("checkpoints_served")
        except CheckpointError as err:
            code, payload = 416, {"error": str(err)}
        except Exception as err:  # noqa: BLE001 - same contract as proofs:
            # the client gets an answer, the IO loop never dies for one
            code, payload = 500, {"error": repr(err)}
        self._done.append((conn, code, payload))
        try:
            self._wake_w.send(b"x")
        except OSError:
            pass

    def _drain_done(self) -> None:
        while self._done:
            conn, code, payload = self._done.popleft()
            conn.inflight = False
            if conn.sock in self._conns:
                self._respond(conn, code, payload)

    def _respond(
        self, conn: _Conn, code: int, payload: dict, *, close: bool = False
    ) -> None:
        reason = {
            200: "OK",
            400: "Bad Request",
            404: "Not Found",
            405: "Method Not Allowed",
            408: "Request Timeout",
            416: "Range Not Satisfiable",
            431: "Request Header Fields Too Large",
            500: "Internal Server Error",
            503: "Service Unavailable",
        }.get(code, "OK")
        body = json.dumps(payload).encode("utf-8")
        close = close or conn.close_after_write
        conn.close_after_write = close
        conn.out += (
            f"HTTP/1.1 {code} {reason}\r\n"
            f"Content-Type: application/json\r\n"
            f"Content-Length: {len(body)}\r\n"
            f"Connection: {'close' if close else 'keep-alive'}\r\n"
            f"\r\n"
        ).encode("ascii") + body
        if conn.sock in self._conns:
            self._selector.modify(
                conn.sock,
                selectors.EVENT_READ | selectors.EVENT_WRITE,
                conn,
            )
