"""Zero-dependency telemetry HTTP endpoints: /metrics, /healthz, /readyz,
/statusz, /profilez (a copy of the JAX package's ``obs/httpd.py``).

Stdlib ``http.server`` only, like everything else in this repo — a
:class:`TelemetryServer` binds a ``ThreadingHTTPServer`` on localhost (or
a given host) and serves:

* ``GET /metrics``  — Prometheus text exposition of the whole metrics
  registry (:mod:`go_ibft_tpu_torch.obs.metrics_export`), cost-ledger families
  included when the ledger is enabled;
* ``GET /healthz``  — liveness JSON from the mounted ``health_fn``;
  HTTP 200 when healthy, 503 when not (a wedged runner flips this — the
  probe a fleet orchestrator restarts on);
* ``GET /readyz``   — readiness JSON from the mounted ``ready_fn``:
  200 only once the node may be routed traffic (recovered + first
  height finalized), 503 before that.  Distinct from liveness on
  purpose — a warm-starting node is alive (do not restart it) but not
  ready (do not send it clients yet); supervisors probe the two
  endpoints for the two decisions.  With no ``ready_fn`` mounted the
  endpoint reports ready (a mount that never warms has nothing to
  gate);
* ``GET /statusz``  — operator status JSON from ``status_fn`` (current
  height/round, breaker level, speculation hit rate, cache stats, ring
  ``dropped`` — whatever the mounting component provides), plus a
  ``cost_ledger`` block (dispatch/occupancy/compile totals) whenever the
  runtime cost ledger is on;
* ``GET /profilez?seconds=0.5`` — an on-demand ``torch.profiler`` window
  (:mod:`go_ibft_tpu_torch.obs.devprof`) on the server's
  ``profile_device`` (``None``: the card): captures the device's activity
  for the given window and returns the trace path + host-clock anchor,
  ready for ``obs/timeline.py::merge_device_trace``.  409 when a window is
  already open, 503 when the profiler is unavailable or recorded nothing
  on the device.  The ONLY non-read-only endpoint — it writes a trace file
  to a temp dir, never touches consensus state.  (``profile_device`` is
  the port's addition: the JAX package's profiler picks its own backend.)

Endpoints are default-off: nothing in the hot path starts a server;
``ChainRunner.start_telemetry`` (or an embedder) mounts one explicitly,
and the handler threads only ever read lock-guarded snapshots, so a
scrape can never block consensus.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Optional, Tuple
from urllib.parse import parse_qs

from ..utils.device import DeviceLike
from . import metrics_export
from . import ledger as cost_ledger

__all__ = ["TelemetryServer"]

StatusFn = Callable[[], dict]
HealthFn = Callable[[], Tuple[bool, dict]]
ReadyFn = Callable[[], Tuple[bool, dict]]


class _Handler(BaseHTTPRequestHandler):
    server_version = "go-ibft-telemetry/1"
    # The outer TelemetryServer injects these per server class (below).
    status_fn: Optional[StatusFn] = None
    health_fn: Optional[HealthFn] = None
    ready_fn: Optional[ReadyFn] = None
    profile_device: DeviceLike = None

    def do_GET(self) -> None:  # noqa: N802 - http.server API
        path, _, query = self.path.partition("?")
        try:
            if path == "/metrics":
                body = metrics_export.render_prometheus().encode("utf-8")
                self._reply(200, metrics_export.CONTENT_TYPE, body)
            elif path == "/healthz":
                ok, payload = (
                    self.health_fn() if self.health_fn is not None else (True, {})
                )
                payload = dict(payload)
                payload.setdefault("ok", ok)
                self._reply_json(200 if ok else 503, payload)
            elif path == "/readyz":
                ready, payload = (
                    self.ready_fn() if self.ready_fn is not None else (True, {})
                )
                payload = dict(payload)
                payload.setdefault("ready", ready)
                self._reply_json(200 if ready else 503, payload)
            elif path == "/statusz":
                payload = self.status_fn() if self.status_fn is not None else {}
                payload = dict(payload)
                # The ledger block rides every mount uniformly (runner,
                # bench, embedder) — None distinguishes "ledger off" from
                # "ledger on, nothing recorded".
                payload.setdefault("cost_ledger", cost_ledger.status())
                self._reply_json(200, payload)
            elif path == "/profilez":
                self._profilez(query)
            else:
                self._reply_json(404, {"error": "not found", "path": path})
        except Exception as err:  # noqa: BLE001 - a scrape must never crash
            # the serving thread; surface the failure to the scraper.
            try:
                self._reply_json(500, {"error": repr(err)})
            except OSError:
                pass  # client went away mid-error: nothing left to do

    def _profilez(self, query: str) -> None:
        """On-demand device-profiler window (see module docstring)."""
        from . import devprof

        params = parse_qs(query)
        try:
            seconds = float(params.get("seconds", ["0.5"])[0])
        except ValueError:
            self._reply_json(400, {"error": "seconds must be a number"})
            return
        result = devprof.capture(seconds, device=self.profile_device)
        if result.get("ok"):
            code = 200
        elif str(result.get("error", "")).startswith("busy"):
            code = 409
        else:
            code = 503
        self._reply_json(code, result)

    def _reply(self, code: int, content_type: str, body: bytes) -> None:
        self.send_response(code)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _reply_json(self, code: int, payload: dict) -> None:
        self._reply(
            code,
            "application/json",
            json.dumps(payload, default=str).encode("utf-8"),
        )

    def log_message(self, fmt: str, *args) -> None:  # silence per-request spam
        pass


class TelemetryServer:
    """Threaded localhost telemetry endpoint mount.

    ``port=0`` binds an ephemeral port (read it back from ``.port`` after
    :meth:`start`).  ``status_fn``/``health_fn`` are called per request on
    a handler thread — they must be cheap, thread-safe reads.
    """

    def __init__(
        self,
        *,
        status_fn: Optional[StatusFn] = None,
        health_fn: Optional[HealthFn] = None,
        ready_fn: Optional[ReadyFn] = None,
        host: str = "127.0.0.1",
        port: int = 0,
        profile_device: DeviceLike = None,
    ) -> None:
        self._host = host
        self._want_port = port
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None
        self.port: Optional[int] = None
        # Per-instance handler class so two servers in one process can
        # mount different status providers.
        self._handler = type(
            "_BoundHandler",
            (_Handler,),
            {"status_fn": staticmethod(status_fn) if status_fn else None,
             "health_fn": staticmethod(health_fn) if health_fn else None,
             "ready_fn": staticmethod(ready_fn) if ready_fn else None,
             "profile_device": profile_device},
        )

    def start(self) -> int:
        """Bind + serve on a daemon thread; returns the bound port."""
        if self._httpd is not None:
            raise RuntimeError("TelemetryServer already started")
        self._httpd = ThreadingHTTPServer(
            (self._host, self._want_port), self._handler
        )
        self._httpd.daemon_threads = True
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever,
            name=f"telemetry-{self.port}",
            daemon=True,
        )
        self._thread.start()
        return self.port

    @property
    def url(self) -> str:
        return f"http://{self._host}:{self.port}"

    def stop(self) -> None:
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
