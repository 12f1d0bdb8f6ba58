"""Observability: the flight recorder (:mod:`.trace`, :mod:`.recorder`), the
cost ledger (:mod:`.ledger`), clock offsets (:mod:`.clock`), the Chrome-trace
export (:mod:`.export`), the timeline reconstruction (:mod:`.timeline`), the
Prometheus text (:mod:`.metrics_export`) and the telemetry endpoints
(:mod:`.httpd`): copies of the JAX package's modules of the same names.  Its
device profiler, evidence capture and gates are not ported yet, and /profilez
answers 501."""

from . import clock, ledger, trace
from .export import to_chrome_trace, write_chrome_trace
from .httpd import TelemetryServer
from .metrics_export import render_prometheus
from .recorder import RingRecorder

__all__ = [
    "RingRecorder",
    "TelemetryServer",
    "clock",
    "ledger",
    "render_prometheus",
    "to_chrome_trace",
    "trace",
    "write_chrome_trace",
]
