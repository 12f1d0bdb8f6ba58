"""Observability: the flight recorder (:mod:`.trace`, :mod:`.recorder`), the
cost ledger (:mod:`.ledger`), clock offsets (:mod:`.clock`), the Chrome-trace
export (:mod:`.export`), the timeline reconstruction (:mod:`.timeline`), the
Prometheus text (:mod:`.metrics_export`), the telemetry endpoints
(:mod:`.httpd`), the regression and SLO gates (:mod:`.gates`), the device
profiler behind /profilez (:mod:`.devprof`, a ``torch.profiler`` window) and
the hang-proof card probe with its evidence writer (:mod:`.evidence`): the
counterparts of the JAX package's modules of the same names."""

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
