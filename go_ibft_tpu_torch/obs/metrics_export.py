"""Prometheus text-exposition rendering of the process metrics registry (a
copy of the JAX package's ``obs/metrics_export.py``).

Zero-dependency (like everything in ``obs/``): walks
:mod:`go_ibft_tpu_torch.utils.metrics` — gauges, monotonic counters, the
windowed deque histograms (rendered as ``_p50``/``_p99``/``_mean``/
``_max``/``_window_count`` gauges: their bounded window breaks true
summary semantics, so they are labeled for what they are), and the
fixed-bucket latency histograms (proper Prometheus ``histogram`` families
with cumulative ``_bucket{le=...}`` lines, ``_sum`` and ``_count``) —
into the text format every Prometheus-compatible scraper ingests
(``text/plain; version=0.0.4``).

Metric naming: a registry key tuple's first three parts become the metric
name (sanitized, joined with ``_``); any remaining parts become a ``tag``
label, so per-route / per-tenant keys like
``("go-ibft", "latency", "verify_drain_ms", "host")`` render as one
family ``go_ibft_latency_verify_drain_ms{tag="host"}`` with one series
per tag.
"""

from __future__ import annotations

import re
from typing import Dict, Iterable, List, Optional, Tuple

from ..utils import metrics

__all__ = ["render_prometheus", "metric_name", "CONTENT_TYPE"]

CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"

_SANITIZE = re.compile(r"[^a-zA-Z0-9_:]")
_LABEL_ESCAPE = str.maketrans({"\\": r"\\", '"': r"\"", "\n": r"\n"})


def _sanitize(part: str) -> str:
    clean = _SANITIZE.sub("_", str(part))
    if clean and clean[0].isdigit():
        clean = "_" + clean
    return clean


def metric_name(key: Tuple[str, ...]) -> Tuple[str, Optional[str]]:
    """Registry key -> (prometheus metric name, optional ``tag`` label)."""
    head = key[:3] if len(key) > 3 else key
    name = "_".join(_sanitize(p) for p in head)
    tag = "_".join(str(p) for p in key[3:]) if len(key) > 3 else None
    return name, tag


def _series(name: str, tag: Optional[str], extra: str = "") -> str:
    labels = []
    if tag is not None:
        labels.append(f'tag="{tag.translate(_LABEL_ESCAPE)}"')
    if extra:
        labels.append(extra)
    return f"{name}{{{','.join(labels)}}}" if labels else name


def _fmt(value: float) -> str:
    if value != value:  # NaN
        return "NaN"
    if isinstance(value, float) and value.is_integer():
        return str(int(value))
    return repr(float(value))


def _percentile(ordered: List[float], q: float) -> float:
    value = metrics.percentile(ordered, q)
    return 0.0 if value is None else value


def render_prometheus() -> str:
    """The full registry as Prometheus text exposition (one scrape)."""
    lines: List[str] = []
    typed: set = set()

    def emit_type(name: str, kind: str) -> None:
        if name not in typed:
            typed.add(name)
            lines.append(f"# TYPE {name} {kind}")

    # Gauges.
    gauges = metrics.gauges_snapshot()
    counters = metrics.counters_snapshot()
    windows = metrics.histograms_snapshot()
    for key in sorted(gauges):
        name, tag = metric_name(key)
        emit_type(name, "gauge")
        lines.append(f"{_series(name, tag)} {_fmt(gauges[key])}")

    # Monotonic counters.
    for key in sorted(counters):
        name, tag = metric_name(key)
        name += "_total"
        emit_type(name, "counter")
        lines.append(f"{_series(name, tag)} {counters[key]}")

    # Windowed deque histograms: summary-ish gauges over the window.
    for key in sorted(windows):
        samples = sorted(windows[key])
        if not samples:
            continue
        name, tag = metric_name(key)
        for suffix, value in (
            ("_p50", _percentile(samples, 0.50)),
            ("_p99", _percentile(samples, 0.99)),
            ("_mean", sum(samples) / len(samples)),
            ("_max", samples[-1]),
            ("_window_count", float(len(samples))),
        ):
            emit_type(name + suffix, "gauge")
            lines.append(f"{_series(name + suffix, tag)} {_fmt(value)}")

    # Fixed-bucket histograms: real Prometheus histogram families.
    fixed = metrics.fixed_histograms_snapshot()
    for key in sorted(fixed):
        name, tag = metric_name(key)
        hist = fixed[key]
        emit_type(name, "histogram")
        cumulative = 0
        for bound, count in zip(hist["bounds"], hist["counts"]):
            cumulative += count
            le = 'le="' + _fmt(float(bound)) + '"'
            lines.append(f"{_series(name + '_bucket', tag, le)} {cumulative}")
        inf = 'le="+Inf"'
        lines.append(f"{_series(name + '_bucket', tag, inf)} {hist['count']}")
        lines.append(f"{_series(name + '_sum', tag)} {_fmt(hist['sum'])}")
        lines.append(f"{_series(name + '_count', tag)} {hist['count']}")

    _render_ledger(lines, emit_type)
    return "\n".join(lines) + "\n"


def _render_ledger(lines: List[str], emit_type) -> None:
    """Cost-ledger families: per-(program, route) dispatch
    counters + occupancy gauges and per-program compile accumulators.
    Nothing renders while the ledger is disabled."""
    from . import ledger as cost_ledger

    snap = cost_ledger.snapshot()
    if snap is None:
        return

    def esc(v: str) -> str:
        return str(v).translate(_LABEL_ESCAPE)

    # Family-major iteration: a family's series must form ONE contiguous
    # group after its TYPE line (the text-format grouping rule strict
    # scrapers enforce) — same discipline as the renderers above.
    rows = snap["dispatches"]
    labels = [
        f'program="{esc(row["program"])}",route="{esc(row["route"])}"'
        for row in rows
    ]
    for family, field, kind in (
        ("go_ibft_ledger_dispatches_total", "dispatches", "counter"),
        ("go_ibft_ledger_lanes_live_total", "live_lanes", "counter"),
        ("go_ibft_ledger_lanes_padded_total", "padded_lanes", "counter"),
        ("go_ibft_ledger_device_ms_total", "device_ms", "counter"),
        ("go_ibft_ledger_occupancy", "occupancy", "gauge"),
    ):
        for row, label in zip(rows, labels):
            value = row[field]
            if value is None:
                continue
            emit_type(family, kind)
            lines.append(f"{family}{{{label}}} {_fmt(float(value))}")
    for family, field in (
        ("go_ibft_ledger_compiles_total", "count"),
        ("go_ibft_ledger_compile_ms_total", "ms"),
    ):
        for program in sorted(snap["compiles"]):
            acc = snap["compiles"][program]
            emit_type(family, "counter")
            lines.append(
                f"{family}{{program=\"{esc(program)}\"}} {_fmt(float(acc[field]))}"
            )


def parse_exposition(text: str) -> Dict[str, float]:
    """Minimal parser for tests and the smoke scraper: series -> value.

    Validates the shape as it goes (every non-comment line must be
    ``<series> <number>``) — raises ``ValueError`` on anything a real
    Prometheus scraper would reject.
    """
    out: Dict[str, float] = {}
    for raw in text.splitlines():
        line = raw.strip()
        if not line or line.startswith("#"):
            continue
        parts = line.rsplit(" ", 1)
        if len(parts) != 2:
            raise ValueError(f"malformed exposition line: {raw!r}")
        series, value = parts
        out[series] = float(value)
    return out
