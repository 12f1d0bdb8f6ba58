"""The port's host tracing tools against the JAX package's, on the CPU.

The same recorded spans, with the recorder's clock injected, go through both
packages' flight recorder, Chrome-trace export (``obs/export.py``) and
timeline tool (``obs/timeline.py``: ``load_trace_file``, ``merge_events``,
``reconstruct``, ``_phase_split``, ``render_report``, ``to_perfetto``): the
JSON documents and reports must be identical.  Two sources of spans: a fixed
script of the engine's records (``net.send``/``net.recv``, sequence bounds,
verify and drain spans) for a 4-node, 2-height loopback, and a 4-node
``ChainRunner`` chain in virtual time (``test_torch_chain``'s harness) with
the recorder on the loop's clock, exported per node through
``ChainRunner.export_trace``.  The Prometheus text of ``obs/metrics_export``
must match too, cost-ledger families included.
"""

import itertools
import json

import pytest
from test_torch_chain import PACKAGES, Cluster, LoopClock, pkg, run_virtual, virtual_clocks  # noqa: F401

NODES = [f"node-{i:02x}" * 2 for i in range(4)]


class _Ticks:
    """A ``time`` stand-in whose ``perf_counter_ns`` steps 37 µs a read."""

    def __init__(self):
        self._t = itertools.count(10_000_000, 37_000)

    def perf_counter_ns(self):
        return next(self._t)


@pytest.fixture
def obs_modules(monkeypatch):
    """Both packages' trace, export, timeline and clock modules, with fresh
    span ids and an empty clock-offset table; tracing off afterwards."""
    out = {}
    for name in PACKAGES:
        mods = {k: __import__(f"{name}.obs.{k}", fromlist=[k]) for k in ("trace", "export", "timeline", "clock")}
        monkeypatch.setattr(mods["trace"], "_span_id_counter", itertools.count(1))
        mods["clock"].reset()
        out[name] = mods
    yield out
    for mods in out.values():
        mods["trace"].disable()
        mods["clock"].reset()


def _script(trace):
    """The engine's records for 2 heights of a 4-node loopback cluster:
    node 0 proposes, every node prepares and commits, node 3 hears last."""
    for h in (1, 2):
        for node in NODES:
            trace.instant("sequence.start", track=node, height=h)
        span = trace.next_span_id()
        trace.instant("net.send", track=NODES[0], height=h, round=0, type=0, span=span)
        for node in NODES[1:]:
            trace.instant("net.recv", track=node, origin=NODES[0], height=h, round=0, type=0, span=span)
        for kind in (1, 2):  # PREPARE, COMMIT
            for sender in NODES:
                span = trace.next_span_id()
                trace.instant("net.send", track=sender, height=h, round=0, type=kind, span=span)
                for node in sorted(NODES, key=lambda n: n == NODES[3]):
                    trace.instant("net.recv", track=node, origin=sender, height=h, round=0, type=kind, span=span)
            for node in NODES:
                with trace.span("verify.drain", track=node, route="host", kind="senders", lanes=4):
                    with trace.span("verify.pack", kind="senders", lanes=4):
                        pass
                with trace.span(("prepare" if kind == 1 else "commit") + ".drain", track=node, height=h):
                    pass
        for node in NODES:
            with trace.span("chain.handoff", track=node, height=h):
                pass
            trace.instant("sequence.done", track=node, height=h)


def _documents(mods, records_of, tmp_path, name):
    """Export, reload, reconstruct and render through one package."""
    trace, export, timeline = mods["trace"], mods["export"], mods["timeline"]
    path = str(tmp_path / f"{name}.json")
    n = export.write_chrome_trace(path, node=NODES[0])
    with open(path) as fh:
        doc = json.load(fh)
    loaded = timeline.load_trace_file(path)
    timelines = timeline.reconstruct(timeline.merge_events([loaded]))
    splits = [timeline._phase_split(tl, tl.critical_node) for tl in timelines if tl.critical_node]
    perfetto = timeline.to_perfetto([loaded])
    for event in perfetto["traceEvents"]:  # the per-file source path differs by name only
        event.get("args", {}).pop("source", None)
    return {
        "events": n,
        "doc": doc,
        "records": records_of(trace),
        "timelines": [tl.to_dict() for tl in timelines],
        "splits": splits,
        "report": timeline.render_report(timelines),
        "perfetto": json.dumps(perfetto, sort_keys=True).replace(path, "<trace>"),
    }


def test_scripted_spans_export_and_report_identically(obs_modules, tmp_path, monkeypatch):
    results = []
    for name in PACKAGES:
        mods = obs_modules[name]
        monkeypatch.setattr(mods["trace"], "time", _Ticks())
        mods["trace"].enable()
        _script(mods["trace"])
        results.append(_documents(mods, lambda t: t.recorder().snapshot(), tmp_path, name))
        mods["trace"].disable()
    assert results[0] == results[1]
    ours = results[0]
    assert [tl["height"] for tl in ours["timelines"]] == [1, 2]
    assert ours["timelines"][0]["critical_node"] == NODES[3]
    assert ours["splits"][0]["verify_us"] > 0 and "height 2" in ours["report"]


def test_chain_runner_traces_export_and_report_identically(obs_modules, tmp_path, monkeypatch, virtual_clocks):
    """A 4-node chain, 3 heights, with the recorder on the virtual clock:
    every node's ``export_trace`` file and the timeline of node 3's."""
    results = []
    for name in PACKAGES:
        mods = obs_modules[name]
        # The recorder's clock and the engine's send stamps (``sent_us``).
        monkeypatch.setattr(mods["trace"], "time", LoopClock)
        monkeypatch.setattr(pkg(name).ibft, "time", LoopClock)
        mods["trace"].enable(1 << 16)

        async def body():
            cluster = Cluster(name, tmp_path / name)
            await cluster.run(3)
            return cluster

        cluster = run_virtual(body())
        files = []
        for i, runner in sorted(cluster.runners.items()):
            path = str(tmp_path / f"{name}-{i}.json")
            runner.export_trace(path)
            with open(path) as fh:
                files.append(json.load(fh))
        timeline = mods["timeline"]
        loaded = timeline.load_trace_file(str(tmp_path / f"{name}-3.json"))
        timelines = timeline.reconstruct(timeline.merge_events([loaded]))
        names = sorted({e["name"] for e in files[0]["traceEvents"]})
        results.append((files, [tl.to_dict() for tl in timelines], timeline.render_report(timelines), names))
        mods["trace"].disable()
    assert results[0] == results[1]
    files, timelines, report, names = results[0]
    assert {"chain.height", "chain.handoff", "verify.drain"} <= set(names)
    assert [tl["height"] for tl in timelines] == [1, 2, 3] and "critical" in report


def _metric_ops(m, ledger):
    m.reset()
    m.enable_fixed_histograms()
    try:
        for i in range(5):
            m.inc_counter(("go-ibft", "chain", "overlap_lanes"), i + 1)
            m.set_gauge(("go-ibft", "sequence", "duration"), 0.25 * i)
            m.observe(("go-ibft", "chain", "handoff_ms"), 0.125 * (i + 1))
            m.observe_fixed(("go-ibft", "latency", "verify_drain_ms", "device"), 0.5 * i)
            m.observe_fixed(("go-ibft", "latency", "wal_append_ms"), 3.0 * i)
        ledger.enable()
        ledger.record_dispatch("ecdsa_recover", "device", live=99, padded=128, ms=0.75)
        ledger.record_dispatch("quorum_certify", "host", live=4, padded=4, ms=1.5)
        ledger.add_device_ms("ecdsa_recover", "device", 0.5)
        ledger.record_compile("ecdsa_recover", 12.0, site="test")
    finally:
        m.disable_fixed_histograms()


def test_prometheus_text_matches_jax():
    texts = []
    for name in PACKAGES:
        metrics = __import__(f"{name}.utils.metrics", fromlist=["reset"])
        ledger = __import__(f"{name}.obs.ledger", fromlist=["enable"])
        metrics_export = __import__(f"{name}.obs.metrics_export", fromlist=["render_prometheus"])
        _metric_ops(metrics, ledger)
        metrics.enable_fixed_histograms()
        try:
            text = metrics_export.render_prometheus()
        finally:
            metrics.disable_fixed_histograms()
            ledger.disable()
            metrics.reset()
        texts.append((text, metrics_export.parse_exposition(text)))
    assert texts[0] == texts[1]
    assert "go_ibft_ledger_dispatches_total" in texts[0][0]
    assert texts[0][1]["go_ibft_chain_overlap_lanes_total"] == 15
