"""One run of one cell: set-up, the measured window, the judgement, the
metrics, and the result line.

Everything a cell needs is found by name from ``BENCHMARK.json``: its
configuration's file, its traffic mix ``portbench/mixes/<traffic>.json``
(whose ``generator`` names the general generator in ``portbench/generators/``
that reads it), and one reader a metric, ``portbench/metrics/<name>.py``.
A new cell, configuration, mix or metric is new files and new entries.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import os
import subprocess
import sys
import time
from typing import Dict, List, Optional

from . import paths, roofline, signer
from .record import RunRecord

FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "go_ibft_tpu")
TRACE_RING = 4_000_000


def load_manifest(path: Optional[str] = None) -> dict:
    with open(path or os.path.join(paths.REPO_ROOT, "BENCHMARK.json")) as fh:
        return json.load(fh)


def cell_parts(manifest: dict, workload: str, mixes_dir: Optional[str] = None):
    """The workload entry, its configuration (the file's contents), its mix
    (from ``mixes_dir``, by default ``portbench/mixes``), and its end-to-end
    and per-layer metric entries."""
    cells = {w["name"]: w for w in manifest["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    conf = {c["name"]: c for c in manifest["configs"]}[cell["config"]]
    with open(os.path.join(paths.REPO_ROOT, conf["file"])) as fh:
        config = json.load(fh)
    with open(os.path.join(mixes_dir or os.path.join(paths.BENCH_DIR, "mixes"), cell["traffic"] + ".json")) as fh:
        mix = json.load(fh)

    def mine(metric: dict) -> bool:
        return "workloads" not in metric or workload in metric["workloads"]

    e2e = [m for m in manifest["end_to_end"] if mine(m)]
    moved = {m["name"] for m in e2e}
    layer = [m for m in manifest["per_layer"] if mine(m) and ("workloads" in m or m["moves"] in moved)]
    return cell, config, mix, e2e, layer


def reader_path(name: str) -> str:
    """``portbench/metrics/<name>.py``, or, where there is none, the file of
    the name without its last ``.suffix``: one reader for the same quantity
    read in cells that report different end-to-end metrics."""
    path = os.path.join(paths.BENCH_DIR, "metrics", name + ".py")
    if not os.path.exists(path) and "." in name:
        path = os.path.join(paths.BENCH_DIR, "metrics", name.rsplit(".", 1)[0] + ".py")
    return path


def _reader(name: str):
    path = reader_path(name)
    spec = importlib.util.spec_from_file_location("portbench_metric_" + name.replace(".", "_").replace("-", "_"),
                                                  path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN_MODULES))


def power_limit_w() -> Optional[float]:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader,nounits"],
                             capture_output=True, text=True, timeout=30)
        return float(out.stdout.strip().splitlines()[0])
    except (OSError, ValueError, IndexError, subprocess.TimeoutExpired):
        return None


def _recover_bound_s(lanes: List[tuple]) -> Optional[float]:
    """The recovery bound over ``(signed bytes, signature)`` of every lane
    the window took to the card (the cell's ``window_lanes()``)."""
    digests: Dict[bytes, bytes] = {}
    cache: Dict[bytes, int] = {}

    def ops(signed: Optional[bytes], sig: bytes) -> int:
        if sig not in cache:
            if signed is None:
                cache[sig] = 0
            else:
                digest = digests.get(signed)
                if digest is None:
                    digest = digests[signed] = signer.keccak256(signed)
                cache[sig] = roofline.lane_ops_of(digest, sig)
        return cache[sig]

    counts = [ops(signed, sig) for signed, sig in lanes]
    return roofline.bound_s(counts) if counts else None


def _breakdown(run: RunRecord) -> dict:
    """The device operations that took most time, and the card's idle time
    in the window by the innermost span open at each gap's middle."""
    import heapq

    from .devtrace import union

    by_name: Dict[str, float] = {}
    for name, a, b in run.device or ():
        by_name[name] = by_name.get(name, 0.0) + (b - a) / 1e6
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    busy = union([(max(a, run.start_us), min(b, run.end_us)) for _n, a, b in run.device or ()
                  if b > run.start_us and a < run.end_us])
    edges = [run.start_us] + [x for iv in busy for x in iv] + [run.end_us]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2) if edges[i + 1] > edges[i]]
    spans = sorted(run.spans or (), key=lambda s: s[2])
    idle: Dict[str, float] = {}
    open_spans: list = []  # (-start, end, name): the latest-starting on top
    k = 0
    for a, b in gaps:  # in time order, so a span that ended before one middle ends before the next
        mid = (a + b) / 2
        while k < len(spans) and spans[k][2] <= mid:
            heapq.heappush(open_spans, (-spans[k][2], spans[k][3], spans[k][0]))
            k += 1
        while open_spans and open_spans[0][1] < mid:
            heapq.heappop(open_spans)
        label = open_spans[0][2] if open_spans else "no span open"
        idle[label] = idle.get(label, 0.0) + (b - a) / 1e6
    gaps_out = sorted(idle.items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[n, s] for n, s in ops], "idle_gaps": [[n, s] for n, s in gaps_out]}


def _host() -> str:
    """The host's cores as this process sees them (for the record)."""
    import torch

    mhz = []
    try:
        with open("/proc/cpuinfo") as fh:
            mhz = [float(line.split(":")[1]) for line in fh if line.startswith("cpu MHz")]
    except OSError:
        pass
    return (f"{len(os.sched_getaffinity(0))} cores, torch threads {torch.get_num_threads()}, "
            f"MHz mean {sum(mhz) / len(mhz) if mhz else 0:.0f}, load {os.getloadavg()[0]:.2f}")


def _cpu_note(t0, t1) -> str:
    user, system = t1.user - t0.user, t1.system - t0.system
    return f"the process's CPU in the window {user + system:.2f} s (user {user:.2f}, system {system:.2f})"


def run_cell(workload: str, seed: int, seconds: float, trace: bool, device, *,
             process_start: float, fault: Optional[str] = None, manifest: Optional[dict] = None,
             workers: Optional[int] = None, mixes_dir: Optional[str] = None) -> dict:
    """Run ``workload`` once on ``device`` and return the result line's
    object (with its checks, and ``notes`` for standard error)."""
    import torch

    from go_ibft_tpu_torch.obs import trace as program_trace
    from go_ibft_tpu_torch.utils import metrics as program_metrics

    manifest = manifest or load_manifest()
    _entry, config, mix, e2e, layer = cell_parts(manifest, workload, mixes_dir)
    generator = importlib.import_module(f"portbench.generators.{mix['generator']}")
    cores = os.cpu_count() or 1
    workers = workers or min(8, cores)
    on_card = torch.device(device).type == "cuda"
    t_enter = time.monotonic()
    cell = generator.Cell(config, mix, seed, torch.device(device), fault=fault, threads=min(8, cores))
    t_built = time.monotonic()
    cell.warm()
    t_warm = time.monotonic()
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    profile = None
    if trace:
        program_trace.enable(TRACE_RING)
    if on_card and (trace or any(m["source"] == "device_trace" for m in e2e)):
        from .devtrace import DeviceProfile

        profile = DeviceProfile()
        profile.start()
    counters0 = program_metrics.counters_snapshot()
    window_start: Dict[str, float] = {}

    def on_start():
        window_start["t"] = time.monotonic()

    cpu0 = os.times()
    try:
        win = cell.window(seconds, on_start=on_start)
    finally:
        if profile is not None:
            profile.stop()
    cpu1 = os.times()
    # The profiler is the benchmark's instrument, not the program's set-up.
    instrument_s = profile.start_s if profile is not None else 0.0
    record = RunRecord(cell, win, window_start["t"] - process_start - instrument_s, win.start_us, win.end_us)
    record.counters = {k: v - counters0.get(k, 0) for k, v in program_metrics.counters_snapshot().items()
                       if v != counters0.get(k, 0)}
    if trace:
        spans = program_trace.recorder().snapshot()
        program_trace.disable()
        record.spans = [(s[1], s[2], s[3], s[3] + s[4], s[5]) for s in spans
                        if s[0] == "X" and s[3] + s[4] >= win.start_us and s[3] <= win.end_us]
        if profile is not None:
            record.recover_bound_s = _recover_bound_s(cell.window_lanes())
    if profile is not None:
        record.device = [e for e in profile.events() if e[2] > win.start_us and e[1] < win.end_us]
    memory_peak = int(torch.cuda.max_memory_allocated()) if on_card else 0
    cell.close()

    t_judge = time.monotonic()
    checks, notes = cell.judge(win, workers, on_card)
    timing = (f"timing: to run_cell {t_enter - process_start:.2f} s, traffic and stack {t_built - t_enter:.2f} s, "
              f"warm-up {t_warm - t_built:.2f} s, window {record.window_s:.2f} s, "
              f"judge {time.monotonic() - t_judge:.2f} s; {cell.describe(win)}; host: {_host()}")
    if profile is not None:
        timing += (f"; the profiler's start {profile.start_s:.1f} s (not in setup_s), "
                   f"its stop and read {profile.read_s:.1f} s")
    notes = list(getattr(win, "errors", [])) + notes + [timing + "; " + _cpu_note(cpu0, cpu1)]
    wanted = layer if trace else e2e
    metrics = {}
    for m in wanted:
        value = _reader(m["name"])(record)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    attempted, failed = cell.tally(win, checks)
    dev = {
        "platform": "gpu" if on_card else "cpu",
        "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
        "count": 1,
        "memory_peak_bytes": memory_peak,
        "power_limit_w": power_limit_w() if on_card else None,
    }
    result = {"correct": all(v <= 0 for v in checks.values()), "attempted": attempted, "failed": failed,
              "metrics": metrics, "device": dev}
    if trace and record.device is not None:
        dev["busy_s"] = record.busy_s()
        dev["window_s"] = record.window_s
        result["breakdown"] = _breakdown(record)
    result["checks"] = {k: {"value": v, "limit": 0} for k, v in checks.items()}
    result["notes"] = notes
    cell.cleanup()
    return result
