"""Per height, mean of the time from the PREPREPARE handed to the ingress to
the persisted finalize less the part of it that the scheduler's flushes
(``sched.coalesce`` and ``sched.dispatch`` spans, which hold the packing, the
launches and the readback) cover: the engine's, the ingress's and the log's
host work, and the waits between flushes."""

from portbench.harness.devtrace import union


def read(run):
    heights = getattr(run.window, "heights", None)
    if run.spans is None or not heights:
        return None
    flushes = union([(s[2], s[3]) for s in run.spans if s[0] in ("sched.coalesce", "sched.dispatch")])
    total, first = 0.0, 0
    for h in heights:  # in time order, one after another
        lo, hi = h.submitted_us, h.finalized_us
        while first < len(flushes) and flushes[first][1] <= lo:
            first += 1
        flushing, j = 0.0, first
        while j < len(flushes) and flushes[j][0] < hi:
            flushing += min(flushes[j][1], hi) - max(flushes[j][0], lo)
            j += 1
        total += (hi - lo) - flushing
    return total / len(heights) / 1e3
