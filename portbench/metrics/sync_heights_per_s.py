"""Heights fetched, verified and accepted by catch-up requests, over the whole
window's seconds (host clock).  The heights of a tampered range, which the
program must refuse, do not count; the time spent on them does."""


def read(run):
    requests = getattr(run.window, "requests", None)
    if not requests:
        return None
    return sum(r.heights for r in requests if r.accepted and r.tampered is None) / run.window_s
