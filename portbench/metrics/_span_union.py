"""What the readers of the program's host spans share: the union of the
named spans' intervals in the window, per finalized height (a live window) or
per height fetched and verified (a sync window), in ms.  Spans that nest or
overlap count once.  ``None`` where the window holds no such span."""

from portbench.harness.devtrace import covered, union


def per_height(run, *names):
    heights = getattr(run.window, "heights", None)
    n = len(heights) if heights is not None else sum(r.heights for r in getattr(run.window, "requests", ()))
    spans = [s for name in names for s in run.spans_named(name)]
    if not n or not spans:
        return None
    return covered(union([(s[2], s[3]) for s in spans]), run.start_us, run.end_us) / n / 1e3
