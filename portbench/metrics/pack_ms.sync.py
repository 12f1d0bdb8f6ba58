"""The verifier's ``verify.pack`` spans of kind ``seal_lanes`` in the window,
summed, per height fetched and verified."""


def read(run):
    if run.spans is None:
        return None
    heights = sum(r.heights for r in getattr(run.window, "requests", ()))
    spans = run.spans_named("verify.pack", kind="seal_lanes")
    if not heights or not spans:
        return None
    return sum(s[3] - s[2] for s in spans) / heights / 1e3
