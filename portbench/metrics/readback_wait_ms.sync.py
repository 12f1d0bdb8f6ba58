"""The verifier pipeline's ``pipeline.readback`` spans in the window (waits
for a chunk's mask from the card), summed, per height fetched and verified:
what the double-buffered pipeline does not hide."""


def read(run):
    if run.spans is None:
        return None
    heights = sum(r.heights for r in getattr(run.window, "requests", ()))
    spans = run.spans_named("pipeline.readback")
    if not heights or not spans:
        return None
    return sum(s[3] - s[2] for s in spans) / heights / 1e3
