"""The card's busy time in the window (the union of its events in the
profiler's trace) per height finalized in the window: what one height costs
of the card, and so how many heights, or chains, one card can serve."""


def read(run):
    busy = run.busy_s()
    heights = getattr(run.window, "heights", None)
    if busy is None or not heights:
        return None
    return 1e3 * busy / len(heights)
