"""The ``sched.dispatch`` spans of the window (``CoalescedDispatcher`` packs,
launches and reads back inside one), summed, per finalized height."""


def read(run):
    heights = getattr(run.window, "heights", None)
    if run.spans is None or not heights:
        return None
    total = sum(s[3] - s[2] for s in run.spans_named("sched.dispatch"))
    return total / len(heights) / 1e3
