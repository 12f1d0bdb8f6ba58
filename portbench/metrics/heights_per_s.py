"""Heights finalized and written to the log, over the whole window's seconds
(host clock; the window closes at the first height finalized after its
length, so it spans whole heights, the passes' restarts included)."""


def read(run):
    heights = getattr(run.window, "heights", None)
    if not heights:
        return None
    return len(heights) / run.window_s
