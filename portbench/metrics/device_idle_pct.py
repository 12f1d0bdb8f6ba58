"""100 x (1 - the union of the card's events in the window / the window),
from the profiler's trace of the traced run.  It reads ``device_idle_pct.<x>``
for every cell that lists it, whatever its traffic."""


def read(run):
    busy = run.busy_s()
    if busy is None:
        return None
    return 100.0 * (1.0 - busy / run.window_s)
