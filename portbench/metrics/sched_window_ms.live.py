"""The ``sched.window`` spans of the window (``sched/scheduler.py::_loop``: the
scheduler thread waiting, pending requests in hand, for a full bucket or the
aged window), the union of their intervals in the window, per finalized
height."""

from portbench.metrics._span_union import per_height


def read(run):
    return per_height(run, "sched.window")
