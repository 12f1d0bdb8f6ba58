"""The ``sched.pack`` spans of the window (``sched/dispatch.py::_device``: a
flush's host packing and uploads, up to its first kernel launch), the union of
their intervals in the window, per finalized height."""

from portbench.metrics._span_union import per_height


def read(run):
    return per_height(run, "sched.pack")
