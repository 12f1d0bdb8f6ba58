"""The ``ingress.window`` spans of the window (``core/transport.py::BatchingIngress``:
from the first message put into an empty buffer to the start of its flush: the
timed coalescing wait where one is chosen, else the rest of the event loop's
tick, which in the live cell is the rest of the delivery burst and the
callbacks queued ahead of the flush), the union of their intervals in the
window, per finalized height."""

from portbench.metrics._span_union import per_height


def read(run):
    return per_height(run, "ingress.window")
