"""The ``wire.decode`` spans of the window (``messages/wire.py::IbftMessage.decode``:
one delivered message decoded from its wire bytes), the union of their
intervals in the window, per finalized height."""

from portbench.metrics._span_union import per_height


def read(run):
    return per_height(run, "wire.decode")
