"""The ``engine.send`` spans of the window (``core/ibft.py``: a message the
engine builds and signs through its backend, then multicasts), the union of
their intervals in the window, per finalized height."""

from portbench.metrics._span_union import per_height


def read(run):
    return per_height(run, "engine.send")
