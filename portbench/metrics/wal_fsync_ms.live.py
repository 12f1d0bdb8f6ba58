"""The ``wal.fsync`` spans of the window (``chain/wal.py::_append``: the
``os.fsync`` of a lock or finalize record alone), the union of their intervals
in the window, per finalized height."""

from portbench.metrics._span_union import per_height


def read(run):
    return per_height(run, "wal.fsync")
