"""The ``sync.group`` and ``sync.lanes`` spans of the window
(``chain/sync.py::SyncClient.verify_blocks``: the blocks grouped by validator
snapshot, then each group's proposal hashes on the host and its lane list,
before the drain), the union of their intervals in the window, per height
fetched and verified."""

from portbench.metrics._span_union import per_height


def read(run):
    return per_height(run, "sync.group", "sync.lanes")
