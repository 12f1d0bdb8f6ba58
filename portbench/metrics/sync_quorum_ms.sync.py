"""The ``sync.quorum`` spans of the window
(``chain/sync.py::SyncClient.verify_blocks``: each height's valid signers and
their voting power against the quorum, after the drains), the union of their
intervals in the window, per height fetched and verified."""

from portbench.metrics._span_union import per_height


def read(run):
    return per_height(run, "sync.quorum")
