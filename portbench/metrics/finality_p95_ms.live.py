"""95th percentile (nearest rank) over every height of the window of the time
from the PREPREPARE handed to the ingress to the runner's persisted finalize
(host clock)."""

from portbench.harness.record import p95


def read(run):
    return p95([(h.finalized_us - h.submitted_us) / 1e3 for h in getattr(run.window, "heights", ())])
