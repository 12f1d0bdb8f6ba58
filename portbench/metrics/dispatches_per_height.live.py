"""The scheduler's coalesced dispatches (its ``dispatches`` counter,
``sched/scheduler.py::DISPATCHES_KEY``) in the window, per finalized height."""

from go_ibft_tpu_torch.sched.scheduler import DISPATCHES_KEY


def read(run):
    heights = getattr(run.window, "heights", None)
    dispatches = run.counters.get(tuple(DISPATCHES_KEY))
    if not heights or dispatches is None:
        return None
    return dispatches / len(heights)
