"""``DeviceBatchVerifier`` under concurrent callers, on the CPU.

The chain drives one verifier from several threads at once: the event loop's
drains, the overlap worker (``loop.run_in_executor``) and the speculator's
worker.  Two pieces of its state are shared between them:

* the pinned staging slots (``_Staging``): a slot handed to a caller stays
  that caller's from ``begin`` to ``finish``, so that no other caller
  rewrites its page-locked buffers while an upload from them may still be
  in flight, and it is reused only after the event of its last dispatch has
  completed.  Checked here with a stub event and many threads;
* the per-height caches (address tables, their device copies, the quorum
  packs and power vectors), evicted oldest-first: threads over distinct
  heights with ``cache_heights=2`` must never see a ``KeyError`` or a
  dictionary changing size mid-iteration, and every lookup must return its
  own height's table.

Python switches threads every 5 ms by default; the tests switch every
microsecond, and the validator source yields, so that the interleavings
that break an unguarded cache come up within a few hundred calls.  The
masks of concurrent drains on the card are held against the host oracle in
``tests/test_torch_cuda.py``.
"""

import sys
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from go_ibft_tpu_torch.verify.batch import DeviceBatchVerifier, _Staging, pack_validator_table

torch.set_num_threads(1)


@pytest.fixture
def fast_switching():
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    yield
    sys.setswitchinterval(old)


class _StubEvent:
    """An end-of-dispatch event that completes some microseconds after it
    is recorded; ``synchronize`` waits for that and counts the waits."""

    waits = 0

    def __init__(self):
        self.done_at = time.perf_counter() + 2e-5

    def synchronize(self):
        _StubEvent.waits += 1
        while time.perf_counter() < self.done_at:
            pass


def _run_threads(n, body):
    errors = []

    def guarded(i):
        try:
            body(i)
        except BaseException as err:  # noqa: BLE001 - reported below
            errors.append(err)

    threads = [threading.Thread(target=guarded, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    assert not any(t.is_alive() for t in threads), "a thread is stuck"
    return errors


@pytest.mark.parametrize("slots", [1, 2])
def test_staging_slot_is_held_from_begin_to_finish(fast_switching, slots):
    staging = _Staging(torch.device("cpu"), slots=slots, event=_StubEvent)
    held = set()
    lock = threading.Lock()
    events = {}

    def body(_):
        for _ in range(200):
            slot = staging.begin()
            with lock:
                assert slot not in held, f"slot {slot} handed out twice while held"
                held.add(slot)
                prior = events.get(slot)
            # The slot's last dispatch has completed before it is reused.
            assert prior is None or time.perf_counter() >= prior.done_at
            time.sleep(0)  # another caller runs while this one holds the slot
            with lock:
                held.discard(slot)
            done = staging.finish(slot)
            with lock:
                events[slot] = done

    _StubEvent.waits = 0
    assert _run_threads(6, body) == []
    assert _StubEvent.waits > 0


def test_staging_releases_the_slot_when_a_dispatch_raises():
    staging = _Staging(torch.device("cpu"), slots=1, event=_StubEvent)
    verifier = DeviceBatchVerifier(lambda h: {bytes([i]) * 20: 1 for i in range(4)}, device="cpu")
    verifier._staging = staging

    def boom(*_args, **_kwargs):
        raise RuntimeError("upload failed")

    verifier._upload = boom
    lanes = SimpleNamespace(live=np.ones(8, dtype=bool))
    for _ in range(2):  # a slot left held would block the second call forever
        with pytest.raises(RuntimeError, match="upload failed"):
            verifier._dispatch_async(lanes, None, None)
    assert staging.begin() == 0


def test_per_height_caches_under_concurrent_heights(fast_switching):
    def powers(height):
        time.sleep(0)  # yield inside the cache fill
        return {bytes([height % 251, i]) * 10: 1 + i for i in range(4)}

    verifier = DeviceBatchVerifier(powers, cache_heights=2, device="cpu")
    expected = {h: pack_validator_table(list(powers(h))) for h in range(1, 13)}

    def body(i):
        for k in range(150):
            h = 1 + (i * 3 + k) % 12
            assert verifier.supports_fused(h)
            table, plo, phi, quorum = verifier._quorum_pack(h)
            assert np.array_equal(table, expected[h])
            assert np.array_equal(verifier._table_dev(h).numpy().view(np.uint32), expected[h])
            dev_table, (plo_dev, _, _), _ = verifier._fused_pack(h, None)
            assert np.array_equal(dev_table.numpy().view(np.uint32), expected[h])
            assert np.array_equal(plo_dev.numpy(), plo) and quorum == 7

    assert _run_threads(8, body) == []
    for cache in (verifier._tables, verifier._tables_dev, verifier._quorum_packs, verifier._quorum_dev):
        assert len(cache) <= 2
