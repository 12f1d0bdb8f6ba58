"""Restart-to-first-finalized harness: one full boot in one process (the
port of the JAX package's ``python -m go_ibft_tpu.boot``).

``python -m go_ibft_tpu_torch.boot --programs digest_words_8l`` performs a
production-shaped boot — warm-start the requested pinned programs on the
device (recorded cold builds on a cold kernel build cache, library loads on
a warm one), then bring up a small real-crypto cluster and finalize its
first height — and prints one JSON line with the measured milestones.  Run
twice against one ``GO_IBFT_TORCH_CACHE_DIR`` (``boot/restart.py``), the
first boot pays the ``nvcc`` builds and the second proves the cache: its
compile ledger (``GO_IBFT_COMPILE_LEDGER``) holds ZERO cold events.

Timing origin is module entry (``entry_to_first_finalized_ms``); the
interpreter and import tax is the parent's to measure.

Differences from the JAX file: no ``XLA_FLAGS`` preamble; ``--device``
(default: the card; ``cpu`` only when asked for) is where the programs and
the cluster's verification run, and ``platform`` in the line is the card's
(``gpu``) or ``cpu``.  Each engine of the cluster verifies through a
:class:`~go_ibft_tpu_torch.verify.DeviceBatchVerifier` on that device,
where the JAX harness uses ``HostBatchVerifier``: on the card what a
restart pays is exactly the first kernel load, so the cluster's path must
carry it.
"""

import argparse
import json
import os
import sys
import time

_T_ENTRY = time.perf_counter()


def _first_finalized_ms(nodes: int, heights: int, device) -> float:
    """Bring up an in-process real-crypto cluster, every engine verifying
    through a ``DeviceBatchVerifier`` on ``device``, and finalize
    ``heights``; returns the wall from cluster construction to the last
    finalize."""
    import asyncio

    from ..chain import ChainRunner
    from ..core import IBFT, BatchingIngress
    from ..crypto import PrivateKey
    from ..crypto.backend import ECDSABackend
    from ..verify import DeviceBatchVerifier

    class _Null:
        def info(self, *a):
            pass

        debug = error = info

    t0 = time.perf_counter()
    keys = [PrivateKey.from_seed(b"boot-harness-%d" % i) for i in range(nodes)]
    src = ECDSABackend.static_validators({k.address: 1 for k in keys})
    cluster = []

    def gossip(message):
        for _core, ingress in cluster:
            ingress.submit(message)

    class _T:
        def multicast(self, message):
            gossip(message)

    runners = []
    for key in keys:
        core = IBFT(
            _Null(),
            ECDSABackend(key, src),
            _T(),
            batch_verifier=DeviceBatchVerifier(src, device=device),
        )
        core.set_base_round_timeout(30.0)
        cluster.append((core, BatchingIngress(core.add_messages)))
        runners.append(ChainRunner(core, overlap=False))

    async def _main():
        await asyncio.wait_for(
            asyncio.gather(*(r.run(until_height=heights) for r in runners)),
            120,
        )

    try:
        asyncio.run(_main())
    finally:
        for core, ingress in cluster:
            ingress.close()
            core.messages.close()
    finalized = min(len(core.backend.inserted) for core, _ in cluster)
    if finalized < heights:
        raise RuntimeError(f"finalized {finalized} < {heights}")
    return (time.perf_counter() - t0) * 1e3


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m go_ibft_tpu_torch.boot")
    p.add_argument(
        "--programs",
        default="",
        help="comma-separated pinned registry keys (default: all)",
    )
    p.add_argument("--manifest", default=None, help="AOT manifest path")
    p.add_argument("--heights", type=int, default=1)
    p.add_argument("--nodes", type=int, default=3)
    p.add_argument(
        "--device",
        default=None,
        help="where the programs and the cluster run (default: the card; 'cpu' when asked for)",
    )
    p.add_argument(
        "--no-chain",
        action="store_true",
        help="warm-start only (no cluster boot)",
    )
    args = p.parse_args(argv)

    from ..obs import ledger as cost_ledger
    from ..utils.device import resolve_device
    from .warmstart import warm_start

    device = resolve_device(args.device)
    compile_log = os.environ.get("GO_IBFT_COMPILE_LEDGER")
    if compile_log:
        cost_ledger.enable(compile_log=compile_log)

    programs = [s for s in args.programs.split(",") if s] or None
    report = warm_start(programs=programs, manifest=args.manifest, device=device)

    chain_ms = 0.0
    if not args.no_chain:
        chain_ms = _first_finalized_ms(args.nodes, args.heights, device)
    entry_ms = (time.perf_counter() - _T_ENTRY) * 1e3

    out = {
        "entry_to_first_finalized_ms": round(entry_ms, 1),
        "warm_ms": round(report.total_ms, 1),
        "chain_ms": round(chain_ms, 1),
        "cache_dir": report.cache_dir,
        "platform": "gpu" if device.type == "cuda" else device.type,
        "device": str(device),
        "cold": len(report.cold),
        "cached": len(report.cached),
        "skipped": len(report.skipped),
        "programs": {
            s.program: {
                "status": s.status,
                "compile_ms": round(s.compile_ms, 1),
            }
            for s in report.programs.values()
        },
        "ts": time.time(),
    }
    if compile_log:
        cost_ledger.disable()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
