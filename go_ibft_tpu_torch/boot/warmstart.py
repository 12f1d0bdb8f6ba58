"""Warm-start: restore durable state *before* the first round opens (the
port of the JAX package's ``boot/warmstart.py``).

A restarted node has three kinds of warmth to recover, in cost order:

1. **The program set** — :class:`~go_ibft_tpu_torch.boot.aot.AOTStore`
   builds every CUDA source the requested pinned families need (library
   loads on a warm build cache; recorded cold builds on a cold or stale
   one) and runs each program once on the device.
2. **The WAL** — ``ChainRunner.recover()`` replays the durable chain and
   the in-flight prepared-certificate lock (warm-start calls it, it does
   not reimplement it).
3. **Verdict caches** — every committed seal persisted in a finalized WAL
   block was quorum-verified before it was written, so its verdict is
   re-derivable from the WAL alone: :func:`seed_verdict_caches` replays
   ``True`` into the scheduler tenant's seal-verdict cache (the
   ``(signer, proposal_hash, signature, height)`` key) and the serve
   plane's :class:`~go_ibft_tpu_torch.serve.SigVerdictCache` (the
   ``(proposal_hash, signer, signature)`` key).  Blocks carrying an
   aggregate certificate have no per-seal lanes and are skipped.
   :class:`~go_ibft_tpu_torch.verify.pipeline.PackCache` entries are keyed
   on live message *objects* and are deliberately NOT persisted.

The second-boot proof rides the cost ledger: enable it with a
``compile_log`` and a warm boot records ZERO cold-build events for the
restored set.

Differences from the JAX file: :func:`warm_start` takes ``device`` (where
the programs run; ``None``: the card) and reads the cache directory from
:mod:`go_ibft_tpu_torch.utils.buildcache`, which the store points the
kernel builds at on the card (on the CPU nothing is built).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, Optional, Sequence

from ..obs import trace
from ..utils.buildcache import resolve_cache_dir
from ..utils.device import DeviceLike
from .aot import AOTStore, ProgramStatus, family_of, load_manifest

__all__ = ["WarmStartReport", "seed_verdict_caches", "warm_start"]


@dataclasses.dataclass
class WarmStartReport:
    """What one warm start restored, and what each part cost."""

    cache_dir: str
    height: int = 0
    programs: Dict[str, ProgramStatus] = dataclasses.field(default_factory=dict)
    seeded_seal_verdicts: int = 0
    seeded_sig_verdicts: int = 0
    warmup_ms: float = 0.0
    total_ms: float = 0.0

    def by_status(self, status: str) -> list:
        return [p for p in self.programs.values() if p.status == status]

    @property
    def cold(self) -> list:
        return self.by_status("cold")

    @property
    def cached(self) -> list:
        return self.by_status("cached")

    @property
    def skipped(self) -> list:
        return self.by_status("skipped")


def seed_verdict_caches(
    blocks: Sequence,
    *,
    handle=None,
    sig_cache=None,
    max_blocks: int = 1024,
) -> Dict[str, int]:
    """Replay finalized blocks' committed seals into verdict caches.

    Sound because the WAL is already the node's trust root: ``recover()``
    replays these same blocks into the chain unconditionally, and each
    seal in a finalized block passed quorum verification before
    ``append_finalize`` persisted it.  ``handle`` is anything exposing
    ``seed_seal_verdicts(entries)`` (the scheduler's tenant handle);
    ``sig_cache`` anything exposing ``store_batch(keys, verdicts)``.
    """
    from ..crypto.backend import proposal_hash_of

    seal_entries = []
    sig_keys = []
    for block in list(blocks)[-max_blocks:]:
        if block.cert is not None or not block.seals:
            continue  # aggregate-certificate blocks carry no seal lanes
        h = proposal_hash_of(block.proposal)
        for seal in block.seals:
            seal_entries.append(((seal.signer, h, seal.signature, block.height), True))
            sig_keys.append((h, seal.signer, seal.signature))
    out = {"seal_verdicts": 0, "sig_verdicts": 0}
    if handle is not None and seal_entries:
        handle.seed_seal_verdicts(seal_entries)
        out["seal_verdicts"] = len(seal_entries)
    if sig_cache is not None and sig_keys:
        sig_cache.store_batch(sig_keys, [True] * len(sig_keys))
        out["sig_verdicts"] = len(sig_keys)
    return out


def warm_start(
    runner=None,
    *,
    programs: Optional[Sequence[str]] = None,
    manifest: Optional[str] = None,
    store: Optional[AOTStore] = None,
    handle=None,
    sig_cache=None,
    warmups: Sequence[Callable[[], object]] = (),
    record: bool = True,
    export: bool = False,
    seed_blocks: int = 1024,
    device: DeviceLike = None,
) -> WarmStartReport:
    """One full warm start; returns what was restored and what it cost.

    Program selection: explicit ``programs`` wins; else a ``manifest``
    path selects the pinned programs whose family it measured — unless the
    manifest is stale (fingerprint mismatch) or unreadable, in which case
    EVERY pinned family is a cold candidate; else every pinned family.

    ``warmups`` are zero-arg callables driven after the program restore
    (e.g. ``verifier.warmup`` / ``scheduler.warmup``).  ``device`` is where
    the programs run when no ``store`` is given (``None``: the card).
    """
    t0 = time.perf_counter()
    cache_dir = store.cache_dir if store is not None else resolve_cache_dir()
    store = store or AOTStore(cache_dir, device=device)
    if programs is None and manifest is not None:
        doc = load_manifest(manifest)
        if doc is not None and not doc.get("stale"):
            measured = set(doc.get("programs", ()))
            programs = [p for p in store.pinned_programs() if family_of(p) in measured]
    statuses = store.ensure(programs, record=record, export=export)

    height = 0
    seeded = {"seal_verdicts": 0, "sig_verdicts": 0}
    if runner is not None:
        height = runner.recover()
        if handle is not None or sig_cache is not None:
            seeded = seed_verdict_caches(
                runner.chain,
                handle=handle,
                sig_cache=sig_cache,
                max_blocks=seed_blocks,
            )

    t_warm = time.perf_counter()
    for fn in warmups:
        fn()
    warmup_ms = (time.perf_counter() - t_warm) * 1e3

    report = WarmStartReport(
        cache_dir=cache_dir,
        height=height,
        programs=statuses,
        seeded_seal_verdicts=seeded["seal_verdicts"],
        seeded_sig_verdicts=seeded["sig_verdicts"],
        warmup_ms=warmup_ms,
        total_ms=(time.perf_counter() - t0) * 1e3,
    )
    trace.instant(
        "boot.warm_start",
        height=height,
        cold=len(report.cold),
        cached=len(report.cached),
        skipped=len(report.skipped),
        seal_verdicts=report.seeded_seal_verdicts,
        sig_verdicts=report.seeded_sig_verdicts,
        total_ms=round(report.total_ms, 1),
    )
    return report
