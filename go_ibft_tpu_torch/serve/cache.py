"""ProofCache: canonical height-range chunks over irreversible finality (the
port of the JAX package's ``serve/cache.py``).

IBFT finality never reverts, so a proof entry built for a finalized
height is immutable — the ideal cache load.  What makes naive caching
weak is the KEY: every client arrives with its own ``(checkpoint,
target)`` pair, and caching per request-range would give 1000 clients
1000 disjoint entries over the same blocks.  This cache normalizes to
**canonical chunks**: the chain is tiled into fixed ``chunk_heights``
windows aligned to height 1 (heights ``[1, C]``, ``[C+1, 2C]``, ...), a
request maps to the chunks covering it, and the server stitches the
answer from chunk entries — so overlapping requests share every full
chunk they touch, and the partial tail chunk (still growing; not yet
canonical) is the only per-request work.

Bounded memory: at most ``max_chunks`` chunks, LRU-evicted (serving old
history to a cold archive walker cannot push the hot head chunks out
faster than they are re-used).  Hit/miss/eviction counters feed
``stats()`` and the ``serve.*`` metrics — the evidence bench config #12
records.

Thread safety: one lock around the OrderedDict; chunk payloads are
immutable after :meth:`put` (the server never mutates a cached entry —
stitching copies the LIST, not the entries).
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from dataclasses import dataclass
from typing import List, Optional, Tuple

from ..utils import metrics
from .proof import ProofEntry, SetDiff

__all__ = [
    "CachedChunk",
    "ProofCache",
    "SERVE_CACHE_HITS_KEY",
    "SERVE_CACHE_MISSES_KEY",
    "SERVE_CACHE_EVICTIONS_KEY",
]

SERVE_CACHE_HITS_KEY = ("go-ibft", "serve", "cache_hits")
SERVE_CACHE_MISSES_KEY = ("go-ibft", "serve", "cache_misses")
SERVE_CACHE_EVICTIONS_KEY = ("go-ibft", "serve", "cache_evictions")


@dataclass(frozen=True)
class CachedChunk:
    """One canonical chunk: entries for ``[start, end]`` plus the rotation
    diffs for the same heights (each vs its predecessor, ``start``
    included — so a rotation on the chunk boundary survives stitching)."""

    start: int
    end: int
    entries: Tuple[ProofEntry, ...]
    diffs: Tuple[SetDiff, ...]


class ProofCache:
    """LRU cache of canonical proof chunks, keyed by chunk start height."""

    def __init__(self, *, chunk_heights: int = 64, max_chunks: int = 256):
        if chunk_heights < 1 or max_chunks < 1:
            raise ValueError("cache bounds must be >= 1")
        self.chunk_heights = chunk_heights
        self.max_chunks = max_chunks
        self._lock = threading.Lock()
        self._chunks: "OrderedDict[int, CachedChunk]" = OrderedDict()
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    # -- canonical geometry ----------------------------------------------

    def chunk_start(self, height: int) -> int:
        """Start height of the canonical chunk containing ``height``
        (heights are 1-based; chunks align to height 1)."""
        return ((height - 1) // self.chunk_heights) * self.chunk_heights + 1

    def chunk_starts(self, start: int, end: int) -> List[int]:
        """Canonical chunk starts covering ``[start, end]``."""
        first = self.chunk_start(start)
        return list(
            range(first, end + 1, self.chunk_heights)
        )

    # -- lookup / insert -------------------------------------------------

    def get(self, chunk_start: int) -> Optional[CachedChunk]:
        with self._lock:
            chunk = self._chunks.get(chunk_start)
            if chunk is None:
                self.misses += 1
                metrics.inc_counter(SERVE_CACHE_MISSES_KEY)
                return None
            self._chunks.move_to_end(chunk_start)
            self.hits += 1
            metrics.inc_counter(SERVE_CACHE_HITS_KEY)
            return chunk

    def peek(self, chunk_start: int) -> Optional[CachedChunk]:
        """Lookup without touching hit/miss counters or LRU order (the
        server's under-build-lock re-check: a stampede loser finding the
        winner's chunk is not a second cold miss)."""
        with self._lock:
            return self._chunks.get(chunk_start)

    def put(
        self,
        chunk_start: int,
        entries: List[ProofEntry],
        diffs: List[SetDiff],
    ) -> CachedChunk:
        """Insert one FULL canonical chunk (``chunk_heights`` entries
        starting exactly at a canonical boundary — partial tail windows
        are never cached: they are still growing and would poison
        stitching once the chain passes them)."""
        if chunk_start != self.chunk_start(chunk_start):
            raise ValueError(
                f"chunk start {chunk_start} is not on a canonical boundary"
            )
        if len(entries) != self.chunk_heights:
            raise ValueError(
                f"chunk must carry exactly {self.chunk_heights} entries, "
                f"got {len(entries)}"
            )
        chunk = CachedChunk(
            start=chunk_start,
            end=chunk_start + self.chunk_heights - 1,
            entries=tuple(entries),
            diffs=tuple(diffs),
        )
        with self._lock:
            self._chunks[chunk_start] = chunk
            self._chunks.move_to_end(chunk_start)
            while len(self._chunks) > self.max_chunks:
                self._chunks.popitem(last=False)
                self.evictions += 1
                metrics.inc_counter(SERVE_CACHE_EVICTIONS_KEY)
        return chunk

    def __len__(self) -> int:
        with self._lock:
            return len(self._chunks)

    def clear(self) -> None:
        with self._lock:
            self._chunks.clear()

    # -- evidence --------------------------------------------------------

    def stats(self) -> dict:
        with self._lock:
            chunks = len(self._chunks)
            hits, misses, evictions = self.hits, self.misses, self.evictions
        lookups = hits + misses
        return {
            "chunks": chunks,
            "chunk_heights": self.chunk_heights,
            "max_chunks": self.max_chunks,
            "hits": hits,
            "misses": misses,
            "hit_rate": round(hits / lookups, 3) if lookups else None,
            "evictions": evictions,
        }
