"""Sketch-gated prefix KV cache (port of ``repro/serve/prefix_cache.py``):
count-min admission over prompt prefixes, holding refcounted paged-pool
block ids (zero-copy prefix sharing).

Every observed prompt increments the count-min frequency of each of its
block-multiple prefixes (sketch/csvec.py, ``signed=False``); a prefix is
admitted to the bounded cache only once its estimate clears
``admit_threshold``, so one-shot prompts never occupy it and the tracker
stays O(rows * cols).  An admitted entry is a tuple of physical pool block
ids; a hit writes them into the new slot's block table.  Eviction is LRU
under a hard byte budget, preferring entries no live slot references.

The count-min table lives on the host: admission is host-side
bookkeeping between decode chunks, and a host table never waits on the
card.
"""
from __future__ import annotations

import hashlib
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ServeConfig
from repro_torch.sketch import csvec

# count-min key domain: prefix hashes land in [0, CM_DOMAIN)
CM_DOMAIN = 1 << 20


def prefix_key(tokens: np.ndarray) -> int:
    """Stable 64-bit hash of a token prefix (process-salt-free)."""
    h = hashlib.blake2b(np.ascontiguousarray(tokens, np.int32).tobytes(),
                        digest_size=8)
    return int.from_bytes(h.digest(), "little")


@dataclass
class PrefixCacheStats:
    lookups: int = 0
    hits: int = 0
    misses: int = 0
    admitted: int = 0
    evicted: int = 0
    rejected: int = 0            # observed prompts yielding no new admission
    bytes: int = 0               # unique cache-held pool blocks * block size


@dataclass
class _Entry:
    plen: int                    # cached prefix length in tokens
    block_ids: Tuple[int, ...]   # physical pool blocks covering [0, plen)


@dataclass
class SketchPrefixCache:
    """``allocator`` is the scheduler's BlockAllocator: the cache holds one
    reference per (entry, block) and the allocator arbitrates frees.
    ``block_size`` is the paged-KV page size in tokens — admitted prefix
    lengths are multiples of it (whole shared blocks only)."""
    cfg: ServeConfig
    allocator: Any = None
    block_size: int = 0
    stats: PrefixCacheStats = field(default_factory=PrefixCacheStats)
    # optional repro_torch.obs.ServeObserver: hit / miss / admit / evict /
    # defer outcomes stream into its windowed ``prefix.*`` counters
    # (``stats`` above stays the cumulative record)
    obs: Any = None

    def __post_init__(self):
        if self.block_size <= 0 or self.cfg.prefix_block % self.block_size:
            raise ValueError(
                f"prefix_block {self.cfg.prefix_block} must be a multiple "
                f"of the kv block size {self.block_size}")
        self._cm = csvec.csvec_zeros(
            CM_DOMAIN, cols=self.cfg.cm_cols, rows=self.cfg.cm_rows,
            seed=self.cfg.seed, signed=False)
        self._entries: "OrderedDict[Tuple[int, ...], _Entry]" = OrderedDict()
        self._held: Dict[int, int] = {}      # block id -> # entries holding
        self._observed = 0

    # -- read path ---------------------------------------------------------
    def _find(self, tokens: np.ndarray
              ) -> Optional[Tuple[Tuple[int, ...], _Entry]]:
        """Longest cached block-multiple prefix (key, entry) of
        ``tokens``, no side effects."""
        block = self.cfg.prefix_block
        for m in range(len(tokens) // block, 0, -1):
            key = tuple(int(t) for t in tokens[:m * block])
            ent = self._entries.get(key)
            if ent is not None:
                return key, ent
        return None

    def peek(self, tokens: np.ndarray
             ) -> Optional[Tuple[int, Tuple[int, ...]]]:
        """Like ``lookup`` but without touching stats or LRU recency —
        for retrying an admission deferred by pool pressure."""
        found = self._find(tokens)
        return None if found is None else (found[1].plen,
                                           found[1].block_ids)

    def lookup(self, tokens: np.ndarray
               ) -> Optional[Tuple[int, Tuple[int, ...]]]:
        """Longest cached block-multiple prefix of ``tokens``: (prefix_len,
        pool block ids), refreshing LRU recency.  The caller installs the
        ids into the slot's table and takes its own allocator reference."""
        self.stats.lookups += 1
        found = self._find(tokens)
        if found is not None:
            key, ent = found
            self._entries.move_to_end(key)
            self.stats.hits += 1
            if self.obs is not None:
                self.obs.prefix_event("hit")
            return ent.plen, ent.block_ids
        self.stats.misses += 1
        if self.obs is not None:
            self.obs.prefix_event("miss")
        return None

    # -- write path --------------------------------------------------------
    def _count(self, tokens: np.ndarray) -> Optional[np.ndarray]:
        """Increment the count-min frequency of every block-multiple
        prefix of ``tokens`` (one batched accumulate) and return the
        estimated counts, aging the table on the decay cadence."""
        block = self.cfg.prefix_block
        n_blocks = len(tokens) // block
        if n_blocks == 0:
            return None
        keys = torch.tensor(
            [prefix_key(tokens[:m * block]) % CM_DOMAIN
             for m in range(1, n_blocks + 1)], dtype=torch.int32)
        csvec.accumulate_coords(self._cm, keys,
                                torch.ones(len(keys), dtype=torch.float32))
        counts = csvec.query(self._cm, keys).numpy()
        self._observed += 1
        if self._observed % self.cfg.cm_decay_every == 0:
            csvec.decay(self._cm, self.cfg.cm_decay)
        return counts

    def observe(self, tokens: np.ndarray) -> Optional[int]:
        """Count an observed prompt (hits and misses alike, TinyLFU-style)
        and return the longest block-aligned prefix length whose estimate
        clears the admission threshold and is not cached yet; None (counted
        in ``stats.rejected``) when nothing new qualifies."""
        counts = self._count(tokens)
        if counts is None:
            self.stats.rejected += 1
            if self.obs is not None:
                self.obs.prefix_event("defer")
            return None
        block = self.cfg.prefix_block
        for m in range(len(counts), 0, -1):
            if counts[m - 1] >= self.cfg.admit_threshold:
                plen = m * block
                key = tuple(int(t) for t in tokens[:plen])
                if key not in self._entries:
                    return plen
                break
        self.stats.rejected += 1
        if self.obs is not None:
            self.obs.prefix_event("defer")
        return None

    def admit(self, tokens: np.ndarray, plen: int,
              block_ids: Tuple[int, ...]) -> None:
        """Hold a reference on the pool blocks covering ``tokens[:plen]``
        (the admitting slot's own prefill blocks), then evict LRU entries
        until under the byte budget.  Re-admitting a present key refreshes
        its recency."""
        assert plen % self.block_size == 0, (plen, self.block_size)
        assert len(block_ids) == plen // self.block_size
        key = tuple(int(t) for t in tokens[:plen])
        if key in self._entries:
            self._entries.move_to_end(key)
            return
        bb = self.allocator.block_bytes
        if len(block_ids) * bb > self.cfg.prefix_cache_bytes:
            return                   # one entry can never fit: don't thrash
        rc = self.allocator.rc
        assert all(int(rc[b]) >= 1 for b in block_ids), (
            "prefix-cache admit of freed block(s): "
            f"{[b for b in block_ids if int(rc[b]) < 1]}")
        self.allocator.ref(block_ids)
        for b in block_ids:
            self._held[b] = self._held.get(b, 0) + 1
        self._entries[key] = _Entry(plen=plen, block_ids=tuple(block_ids))
        self.stats.bytes = len(self._held) * bb
        self.stats.admitted += 1
        if self.obs is not None:
            self.obs.prefix_event("admit")
        while self.stats.bytes > self.cfg.prefix_cache_bytes:
            if not self.evict_one():
                break

    # -- eviction ----------------------------------------------------------
    def _entry_busy(self, ent: _Entry) -> bool:
        """True if any live slot still references the entry's blocks."""
        rc = self.allocator.rc
        return any(int(rc[b]) > self._held.get(b, 0)
                   for b in ent.block_ids)

    def _remove(self, key: Tuple[int, ...]) -> None:
        ent = self._entries.pop(key)
        for b in ent.block_ids:
            self._held[b] -= 1
            if self._held[b] == 0:
                del self._held[b]
        self.allocator.unref(ent.block_ids)
        self.stats.bytes = len(self._held) * self.allocator.block_bytes
        self.stats.evicted += 1
        if self.obs is not None:
            self.obs.prefix_event("evict")

    def evict_one(self, idle_only: bool = False) -> bool:
        """Evict one entry in LRU order, preferring entries no live slot
        references; ``idle_only`` stops there (the pool-pressure caller
        gains nothing from evicting busy entries).  False when nothing
        eligible remains."""
        if not self._entries:
            return False
        for key, ent in self._entries.items():
            if not self._entry_busy(ent):
                self._remove(key)
                return True
        if idle_only:
            return False
        self._remove(next(iter(self._entries)))
        return True

    # -- introspection -----------------------------------------------------
    def held_blocks(self) -> int:
        """Unique pool blocks currently held by the cache."""
        return len(self._held)
