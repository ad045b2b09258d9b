"""KV page pool: bitmap allocator + refcounts (paper leaf-bitmap design) —
a copy of ``repro.serving.pages`` (it is numpy).

Pages hold one token-block of per-layer KV (or SSM snapshot) in a page
store (a device tensor in the serving engine); shared prefixes share pages
via refcounting. The free list is a
bitmap — allocation = find-first-zero ranks, exactly the leaf-slot discipline
FB+-tree leaves use (occupancy bitmap + slot install).
"""
from __future__ import annotations

from typing import Optional

import numpy as np


class PagePool:
    def __init__(self, n_pages: int):
        self.n_pages = n_pages
        self.used = np.zeros(n_pages, dtype=bool)
        self.refs = np.zeros(n_pages, dtype=np.int32)
        self.last_access = np.zeros(n_pages, dtype=np.int64)
        self.hits = np.zeros(n_pages, dtype=np.int64)
        self.clock = 0

    @property
    def n_free(self) -> int:
        return int((~self.used).sum())

    def alloc(self, n: int) -> Optional[np.ndarray]:
        free = np.nonzero(~self.used)[0]
        if free.size < n:
            return None
        ids = free[:n]
        self.used[ids] = True
        self.refs[ids] = 1
        self.clock += 1
        self.last_access[ids] = self.clock
        return ids.astype(np.int32)

    def retain(self, ids: np.ndarray):
        self.refs[ids] += 1
        self.clock += 1
        self.last_access[ids] = self.clock
        self.hits[ids] += 1

    def touch(self, ids: np.ndarray):
        """Record access (LRU stamp + hit count) without pinning."""
        self.clock += 1
        self.last_access[ids] = self.clock
        self.hits[ids] += 1

    def release(self, ids: np.ndarray):
        self.refs[ids] -= 1
        # pages stay resident (cache) until evicted; refs==0 means evictable

    def evictable(self) -> np.ndarray:
        return np.nonzero(self.used & (self.refs <= 0))[0]

    def lru_candidates(self, n: int) -> np.ndarray:
        ev = self.evictable()
        order = np.argsort(self.last_access[ev])
        return ev[order[:n]].astype(np.int32)

    def evict(self, ids: np.ndarray):
        self.used[ids] = False
        self.refs[ids] = 0
