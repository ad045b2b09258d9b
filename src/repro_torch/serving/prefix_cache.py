"""FB+-tree-backed prefix cache (RadixAttention-style KV reuse) — the
port's counterpart of ``repro.serving.prefix_cache``.

Keys: 16-byte chained block digests — ``key_i = H(key_{i-1} ‖ tokens_i)``
for token blocks of ``block_tokens`` — appended with the block index so
sibling blocks of one chain sort adjacently (range-scan friendly; YCSB-E
analogue is the eviction sweep). Values: page ids into a PagePool.

All cache operations are *batched tree ops* on the FB+-tree core:
  admit(requests)  -> one lookup_batch over every block of every request
  publish(blocks)  -> one insert_batch (latch-free bulk-synchronous commit)
  touch            -> update_batch on access stamps (the paper's latch-free
                      update path: value CAS, version untouched, readers
                      never restart)
  evict sweep      -> range_scan over the digest space (scan engine,
                      DESIGN.md §6: dispatches to the fused scan kernel
                      when the cache's engine backend registers one, else
                      the torch chain walk; leaves the cache keeps ordered
                      ride the lazy-rearrangement fast path)
  compact          -> rebuild (device-side bulk build, DESIGN.md §5) run
                      as an atomic fsck-gated publish through
                      core.lifecycle.TreeVersionManager (DESIGN.md §8):
                      a failed barrier leaves the old tree serving
This is exactly the paper's skewed workload: shared system prompts ⇒ heavy
key-prefix skew ⇒ the tree behaves trie-like (feature comparison wins).

**Sharded mode** (``n_shards > 1``, DESIGN.md §7): the cache runs on a
``repro_torch.shard.ShardedTree`` — digests are uniform, so evenly spaced
first-byte sentinels seed a balanced range partition and every op above
routes through the shard layer unchanged (same engine, same semantics);
``compact`` becomes ``rebalance`` (the cross-shard barrier). The tree
lives on the device the cache is given (``target``; the card unless asked
for the CPU), and every op above runs there.
"""
from __future__ import annotations

import hashlib
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core import batch_ops as B
from ..core import keys as K
from ..core.faults import FaultPlan, RetryPolicy
from ..core.fbtree import TreeConfig, bulk_build
from ..core.lifecycle import PublishReport, TreeVersionManager
from ..core.traverse import TraversalEngine

from .pages import PagePool

KEY_W = 20  # 16-byte digest + 4-byte block index


def _digest(prev: bytes, tokens: np.ndarray) -> bytes:
    return hashlib.blake2b(prev + tokens.tobytes(), digest_size=16).digest()


def chain_keys(tokens: np.ndarray, block_tokens: int) -> List[bytes]:
    """Block-chain digests for one request's full token prefix."""
    out = []
    prev = b"\x00" * 16
    n_blocks = len(tokens) // block_tokens
    for i in range(n_blocks):
        blk = np.asarray(tokens[i * block_tokens:(i + 1) * block_tokens],
                         dtype=np.int32)
        prev = _digest(prev, blk)
        out.append(prev + int(i).to_bytes(4, "big"))
    return out


class PrefixCache:
    def __init__(self, n_pages: int = 4096, block_tokens: int = 32,
                 max_keys: int = 1 << 16,
                 engine: Optional[TraversalEngine] = None,
                 compact_factor: float = 4.0, n_shards: int = 1,
                 faults: Optional[FaultPlan] = None,
                 retry: Optional[RetryPolicy] = None,
                 target: Optional[str] = None):
        self.block_tokens = block_tokens
        # serving never reads the modeled hardware counters, so the default
        # engine runs the stats-free hot path (DESIGN.md §3): leaf ids and
        # found-ness are bit-identical, the counter machinery compiles to
        # nothing. An explicit `engine` is honored as-is (pass
        # collect_stats=True to trace counters through the cache).
        self.engine = (engine if engine is not None
                       else TraversalEngine(collect_stats=False))
        self.pool = PagePool(n_pages)
        # auto-compact (device rebuild, DESIGN.md §5) once the tree holds
        # compact_factor× more leaves than a fresh build of the live keys
        # would; 0/None disables the trigger (compact() stays callable)
        self.compact_factor = compact_factor
        self.n_shards = int(n_shards)
        self.faults = faults
        self.retry = retry
        cfg = TreeConfig.plan(
            max_keys=max_keys, key_width=KEY_W,
            stacked=(engine is not None and engine.layout == "stacked"))
        if self.n_shards > 1:
            from .. import shard as SH
            self._shard = SH
            # one sentinel per shard, first bytes evenly spaced over the
            # (uniform) digest space — balanced routing without rebalancing
            seeds = [bytes([(256 * s) // self.n_shards]) +
                     b"\x00" * (KEY_W - 1) for s in range(self.n_shards)]
            ks = K.make_keyset(seeds, KEY_W)
            tree = SH.sharded_build(
                ks, np.full(self.n_shards, -1, np.int32), self.n_shards,
                cfg=cfg, target=target)
        else:
            self._shard = None
            seed = K.make_keyset([b"\x00" * KEY_W], KEY_W)  # sentinel root
            tree = bulk_build(cfg, seed, np.array([-1], np.int32),
                              target=target)
        # all tree state lives behind the version manager (DESIGN.md §8):
        # in-place ops commit under the current version; compact() is an
        # atomic fsck-gated publish, so a failed barrier can never leave
        # the cache serving from a half-built tree
        self.lifecycle = TreeVersionManager(tree, faults=faults)
        self.stats = {"lookups": 0, "hits": 0, "inserts": 0, "evicts": 0,
                      "rebuilds": 0}

    # ---- tree-op adapters: one call site per op, sharded or not ----
    @property
    def tree(self):
        """The serving tree — always the current published version."""
        return self.lifecycle.current

    @property
    def _cfg(self) -> TreeConfig:
        return self.tree.config

    def _leaf_count(self) -> int:
        if self._shard is not None:
            return sum(int(t.arrays.leaf_count) for t in self.tree.shards)
        return int(self.tree.arrays.leaf_count)

    def _key_headroom_ok(self, n_new: int) -> bool:
        """Can the pool absorb ``n_new`` appends without a compact?
        Sharded mode is conservative: assumes the whole batch routes to the
        fullest shard."""
        if self._shard is not None:
            worst = max(int(t.arrays.key_count) for t in self.tree.shards)
            return worst + n_new <= self._cfg.key_cap
        return int(self.tree.arrays.key_count) + n_new <= self._cfg.key_cap

    def _lookup(self, kb, kl):
        if self._shard is not None:
            # degraded lanes (report.degraded) serve from the last-barrier
            # snapshot: possibly-stale hits beat refusing the request
            return self._shard.lookup_batch(self.tree, kb, kl,
                                            engine=self.engine,
                                            faults=self.faults,
                                            retry=self.retry)
        return B.lookup_batch(self.tree, kb, kl, engine=self.engine)

    def _insert(self, kb, kl, vals):
        if self._shard is not None:
            tree, rep, _ = self._shard.insert_batch(
                self.tree, kb, kl, vals, engine=self.engine,
                faults=self.faults, retry=self.retry)
        else:
            tree, rep, _ = B.insert_batch(self.tree, kb, kl, vals,
                                          engine=self.engine)
        self.lifecycle.commit(tree)
        return rep

    def _remove(self, kb, kl):
        if self._shard is not None:
            tree, rep = self._shard.remove_batch(self.tree, kb, kl,
                                                 engine=self.engine,
                                                 faults=self.faults,
                                                 retry=self.retry)
        else:
            tree, rep = B.remove_batch(self.tree, kb, kl,
                                       engine=self.engine)
        self.lifecycle.commit(tree)
        return rep

    def _scan(self, kb, kl, max_items):
        """-> (kid-or-gkid, val, emitted); kid resolution goes through
        :meth:`_kid_rows`."""
        if self._shard is not None:
            kid, val, em, _, failed = self._shard.range_scan(
                self.tree, kb, kl, max_items=max_items, engine=self.engine,
                faults=self.faults, retry=self.retry)
            # a failed lane's emissions are a correct ascending prefix —
            # the eviction sweep just sees fewer candidates this round
            return kid, val, em
        kid, val, em, _ = B.range_scan(self.tree, kb, kl,
                                       max_items=max_items,
                                       engine=self.engine)
        return kid, val, em

    def _kid_rows(self, kid):
        """Resolve scan-returned key ids to (bytes, lens)."""
        if self._shard is not None:
            return self.tree.key_rows(kid)
        idx = torch.as_tensor(kid, dtype=torch.long, device=self.tree.device)
        return self.tree.arrays.key_bytes[idx], self.tree.arrays.key_lens[idx]

    # ---------------------------------------------------------------- admit
    def match(self, requests: Sequence[np.ndarray]
              ) -> Tuple[List[int], List[List[int]]]:
        """For each request: longest cached block-prefix.

        Returns (hit_blocks per request, page ids per request) — resolved in
        ONE batched lookup over all blocks of all requests.
        """
        all_keys: List[bytes] = []
        spans = []
        for toks in requests:
            ks = chain_keys(np.asarray(toks, np.int32), self.block_tokens)
            spans.append((len(all_keys), len(ks)))
            all_keys.extend(ks)
        if not all_keys:
            return [0] * len(requests), [[] for _ in requests]
        ks = K.make_keyset(all_keys, KEY_W)
        vals, rep = self._lookup(ks.bytes, ks.lens)
        vals = vals.cpu().numpy()
        found = rep.found.cpu().numpy()
        self.stats["lookups"] += len(all_keys)
        hit_blocks, pages = [], []
        for (off, n) in spans:
            h = 0
            pg: List[int] = []
            for i in range(n):
                if not found[off + i]:
                    break
                h += 1
                pg.append(int(vals[off + i]))
            hit_blocks.append(h)
            pages.append(pg)
            self.stats["hits"] += h
        # touch pages (latch-free update analogue on access metadata);
        # cache-resident pages stay evictable — callers pin explicitly via
        # pool.retain if they hold pages across steps
        flat = np.asarray([p for pg in pages for p in pg], np.int64)
        if flat.size:
            self.pool.touch(flat.astype(np.int32))
        return hit_blocks, pages

    # -------------------------------------------------------------- publish
    def publish(self, tokens: np.ndarray, n_known_blocks: int
                ) -> Optional[np.ndarray]:
        """Register the blocks of a freshly prefilled request; returns the
        page ids assigned to the *new* blocks (None if pool exhausted)."""
        ks_all = chain_keys(np.asarray(tokens, np.int32), self.block_tokens)
        new = ks_all[n_known_blocks:]
        if not new:
            return np.zeros((0,), np.int32)
        # key-pool headroom guard: evicted digests tombstone leaf slots but
        # only a rebuild reclaims their pool rows, and steady churn can march
        # key_count to key_cap while the live set stays small — compact
        # before appending would overflow (DESIGN.md §5)
        if not self._key_headroom_ok(len(new)):
            rep = self.compact()
            if not rep.ok and not self._key_headroom_ok(len(new)):
                # the barrier aborted (fault/fsck) and the old pool is
                # still full: degrade to not admitting new blocks rather
                # than crashing the serving loop on the append overflow
                return None
        ids = self.pool.alloc(len(new))
        if ids is None:
            self._evict(len(new) * 2)
            ids = self.pool.alloc(len(new))
            if ids is None:
                return None
        ks = K.make_keyset(new, KEY_W)
        self._insert(ks.bytes, ks.lens, ids.astype(np.int32))
        self.pool.release(ids)       # cache-owned: evictable until pinned
        self.stats["inserts"] += len(new)
        return ids

    # ---------------------------------------------------------------- evict
    def _evict(self, n: int):
        victims = self.pool.lru_candidates(n)
        if victims.size == 0:
            return
        # removing by value requires key lookup; we keep a reverse map built
        # from a range scan over the digest space (the YCSB-E analogue).
        # self.engine selects the scan route (DESIGN.md §6) and is
        # stats-free by default, so the rearranged counter costs nothing
        start = K.make_keyset([b"\x00" * KEY_W], KEY_W)
        kid, val, emitted = self._scan(
            start.bytes, start.lens,
            max_items=min(4096, self._cfg.key_cap))
        kid, val = kid[0].cpu().numpy(), val[0].cpu().numpy()
        emitted = emitted.cpu().numpy()
        vict = set(victims.tolist())
        sel = [i for i in range(int(emitted[0]))
               if int(val[i]) in vict and kid[i] >= 0]
        if not sel:
            return
        kb, kl = self._kid_rows(kid[sel])
        self._remove(kb, kl)
        self.pool.evict(victims)
        self.stats["evicts"] += len(sel)
        # cheap necessary condition first (leaf_count is a scalar pull;
        # frag_factor costs a device reduction): need >= 1 leaves, so
        # frag >= cf requires leaf_count >= cf
        if (self.compact_factor
                and self._leaf_count() >= self.compact_factor
                and self.frag_factor >= self.compact_factor):
            self.compact()

    # --------------------------------------------------------------- compact
    @property
    def frag_factor(self) -> float:
        """Allocated leaves vs the minimum a fresh build would use.

        Grows as splits allocate leaves that later drain through eviction;
        can sit below 1 while in-place slot reuse keeps early leaves denser
        than the ``leaf_fill`` build target (no compaction needed then).
        """
        live = self.tree.n_keys_live
        need = max(1, -(-live // self._cfg.leaf_fill))
        if self._shard is not None:
            # a sharded build can never use fewer than one leaf per shard,
            # so floor `need` there — otherwise a small live set reads as
            # permanently fragmented and the evict-time trigger thrashes
            # (rebalance can't drop below n_shards leaves)
            need = max(need, self.tree.n_shards)
        return self._leaf_count() / need

    def compact(self) -> PublishReport:
        """Online rebuild (DESIGN.md §5) as an atomic publish (§8): drop
        eviction tombstones, re-pack the key pool, and rebuild all levels
        on the tree's device — **off to the side**. The staged tree is
        structurally fsck'd and swapped in only on success; an abort,
        capacity error, or corruption mid-barrier leaves the current tree
        serving, bit-identical. Sharded mode runs the cross-shard form —
        ``shard.rebalance`` (DESIGN.md §7) — which also re-balances the
        partition and re-admits downed shards.

        A bulk-synchronous barrier between serving batches — cached page
        ids (the tree *values*) survive, but key ids/leaf ids/versions
        from before the barrier are invalidated, which is fine here:
        match() re-traverses from scratch every batch. Returns a
        ``core.lifecycle.PublishReport``; on success ``rep.aux`` is the
        build or rebalance report (both expose ``n_live``/``reclaimed``).
        """
        if self._shard is not None:
            rep = self.lifecycle.rebalance(label="compact")
        else:
            rep = self.lifecycle.rebuild(label="compact")
        if rep.ok:
            self.stats["rebuilds"] += 1
        return rep

    def hit_rate(self) -> float:
        lk = max(self.stats["lookups"], 1)
        return self.stats["hits"] / lk
