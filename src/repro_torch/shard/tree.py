"""ShardedTree container (DESIGN.md §7) — the port's counterpart of
``repro.shard.tree``: one FBTree per range shard plus a replicated
split-key router.

Every shard's inner levels are ordinary FBTree levels over the shard's own
leaf and key arrays, so the global key pool and leaf chain exist only as
the disjoint union of the per-shard arrays. All shards share one
``TreeConfig``.

Invariants (``tests/test_torch_shard.py`` holds them against the
reference):

* **Range partition.** Shard ``s`` holds exactly the live keys in
  ``[split[s], split[s+1])`` (shard 0's range is open below). Routed
  inserts keep this; only ``rebalance`` moves the boundaries.
* **Global order = shard order.** The shards' sorted live key sets,
  concatenated in shard order, are the globally sorted live key set — the
  property the cross-shard range scan's merge and ``rebalance`` rely on.
* **Parity.** Every routed op gives the values, found-ness, emitted counts
  and resolved key bytes of the same op on one unsharded tree over the
  same keys, for any shard count.

Key ids are pool-local per shard; ``range_scan`` returns **global key
ids** ``gkid = shard * (key_cap + 1) + kid`` (int64, EMPTY stays -1),
which :meth:`ShardedTree.key_rows` resolves back to bytes.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from ..core.fbtree import EMPTY, FBTree, TreeConfig
from .router import ShardRouter

__all__ = ["ShardedTree", "ShardHealth"]


class ShardHealth:
    """Mutable host-side health registry, shared across the ``replace``
    lineage (DESIGN.md §8).

    A shard is marked down when a routed dispatch exhausts its retries
    (``shard.ops._dispatch``); while down, ops skip its launches and
    report its lanes ``failed`` (mutations, scans) or serve them
    ``degraded`` from the last-barrier snapshot (lookups). The shard's
    arrays stay intact — only reachability is modelled — so ``rebalance``
    (a fresh ShardedTree with fresh health) re-admits it.
    """

    def __init__(self, n_shards: int):
        self.ok = np.ones(int(n_shards), dtype=bool)
        self.reasons = [""] * int(n_shards)

    def is_ok(self, s: int) -> bool:
        return bool(self.ok[s])

    def mark_down(self, s: int, reason: str = ""):
        self.ok[s] = False
        self.reasons[s] = reason

    def mark_up(self, s: int):
        self.ok[s] = True
        self.reasons[s] = ""

    def reset(self):
        self.ok[:] = True
        self.reasons = [""] * self.ok.shape[0]

    @property
    def n_unhealthy(self) -> int:
        return int((~self.ok).sum())

    def __repr__(self):
        down = [f"{s}:{r or 'down'}" for s, r in enumerate(self.reasons)
                if not self.ok[s]]
        return (f"ShardHealth({self.ok.size} shards, "
                f"{'all ok' if not down else 'down ' + ', '.join(down)})")


@dataclasses.dataclass
class ShardedTree:
    """Per-shard trees, the router, and their placement.

    Dispatch is a host loop launching one op per shard on that shard's
    device; results combine on the router's device.

    ``health`` is a *shared mutable* object: routed ops return a new
    ShardedTree (``replace``), and a shard marked down mid-batch stays down
    in every tree derived from that lineage until a ``rebalance`` barrier.
    ``snapshots`` are the per-shard trees as of the last barrier
    (build/rebalance), the read-only replica degraded lookups serve from;
    commits advance ``shards`` but never ``snapshots``. Sharing them is
    safe because every op of the port writes only clones.
    """
    shards: Tuple[FBTree, ...]
    router: ShardRouter
    devices: Tuple = ()            # per-shard torch.device (None = unplaced)
    mesh: object = None            # tuple of torch.device | None
    health: ShardHealth = None     # shared across replace() lineage
    snapshots: Tuple[FBTree, ...] = ()   # last-barrier per-shard trees

    def __post_init__(self):
        if not self.devices:
            self.devices = (None,) * len(self.shards)
        if self.health is None:
            self.health = ShardHealth(len(self.shards))
        if not self.snapshots:
            self.snapshots = self.shards
        if len(self.devices) != len(self.shards):
            raise ValueError(
                f"ShardedTree: {len(self.devices)} devices for "
                f"{len(self.shards)} shards — one device slot per shard "
                f"(None for unplaced)")
        if self.router.n_shards != len(self.shards):
            raise ValueError(
                f"ShardedTree: router has {self.router.n_shards} split "
                f"keys for {len(self.shards)} shards — rebuild the router "
                f"with make_router over one min key per shard")
        if self.health.ok.size != len(self.shards):
            raise ValueError(
                f"ShardedTree: health tracks {self.health.ok.size} shards "
                f"but the tree has {len(self.shards)}")

    # ------------------------------------------------------------- shape
    @property
    def n_shards(self) -> int:
        return len(self.shards)

    @property
    def config(self) -> TreeConfig:
        return self.shards[0].config

    @property
    def kid_stride(self) -> int:
        """Rows per shard key pool — the global-key-id stride."""
        return self.config.key_cap + 1

    @property
    def n_keys_live(self) -> int:
        return sum(t.n_keys_live for t in self.shards)

    def replace(self, **kw) -> "ShardedTree":
        return dataclasses.replace(self, **kw)

    # ------------------------------------------------------- global kids
    def split_gkid(self, gkid):
        """Decode global key ids into ``(shard int32, local kid int32)``
        tensors of the same shape; EMPTY ids map to ``(0, EMPTY)``."""
        g = torch.as_tensor(gkid).to(torch.int64)
        ok = g >= 0
        shard = torch.where(ok, g // self.kid_stride, 0).to(torch.int32)
        kid = torch.where(ok, g % self.kid_stride, EMPTY).to(torch.int32)
        return shard, kid

    def key_rows(self, gkid):
        """Resolve global key ids to ``(key_bytes uint8 [.., L], lens int32
        [..])`` on ``gkid``'s device; EMPTY ids resolve to zero rows. Each
        shard's rows are gathered on the shard's own device."""
        shard, kid = self.split_gkid(gkid)
        dev = shard.device
        out_b = torch.zeros(shard.shape + (self.config.key_width,),
                            dtype=torch.uint8, device=dev)
        out_l = torch.zeros(shard.shape, dtype=torch.int32, device=dev)
        for s, t in enumerate(self.shards):
            sel = (shard == s) & (kid >= 0)
            k = torch.where(sel, kid, 0).to(t.device).long()
            out_b = torch.where(sel[..., None],
                                t.arrays.key_bytes[k].to(dev), out_b)
            out_l = torch.where(sel, t.arrays.key_lens[k].to(dev), out_l)
        return out_b, out_l

    # ----------------------------------------------------- op delegation
    # a thin method facade over shard.ops (imported lazily to keep the
    # module graph acyclic); the functional API is the primary surface
    def lookup(self, qb, ql, engine=None, **kw):
        from . import ops
        return ops.lookup_batch(self, qb, ql, engine=engine, **kw)

    def update(self, qb, ql, vals, engine=None, **kw):
        from . import ops
        return ops.update_batch(self, qb, ql, vals, engine=engine, **kw)

    def insert(self, qb, ql, vals, engine=None, **kw):
        from . import ops
        return ops.insert_batch(self, qb, ql, vals, engine=engine, **kw)

    def remove(self, qb, ql, engine=None, **kw):
        from . import ops
        return ops.remove_batch(self, qb, ql, engine=engine, **kw)

    def range_scan(self, qb, ql, max_items: int = 64, engine=None, **kw):
        from . import ops
        return ops.range_scan(self, qb, ql, max_items=max_items,
                              engine=engine, **kw)

    def rebalance(self, device: bool = True, **kw):
        from . import ops
        return ops.rebalance(self, device=device, **kw)
