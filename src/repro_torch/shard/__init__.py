"""Sharded-tree subsystem (DESIGN.md §7) — the port's counterpart of
``repro.shard``: one FBTree per range shard over a tuple of devices, a
replicated split-key router, shard-local dispatch of every batch op
through the traversal engine, cross-shard range scans, and ``rebalance``
as the skew-recovery barrier.

Stable public surface — import from here, not from the submodules:

    from repro_torch.shard import ShardedTree, sharded_build, lookup_batch, ...
"""
from .build import sharded_build
from .mesh import make_shard_mesh, place_shard, shard_devices
from .ops import (DEFAULT_RETRY, RebalanceReport, ShardOpReport,
                  insert_batch, lookup_batch, range_scan, rebalance,
                  remove_batch, update_batch)
from .router import ShardRouter, make_router, route
from .tree import ShardedTree, ShardHealth

__all__ = [
    "ShardedTree", "ShardHealth", "sharded_build",
    "ShardRouter", "make_router", "route",
    "make_shard_mesh", "shard_devices",
    "lookup_batch", "update_batch", "insert_batch", "remove_batch",
    "range_scan", "rebalance",
    "ShardOpReport", "RebalanceReport", "DEFAULT_RETRY",
]
