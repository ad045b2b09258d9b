"""Plain torch version of the fused descent: the same descend → sibling-hop
→ probe pipeline composed from the core primitives (one torch call per
stage instead of one fused kernel), as the reference's
``repro.kernels.fused_descent.ref``. The CPU path of ``ops`` runs it, and
the kernel is held against it on the card."""
from __future__ import annotations

import torch

from ...core.branch import BranchStats, branch_level, to_sibling
from ...core.leaf import probe


def fused_traverse_ref(tree, qb, ql, sibling_check: bool = True,
                       collect_stats: bool = True):
    a = tree.arrays
    B = qb.shape[0]
    node_ids = torch.zeros((B,), dtype=torch.int32, device=qb.device)
    stats = BranchStats.zeros(B, qb.device) if collect_stats else None
    path = []
    for level in a.levels:
        path.append(node_ids)
        node_ids, s = branch_level(level, a.key_bytes, a.key_lens, node_ids,
                                   qb, ql, collect_stats=collect_stats)
        if collect_stats:
            stats = stats + s
    if sibling_check:
        node_ids, hops = to_sibling(tree, node_ids, qb, ql)
        if collect_stats:
            stats = stats._replace(sibling_hops=stats.sibling_hops + hops)
    return node_ids, path, stats


def fused_traverse_probe_ref(tree, qb, ql, sibling_check: bool = True,
                             collect_stats: bool = True):
    leaf_ids, path, bstats = fused_traverse_ref(
        tree, qb, ql, sibling_check=sibling_check,
        collect_stats=collect_stats)
    found, slot, val, lstats = probe(tree, leaf_ids, qb, ql,
                                     collect_stats=collect_stats)
    return leaf_ids, path, found, slot, val, bstats, lstats
