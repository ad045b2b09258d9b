"""Plain torch version of the fused range scan: the chain walk of
``core.batch_ops._range_scan_torch`` (one definition — it is also the path
``range_scan`` runs for every engine without a scan kernel), pinned to the
``"torch"`` descent so the kernel is held against a fixed configuration
whichever engine a caller would select, as the reference's
``repro.kernels.fused_scan.ref`` pins its ``"jnp"`` descent. The CPU path of
``ops`` runs it, and the kernel is held against it on the card."""
from __future__ import annotations


def fused_range_scan_ref(tree, qb, ql, max_items: int = 64,
                         collect_stats: bool = True, force_sort: bool = False):
    from ...core.batch_ops import _range_scan_torch
    from ...core.traverse import TraversalEngine
    eng = TraversalEngine("torch", collect_stats=collect_stats)
    return _range_scan_torch(tree, qb, ql, max_items, eng,
                             force_sort=force_sort)
