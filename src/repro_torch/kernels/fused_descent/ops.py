"""Engine-facing wrappers for the fused whole-descent kernel — the
``"fused"`` descent backend of ``core.traverse``.

:func:`fused_traverse` matches the descent-backend signature and
:func:`fused_traverse_probe` is the fused traverse+probe entry
``core.batch_ops._traverse_probe`` collapses to. For queries on the card
they launch the CUDA kernel (``cuda.py``) once, or raise; for queries on the
CPU they run the plain torch version (``ref.py``). ``LAUNCHES`` counts the
kernel launches made in this process; with ``obs.enable()`` the counter
``kernel.launches`` (labels ``kernel=fused_descent``, ``stripes=S``,
``lanes=G``) counts them by the build launched: S and the lanes a query G
as the compiled library picks them for the node size and key width.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import torch

from ... import obs
from ...core.branch import BranchStats
from ...core.fbtree import FBTree
from ...core.leaf import LeafStats
from . import cuda
from .ref import fused_traverse_probe_ref, fused_traverse_ref

__all__ = ["fused_traverse", "fused_traverse_probe", "LAUNCHES"]

LAUNCHES = 0


def _run(tree: FBTree, qb, ql, sibling_check: bool, with_probe: bool,
         collect_stats: bool):
    global LAUNCHES
    a = tree.arrays
    ns = a.stacked.features.shape[-1]
    leaf, path_arr, found, slot, val, st = cuda.launch(
        a, qb, ql, sibling_check=sibling_check, with_probe=with_probe,
        collect_stats=collect_stats)
    LAUNCHES += 1
    if obs.enabled():
        L = qb.shape[1]
        obs.counter("kernel.launches", kernel="fused_descent",
                    stripes=cuda.stripes(L), lanes=cuda.lanes(ns, L)).inc()
    path = list(path_arr.unbind(1))
    bstats = lstats = None
    if collect_stats:
        fr, sb, kc, li, sh, tc = st.unbind(0)
        bstats = BranchStats(feat_rounds=fr, suffix_bs=sb, key_compares=kc,
                             lines_touched=li, sibling_hops=sh)
        if with_probe:
            kw_lines = torch.div(ql + 63, 64, rounding_mode="floor")
            lstats = LeafStats(
                tag_candidates=tc,
                lines_touched=(max(1, ns // 64) + 1 + tc * (1 + kw_lines)
                               ).to(torch.int32))
    if not with_probe:
        found = slot = val = None
    return leaf, path, found, slot, val, bstats, lstats


def fused_traverse(tree: FBTree, qb, ql, sibling_check: bool = True,
                   collect_stats: bool = True,
                   ) -> Tuple[torch.Tensor, List[torch.Tensor],
                              Optional[BranchStats]]:
    """Descent-backend entry: whole root→leaf descent in one kernel launch.
    Returns ``(leaf_ids, path, stats | None)`` — the
    ``TraversalEngine.traverse`` contract."""
    if not qb.is_cuda:
        return fused_traverse_ref(tree, qb, ql, sibling_check=sibling_check,
                                  collect_stats=collect_stats)
    leaf_ids, path, _, _, _, bstats, _ = _run(
        tree, qb, ql, sibling_check, with_probe=False,
        collect_stats=collect_stats)
    return leaf_ids, path, bstats


def fused_traverse_probe(tree: FBTree, qb, ql, sibling_check: bool = True,
                         collect_stats: bool = True):
    """Fused traverse+probe: descent, sibling hop, and the hashtag leaf
    probe (full-key verify included) in ONE launch. Returns
    ``(leaf_ids, path, found, slot, val, bstats | None, lstats | None)`` —
    the ``core.batch_ops._traverse_probe`` contract."""
    if not qb.is_cuda:
        return fused_traverse_probe_ref(tree, qb, ql,
                                        sibling_check=sibling_check,
                                        collect_stats=collect_stats)
    return _run(tree, qb, ql, sibling_check, with_probe=True,
                collect_stats=collect_stats)
