"""Wrappers for the hashtag leaf-filter kernel — the port's counterpart of
``repro.kernels.leaf_probe.ops``.

:func:`probe_cuda` is a drop-in for ``core.leaf.probe``: the kernel
(:func:`leaf_probe`) filters each query's leaf by hashtag and counts the
candidates, and ``core.leaf.verify_candidates`` compares full keys for the
candidates only. No batch op calls it (the point ops run ``leaf.probe``, or
the probe fused into the descent kernel), as in the reference; it is its
own entry point. For tensors on the card :func:`leaf_probe` launches the
CUDA kernel (``cuda.py``) or raises; for tensors on the CPU it runs the
plain torch version (``ref.py``). ``LAUNCHES`` counts the kernel launches
made in this process.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from ...core.fbtree import FBTree
from ...core.keys import fnv1a_tags
from ...core.leaf import LeafStats, verify_candidates
from . import cuda
from .ref import leaf_probe_ref

__all__ = ["leaf_probe", "probe_cuda", "LAUNCHES"]

LAUNCHES = 0


def leaf_probe(tags, occ, qtag):
    """``tags [B, ns] u8``, ``occ [B, ns] bool``, ``qtag [B] u8`` ->
    ``(cand [B, ns] u8 0/1, first [B] int32, count [B] int32)``."""
    global LAUNCHES
    if not tags.is_cuda:
        return leaf_probe_ref(tags, occ, qtag)
    out = cuda.launch(tags, occ, qtag)
    LAUNCHES += 1
    return out


def probe_cuda(tree: FBTree, leaf_ids, qb, ql, collect_stats: bool = True,
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                          Optional[LeafStats]]:
    """Find each query's slot in its leaf, with the hashtag filter in the
    kernel. Returns ``(found [B] bool, slot [B] int32, val [B], stats)``
    as ``core.leaf.probe`` does; ``stats`` is ``None`` when
    ``collect_stats`` is off."""
    a = tree.arrays
    ns = a.leaf_tags.shape[-1]
    lid = leaf_ids.long()
    cand_u8, _, count = leaf_probe(a.leaf_tags[lid], a.leaf_occ[lid],
                                   fnv1a_tags(qb, ql))
    found, slot = verify_candidates(a, cand_u8 != 0, a.leaf_keyid[lid], qb,
                                    ql)
    val = a.leaf_val[lid, slot.long()]
    val = torch.where(found, val, torch.zeros_like(val))
    if not collect_stats:
        return found, slot, val, None
    kw_lines = torch.div(ql + 63, 64, rounding_mode="floor")
    stats = LeafStats(
        tag_candidates=count,
        lines_touched=(max(1, ns // 64) + 1 + count * (1 + kw_lines)
                       ).to(torch.int32),
    )
    return found, slot, val, stats
