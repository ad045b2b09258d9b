"""Engine-facing wrapper for the fused range-scan kernel — the ``"fused"``
scan backend of ``core.traverse``.

:func:`fused_range_scan` matches the ScanBackend signature, so
``core.batch_ops.range_scan`` collapses the whole scan (descent, sibling
hop, and the leaf-chain walk with lazy rearrangement) into one kernel
launch when the engine's backend is ``"fused"``. For queries on the card it
launches the CUDA kernel (``cuda.py``) once, or raises; for queries on the
CPU it runs the plain torch version (``ref.py``). ``LAUNCHES`` counts the
kernel launches made in this process.
"""
from __future__ import annotations

from typing import Tuple

import torch

from ...core.fbtree import FBTree
from . import cuda
from .ref import fused_range_scan_ref

__all__ = ["fused_range_scan", "LAUNCHES"]

LAUNCHES = 0


def fused_range_scan(tree: FBTree, qb, ql, max_items: int = 64,
                     collect_stats: bool = True,
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                torch.Tensor]:
    """Scan-backend entry: the whole range scan in one kernel launch.

    Returns ``(out_kid [B, max_items], out_val [B, max_items], emitted [B],
    rearranged [B])`` — the ``core.batch_ops.range_scan`` contract;
    ``rearranged`` is all-zero when ``collect_stats`` is off.
    """
    global LAUNCHES
    if not qb.is_cuda:
        return fused_range_scan_ref(tree, qb, ql, max_items=max_items,
                                    collect_stats=collect_stats)
    out = cuda.launch(tree.arrays, qb, ql, max_items=max_items,
                      collect_stats=collect_stats)
    LAUNCHES += 1
    return out
