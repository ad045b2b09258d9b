"""Engine-facing wrappers for the per-level feature-comparison kernel — the
``"cuda"`` level backend of ``core.traverse`` (the reference's
``"pallas"``, ``repro.kernels.feature_branch.ops``).

:func:`branch_level_cuda` is a drop-in for ``core.branch.branch_level``
with the same ``BranchStats`` accounting and the same ``collect_stats``
switch: the gathers and the prefix compare run in torch, the feature
rounds in the kernel (:func:`feature_branch`), and the suffix binary search
is the shared ``core.branch.suffix_binary_search``. Like the reference it
has no all-trivial short-circuit: every level of every descent launches the
kernel once. For tensors on the card :func:`feature_branch` launches the
CUDA kernel (``cuda.py``) or raises; for tensors on the CPU it runs the
plain torch version (``ref.py``). ``LAUNCHES`` counts the kernel launches
made in this process.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from ...core.branch import BranchStats, level_inputs, suffix_binary_search
from . import cuda
from .ref import feature_compare_rounds

__all__ = ["feature_branch", "branch_level_cuda", "LAUNCHES"]

LAUNCHES = 0


def feature_branch(feats, qfeat, knum, pcmp, collect_stats: bool = True):
    """The feature rounds of one level: ``feats [B, fs, ns] u8``,
    ``qfeat [B, fs] u8``, ``knum``/``pcmp [B]`` int32 -> ``(idx, resolved,
    run_lo, run_hi, rounds)``, each ``[B]`` int32 (the reference kernel's
    outputs without their trailing axis); ``rounds`` is all-zero when
    ``collect_stats`` is off."""
    global LAUNCHES
    if not feats.is_cuda:
        idx, resolved, lo, hi, rounds = feature_compare_rounds(
            feats, qfeat, knum, pcmp, collect_stats=collect_stats)
        return idx, resolved.to(torch.int32), lo, hi, rounds
    out = cuda.launch(feats, qfeat, knum, pcmp, collect_stats=collect_stats)
    LAUNCHES += 1
    return out


def branch_level_cuda(level, key_bytes, key_lens, node_ids, qb, ql,
                      collect_stats: bool = True,
                      ) -> Tuple[torch.Tensor, Optional[BranchStats]]:
    """Drop-in for ``core.branch.branch_level`` built on the kernel."""
    B = node_ids.shape[0]
    ns = level.features.shape[-1]
    lines_per_row = max(1, ns // 64)
    nid = node_ids.long()
    feats, qfeat, knum, pcmp = level_inputs(level, nid, qb)
    idx, resolved, run_lo, run_hi, rounds = feature_branch(
        feats, qfeat, knum, pcmp, collect_stats=collect_stats)
    # the kernel's `resolved` folds in the prefix and trivial overrides, so
    # its complement is exactly the set billed for the suffix binary search
    need_bs = resolved == 0
    lo_b, key_cmp = suffix_binary_search(
        level.anchors, nid, key_bytes, key_lens, qb, ql, run_lo, run_hi,
        need_bs, ns, count_compares=collect_stats)
    kmax = torch.clamp(knum - 1, min=0)
    bs_idx = torch.minimum(torch.clamp(lo_b - 1, min=0), kmax)
    idx = torch.where(need_bs, bs_idx, idx)
    child = level.children[nid, idx.long()]
    if not collect_stats:
        return child, None
    trivial = knum <= 1

    def nz(x):
        return torch.where(trivial, 0, x).to(torch.int32)

    kw_lines = torch.div(ql + 63, 64, rounding_mode="floor")
    stats = BranchStats(
        feat_rounds=nz(rounds),
        suffix_bs=nz(need_bs.to(torch.int32)),
        key_compares=nz(key_cmp),
        lines_touched=nz(1 + rounds * lines_per_row
                         + key_cmp * (1 + kw_lines) + 1),
        sibling_hops=torch.zeros((B,), dtype=torch.int32, device=qb.device),
    )
    return child, stats
