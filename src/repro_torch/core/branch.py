"""Feature-comparison branch (paper §3.2/3.4, Fig. 6 lines 1-28), batched —
the port's counterpart of ``repro.core.branch``.

Given a batch of queries positioned at nodes of one inner level, resolve
each query's child index with (1) the common-prefix 3-way compare, (2) the
progressive byte-wise feature comparison
(:func:`repro_torch.kernels.feature_branch.ref.feature_compare_rounds`),
and (3) a binary search over anchor suffixes when the equal run survives
all ``fs`` rows.

This is the plain torch oracle. The reference's ``lax.while_loop``s are
Python ``while`` loops over the still-active lanes, and its ``lax.cond``
short-circuit for all-trivial levels is an ``if`` on a host-synced
``.all()``; the fused CUDA kernel (``kernels/fused_descent``) is the hot
path. Every function takes a ``collect_stats`` flag: with it off the counter
arithmetic is skipped and stats come back as ``None`` (DESIGN.md §3).
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from ..kernels.feature_branch.ref import feature_compare_rounds
from .fbtree import FBTree, Level
from .keys import compare_padded

__all__ = ["BranchStats", "branch_level", "level_inputs",
           "suffix_binary_search", "to_sibling"]

_SIBLING_HOPS = 2  # bounded hops; batch ops keep parents exact so 2 suffices


class BranchStats(NamedTuple):
    feat_rounds: torch.Tensor     # int32 [B] feature rows examined (all levels)
    suffix_bs: torch.Tensor       # int32 [B] # of suffix binary searches taken
    key_compares: torch.Tensor    # int32 [B] full key comparisons performed
    lines_touched: torch.Tensor   # int32 [B] modeled 64B cache lines loaded
    sibling_hops: torch.Tensor    # int32 [B]

    @staticmethod
    def zeros(b: int, device=None) -> "BranchStats":
        z = torch.zeros((b,), dtype=torch.int32, device=device)
        return BranchStats(z, z, z, z, z)

    def __add__(self, o: "BranchStats") -> "BranchStats":
        return BranchStats(*(a + b for a, b in zip(self, o)))


def _first_diff_cmp(a: torch.Tensor, b: torch.Tensor,
                    nbytes: torch.Tensor) -> torch.Tensor:
    """3-way compare of the first ``nbytes`` bytes of a vs b. [B, L] inputs;
    the difference is masked to those bytes before the first nonzero one is
    taken."""
    L = a.shape[-1]
    pos = torch.arange(L, dtype=torch.int32, device=a.device)
    m = pos[None, :] < nbytes[:, None]
    diff = (a.to(torch.int32) - b.to(torch.int32)) * m
    nz = diff != 0
    first_idx = torch.where(nz, pos, L).amin(-1).clamp(max=L - 1)
    first = torch.gather(diff, -1, first_idx[:, None].long())[:, 0]
    return torch.where(nz.any(-1), torch.sign(first), 0).to(torch.int32)


def suffix_binary_search(anchors, node_ids, key_bytes, key_lens, qb, ql, lo,
                         hi, billed, ns: int, count_compares: bool):
    """Binary search over anchor runs ``[lo, hi]``, lanes gated by ``billed``.

    Each round gathers one anchor id per lane (``anchors[node_ids, mid]``)
    and compares that anchor's full key with the query; it steps right while
    ``anchor <= query``. The loop runs while any lane is active, so its trip
    count is ``ceil(log2(w))`` for the widest billed run ``w``. Unbilled
    lanes start with an empty run. Returns ``(lo_final, key_cmp)``, with
    ``key_cmp`` all-zero when ``count_compares`` is off.
    """
    lo_b = torch.where(billed, lo, 0)
    hi_b = torch.where(billed, hi + 1, 0)
    key_cmp = torch.zeros_like(lo_b)
    while True:
        active = lo_b < hi_b
        if not bool(active.any()):
            break
        mid = torch.clamp(torch.div(lo_b + hi_b, 2, rounding_mode="floor"),
                          0, ns - 1)
        aid = anchors[node_ids.long(), mid.long()]   # one anchor id per lane
        aid_safe = torch.clamp(aid, min=0).long()
        c3 = compare_padded(key_bytes[aid_safe], key_lens[aid_safe], qb, ql)
        go_right = c3 <= 0
        lo_b = torch.where(active & go_right, mid + 1, lo_b)
        hi_b = torch.where(active & ~go_right, mid, hi_b)
        if count_compares:
            key_cmp = key_cmp + active.to(torch.int32)
    return lo_b, key_cmp


def branch_level(level: Level, key_bytes: torch.Tensor, key_lens: torch.Tensor,
                 node_ids: torch.Tensor, qb: torch.Tensor, ql: torch.Tensor,
                 collect_stats: bool = True,
                 ) -> Tuple[torch.Tensor, Optional[BranchStats]]:
    """Resolve child ids for a batch at one level. Returns (child_ids,
    stats); stats is ``None`` when ``collect_stats`` is off."""
    B = node_ids.shape[0]
    nid = node_ids.long()
    knum = level.knum[nid]
    # all-trivial short-circuit: the upper chain levels of an under-full
    # fixed-height tree are single-child nodes for the whole batch, so the
    # feature loop, prefix compare and suffix search are dead work there
    if bool((knum <= 1).all()):
        child = level.children[nid, 0]
        return child, (BranchStats.zeros(B, qb.device) if collect_stats
                       else None)
    return _branch_level_full(level, key_bytes, key_lens, nid, knum, qb, ql,
                              collect_stats)


def level_inputs(level: Level, nid: torch.Tensor, qb: torch.Tensor):
    """The feature rounds' inputs for a batch at one level: ``(feats [B, fs,
    ns] u8, qfeat [B, fs] u8, knum [B], pcmp [B])`` — each query's node row
    gathered, the 3-way prefix compare, and the query's byte ``plen + fid``
    for every feature row (0 past the key width)."""
    fs = level.features.shape[-2]
    L = qb.shape[-1]
    knum = level.knum[nid]
    plen = level.plen[nid]
    feats = level.features[nid]
    pcmp = _first_diff_cmp(qb, level.prefix[nid], plen)
    qpos = plen[:, None] + torch.arange(fs, dtype=torch.int32,
                                        device=qb.device)[None, :]
    qfeat = torch.gather(qb, -1, torch.clamp(qpos, 0, L - 1).long())
    qfeat = torch.where(qpos < L, qfeat, 0).to(torch.uint8)
    return feats, qfeat, knum, pcmp


def _branch_level_full(level, key_bytes, key_lens, nid, knum, qb, ql,
                       collect_stats):
    ns = level.features.shape[-1]
    lines_per_row = max(1, ns // 64)
    feats, qfeat, _, pcmp = level_inputs(level, nid, qb)

    idx, resolved, run_lo, run_hi, rounds = feature_compare_rounds(
        feats, qfeat, knum, pcmp, collect_stats=collect_stats)
    # a prefix mismatch or a trivial node decided the branch outright; the
    # remaining lanes take the suffix binary search over the surviving run
    billed_bs = ~resolved
    lo_b, key_cmp = suffix_binary_search(
        level.anchors, nid, key_bytes, key_lens, qb, ql, run_lo, run_hi,
        billed_bs, ns, count_compares=collect_stats)
    kmax = torch.clamp(knum - 1, min=0)
    bs_idx = torch.minimum(torch.clamp(lo_b - 1, min=0), kmax)
    idx = torch.where(billed_bs, bs_idx, idx)
    child = level.children[nid, idx.long()]

    if not collect_stats:
        return child, None
    kw_lines = torch.div(ql + 63, 64, rounding_mode="floor")
    stats = BranchStats(
        feat_rounds=rounds,
        suffix_bs=billed_bs.to(torch.int32),
        key_compares=key_cmp,
        # trivial lanes are never billed: rounds and key_cmp are 0 there
        lines_touched=torch.where(
            knum <= 1, 0,
            1 + rounds * lines_per_row + key_cmp * (1 + kw_lines) + 1
        ).to(torch.int32),
        sibling_hops=torch.zeros_like(rounds),
    )
    return child, stats


def to_sibling(tree: FBTree, leaf_ids: torch.Tensor, qb: torch.Tensor,
               ql: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Blink-style high-key check (§4.3): hop right while query >= high_key,
    at most ``_SIBLING_HOPS`` times. Returns ``(leaf_ids, hops)``."""
    a = tree.arrays
    hops = torch.zeros_like(leaf_ids, dtype=torch.int32)
    for _ in range(_SIBLING_HOPS):
        lid = leaf_ids.long()
        hk = a.leaf_high[lid]
        nxt = a.leaf_next[lid]
        hk_safe = torch.clamp(hk, min=0).long()
        c = compare_padded(qb, ql, a.key_bytes[hk_safe], a.key_lens[hk_safe])
        must_hop = (hk >= 0) & (c >= 0) & (nxt >= 0)
        leaf_ids = torch.where(must_hop, nxt, leaf_ids)
        hops = hops + must_hop.to(torch.int32)
    return leaf_ids, hops
