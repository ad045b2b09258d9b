"""Baseline B+-tree branch/probe variants for the paper's factor analysis —
the port's counterpart of ``repro.core.baseline``.

Fig. 12(a) enables optimizations one by one starting from a typical B+-tree:

  base       binary search over anchors in inner nodes + binary search in
             sorted leaves (STX-B+-tree / B+-treeOLC behaviour)
  +prefix    compare the common prefix once, then binary search on suffixes
  +feature2  feature comparison with fs=2 (build the tree with fs=2)
  +feature4  feature comparison with fs=4 (the default engine)
  +hashtag   hashtag probe in leaves instead of leaf binary search

All variants run over the same ``FBTree`` arrays, so the modeled hardware
counters (key compares, 64B lines touched) are directly comparable. Plain
torch: the reference has no kernel here either; the feature steps run
through whatever level or descent backend the engine names (the ``"cuda"``
level backend runs the feature-comparison kernel).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from .batch_ops import _queries
from .branch import BranchStats, _first_diff_cmp
from .fbtree import FBTree, Level
from .keys import compare_padded
from .leaf import LeafStats, probe
from .traverse import TraversalEngine, resolve_engine

__all__ = ["branch_level_binary", "probe_leaf_binary", "lookup_variant",
           "VARIANTS"]

VARIANTS = ("base", "prefix", "feature", "feature+hash")


def _full_cmp(key_bytes, key_lens, aid, qb, ql):
    """3-way compare of the key pool rows ``aid`` against the queries."""
    aid_safe = torch.clamp(aid, min=0).long()
    return compare_padded(key_bytes[aid_safe], key_lens[aid_safe], qb, ql)


def _mid(lo, hi, ns: int):
    return torch.clamp(torch.div(lo + hi, 2, rounding_mode="floor"), 0,
                       ns - 1)


def branch_level_binary(level: Level, key_bytes, key_lens, node_ids, qb, ql,
                        use_prefix: bool, collect_stats: bool = True,
                        ) -> Tuple[torch.Tensor, Optional[BranchStats]]:
    """Classic binary-search branch (optionally with the +prefix skip).

    ``ns.bit_length()`` full-key compare rounds over each node's anchors
    (lanes whose run is empty stop counting); with ``use_prefix`` a
    mismatch of the node's common prefix decides the branch outright."""
    B = node_ids.shape[0]
    ns = level.features.shape[-1]
    nid = node_ids.long()
    knum = level.knum[nid]
    plen = level.plen[nid]
    if use_prefix:
        # one prefix compare, counted as touching the prefix line(s)
        pcmp = _first_diff_cmp(qb, level.prefix[nid], plen)
    else:
        pcmp = torch.zeros((B,), dtype=torch.int32, device=qb.device)

    lo = torch.zeros((B,), dtype=torch.int32, device=qb.device)
    hi = knum
    key_cmp = torch.zeros_like(lo)
    for _ in range(max(1, ns.bit_length())):
        active = lo < hi
        mid = _mid(lo, hi, ns)
        c = _full_cmp(key_bytes, key_lens, level.anchors[nid, mid.long()],
                      qb, ql)
        go_right = c <= 0
        lo = torch.where(active & go_right, mid + 1, lo)
        hi = torch.where(active & ~go_right, mid, hi)
        if collect_stats:
            key_cmp = key_cmp + active.to(torch.int32)
    kmax = torch.clamp(knum - 1, min=0)
    idx = torch.minimum(torch.clamp(lo - 1, min=0), kmax)
    idx = torch.where(pcmp < 0, 0, idx)
    idx = torch.where(pcmp > 0, kmax, idx)
    trivial = knum <= 1
    idx = torch.where(trivial, 0, idx)
    child = level.children[nid, idx.long()]

    if not collect_stats:
        return child, None
    # modeled lines: control line + per compare (anchor-pointer line + key
    # line(s)); +prefix adds the prefix line but shortens the compared bytes

    def nzs(x):
        return torch.where(trivial, 0, x).to(torch.int32)

    cmp_bytes = torch.clamp(ql - (plen if use_prefix else 0), min=1)
    kw_lines = torch.div(cmp_bytes + 63, 64, rounding_mode="floor")
    lines = 1 + key_cmp * (1 + kw_lines) + (1 if use_prefix else 0) + 1
    zeros = torch.zeros((B,), dtype=torch.int32, device=qb.device)
    stats = BranchStats(
        feat_rounds=zeros,
        suffix_bs=nzs(torch.ones_like(zeros)),
        key_compares=nzs(key_cmp),
        lines_touched=nzs(lines),
        sibling_hops=zeros,
    )
    return child, stats


def probe_leaf_binary(tree: FBTree, leaf_ids, qb, ql):
    """Sorted-leaf binary search (models STX; requires bulk-built leaves,
    whose occupied slots hold the keys in order from slot 0). Returns
    ``(found, slot, val, LeafStats)``; the stats are always computed."""
    a = tree.arrays
    ns = a.leaf_tags.shape[-1]
    B = leaf_ids.shape[0]
    lid = leaf_ids.long()
    kid = a.leaf_keyid[lid]
    nocc = a.leaf_occ[lid].sum(-1, dtype=torch.int32)
    rows = torch.arange(B, device=qb.device)
    lo = torch.zeros((B,), dtype=torch.int32, device=qb.device)
    hi = nocc
    key_cmp = torch.zeros_like(lo)
    for _ in range(max(1, ns.bit_length())):
        active = lo < hi
        mid = _mid(lo, hi, ns)
        c = _full_cmp(a.key_bytes, a.key_lens, kid[rows, mid.long()], qb, ql)
        go_right = c < 0
        lo = torch.where(active & go_right, mid + 1, lo)
        hi = torch.where(active & ~go_right, mid, hi)
        key_cmp = key_cmp + active.to(torch.int32)
    slot = torch.clamp(lo, 0, ns - 1)
    c = _full_cmp(a.key_bytes, a.key_lens, kid[rows, slot.long()], qb, ql)
    found = (lo < nocc) & (c == 0)
    val = a.leaf_val[lid, slot.long()]
    val = torch.where(found, val, torch.zeros_like(val))
    kw_lines = torch.div(ql + 63, 64, rounding_mode="floor")
    stats = LeafStats(
        tag_candidates=torch.zeros((B,), dtype=torch.int32, device=qb.device),
        lines_touched=(1 + (key_cmp + 1) * (1 + kw_lines)).to(torch.int32),
    )
    return found, slot, val, stats


def lookup_variant(tree: FBTree, qb, ql, variant: str = "feature+hash",
                   engine: Optional[TraversalEngine] = None):
    """Point lookup under a factor-analysis variant. Returns ``(found, val,
    stats, leaf_stats)``; ``stats.lines_touched`` includes the leaf's.

    All variants descend through the traversal engine: the binary-search
    baselines are the registered ``"binary"`` / ``"binary+prefix"``
    backends, and the feature variants use ``engine``'s backend
    (``"torch"``, ``"cuda"`` or ``"fused"``). ``engine`` also selects the
    descent layout and the stats switch. ``qb``/``ql`` may be numpy arrays
    or tensors; they are moved to the tree's device. Raises ``ValueError``
    for an unknown variant (the reference asserts).
    """
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}; expected one of "
                         f"{VARIANTS}")
    qb, ql = _queries(tree, qb, ql)
    eng = resolve_engine(engine)
    if variant in ("base", "prefix"):
        eng = TraversalEngine(
            backend="binary" if variant == "base" else "binary+prefix",
            layout=eng.layout, collect_stats=eng.collect_stats)
    node_ids, _, stats = eng.traverse(tree, qb, ql, sibling_check=True)
    if variant == "feature+hash":
        found, _, val, ls = probe(tree, node_ids, qb, ql,
                                  collect_stats=eng.collect_stats)
    else:
        found, _, val, ls = probe_leaf_binary(tree, node_ids, qb, ql)
    if ls is None:
        ls = LeafStats.zeros(node_ids.shape[0], qb.device)
    return found, val, stats._replace(
        lines_touched=stats.lines_touched + ls.lines_touched), ls
