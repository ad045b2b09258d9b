"""Leaf-node operations: hashtag probe (paper Fig. 6 lines 30-42) and
free-slot ranking — the port's counterpart of ``repro.core.leaf``."""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from .fbtree import FBTree
from .keys import fnv1a_tags

__all__ = ["LeafStats", "probe", "verify_candidates", "find_free_slots"]


class LeafStats(NamedTuple):
    tag_candidates: torch.Tensor  # int32 [B] slots passing the hashtag filter
    lines_touched: torch.Tensor   # int32 [B]

    @staticmethod
    def zeros(b: int, device=None) -> "LeafStats":
        z = torch.zeros((b,), dtype=torch.int32, device=device)
        return LeafStats(z, z)


def verify_candidates(a, cand: torch.Tensor, kid: torch.Tensor,
                      qb: torch.Tensor, ql: torch.Tensor,
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact-match verification over the hashtag candidate mask.

    Checks candidates one at a time in slot order: each round gathers one
    key per still-unmatched lane and compares it in full, so key bytes are
    read only for candidates (the paper's lines 36-38). The first matching
    candidate wins; ``slot`` is 0 where nothing matches. Returns
    ``(found [B] bool, slot [B] int32)``.
    """
    B, ns = cand.shape
    dev = cand.device
    crank = torch.cumsum(cand.to(torch.int32), dim=-1) - 1   # cand rank/slot
    n_cand = cand.sum(-1, dtype=torch.int32)
    lane = torch.arange(ns, dtype=torch.int32, device=dev)[None, :]
    rows = torch.arange(B, device=dev)
    checked = torch.zeros(B, dtype=torch.int32, device=dev)
    found = torch.zeros(B, dtype=torch.bool, device=dev)
    slot = torch.zeros(B, dtype=torch.int32, device=dev)
    while True:
        active = (~found) & (checked < n_cand)
        if not bool(active.any()):
            break
        is_k = cand & (crank == checked[:, None])
        s = torch.where(is_k, lane, ns).amin(-1)
        s = torch.where(active, torch.clamp(s, max=ns - 1), 0)
        kd = torch.clamp(kid[rows, s.long()], min=0).long()
        eqk = ((a.key_bytes[kd] == qb).all(-1) & (a.key_lens[kd] == ql)
               & active)
        slot = torch.where(eqk, s, slot)
        found = found | eqk
        checked = checked + active.to(torch.int32)
    return found, slot


def probe(tree: FBTree, leaf_ids: torch.Tensor, qb: torch.Tensor,
          ql: torch.Tensor, collect_stats: bool = True,
          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                     Optional[LeafStats]]:
    """Find each query's slot in its leaf.

    Returns (found [B] bool, slot [B] int32, val [B], stats). The hashtag
    filter ``tags == fnv1a(query) & occ`` narrows the candidates, and
    :func:`verify_candidates` compares full keys. ``val`` is 0 where the key
    was not found. ``collect_stats=False`` returns ``stats=None``.
    """
    a = tree.arrays
    ns = a.leaf_tags.shape[-1]
    lid = leaf_ids.long()
    qtag = fnv1a_tags(qb, ql)
    cand = (a.leaf_tags[lid] == qtag[:, None]) & a.leaf_occ[lid]
    kid = a.leaf_keyid[lid]                   # [B, ns]
    found, slot = verify_candidates(a, cand, kid, qb, ql)
    val = a.leaf_val[lid, slot.long()]
    val = torch.where(found, val, torch.zeros_like(val))
    if not collect_stats:
        return found, slot, val, None
    n_cand = cand.sum(-1, dtype=torch.int32)
    kw_lines = torch.div(ql + 63, 64, rounding_mode="floor")
    stats = LeafStats(
        tag_candidates=n_cand,
        # modeled: control+tags row (ns bytes -> ns/64 lines) + bitmap word +
        # per-candidate kv pointer line + key line(s)
        lines_touched=(max(1, ns // 64) + 1 + n_cand * (1 + kw_lines)
                       ).to(torch.int32),
    )
    return found, slot, val, stats


def find_free_slots(occ_row: torch.Tensor, count) -> torch.Tensor:
    """Rank free slots of a leaf row: returns int32 [ns] where entry r is the
    slot index of the r-th free slot (ns if fewer free slots exist)."""
    ns = occ_row.shape[-1]
    free = ~occ_row
    lane = torch.arange(ns, device=occ_row.device)
    order = torch.argsort(torch.where(free, lane, ns + lane))
    rank_valid = lane < torch.minimum(free.sum(), torch.as_tensor(
        count, device=occ_row.device))
    return torch.where(rank_valid, order, ns).to(torch.int32)
