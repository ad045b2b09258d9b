"""Structural fsck over real ``TreeArrays`` (DESIGN.md §8) — the port's
counterpart of ``repro.core.fsck``, for FBTrees (:func:`check_tree`) and
ShardedTrees (:func:`check_sharded`).

``core.protocol.check_invariants`` validates the §2 concurrency protocol
on a *simulated* tree; this module ports the same invariants — chain
order, high-key coverage, accounting — to the actual device arrays, plus
everything the structure-of-arrays layout adds (anchor order, DFS
reachability, meta coherence, stacked/tuple layout agreement). It is the
gate :class:`core.lifecycle.TreeVersionManager` runs on every staged tree
before a publish swap: a corrupted or half-built version can never become
the serving version.

Checks are host-side numpy (one ``.cpu().numpy()`` per array) and
O(n_live + nodes) — cheap next to the rebuild they guard. Key comparisons
use a dense rank over the pool (equal ``(bytes, len)`` rows share a rank),
so strict/non-strict boundary semantics are exact even when tombstoned
pool rows duplicate live key bytes.

Invariants (each has a corruption in ``core.faults.CORRUPTIONS`` proving
it detectable):

1. watermarks in range; no occupied slot outside ``[0, leaf_count)`` rows.
2. every occupied slot's key id in ``[0, key_count)``; ids unique; live
   key *bytes* unique.
3. leaf chain from leaf 0: cycle-free, visits exactly the allocated
   leaves; ``leaf_high`` EMPTY iff last; high keys strictly ascending.
4. high-key coverage: every live key < its leaf's high; the next leaf's
   keys >= it (protocol.py's ``high_key``/order invariant).
5. ``leaf_ordered`` leaves really are ascending in slot order.
6. inner nodes: valid lanes non-EMPTY, pad lanes EMPTY, anchors strictly
   ascending, child ids in range.
7. DFS from the root reaches every allocated node/leaf exactly once,
   leaf order equals chain order, and every live key lies in its leaf's
   ``[lo, hi)`` anchor bounds.
8. ``plen``/``prefix``/``features`` equal ``recompute_inner_meta`` of the
   anchors (the §3 SIMD metadata is derived state — it must agree).
9. ``stacked`` equals ``stack_levels(levels)`` (layout coherence).
10. ``leaf_version`` >= 0, and (vs an optional ``prev`` snapshot) versions
    never regress on surviving leaves — §4.2 monotonicity.
"""
from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple

import numpy as np

import torch

from .fbtree import FBTree, recompute_inner_meta, stack_levels

__all__ = ["FsckReport", "check_tree", "check_sharded", "check",
           "assert_ok"]

_EMPTY = -1


class FsckReport(NamedTuple):
    ok: bool
    violations: Tuple[str, ...]
    n_live: int
    n_leaves: int

    def __bool__(self) -> bool:  # `if fsck.check(t):` reads naturally
        return self.ok


def _np(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy()


def _words64(kb: np.ndarray) -> np.ndarray:
    """Key bytes as big-endian uint64 words, zero-padded: the words compare
    as the bytes do."""
    n, L = kb.shape
    buf = np.zeros((n, -(-L // 8) * 8), np.uint8)
    buf[:, :L] = kb
    return buf.view(">u8").astype(np.uint64)


def _key_ranks(kb: np.ndarray, kl: np.ndarray) -> np.ndarray:
    """Dense order rank per pool row; equal (bytes, len) rows share a rank.

    The order is the tree's key order (padded-byte compare with the
    length tie-break), the reference's row-lexicographic order over
    ``bytes ‖ len_be``. The rows are sorted as 64-bit words plus the
    length with one ``np.lexsort``, which at millions of rows takes
    seconds where the reference's ``np.unique(axis=0)`` over byte rows
    takes minutes.
    """
    if kb.shape[0] == 0:
        return np.zeros((0,), np.int64)
    words = _words64(kb)
    order = np.lexsort([kl] + [words[:, i]
                               for i in range(words.shape[1] - 1, -1, -1)])
    sw, sl = words[order], kl[order]
    new = np.empty(order.shape[0], dtype=bool)
    new[0] = False
    new[1:] = (sw[1:] != sw[:-1]).any(axis=1) | (sl[1:] != sl[:-1])
    ranks = np.empty(order.shape[0], np.int64)
    ranks[order] = np.cumsum(new)
    return ranks


def _owners(kb: np.ndarray, kl: np.ndarray, sb: np.ndarray,
            sl: np.ndarray) -> np.ndarray:
    """Routed shard per key: the largest ``s`` with ``key >= split[s]``
    (0 below every split), by the tree's key order — the reference's
    rank-based owner, computed by direct compares."""
    kw, sw = _words64(kb), _words64(sb)
    cmp = np.sign(kl[:, None].astype(np.int64) - sl[None, :].astype(np.int64))
    for i in range(kw.shape[1] - 1, -1, -1):
        a, b = kw[:, None, i], sw[None, :, i]
        d = (a > b).astype(np.int64) - (a < b).astype(np.int64)
        cmp = np.where(d != 0, d, cmp)
    return np.maximum((cmp >= 0).sum(axis=1) - 1, 0)


def check_tree(tree: FBTree, name: str = "tree",
               prev: Optional[FBTree] = None,
               max_violations: int = 20) -> FsckReport:
    """Run every structural invariant; collect up to ``max_violations``."""
    cfg = tree.config
    a = tree.arrays
    v: List[str] = []

    def bad(msg: str):
        if len(v) < max_violations:
            v.append(f"{name}: {msg}")

    kb = _np(a.key_bytes)
    kl = _np(a.key_lens)
    kc = int(a.key_count)
    occ = _np(a.leaf_occ)
    kid = _np(a.leaf_keyid)
    high = _np(a.leaf_high)
    nxt = _np(a.leaf_next)
    ver = _np(a.leaf_version)
    ordered = _np(a.leaf_ordered)
    leaf_count = int(a.leaf_count)
    LCAP = cfg.leaf_cap

    # ---- 1: watermarks + allocation hygiene ----
    if not (0 <= kc <= cfg.key_cap):
        bad(f"key_count {kc} outside [0, key_cap={cfg.key_cap}]")
    if not (1 <= leaf_count <= LCAP):
        bad(f"leaf_count {leaf_count} outside [1, leaf_cap={LCAP}]")
        leaf_count = max(1, min(leaf_count, LCAP))
    if occ[leaf_count:].any():
        bad(f"occupied slots in {int(occ[leaf_count:].any(axis=1).sum())} "
            f"rows at/above the leaf watermark {leaf_count}")

    # ---- 2: live key ids ----
    locc = occ[:leaf_count]
    lkid = kid[:leaf_count]
    oob = locc & ((lkid < 0) | (lkid >= kc))
    if oob.any():
        bad(f"{int(oob.sum())} occupied slots with key id outside "
            f"[0, key_count={kc})")
    live_ids = lkid[locc & ~oob]
    if live_ids.size != np.unique(live_ids).size:
        bad("duplicate key id across occupied leaf slots")
    ranks = _key_ranks(kb, kl)
    live_rank = ranks[live_ids] if live_ids.size else np.zeros(0, np.int64)
    if live_rank.size != np.unique(live_rank).size:
        bad("duplicate live key bytes (two occupied slots, same key)")
    n_live = int(locc.sum())

    # per-leaf rank rows: rank of each occupied slot, -1 elsewhere
    slot_rank = np.full(locc.shape, -1, np.int64)
    ok_slots = locc & ~oob
    slot_rank[ok_slots] = ranks[lkid[ok_slots]]

    def leaf_min(i):
        r = slot_rank[i][slot_rank[i] >= 0]
        return int(r.min()) if r.size else None

    def leaf_max(i):
        r = slot_rank[i][slot_rank[i] >= 0]
        return int(r.max()) if r.size else None

    # ---- 3: leaf chain ----
    chain: List[int] = []
    seen = np.zeros(occ.shape[0], bool)
    cur = 0
    while cur != _EMPTY:
        if not (0 <= cur < leaf_count):
            bad(f"leaf chain points at unallocated leaf {cur}")
            break
        if seen[cur]:
            bad(f"leaf chain cycles back to leaf {cur}")
            break
        seen[cur] = True
        chain.append(cur)
        cur = int(nxt[cur])
    if len(chain) != leaf_count:
        bad(f"leaf chain visits {len(chain)} of {leaf_count} "
            f"allocated leaves")

    # ---- 3/4: high keys + order along the chain ----
    prev_high_rank = None
    for pos, i in enumerate(chain):
        last = pos == len(chain) - 1
        h = int(high[i])
        if (h == _EMPTY) != (int(nxt[i]) == _EMPTY):
            bad(f"leaf {i}: high-key EMPTY must coincide with chain end "
                f"(high={h}, next={int(nxt[i])})")
        if h != _EMPTY and not (0 <= h < max(kc, 1)):
            bad(f"leaf {i}: high key id {h} outside the pool watermark")
            h = _EMPTY
        hr = None if h == _EMPTY else int(ranks[h])
        mx, mn = leaf_max(i), leaf_min(i)
        if hr is not None and mx is not None and not (mx < hr):
            bad(f"leaf {i}: live key >= its high key")
        if prev_high_rank is not None:
            if hr is not None and not (prev_high_rank < hr):
                bad(f"leaf {i}: high keys not ascending along the chain")
            if mn is not None and mn < prev_high_rank:
                bad(f"leaf {i}: live key below the previous leaf's high "
                    f"key (chain order broken)")
        if not last and hr is not None:
            prev_high_rank = hr
        # ---- 5: ordered leaves are really ordered ----
        if bool(ordered[i]):
            sr = slot_rank[i][slot_rank[i] >= 0]
            idx = np.nonzero(slot_rank[i] >= 0)[0]
            if sr.size > 1 and not (np.diff(slot_rank[i][idx]) > 0).all():
                bad(f"leaf {i}: marked ordered but slots are not "
                    f"ascending")

    # ---- 10: versions ----
    if (ver[:leaf_count] < 0).any():
        bad("negative leaf version")
    if prev is not None and prev.config == cfg:
        pv = _np(prev.arrays.leaf_version)
        plc = int(prev.arrays.leaf_count)
        if leaf_count < plc:
            bad(f"leaf_count regressed {plc} -> {leaf_count} without a "
                f"rebuild barrier")
        n = min(plc, leaf_count)
        if (ver[:n] < pv[:n]).any():
            bad("leaf version regressed on a surviving leaf (§4.2 "
                "monotonicity)")

    # ---- 6: inner levels ----
    levels = []
    for li, lv in enumerate(a.levels):
        levels.append(dict(
            knum=_np(lv.knum), children=_np(lv.children),
            anchors=_np(lv.anchors), plen=_np(lv.plen),
            prefix=_np(lv.prefix),
            features=_np(lv.features), count=int(lv.count)))
    for li, lv in enumerate(levels):
        cap = cfg.level_caps[li]
        cnt = lv["count"]
        if not (1 <= cnt <= cap):
            bad(f"level {li}: count {cnt} outside [1, cap={cap}]")
            lv["count"] = cnt = max(1, min(cnt, cap))
        child_hi = (levels[li + 1]["count"] if li + 1 < len(levels)
                    else leaf_count)
        for r in range(cnt):
            k = int(lv["knum"][r])
            if not (1 <= k <= cfg.ns):
                bad(f"level {li} node {r}: knum {k} outside [1, ns]")
                continue
            ch = lv["children"][r]
            an = lv["anchors"][r]
            if (ch[:k] == _EMPTY).any() or (an[:k] == _EMPTY).any():
                bad(f"level {li} node {r}: EMPTY child/anchor in a valid "
                    f"lane")
                continue
            if (ch[:k] < 0).any() or (ch[:k] >= child_hi).any():
                bad(f"level {li} node {r}: child id outside "
                    f"[0, {child_hi})")
            if (an[:k] < 0).any() or (an[:k] >= max(kc, 1)).any():
                bad(f"level {li} node {r}: anchor key id outside the "
                    f"pool watermark")
                continue
            ar = ranks[an[:k]]
            if k > 1 and not (np.diff(ar) > 0).all():
                bad(f"level {li} node {r}: anchors not strictly "
                    f"ascending")

    # ---- 7: DFS reachability + bounds ----
    reached = [set() for _ in levels]
    leaf_seq: List[int] = []
    leaf_bounds = {}
    dup_reach = False

    def walk(li: int, node: int, lo, hi):
        nonlocal dup_reach
        lv = levels[li]
        if not (0 <= node < lv["count"]):
            return
        if node in reached[li]:
            dup_reach = True
            return
        reached[li].add(node)
        k = int(lv["knum"][r0 := node])
        k = max(0, min(k, cfg.ns))
        ch = lv["children"][r0]
        an = lv["anchors"][r0]
        for i in range(k):
            c = int(ch[i])
            if c == _EMPTY:
                continue
            aid = int(an[i])
            a_rank = (int(ranks[aid]) if 0 <= aid < max(kc, 1) else None)
            clo = a_rank if i > 0 else lo
            nid = int(an[i + 1]) if i + 1 < k else _EMPTY
            chi = (int(ranks[nid]) if (i + 1 < k
                                       and 0 <= nid < max(kc, 1)) else hi)
            if li + 1 < len(levels):
                walk(li + 1, c, clo, chi)
            else:
                if 0 <= c < leaf_count and c not in leaf_bounds:
                    leaf_bounds[c] = (clo, chi)
                    leaf_seq.append(c)
                elif c in leaf_bounds:
                    dup_reach = True

    walk(0, 0, None, None)
    if dup_reach:
        bad("a node or leaf is reachable twice from the root")
    for li, lv in enumerate(levels):
        if len(reached[li]) != lv["count"]:
            bad(f"level {li}: DFS reaches {len(reached[li])} of "
                f"{lv['count']} allocated nodes")
    if leaf_seq != chain:
        bad("DFS leaf order differs from the sibling chain order")
    for c, (lo, hi) in leaf_bounds.items():
        sr = slot_rank[c][slot_rank[c] >= 0]
        if sr.size == 0:
            continue
        if lo is not None and int(sr.min()) < lo:
            bad(f"leaf {c}: live key below its anchor lower bound")
        if hi is not None and int(sr.max()) >= hi:
            bad(f"leaf {c}: live key at/above its anchor upper bound")

    # ---- 8: derived inner metadata agrees with recompute ----
    if kc > 0 and not v:  # skip on earlier damage: meta of garbage anchors
        for li, lv in enumerate(a.levels):
            cnt = levels[li]["count"]
            pl, pf, ft = recompute_inner_meta(a.key_bytes, a.key_lens,
                                              lv.anchors, lv.knum, cfg.fs)
            if (not np.array_equal(_np(pl)[:cnt], levels[li]["plen"][:cnt])
                    or not np.array_equal(_np(pf)[:cnt],
                                          levels[li]["prefix"][:cnt])
                    or not np.array_equal(_np(ft)[:cnt],
                                          levels[li]["features"][:cnt])):
                bad(f"level {li}: plen/prefix/features disagree with "
                    f"recompute_inner_meta of the anchors")

    # ---- 9: stacked/tuple layout coherence ----
    st = stack_levels(a.levels)
    for f in st._fields:
        if not torch.equal(getattr(st, f), getattr(a.stacked, f)):
            bad(f"stacked layout field {f!r} out of sync with levels")
            break

    return FsckReport(ok=not v, violations=tuple(v), n_live=n_live,
                      n_leaves=leaf_count)


def check_sharded(st, prev=None, max_violations: int = 20) -> FsckReport:
    """fsck a ShardedTree: per-shard :func:`check_tree` plus the router
    invariants — ascending split keys and every shard's live keys inside
    its routed range."""
    v: List[str] = []
    n_live = 0
    n_leaves = 0
    prev_shards = getattr(prev, "shards", None)
    for s, t in enumerate(st.shards):
        p = (prev_shards[s] if prev_shards is not None
             and len(prev_shards) == len(st.shards) else None)
        rep = check_tree(t, name=f"shard{s}", prev=p,
                         max_violations=max_violations - len(v))
        v.extend(rep.violations)
        n_live += rep.n_live
        n_leaves += rep.n_leaves
    # router: ascending splits, and range partition holds
    sb = _np(st.router.split_bytes)
    sl = _np(st.router.split_lens)
    ranks = _key_ranks(sb, sl)
    if len(v) < max_violations:
        if sb.shape[0] != len(st.shards):
            v.append(f"router has {sb.shape[0]} splits for "
                     f"{len(st.shards)} shards")
        elif sb.shape[0] > 1 and not (np.diff(ranks) > 0).all():
            v.append("router split keys not strictly ascending")
    for s, t in enumerate(st.shards):
        if len(v) >= max_violations:
            break
        a = t.arrays
        occ = _np(a.leaf_occ)
        kid = _np(a.leaf_keyid)
        kc = int(a.key_count)
        ids = kid[occ]
        ids = ids[(ids >= 0) & (ids < kc)]
        if ids.size == 0:
            continue
        owner = _owners(_np(a.key_bytes)[ids], _np(a.key_lens)[ids], sb, sl)
        if (owner != s).any():
            v.append(f"shard{s}: {int((owner != s).sum())} live keys "
                     f"route to a different shard (partition broken)")
    return FsckReport(ok=not v, violations=tuple(v), n_live=n_live,
                      n_leaves=n_leaves)


def check(obj, prev=None, max_violations: int = 20) -> FsckReport:
    """Dispatch on tree flavor (FBTree vs ShardedTree, duck-typed)."""
    if hasattr(obj, "shards"):
        return check_sharded(obj, prev=prev, max_violations=max_violations)
    return check_tree(obj, prev=prev, max_violations=max_violations)


def assert_ok(obj, prev=None, context: str = ""):
    """Raise ``AssertionError`` listing the violations (chaos/CI helper)."""
    rep = check(obj, prev=prev)
    if not rep.ok:
        where = f" [{context}]" if context else ""
        raise AssertionError(
            f"fsck failed{where}: " + "; ".join(rep.violations))
    return rep
