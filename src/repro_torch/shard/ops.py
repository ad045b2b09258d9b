"""Routed batch ops over a ShardedTree (DESIGN.md §7) — the port's
counterpart of ``repro.shard.ops``.

Dispatch model: the router assigns each query its owning shard, then a
host loop runs ONE shard-local op per shard that owns lanes — the same
``core.batch_ops`` entry points every unsharded call site uses, through
the same ``TraversalEngine`` (with ``"fused"``, K1 and K2 on the card).
Each shard runs over the *full* batch with the routed-op ``mask`` hook of
``core.batch_ops``: masked-out lanes read harmlessly and never write, so a
shard-local op commits exactly its owned lanes. Shards owning no lanes are
skipped outright. Results combine on the router's device with
``torch.where`` and index scatters; the host learns the owner counts with
one copy per batch (``torch.bincount``), not one per shard.

Cross-shard ``range_scan``: each query starts in its owner shard; lanes
that exhaust the owner's leaf chain before ``max_items`` spill to the next
shard (the range partition makes the next shard's first key the chain's
successor), and the per-shard emissions, each ascending, concatenate in
shard order into the globally ascending result. Lanes that are not active
on a shard are parked on an all-0xFF start key of length ``key_width``,
so the shard does one trivial descent for them, and the host loop stops as
soon as no lane can gain.

Fault tolerance (DESIGN.md §8): every launch goes through
:func:`_dispatch`, which retries injected :class:`ShardDropped` faults
with capped exponential backoff and marks a shard unhealthy
(``ShardedTree.health``) once retries are exhausted. Unhealthy shards
degrade instead of erroring: lookups serve their lanes from the
last-barrier ``snapshots`` replica (``degraded``: possibly stale),
mutations and scans report those lanes ``failed`` (never silently dropped
or truncated), and :func:`rebalance` is the recovery barrier that
re-admits the shard with fresh health and snapshots.
"""
from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from .. import obs
from ..core import batch_ops as B
from ..core import keys as K
from ..core.faults import FaultPlan, RetryPolicy, ShardDropped
from ..core.fbtree import EMPTY
from ..core.traverse import TraversalEngine
from .build import sharded_build, sharded_build_sorted
from .router import route
from .tree import ShardedTree

__all__ = ["ShardOpReport", "RebalanceReport", "lookup_batch",
           "update_batch", "insert_batch", "remove_batch", "range_scan",
           "rebalance", "DEFAULT_RETRY"]

DEFAULT_RETRY = RetryPolicy()
I32 = torch.int32


class ShardOpReport(NamedTuple):
    """Cross-shard op outcome; tensors live on the router's device.

    A shard ends a routed op in exactly one of three states, and the
    report keeps them apart: **hit** (owned lanes, served normally),
    **skipped** (owned no lanes this batch — healthy, no launch
    attempted), or **dropped** (owned lanes but was unreachable: its lanes
    appear in ``degraded`` for lookups or ``failed`` for mutations).
    """
    found: torch.Tensor     # bool [B] — owner shard's found
    conflicts: torch.Tensor  # int32 — in-batch dedupe losers (global, once)
    splits: torch.Tensor    # int32 — leaf splits summed over shards
    error: torch.Tensor     # bool — any shard hit a capacity error
    owner: torch.Tensor     # int32 [B] — routed shard per query
    shards_hit: int         # shards that owned lanes AND served normally
    failed: torch.Tensor    # bool [B] — lane not served (owner shard down;
    #                         mutations: NOT committed)
    degraded: torch.Tensor  # bool [B] — lane served from the last-barrier
    #                         snapshot (may be stale)
    shards_skipped: int = 0  # healthy shards that owned no lanes
    shards_dropped: Tuple[int, ...] = ()   # shard ids unreachable this op


class RebalanceReport(NamedTuple):
    """Outcome of a cross-shard rebalance (a bulk-synchronous barrier)."""
    n_live: int             # keys carried into the new partition
    reclaimed: int          # key-pool rows freed across shards
    counts_before: Tuple[int, ...]   # live keys per shard pre-barrier
    counts_after: Tuple[int, ...]    # live keys per shard post-barrier


def _owner_masks(st: ShardedTree, qb, ql):
    """Route once. Returns the queries and owners on the router's device
    and the owned-lane count per shard on the host (one copy)."""
    dev = st.router.device
    qb = torch.as_tensor(qb, device=dev)
    if qb.dim() != 2 or qb.shape[-1] != st.config.key_width:
        got = "x".join(map(str, qb.shape))
        raise ValueError(
            f"query batch shape [{got}] does not match the tree's key "
            f"width {st.config.key_width}: routing compares packed words, "
            f"so keys must be zero-padded to exactly key_width bytes — "
            f"build them with repro_torch.core.keys.make_keyset(keys, "
            f"max_key_len={st.config.key_width})")
    ql = torch.as_tensor(ql, device=dev).to(I32)
    owner = route(st.router, qb, ql)
    counts = torch.bincount(owner, minlength=st.n_shards).tolist()
    return qb, ql, owner, counts


def _dispatch(st: ShardedTree, s: int, opname: str, call,
              faults: Optional[FaultPlan], retry: Optional[RetryPolicy]):
    """Launch one shard-local op through the fault layer.

    Returns the op's result, or None when the shard cannot be reached: the
    site ``shard.dispatch.<opname>`` fires per attempt; ShardDropped is
    retried with capped exponential backoff; exhausting the retries marks
    the shard down in ``st.health`` so later ops skip it outright. Any
    other exception (capacity overflow etc.) propagates unchanged — faults
    model reachability, not data errors.
    """
    if st.health is not None and not st.health.is_ok(s):
        obs.counter("shard.skipped_down", op=opname).inc()
        return None
    pol = retry if retry is not None else DEFAULT_RETRY
    delays = list(pol.delays()) + [None]        # None = no sleep after last
    with obs.span("shard.dispatch", op=opname, shard=s):
        for attempt, delay in enumerate(delays):
            try:
                if faults is not None:
                    faults.fire(f"shard.dispatch.{opname}", shard=s,
                                attempt=attempt)
                return call()
            except ShardDropped:
                obs.counter("shard.retries", op=opname).inc()
                obs.event("shard.retry", op=opname, shard=s,
                          attempt=attempt)
                if delay is not None:
                    pol.sleep(delay)
    if st.health is not None:
        st.health.mark_down(
            s, f"{opname}: unreachable after {len(delays)} attempts")
    obs.counter("shard.down", op=opname).inc()
    obs.event("shard.down", op=opname, shard=s, attempts=len(delays))
    return None


def lookup_batch(st: ShardedTree, qb, ql,
                 engine: Optional[TraversalEngine] = None,
                 faults: Optional[FaultPlan] = None,
                 retry: Optional[RetryPolicy] = None):
    """Batched point lookup across shards. Returns ``(vals [B], report)``;
    ``vals``/``found`` equal ``core.batch_ops.lookup_batch`` on one
    unsharded tree over the same keys.

    Degradation: lanes owned by an unreachable shard are served from that
    shard's last-barrier snapshot (``report.degraded``: correct as of the
    barrier, possibly stale) rather than failed. ``report.failed`` stays
    all-False for lookups.
    """
    qb, ql, owner, counts = _owner_masks(st, qb, ql)
    n, dev = qb.shape[0], qb.device
    vals = torch.zeros((n,), dtype=st.config.val_dtype, device=dev)
    found = torch.zeros((n,), dtype=torch.bool, device=dev)
    degraded = torch.zeros((n,), dtype=torch.bool, device=dev)
    hit = skipped = 0
    dropped = []
    for s, t in enumerate(st.shards):
        if not counts[s]:
            skipped += 1                        # healthy skip, not a drop
            continue
        sel = owner == s
        res = _dispatch(
            st, s, "lookup",
            lambda: B.lookup_batch(t, qb.to(t.device), ql.to(t.device),
                                   engine=engine),
            faults, retry)
        if res is None:
            # degrade: the snapshot replica is reachable by construction
            # (it lives with the router, not behind the downed dispatch)
            snap = st.snapshots[s]
            v, rep = B.lookup_batch(snap, qb.to(snap.device),
                                    ql.to(snap.device), engine=engine)
            degraded |= sel
            dropped.append(s)
            obs.counter("shard.degraded_lanes", op="lookup").inc(counts[s])
            obs.event("shard.degraded", op="lookup", shard=s,
                      lanes=counts[s])
        else:
            v, rep = res
            hit += 1
        vals = torch.where(sel, v.to(dev), vals)
        found = torch.where(sel, rep.found.to(dev), found)
    rep = ShardOpReport(
        found=found, conflicts=torch.zeros((), dtype=I32, device=dev),
        splits=torch.zeros((), dtype=I32, device=dev),
        error=torch.zeros((), dtype=torch.bool, device=dev), owner=owner,
        shards_hit=hit, failed=torch.zeros((n,), dtype=torch.bool,
                                           device=dev),
        degraded=degraded, shards_skipped=skipped,
        shards_dropped=tuple(dropped))
    return vals, rep


def _routed_mutation(st: ShardedTree, owner, counts, opname, run_one, faults,
                     retry):
    """Shared mutation loop: run ``run_one(shard_tree, mask)`` on every
    reachable shard owning lanes; returns ``(new shards, outcomes, failed,
    skipped, dropped)``.

    Lanes of an unreachable shard are reported ``failed`` and its tree is
    left untouched (the mutation is NOT committed there), so a caller can
    re-apply exactly the failed lanes after recovery.
    """
    shards = list(st.shards)
    outcomes = []
    failed = torch.zeros(owner.shape, dtype=torch.bool, device=owner.device)
    skipped = 0
    dropped = []
    for s, t in enumerate(st.shards):
        if not counts[s]:
            skipped += 1                        # healthy skip, not a drop
            continue
        sel = owner == s
        res = _dispatch(st, s, opname,
                        lambda t=t, sel=sel: run_one(t, sel.to(t.device)),
                        faults, retry)
        if res is None:
            failed |= sel
            dropped.append(s)
            obs.counter("shard.failed_lanes", op=opname).inc(counts[s])
            obs.event("shard.failed", op=opname, shard=s, lanes=counts[s])
            continue
        shards[s], out = res
        outcomes.append((sel, out))
    return tuple(shards), outcomes, failed, skipped, tuple(dropped)


def _combine(outcomes, owner, failed, skipped=0,
             dropped=()) -> ShardOpReport:
    dev = owner.device
    found = torch.zeros(owner.shape, dtype=torch.bool, device=dev)
    splits = torch.zeros((), dtype=I32, device=dev)
    error = torch.zeros((), dtype=torch.bool, device=dev)
    conflicts = torch.zeros((), dtype=I32, device=dev)
    for i, (sel, rep) in enumerate(outcomes):
        found = torch.where(sel, rep.found.to(dev), found)
        splits = splits + rep.splits.to(dev)
        error = error | rep.error.to(dev)
        if i == 0:
            # per-shard ops dedupe the FULL batch before the mask ANDs in,
            # so any one report already carries the global conflict count
            conflicts = rep.conflicts.to(dev)
    return ShardOpReport(found=found, conflicts=conflicts, splits=splits,
                         error=error, owner=owner, shards_hit=len(outcomes),
                         failed=failed,
                         degraded=torch.zeros(owner.shape, dtype=torch.bool,
                                              device=dev),
                         shards_skipped=skipped,
                         shards_dropped=tuple(dropped))


def update_batch(st: ShardedTree, qb, ql, vals,
                 engine: Optional[TraversalEngine] = None,
                 faults: Optional[FaultPlan] = None,
                 retry: Optional[RetryPolicy] = None):
    """Routed blind update. Returns ``(ShardedTree', report)``."""
    qb, ql, owner, counts = _owner_masks(st, qb, ql)
    vals = torch.as_tensor(vals, device=qb.device)

    def run_one(t, mask):
        d = t.device
        return B.update_batch(t, qb.to(d), ql.to(d), vals.to(d),
                              engine=engine, mask=mask)
    shards, outcomes, failed, skipped, dropped = _routed_mutation(
        st, owner, counts, "update", run_one, faults, retry)
    return (st.replace(shards=shards),
            _combine(outcomes, owner, failed, skipped, dropped))


def remove_batch(st: ShardedTree, qb, ql,
                 engine: Optional[TraversalEngine] = None,
                 faults: Optional[FaultPlan] = None,
                 retry: Optional[RetryPolicy] = None):
    """Routed tombstone removal. Returns ``(ShardedTree', report)``."""
    qb, ql, owner, counts = _owner_masks(st, qb, ql)

    def run_one(t, mask):
        d = t.device
        return B.remove_batch(t, qb.to(d), ql.to(d), engine=engine,
                              mask=mask)
    shards, outcomes, failed, skipped, dropped = _routed_mutation(
        st, owner, counts, "remove", run_one, faults, retry)
    return (st.replace(shards=shards),
            _combine(outcomes, owner, failed, skipped, dropped))


def insert_batch(st: ShardedTree, qb, ql, vals,
                 engine: Optional[TraversalEngine] = None,
                 faults: Optional[FaultPlan] = None,
                 retry: Optional[RetryPolicy] = None, **kw):
    """Routed upsert. Returns ``(ShardedTree', report, rounds)`` —
    ``rounds`` is the most split rounds any shard needed. New keys land in
    their owner shard only (the range partition is preserved); a per-shard
    capacity overflow raises exactly as the unsharded op does —
    ``rebalance`` is the recovery for skew-driven overflow."""
    qb, ql, owner, counts = _owner_masks(st, qb, ql)
    vals = torch.as_tensor(vals, device=qb.device)
    rounds_max = 0

    def run_one(t, mask):
        nonlocal rounds_max
        d = t.device
        t2, rep, rounds = B.insert_batch(t, qb.to(d), ql.to(d), vals.to(d),
                                         engine=engine, mask=mask, **kw)
        rounds_max = max(rounds_max, rounds)
        return t2, rep
    shards, outcomes, failed, skipped, dropped = _routed_mutation(
        st, owner, counts, "insert", run_one, faults, retry)
    return (st.replace(shards=shards),
            _combine(outcomes, owner, failed, skipped, dropped),
            rounds_max)


# --------------------------------------------------------------------------
# cross-shard range scan
# --------------------------------------------------------------------------

def range_scan(st: ShardedTree, qb, ql, max_items: int = 64,
               engine: Optional[TraversalEngine] = None,
               faults: Optional[FaultPlan] = None,
               retry: Optional[RetryPolicy] = None):
    """Cross-shard range scan with spill-to-next-shard continuation.

    Returns ``(gkid int64 [B, max_items], val [B, max_items], emitted
    int32 [B], rearranged int32 [B], failed bool [B])`` on the router's
    device — ascending per lane, starting at the first key >= the query;
    ``gkid`` is the global key id (``ShardedTree.key_rows`` resolves it),
    EMPTY past ``emitted``. Values, emitted counts and the resolved key
    bytes equal the unsharded §6 scan; ``rearranged`` sums the dirty
    leaves visited across shards (leaf chunking differs per partition, so
    it is *not* comparable to the unsharded count).

    Degradation: a lane whose next needed shard is unreachable is marked
    ``failed`` and stops there — its emissions so far are a correct
    ascending *prefix* of the full result. ``failed[i]`` false guarantees
    lane ``i`` is complete. Failed lanes take no items from later shards
    (a gap would corrupt the ascending merge), and snapshots are not
    substituted here for the same reason.
    """
    if max_items < 1:
        raise ValueError(
            f"range_scan: max_items must be >= 1, got {max_items} — each "
            f"lane emits up to max_items (key, value) pairs")
    qb, ql, owner, counts = _owner_masks(st, qb, ql)
    n, dev = qb.shape[0], qb.device
    L, stride, M = st.config.key_width, st.kid_stride, max_items
    # one scratch column at index M for masked scatter dumps; it only ever
    # receives the EMPTY / 0 it holds, so repeated writes agree
    out_kid = torch.full((n, M + 1), EMPTY, dtype=torch.int64, device=dev)
    out_val = torch.zeros((n, M + 1), dtype=st.config.val_dtype, device=dev)
    emitted = torch.zeros((n,), dtype=I32, device=dev)
    rearranged = torch.zeros((n,), dtype=I32, device=dev)
    failed = torch.zeros((n,), dtype=torch.bool, device=dev)
    # parked lanes descend to the last leaf and emit (almost) nothing
    park_b = torch.full((L,), 0xFF, dtype=torch.uint8, device=dev)
    cols = torch.arange(M, dtype=I32, device=dev)[None, :]
    later = np.cumsum(counts[::-1])[::-1]        # lanes owned by >= s

    for s, t in enumerate(st.shards):
        active = (owner <= s) & (emitted < M) & ~failed
        n_active = int(active.sum())
        if not n_active:
            # stop only when NO lane can still gain: lanes owned by later
            # shards have not started yet (owners may be clustered, {0, 3})
            if s + 1 >= len(counts) or not later[s + 1]:
                break
            continue
        sqb = torch.where(active[:, None], qb, park_b)
        sql = torch.where(active, ql, L)
        d = t.device
        res = _dispatch(
            st, s, "range_scan",
            lambda: B.range_scan(t, sqb.to(d), sql.to(d), max_items=M,
                                 engine=engine),
            faults, retry)
        if res is None:
            failed |= active      # partial prefix, flagged — never silent
            obs.counter("shard.failed_lanes", op="range_scan").inc(n_active)
            obs.event("shard.failed", op="range_scan", shard=s,
                      lanes=n_active)
            continue
        kid_s, val_s, em_s, re_s = (x.to(dev) for x in res)
        take = torch.where(active, torch.minimum(em_s, M - emitted), 0)
        ok = cols < take[:, None]          # emitted slots only: kid_s >= 0
        dst = torch.where(ok, emitted[:, None] + cols, M).long()
        out_kid.scatter_(1, dst, torch.where(ok, kid_s.long() + s * stride,
                                             EMPTY))
        out_val.scatter_(1, dst, torch.where(ok, val_s, 0).to(out_val.dtype))
        emitted = (emitted + take).to(I32)
        rearranged = (rearranged + torch.where(active, re_s, 0)).to(I32)
    return (out_kid[:, :M].contiguous(), out_val[:, :M].contiguous(),
            emitted, rearranged, failed)


# --------------------------------------------------------------------------
# rebalance — the skew-recovery barrier
# --------------------------------------------------------------------------

def rebalance(st: ShardedTree, device: bool = True,
              faults: Optional[FaultPlan] = None
              ) -> Tuple[ShardedTree, RebalanceReport]:
    """Re-partition the live key set evenly across shards.

    Built on the rebuild primitive (DESIGN.md §5/§7):
    ``core.batch_ops.gather_live_sorted`` snapshots each shard — sorted,
    tombstones dropped, pool compacted — and because shards are
    range-partitioned, the snapshots concatenated in shard order ARE the
    globally sorted live set. That set is split into balanced runs again
    and rebuilt with the *same* shared ``TreeConfig`` and the same mesh
    placement, with a fresh router from the new boundaries. With
    ``device=True`` the concatenation, the split and every shard's build
    stay on the device (each shard equals the device build of its
    ``sharded_partition`` run); ``device=False`` runs the host path,
    ``sharded_build(presorted=True)``.

    Same barrier semantics as ``rebuild``: key ids (global ones included)
    are not stable across it, versions reset, values carry over. With
    ``n_shards == 1`` it degenerates to exactly ``rebuild``.

    This is also the **recovery barrier** (DESIGN.md §8): the snapshots
    are gathered from the authoritative per-shard arrays, which survive a
    dispatch outage intact, so every committed op is carried over, and the
    fresh ShardedTree starts with all-healthy ``health`` and new barrier
    ``snapshots``. Run it through ``core.lifecycle.TreeVersionManager``
    (``manager.rebalance()``) to make it abortable: the fault sites
    ``lifecycle.rebalance.gather`` (per shard) and ``.build`` then leave
    the old partition serving.
    """
    counts_before = tuple(int(t.n_keys_live) for t in st.shards)
    home = st.router.device
    with obs.span("shard.rebalance", n_shards=st.n_shards):
        kbs: List[torch.Tensor] = []
        kls: List[torch.Tensor] = []
        vvs: List[torch.Tensor] = []
        reclaimed = 0
        for s, t in enumerate(st.shards):
            if faults is not None:
                faults.fire("lifecycle.rebalance.gather", shard=s)
            kb, kl, _, vv, n_live = B.gather_live_sorted(t)
            n = int(n_live)
            reclaimed += int(t.arrays.key_count) - n
            kbs.append(kb[:n].to(home))
            kls.append(kl[:n].to(home))
            vvs.append(vv[:n].to(home))
            del kb, kl, vv
        kb, kl, vv = torch.cat(kbs), torch.cat(kls), torch.cat(vvs)
        del kbs, kls, vvs
        if faults is not None:
            faults.fire("lifecycle.rebalance.build")
        if device:
            st2 = sharded_build_sorted(kb, kl, vv, st.n_shards, st.config,
                                       st.mesh)
        else:
            # the concatenation is already globally sorted (invariant
            # above) — presorted skips re-running step 1's sort
            st2 = sharded_build(K.KeySet(kb.cpu().numpy(), kl.cpu().numpy()),
                                vv.cpu().numpy(), st.n_shards, cfg=st.config,
                                mesh=st.mesh, presorted=True, target=home)
    rep = RebalanceReport(
        n_live=int(kb.shape[0]), reclaimed=reclaimed,
        counts_before=counts_before,
        counts_after=tuple(int(t.n_keys_live) for t in st2.shards))
    obs.event("rebalance", n_live=rep.n_live, reclaimed=rep.reclaimed)
    return st2, rep
