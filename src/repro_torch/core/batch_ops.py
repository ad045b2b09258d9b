"""Batched tree operations — the port's counterpart of
``repro.core.batch_ops``: lookup, update, remove, insert (upsert) and
range scan, and the rebuild barrier.

Every op runs on the device its tree lives on. A point op is one engine
descent plus one hashtag leaf probe; engines whose descent backend exposes
a fused traverse+probe entry (``"fused"``) collapse both into one kernel
launch, and the ``"fused"`` scan backend runs a whole range scan in one
launch.

The reference's arrays are immutable; here every op returns a new
:class:`FBTree` and leaves its input unchanged, cloning only the arrays it
writes and updating those clones in place. The reference's jitted
``lax.while_loop``/``lax.cond`` become Python loops and ``if``s on host
syncs (the plain version; the hot paths are the kernels).

Scatter hazards, and how the port meets them (DESIGN.md §2):

* ``.at[i].add`` with repeated indices becomes
  ``index_put_(..., accumulate=True)``; plain ``t[i] += v`` would drop the
  repeats.
* ``.at[i].set`` with repeated indices: masked lanes point at the scratch
  row and write back the old value they gathered, so every repeated write
  carries the same value and CUDA's choice of writer cannot change the
  result. Each scatter below keeps that property; the only exceptions
  happen when a capacity check has already failed, and the op then raises.
* JAX clamps out-of-range gathers and drops out-of-range scatters; torch
  raises on the CPU and faults the context on CUDA. Ids that can run past a
  table when its capacity is exceeded are clamped to the scratch row, and
  the capacity error raises before the tree escapes.
* ``cumsum``/``sum`` of bool give int64 in torch: results are cast back to
  int32 wherever the reference yields int32.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import torch

from .. import obs
from .branch import BranchStats
from .fbtree import (BIG, EMPTY, FBTree, Level, TreeArrays,
                     _device_build_from_sorted, chunk_of_pos, chunk_start,
                     recompute_inner_meta, stack_levels)
from .keys import (compare_padded, fnv1a_tags, lex_sort_indices_t,
                   pack_words_t)
from .leaf import LeafStats, probe
from .traverse import TraversalEngine, resolve_engine

__all__ = ["OpReport", "lookup_batch", "update_batch", "insert_batch",
           "remove_batch", "range_scan", "dedupe_last_wins",
           "rowwise_lex_argsort", "traverse_path", "traverse_probe",
           "BuildReport", "gather_live_sorted", "rebuild"]

I32 = torch.int32


class OpReport(NamedTuple):
    found: torch.Tensor          # bool [B]
    conflicts: torch.Tensor      # int32 scalar — ops superseded inside batch
    splits: torch.Tensor         # int32 scalar — leaves split
    error: torch.Tensor          # bool scalar — capacity violated
    feat_rounds: torch.Tensor    # int32 [B]
    suffix_bs: torch.Tensor      # int32 [B]
    key_compares: torch.Tensor   # int32 [B]
    lines_touched: torch.Tensor  # int32 [B]
    tag_candidates: torch.Tensor  # int32 [B]


def _scalar(v, dtype: torch.dtype, dev: torch.device) -> torch.Tensor:
    """A 0-d tensor on ``dev``: a fill for a Python value, a cast for a
    tensor (no host-to-device copy either way)."""
    if isinstance(v, torch.Tensor):
        return v.to(dtype)
    return torch.full((), v, dtype=dtype, device=dev)


def _report(found, bstats: Optional[BranchStats],
            lstats: Optional[LeafStats] = None, conflicts=0, splits=0,
            error=False) -> OpReport:
    """``bstats``/``lstats`` may be ``None`` (stats-free engines): counters
    come back all-zero, ``found`` stays exact."""
    b, dev = found.shape[0], found.device
    z = torch.zeros((b,), dtype=I32, device=dev)
    if bstats is None:
        bstats = BranchStats.zeros(b, dev)
    return OpReport(
        found=found,
        conflicts=_scalar(conflicts, I32, dev),
        splits=_scalar(splits, I32, dev),
        error=_scalar(error, torch.bool, dev),
        feat_rounds=bstats.feat_rounds,
        suffix_bs=bstats.suffix_bs,
        key_compares=bstats.key_compares,
        lines_touched=bstats.lines_touched + (lstats.lines_touched
                                              if lstats else z),
        tag_candidates=(lstats.tag_candidates if lstats else z),
    )


def _queries(tree: FBTree, qb, ql):
    """Query bytes/lengths as tensors on the tree's device."""
    dev = tree.device
    qb = torch.as_tensor(qb, device=dev)
    ql = torch.as_tensor(ql, device=dev).to(I32)
    return qb, ql


def _lanes(tree: FBTree, vals, mask):
    """Per-lane values (in the tree's value dtype) and the optional routed-op
    mask as tensors on the tree's device."""
    dev = tree.device
    vals = torch.as_tensor(vals, device=dev).to(tree.arrays.leaf_val.dtype)
    if mask is not None:
        mask = torch.as_tensor(mask, device=dev).to(torch.bool)
    return vals, mask


def traverse_path(tree: FBTree, qb, ql, sibling_check: bool = True,
                  engine: Optional[TraversalEngine] = None):
    """Root-to-leaf traversal recording the node id at every level:
    ``(leaf_ids, path, stats)`` from the engine."""
    qb, ql = _queries(tree, qb, ql)
    return resolve_engine(engine).traverse(tree, qb, ql,
                                           sibling_check=sibling_check)


def _traverse_probe(tree: FBTree, qb, ql, engine, sibling_check=True):
    """The shared descend+probe pipeline every point op runs: one engine
    descent, one hashtag leaf probe. Returns
    (leaf_ids, path, found, slot, val, branch_stats, leaf_stats); stats may
    be ``None`` under a stats-free engine."""
    eng = resolve_engine(engine)
    fused = eng.probe_path()
    if fused is not None:
        return fused(tree, qb, ql, sibling_check=sibling_check,
                     collect_stats=eng.collect_stats)
    leaf_ids, path, bstats = eng.traverse(
        tree, qb, ql, sibling_check=sibling_check)
    found, slot, val, lstats = probe(tree, leaf_ids, qb, ql,
                                     collect_stats=eng.collect_stats)
    return leaf_ids, path, found, slot, val, bstats, lstats


def traverse_probe(tree: FBTree, qb, ql,
                   engine: Optional[TraversalEngine] = None,
                   sibling_check: bool = True):
    """Public traverse+probe (see ``_traverse_probe``)."""
    qb, ql = _queries(tree, qb, ql)
    return _traverse_probe(tree, qb, ql, engine, sibling_check)


def dedupe_last_wins(qb: torch.Tensor, ql: torch.Tensor, seq: torch.Tensor,
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Deterministic in-batch conflict resolution: highest seq per key wins.
    Returns ``(winners bool [B], conflicts int32 scalar)``."""
    B = qb.shape[0]
    order = torch.argsort(seq, stable=True)       # seq = least significant
    perm = order[lex_sort_indices_t(qb[order], ql[order])]
    sb, sl = qb[perm], ql[perm]
    same_next = torch.cat([
        (sb[1:] == sb[:-1]).all(-1) & (sl[1:] == sl[:-1]),
        torch.zeros((1,), dtype=torch.bool, device=qb.device)])
    keep_sorted = ~same_next                      # last of each equal-run wins
    winners = torch.zeros((B,), dtype=torch.bool, device=qb.device)
    winners[perm] = keep_sorted                   # perm is a permutation
    return winners, (B - keep_sorted.sum()).to(I32)


def rowwise_lex_argsort(kb: torch.Tensor, kl: torch.Tensor,
                        valid: torch.Tensor) -> torch.Tensor:
    """argsort rows of kb [R,T,L] by (valid desc, key bytes asc, len asc);
    int64 [R, T]."""
    R, T, _ = kb.shape
    words = pack_words_t(kb)                      # [R, T, W]
    perm = torch.arange(T, device=kb.device).expand(R, T)

    def resort(col_vals, perm):
        v = torch.gather(col_vals, -1, perm)
        return torch.gather(perm, -1, torch.argsort(v, dim=-1, stable=True))

    perm = resort(kl, perm)
    for col in range(words.shape[-1] - 1, -1, -1):
        perm = resort(words[..., col], perm)
    return resort((~valid).to(I32), perm)         # invalid -> end


def _seg_head_rank(sorted_ids: torch.Tensor):
    """(is_head, rank-within-run int32) for a sorted id array."""
    n = sorted_ids.shape[0]
    idx = torch.arange(n, dtype=I32, device=sorted_ids.device)
    is_head = torch.cat([torch.ones((1,), dtype=torch.bool,
                                    device=sorted_ids.device),
                         sorted_ids[1:] != sorted_ids[:-1]])
    head_pos = torch.cummax(torch.where(is_head, idx, 0), dim=0).values
    return is_head, idx - head_pos


def _put(arr: torch.Tensor, idx, new, keep: torch.Tensor) -> None:
    """``arr[idx] = where(keep, new, arr[idx])`` in place: lanes with
    ``keep`` false write back the value they gathered (the reference's
    masked ``.at[idx].set``). ``new`` is a tensor or a Python scalar."""
    old = arr[idx]
    keep = keep.reshape(keep.shape + (1,) * (old.dim() - keep.dim()))
    if isinstance(new, torch.Tensor):
        new = new.to(arr.dtype)
    arr[idx] = torch.where(keep, new, old)


# --------------------------------------------------------------------------
# lookup / update / remove
# --------------------------------------------------------------------------

def _lookup(tree, qb, ql, sibling_check, engine):
    _, _, found, _, val, bstats, lstats = _traverse_probe(
        tree, qb, ql, engine, sibling_check)
    return val, _report(found, bstats, lstats)


def lookup_batch(tree: FBTree, qb, ql, sibling_check: bool = True,
                 engine: Optional[TraversalEngine] = None):
    """Batched point lookup. Returns (vals [B], report).

    ``qb``/``ql`` may be numpy arrays or tensors; they are moved to the
    tree's device. Telemetry (DESIGN.md §9): with ``repro_torch.obs``
    enabled, the call runs under a host span (histogram
    ``span.op.lookup``) and the report's counters drain into the registry
    with one device-to-host copy per batch. With it off this is the bare
    call.
    """
    qb, ql = _queries(tree, qb, ql)
    if not obs.enabled():
        return _lookup(tree, qb, ql, sibling_check, engine)
    with obs.span("op.lookup"):
        val, rep = _lookup(tree, qb, ql, sibling_check, engine)
        obs.drain_op_report("lookup", rep)
    return val, rep


def _point_write_lanes(tree: FBTree, qb, ql, engine, mask):
    """Dedupe + descend + probe shared by update, remove and insert: returns
    the dedupe winners, the lanes that write in place (``do`` = winners
    whose key was found), their scatter coordinates (the other lanes point
    at the scratch leaf) and the report inputs."""
    B = qb.shape[0]
    dump = tree.arrays.leaf_occ.shape[0] - 1
    winners, conflicts = dedupe_last_wins(
        qb, ql, torch.arange(B, dtype=I32, device=qb.device))
    if mask is not None:
        winners = winners & mask
    leaf_ids, _, found, slot, _, bstats, lstats = _traverse_probe(
        tree, qb, ql, engine)
    do = winners & found
    li = torch.where(do, leaf_ids, dump).long()
    return winners, do, (li, slot.long()), found, bstats, lstats, conflicts


def _update(tree, qb, ql, vals, engine, mask):
    _, do, at, found, bstats, lstats, conflicts = _point_write_lanes(
        tree, qb, ql, engine, mask)
    lv = tree.arrays.leaf_val.clone()
    _put(lv, at, vals, do)
    return tree.replace(leaf_val=lv), _report(found, bstats, lstats,
                                              conflicts=conflicts)


def update_batch(tree: FBTree, qb, ql, vals,
                 engine: Optional[TraversalEngine] = None, mask=None):
    """Blind value update for existing keys (latch-free CAS analogue).
    Returns ``(tree', report)``.

    Does NOT bump leaf versions (§4.2 — readers never restart on updates).
    ``mask`` (bool [B], optional) is the routed-op hook (DESIGN.md §7):
    lanes with ``mask=False`` never write. ``found`` is reported for every
    lane regardless of mask. Same obs contract as :func:`lookup_batch`
    (span ``op.update``).
    """
    qb, ql = _queries(tree, qb, ql)
    vals, mask = _lanes(tree, vals, mask)
    if not obs.enabled():
        return _update(tree, qb, ql, vals, engine, mask)
    with obs.span("op.update"):
        tree2, rep = _update(tree, qb, ql, vals, engine, mask)
        obs.drain_op_report("update", rep)
    return tree2, rep


def _remove(tree, qb, ql, engine, mask):
    a = tree.arrays
    _, do, at, found, bstats, lstats, conflicts = _point_write_lanes(
        tree, qb, ql, engine, mask)
    occ, kid, ver = (a.leaf_occ.clone(), a.leaf_keyid.clone(),
                     a.leaf_version.clone())
    _put(occ, at, False, do)
    _put(kid, at, EMPTY, do)
    ver.index_put_((at[0],), do.to(I32), accumulate=True)
    return (tree.replace(leaf_occ=occ, leaf_keyid=kid, leaf_version=ver),
            _report(found, bstats, lstats, conflicts=conflicts))


def remove_batch(tree: FBTree, qb, ql,
                 engine: Optional[TraversalEngine] = None, mask=None):
    """Tombstone removal (slot cleared, version bumped). Returns
    ``(tree', report)``. ``mask`` gates writes exactly as in
    :func:`update_batch`; same obs contract (span ``op.remove``)."""
    qb, ql = _queries(tree, qb, ql)
    if mask is not None:
        mask = torch.as_tensor(mask, device=tree.device).to(torch.bool)
    if not obs.enabled():
        return _remove(tree, qb, ql, engine, mask)
    with obs.span("op.remove"):
        tree2, rep = _remove(tree, qb, ql, engine, mask)
        obs.drain_op_report("remove", rep)
    return tree2, rep


# --------------------------------------------------------------------------
# insert (upsert)
# --------------------------------------------------------------------------

def _prepare_insert(tree: FBTree, qb, ql, vals, engine, mask):
    """Dedupe, update existing keys in place, append new key bytes to pool.

    ``mask`` (routed-op hook): masked-out lanes lose the dedupe outright,
    so they neither update in place nor append to the pool. Returns
    ``(tree', kid_op int32 [B], is_new bool [B], report)``."""
    a = tree.arrays
    kdump = a.key_bytes.shape[0] - 1
    winners, upd, at, found, bstats, lstats, conflicts = _point_write_lanes(
        tree, qb, ql, engine, mask)
    lv = a.leaf_val.clone()
    _put(lv, at, vals, upd)

    is_new = winners & ~found
    offs = torch.cumsum(is_new.to(I32), 0).to(I32) - 1
    kid_op = torch.where(is_new, a.key_count + offs, EMPTY).to(I32)
    n_new = is_new.sum().to(I32)
    err = (a.key_count + n_new) > kdump
    # a new key past the pool's last row is routed to the scratch row; that
    # only happens when err is set, and insert_batch then raises
    dst = torch.where(is_new & (kid_op < kdump), kid_op, kdump).long()
    kb_new, kl_new, kt_new = (a.key_bytes.clone(), a.key_lens.clone(),
                              a.key_tags.clone())
    _put(kb_new, dst, qb, is_new)
    _put(kl_new, dst, ql, is_new)
    _put(kt_new, dst, fnv1a_tags(qb, ql), is_new)
    tree2 = tree.replace(leaf_val=lv, key_bytes=kb_new, key_lens=kl_new,
                         key_tags=kt_new, key_count=(a.key_count + n_new).to(I32))
    return tree2, kid_op, is_new, _report(found, bstats, lstats,
                                          conflicts=conflicts, error=err)


class _Repack(NamedTuple):
    """Chunking state of :func:`_repack_rows` (the reference's dict)."""
    a: torch.Tensor             # [R, T] sorted item ids (key ids / anchors)
    b: torch.Tensor             # [R, T] sorted payloads (values / children)
    valid: torch.Tensor         # [R, T]
    Tcnt: torch.Tensor          # [R] valid items per row
    n_chunks: torch.Tensor      # [R]
    chunk: torch.Tensor         # [R, T] chunk of each item
    slot: torch.Tensor          # [R, T] slot of each item in its chunk
    cidx: torch.Tensor          # [1, c_max]
    chunk_exists: torch.Tensor  # [R, c_max]
    csize: torch.Tensor         # [R, c_max]
    cmin: torch.Tensor          # [R, c_max] first item of each chunk


def _repack_rows(kb_store, kl_store, item_a, item_b, item_valid, row_valid,
                 fill: int, c_max: int) -> _Repack:
    """Sort row workspaces by key and cut them into balanced chunks of at
    most ``fill`` items."""
    dev = item_a.device
    ia = torch.clamp(item_a, min=0).long()
    akb = kb_store[ia]
    akl = torch.where(item_valid, kl_store[ia], 0)
    sperm = rowwise_lex_argsort(akb, akl, item_valid)
    item_a, item_b, item_valid = (torch.gather(x, -1, sperm)
                                  for x in (item_a, item_b, item_valid))
    T = item_a.shape[1]
    Tcnt = item_valid.sum(-1, dtype=I32)
    n_chunks = torch.where(row_valid, -torch.div(-Tcnt, fill,
                                                 rounding_mode="floor"),
                           0).to(I32)
    nc1 = torch.clamp(n_chunks, min=1)
    base = torch.div(Tcnt, nc1, rounding_mode="floor").to(I32)
    rem = (Tcnt - base * nc1).to(I32)
    pos = torch.arange(T, dtype=I32, device=dev)[None, :]
    chunk = chunk_of_pos(pos, base[:, None], rem[:, None])
    chunk = torch.where(item_valid, torch.clamp(chunk, max=c_max - 1),
                        c_max - 1).to(I32)
    slot = (pos - chunk_start(chunk, base[:, None], rem[:, None])).to(I32)
    cidx = torch.arange(c_max, dtype=I32, device=dev)[None, :]
    cstart = chunk_start(cidx, base[:, None], rem[:, None])
    chunk_exists = (cidx < n_chunks[:, None]) & row_valid[:, None]
    csize = (base[:, None] + (cidx < rem[:, None])).to(I32)
    cmin = torch.gather(item_a, -1, torch.clamp(cstart, max=T - 1).long())
    return _Repack(item_a, item_b, item_valid, Tcnt, n_chunks, chunk, slot,
                   cidx, chunk_exists, csize, cmin)


def _make_insert_round(cfg, max_ov: int, ins_cap: int,
                       engine: TraversalEngine):
    """Build the per-round insert function (a plain closure: PyTorch runs
    eagerly, so nothing is compiled or cached)."""
    ns, fs = cfg.ns, cfg.fs
    lfill = cfg.leaf_fill
    ifill = cfg.inner_fill
    C_MAX = -(-(ns + ins_cap) // lfill) + 1
    # worst-case anchors arriving at one parent: every one of its <= ns ov
    # children contributes C_MAX-1 new chunks (one extra level of slack; the
    # error flag + raise in insert_batch is the backstop for pathologies)
    IN_CAP = min(max_ov, ns) * (C_MAX - 1) + ns
    # the round's descent only needs leaf ids and paths, which are the same
    # with the counters off
    eng = dataclasses.replace(engine, collect_stats=False)

    def round_fn(tree: FBTree, kid_op, pending, vals):
        a = tree.arrays
        dev = kid_op.device
        B = kid_op.shape[0]
        LC = a.leaf_occ.shape[0]
        ldump = LC - 1
        kid0 = torch.clamp(kid_op, min=0).long()
        qb = a.key_bytes[kid0]
        ql = torch.where(pending, a.key_lens[kid0], 0).to(I32)
        leaf_ids, path, _ = eng.traverse(tree, qb, ql, sibling_check=False)
        leaf_ids = torch.where(pending, leaf_ids, ldump).to(I32)

        perm = torch.argsort(torch.where(pending, leaf_ids, BIG), stable=True)
        s_leaf = leaf_ids[perm]
        sl = s_leaf.long()
        s_pending = pending[perm]
        s_kid = kid_op[perm]
        s_val = vals[perm]
        is_head, rank = _seg_head_rank(s_leaf)

        # .at[].add with repeated leaves: accumulate, never t[i] += v
        cnt_leaf = torch.zeros((LC,), dtype=I32, device=dev).index_put_(
            (torch.where(s_pending, s_leaf, ldump).long(),),
            s_pending.to(I32), accumulate=True)
        occ_cnt = a.leaf_occ.sum(-1, dtype=I32)
        fits_leaf = (occ_cnt + cnt_leaf) <= ns

        # ---------- fit path ----------
        # fit lanes of one leaf take distinct free slots (rank < free count);
        # every other lane writes its gathered old value to the scratch leaf
        s_fit = s_pending & fits_leaf[sl]
        free_order = torch.argsort(a.leaf_occ[sl].to(I32), dim=-1, stable=True)
        slot = torch.gather(free_order, -1,
                            torch.clamp(rank, max=ns - 1)[:, None].long())[:, 0]
        li = torch.where(s_fit, s_leaf, ldump).long()
        at = (li, slot)
        leaf_keyid, leaf_val, leaf_tags, leaf_occ = (
            a.leaf_keyid.clone(), a.leaf_val.clone(), a.leaf_tags.clone(),
            a.leaf_occ.clone())
        leaf_version, leaf_ordered = a.leaf_version.clone(), a.leaf_ordered.clone()
        _put(leaf_keyid, at, s_kid, s_fit)
        _put(leaf_val, at, s_val, s_fit)
        _put(leaf_tags, at, a.key_tags[torch.clamp(s_kid, min=0).long()], s_fit)
        _put(leaf_occ, at, True, s_fit)
        leaf_version.index_put_((li,), s_fit.to(I32), accumulate=True)
        _put(leaf_ordered, li, False, s_fit)     # every repeat writes False
        done_sorted = s_fit

        # ---------- overflow path ----------
        ov_head = is_head & s_pending & ~fits_leaf[sl]
        ov_head_pos = torch.argsort(
            torch.where(ov_head, torch.arange(B, dtype=I32, device=dev), BIG),
            stable=True)[:max_ov]
        ov_valid = ov_head[ov_head_pos]
        ov_leaf = torch.where(ov_valid, s_leaf[ov_head_pos], EMPTY)
        ov_repop = torch.where(ov_valid, perm[ov_head_pos], 0)
        ovl = torch.where(ov_valid, ov_leaf, ldump).long()

        # overflow leaves are distinct; invalid rows all write BIG to scratch
        ov_rank_of_leaf = torch.full((LC,), BIG, dtype=I32, device=dev)
        ov_rank_of_leaf[ovl] = torch.where(
            ov_valid, torch.arange(max_ov, dtype=I32, device=dev), BIG)
        op_ovr = ov_rank_of_leaf[sl]
        s_proc = (s_pending & ~fits_leaf[sl] & (op_ovr < max_ov)
                  & (rank < ins_cap))
        done_sorted = done_sorted | s_proc

        ws_kid = torch.cat([a.leaf_keyid[ovl], torch.full(
            (max_ov, ins_cap), EMPTY, dtype=I32, device=dev)], dim=1)
        ws_val = torch.cat([a.leaf_val[ovl], torch.zeros(
            (max_ov, ins_cap), dtype=a.leaf_val.dtype, device=dev)], dim=1)
        ws_valid = torch.cat([a.leaf_occ[ovl] & ov_valid[:, None], torch.zeros(
            (max_ov, ins_cap), dtype=torch.bool, device=dev)], dim=1)
        # processed lanes land in distinct columns >= ns; the others write
        # their gathered value back to (max_ov - 1, 0)
        ri = torch.where(s_proc, op_ovr, max_ov - 1).long()
        ci = torch.where(s_proc, ns + torch.clamp(rank, max=ins_cap - 1),
                         0).long()
        _put(ws_kid, (ri, ci), s_kid, s_proc)
        _put(ws_val, (ri, ci), s_val, s_proc)
        _put(ws_valid, (ri, ci), True, s_proc)

        rp = _repack_rows(a.key_bytes, a.key_lens, ws_kid, ws_val, ws_valid,
                          ov_valid, lfill, C_MAX)

        new_per_row = torch.clamp(rp.n_chunks - 1, min=0)
        new_base = (a.leaf_count + torch.cumsum(new_per_row, 0)
                    - new_per_row).long()
        err = (a.leaf_count + new_per_row.sum()) > ldump

        # a new leaf id past the scratch row means leaf_cap is exceeded (err
        # is set and the round raises): clamp it to the scratch row
        dst_leaf = torch.where(rp.chunk == 0, ovl[:, None],
                               new_base[:, None] + rp.chunk - 1)
        dst_leaf = torch.where(
            rp.valid & (rp.chunk < rp.n_chunks[:, None]),
            torch.clamp(dst_leaf, max=ldump), ldump)

        _put(leaf_occ, ovl, False, ov_valid)
        _put(leaf_keyid, ovl, EMPTY, ov_valid)

        fvalid = rp.valid.reshape(-1)
        fl = torch.where(fvalid, dst_leaf.reshape(-1), ldump)
        fsl = torch.where(fvalid, torch.clamp(rp.slot, 0, ns - 1).reshape(-1),
                          ns - 1).long()
        fkid = rp.a.reshape(-1)
        at = (fl, fsl)
        _put(leaf_keyid, at, fkid, fvalid)
        _put(leaf_val, at, rp.b.reshape(-1), fvalid)
        _put(leaf_tags, at, a.key_tags[torch.clamp(fkid, min=0).long()], fvalid)
        _put(leaf_occ, at, True, fvalid)

        cidx, chunk_exists, cmin = rp.cidx, rp.chunk_exists, rp.cmin
        has_next = cidx + 1 < rp.n_chunks[:, None]
        chunk_leaf = torch.where(cidx == 0, ovl[:, None],
                                 new_base[:, None] + cidx - 1)
        next_chunk_leaf = torch.where(has_next, new_base[:, None] + cidx,
                                      a.leaf_next[ovl][:, None])
        chunk_high = torch.where(
            has_next,
            torch.gather(cmin, -1,
                         torch.clamp(cidx + 1, max=C_MAX - 1).long().expand_as(cmin)),
            a.leaf_high[ovl][:, None])
        wmask = chunk_exists.reshape(-1)
        wl = torch.where(wmask, torch.clamp(chunk_leaf, max=ldump).reshape(-1),
                         ldump)
        leaf_next, leaf_high = a.leaf_next.clone(), a.leaf_high.clone()
        _put(leaf_next, wl, next_chunk_leaf.reshape(-1), wmask)
        _put(leaf_high, wl, chunk_high.reshape(-1), wmask)
        leaf_version.index_put_((wl,), wmask.to(I32), accumulate=True)
        _put(leaf_ordered, wl, True, wmask)
        leaf_count = (a.leaf_count + new_per_row.sum()).to(I32)
        n_splits = ov_valid.sum().to(I32)

        arrays = a._replace(
            leaf_keyid=leaf_keyid, leaf_val=leaf_val, leaf_tags=leaf_tags,
            leaf_occ=leaf_occ, leaf_high=leaf_high, leaf_next=leaf_next,
            leaf_version=leaf_version, leaf_ordered=leaf_ordered,
            leaf_count=leaf_count)

        # tuples for the parent level: (parent node, anchor kid, child, rep-op)
        tup_mask = (chunk_exists & (cidx >= 1)).reshape(-1)
        tup_repop = ov_repop[:, None].expand(max_ov, C_MAX).reshape(-1)
        tup_parent = torch.where(tup_mask, path[-1][tup_repop], EMPTY).to(I32)
        tup_anchor = torch.where(tup_mask, cmin.reshape(-1), EMPTY).to(I32)
        tup_child = torch.where(tup_mask, chunk_leaf.reshape(-1), EMPTY).to(I32)

        new_levels = list(arrays.levels)
        for lvl in range(len(arrays.levels) - 1, -1, -1):
            parent_path = path[lvl - 1] if lvl > 0 else None
            (lvl2, tup_parent, tup_anchor, tup_child, tup_repop,
             e) = _inner_insert(new_levels[lvl], arrays, tup_parent,
                                tup_anchor, tup_child, tup_repop, parent_path)
            new_levels[lvl] = lvl2
            err = err | e
        # keep both descent layouts coherent: splits rewrote inner nodes
        arrays = arrays._replace(levels=tuple(new_levels),
                                 stacked=stack_levels(tuple(new_levels)))

        done_orig = torch.zeros((B,), dtype=torch.bool, device=dev)
        done_orig[perm] = done_sorted
        return (FBTree(tree.config, arrays), pending & ~done_orig, n_splits,
                err)

    def _inner_insert(level: Level, arrays: TreeArrays, tup_parent,
                      tup_anchor, tup_child, tup_repop, parent_path):
        """Insert (anchor, child) tuples into one inner level; emit next
        tuples."""
        dev = tup_parent.device
        NT = tup_parent.shape[0]
        capn = level.knum.shape[0]
        ndump = capn - 1
        kb_store, kl_store = arrays.key_bytes, arrays.key_lens
        is_root = parent_path is None

        tv = tup_parent >= 0
        perm = torch.argsort(torch.where(tv, tup_parent, BIG), stable=True)
        sp, sa, sc, sr, stv = (x[perm] for x in (tup_parent, tup_anchor,
                                                 tup_child, tup_repop, tv))
        is_head, rank = _seg_head_rank(sp)

        R = max_ov
        head_pos = torch.argsort(
            torch.where(is_head & stv, torch.arange(NT, dtype=I32, device=dev),
                        BIG), stable=True)[:R]
        row_valid = (is_head & stv)[head_pos]
        row_node = torch.where(row_valid, sp[head_pos], EMPTY)
        row_repop = torch.where(row_valid, sr[head_pos], 0)
        rn = torch.where(row_valid, row_node, ndump).long()
        rank_of_node = torch.full((capn,), BIG, dtype=I32, device=dev)
        rank_of_node[rn] = torch.where(
            row_valid, torch.arange(R, dtype=I32, device=dev), BIG)
        op_row = rank_of_node[torch.clamp(sp, min=0).long()]
        s_ok = stv & (op_row < R) & (rank < IN_CAP)
        err = (stv & ~s_ok).any()

        lane = torch.arange(ns, dtype=I32, device=dev)[None, :]
        ws_anchor = torch.cat([level.anchors[rn], torch.full(
            (R, IN_CAP), EMPTY, dtype=I32, device=dev)], dim=1)
        ws_child = torch.cat([level.children[rn], torch.full(
            (R, IN_CAP), EMPTY, dtype=I32, device=dev)], dim=1)
        ws_valid = torch.cat([
            (lane < level.knum[rn][:, None]) & row_valid[:, None],
            torch.zeros((R, IN_CAP), dtype=torch.bool, device=dev)], dim=1)
        ri = torch.where(s_ok, op_row, R - 1).long()
        ci = torch.where(s_ok, ns + torch.clamp(rank, max=IN_CAP - 1), 0).long()
        _put(ws_anchor, (ri, ci), sa, s_ok)
        _put(ws_child, (ri, ci), sc, s_ok)
        _put(ws_valid, (ri, ci), True, s_ok)

        CI_MAX = -(-(ns + IN_CAP) // ifill) + 1
        rp = _repack_rows(kb_store, kl_store, ws_anchor, ws_child, ws_valid,
                          row_valid, ifill, CI_MAX)
        n_chunks = rp.n_chunks
        if is_root:
            err = err | (n_chunks > 1).any() | (rp.Tcnt > ns).any()
            n_chunks = torch.clamp(n_chunks, max=1)

        new_per_row = torch.clamp(n_chunks - 1, min=0)
        new_base = (level.count + torch.cumsum(new_per_row, 0)
                    - new_per_row).long()
        err = err | ((level.count + new_per_row.sum()) > ndump)

        # node ids past the scratch row only arise with err set: clamp them
        dst_node = torch.where(rp.chunk == 0, rn[:, None],
                               new_base[:, None] + rp.chunk - 1)
        dst_node = torch.where(rp.valid & (rp.chunk < n_chunks[:, None]),
                               torch.clamp(dst_node, max=ndump), ndump)

        anchors_new, children_new = level.anchors.clone(), level.children.clone()
        _put(anchors_new, rn, EMPTY, row_valid)
        _put(children_new, rn, EMPTY, row_valid)
        fvalid = (rp.valid & (rp.slot < ns) & (rp.slot >= 0)
                  & (rp.chunk < n_chunks[:, None])).reshape(-1)
        fn = torch.where(fvalid, dst_node.reshape(-1), ndump)
        fsl = torch.where(fvalid, torch.clamp(rp.slot, 0, ns - 1).reshape(-1),
                          ns - 1).long()
        _put(anchors_new, (fn, fsl), rp.a.reshape(-1), fvalid)
        _put(children_new, (fn, fsl), rp.b.reshape(-1), fvalid)

        cidx = rp.cidx
        chunk_exists = (cidx < n_chunks[:, None]) & row_valid[:, None]
        csize = torch.clamp(rp.csize, max=ns)
        cnode = torch.where(cidx == 0, rn[:, None], new_base[:, None] + cidx - 1)
        wm = chunk_exists.reshape(-1)
        wn = torch.where(wm, torch.clamp(cnode, max=ndump).reshape(-1), ndump)
        knum_new = level.knum.clone()
        _put(knum_new, wn, csize.reshape(-1), wm)

        pl, pf, ft = recompute_inner_meta(kb_store, kl_store, anchors_new[wn],
                                          knum_new[wn], fs)
        plen_new, prefix_new, feats_new = (level.plen.clone(),
                                           level.prefix.clone(),
                                           level.features.clone())
        _put(plen_new, wn, pl, wm)
        _put(prefix_new, wn, pf, wm)
        _put(feats_new, wn, ft, wm)
        count_new = (level.count + new_per_row.sum()).to(I32)

        level2 = Level(knum=knum_new, plen=plen_new, prefix=prefix_new,
                       features=feats_new, children=children_new,
                       anchors=anchors_new, count=count_new)

        nt_mask = (chunk_exists & (cidx >= 1)).reshape(-1)
        nt_repop = row_repop[:, None].expand(R, CI_MAX).reshape(-1)
        if is_root:
            nt_parent = torch.full((R * CI_MAX,), EMPTY, dtype=I32, device=dev)
        else:
            nt_parent = torch.where(nt_mask, parent_path[nt_repop],
                                    EMPTY).to(I32)
        nt_anchor = torch.where(nt_mask, rp.cmin.reshape(-1), EMPTY).to(I32)
        nt_child = torch.where(nt_mask, cnode.reshape(-1), EMPTY).to(I32)
        return level2, nt_parent, nt_anchor, nt_child, nt_repop, err

    return round_fn


def insert_batch(tree: FBTree, qb, ql, vals, max_ov: int = 128,
                 ins_cap: int = None, max_rounds: int = 64,
                 engine: Optional[TraversalEngine] = None, mask=None):
    """Batched upsert. Returns ``(tree', report, rounds)``.

    Dedupe/update/append, then split rounds (bounded work per round) until
    no op is pending. ``ins_cap`` bounds keys absorbed per leaf per round
    (default ``4 * ns``: monotone-append workloads funnel a whole batch into
    the rightmost leaf). ``mask`` (bool [B], optional) is the routed-op
    hook: masked-out lanes are no-ops — no in-place update, no pool append,
    never pending. Raises ``RuntimeError`` when the key pool, a leaf/node
    table or the root overflows, or when ops are still pending after
    ``max_rounds``.

    Telemetry: same obs contract as :func:`lookup_batch` (span
    ``op.insert``), plus an ``op.rounds`` counter labeled ``op=insert``.
    """
    qb, ql = _queries(tree, qb, ql)
    vals, mask = _lanes(tree, vals, mask)
    if not obs.enabled():
        return _insert_batch_impl(tree, qb, ql, vals, max_ov, ins_cap,
                                  max_rounds, engine, mask)
    with obs.span("op.insert"):
        tree2, rep, rounds = _insert_batch_impl(
            tree, qb, ql, vals, max_ov, ins_cap, max_rounds, engine, mask)
        obs.drain_op_report("insert", rep)
        obs.counter("op.rounds", op="insert").inc(rounds)
    return tree2, rep, rounds


def _insert_batch_impl(tree: FBTree, qb, ql, vals, max_ov, ins_cap,
                       max_rounds, engine, mask):
    max_ov = min(max_ov, qb.shape[0])   # can't overflow more leaves than ops
    if ins_cap is None:
        ins_cap = 4 * tree.config.ns
    engine = resolve_engine(engine)
    round_fn = _make_insert_round(tree.config, max_ov, ins_cap, engine)

    tree, kid_op, pending, rep = _prepare_insert(tree, qb, ql, vals, engine,
                                                 mask)
    if bool(rep.error):
        raise RuntimeError("insert_batch: key pool capacity exceeded")
    total_splits = torch.zeros((), dtype=I32, device=tree.device)
    rounds = 0
    while rounds < max_rounds:
        if not bool(pending.any()):
            break
        tree, pending, n_splits, e = round_fn(tree, kid_op, pending, vals)
        if bool(e):
            raise RuntimeError("insert_batch: capacity violated (leaf/node/"
                               "root overflow) — grow TreeConfig caps")
        total_splits = total_splits + n_splits
        rounds += 1
    if bool(pending.any()):
        raise RuntimeError("insert_batch: ops still pending after "
                           f"{max_rounds} rounds (capacity exhausted?)")
    return tree, rep._replace(splits=total_splits), rounds


# --------------------------------------------------------------------------
# range scan
# --------------------------------------------------------------------------

def _range_scan_torch(tree: FBTree, qb, ql, max_items: int,
                      eng: TraversalEngine, force_sort: bool = False):
    """Plain chain-walk version of the range scan (DESIGN.md §6), the twin
    of the reference's ``_range_scan_jnp``.

    One engine descent to the start leaf, then an early-exit walk over the
    sibling chain: lanes retire as they reach ``max_items`` or the chain
    end. Hop 0 is peeled: it is the only hop that needs key bytes
    unconditionally (the start-key compare) and the only one that filters
    ``key >= query``. Lazy rearrangement (§4.5): a hop sorts its leaves
    (``rowwise_lex_argsort``) only when some active lane sits on a leaf with
    its ``leaf_ordered`` bit clear (an ``if`` on a host sync in the place of
    ``lax.cond``); otherwise emission is an occupancy cumsum in slot order.
    ``rearranged`` counts the dirty leaves each lane visited, all-zero with
    the engine's ``collect_stats`` off. ``force_sort=True`` disables the
    ordered fast path (the always-sort baseline); outputs are bit-identical
    either way.
    """
    a = tree.arrays
    ns = tree.config.ns
    B, L = qb.shape
    dev = qb.device
    dump = a.leaf_occ.shape[0] - 1
    cs = eng.collect_stats
    leaf_ids, _, _ = eng.traverse(tree, qb, ql)
    bidx = torch.arange(B, device=dev)[:, None].expand(B, ns)

    # one scratch column at index max_items for masked scatter dumps; it
    # only ever receives the EMPTY/0 it holds, so repeated writes agree
    out_kid = torch.full((B, max_items + 1), EMPTY, dtype=I32, device=dev)
    out_val = torch.zeros((B, max_items + 1), dtype=a.leaf_val.dtype,
                          device=dev)
    emitted = torch.zeros((B,), dtype=I32, device=dev)

    def emit_to(emitted, kid, val, emit):
        rank = torch.cumsum(emit.to(I32), dim=-1) - 1
        dstpos = emitted[:, None] + rank
        ok = emit & (dstpos < max_items) & (dstpos >= 0)
        at = (bidx, torch.where(ok, dstpos, max_items).long())
        _put(out_kid, at, kid, ok)
        _put(out_val, at, val, ok)
        return torch.clamp(emitted + emit.sum(-1), max=max_items).to(I32)

    def sort_rows(kb, kl, occ, *rows):
        perm = rowwise_lex_argsort(kb, kl, occ)
        return tuple(torch.gather(x, -1, perm) for x in rows) + (perm,)

    def keys_of(kid, occ):
        k = torch.clamp(kid, min=0).long()
        return a.key_bytes[k], torch.where(occ, a.key_lens[k], 0)

    # ---- hop 0 (peeled): start-key compare
    cur = leaf_ids.long()
    kid, val, occ = a.leaf_keyid[cur], a.leaf_val[cur], a.leaf_occ[cur]
    kb, kl = keys_of(kid, occ)
    dirty = ~a.leaf_ordered[cur]
    if force_sort or bool(dirty.any()):
        kid, val, occ, kl, perm = sort_rows(kb, kl, occ, kid, val, occ, kl)
        kb = torch.gather(kb, 1, perm[:, :, None].expand(B, ns, L))
    emit = occ & (compare_padded(kb, kl, qb[:, None, :], ql[:, None]) >= 0)
    emitted = emit_to(emitted, kid, val, emit)
    nxt = a.leaf_next[cur]
    cur = torch.where((nxt >= 0) & (emitted < max_items), nxt, dump).long()
    rearr = dirty.to(I32)

    # ---- hops 1+: every key of an active leaf emits (the chain ascends)
    while bool((cur != dump).any()):
        active = cur != dump
        kid, val = a.leaf_keyid[cur], a.leaf_val[cur]
        occ = a.leaf_occ[cur] & active[:, None]
        dirty = active & ~a.leaf_ordered[cur]
        if force_sort or bool(dirty.any()):
            kid, val, occ, _ = sort_rows(*keys_of(kid, occ), occ, kid, val,
                                         occ)
        emitted = emit_to(emitted, kid, val, occ)
        nxt = a.leaf_next[cur]
        cur = torch.where(active & (nxt >= 0) & (emitted < max_items), nxt,
                          dump).long()
        rearr = rearr + dirty.to(I32)
    rearranged = rearr if cs else torch.zeros((B,), dtype=I32, device=dev)
    return (out_kid[:, :max_items].contiguous(),
            out_val[:, :max_items].contiguous(), emitted, rearranged)


def _range_scan(tree, qb, ql, max_items, engine):
    eng = resolve_engine(engine)
    fused = eng.scan_path()
    if fused is not None:
        return fused(tree, qb, ql, max_items=max_items,
                     collect_stats=eng.collect_stats)
    return _range_scan_torch(tree, qb, ql, max_items, eng)


def range_scan(tree: FBTree, qb, ql, max_items: int = 64,
               engine: Optional[TraversalEngine] = None):
    """Batched range scan: for each start key return up to ``max_items``
    ``(key_id, value)`` pairs in ascending key order, starting at the first
    key >= the query (lazy rearrangement: unsorted leaves are sorted on the
    fly, modeling §4.5; ordered leaves skip the sort entirely).

    Dispatches through the engine's scan backend (DESIGN.md §6): a backend
    with a registered whole-scan kernel (``"fused"`` →
    ``kernels/fused_scan``, one launch on the card) runs it; every other
    backend runs the plain chain walk (:func:`_range_scan_torch`),
    descending through the engine. Returns ``(out_kid [B, max_items],
    out_val [B, max_items], emitted [B], rearranged [B])``; ``rearranged``
    (dirty leaves visited) is all-zero under a stats-free engine. Raises
    ``ValueError`` for ``max_items < 1``.

    Telemetry: same obs contract as :func:`lookup_batch` — span
    ``op.scan``, and ``op.calls``/``op.lanes``/``op.emitted``/
    ``op.rearranged`` counters drained with one device-to-host copy.
    """
    if max_items < 1:
        raise ValueError(
            f"range_scan: max_items must be >= 1, got {max_items} — each "
            f"lane emits up to max_items (key, value) pairs")
    qb, ql = _queries(tree, qb, ql)
    if not obs.enabled():
        return _range_scan(tree, qb, ql, max_items, engine)
    with obs.span("op.scan"):
        out_kid, out_val, emitted, rearranged = _range_scan(
            tree, qb, ql, max_items, engine)
        em, re = torch.stack([emitted, rearranged]).cpu()
        obs.counter("op.calls", op="scan").inc()
        obs.counter("op.lanes", op="scan").inc(int(em.numel()))
        obs.counter("op.emitted", op="scan").inc(int(em.sum()))
        obs.counter("op.rearranged", op="scan").inc(int(re.sum()))
    return out_kid, out_val, emitted, rearranged


# --------------------------------------------------------------------------
# rebuild — device-side bulk re-construction (DESIGN.md §5)
# --------------------------------------------------------------------------

class BuildReport(NamedTuple):
    """Outcome of a device-side (re)build; every field a 0-d tensor."""
    n_live: torch.Tensor     # int32 — keys carried into the new tree
    n_leaves: torch.Tensor   # int32 — leaves the fresh build allocated
    reclaimed: torch.Tensor  # int32 — key-pool rows freed (tombstones, dupes)
    error: torch.Tensor      # bool — capacity exceeded; discard the result


def gather_live_sorted(tree: FBTree):
    """Gather a tree's live key set into a sorted, compacted, pool-shaped
    snapshot: ``(kb, kl, ktags, vals, n_live)`` with rows ``[0, n_live)``
    holding the live keys ascending and zeros everywhere else — exactly the
    input contract of ``fbtree._device_build_from_sorted``. ``n_live`` is a
    0-d int32 tensor; nothing here waits for the device.

    :func:`rebuild` feeds it straight back into the device build, and the
    shard layer (DESIGN.md §7) concatenates per-shard snapshots, which are
    already globally sorted since shards are range-partitioned.
    """
    a, cfg = tree.arrays, tree.config
    KC, L = cfg.key_cap, cfg.key_width
    occ = a.leaf_occ.reshape(-1)                  # [(leaf_cap+1) * ns]
    kid = torch.where(occ, a.leaf_keyid.reshape(-1), EMPTY)
    kid_safe = torch.clamp(kid, min=0).long()
    lens = torch.where(occ, a.key_lens[kid_safe], 0)
    order = lex_sort_indices_t(a.key_bytes[kid_safe], lens,
                               invalid=~occ)      # live slots first, sorted
    del kid_safe, lens
    n_live = occ.sum(dtype=I32)
    skid = torch.clamp(kid[order], min=0).long()
    r = torch.arange(order.shape[0], dtype=I32, device=occ.device)
    valid = r < n_live                            # n_live <= KC always
    dst = torch.where(valid, torch.clamp(r, max=KC), KC).long()
    # every invalid lane writes zeros into the scratch row KC: the repeated
    # writes all carry the same value, so CUDA's choice of writer cannot
    # matter, and the pool tail past n_live stays zero
    kb = torch.zeros((KC + 1, L), dtype=torch.uint8, device=occ.device)
    kb[dst] = torch.where(valid[:, None], a.key_bytes[skid], 0)
    kl = torch.zeros((KC + 1,), dtype=I32, device=occ.device)
    kl[dst] = torch.where(valid, a.key_lens[skid], 0)
    ktags = torch.zeros((KC + 1,), dtype=torch.uint8, device=occ.device)
    ktags[dst] = torch.where(valid, a.key_tags[skid], 0)
    vv = torch.zeros((KC + 1,), dtype=a.leaf_val.dtype, device=occ.device)
    vv[dst] = torch.where(valid, a.leaf_val.reshape(-1)[order], 0)
    return kb, kl, ktags, vv, n_live


def _rebuild(tree: FBTree) -> Tuple[FBTree, BuildReport]:
    a, cfg = tree.arrays, tree.config
    kb, kl, ktags, vv, n_live = gather_live_sorted(tree)
    arrays, err = _device_build_from_sorted(cfg, kb, kl, ktags, vv, n_live)
    rep = BuildReport(n_live=n_live, n_leaves=arrays.leaf_count,
                      reclaimed=(a.key_count - n_live).to(I32), error=err)
    return FBTree(cfg, arrays), rep


def rebuild(tree: FBTree) -> Tuple[FBTree, BuildReport]:
    """Compact a split-fragmented tree by re-running the device bulk build
    on the tree's device.

    Gathers the live (key, value) pairs from the leaves
    (:func:`gather_live_sorted`: packed-word sort, invalid slots last, pool
    re-packed front to back) and reconstructs every level, tuple and
    stacked layouts alike, through ``fbtree._device_build_from_sorted``.
    The output tree is exactly what ``bulk_build`` (host or device) would
    produce from the live key set.

    Semantics w.r.t. the §2 protocol (DESIGN.md §5): a rebuild is a
    bulk-synchronous barrier. Tombstoned keys are dropped and the pool is
    compacted, so *key ids are not stable across a rebuild*; leaf versions
    reset to zero and sibling links are relinked left to right. Results
    cached from before the barrier (leaf ids, key ids, versions) must be
    re-resolved by a fresh traversal.

    Telemetry: the obs contract of :func:`lookup_batch` — span
    ``op.rebuild``, counters ``op.calls`` and ``build.n_live`` /
    ``build.reclaimed`` labelled ``op=rebuild``, drained with one
    device-to-host copy of the report.
    """
    if not obs.enabled():
        return _rebuild(tree)
    with obs.span("op.rebuild"):
        tree2, rep = _rebuild(tree)
        n_live, reclaimed = torch.stack([rep.n_live, rep.reclaimed]).cpu()
        obs.counter("op.calls", op="rebuild").inc()
        obs.counter("build.n_live", op="rebuild").inc(int(n_live))
        obs.counter("build.reclaimed", op="rebuild").inc(int(reclaimed))
    return tree2, rep
