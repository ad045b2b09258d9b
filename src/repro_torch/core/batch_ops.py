"""Batched tree operations — the port's counterpart of
``repro.core.batch_ops``, lookup path only (update, remove, insert, scan
and rebuild are later slices).

Every op runs on the device its tree lives on. A lookup is one engine
descent plus one hashtag leaf probe; engines whose descent backend exposes
a fused traverse+probe entry (``"fused"``) collapse both into one kernel
launch.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .. import obs
from .branch import BranchStats
from .fbtree import FBTree
from .leaf import LeafStats, probe
from .traverse import TraversalEngine, resolve_engine

__all__ = ["OpReport", "lookup_batch", "traverse_path", "traverse_probe"]


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


def _report(found, bstats: Optional[BranchStats],
            lstats: Optional[LeafStats] = None, conflicts=0, splits=0,
            error=False) -> OpReport:
    """``bstats``/``lstats`` may be ``None`` (stats-free engines): counters
    come back all-zero, ``found`` stays exact."""
    b, dev = found.shape[0], found.device
    z = torch.zeros((b,), dtype=torch.int32, device=dev)
    if bstats is None:
        bstats = BranchStats.zeros(b, dev)
    return OpReport(
        found=found,
        conflicts=torch.tensor(conflicts, dtype=torch.int32, device=dev),
        splits=torch.tensor(splits, dtype=torch.int32, device=dev),
        error=torch.tensor(error, dtype=torch.bool, device=dev),
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
    ql = torch.as_tensor(ql, device=dev).to(torch.int32)
    return qb, ql


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
