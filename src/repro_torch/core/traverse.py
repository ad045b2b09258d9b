"""Traversal engine with pluggable branch and descent backends — the port's
counterpart of ``repro.core.traverse`` (DESIGN.md §3).

Three registries, as in the reference:

* **Level backends** resolve ONE inner level for a batch:
  ``fn(level, key_bytes, key_lens, node_ids, qb, ql, collect_stats=...)
  -> (child_ids, stats | None)``. Built-in: ``"torch"``, the plain torch
  oracle (``core.branch.branch_level``), in the place of the reference's
  ``"jnp"``; ``"cuda"``, the feature-comparison kernel per level
  (``kernels.feature_branch``, one CUDA launch per level for a tree on the
  card), in the place of the reference's ``"pallas"``; and the
  factor-analysis baselines ``"binary"`` and ``"binary+prefix"``
  (``core.baseline``). The engine loops a level backend over the levels in either
  layout: ``"tuple"`` walks the per-level tuple, ``"stacked"`` walks the
  padded ``[n_levels, C_max, ...]`` tensors one level slice at a time.
* **Descent backends** resolve the whole root→leaf descent in one call:
  ``fn(tree, qb, ql, sibling_check=..., collect_stats=...)
  -> (leaf_ids, path, stats | None)``, optionally with a fused
  traverse+probe entry. Built-in: ``"fused"`` (``kernels.fused_descent``,
  one CUDA kernel launch for a tree on the card).
* **Scan backends** run a whole range scan:
  ``fn(tree, qb, ql, max_items=..., collect_stats=...)
  -> (out_kid, out_val, emitted, rearranged)``. Built-in: ``"fused"``
  (``kernels.fused_scan``, one CUDA kernel launch for a tree on the card).
  :meth:`TraversalEngine.scan_path` is ``None`` for every other engine,
  and ``core.batch_ops.range_scan`` then runs the plain chain walk.

``TraversalEngine`` is a frozen (hashable) dataclass; its ``collect_stats``
flag is threaded into every backend, and with it off the returned
``BranchStats`` are all-zero while leaf ids and paths stay bit-identical.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import torch

from .branch import BranchStats, branch_level, to_sibling
from .fbtree import FBTree, Level

__all__ = [
    "TraversalEngine", "DEFAULT_ENGINE", "DescentBackend", "ScanBackend",
    "register_backend", "get_backend", "register_descent_backend",
    "get_descent_backend", "register_scan_backend", "get_scan_backend",
    "available_backends", "backend_kind", "resolve_engine",
]

# fn(level, key_bytes, key_lens, node_ids, qb, ql, collect_stats=...)
#   -> (child_ids, stats | None)
BackendFn = Callable[..., Tuple[torch.Tensor, Optional[BranchStats]]]

_BACKENDS: Dict[str, BackendFn] = {}
_LAZY_BACKENDS: Dict[str, Callable[[], BackendFn]] = {}


class DescentBackend(NamedTuple):
    """A whole-descent backend.

    ``traverse(tree, qb, ql, sibling_check=..., collect_stats=...)``
      -> (leaf_ids, path, stats | None) — ``path[l]`` is each query's node
      id at level ``l``, matching ``TraversalEngine.traverse``.
    ``traverse_probe`` (optional) additionally fuses the hashtag leaf probe:
      ``-> (leaf_ids, path, found, slot, val, bstats | None, lstats | None)``.
    """
    traverse: Callable
    traverse_probe: Optional[Callable] = None


_DESCENT: Dict[str, DescentBackend] = {}
_LAZY_DESCENT: Dict[str, Callable[[], DescentBackend]] = {}

# fn(tree, qb, ql, max_items=..., collect_stats=...)
#   -> (out_kid [B, max_items], out_val [B, max_items], emitted [B],
#       rearranged [B])
ScanBackend = Callable[..., Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                  torch.Tensor]]

_SCAN: Dict[str, ScanBackend] = {}
_LAZY_SCAN: Dict[str, Callable[[], ScanBackend]] = {}


def _register(eager: dict, lazy: dict, name: str, value, loader) -> None:
    if (value is None) == (loader is None):
        raise ValueError("pass exactly one of the entry or loader=")
    if value is not None:
        eager[name] = value
        lazy.pop(name, None)
    else:
        lazy[name] = loader


def _get(eager: dict, lazy: dict, kind: str, name: str):
    if name not in eager:
        if name not in lazy:
            raise KeyError(f"unknown {kind} backend {name!r}; "
                           f"available: {available_backends()}")
        eager[name] = lazy.pop(name)()
    return eager[name]


def register_backend(name: str, fn: BackendFn = None, *,
                     loader: Callable[[], BackendFn] = None) -> None:
    """Register a per-level branch backend (eagerly, or via a deferred
    ``loader`` for backends whose import is heavy or optional)."""
    _register(_BACKENDS, _LAZY_BACKENDS, name, fn, loader)


def register_descent_backend(name: str, backend: DescentBackend = None, *,
                             loader: Callable[[], DescentBackend] = None,
                             ) -> None:
    """Register a whole-descent backend (same eager/lazy split)."""
    _register(_DESCENT, _LAZY_DESCENT, name, backend, loader)


def register_scan_backend(name: str, fn: ScanBackend = None, *,
                          loader: Callable[[], ScanBackend] = None) -> None:
    """Register a whole-scan backend under the name of the level/descent
    backend it pairs with (same eager/lazy split)."""
    _register(_SCAN, _LAZY_SCAN, name, fn, loader)


def get_backend(name: str) -> BackendFn:
    return _get(_BACKENDS, _LAZY_BACKENDS, "level", name)


def get_descent_backend(name: str) -> DescentBackend:
    return _get(_DESCENT, _LAZY_DESCENT, "descent", name)


def get_scan_backend(name: str) -> ScanBackend:
    return _get(_SCAN, _LAZY_SCAN, "scan", name)


def available_backends() -> List[str]:
    return sorted(set(_BACKENDS) | set(_LAZY_BACKENDS)
                  | set(_DESCENT) | set(_LAZY_DESCENT)
                  | set(_SCAN) | set(_LAZY_SCAN))


def backend_kind(name: str) -> str:
    """``"level"``, ``"descent"``, or ``"scan"`` for a scan-only name
    (KeyError if unregistered). Names registered in several registries
    report the kind that drives point-op descent: descent > level."""
    if name in _DESCENT or name in _LAZY_DESCENT:
        return "descent"
    if name in _BACKENDS or name in _LAZY_BACKENDS:
        return "level"
    if name in _SCAN or name in _LAZY_SCAN:
        return "scan"
    raise KeyError(f"unknown traversal backend {name!r}; "
                   f"available: {available_backends()}")


def _load_cuda_backend() -> BackendFn:
    from ..kernels.feature_branch.ops import branch_level_cuda
    return branch_level_cuda


def _load_binary_backend(use_prefix: bool) -> BackendFn:
    from .baseline import branch_level_binary
    return functools.partial(branch_level_binary, use_prefix=use_prefix)


def _load_fused_backend() -> DescentBackend:
    from ..kernels.fused_descent.ops import (fused_traverse,
                                             fused_traverse_probe)
    return DescentBackend(fused_traverse, fused_traverse_probe)


def _load_fused_scan_backend() -> ScanBackend:
    from ..kernels.fused_scan.ops import fused_range_scan
    return fused_range_scan


register_backend("torch", branch_level)
register_backend("cuda", loader=_load_cuda_backend)
register_backend("binary", loader=functools.partial(_load_binary_backend, False))
register_backend("binary+prefix",
                 loader=functools.partial(_load_binary_backend, True))
register_descent_backend("fused", loader=_load_fused_backend)
register_scan_backend("fused", loader=_load_fused_scan_backend)

LAYOUTS = ("tuple", "stacked")


@dataclasses.dataclass(frozen=True)
class TraversalEngine:
    """Root-to-leaf descent strategy: (backend, layout, collect_stats).

    ``layout=None`` defers to ``tree.config.stacked``; descent backends
    ignore the layout (they always read the stacked tensors).
    ``collect_stats=False`` skips the stats machinery: the returned
    ``BranchStats`` are all-zero, leaf ids and paths bit-identical.
    """
    backend: str = "torch"
    layout: Optional[str] = None
    collect_stats: bool = True

    def __post_init__(self):
        if self.backend not in available_backends():
            raise ValueError(f"unknown traversal backend {self.backend!r}; "
                             f"available: {available_backends()}")
        if self.layout not in (None,) + LAYOUTS:
            raise ValueError(f"unknown layout {self.layout!r}; "
                             f"expected one of {LAYOUTS} or None")

    @property
    def kind(self) -> str:
        return backend_kind(self.backend)

    def resolve_layout(self, tree: FBTree) -> str:
        return self.layout or ("stacked" if tree.config.stacked else "tuple")

    def probe_path(self) -> Optional[Callable]:
        """Fused traverse+probe entry of a descent backend, or None — the
        hook ``core.batch_ops._traverse_probe`` collapses to one launch."""
        if self.kind != "descent":
            return None
        return get_descent_backend(self.backend).traverse_probe

    def scan_path(self) -> Optional[ScanBackend]:
        """Whole-scan entry of this engine's backend, or None."""
        if self.backend in _SCAN or self.backend in _LAZY_SCAN:
            return get_scan_backend(self.backend)
        return None

    def traverse(self, tree: FBTree, qb: torch.Tensor, ql: torch.Tensor,
                 sibling_check: bool = True,
                 ) -> Tuple[torch.Tensor, List[torch.Tensor], BranchStats]:
        """Descend all inner levels. Returns (leaf_ids, path, stats) where
        ``path[l]`` is each query's node id AT level ``l`` (root first)."""
        B = qb.shape[0]
        cs = self.collect_stats
        dev = qb.device

        if self.kind == "descent":
            d = get_descent_backend(self.backend)
            leaf_ids, path, stats = d.traverse(
                tree, qb, ql, sibling_check=sibling_check, collect_stats=cs)
            return leaf_ids, path, stats if cs else BranchStats.zeros(B, dev)

        a = tree.arrays
        fn = get_backend(self.backend)
        if self.resolve_layout(tree) == "tuple":
            levels = a.levels
        else:
            s = a.stacked
            levels = [Level(*(x[l] for x in s)) for l in range(len(a.levels))]
        node_ids = torch.zeros((B,), dtype=torch.int32, device=dev)
        stats = BranchStats.zeros(B, dev)
        path = []
        for level in levels:
            path.append(node_ids)
            node_ids, st = fn(level, a.key_bytes, a.key_lens, node_ids,
                              qb, ql, collect_stats=cs)
            if cs:
                stats = stats + st

        if sibling_check:
            node_ids, hops = to_sibling(tree, node_ids, qb, ql)
            if cs:
                stats = stats._replace(
                    sibling_hops=stats.sibling_hops + hops)
        return node_ids, path, stats


DEFAULT_ENGINE = TraversalEngine(backend="torch", layout=None)


def resolve_engine(engine: Optional[TraversalEngine]) -> TraversalEngine:
    return DEFAULT_ENGINE if engine is None else engine
