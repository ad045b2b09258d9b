"""Versioned tree lifecycle: double-buffered atomic publish (DESIGN.md §8) —
the port's counterpart of ``repro.core.lifecycle``.

``TreeVersionManager`` owns the serving tree (FBTree or ShardedTree) and
splits mutations into two classes, mirroring the paper's §2 protocol
promoted from ``core.protocol``'s simulator to the real arrays:

* :meth:`commit`  — in-place batch-op results (insert/update/remove).
  These are already latch-free-safe under the version/link protocol; they
  replace the current object *within* the same published version.
* :meth:`publish` — bulk barriers (``rebuild``, ``rebalance``,
  ``PrefixCache.compact``, ``sharded_build``). The new version is built
  **off to the side**, structurally fsck'd (``core.fsck``), and swapped in
  only on success. Any failure — an exception mid-build, a capacity
  error, an fsck violation on the staged arrays — leaves the previous
  version serving, bit-identical (the staged object is simply dropped).

The manager holds the previous version alongside the current one
(double-buffering): degraded readers and regression tests can address the
last-barrier snapshot explicitly, and the swap itself is a single host
reference assignment — atomic with respect to anything reading
``manager.current``.

Fault sites (``core.faults.FaultPlan.fire``): ``lifecycle.begin``,
``lifecycle.rebuild.gather``, ``lifecycle.rebuild.build``,
``lifecycle.rebalance.barrier``, ``lifecycle.staged`` (corruption),
``lifecycle.fsck``, ``lifecycle.swap``.
"""
from __future__ import annotations

import time
from typing import Any, Callable, List, NamedTuple, Optional, Tuple

import torch

from .. import obs
from . import batch_ops as B
from . import fsck
from .faults import FaultInjected, FaultPlan
from .fbtree import FBTree, _device_build_from_sorted

__all__ = ["TreeVersion", "PublishReport", "TreeVersionManager"]


class TreeVersion(NamedTuple):
    obj: Any          # FBTree | ShardedTree
    version: int      # bumps on every successful publish, never on commit
    label: str        # what published it ("initial", "rebuild", ...)


class PublishReport(NamedTuple):
    """Outcome of one publish attempt. ``ok=False`` means the old version
    is still serving; ``reason`` says why (``fault:<site>``,
    ``fsck:<first violation>``, ``build-error``, ``error:<exc>``)."""
    ok: bool
    version: int                 # serving version AFTER the attempt
    label: str
    reason: str
    violations: Tuple[str, ...]
    aux: Any                     # the build's report (BuildReport/...) | None


class TreeVersionManager:
    """Double-buffered tree versions with abortable, fsck-gated publish."""

    def __init__(self, obj, faults: Optional[FaultPlan] = None,
                 verify: bool = True):
        self._current = TreeVersion(obj, 0, "initial")
        self._previous: Optional[TreeVersion] = None
        self.faults = faults
        self.verify = verify
        self.history: List[Tuple[int, str, bool, str]] = [
            (0, "initial", True, "")]

    # ------------------------------------------------------------- reads
    @property
    def current(self):
        """The serving tree. Readers grab this once per batch; the swap in
        :meth:`publish` is a single assignment, so a reader never sees a
        half-built version."""
        return self._current.obj

    @property
    def previous(self):
        """Last-barrier snapshot (None before the first publish)."""
        return self._previous.obj if self._previous is not None else None

    @property
    def version(self) -> int:
        return self._current.version

    @property
    def label(self) -> str:
        return self._current.label

    # ------------------------------------------------------------ writes
    def commit(self, obj) -> None:
        """Adopt an in-place batch-op result under the current version.

        No fsck, no version bump: in-place ops are covered by the leaf
        version/link protocol (readers validate per-leaf), and gating the
        hot path here would serialize serving on a host-side check.
        """
        self._current = self._current._replace(obj=obj)

    def _fire(self, site: str, **ctx):
        if self.faults is not None:
            self.faults.fire(site, **ctx)

    def publish(self, build_fn: Callable[[], Any],
                label: str = "publish") -> PublishReport:
        """Run ``build_fn`` off to the side and swap its result in iff it
        is structurally sound.

        ``build_fn`` returns the staged object, or ``(staged, aux)`` where
        ``aux`` is a build report (``aux.error`` truthy vetoes the swap
        — e.g. ``BuildReport.error`` flagging a capacity overflow whose
        arrays are shape-valid garbage). Exceptions (including injected
        faults) abort the publish; the current version is untouched on
        every failure path, because it is only reassigned on the last
        line.
        """
        t0 = time.perf_counter()

        def fail(reason: str, violations=(), aux=None) -> PublishReport:
            self.history.append((self.version, label, False, reason))
            obs.event("publish", label=label, version=self.version,
                      ok=False, reason=reason,
                      duration_s=time.perf_counter() - t0)
            return PublishReport(False, self.version, label, reason,
                                 tuple(violations), aux)

        aux = None
        with obs.span("lifecycle.publish", label=label):
            try:
                self._fire("lifecycle.begin", label=label)
                staged = build_fn()
                if isinstance(staged, tuple):
                    staged, aux = staged[0], (staged[1] if len(staged) == 2
                                              else staged[1:])
                if aux is not None and bool(getattr(aux, "error", False)):
                    return fail("build-error", aux=aux)
                if self.faults is not None:
                    staged, _ = self.faults.corrupt_staged(
                        "lifecycle.staged", staged)
                if self.verify:
                    self._fire("lifecycle.fsck", label=label)
                    rep = fsck.check(staged)
                    if not rep.ok:
                        obs.event("fsck", label=label,
                                  violations=list(rep.violations))
                        return fail("fsck:" + rep.violations[0],
                                    violations=rep.violations, aux=aux)
                self._fire("lifecycle.swap", label=label)
            except FaultInjected as e:
                return fail(f"fault:{e.site}", aux=aux)
            except Exception as e:  # a real build bug must not kill serving
                return fail(f"error:{type(e).__name__}: {e}", aux=aux)
            self._previous = self._current
            self._current = TreeVersion(staged, self.version + 1, label)
            self.history.append((self.version, label, True, ""))
            obs.event("publish", label=label, version=self.version, ok=True,
                      reason="", duration_s=time.perf_counter() - t0)
            return PublishReport(True, self.version, label, "", (), aux)

    # --------------------------------------------- barrier conveniences
    def rebuild(self, label: str = "rebuild") -> PublishReport:
        """``batch_ops.rebuild`` as an abortable publish, staged in two
        observable steps (gather, then device build) so a fault can land
        between them. Runs the same primitives as ``batch_ops.rebuild`` —
        the published arrays are bit-identical to it."""
        tree = self.current
        if not isinstance(tree, FBTree):
            raise TypeError("rebuild() needs an FBTree; use rebalance() "
                            "for a ShardedTree")

        def build():
            self._fire("lifecycle.rebuild.gather", label=label)
            kb, kl, ktags, vv, n_live = B.gather_live_sorted(tree)
            self._fire("lifecycle.rebuild.build", label=label)
            arrays, err = _device_build_from_sorted(tree.config, kb, kl,
                                                    ktags, vv, n_live)
            rep = B.BuildReport(
                n_live=n_live, n_leaves=arrays.leaf_count,
                reclaimed=(tree.arrays.key_count - n_live).to(torch.int32),
                error=err)
            return FBTree(tree.config, arrays), rep

        return self.publish(build, label=label)

    def rebalance(self, device: bool = True,
                  label: str = "rebalance") -> PublishReport:
        """``shard.ops.rebalance`` as an abortable publish. Doubles as the
        recovery path for dropped shards: the rebuilt ShardedTree starts
        with fresh (all-healthy) health state and fresh barrier snapshots,
        re-admitting any shard that was marked down. On an FBTree it is
        :meth:`rebuild`."""
        st = self.current
        if isinstance(st, FBTree):
            return self.rebuild(label=label)
        from ..shard import ops as shard_ops  # lazy: core<->shard

        def build():
            self._fire("lifecycle.rebalance.barrier", label=label)
            return shard_ops.rebalance(st, device=device,
                                       faults=self.faults)

        return self.publish(build, label=label)
