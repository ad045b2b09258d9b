"""Device-counter export: op reports into the registry — the port's copy of
``repro.obs.bridge``, without its host sync.

The tree's modeled hardware counters (``BranchStats``/``LeafStats`` and the
op-level ``OpReport`` built from them) are tensors on the tree's device.
Each batch adds its counts into device-side sums (one int64 vector per op
and set of counters) and copies nothing to the host, so draining never
waits for the card. Registry counters named ``tree.<field>`` /
``op.<outcome>``, labeled by op, are bound to the entries of those sums;
reading a counter's ``value`` (or exporting it) makes the one
device-to-host copy (:func:`_host`).
"""
from __future__ import annotations

from typing import Dict

from . import registry as _reg

__all__ = ["drain_op_report", "drain_counts"]

# OpReport counter columns that come from BranchStats/LeafStats
# (DESIGN.md §3); `found` et al. are outcomes, not device counters.
_REPORT_COUNTERS = ("feat_rounds", "suffix_bs", "key_compares",
                    "lines_touched", "tag_candidates")


def _host(t):
    """A device vector as host ints, through one ``.cpu()``."""
    return t.cpu().tolist()


class _DeviceSums:
    """An int64 vector on the device that every batch adds into; counters
    bound to its entries read it when they are read."""

    __slots__ = ("t",)

    def __init__(self, t):
        self.t = t

    def read(self, i: int) -> int:
        return _host(self.t)[i]


# (op, counter names, device) -> the sums behind counters <name>{op=...}
_SUMS: Dict[tuple, _DeviceSums] = {}


def _clear() -> None:
    _SUMS.clear()


def drain_counts(op: str, counts: dict) -> None:
    """Add one batch's counts into counters ``<name>`` labeled
    ``op=<op>``: ``counts`` maps each name to a device tensor whose sum is
    the batch's count. The sums stay on the device; no host sync."""
    if not _reg.enabled():
        return
    import torch
    names = tuple(counts)
    cols = [torch.as_tensor(c) for c in counts.values()]
    key = (op, names, cols[0].device)
    sums = _SUMS.get(key)
    if sums is None:
        sums = _SUMS[key] = _DeviceSums(torch.zeros(
            (len(names),), dtype=torch.int64, device=cols[0].device))
        for i, name in enumerate(names):
            _reg.counter(name, op=op).bind(sums, i)
    sums.t += torch.stack([c.sum(dtype=torch.int64) for c in cols])


def drain_op_report(op: str, rep, stats: bool = True) -> None:
    """Drain a ``core.batch_ops.OpReport`` after one batched op: op-level
    ``op.calls`` / ``op.lanes`` (host counts) and ``op.found`` /
    ``op.conflicts`` / ``op.splits`` outcomes, plus, with ``stats`` (the
    engine collects them), the BranchStats/LeafStats-derived per-lane
    ``tree.<field>`` counters, all labeled ``op=<name>``. A stats-free
    engine's report holds zeros there, and they are not drained."""
    if not _reg.enabled() or rep is None:
        return
    _reg.counter("op.calls", op=op).inc()
    _reg.counter("op.lanes", op=op).inc(rep.found.numel())
    counts = {"op.found": rep.found, "op.conflicts": rep.conflicts,
              "op.splits": rep.splits}
    if stats:
        counts.update((f"tree.{f}", getattr(rep, f))
                      for f in _REPORT_COUNTERS)
    drain_counts(op, counts)
