"""Device-counter export: drain stats NamedTuples into the registry — the
port's copy of ``repro.obs.bridge``.

The tree's modeled hardware counters (``BranchStats``/``LeafStats`` and the
op-level ``OpReport`` built from them) are tensors on the tree's device.
This bridge is the host-side sink for the stats-on path: ONE device-to-host
copy per report (the fields are flattened into one int64 tensor, which
makes one ``.cpu()`` call), never one per field, then per-lane counters are
summed into registry counters named ``tree.<field>`` labeled by op.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from . import registry as _reg

__all__ = ["drain_stats", "drain_op_report"]

# OpReport counter columns that come from BranchStats/LeafStats
# (DESIGN.md §3); `found` et al. are outcomes, not device counters.
_REPORT_COUNTERS = ("feat_rounds", "suffix_bs", "key_compares",
                    "lines_touched", "tag_candidates")


def _host(report):
    """The report's fields as numpy arrays, through one ``.cpu()``."""
    import torch
    cols = [torch.as_tensor(c) for c in report]
    flat = torch.cat([c.reshape(-1).to(torch.int64) for c in cols]).cpu()
    out, at = [], 0
    for c in cols:
        n = c.numel()
        out.append(flat[at:at + n].numpy().reshape(tuple(c.shape)))
        at += n
    return out


def drain_stats(stats, prefix: str = "tree", **labels) -> None:
    """Drain one stats NamedTuple (``BranchStats``/``LeafStats``) into
    counters ``<prefix>.<field>``. ``stats=None`` (stats-free engine) is a
    no-op, as is a disabled registry."""
    if not _reg.enabled() or stats is None:
        return
    host = _host(stats)                        # one device->host copy
    for f, col in zip(stats._fields, host):
        _reg.counter(f"{prefix}.{f}", **labels).inc(int(col.sum()))


def drain_op_report(op: str, rep, batch: Optional[int] = None) -> None:
    """Drain a ``core.batch_ops.OpReport`` after one batched op: the
    BranchStats/LeafStats-derived per-lane counters, plus op-level
    ``op.calls`` / ``op.lanes`` / ``op.found`` / ``op.conflicts`` /
    ``op.splits`` outcomes, all labeled ``op=<name>``."""
    if not _reg.enabled() or rep is None:
        return
    host = _host(rep)                          # one device->host copy
    d = dict(zip(rep._fields, host))
    _reg.counter("op.calls", op=op).inc()
    found = d.get("found")
    if found is not None:
        _reg.counter("op.lanes", op=op).inc(int(np.size(found)))
        _reg.counter("op.found", op=op).inc(int(found.sum()))
    for f in ("conflicts", "splits"):
        if f in d:
            _reg.counter(f"op.{f}", op=op).inc(int(d[f]))
    for f in _REPORT_COUNTERS:
        if f in d:
            _reg.counter(f"tree.{f}", op=op).inc(int(d[f].sum()))
