"""Telemetry exporters (DESIGN.md §9): JSON-lines events, Prometheus
text, and a console summary table (a copy of ``repro.obs.export``).

All three read the process-global registry/event log and work with
collection disabled (export after the run is the normal shape — e.g. the
chaos sweep dumps the event log only when a schedule fails).
"""
from __future__ import annotations

import json
import os
from typing import List, Optional

from . import registry as _reg
from .events import event_summary as _event_summary
from .events import events as _all_events

__all__ = ["export_events_jsonl", "prometheus_text", "console_summary"]


def export_events_jsonl(path: str) -> int:
    """Write the event log as JSON lines (one event per line, emit
    order); returns the number of events written. Parent directories are
    created — exports land next to CI artifacts like failing chaos
    seeds."""
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    evs = _all_events()
    with open(path, "w", encoding="utf-8") as f:
        for e in evs:
            f.write(json.dumps(e, sort_keys=True) + "\n")
    return len(evs)


def _fmt_labels(labels) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{v}"' for k, v in labels)
    return "{" + inner + "}"


def _prom_name(name: str) -> str:
    return name.replace(".", "_").replace("-", "_")


def prometheus_text() -> str:
    """The registry in Prometheus text exposition format. Histograms emit
    the standard cumulative ``_bucket{le=...}`` ladder over the shared
    log2 bounds plus ``_sum``/``_count``."""
    lines: List[str] = []
    seen_type = set()
    for m in _reg.all_metrics():
        pname = _prom_name(m.name)
        if pname not in seen_type:
            seen_type.add(pname)
            lines.append(f"# TYPE {pname} {m.kind}")
        if m.kind in ("counter", "gauge"):
            lines.append(f"{pname}{_fmt_labels(m.labels)} {m.value}")
            continue
        acc = 0
        for bound, c in zip(_reg.HIST_BOUNDS, m.buckets):
            acc += c
            lab = _fmt_labels(m.labels + (("le", f"{bound:g}"),))
            lines.append(f"{pname}_bucket{lab} {acc}")
        lab = _fmt_labels(m.labels + (("le", "+Inf"),))
        lines.append(f"{pname}_bucket{lab} {m.count}")
        lines.append(f"{pname}_sum{_fmt_labels(m.labels)} {m.sum:g}")
        lines.append(f"{pname}_count{_fmt_labels(m.labels)} {m.count}")
    return "\n".join(lines) + ("\n" if lines else "")


def _fmt_s(v: float) -> str:
    if v >= 1.0:
        return f"{v:.2f}s"
    if v >= 1e-3:
        return f"{v * 1e3:.2f}ms"
    return f"{v * 1e6:.0f}us"


def console_summary() -> str:
    """Human-readable registry + event roll-up: counters/gauges one per
    line, histograms with count/p50/p90/p99/mean, then event counts."""
    rows = []
    for m in _reg.all_metrics():
        lbl = _fmt_labels(m.labels)
        if m.kind == "counter":
            rows.append((f"{m.name}{lbl}", f"{m.value}"))
        elif m.kind == "gauge":
            rows.append((f"{m.name}{lbl}", f"{m.value:.4g}"))
        else:
            mean = m.sum / m.count if m.count else 0.0
            rows.append((
                f"{m.name}{lbl}",
                f"n={m.count} p50={_fmt_s(m.p50)} p90={_fmt_s(m.p90)} "
                f"p99={_fmt_s(m.p99)} mean={_fmt_s(mean)}"))
    for etype, n in _event_summary().items():
        rows.append((f"event.{etype}", f"{n}"))
    if not rows:
        return "telemetry: no metrics or events recorded\n"
    w = max(len(r[0]) for r in rows)
    head = f"{'metric':<{w}}  value"
    sep = "-" * len(head)
    return "\n".join([head, sep] + [f"{k:<{w}}  {v}" for k, v in rows]) + "\n"
