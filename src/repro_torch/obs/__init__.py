"""Telemetry subsystem: spans, metrics, device-counter export, events
(DESIGN.md §9).

Zero-cost when off — the default. Every instrumented call site in the
port goes through this surface, and with collection disabled each one
reduces to a single predicate check on the host, so op outputs are
bit-identical either way. Enable with :func:`enable` or ``REPRO_OBS=1``.
This is the port's copy of ``repro.obs``: spans open
``torch.profiler.record_function`` ranges, and the counter bridge makes
one ``.cpu()`` copy per report.

Quick tour::

    from repro_torch import obs

    obs.enable()
    with obs.span("descent", shard=0):          # host span + profiler
        vals, rep = lookup_batch(tree, qb, ql)  #   record_function range
    obs.histogram("serve.request_latency_s").observe(dt)
    obs.counter("shard.retries", op="lookup").inc()
    obs.event("publish", label="compact", version=1, ok=True,
              reason="", duration_s=0.12)
    print(obs.console_summary())
    obs.export_events_jsonl("out/obs/events.jsonl")

Stable public surface — import from here, not from the submodules.
"""
from .bridge import drain_op_report, drain_stats
from .events import (EVENT_TYPES, event, event_summary, events,
                     validate_event)
from .export import console_summary, export_events_jsonl, prometheus_text
from .registry import (HIST_BOUNDS, Counter, Gauge, Histogram, all_metrics,
                       counter, disable, enable, enabled, gauge, get_metric,
                       histogram, reset)
from .trace import current_path, span

__all__ = [
    # state
    "enabled", "enable", "disable", "reset",
    # spans
    "span", "current_path",
    # metrics
    "Counter", "Gauge", "Histogram", "HIST_BOUNDS",
    "counter", "gauge", "histogram", "get_metric", "all_metrics",
    # device-counter bridge
    "drain_stats", "drain_op_report",
    # events
    "EVENT_TYPES", "event", "events", "event_summary", "validate_event",
    # exporters
    "export_events_jsonl", "prometheus_text", "console_summary",
]
