"""Telemetry subsystem: spans, metrics, device-counter export, events
(DESIGN.md §9).

Zero-cost when off — the default. Every instrumented call site in the
port goes through this surface, and with collection and recording off each
one reduces to a single predicate check on the host, so op outputs are
bit-identical either way. This is the port's copy of ``repro.obs``, with
two sinks that can be switched on apart:

* :func:`enable` (or ``REPRO_OBS=1``): the registry. Spans observe
  ``span.<path>`` histograms and open ``torch.profiler.record_function``
  ranges; op reports drain into counters by adding into device-side sums,
  with no host sync per batch (a counter's ``value`` reads them).
* :func:`recording`: the span log alone, records of flat ints on
  ``time.perf_counter_ns``, for a benchmark's traced window.

Spans time the host's enqueue, not the card's work. A kernel's device time
comes from a profiler trace: CUPTI's correlation id links it to the runtime
call that launched it, which lies inside the innermost span open then.

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

    with obs.recording() as rec:                # span log only
        lookup_batch(tree, qb, ql)
    [rec.name(i) for i in range(len(rec))]      # op.lookup, op.lookup.* ...

Stable public surface — import from here, not from the submodules.
"""
from .bridge import drain_counts, drain_op_report
from .events import (EVENT_TYPES, event, event_summary, events,
                     validate_event)
from .export import console_summary, export_events_jsonl, prometheus_text
from .registry import (HIST_BOUNDS, Counter, Gauge, Histogram, all_metrics,
                       counter, disable, enable, enabled, gauge, get_metric,
                       histogram, reset)
from .trace import Recording, current_path, recording, span

__all__ = [
    # state
    "enabled", "enable", "disable", "reset",
    # spans
    "span", "current_path", "recording", "Recording",
    # metrics
    "Counter", "Gauge", "Histogram", "HIST_BOUNDS",
    "counter", "gauge", "histogram", "get_metric", "all_metrics",
    # device-counter bridge
    "drain_counts", "drain_op_report",
    # events
    "EVENT_TYPES", "event", "events", "event_summary", "validate_event",
    # exporters
    "export_events_jsonl", "prometheus_text", "console_summary",
]
