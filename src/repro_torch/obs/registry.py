"""Process-global metrics registry: counters, gauges, latency histograms.

The registry is the host-side half of the port's telemetry subsystem
(DESIGN.md §9), a framework-free copy of ``repro.obs.registry``. Everything
hangs off one module-global ``enabled`` flag:

* **off** (the default) — ``counter()``/``gauge()``/``histogram()`` return
  a shared no-op metric and :func:`span`/:func:`event` short-circuit, so
  instrumented call sites cost one predicate check. Instrumentation lives
  only at the host call sites around kernel launches, so op outputs are
  bit-identical either way.
* **on** — metrics are created on first touch, keyed by
  ``(name, sorted labels)``, and accumulate until :func:`reset`.

Histograms use fixed log2 buckets (1 µs … ~1.2 h for latencies, but any
positive value works): ``observe`` is one ``bisect`` per sample, quantile
readout walks the cumulative counts and interpolates geometrically inside
the winning bucket — good to a factor of ``2**0.5`` worst case, which is
plenty for p50/p90/p99 latency reporting and costs no per-sample storage.

Single-threaded by design, like the dispatch loops it instruments; the
registry is plain dicts with no locking.
"""
from __future__ import annotations

import math
import os
from bisect import bisect_left
from typing import Dict, List, Optional, Tuple

__all__ = [
    "Counter", "Gauge", "Histogram", "HIST_BOUNDS",
    "enabled", "enable", "disable", "reset",
    "counter", "gauge", "histogram", "all_metrics", "get_metric",
]

# ---------------------------------------------------------------- state

_ENABLED = os.environ.get("REPRO_OBS", "") not in ("", "0")

# (name, ((label, value), ...)) -> metric
_METRICS: Dict[Tuple[str, Tuple[Tuple[str, str], ...]], object] = {}


def enabled() -> bool:
    """Is telemetry collection on? Instrumented call sites check this
    once and fall through to the uninstrumented path when off."""
    return _ENABLED


def enable() -> None:
    global _ENABLED
    _ENABLED = True


def disable() -> None:
    """Turn collection off. Existing metrics are kept (readable/exportable)
    until :func:`reset`; new samples are dropped."""
    global _ENABLED
    _ENABLED = False


def reset() -> None:
    """Clear every metric and the event log (per-test isolation). The
    enabled flag is left as-is."""
    # import the submodule explicitly: the package re-exports an `events()`
    # *function* that shadows the module attribute of the same name
    from .events import _clear
    _METRICS.clear()
    _clear()


def _labelkey(labels: dict) -> Tuple[Tuple[str, str], ...]:
    return tuple(sorted((k, str(v)) for k, v in labels.items()))


# -------------------------------------------------------------- metrics

class Counter:
    """Monotonic counter."""

    kind = "counter"

    def __init__(self, name: str, labels: Tuple[Tuple[str, str], ...] = ()):
        self.name = name
        self.labels = labels
        self.value = 0

    def inc(self, n: int = 1) -> None:
        self.value += int(n)


class Gauge:
    """Last-write-wins instantaneous value."""

    kind = "gauge"

    def __init__(self, name: str, labels: Tuple[Tuple[str, str], ...] = ()):
        self.name = name
        self.labels = labels
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)


# log2 buckets: 1 µs, 2 µs, 4 µs, ... ~1.2 h (upper bounds, seconds).
# Shared by every histogram so quantiles are comparable across metrics
# and the Prometheus export emits one consistent ``le`` ladder.
HIST_BOUNDS: Tuple[float, ...] = tuple(1e-6 * 2 ** i for i in range(33))


class Histogram:
    """Fixed-bucket log-scale histogram with quantile readout."""

    kind = "histogram"

    def __init__(self, name: str, labels: Tuple[Tuple[str, str], ...] = ()):
        self.name = name
        self.labels = labels
        self.buckets = [0] * (len(HIST_BOUNDS) + 1)   # +1 overflow bucket
        self.count = 0
        self.sum = 0.0

    def observe(self, v: float) -> None:
        v = float(v)
        self.buckets[bisect_left(HIST_BOUNDS, v)] += 1
        self.count += 1
        self.sum += v

    def percentile(self, q: float) -> float:
        """Approximate q-quantile (q in [0, 1]): geometric midpoint of the
        bucket holding the q-th sample; 0.0 on an empty histogram."""
        if self.count == 0:
            return 0.0
        target = max(1, math.ceil(q * self.count))
        acc = 0
        for i, c in enumerate(self.buckets):
            acc += c
            if acc >= target:
                if i >= len(HIST_BOUNDS):          # overflow bucket
                    return HIST_BOUNDS[-1]
                hi = HIST_BOUNDS[i]
                lo = HIST_BOUNDS[i - 1] if i > 0 else hi / 2.0
                return math.sqrt(lo * hi)
        return HIST_BOUNDS[-1]

    @property
    def p50(self) -> float:
        return self.percentile(0.50)

    @property
    def p90(self) -> float:
        return self.percentile(0.90)

    @property
    def p99(self) -> float:
        return self.percentile(0.99)


class _NullMetric:
    """Shared do-nothing metric handed out while telemetry is off, so call
    sites never branch on the flag themselves."""

    __slots__ = ()

    def inc(self, n: int = 1) -> None:
        pass

    def set(self, v: float) -> None:
        pass

    def observe(self, v: float) -> None:
        pass


_NULL = _NullMetric()


def _get(cls, name: str, labels: dict):
    key = (name, _labelkey(labels))
    m = _METRICS.get(key)
    if m is None:
        m = _METRICS[key] = cls(name, key[1])
    elif not isinstance(m, cls):
        raise TypeError(f"metric {name!r} already registered as {m.kind}")
    return m


def counter(name: str, **labels) -> Counter:
    """Get-or-create a counter (no-op metric while disabled)."""
    return _get(Counter, name, labels) if _ENABLED else _NULL


def gauge(name: str, **labels) -> Gauge:
    return _get(Gauge, name, labels) if _ENABLED else _NULL


def histogram(name: str, **labels) -> Histogram:
    return _get(Histogram, name, labels) if _ENABLED else _NULL


def get_metric(name: str, **labels):
    """Read-side lookup: the metric, or None if never touched. Works with
    collection disabled (post-run assertions / exporters)."""
    return _METRICS.get((name, _labelkey(labels)))


def all_metrics() -> List[object]:
    """Every registered metric, sorted by (name, labels) for stable
    export order."""
    return [_METRICS[k] for k in sorted(_METRICS)]
