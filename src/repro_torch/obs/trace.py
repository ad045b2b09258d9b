"""Nestable host-side tracing spans (DESIGN.md §9) — the port's copy of
``repro.obs.trace``.

``span("descent", shard=0)`` times a host-side region into the metrics
registry (histogram ``span.<dotted.path>``, the path being the names of
the enclosing spans joined with dots, so the same leaf name nested under
different parents stays distinguishable) and opens a
``torch.profiler.record_function`` range of the same name, so the host
region lines up with the device timeline in a profiler trace.

While telemetry is off, ``span`` hands back a shared null context manager
— one predicate check per call site, nothing recorded.
"""
from __future__ import annotations

import time
from typing import List

from . import registry as _reg

__all__ = ["span", "current_path"]

_STACK: List[str] = []


def current_path() -> str:
    """Dotted path of the innermost open span ("" at top level)."""
    return ".".join(_STACK)


class _NullSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL = _NullSpan()


class _Span:
    __slots__ = ("name", "labels", "path", "t0", "_annot")

    def __init__(self, name: str, labels: dict):
        self.name = name
        self.labels = labels
        self.path = ""
        self.t0 = 0.0
        self._annot = None

    def __enter__(self):
        import torch.profiler
        _STACK.append(self.name)
        self.path = ".".join(_STACK)
        self._annot = torch.profiler.record_function(self.path)
        self._annot.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self.t0
        self._annot.__exit__(*exc)
        if _STACK and _STACK[-1] == self.name:
            _STACK.pop()
        _reg.histogram(f"span.{self.path}", **self.labels).observe(dt)
        return False


def span(name: str, **labels):
    """Context manager timing a host region into histogram
    ``span.<path>`` (labels become metric labels — keep their cardinality
    bounded: shard ids and op names, not batch contents)."""
    if not _reg.enabled():
        return _NULL
    return _Span(name, labels)
