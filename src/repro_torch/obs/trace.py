"""Nestable host-side tracing spans (DESIGN.md §9) — the port's copy of
``repro.obs.trace``, with an in-memory span log besides.

A span times the host's work inside it: for the op layer that is the
enqueue of the kernels a stage launches, not their completion on the card.
Each span feeds two sinks, switched on apart:

* :func:`registry.enable` (``obs.enable()``): the span's duration goes into
  histogram ``span.<path>`` (the path being the names of the enclosing spans
  joined with dots, so the same leaf name nested under different parents
  stays distinguishable) and a ``torch.profiler.record_function`` range of
  the same name opens around it.
* :func:`recording`: the span appends one record of flat ints to the
  block's :class:`Recording`, on the ``time.perf_counter_ns`` clock. No
  registry, no counter drain and no profiler range is turned on. Device
  time per span comes from a profiler trace of the same window: CUPTI links
  each kernel, copy and fill to the runtime call that launched it
  (correlation id), and that call's host time lies inside the innermost
  span open then (``bench/stages.py`` does the attribution).

With both off, ``span`` hands back a shared null context manager: one
predicate check per call site, nothing recorded.
"""
from __future__ import annotations

import time
from contextlib import contextmanager
from typing import Dict, List, Optional, Tuple

from . import registry as _reg

__all__ = ["span", "current_path", "recording", "Recording"]

_STACK: List[str] = []
FIELDS = 5          # ints a record: name id, parent, root, t0_ns, t1_ns


def current_path() -> str:
    """Dotted path of the innermost span open while telemetry is on (""
    at top level)."""
    return ".".join(_STACK)


class Recording:
    """The span log of one :func:`recording` block.

    Record ``i`` is ``log[FIELDS * i:FIELDS * (i + 1)]``: the span's name id
    (``names[id]`` is its dotted path among the recorded spans), the index
    of its parent record (-1 for a root), the index of its root record (the
    call it belongs to: spans of one call share it), and its ``t0_ns`` and
    ``t1_ns`` on ``time.perf_counter_ns`` (``t1_ns`` is 0 while the span is
    open). Records are in the order the spans opened, so ``t0_ns`` never
    decreases and a parent precedes its children. The log is one flat list
    of ints, objects the collector does not track: a window adds no tracked
    object that outlives its call.
    """

    def __init__(self):
        self.log: List[int] = []
        self.names: List[str] = []
        self._ids: Dict[Tuple[int, str], int] = {}
        # (record, name id, root) of each open span, innermost last
        self._open: List[Tuple[int, int, int]] = [(-1, -1, -1)]

    def __len__(self) -> int:
        return len(self.log) // FIELDS

    def record(self, i: int) -> Tuple[int, int, int, int, int]:
        """``(name id, parent, root, t0_ns, t1_ns)`` of record ``i``."""
        return tuple(self.log[FIELDS * i:FIELDS * (i + 1)])

    def name(self, i: int) -> str:
        """The dotted path of record ``i``."""
        return self.names[self.log[FIELDS * i]]

    def _enter(self, name: str) -> int:
        """Open a record for span ``name`` now; returns its index."""
        i = len(self.log) // FIELDS
        p, pid, root = self._open[-1]
        nid = self._ids.get((pid, name))
        if nid is None:
            nid = self._ids[(pid, name)] = len(self.names)
            self.names.append(name if pid < 0 else f"{self.names[pid]}.{name}")
        if p < 0:
            root = i
        self._open.append((i, nid, root))
        self.log += (nid, p, root, time.perf_counter_ns(), 0)
        return i

    def _exit(self, i: int) -> None:
        """Close record ``i`` (the innermost open one) now."""
        self.log[FIELDS * i + 4] = time.perf_counter_ns()
        self._open.pop()


_REC: Optional[Recording] = None


@contextmanager
def recording():
    """Record every span opened inside the block into a fresh
    :class:`Recording`, which the block gets. Turns on nothing else."""
    global _REC
    prev, _REC = _REC, Recording()
    try:
        yield _REC
    finally:
        _REC = prev


class _NullSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL = _NullSpan()


class _RecordedSpan:
    """A span while only a recording is on: one record, nothing else."""

    __slots__ = ("rec", "name", "i")

    def __init__(self, rec: Recording, name: str):
        self.rec = rec
        self.name = name

    def __enter__(self):
        self.i = self.rec._enter(self.name)
        return self

    def __exit__(self, *exc):
        self.rec._exit(self.i)
        return False


class _Span:
    """A span while telemetry is on: histogram, profiler range, and a
    record where a recording is on too."""

    __slots__ = ("name", "labels", "path", "t0", "_annot", "_rec", "_i")

    def __init__(self, name: str, labels: dict, rec: Optional[Recording]):
        self.name = name
        self.labels = labels
        self._rec = rec

    def __enter__(self):
        import torch.profiler
        _STACK.append(self.name)
        self.path = ".".join(_STACK)
        self._annot = torch.profiler.record_function(self.path)
        self._annot.__enter__()
        if self._rec is not None:
            self._i = self._rec._enter(self.name)
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        if self._rec is not None:
            self._rec._exit(self._i)
        self._annot.__exit__(*exc)
        if _STACK and _STACK[-1] == self.name:
            _STACK.pop()
        _reg.histogram(f"span.{self.path}", **self.labels).observe(
            (t1 - self.t0) * 1e-9)
        return False


def span(name: str, **labels):
    """Context manager timing a host region into histogram
    ``span.<path>`` while telemetry is on (labels become metric labels —
    keep their cardinality bounded: shard ids and op names, not batch
    contents), and into the active :func:`recording`'s log (name only)."""
    if _reg.enabled():
        return _Span(name, labels, _REC)
    if _REC is None:
        return _NULL
    return _RecordedSpan(_REC, name)
