"""Structured telemetry event log (DESIGN.md §9).

Events are the discrete, low-rate facts the metrics registry can't carry:
a lifecycle publish committed or aborted, a fault fired, a shard retry /
degraded serve / failed-lane batch, a rebalance recovery. Each event is a
flat dict — ``type`` + ``seq`` + ``ts`` plus the type's required fields —
append-only in arrival order, exported as JSON lines
(``repro_torch.obs.export``); a framework-free copy of
``repro.obs.events``.

The type table below is the single source of truth for that schema:
:func:`event` refuses unknown types and missing required fields at emit
time (an instrumentation bug should fail the emitting test, not produce
an unparseable artifact).
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple

from . import registry as _reg

__all__ = ["EVENT_TYPES", "event", "events", "event_summary",
           "validate_event"]

# type -> required field names (beyond the envelope's type/seq/ts).
# Optional fields are free-form; validation only pins the required set.
EVENT_TYPES: Dict[str, Tuple[str, ...]] = {
    # lifecycle (core.lifecycle): one per publish attempt, ok or not
    "publish":        ("label", "version", "ok", "reason", "duration_s"),
    # fsck gate rejected a staged tree (also reflected in its publish event)
    "fsck":           ("label", "violations"),
    # fault injection (core.faults): one per fired fault, replay context
    "fault":          ("site", "kind", "seed"),
    # shard dispatch (shard.ops)
    "shard.retry":    ("op", "shard", "attempt"),
    "shard.down":     ("op", "shard", "attempts"),
    "shard.degraded": ("op", "shard", "lanes"),
    "shard.failed":   ("op", "shard", "lanes"),
    # recovery barrier (shard.ops.rebalance)
    "rebalance":      ("n_live", "reclaimed"),
}

_EVENTS: List[dict] = []
_SEQ = 0


def _clear() -> None:
    global _SEQ
    _EVENTS.clear()
    _SEQ = 0


def _jsonable(v):
    """Coerce numpy scalars / tuples so every event dumps with the stock
    json encoder."""
    if isinstance(v, (list, tuple)):
        return [_jsonable(x) for x in v]
    if isinstance(v, (str, int, float, bool)) or v is None:
        return v
    if hasattr(v, "item"):          # numpy scalar / one-element tensor
        return v.item()
    return str(v)


def event(etype: str, **fields) -> Optional[dict]:
    """Record one structured event (no-op while telemetry is off).

    Unknown ``etype`` or missing required fields raise immediately —
    the emit-time schema gate that keeps exports machine-checkable.
    Returns the recorded dict (None when disabled).
    """
    if not _reg.enabled():
        return None
    required = EVENT_TYPES.get(etype)
    if required is None:
        raise ValueError(f"unknown telemetry event type {etype!r}; "
                         f"one of {sorted(EVENT_TYPES)}")
    missing = [f for f in required if f not in fields]
    if missing:
        raise ValueError(f"event {etype!r} missing required fields "
                         f"{missing}; requires {list(required)}")
    global _SEQ
    e = {"type": etype, "seq": _SEQ, "ts": time.time()}
    e.update({k: _jsonable(v) for k, v in fields.items()})
    _EVENTS.append(e)
    _SEQ += 1
    return e


def events() -> List[dict]:
    """The event log so far, in emit order (live list — don't mutate)."""
    return _EVENTS


def event_summary() -> Dict[str, int]:
    """``{type: count}`` over the log — the console one-liner chaos
    failures print next to the replay seed."""
    out: Dict[str, int] = {}
    for e in _EVENTS:
        out[e["type"]] = out.get(e["type"], 0) + 1
    return dict(sorted(out.items()))


def validate_event(e: object) -> List[str]:
    """Schema-check one decoded JSON-lines record; returns the list of
    violations (empty = valid)."""
    errs = []
    if not isinstance(e, dict):
        return [f"event is {type(e).__name__}, expected object"]
    etype = e.get("type")
    if etype not in EVENT_TYPES:
        return [f"unknown event type {etype!r}"]
    for f in ("seq", "ts"):
        if not isinstance(e.get(f), (int, float)):
            errs.append(f"{etype}: field {f!r} missing or non-numeric")
    for f in EVENT_TYPES[etype]:
        if f not in e:
            errs.append(f"{etype}: missing required field {f!r}")
    return errs
