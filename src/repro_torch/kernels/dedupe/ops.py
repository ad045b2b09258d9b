"""Wrapper for the write path's last-lane-wins dedupe kernel.

:func:`dedupe_last_lanes` is what ``core.batch_ops`` calls in the stage
``dedupe`` of every write (update, remove, insert): for tensors on the card
it launches the CUDA kernel (``cuda.py``: a hash table, three launches) or
raises; for tensors on the CPU it runs the plain torch version
(``ref.py``: the lexicographic sort). ``LAUNCHES`` counts the kernel
launches made through it in this process, three a call on the card.
"""
from __future__ import annotations

from . import cuda, ref

__all__ = ["dedupe_last_lanes", "LAUNCHES"]

LAUNCHES = 0


def dedupe_last_lanes(qb, ql, count_probes: bool = False):
    """``qb [B, L] u8``, ``ql [B] int32`` -> ``(winners [B] bool, conflicts
    int32 scalar, probes)``: the last lane of each key wins; ``probes`` is
    the kernel's probe steps (an int64 scalar) with ``count_probes`` on the
    card, else ``None``."""
    global LAUNCHES
    if not qb.is_cuda:
        return (*ref.dedupe_ref(qb, ql), None)
    out = cuda.launch(qb, ql, count_probes=count_probes)
    LAUNCHES += 3           # fill, insert, resolve
    return out
