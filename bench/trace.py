"""The device trace of a run's window, reduced to what the per-layer
metrics read: the device's activity, busy and idle time, and what the host
was doing in each idle gap.

The window runs under ``torch.profiler`` with the CUDA activity alone:
recording every host-side op as well slowed the write path's calls several
fold and left the card idle for want of work. The harness keeps its own
host spans (``time.perf_counter_ns``) and one anchor: the moment a
synchronize of the current stream just before the window returned. The
trace's record of that ``cudaStreamSynchronize`` call, the first in the
trace, puts the anchor on the trace's clock, and the spans with it.
"""
import bisect
import time
from contextlib import contextmanager

import torch

DEVICE_KINDS = ("kernel", "gpu_memcpy", "gpu_memset")
ANCHOR = "cudaStreamSynchronize"


@contextmanager
def profiled(enabled: bool):
    """Profile the block's device activity when ``enabled``; yields the
    profiler or None. Without a card (the CPU tests) the host's ops are
    profiled instead, and none of them counts as the device's."""
    if not enabled:
        yield None
        return
    act = torch.profiler.ProfilerActivity
    with torch.profiler.profile(activities=[
            act.CUDA if torch.cuda.is_available() else act.CPU]) as prof:
        yield prof


def anchor() -> int:
    """Wait for the current stream and return the host's clock: the
    anchor :meth:`Trace.from_profiler` finds in the trace."""
    if torch.cuda.is_available():
        time.sleep(0.05)           # let the profiler's tracing settle first
        torch.cuda.current_stream().synchronize()
    return time.perf_counter_ns()


def _on_device(e) -> bool:
    try:
        return e.activity_type() in DEVICE_KINDS
    except AttributeError:        # a torch without activity types
        return e.device_type() == torch.autograd.DeviceType.CUDA


class Trace:
    """Device intervals and the harness's host spans of the traced window,
    in ns on the trace's clock."""

    def __init__(self, device_ops, host_spans, window):
        self.device_ops = device_ops      # [(name, start, end)], by start
        self.host_spans = host_spans      # [(name, start, end)], by start
        self.window = window              # (start, end)

    @classmethod
    def from_profiler(cls, prof, anchor: int, spans, window) -> "Trace":
        """``anchor``, ``spans`` and ``window`` are on the host's
        ``perf_counter_ns`` clock; ``anchor`` is when the synchronize that
        opens the window returned."""
        device, syncs = [], []
        for e in prof.profiler.kineto_results.events():
            if _on_device(e):
                device.append((e.name(), e.start_ns(), e.end_ns()))
            elif e.name() == ANCHOR:
                syncs.append(e.end_ns())
        if device and not syncs:
            raise RuntimeError(f"the trace holds no {ANCHOR} to put the "
                               f"host's spans on its clock")
        off = min(syncs) - anchor if syncs else 0
        w0, w1 = window[0] + off, window[1] + off
        device = sorted((n, max(s, w0), min(e, w1)) for n, s, e in device
                        if e > w0 and s < w1)
        device.sort(key=lambda d: d[1])
        host = sorted(((n, s + off, e + off) for n, s, e in spans),
                      key=lambda h: h[1])
        out = cls(device, host, (w0, w1))
        out.offset_ns = off
        return out

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) * 1e-9

    def busy_intervals(self):
        """The union of the device's activity, as sorted disjoint spans."""
        out = []
        for _, s, e in self.device_ops:
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return out

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) * 1e-9

    def kernel_s(self, fragment: str) -> float:
        """Device seconds of the ops whose name holds ``fragment``."""
        return sum(e - s for n, s, e in self.device_ops if fragment in n) * 1e-9

    def count(self, fragment: str) -> int:
        return sum(1 for n, _, _ in self.device_ops if fragment in n)

    def top_ops(self, k: int = 10):
        """``[[name, seconds]]`` of the device ops that took most time."""
        tot = {}
        for n, s, e in self.device_ops:
            tot[n[:120]] = tot.get(n[:120], 0) + (e - s)
        top = sorted(tot.items(), key=lambda kv: -kv[1])[:k]
        return [[n, t * 1e-9] for n, t in top]

    def idle_gaps(self, k: int = 10):
        """``[[what the host was doing, seconds]]`` of the longest idle
        gaps: the harness span open at the gap's start (``call.<op>``:
        issuing a call; ``wait``: waiting for one)."""
        busy = self.busy_intervals()
        edges = [self.window[0]] + [x for b in busy for x in b] + [self.window[1]]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]
        starts = [s for _, s, _ in self.host_spans]
        out = []
        for g0, g1 in sorted(gaps, key=lambda g: g[0] - g[1])[:k]:
            i = bisect.bisect_right(starts, g0) - 1
            n, s, e = self.host_spans[i] if i >= 0 else ("", 0, 0)
            out.append([n if s <= g0 < e else "between calls", (g1 - g0) * 1e-9])
        return out
