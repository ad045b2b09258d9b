"""Each device op of a traced window put down to the program stage that
launched it.

The port's op layer opens a root span a call (``op.lookup``,
``op.update``, ...) with a span a stage inside it (``dedupe``,
``descend_probe``, ``clone``, ``write``, ``report``; see
``repro_torch/core/batch_ops.py``), and under ``obs.recording()`` logs them
in memory on the host's ``perf_counter_ns`` clock. In the profiler's trace
CUPTI links every kernel, copy and fill to the runtime call that launched
it (``cudaLaunchKernel``, ``cudaMemcpyAsync``, ...) by a correlation id.
That call's start, on the trace's clock, lies inside the innermost program
span open at the launch, once the spans are moved onto the trace's clock by
the anchor's offset (``bench/trace.py``). An op launched outside every
program span is the harness's own work (``harness``); one whose launch
record the trace lacks is ``unattributed``.

Run a cell's traced run with the span log on (``--record 1``) or off::

    PYTHONPATH=src python3 -m bench.stages --workload <cell> --seed <n> \\
        --seconds <s> --record 1

It prints a line a stage on stderr, and on stdout one JSON line: the
harness's traced result, ``ops_per_s`` of the traced window, and the
readings of :data:`METRICS`.
"""
import bisect
import json
import sys
from contextlib import nullcontext

HARNESS, UNATTRIBUTED = "harness", "unattributed"
K1 = "fused_descent"
MAX_UNATTRIBUTED = 0.01       # of busy time; past it no stage metric reads


def attach_launches(tr, prof) -> None:
    """Set ``tr.launch_ns``: for each of ``tr.device_ops``, the start of
    the runtime call that launched it on the trace's clock, or None where
    the trace lacks that record. ``prof`` is the profiler ``tr`` was read
    from."""
    from .trace import _on_device
    launch, dev = {}, []
    for e in prof.profiler.kineto_results.events():
        if _on_device(e):
            dev.append((e.name(), e.start_ns(), e.end_ns(), e.correlation_id()))
        elif e.name().startswith("cu"):    # a CUDA runtime or driver call
            launch[e.correlation_id()] = e.start_ns()
    w0, w1 = tr.window
    ops = [(n, max(s, w0), min(e, w1), launch.get(c)) for n, s, e, c in dev
           if e > w0 and s < w1]
    ops.sort(key=lambda d: d[:3])          # Trace.from_profiler's order
    ops.sort(key=lambda d: d[1])
    if [d[:3] for d in ops] != tr.device_ops:
        raise RuntimeError("the profiler's device ops differ from the Trace's")
    tr.launch_ns = [d[3] for d in ops]


def _overlap_ns(a, b) -> int:
    """Total overlap of two sorted lists of disjoint ``(start, end)``."""
    i = j = tot = 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        tot += max(0, hi - lo)
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return tot


class Stages:
    """The traced window's device and host time by program stage.

    ``rows[path] = [calls, device_ns, host_self_ns, launches]``: for each
    recorded span path, the spans of it in the window, the device time of
    the ops launched inside it and no deeper span, its host time less its
    child spans' (self time), and those ops' count; rows ``harness`` and
    ``unattributed`` hold device time and ops alone. ``tr`` carries
    ``launch_ns`` (:func:`attach_launches`) and ``offset_ns``; ``rec`` is
    the run's ``obs.Recording``.
    """

    def __init__(self, tr, rec):
        off, (w0, w1) = tr.offset_ns, tr.window
        _, parent, root, t0, t1 = zip(*map(rec.record, range(len(rec)))
                                      ) if len(rec) else ((),) * 5
        t0 = [t + off for t in t0]
        t1 = [t + off for t in t1]
        n = len(t0)
        self.rows = {}

        def row(key):
            return self.rows.setdefault(key, [0, 0, 0, 0])

        roots = []
        for i in range(n):
            if not w0 <= t0[i] <= t1[i] <= w1:
                continue
            r = row(rec.name(i))
            r[0] += 1
            r[2] += t1[i] - t0[i]
            if parent[i] >= 0:
                row(rec.name(parent[i]))[2] -= t1[i] - t0[i]
            elif rec.name(i).startswith("op."):
                roots.append((t0[i], t1[i]))
        self.calls = len(roots)
        self.call_host_ns = sum(e - s for s, e in roots)
        self.call_ops = self.k1 = self.k1_probe = 0
        for (name, s, e), at in zip(tr.device_ops, tr.launch_ns):
            j = -1
            if at is not None:
                j = bisect.bisect_right(t0, at) - 1
                while j >= 0 and t1[j] < at:     # closed: go up its parents
                    j = parent[j]
            key = (UNATTRIBUTED if at is None else
                   HARNESS if j < 0 else rec.name(j))
            r = row(key)
            r[1] += e - s
            r[3] += 1
            if j >= 0 and rec.name(root[j]).startswith("op."):
                self.call_ops += 1
            if K1 in name:
                self.k1 += 1
                self.k1_probe += key.endswith(".descend_probe")
        busy = tr.busy_intervals()
        self.window_ns = w1 - w0
        self.busy_ns = sum(e - s for s, e in busy)
        self.device_op_ns = sum(e - s for _, s, e in tr.device_ops)
        edges = [w0] + [x for b in busy for x in b] + [w1]
        idle = [(edges[k], edges[k + 1]) for k in range(0, len(edges), 2)]
        self.idle_in_calls_ns = _overlap_ns(idle, roots)

    def device_ns(self, *paths) -> int:
        """Device time of the ops launched in ``paths`` or spans below."""
        return sum(r[1] for k, r in self.rows.items()
                   if any(k == p or k.startswith(p + ".") for p in paths))

    def read(self) -> bool:
        """Whether stage metrics read: device ops ran, and no more than
        ``MAX_UNATTRIBUTED`` of busy time lacks its launch record."""
        lost = self.rows.get(UNATTRIBUTED, [0, 0])[1]
        return self.busy_ns > 0 and lost <= MAX_UNATTRIBUTED * self.busy_ns

    def lines(self):
        """A line a stage: calls, device and host seconds, launches."""
        out = []
        for key in sorted(self.rows, key=lambda k: k in (HARNESS,
                                                           UNATTRIBUTED)):
            c, d, h, k = self.rows[key]
            out.append(f"stage {key} calls {c} device_s {d * 1e-9} "
                       f"host_self_s {h * 1e-9} launches {k}")
        return out


def _per_update_ms(st, *paths):
    calls = st.rows.get("op.update", [0])[0]
    if not calls or not st.read():
        return None
    return 1e-6 * st.device_ns(*paths) / calls


def dedupe_device_ms(st):
    """Device time per update call of the ops ``op.update.dedupe``
    launched: ``dedupe_last_wins``'s sorts, gathers and compares."""
    return _per_update_ms(st, "op.update.dedupe")


def update_write_device_ms(st):
    """Device time per update call of ``op.update.clone`` and
    ``op.update.write``: the ``leaf_val`` clone and the masked write."""
    return _per_update_ms(st, "op.update.clone", "op.update.write")


def device_ops_per_call(st):
    """Device ops (kernels, copies, fills) launched inside an ``op.*``
    call, per call: the op layer's work as a count."""
    if not st.calls or not st.read():
        return None
    return st.call_ops / st.calls


def op_span_host_ms(st):
    """Mean host time of an ``op.*`` root span: the op layer's issuing,
    measured inside the harness's own clock around the call."""
    if not st.calls:
        return None
    return 1e-6 * st.call_host_ns / st.calls


def idle_issuing_pct(st):
    """Share of the window in which the card was idle while the host was
    inside an ``op.*`` call: the op layer's part of the idle share."""
    if not st.calls or not st.read():
        return None
    return 100.0 * st.idle_in_calls_ns / st.window_ns


# name -> (unit, reader); each should move ops_per_s
METRICS = {
    "dedupe_device_ms": ("ms", dedupe_device_ms),
    "update_write_device_ms": ("ms", update_write_device_ms),
    "device_ops_per_call": ("ops", device_ops_per_call),
    "op_span_host_ms": ("ms", op_span_host_ms),
    "idle_issuing_pct": ("%", idle_issuing_pct),
}


def run(cell, seed: int, seconds: float, record: bool, device="cuda"):
    """A traced run of ``cell`` (``harness.run_cell``) with the span log
    on or off. Returns the harness's result line, with ``ops_per_s`` of
    the traced window and, with the log on, the stage metrics and rows
    added, and the :class:`Stages` (None with the log off)."""
    from repro_torch import obs
    from . import harness, trace
    # run_cell keeps neither the profiler nor the trace it reads: wrap the
    # trace's constructor for this run to keep both
    held = {}
    real = trace.Trace.from_profiler
    own = trace.Trace.__dict__["from_profiler"]

    def from_profiler(prof, anchor, spans, window):
        tr = held["trace"] = real(prof, anchor, spans, window)
        attach_launches(tr, prof)
        return tr

    trace.Trace.from_profiler = staticmethod(from_profiler)
    try:
        with (obs.recording() if record else nullcontext()) as rec:
            res = harness.run_cell(cell, seed, seconds, True, device=device)
    finally:
        trace.Trace.from_profiler = own
    res["ops_per_s"] = res["attempted"] / res["device"]["window_s"]
    if not record:
        return res, None
    st = Stages(held["trace"], rec)
    for name, (unit, read) in METRICS.items():
        v = read(st)
        if v is not None:
            res["metrics"][name] = {"value": v, "unit": unit}
    res["stages"] = {k: [c, d * 1e-9, h * 1e-9, n]
                     for k, (c, d, h, n) in st.rows.items()}
    res["stage_checks"] = {
        "k1_launches": st.k1, "k1_in_descend_probe": st.k1_probe,
        "stage_device_s": sum(r[1] for r in st.rows.values()) * 1e-9,
        "trace_device_op_s": st.device_op_ns * 1e-9,
        "unattributed_share_of_busy": (
            st.rows.get(UNATTRIBUTED, [0, 0])[1] / st.busy_ns
            if st.busy_ns else None)}
    return res, st


def main(argv=None) -> int:
    import argparse

    import torch

    from .harness import Cell, log
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--record", type=int, choices=(0, 1), default=1)
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        log("no CUDA device: the stages are the card's")
        return 2
    res, st = run(Cell(a.workload), a.seed, a.seconds, bool(a.record))
    for line in (st.lines() if st else []):
        log(line)
    print(json.dumps({"workload": a.workload, "seed": a.seed,
                      "record": a.record, **res}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
