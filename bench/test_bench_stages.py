"""Device ops put down to program stages: launches joined by correlation
id, each op given to the innermost span open at its launch, the rest to
``harness`` or ``unattributed``, and a cell's traced run on the CPU with
the span log on."""
from unittest.mock import patch

import pytest
import torch

from bench import harness, stages, trace
from repro_torch import obs

OFF = 1000                    # the trace's clock less perf_counter_ns


class Ev:
    """A stand-in for the profiler's ``_KinetoEvent``."""

    def __init__(self, name, kind, start, end, corr):
        self._v = (name, kind, start, end, corr)

    def name(self):
        return self._v[0]

    def activity_type(self):
        return self._v[1]

    def start_ns(self):
        return self._v[2]

    def end_ns(self):
        return self._v[3]

    def correlation_id(self):
        return self._v[4]


class Prof:
    def __init__(self, events):
        self.profiler = type("P", (), {"kineto_results": type(
            "K", (), {"events": lambda _: events})()})()


def test_launches_are_joined_by_correlation_id():
    events = [
        Ev(trace.ANCHOR, "cuda_runtime", 0, 1000, 9),  # anchor 0: offset OFF
        Ev("cudaLaunchKernel", "cuda_runtime", 1500, 1510, 1),
        Ev("fused_descent", "kernel", 1600, 1900, 1),
        Ev("Memcpy DtoD", "gpu_memcpy", 1950, 2000, 2),  # no launch record
        Ev("cuLaunchKernel", "cuda_driver", 1520, 1530, 3),
        Ev("late", "kernel", 2100, 2300, 3),           # clipped at the end
        Ev("aten::add", "cpu_op", 1400, 1700, 1),
    ]
    prof = Prof(events)
    tr = trace.Trace.from_profiler(prof, 0, [], (500, 1200))
    stages.attach_launches(tr, prof)
    assert tr.device_ops == [("fused_descent", 1600, 1900),
                             ("Memcpy DtoD", 1950, 2000), ("late", 2100, 2200)]
    assert tr.launch_ns == [1500, None, 1520]


def synthetic(unattributed_ns):
    """Two update calls and one lookup, spans on ``perf_counter_ns`` and
    ops on the trace's clock (``OFF`` later)."""
    rec = obs.Recording()
    for base in (0, 1000):                       # two updates
        at = iter([base + t for t in [10, 20, 90, 120, 190, 220, 290, 320,
                                      390, 420, 490, 600]])
        with patch("time.perf_counter_ns", lambda: next(at)):
            u = rec._enter("op.update")
            for stage in ("dedupe", "descend_probe", "clone", "write",
                          "report"):
                rec._exit(rec._enter(stage))
            rec._exit(u)
    at = iter([2000, 2010, 2050, 2100])
    with patch("time.perf_counter_ns", lambda: next(at)):
        lk = rec._enter("op.lookup")
        rec._exit(rec._enter("descend_probe"))
        rec._exit(lk)
    ops, at = [], []
    t = 5000
    for base in (0, 1000):
        for k, (name, d) in enumerate((("sort", 40), ("fused_descent", 300),
                                       ("copy", 20), ("scatter", 10))):
            ops.append((name, t, t + d))
            at.append(OFF + base + 30 + 100 * k)
            t += d
        ops.append(("harness_add", t, t + 5))    # between calls
        at.append(OFF + base + 800)
        t += 5
    ops.append(("fused_descent", t, t + 200))
    at.append(OFF + 2020)
    t += 200
    ops.append(("lost", t, t + unattributed_ns))
    at.append(None)
    tr = trace.Trace(ops, [], (OFF, OFF + 10000))
    tr.offset_ns, tr.launch_ns = OFF, at
    return stages.Stages(tr, rec)


def test_device_time_goes_to_the_stage_that_launched_it():
    st = synthetic(unattributed_ns=5)
    rows = st.rows
    assert rows["op.update.dedupe"] == [2, 80, 140, 2]
    assert rows["op.update.descend_probe"][1::2] == [600, 2]
    assert rows["op.update.clone"][1] == 40 and rows["op.update.write"][1] == 20
    assert rows["op.update"][:3] == [2, 0, 2 * (590 - 5 * 70)]
    assert rows["op.lookup.descend_probe"][1] == 200
    assert rows[stages.HARNESS][1::2] == [10, 2]
    assert rows[stages.UNATTRIBUTED][1::2] == [5, 1]
    assert sum(r[1] for r in rows.values()) == st.device_op_ns
    assert (st.k1, st.k1_probe) == (3, 3)
    assert stages.dedupe_device_ms(st) == pytest.approx(40e-6)
    assert stages.update_write_device_ms(st) == pytest.approx(30e-6)
    assert stages.device_ops_per_call(st) == pytest.approx(9 / 3)
    assert stages.op_span_host_ms(st) == pytest.approx((590 * 2 + 100) / 3e6)
    # the card is busy only from 5000 on (trace clock), after every call
    assert stages.idle_issuing_pct(st) == pytest.approx(
        100 * (590 * 2 + 100) / 10000)
    assert len(st.lines()) == len(rows)


def test_no_stage_metric_reads_past_one_percent_unattributed():
    st = synthetic(unattributed_ns=20)            # 20 of 970 busy ns
    for name, (_, read) in stages.METRICS.items():
        assert (read(st) is None) == (name != "op_span_host_ms"), name


def test_a_traced_cpu_run_records_the_stages():
    cell = harness.Cell("ycsb-a", config={"recordcount": 5000}, traffic={
        "pool": 1, "sample_lanes": 64,
        "rounds": [{"op": "lookup", "batch": 256},
                   {"op": "update", "batch": 256}]})
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        res, st = stages.run(cell, 5, 0.2, True, device="cpu")
    finally:
        torch.set_num_threads(threads)
    assert res["correct"] or res["checks"]["jax_modules_loaded"]["value"]
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    n_update = res["attempted"] // 512
    assert st.rows["op.update.dedupe"][0] == n_update >= 1
    assert st.rows["op.lookup.descend_probe"][0] == n_update
    assert st.calls == 2 * n_update
    # the CPU has no device ops: only the host-clock metric reads
    assert set(res["metrics"]) >= {"op_span_host_ms", "op_call_host_ms"}
    assert "dedupe_device_ms" not in res["metrics"]
    assert res["metrics"]["op_span_host_ms"]["value"] <= res["metrics"][
        "op_call_host_ms"]["value"]
