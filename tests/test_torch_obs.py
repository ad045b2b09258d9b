"""The port's telemetry (``repro_torch.obs``): the framework-free half of
``tests/test_obs.py`` — off is bit-identical and registers nothing, the
drained counters equal the report's sums, histograms, spans and the event
schema behave as in the reference."""
import numpy as np
import pytest
import torch

from repro_torch import obs
from repro_torch.core import batch_ops as B
from repro_torch.core import keys as K
from repro_torch.core.fbtree import TreeConfig, bulk_build
from repro_torch.core.traverse import TraversalEngine

W = 8


@pytest.fixture(autouse=True)
def _obs_isolation():
    obs.disable()
    obs.reset()
    yield
    obs.disable()
    obs.reset()


def _keyset(ints):
    return K.make_keyset([int(x).to_bytes(W, "big") for x in ints], W)


def _tree(n=200, seed=7):
    rng = np.random.default_rng(seed)
    base = np.sort(rng.choice(1 << 40, n, replace=False))
    cfg = TreeConfig.plan(max_keys=1024, key_width=W)
    return (bulk_build(cfg, _keyset(base), np.arange(n, dtype=np.int32),
                       target="cpu"), base)


@pytest.mark.parametrize("backend", ("torch", "fused"))
def test_disabled_is_bit_identical_and_registers_nothing(backend):
    tree, base = _tree()
    q = _keyset([int(x) for x in base[:64]] + [3, 5])
    eng = TraversalEngine(backend)
    v0, rep0 = B.lookup_batch(tree, q.bytes, q.lens, engine=eng)
    assert obs.all_metrics() == [] and obs.events() == []
    obs.enable()
    v1, rep1 = B.lookup_batch(tree, q.bytes, q.lens, engine=eng)
    assert torch.equal(v0, v1)
    for f in rep0._fields:
        assert torch.equal(getattr(rep0, f), getattr(rep1, f)), f
    assert obs.all_metrics(), "enabled run should register metrics"


def test_null_metrics_while_disabled():
    c = obs.counter("x")
    g = obs.gauge("y")
    h = obs.histogram("z")
    c.inc(), g.set(3.0), h.observe(0.5)
    assert obs.all_metrics() == []
    assert obs.get_metric("x") is None
    assert obs.event("rebalance", n_live=1, reclaimed=0) is None
    assert obs.events() == []


def test_drained_counters_match_report_totals():
    tree, base = _tree()
    q = _keyset([int(x) for x in base[:96]])
    eng = TraversalEngine("torch", "tuple", collect_stats=True)
    _, rep = B.lookup_batch(tree, q.bytes, q.lens, engine=eng)
    obs.enable()
    obs.reset()
    _, rep2 = B.lookup_batch(tree, q.bytes, q.lens, engine=eng)
    for f in ("feat_rounds", "suffix_bs", "key_compares", "lines_touched",
              "tag_candidates"):
        want = int(getattr(rep, f).sum())
        m = obs.get_metric(f"tree.{f}", op="lookup")
        assert m is not None and m.value == want, (f, m and m.value, want)
    assert obs.get_metric("op.found", op="lookup").value == int(rep.found.sum())
    assert obs.get_metric("op.lanes", op="lookup").value == 96
    assert obs.get_metric("op.calls", op="lookup").value == 1


def test_drain_stats_sums_each_field():
    from repro_torch.core.branch import BranchStats
    obs.enable()
    st = BranchStats(*(torch.arange(4, dtype=torch.int32) * k
                       for k in range(1, 6)))
    obs.drain_stats(st, op="x")
    for k, f in enumerate(st._fields, 1):
        assert obs.get_metric(f"tree.{f}", op="x").value == 6 * k
    obs.drain_stats(None, op="x")            # stats-free engine: no-op


def test_histogram_quantiles_and_prometheus_export():
    obs.enable()
    h = obs.histogram("lat", op="x")
    for v in (1e-5, 1e-4, 1e-3, 1e-2, 0.1, 1.0):
        h.observe(v)
    assert h.count == 6 and h.p50 <= h.p90 <= h.p99
    assert 0.5e-3 <= h.p50 <= 2e-3
    assert 0.5 <= h.p99 <= 2.0
    text = obs.prometheus_text()
    assert '# TYPE lat histogram' in text
    assert 'lat_count{op="x"} 6' in text
    assert 'lat_bucket{op="x",le="+Inf"} 6' in text
    obs.counter("hits", op="x").inc(3)
    assert 'hits{op="x"} 3' in obs.prometheus_text()
    assert "lat{op=\"x\"}" in obs.console_summary()


def test_spans_nest_and_record_duration():
    obs.enable()
    with obs.span("outer"):
        assert obs.current_path() == "outer"
        with obs.span("inner", shard=1):
            assert obs.current_path() == "outer.inner"
    assert obs.current_path() == ""
    m = obs.get_metric("span.outer.inner", shard=1)
    assert m is not None and m.count == 1 and m.sum > 0
    assert obs.get_metric("span.outer").count == 1


def test_event_schema_enforced_at_emit(tmp_path):
    obs.enable()
    with pytest.raises(ValueError, match="unknown telemetry event type"):
        obs.event("not-a-type", x=1)
    with pytest.raises(ValueError, match="missing required fields"):
        obs.event("publish", label="x")
    e = obs.event("publish", label="x", version=1, ok=True, reason="",
                  duration_s=torch.tensor(0.5))
    assert e["seq"] == 0 and obs.validate_event(e) == []
    assert e["duration_s"] == 0.5
    assert obs.validate_event({"type": "nope"}) != []
    assert obs.validate_event({"type": "fault", "seq": 1, "ts": 2.0}) != []
    assert obs.event_summary() == {"publish": 1}
    assert obs.export_events_jsonl(str(tmp_path / "ev.jsonl")) == 1
