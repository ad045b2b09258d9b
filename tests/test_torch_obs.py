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


def test_counters_add_on_the_device_with_no_copy_a_batch(monkeypatch):
    """Drained counters equal the reports' totals, with no device-to-host
    copy while the ops run (the bridge's one copy raises until they are
    read); a stats-free engine drains no ``tree.*`` counter."""
    from repro_torch.obs import bridge
    tree, base = _tree()
    q = _keyset([int(x) for x in base[:64]] + [3, 5])
    vals = np.arange(66, dtype=np.int32)
    eng = TraversalEngine("torch", "tuple", collect_stats=True)
    obs.enable()
    real = bridge._host
    monkeypatch.setattr(bridge, "_host", lambda t: pytest.fail("host copy"))
    _, r1 = B.lookup_batch(tree, q.bytes, q.lens, engine=eng)
    _, r2 = B.lookup_batch(tree, q.bytes, q.lens, engine=eng)
    _, r3 = B.update_batch(tree, q.bytes, q.lens, vals, engine=eng)
    B.update_batch(tree, q.bytes, q.lens, vals,
                   engine=TraversalEngine("torch", collect_stats=False))
    monkeypatch.setattr(bridge, "_host", real)
    for f in ("feat_rounds", "key_compares", "tag_candidates"):
        assert obs.get_metric(f"tree.{f}", op="lookup").value == int(
            getattr(r1, f).sum() + getattr(r2, f).sum()), f
        assert obs.get_metric(f"tree.{f}", op="update").value == int(
            getattr(r3, f).sum()), f
    assert obs.get_metric("op.found", op="lookup").value == 128
    assert obs.get_metric("op.found", op="update").value == 128
    assert obs.get_metric("op.calls", op="update").value == 2
    assert obs.get_metric("op.lanes", op="update").value == 132


def _stub_k1(monkeypatch, stripes, lanes, builds):
    """K1's launch and the compiled library's answers stood in for (a CUDA
    kernel has no CPU mode), and any device sync or read made a failure.
    ``builds`` are (ns, key width) pairs; returns ``run(ns, width, times)``,
    which launches K1 through ``ops._run`` on a tree of that build, and the
    list of the library's answers asked for."""
    from repro_torch.kernels.fused_descent import cuda as kcuda
    from repro_torch.kernels.fused_descent import ops

    def launch(a, qb, ql, **kw):
        z = lambda *s: torch.zeros(s, dtype=torch.int32)
        B, NL = qb.shape[0], a.stacked.knum.shape[0]
        return (z(B), z(B, NL), torch.zeros(B, dtype=torch.bool), z(B), z(B),
                z(6, B))

    def inputs(ns, width):
        q = K.make_keyset([int(x).to_bytes(width, "big") for x in range(50)],
                          width)
        cfg = TreeConfig.plan(max_keys=1024, key_width=width, ns=ns)
        return (bulk_build(cfg, q, np.arange(50, dtype=np.int32),
                           target="cpu"),
                torch.from_numpy(q.bytes), torch.from_numpy(q.lens))
    trees = {b: inputs(*b) for b in builds}
    asked = []

    def run(ns, width, times):
        for _ in range(times):
            ops._run(*trees[(ns, width)], True, True, False)

    def ask_stripes(L):
        asked.append(("stripes", L))
        return stripes[L]

    def ask_lanes(ns, L):
        asked.append(("lanes", ns, L))
        return lanes[(ns, L)]

    monkeypatch.setattr(kcuda, "launch", launch)
    monkeypatch.setattr(kcuda, "stripes", ask_stripes)
    monkeypatch.setattr(kcuda, "lanes", ask_lanes)
    for name in ("synchronize", "current_stream"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **k: pytest.fail(
            "device sync"))
    for name in ("item", "tolist", "cpu"):
        monkeypatch.setattr(torch.Tensor, name, lambda *a, **k: pytest.fail(
            "device read"))
    return run, asked


def test_k1_launches_count_by_build_on_the_host(monkeypatch):
    """``kernel.launches`` counts K1's launches by the build launched
    (``stripes``, as the library picks it for the key width): S = 1 and
    S = 2 apart, nothing while telemetry is off (the library is not even
    asked then), and no sync or read of the card's results. The launch and
    the library's answers are stood in for: a CUDA kernel has no CPU mode."""
    from repro_torch.kernels.fused_descent import ops
    run, asked = _stub_k1(monkeypatch, {W: 1, 40: 2},
                          {(64, W): 8, (64, 40): 8}, ((64, W), (64, 40)))
    n0 = ops.LAUNCHES
    run(64, W, 1)
    assert obs.all_metrics() == [] and asked == []
    obs.enable()
    run(64, W, 2)
    run(64, 40, 1)
    assert ops.LAUNCHES == n0 + 4
    assert [a for a in asked if a[0] == "stripes"] == [
        ("stripes", W), ("stripes", W), ("stripes", 40)]

    def launches(s):
        return obs.get_metric("kernel.launches", kernel="fused_descent",
                              stripes=s, lanes=8)
    assert launches(1).value == 2 and launches(2).value == 1
    assert launches(3) is None


def test_k1_launches_carry_the_lanes_a_query(monkeypatch):
    """``kernel.launches`` carries ``lanes=G`` beside ``stripes=S``: the
    lanes a query of the body each launch ran, as the library picks them
    for the node size and key width (``cuda.lanes``), asked only while
    telemetry is on; a build of one S at another G counts apart."""
    from repro_torch.kernels.fused_descent import ops
    run, asked = _stub_k1(monkeypatch, {W: 1, 40: 2},
                          {(64, W): 8, (64, 40): 4, (128, W): 32},
                          ((64, W), (64, 40), (128, W)))
    run(128, W, 1)
    assert asked == []
    obs.enable()
    run(64, W, 2)
    run(64, 40, 1)
    run(128, W, 3)
    assert [a for a in asked if a[0] == "lanes"] == [
        ("lanes", 64, W), ("lanes", 64, W), ("lanes", 64, 40)] + [
        ("lanes", 128, W)] * 3

    def launches(s, g):
        m = obs.get_metric("kernel.launches", kernel="fused_descent",
                           stripes=s, lanes=g)
        return None if m is None else m.value
    assert (launches(1, 8), launches(2, 4), launches(1, 32)) == (2, 1, 3)
    assert launches(1, 4) is None and launches(2, 8) is None
    assert len([m for m in obs.all_metrics()
                if m.name == "kernel.launches"]) == 3


def _names(rec):
    return [rec.name(i) for i in range(len(rec))]


def test_update_records_its_stages_in_order():
    tree, base = _tree()
    q = _keyset([int(x) for x in base[:32]])
    with obs.recording() as rec:
        B.update_batch(tree, q.bytes, q.lens, np.arange(32, dtype=np.int32),
                       engine=TraversalEngine("fused"))
    assert _names(rec) == ["op.update"] + [f"op.update.{s}" for s in (
        "dedupe", "descend_probe", "clone", "write", "report")]
    root = rec.record(0)
    assert root[1:3] == (-1, 0)
    prev_end = root[3]
    for i in range(1, len(rec)):
        _, parent, r, t0, t1 = rec.record(i)
        assert (parent, r) == (0, 0)
        assert prev_end <= t0 <= t1 <= root[4]
        prev_end = t1
    # nothing but the log: no registry, no profiler range
    assert obs.all_metrics() == [] and not obs.enabled()


def test_recording_changes_no_output_and_ends_with_its_block():
    """Outputs are bit-identical with the log on and off; an insert
    records its prepare, round and sync stages; spans after the block
    record nothing."""
    tree, base = _tree()
    q = _keyset([int(x) for x in base[:40]] + list(range(7, 7 + 24 * 97, 97)))
    vals = np.arange(64, dtype=np.int32)

    def calls():
        v, rl = B.lookup_batch(tree, q.bytes, q.lens)
        t2, ru = B.update_batch(tree, q.bytes, q.lens, vals)
        t3, ri, rounds = B.insert_batch(tree, q.bytes, q.lens, vals,
                                        max_ov=2)
        return [v, t2.arrays.leaf_val, t3.arrays.leaf_keyid, rounds,
                *rl, *ru, *ri]

    off = calls()
    with obs.recording() as rec:
        on = calls()
    assert len(off) == len(on)
    for a, b in zip(off, on):
        assert (torch.equal(a, b) if isinstance(a, torch.Tensor)
                else a == b)
    names = _names(rec)
    n = len(rec)
    assert rec.name(next(i for i in range(n) if rec.record(i)[1] < 0)
                    ) == "op.lookup"
    for stage in ("prepare", "prepare.dedupe", "round", "sync", "report"):
        assert f"op.insert.{stage}" in names, stage
    assert names.count("op.insert.round") == off[3] >= 1
    with obs.span("after"):
        pass
    assert len(rec) == n


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
