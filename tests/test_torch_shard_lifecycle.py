"""The port's sharded fsck, fault layer, lifecycle and chaos sweep against
the reference's.

Mirrors the sharded cases of ``tests/test_lifecycle.py``: the same build,
fault plan and op sequence run on ``repro.shard`` and on
``repro_torch.shard``; after every step both sharded trees' arrays are
equal bit for bit, and every verdict is the same — fsck reports, op
reports (``degraded``, ``failed``, owners), health, publish reports and
each fault plan's event log. The chaos sweep's twin
(``tools/chaos_sweep_torch.py``) runs the reference's mini schedules, and
for seed 0 on 4 shards each scenario fires the reference sweep's faults,
in order.
"""
import random

import numpy as np
import pytest
import torch

from repro import shard as RSH
from repro.core import fsck as rfsck
from repro.core import keys as RK
from repro.core.faults import FaultPlan as RFaultPlan
from repro.core.faults import FaultSpec as RFaultSpec
from repro.core.faults import RetryPolicy as RRetry
from repro.core.faults import corrupt_tree as r_corrupt_tree
from repro.core.lifecycle import TreeVersionManager as RManager
from repro_torch import shard as SH
from repro_torch.core import fsck
from repro_torch.core import keys as K
from repro_torch.core.faults import (FaultPlan, FaultSpec, RetryPolicy,
                                     corrupt_tree)
from repro_torch.core.lifecycle import TreeVersionManager

from test_torch_shard import W8_MAX_KEYS, _same_report, _same_shards

W = 8
FAST = RetryPolicy(max_attempts=2, sleep=lambda s: None)
R_FAST = RRetry(max_attempts=2, sleep=lambda s: None)



@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Run this module's torch ops on one thread: the sharded ops are many
    small ops, which gain nothing from intra-op threads, and the test
    workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

def _keyset(ints):
    return K.make_keyset([int(x).to_bytes(W, "big") for x in ints], W)


def _sharded(n=200, n_shards=4, seed=1, max_keys=W8_MAX_KEYS):
    """The reference's and the port's sharded tree of the same keys."""
    rng = np.random.default_rng(seed)
    base = np.sort(rng.choice(1 << 40, n, replace=False))
    vals = np.arange(n, dtype=np.int32)
    ks = _keyset(base)
    rst = RSH.sharded_build(RK.KeySet(ks.bytes, ks.lens), vals, n_shards,
                            max_keys=max_keys)
    pst = SH.sharded_build(ks, vals, n_shards, max_keys=max_keys,
                           target="cpu")
    _same_shards(rst, pst)
    return rst, pst, base, vals


def _plans(*specs):
    return (RFaultPlan(tuple(RFaultSpec(*s) for s in specs)),
            FaultPlan(tuple(FaultSpec(*s) for s in specs)))


def _same_fsck(r, p):
    assert (r.ok, r.violations, r.n_live, r.n_leaves) == \
        (p.ok, p.violations, p.n_live, p.n_leaves), (r, p)
    return p


def _same_publish(r, p):
    assert (r.ok, r.version, r.label, r.reason, r.violations) == \
        (p.ok, p.version, p.label, p.reason, p.violations), (r, p)
    return p


def test_fsck_sharded_ownership():
    """check_sharded: per-shard structure plus router ownership — a key
    living in the wrong shard is a violation even if both shards are
    individually well-formed; the reports equal the reference's."""
    rst, pst, *_ = _sharded(n=120, n_shards=3, seed=5)
    assert _same_fsck(rfsck.check_sharded(rst), fsck.check_sharded(pst)).ok
    assert fsck.check(pst).ok
    bad_r = rst.replace(shards=(rst.shards[0], rst.shards[2],
                                rst.shards[2]))
    bad_p = pst.replace(shards=(pst.shards[0], pst.shards[2],
                                pst.shards[2]))
    r = _same_fsck(rfsck.check_sharded(bad_r), fsck.check_sharded(bad_p))
    assert not r.ok
    assert any("route to a different shard" in v for v in r.violations)
    _same_fsck(rfsck.check(bad_r), fsck.check(bad_p))


@pytest.mark.parametrize("width", (3, 8, 13, 24))
def test_fsck_key_ranks_match_reference(width):
    """fsck's key ranks (a lexsort over 64-bit words) equal the
    reference's (``np.unique`` over ``bytes ‖ len_be`` rows), and its
    owners the reference's rank-based owners, on keys from a three-byte
    alphabet: many equal rows, shared prefixes, twins that only the length
    tells apart, widths no multiple of 8."""
    from repro.core.fsck import _key_ranks as r_ranks
    from repro_torch.core.fsck import _key_ranks, _owners
    rng = np.random.default_rng(width)
    kb = rng.integers(0, 3, size=(400, width)).astype(np.uint8)
    kl = rng.integers(0, width + 1, size=400).astype(np.int32)
    kb[np.arange(width)[None, :] >= kl[:, None]] = 0
    want = r_ranks(kb, kl)
    assert np.array_equal(_key_ranks(kb, kl), want)
    assert _key_ranks(kb[:0], kl[:0]).shape == (0,)
    sb, sl = kb[[5, 17, 99]], kl[[5, 17, 99]]
    order = np.argsort(r_ranks(sb, sl), kind="stable")
    sb, sl = sb[order], sl[order]
    r = r_ranks(np.concatenate([sb, kb]), np.concatenate([sl, kl]))
    split_r, key_r = r[:3], r[3:]
    ref_owner = np.maximum((key_r[:, None] >= split_r[None, :]).sum(1) - 1,
                           0)
    assert np.array_equal(_owners(kb, kl, sb, sl), ref_owner)


@pytest.mark.parametrize("seed", (0, 1, 7))
def test_corrupt_sharded_tree_matches_reference(seed):
    """corrupt_tree on a sharded tree draws the victim shard before the
    shard's corruption, so one ``random.Random`` seed damages the same
    shard with the same kind as the reference; fsck flags both alike."""
    rst, pst, *_ = _sharded(n=160, n_shards=4, seed=3)
    for kind in (None, "chain_break", "knum_bump"):
        rr, pr = random.Random(seed), random.Random(seed)
        rbad, rk = r_corrupt_tree(rst, rr, kind=kind)
        pbad, pk = corrupt_tree(pst, pr, kind=kind)
        assert rk == pk and rr.getstate() == pr.getstate()
        _same_shards(rbad, pbad)
        rep = _same_fsck(rfsck.check(rbad), fsck.check(pbad))
        assert not rep.ok
        # the input tree is untouched
        assert fsck.check(pst).ok


def test_transient_drop_absorbed_by_retry():
    """A one-attempt flake (nth=0, count=1) is retried and served live —
    no degraded lanes, shard stays healthy."""
    rst, pst, base, vals = _sharded()
    rplan, pplan = _plans(("shard.dispatch.lookup", "drop_shard", 0, 1, 1))
    q = _keyset(base[::4])
    rv, rrep = RSH.lookup_batch(rst, q.bytes, q.lens, faults=rplan,
                                retry=R_FAST)
    v, rep = SH.lookup_batch(pst, q.bytes, q.lens, faults=pplan, retry=FAST)
    _same_report(rrep, rep)
    assert bool(rep.found.all())
    assert np.array_equal(v.numpy(), vals[::4]) and np.array_equal(
        rv, v.numpy())
    assert not bool(rep.degraded.any())
    assert pst.health.is_ok(1)
    assert ("shard.dispatch.lookup", "drop_shard", 1) in pplan.events
    assert rplan.events == pplan.events


def test_down_shard_degrades_and_recovers():
    """Retry exhaustion on a persistently down shard: lookups serve the
    last-barrier snapshot (degraded, stale-but-true), mutations flag
    exactly the down lanes failed (never partially applied), and the
    rebalance barrier is the recovery path — no committed op lost. Every
    step equals the reference's."""
    rst, pst, base, vals = _sharded()
    rplan, pplan = _plans(("shard.dispatch.*", "drop_shard", 0, -1, 2))
    q = _keyset(base[::4])
    idx = np.arange(0, 200, 4)

    rv, rrep = RSH.lookup_batch(rst, q.bytes, q.lens, faults=rplan,
                                retry=R_FAST)
    v, rep = SH.lookup_batch(pst, q.bytes, q.lens, faults=pplan, retry=FAST)
    _same_report(rrep, rep)
    down = rep.owner == 2
    assert bool(down.any()) and torch.equal(rep.degraded, down)
    assert bool(rep.found.all())              # the snapshot still has them
    assert np.array_equal(v.numpy(), vals[idx]) and np.array_equal(
        rv, v.numpy())
    assert not pst.health.is_ok(2)
    assert list(rst.health.ok) == list(pst.health.ok)

    newv = (vals[idx] + 1000).astype(np.int32)
    rst2, rrep = RSH.update_batch(rst, q.bytes, q.lens, newv, faults=rplan,
                                  retry=R_FAST)
    pst2, urep = SH.update_batch(pst, q.bytes, q.lens, newv, faults=pplan,
                                 retry=FAST)
    _same_report(rrep, urep)
    _same_shards(rst2, pst2)
    assert torch.equal(urep.failed, down)
    v2, lrep = SH.lookup_batch(pst2, q.bytes, q.lens, faults=pplan,
                               retry=FAST)
    d = down.numpy()
    assert np.array_equal(v2.numpy()[~d], newv[~d])     # committed lanes
    assert np.array_equal(v2.numpy()[d], vals[idx][d])  # stale snapshot
    _same_fsck(rfsck.check_sharded(rst2), fsck.check_sharded(pst2))
    assert fsck.check_sharded(pst2).ok

    for plan, st in ((rplan, rst2), (pplan, pst2)):
        plan.heal()
        plan.disarm()
        st.health.reset()
    rst3, rrb = RSH.rebalance(rst2)
    pst3, prb = SH.rebalance(pst2)
    assert rrb == prb
    _same_shards(rst3, pst3)
    assert pst3.health.n_unhealthy == 0
    assert fsck.check_sharded(pst3).ok
    v3, rep3 = SH.lookup_batch(pst3, q.bytes, q.lens)
    assert bool(rep3.found.all())
    assert np.array_equal(v3.numpy()[~d], newv[~d])
    assert np.array_equal(v3.numpy()[d], vals[idx][d])
    assert rplan.events == pplan.events


def test_down_shard_insert_and_remove_fail_exactly_its_lanes():
    """Inserts and removes routed to a down shard report exactly its lanes
    failed and commit nothing there; the reference agrees lane for lane
    and array for array."""
    rst, pst, base, vals = _sharded()
    rplan, pplan = _plans(("shard.dispatch.*", "drop_shard", 0, -1, 1))
    new = _keyset([int(x) + 1 for x in base[::3]])
    nv = np.arange(new.n, dtype=np.int32) + 7000
    rst2, rrep, rr = RSH.insert_batch(rst, new.bytes, new.lens, nv,
                                      faults=rplan, retry=R_FAST)
    pst2, prep, pr = SH.insert_batch(pst, new.bytes, new.lens, nv,
                                     faults=pplan, retry=FAST)
    assert rr == pr
    _same_report(rrep, prep)
    assert torch.equal(prep.failed, prep.owner == 1)
    _same_shards(rst2, pst2)
    q = _keyset(base[::5])
    rst3, rrep = RSH.remove_batch(rst2, q.bytes, q.lens, faults=rplan,
                                  retry=R_FAST)
    pst3, prep = SH.remove_batch(pst2, q.bytes, q.lens, faults=pplan,
                                 retry=FAST)
    _same_report(rrep, prep)
    _same_shards(rst3, pst3)
    assert prep.shards_dropped == (1,)
    assert rplan.events == pplan.events


def test_manager_rebalance_recovery_barrier():
    """TreeVersionManager.rebalance over a ShardedTree: a publish that
    aborts mid-gather changes nothing; the clean retry bumps the version
    and serves identically — both equal to the reference's."""
    rst, pst, base, vals = _sharded(n_shards=3)
    rplan, pplan = _plans(("lifecycle.rebalance.gather", "abort", 0, -1, 1))
    rmgr, mgr = RManager(rst, faults=rplan), TreeVersionManager(pst,
                                                                faults=pplan)
    rep = _same_publish(rmgr.rebalance(), mgr.rebalance())
    assert not rep.ok and rep.reason == "fault:lifecycle.rebalance.gather"
    assert mgr.version == 0 and mgr.current is pst
    rplan.disarm()
    pplan.disarm()
    rep = _same_publish(rmgr.rebalance(), mgr.rebalance())
    assert rep.ok and mgr.version == 1 and mgr.previous is pst
    _same_shards(rmgr.current, mgr.current)
    q = _keyset(base)
    v, lrep = SH.lookup_batch(mgr.current, q.bytes, q.lens)
    assert bool(lrep.found.all())
    assert np.array_equal(v.numpy(), vals)
    assert rplan.events == pplan.events
    # the barrier site fires first, and an abort there is clean too
    for rp, pp in (_plans(("lifecycle.rebalance.barrier", "abort")),
                   _plans(("lifecycle.rebalance.build", "abort"))):
        rep = _same_publish(RManager(rmgr.current, faults=rp).rebalance(),
                            TreeVersionManager(mgr.current,
                                               faults=pp).rebalance())
        assert not rep.ok and rep.reason.startswith("fault:lifecycle.")
    # on an FBTree, rebalance is rebuild
    m1 = TreeVersionManager(pst.shards[0])
    rep = m1.rebalance()
    assert rep.ok and m1.label == "rebalance"
    with pytest.raises(TypeError, match="use rebalance"):
        TreeVersionManager(pst).rebuild()


def test_manager_rebalance_rejects_corrupt_staged():
    """A corruption planted on the staged sharded tree is caught by the
    fsck gate: the publish fails with the reference's reason and the old
    partition keeps serving."""
    rst, pst, *_ = _sharded(n_shards=4)
    rplan, pplan = _plans(("lifecycle.staged", "corrupt"))
    rep = _same_publish(RManager(rst, faults=rplan).rebalance(),
                        TreeVersionManager(pst, faults=pplan).rebalance())
    assert not rep.ok and rep.reason.startswith("fsck:")
    assert rplan.events == pplan.events


def test_sharded_build_validation_messages():
    ks = _keyset([1, 2, 3])
    vals = np.arange(3, dtype=np.int32)
    with pytest.raises(ValueError, match="n_shards must be >= 1"):
        SH.sharded_build(ks, vals, 0, target="cpu")
    with pytest.raises(ValueError, match="sentinel keys"):
        SH.sharded_build(ks, vals, 8, target="cpu")
    with pytest.raises(ValueError, match="one value per"):
        SH.sharded_build(ks, vals[:2], 2, target="cpu")
    from repro_torch.core.fbtree import TreeConfig
    cfg = TreeConfig.plan(max_keys=64, key_width=16)
    with pytest.raises(ValueError, match="key_width"):
        SH.sharded_build(ks, vals, 2, cfg=cfg, target="cpu")
    # word for word the reference's messages
    from repro.core.fbtree import TreeConfig as RConfig
    rks = RK.KeySet(ks.bytes, ks.lens)
    cases = [((ks, vals, 0), (rks, vals, 0), {}),
             ((ks, vals, 8), (rks, vals, 8), {}),
             ((ks, vals[:2], 2), (rks, vals[:2], 2), {}),
             ((ks, vals, 2), (rks, vals, 2), "cfg")]
    for pargs, rargs, kw in cases:
        with pytest.raises(ValueError) as pe:
            SH.sharded_build(*pargs, target="cpu",
                             **({"cfg": cfg} if kw else {}))
        with pytest.raises(ValueError) as re_:
            RSH.sharded_build(*rargs, **({"cfg": RConfig.plan(
                max_keys=64, key_width=16)} if kw else {}))
        assert str(pe.value) == str(re_.value)


def test_range_scan_validates_max_items():
    rst, pst, base, _ = _sharded(n=40, n_shards=2)
    q = _keyset([int(base[0])])
    with pytest.raises(ValueError, match="max_items"):
        SH.range_scan(pst, q.bytes, q.lens, max_items=0)
    with pytest.raises(ValueError, match="key width"):
        SH.lookup_batch(pst, q.bytes[:, :4], q.lens)


def test_sharded_tree_wiring_validation():
    """ShardedTree construction rejects mismatched router/devices/health
    sizes with actionable errors instead of asserts."""
    _, st, *_ = _sharded(n=40, n_shards=2)
    with pytest.raises(ValueError, match="per shard"):
        st.replace(shards=st.shards[:1])
    with pytest.raises(ValueError, match="health"):
        st.replace(health=SH.ShardHealth(3))
    with pytest.raises(ValueError, match="split"):
        st.replace(shards=st.shards[:1], devices=(None,))
    h = st.health
    h.mark_down(1, "test")
    assert repr(h) == "ShardHealth(2 shards, down 1:test)"
    assert h.n_unhealthy == 1
    h.mark_up(1)
    assert repr(h) == "ShardHealth(2 shards, all ok)"


# ------------------------------------------------------------- mini chaos

def _recording(module, plan_cls, monkeypatch):
    """Record every FaultPlan a sweep module makes."""
    plans = []

    class Rec(plan_cls):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            plans.append(self)
    monkeypatch.setattr(module, "FaultPlan", Rec)
    return plans


@pytest.mark.parametrize("scenario", ("rebuild", "rebalance", "compact",
                                      "lookup"))
def test_mini_chaos_schedules(scenario, monkeypatch):
    """The reference's slice of the chaos sweep, on the port's twin
    (``tools/chaos_sweep_torch.py``): every seeded schedule ends
    fsck-clean with no committed op lost (run_schedule raises on any
    violation). For seed 0 on 4 shards the fired fault list equals the
    reference sweep's, event for event."""
    import tools.chaos_sweep as ref_sweep
    import tools.chaos_sweep_torch as sweep
    plans = _recording(sweep, FaultPlan, monkeypatch)
    fired = 0
    for seed in range(2):
        for n_shards in (1, 4):
            r = sweep.run_schedule(seed, n_shards, scenario, target="cpu")
            assert r["events"] == len(plans[-1].events)
            fired += r["events"]
            if (seed, n_shards) == (0, 4):
                port_events = list(plans[-1].events)
    assert fired > 0, "no faults fired — schedules proved nothing"
    ref_plans = _recording(ref_sweep, RFaultPlan, monkeypatch)
    ref_sweep.run_schedule(0, 4, scenario)
    assert port_events == ref_plans[-1].events
    assert port_events, "seed 0 on 4 shards fired no fault"
