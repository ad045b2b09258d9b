"""The port's fsck, fault layer and versioned lifecycle against the
reference's, on unsharded trees.

Mirrors the unsharded cases of ``tests/test_lifecycle.py``: the same op
sequence, corruption or fault schedule runs on a reference tree and on the
port's tree of the same keys; after every step both trees' arrays are
equal bit for bit, and every verdict is the same — fsck's ``ok``, its
violation messages, ``n_live`` and ``n_leaves``; each publish report's
``ok``, ``version``, ``label``, ``reason`` and violations; each fault
plan's event log.
"""
import random

import numpy as np
import pytest

from repro.core import batch_ops as RB
from repro.core import fsck as rfsck
from repro.core import keys as RK
from repro.core.faults import CORRUPTIONS as R_CORRUPTIONS
from repro.core.faults import FaultInjected as RFaultInjected
from repro.core.faults import FaultPlan as RFaultPlan
from repro.core.faults import FaultSpec as RFaultSpec
from repro.core.faults import corrupt_tree as r_corrupt_tree
from repro.core.fbtree import TreeConfig as RConfig
from repro.core.fbtree import bulk_build as r_bulk_build
from repro.core.lifecycle import TreeVersionManager as RManager
from repro_torch.core import batch_ops as PB
from repro_torch.core import fsck
from repro_torch.core.faults import (CORRUPTIONS, FaultInjected, FaultPlan,
                                     FaultSpec, ShardDropped, corrupt_tree)
from repro_torch.core.fbtree import TreeConfig, bulk_build
from repro_torch.core.lifecycle import TreeVersionManager

from test_torch_tree import assert_arrays_equal

W = 8


def _keys(ints):
    return [int(x).to_bytes(W, "big") for x in ints]


def _both(n=160, seed=3, max_keys=1024):
    rng = np.random.default_rng(seed)
    base = np.sort(rng.choice(1 << 40, n, replace=False))
    vals = np.arange(n, dtype=np.int32)
    ks = RK.make_keyset(_keys(base), W)
    rt = r_bulk_build(RConfig.plan(max_keys=max_keys, key_width=W), ks, vals)
    pt = bulk_build(TreeConfig.plan(max_keys=max_keys, key_width=W), ks, vals,
                    target="cpu")
    assert_arrays_equal(rt.arrays, pt.arrays)
    return rt, pt, base


def _same_report(r, p):
    assert (r.ok, r.violations, r.n_live, r.n_leaves) == \
        (p.ok, p.violations, p.n_live, p.n_leaves), (r, p)
    return p


def _same_publish(r, p):
    assert (r.ok, r.version, r.label, r.reason, r.violations) == \
        (p.ok, p.version, p.label, p.reason, p.violations), (r, p)
    return p


def _ops(rt, pt, op, keys, vals=None):
    ks = RK.make_keyset(keys, W)
    if op == "insert":
        rt, _, _ = RB.insert_batch(rt, ks.bytes, ks.lens, vals)
        pt, _, _ = PB.insert_batch(pt, ks.bytes, ks.lens, vals)
    else:
        rt, _ = RB.remove_batch(rt, ks.bytes, ks.lens)
        pt, _ = PB.remove_batch(pt, ks.bytes, ks.lens)
    assert_arrays_equal(rt.arrays, pt.arrays)
    return rt, pt


def test_corruption_vocabulary_is_the_reference_one():
    assert CORRUPTIONS == R_CORRUPTIONS


def test_fsck_clean_through_op_lifecycle():
    """check_tree passes on a fresh build and stays clean through inserts
    (with leaf splits), removes and a rebuild, with version monotonicity
    against the previous arrays; both packages give the same verdicts."""
    rt, pt, base = _both()
    assert _same_report(rfsck.check_tree(rt), fsck.check_tree(pt)).ok
    rprev, pprev = rt, pt
    new = [int(x) + 1 for x in base[:64]]        # force splits via density
    rt, pt = _ops(rt, pt, "insert", _keys(new), np.arange(64, dtype=np.int32))
    assert _same_report(rfsck.check_tree(rt, prev=rprev),
                        fsck.check_tree(pt, prev=pprev)).ok
    rprev, pprev = rt, pt
    rt, pt = _ops(rt, pt, "remove", _keys(base[10:40]))
    assert _same_report(rfsck.check_tree(rt, prev=rprev),
                        fsck.check_tree(pt, prev=pprev)).ok
    rt2, rrep = RB.rebuild(rt)
    pt2, prep = PB.rebuild(pt)
    assert_arrays_equal(rt2.arrays, pt2.arrays)
    r = _same_report(rfsck.check_tree(rt2), fsck.check_tree(pt2))
    assert r.ok and r.n_live == int(prep.n_live) == int(rrep.n_live)
    # empty tree: remove everything, rebuild, still structurally valid
    live_b, live_l, *_ = PB.gather_live_sorted(pt)
    n_live = pt.n_keys_live
    keys = [bytes(b[:l]) for b, l in zip(live_b[:n_live].numpy(),
                                        live_l[:n_live].numpy())]
    rt3, pt3 = _ops(rt, pt, "remove", keys)
    rt4, _ = RB.rebuild(rt3)
    pt4, _ = PB.rebuild(pt3)
    assert_arrays_equal(rt4.arrays, pt4.arrays)
    r = _same_report(rfsck.check_tree(rt4), fsck.check_tree(pt4))
    assert r.ok and pt4.n_keys_live == 0


def test_fsck_version_regression_detected():
    rt, pt, _ = _both(n=80)
    rt2, pt2 = _ops(rt, pt, "insert", _keys(range(5)),
                    np.arange(5, dtype=np.int32))
    assert _same_report(rfsck.check_tree(rt2, prev=rt),
                        fsck.check_tree(pt2, prev=pt)).ok
    r = _same_report(rfsck.check_tree(rt, prev=rt2),
                     fsck.check_tree(pt, prev=pt2))   # swapped: regress
    assert not r.ok and any("version" in v for v in r.violations)


@pytest.mark.parametrize("kind", R_CORRUPTIONS)
def test_fsck_detects_every_corruption(kind):
    """One seed damages the same slot in both packages; fsck flags it with
    the same messages, and the input tree is left untouched."""
    rt, pt, _ = _both()
    rt2, rk = r_corrupt_tree(rt, random.Random(7), kind=kind)
    pt2, pk = corrupt_tree(pt, random.Random(7), kind=kind)
    assert rk == pk == kind
    assert_arrays_equal(rt2.arrays, pt2.arrays)
    assert_arrays_equal(rt.arrays, pt.arrays)     # inputs untouched
    r = _same_report(rfsck.check_tree(rt2), fsck.check_tree(pt2))
    assert not r.ok, f"{kind} went undetected"


def test_corrupt_tree_random_kind_matches_reference():
    rt, pt, _ = _both(n=40)
    for seed in range(6):
        rt2, rk = r_corrupt_tree(rt, random.Random(seed))
        pt2, pk = corrupt_tree(pt, random.Random(seed))
        assert rk == pk
        assert_arrays_equal(rt2.arrays, pt2.arrays)


def test_publish_success_and_abort_atomicity():
    """rebuild() as an atomic publish: success bumps the version and keeps
    the old one as rollback; an injected abort at any lifecycle step leaves
    the current version serving bit-identically — in both packages."""
    rt, pt, base = _both()
    q = _keys(base[:32])
    rt, pt = _ops(rt, pt, "remove", q)            # give rebuild work
    rmgr, pmgr = RManager(rt), TreeVersionManager(pt)
    rep = _same_publish(rmgr.rebuild(), pmgr.rebuild())
    assert rep.ok and pmgr.version == 1
    assert pmgr.previous is pt
    assert int(rep.aux.reclaimed) == 32
    assert_arrays_equal(rmgr.current.arrays, pmgr.current.arrays)
    ks = RK.make_keyset(q, W)
    for site in ("lifecycle.begin", "lifecycle.rebuild.gather",
                 "lifecycle.rebuild.build", "lifecycle.fsck",
                 "lifecycle.swap"):
        rm2 = RManager(rmgr.current,
                       faults=RFaultPlan((RFaultSpec(site, "abort"),)))
        pm2 = TreeVersionManager(pmgr.current,
                                 faults=FaultPlan((FaultSpec(site, "abort"),)))
        before = pm2.current
        rep = _same_publish(rm2.rebuild(), pm2.rebuild())
        assert not rep.ok and rep.reason == f"fault:{site}"
        assert pm2.current is before and pm2.version == 0
        assert pm2.faults.events == rm2.faults.events
        _, lrep = PB.lookup_batch(pm2.current, ks.bytes, ks.lens)
        assert not lrep.found.any()               # removed keys stay gone


def test_publish_fsck_gate_blocks_corrupt_staged():
    rt, pt, _ = _both()
    rplan = RFaultPlan((RFaultSpec("lifecycle.staged", "corrupt"),), seed=11)
    pplan = FaultPlan((FaultSpec("lifecycle.staged", "corrupt"),), seed=11)
    rmgr = RManager(rt, faults=rplan)
    pmgr = TreeVersionManager(pt, faults=pplan)
    rep = _same_publish(rmgr.rebuild(), pmgr.rebuild())
    assert not rep.ok and rep.reason.startswith("fsck:")
    assert rep.violations and pmgr.version == 0 and pmgr.current is pt
    assert pplan.events == rplan.events
    assert any(k.startswith("corrupt:") for _, k, _ in pplan.events)
    assert fsck.check_tree(pmgr.current).ok
    rplan.disarm()
    pplan.disarm()
    assert _same_publish(rmgr.rebuild(), pmgr.rebuild()).ok
    assert_arrays_equal(rmgr.current.arrays, pmgr.current.arrays)


def test_fault_plan_replay_and_spec_windows():
    """Determinism contract: the same seed replays the same schedule (and
    the reference's); a FaultSpec nth/count window fires on exactly its
    visits."""
    def drive(plan, exc):
        for i in range(6):
            try:
                plan.fire("lifecycle.step", shard=None)
            except exc:
                pass
            try:
                plan.fire("shard.dispatch.lookup", shard=i % 2)
            except exc:
                pass
        return list(plan.events)
    p = {"abort": 0.5, "drop_shard": 0.5}
    e1 = drive(FaultPlan(seed=42, p=p), FaultInjected)
    e2 = drive(FaultPlan(seed=42, p=p), FaultInjected)
    e3 = drive(FaultPlan(seed=43, p=p), FaultInjected)
    assert e1 == e2 and e1 and e1 != e3
    assert e1 == drive(RFaultPlan(seed=42, p=p), RFaultInjected)
    spec = FaultSpec("shard.dispatch.*", "drop_shard", nth=1, count=2)
    plan = FaultPlan((spec,))
    fired = []
    for _ in range(5):
        try:
            plan.fire("shard.dispatch.update", shard=0)
            fired.append(False)
        except ShardDropped:
            fired.append(True)
    assert fired == [False, True, True, False, False]
    with pytest.raises(ValueError, match="unknown fault kind"):
        FaultPlan((FaultSpec("x", "explode"),))
