#!/usr/bin/env python
"""Seeded chaos sweep over the tree lifecycle + fault layer (DESIGN.md §8),
on the PyTorch port (``repro_torch``); the twin of ``tools/chaos_sweep.py``.

Each schedule builds a fresh tree (or serving cache), runs one scenario
under a seeded random :class:`repro_torch.core.faults.FaultPlan`, checks
``core.fsck`` after every step, then heals/disarms, runs the recovery
barrier, and verifies that every *committed* op survived — nothing lost,
nothing phantom. A schedule fails loudly (AssertionError) on any invariant
break, so the sweep doubles as the CI chaos smoke.

Scenarios (× shard counts):

  rebuild    single-tree lifecycle rebuild under abort/corrupt faults
  rebalance  sharded rebalance barrier under abort/corrupt faults
  compact    PrefixCache.compact (serving layer) under abort/corrupt faults
  lookup     routed lookup/update/insert/remove under drop/delay faults

Determinism: the fault schedule is a pure function of (seed, n_shards,
scenario) — replay a failing schedule with the same triple. The port
visits the same fault sites in the same order as the reference, so one
triple fires the same faults in both sweeps.

Trees are built on the card unless ``--target cpu`` is given.

Usage:

  PYTHONPATH=src python tools/chaos_sweep_torch.py \
      --schedules 200 --shards 1,4 --target cpu
"""
from __future__ import annotations

import argparse
import os
import sys
import time
from typing import Optional

sys.path.insert(0, os.path.join(os.path.dirname(__file__), os.pardir, "src"))

import numpy as np

from repro_torch import obs
from repro_torch import shard as SH
from repro_torch.core import batch_ops as B
from repro_torch.core import fsck
from repro_torch.core import keys as K
from repro_torch.core.faults import FaultPlan, RetryPolicy
from repro_torch.core.fbtree import TreeConfig, bulk_build
from repro_torch.core.lifecycle import TreeVersionManager

W = 8            # key width (uint64 big-endian)
N0 = 96          # live keys per schedule
BATCH = 16       # routed-op lane count
MAX_KEYS = 512
SCENARIOS = ("rebuild", "rebalance", "compact", "lookup")
# no real sleeping in the sweep: retries and delays are logical only
FAST = RetryPolicy(max_attempts=2, sleep=lambda s: None)
P = {"abort": 0.35, "corrupt": 0.25, "drop_shard": 0.30, "delay": 0.15}

_CFG_CACHE = {}


def _cfg() -> TreeConfig:
    """One shared TreeConfig for every schedule (the reference's: pool
    shapes are cap-sized)."""
    if "cfg" not in _CFG_CACHE:
        _CFG_CACHE["cfg"] = TreeConfig.plan(max_keys=MAX_KEYS, key_width=W)
    return _CFG_CACHE["cfg"]


def _keyset(ints) -> K.KeySet:
    return K.make_keyset([int(x).to_bytes(W, "big") for x in ints], W)


def _fresh_ints(rng, model, n):
    out = []
    while len(out) < n:
        x = int(rng.integers(0, 1 << 40))
        if x not in model and x not in out:
            out.append(x)
    return out


def _verify(obj, model, sharded: bool, ctx: str):
    """Every committed key must be found with its committed value.

    Batches are padded to a multiple of 64 (repeating the first key), as
    the reference pads them.
    """
    ints = sorted(model)
    if not ints:
        return
    pad = (-len(ints)) % 64
    q = ints + [ints[0]] * pad
    ks = _keyset(q)
    if sharded:
        v, rep = SH.lookup_batch(obj, ks.bytes, ks.lens)
    else:
        v, rep = B.lookup_batch(obj, ks.bytes, ks.lens)
    found = rep.found.cpu().numpy()
    vv = v.cpu().numpy()
    exp = np.array([model[i] for i in q])
    assert found.all(), f"{ctx}: committed key missing"
    assert (vv == exp).all(), f"{ctx}: committed value lost"


def _fsck_ok(obj, ctx: str):
    r = fsck.check(obj)
    assert r.ok, f"{ctx}: fsck violations {r.violations[:3]}"


# ------------------------------------------------------------- scenarios

def _scenario_rebuild(n_shards, plan, rng, model, target):
    """Lifecycle rebuild publishes under abort/corrupt; the serving version
    must stay fsck-clean and bit-stable through every failed attempt."""
    ints = sorted(model)
    tree = bulk_build(_cfg(), _keyset(ints),
                      np.array([model[i] for i in ints], np.int32),
                      target=target)
    plan.disarm()
    # churn fault-free: tombstones give the rebuild something to reclaim
    rm = [int(x) for x in rng.choice(ints, BATCH, replace=False)]
    q = _keyset(rm)
    tree, _ = B.remove_batch(tree, q.bytes, q.lens)
    for k in rm:
        del model[k]
    new = _fresh_ints(rng, model, BATCH)
    nv = rng.integers(0, 1 << 30, BATCH).astype(np.int32)
    q = _keyset(new)
    tree, _, _ = B.insert_batch(tree, q.bytes, q.lens, nv)
    model.update(zip(new, (int(x) for x in nv)))

    mgr = TreeVersionManager(tree, faults=plan)
    plan.arm()
    for _ in range(4):
        v0 = mgr.version
        rep = mgr.rebuild()
        plan.disarm()
        _fsck_ok(mgr.current, "rebuild attempt")
        _verify(mgr.current, model, False, "rebuild attempt")
        if not rep.ok:
            assert mgr.version == v0, "failed publish advanced the version"
        plan.arm()
        if rep.ok:
            break
    plan.disarm()
    rep = mgr.rebuild()
    assert rep.ok, f"fault-free rebuild failed: {rep.reason}"
    _fsck_ok(mgr.current, "post-recovery")
    _verify(mgr.current, model, False, "post-recovery")


def _scenario_rebalance(n_shards, plan, rng, model, target):
    """Sharded rebalance barrier under abort/corrupt faults."""
    ints = sorted(model)
    st = SH.sharded_build(_keyset(ints),
                          np.array([model[i] for i in ints], np.int32),
                          n_shards, cfg=_cfg(), target=target)
    plan.disarm()
    rm = [int(x) for x in rng.choice(ints, BATCH, replace=False)]
    q = _keyset(rm)
    st, _ = SH.remove_batch(st, q.bytes, q.lens)
    for k in rm:
        del model[k]
    new = _fresh_ints(rng, model, BATCH)
    nv = rng.integers(0, 1 << 30, BATCH).astype(np.int32)
    q = _keyset(new)
    st, _, _ = SH.insert_batch(st, q.bytes, q.lens, nv)
    model.update(zip(new, (int(x) for x in nv)))

    mgr = TreeVersionManager(st, faults=plan)
    plan.arm()
    for _ in range(4):
        v0 = mgr.version
        rep = mgr.rebalance()
        plan.disarm()
        _fsck_ok(mgr.current, "rebalance attempt")
        _verify(mgr.current, model, True, "rebalance attempt")
        if not rep.ok:
            assert mgr.version == v0, "failed publish advanced the version"
        plan.arm()
        if rep.ok:
            break
    plan.disarm()
    plan.heal()
    rep = mgr.rebalance()
    assert rep.ok, f"fault-free rebalance failed: {rep.reason}"
    _fsck_ok(mgr.current, "post-recovery")
    _verify(mgr.current, model, True, "post-recovery")


def _scenario_compact(n_shards, plan, rng, model, target):
    """PrefixCache.compact is an atomic publish: a failed compaction must
    leave the cache serving exactly what it served before."""
    from repro_torch.serving.prefix_cache import PrefixCache
    plan.disarm()
    pc = PrefixCache(n_pages=64, block_tokens=8, max_keys=2048,
                     n_shards=n_shards, faults=plan, retry=FAST,
                     target=target)
    prompts = [rng.integers(0, 1000, size=24).astype(np.int32)
               for _ in range(6)]
    for p in prompts:
        hb, _pages = pc.match([p])
        pc.publish(p, hb[0])
    ref_hits, ref_pages = pc.match(prompts)
    plan.arm()
    for _ in range(3):
        rep = pc.compact()
        plan.disarm()
        _fsck_ok(pc.tree, "compact attempt")
        hits, pages = pc.match(prompts)
        assert hits == ref_hits and pages == ref_pages, \
            "compact changed serving results"
        plan.arm()
        if rep.ok:
            break
    plan.disarm()
    plan.heal()
    rep = pc.compact()
    assert rep.ok, f"fault-free compact failed: {rep.reason}"
    _fsck_ok(pc.tree, "post-recovery")
    hits, pages = pc.match(prompts)
    assert hits == ref_hits and pages == ref_pages, \
        "recovery compact changed serving results"


def _scenario_lookup(n_shards, plan, rng, model, target):
    """Routed ops under sticky drops + delays: failed lanes are never
    committed, degraded lanes serve the last-barrier snapshot, and the
    recovery rebalance loses nothing."""
    ints = sorted(model)
    st = SH.sharded_build(_keyset(ints),
                          np.array([model[i] for i in ints], np.int32),
                          n_shards, cfg=_cfg(), target=target)
    snap_model = dict(model)      # snapshots advance only at barriers
    plan.arm()
    for _ in range(3):
        op = ("lookup", "update", "remove", "insert")[int(rng.integers(4))]
        if op == "insert":
            keys = _fresh_ints(rng, model, BATCH)
            nv = rng.integers(0, 1 << 30, BATCH).astype(np.int32)
            q = _keyset(keys)
            st, rep, _ = SH.insert_batch(st, q.bytes, q.lens, nv,
                                         faults=plan, retry=FAST)
            failed = rep.failed.cpu().numpy()
            for i, k in enumerate(keys):
                if not failed[i]:
                    model[k] = int(nv[i])
        elif op == "update":
            keys = [int(x) for x in
                    rng.choice(sorted(model), BATCH, replace=False)]
            nv = rng.integers(0, 1 << 30, BATCH).astype(np.int32)
            q = _keyset(keys)
            st, rep = SH.update_batch(st, q.bytes, q.lens, nv,
                                      faults=plan, retry=FAST)
            failed = rep.failed.cpu().numpy()
            for i, k in enumerate(keys):
                if not failed[i]:
                    model[k] = int(nv[i])
        elif op == "remove":
            keys = [int(x) for x in
                    rng.choice(sorted(model), BATCH, replace=False)]
            q = _keyset(keys)
            st, rep = SH.remove_batch(st, q.bytes, q.lens,
                                      faults=plan, retry=FAST)
            failed = rep.failed.cpu().numpy()
            for i, k in enumerate(keys):
                if not failed[i]:
                    del model[k]
        else:
            keys = [int(x) for x in
                    rng.choice(sorted(model), BATCH, replace=False)]
            q = _keyset(keys)
            v, rep = SH.lookup_batch(st, q.bytes, q.lens,
                                     faults=plan, retry=FAST)
            deg = rep.degraded.cpu().numpy()
            found = rep.found.cpu().numpy()
            vv = v.cpu().numpy()
            for i, k in enumerate(keys):
                ref = snap_model if deg[i] else model
                assert found[i] == (k in ref), \
                    f"lookup: lane {i} found={found[i]} degraded={deg[i]}"
                if k in ref:
                    assert int(vv[i]) == ref[k], \
                        f"lookup: lane {i} wrong value (degraded={deg[i]})"
        _fsck_ok(st, f"after routed {op}")
    plan.heal()
    plan.disarm()
    st.health.reset()
    st, _rep = SH.rebalance(st)
    _fsck_ok(st, "post-recovery")
    _verify(st, model, True, "post-recovery")
    # removed keys must stay gone after recovery
    gone = sorted(set(snap_model) - set(model))[:BATCH]
    if gone:
        gone = gone + [gone[0]] * (BATCH - len(gone))
        q = _keyset(gone)
        _v, rep = SH.lookup_batch(st, q.bytes, q.lens)
        assert not bool(rep.found.any()), \
            "removed key resurrected by recovery"


_SCENARIO_FNS = {"rebuild": _scenario_rebuild,
                 "rebalance": _scenario_rebalance,
                 "compact": _scenario_compact,
                 "lookup": _scenario_lookup}


def run_schedule(seed: int, n_shards: int, scenario: str,
                 target: Optional[str] = None) -> dict:
    """Run one seeded chaos schedule on ``target`` (the card unless
    ``"cpu"``); raises on any invariant violation.

    Returns ``{"seed", "n_shards", "scenario", "events"}`` where ``events``
    is the number of faults that actually fired (replayable from the seed).
    """
    sidx = SCENARIOS.index(scenario)
    rng = np.random.default_rng([seed, n_shards, sidx])
    plan = FaultPlan(seed=(seed << 8) ^ (n_shards << 4) ^ sidx, p=P,
                     sleep=lambda s: None)
    base = np.sort(rng.choice(1 << 40, N0, replace=False))
    vals = rng.integers(0, 1 << 30, N0).astype(np.int32)
    model = {int(k): int(v) for k, v in zip(base, vals)}
    _SCENARIO_FNS[scenario](n_shards, plan, rng, model, target)
    return {"seed": seed, "n_shards": n_shards, "scenario": scenario,
            "events": len(plan.events)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--schedules", type=int, default=40,
                    help="total schedules to run (CI uses 200)")
    ap.add_argument("--shards", default="1,4",
                    help="comma-separated shard counts")
    ap.add_argument("--scenarios", default=",".join(SCENARIOS))
    ap.add_argument("--events-dir", default="out/chaos",
                    help="where failing schedules dump their telemetry "
                         "event logs (JSON lines, one file per failure)")
    ap.add_argument("--target", default=None,
                    help="device to build the trees on (default: the card; "
                         "'cpu' for the CPU)")
    args = ap.parse_args(argv)
    shard_list = [int(s) for s in args.shards.split(",")]
    scen = [s for s in args.scenarios.split(",") if s]
    for s in scen:
        if s not in SCENARIOS:
            ap.error(f"unknown scenario {s!r}; one of {SCENARIOS}")

    # telemetry on for the whole sweep: each schedule's event log is the
    # replay context a failure ships as its CI artifact
    obs.enable()
    t0 = time.time()
    events = 0
    fails = []
    for i in range(args.schedules):
        sc = scen[i % len(scen)]
        nsh = shard_list[(i // len(scen)) % len(shard_list)]
        obs.reset()                     # one event log per schedule
        try:
            r = run_schedule(i, nsh, sc, target=args.target)
            events += r["events"]
        except Exception as e:  # noqa: BLE001 — report, keep sweeping
            fails.append((i, nsh, sc, repr(e)))
            dump = os.path.join(args.events_dir,
                                f"fail_seed{i}_shards{nsh}_{sc}.events.jsonl")
            n_ev = obs.export_events_jsonl(dump)
            summary = ", ".join(f"{k}={v}" for k, v in
                                obs.event_summary().items()) or "none"
            print(f"FAIL seed={i} shards={nsh} scenario={sc}: {e!r}\n"
                  f"     events: {summary}\n"
                  f"     log: {dump} ({n_ev} events)")
    dt = time.time() - t0
    print(f"chaos sweep: {args.schedules} schedules, {events} faults fired, "
          f"{len(fails)} failures, {dt:.1f}s")
    if not fails and events == 0:
        print("ERROR: no faults fired — the sweep proved nothing")
        return 2
    return 1 if fails else 0


if __name__ == "__main__":
    sys.exit(main())
