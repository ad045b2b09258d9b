"""The port's sharded tree (``repro_torch.shard``) against its own unsharded
ops and against the reference's ``repro.shard``.

Mirrors ``tests/test_shard_tree.py``. Parity with the unsharded tree:
every routed op on a ShardedTree gives the values, found-ness, emitted
counts and resolved key bytes of the same op on one unsharded tree over the
same keys, for shard counts {1, 2, 4}, with the ``"torch"`` and the
``"fused"`` engine (on the CPU, K1's and K2's plain versions), on ordered
and dirtied leaves. Parity with the reference: one fixed case per dataset
(300 keys) runs the same ops on ``repro.shard`` and on the port — owners,
values, found, emitted, resolved key bytes and every shard's arrays must
be equal bit for bit, also after ``rebalance``; the router's owners equal
``repro.shard.route``'s; the sharded prefix cache answers hit for hit
with the reference's.
"""
import numpy as np
import pytest
import torch

from repro import shard as RS
from repro.core import keys as RK
from repro.core.fbtree import TreeConfig as RConfig
from repro.core.traverse import TraversalEngine as REngine
from repro.serving import PrefixCache as RPrefixCache
from repro_torch import shard as S
from repro_torch.core import batch_ops as B
from repro_torch.core import keys as K
from repro_torch.core.faults import FaultPlan, FaultSpec, RetryPolicy
from repro_torch.core.fbtree import EMPTY, TreeConfig, bulk_build
from repro_torch.core.traverse import TraversalEngine
from repro_torch.serving import PrefixCache

from benchmarks.common import make_dataset
from test_torch_serving import assert_pools_equal
from test_torch_tree import assert_arrays_equal

SHARD_COUNTS = (1, 2, 4)
ENGINES = (TraversalEngine("torch"), TraversalEngine("fused"))
N_KEYS = 300
# the width-8 trees share the chaos sweep's config (max_keys 512), so the
# reference compiles its ops for that shape once in a process
W8_MAX_KEYS = 512



@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Run this module's torch ops on one thread: the sharded ops are many
    small ops, which gain nothing from intra-op threads, and the test
    workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

def _np(t):
    return t.cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _dataset(ds_name, seed, n_keys=N_KEYS):
    keys, width = make_dataset(ds_name, n_keys, seed=seed)
    ks = K.make_keyset(keys, width)
    return ks, np.arange(len(keys), dtype=np.int32)


def _perturbed_queries(ks, rng, n, miss_frac=0.33):
    """Query batch mixing existing keys and perturbed (mostly-miss) keys."""
    picks = rng.integers(0, ks.n, size=n)
    qb = ks.bytes[picks].copy()
    ql = ks.lens[picks].copy()
    flip = rng.random(n) < miss_frac
    qb[flip, -1] ^= 0xA5
    return qb, ql


def _dirty_keys(ks, rng):
    """Fresh keys next to existing ones: in-place fits that clear
    ``leaf_ordered`` mid-range (the reference test's recipe)."""
    db, dl = _perturbed_queries(ks, rng, 40, miss_frac=1.0)
    uniq = {(bytes(db[i].tobytes()), int(dl[i])) for i in range(40)}
    uniq -= {(bytes(ks.bytes[i].tobytes()), int(ks.lens[i]))
             for i in range(ks.n)}
    uniq = sorted(uniq)
    return K.KeySet(np.stack([np.frombuffer(b, np.uint8) for b, _ in uniq]),
                    np.asarray([l for _, l in uniq], np.int32))


def _build_both(ks, cfg, vals, n_shards, dirty_ks=None):
    ref = bulk_build(cfg, ks, vals, target="cpu")
    st = S.sharded_build(ks, vals, n_shards, cfg=cfg, target="cpu")
    if dirty_ks is not None:
        dv = np.arange(dirty_ks.n, dtype=np.int32) + (1 << 20)
        ref, _, _ = B.insert_batch(ref, dirty_ks.bytes, dirty_ks.lens, dv)
        st, _, _ = S.insert_batch(st, dirty_ks.bytes, dirty_ks.lens, dv)
    return ref, st


def _assert_scan_parity(ref, st, qb, ql, max_items, engine, ctx):
    k_ref, v_ref, em_ref, _ = B.range_scan(ref, qb, ql, max_items=max_items,
                                           engine=engine)
    gk, v_sh, em_sh, _, failed = S.range_scan(st, qb, ql,
                                              max_items=max_items,
                                              engine=engine)
    assert gk.dtype == torch.int64 and em_sh.dtype == torch.int32, ctx
    assert not bool(failed.any()), ctx     # fault-free scans never degrade
    assert torch.equal(em_ref, em_sh), ctx
    assert torch.equal(v_ref, v_sh), ctx
    # key ids are pool-local: parity is on the resolved key bytes
    sb, sl = st.key_rows(gk)
    live = k_ref >= 0
    k = torch.clamp(k_ref, min=0).long()
    rb = torch.where(live[..., None], ref.arrays.key_bytes[k], 0)
    rl = torch.where(live, ref.arrays.key_lens[k], 0)
    assert torch.equal(sb, rb) and torch.equal(sl, rl), ctx
    past = torch.arange(max_items)[None, :] >= em_sh[:, None]
    assert bool((gk[past] == EMPTY).all()), ctx


@pytest.mark.parametrize("dirty", (False, True), ids=("ordered", "dirty"))
@pytest.mark.parametrize("ds_name", ("rand-int", "ycsb", "url"))
def test_shard_op_parity(ds_name, dirty):
    """lookup / update / insert / remove / range_scan on a ShardedTree ==
    the unsharded op, for shard counts {1, 2, 4} x engines x ordered/dirty
    leaves."""
    seed = {"rand-int": 11, "ycsb": 12, "url": 13}[ds_name] + 100 * dirty
    ks, vals = _dataset(ds_name, seed)
    cfg = TreeConfig.plan(max_keys=3 * N_KEYS, key_width=ks.width)
    rng = np.random.default_rng(seed)
    dirty_ks = _dirty_keys(ks, rng) if dirty else None
    qb, ql = _perturbed_queries(ks, rng, 48)
    upd_vals = rng.integers(0, 1 << 20, size=48).astype(np.int32)

    for n_shards in SHARD_COUNTS:
        ref, st = _build_both(ks, cfg, vals, n_shards, dirty_ks)
        if dirty:
            n_dirty = sum(int((~t.arrays.leaf_ordered[
                :int(t.arrays.leaf_count)]).sum()) for t in st.shards)
            assert n_dirty > 0, "dirtying produced no unordered leaves"
        for eng in ENGINES:
            ctx = (ds_name, n_shards, eng.backend, dirty)
            v_ref, rep_ref = B.lookup_batch(ref, qb, ql, engine=eng)
            v_sh, rep_sh = S.lookup_batch(st, qb, ql, engine=eng)
            f = rep_ref.found
            assert torch.equal(f, rep_sh.found), ctx
            assert torch.equal(v_ref[f], v_sh[f]), ctx
            # some queries start near shard boundaries: the spill path
            _assert_scan_parity(ref, st, qb[:16], ql[:16], 48, eng, ctx)

            ctx = (ds_name, n_shards, "mutations", eng.backend, dirty)
            r2, rep_r = B.update_batch(ref, qb, ql, upd_vals, engine=eng)
            s2, rep_s = S.update_batch(st, qb, ql, upd_vals, engine=eng)
            assert torch.equal(rep_r.found, rep_s.found), ctx
            assert int(rep_r.conflicts) == int(rep_s.conflicts), ctx
            r3, rep_r, _ = B.insert_batch(r2, qb, ql, upd_vals, engine=eng)
            s3, rep_s, _ = S.insert_batch(s2, qb, ql, upd_vals, engine=eng)
            assert torch.equal(rep_r.found, rep_s.found), ctx
            assert r3.n_keys_live == s3.n_keys_live, ctx
            r4, rep_r = B.remove_batch(r3, qb[::2], ql[::2], engine=eng)
            s4, rep_s = S.remove_batch(s3, qb[::2], ql[::2], engine=eng)
            assert torch.equal(rep_r.found, rep_s.found), ctx
            assert r4.n_keys_live == s4.n_keys_live, ctx
            v_ref, rep_ref = B.lookup_batch(r4, qb, ql, engine=eng)
            v_sh, rep_sh = S.lookup_batch(s4, qb, ql, engine=eng)
            f = rep_ref.found
            assert torch.equal(f, rep_sh.found), ctx
            assert torch.equal(v_ref[f], v_sh[f]), ctx
            _assert_scan_parity(r4, s4, qb[:8], ql[:8], 64, eng, ctx)


# ------------------------------------------------------ against repro.shard

def _same_shards(rst, pst):
    assert pst.n_shards == rst.n_shards
    for rt, pt in zip(rst.shards, pst.shards):
        assert_arrays_equal(rt.arrays, pt.arrays)
    for f in ("split_bytes", "split_lens", "split_words"):
        r, p = np.asarray(getattr(rst.router, f)), _np(getattr(pst.router, f))
        assert r.dtype == p.dtype and np.array_equal(r, p), f


def _same_report(r, p, fields=("found", "owner", "failed", "degraded",
                               "conflicts", "splits", "error")):
    for f in fields:
        a, b = np.asarray(getattr(r, f)), _np(getattr(p, f))
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    assert (r.shards_hit, r.shards_skipped, r.shards_dropped) == \
        (p.shards_hit, p.shards_skipped, p.shards_dropped)


def _same_scan(rout, pout):
    for name, r, p in zip(("gkid", "val", "emitted", "rearranged", "failed"),
                          rout, pout):
        r, p = np.asarray(r), _np(p)
        assert r.dtype == p.dtype and np.array_equal(r, p), name


@pytest.mark.parametrize("ds_name", ("ycsb", "url", "rand-int"))
def test_shard_matches_reference(ds_name):
    """One fixed case per dataset on ``repro.shard`` and on the port: the
    same build, owners, lookups, scans (global ids, values, emitted,
    resolved key bytes), mutations and rebalance, with every shard's
    arrays equal bit for bit after each step."""
    ks, vals = _dataset(ds_name, 5)
    rks = RK.KeySet(ks.bytes, ks.lens)
    rst = RS.sharded_build(rks, vals, 4, cfg=RConfig.plan(
        max_keys=3 * N_KEYS, key_width=ks.width))
    pst = S.sharded_build(ks, vals, 4, cfg=TreeConfig.plan(
        max_keys=3 * N_KEYS, key_width=ks.width), target="cpu")
    _same_shards(rst, pst)
    rng = np.random.default_rng(7)
    qb, ql = _perturbed_queries(ks, rng, 64)
    # a start below every split key and the split keys themselves
    qb[0], ql[0] = 0, 1
    sb = _np(pst.router.split_bytes)
    qb[1:5], ql[1:5] = sb, _np(pst.router.split_lens)
    reng, peng = REngine("jnp"), TraversalEngine("fused")

    assert np.array_equal(np.asarray(RS.route(rst.router, qb, ql)),
                          _np(S.route(pst.router, qb, ql)))
    rv, rrep = RS.lookup_batch(rst, qb, ql, engine=reng)
    pv, prep = S.lookup_batch(pst, qb, ql, engine=peng)
    _same_report(rrep, prep)
    assert np.array_equal(rv, _np(pv))
    rout = RS.range_scan(rst, qb, ql, max_items=80, engine=reng)
    pout = S.range_scan(pst, qb, ql, max_items=80, engine=peng)
    _same_scan(rout, pout)
    for r, p in zip(rst.key_rows(rout[0]), pst.key_rows(pout[0])):
        assert np.array_equal(r, _np(p))

    nv = rng.integers(0, 1 << 20, size=64).astype(np.int32)
    ins_ks = _dirty_keys(ks, rng)
    iv = np.arange(ins_ks.n, dtype=np.int32) + 5000
    rst, rrep, rr = RS.insert_batch(rst, ins_ks.bytes, ins_ks.lens, iv,
                                    engine=reng)
    pst, prep, pr = S.insert_batch(pst, ins_ks.bytes, ins_ks.lens, iv,
                                   engine=peng)
    assert rr == pr
    _same_report(rrep, prep)
    _same_shards(rst, pst)
    rst, rrep = RS.update_batch(rst, qb, ql, nv, engine=reng)
    pst, prep = S.update_batch(pst, qb, ql, nv, engine=peng)
    _same_report(rrep, prep)
    _same_shards(rst, pst)
    rst, rrep = RS.remove_batch(rst, qb[::3], ql[::3], engine=reng)
    pst, prep = S.remove_batch(pst, qb[::3], ql[::3], engine=peng)
    _same_report(rrep, prep)
    _same_shards(rst, pst)
    _same_scan(RS.range_scan(rst, qb, ql, max_items=80, engine=reng),
               S.range_scan(pst, qb, ql, max_items=80, engine=peng))

    rst2, rrep = RS.rebalance(rst)
    pst2, prep = S.rebalance(pst)
    assert rrep == prep
    _same_shards(rst2, pst2)
    pst3, prep3 = S.rebalance(pst, device=False)     # the host path
    assert prep3 == prep
    _same_shards(rst2, pst3)
    rv, rrep = RS.lookup_batch(rst2, qb, ql, engine=reng)
    pv, prep = S.lookup_batch(pst2, qb, ql, engine=peng)
    _same_report(rrep, prep)
    assert np.array_equal(rv, _np(pv))


def test_router_boundaries():
    """Router contract: shard s owns [split[s], split[s+1]); shard 0's
    range is open below; equal-to-split routes right; the length
    tie-break matches the byte-compare order — and every owner equals
    ``repro.shard.route``'s."""
    splits = [b"b", b"dd", b"f"]
    rows = [(np.frombuffer(k.ljust(4, b"\x00"), np.uint8), len(k))
            for k in splits]
    router = S.make_router(rows, target="cpu")
    qs = [b"a", b"b", b"c", b"d", b"dd", b"dd\x01", b"ddd", b"e", b"f", b"z",
          b"", b"\x00", b"b\x00", b"ddd\xff", b"\xff\xff\xff\xff"]
    ks = K.make_keyset(qs, 4)
    owner = S.route(router, ks.bytes, ks.lens)
    assert owner.dtype == torch.int32
    #      a  b  c  d  dd dd. ddd e  f  z  '' 0  b0 ddd. ff
    want = [0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 0, 0, 0, 1, 2]
    assert owner.tolist() == want, owner.tolist()
    assert np.array_equal(np.asarray(RS.route(RS.make_router(rows),
                                              ks.bytes, ks.lens)),
                          owner.numpy())
    # random splits and queries over a narrow alphabet (many ties and
    # shared prefixes), widths that pad the last packed word
    rng = np.random.default_rng(3)
    for width in (5, 8, 13):
        pool = rng.integers(0, 3, size=(64, width)).astype(np.uint8)
        lens = rng.integers(0, width + 1, size=64).astype(np.int32)
        pool[np.arange(width)[None, :] >= lens[:, None]] = 0
        uniq = sorted({(pool[i].tobytes(), int(lens[i])) for i in range(64)})
        pick = sorted(rng.choice(len(uniq), 4, replace=False))
        rows = [(np.frombuffer(uniq[i][0], np.uint8), uniq[i][1])
                for i in pick]
        got = S.route(S.make_router(rows, target="cpu"), pool, lens)
        want = RS.route(RS.make_router(rows), pool, lens)
        assert np.array_equal(np.asarray(want), got.numpy()), width


def test_routed_mask_hook():
    """The batch_ops routed-op hook: mask=False lanes are no-ops for
    update / remove / insert (no write, no pool append, not pending)."""
    rng = np.random.default_rng(5)
    keys = sorted({int(x) for x in rng.integers(0, 2**62, size=100)})
    ks = K.make_keyset(keys, 8)
    cfg = TreeConfig.plan(max_keys=400, key_width=8)
    t = bulk_build(cfg, ks, np.arange(len(keys), dtype=np.int32),
                   target="cpu")
    qb, ql = ks.bytes[:8], ks.lens[:8]
    mask = torch.tensor([True, False] * 4)

    t2, rep = B.update_batch(t, qb, ql, torch.full((8,), 999,
                                                   dtype=torch.int32),
                             mask=mask)
    v, _ = B.lookup_batch(t2, qb, ql)
    assert torch.equal(v, torch.where(mask, 999, torch.arange(8,
                                                              dtype=v.dtype)))
    assert bool(rep.found.all())            # found reported mask-blind

    t3, rep = B.remove_batch(t2, qb, ql, mask=mask)
    _, rep2 = B.lookup_batch(t3, qb, ql)
    assert torch.equal(rep2.found, ~mask)

    # insert: masked-out NEW keys must not append to the pool
    nks = K.make_keyset([int(x) + 1 for x in keys[:4]], 8)
    kc0 = int(t3.arrays.key_count)
    t4, rep, _ = B.insert_batch(t3, nks.bytes, nks.lens,
                                np.arange(4, dtype=np.int32),
                                mask=torch.tensor([True, True, False, False]))
    assert int(t4.arrays.key_count) == kc0 + 2
    _, rep3 = B.lookup_batch(t4, nks.bytes, nks.lens)
    assert rep3.found.tolist() == [True, True, False, False]


def test_rebalance_recovers_skew():
    """Skewed ingest concentrates keys in one shard; rebalance re-splits
    evenly, preserves every (key, value), refreshes the router, and
    matches the reference's rebalance array for array."""
    rng = np.random.default_rng(9)
    base = sorted({int(x) for x in rng.integers(0, 2**40, size=160)})
    ks = K.make_keyset(base, 8)
    vals = np.arange(len(base), dtype=np.int32)
    st = S.sharded_build(ks, vals, 4, max_keys=W8_MAX_KEYS, target="cpu")
    # skew: every new key routes to the LAST shard (beyond current max)
    hot = [int(x) + 2**50 for x in range(200)]
    hks = K.make_keyset(hot, 8)
    hv = np.arange(200, dtype=np.int32) + 1000
    st2, _, _ = S.insert_batch(st, hks.bytes, hks.lens, hv)
    counts = [int(t.n_keys_live) for t in st2.shards]
    assert counts[-1] >= 200, counts
    st3, rep = S.rebalance(st2)
    assert rep.n_live == st2.n_keys_live == st3.n_keys_live
    after = list(rep.counts_after)
    assert max(after) - min(after) <= 1, after
    assert after != list(rep.counts_before)
    allb = np.concatenate([ks.bytes, hks.bytes])
    alll = np.concatenate([ks.lens, hks.lens])
    v, rep2 = S.lookup_batch(st3, allb, alll)
    assert bool(rep2.found.all())
    assert np.array_equal(v.numpy(), np.concatenate([vals, hv]))
    # the reference, same steps
    rst = RS.sharded_build(RK.KeySet(ks.bytes, ks.lens), vals, 4,
                           max_keys=W8_MAX_KEYS)
    rst2, _, _ = RS.insert_batch(rst, hks.bytes, hks.lens, hv)
    rst3, rrep = RS.rebalance(rst2)
    assert rrep == rep
    _same_shards(rst3, st3)
    # n_shards == 1 degenerates to rebuild: the same tree
    st1 = S.sharded_build(ks, vals, 1, max_keys=W8_MAX_KEYS, target="cpu")
    st1b, _ = S.rebalance(st1)
    ref, _ = B.rebuild(st1.shards[0])
    assert_arrays_equal(_as_numpy(ref), st1b.shards[0].arrays)


def _as_numpy(tree):
    """A port tree's arrays as numpy, so ``assert_arrays_equal`` can take
    them on its reference side."""
    a = tree.arrays

    def conv(x):
        return x.cpu().numpy()
    flat = {f: conv(getattr(a, f)) for f in a._fields
            if f not in ("levels", "stacked")}
    return a._replace(levels=tuple(type(lv)(*map(conv, lv))
                                   for lv in a.levels),
                      stacked=type(a.stacked)(*map(conv, a.stacked)), **flat)


def _stride_tree(step=3, top=1200):
    keys = list(range(0, top, step))
    ks = K.make_keyset(keys, 8)
    vals = np.arange(len(keys), dtype=np.int32)
    cfg = TreeConfig.plan(max_keys=W8_MAX_KEYS, key_width=8)
    return keys, ks, vals, cfg


def test_scan_spills_across_shards():
    """A scan starting in the last leaves of shard s continues into shard
    s+1 (and further) until max_items — the continuation the leaf chain
    would have given unsharded."""
    keys, ks, vals, cfg = _stride_tree()
    ref = bulk_build(cfg, ks, vals, target="cpu")
    st = S.sharded_build(ks, vals, 4, cfg=cfg, target="cpu")
    starts = [int(K.decode_uint64(sb[None, :8])[0])
              for sb in st.router.split_bytes.numpy()[1:]]
    starts = [s - 2 for s in starts] + [0]
    sks = K.make_keyset(starts, 8)
    M = 150   # > one shard's tail, forces a multi-shard merge
    for eng in ENGINES:
        _assert_scan_parity(ref, st, sks.bytes, sks.lens, M, eng,
                            ("boundary spill", eng.backend))
    # drain to the end: max_items beyond the whole key set
    gk, v, em, _, _ = S.range_scan(st, sks.bytes[-1:], sks.lens[-1:],
                                   max_items=512)
    assert int(em[0]) == len(keys)


def test_scan_spill_into_unhealthy_shard():
    """Degraded-serving contract (DESIGN.md §8): a lane that must continue
    into an unhealthy shard is flagged ``failed`` with a prefix-correct
    emission — never a silently truncated 'complete' result and never a
    stale-snapshot splice; the reference flags the same lanes."""
    keys, ks, vals, cfg = _stride_tree()
    st = S.sharded_build(ks, vals, 4, cfg=cfg, target="cpu")
    fast = RetryPolicy(max_attempts=2, sleep=lambda s: None)
    plan = FaultPlan((FaultSpec("shard.dispatch.range_scan", "drop_shard",
                                shard=1),))
    sbs = st.router.split_bytes.numpy()
    # lane 0 starts 7 below the shard-1 boundary (two shard-0 keys, then
    # the spill into the dropped shard); lane 1 lives inside shard 3
    start0 = int(K.decode_uint64(sbs[1][None, :8])[0]) - 7
    start3 = int(K.decode_uint64(sbs[3][None, :8])[0])
    sks = K.make_keyset([start0, start3], 8)
    M = 40
    out = S.range_scan(st, sks.bytes, sks.lens, max_items=M, faults=plan,
                       retry=fast)
    gk, v, em, _, failed = out
    assert failed.tolist() == [True, False]
    assert st.health.is_ok(1) is False     # retries exhausted -> marked
    gk2, v2, em2, _, f2 = S.range_scan(
        S.sharded_build(ks, vals, 4, cfg=cfg, target="cpu"), sks.bytes,
        sks.lens, max_items=M)
    assert not bool(f2.any()) and int(em2[0]) == M
    n0 = int(em[0])
    assert 0 < n0 < M, n0
    assert torch.equal(gk[0, :n0], gk2[0, :n0])
    assert torch.equal(v[0, :n0], v2[0, :n0])
    assert bool((gk[0, n0:] == EMPTY).all())
    assert int(em[1]) == int(em2[1])
    assert torch.equal(gk[1], gk2[1]) and torch.equal(v[1], v2[1])
    # the reference under the same fault plan
    from repro.core.faults import FaultPlan as RPlan
    from repro.core.faults import FaultSpec as RSpec
    from repro.core.faults import RetryPolicy as RRetry
    rst = RS.sharded_build(RK.KeySet(ks.bytes, ks.lens), vals, 4,
                           cfg=RConfig.plan(max_keys=W8_MAX_KEYS, key_width=8))
    rplan = RPlan((RSpec("shard.dispatch.range_scan", "drop_shard",
                         shard=1),))
    rout = RS.range_scan(rst, sks.bytes, sks.lens, max_items=M, faults=rplan,
                         retry=RRetry(max_attempts=2, sleep=lambda s: None))
    _same_scan(rout, out)
    assert rplan.events == plan.events


def test_scan_clustered_owners():
    """A batch whose owners skip middle shards ({0, 3}) still scans the
    later owners: the loop finds no active lane at shards 1 and 2 but may
    not stop there."""
    keys, ks, vals, cfg = _stride_tree(step=4, top=1600)
    ref = bulk_build(cfg, ks, vals, target="cpu")
    st = S.sharded_build(ks, vals, 4, cfg=cfg, target="cpu")
    last_min = st.router.split_bytes.numpy()[-1]
    qb = np.stack([ks.bytes[0], last_min])
    ql = np.asarray([int(ks.lens[0]), 8], np.int32)
    for eng in ENGINES:
        _assert_scan_parity(ref, st, qb, ql, 20, eng,
                            ("clustered owners", eng.backend))


def test_shard_public_surface():
    """``__all__`` is the reference's, and every name exists."""
    import repro_torch.serving as serving
    import repro_torch.shard as shard
    assert shard.__all__ == RS.__all__
    for name in shard.__all__:
        assert hasattr(shard, name), name
    for name in serving.__all__:
        assert hasattr(serving, name), name
    assert "PrefixCache" in serving.__all__


def test_sharded_prefix_cache_roundtrip():
    """The sharded cache mode (DESIGN.md §7): match / publish / compact
    through the shard layer, hit for hit with the unsharded cache and with
    ``repro.serving.PrefixCache(n_shards=4)``, every shard's arrays, the
    pool and the stats equal to the reference's after each step."""
    rng = np.random.default_rng(0xFB)
    kw = dict(n_pages=256, block_tokens=16, max_keys=4096)
    pc1 = PrefixCache(target="cpu", **kw)
    pc4 = PrefixCache(n_shards=4, target="cpu", **kw)
    rc4 = RPrefixCache(n_shards=4, **kw)
    sysp = rng.integers(0, 500, size=64).astype(np.int32)
    r1 = np.concatenate([sysp, rng.integers(0, 500, 32)]).astype(np.int32)
    r2 = np.concatenate([sysp, rng.integers(0, 500, 32)]).astype(np.int32)

    def same():
        _same_shards(rc4.tree, pc4.tree)
        assert_pools_equal(rc4.pool, pc4.pool)
        assert rc4.stats == pc4.stats

    for pc in (pc1, pc4, rc4):
        hit, _ = pc.match([r1])
        assert hit == [0]
        pc.publish(r1, 0)
        hit, pages = pc.match([r2])
        assert hit == [4] and len(pages[0]) == 4
    same()
    assert pc4.tree.n_shards == 4
    # a small live set is NOT fragmentation: one leaf per shard is the
    # sharded floor, so the evict-time trigger must not thrash compacts
    assert pc4.frag_factor == rc4.frag_factor < pc4.compact_factor
    rep, rrep = pc4.compact(), rc4.compact()
    assert (rep.ok, rep.version, rep.reason) == (rrep.ok, rrep.version,
                                                 rrep.reason)
    assert pc4.stats["rebuilds"] == 1
    assert pc4.frag_factor < pc4.compact_factor
    same()
    hit = pc4.match([r1])
    assert hit == rc4.match([r1]) == pc1.match([r1])
    assert hit[0] == [6]
    same()
    # pressure: many prompts through 256 pages force eviction scans across
    # shards and their removes
    prompts = [rng.integers(0, 500, size=96).astype(np.int32)
               for _ in range(60)]
    for p in prompts:
        a, b = pc4.match([p]), rc4.match([p])
        assert a == b
        x, y = pc4.publish(p, a[0][0]), rc4.publish(p, b[0][0])
        assert (x is None) == (y is None)
        assert x is None or np.array_equal(x, y)
    assert pc4.stats["evicts"] > 0
    same()


def test_four_entry_device_list():
    """A four-entry device list (CPU stand-ins for four cards): one shard
    per entry, round-robin placement, ops equal to the unsharded tree,
    and ``place_shard`` copies."""
    rng = np.random.default_rng(1)
    keys = sorted({int(x) for x in rng.integers(0, 2**62, size=300)})[:256]
    ks = K.make_keyset(keys, 8)
    vals = np.arange(len(keys), dtype=np.int32)
    cfg = TreeConfig.plan(max_keys=1024, key_width=8)
    mesh = S.make_shard_mesh(4, devices=["cpu"] * 4)
    assert mesh == (torch.device("cpu"),) * 4
    assert S.make_shard_mesh(8, devices=["cpu"] * 4) == mesh
    assert S.make_shard_mesh(2, devices=["cpu"] * 4) == mesh[:2]
    assert S.shard_devices(mesh[:2], 4) == mesh
    assert S.make_shard_mesh(4, target="cpu") == (torch.device("cpu"),)
    st = S.sharded_build(ks, vals, 4, cfg=cfg, device=True, mesh=mesh)
    assert st.devices == mesh and st.mesh == mesh
    ref = bulk_build(cfg, ks, vals, target="cpu")
    v_ref, _ = B.lookup_batch(ref, ks.bytes, ks.lens)
    v_sh, rep = S.lookup_batch(st, ks.bytes, ks.lens)
    assert bool(rep.found.all()) and torch.equal(v_ref, v_sh)
    gk, v, em, _, _ = S.range_scan(st, ks.bytes[:4], ks.lens[:4],
                                   max_items=64)
    kr, vr, er, _ = B.range_scan(ref, ks.bytes[:4], ks.lens[:4], max_items=64)
    assert torch.equal(er, em) and torch.equal(vr, v)
    # the device build equals the host build, shard by shard
    host = S.sharded_build(ks, vals, 4, cfg=cfg, mesh=mesh)
    for a, b in zip(st.shards, host.shards):
        assert_arrays_equal(_as_numpy(a), b.arrays)
    placed = S.place_shard(st.shards[0], "cpu")
    assert placed.arrays.leaf_val is not st.shards[0].arrays.leaf_val
    assert_arrays_equal(_as_numpy(placed), st.shards[0].arrays)
    assert S.place_shard(st.shards[0], None) is st.shards[0]


def test_chip_smoke_shard_phase_rehearses_on_the_cpu():
    """``chip_smoke.rehearse_shard``: the card's ``shard`` phase with all of
    its checks but the kernels' (build == device build of each partition
    run, lookups and YCSB-E scans == the unsharded tree, spilled and parked
    lanes, update/remove, degradation under a dropped shard 2, rebalance
    published and == the device build of the live set's partition) at
    6,000 keys, and the sharded cache replaying the serve rehearsal's
    calls on the CPU."""
    import chip_smoke
    out, cache = chip_smoke.rehearse_shard(seed=0)
    assert out["lookup_batches_equal"] == out["lookup_batches"]
    assert out["scans_equal"] == out["scan_rounds"] == 2
    assert out["spilled_lanes"] > 0 and out["parked_lanes_checked"] > 0
    assert out["degraded_lanes"] > 0 and out["insert_failed_lanes"] > 0
    assert out["scan_failed_lanes"] > 0
    assert out["live_found"] == out["n_live"]
    assert max(out["counts_after"]) - min(out["counts_after"]) <= 1
    assert cache["answers_equal"] == cache["calls"] > 0
    assert cache["diffs"] == [] and cache["stats_equal"]
    assert cache["evicts"] > 0
