"""The port's mutations against the reference's, bit for bit.

Mirrors ``tests/test_tree_ops.py`` (mixed ops against a dict oracle,
monotone append, range scan against a sorted oracle, version semantics,
capacity errors): the same op sequence runs on a reference tree and on its
port copy (``tree_from_numpy``), and after every op each ``TreeArrays``
field (levels, stacked copy and scratch rows included), each ``OpReport``
field and the insert round count must be equal in dtype, shape and value.
Masked lanes (the routed-op hook) are covered, at ns=64 and ns=128. The
shared helpers of the insert path (dedupe, row sort, segment ranks, inner
metadata, free slots) are held against the reference's on their own.

Every insert, update and remove batch has 128 lanes and every tree one
config per ns (``config``, shared with ``tests/test_torch_scan.py``), so
the reference compiles each op once per ns.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import obs as robs
from repro.core import batch_ops as RB
from repro.core import keys as RK
from repro.core.fbtree import TreeConfig as RConfig
from repro.core.fbtree import bulk_build as r_bulk_build
from repro.core.fbtree import recompute_inner_meta as r_meta
from repro.core.leaf import find_free_slots as r_free
from repro_torch import obs as pobs
from repro_torch.core import batch_ops as PB
from repro_torch.core.convert import tree_from_numpy
from repro_torch.core.fbtree import recompute_inner_meta as p_meta
from repro_torch.core.leaf import find_free_slots as p_free
from repro_torch.core.traverse import TraversalEngine

from test_torch_tree import assert_arrays_equal

KW = 24              # ycsb and int keys fit; one config per ns
CAP = 4096
BATCH = 128
UNIVERSE = [bytes([a, b]) for a in range(16, 48) for b in range(4)]
ENGINES = (TraversalEngine("torch"), TraversalEngine("fused"))


def to_port(rt):
    """The port's copy of a reference tree, on the CPU."""
    host = jax.device_get(rt.arrays)
    arrays = host._asdict()
    arrays["levels"] = [lv._asdict() for lv in host.levels]
    arrays["stacked"] = host.stacked._asdict()
    return tree_from_numpy(dataclasses.asdict(rt.config), arrays, target="cpu")


def assert_reports_equal(rrep, prep, where=""):
    rrep = jax.device_get(rrep)
    for f in rrep._fields:
        r, p = np.asarray(getattr(rrep, f)), getattr(prep, f).numpy()
        assert r.dtype == p.dtype and r.shape == p.shape, (where, f)
        assert np.array_equal(r, p), (where, f)


def config(ns=64):
    return RConfig.plan(max_keys=CAP, key_width=KW, ns=ns)


def build_both(keys, vals, ns=64):
    rt = r_bulk_build(config(ns), RK.make_keyset(keys, KW),
                      np.asarray(vals, np.int32))
    return rt, to_port(rt)


def both_ops(rt, pt, op, keys, vals=None, mask=None, engine=None):
    """Run one batched op on both packages; compare trees and reports."""
    ks = RK.make_keyset(keys, KW)
    rmask = None if mask is None else jnp.asarray(mask)
    if op == "insert":
        rt, rrep, rr = RB.insert_batch(rt, ks.bytes, ks.lens, vals, mask=rmask)
        pt, prep, pr = PB.insert_batch(pt, ks.bytes, ks.lens, vals,
                                       mask=mask, engine=engine)
        assert rr == pr, ("rounds", rr, pr)
    elif op == "update":
        rt, rrep = RB.update_batch(rt, ks.bytes, ks.lens, vals, mask=rmask)
        pt, prep = PB.update_batch(pt, ks.bytes, ks.lens, vals, mask=mask,
                                   engine=engine)
    else:
        rt, rrep = RB.remove_batch(rt, ks.bytes, ks.lens, mask=rmask)
        pt, prep = PB.remove_batch(pt, ks.bytes, ks.lens, mask=mask,
                                   engine=engine)
    assert_arrays_equal(rt.arrays, pt.arrays)
    assert_reports_equal(rrep, prep, op)
    return rt, pt, prep


def lookup_all(pt, keys, engine=None):
    ks = RK.make_keyset(keys, KW)
    vals, rep = PB.lookup_batch(pt, ks.bytes, ks.lens, engine=engine)
    return vals.numpy(), rep.found.numpy()


@pytest.mark.parametrize("ns,seed", ((64, 0), (64, 1), (64, 2), (128, 3),
                                     (128, 4)))
def test_mixed_ops_match_reference_and_oracle(ns, seed):
    rng = np.random.default_rng(seed)
    init = sorted({UNIVERSE[i] for i in rng.integers(0, len(UNIVERSE),
                                                     rng.integers(4, 41))})
    oracle = {k: i for i, k in enumerate(init)}
    rt, pt = build_both(init, list(oracle.values()), ns=ns)
    for step, op in enumerate(("insert", "update", "remove", "insert",
                               "remove")):
        batch = [UNIVERSE[i] for i in rng.integers(0, len(UNIVERSE), BATCH)]
        vals = np.arange(BATCH, dtype=np.int32) + 1000 * (step + 1)
        mask = (rng.random(BATCH) < 0.75) if step % 2 else None
        engine = ENGINES[step % 2]
        rt, pt, _ = both_ops(rt, pt, op, batch, vals, mask, engine)
        on = np.ones(BATCH, bool) if mask is None else mask
        last = {k: i for i, k in enumerate(batch)}
        for k, i in last.items():   # the last lane of a key wins the dedupe
            if not on[i]:           # and writes only if its mask is set
                continue
            if op == "insert":
                oracle[k] = int(vals[i])
            elif op == "update" and k in oracle:
                oracle[k] = int(vals[i])
            elif op == "remove":
                oracle.pop(k, None)
        got, found = lookup_all(pt, UNIVERSE, engine)
        for i, k in enumerate(UNIVERSE):
            assert found[i] == (k in oracle), (op, k)
            if k in oracle:
                assert got[i] == oracle[k], (op, k)


@pytest.mark.parametrize("ns", (64, 128))
def test_insert_monotone_append(ns):
    """Monotone appends funnel every batch into the rightmost leaf: leaf
    splits over several rounds and inner-node inserts."""
    keys = [int(x) for x in range(0, 2 * (100 + 3 * BATCH), 2)]
    rt, pt = build_both(keys[:100], np.arange(100), ns=ns)
    knum0 = int(pt.arrays.levels[-1].knum[0])
    splits = 0
    for i in range(3):
        lo = 100 + i * BATCH
        rt, pt, rep = both_ops(rt, pt, "insert", keys[lo:lo + BATCH],
                               np.arange(lo, lo + BATCH, dtype=np.int32),
                               engine=ENGINES[i % 2])
        splits += int(rep.splits)
    assert splits > 0
    assert int(pt.arrays.levels[-1].knum[0]) > knum0     # inner inserts
    got, found = lookup_all(pt, keys)
    assert found.all() and (got == np.arange(len(keys))).all()


def test_range_scan_vs_sorted():
    rng = np.random.default_rng(0xFB)
    ints = rng.choice(2**32, size=800, replace=False)
    rt, pt = build_both([int(x) for x in ints], np.arange(800))
    srt = np.sort(ints.astype(np.uint64))
    at = np.array([0, 100, 700, 795] * 6)
    starts = RK.make_keyset([int(x) for x in srt[at]], KW)
    want = jax.device_get(RB.range_scan(rt, starts.bytes, starts.lens,
                                        max_items=32))
    kb = pt.arrays.key_bytes.numpy()
    for eng in ENGINES:
        got = PB.range_scan(pt, starts.bytes, starts.lens, max_items=32,
                            engine=eng)
        for g, w in zip(got, want):
            assert g.dtype == torch.int32 and np.array_equal(g.numpy(), w)
        kid, _, emitted, _ = got
        for i, s in enumerate(srt[at]):
            expect = srt[srt >= s][:32]
            n = int(emitted[i])
            assert n == len(expect)
            assert (RK.decode_uint64(kb[kid[i, :n].numpy()][:, :8])
                    == expect).all()


def test_version_semantics():
    """Insert/remove bump leaf versions; update does not (paper §4.2)."""
    keys = [int(x) for x in range(200)]
    rt, pt = build_both(keys, np.arange(200))
    v0 = pt.arrays.leaf_version.clone()
    rt, pt2, _ = both_ops(rt, pt, "update", keys[:BATCH],
                          np.arange(BATCH, dtype=np.int32))
    assert torch.equal(pt2.arrays.leaf_version, v0)
    rt, pt3, _ = both_ops(rt, pt2, "remove", keys[:BATCH])
    assert int(pt3.arrays.leaf_version.sum()) > int(v0.sum())
    # ops return new trees and leave their inputs unchanged
    assert torch.equal(pt.arrays.leaf_version, v0)
    assert bool(pt2.arrays.leaf_occ.sum() > pt3.arrays.leaf_occ.sum())


def test_capacity_error_raises():
    keys = [int(x) for x in range(60)]
    ks = RK.make_keyset(keys, KW)
    cfg = RConfig.plan(max_keys=64, key_width=KW)
    rt = r_bulk_build(cfg, ks, np.arange(60, dtype=np.int32))
    pt = to_port(rt)
    big = RK.make_keyset([int(x) for x in range(100, 400)], KW)
    vals = np.arange(300, dtype=np.int32)
    with pytest.raises(RuntimeError):
        RB.insert_batch(rt, big.bytes, big.lens, vals)
    with pytest.raises(RuntimeError, match="key pool"):
        PB.insert_batch(pt, big.bytes, big.lens, vals)


def test_leaf_capacity_error_raises_without_an_index_fault():
    """A split past leaf_cap: the new leaf ids run past the table, which the
    reference drops and the port clamps to the scratch row, and the round
    raises the reference's RuntimeError instead of an index error."""
    keys = [int(x) for x in range(0, 120, 2)]
    ks = RK.make_keyset(keys, KW)
    cfg = dataclasses.replace(config(), leaf_cap=2)
    pt = to_port(r_bulk_build(cfg, ks, np.arange(60, dtype=np.int32)))
    more = RK.make_keyset([int(x) for x in range(1, 400, 2)], KW)
    with pytest.raises(RuntimeError, match="capacity violated"):
        PB.insert_batch(pt, more.bytes, more.lens,
                        np.arange(200, dtype=np.int32))


def test_insert_obs_counters_match_reference():
    keys = [int(x) for x in range(0, 400, 4)]
    rt, pt = build_both(keys, np.arange(100))
    ins = RK.make_keyset([int(x) for x in range(1, 2 * BATCH, 2)], KW)
    vals = np.arange(BATCH, dtype=np.int32)
    robs.disable(), robs.reset(), pobs.disable(), pobs.reset()
    try:
        robs.enable(), pobs.enable()
        RB.insert_batch(rt, ins.bytes, ins.lens, vals)
        PB.insert_batch(pt, ins.bytes, ins.lens, vals)
        counts = [{(m.name, m.labels): m.value for m in o.all_metrics()
                   if m.kind == "counter"} for o in (robs, pobs)]
        assert counts[0] == counts[1]
        assert counts[1][("op.rounds", (("op", "insert"),))] >= 1
        assert pobs.get_metric("span.op.insert").count == 1
    finally:
        robs.disable(), robs.reset(), pobs.disable(), pobs.reset()


# ------------------------------------------------- helpers of the insert path

def _key_batch(seed, n=96, width=12):
    rng = np.random.default_rng(seed)
    kb = rng.integers(0, 4, size=(n, width)).astype(np.uint8)
    kl = rng.integers(1, width + 1, size=n).astype(np.int32)
    kb[np.arange(width)[None, :] >= kl[:, None]] = 0
    return kb, kl


@pytest.mark.parametrize("seed", (0, 1))
def test_dedupe_and_row_sort_match_reference(seed):
    kb, kl = _key_batch(seed)
    seq = np.arange(len(kl), dtype=np.int32)
    rw, rc = jax.jit(RB.dedupe_last_wins)(kb, kl, seq)
    pw, pc = PB.dedupe_last_wins(torch.from_numpy(kb), torch.from_numpy(kl),
                                 torch.from_numpy(seq))
    assert np.array_equal(np.asarray(rw), pw.numpy())
    assert pc.dtype == torch.int32 and int(pc) == int(rc) > 0
    valid = np.random.default_rng(seed).random((4, 24)) < 0.7
    rows = (kb[:96].reshape(4, 24, 12), kl[:96].reshape(4, 24), valid)
    rp = jax.jit(RB.rowwise_lex_argsort)(*rows)
    pp = PB.rowwise_lex_argsort(*(torch.from_numpy(x) for x in rows))
    assert np.array_equal(np.asarray(rp), pp.numpy())
    ids = np.sort(np.random.default_rng(seed).integers(0, 9, 40)).astype(
        np.int32)
    rh, rr = jax.jit(RB._seg_head_rank)(ids)
    ph, pr = PB._seg_head_rank(torch.from_numpy(ids))
    assert pr.dtype == torch.int32
    assert np.array_equal(np.asarray(rh), ph.numpy())
    assert np.array_equal(np.asarray(rr), pr.numpy())


@pytest.mark.parametrize("fs", (2, 4))
def test_recompute_inner_meta_and_free_slots_match_reference(fs):
    kb, kl = _key_batch(fs, n=200)
    kb[:, :3] = 7                                   # shared prefix
    rng = np.random.default_rng(fs)
    anchors = rng.integers(-1, 200, size=(6, 16)).astype(np.int32)
    knum = np.array([0, 1, 2, 9, 16, 16], np.int32)
    want = jax.jit(r_meta, static_argnums=4)(kb, kl, anchors, knum, fs)
    got = p_meta(torch.from_numpy(kb), torch.from_numpy(kl),
                 torch.from_numpy(anchors), torch.from_numpy(knum), fs)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.numpy().dtype == w.dtype and np.array_equal(g.numpy(), w)
    for count in (0, 3, 64):
        occ = rng.random(64) < 0.6
        w = np.asarray(jax.jit(r_free)(occ, np.int32(count)))
        g = p_free(torch.from_numpy(occ), count).numpy()
        assert g.dtype == w.dtype and np.array_equal(g, w)
