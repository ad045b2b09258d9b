"""The port's range scan against the reference's, bit for bit.

Mirrors ``tests/test_scan.py``: every scan route of the port — the plain
chain walk under the ``"torch"`` engine in both layouts, the always-sort
baseline, and the ``"fused"`` scan backend (on the CPU, its plain version)
— emits the reference's ``(key_id, value)`` pairs, ``emitted`` and
``rearranged`` exactly, on ordered trees and on trees dirtied by the
reference's ``insert_batch`` (lazily rearranged leaves), at ns=64 and
ns=128; the reference's fused Pallas scan (interpret mode) agrees too. The
early-exit walk drains short chains, ``rearranged`` counts exactly the
dirty leaves visited, and the registry exposes the ``"fused"`` scan.

Every tree but the url one has the config of
``tests/test_torch_mutations.py`` (key width 24) and every batch the same
lanes, so the reference compiles each op once per ns; the url tree (width
72) is scanned clean, as a reference insert round at that width takes
longer to compile than this file's budget.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import obs as robs
from repro.core import batch_ops as RB
from repro.core import keys as RK
from repro.core.fbtree import EMPTY
from repro.core.fbtree import TreeConfig as RConfig
from repro.core.fbtree import bulk_build as r_bulk_build
from repro.core.traverse import TraversalEngine as REngine
from repro_torch import obs as pobs
from repro_torch.core import batch_ops as PB
from repro_torch.core.traverse import (TraversalEngine, available_backends,
                                       get_scan_backend)
from repro_torch.kernels.fused_scan import ops as p_ops
from repro_torch.kernels.fused_scan.ref import fused_range_scan_ref

from benchmarks.common import make_dataset
from test_torch_mutations import BATCH, KW, config, to_port
from test_torch_tie_keys import tie_scan_tree

OUT = ("kid", "val", "emitted", "rearranged")
PORT_ENGINES = (("torch", "tuple"), ("torch", "stacked"), ("fused", None))
# (dataset, dirty, seed, ns)
CASES = (("rand-int", True, 11, 64), ("ycsb", False, 12, 64),
         ("ycsb", True, 13, 64), ("url", False, 14, 64),
         ("rand-int", True, 15, 128))
N_KEYS, N_Q, M = 400, 24, 32


def build(keys, ns=64, width=KW):
    cfg = config(ns)
    if width != KW:
        cfg = RConfig.plan(max_keys=cfg.key_cap, key_width=width, ns=ns)
    rt = r_bulk_build(cfg, RK.make_keyset(keys, width),
                      np.arange(len(keys), dtype=np.int32))
    return rt, to_port(rt)


def starts(keys):
    """``N_Q`` scan starts (the keys repeated to fill the batch)."""
    return RK.make_keyset([keys[i % len(keys)] for i in range(N_Q)], KW)


@functools.lru_cache(maxsize=None)
def churned(ds, dirty, seed, ns):
    """Reference tree (in-place inserts of ``BATCH`` fresh keys clear
    ``leaf_ordered`` on the leaves they land in when ``dirty``), its port
    copy, and ``N_Q`` starts, a third of them between keys."""
    keys, width = make_dataset(ds, N_KEYS, seed=seed)
    rt, _ = build(keys, ns, max(width, KW))
    if dirty:
        have = set(keys)
        extra, _ = make_dataset(ds, 2 * BATCH, seed=seed + 1)
        extra = [k for k in extra if k not in have][:BATCH]
        eks = RK.make_keyset(extra, KW)
        rt, _, _ = RB.insert_batch(rt, eks.bytes, eks.lens,
                                   np.arange(BATCH, dtype=np.int32)
                                   + 10 * N_KEYS)
    pt = to_port(rt)
    a = pt.arrays
    occ = a.leaf_occ
    assert bool((~a.leaf_ordered[:int(a.leaf_count)]).any()) == dirty
    rng = np.random.default_rng(seed)
    kid = a.leaf_keyid[occ].numpy()[rng.integers(0, int(occ.sum()), N_Q)]
    qb, ql = a.key_bytes.numpy()[kid].copy(), a.key_lens.numpy()[kid].copy()
    qb[rng.random(N_Q) < 0.33, -1] ^= 0xA5
    return rt, pt, qb, ql


def ref_scan(rt, qb, ql, max_items=M, backend="jnp", stats=True):
    return jax.device_get(RB.range_scan(
        rt, jnp.asarray(qb), jnp.asarray(ql), max_items=max_items,
        engine=REngine(backend, collect_stats=stats)))


def assert_scan_equal(got, want, where):
    for g, w, name in zip(got, want, OUT):
        w = np.asarray(w)
        assert g.dtype == torch.int32 and tuple(g.shape) == w.shape, \
            (where, name)
        assert np.array_equal(g.numpy(), w), (where, name)


def _oracle(pt, qb_row, ql_row, max_items):
    """The first ``max_items`` live (kid, value) pairs >= the start."""
    a = pt.arrays
    occ = a.leaf_occ.numpy()
    kid = a.leaf_keyid.numpy()[occ]
    val = a.leaf_val.numpy()[occ]
    keys = [(a.key_bytes.numpy()[k].tobytes(), int(a.key_lens.numpy()[k]))
            for k in kid]
    q = (qb_row.tobytes(), int(ql_row))
    order = sorted((k, i) for i, k in enumerate(keys) if k >= q)[:max_items]
    idx = [i for _, i in order]
    return kid[idx], val[idx]


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"{c[0]}-{'dirty' if c[1] else 'clean'}-ns{c[3]}")
def test_scan_backend_parity(case):
    """Port engines × layouts, stats on and off, against the reference's jnp
    walk (and its fused Pallas scan on one case); pairs ascending from the
    first key >= the start, EMPTY past ``emitted``."""
    rt, pt, qb, ql = churned(*case)
    want = ref_scan(rt, qb, ql)
    for backend, layout in PORT_ENGINES:
        for stats in (True, False):
            got = PB.range_scan(pt, qb, ql, max_items=M,
                                engine=TraversalEngine(backend, layout, stats))
            w = want if stats else want[:3] + (np.zeros_like(want[3]),)
            assert_scan_equal(got, w, (backend, layout, stats))
    for i in range(qb.shape[0]):
        ek, ev = _oracle(pt, qb[i], ql[i], M)
        n = int(want[2][i])
        assert n == len(ek) and (want[0][i, :n] == ek).all()
        assert (want[1][i, :n] == ev).all() and (want[0][i, n:] == EMPTY).all()
    assert (int(want[3].sum()) > 0) == case[1]
    if case[0] == "ycsb":
        assert_scan_equal(PB.range_scan(pt, qb, ql, max_items=M,
                                        engine=TraversalEngine("fused")),
                          ref_scan(rt, qb, ql, backend="fused"), "pallas")


_jnp_scan = jax.jit(RB._range_scan_jnp,
                    static_argnames=("max_items", "eng", "force_sort"))


@pytest.mark.parametrize("case", CASES[2::2], ids=lambda c: f"{c[0]}-ns{c[3]}")
def test_scan_always_sort_bit_identical(case):
    """The lazy-rearrangement fast path changes nothing observable: the
    always-sort baseline (``force_sort=True``) emits bit-identical pairs,
    and equals the reference's always-sort walk."""
    rt, pt, qb, ql = churned(*case)
    fast = PB.range_scan(pt, qb, ql, max_items=M)
    slow = PB._range_scan_torch(pt, torch.from_numpy(qb), torch.from_numpy(ql),
                                M, TraversalEngine("torch"), force_sort=True)
    ref = jax.device_get(_jnp_scan(rt, jnp.asarray(qb), jnp.asarray(ql),
                                   max_items=M, eng=REngine("jnp"),
                                   force_sort=True))
    for f, s_, r, name in zip(fast, slow, ref, OUT):
        assert torch.equal(f, s_), name
        assert np.array_equal(s_.numpy(), np.asarray(r)), name


def test_scan_drains_short_chains():
    """After tombstoning most keys (the same removes on both packages), a
    ``max_items`` larger than the live set drains the whole chain."""
    rng = np.random.default_rng(7)
    ints = rng.choice(2**31, size=4 * BATCH + 20, replace=False)
    keys = [int(x) for x in ints]
    rt, pt = build(keys)
    for lo in range(0, 4 * BATCH, BATCH):
        rm = RK.make_keyset(keys[lo:lo + BATCH], KW)
        rt, _ = RB.remove_batch(rt, rm.bytes, rm.lens)
        pt, _ = PB.remove_batch(pt, rm.bytes, rm.lens)
    live = np.sort(ints[4 * BATCH:].astype(np.uint64))
    s0 = starts([int(live[0])])
    want = ref_scan(rt, s0.bytes, s0.lens)
    for backend in ("torch", "fused"):
        got = PB.range_scan(pt, s0.bytes, s0.lens, max_items=M,
                            engine=TraversalEngine(backend))
        assert_scan_equal(got, want, backend)
        assert int(got[2][0]) == len(live) < M
        kb = pt.arrays.key_bytes.numpy()[got[0][0, :len(live)].numpy()]
        assert (RK.decode_uint64(kb[:, :8]) == live).all()


def test_scan_rearranged_accounting():
    """``rearranged`` counts the dirty leaves a lane visited across all
    hops, is zero on a fresh build and under a stats-free engine, and
    equals the reference's."""
    keys = [int(x) for x in range(0, 4000, 4)]
    rt, pt = build(keys)
    s = starts([300])                   # leaf 1; 32 items reach leaf 2
    _, _, em, rearr = PB.range_scan(pt, s.bytes, s.lens, max_items=M)
    assert int(em[0]) == M and int(rearr.abs().sum()) == 0

    # dirty leaf 2 with one in-place insert (the other lanes are masked)
    ins = RK.make_keyset([401] * BATCH, KW)
    vals = np.full(BATCH, 9999, np.int32)
    mask = np.arange(BATCH) == BATCH - 1      # the dedupe winner
    rt, _, _ = RB.insert_batch(rt, ins.bytes, ins.lens, vals,
                               mask=jnp.asarray(mask))
    pt, _, _ = PB.insert_batch(pt, ins.bytes, ins.lens, vals, mask=mask)
    a = pt.arrays
    assert int((~a.leaf_ordered[:int(a.leaf_count)]).sum()) == 1
    for start, billed in ((s, 1), (starts([2000]), 0)):
        want = ref_scan(rt, start.bytes, start.lens)
        for backend in ("torch", "fused"):
            got = PB.range_scan(pt, start.bytes, start.lens, max_items=M,
                                engine=TraversalEngine(backend))
            assert_scan_equal(got, want, backend)
            assert int(got[3][0]) == billed    # billed on a later hop
            off = PB.range_scan(pt, start.bytes, start.lens, max_items=M,
                                engine=TraversalEngine(backend,
                                                       collect_stats=False))
            assert torch.equal(off[2], got[2])
            assert int(off[3].abs().sum()) == 0


def test_scan_registry():
    """``fused`` exposes a whole-scan entry (lazily loaded), ``torch`` falls
    back to the plain walk, and the kernel entry, called outside the engine
    dispatch, matches its plain version and the reference's scan."""
    assert callable(get_scan_backend("fused"))
    assert TraversalEngine("fused").scan_path() is p_ops.fused_range_scan
    assert TraversalEngine("torch").scan_path() is None
    assert TraversalEngine("cuda").scan_path() is None
    assert set(available_backends()) == {"torch", "cuda", "binary",
                                         "binary+prefix", "fused"}
    with pytest.raises(KeyError):
        get_scan_backend("no-such-scan-backend")
    rt, pt, qb, ql = churned(*CASES[2])
    qb_t, ql_t = torch.from_numpy(qb), torch.from_numpy(ql)
    n0 = p_ops.LAUNCHES
    got = p_ops.fused_range_scan(pt, qb_t, ql_t, max_items=M)
    assert p_ops.LAUNCHES == n0          # a CPU tree takes the plain version
    for g, w in zip(got, fused_range_scan_ref(pt, qb_t, ql_t, max_items=M)):
        assert torch.equal(g, w)
    assert_scan_equal(got, ref_scan(rt, qb, ql), "kernel entry")


def test_scan_rejects_bad_max_items_and_drains_obs():
    rt, pt, qb, ql = churned(*CASES[2])
    with pytest.raises(ValueError, match="max_items"):
        PB.range_scan(pt, qb, ql, max_items=0)
    robs.disable(), robs.reset(), pobs.disable(), pobs.reset()
    try:
        robs.enable(), pobs.enable()
        RB.range_scan(rt, jnp.asarray(qb), jnp.asarray(ql), max_items=M)
        PB.range_scan(pt, qb, ql, max_items=M,
                      engine=TraversalEngine("fused"))
        counts = [{(m.name, m.labels): m.value for m in o.all_metrics()
                   if m.kind == "counter"} for o in (robs, pobs)]
        assert counts[0] == counts[1]
        assert counts[1][("op.rearranged", (("op", "scan"),))] > 0
        assert pobs.get_metric("span.op.scan").count == 1
    finally:
        robs.disable(), robs.reset(), pobs.disable(), pobs.reset()


def to_reference(pt):
    """The reference's copy of a port tree (numpy in between)."""
    from repro.core import fbtree as RF
    a = pt.arrays
    arr = lambda t: jnp.asarray(t.numpy())
    level = lambda lv: RF.Level(*(arr(getattr(lv, f)) for f in RF.Level._fields))
    fields = {f: (tuple(level(lv) for lv in a.levels) if f == "levels" else
                  level(a.stacked) if f == "stacked" else arr(getattr(a, f)))
              for f in RF.TreeArrays._fields}
    cfg = dict(dataclasses.asdict(pt.config), val_dtype=jnp.int32)
    return RF.FBTree(RF.TreeConfig(**cfg), RF.TreeArrays(**fields))


@pytest.mark.parametrize("ns,width", ((64, 21), (128, 28)))
def test_scan_tie_keys_match_reference_fused(ns, width):
    """Keys that packed words can get wrong (``tie_keys``: twins
    with equal padded bytes and lengths that differ, ties on the first 4, 8
    and 16 bytes, 0x00/0xFF at word boundaries, a width that is no multiple
    of 8), dirtied by the port's own inserts: the port's scan (the plain
    version of the fused scan on the CPU) equals the reference's fused
    Pallas scan (interpret mode) bit for bit, and a sorted oracle."""
    pt, qb, ql, twins = tie_scan_tree(width, ns, seed=ns + width,
                                      device="cpu")
    assert twins > 0                    # dirty leaves hold twin pairs
    rt = to_reference(pt)
    qbn, qln = qb.numpy(), ql.numpy()
    want = ref_scan(rt, qbn, qln, backend="fused")
    got = PB.range_scan(pt, qb, ql, max_items=M,
                        engine=TraversalEngine("fused"))
    assert_scan_equal(got, want, ("tie", ns, width))
    assert int(want[3].sum()) > 0       # dirty leaves were ranked
    for i in range(0, qbn.shape[0], 17):
        ek, ev = _oracle(pt, qbn[i], qln[i], M)
        n = int(want[2][i])
        assert n == len(ek) and (want[0][i, :n] == ek).all()
        assert (want[1][i, :n] == ev).all()
