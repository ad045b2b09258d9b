"""The port's device build, rebuild and shard partition against the
reference's, bit for bit, on the CPU.

Mirrors ``tests/test_tree_ops.py::test_device_build_equals_host`` and
``test_rebuild_then_traverse``, ``tests/test_traverse_parity.py``'s
device-built and rebuilt trees, and
``tests/test_shard_tree.py::test_sharded_partition_invariants``: the
packed-word device sort equals the reference's ``lex_sort_indices_j``;
``bulk_build(device=True)`` equals the reference's host and device builds
in every ``TreeArrays`` field; after the same insert and remove sequences
``gather_live_sorted``, ``rebuild`` and its ``BuildReport`` equal the
reference's, and the rebuilt tree answers every engine alike.
"""
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
from repro.core.fbtree import sharded_partition as r_partition
from repro_torch import obs as pobs
from repro_torch.core import batch_ops as PB
from repro_torch.core import fbtree as PF
from repro_torch.core.keys import KeySet, lex_sort_indices_t
from repro_torch.core.traverse import TraversalEngine

from benchmarks.common import make_dataset
from test_torch_mutations import (BATCH, UNIVERSE, both_ops, build_both,
                                  lookup_all)
from test_torch_tree import assert_arrays_equal

DATASETS = ("rand-int", "ycsb", "url")


def _keyset(ds, n, seed):
    keys, width = make_dataset(ds, n, seed=seed)
    return RK.make_keyset(keys, width), width


@pytest.mark.parametrize("with_invalid", (False, True),
                         ids=("all-valid", "invalid"))
@pytest.mark.parametrize("ds", DATASETS)
def test_lex_sort_indices_t_matches_reference(ds, with_invalid):
    """The same permutation as ``jnp.lexsort`` over packed words, repeated
    rows included (equal rows keep their input order)."""
    ks, _ = _keyset(ds, 400, seed=3)
    rng = np.random.default_rng(4)
    rows = rng.integers(0, ks.n, size=600)         # repeats on purpose
    kb, kl = ks.bytes[rows], ks.lens[rows]
    invalid = rng.random(600) < 0.3 if with_invalid else None
    want = RK.lex_sort_indices_j(
        jnp.asarray(kb), jnp.asarray(kl),
        invalid=None if invalid is None else jnp.asarray(invalid))
    got = lex_sort_indices_t(
        torch.from_numpy(kb), torch.from_numpy(kl),
        invalid=None if invalid is None else torch.from_numpy(invalid))
    assert got.dtype == torch.int64
    assert np.array_equal(got.numpy(), np.asarray(want))
    if invalid is None:
        assert np.array_equal(got.numpy(), RK.lex_sort_indices(
            RK.KeySet(kb, kl)))


@pytest.mark.parametrize("ns", (64, 128))
@pytest.mark.parametrize("fs", (2, 4))
@pytest.mark.parametrize("ds", DATASETS)
def test_device_build_matches_reference(ds, fs, ns):
    ks, width = _keyset(ds, 500, seed=21)
    vals = np.arange(ks.n, dtype=np.int32)[::-1].copy()
    rcfg = RConfig.plan(max_keys=2 * ks.n, key_width=width, fs=fs, ns=ns)
    pcfg = PF.TreeConfig.plan(max_keys=2 * ks.n, key_width=width, fs=fs,
                              ns=ns)
    pt = PF.bulk_build(pcfg, KeySet(ks.bytes, ks.lens), vals, device=True,
                       target="cpu")
    assert_arrays_equal(r_bulk_build(rcfg, ks, vals).arrays, pt.arrays)
    assert_arrays_equal(r_bulk_build(rcfg, ks, vals, device=True).arrays,
                        pt.arrays)
    for got, want in zip(pt.arrays.stacked, PF.stack_levels(pt.arrays.levels)):
        assert torch.equal(got, want)


@pytest.mark.parametrize("n", (1, 2, 9, 300))
@pytest.mark.parametrize("fs", (2, 4))
def test_device_build_small_sets_equal_host(n, fs):
    """Under-full trees: single-child chain levels above a few leaves."""
    rng = np.random.default_rng(n * fs)
    keys = sorted({bytes(rng.integers(0, 256, size=int(rng.integers(1, 9)),
                                      dtype=np.uint8)) for _ in range(n)})
    ks = RK.make_keyset(keys, 8)
    vals = np.arange(len(keys), dtype=np.int32)
    rcfg = RConfig.plan(max_keys=max(64, 2 * len(keys)), key_width=8, fs=fs)
    pcfg = PF.TreeConfig.plan(max_keys=max(64, 2 * len(keys)), key_width=8,
                              fs=fs)
    pt = PF.bulk_build(pcfg, KeySet(ks.bytes, ks.lens), vals, device=True,
                       target="cpu")
    assert_arrays_equal(r_bulk_build(rcfg, ks, vals).arrays, pt.arrays)


def _churn(ns, seed):
    """Reference and port trees after the same inserts (with splits) and
    removes, and the dict oracle of the live keys."""
    rng = np.random.default_rng(seed)
    init = sorted({UNIVERSE[i] for i in rng.integers(0, len(UNIVERSE), 30)})
    oracle = {k: i for i, k in enumerate(init)}
    rt, pt = build_both(init, list(oracle.values()), ns=ns)
    for step, op in enumerate(("insert", "remove", "insert", "remove")):
        batch = [UNIVERSE[i] for i in rng.integers(0, len(UNIVERSE), BATCH)]
        vals = np.arange(BATCH, dtype=np.int32) + 1000 * (step + 1)
        rt, pt, _ = both_ops(rt, pt, op, batch, vals)
        for k, i in {k: i for i, k in enumerate(batch)}.items():
            if op == "insert":
                oracle[k] = int(vals[i])
            else:
                oracle.pop(k, None)
    return rt, pt, oracle


@pytest.mark.parametrize("ns,seed", ((64, 0), (64, 1), (128, 2)))
def test_rebuild_matches_reference_and_oracle(ns, seed):
    rt, pt, oracle = _churn(ns, seed)
    want = RB.gather_live_sorted(rt)
    got = PB.gather_live_sorted(pt)
    for w, g in zip(want, got):
        w = np.asarray(w)
        assert w.dtype == g.numpy().dtype and np.array_equal(w, g.numpy())

    rt2, rrep = RB.rebuild(rt)
    pt2, prep = PB.rebuild(pt)
    assert_arrays_equal(rt2.arrays, pt2.arrays)
    rrep = jax.device_get(rrep)
    for f in rrep._fields:
        r, p = np.asarray(getattr(rrep, f)), getattr(prep, f).numpy()
        assert r.dtype == p.dtype and r.shape == p.shape == (), f
        assert np.array_equal(r, p), f
    assert int(prep.n_live) == len(oracle) and not bool(prep.error)
    assert int(prep.reclaimed) > 0
    assert (pt2.arrays.leaf_version == 0).all()

    # the rebuilt tree IS the bulk-built tree of the live set
    live = sorted(oracle)
    ks = RK.make_keyset(live, pt.config.key_width)
    fresh = PF.bulk_build(pt.config, KeySet(ks.bytes, ks.lens),
                          np.asarray([oracle[k] for k in live], np.int32),
                          target="cpu")
    assert_arrays_equal(rt2.arrays, fresh.arrays)

    # every engine reads it alike, and as the oracle says
    ref = None
    for eng in (TraversalEngine("torch"), TraversalEngine("cuda", "stacked"),
                TraversalEngine("binary", "tuple"), TraversalEngine("fused")):
        got_v, found = lookup_all(pt2, UNIVERSE, eng)
        if ref is None:
            ref = (got_v, found)
            for i, k in enumerate(UNIVERSE):
                assert found[i] == (k in oracle), k
                if k in oracle:
                    assert got_v[i] == oracle[k], k
        assert np.array_equal(got_v, ref[0]) and np.array_equal(found, ref[1])


def test_rebuild_drains_obs_like_reference():
    rt, pt, _ = _churn(64, 5)
    robs.disable(), robs.reset(), pobs.disable(), pobs.reset()
    try:
        robs.enable(), pobs.enable()
        RB.rebuild(rt)
        PB.rebuild(pt)
        counts = [{(m.name, m.labels): m.value for m in o.all_metrics()
                   if m.kind == "counter"} for o in (robs, pobs)]
        assert counts[0] == counts[1]
        assert counts[1][("build.reclaimed", (("op", "rebuild"),))] > 0
        assert pobs.get_metric("span.op.rebuild").count == 1
    finally:
        robs.disable(), robs.reset(), pobs.disable(), pobs.reset()


@pytest.mark.parametrize("presorted", (False, True))
@pytest.mark.parametrize("n_shards", (1, 3, 4))
def test_sharded_partition_matches_reference(n_shards, presorted):
    """Balanced contiguous runs and split keys equal the reference's; the
    runs concatenate back to the sorted key set."""
    rng = np.random.default_rng(11)
    keys = sorted({int(x) for x in rng.integers(0, 2**62, size=200)})
    ks = RK.make_keyset(keys, 8)
    vals = np.arange(len(keys), dtype=np.int32)[::-1].copy()
    if presorted:
        order = RK.lex_sort_indices(ks)
        ks, vals = RK.KeySet(ks.bytes[order], ks.lens[order]), vals[order]
    want_parts, want_split = r_partition(ks, vals, n_shards,
                                         presorted=presorted)
    parts, split = PF.sharded_partition(KeySet(ks.bytes, ks.lens), vals,
                                        n_shards, presorted=presorted)
    assert len(parts) == len(want_parts) == n_shards
    for (p, pv), (w, wv) in zip(parts, want_parts):
        assert np.array_equal(p.bytes, w.bytes)
        assert np.array_equal(p.lens, w.lens) and np.array_equal(pv, wv)
    for (pb, pl), (wb, wl) in zip(split, want_split):
        assert np.array_equal(pb, wb) and pl == wl
    sizes = [p.n for p, _ in parts]
    assert sum(sizes) == len(keys) and max(sizes) - min(sizes) <= 1
    with pytest.raises(ValueError, match="at least one key per shard"):
        PF.sharded_partition(KeySet(ks.bytes[:2], ks.lens[:2]), vals[:2], 3)
    with pytest.raises(ValueError, match="n_shards"):
        PF.sharded_partition(KeySet(ks.bytes, ks.lens), vals, 0)
