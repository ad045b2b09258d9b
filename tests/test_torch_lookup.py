"""The port's lookup path against the reference's, bit for bit.

Mirrors ``tests/test_traverse_parity.py`` (backend × layout parity, the
stats-free path, lookup reports across engines): the port's ``"torch"``
engine in both layouts and its ``"fused"`` engine (on the CPU, the plain
torch version) must equal the reference's ``"jnp"`` engine on leaf ids,
per-level paths, found/slot/val and every ``BranchStats``/``LeafStats``
counter — stats on and off, sibling check on and off, ns=64 and ns=128.
The trees have stale parents, so the sibling hop really hops; the same
stale state is given to both packages.
"""
import functools

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
from repro.core.leaf import probe as r_probe
from repro.core.traverse import TraversalEngine as REngine
from repro_torch import obs as pobs
from repro_torch.core import batch_ops as PB
from repro_torch.core import fbtree as PF
from repro_torch.core.keys import KeySet
from repro_torch.core.traverse import (DEFAULT_ENGINE, TraversalEngine,
                                       available_backends, backend_kind,
                                       get_backend, get_descent_backend)

from benchmarks.common import make_dataset
from chip_smoke import stale_parents

# (dataset, fs, ns, stale-parent kind): ns=64 leaves have 16 free slots, one
# moved key fits; ns=128 leaves have 80, a whole sibling fits (two hops)
CASES = (("ycsb", 4, 64, "single"), ("url", 2, 64, "single"),
         ("rand-int", 4, 128, "double"), ("url", 4, 128, "double"))
PORT_ENGINES = (("torch", "tuple"), ("torch", "stacked"), ("fused", None))
N_KEYS, N_Q = 600, 192


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@functools.lru_cache(maxsize=None)
def case_data(case):
    """Reference and port trees with the same stale parents, a query batch
    (present, flipped and moved keys), and the reference's outputs."""
    ds, fs, ns, stale = case
    keys, width = make_dataset(ds, N_KEYS, seed=7)
    ks = RK.make_keyset(keys, width)
    vals = (np.arange(len(keys), dtype=np.int32) * 3 + 1)
    rt = r_bulk_build(RConfig.plan(max_keys=2 * len(keys), key_width=width,
                                   fs=fs, ns=ns), ks, vals)
    pt = PF.bulk_build(PF.TreeConfig.plan(max_keys=2 * len(keys),
                                          key_width=width, fs=fs, ns=ns),
                       KeySet(ks.bytes, ks.lens), vals, target="cpu")
    pt, moved = stale_parents(pt, [1, 5, 9], double=(stale == "double"))
    a = pt.arrays
    rt = rt.replace(**{f: jnp.asarray(getattr(a, f).numpy()) for f in (
        "leaf_tags", "leaf_keyid", "leaf_val", "leaf_occ", "leaf_high")})

    rng = np.random.default_rng(sum(map(ord, ds)) + ns)
    idx = rng.integers(0, ks.n, size=N_Q)
    kb, kl = a.key_bytes.numpy(), a.key_lens.numpy()
    qb, ql = kb[idx].copy(), kl[idx].copy()
    qb[:len(moved)], ql[:len(moved)] = kb[moved], kl[moved]
    flip = rng.random(N_Q) < 0.3
    flip[:len(moved)] = False
    qb[flip, -1] ^= 0xA5

    ref = {}
    for sib in (True, False):
        eng = REngine("jnp", "tuple", collect_stats=True)
        leaf, path, bst = eng.traverse(rt, jnp.asarray(qb), jnp.asarray(ql),
                                       sibling_check=sib)
        found, slot, val, lst = r_probe(rt, leaf, jnp.asarray(qb),
                                        jnp.asarray(ql))
        ref[sib] = jax.device_get((leaf, path, found, slot, val, bst, lst))
    assert ref[True][5].sibling_hops.sum() > 0   # the hop path is exercised
    assert np.asarray(ref[True][2])[:len(moved)].all()
    return rt, pt, qb, ql, ref


def assert_outputs_equal(got, want, stats: bool, where):
    leaf, path, found, slot, val, bst, lst = got
    rleaf, rpath, rfound, rslot, rval, rbst, rlst = want
    assert leaf.dtype == torch.int32 and val.dtype == torch.int32
    assert found.dtype == torch.bool and slot.dtype == torch.int32
    assert np.array_equal(_np(leaf), rleaf), (where, "leaf")
    assert len(path) == len(rpath)
    for lvl, (p, rp) in enumerate(zip(path, rpath)):
        assert np.array_equal(_np(p), rp), (where, "path", lvl)
    for name, g, r in (("found", found, rfound), ("slot", slot, rslot),
                       ("val", val, rval)):
        assert np.array_equal(_np(g), r), (where, name)
    if not stats:
        for s in (bst, lst):
            assert s is None or all((_np(c) == 0).all() for c in s), where
        return
    for s, rs in ((bst, rbst), (lst, rlst)):
        for f in rs._fields:
            g = getattr(s, f)
            assert g.dtype == torch.int32, (where, f)
            assert np.array_equal(_np(g), np.asarray(getattr(rs, f))), \
                (where, f)


@pytest.mark.parametrize("sib", (True, False), ids=("sib", "nosib"))
@pytest.mark.parametrize("stats", (True, False), ids=("stats", "nostats"))
@pytest.mark.parametrize("backend,layout", PORT_ENGINES,
                         ids=lambda v: str(v))
@pytest.mark.parametrize("case", CASES, ids=lambda c: f"{c[0]}-fs{c[1]}-ns{c[2]}")
def test_port_engines_match_reference(case, backend, layout, stats, sib):
    _, pt, qb, ql, ref = case_data(case)
    eng = TraversalEngine(backend, layout, collect_stats=stats)
    got = PB.traverse_probe(pt, qb, ql, engine=eng, sibling_check=sib)
    assert_outputs_equal(got, ref[sib], stats,
                         (backend, layout, stats, sib))
    # the engine's bare traverse returns the same leaves and zeros when off
    leaf, path, bst = eng.traverse(pt, torch.from_numpy(qb),
                                   torch.from_numpy(ql), sibling_check=sib)
    assert torch.equal(leaf, got[0])
    if not stats:
        assert all(int(c.abs().sum()) == 0 for c in bst)


@pytest.mark.parametrize("case", CASES[::3], ids=lambda c: f"{c[0]}-ns{c[2]}")
def test_lookup_reports_and_obs_drain_match_reference(case):
    rt, pt, qb, ql, _ = case_data(case)
    robs.disable(), robs.reset(), pobs.disable(), pobs.reset()
    try:
        robs.enable()
        rv, rrep = RB.lookup_batch(rt, jnp.asarray(qb), jnp.asarray(ql),
                                   engine=REngine("jnp", "tuple"))
        rrep = jax.device_get(rrep)
        ref_counts = {(m.name, m.labels): m.value for m in robs.all_metrics()
                      if m.kind == "counter"}
        for backend, layout in PORT_ENGINES:
            pobs.reset()
            pobs.enable()
            v, rep = PB.lookup_batch(pt, qb, ql,
                                     engine=TraversalEngine(backend, layout))
            assert np.array_equal(v.numpy(), np.asarray(rv)), backend
            for f in rrep._fields:
                g, r = getattr(rep, f).numpy(), np.asarray(getattr(rrep, f))
                assert g.dtype == r.dtype and g.shape == r.shape, (backend, f)
                assert np.array_equal(g, r), (backend, f)
            got_counts = {(m.name, m.labels): m.value
                          for m in pobs.all_metrics() if m.kind == "counter"}
            assert got_counts == ref_counts, backend
            assert pobs.get_metric("span.op.lookup").count == 1
    finally:
        robs.disable(), robs.reset(), pobs.disable(), pobs.reset()


def test_backend_registry():
    assert backend_kind("torch") == "level"
    assert callable(get_backend("torch"))
    assert backend_kind("fused") == "descent"
    d = get_descent_backend("fused")
    assert callable(d.traverse) and callable(d.traverse_probe)
    for name in ("cuda", "binary", "binary+prefix"):
        assert backend_kind(name) == "level"
        assert callable(get_backend(name))
    assert set(available_backends()) == {"torch", "cuda", "binary",
                                         "binary+prefix", "fused"}
    with pytest.raises(KeyError):
        get_backend("no-such-backend")
    with pytest.raises(KeyError):
        get_descent_backend("no-such-backend")
    with pytest.raises(ValueError):
        TraversalEngine(backend="no-such-backend")
    with pytest.raises(ValueError):
        TraversalEngine(layout="rows")
    assert DEFAULT_ENGINE == TraversalEngine("torch")
    assert DEFAULT_ENGINE.collect_stats
    assert TraversalEngine("fused").probe_path() is not None
    assert TraversalEngine("torch").probe_path() is None
    assert TraversalEngine("fused").scan_path() is not None
    assert TraversalEngine("torch").scan_path() is None
