"""The port's factor-analysis baselines and per-level backends against the
reference's, bit for bit, on the CPU.

Mirrors ``tests/test_baselines.py`` (every variant finds every key; the
paper's Fig. 12(a) counter orderings; the suffix-search rate falling with
fs) on the port, holds each ``VARIANTS`` entry's ``(found, val, stats,
leaf stats)`` against the reference's ``lookup_variant``, and adds the
``"cuda"``, ``"binary"`` and ``"binary+prefix"`` × layout rows of
``tests/test_traverse_parity.py`` (leaf ids, per-level paths and every
counter against the reference's ``"pallas"``/``"binary"`` backends, on
host- and device-built trees, stats on and off).
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import keys as RK
from repro.core.baseline import lookup_variant as r_lookup_variant
from repro.core.fbtree import TreeConfig as RConfig
from repro.core.fbtree import bulk_build as r_bulk_build
from repro.core.traverse import TraversalEngine as REngine
from repro_torch.core import fbtree as PF
from repro_torch.core.baseline import VARIANTS, lookup_variant
from repro_torch.core.keys import KeySet
from repro_torch.core.traverse import TraversalEngine

from benchmarks.common import make_dataset

REF_BACKEND = {"cuda": "pallas", "binary": "binary",
               "binary+prefix": "binary+prefix", "torch": "jnp"}


def _port_tree(ks, width, fs=4, n=None, device=False):
    n = ks.n if n is None else n
    cfg = PF.TreeConfig.plan(max_keys=2 * n, key_width=width, fs=fs)
    return PF.bulk_build(cfg, KeySet(ks.bytes, ks.lens),
                         np.arange(ks.n, dtype=np.int32), device=device,
                         target="cpu")


@pytest.fixture(scope="module")
def tree_and_keys():
    rng = np.random.default_rng(42)
    # skewed string keys: shared prefixes (zipf-ish families)
    fams = [b"com.example.", b"org.acme.", b"io.x.", b"net.service.deep."]
    keys = list({fams[int(rng.zipf(1.4)) % 4]
                 + bytes(rng.integers(97, 123, size=8, dtype=np.uint8))
                 for _ in range(3000)})
    ks = RK.make_keyset(keys, 32)
    return _port_tree(ks, 32), ks, keys


def _dense_keys(n=3000):
    """ycsb-style keys: long shared plen, then dense digits."""
    rng = np.random.default_rng(5)
    return list({f"user{int(x):016d}".encode()
                 for x in rng.integers(0, 10**15, size=2 * n)})[:n]


def _q(ks, n):
    return torch.from_numpy(ks.bytes[:n]), torch.from_numpy(ks.lens[:n])


def test_variants_agree(tree_and_keys):
    t, ks, _ = tree_and_keys
    qb, ql = _q(ks, 512)
    outs = {}
    for var in VARIANTS:
        found, val, _, _ = lookup_variant(t, qb, ql, variant=var)
        assert bool(found.all()), var
        outs[var] = val
    for var in VARIANTS[1:]:
        assert torch.equal(outs[var], outs[VARIANTS[0]]), var
    with pytest.raises(ValueError, match="variant"):
        lookup_variant(t, qb, ql, variant="no-such-variant")


def test_feature_reduces_key_compares_and_lines():
    """Fig 12a ordering on dense keys: feature comparison slashes full-key
    compares; the hashtag leaf drops further lines."""
    ks = RK.make_keyset(_dense_keys(), 24)
    t = _port_tree(ks, 24)
    qb, ql = _q(ks, 1024)
    stats = {}
    for var in VARIANTS:
        _, _, st, _ = lookup_variant(t, qb, ql, variant=var,
                                     engine=TraversalEngine("cuda"))
        stats[var] = (float(st.key_compares.float().mean()),
                      float(st.lines_touched.float().mean()))
    assert stats["feature"][0] < 0.3 * stats["base"][0]
    assert stats["feature+hash"][1] < stats["feature"][1]
    assert stats["feature"][1] < stats["base"][1]


def test_suffix_fallback_rate_drops_with_fs(tree_and_keys):
    """Fig 13b analogue: suffix binary searches decrease as fs grows (dense
    keys; the url-like families keep a floor, checked for monotonicity)."""
    for keyset, need_big_drop in ((_dense_keys(), True),
                                  (tree_and_keys[2], False)):
        ks = RK.make_keyset(keyset, 32)
        qb, ql = _q(ks, 1024)
        rates = []
        for fs in (1, 2, 4, 8):
            t = _port_tree(ks, 32, fs=fs)
            _, _, st, _ = lookup_variant(t, qb, ql, variant="feature+hash")
            rates.append(float(st.suffix_bs.float().mean()))
        assert rates[0] >= rates[1] >= rates[3] - 1e-9
        if need_big_drop:
            assert rates[3] < 0.5 * max(rates[0], 1e-9) or rates[0] == 0


@functools.lru_cache(maxsize=None)
def _pair(ds, fs, n=600, seed=17):
    """A reference tree, the port's host- and device-built twins, and a
    query batch of present and flipped (mostly absent) keys."""
    keys, width = make_dataset(ds, n, seed=seed)
    ks = RK.make_keyset(keys, width)
    vals = np.arange(ks.n, dtype=np.int32)
    rt = r_bulk_build(RConfig.plan(max_keys=2 * n, key_width=width, fs=fs),
                      ks, vals)
    host = _port_tree(ks, width, fs=fs, n=n)
    dev = _port_tree(ks, width, fs=fs, n=n, device=True)
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, ks.n, size=160)
    qb, ql = ks.bytes[idx].copy(), ks.lens[idx].copy()
    qb[rng.random(160) < 0.3, -1] ^= 0xA5
    return rt, host, dev, qb, ql


@pytest.mark.parametrize("layout", ("tuple", "stacked"))
@pytest.mark.parametrize("variant", VARIANTS)
def test_lookup_variant_matches_reference(variant, layout):
    """(found, val, stats, leaf stats) of every variant equal the
    reference's, through the ``"cuda"`` level backend (and the plain
    ``"torch"`` one) for the feature variants."""
    rt, pt, _, qb, ql = _pair("ycsb", 4)
    want = r_lookup_variant(rt, jnp.asarray(qb), jnp.asarray(ql),
                            variant=variant, engine=REngine("jnp", layout))
    for backend in ("cuda", "torch"):
        got = lookup_variant(pt, qb, ql, variant=variant,
                             engine=TraversalEngine(backend, layout))
        for i, name in ((0, "found"), (1, "val")):
            assert np.array_equal(got[i].numpy(), np.asarray(want[i])), name
        for g, w in ((got[2], want[2]), (got[3], want[3])):
            for f in w._fields:
                assert np.array_equal(getattr(g, f).numpy(),
                                      np.asarray(getattr(w, f))), (backend, f)


@pytest.mark.parametrize("layout", ("tuple", "stacked"))
@pytest.mark.parametrize("backend", ("cuda", "binary", "binary+prefix"))
@pytest.mark.parametrize("ds,fs", (("url", 2), ("rand-int", 4)))
def test_level_backend_rows_match_reference(ds, fs, backend, layout):
    """Leaf ids, per-level paths and every BranchStats counter equal the
    reference's matching backend on the host-built tree, and the same on
    the device-built twin; with stats off, the same leaves and paths and
    all-zero counters."""
    rt, host, dev, qb, ql = _pair(ds, fs)
    r_leaf, r_path, r_stats = REngine(REF_BACKEND[backend], layout).traverse(
        rt, jnp.asarray(qb), jnp.asarray(ql))
    pqb, pql = torch.from_numpy(qb), torch.from_numpy(ql)
    for tree in (host, dev):
        leaf, path, stats = TraversalEngine(backend, layout).traverse(
            tree, pqb, pql)
        assert np.array_equal(leaf.numpy(), np.asarray(r_leaf))
        for p, rp in zip(path, r_path):
            assert np.array_equal(p.numpy(), np.asarray(rp))
        for f in r_stats._fields:
            assert np.array_equal(getattr(stats, f).numpy(),
                                  np.asarray(getattr(r_stats, f))), f
        off = TraversalEngine(backend, layout, collect_stats=False)
        leaf_off, path_off, stats_off = off.traverse(tree, pqb, pql)
        assert torch.equal(leaf_off, leaf)
        for p, q in zip(path_off, path):
            assert torch.equal(p, q)
        for f in stats_off._fields:
            assert not getattr(stats_off, f).any(), f
