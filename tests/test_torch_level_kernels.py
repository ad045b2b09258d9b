"""The port's per-level kernels K3 (feature rounds) and K4 (hashtag leaf
filter) against the reference's, bit for bit, on the CPU.

Mirrors the feature-branch and leaf-probe cases of ``tests/test_kernels.py``:
on the CPU the port's wrappers run their plain torch versions, and the
reference runs its Pallas kernels in interpret mode and its jnp oracles.
Inputs are made from numpy with a seed and handed to both packages.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import keys as RK
from repro.core.branch import traverse as r_traverse
from repro.core.fbtree import TreeConfig as RConfig
from repro.core.fbtree import bulk_build as r_bulk_build
from repro.kernels.feature_branch.ops import branch_level_pallas
from repro.kernels.feature_branch.ops import feature_branch as r_feature_branch
from repro.kernels.feature_branch.ref import feature_branch_ref
from repro.kernels.leaf_probe.ops import leaf_probe as r_leaf_probe
from repro.kernels.leaf_probe.ops import probe_pallas
from repro.kernels.leaf_probe.ref import leaf_probe_ref as r_leaf_probe_ref
from repro_torch.core import fbtree as PF
from repro_torch.core.branch import branch_level
from repro_torch.core.keys import KeySet
from repro_torch.core.leaf import probe as p_probe
from repro_torch.core.traverse import TraversalEngine
from repro_torch.kernels.feature_branch import ops as k3
from repro_torch.kernels.leaf_probe import ops as k4

K3_OUT = ("idx", "resolved", "run_lo", "run_hi", "rounds")


def _k3_inputs(seed, B, fs, ns, skew):
    """Sorted feature rows, as a built node holds them; knum over [0, ns]
    (trivial nodes included) and pcmp in {-1, 0, 1}."""
    rng = np.random.default_rng(seed)
    hi = 8 if skew else 256
    feats = np.sort(rng.integers(0, hi, size=(B, fs, ns), dtype=np.uint8), -1)
    qfeat = rng.integers(0, hi, size=(B, fs), dtype=np.uint8)
    knum = rng.integers(0, ns + 1, size=B, dtype=np.int32)
    knum[:4] = (0, 1, 1, ns)
    pcmp = rng.integers(-1, 2, size=B, dtype=np.int32)
    return feats, qfeat, knum, pcmp


@pytest.mark.parametrize("skew", (False, True), ids=("wide", "skewed"))
@pytest.mark.parametrize("B,fs,ns", [(32, 4, 64), (64, 2, 64), (16, 4, 128),
                                     (37, 4, 64)])
def test_feature_branch_matches_reference(B, fs, ns, skew):
    """Every output on every lane, stats on and off, against the Pallas
    kernel (interpret mode; the odd B goes through the reference's
    pad-to-tile wrapper) and the jnp oracle."""
    feats, qfeat, knum, pcmp = _k3_inputs(B * fs + ns, B, fs, ns, skew)
    rin = (jnp.asarray(feats), jnp.asarray(qfeat), jnp.asarray(knum[:, None]),
           jnp.asarray(pcmp[:, None]))
    want_ref = [np.asarray(o)[:, 0] for o in feature_branch_ref(*rin)]
    want_kernel = [np.asarray(o)[:, 0]
                   for o in r_feature_branch(*rin, use_pallas=True)]
    pin = tuple(torch.from_numpy(x) for x in (feats, qfeat, knum, pcmp))
    got = [o.numpy() for o in k3.feature_branch(*pin, collect_stats=True)]
    for name, g, wr, wk in zip(K3_OUT, got, want_ref, want_kernel):
        assert g.dtype == np.int32 and g.shape == (B,), name
        assert np.array_equal(g, wr), name
        assert np.array_equal(g, wk), name
    off = [o.numpy() for o in k3.feature_branch(*pin, collect_stats=False)]
    for name, g, w in zip(K3_OUT[:4], off[:4], got[:4]):
        assert np.array_equal(g, w), name
    assert not off[4].any()
    # the overrides: trivial nodes resolve at idx 0 with no rounds
    assert (got[1][knum <= 1] == 1).all() and (got[4][knum <= 1] == 0).all()


def _int_tree(n, width, seed):
    rng = np.random.default_rng(seed)
    ints = rng.choice(2**48, size=n, replace=False)
    ks = RK.make_keyset([int(x) for x in ints], width)
    vals = np.arange(n, dtype=np.int32)
    rt = r_bulk_build(RConfig.plan(max_keys=2 * n, key_width=width), ks, vals)
    pt = PF.bulk_build(PF.TreeConfig.plan(max_keys=2 * n, key_width=width),
                       KeySet(ks.bytes, ks.lens), vals, target="cpu")
    return rt, pt, ks


@pytest.mark.parametrize("n,width", [(500, 8), (900, 16)])
def test_branch_level_cuda_matches_pallas_full_tree(n, width):
    """Level by level down a full tree: children and every BranchStats
    counter equal the reference's ``branch_level_pallas`` and the port's
    plain ``branch_level``; stats off gives the same children."""
    rt, pt, ks = _int_tree(n, width, seed=n)
    qb_np, ql_np = ks.bytes[:256].copy(), ks.lens[:256].copy()
    qb_np[::5, -1] ^= 0xA5
    rqb, rql = jnp.asarray(qb_np), jnp.asarray(ql_np)
    pqb, pql = torch.from_numpy(qb_np), torch.from_numpy(ql_np)
    ra, pa = rt.arrays, pt.arrays
    node = np.zeros(256, np.int32)
    for rlv, plv in zip(ra.levels, pa.levels):
        rc, rs = branch_level_pallas(rlv, ra.key_bytes, ra.key_lens,
                                     jnp.asarray(node), rqb, rql)
        pn = torch.from_numpy(node)
        pc, ps = k3.branch_level_cuda(plv, pa.key_bytes, pa.key_lens, pn,
                                      pqb, pql)
        oc, os_ = branch_level(plv, pa.key_bytes, pa.key_lens, pn, pqb, pql)
        assert np.array_equal(pc.numpy(), np.asarray(rc))
        assert torch.equal(pc, oc)
        for f in rs._fields:
            assert np.array_equal(getattr(ps, f).numpy(),
                                  np.asarray(getattr(rs, f))), f
            assert torch.equal(getattr(ps, f), getattr(os_, f)), f
        nc, none = k3.branch_level_cuda(plv, pa.key_bytes, pa.key_lens, pn,
                                        pqb, pql, collect_stats=False)
        assert none is None and torch.equal(nc, pc)
        node = pc.numpy()


@pytest.mark.parametrize("B,ns", [(40, 64), (33, 128)])
def test_leaf_probe_matches_reference(B, ns):
    rng = np.random.default_rng(B * ns)
    tags = rng.integers(0, 4, size=(B, ns), dtype=np.uint8)
    occ = rng.random((B, ns)) < 0.7
    qtag = rng.integers(0, 5, size=B, dtype=np.uint8)
    occ[0] = False                                  # no candidate: first = ns
    rin = (jnp.asarray(tags), jnp.asarray(occ.astype(np.uint8)),
           jnp.asarray(qtag[:, None]))
    got = [o.numpy() for o in k4.leaf_probe(torch.from_numpy(tags),
                                            torch.from_numpy(occ),
                                            torch.from_numpy(qtag))]
    for want in (r_leaf_probe_ref(*rin), r_leaf_probe(*rin, use_pallas=True)):
        want = [np.asarray(w) for w in want]
        assert got[0].dtype == np.uint8 and np.array_equal(got[0], want[0])
        for g, w in zip(got[1:], want[1:]):
            assert g.dtype == np.int32 and np.array_equal(g, w[:, 0])
    assert got[1][0] == ns and got[2][0] == 0


def test_probe_cuda_matches_probe_pallas():
    """found, slot, val and both LeafStats counters equal the reference's
    ``probe_pallas`` and the port's ``leaf.probe``, for present and absent
    keys."""
    rt, pt, ks = _int_tree(700, 8, seed=7)
    qb_np, ql_np = ks.bytes[:256].copy(), ks.lens[:256].copy()
    qb_np[::4, -1] ^= 0x5A
    rqb, rql = jnp.asarray(qb_np), jnp.asarray(ql_np)
    pqb, pql = torch.from_numpy(qb_np), torch.from_numpy(ql_np)
    leaf, _ = r_traverse(rt, rqb, rql)
    pleaf, _, _ = TraversalEngine("torch").traverse(pt, pqb, pql)
    assert np.array_equal(pleaf.numpy(), np.asarray(leaf))
    want = probe_pallas(rt, leaf, rqb, rql)
    got = k4.probe_cuda(pt, pleaf, pqb, pql)
    plain = p_probe(pt, pleaf, pqb, pql)
    for g, w, p in zip(got[:3], want[:3], plain[:3]):
        assert np.array_equal(g.numpy(), np.asarray(w))
        assert torch.equal(g, p)
    for f in want[3]._fields:
        assert np.array_equal(getattr(got[3], f).numpy(),
                              np.asarray(getattr(want[3], f))), f
        assert torch.equal(getattr(got[3], f), getattr(plain[3], f)), f
    assert got[0].any() and not got[0].all()
    off = k4.probe_cuda(pt, pleaf, pqb, pql, collect_stats=False)
    assert off[3] is None
    for g, w in zip(off[:3], got[:3]):
        assert torch.equal(g, w)
