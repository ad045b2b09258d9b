"""The port's fused descent against the reference's Pallas kernel.

Mirrors ``tests/test_kernels.py::test_fused_descent_kernel_matches_ref``:
on the CPU the port's ``fused_traverse``/``fused_traverse_probe`` run the
plain torch version, which must equal the reference's Pallas kernel (in
interpret mode) on leaves, paths, probe results and every counter. The
feature-comparison rounds shared by the kernels are held against the
reference's ``feature_compare_rounds``. The CUDA kernel itself is held
against the plain version in ``tests/test_torch_cuda.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import keys as RK
from repro.core.fbtree import TreeConfig as RConfig
from repro.core.fbtree import bulk_build as r_bulk_build
from repro.kernels.feature_branch.kernel import \
    feature_compare_rounds as r_rounds
from repro.kernels.fused_descent import ops as r_ops
from repro_torch.core import fbtree as PF
from repro_torch.core.keys import KeySet
from repro_torch.kernels.feature_branch.ref import feature_compare_rounds
from repro_torch.kernels.fused_descent import ops as p_ops

from benchmarks.common import make_dataset
from chip_smoke import stale_parents


def _trees(ds, n, ns, width=None, seed=5):
    """Reference and port trees over the same keys with the same stale
    parents (so the sibling hop hops), and a query batch."""
    if ds == "int":
        rng = np.random.default_rng(seed)
        ks = RK.make_keyset([int(x) for x in rng.choice(2**48, size=n,
                                                        replace=False)], width)
    else:
        keys, width = make_dataset(ds, n, seed=seed)
        ks = RK.make_keyset(keys, width)
    vals = np.arange(n, dtype=np.int32) + 100
    rt = r_bulk_build(RConfig.plan(max_keys=2 * n, key_width=width, ns=ns),
                      ks, vals)
    pt = PF.bulk_build(PF.TreeConfig.plan(max_keys=2 * n, key_width=width,
                                          ns=ns),
                       KeySet(ks.bytes, ks.lens), vals, target="cpu")
    pt, moved = stale_parents(pt, [2, 7], double=(ns == 128))
    a = pt.arrays
    rt = rt.replace(**{f: jnp.asarray(getattr(a, f).numpy()) for f in (
        "leaf_tags", "leaf_keyid", "leaf_val", "leaf_occ", "leaf_high")})
    qb = ks.bytes[:192].copy()
    ql = ks.lens[:192].copy()
    kb, kl = a.key_bytes.numpy(), a.key_lens.numpy()
    qb[:len(moved)], ql[:len(moved)] = kb[moved], kl[moved]
    qb[len(moved)::4, -1] ^= 0x5A             # mix in missing keys
    return rt, pt, qb, ql


def _eq(got, want, what):
    g = got.cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert np.array_equal(g, np.asarray(want)), what


@pytest.mark.parametrize("stats,sib", ((True, True), (False, False)),
                         ids=("stats-sib", "nostats-nosib"))
@pytest.mark.parametrize("ds,ns,width", (("int", 64, 10), ("url", 128, None)))
def test_fused_matches_reference_pallas_kernel(ds, ns, width, stats, sib):
    rt, pt, qb, ql = _trees(ds, 800, ns, width)
    want = jax.device_get(r_ops.fused_traverse_probe(
        rt, jnp.asarray(qb), jnp.asarray(ql), sibling_check=sib,
        collect_stats=stats))
    got = p_ops.fused_traverse_probe(pt, torch.from_numpy(qb),
                                     torch.from_numpy(ql), sibling_check=sib,
                                     collect_stats=stats)
    _eq(got[0], want[0], "leaf")
    for lvl, (p, rp) in enumerate(zip(got[1], want[1])):
        _eq(p, rp, ("path", lvl))
    for i, name in ((2, "found"), (3, "slot"), (4, "val")):
        _eq(got[i], want[i], name)
    if stats:
        assert int(want[5].sibling_hops.sum()) > 0
        for g, w in zip(got[5:], want[5:]):
            for f in w._fields:
                _eq(getattr(g, f), getattr(w, f), f)
    else:
        assert got[5] is None and got[6] is None
    # the descent-only entry agrees with the probe entry's descent
    leaf, path, _ = p_ops.fused_traverse(pt, torch.from_numpy(qb),
                                         torch.from_numpy(ql),
                                         sibling_check=sib,
                                         collect_stats=stats)
    _eq(leaf, want[0], "fused_traverse leaf")


@pytest.mark.parametrize("ns", (64, 128))
@pytest.mark.parametrize("fs", (2, 4))
def test_feature_compare_rounds_matches_reference(fs, ns):
    rng = np.random.default_rng(fs * 1000 + ns)
    B = 256
    # few distinct byte values, so equal runs survive several rounds
    feats = rng.integers(0, 4, size=(B, fs, ns)).astype(np.uint8)
    feats.sort(axis=-1)
    qfeat = rng.integers(0, 5, size=(B, fs)).astype(np.uint8)
    knum = rng.integers(0, ns + 1, size=(B,)).astype(np.int32)
    pcmp = rng.choice([-1, 0, 0, 0, 1], size=(B,)).astype(np.int32)
    for stats in (True, False):
        want = r_rounds(jnp.asarray(feats), jnp.asarray(qfeat),
                        jnp.asarray(knum)[:, None], jnp.asarray(pcmp)[:, None],
                        fs=fs, ns=ns, collect_stats=stats)
        got = feature_compare_rounds(torch.from_numpy(feats),
                                     torch.from_numpy(qfeat),
                                     torch.from_numpy(knum),
                                     torch.from_numpy(pcmp),
                                     collect_stats=stats)
        for name, g, w in zip(("idx", "resolved", "run_lo", "run_hi",
                               "rounds"), got, want):
            _eq(g, np.asarray(w)[:, 0], (name, stats))


def test_cpu_queries_never_launch():
    _, pt, qb, ql = _trees("int", 300, 64, 10)
    n0 = p_ops.LAUNCHES
    p_ops.fused_traverse_probe(pt, torch.from_numpy(qb), torch.from_numpy(ql))
    assert p_ops.LAUNCHES == n0
