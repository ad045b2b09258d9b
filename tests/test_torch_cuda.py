"""The CUDA kernel on a card: held against its plain torch version bit for
bit, launched once per call, and strict about its inputs.

Every test here is marked ``cuda`` and skips where no card is present (a
CUDA kernel has no CPU mode). The file imports no JAX, so it runs on a
machine with a card and no JAX:
``PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py``.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import batch_ops as B
from repro_torch.core.fbtree import TreeConfig, bulk_build
from repro_torch.core.keys import KeySet
from repro_torch.core.traverse import TraversalEngine
from repro_torch.kernels.fused_descent import cuda as kcuda
from repro_torch.kernels.fused_descent import ops

from chip_smoke import (int_keys, kernel_vs_plain, stale_parents, url_keys,
                        ycsb_keys)

GEN = {"ycsb": ycsb_keys, "url": url_keys, "int": int_keys}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _tree_and_queries(kind, ns, n=4000, seed=3):
    kb, kl = GEN[kind](n, seed)
    cfg = TreeConfig.plan(max_keys=int(2.5 * n), key_width=kb.shape[1], ns=ns)
    tree = bulk_build(cfg, KeySet(kb, kl), np.arange(n, dtype=np.int32) * 7,
                      target="cuda")
    tree, moved = stale_parents(tree, [2, 7, 11], double=(ns == 128))
    rng = np.random.default_rng(seed)
    idx = np.concatenate([np.asarray(moved), rng.integers(0, n, 509)])
    a = tree.arrays
    qi = torch.from_numpy(idx).cuda()
    qb, ql = a.key_bytes[qi].clone(), a.key_lens[qi].clone()
    qb[len(moved)::3, -1] ^= 0xA5
    return tree, qb, ql


@pytest.mark.cuda
@pytest.mark.parametrize("kind,ns", (("ycsb", 64), ("url", 64), ("int", 128)))
def test_cuda_kernel_matches_plain(cuda_device, kind, ns):
    tree, qb, ql = _tree_and_queries(kind, ns)
    n0 = ops.LAUNCHES
    assert kernel_vs_plain(tree, qb, ql) == 0
    assert ops.LAUNCHES == n0 + 8       # 2 entries x stats x sibling check
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_cuda_lookup_batch_is_one_launch(cuda_device):
    tree, qb, ql = _tree_and_queries("ycsb", 64)
    n0 = ops.LAUNCHES
    vals, rep = B.lookup_batch(tree, qb, ql, engine=TraversalEngine("fused"))
    assert ops.LAUNCHES == n0 + 1
    assert vals.is_cuda and rep.found.is_cuda
    # the plain "torch" engine on the same tree gives the same values/report
    ref_vals, ref_rep = B.lookup_batch(tree, qb, ql,
                                       engine=TraversalEngine("torch"))
    assert ops.LAUNCHES == n0 + 1
    assert torch.equal(vals, ref_vals)
    for f in rep._fields:
        assert torch.equal(getattr(rep, f), getattr(ref_rep, f)), f


@pytest.mark.cuda
def test_cuda_wrapper_rejects_what_the_kernel_does_not_take(cuda_device):
    tree, qb, ql = _tree_and_queries("int", 64, n=500)
    a = tree.arrays
    kw = dict(sibling_check=True, with_probe=True, collect_stats=False)
    with pytest.raises(TypeError, match="ql"):
        kcuda.launch(a, qb, ql.long(), **kw)
    with pytest.raises(ValueError, match="contiguous"):
        kcuda.launch(a, qb.t().contiguous().t(), ql, **kw)
    with pytest.raises(ValueError, match="on"):
        kcuda.launch(a._replace(leaf_high=a.leaf_high.cpu()), qb, ql, **kw)
    with pytest.raises(ValueError, match="shape"):
        kcuda.launch(a, qb[:, :-1].contiguous(), ql, **kw)
    empty = kcuda.launch(a, qb[:0], ql[:0], **kw)
    assert all(t.shape[-1] == 0 or t.shape[0] == 0 for t in empty)
