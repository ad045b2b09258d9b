"""The port's host bulk build and tree converter against the reference:
every ``TreeArrays`` field — the per-level tuple, the stacked copy and the
trailing scratch rows — is equal in dtype, shape and value."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.core import keys as RK
from repro.core.fbtree import TreeConfig as RConfig
from repro.core.fbtree import bulk_build as r_bulk_build
from repro_torch.core import fbtree as PF
from repro_torch.core.convert import tree_from_numpy
from repro_torch.core.keys import KeySet

from benchmarks.common import make_dataset

DATASETS = ("rand-int", "ycsb", "url")


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def assert_arrays_equal(ref_arrays, port_arrays):
    """Field by field, dtype + shape + value; ``levels`` per level."""
    ref = jax.device_get(ref_arrays)
    for f in ref._fields:
        r, p = getattr(ref, f), getattr(port_arrays, f)
        if f == "levels":
            assert len(r) == len(p)
            pairs = [(f"levels[{i}].{g}", getattr(rl, g), getattr(pl, g))
                     for i, (rl, pl) in enumerate(zip(r, p))
                     for g in rl._fields]
        elif f == "stacked":
            pairs = [(f"stacked.{g}", getattr(r, g), getattr(p, g))
                     for g in r._fields]
        else:
            pairs = [(f, r, p)]
        for name, rv, pv in pairs:
            rv, pv = np.asarray(rv), _np(pv)
            assert rv.dtype == pv.dtype, (name, rv.dtype, pv.dtype)
            assert rv.shape == pv.shape, (name, rv.shape, pv.shape)
            assert np.array_equal(rv, pv), name


def _build_both(ds, fs, ns, n=500, seed=21):
    keys, width = make_dataset(ds, n, seed=seed)
    ks = RK.make_keyset(keys, width)
    vals = np.arange(len(keys), dtype=np.int32)[::-1].copy()
    rcfg = RConfig.plan(max_keys=2 * len(keys), key_width=width, fs=fs, ns=ns)
    pcfg = PF.TreeConfig.plan(max_keys=2 * len(keys), key_width=width, fs=fs,
                              ns=ns)
    rt = r_bulk_build(rcfg, ks, vals)
    pt = PF.bulk_build(pcfg, KeySet(ks.bytes, ks.lens), vals, target="cpu")
    return rt, pt


@pytest.mark.parametrize("ns", (64, 128))
@pytest.mark.parametrize("fs", (2, 4))
@pytest.mark.parametrize("ds", DATASETS)
def test_host_build_equals_reference(ds, fs, ns):
    rt, pt = _build_both(ds, fs, ns)
    rc, pc = dataclasses.asdict(rt.config), dataclasses.asdict(pt.config)
    rc.pop("val_dtype"), pc.pop("val_dtype")
    assert rc == pc
    assert pt.config.val_dtype == torch.int32
    assert pt.device == torch.device("cpu")
    assert_arrays_equal(rt.arrays, pt.arrays)
    # the stacked copy is the restacked tuple, as in the reference
    for got, want in zip(pt.arrays.stacked, PF.stack_levels(pt.arrays.levels)):
        assert torch.equal(got, want)


@pytest.mark.parametrize("ds", DATASETS)
def test_tree_from_numpy_equals_port_build(ds):
    rt, pt = _build_both(ds, 4, 64)
    host = jax.device_get(rt.arrays)
    arrays = host._asdict()
    arrays["levels"] = [lv._asdict() for lv in host.levels]
    arrays["stacked"] = host.stacked._asdict()
    ct = tree_from_numpy(dataclasses.asdict(rt.config), arrays, target="cpu")
    assert ct.config == pt.config
    assert_arrays_equal(rt.arrays, ct.arrays)
    for f in ("key_bytes", "leaf_keyid", "leaf_occ", "key_count"):
        assert torch.equal(getattr(ct.arrays, f), getattr(pt.arrays, f))


def test_bulk_build_target_none_means_the_card():
    keys, width = make_dataset("ycsb", 50, seed=1)
    ks = RK.make_keyset(keys, width)
    cfg = PF.TreeConfig.plan(max_keys=100, key_width=width)
    vals = np.arange(len(keys), dtype=np.int32)
    if torch.cuda.is_available():
        assert PF.bulk_build(cfg, KeySet(*ks), vals).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            PF.bulk_build(cfg, KeySet(*ks), vals)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            PF.bulk_build(cfg, KeySet(*ks), vals, target="cuda")


def test_bulk_build_device_pipeline_not_ported_and_caps_checked():
    """The device pipeline, ported since this test was written, gives the
    host build's tree; both paths check the caps on the host."""
    keys, width = make_dataset("rand-int", 60, seed=2)
    ks = KeySet(*RK.make_keyset(keys, width))
    vals = np.arange(len(keys), dtype=np.int32)
    cfg = PF.TreeConfig.plan(max_keys=120, key_width=width)
    dev = PF.bulk_build(cfg, ks, vals, device=True, target="cpu")
    host = PF.bulk_build(cfg, ks, vals, target="cpu")

    def flat(t):
        a = t.arrays
        return ([getattr(a, f) for f in a._fields
                 if f not in ("levels", "stacked")]
                + [x for lv in a.levels for x in lv] + list(a.stacked))

    for u, v in zip(flat(dev), flat(host)):
        assert u.dtype == v.dtype and torch.equal(u, v)
    small = PF.TreeConfig.plan(max_keys=30, key_width=width)
    for device in (False, True):
        with pytest.raises(ValueError, match="key_cap"):
            PF.bulk_build(small, ks, vals, device=device, target="cpu")
    with pytest.raises(ValueError, match="level_caps"):
        PF.TreeConfig(key_width=8, n_levels=2, level_caps=(1,))
