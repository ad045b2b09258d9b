"""The port's key functions (``repro_torch.core.keys``) against the
reference's (``repro.core.keys``) on the benchmark datasets: every output is
bit-equal."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import keys as RK
from repro_torch.core import keys as PK

from benchmarks.common import make_dataset

DATASETS = ("rand-int", "ycsb", "url")


@pytest.fixture(scope="module", params=DATASETS)
def dataset(request):
    keys, width = make_dataset(request.param, 400, seed=11)
    return keys, width, RK.make_keyset(keys, width)


def test_make_keyset_equal(dataset):
    keys, width, ref = dataset
    got = PK.make_keyset(keys, width)
    assert got.bytes.dtype == ref.bytes.dtype and got.lens.dtype == ref.lens.dtype
    assert np.array_equal(got.bytes, ref.bytes)
    assert np.array_equal(got.lens, ref.lens)


def test_pack_words_equal(dataset):
    _, _, ks = dataset
    want = RK.pack_words(ks.bytes)
    assert np.array_equal(PK.pack_words(ks.bytes), want)
    got_t = PK.pack_words_t(torch.from_numpy(ks.bytes))
    assert got_t.dtype == torch.int32
    assert np.array_equal(got_t.numpy(), want)
    assert np.array_equal(got_t.numpy(),
                          np.asarray(RK.pack_words_j(jnp.asarray(ks.bytes))))


def test_lex_sort_indices_equal(dataset):
    _, _, ks = dataset
    assert np.array_equal(PK.lex_sort_indices(PK.KeySet(*ks)),
                          RK.lex_sort_indices(ks))


def test_compare_padded_equal(dataset):
    _, _, ks = dataset
    rng = np.random.default_rng(5)
    a = rng.integers(0, ks.n, size=300)
    b = np.where(rng.random(300) < 0.3, a, rng.integers(0, ks.n, size=300))
    ab, al = ks.bytes[a].copy(), ks.lens[a].copy()
    bb, bl = ks.bytes[b].copy(), ks.lens[b].copy()
    # equal bytes with a shorter length, to reach the length tie-break
    al[::7] = np.maximum(al[::7] - 1, 0)
    want = RK.compare_padded(ab, al, bb, bl)
    assert set(np.unique(want)) == {-1, 0, 1}
    got_t = PK.compare_padded(*(torch.from_numpy(x) for x in (ab, al, bb, bl)))
    assert got_t.dtype == torch.int32
    assert np.array_equal(got_t.numpy(), want)
    # broadcast over a leading dim, as the descent's [B, L] x [B, L] calls
    got_b = PK.compare_padded(torch.from_numpy(ab[:, None]),
                              torch.from_numpy(al[:, None]),
                              torch.from_numpy(bb[None, :5]),
                              torch.from_numpy(bl[None, :5]))
    want_b = RK.compare_padded(ab[:, None], al[:, None], bb[None, :5],
                               bl[None, :5])
    assert np.array_equal(got_b.numpy(), want_b)


def test_fnv1a_tags_equal(dataset):
    _, _, ks = dataset
    lens = ks.lens.copy()
    lens[::5] //= 2                           # tags of prefixes too
    want = RK.fnv1a_tags(ks.bytes, lens)
    assert np.array_equal(PK.fnv1a_tags(ks.bytes, lens), want)
    got_t = PK.fnv1a_tags(torch.from_numpy(ks.bytes), torch.from_numpy(lens))
    assert got_t.dtype == torch.uint8
    assert np.array_equal(got_t.numpy(), want)
    assert np.array_equal(
        got_t.numpy(),
        np.asarray(RK.fnv1a_tags(jnp.asarray(ks.bytes), jnp.asarray(lens))))


def test_int_encoders_equal():
    rng = np.random.default_rng(3)
    u = rng.integers(0, 2**63, size=200).astype(np.uint64) * np.uint64(2)
    s = rng.integers(-2**62, 2**62, size=200)
    assert np.array_equal(PK.encode_uint64(u), RK.encode_uint64(u))
    assert np.array_equal(PK.encode_int64(s), RK.encode_int64(s))
    assert np.array_equal(PK.decode_uint64(PK.encode_uint64(u)), u)
    ints = [int(x) for x in s[:50]]
    for mode in ("uint64", "int64"):
        a = PK.make_keyset([abs(x) for x in ints], 8, int_mode=mode)
        b = RK.make_keyset([abs(x) for x in ints], 8, int_mode=mode)
        assert np.array_equal(a.bytes, b.bytes)
