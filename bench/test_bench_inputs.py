"""The benchmark's inputs: YCSB's key names and its scrambled zipfian, held
against a plain transcription of YCSB's Java code, and the same requests
from the same seed and others from another."""
import numpy as np
import pytest
import torch

from bench import dists, keysets
from bench.dists import scrambled_zipfian as sz
from bench.keysets import ycsb

MASK = (1 << 64) - 1


def java_fnvhash64(val: int) -> int:
    """``site.ycsb.Utils.fnvhash64`` in Python's exact integers: the
    products wrapped to 64 bits, then ``Math.abs`` of the signed result."""
    h = 0xCBF29CE484222325
    for _ in range(8):
        h = ((h ^ (val & 0xFF)) * 1099511628211) & MASK
        val >>= 8
    return abs(h - (1 << 64) if h >> 63 else h)


@pytest.fixture
def device():
    """The card where there is one, else the CPU."""
    return torch.device("cuda" if torch.cuda.is_available() else "cpu")


@pytest.mark.parametrize("name", ["ycsb"])
def test_key_sets_follow_the_seed(name, device):
    """YCSB's key names have no seed: every seed loads the same distinct,
    zero-padded keys, record ``i`` in row ``i``."""
    gen = keysets.load(name).generate
    a, al = gen(3000, 11, device)
    b, bl = gen(3000, 12, device)
    assert torch.equal(a, b) and torch.equal(al, bl)
    assert a.shape == (3000, keysets.load(name).WIDTH)
    rows = {bytes(r) for r in a.cpu().numpy()}
    assert len(rows) == 3000                              # distinct keys
    for r, n in zip(a.cpu().numpy()[:50], al.cpu().numpy()[:50]):
        assert r[n:].sum() == 0 and r[:n].all()           # padded, no zeros


def test_ycsb_keys_are_user_and_19_digits(device):
    """Record ``i`` is ``user`` + ``fnvhash64(i)`` in decimal, unpadded, as
    ``CoreWorkload.buildKeyName`` names it (``user6284781860667377211`` is
    YCSB's first key)."""
    kb, kl = ycsb.generate(2000, 0, device)
    got = [bytes(r[:n]) for r, n in zip(kb.cpu().numpy(), kl.cpu().numpy())]
    assert got == [f"user{java_fnvhash64(i)}".encode() for i in range(2000)]
    assert got[0] == b"user6284781860667377211"
    assert max(len(k) for k in got) <= ycsb.WIDTH


@pytest.mark.parametrize("val", [0, 1, 255, 256, 65535, 10**7, 2**31 - 1,
                                 sz.ITEM_COUNT, 2**62 + 12345])
def test_fnvhash64_wraps_as_java_does(val, device):
    got = ycsb.fnvhash64(torch.tensor([val], dtype=torch.int64, device=device))
    assert int(got[0]) == java_fnvhash64(val)


def test_key_names_have_no_zero_padding(device):
    nums = torch.tensor([0, 7, 10, 1234, 10**18, 2**63 - 1], device=device)
    kb, kl = ycsb.key_names(nums)
    got = [bytes(r[:n]) for r, n in zip(kb.cpu().numpy(), kl.cpu().numpy())]
    assert got == [f"user{int(x)}".encode() for x in nums.cpu()]
    assert int(kb[:, 4 + 19:].sum()) == 0


def test_scrambled_zipfian_follows_the_seed_and_copies_numpy(device):
    """The same seed draws the same requests and another seed others; each
    is ``fnvhash64(rank) % (recordcount + 1)`` for the seed's uniforms in
    numpy's order, drawn again (in a later pass) where it lands past the
    loaded records, as ``CoreWorkload.nextKeynum`` does."""
    d = dists.load("scrambled_zipfian")
    p = {"name": "scrambled_zipfian", "theta": 0.99}
    a = d.draw(np.random.default_rng(1), 1000, (3, 5000), p, device)
    b = d.draw(np.random.default_rng(1), 1000, (3, 5000), p, device)
    c = d.draw(np.random.default_rng(2), 1000, (3, 5000), p, device)
    assert a.shape == (3, 5000)
    assert torch.equal(a, b) and not torch.equal(a, c)
    rng = np.random.default_rng(1)
    want, todo, passes = [None] * 15000, list(range(15000)), 0
    while todo:
        us = torch.from_numpy(rng.random(len(todo))).to(device)
        ranks = sz._ranks(us).tolist()
        nxt = []
        for i, rank in zip(todo, ranks):
            want[i] = java_fnvhash64(rank) % 1001
            if want[i] >= 1000:
                nxt.append(i)
        todo, passes = nxt, passes + 1
    assert a.reshape(-1).tolist() == want and passes > 1


def test_ycsb_ranks_follow_the_closed_form(device):
    """``_ranks`` is ``ZipfianGenerator.nextLong`` over ``[0,
    ITEM_COUNT]``: its two special cases, both sides of each, and its
    tail (to the ulp of the power, where the device's may differ)."""
    us = [0.0, 0.03, 0.0377, 0.038, 0.05, 0.0566, 0.06, 0.5, 0.9, 0.999999]
    got = sz._ranks(torch.tensor(us, dtype=torch.float64, device=device))
    items = sz.ITEM_COUNT + 1
    zeta2 = 1 + 0.5 ** 0.99
    eta = (1 - (2.0 / items) ** 0.01) / (1 - zeta2 / sz.ZETAN)
    for u, g in zip(us, got.tolist()):
        want = (0 if u * sz.ZETAN < 1 else 1 if u * sz.ZETAN < zeta2
                else int(items * (eta * u - eta + 1) ** 100))
        assert abs(g - want) <= max(1, want * 1e-12), (u, g, want)
    assert got.tolist()[:4] == [0, 0, 0, 1] and got.tolist()[5] == 1


def test_the_hot_records_are_the_same_for_every_seed(device):
    """The scramble is a hash, as YCSB's: two seeds put the same records
    first, and the top record takes about 1 / ZETAN of the requests."""
    d = dists.load("scrambled_zipfian")
    p = {"name": "scrambled_zipfian", "theta": 0.99}
    tops = []
    for seed in (3, 4):
        x = d.draw(np.random.default_rng(seed), 100000, (1, 200000), p,
                   device).reshape(-1)
        assert int(x.min()) >= 0 and int(x.max()) < 100000
        c = torch.bincount(x, minlength=100000)
        tops.append(torch.topk(c, 5).indices.tolist())
        assert abs(int(c.max()) / x.numel() - 1 / sz.ZETAN) < 0.003
    assert tops[0] == tops[1]
    assert tops[0][0] == java_fnvhash64(0) % 100001
