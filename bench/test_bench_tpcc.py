"""TPC-C's customer-name key set held against a plain transcription of the
specification's population loop, and the ``tpcc-c`` cell run small: sound,
it is correct; with the timed path broken or the control in the program's
place, it is not."""
import numpy as np
import pytest
import torch

from bench import harness
from bench.keysets import tpcc_customer as tpcc
from bench.reference.control import HashtagOnly
from bench.test_bench_harness import lookup_altered, lookup_half

SMALL = {"recordcount": 21000}           # 7 districts
TRAFFIC = {"pool": 2, "sample_lanes": 1024,
           "rounds": [{"op": "lookup", "batch": 1024}]}


@pytest.fixture
def device():
    """The card where there is one, else the CPU, with few threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield torch.device("cuda" if torch.cuda.is_available() else "cpu")
    torch.set_num_threads(n)


def rows(kb, kl):
    return [bytes(r[:n]) for r, n in zip(kb.cpu().numpy(), kl.cpu().numpy())]


def spec_population(warehouses: int):
    """4.3.3.1's loop, customer by customer, from the same numpy draws in
    the order the module's docstring gives."""
    syl = ["BAR", "OUGHT", "ABLE", "PRI", "PRES", "ESE", "ANTI", "CALLY",
           "ATION", "EING"]
    chars = ("0123456789ABCDEFGHIJKLMNOPQRSTUVWXYZ"
             "abcdefghijklmnopqrstuvwxyz")
    n_d, n = 10 * warehouses, 30000 * warehouses
    rng = np.random.default_rng(511)
    c_load = int(rng.integers(0, 256))
    r_a = rng.integers(0, 256, size=(n_d, 2000), dtype=np.int16)
    r_xy = rng.integers(0, 1000, size=(n_d, 2000), dtype=np.int16)
    flen = rng.integers(8, 17, size=n, dtype=np.uint8)
    quads = rng.integers(0, 62 ** 4, size=(n, 4), dtype=np.uint32)
    keys = []
    for w in range(1, warehouses + 1):
        for d in range(1, 11):
            dist = 10 * (w - 1) + d - 1
            for c in range(1, 3001):
                if c <= 1000:
                    num = c - 1
                else:
                    a, b = int(r_a[dist, c - 1001]), int(r_xy[dist, c - 1001])
                    num = ((a | b) + c_load) % 1000          # NURand
                last = "".join(syl[int(x)] for x in f"{num:03d}")
                i = len(keys)
                first = ""
                for q in quads[i]:
                    q = int(q)
                    first += "".join(chars[q // 62 ** (3 - k) % 62]
                                     for k in range(4))
                keys.append(w.to_bytes(4, "big") + d.to_bytes(4, "big")
                            + last.encode().ljust(16, b"\0")
                            + first[:flen[i]].encode())
    return keys


def test_population_equals_the_spec_loop_at_one_warehouse(device):
    kb, kl = tpcc.generate(30000, 5, device)
    assert kb.shape == (30000, tpcc.WIDTH) and kb.dtype == torch.uint8
    assert rows(kb, kl) == spec_population(1)
    pad = torch.arange(tpcc.WIDTH, device=kb.device) >= kl[:, None].long()
    assert int((kb * pad).sum()) == 0                   # zero-padded


@pytest.mark.parametrize("num,name", [(371, "PRICALLYOUGHT"),
                                      (40, "BARPRESBAR"), (0, "BARBARBAR"),
                                      (999, "EINGEINGEING")])
def test_last_names_follow_4_3_2_3(num, name):
    assert tpcc.last_name(num) == name


def test_each_district_names_its_first_1000_customers_in_order(device):
    kb, _ = tpcc.generate(21000, 0, device)
    names = [tpcc.last_name(i).encode().ljust(16, b"\0") for i in range(1000)]
    for dist in range(7):
        got = kb[3000 * dist:3000 * dist + 1000, 8:24].cpu().numpy()
        assert [bytes(r) for r in got] == names
        w, d = divmod(dist, 10)
        assert bytes(kb[3000 * dist, :8].tolist()) == (
            (w + 1).to_bytes(4, "big") + (d + 1).to_bytes(4, "big"))


def test_nurand_stays_in_0_to_999():
    a = np.arange(256, dtype=np.int16)[:, None]
    b = np.arange(1000, dtype=np.int16)[None, :]
    for c in (0, 1, 193, 255):
        v = tpcc.nurand(a, b, np.int16(c))
        assert v.min() >= 0 and v.max() <= 999
    c_load, num = tpcc.last_numbers(40, np.random.default_rng(7))
    assert 0 <= c_load <= 255 and num.min() >= 0 and num.max() <= 999
    # NURand is skewed: some names are far more common than others
    counts = np.bincount(num[:, 1000:].reshape(-1), minlength=1000)
    assert counts.max() > 4 * counts.mean()


def test_first_names_are_8_to_16_alphanumerics(device):
    kb, kl = tpcc.generate(30000, 0, device)
    firsts = [k[24:] for k in rows(kb, kl)]
    lens = np.bincount([len(f) for f in firsts])
    assert lens[:8].sum() == 0 and len(lens) == 17 and lens[8:].min() > 2500
    used = set(b"".join(firsts))
    assert used == set(tpcc.ALNUM)
    assert int(kl.min()) == 32 and int(kl.max()) == 40


def test_keys_are_distinct_and_ordered_by_w_d_last_first(device):
    kb, kl = tpcc.generate(60000, 0, device)
    keys = rows(kb, kl)
    assert len(set(keys)) == len(keys)
    fields = [(int.from_bytes(k[:4], "big"), int.from_bytes(k[4:8], "big"),
               k[8:24].rstrip(b"\0"), k[24:]) for k in keys]
    by_bytes = sorted(range(len(keys)), key=keys.__getitem__)
    by_fields = sorted(range(len(keys)), key=fields.__getitem__)
    assert by_bytes == by_fields
    # the skew the index sees: 3,000 keys a district behind 8 bytes, and
    # the four bytes after them take at most 25 values (10 first
    # syllables, three of them 3 letters long)
    assert len({k[:8] for k in keys}) == 20
    assert len({k[8:12] for k in keys}) <= 25


def test_keys_are_the_same_for_every_run_seed(device):
    a, al = tpcc.generate(9000, 1, device)
    b, bl = tpcc.generate(9000, 2 ** 33 + 17, device)
    assert torch.equal(a, b) and torch.equal(al, bl)
    with pytest.raises(ValueError):
        tpcc.generate(10000, 1, device)


def test_a_first_name_that_repeats_a_key_is_drawn_again(device, monkeypatch):
    """Every record's first draw is the same ``C_FIRST``: in each group of
    one warehouse, district and ``C_LAST`` the first record keeps it and
    the later ones draw again, until the keys are distinct."""
    real = tpcc.first_draws
    calls = []

    def same_first(k, rng):
        flen, quads = real(k, rng)
        if not calls:
            flen[:], quads[:] = flen[0], quads[0]
        calls.append(k)
        return flen, quads
    monkeypatch.setattr(tpcc, "first_draws", same_first)
    kb, kl = tpcc.generate(6000, 0, device)
    keys = rows(kb, kl)
    assert len(set(keys)) == 6000 and len(calls) >= 2
    planted = keys[0][24:]
    group = [k[:24] for k in keys]
    seen = set()
    for k, g in zip(keys, group):
        assert (k[24:] == planted) == (g not in seen)
        seen.add(g)
    assert calls[1] == 6000 - len(seen)
    flag = tpcc.repeats(torch.tensor([3, 3, 4, 3]),
                        torch.tensor([[65] * 16] * 4, dtype=torch.uint8))
    assert flag.tolist() == [False, True, False, True]


def small_cell():
    return harness.Cell("tpcc-c", config=SMALL, traffic=TRAFFIC)


def test_a_small_tpcc_c_run_is_correct(device):
    cell = small_cell()
    assert cell.config["key_set"] == "tpcc_customer"
    assert [m["name"] for m in cell.per_layer][-1] == "k1_wide_roofline"
    res = harness.run_cell(cell, 2 ** 33 + 5, 0.3, False, device=device)
    checks = res["checks"]
    assert checks["wrong_answers"]["value"] == 0, checks
    assert checks["answers_compared"]["value"] > 0
    assert res["correct"] == (checks["jax_modules_loaded"]["value"] == 0)
    assert {"ops_per_s", "batch_p95_ms", "setup_s"} <= set(res["metrics"])


@pytest.mark.parametrize("fault", [lookup_half, lookup_altered, None],
                         ids=["lookup_half", "lookup_altered", "control"])
def test_a_broken_path_or_the_control_is_not_correct(fault, device,
                                                     monkeypatch):
    from repro_torch.core import batch_ops
    cell = small_cell()
    cell.traffic["sample_lanes"] = 4096               # every lane judged
    kw = {"system": HashtagOnly} if fault is None else {}
    if fault is not None:
        monkeypatch.setattr(batch_ops, "lookup_batch",
                            fault(batch_ops.lookup_batch))
    res = harness.run_cell(cell, 11, 0.3, False, device=device, **kw)
    assert res["attempted"] >= 2 * 1024
    assert not res["correct"]
    assert res["checks"]["wrong_answers"]["value"] > 0


def test_chip_smoke_tpcc_phase_rehearses_on_the_cpu(device):
    """``chip_smoke.run_tpcc`` at 7 districts: every present key found with
    its record id, every key with its last byte changed absent, and K1 (the
    plain version on the CPU) equal to the plain version on the first and
    the ragged last batch."""
    import chip_smoke
    out = chip_smoke.run_tpcc(21000, seed=7, device=device, batch=4096)
    assert out["batches"] == 6 and out["kernel_vs_plain_lanes"] == [4096, 520]
    assert out["present_found"] == out["present"] > 0
    assert out["flipped_absent"] == out["flipped"] > 0
    assert out["present"] + out["flipped"] == 21000
    assert out["key_lens"] == [32, 40] and out["width"] == 40
    assert out["kernel_vs_plain_max_abs_err"] == 0
