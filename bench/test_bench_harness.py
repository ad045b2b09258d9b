"""The harness end to end at a small size: cells are found by name, a sound
run is correct, and ``correct`` comes out false with the timed path broken
underneath or the control in the program's place. Runs on the card where
there is one, else on the CPU (the port's plain versions stand in for its
kernels there)."""
import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from bench import harness
from bench.reference.control import HashtagOnly

ROOT = Path(__file__).resolve().parents[1]
SMALL = {"recordcount": 20000}
TRAFFIC = {
    "workload-c": {"rounds": [{"op": "lookup", "batch": 1024}]},
    "workload-a": {"rounds": [{"op": "lookup", "batch": 512},
                              {"op": "update", "batch": 512}]},
    "workload-e": {"rounds": [{"op": "scan", "batch": 256, "max_items": 50},
                              {"op": "insert", "batch": 200, "rounds": 400}]},
    # reads beside inserts, as YCSB D mixes them: the judge ranks each
    # lookup against the reference as the inserts before it left it
    "mixed": {"rounds": [{"op": "insert", "batch": 200, "rounds": 400},
                         {"op": "lookup", "batch": 512},
                         {"op": "update", "batch": 256}]},
}
EXTRA = {"ycsb-e": "workload-e", "ycsb-mixed": "mixed"}


@pytest.fixture
def device():
    """The card where there is one, else the CPU, with few threads: the
    small ops gain nothing from more, and test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield "cuda" if torch.cuda.is_available() else "cpu"
    torch.set_num_threads(n)


def small(name):
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    traffic = {w["name"]: w["traffic"] for w in spec["workloads"]}.get(
        name) or EXTRA[name]
    return harness.Cell(name, config=SMALL,
                        traffic={"pool": 2, "sample_lanes": 1024,
                                 **TRAFFIC[traffic]})


def run(cell, device, seed=123, **kw):
    """A short window; ycsb-e's a longer one, so that a later round's
    scans can see an earlier round's inserts."""
    seconds = 1.5 if cell.name in EXTRA else 0.3
    return harness.run_cell(cell, seed, seconds, False, device=device, **kw)


def with_e(monkeypatch):
    """``BENCHMARK.json`` with the ycsb-e cell (kept out of the benchmark:
    its card idles most of a window) and a mix of reads and inserts added,
    to drive scans and inserts."""
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    for name, traffic in EXTRA.items():
        spec["workloads"].append({"name": name, "config": "ycsb-10M",
                                  "traffic": "workload-e", "chips": 1,
                                  "why": "-"})
    real = harness._json
    monkeypatch.setattr(harness, "_json", lambda p: spec if p.name ==
                        "BENCHMARK.json" else real(p))


def test_every_cell_finds_its_files():
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    for w in spec["workloads"]:
        cell = harness.Cell(w["name"])
        assert cell.config["recordcount"] > 0 and cell.traffic["rounds"]
        assert {m["name"] for m in cell.end_to_end} >= {"setup_s"}
        for m in cell.per_layer:
            assert callable(harness.load_metric(m["name"]).read)
    for c in spec["configs"]:
        assert (ROOT / c["file"]).is_file()
    with pytest.raises(SystemExit):
        harness.Cell("no-such-cell")


@pytest.mark.parametrize("name", ["ycsb-c", "ycsb-a", "ycsb-e",
                                  "ycsb-mixed"])
def test_a_sound_run_is_correct(name, device, monkeypatch):
    with_e(monkeypatch)
    res = run(small(name), device)
    checks = res["checks"]
    assert checks["wrong_answers"]["value"] == 0, checks
    assert checks["answers_compared"]["value"] > 0
    # a test process that imported JAX for other tests reads as not correct
    assert res["correct"] == (checks["jax_modules_loaded"]["value"] == 0)
    assert res["attempted"] > 0 and res["failed"] == 0
    assert {"ops_per_s", "batch_p95_ms", "setup_s"} <= set(res["metrics"])


def test_every_call_is_judged(device):
    """Each lookup of the window keeps its sampled lanes and is judged:
    the answers compared are the calls times the lanes."""
    cell = small("ycsb-c")
    cell.traffic["sample_lanes"] = 100
    res = run(cell, device)
    calls = res["attempted"] // 1024
    assert calls > 2
    assert res["checks"]["answers_compared"]["value"] == calls * 100


def test_the_traced_run_reads_the_per_layer_metrics(device):
    res = harness.run_cell(small("ycsb-a"), 7, 0.3, True, device=device)
    assert res["checks"]["wrong_answers"]["value"] == 0
    assert {"device_idle_pct", "op_call_host_ms"} <= set(res["metrics"])
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    assert res["device"]["window_s"] > 0


def test_the_control_is_not_correct(device):
    for name in ("ycsb-c", "ycsb-a"):
        res = run(small(name), device, system=HashtagOnly)
        assert not res["correct"]
        assert res["checks"]["wrong_answers"]["value"] > 0


def lookup_half(real):
    """Half of the batch left out: the second half answers not found."""
    def f(tree, qb, ql, **kw):
        vals, rep = real(tree, qb, ql, **kw)
        h = qb.shape[0] // 2
        vals, found = vals.clone(), rep.found.clone()
        vals[h:], found[h:] = 0, False
        return vals, rep._replace(found=found)
    return f


def lookup_altered(real):
    """One answer altered where it is produced."""
    def f(tree, qb, ql, **kw):
        vals, rep = real(tree, qb, ql, **kw)
        vals = vals.clone()
        vals[qb.shape[0] // 3] += 1
        return vals, rep
    return f


def update_unchanged(real):
    """A step that returns its state unchanged."""
    def f(tree, qb, ql, vals, **kw):
        _, rep = real(tree, qb, ql, vals, **kw)
        return tree, rep
    return f


def insert_unchanged(real):
    def f(tree, qb, ql, vals, **kw):
        _, rep, rounds = real(tree, qb, ql, vals, **kw)
        return tree, rep, rounds
    return f


def scan_altered(real):
    def f(tree, qb, ql, **kw):
        kid, val, n, re = real(tree, qb, ql, **kw)
        val = val.clone()
        val[0, 0] += 1
        return kid, val, n, re
    return f


@pytest.mark.parametrize("name,op,fault", [
    ("ycsb-c", "lookup_batch", lookup_half),
    ("ycsb-c", "lookup_batch", lookup_altered),
    ("ycsb-mixed", "lookup_batch", lookup_altered),
    ("ycsb-a", "update_batch", update_unchanged),
    ("ycsb-a", "lookup_batch", lookup_altered),
    ("ycsb-e", "insert_batch", insert_unchanged),
    ("ycsb-e", "range_scan", scan_altered),
])
def test_a_broken_timed_path_is_not_correct(name, op, fault, device,
                                            monkeypatch):
    from repro_torch.core import batch_ops
    with_e(monkeypatch)
    monkeypatch.setattr(batch_ops, op, fault(getattr(batch_ops, op)))
    cell = small(name)
    cell.traffic["sample_lanes"] = 4096          # every lane judged
    res = run(cell, device)
    calls = sum(o["batch"] for o in cell.traffic["rounds"])
    assert res["attempted"] >= 2 * calls          # two rounds or more ran
    assert not res["correct"]
    assert res["checks"]["wrong_answers"]["value"] > 0


def test_a_run_loads_no_jax_and_refuses_without_a_card():
    """In a process of its own: the run loads nothing of JAX, the JAX
    package, ``benchmarks`` or ``chip_smoke`` (names compared whole, as
    ``repro_torch`` starts with ``repro``), and the command exits with
    another code than 0, printing nothing, where there is no card."""
    code = (
        "import sys, torch; sys.path[:0] = ['src']\n"
        "torch.set_num_threads(1)\n"
        "from bench import harness\n"
        "cell = harness.Cell('ycsb-a', config={'recordcount': 5000}, "
        "traffic={"
        "'pool': 1, 'rounds': [{'op': 'lookup', 'batch': 256}, "
        "{'op': 'update', 'batch': 256}]})\n"
        "res = harness.run_cell(cell, 1, 0.2, False, device='cpu')\n"
        "bad = {m.split('.')[0] for m in sys.modules} & harness.BANNED\n"
        "print(res['correct'], sorted(bad), 'repro_torch' in sys.modules)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                         capture_output=True, text=True).stdout
    assert out.split("\n")[-2] == "True [] True"
    if not torch.cuda.is_available():
        p = subprocess.run([sys.executable, "bench/run.py", "--workload",
                            "ycsb-c", "--seed", "1", "--seconds", "1",
                            "--trace", "0"], cwd=ROOT, capture_output=True,
                           text=True)
        assert p.returncode != 0 and p.stdout == ""


def test_kept_answers_grow_a_chunk_at_a_time():
    """Rows past a chunk go into a new one; every row reads back, and a
    column holds the rows kept, round by round."""
    kept = harness.Kept("cpu", ((3,), torch.int32), ((), torch.bool))
    n = 2 * harness.CHUNK + 5
    for r in range(n):
        kept.put(r, torch.full((3,), r, dtype=torch.int32),
                 torch.tensor(r % 2 == 0))
    assert len(kept.chunks) == 3 and kept.n == n
    assert [int(kept[r][0][1]) for r in range(n)] == list(range(n))
    assert kept.column(1).tolist() == [r % 2 == 0 for r in range(n)]
    assert harness._bytes(kept.tensors()) == 3 * (
        harness.CHUNK * 12 + harness.CHUNK)
