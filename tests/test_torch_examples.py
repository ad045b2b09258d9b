"""The four example twins (``examples/*_torch.py``) on the CPU, each at its
own size, in this process. Their deterministic lines must equal the
reference examples' lines, which stand here as literals, taken from one
run of each reference example on the CPU (``PYTHONPATH=src:. python
examples/quickstart.py``, ``examples/ycsb_demo.py`` and
``examples/serve_lm.py``; ~40 s, ~30 s and ~30 s there, too slow to run
here). The reference's ``train_loop`` fails on JAX 0.9 (ROADMAP queue 3),
so ``train_lm_torch.py`` is held on its own JSON."""
import importlib.util
import json
import os

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

QUICKSTART_LINES = """\
built: 10000 keys, height=3, leaves=209
lookup: [(True, 100), (False, 0), (True, 9999)]
after update: 777
inserted 1000 keys in 1 bulk-split rounds (21 leaf splits)
rebuild: 7500 live keys in 157 leaves (2500 pool rows reclaimed)
scan from user:000399 -> ['user:000400', 'user:000401', 'user:000404', 'user:000405', 'user:000408']
base          key_compares/op= 8.19 modeled_lines/op= 34.8
feature+hash  key_compares/op= 0.05 modeled_lines/op= 13.8
sharded lookup (owner per query: [0, 0, 3] ) -> [(True, 100), (False, 0), (True, 9999)]
rebalance: (2500, 2500, 2500, 2500) -> (2500, 2500, 2500, 2500)
""".splitlines()

YCSB_LINES = """\
== YCSB-C / A on the url dataset (heavy prefix skew) ==
  base          found=True keycmp/op= 8.05 lines/op= 34.4 suffix_bs/op=2.000
  feature       found=True keycmp/op= 4.21 lines/op= 34.4 suffix_bs/op=1.701
  feature+hash  found=True keycmp/op= 4.21 lines/op= 24.5 suffix_bs/op=1.701
  YCSB-A updates: batch=4096, in-batch dup ops superseded=2552 (latch-free last-writer-wins)

== prefix cache: shared system prompts ==
  wave 0: hit blocks per request = [0, 0, 0, 0, 0, 0, 0, 0] (prefix hit rate so far 0.00)
  wave 1: hit blocks per request = [4, 4, 4, 4, 4, 4, 4, 4] (prefix hit rate so far 0.29)
  wave 2: hit blocks per request = [4, 4, 4, 4, 4, 4, 4, 4] (prefix hit rate so far 0.38)
  wave 3: hit blocks per request = [4, 4, 4, 4, 4, 4, 4, 4] (prefix hit rate so far 0.43)
  tree stats: {'lookups': 224, 'hits': 96, 'inserts': 128, 'evicts': 0, 'rebuilds': 0}
""".splitlines()

# examples/serve_lm.py's JSON, but for tok_per_s (a wall-clock rate)
SERVE_REF = {"requests": 24, "all_done": True, "new_tokens": 288,
             "prefix_hit_rate": 0.5,
             "tree_stats": {"lookups": 144, "hits": 72, "inserts": 72,
                            "evicts": 0, "rebuilds": 0},
             "decode_steps": 66}


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def twin(name):
    path = os.path.join(ROOT, "examples", name + ".py")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run(capsys, name, *argv):
    twin(name).main(["--device", "cpu", *argv])
    return capsys.readouterr().out.splitlines()


def _launches(lines):
    assert lines[-1].startswith("launches: ")
    return json.loads(lines[-1][len("launches: "):])


def test_quickstart_twin_lines_equal_reference(capsys):
    lines = _run(capsys, "quickstart_torch")
    assert lines[:-1] == QUICKSTART_LINES
    assert _launches(lines) == {"fused_descent": 0, "fused_scan": 0}  # CPU


def test_ycsb_demo_twin_lines_equal_reference(capsys):
    lines = _run(capsys, "ycsb_demo_torch")
    assert lines[:-1] == YCSB_LINES
    assert set(_launches(lines)) == {"fused_descent", "fused_scan"}


def test_ycsb_demo_twin_keeps_the_benchmark_dataset():
    """The twin's copies of ``benchmarks/common.py``'s generators give the
    same keys and draws."""
    import numpy as np
    from benchmarks import common as BC
    mod = twin("ycsb_demo_torch")
    assert mod.make_dataset("url", 2000) == BC.make_dataset("url", 2000)
    a = mod.zipf_indices(np.random.default_rng(3), 1000, 500, 0.99)
    b = BC.zipf_indices(np.random.default_rng(3), 1000, 500, 0.99)
    assert np.array_equal(a, b)


def test_serve_lm_twin_equals_reference_json(capsys):
    lines = _run(capsys, "serve_lm_torch")
    got = json.loads(lines[-1])
    assert got["device"] == "cpu"
    assert {k: got[k] for k in SERVE_REF} == SERVE_REF


def test_train_lm_twin_learns_and_restarts_once(capsys, tmp_path):
    lines = _run(capsys, "train_lm_torch", "--steps", "30", "--batch", "4",
                 "--seq", "64", "--ckpt", str(tmp_path / "ck"))
    start = max(i for i, l in enumerate(lines) if l == "{")
    out = json.loads("\n".join(lines[start:]))
    assert out["last5"] < out["first5"]
    assert len(out["restarts"]) == 1
    assert out["restarts"][0]["step"] == 28
