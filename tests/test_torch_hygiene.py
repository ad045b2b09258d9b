"""The port stands alone: no module of ``repro_torch``, and not
``chip_smoke.py`` nor the port's tools (``tools/chaos_sweep_torch.py``,
``tools/tree_bench.py``, ``tools/k5_bench.py``, ``tools/decode_drift.py``)
nor the example twins (``examples/*_torch.py``), imports JAX or anything
of the reference package."""
import ast
import os
import pkgutil
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "src", "repro_torch")
FORBIDDEN = ("jax", "jaxlib", "repro", "benchmarks")
TOOLS = ("chaos_sweep_torch", "tree_bench", "k5_bench", "decode_drift")
EXAMPLES = ("quickstart_torch", "ycsb_demo_torch", "serve_lm_torch",
            "train_lm_torch")


def _port_modules():
    import repro_torch
    names = ["repro_torch"]
    for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
        names.append(m.name)
    return names


def test_importing_every_port_module_loads_no_jax_or_reference():
    mods = _port_modules()
    assert "repro_torch.kernels.fused_descent.cuda" in mods
    # the walk reaches the serving slice's subpackages too
    for m in ("repro_torch.kernels.flash_attention.cuda",
              "repro_torch.serving.engine", "repro_torch.models.lm",
              "repro_torch.configs.yi_9b", "repro_torch.launch.serve",
              "repro_torch.core.lifecycle", "repro_torch.core.protocol",
              "repro_torch.shard.ops", "repro_torch.shard.router",
              "repro_torch.train.train_step", "repro_torch.train.checkpoint",
              "repro_torch.launch.train", "repro_torch.parallel.compression",
              "repro_torch.parallel.sharding", "repro_torch.parallel.pipeline",
              "repro_torch.launch.dryrun", "repro_torch.launch.dryrun_pipeline",
              "repro_torch.launch.cost_analysis", "repro_torch.launch.report",
              "repro_torch.parallel.dtensor"):
        assert m in mods, m
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r} + ['chip_smoke']:\n"
        "    importlib.import_module(m)\n"
        f"sys.path.insert(0, {os.path.join(ROOT, 'tools')!r})\n"
        f"for m in {TOOLS!r}:\n"
        "    importlib.import_module(m)\n"
        f"sys.path.insert(0, {os.path.join(ROOT, 'examples')!r})\n"
        f"for m in {EXAMPLES!r}:\n"
        "    importlib.import_module(m)\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r})\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr


def _sources():
    for dirpath, _, files in os.walk(PKG):
        for fn in files:
            if fn.endswith(".py"):
                yield os.path.join(dirpath, fn)
    yield os.path.join(ROOT, "chip_smoke.py")
    for t in TOOLS:
        yield os.path.join(ROOT, "tools", t + ".py")
    for e in EXAMPLES:
        yield os.path.join(ROOT, "examples", e + ".py")


@pytest.mark.parametrize("path", sorted(_sources()),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_no_source_imports_jax_or_reference(path):
    with open(path, encoding="utf-8") as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for n in names:
            assert n.split(".")[0] not in FORBIDDEN, (path, n)
