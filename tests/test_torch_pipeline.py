"""The port's GPipe schedule (``repro_torch.parallel.pipeline``) against
the reference's on one stage (``tests/test_pipeline.py``'s case), and
against the stages applied in sequence on 2 and 4 stages, in one process
(with autograd) and across 2 gloo ranks (``tests/torch_gloo.py``). The
reference's own multi-stage run returns zeros (ROADMAP queue 3):
``test_reference_multi_stage_pipeline_returns_zeros`` shows it."""
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.launch.mesh import make_pipeline_mesh as ref_pipeline_mesh
from repro.parallel.pipeline import pipeline_apply as ref_pipeline_apply
from repro_torch.launch.mesh import make_pipeline_mesh
from repro_torch.parallel.pipeline import bubble_fraction, pipeline_apply

import torch_gloo

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def stage(w, x):
    return torch.tanh(x @ w)


def sequential(W, x, n_micro):
    """The stages applied in sequence, microbatch by microbatch."""
    mb = x.shape[0] // n_micro
    out = []
    for m in range(n_micro):
        h = x[m * mb:(m + 1) * mb]
        for s in range(W.shape[0]):
            h = stage(W[s], h)
        out.append(h)
    return torch.cat(out)


def test_pipeline_single_stage_matches_reference():
    mesh = ref_pipeline_mesh(1)
    W = jax.random.normal(jax.random.PRNGKey(0), (1, 16, 16))
    x = jax.random.normal(jax.random.PRNGKey(1), (8, 16))
    with mesh:
        want = ref_pipeline_apply(mesh, lambda w, h: jnp.tanh(h @ w), W, x,
                                  n_micro=4)
    got = pipeline_apply(make_pipeline_mesh(1, device="cpu"), stage,
                         torch.from_numpy(np.array(W)),
                         torch.from_numpy(np.array(x)), n_micro=4)
    assert np.allclose(got.numpy(), np.asarray(want), atol=1e-5)
    assert np.allclose(got.numpy(), np.tanh(np.asarray(x) @ np.asarray(W)[0]),
                       atol=1e-5)


@pytest.mark.parametrize("n_stages", [2, 4])
def test_in_process_stages_match_sequential_with_grads(n_stages):
    rng = np.random.default_rng(n_stages)
    W = torch.from_numpy(rng.standard_normal((n_stages, 16, 16)) * 0.5)
    x = torch.from_numpy(rng.standard_normal((8, 16)))
    g = torch.from_numpy(rng.standard_normal((8, 16)))
    W.requires_grad_(True)
    x.requires_grad_(True)
    y = pipeline_apply(make_pipeline_mesh(n_stages, device="cpu"), stage, W,
                       x, n_micro=4)
    want = sequential(W, x, 4)
    assert torch.equal(y, want)
    gx, gw = torch.autograd.grad((y * g).sum(), (x, W))
    wx, ww = torch.autograd.grad((want * g).sum(), (x, W))
    assert torch.equal(gx, wx) and torch.equal(gw, ww)
    # against the whole batch at once, stage after stage
    whole = x
    for s in range(n_stages):
        whole = stage(W[s], whole)
    assert torch.allclose(y, whole, rtol=0, atol=1e-12)
    assert bubble_fraction(n_stages, 4) == (n_stages - 1) / (4 + n_stages - 1)


def test_inactive_stages_compute_nothing():
    calls = []

    def counting(w, h):
        calls.append(h.shape[0])
        return stage(w, h)

    x = torch.randn(12, 16, dtype=torch.float64)
    W = torch.randn(3, 16, 16, dtype=torch.float64)
    pipeline_apply(make_pipeline_mesh(3, device="cpu"), counting, W, x,
                   n_micro=6)
    assert calls == [2] * 18       # n_stages x n_micro, no bubble work


def test_gloo_two_ranks_match_sequential():
    outs = torch_gloo.run_ranks("pipeline", 2, timeout=90)
    for o in outs:
        assert o["equal"], o
        assert o["max_abs_y"] > 0.5


_REF_TWO_STAGES = r"""
import json, sys
import numpy as np
import jax, jax.numpy as jnp
from repro.parallel.pipeline import pipeline_apply
mesh = jax.make_mesh((2,), ("stage",))
rng = np.random.default_rng(0)
W = (rng.standard_normal((2, 16, 16)) * 0.5).astype(np.float32)
x = rng.standard_normal((8, 16)).astype(np.float32)
with mesh:
    y = pipeline_apply(mesh, lambda w, h: jnp.tanh(h @ w), jnp.asarray(W),
                       jnp.asarray(x), n_micro=4)
np.savez(sys.argv[1], W=W, x=x, y=np.asarray(y))
print(json.dumps({"devices": jax.device_count()}))
"""


def test_reference_multi_stage_pipeline_returns_zeros(tmp_path):
    """The reference's ``pipeline_apply`` on 2 host devices returns all
    zeros: only the last stage writes ``out``, and ``out_specs=P()`` reads
    it from another (src/repro/parallel/pipeline.py:59-60, :76-77). The
    port on the same inputs equals the stages in sequence."""
    path = str(tmp_path / "ref.npz")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=2")
    res = subprocess.run([sys.executable, "-c", _REF_TWO_STAGES, path],
                         cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0, res.stderr[-3000:]
    assert json.loads(res.stdout.strip().splitlines()[-1])["devices"] == 2
    with np.load(path) as f:
        W, x, y_ref = f["W"], f["x"], f["y"]
    want = sequential(torch.from_numpy(W), torch.from_numpy(x), 4)
    assert float(np.abs(y_ref).max()) == 0.0              # the fault
    assert float(want.abs().max()) > 0.5
    got = pipeline_apply(make_pipeline_mesh(2, device="cpu"), stage,
                         torch.from_numpy(W), torch.from_numpy(x), n_micro=4)
    assert torch.equal(got, want)


def test_chip_smoke_parallel_phase_rehearses_on_the_cpu():
    """``chip_smoke.rehearse_parallel``: the card's ``parallel`` phase on
    the CPU (a one-rank gloo group for the placement; the pipelines at
    small widths)."""
    import chip_smoke
    out = chip_smoke.rehearse_parallel(seed=0)
    assert out["fails"] == []
    assert out["placement"]["loss"] == out["placement"]["train_first_loss"]
    assert out["pipeline_dense"]["equal_to_sequential"]
    assert out["pipeline_yi"]["vs_unpipelined"]["y_equal"]
