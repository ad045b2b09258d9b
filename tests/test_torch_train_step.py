"""The port's loss, gradients and train step against the reference's, and
the flash-attention Function's gradients: ``train.losses.loss_fn`` against
``jax.value_and_grad`` of ``repro.train.losses.loss_fn``, three
``make_train_step`` steps against ``jax.jit(repro...make_train_step)``
from one converted state (AdamW and Adafactor, ``n_micro`` 1 and 2,
``compress`` off and on), ``remat`` against plain autograd, and
``kernels.flash_attention.ops.flash_sdpa``'s backward against ``jax.grad``
of the reference's ``flash_sdpa`` (its Pallas kernel in interpret mode, as
``tests/test_kernels.py`` runs it) and of ``_sdpa_flash``.

Tolerances, stated with their reasons:

* float32 loss and gradients: 1e-5 of the largest reference value. Both
  sum float32 products in other orders (observed ~1e-6).
* bf16 loss: 2e-3 relative; bf16 gradients: 5e-2 of each gradient's
  largest element. Every op rounds to bf16 (8 significant bits) at other
  places in XLA's and torch's CPU kernels (observed 3e-4 and 1.8e-2).
* Three float32 train steps: loss, ce and grad_norm within 1e-5 relative
  (1e-4 with compression, whose int8 roundings feed steps 2 and 3), lr
  within 1e-6 (XLA's cosine and torch's, a few float32 ulps apart).
  State tensors: Adam's update m/sqrt(v) is a sign where a gradient is
  near zero, so a float32 difference can flip it: at most
  0.1% of each tensor's elements may be off by more than 1e-5 of its
  largest element, and none by more than 2·Σ lr + that (Adam's elementwise
  update is at most ~lr, Adafactor's clipped to an RMS of 1). With
  compression an element whose corrected gradient sits at a rounding
  midpoint of the int8 grid quantizes one step apart, and steps 2 and 3
  carry that on: at most 1% of the elements off by more than 1e-3 of the
  largest, none by more than 1e-2 of it plus 2·Σ lr; ``error_fb`` (each
  element at most half its block's step on either side) within twice its
  largest element, and after step 1 all but 0.1% within 1e-2 of it (the
  residual is ~1/254 of the gradient it comes from, so the gradients'
  float32 differences weigh ~254 times more in it).
* ``remat="full"`` and ``"dots"``: equal to ``"none"``'s gradients within
  1e-6 of each gradient's largest element (the same float32 ops
  recomputed; observed equal).
* ``flash_sdpa``'s gradients, float32: 1e-4 absolute on inputs of unit
  scale (the reference's own bound in ``test_kernels.py`` is 1e-3); the
  chunked backward against plain autograd through ``_sdpa_flash``: 1e-6
  (the same VJP, dk and dv summed over chunks in another order).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as r_get_config
from repro.kernels.flash_attention.ops import flash_sdpa as r_flash_sdpa
from repro.models import attention as RA
from repro.models import lm as rlm
from repro.train import losses as RL
from repro.train import optim as RO
from repro.train import train_step as RTS
from repro_torch.configs import get_config
from repro_torch.configs.common import smoke_batch
from repro_torch.kernels.flash_attention import ops as p_ops
from repro_torch.models import attention as PA
from repro_torch.models.convert import params_from_numpy
from repro_torch.train import losses as PL
from repro_torch.train import optim as O
from repro_torch.train.train_step import (_grads_of, init_state,
                                          make_eval_step, make_train_step)
from repro_torch.train.tree import tree_map, tree_paths

ARCHS = ("yi-9b", "qwen2.5-14b", "qwen3-14b", "nemotron-4-15b")


def _np(tree):
    return {k: np.asarray(v, np.float32) for k, v in
            tree_paths(jax.device_get(tree))}


def _close(got, want, rel, what):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want).max()
    assert err <= rel * max(np.abs(want).max(), 1e-30), (what, err)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_loss_fn_value_and_grads_match_reference(dtype):
    rc = r_get_config("yi-9b", smoke=True, param_dtype=dtype)
    pc = get_config("yi-9b", smoke=True, param_dtype=dtype)
    rp = rlm.init_params(rc, jax.random.PRNGKey(0))
    pp = params_from_numpy(jax.device_get(rp), "cpu")
    toks = np.random.default_rng(0).integers(0, rc.vocab, (2, 24)) \
        .astype(np.int32)
    (rl, rm), rg = jax.value_and_grad(
        lambda p: RL.loss_fn(p, rc, {"tokens": jnp.asarray(toks)}),
        has_aux=True)(rp)
    pg, pm = _grads_of(pp, pc, {"tokens": torch.from_numpy(toks)})
    loss_rel, grad_rel = (1e-5, 1e-5) if dtype == "float32" else (2e-3, 5e-2)
    for k in ("loss", "ce", "aux"):
        assert pm[k].dtype == torch.float32
        assert abs(float(pm[k]) - float(rm[k])) \
            <= loss_rel * max(abs(float(rm[k])), 1e-30), k
    want = _np(rg)
    for k, g in tree_paths(pg):
        assert g.dtype == pc.dtype, k              # grads in the params' dtype
        _close(g, want[k], grad_rel, k)
    # the eval step gives the same metrics, without gradients
    em = make_eval_step(pc)(pp, {"tokens": torch.from_numpy(toks)})
    assert float(em["loss"]) == float(pm["loss"])


def _state_ok(key, got, want, lr_sum, compress, first_step=False):
    d = np.abs(got - want)
    top = max(np.abs(want).max(), 1e-30)
    if key.startswith("error_fb"):
        if first_step:
            assert (d > 1e-2 * top).mean() <= 1e-3, key
        assert d.max() <= 2 * top + 1e-12, key
        return
    small, frac = (1e-3, 1e-2) if compress else (1e-5, 1e-3)
    assert (d > small * top).mean() <= frac, (key, (d > small * top).mean())
    cap = 2 * lr_sum + (1e-2 if compress else 1e-5) * top
    assert d.max() <= cap, (key, d.max(), cap)


@pytest.mark.parametrize("compress", [False, True], ids=["plain", "int8"])
@pytest.mark.parametrize("n_micro", [1, 2])
@pytest.mark.parametrize("kind", ["adamw", "adafactor"])
def test_train_steps_match_reference(kind, n_micro, compress):
    rc = r_get_config("yi-9b", smoke=True, param_dtype="float32")
    pc = get_config("yi-9b", smoke=True, param_dtype="float32")
    kw = dict(kind=kind, lr=1e-3, warmup=1, total_steps=10)
    rcfg, pcfg = RO.OptConfig(**kw), O.OptConfig(**kw)
    rs = RTS.init_state(rc, rcfg, jax.random.PRNGKey(0))
    ps = params_from_numpy(jax.device_get(rs), "cpu")
    rstep = jax.jit(RTS.make_train_step(rc, rcfg, n_micro=n_micro,
                                        compress=compress))
    pstep = make_train_step(pc, pcfg, n_micro=n_micro, compress=compress)
    lr_sum = 0.0
    rel = 1e-4 if compress else 1e-5
    for s in range(3):
        toks = np.random.default_rng(s).integers(0, rc.vocab, (4, 16)) \
            .astype(np.int32)
        rs, rm = rstep(rs, {"tokens": jnp.asarray(toks)})
        ps, pm = pstep(ps, {"tokens": torch.from_numpy(toks)})
        assert sorted(pm) == sorted(rm)
        for k in ("loss", "ce", "grad_norm"):
            assert abs(float(pm[k]) - float(rm[k])) \
                <= rel * abs(float(rm[k])), (s, k)
        assert abs(float(pm["lr"]) - float(rm["lr"])) \
            <= 1e-6 * float(rm["lr"])
        lr_sum += float(rm["lr"])
        if compress and s == 0:
            want = _np(rs["error_fb"])
            for k, t in tree_paths(ps["error_fb"]):
                _state_ok("error_fb/" + k, t.numpy(), want[k], lr_sum,
                          compress, first_step=True)
    want = _np(rs)
    got = {k: t.float().numpy() for k, t in tree_paths(ps)}
    assert sorted(got) == sorted(want)
    assert int(ps["opt"]["step"]) == 3
    for k in want:
        _state_ok(k, got[k], want[k], lr_sum, compress)


def test_microbatch_accumulation_matches_full_batch():
    cfg = get_config("yi-9b", smoke=True)
    ocfg = O.OptConfig(lr=1e-3, warmup=1, total_steps=10)
    state1 = init_state(cfg, ocfg, torch.Generator().manual_seed(0))
    state2 = tree_map(lambda t: t.clone(), state1)
    from repro_torch.train.data import DataConfig, TokenStream
    data = TokenStream(DataConfig(vocab=cfg.vocab, global_batch=4,
                                  seq_len=16, seed=0), cfg)
    b = {k: torch.from_numpy(v) for k, v in data.batch_at(0).items()}
    out1, _ = make_train_step(cfg, ocfg, n_micro=1)(state1, b)
    out2, _ = make_train_step(cfg, ocfg, n_micro=2)(state2, b)
    for (k, a), (_, bb) in zip(tree_paths(out1["params"]),
                               tree_paths(out2["params"])):
        assert torch.allclose(a.float(), bb.float(), atol=2e-2), \
            "microbatched step diverged from full batch"


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_decreases_loss(arch):
    """Mirrors ``test_models.py::test_train_step_decreases_loss`` for the
    dense archs the port has."""
    cfg = get_config(arch, smoke=True)
    ocfg = O.OptConfig(lr=5e-3, warmup=1, total_steps=50)
    state = init_state(cfg, ocfg, torch.Generator().manual_seed(0))
    step = make_train_step(cfg, ocfg)
    batch = smoke_batch(cfg, B=2, S=16, device="cpu")
    losses = []
    for _ in range(8):
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
        assert np.isfinite(losses[-1]), arch
    assert losses[-1] < losses[0], losses


@pytest.mark.parametrize("seq", [20, 2100], ids=["small", "flash"])
@pytest.mark.parametrize("remat", ["full", "dots"])
def test_remat_gives_the_gradients_of_none(remat, seq):
    """At 2,100 tokens (S*T above ``FLASH_THRESH``) attention is the
    ``flash_sdpa`` Function, recomputed inside the checkpoint."""
    pc = get_config("yi-9b", smoke=True, param_dtype="float32")
    if seq > 1024:
        pc = dataclasses.replace(pc, n_layers=1)
    p = init_state(pc, O.OptConfig(), torch.Generator().manual_seed(1)) \
        ["params"]
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, pc.vocab, (2 if seq < 1024 else 1, seq)).astype(np.int32))
    g0, m0 = _grads_of(p, pc, {"tokens": toks})
    g1, m1 = _grads_of(p, dataclasses.replace(pc, remat=remat),
                       {"tokens": toks})
    assert float(m1["loss"]) == float(m0["loss"])
    want = dict(tree_paths(g0))
    for k, g in tree_paths(g1):
        _close(g, want[k].numpy(), 1e-6, k)


def test_remat_dots_saves_the_matrix_products_only():
    """The ``"dots"`` policy keeps what ``aten.mm``/``addmm`` return and
    recomputes everything else, as ``checkpoint_dots_with_no_batch_dims``
    keeps the dots without batch dimensions."""
    from repro_torch.models import lm
    from torch.utils.checkpoint import CheckpointPolicy
    mm, bmm = torch.ops.aten.mm.default, torch.ops.aten.bmm.default
    assert lm._save_dots(None, mm) == CheckpointPolicy.MUST_SAVE
    assert lm._save_dots(None, bmm) == CheckpointPolicy.PREFER_RECOMPUTE
    assert lm._save_dots(None, torch.ops.aten.exp.default) \
        == CheckpointPolicy.PREFER_RECOMPUTE
    with pytest.raises(ValueError, match="remat"):
        lm._maybe_remat(lambda x: x, dataclasses.replace(
            get_config("yi-9b", smoke=True), remat="some"))


def test_unported_losses_raise_naming_the_roadmap():
    for arch in ("paligemma-3b", "deepseek-v3-671b"):
        cfg = get_config(arch, smoke=True)
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            PL.loss_fn({}, cfg, {"tokens": torch.zeros((1, 4),
                                                       dtype=torch.int32)})


# ------------------------------------------------- flash-attention grads
def _qkvg(B, S, T, H, Hk, hd, seed):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    return f(B, S, H, hd), f(B, T, Hk, hd), f(B, T, Hk, hd), f(B, S, H * hd)


def _port_grads(q, k, v, g, mask, n_rep, scale, fn=p_ops.flash_sdpa):
    ins = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    out = fn(*ins, mask, n_rep, scale)
    return torch.autograd.grad(out, ins, torch.from_numpy(g))


@pytest.mark.parametrize("kind,window,prefix", [("causal", 0, 0),
                                                ("full", 0, 0),
                                                ("causal", 48, 0),
                                                ("causal", 0, 33)])
def test_flash_sdpa_grads_match_reference_kernel(kind, window, prefix):
    """``jax.grad`` through the reference's ``flash_sdpa`` (Pallas kernel
    forward in interpret mode, recompute backward) at
    ``test_kernels.py::test_flash_sdpa_gqa_and_grads``' shape."""
    B, S, H, Hk, hd = 2, 200, 8, 2, 32
    q, k, v, g = _qkvg(B, S, S, H, Hk, hd, 7)
    scale = hd ** -0.5
    rspec = RA.MaskSpec(kind, window, prefix)
    want = jax.vjp(lambda a, b, c: r_flash_sdpa(a, b, c, rspec, H // Hk,
                                                scale),
                   *map(jnp.asarray, (q, k, v)))[1](jnp.asarray(g))
    got = _port_grads(q, k, v, g, PA.MaskSpec(kind, window, prefix), H // Hk,
                      scale)
    for n, a, w in zip(("dq", "dk", "dv"), got, want):
        err = np.abs(a.numpy() - np.asarray(w)).max()
        assert err <= 1e-4, (n, err)


def test_flash_sdpa_grads_match_reference_above_flash_thresh():
    """At S = 2,100 (S*S above ``FLASH_THRESH``: 3 q chunks, the last one
    ragged): the Function's gradients against ``jax.vjp`` of the
    reference's ``_sdpa_flash`` (what its ``_bwd`` differentiates), and the
    chunked backward against plain autograd through the port's
    ``_sdpa_flash``."""
    B, S, H, Hk, hd = 1, 2100, 4, 1, 16
    assert S * S > PA.FLASH_THRESH
    q, k, v, g = _qkvg(B, S, S, H, Hk, hd, 8)
    mask = PA.MaskSpec("causal", 700, 0)
    rmask = RA.MaskSpec("causal", 700, 0)
    want = jax.vjp(lambda a, b, c: RA._sdpa_flash(a, b, c, rmask, H // Hk),
                   *map(jnp.asarray, (q, k, v)))[1](jnp.asarray(g))
    got = _port_grads(q, k, v, g, mask, H // Hk, hd ** -0.5)
    plain = _port_grads(q, k, v, g, mask, H // Hk, hd ** -0.5,
                        fn=PA._sdpa_flash)
    for n, a, w, p in zip(("dq", "dk", "dv"), got, want, plain):
        assert np.abs(a.numpy() - np.asarray(w)).max() <= 1e-4, n
        assert np.abs(a.numpy() - p.numpy()).max() <= 1e-6, n


def test_flash_sdpa_bf16_grads_keep_dtype_and_launch_nothing_on_cpu():
    q, k, v, g = (torch.from_numpy(x).to(torch.bfloat16)
                  for x in _qkvg(1, 64, 64, 4, 2, 16, 9))
    n0 = p_ops.LAUNCHES
    ins = [t.requires_grad_() for t in (q, k, v)]
    out = p_ops.flash_sdpa(*ins, PA.CAUSAL, 2, 0.25)
    dq, dk, dv = torch.autograd.grad(out, ins, g)
    assert p_ops.LAUNCHES == n0
    assert (dq.dtype, dk.dtype, dv.dtype) == (torch.bfloat16,) * 3
    assert dq.shape == q.shape and dk.shape == k.shape
