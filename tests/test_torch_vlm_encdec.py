"""The port's vlm family (paligemma-3b) and enc-dec family (whisper-medium)
against the reference's, at their ``SMOKE`` sizes: the reference's
``init_params`` carried across by ``models.convert.params_from_numpy``,
then ``forward``, ``prefill``, ``decode_step`` and ``encode`` on the same
numpy inputs (tokens, image patches, stub frames), the enc-dec cache
across ``convert.py``, ``loss_fn`` (the vlm's text-only cross entropy)
with its gradients, and one train step. The reference runs jitted: one
compile a shape.

Tolerances (those of ``test_torch_models.py`` and
``test_torch_train_step.py``, with their reasons there):

* float32 logits, hidden states and encoder outputs before the bf16 cache:
  1e-4 of the largest reference value (float32 sums in other orders);
  decode logits, which read the bf16 cache: 1e-3.
* the bf16 caches of float32 runs: each entry within 2^-7 of its own
  magnitude plus 1e-4 of the largest (neighbouring bf16 values).
* bfloat16 parameters: 5e-2 of the largest reference value (every op
  rounds to bf16 at other places in XLA's and torch's CPU kernels).
* loss terms 1e-5 relative in float32, 2e-3 in bf16; gradients 1e-5 /
  5e-2 of each gradient's largest element.
* the train step's state (:func:`_step_ok`): each array within 1e-5 of its
  largest element but for at most one element in a thousand (at least
  one), and every element within 2 lr plus that. AdamW's first step
  divides a gradient by its own magnitude plus eps = 1e-8, so a gradient
  within a few eps of zero (a norm weight's ~4e-7, a float32 sum of terms
  near 1e-2) turns summation-order noise of ~1e-9 into ~4e-8 of its
  update (observed on one of paligemma's 128 norm weights).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as r_get_config
from repro.models import lm as rlm
from repro.train import losses as RL
from repro.train import optim as RO
from repro.train import train_step as RTS
from repro_torch.configs import get_config
from repro_torch.models import attention as PA
from repro_torch.models import lm as plm
from repro_torch.models.convert import (cache_from_numpy, cache_to_numpy,
                                        params_from_numpy)
from repro_torch.serving import Engine, ServeConfig
from repro_torch.train import optim as O
from repro_torch.train.train_step import _grads_of, make_train_step
from repro_torch.train.tree import tree_paths

from test_torch_models import TOL, _cache_close

ARCHS = ("paligemma-3b", "whisper-medium")
_MODELS = {}
_JITS = {}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Run this module's torch ops on one thread: they are small, gain
    nothing from intra-op threads, and the test workers share the
    machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, dtype=np.float32)


def _close(got, want, rel, what):
    got, want = _f32(got), _f32(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want).max()
    assert err <= rel * max(np.abs(want).max(), 1e-30), (what, err)


def _model(arch, dtype="float32", **over):
    """(reference cfg, port cfg, reference params, the same params in the
    port); the reference's ``init_params`` is jitted and shared by the
    module."""
    rc = r_get_config(arch, smoke=True, param_dtype=dtype, **over)
    pc = get_config(arch, smoke=True, param_dtype=dtype, **over)
    key = (arch, dtype, tuple(sorted(over.items())))
    if key not in _MODELS:
        rp = jax.jit(rlm.init_params, static_argnums=0)(
            rc, jax.random.PRNGKey(0))
        _MODELS[key] = (rp, params_from_numpy(jax.device_get(rp), "cpu"))
    return (rc, pc, *_MODELS[key])


def _ref(name, rc, **kw):
    """The reference's ``lm.<name>`` for ``rc`` (and static ``kw``),
    jitted once for the module, so tests of the same shapes share its
    compiles."""
    key = (name, rc, tuple(sorted(kw.items())))
    if key not in _JITS:
        fn = getattr(rlm, name)
        _JITS[key] = jax.jit(lambda *a: fn(a[0], rc, *a[1:], **kw))
    return _JITS[key]


def _batch(cfg, B, S, T=40, seed=1):
    """numpy inputs: tokens [B, S], and the vlm's patches [B, n_patches,
    frontend_dim] or the enc-dec's frames [B, T, frontend_dim]."""
    rng = np.random.default_rng(seed)
    b = {"tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)}
    if cfg.family == "vlm":
        b["patches"] = rng.standard_normal(
            (B, cfg.n_patches, cfg.frontend_dim)).astype(np.float32)
    if cfg.family == "encdec":
        b["frames"] = rng.standard_normal(
            (B, T, cfg.frontend_dim)).astype(np.float32)
    return b


def _jax(b, S=None):
    return {k: jnp.asarray(v[:, :S] if k == "tokens" else v)
            for k, v in b.items()}


def _torch(b, S=None):
    return {k: torch.from_numpy(np.ascontiguousarray(
        v[:, :S] if k == "tokens" else v)) for k, v in b.items()}


def _offset(cfg):
    """Positions before the first text token: the vlm's image patches."""
    return cfg.n_patches if cfg.family == "vlm" else 0


def _caches_close(got, want, dtype, what):
    """A port cache against the reference's: the ``KVCache``, or the
    enc-dec's dict of it and the cross attention's k and v."""
    if isinstance(want, dict):
        _caches_close(got["self"], want["self"], dtype, f"{what} self")
        for f in ("cross_k", "cross_v"):
            assert got[f].dtype == torch.bfloat16
            _cache_close(got[f], want[f], dtype, f"{what} {f}")
        return
    for f, g in zip(got._fields, got):
        assert g.dtype == torch.bfloat16
        _cache_close(g, getattr(want, f), dtype, f"{what} {f}")


@pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_prefill_decode_match_reference(arch, dtype):
    """``lm.forward`` (logits over the patches and the text for vlm),
    ``prefill`` of the first 20 text tokens (logits and cache: for enc-dec
    the self attention's and the cross attention's rows) and four
    ``decode_step`` calls, against the reference's."""
    rc, pc, rp, pp = _model(arch, dtype)
    b = _batch(rc, 2, 24)
    tol, off = TOL[dtype], _offset(rc)
    rl, _, rh = _ref("forward", rc)(rp, _jax(b))
    pl, paux, ph = plm.forward(pp, pc, _torch(b))
    assert pl.dtype == pc.dtype and pl.shape[1] == off + 24
    assert float(paux) == 0.0
    _close(pl, rl, tol["logits"], "forward logits")
    _close(ph, rh, tol["logits"], "forward hidden")

    S_max = off + 32
    rpl, rcache = _ref("prefill", rc, S_max=S_max)(rp, _jax(b, 20))
    ppl, pcache = plm.prefill(pp, pc, _torch(b, 20), S_max=S_max)
    _close(ppl, rpl, tol["logits"], "prefill logits")
    _caches_close(pcache, rcache, dtype, "prefill cache")
    rdecode = _ref("decode_step", rc)
    for t in range(20, 24):
        pos = np.full((2,), off + t, np.int32)
        tok = b["tokens"][:, t]
        rdl, rcache = rdecode(rp, jnp.asarray(tok), jnp.asarray(pos), rcache)
        pdl, pcache = plm.decode_step(pp, pc, torch.from_numpy(tok),
                                      torch.from_numpy(pos), pcache)
        _close(pdl, rdl, tol["decode"], f"decode logits t={t}")
        _caches_close(pcache, rcache, dtype, f"decode cache t={t}")


@pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
def test_encode_matches_reference(dtype):
    """whisper's encoder alone: projection, learned positions, the layers
    (attention without a mask, no rotary) and the final norm."""
    rc, pc, rp, pp = _model("whisper-medium", dtype)
    frames = _batch(rc, 2, 8, T=48, seed=4)["frames"]
    want = _ref("encode", rc)(rp, jnp.asarray(frames))
    got = plm.encode(pp, pc, torch.from_numpy(frames))
    assert got.dtype == pc.dtype
    _close(got, want, TOL[dtype]["logits"], "encoder output")


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_above_flash_thresh_matches_reference(arch):
    """Sequences with S·T above ``FLASH_THRESH``, so both packages take
    their long attention path (the reference's scan-tiled softmax, the
    port's ``_sdpa_flash`` on the CPU) inside ``prefill``: paligemma's 8
    patches + 2,092 text tokens under the prefix-LM mask; whisper's
    encoder over 2,064 frames without a mask and its decoder's cross
    attention from 2,040 tokens (S != T; their causal self attention,
    2,040² below the threshold, stays on the exact path), with the learned
    position tables sized to 2,112 rows."""
    over = {"enc_seq": 2112} if arch == "whisper-medium" else {}
    rc, pc, rp, pp = _model(arch, **over)
    n_text = 2100 - _offset(rc) if rc.family == "vlm" else 2040
    b = _batch(rc, 1, n_text, T=2064, seed=3)
    assert 2064 ** 2 > PA.FLASH_THRESH and n_text * 2064 > PA.FLASH_THRESH
    S_max = 2100 + 4
    rpl, rcache = _ref("prefill", rc, S_max=S_max)(rp, _jax(b))
    ppl, pcache = plm.prefill(pp, pc, _torch(b), S_max=S_max)
    _close(ppl, rpl, TOL["float32"]["logits"], "prefill logits")
    _caches_close(pcache, rcache, "float32", "prefill cache")


def test_encdec_cache_converts_both_ways_bit_for_bit():
    """The reference's enc-dec cache (a ``KVCache`` and the cross rows)
    through ``cache_from_numpy`` and back equals itself bit for bit, and
    the port decodes from it as the reference does (the shapes of
    :func:`test_forward_prefill_decode_match_reference`, whose compiles
    it shares)."""
    rc, pc, rp, pp = _model("whisper-medium")
    b = _batch(rc, 2, 24)
    _, rcache = _ref("prefill", rc, S_max=32)(rp, _jax(b, 20))
    ref = jax.device_get(rcache)
    pcache = cache_from_numpy(ref, "cpu")
    assert set(pcache) == {"self", "cross_k", "cross_v"}
    assert pcache["self"].k.dtype == torch.bfloat16
    back = cache_to_numpy(pcache)
    pairs = [(back["self"]["k"], ref["self"].k),
             (back["self"]["v"], ref["self"].v),
             (back["cross_k"], ref["cross_k"]),
             (back["cross_v"], ref["cross_v"])]
    for got, want in pairs:
        assert got.dtype == want.dtype and got.shape == want.shape
        assert np.array_equal(got.view(np.uint16), want.view(np.uint16))
    tok, pos = b["tokens"][:, 20], np.full((2,), 20, np.int32)
    rdl, _ = _ref("decode_step", rc)(rp, jnp.asarray(tok), jnp.asarray(pos),
                                     rcache)
    pdl, _ = plm.decode_step(pp, pc, torch.from_numpy(tok),
                             torch.from_numpy(pos), pcache)
    _close(pdl, rdl, TOL["float32"]["decode"], "decode from converted cache")


@pytest.mark.parametrize("arch", ARCHS)
def test_params_have_the_reference_tree(arch):
    """The port's own ``init_params`` gives the reference's keys, shapes
    and dtypes (``proj`` for vlm; ``enc``, ``dec_pos`` and ``dec_blocks``
    for enc-dec)."""
    rc, pc, rp, _ = _model(arch)
    own = plm.init_params(pc, torch.Generator().manual_seed(0))
    want = {k: (tuple(a.shape), str(a.dtype))
            for k, a in tree_paths(jax.device_get(rp))}
    got = {k: (tuple(t.shape), str(t.dtype).split(".")[-1])
           for k, t in tree_paths(own)}
    assert got == want


@pytest.mark.parametrize("arch,dtype", (("paligemma-3b", "float32"),
                                        ("paligemma-3b", "bfloat16"),
                                        ("whisper-medium", "float32")))
def test_loss_and_grads_match_reference(arch, dtype):
    """``loss_fn`` (for vlm the cross entropy over the text positions only)
    and every gradient against ``jax.value_and_grad`` of the
    reference's."""
    rc, pc, rp, pp = _model(arch, dtype)
    b = _batch(rc, 2, 16, seed=0)
    (_, rm), rg = jax.jit(jax.value_and_grad(
        lambda p, x: RL.loss_fn(p, rc, x), has_aux=True))(rp, _jax(b))
    pg, pm = _grads_of(pp, pc, _torch(b))
    assert set(pm) == set(rm) | {"loss"}
    loss_rel, grad_rel = (1e-5, 1e-5) if dtype == "float32" else (2e-3, 5e-2)
    for k in pm:
        assert pm[k].dtype == torch.float32
        assert abs(float(pm[k]) - float(rm[k])) \
            <= loss_rel * max(abs(float(rm[k])), 1e-30), (k, pm[k], rm[k])
    want = dict(tree_paths(jax.device_get(rg)))
    for k, g in tree_paths(pg):
        assert g.dtype == pc.dtype, k
        _close(g, want[k], grad_rel, k)


def _step_ok(key, got, want, lr):
    """The train state's bound (see the module's docstring)."""
    d = np.abs(got - want)
    top = max(np.abs(want).max(), 1e-30)
    n_off = int((d > 1e-5 * top).sum())
    assert n_off <= max(1, 1e-3 * d.size), (key, n_off, d.size)
    assert d.max() <= 2 * lr + 1e-5 * top, (key, d.max())


def test_train_step_matches_reference():
    """One AdamW step of paligemma (the vlm's text-only loss; whisper's
    gradients are held above) from one converted train state (float32):
    the metrics and every array of the new state."""
    rc, pc = (r_get_config("paligemma-3b", smoke=True, param_dtype="float32"),
              get_config("paligemma-3b", smoke=True, param_dtype="float32"))
    kw = dict(kind="adamw", lr=1e-3, warmup=1, total_steps=10)
    rcfg, pcfg = RO.OptConfig(**kw), O.OptConfig(**kw)
    rs = jax.jit(RTS.init_state, static_argnums=(0, 1))(
        rc, rcfg, jax.random.PRNGKey(0))
    ps = params_from_numpy(jax.device_get(rs), "cpu")
    b = _batch(rc, 2, 16, seed=2)
    rs, rm = jax.jit(RTS.make_train_step(rc, rcfg))(rs, _jax(b))
    ps, pm = make_train_step(pc, pcfg)(ps, _torch(b))
    assert sorted(pm) == sorted(rm)
    for k in ("loss", "ce", "grad_norm"):
        assert abs(float(pm[k]) - float(rm[k])) <= 1e-5 * abs(float(rm[k])), k
    want = dict(tree_paths(jax.device_get(rs)))
    got = {k: t.float().numpy() for k, t in tree_paths(ps)}
    assert sorted(got) == sorted(want)
    for k in want:
        _step_ok(k, got[k], np.asarray(want[k], np.float32), float(rm["lr"]))


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_refuses_the_family(arch):
    """As the reference's engine does: both families are served through
    ``lm.prefill`` and ``lm.decode_step``."""
    cfg = get_config(arch, smoke=True)
    p = plm.init_params(cfg, torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="decoder-only"):
        Engine(cfg, p, ServeConfig(max_batch=2, s_max=32))


@pytest.mark.parametrize("phase", ("serve_vlm", "serve_whisper"))
def test_chip_smoke_phase_rehearses_on_the_cpu(phase):
    """``chip_smoke.rehearse_serve_vlm`` / ``rehearse_serve_whisper``: the
    card's checks on the CPU at SMOKE size (prefill, decode steps, finite
    logits of the right shape, decode equal to forward)."""
    import chip_smoke
    out = getattr(chip_smoke, f"rehearse_{phase}")(seed=0)
    assert out["fails"] == [], out["fails"]
    assert out["decode_vs_forward"]["max_abs_err"] < 0.15
