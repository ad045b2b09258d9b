"""The port's ssm family (falcon-mamba-7b: mamba1) and hybrid family
(zamba2-7b: mamba2 and the shared attention block with a LoRA per
occurrence) against the reference's, at their ``SMOKE`` sizes: the mixers
alone (``mamba1_forward``, ``mamba2_forward``, both decodes, both
``ssm_scan`` branches, S no multiple of the chunk, with and without an
initial state), then ``lm.forward``, ``prefill`` (caches included) and
``decode_step``, the caches across ``convert.py`` and back, ``loss_fn``
with its gradients and one train step. Parameters are the reference's,
carried across by ``params_from_numpy``; inputs come from a numpy seed.
zamba2's LoRA ``qb`` starts at zero in both packages, so the tests give it
random values (the same in both) to reach the LoRA path.

Tolerances (those of ``test_torch_models.py`` and
``test_torch_vlm_encdec.py``, with their reasons there):

* float32 outputs, logits and float32 states: 1e-4 of the largest
  reference value (float32 sums in other orders); decode logits after
  the bf16 k/v cache: 1e-3; the bf16 k/v cache of float32 runs: each
  entry within 2^-7 of its own magnitude plus 1e-4 of the largest.
* bfloat16 parameters: 5e-2 of the largest reference value (outputs,
  logits, states and caches alike: every op rounds to bf16 at other places
  in XLA's and torch's CPU kernels).
* loss terms 1e-5 relative in float32, 2e-3 in bf16; gradients 1e-5 /
  5e-2 of each gradient's largest element; the train step's state as
  ``test_torch_vlm_encdec._step_ok``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as r_get_config
from repro.models import lm as rlm
from repro.models import mamba as RM
from repro.train import losses as RL
from repro.train import optim as RO
from repro.train import train_step as RTS
from repro_torch.configs import get_config
from repro_torch.models import attention as PA
from repro_torch.models import blocks as PB
from repro_torch.models import lm as plm
from repro_torch.models import mamba as PM
from repro_torch.models.convert import (cache_from_numpy, cache_to_numpy,
                                        params_from_numpy)
from repro_torch.serving import Engine, ServeConfig
from repro_torch.train import optim as O
from repro_torch.train.train_step import _grads_of, make_train_step
from repro_torch.train.tree import tree_paths

from test_torch_models import TOL, _cache_close
from test_torch_vlm_encdec import _close, _f32, _step_ok

ARCHS = ("falcon-mamba-7b", "zamba2-7b")
KIND_ARCH = {"mamba1": "falcon-mamba-7b", "mamba2": "zamba2-7b"}
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


def _cfgs(arch, dtype="float32", **over):
    return (r_get_config(arch, smoke=True, param_dtype=dtype, **over),
            get_config(arch, smoke=True, param_dtype=dtype, **over))


def _live_lora(tree):
    """The params tree with zamba2's LoRA ``qb`` drawn at random (the same
    numbers in both packages), so the LoRA path adds to the output."""
    if "lora" in tree:
        qb = tree["lora"]["qb"]
        rng = np.random.default_rng(7)
        tree["lora"]["qb"] = (0.1 * rng.standard_normal(qb.shape)).astype(
            qb.dtype)
    return tree


def _model(arch, dtype="float32", **over):
    """(reference cfg, port cfg, reference params, the same params in the
    port), shared by the module."""
    rc, pc = _cfgs(arch, dtype, **over)
    key = (arch, dtype)
    if key not in _MODELS:
        rp = _live_lora(jax.device_get(jax.jit(
            rlm.init_params, static_argnums=0)(rc, jax.random.PRNGKey(0))))
        _MODELS[key] = (jax.tree_util.tree_map(jnp.asarray, rp),
                        params_from_numpy(rp, "cpu"))
    return (rc, pc, *_MODELS[key])


def _ref(name, rc, **kw):
    """The reference's ``lm.<name>`` for ``rc`` (and static ``kw``),
    jitted once for the module."""
    key = (name, rc, tuple(sorted(kw.items())))
    if key not in _JITS:
        fn = getattr(rlm, name)
        _JITS[key] = jax.jit(lambda *a: fn(a[0], rc, *a[1:], **kw))
    return _JITS[key]


def _tokens(cfg, B, S, seed=1):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (B, S)) \
        .astype(np.int32)


def _state_close(got, want, dtype, what):
    """A port ``MambaState`` (or its stack) against the reference's: the
    conv window in the activations' dtype, the ssm state float32, both at
    the outputs' bound."""
    for f in ("conv", "ssm"):
        g, w = getattr(got, f), getattr(want, f)
        assert str(g.dtype).split(".")[-1] == str(w.dtype), (what, f)
        _close(g, w, TOL[dtype]["logits"], f"{what} {f}")


def _caches_close(got, want, dtype, what):
    """ssm: one stacked ``MambaState``; hybrid: ``grp`` and ``tail``
    states and the shared blocks' bf16 ``KVCache``."""
    if isinstance(want, dict):
        assert set(got) == set(want), (what, set(got), set(want))
        for k in ("grp", "tail"):
            _state_close(got[k], want[k], dtype, f"{what} {k}")
        for f in ("k", "v"):
            g = getattr(got["attn"], f)
            assert g.dtype == torch.bfloat16
            _cache_close(g, getattr(want["attn"], f), dtype,
                         f"{what} attn {f}")
        return
    _state_close(got, want, dtype, what)


# ------------------------------------------------------------------ scan
@pytest.mark.parametrize("n", (1, 2, 3, 7, 8, 13))
def test_associative_scan_is_the_sequential_scan(n):
    """``mamba.associative_scan`` under mamba1's combine equals the
    sequential recurrence h_t = a_t h_{t-1} + b_t, at lengths odd and even
    (float64, so only the order of exact-enough sums differs)."""
    rng = np.random.default_rng(n)
    a = torch.from_numpy(rng.uniform(0.5, 1.0, (2, n, 3)))
    b = torch.from_numpy(rng.standard_normal((2, n, 3)))
    accA, acc = PM.associative_scan(PM._m1_combine, (a, b), dim=1)
    h = torch.zeros(2, 3, dtype=torch.float64)
    pa = torch.ones(2, 3, dtype=torch.float64)
    for t in range(n):
        h = a[:, t] * h + b[:, t]
        pa = a[:, t] * pa
        assert torch.allclose(acc[:, t], h, rtol=1e-12, atol=1e-12)
        assert torch.allclose(accA[:, t], pa, rtol=1e-12, atol=1e-12)


# ------------------------------------------------------------------ mixers
def _mixer(kind, dtype, scan="assoc"):
    """The reference's params of one mixer (and both configs)."""
    rc, pc = _cfgs(KIND_ARCH[kind], dtype, ssm_scan=scan)
    make = RM.mamba1_params if kind == "mamba1" else RM.mamba2_params
    rp = jax.device_get(make(jax.random.PRNGKey(3), rc))
    return rc, pc, jax.tree_util.tree_map(jnp.asarray, rp), \
        params_from_numpy(rp, "cpu")


def _state(cfg, kind, B, dtype, seed):
    """A random state: the conv window in ``dtype``, the ssm state float32
    (mamba2 in forward's ``[nh, ds, hp]``)."""
    rng = np.random.default_rng(seed)
    if kind == "mamba1":
        conv_dim, ssm = cfg.d_inner, (cfg.d_inner, cfg.ssm_state)
    else:
        conv_dim = cfg.d_inner + 2 * cfg.ssm_state
        ssm = (cfg.n_ssm_heads, cfg.ssm_state, cfg.ssm_headdim)
    conv = rng.standard_normal((B, conv_dim, cfg.d_conv)).astype(np.float32)
    h = (0.5 * rng.standard_normal((B,) + ssm)).astype(np.float32)
    ref = RM.MambaState(jnp.asarray(conv).astype(dtype), jnp.asarray(h))
    port = PM.MambaState(torch.from_numpy(conv).to(getattr(torch, dtype)),
                         torch.from_numpy(h))
    return ref, port


@pytest.mark.parametrize("with_state", (False, True))
@pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
@pytest.mark.parametrize("kind,scan", (("mamba1", "assoc"),
                                       ("mamba1", "cumsum"),
                                       ("mamba2", "assoc")))
def test_mixer_forward_matches_reference(kind, scan, dtype, with_state):
    """``mamba1_forward`` (both ``ssm_scan`` branches) and
    ``mamba2_forward`` on 300 tokens, no multiple of their chunks (256 and
    128: the last chunk is ragged), from no state or a random one: the
    output and the final state."""
    rc, pc, rp, pp = _mixer(kind, dtype, scan)
    x = np.random.default_rng(2).standard_normal((2, 300, rc.d_model)) \
        .astype(np.float32)
    rs = ps = None
    if with_state:
        rs, ps = _state(rc, kind, 2, dtype, seed=4)
    rfwd = RM.mamba1_forward if kind == "mamba1" else RM.mamba2_forward
    pfwd = PM.mamba1_forward if kind == "mamba1" else PM.mamba2_forward
    ry, rst = jax.jit(rfwd, static_argnums=1)(
        rp, rc, jnp.asarray(x).astype(dtype), rs)
    py, pst = pfwd(pp, pc, torch.from_numpy(x).to(getattr(torch, dtype)), ps)
    assert py.dtype == pc.dtype
    _close(py, ry, TOL[dtype]["logits"], f"{kind} output")
    _state_close(pst, rst, dtype, f"{kind} final state")


@pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
@pytest.mark.parametrize("kind", ("mamba1", "mamba2"))
def test_mixer_decode_matches_reference(kind, dtype):
    """Three ``mamba1_decode`` / ``mamba2_decode`` steps from a random
    state: each step's output and new state."""
    rc, pc, rp, pp = _mixer(kind, dtype)
    rs, ps = _state(rc, kind, 2, dtype, seed=5)
    xs = np.random.default_rng(6).standard_normal((3, 2, 1, rc.d_model)) \
        .astype(np.float32)
    rdec = jax.jit(RM.mamba1_decode if kind == "mamba1" else
                   RM.mamba2_decode, static_argnums=1)
    pdec = PM.mamba1_decode if kind == "mamba1" else PM.mamba2_decode
    for t, x in enumerate(xs):
        ry, rs = rdec(rp, rc, jnp.asarray(x).astype(dtype), rs)
        py, ps = pdec(pp, pc, torch.from_numpy(x).to(getattr(torch, dtype)),
                      ps)
        _close(py, ry, TOL[dtype]["logits"], f"{kind} decode {t}")
        _state_close(ps, rs, dtype, f"{kind} state {t}")


# ------------------------------------------------------------------ lm
@pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
@pytest.mark.parametrize("arch,scan", (("falcon-mamba-7b", "assoc"),
                                       ("falcon-mamba-7b", "cumsum"),
                                       ("zamba2-7b", "assoc")))
def test_forward_prefill_decode_match_reference(arch, scan, dtype):
    """``lm.forward`` on 300 tokens, ``prefill`` of the first 296 (logits
    and cache: the stacked mamba states, for zamba2 also the shared
    blocks' k/v) and four ``decode_step`` calls, against the reference's."""
    rc, pc, rp, pp = _model(arch, dtype)
    if scan != rc.ssm_scan:
        rc, pc = _cfgs(arch, dtype, ssm_scan=scan)
    toks = _tokens(rc, 2, 300)
    tol = TOL[dtype]
    rl, _, rh = _ref("forward", rc)(rp, {"tokens": jnp.asarray(toks)})
    pl, paux, ph = plm.forward(pp, pc, {"tokens": torch.from_numpy(toks)})
    assert pl.dtype == pc.dtype and float(paux) == 0.0
    _close(pl, rl, tol["logits"], "forward logits")
    _close(ph, rh, tol["logits"], "forward hidden")
    rpl, rcache = _ref("prefill", rc, S_max=304)(
        rp, {"tokens": jnp.asarray(toks[:, :296])})
    ppl, pcache = plm.prefill(pp, pc, {"tokens": torch.from_numpy(
        np.ascontiguousarray(toks[:, :296]))}, S_max=304)
    _close(ppl, rpl, tol["logits"], "prefill logits")
    _caches_close(pcache, rcache, dtype, "prefill cache")
    rdecode = _ref("decode_step", rc)
    for t in range(296, 300):
        pos = np.full((2,), t, np.int32)
        tok = np.ascontiguousarray(toks[:, t])
        rdl, rcache = rdecode(rp, jnp.asarray(tok), jnp.asarray(pos), rcache)
        before = pcache
        pdl, pcache = plm.decode_step(pp, pc, torch.from_numpy(tok),
                                      torch.from_numpy(pos), pcache)
        assert pcache is before        # every row written in place
        _close(pdl, rdl, tol["decode"], f"decode logits t={t}")
        _caches_close(pcache, rcache, dtype, f"decode cache t={t}")


def test_zamba_prefill_above_flash_thresh_matches_reference():
    """zamba2's prefill of 2,100 tokens: S² above ``FLASH_THRESH``, so the
    shared attention takes both packages' long path (the reference's
    scan-tiled softmax, the port's ``_sdpa_flash`` on the CPU; K5 on the
    card) in each occurrence; 17 mamba2 chunks, the last ragged."""
    rc, pc, rp, pp = _model("zamba2-7b")
    S = 2100
    assert S * S > PA.FLASH_THRESH
    toks = _tokens(rc, 1, S, seed=3)
    rpl, rcache = _ref("prefill", rc, S_max=S + 4)(
        rp, {"tokens": jnp.asarray(toks)})
    ppl, pcache = plm.prefill(pp, pc, {"tokens": torch.from_numpy(toks)},
                              S_max=S + 4)
    _close(ppl, rpl, TOL["float32"]["logits"], "prefill logits")
    _caches_close(pcache, rcache, "float32", "prefill cache")


@pytest.mark.parametrize("arch", ARCHS)
def test_params_have_the_reference_tree(arch):
    """The port's own ``init_params`` gives the reference's keys, shapes
    and dtypes (``A_log``, ``dt_b``, ``D`` float32; zamba2's ``mamba_grp``
    ``[13-like groups, period - 1, ...]``, ``mamba_tail``, ``shared``,
    ``lora``)."""
    rc, pc, rp, _ = _model(arch)
    own = plm.init_params(pc, torch.Generator().manual_seed(0))
    want = {k: (tuple(a.shape), str(a.dtype))
            for k, a in tree_paths(jax.device_get(rp))}
    got = {k: (tuple(t.shape), str(t.dtype).split(".")[-1])
           for k, t in tree_paths(own)}
    assert got == want


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_decode_matches_forward(arch):
    """``tests/test_models.py::test_prefill_decode_matches_forward`` on the
    port alone, with the port's own bf16 init: prefill of 260 tokens then
    four decode steps against the teacher-forced forward, bound 0.15. A
    decode step sums the conv's taps as the forward does
    (``mamba._conv_step``), so falcon-mamba, which has no attention,
    decodes bit for bit as it forwards here."""
    cfg = get_config(arch, smoke=True)
    p = plm.init_params(cfg, torch.Generator().manual_seed(0))
    toks = torch.from_numpy(_tokens(cfg, 2, 264, seed=2))
    logits, _, _ = plm.forward(p, cfg, {"tokens": toks})
    pl, cache = plm.prefill(p, cfg, {"tokens": toks[:, :260]}, S_max=272)
    got = [pl]
    for t in range(260, 264):
        pos = torch.full((2,), t, dtype=torch.int32)
        dl, cache = plm.decode_step(p, cfg, toks[:, t], pos, cache)
        got.append(dl)
    for t, g in zip(range(259, 264), got):
        err = float((g.float() - logits[:, t].float()).abs().max())
        assert err < 0.15, (arch, t, err)
        if cfg.family == "ssm":
            assert torch.equal(g, logits[:, t]), (arch, t, err)


# ------------------------------------------------------------------ caches
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_converts_both_ways_bit_for_bit(arch):
    """The reference's prefill cache (falcon-mamba: a stacked
    ``MambaState``; zamba2: ``grp``, ``attn``, ``tail``) through
    ``cache_from_numpy`` and back equals itself bit for bit (each field as
    the same named tuple in the port), and the port decodes from it as the
    reference does."""
    rc, pc, rp, pp = _model(arch, "bfloat16")
    toks = _tokens(rc, 2, 300)
    _, rcache = _ref("prefill", rc, S_max=304)(
        rp, {"tokens": jnp.asarray(toks[:, :296])})
    ref = jax.device_get(rcache)
    pcache = cache_from_numpy(ref, "cpu")
    back = cache_to_numpy(pcache)
    parts = (ref.items() if isinstance(ref, dict) else [("", ref)])
    for name, want in parts:
        got = back[name] if name else back
        mine = pcache[name] if name else pcache
        assert type(mine).__name__ == type(want).__name__, name
        for f in want._fields:
            w = getattr(want, f)
            assert got[f].dtype == w.dtype and got[f].shape == w.shape
            assert np.array_equal(got[f].view(np.uint8), w.view(np.uint8)), \
                (name, f)
    tok, pos = np.ascontiguousarray(toks[:, 296]), np.full((2,), 296, np.int32)
    rdl, _ = _ref("decode_step", rc)(rp, jnp.asarray(tok), jnp.asarray(pos),
                                     rcache)
    pdl, _ = plm.decode_step(pp, pc, torch.from_numpy(tok),
                             torch.from_numpy(pos), pcache)
    _close(pdl, rdl, TOL["bfloat16"]["decode"], "decode from converted cache")


def test_init_cache_reference_mamba2_state_is_transposed():
    """A reference fault (ROADMAP queue 3), kept by the port: zamba2's
    ``init_cache`` gives the mamba2 ssm state ``[nh, hp, ds]``
    (``init_mamba_state``) where ``mamba2_forward`` and ``mamba2_decode``
    keep ``[nh, ds, hp]``. At SMOKE (``ssm_headdim`` 16, ``ssm_state`` 8)
    ``grp.ssm`` is the first field that differs: (2, 2, 2, 8, 16, 8) from
    ``init_cache(cfg, 2, 8)``, (2, 2, 2, 8, 8, 16) from ``prefill``, and
    ``decode_step`` from ``init_cache`` fails in both packages. At full
    width hp = ds = 64, so the shapes agree there."""
    rc, pc, rp, pp = _model("zamba2-7b")
    toks = _tokens(rc, 2, 8)
    rinit = rlm.init_cache(rc, 2, 8)
    _, rpre = _ref("prefill", rc, S_max=8)(rp, {"tokens": jnp.asarray(toks)})
    assert rinit["grp"].ssm.shape == (2, 2, 2, 8, 16, 8)
    assert rpre["grp"].ssm.shape == (2, 2, 2, 8, 8, 16)
    pinit = plm.init_cache(pc, 2, 8, device="cpu")
    for k in rinit:
        for f in rinit[k]._fields:
            assert tuple(getattr(pinit[k], f).shape) \
                == getattr(rinit[k], f).shape, (k, f)
    tok, pos = np.zeros((2,), np.int32), np.zeros((2,), np.int32)
    with pytest.raises(TypeError, match="incompatible shapes"):
        rlm.decode_step(rp, rc, jnp.asarray(tok), jnp.asarray(pos), rinit)
    with pytest.raises(RuntimeError):
        plm.decode_step(pp, pc, torch.from_numpy(tok), torch.from_numpy(pos),
                        pinit)
    full_r, full_p = r_get_config("zamba2-7b"), get_config("zamba2-7b")
    shapes = jax.eval_shape(lambda: rlm.init_cache(full_r, 1, 8))
    meta = plm.init_cache(full_p, 1, 8, device="meta")
    assert shapes["grp"].ssm.shape == tuple(meta["grp"].ssm.shape) \
        == (13, 5, 1, 112, 64, 64)


# ------------------------------------------------------------------ training
@pytest.mark.parametrize("arch,dtype", (("falcon-mamba-7b", "float32"),
                                        ("falcon-mamba-7b", "bfloat16"),
                                        ("zamba2-7b", "float32")))
def test_loss_and_grads_match_reference(arch, dtype):
    """``loss_fn`` and every gradient (the mixers' float32 ``A_log``,
    ``dt_b``, ``D`` too; zamba2's shared block and LoRA) against
    ``jax.value_and_grad`` of the reference's."""
    rc, pc, rp, pp = _model(arch, dtype)
    toks = _tokens(rc, 2, 40, seed=0)
    (_, rm), rg = jax.jit(jax.value_and_grad(
        lambda p, x: RL.loss_fn(p, rc, x), has_aux=True))(
            rp, {"tokens": jnp.asarray(toks)})
    pg, pm = _grads_of(pp, pc, {"tokens": torch.from_numpy(toks)})
    assert set(pm) == set(rm) | {"loss"}
    loss_rel, grad_rel = (1e-5, 1e-5) if dtype == "float32" else (2e-3, 5e-2)
    for k in pm:
        assert pm[k].dtype == torch.float32
        assert abs(float(pm[k]) - float(rm[k])) \
            <= loss_rel * max(abs(float(rm[k])), 1e-30), (k, pm[k], rm[k])
    want = dict(tree_paths(jax.device_get(rg)))
    got = dict(tree_paths(pg))
    assert sorted(got) == sorted(want)
    for k, g in got.items():
        assert str(g.dtype).split(".")[-1] == str(want[k].dtype), k
        _close(g, want[k], grad_rel, k)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_reference(arch):
    """One AdamW step from one converted float32 train state: the metrics
    and every array of the new state."""
    rc, pc = _cfgs(arch)
    kw = dict(kind="adamw", lr=1e-3, warmup=1, total_steps=10)
    rcfg, pcfg = RO.OptConfig(**kw), O.OptConfig(**kw)
    rs = jax.jit(RTS.init_state, static_argnums=(0, 1))(
        rc, rcfg, jax.random.PRNGKey(0))
    ps = params_from_numpy(jax.device_get(rs), "cpu")
    toks = _tokens(rc, 2, 32, seed=2)
    rs, rm = jax.jit(RTS.make_train_step(rc, rcfg))(
        rs, {"tokens": jnp.asarray(toks)})
    ps, pm = make_train_step(pc, pcfg)(ps, {"tokens": torch.from_numpy(toks)})
    assert sorted(pm) == sorted(rm)
    for k in ("loss", "ce", "grad_norm"):
        assert abs(float(pm[k]) - float(rm[k])) <= 1e-5 * abs(float(rm[k])), k
    want = dict(tree_paths(jax.device_get(rs)))
    got = {k: _f32(t) for k, t in tree_paths(ps)}
    assert sorted(got) == sorted(want)
    for k in want:
        _step_ok(k, got[k], np.asarray(want[k], np.float32), float(rm["lr"]))


# ------------------------------------------------------------------ serving
@pytest.mark.parametrize("arch", ARCHS)
def test_engine_refuses_the_family(arch):
    """As the reference's engine does: both families are served through
    ``lm.prefill`` and ``lm.decode_step``."""
    cfg = get_config(arch, smoke=True)
    p = plm.init_params(cfg, torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="decoder-only"):
        Engine(cfg, p, ServeConfig(max_batch=2, s_max=32))


@pytest.mark.parametrize("kind", ("hybrid", "encdec"))
def test_blocks_refuse_the_kinds_lm_assembles(kind):
    cfg = get_config("zamba2-7b", smoke=True)
    with pytest.raises(ValueError, match="lm.py"):
        PB.block_params(torch.Generator().manual_seed(0), cfg, kind)


@pytest.mark.parametrize("phase", ("serve_mamba", "serve_zamba"))
def test_chip_smoke_phase_rehearses_on_the_cpu(phase):
    """``chip_smoke.rehearse_serve_mamba`` / ``rehearse_serve_zamba``: the
    card's checks on the CPU at SMOKE size (prefills of 300 tokens, decode
    steps, finite logits of the right shape, decode equal to forward on
    the float32 draws with the bf16 drift measured beside it, the SMOKE
    train step)."""
    import chip_smoke
    out = getattr(chip_smoke, f"rehearse_{phase}")(seed=0)
    assert out["fails"] == [], out["fails"]
    assert out["k5_launches"] == out["expected_k5_launches"] == 0
    assert out["decode_vs_forward"]["max_abs_err"] < 0.15
    # decode vs forward is held on the float32 draws, the bf16 drift beside
    assert out["decode_vs_forward"]["param_dtype"] == "float32"
    assert out["bf16_decode_drift"]["param_dtype"] == "bfloat16"
