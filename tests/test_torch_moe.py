"""The port's MoE layer and MLA against the reference's, at the ``SMOKE``
widths of deepseek-v3-671b (MLA, sigmoid router with bias, top-2 of 4,
MTP) and llama4-scout-17b-a16e (GQA, softmax router with the Switch aux
loss, top-1 of 4, a shared expert): the router with planted ties, the
slot assignment, the three dispatches, ``gather_dispatch``'s gradient,
MLA's forward, prefill cache and absorbed decode, the loss with its aux
and MTP terms and its gradients, a llama4 serve through ``Engine``, and
``flash_sdpa`` at q/k head dim 192 and v head dim 128.

Tolerances, stated with their reasons:

* the router's expert ids and the slot assignment: exact (integers).
* float32 values: 1e-5 of the largest reference value (both sum float32
  products in other orders; observed ~1e-7).
* bf16 values: 5e-2 of the largest reference value (every op rounds to
  bf16 at other places in XLA's and torch's CPU kernels), as in
  ``test_torch_models.py``; the float32 aux loss of a bf16 model, and the
  bf16 loss terms, 2e-3 relative (as ``test_torch_train_step.py``).
* a token whose experts differ between the packages at a near-tie of the
  reference (its k-th and (k+1)-th selection scores within 2^-5; bf16
  only) is left out of the value comparison: its FFN output changes
  wholesale (``_flips``).
* the bf16 MLA cache in float32 runs: each entry within 2^-7 of its own
  magnitude plus 1e-4 of the largest (a float32 latent a few ulps apart
  can round to the neighbouring bf16 value).

The reference's slot assignment scatters every slot past capacity onto
``(E-1, C-1)``; when the last expert itself overflows, XLA on the CPU lets
a drop overwrite that expert's real slot ``C-1`` (recorded in ROADMAP queue
3). The port scatters drops into a spare column instead, so every kept slot
holds its token: ``test_slot_assignment_reference_lets_a_drop_win`` pins
the one place where the two differ. Where a dispatch runs with drops, the
reference is run on the port's slot assignment (its ``_slot_assignment``
swapped for the port's), so the dispatch math is compared on the same
slots; without drops it runs unchanged.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as r_get_config
from repro.models import attention as RA
from repro.models import lm as rlm
from repro.models import mla as RMLA
from repro.models import moe as RM
from repro.serving import Engine as REngine
from repro.serving import ServeConfig as RServeConfig
from repro.train import losses as RL
from repro_torch.configs import get_config
from repro_torch.kernels.flash_attention import ops as p_ops
from repro_torch.models import attention as PA
from repro_torch.models import lm as plm
from repro_torch.models import mla as PMLA
from repro_torch.models import moe as PM
from repro_torch.models.convert import (cache_from_numpy, cache_to_numpy,
                                        params_from_numpy, params_to_numpy)
from repro_torch.serving import Engine, ServeConfig
from repro_torch.train.train_step import _grads_of
from repro_torch.train.tree import tree_paths

from test_torch_models import TOL, _cache_close

MOE_ARCHS = ("deepseek-v3-671b", "llama4-scout-17b-a16e")
REL = {"float32": 1e-5, "bfloat16": 5e-2}
_MODELS = {}


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
    err = np.abs(got - want).max() if got.size else 0.0
    assert err <= rel * max(np.abs(want).max(), 1e-30), (what, err)


def _cfgs(arch, dtype="float32", **kw):
    return (r_get_config(arch, smoke=True, param_dtype=dtype, **kw),
            get_config(arch, smoke=True, param_dtype=dtype, **kw))


def _model(arch, dtype, cf=8.0):
    """(reference cfg, port cfg, reference params, the same params in the
    port) at capacity factor ``cf``; the reference's ``init_params`` is
    jitted (the same numbers, one compile) and shared by the module."""
    if (arch, dtype) not in _MODELS:
        rc, _ = _cfgs(arch, dtype)
        rp = jax.jit(rlm.init_params, static_argnums=0)(
            rc, jax.random.PRNGKey(0))
        _MODELS[arch, dtype] = (rp, params_from_numpy(jax.device_get(rp),
                                                      "cpu"))
    return (*_cfgs(arch, dtype, capacity_factor=cf), *_MODELS[arch, dtype])


def _x(cfg, B=2, S=24, seed=0, dtype="float32"):
    a = np.random.default_rng(seed).standard_normal(
        (B, S, cfg.d_model)).astype(np.float32)
    return jnp.asarray(a).astype(dtype), torch.from_numpy(a).to(
        getattr(torch, dtype))


@pytest.fixture(scope="module")
def moe_layers():
    """Each arch's float32 MoE parameters (the reference's, carried
    across) and its bf16 ones."""
    out = {}
    for arch in MOE_ARCHS:
        for dtype in ("float32", "bfloat16"):
            rc, pc = _cfgs(arch, dtype)
            rp = RM.moe_params(jax.random.PRNGKey(1), rc)
            out[arch, dtype] = (rc, pc, rp,
                                params_from_numpy(jax.device_get(rp), "cpu"))
    return out


# ------------------------------------------------------------------ router

@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_route_matches_reference_with_planted_ties(arch, moe_layers):
    """Experts 1 and 2 get the same router column (and, for the sigmoid
    router, the same bias), so they tie on every token: both packages must
    put expert 1 first. The bias moves the sigmoid router's selection but
    not its weights."""
    rc, pc, rp, _ = moe_layers[arch, "float32"]
    rp = dict(rp)
    r = np.array(rp["router"])
    r[:, 2] = r[:, 1]
    rp["router"] = jnp.asarray(r)
    if rc.router == "sigmoid":
        rp["router_bias"] = jnp.asarray(np.array([0.0, 0.3, 0.3, -0.2],
                                                 np.float32))
    pp = params_from_numpy(jax.device_get(rp), "cpu")
    rx, px = _x(rc, seed=2)
    ri, rw, ra = RM._route(rp, rc, rx)
    pi, pw, pa = PM._route(pp, pc, px)
    assert pi.dtype == torch.int32
    assert np.array_equal(pi.numpy(), np.asarray(ri))
    if rc.top_k > 1:       # the tied pair is chosen, lower index first
        both = (pi == 1).any(-1) & (pi == 2).any(-1)
        assert bool(both.any())
        first = torch.argmax((pi == 1).int(), -1) < torch.argmax(
            (pi == 2).int(), -1)
        assert bool(first[both].all())
    else:                  # top-1 never picks the tied expert 2
        assert not bool((pi == 2).any()) and bool((pi == 1).any())
    _close(pw, rw, REL["float32"], "weights")
    _close(pa, ra, REL["float32"], "aux")


# ------------------------------------------------------------------ slots

def _slots_ref(idx, E, C):
    st, sk = RM._slot_assignment(jnp.asarray(idx), E, C)
    return np.array(st), np.array(sk)


def _slots_port(idx, E, C):
    st, sk = PM._slot_assignment(torch.from_numpy(idx), E, C)
    return st.numpy(), sk.numpy()


def _skewed_idx(B, S, k, E, seed, p):
    """[B,S,k] distinct experts per token, drawn with weights ``p``."""
    rng = np.random.default_rng(seed)
    return np.stack([np.stack([rng.choice(E, size=k, replace=False, p=p)
                               for _ in range(S)]) for _ in range(B)]
                    ).astype(np.int32)


@pytest.mark.parametrize("case", ("no_drops", "drops"))
def test_slot_assignment_matches_reference(case):
    """Bit for bit. Without drops (capacity above every expert's load), and
    with drops where experts 0 and 1 overflow and the last expert stays
    within capacity (the reference's scatter is then well defined)."""
    E, k, C = 6, 2, 8
    p = (np.full(E, 1 / E) if case == "no_drops"
         else np.array([0.35, 0.3, 0.15, 0.1, 0.05, 0.05]))
    idx = _skewed_idx(3, 20, k, E, seed=4, p=p)
    load = np.stack([(idx[b] == e).sum() for b in range(3)
                     for e in range(E)]).reshape(3, E)
    C = int(load.max()) if case == "no_drops" else C
    if case == "drops":
        assert (load[:, :2] > C).all() and (load[:, -1] <= C).all(), load
    st_r, sk_r = _slots_ref(idx, E, C)
    st_p, sk_p = _slots_port(idx, E, C)
    assert st_p.dtype == np.int32 and sk_p.dtype == np.int32
    assert np.array_equal(st_p, st_r) and np.array_equal(sk_p, sk_r)
    # every kept slot holds a token that routed there, at its own choice
    S = idx.shape[1]
    for b, e, c in zip(*np.nonzero(st_p < S)):
        assert idx[b, st_p[b, e, c], sk_p[b, e, c]] == e


def test_slot_assignment_reference_lets_a_drop_win():
    """The last expert overflows: the reference's drops land on its slot
    C-1, over the real token there (XLA on the CPU applies the updates in
    order, the overflow last). The port keeps the real token; every other
    slot is equal."""
    E, C = 3, 2
    idx = np.array([[[2], [0], [2], [1], [2], [0]]], np.int32)
    st_r, sk_r = _slots_ref(idx, E, C)
    st_p, sk_p = _slots_port(idx, E, C)
    S = idx.shape[1]
    assert st_r[0, E - 1, C - 1] == S           # the drop won
    assert st_p[0, E - 1, C - 1] == 2           # tokens 0 and 2 kept
    st_r[0, E - 1, C - 1] = st_p[0, E - 1, C - 1]
    assert np.array_equal(st_p, st_r) and np.array_equal(sk_p, sk_r)


# ------------------------------------------------------------------ dispatch

def _port_slots_in_reference(monkeypatch):
    def slots(idx, E, C):
        st, sk = PM._slot_assignment(torch.from_numpy(np.array(idx)), E, C)
        return jnp.asarray(st.numpy()), jnp.asarray(sk.numpy())
    monkeypatch.setattr(RM, "_slot_assignment", slots)


@pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
@pytest.mark.parametrize("cf", (8.0, 1.0))
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_dispatches_match_reference(arch, cf, dtype, moe_layers,
                                        monkeypatch):
    """``moe_scatter``, ``moe_mixed`` and ``moe_gshard`` (and ``moe_apply``
    with the shared expert) against the reference's own functions at
    capacity factor 8 (no drops) and 1 (drops; the reference on the port's
    slots)."""
    _, _, rp, pp = moe_layers[arch, dtype]
    rc, pc = _cfgs(arch, dtype, capacity_factor=cf)
    rx, px = _x(rc, seed=3, dtype=dtype)
    C = PM.capacity(pc, px.shape[1])
    assert C == RM.capacity(rc, px.shape[1])
    idx, _, _ = PM._route(pp, pc, px)
    drops = any(int((idx[b] == e).sum()) > C for b in range(idx.shape[0])
                for e in range(pc.n_experts))
    assert drops == (cf == 1.0)
    if drops:
        _port_slots_in_reference(monkeypatch)
    for name in ("moe_scatter", "moe_mixed", "moe_gshard"):
        ry, ra = getattr(RM, name)(rp, rc, rx)
        py, pa = getattr(PM, name)(pp, pc, px)
        assert py.dtype == px.dtype and pa.dtype == torch.float32
        _close(py, ry, REL[dtype], name)
        _close(pa, ra, REL["float32"], name + " aux")
    ry, _ = RM.moe_apply(rp, rc, rx)
    py, _ = PM.moe_apply(pp, pc, px)
    _close(py, ry, REL[dtype], "moe_apply")


def test_gather_dispatch_grad_matches_jax_vjp():
    """Autograd of the port's plain gather against ``jax.vjp`` of the
    reference's ``gather_dispatch`` (its custom one-hot VJP): the same
    scatter-add, with repeated tokens and the padding row."""
    rng = np.random.default_rng(5)
    B, S, d, E, C = 2, 9, 6, 3, 4
    xpad = rng.standard_normal((B, S + 1, d)).astype(np.float32)
    st = rng.integers(0, S + 1, (B, E, C)).astype(np.int32)
    g = rng.standard_normal((B, E, C, d)).astype(np.float32)
    out, vjp = jax.vjp(lambda a: RM.gather_dispatch(a, jnp.asarray(st)),
                       jnp.asarray(xpad))
    (want,) = vjp(jnp.asarray(g))
    xt = torch.from_numpy(xpad).requires_grad_()
    got = PM.gather_dispatch(xt, torch.from_numpy(st))
    _close(got, out, 0.0, "forward")
    (dx,) = torch.autograd.grad(got, xt, torch.from_numpy(g))
    _close(dx, want, REL["float32"], "vjp")


# ------------------------------------------------------------------ MLA

def test_mla_forward_prefill_and_absorbed_decode_match_reference():
    """One MLA layer (float32 parameters): ``mla_forward``, the bf16
    latent cache of ``mla_prefill``, and four absorbed-latent decode steps
    (their outputs and the cache rows they write)."""
    rc, pc = _cfgs("deepseek-v3-671b")
    rp = jax.jit(RMLA.mla_params, static_argnums=1)(jax.random.PRNGKey(2),
                                                    rc)
    pp = params_from_numpy(jax.device_get(rp), "cpu")
    rx, px = _x(rc, B=2, S=24, seed=6)
    pos = np.broadcast_to(np.arange(24, dtype=np.int32), (2, 24))
    rmask, pmask = RA.MaskSpec("causal"), PA.MaskSpec("causal")
    ry = jax.jit(lambda p, x, ps: RMLA.mla_forward(p, rc, x, ps, rmask))(
        rp, rx, jnp.asarray(pos))
    py = PMLA.mla_forward(pp, pc, px, torch.from_numpy(pos.copy()), pmask)
    _close(py, ry, REL["float32"], "forward")
    ry, rcache = jax.jit(lambda p, x, ps: RMLA.mla_prefill(
        p, rc, x, ps, rmask, 32))(rp, rx[:, :20], jnp.asarray(pos[:, :20]))
    py, pcache = PMLA.mla_prefill(pp, pc, px[:, :20],
                                  torch.from_numpy(pos[:, :20].copy()),
                                  pmask, 32)
    _close(py, ry, REL["float32"], "prefill")

    def cache_ok(what):
        for f, got in cache_to_numpy(pcache).items():
            want = _f32(getattr(rcache, f))
            got = got.astype(np.float32)
            assert got.shape == want.shape, (what, f)
            ok = (np.abs(got - want)
                  <= 2.0 ** -7 * np.abs(want) + 1e-4 * np.abs(want).max())
            assert ok.all(), (what, f)
    assert pcache.ckv.dtype == torch.bfloat16
    cache_ok("prefill cache")
    rdecode = jax.jit(lambda p, x, ps, c: RMLA.mla_decode(p, rc, x, ps, c))
    for t in range(20, 24):
        p1 = np.full((2,), t, np.int32)
        ry, rcache = rdecode(rp, rx[:, t:t + 1], jnp.asarray(p1), rcache)
        py, same = PMLA.mla_decode(pp, pc, px[:, t:t + 1],
                                   torch.from_numpy(p1), pcache)
        assert same is pcache                    # written in place
        _close(py, ry, 1e-4, f"decode t={t}")
        cache_ok(f"decode cache t={t}")


def test_moe_params_and_mla_cache_convert_both_ways_bit_for_bit():
    """deepseek's whole tree (MLA, stacked experts, the float32 router, the
    ``router_bias`` buffer, the ``mtp`` subtree) and an ``MLACache`` go
    across and back bit for bit; the port's own init gives the same keys,
    shapes and dtypes."""
    rc, pc, rp, _ = _model("deepseek-v3-671b", "bfloat16")
    rp = jax.device_get(rp)
    back = params_to_numpy(params_from_numpy(rp, "cpu"))
    lr, tr = jax.tree_util.tree_flatten(rp)
    lb, tb = jax.tree_util.tree_flatten(back)
    assert tr == tb
    for a, b in zip(lr, lb):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert np.array_equal(a.view(np.uint8), b.view(np.uint8))
    assert rp["seg1"]["moe"]["router"].dtype == np.float32
    assert rp["seg1"]["moe"]["router_bias"].shape == (3 - 1, 4)
    own = plm.init_params(pc, torch.Generator().manual_seed(0))
    assert [(k, tuple(t.shape), str(t.dtype).split(".")[-1])
            for k, t in tree_paths(own)] == [
        (k, a.shape, str(a.dtype)) for k, a in tree_paths(rp)]
    rcache = rlm.init_cache(rc, 2, 8)
    rcache = RMLA.MLACache(*(jnp.asarray(np.random.default_rng(1)
                                         .standard_normal(a.shape))
                             .astype(a.dtype) for a in rcache))
    pcache = cache_from_numpy(jax.device_get(rcache), "cpu")
    assert isinstance(pcache, PMLA.MLACache)
    for f, a in cache_to_numpy(pcache).items():
        assert np.array_equal(a.view(np.uint8),
                              np.asarray(getattr(rcache, f)).view(np.uint8))


# ------------------------------------------------------------------ lm

TIE = 2.0 ** -5     # a near-tie: the reference's k-th and (k+1)-th scores


def _record_routes(monkeypatch):
    """Record each routing of both packages in call order: (expert ids
    [B,S,k], selection scores [B,S,E]) as numpy. The reference's are read
    out of its jitted scans by an ordered callback."""
    rec = {"ref": [], "port": []}
    r0, p0 = RM._route, PM._route

    def ref_route(p, cfg, x):
        out = r0(p, cfg, x)
        logits = x.astype(jnp.float32) @ p["router"]
        sel = (jax.nn.sigmoid(logits) + p["router_bias"]
               if cfg.router == "sigmoid" else jax.nn.softmax(logits, -1))
        jax.debug.callback(lambda i, s: rec["ref"].append(
            (np.asarray(i), np.asarray(s))), out[0], sel, ordered=True)
        return out

    def port_route(p, cfg, x):
        out = p0(p, cfg, x)
        rec["port"].append((out[0].numpy(), None))
        return out
    monkeypatch.setattr(RM, "_route", ref_route)
    monkeypatch.setattr(PM, "_route", port_route)
    return rec


def _flips(rec):
    """The (b, s) whose experts differ between the packages in any routing
    since the last call, each checked to be a near-tie of the reference
    (its k-th and (k+1)-th selection scores within ``TIE``); the lists are
    emptied. In bf16 the two packages' hidden states differ by a few ulps,
    which can reorder two experts whose scores all but tie: that token's
    FFN output then changes wholesale, and is excused from the value
    comparison."""
    assert len(rec["ref"]) == len(rec["port"])
    out = set()
    for (ri, sel), (pi, _) in zip(rec["ref"], rec["port"]):
        k = ri.shape[-1]
        top = -np.sort(-sel, axis=-1)
        for b, s in np.argwhere((np.sort(ri, -1) != np.sort(pi, -1)).any(-1)):
            assert top[b, s, k - 1] - top[b, s, k] <= TIE, (b, s, top[b, s])
            out.add((int(b), int(s)))
    rec["ref"].clear()
    rec["port"].clear()
    return out


def _close_except(got, want, rel, what, skip):
    """:func:`_close` over the [B,S,...] values outside positions
    ``skip``."""
    got, want = _f32(got), _f32(want)
    keep = np.ones(got.shape[:2], bool)
    for b, s in skip:
        keep[b, s] = False
    _close(got[keep], want[keep], rel, what)

@pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_forward_prefill_decode_match_reference(arch, dtype, monkeypatch):
    """``lm.forward`` (logits, hidden, aux), ``prefill`` (logits and the
    cache: a ``KVCache`` for llama4, an ``MLACache`` for deepseek) and four
    ``decode_step`` calls against the reference's (jitted), at capacity
    factor 8, so prefill and forward drop no slot and see the experts that
    decode (one token a step) sees; the tolerances of
    ``test_torch_models.py``, outside tokens whose experts differ at a
    near-tie of the reference (:func:`_flips`; in bf16 only)."""
    rc, pc, rp, pp = _model(arch, dtype)
    rec = _record_routes(monkeypatch)
    toks = np.random.default_rng(1).integers(0, rc.vocab, (2, 24)) \
        .astype(np.int32)
    tol = TOL[dtype]
    rl, raux, rh = jax.jit(lambda p, t: rlm.forward(p, rc, {"tokens": t}))(
        rp, jnp.asarray(toks))
    pl, paux, ph = plm.forward(pp, pc, {"tokens": torch.from_numpy(toks)})
    assert pl.dtype == pc.dtype
    flips = _flips(rec)
    assert dtype == "bfloat16" or not flips
    _close_except(pl, rl, tol["logits"], "forward logits", flips)
    _close_except(ph, rh, tol["logits"], "forward hidden", flips)
    if not flips:       # each flip moves the Switch aux's token counts
        _close(paux, raux, 1e-5 if dtype == "float32" else 2e-3, "aux")
    rpl, rcache = jax.jit(lambda p, t: rlm.prefill(p, rc, {"tokens": t},
                                                   S_max=32))(
        rp, jnp.asarray(toks[:, :20]))
    ppl, pcache = plm.prefill(pp, pc, {"tokens": torch.from_numpy(
        toks[:, :20].copy())}, S_max=32)
    flips = _flips(rec)
    assert dtype == "bfloat16" or not flips
    _close_except(ppl[:, None], rpl[:, None], tol["logits"],
                  "prefill logits", {(b, 0) for b, s in flips if s == 19})
    assert isinstance(pcache, PMLA.MLACache) == (rc.attention == "mla")

    def caches(what):
        for f, got in zip(pcache._fields, pcache):
            assert got.dtype == torch.bfloat16
            want = _f32(getattr(rcache, f)).copy()
            got = _f32(got).copy()
            for b, s in flips:      # every layer's row of a flipped token
                want[:, b, s] = got[:, b, s] = 0
            _cache_close(got, want, dtype, f"{what} {f}")
    caches("prefill cache")
    rdecode = jax.jit(lambda p, t, ps, c: rlm.decode_step(p, rc, t, ps, c))
    for t in range(20, 24):
        pos = np.full((2,), t, np.int32)
        rdl, rcache = rdecode(rp, jnp.asarray(toks[:, t]), jnp.asarray(pos),
                              rcache)
        pdl, pcache = plm.decode_step(pp, pc, torch.from_numpy(toks[:, t]),
                                      torch.from_numpy(pos), pcache)
        step = {(b, t) for b, _ in _flips(rec)}
        assert dtype == "bfloat16" or not step
        flips |= step
        _close_except(pdl[:, None], rdl[:, None], tol["decode"],
                      f"decode logits t={t}", {(b, 0) for b, _ in step})
        caches(f"decode cache t={t}")


# ------------------------------------------------------------------ loss

@pytest.mark.parametrize("arch,dtype", (("deepseek-v3-671b", "float32"),
                                        ("deepseek-v3-671b", "bfloat16"),
                                        ("llama4-scout-17b-a16e", "float32")))
def test_loss_with_aux_and_mtp_and_grads_match_reference(arch, dtype):
    """``loss_fn`` (ce, the MoE aux loss, deepseek's MTP loss) and every
    gradient against ``jax.value_and_grad`` of the reference's (jitted),
    at capacity factor 8 (no drops; drops are compared above). bf16: 2e-3
    relative on the loss terms and 5e-2 of each gradient's largest
    element, as in ``test_torch_train_step.py``."""
    rc, pc, rp, pp = _model(arch, dtype)
    toks = np.random.default_rng(0).integers(0, rc.vocab, (2, 24)) \
        .astype(np.int32)
    (rl, rm), rg = jax.jit(jax.value_and_grad(
        lambda p, t: RL.loss_fn(p, rc, {"tokens": t}), has_aux=True))(
        rp, jnp.asarray(toks))
    pg, pm = _grads_of(pp, pc, {"tokens": torch.from_numpy(toks)})
    assert set(pm) == set(rm) | {"loss"}
    assert ("mtp_ce" in pm) == (arch == "deepseek-v3-671b")
    loss_rel, grad_rel = (1e-5, 1e-5) if dtype == "float32" else (2e-3, 5e-2)
    for k in pm:
        assert abs(float(pm[k]) - float(rm[k])) \
            <= loss_rel * max(abs(float(rm[k])), 1e-30), (k, pm[k], rm[k])
    want = dict(tree_paths(jax.device_get(rg)))
    for k, g in tree_paths(pg):
        _close(g, want[k], grad_rel, k)


# ------------------------------------------------------------------ serving

def test_engine_serves_llama4_as_the_reference():
    """llama4-scout's SMOKE config (float32, capacity factor 8 so no prefill
    drops a slot) through the port's ``Engine`` and the reference's: the
    same tokens, cache hits, page ids, stats and tree."""
    rc, pc, rp, pp = _model("llama4-scout-17b-a16e", "float32")
    rng = np.random.default_rng(6)
    shared = rng.integers(0, rc.vocab, size=32).astype(np.int32)
    reqs = [np.concatenate([shared, rng.integers(0, rc.vocab, 8)])
            .astype(np.int32) for _ in range(4)]
    kw = dict(max_batch=2, s_max=96, block_tokens=8, n_pages=64,
              max_new_tokens=4)
    reng = REngine(rc, rp, RServeConfig(**kw))
    peng = Engine(pc, pp, ServeConfig(tree_backend="fused", **kw))
    rdone, pdone = reng.run(reqs), peng.run(reqs)
    assert all(r.done for r in pdone) and peng.steps == reng.steps
    assert [r.out for r in pdone] == [r.out for r in rdone]
    assert [r.cached_blocks for r in pdone] == [r.cached_blocks for r in rdone]
    assert sum(r.cached_blocks for r in pdone) > 0
    assert peng.prefix.stats == reng.prefix.stats
    assert np.array_equal(peng.prefix.pool.used, reng.prefix.pool.used)


def test_engine_refuses_mla():
    cfg = get_config("deepseek-v3-671b", smoke=True)
    p = plm.init_params(cfg, torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="MLA"):
        Engine(cfg, p, ServeConfig(max_batch=2, s_max=32))


# ------------------------------------------------------------------ flash

def test_flash_sdpa_192_128_matches_reference_sdpa_flash():
    """q/k head dim 192, v 128 (MLA's widths), S = T = 2,100 (above
    ``FLASH_THRESH``), causal, float32: the port's ``flash_sdpa`` (on the
    CPU its plain version forward, the chunked recompute backward) against
    the reference's tiled ``_sdpa_flash`` and its VJP; 1e-4 absolute on
    inputs of unit scale (the bound of ``test_torch_train_step.py``)."""
    S, H, hd, hv = 2100, 2, 192, 128
    assert S * S > PA.FLASH_THRESH
    rng = np.random.default_rng(8)
    q, k = (rng.standard_normal((1, S, H, hd)).astype(np.float32)
            for _ in range(2))
    v = rng.standard_normal((1, S, H, hv)).astype(np.float32)
    g = rng.standard_normal((1, S, H * hv)).astype(np.float32)
    scale = hd ** -0.5
    out, vjp = jax.vjp(lambda a, b, c: RA._sdpa_flash(
        a, b, c, RA.CAUSAL, 1, scale), *map(jnp.asarray, (q, k, v)))
    want = vjp(jnp.asarray(g))
    qt, kt, vt = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    got = p_ops.flash_sdpa(qt, kt, vt, PA.CAUSAL, 1, scale)
    assert got.shape == (1, S, H * hv)
    assert np.abs(got.detach().numpy() - np.asarray(out)).max() <= 1e-4
    grads = torch.autograd.grad(got, (qt, kt, vt), torch.from_numpy(g))
    for name, gt, w in zip("qkv", grads, want):
        assert np.abs(gt.numpy() - np.asarray(w)).max() <= 1e-4, name


def test_chip_smoke_serve_moe_phase_rehearses_on_the_cpu():
    """``chip_smoke.rehearse_serve_moe``: the card's ``serve-moe`` checks on
    the CPU at SMOKE size (llama4 through ``Engine``: every request done,
    hits, fsck, the CPU replay, cached KV, the three dispatches in
    agreement, decode equal to forward; deepseek through ``lm.prefill`` and
    ``lm.decode_step``: decode equal to forward)."""
    import chip_smoke
    out = chip_smoke.rehearse_serve_moe(seed=0)
    assert out["llama4"]["fails"] == [] and out["deepseek"]["fails"] == []
    assert out["llama4"]["replay_equal"] and out["llama4"]["fsck_ok"]
    assert out["llama4"]["cache_stats"]["hits"] > 0
    for part in ("llama4", "deepseek"):
        assert out[part]["decode_vs_forward"]["max_abs_err"] < 0.15


def test_route_diff_excuses_only_reference_near_ties():
    """``chip_smoke.route_diff``: a token routed otherwise is excused only
    where the reference run's k-th and (k+1)-th scores lie within
    ``ROUTE_TIE_GAP`` (2^-5, this file's ``TIE``), however far the scores
    moved; a token's later layers are not judged once it differs."""
    import chip_smoke
    assert chip_smoke.ROUTE_TIE_GAP == TIE

    def layer(idx, sel):
        return (torch.tensor(idx, dtype=torch.int32)[None, :, None],
                torch.tensor(sel)[None])
    want = [layer([0, 1], [[0.5, 0.49, 0.01], [0.2, 0.7, 0.1]]),
            layer([0, 0], [[0.6, 0.3, 0.1], [0.9, 0.05, 0.05]])]
    near = [layer([1, 1], [[0.49, 0.5, 0.01], [0.2, 0.7, 0.1]]),
            layer([2, 0], [[0.1, 0.2, 0.7], [0.9, 0.05, 0.05]])]
    flipped, faults, ties = chip_smoke.route_diff(want, near)
    assert flipped == {(0, 0)} and faults == []
    assert [(lay, round(g, 6)) for lay, g, _ in ties] == [(0, 0.01)]
    far = [want[0], layer([0, 1], [[0.59, 0.31, 0.1], [0.05, 0.9, 0.05]])]
    flipped, faults, ties = chip_smoke.route_diff(want, far)
    assert flipped == {(0, 1)} and len(faults) == 1 and "layer 1" in faults[0]
    r = chip_smoke.tie_readings(ties)
    assert r["tokens"] == 1 and r["max_gap_first_moe_layer"] is None
    assert abs(r["max_gap"] - 0.85) < 1e-6


def test_serve_cli_serves_llama4_on_the_cpu(capsys):
    """``launch/serve.py --arch llama4-scout-17b-a16e`` (SMOKE) on the CPU:
    every request done, the cache hit."""
    import json
    from repro_torch.launch import serve
    serve.main(["--arch", "llama4-scout-17b-a16e", "--device", "cpu",
                "--requests", "6", "--max-new", "4"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["all_done"] and out["requests"] == 6
    assert out["prefix_hit_rate"] > 0


@pytest.mark.parametrize("pages", [None, 36])
def test_serve_cli_pages_hold_every_block(pages, capsys):
    """``launch/serve.py`` sizes its page store so that no page is evicted
    (the engine does not pin the pages a wave matched, ROADMAP queue 3):
    by default every block of the requests and at least 512; an explicit
    ``--pages`` at exactly the requests' 36 blocks serves without an
    eviction, with ``--layers`` cutting the depth; one page fewer is
    refused."""
    import json
    from repro_torch.launch import serve
    args = ["--arch", "llama4-scout-17b-a16e", "--device", "cpu",
            "--requests", "6", "--prompt-len", "96", "--shared-prefix", "64",
            "--max-new", "2", "--layers", "1"]
    assert serve.pages_needed(6, 96) == 36
    serve.main(args + ([] if pages is None else ["--pages", str(pages)]))
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["pages"] == (512 if pages is None else pages)
    assert out["all_done"] and out["tree_stats"]["evicts"] == 0
    assert out["tree_stats"]["hits"] > 0
    if pages is not None:
        with pytest.raises(SystemExit):
            serve.main(args + ["--pages", str(pages - 1)])
        assert "cannot hold the requests' 36 blocks" in capsys.readouterr().err
