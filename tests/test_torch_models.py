"""The port's LM stack against the reference's, for the dense archs the
serving slice covers (yi-9b, qwen2.5-14b, qwen3-14b, nemotron-4-15b, at
their ``SMOKE`` sizes): the reference's ``init_params`` carried across by
``models.convert.params_from_numpy``, then ``forward``, ``prefill`` and
``decode_step`` on the same tokens, logits and caches compared. The MoE
archs (deepseek-v3, llama4-scout) are held against the reference the same
way in ``test_torch_moe.py``; here they join the port-alone
prefill/decode-vs-forward check.

Tolerances, stated with their reasons:

* float32 parameters, before the bf16 cache (``forward`` and ``prefill``
  logits): 1e-4 of the largest reference logit. Both sides compute in
  float32 in another summation order; the observed gap is ~1e-6 relative.
* float32, the bf16 cache: each entry within 2^-7 of its own magnitude
  plus 1e-4 of the largest entry: the float32 k and v agree to the logits'
  bound, and rounding to bf16 can then land on neighbouring values, one
  bf16 ulp (2^-8 relative) apart.
* float32, after the bf16 cache (``decode_step`` logits): 1e-3 of the
  largest reference logit, since decode reads those rounded entries.
* bfloat16 parameters: 5e-2 of the largest reference value (logits and
  cache). Every op rounds to bf16 (8 significant bits), at other places in
  XLA's and torch's CPU kernels; through two layers the gap is a few bf16
  ulps of the largest value (observed up to 1.2e-2 relative).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as r_get_config
from repro.models import lm as rlm
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.models import lm as plm
from repro_torch.models.attention import FLASH_THRESH
from repro_torch.models.convert import params_from_numpy, params_to_numpy


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Run this module's torch ops on one thread: its tensors are small and
    gain little from intra-op threads, and under the test workers the
    threads of every process fight for the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ARCHS = ("yi-9b", "qwen2.5-14b", "qwen3-14b", "nemotron-4-15b")
TOL = {"float32": dict(logits=1e-4, decode=1e-3),
       "bfloat16": dict(logits=5e-2, decode=5e-2, cache=5e-2)}


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, dtype=np.float32)


def _close(got, want, rel, what):
    got, want = _f32(got), _f32(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want).max()
    bound = rel * np.abs(want).max()
    assert err <= bound, (what, err, bound)


def _cache_close(got, want, dtype, what):
    got, want = _f32(got), _f32(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    if dtype == "float32":
        ok = (np.abs(got - want)
              <= 2.0 ** -7 * np.abs(want) + 1e-4 * np.abs(want).max())
        assert ok.all(), (what, np.abs(got - want).max())
    else:
        _close(got, want, TOL[dtype]["cache"], what)


def _both(arch, dtype, seed=0):
    rc = r_get_config(arch, smoke=True, param_dtype=dtype)
    pc = get_config(arch, smoke=True, param_dtype=dtype)
    rp = rlm.init_params(rc, jax.random.PRNGKey(seed))
    pp = params_from_numpy(jax.device_get(rp), "cpu")
    return rc, pc, rp, pp


def test_configs_are_the_reference_configs():
    from repro.configs import ARCH_IDS as R_IDS
    assert ARCH_IDS == R_IDS
    for arch in ARCH_IDS:
        for smoke in (False, True):
            rc = r_get_config(arch, smoke=smoke)
            pc = get_config(arch, smoke=smoke)
            assert dataclasses.asdict(rc) == dataclasses.asdict(pc), arch
            assert rc.param_count() == pc.param_count(), arch
    cfg = get_config("yi-9b")
    assert cfg.dtype == torch.bfloat16
    assert abs(cfg.param_count()[0] - 8.83e9) < 0.01e9


@pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
def test_params_round_trip_bit_for_bit(dtype):
    rc, pc, rp, pp = _both("qwen2.5-14b", dtype)
    ref = jax.device_get(rp)
    back = params_to_numpy(pp)
    leaves_r, tree_r = jax.tree_util.tree_flatten(ref)
    leaves_b, tree_b = jax.tree_util.tree_flatten(back)
    assert tree_r == tree_b
    for a, b in zip(leaves_r, leaves_b):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert np.array_equal(a.view(np.uint8), b.view(np.uint8))
    # the port's own init gives the same keys, shapes and dtypes
    own = plm.init_params(pc, torch.Generator().manual_seed(0))
    shapes = jax.tree_util.tree_map(lambda t: (tuple(t.shape), str(t.dtype)),
                                    own)
    want = jax.tree_util.tree_map(
        lambda a: (a.shape, "torch." + ("bfloat16" if a.dtype.name ==
                                        "bfloat16" else str(a.dtype))), ref)
    assert shapes == want


@pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_prefill_decode_match_reference(arch, dtype):
    rc, pc, rp, pp = _both(arch, dtype)
    rng = np.random.default_rng(1)
    toks = rng.integers(0, rc.vocab, (2, 24)).astype(np.int32)
    tol = TOL[dtype]
    rl, _, rh = rlm.forward(rp, rc, {"tokens": jnp.asarray(toks)})
    pl, _, ph = plm.forward(pp, pc, {"tokens": torch.from_numpy(toks)})
    assert pl.dtype == pc.dtype
    _close(pl, rl, tol["logits"], "forward logits")
    _close(ph, rh, tol["logits"], "forward hidden")

    rpl, rcache = rlm.prefill(rp, rc, {"tokens": jnp.asarray(toks[:, :20])},
                              S_max=32)
    ppl, pcache = plm.prefill(pp, pc, {"tokens": torch.from_numpy(toks[:, :20])},
                              S_max=32)
    _close(ppl, rpl, tol["logits"], "prefill logits")
    assert pcache.k.dtype == torch.bfloat16
    _cache_close(pcache.k, rcache.k, dtype, "prefill cache k")
    _cache_close(pcache.v, rcache.v, dtype, "prefill cache v")
    for t in range(20, 24):
        pos = np.full((2,), t, np.int32)
        rdl, rcache = rlm.decode_step(rp, rc, jnp.asarray(toks[:, t]),
                                      jnp.asarray(pos), rcache)
        pdl, pcache = plm.decode_step(pp, pc, torch.from_numpy(toks[:, t]),
                                      torch.from_numpy(pos), pcache)
        _close(pdl, rdl, tol["decode"], f"decode logits t={t}")
        _cache_close(pcache.k, rcache.k, dtype, f"decode cache k t={t}")
        _cache_close(pcache.v, rcache.v, dtype, f"decode cache v t={t}")


@pytest.mark.parametrize("arch", ARCHS + ("deepseek-v3-671b",
                                           "llama4-scout-17b-a16e"))
def test_prefill_decode_matches_forward(arch):
    """Mirrors ``test_models.py::test_prefill_decode_matches_forward`` on
    the port alone, with the port's own init (bf16, bound 0.15 as there;
    the MoE archs at capacity factor 8, as there, so no slot is dropped)."""
    cfg = get_config(arch, smoke=True)
    if cfg.n_experts:
        cfg = dataclasses.replace(cfg, capacity_factor=8.0)
    p = plm.init_params(cfg, torch.Generator().manual_seed(0))
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab, (2, 24)).astype(np.int32))
    logits, _, _ = plm.forward(p, cfg, {"tokens": toks})
    pl, cache = plm.prefill(p, cfg, {"tokens": toks[:, :20]}, S_max=32)
    assert (pl.float() - logits[:, 19].float()).abs().max() < 0.15
    for t in range(20, 24):
        pos = torch.full((2,), t, dtype=torch.int32)
        dl, cache = plm.decode_step(p, cfg, toks[:, t], pos, cache)
        err = float((dl.float() - logits[:, t].float()).abs().max())
        assert err < 0.15, (arch, t, err)


def test_prefill_above_flash_thresh_matches_reference():
    """S = 2,100 at the SMOKE widths: S*S > FLASH_THRESH, so both packages
    take their long attention path (the reference's scan-tiled softmax,
    the port's ``_sdpa_flash`` on the CPU) inside ``prefill``."""
    S = 2100
    assert S * S > FLASH_THRESH
    rc, pc, rp, pp = _both("yi-9b", "float32")
    toks = np.random.default_rng(3).integers(0, rc.vocab, (1, S)) \
        .astype(np.int32)
    rpl, rcache = rlm.prefill(rp, rc, {"tokens": jnp.asarray(toks)},
                              S_max=S + 4)
    ppl, pcache = plm.prefill(pp, pc, {"tokens": torch.from_numpy(toks)},
                              S_max=S + 4)
    _close(ppl, rpl, TOL["float32"]["logits"], "prefill logits")
    _cache_close(pcache.k, rcache.k, "float32", "prefill cache k")
    _cache_close(pcache.v, rcache.v, "float32", "prefill cache v")
