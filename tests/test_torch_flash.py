"""The port's flash-attention path against the reference's.

On the CPU the port's ``flash_sdpa`` runs its plain torch version
(``kernels/flash_attention/ref.py``, whose ``flash_attention_ref`` takes
the reference kernel's own ``[BH,S,hd]`` layout with ``kv_len``) and the
port's
``sdpa`` takes its tiled online-softmax path ``_sdpa_flash`` above
``FLASH_THRESH``. They are held against the reference's Pallas kernel
(``flash_attention_kernel``, interpret mode, as ``tests/test_kernels.py``
runs it), its ``flash_sdpa`` (which interprets off-TPU), its ref and its
``_sdpa_small`` / ``_sdpa_flash``, on the same numpy inputs. Mirrors
``test_kernels.py::test_flash_attention_kernel_sweep`` and
``test_flash_sdpa_gqa_and_grads`` (forward), ``test_models.py::
test_flash_attention_matches_small`` and cases of ``test_properties.py::
test_flash_equals_exact_attention``.

Tolerance: 1e-4 absolute in float32, on inputs of unit scale. Both sides
compute exact float32 products with float32 sums, but in another order
and with another tiling, and the reference's kernel normalizes after the
p·v sum where its ref (a single softmax) normalizes before: a few float32
ulps of outputs below 4 in magnitude. The reference's own tests use the
same bound (2e-4 for the property cases, as there).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.attention as RA
from repro.kernels.flash_attention.kernel import flash_attention_kernel
from repro.kernels.flash_attention.ops import flash_sdpa as r_flash_sdpa
from repro.kernels.flash_attention.ref import (
    flash_attention_ref as r_flash_ref)
import repro_torch.models.attention as PA
from repro_torch.kernels.flash_attention import ops as p_ops
from repro_torch.kernels.flash_attention.ref import flash_attention_ref

TOL = 1e-4
MASKS = [(True, 0, 0), (False, 0, 0), (True, 48, 0), (True, 0, 33)]


def _np(x):
    return np.asarray(x, dtype=np.float32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("BH,S,T,hd,hv,bq,bk", [
    (2, 128, 128, 32, 32, 128, 128),
    (4, 256, 384, 64, 32, 128, 128),
    (1, 512, 256, 16, 16, 256, 128)])
def test_flash_attention_matches_reference_kernel_sweep(BH, S, T, hd, hv, bq,
                                                        bk):
    rng = np.random.default_rng(S + T + hd)
    q = rng.standard_normal((BH, S, hd)).astype(np.float32)
    k = rng.standard_normal((BH, T, hd)).astype(np.float32)
    v = rng.standard_normal((BH, T, hv)).astype(np.float32)
    for causal, window, pre in MASKS:
        kw = dict(scale=hd ** -0.5, kv_len=T, causal=causal, window=window,
                  prefix_len=pre)
        rk = flash_attention_kernel(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), block_q=bq, block_k=bk,
                                    interpret=True, **kw)
        rr = r_flash_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **kw)
        got = flash_attention_ref(_t(q), _t(k), _t(v), **kw)
        assert got.shape == (BH, S, hv) and got.dtype == torch.float32
        assert np.abs(got.numpy() - _np(rk)).max() < TOL, (causal, window, pre)
        assert np.abs(got.numpy() - _np(rr)).max() < TOL, (causal, window, pre)


@pytest.mark.parametrize("prefix", [256, 200])
def test_flash_attention_256_prefix_lm_matches_reference_kernel(prefix):
    """Head dims (256, 256), PaliGemma's, under the prefix-LM mask: a
    bidirectional prefix of 256 keys (its image patches), whose first q
    tile sees keys past its own diagonal, and of 200 (no multiple of any
    key tile). The port's plain version against the reference's kernel in
    interpret mode and its ref."""
    rng = np.random.default_rng(prefix)
    BH, S, hd = 2, 384, 256
    q = rng.standard_normal((BH, S, hd)).astype(np.float32)
    k = rng.standard_normal((BH, S, hd)).astype(np.float32)
    v = rng.standard_normal((BH, S, hd)).astype(np.float32)
    kw = dict(scale=hd ** -0.5, kv_len=S, causal=True, window=0,
              prefix_len=prefix)
    rk = flash_attention_kernel(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), block_q=128, block_k=128,
                                interpret=True, **kw)
    rr = r_flash_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **kw)
    got = flash_attention_ref(_t(q), _t(k), _t(v), **kw).numpy()
    assert got.shape == (BH, S, hd)
    assert np.abs(got - _np(rk)).max() < TOL
    assert np.abs(got - _np(rr)).max() < TOL


@pytest.mark.parametrize("kv_len,window", [(200, 0), (131, 0), (96, 40)])
def test_flash_attention_kv_len_tail_and_empty_rows(kv_len, window):
    """Keys at or past ``kv_len`` are masked; a row with no valid key (a
    window that ends before ``kv_len``... or starts past it) is 0, as the
    reference's kernel and ref give."""
    rng = np.random.default_rng(kv_len)
    BH, S, T, hd = 2, 256, 256, 32
    q = rng.standard_normal((BH, S, hd)).astype(np.float32)
    k = rng.standard_normal((BH, T, hd)).astype(np.float32)
    v = rng.standard_normal((BH, T, hd)).astype(np.float32)
    kw = dict(scale=hd ** -0.5, kv_len=kv_len, causal=True, window=window,
              prefix_len=0)
    rk = flash_attention_kernel(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), block_q=128, block_k=128,
                                interpret=True, **kw)
    rr = r_flash_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **kw)
    got = flash_attention_ref(_t(q), _t(k), _t(v), **kw).numpy()
    assert np.abs(got - _np(rk)).max() < TOL
    assert np.abs(got - _np(rr)).max() < TOL
    if window:   # rows whose window lies wholly past kv_len are all zero
        empty = np.arange(S) - window + 1 >= kv_len
        assert empty.any() and (got[:, empty] == 0).all()


@pytest.mark.parametrize("B,S,T,H,Hk,hd", [(2, 200, 200, 8, 2, 32),
                                           (1, 130, 70, 4, 4, 16),
                                           (1, 96, 160, 8, 1, 16)])
def test_flash_sdpa_gqa_matches_reference(B, S, T, H, Hk, hd):
    """The port's ``flash_sdpa`` (GQA without repeating kv) against the
    reference's ``flash_sdpa`` (repeated kv, padded, interpret mode) and
    ``_sdpa_small``; ragged S and T."""
    rng = np.random.default_rng(S * T)
    q = rng.standard_normal((B, S, H, hd)).astype(np.float32)
    k = rng.standard_normal((B, T, Hk, hd)).astype(np.float32)
    v = rng.standard_normal((B, T, Hk, hd)).astype(np.float32)
    n_rep = H // Hk
    for kind, window, pre in (("causal", 0, 0), ("full", 0, 0),
                              ("causal", 24, 0), ("causal", 0, 13)):
        rspec = RA.MaskSpec(kind, window, pre)
        pspec = PA.MaskSpec(kind, window, pre)
        jq, jk, jv = jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)
        want = _np(r_flash_sdpa(jq, jk, jv, rspec, n_rep, hd ** -0.5))
        small = _np(RA._sdpa_small(jq, jk, jv, rspec, n_rep))
        got = p_ops.flash_sdpa(_t(q), _t(k), _t(v), pspec, n_rep, hd ** -0.5)
        assert got.shape == (B, S, H * hd)
        valid = rspec.tile(jnp.arange(S), jnp.arange(T)).any(-1)
        valid = np.asarray(valid)
        assert np.abs(got.numpy() - want).max() < TOL, (kind, window, pre)
        # _sdpa_small spreads uniform weights over a row with no valid key
        assert np.abs(got.numpy()[:, valid] - small[:, valid]).max() < TOL


def test_sdpa_flash_matches_small_and_reference():
    """Mirrors ``test_models.py::test_flash_attention_matches_small`` on
    the port, with the reference's ``_sdpa_flash`` as a third party."""
    rng = np.random.default_rng(0)
    q = rng.standard_normal((2, 200, 4, 16)).astype(np.float32)
    k = rng.standard_normal((2, 200, 2, 16)).astype(np.float32)
    v = rng.standard_normal((2, 200, 2, 16)).astype(np.float32)
    jq, jk, jv = jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)
    for kind, window, pre in (("causal", 0, 0), ("full", 0, 0),
                              ("causal", 32, 0), ("causal", 0, 13)):
        pspec = PA.MaskSpec(kind, window, pre)
        rspec = RA.MaskSpec(kind, window, pre)
        small = PA._sdpa_small(_t(q), _t(k), _t(v), pspec, 2)
        flash = PA._sdpa_flash(_t(q), _t(k), _t(v), pspec, 2, q_chunk=64,
                               kv_chunk=48)
        rflash = _np(RA._sdpa_flash(jq, jk, jv, rspec, 2, q_chunk=64,
                                    kv_chunk=48))
        rsmall = _np(RA._sdpa_small(jq, jk, jv, rspec, 2))
        assert (flash - small).abs().max() < TOL, pspec
        assert np.abs(flash.numpy() - rflash).max() < TOL, pspec
        assert np.abs(small.numpy() - rsmall).max() < TOL, pspec


@pytest.mark.parametrize("S,T,n_rep,hd,causal,window,seed", [
    (8, 8, 1, 8, False, 0, 1), (37, 90, 2, 16, True, 9, 2),
    (96, 96, 4, 8, True, 0, 3), (50, 23, 2, 16, False, 0, 4),
    (64, 80, 1, 16, True, 17, 5), (11, 96, 4, 8, True, 12, 6)])
def test_flash_equals_exact_attention_cases(S, T, n_rep, hd, causal, window,
                                            seed):
    """Cases of ``test_properties.py::test_flash_equals_exact_attention``
    (the same draw rules: T >= S when causal, window >= 8), with the
    reference's exact path as the oracle."""
    if causal and T < S:
        T = S
    rng = np.random.default_rng(seed)
    Hk = 2
    q = rng.standard_normal((1, S, Hk * n_rep, hd)).astype(np.float32)
    k = rng.standard_normal((1, T, Hk, hd)).astype(np.float32)
    v = rng.standard_normal((1, T, Hk, hd)).astype(np.float32)
    kind = "causal" if causal else "full"
    w = window if causal and window >= 8 else 0
    ref = _np(RA._sdpa_small(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             RA.MaskSpec(kind, w, 0), n_rep))
    got = PA._sdpa_flash(_t(q), _t(k), _t(v), PA.MaskSpec(kind, w, 0), n_rep,
                         q_chunk=32, kv_chunk=16)
    assert np.abs(got.numpy() - ref).max() < 2e-4


def test_k5_bound_admits_tiled_bf16_and_rejects_a_dropped_tile():
    """``chip_smoke.k5_tolerance``, the per-element bf16 bound K5 is held to
    on the card, checked here on the port's tiled path: ``_sdpa_flash`` in
    bf16 (64-key tiles, float32 running state, p rounded to bf16 before
    p·v, as in the kernel) lies within it of the plain version, causal and
    full; the same with one 64-key tile of 1,024 dropped (the full mask
    over the other keys) breaks it."""
    from chip_smoke import k5_check
    rng = np.random.default_rng(14)
    B, S, H, Hk, hd = 1, 1024, 4, 1, 64
    q, k, v = (_t(rng.standard_normal((B, S, h, hd)).astype(np.float32))
               .bfloat16() for h in (H, Hk, Hk))
    scale = hd ** -0.5
    for kind in ("causal", "full"):
        spec = PA.MaskSpec(kind, 0, 0)
        tiled = PA._sdpa_flash(q, k, v, spec, H // Hk, scale, q_chunk=64,
                               kv_chunk=64)
        r = k5_check(tiled, q, k, v, spec, H // Hk, scale)
        assert 0 < r["max_err_over_tol"] <= 1.0, (kind, r)
    keep = torch.ones(S, dtype=torch.bool)
    keep[320:384] = False
    full = PA.MaskSpec("full", 0, 0)
    dropped = PA._sdpa_flash(q, k[:, keep], v[:, keep], full, H // Hk, scale,
                             q_chunk=64, kv_chunk=64)
    r = k5_check(dropped, q, k, v, full, H // Hk, scale)
    assert r["max_err_over_tol"] > 1.0, r


def test_k5_check_counts_a_nan_as_an_infinite_error():
    """``chip_smoke._err_over_tol``, which every K5 check reads: a NaN in
    the kernel's output is an infinite error, so neither its maximum nor
    ``k5_sweep``'s running maximum over the cases can pass it."""
    import chip_smoke
    want = torch.ones(4)
    got = torch.tensor([1.0, float("nan"), 1.0, 1.0])
    r = chip_smoke._err_over_tol(got, want, torch.full((4,), 0.5))
    assert r["max_abs_err"] == float("inf")
    assert r["max_err_over_tol"] == float("inf")
    assert chip_smoke._err_over_tol(want, want, want)["max_err_over_tol"] == 0


def test_sdpa_dispatch_on_the_cpu_takes_the_tiled_path():
    """Above ``FLASH_THRESH`` a CPU tensor runs ``_sdpa_flash`` (no kernel
    launch); below it ``_sdpa_small``."""
    rng = np.random.default_rng(9)
    S = 2100                      # S*S > 2048*2048
    q = _t(rng.standard_normal((1, S, 2, 8)).astype(np.float32))
    k = _t(rng.standard_normal((1, S, 1, 8)).astype(np.float32))
    v = _t(rng.standard_normal((1, S, 1, 8)).astype(np.float32))
    n0 = p_ops.LAUNCHES
    got = PA.sdpa(q, k, v, PA.CAUSAL, 2)
    assert p_ops.LAUNCHES == n0
    assert torch.equal(got, PA._sdpa_flash(q, k, v, PA.CAUSAL, 2))
    small = PA.sdpa(q[:, :64], k[:, :64], v[:, :64], PA.CAUSAL, 2)
    assert torch.equal(small, PA._sdpa_small(q[:, :64], k[:, :64],
                                             v[:, :64], PA.CAUSAL, 2))


# ------------------------------------------- K5's input checks, on the CPU

def _bf16(shape, offset=0, strides=None):
    """A bf16 view of ``shape`` whose base lies ``offset`` elements into a
    fresh buffer (an allocation is 64-byte aligned), with ``strides`` if
    given."""
    n = int(np.prod(shape)) if strides is None else 1 + sum(
        (d - 1) * s for d, s in zip(shape, strides))
    buf = torch.zeros(n + offset, dtype=torch.bfloat16)
    if strides is None:
        return buf[offset:].view(shape)
    return buf.as_strided(shape, strides, offset)


def _heads(x):
    """[B, rows, heads, d] -> the [B, heads, rows, d] view launch takes."""
    return x.permute(0, 2, 1, 3)


@pytest.mark.parametrize("name,t,why", [
    ("contiguous [B,S,H,d] heads", _heads(_bf16((2, 70, 4, 128))), None),
    ("head dim 24 of one head", _heads(_bf16((3, 65, 1, 24))), None),
    ("base 16 bytes in", _heads(_bf16((1, 64, 2, 64), offset=8)), None),
    ("extent-1 dims with odd strides",
     _bf16((1, 1, 64, 16), strides=(5, 3, 16, 1)), None),
    ("base 2 bytes in", _heads(_bf16((1, 64, 2, 64), offset=1)),
     "not 16-byte aligned"),
    ("base 8 bytes in", _heads(_bf16((1, 64, 2, 64), offset=4)),
     "not 16-byte aligned"),
    ("head dim 20", _heads(_bf16((1, 64, 1, 20))), "not a multiple of 8"),
    ("head stride 20 elements", _heads(_bf16((1, 64, 4, 20))[..., :16]),
     "not multiples of 16 bytes"),
    ("row stride 12 elements", _bf16((2, 1, 64, 8), strides=(768, 768, 12, 1)),
     "not multiples of 16 bytes"),
])
def test_k5_tma_refusal_on_cpu_tensors(name, t, why):
    """``cuda.tma_refusal``: which bf16 views the kernel's TMA loads can
    describe (base 16-byte aligned, head dim and every stride of a dim of
    extent above 1 whole 16-byte units) and why the others are refused."""
    from repro_torch.kernels.flash_attention import cuda as k5cuda
    got = k5cuda.tma_refusal(t)
    if why is None:
        assert got is None, (name, got)
    else:
        assert got is not None and why in got, (name, got)


def _qkv(H=4, Hk=2, S=64, T=64, hd=64, hv=64, dtype=torch.bfloat16):
    return (_heads(torch.zeros((1, S, H, hd), dtype=dtype)),
            _heads(torch.zeros((1, T, Hk, hd), dtype=dtype)),
            _heads(torch.zeros((1, T, Hk, hv), dtype=dtype)))


@pytest.mark.parametrize("name,build,kw,exc", [
    ("bf16 GQA", lambda: _qkv(), {}, None),
    ("float32, head dim 20", lambda: _qkv(hd=20, hv=20, dtype=torch.float32),
     {}, None),
    ("bf16 kv_len < T", lambda: _qkv(T=96), dict(kv_len=40), None),
    ("not 4-D", lambda: tuple(x[0] for x in _qkv()), {}, ValueError),
    ("kv heads x n_rep != heads", lambda: _qkv(), dict(n_rep=4), ValueError),
    ("k and v rows disagree", lambda: (*_qkv()[:2], _qkv(T=32)[2]), {},
     ValueError),
    ("v another dtype", lambda: (*_qkv()[:2], _qkv(dtype=torch.float32)[2]),
     {}, TypeError),
    ("float16", lambda: _qkv(dtype=torch.float16), {}, TypeError),
    ("last dim strided", lambda: (_qkv()[0].transpose(2, 3), *_qkv()[1:]), {},
     ValueError),
    ("head dim 256", lambda: _qkv(hd=256, hv=256), {}, None),
    ("bf16 q/k 192, v 128 (MLA)", lambda: _qkv(hd=192, hv=128), {}, None),
    ("float32 q/k 136, v 64", lambda: _qkv(hd=136, hv=64,
                                           dtype=torch.float32), {}, None),
    ("v head dim 192", lambda: _qkv(hd=192, hv=192), {}, None),
    ("q/k head dim 200", lambda: _qkv(hd=200, hv=128), {}, None),
    ("float32 head dim 256", lambda: _qkv(hd=256, hv=256,
                                          dtype=torch.float32), {}, None),
    ("head dim 264", lambda: _qkv(hd=264, hv=264), {}, ValueError),
    ("v head dim 320", lambda: _qkv(hd=64, hv=320), {}, ValueError),
    ("q/k head dim 320", lambda: _qkv(hd=320, hv=128), {}, ValueError),
    ("kv_len past T", lambda: _qkv(), dict(kv_len=65), ValueError),
    ("bf16 base not aligned",
     lambda: (_heads(_bf16((1, 64, 4, 64), offset=1)), *_qkv()[1:]), {},
     ValueError),
    ("bf16 head dim 20", lambda: _qkv(hd=20, hv=20), {}, ValueError),
])
def test_k5_check_inputs_on_cpu_tensors(name, build, kw, exc):
    """``cuda.check_inputs``, everything ``launch`` checks but the device,
    on CPU tensors: the shapes, dtypes and layouts it refuses, and bf16
    views TMA cannot describe (``ValueError``), while float32 takes any
    head dim and bf16 any describable GQA view."""
    from repro_torch.kernels.flash_attention import cuda as k5cuda
    q, k, v = build()
    args = dict(n_rep=2, kv_len=k.shape[2] if k.dim() == 4 else 0)
    args.update(kw)
    if exc is None:
        k5cuda.check_inputs(q, k, v, **args)
    else:
        with pytest.raises(exc):
            k5cuda.check_inputs(q, k, v, **args)


def test_k5_launch_refuses_cpu_tensors():
    from repro_torch.kernels.flash_attention import cuda as k5cuda
    with pytest.raises(ValueError, match="CUDA"):
        k5cuda.launch(*_qkv(), n_rep=2, scale=0.125, kv_len=64, causal=True,
                      window=0, prefix_len=0)
