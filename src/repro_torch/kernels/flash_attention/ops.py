"""Wrapper for the flash-attention forward kernel (K5) — the port's
counterpart of ``repro.kernels.flash_attention.ops``.

:func:`flash_sdpa` is what ``models.attention.sdpa`` calls above
``FLASH_THRESH``: q [B,S,H,hd], k/v [B,T,Hk,hv] -> [B,S,H*hv]. For tensors
on the card its forward launches the CUDA kernel (``cuda.py``) once, or
raises; for tensors on the CPU it runs the plain torch version
(``ref.py``). Unlike the reference's wrapper, nothing is padded and kv is
not repeated: the kernel masks its edges and reads kv head ``h // n_rep``
for query head ``h``. ``LAUNCHES`` counts the kernel launches made in this
process.

It is a ``torch.autograd.Function``, as the reference's is a
``jax.custom_vjp``: the forward saves only q, k and v, and the backward
recomputes, taking the VJP of the tiled online-softmax path
``models.attention._sdpa_flash`` as the reference's ``_bwd`` does. It
recomputes and differentiates one q chunk (``Q_CHUNK`` rows) at a time,
writing that chunk's dq rows and adding its dk and dv into float32 sums,
so only one chunk's tiles are alive at once (differentiating the whole
path would keep every tile's logits: ~10 GB a layer of yi-9b at 4,096
tokens). There is no backward kernel: the reference has none either.
"""
from __future__ import annotations

import torch

from . import cuda
from .ref import flash_sdpa_ref

__all__ = ["flash_sdpa", "flash_sdpa_backward", "LAUNCHES"]

LAUNCHES = 0


def _forward(q, k, v, mask, n_rep: int, scale: float):
    global LAUNCHES
    if not q.is_cuda:
        return flash_sdpa_ref(q, k, v, mask, n_rep, scale)
    B, S, H, _ = q.shape
    out, launched = cuda.launch(
        q.permute(0, 2, 1, 3), k.permute(0, 2, 1, 3), v.permute(0, 2, 1, 3),
        n_rep=n_rep, scale=scale, kv_len=k.shape[1],
        causal=mask.kind == "causal", window=mask.window,
        prefix_len=mask.prefix_len)
    LAUNCHES += launched
    return out.reshape(B, S, H * v.shape[-1])


def flash_sdpa_backward(q, k, v, g, mask, n_rep: int, scale: float):
    """(dq, dk, dv) of ``_sdpa_flash(q, k, v, ...)`` for the output
    cotangent ``g`` [B,S,H*hv], one q chunk at a time: each chunk's rows
    are recomputed by ``_flash_rows`` and differentiated with
    ``torch.autograd.grad``; dq is written chunk by chunk, dk and dv are
    summed in float32 and cast to k's and v's dtype at the end."""
    from ...models.attention import Q_CHUNK, _flash_rows   # imports ops
    S = q.shape[1]
    qc = min(Q_CHUNK, S)
    dq = torch.empty_like(q)
    dk = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
    dv = torch.zeros(v.shape, dtype=torch.float32, device=v.device)
    with torch.enable_grad():
        kd = k.detach().requires_grad_()
        vd = v.detach().requires_grad_()
        for s0 in range(0, S, qc):
            qd = q[:, s0:s0 + qc].detach().requires_grad_()
            out = _flash_rows(qd, kd, vd, mask, n_rep, scale, s0)
            gq, gk, gv = torch.autograd.grad(out, (qd, kd, vd),
                                             g[:, s0:s0 + qc])
            dq[:, s0:s0 + qc] = gq
            dk += gk
            dv += gv
    return dq, dk.to(k.dtype), dv.to(v.dtype)


class _FlashSDPA(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, mask, n_rep, scale):
        ctx.save_for_backward(q, k, v)
        ctx.attrs = (mask, n_rep, scale)
        return _forward(q, k, v, mask, n_rep, scale)

    @staticmethod
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        dq, dk, dv = flash_sdpa_backward(q, k, v, g, *ctx.attrs)
        return dq, dk, dv, None, None, None


def flash_sdpa(q, k, v, mask, n_rep: int, scale: float):
    """q [B,S,H,hd], k/v [B,T,Hk,hv] -> [B,S,H*hv]; ``mask`` is a
    ``models.attention.MaskSpec`` (kind, window, prefix_len). Differentiable
    in q, k and v (recompute backward, :func:`flash_sdpa_backward`)."""
    return _FlashSDPA.apply(q, k, v, mask, n_rep, scale)
