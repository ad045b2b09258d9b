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

The forward is the custom op ``repro_torch::flash_fwd``
(``torch.library.custom_op``): its fake gives the output's shape and
dtype, so a dry run traces it on fake tensors and launches nothing, and
its FLOP formula (:func:`flop_count`, registered with
``torch.utils.flop_counter``) counts the (query, key) pairs the mask
lets through. A ``DTensor`` q (with k and v) runs the op on each rank's
shard (:func:`_flash_sdpa_dtensor`): batch and query heads keep their
shards, sequence and head dims are replicated, and the kv heads follow
the query heads (sharded with them where they divide the mesh dim, else
each rank slices the kv heads its query heads read).
"""
from __future__ import annotations

from typing import NamedTuple

import torch
from torch.utils.flop_counter import register_flop_formula

from . import cuda
from .ref import flash_sdpa_ref

__all__ = ["flash_sdpa", "flash_sdpa_backward", "flash_fwd", "flop_count",
           "visible_pairs", "sharded_attention", "LAUNCHES"]

LAUNCHES = 0


@torch.library.custom_op("repro_torch::flash_fwd", mutates_args=())
def flash_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, n_rep: int,
              scale: float, causal: bool, window: int,
              prefix_len: int) -> torch.Tensor:
    """K5's forward: q [B,S,H,hd], k/v [B,T,Hk,hv] -> [B,S,H*hv]; one
    launch on the card, the plain version on the CPU."""
    global LAUNCHES
    mask = _Mask("causal" if causal else "full", window, prefix_len)
    if not q.is_cuda:
        return flash_sdpa_ref(q, k, v, mask, n_rep, scale)
    B, S, H, _ = q.shape
    out, launched = cuda.launch(
        q.permute(0, 2, 1, 3), k.permute(0, 2, 1, 3), v.permute(0, 2, 1, 3),
        n_rep=n_rep, scale=scale, kv_len=k.shape[1], causal=causal,
        window=window, prefix_len=prefix_len)
    LAUNCHES += launched
    return out.reshape(B, S, H * v.shape[-1])


@flash_fwd.register_fake
def _flash_fwd_fake(q, k, v, n_rep, scale, causal, window, prefix_len):
    B, S, H, _ = q.shape
    return q.new_empty((B, S, H * v.shape[-1]))


class _Mask(NamedTuple):
    kind: str
    window: int
    prefix_len: int


def visible_pairs(S: int, T: int, causal: bool, window: int = 0,
                  prefix_len: int = 0) -> int:
    """The (query, key) pairs the mask lets through: query i sees key j
    when j <= i and i - j < window (window 0: no limit), or j below the
    bidirectional prefix; every pair without a causal mask."""
    if not causal:
        return S * T

    p = min(prefix_len, T)

    def row(i: int) -> int:                 # keys of query row i
        lo = max(0, i - window + 1) if window else 0
        hi = min(i, T - 1)
        if hi < lo:
            return p
        # the band [lo, hi] and the prefix keys outside it
        return hi - lo + 1 + min(p, lo) + max(0, p - hi - 1)

    if not window and not prefix_len:
        m = min(S, T)
        return m * (m + 1) // 2 + max(0, S - T) * T
    return sum(row(i) for i in range(S))


def flop_count(q_shape, k_shape, v_shape, n_rep, scale, causal, window,
               prefix_len, *args, **kwargs) -> int:
    """FLOPs of one K5 forward: 2 (hd + hv) a visible (query, key) pair a
    query head (q k^T and p v; 4 B H S T hd without a mask)."""
    B, S, H, hd = q_shape
    T, hv = k_shape[1], v_shape[-1]
    return 2 * B * H * (hd + hv) * visible_pairs(S, T, causal, window,
                                                 prefix_len)


register_flop_formula(torch.ops.repro_torch.flash_fwd)(flop_count)


def _forward(q, k, v, mask, n_rep: int, scale: float):
    return flash_fwd(q, k, v, n_rep, float(scale), mask.kind == "causal",
                     int(mask.window), int(mask.prefix_len))


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
    in q, k and v (recompute backward, :func:`flash_sdpa_backward`).
    DTensors run on each rank's shard (:func:`_flash_sdpa_dtensor`)."""
    from torch.distributed.tensor import DTensor
    if isinstance(q, DTensor):
        return _flash_sdpa_dtensor(q, k, v, mask, n_rep, scale)
    return _FlashSDPA.apply(q, k, v, mask, n_rep, scale)


def _flash_sdpa_dtensor(q, k, v, mask, n_rep: int, scale: float):
    """:func:`flash_sdpa` on DTensors: K5 on each rank's shard
    (:func:`sharded_attention`)."""
    return sharded_attention(
        q, k, v, n_rep,
        lambda ql, kl, vl, rep: _FlashSDPA.apply(ql, kl, vl, mask, rep,
                                                 scale))


def sharded_attention(q, k, v, n_rep: int, fn):
    """``fn(q, k, v, n_rep)`` (an attention over [B,S,H,hd] q and
    [B,T,Hk,hv] k/v -> [B,S,H*hv]) on DTensors over one mesh, on each
    rank's shard: each mesh dim keeps q's batch shard (k and v take it
    too), else shards the query heads
    where they divide it, else replicates. Where the query heads shard a
    mesh dim and the kv heads do not divide it, k and v stay replicated
    there and each rank takes the kv heads its query heads read (their
    gradient a partial sum over that dim). The output [B,S,H*hv] keeps
    the batch and head shards. Plain tensors go to ``fn`` as they are."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    if not isinstance(q, DTensor):
        return fn(q, k, v, n_rep)
    mesh = q.device_mesh
    B, S, H, _ = q.shape
    Hk, hv = k.shape[2], v.shape[-1]
    qp, kvp, kv_grad, cut = [], [], [], None
    h_local = H
    for md, pl in enumerate(q.placements):
        n = mesh.size(md)
        if isinstance(pl, Shard) and pl.dim == 0 and B % n == 0:
            qp.append(Shard(0))
            kvp.append(Shard(0))
            kv_grad.append(Shard(0))
            continue
        if h_local % n == 0:                # heads: a local slice or a
            hl = h_local // n               # reduce-scatter of a sum
            if Hk % n == 0 and cut is None:
                qp.append(Shard(2))
                kvp.append(Shard(2))
                kv_grad.append(Shard(2))
                h_local = hl
                continue
            if cut is None and (hl % n_rep == 0 or n_rep % hl == 0):
                qp.append(Shard(2))
                kvp.append(Replicate())
                kv_grad.append(Partial())
                cut = (md, hl)
                h_local = hl
                continue
        qp.append(Replicate())
        kvp.append(Replicate())
        kv_grad.append(Replicate())
    ql = q.redistribute(mesh, qp).to_local()
    kl = k.redistribute(mesh, kvp).to_local(grad_placements=kv_grad)
    vl = v.redistribute(mesh, kvp).to_local(grad_placements=kv_grad)
    rep = n_rep
    if cut is not None:
        md, hl = cut
        first = mesh.get_local_rank(md) * hl
        g0, g1 = first // n_rep, (first + hl - 1) // n_rep + 1
        kl, vl = kl[:, :, g0:g1], vl[:, :, g0:g1]
        rep = min(n_rep, hl)
    out = fn(ql, kl, vl, rep)
    outp = [pl if isinstance(pl, Shard) else Replicate() for pl in qp]
    shape = (B, S, H * hv)
    return DTensor.from_local(out, mesh, outp, run_check=False, shape=shape,
                              stride=(S * H * hv, H * hv, 1))
