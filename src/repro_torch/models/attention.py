"""GQA attention: training forward, prefill, and one-token decode with a KV
cache — the port's counterpart of ``repro.models.attention``.

The same knobs as the reference: GQA group sizes, QKV bias (qwen2.5),
qk-norm (qwen3), sliding window, prefix-LM masks, RoPE. Masks are specs,
not tensors. :func:`sdpa` dispatches as the reference does: the exact
single-softmax path below ``FLASH_THRESH``; above it, a tensor on the card
goes to the flash-attention kernel (``kernels.flash_attention.ops
.flash_sdpa``, K5) and a tensor on the CPU to the tiled online-softmax
path :func:`_sdpa_flash`.

Where the reference asks for a float32 product of bf16 operands
(``preferred_element_type=jnp.float32``), q and k are upcast to float32
first: the products are exact and the sums are float32, as there.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from ..kernels.flash_attention import ops as flash_ops
from .config import ModelConfig
from .layers import (Params, _trunc_normal, dense_init, norm_params,
                     rms_norm, rope_apply, rope_freqs)

__all__ = ["NEG", "FLASH_THRESH", "Q_CHUNK", "KV_CHUNK", "MaskSpec", "CAUSAL",
           "FULL", "proj_out", "KVCache", "attn_params", "sdpa",
           "attn_forward", "attn_prefill", "attn_decode", "init_kv_cache"]

NEG = -1e30
FLASH_THRESH = 2048 * 2048       # S*T above this -> tiled path
Q_CHUNK = 1024
KV_CHUNK = 1024


class MaskSpec(NamedTuple):
    kind: str = "causal"             # causal | full
    window: int = 0                  # 0 = unlimited
    prefix_len: int = 0              # bidirectional prefix (PaliGemma)

    def tile(self, qi, kj):
        """Boolean tile mask from absolute indices qi [qc], kj [kc]."""
        if self.kind == "full":
            return torch.ones((qi.shape[0], kj.shape[0]), dtype=torch.bool,
                              device=qi.device)
        m = kj[None, :] <= qi[:, None]
        if self.window:
            m &= kj[None, :] > (qi[:, None] - self.window)
        if self.prefix_len:
            m |= kj[None, :] < self.prefix_len
        return m


CAUSAL = MaskSpec("causal")
FULL = MaskSpec("full")


def proj_out(flat, wo):
    """[B,S,H*hv] x wo[H,hv,d] -> [B,S,d]."""
    B, S = flat.shape[:2]
    H, hv, d = wo.shape
    return flat.reshape(B, S, H * hv) @ wo.reshape(H * hv, d)


class KVCache(NamedTuple):
    k: torch.Tensor  # [B, S_max, n_kv, hd]
    v: torch.Tensor  # [B, S_max, n_kv, hd]


def attn_params(gen, cfg: ModelConfig, dtype=None) -> Params:
    dtype = dtype or cfg.dtype
    d, H, Hk, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    dev = gen.device
    p = {"wq": dense_init(gen, d, H, hd, dtype=dtype),
         "wk": dense_init(gen, d, Hk, hd, dtype=dtype),
         "wv": dense_init(gen, d, Hk, hd, dtype=dtype),
         # [H, hd, d] so either heads or head_dim can shard
         "wo": _trunc_normal(gen, (H, hd, d), (H * hd) ** -0.5, dtype)}
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((H, hd), dtype=dtype, device=dev)
        p["bk"] = torch.zeros((Hk, hd), dtype=dtype, device=dev)
        p["bv"] = torch.zeros((Hk, hd), dtype=dtype, device=dev)
    if cfg.qk_norm:
        p["qnorm"] = norm_params(gen, hd, "rms", dtype)
        p["knorm"] = norm_params(gen, hd, "rms", dtype)
    return p


def _heads(x, w):
    """x [B,S,d] @ w [d,n,h] -> [B,S,n,h] (the reference's einsum
    ``bsd,dnh->bsnh``)."""
    d, n, h = w.shape
    return (x @ w.reshape(d, n * h)).reshape(*x.shape[:-1], n, h)


def _qkv(p: Params, cfg: ModelConfig, x, positions):
    q = _heads(x, p["wq"])
    k = _heads(x, p["wk"])
    v = _heads(x, p["wv"])
    if cfg.qkv_bias:
        q = q + p["bq"]
        k = k + p["bk"]
        v = v + p["bv"]
    if cfg.qk_norm:
        q = rms_norm(q, p["qnorm"]["w"], cfg.norm_eps)
        k = rms_norm(k, p["knorm"]["w"], cfg.norm_eps)
    if cfg.pos == "rope" and positions is not None:
        sin, cos = rope_freqs(positions, cfg.hd, cfg.rope_theta)
        q = rope_apply(q, sin, cos)
        k = rope_apply(k, sin, cos)
    return q, k, v


# ------------------------------------------------------------------ sdpa
def sdpa(q, k, v, mask: Optional[MaskSpec], n_rep: int,
         scale: Optional[float] = None):
    """q [B,S,H,hd], k/v [B,T,Hk,hd] -> [B,S,H*hd]. mask=None means full.

    Dispatch: small sequences use the exact single-softmax path; long ones
    the flash-attention kernel K5 for tensors on the card, and the tiled
    online softmax :func:`_sdpa_flash` for tensors on the CPU (in the
    reference: the Pallas kernel on a TPU, the scan path elsewhere).
    """
    B, S, H, hd = q.shape
    T = k.shape[1]
    mask = mask or FULL
    if S * T > FLASH_THRESH:
        if q.is_cuda:
            return flash_ops.flash_sdpa(q, k, v, mask, n_rep,
                                        scale or hd ** -0.5)
        return _sdpa_flash(q, k, v, mask, n_rep, scale)
    return _sdpa_small(q, k, v, mask, n_rep, scale)


def _sdpa_small(q, k, v, mask: MaskSpec, n_rep: int, scale=None):
    B, S, H, hd = q.shape
    T, Hk = k.shape[1], k.shape[2]
    hv = v.shape[-1]
    scale = scale or hd ** -0.5
    qg = q.reshape(B, S, Hk, n_rep, hd)
    logits = torch.einsum("bskrh,btkh->bkrst", qg.float(), k.float()) * scale
    dev = q.device
    m = mask.tile(torch.arange(S, device=dev), torch.arange(T, device=dev))
    logits = torch.where(m[None, None, None], logits, NEG)
    w = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkrst,btkh->bskrh", w.to(v.dtype), v)
    return out.reshape(B, S, H * hv)


def _sdpa_flash(q, k, v, mask: MaskSpec, n_rep: int, scale=None,
                q_chunk: int = Q_CHUNK, kv_chunk: int = KV_CHUNK):
    """Online-softmax tiling; [S,T] logits never materialize. The
    reference's outer ``lax.scan`` over q chunks becomes a loop over
    :func:`_flash_rows`, one call a chunk (rows are independent, so the
    last chunk is not padded); its inner scan is the loop inside."""
    S = q.shape[1]
    qc = min(q_chunk, S)
    return torch.cat([_flash_rows(q[:, s0:s0 + qc], k, v, mask, n_rep,
                                  scale, s0, kv_chunk)
                      for s0 in range(0, S, qc)], dim=1)


def _flash_rows(q, k, v, mask: MaskSpec, n_rep: int, scale, q0: int,
                kv_chunk: int = KV_CHUNK):
    """Rows ``q0 .. q0 + qc`` of :func:`_sdpa_flash`: q [B,qc,H,hd] those
    rows' queries, k/v [B,T,Hk,hv] every key -> [B,qc,H*hv]. The masks
    take absolute row indices from ``q0``. The flash-attention backward
    (``kernels.flash_attention.ops``) differentiates one such chunk at a
    time."""
    B, qc, H, hd = q.shape
    T, Hk = k.shape[1], k.shape[2]
    hv = v.shape[-1]
    scale = scale or hd ** -0.5
    dev = q.device
    kc = min(kv_chunk, T)
    nk = -(-T // kc)
    Tp = nk * kc
    kg = F.pad(k, (0, 0, 0, 0, 0, Tp - T))
    vg = F.pad(v, (0, 0, 0, 0, 0, Tp - T))
    qt = q.reshape(B, qc, Hk, n_rep, hd).permute(0, 2, 3, 1, 4).float()
    kg = kg.reshape(B, nk, kc, Hk, hd).permute(1, 0, 3, 2, 4)
    vg = vg.reshape(B, nk, kc, Hk, hv).permute(1, 0, 3, 2, 4)
    # qt [B, Hk, rep, qc, hd]; kg/vg [nk, B, Hk, kc, hd]
    qidx = q0 + torch.arange(qc, device=dev)
    m_run = torch.full((B, Hk, n_rep, qc), NEG, dtype=torch.float32,
                       device=dev)
    l_run = torch.zeros((B, Hk, n_rep, qc), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, Hk, n_rep, qc, hv), dtype=torch.float32,
                      device=dev)
    for jk in range(nk):
        kt, vt = kg[jk], vg[jk]
        kidx = jk * kc + torch.arange(kc, device=dev)
        s = torch.einsum("bkrqh,bkch->bkrqc", qt, kt.float()) * scale
        tm = mask.tile(qidx, kidx) & (kidx < T)[None, :]
        s = torch.where(tm[None, None, None], s, NEG)
        m_new = torch.maximum(m_run, s.amax(-1))
        p = torch.where(tm[None, None, None],
                        torch.exp(s - m_new[..., None]), 0.0)
        corr = torch.exp(m_run - m_new)
        l_run = l_run * corr + p.sum(-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bkrqc,bkch->bkrqh", p.to(vt.dtype), vt).float()
        m_run = m_new
    out = (acc / torch.clamp(l_run, min=1e-20)[..., None]).to(q.dtype)
    # [B, Hk, rep, qc, hv] -> [B, qc, H*hv]
    return out.permute(0, 3, 1, 2, 4).reshape(B, qc, Hk * n_rep * hv)


def attn_forward(p: Params, cfg: ModelConfig, x, positions,
                 mask: Optional[MaskSpec]) -> torch.Tensor:
    """Training/prefill attention over the full sequence."""
    q, k, v = _qkv(p, cfg, x, positions)
    out = sdpa(q, k, v, mask, cfg.n_heads // cfg.n_kv_heads)
    return proj_out(out, p["wo"])


def attn_prefill(p: Params, cfg: ModelConfig, x, positions,
                 mask: Optional[MaskSpec], cache_len: int,
                 ) -> Tuple[torch.Tensor, KVCache]:
    """Prefill: run full attention AND return a KV cache padded to cache_len."""
    q, k, v = _qkv(p, cfg, x, positions)
    B, S = x.shape[:2]
    out = sdpa(q, k, v, mask, cfg.n_heads // cfg.n_kv_heads)
    pad = (0, 0, 0, 0, 0, cache_len - S)
    return proj_out(out, p["wo"]), KVCache(
        F.pad(k, pad).to(torch.bfloat16), F.pad(v, pad).to(torch.bfloat16))


def attn_decode(p: Params, cfg: ModelConfig, x, pos, cache: KVCache,
                ) -> Tuple[torch.Tensor, KVCache]:
    """One-token decode. x [B,1,d]; pos int32 [B] absolute position.

    The new k/v row of each sequence is written into ``cache`` in place
    (``index_put_``; the reference's ``.at[bidx, pos].set`` returns a new
    array), and the same cache comes back.
    """
    q, k, v = _qkv(p, cfg, x, pos[:, None])
    B = x.shape[0]
    S_max = cache.k.shape[1]
    dev = x.device
    bidx = torch.arange(B, device=dev)
    pl = pos.long()
    cache.k.index_put_((bidx, pl), k[:, 0].to(cache.k.dtype))
    cache.v.index_put_((bidx, pl), v[:, 0].to(cache.v.dtype))
    t = torch.arange(S_max, device=dev)[None, :]
    valid = t <= pos[:, None]                                  # [B, S_max]
    if cfg.window:
        valid &= t > (pos[:, None] - cfg.window)
    Hk, n_rep = cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads
    hd = cfg.hd
    qg = q.reshape(B, Hk, n_rep, hd)
    # the cache upcast to float32 is exact, as is the reference's astype
    logits = torch.einsum("bkrh,btkh->bkrt", qg.float(),
                          cache.k.float()) * hd ** -0.5
    logits = torch.where(valid[:, None, None], logits, NEG)
    w = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkrt,btkh->bkrh", w.to(x.dtype),
                       cache.v.to(x.dtype)).reshape(B, 1, Hk * n_rep * hd)
    return proj_out(out, p["wo"]), cache


def init_kv_cache(cfg: ModelConfig, B: int, S_max: int, n_layers: int,
                  dtype=torch.bfloat16, device=None) -> KVCache:
    """Zero caches ``[n_layers, B, S_max, n_kv, hd]`` on ``device`` (the
    card when None)."""
    shape = (n_layers, B, S_max, cfg.n_kv_heads, cfg.hd)
    dev = torch.device("cuda" if device is None else device)
    return KVCache(torch.zeros(shape, dtype=dtype, device=dev),
                   torch.zeros(shape, dtype=dtype, device=dev))
