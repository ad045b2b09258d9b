"""Plain torch version of the flash-attention forward, the counterpart of
``repro.kernels.flash_attention.ref``: one materialized softmax over the
whole ``[S, T]`` logits. The CPU path of ``ops`` runs it, and the kernel
(``csrc/flash_attention.cu``) is held against it on the card."""
from __future__ import annotations

import torch

__all__ = ["NEG", "key_mask", "flash_attention_ref", "flash_sdpa_ref",
           "to_flat", "from_flat"]

NEG = -1e30


def key_mask(S: int, T: int, causal: bool, window: int, prefix_len: int,
             device) -> torch.Tensor:
    """[S, T] bool: which keys each query row may see."""
    qi = torch.arange(S, device=device)[:, None]
    kj = torch.arange(T, device=device)[None, :]
    if not causal:
        return torch.ones((S, T), dtype=torch.bool, device=device)
    m = kj <= qi
    if window:
        m &= kj > qi - window
    if prefix_len:
        m |= kj < prefix_len
    return m


def flash_attention_ref(q, k, v, *, scale: float, kv_len: int,
                        causal: bool = True, window: int = 0,
                        prefix_len: int = 0):
    """q [BH,S,hd], k/v [BH,T,hv] (kv already head-repeated) -> [BH,S,hv].

    Logits in float32 (exact products of the inputs, float32 sums), the
    softmax in float32, its weights in v's dtype for the product with v.
    Keys at or past ``kv_len`` are dropped; a row with no valid key is 0
    (a bare softmax would spread uniform weights over it).
    """
    S = q.shape[1]
    kk, vv = k[:, :kv_len], v[:, :kv_len]
    m = key_mask(S, kv_len, causal, window, prefix_len, q.device)
    s = torch.einsum("bsh,bth->bst", q.float(), kk.float()) * scale
    s = torch.where(m[None], s, NEG)
    w = torch.softmax(s, dim=-1)
    out = torch.einsum("bst,bth->bsh", w.to(v.dtype), vv)
    return torch.where(m.any(-1)[None, :, None], out, 0.0).to(v.dtype)


def to_flat(q, k, v, n_rep: int):
    """q [B,S,H,hd], k/v [B,T,Hk,hv] -> q [BH,S,hd], k/v [BH,T,hv]: heads
    flattened in the (kv head, rep) order and kv repeated, as the
    reference's wrapper does."""
    B, S, H, hd = q.shape
    T, Hk = k.shape[1], k.shape[2]
    hv = v.shape[-1]
    qf = q.reshape(B, S, Hk, n_rep, hd).permute(0, 2, 3, 1, 4) \
          .reshape(B * H, S, hd)
    kf = k.permute(0, 2, 1, 3)[:, :, None].expand(B, Hk, n_rep, T, hd) \
          .reshape(B * H, T, hd)
    vf = v.permute(0, 2, 1, 3)[:, :, None].expand(B, Hk, n_rep, T, hv) \
          .reshape(B * H, T, hv)
    return qf, kf, vf


def from_flat(out, B: int, Hk: int, n_rep: int):
    """[BH,S,hv] in the order of :func:`to_flat` -> [B,S,H*hv]."""
    S, hv = out.shape[1], out.shape[2]
    return out.reshape(B, Hk, n_rep, S, hv).permute(0, 3, 1, 2, 4) \
              .reshape(B, S, Hk * n_rep * hv)


def flash_sdpa_ref(q, k, v, mask, n_rep: int, scale: float):
    """:func:`flash_attention_ref` in the layout of ``ops.flash_sdpa``:
    q [B,S,H,hd], k/v [B,T,Hk,hv] -> [B,S,H*hv]."""
    out = flash_attention_ref(*to_flat(q, k, v, n_rep), scale=scale,
                              kv_len=k.shape[1],
                              causal=mask.kind == "causal",
                              window=mask.window, prefix_len=mask.prefix_len)
    return from_flat(out, q.shape[0], k.shape[2], n_rep)
