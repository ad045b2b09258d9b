"""Multi-head Latent Attention (DeepSeek-V3) with absorbed-latent decode —
the port's counterpart of ``repro.models.mla``.

Train and prefill: queries through the low-rank q projection, keys and
values up-projected from the compressed latent ``c_kv``, one rotary key
head shared by every head. The rotary slice is concatenated onto every
head's nope slice, so attention is ordinary ``sdpa`` with q/k head dim
``nope + rope`` and v head dim ``v_head_dim`` (192 and 128 at full width:
on the card, the flash-attention kernel K5 above ``FLASH_THRESH``).

Decode: the cache holds only ``(c_kv, k_rope)`` a position; W_uk is folded
into the query and W_uv into the output, so attention runs in the latent
space (einsums over the cache; no kernel). Each step writes its position
of the cache in place (the reference's ``.at[...].set`` returns a new
array).
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from ..parallel import dtensor as DT
from ..parallel.dtensor import heads_in, write_rows
from .config import ModelConfig
from .layers import (Params, _trunc_normal, dense_init, rms_norm, rope_apply,
                     rope_freqs)

__all__ = ["MLACache", "mla_params", "mla_qkv", "mla_forward",
           "mla_prefill", "mla_decode", "init_mla_cache"]


class MLACache(NamedTuple):
    ckv: torch.Tensor     # [B, S_max, kv_lora]
    krope: torch.Tensor   # [B, S_max, rope_dim]


def mla_params(gen, cfg: ModelConfig, dtype=None) -> Params:
    dtype = dtype or cfg.dtype
    d, H = cfg.d_model, cfg.n_heads
    qr, kr = cfg.q_lora_rank, cfg.kv_lora_rank
    nope, rope, vh = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    dev = gen.device
    return {
        "wdq": dense_init(gen, d, qr, dtype=dtype),
        "qnorm": {"w": torch.zeros((qr,), dtype=dtype, device=dev)},
        "wuq": dense_init(gen, qr, H, nope + rope, dtype=dtype),
        "wdkv": dense_init(gen, d, kr, dtype=dtype),
        "kvnorm": {"w": torch.zeros((kr,), dtype=dtype, device=dev)},
        "wkr": dense_init(gen, d, rope, dtype=dtype),
        "wukv": dense_init(gen, kr, H, nope + vh, dtype=dtype),
        "wo": _trunc_normal(gen, (H, vh, d), (H * vh) ** -0.5, dtype),
    }


def _up(x, w):
    """x [..., r] @ w [r, n, h] -> [..., n, h] (the einsum ``bsr,rnh``)."""
    return heads_in(x, w)


def _queries(p, cfg: ModelConfig, x, positions):
    nope, rope = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    q = rms_norm(x @ p["wdq"], p["qnorm"]["w"], cfg.norm_eps)
    q = _up(q, p["wuq"])
    sin, cos = rope_freqs(positions, rope, cfg.rope_theta)
    return q[..., :nope], rope_apply(q[..., nope:], sin, cos)


def _latents(p, cfg: ModelConfig, x, positions):
    rope = cfg.qk_rope_head_dim
    ckv = rms_norm(x @ p["wdkv"], p["kvnorm"]["w"], cfg.norm_eps)
    kr = (x @ p["wkr"])[:, :, None, :]                   # [B,S,1,rope]
    sin, cos = rope_freqs(positions, rope, cfg.rope_theta)
    return ckv, rope_apply(kr, sin, cos)[:, :, 0, :]


def mla_qkv(p, cfg: ModelConfig, x, positions, latents=None):
    """What MLA hands ``sdpa``: q [B,S,H,nope+rope], k [B,S,H,nope+rope]
    (the shared rotary key on every head) and v [B,S,H,v_head_dim] (a view
    into the up-projected latents), and the scale (nope + rope)^-0.5.
    ``latents`` are :func:`_latents`' (computed when None)."""
    nope, rope = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    ckv, kr = latents if latents is not None else _latents(p, cfg, x,
                                                           positions)
    q_nope, q_rope = _queries(p, cfg, x, positions)
    kv = _up(ckv, p["wukv"])
    k_nope, v = kv[..., :nope], kv[..., nope:]
    q_cat = torch.cat([q_nope, q_rope], dim=-1)
    k_cat = torch.cat([k_nope, kr[:, :, None, :].expand(
        *k_nope.shape[:3], rope)], dim=-1)
    return q_cat, k_cat, v, (nope + rope) ** -0.5


def _attend(p, cfg: ModelConfig, x, positions, mask, latents=None):
    from .attention import proj_out, sdpa
    q, k, v, scale = mla_qkv(p, cfg, x, positions, latents)
    return proj_out(sdpa(q, k, v, mask, 1, scale=scale), p["wo"])


def mla_forward(p: Params, cfg: ModelConfig, x, positions, mask):
    """Full-sequence MLA (training and prefill compute); ``mask`` is a
    ``MaskSpec``."""
    return _attend(p, cfg, x, positions, mask)


def mla_prefill(p, cfg: ModelConfig, x, positions, mask, cache_len: int,
                ) -> Tuple[torch.Tensor, MLACache]:
    """:func:`mla_forward` and the layer's latent cache, padded to
    ``cache_len`` and rounded to bf16."""
    ckv, kr = _latents(p, cfg, x, positions)
    y = _attend(p, cfg, x, positions, mask, (ckv, kr))
    pad = (0, 0, 0, cache_len - x.shape[1])
    return y, MLACache(DT.pad(ckv, pad).to(torch.bfloat16),
                       DT.pad(kr, pad).to(torch.bfloat16))


def mla_decode(p: Params, cfg: ModelConfig, x, pos, cache: MLACache,
               ) -> Tuple[torch.Tensor, MLACache]:
    """Absorbed-latent one-token decode. x [B,1,d], pos int32 [B]; the new
    latent row of each sequence is written into ``cache`` in place, and the
    same cache comes back."""
    nope, rope = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    q_nope, q_rope = _queries(p, cfg, x, pos[:, None])   # [B,1,H,.]
    ckv_t, kr_t = _latents(p, cfg, x, pos[:, None])      # [B,1,kr], [B,1,rope]
    write_rows(cache.ckv, pos, ckv_t[:, 0].to(cache.ckv.dtype))
    write_rows(cache.krope, pos, kr_t[:, 0].to(cache.krope.dtype))
    wuk = p["wukv"][..., :nope]                          # [kr, H, nope]
    wuv = p["wukv"][..., nope:]                          # [kr, H, vh]
    q_lat = torch.einsum("bnh,rnh->bnr", q_nope[:, 0], wuk)   # absorb W_uk
    # float32 logits of exact products, as preferred_element_type=float32
    logits = (torch.einsum("bnr,btr->bnt", q_lat.float(),
                           cache.ckv.to(x.dtype).float())
              + torch.einsum("bnh,bth->bnt", q_rope[:, 0].float(),
                             cache.krope.to(x.dtype).float())) \
        * (nope + rope) ** -0.5
    S_max = cache.ckv.shape[1]
    valid = torch.arange(S_max, device=x.device)[None, None, :] \
        <= pos[:, None, None]
    w = torch.softmax(torch.where(valid, logits, -1e30), dim=-1)
    lat = torch.einsum("bnt,btr->bnr", w.to(x.dtype), cache.ckv.to(x.dtype))
    out = torch.einsum("bnr,rnh->bnh", lat, wuv)         # absorb W_uv
    y = torch.einsum("bnh,nhd->bd", out, p["wo"])[:, None]
    return y, cache


def init_mla_cache(cfg: ModelConfig, B: int, S_max: int, n_layers: int,
                   device=None) -> MLACache:
    """Zero latent caches ``[n_layers, B, S_max, kv_lora]`` and
    ``[n_layers, B, S_max, rope]`` (bf16) on ``device`` (the card when
    None)."""
    dev = torch.device("cuda" if device is None else device)
    return MLACache(
        torch.zeros((n_layers, B, S_max, cfg.kv_lora_rank),
                    dtype=torch.bfloat16, device=dev),
        torch.zeros((n_layers, B, S_max, cfg.qk_rope_head_dim),
                    dtype=torch.bfloat16, device=dev))
