"""Decoder block wiring — the port's counterpart of ``repro.models.blocks``.

A block = pre-norm mixer + residual (+ pre-norm FFN + residual when the
family has a separate FFN). The port has every kind of the reference: the
mixer GQA attention (``"dense"``, ``"gqa+..."``), MLA (``"mla+..."``) or a
mamba mixer (``"mamba1"``, ``"mamba2"``: no FFN, no aux loss); the FFN a
dense MLP (``"dense"``, ``"...+mlp"``; ``"mla+mlp"`` takes ``d_ff_dense``
when it is set) or MoE (``"...+moe"``, whose aux loss ``block_forward``
returns); zamba2's one shared attention+MLP block with a LoRA on ``wq``
per occurrence (:func:`shared_block_params`, :func:`shared_lora_params`,
:func:`shared_block_forward`, :func:`shared_block_prefill`,
:func:`shared_block_decode`); and the encoder-decoder's blocks, whose
parameters :func:`enc_block_params` and :func:`dec_block_params` make. The
``"hybrid"`` and ``"encdec"`` kinds of :func:`block_kinds` are assembled
by ``lm.py`` itself, as the reference's are, and raise ``ValueError`` here.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import attention as A
from . import mamba as M
from . import mla as MLA
from . import moe as MOE
from .config import ModelConfig
from .layers import (NOSHARD, Params, apply_norm, dense_init, mlp_apply,
                     mlp_params, norm_params)

__all__ = ["block_kinds", "block_params", "enc_block_params",
           "dec_block_params", "block_forward", "block_prefill",
           "block_decode", "shared_block_params", "shared_lora_params",
           "shared_block_forward", "shared_block_prefill",
           "shared_block_decode"]

MAMBA = {"mamba1": (M.mamba1_params, M.mamba1_forward, M.mamba1_decode),
         "mamba2": (M.mamba2_params, M.mamba2_forward, M.mamba2_decode)}


def block_kinds(cfg: ModelConfig) -> Tuple[Tuple[str, int], ...]:
    """Layer-segment plan: ((kind, n_layers), ...) run homogeneously."""
    f = cfg.family
    if f in ("dense", "vlm"):
        return (("dense", cfg.n_layers),)
    if f == "moe":
        mixer = "mla" if cfg.attention == "mla" else "gqa"
        segs = []
        if cfg.n_dense_layers:
            segs.append((f"{mixer}+mlp", cfg.n_dense_layers))
        segs.append((f"{mixer}+moe", cfg.n_layers - cfg.n_dense_layers))
        return tuple(segs)
    if f == "ssm":
        return ((f"mamba{cfg.ssm_version}", cfg.n_layers),)
    if f == "hybrid":
        return (("hybrid", cfg.n_layers),)
    if f == "encdec":
        return (("encdec", cfg.n_layers),)
    raise ValueError(f)


def _assembled_in_lm(kind: str) -> None:
    if kind in ("hybrid", "encdec"):
        raise ValueError(f"block kind {kind!r} is assembled by lm.py (its "
                         f"layers are not one homogeneous stack)")


def _mixer(p, cfg: ModelConfig, kind: str, h, positions, mask):
    if kind.startswith("mla"):
        return MLA.mla_forward(p["attn"], cfg, h, positions, mask)
    return A.attn_forward(p["attn"], cfg, h, positions, mask)


# ------------------------------------------------------------------ params
def block_params(gen, cfg: ModelConfig, kind: str) -> Params:
    _assembled_in_lm(kind)
    d, dtype = cfg.d_model, cfg.dtype
    if kind in MAMBA:
        return {"ln1": norm_params(gen, d, cfg.norm, dtype),
                "mixer": MAMBA[kind][0](gen, cfg)}
    p: Params = {"ln1": norm_params(gen, d, cfg.norm, dtype),
                 "attn": (MLA.mla_params(gen, cfg) if kind.startswith("mla")
                          else A.attn_params(gen, cfg)),
                 "ln2": norm_params(gen, d, cfg.norm, dtype)}
    if kind.endswith("+moe"):
        p["moe"] = MOE.moe_params(gen, cfg)
    else:
        ff = (cfg.d_ff_dense if kind == "mla+mlp" and cfg.d_ff_dense
              else cfg.d_ff)
        p["mlp"] = mlp_params(gen, d, ff, cfg.mlp, dtype)
    return p


def enc_block_params(gen, cfg: ModelConfig) -> Params:
    """One encoder layer: self attention (no mask) and the MLP."""
    d, dtype = cfg.d_model, cfg.dtype
    return {"ln1": norm_params(gen, d, cfg.norm, dtype),
            "attn": A.attn_params(gen, cfg),
            "ln2": norm_params(gen, d, cfg.norm, dtype),
            "mlp": mlp_params(gen, d, cfg.d_ff, cfg.mlp, dtype)}


def dec_block_params(gen, cfg: ModelConfig) -> Params:
    """One decoder layer: causal self attention, cross attention over the
    encoder's output (``lnx`` its norm) and the MLP."""
    d, dtype = cfg.d_model, cfg.dtype
    return {"ln1": norm_params(gen, d, cfg.norm, dtype),
            "attn": A.attn_params(gen, cfg),
            "lnx": norm_params(gen, d, cfg.norm, dtype),
            "cross": A.cross_attn_params(gen, cfg),
            "ln2": norm_params(gen, d, cfg.norm, dtype),
            "mlp": mlp_params(gen, d, cfg.d_ff, cfg.mlp, dtype)}


def _ffn(p, cfg: ModelConfig, h, shard=NOSHARD):
    """The block's FFN on the normed h: (y, MoE aux loss or 0.0)."""
    if "moe" in p:
        return MOE.moe_apply(p["moe"], cfg, h, shard)
    return mlp_apply(p["mlp"], h, cfg.mlp), 0.0


# ------------------------------------------------------------------ forward
def block_forward(p: Params, cfg: ModelConfig, kind: str, x, positions,
                  mask, shard=NOSHARD):
    """Training/prefill-compute path (no cache). Returns (x, aux_loss).
    ``shard`` places the mixer's and the FFN's outputs (``"bsd"``) and
    reaches the MoE dispatch."""
    _assembled_in_lm(kind)
    h = apply_norm(x, p["ln1"], cfg.norm, cfg.norm_eps)
    if kind in MAMBA:
        y, _ = MAMBA[kind][1](p["mixer"], cfg, h)
        return x + shard(y, "bsd"), 0.0
    x = x + shard(_mixer(p, cfg, kind, h, positions, mask), "bsd")
    y, aux = _ffn(p, cfg, apply_norm(x, p["ln2"], cfg.norm, cfg.norm_eps),
                  shard)
    return x + shard(y, "bsd"), aux


def block_prefill(p, cfg: ModelConfig, kind: str, x, positions, mask,
                  cache_len: int, shard=NOSHARD):
    """Like block_forward but also emits this layer's decode cache (a
    ``KVCache``, an ``MLACache`` for the MLA kinds, the final
    ``MambaState`` for the mamba kinds)."""
    _assembled_in_lm(kind)
    h = apply_norm(x, p["ln1"], cfg.norm, cfg.norm_eps)
    if kind in MAMBA:
        y, cache = MAMBA[kind][1](p["mixer"], cfg, h)
        return x + shard(y, "bsd"), cache
    if kind.startswith("mla"):
        y, cache = MLA.mla_prefill(p["attn"], cfg, h, positions, mask,
                                   cache_len)
    else:
        y, cache = A.attn_prefill(p["attn"], cfg, h, positions, mask,
                                  cache_len)
    x = x + shard(y, "bsd")
    y, _ = _ffn(p, cfg, apply_norm(x, p["ln2"], cfg.norm, cfg.norm_eps),
                shard)
    return x + shard(y, "bsd"), cache


def block_decode(p, cfg: ModelConfig, kind: str, x, pos, cache,
                 shard=NOSHARD):
    """One-token step. ``cache`` is this layer's cache slice, updated in
    place (a mamba layer's new conv window and ssm state are copied into
    it); returns (x, cache). ``shard`` reaches the MoE dispatch only, as
    in the reference."""
    _assembled_in_lm(kind)
    h = apply_norm(x, p["ln1"], cfg.norm, cfg.norm_eps)
    if kind in MAMBA:
        y, new = MAMBA[kind][2](p["mixer"], cfg, h, cache)
        for t, n in zip(cache, new):
            t.copy_(n)
        return x + y, cache
    if kind.startswith("mla"):
        y, cache = MLA.mla_decode(p["attn"], cfg, h, pos, cache)
    else:
        y, cache = A.attn_decode(p["attn"], cfg, h, pos, cache)
    x = x + y
    y, _ = _ffn(p, cfg, apply_norm(x, p["ln2"], cfg.norm, cfg.norm_eps),
                shard)
    return x + y, cache


# ------------------------------------------------------------- zamba2 shared
def shared_block_params(gen, cfg: ModelConfig) -> Params:
    """The single shared attention+MLP block (zamba2)."""
    return block_params(gen, cfg, "dense")


def shared_lora_params(gen, cfg: ModelConfig) -> Params:
    """One occurrence's LoRA on the shared block's wq: ``qa`` [d, r] and
    ``qb`` [r, H*hd], zero as the reference starts it."""
    r = cfg.shared_lora_rank
    d, H, hd = cfg.d_model, cfg.n_heads, cfg.hd
    return {"qa": dense_init(gen, d, r, dtype=cfg.dtype),
            "qb": torch.zeros((r, H * hd), dtype=cfg.dtype, device=gen.device)}


def _lora_out(p, lora: Optional[Params], h, y):
    """The attention output ``y`` plus the occurrence's LoRA correction on
    the normed input ``h``, joined through the output projection."""
    if lora is None:
        return y
    dq = (h @ lora["qa"]) @ lora["qb"]
    return y + A.proj_out(dq, p["attn"]["wo"])


def _shared_mlp(p, cfg: ModelConfig, x, shard=NOSHARD):
    return x + shard(mlp_apply(p["mlp"], apply_norm(x, p["ln2"], cfg.norm,
                                                    cfg.norm_eps), cfg.mlp),
                     "bsd")


def shared_block_forward(p: Params, lora: Optional[Params], cfg: ModelConfig,
                         x, positions, mask, shard=NOSHARD):
    h = apply_norm(x, p["ln1"], cfg.norm, cfg.norm_eps)
    y = A.attn_forward(p["attn"], cfg, h, positions, mask)
    return _shared_mlp(p, cfg, x + shard(_lora_out(p, lora, h, y), "bsd"),
                       shard)


def shared_block_prefill(p: Params, lora: Optional[Params], cfg: ModelConfig,
                         x, positions, mask, cache_len: int, shard=NOSHARD):
    """:func:`shared_block_forward` that also returns the occurrence's
    ``KVCache`` padded to ``cache_len`` (the reference writes it out inside
    ``lm._hybrid_prefill``)."""
    h = apply_norm(x, p["ln1"], cfg.norm, cfg.norm_eps)
    y, cache = A.attn_prefill(p["attn"], cfg, h, positions, mask, cache_len)
    return _shared_mlp(p, cfg, x + shard(_lora_out(p, lora, h, y), "bsd"),
                       shard), cache


def shared_block_decode(p, lora, cfg: ModelConfig, x, pos, cache):
    """One-token step of an occurrence; its k/v row is written into
    ``cache`` in place."""
    h = apply_norm(x, p["ln1"], cfg.norm, cfg.norm_eps)
    y, cache = A.attn_decode(p["attn"], cfg, h, pos, cache)
    return _shared_mlp(p, cfg, x + _lora_out(p, lora, h, y)), cache
