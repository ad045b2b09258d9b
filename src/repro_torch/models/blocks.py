"""Decoder block wiring — the port's counterpart of ``repro.models.blocks``.

A block = pre-norm mixer + residual + pre-norm FFN + residual. The port
has the decoder kinds of the dense, vlm and MoE families: the mixer GQA
attention (``"dense"``, ``"gqa+..."``) or MLA (``"mla+..."``), the FFN a
dense MLP (``"dense"``, ``"...+mlp"``; ``"mla+mlp"`` takes ``d_ff_dense``
when it is set) or MoE (``"...+moe"``, whose aux loss ``block_forward``
returns); and the encoder-decoder's blocks, whose parameters
:func:`enc_block_params` and :func:`dec_block_params` make and whose
layers ``lm.py`` runs itself, as the reference's does (self attention, then
for the decoder cross attention, then the MLP). The plan
:func:`block_kinds` is whole; the mamba and hybrid kinds raise
``NotImplementedError`` naming their ROADMAP item.
"""
from __future__ import annotations

from typing import Tuple

from . import attention as A
from . import mla as MLA
from . import moe as MOE
from .config import ModelConfig
from .layers import Params, apply_norm, mlp_apply, mlp_params, norm_params

__all__ = ["PORTED_KINDS", "block_kinds", "block_params", "enc_block_params",
           "dec_block_params", "block_forward", "block_prefill",
           "block_decode"]

PORTED_KINDS = ("dense", "gqa+mlp", "gqa+moe", "mla+mlp", "mla+moe")


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


def _ported(kind: str) -> None:
    if kind not in PORTED_KINDS:
        raise NotImplementedError(
            f"block kind {kind!r} is not ported yet: the mamba and hybrid "
            f"blocks come with their families (ROADMAP queue 1, \"Modules "
            f"to port\"); the enc-dec layers run in lm.py")


def _mixer(p, cfg: ModelConfig, kind: str, h, positions, mask):
    if kind.startswith("mla"):
        return MLA.mla_forward(p["attn"], cfg, h, positions, mask)
    return A.attn_forward(p["attn"], cfg, h, positions, mask)


# ------------------------------------------------------------------ params
def block_params(gen, cfg: ModelConfig, kind: str) -> Params:
    _ported(kind)
    d, dtype = cfg.d_model, cfg.dtype
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


def _ffn(p, cfg: ModelConfig, h):
    """The block's FFN on the normed h: (y, MoE aux loss or 0.0)."""
    if "moe" in p:
        return MOE.moe_apply(p["moe"], cfg, h)
    return mlp_apply(p["mlp"], h, cfg.mlp), 0.0


# ------------------------------------------------------------------ forward
def block_forward(p: Params, cfg: ModelConfig, kind: str, x, positions,
                  mask):
    """Training/prefill-compute path (no cache). Returns (x, aux_loss)."""
    _ported(kind)
    h = apply_norm(x, p["ln1"], cfg.norm, cfg.norm_eps)
    x = x + _mixer(p, cfg, kind, h, positions, mask)
    y, aux = _ffn(p, cfg, apply_norm(x, p["ln2"], cfg.norm, cfg.norm_eps))
    return x + y, aux


def block_prefill(p, cfg: ModelConfig, kind: str, x, positions, mask,
                  cache_len: int):
    """Like block_forward but also emits this layer's decode cache (a
    ``KVCache``, or an ``MLACache`` for the MLA kinds)."""
    _ported(kind)
    h = apply_norm(x, p["ln1"], cfg.norm, cfg.norm_eps)
    if kind.startswith("mla"):
        y, cache = MLA.mla_prefill(p["attn"], cfg, h, positions, mask,
                                   cache_len)
    else:
        y, cache = A.attn_prefill(p["attn"], cfg, h, positions, mask,
                                  cache_len)
    x = x + y
    y, _ = _ffn(p, cfg, apply_norm(x, p["ln2"], cfg.norm, cfg.norm_eps))
    return x + y, cache


def block_decode(p, cfg: ModelConfig, kind: str, x, pos, cache):
    """One-token step. ``cache`` is this layer's cache slice, updated in
    place; returns (x, cache)."""
    _ported(kind)
    h = apply_norm(x, p["ln1"], cfg.norm, cfg.norm_eps)
    if kind.startswith("mla"):
        y, cache = MLA.mla_decode(p["attn"], cfg, h, pos, cache)
    else:
        y, cache = A.attn_decode(p["attn"], cfg, h, pos, cache)
    x = x + y
    y, _ = _ffn(p, cfg, apply_norm(x, p["ln2"], cfg.norm, cfg.norm_eps))
    return x + y, cache
