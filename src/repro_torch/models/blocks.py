"""Decoder block wiring — the port's counterpart of ``repro.models.blocks``.

A block = pre-norm mixer + residual + pre-norm FFN + residual. This slice
ports the dense kinds (``"dense"`` and ``"gqa+mlp"``: GQA attention and a
dense MLP); the plan :func:`block_kinds` is whole, and every other kind
raises ``NotImplementedError`` naming its ROADMAP item.
"""
from __future__ import annotations

from typing import Tuple

from . import attention as A
from .config import ModelConfig
from .layers import Params, apply_norm, mlp_apply, mlp_params, norm_params

__all__ = ["DENSE_KINDS", "block_kinds", "block_params", "block_forward",
           "block_prefill", "block_decode"]

DENSE_KINDS = ("dense", "gqa+mlp")


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


def _dense_only(kind: str) -> None:
    if kind not in DENSE_KINDS:
        raise NotImplementedError(
            f"block kind {kind!r} is not ported yet: the MoE, MLA, mamba, "
            f"hybrid and enc-dec blocks come with the other model families "
            f"(ROADMAP queue 1, \"The other model families\")")


# ------------------------------------------------------------------ params
def block_params(gen, cfg: ModelConfig, kind: str) -> Params:
    _dense_only(kind)
    d, dtype = cfg.d_model, cfg.dtype
    return {"ln1": norm_params(gen, d, cfg.norm, dtype),
            "attn": A.attn_params(gen, cfg),
            "ln2": norm_params(gen, d, cfg.norm, dtype),
            "mlp": mlp_params(gen, d, cfg.d_ff, cfg.mlp, dtype)}


# ------------------------------------------------------------------ forward
def block_forward(p: Params, cfg: ModelConfig, kind: str, x, positions,
                  mask):
    """Training/prefill-compute path (no cache). Returns (x, aux_loss)."""
    _dense_only(kind)
    h = apply_norm(x, p["ln1"], cfg.norm, cfg.norm_eps)
    x = x + A.attn_forward(p["attn"], cfg, h, positions, mask)
    h = apply_norm(x, p["ln2"], cfg.norm, cfg.norm_eps)
    return x + mlp_apply(p["mlp"], h, cfg.mlp), 0.0


def block_prefill(p, cfg: ModelConfig, kind: str, x, positions, mask,
                  cache_len: int):
    """Like block_forward but also emits this layer's decode cache."""
    _dense_only(kind)
    h = apply_norm(x, p["ln1"], cfg.norm, cfg.norm_eps)
    y, cache = A.attn_prefill(p["attn"], cfg, h, positions, mask, cache_len)
    x = x + y
    h = apply_norm(x, p["ln2"], cfg.norm, cfg.norm_eps)
    return x + mlp_apply(p["mlp"], h, cfg.mlp), cache


def block_decode(p, cfg: ModelConfig, kind: str, x, pos, cache):
    """One-token step. ``cache`` is this layer's cache slice, updated in
    place; returns (x, cache)."""
    _dense_only(kind)
    h = apply_norm(x, p["ln1"], cfg.norm, cfg.norm_eps)
    y, cache = A.attn_decode(p["attn"], cfg, h, pos, cache)
    x = x + y
    h = apply_norm(x, p["ln2"], cfg.norm, cfg.norm_eps)
    return x + mlp_apply(p["mlp"], h, cfg.mlp), cache
