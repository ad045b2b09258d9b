"""Model assembly: init / forward / prefill / decode — the port's
counterpart of ``repro.models.lm``, for the dense decoder-only families.

Parameters are a dict of tensors keyed and shaped as the reference's
pytree: per-segment stacks ``p["seg0"][...]`` of shape ``[n_layers, ...]``.
The reference's ``lax.scan`` over a stack becomes a Python loop over views
of it, and ``jax.jit`` plain eager calls (the serving engine runs them
under ``torch.inference_mode()``). The moe, mla, ssm, hybrid, enc-dec and
vlm families raise ``NotImplementedError`` naming their ROADMAP item.
"""
from __future__ import annotations

from typing import Dict

import torch

from . import attention as A
from . import blocks as BLK
from .config import ModelConfig
from .layers import Params, apply_norm, dense_init, embed_init, norm_params

__all__ = ["init_params", "unembed", "forward", "init_cache", "decode_step",
           "prefill", "layer_params"]


def _dense_family(cfg: ModelConfig) -> None:
    if cfg.family != "dense" or cfg.attention != "gqa":
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family} family is not ported yet (only "
            f"dense GQA decoders are); the moe, mla, ssm, hybrid, enc-dec "
            f"and vlm families come later (ROADMAP queue 1, \"The other "
            f"model families\")")


def layer_params(seg: Params, i: int) -> Params:
    """Layer ``i`` of a stacked segment: the same dict of views ``[i]``."""
    return {k: layer_params(v, i) if isinstance(v, dict) else v[i]
            for k, v in seg.items()}


def _alloc_stacks(layer: Params, n: int) -> Params:
    """Empty stacks ``[n, ...]`` shaped like one layer's params."""
    return {k: _alloc_stacks(v, n) if isinstance(v, dict) else
            torch.empty((n,) + tuple(v.shape), dtype=v.dtype, device=v.device)
            for k, v in layer.items()}


def _copy_layer(stacks: Params, layer: Params, i: int) -> None:
    for k, v in layer.items():
        if isinstance(v, dict):
            _copy_layer(stacks[k], v, i)
        else:
            stacks[k][i].copy_(v)


# ===================================================================== init
def init_params(cfg: ModelConfig, gen: torch.Generator) -> Params:
    """Random parameters drawn from ``gen``, on ``gen``'s device; the same
    keys, shapes and dtypes as the reference's ``init_params`` (the numbers
    differ: another generator)."""
    _dense_family(cfg)
    d, dtype = cfg.d_model, cfg.dtype
    p: Params = {"embed": embed_init(gen, cfg.vocab, d, dtype),
                 "final_norm": norm_params(gen, d, cfg.norm, dtype)}
    if not cfg.tie_embeddings:
        p["lm_head"] = dense_init(gen, d, cfg.vocab, dtype=dtype)
    for i, (kind, n) in enumerate(BLK.block_kinds(cfg)):
        seg = None
        for j in range(n):     # layer by layer: no second full copy
            layer = BLK.block_params(gen, cfg, kind)
            if seg is None:
                seg = _alloc_stacks(layer, n)
            _copy_layer(seg, layer, j)
        p[f"seg{i}"] = seg
    return p


def unembed(p: Params, cfg: ModelConfig, x):
    if cfg.tie_embeddings:
        return x @ p["embed"].T
    return x @ p["lm_head"]


def _embed(p: Params, tokens):
    return p["embed"][tokens.long()]


def _positions(B: int, S: int, device):
    return torch.arange(S, dtype=torch.int32, device=device).expand(B, S)


# ===================================================================== train
def forward(p: Params, cfg: ModelConfig, batch: Dict):
    """-> (logits [B,S,V], aux_loss, hidden [B,S,d])."""
    _dense_family(cfg)
    tokens = batch["tokens"]
    B, S = tokens.shape
    x = _embed(p, tokens)
    positions = _positions(B, S, x.device)
    mask = A.MaskSpec("causal", cfg.window, 0)
    aux = 0.0
    for i, (kind, n) in enumerate(BLK.block_kinds(cfg)):
        for j in range(n):
            x, a = BLK.block_forward(layer_params(p[f"seg{i}"], j), cfg,
                                     kind, x, positions, mask)
            aux = aux + a
    h = apply_norm(x, p["final_norm"], cfg.norm, cfg.norm_eps)
    return unembed(p, cfg, h), aux, h


# ===================================================================== caches
def init_cache(cfg: ModelConfig, B: int, S_max: int, device=None):
    """Zero KV cache ``[n_layers, B, S_max, n_kv, hd]`` (bf16) on ``device``
    (the card when None)."""
    _dense_family(cfg)
    return A.init_kv_cache(cfg, B, S_max, cfg.n_layers, device=device)


# ===================================================================== decode
def decode_step(p: Params, cfg: ModelConfig, tokens, pos, cache):
    """One new token for every sequence. tokens [B] int32, pos [B] int32.
    Returns (logits [B, V], cache). Each layer's new k/v row is written
    into ``cache`` in place, and the same cache comes back."""
    _dense_family(cfg)
    x = _embed(p, tokens)[:, None, :]          # [B,1,d]
    off = 0
    for i, (kind, n) in enumerate(BLK.block_kinds(cfg)):
        for j in range(n):
            c = A.KVCache(cache.k[off + j], cache.v[off + j])
            x, _ = BLK.block_decode(layer_params(p[f"seg{i}"], j), cfg,
                                    kind, x, pos, c)
        off += n
    h = apply_norm(x, p["final_norm"], cfg.norm, cfg.norm_eps)
    return unembed(p, cfg, h)[:, 0], cache


# ===================================================================== prefill
def prefill(p: Params, cfg: ModelConfig, batch: Dict, S_max: int):
    """Process a full prompt; returns (last-token logits [B,V], cache).

    Only the final position's logits are computed (serving practice — the
    full [B,S,V] tensor never materializes). Each layer's cache goes
    straight into its row of the ``[n_layers, ...]`` cache.
    """
    _dense_family(cfg)
    tokens = batch["tokens"]
    B, S = tokens.shape
    x = _embed(p, tokens)
    positions = _positions(B, S, x.device)
    mask = A.MaskSpec("causal", cfg.window, 0)
    cache = init_cache(cfg, B, S_max, device=x.device)
    off = 0
    for i, (kind, n) in enumerate(BLK.block_kinds(cfg)):
        for j in range(n):
            x, c = BLK.block_prefill(layer_params(p[f"seg{i}"], j), cfg,
                                     kind, x, positions, mask, S_max)
            cache.k[off + j].copy_(c.k)
            cache.v[off + j].copy_(c.v)
        off += n
    h = apply_norm(x[:, -1:], p["final_norm"], cfg.norm, cfg.norm_eps)
    return unembed(p, cfg, h)[:, 0], cache
