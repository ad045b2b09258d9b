"""Model assembly: init / forward / prefill / decode — the port's
counterpart of ``repro.models.lm``, for the decoder-only dense and MoE
families (GQA or MLA attention; DeepSeek's MTP head).

Parameters are a dict of tensors keyed and shaped as the reference's
pytree: per-segment stacks ``p["seg0"][...]`` of shape ``[n_layers, ...]``.
The reference's ``lax.scan`` over a stack becomes a Python loop over its
layers, and ``jax.jit`` plain eager calls. :func:`forward` is the training
forward: it runs under autograd (``train.losses.loss_fn`` differentiates
it) and takes the reference's ``cfg.remat`` per block — ``"none"`` plain
autograd, ``"full"`` ``torch.utils.checkpoint`` of the block,
``"dots"`` a selective checkpoint that keeps the outputs of the
non-batched matrix products (the reference's
``checkpoint_dots_with_no_batch_dims``) and recomputes the rest.
:func:`prefill` and :func:`decode_step` are the serving engine's eager
inference calls (run under ``torch.inference_mode()``); their cache is a
``KVCache`` of ``[n_layers, ...]`` stacks, or an ``MLACache`` for MLA, and
each layer writes its row in place. The ssm, hybrid, enc-dec and vlm
families raise ``NotImplementedError`` naming their ROADMAP item.
"""
from __future__ import annotations

import functools
from typing import Dict

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from . import attention as A
from . import blocks as BLK
from . import mla as MLA
from .config import ModelConfig
from .layers import Params, apply_norm, dense_init, embed_init, norm_params

__all__ = ["init_params", "unembed", "forward", "mtp_logits", "init_cache",
           "decode_step", "prefill", "layer_params"]


def _ported_family(cfg: ModelConfig) -> None:
    if cfg.family not in ("dense", "moe"):
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family} family is not ported yet (the "
            f"dense and moe decoders are); the ssm, hybrid, enc-dec and vlm "
            f"families come later (ROADMAP queue 1, \"The other model "
            f"families\")")


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
    _ported_family(cfg)
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
    if cfg.mtp:
        d = cfg.d_model
        p["mtp"] = {
            "proj": dense_init(gen, 2 * d, d, dtype=dtype),
            "norm_h": norm_params(gen, d, cfg.norm, dtype),
            "norm_e": norm_params(gen, d, cfg.norm, dtype),
            "block": BLK.block_params(gen, cfg, BLK.block_kinds(cfg)[-1][0]),
        }
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
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    """Selective-checkpoint policy of ``remat="dots"``: keep what the
    non-batched matrix products return, recompute everything else."""
    return (CheckpointPolicy.MUST_SAVE if op in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _maybe_remat(fn, cfg: ModelConfig):
    if cfg.remat == "none":
        return fn
    if cfg.remat == "dots":
        ctx = functools.partial(create_selective_checkpoint_contexts,
                                _save_dots)
        return lambda *a: checkpoint(fn, *a, use_reentrant=False,
                                     context_fn=ctx)
    if cfg.remat == "full":
        return lambda *a: checkpoint(fn, *a, use_reentrant=False)
    raise ValueError(f"remat {cfg.remat!r}: none | full | dots")


def _unbind_layers(seg: Params, n: int):
    """The ``n`` layers of a stacked segment as dicts of views. Their
    backward (``torch.unbind``'s) stacks the layers' gradients once, where
    indexing each layer would scatter its gradient into a zero stack."""
    parts = {k: _unbind_layers(v, n) if isinstance(v, dict) else v.unbind(0)
             for k, v in seg.items()}
    return [{k: parts[k][j] for k in parts} for j in range(n)]


def forward(p: Params, cfg: ModelConfig, batch: Dict):
    """-> (logits [B,S,V], aux_loss (float32 scalar, the sum over the MoE
    layers), hidden [B,S,d])."""
    _ported_family(cfg)
    tokens = batch["tokens"]
    B, S = tokens.shape
    x = _embed(p, tokens)
    positions = _positions(B, S, x.device)
    mask = A.MaskSpec("causal", cfg.window, 0)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i, (kind, n) in enumerate(BLK.block_kinds(cfg)):
        for pl in _unbind_layers(p[f"seg{i}"], n):
            def body(h, pl=pl, kind=kind):
                return BLK.block_forward(pl, cfg, kind, h, positions, mask)
            x, a = _maybe_remat(body, cfg)(x)
            aux = aux + a
    h = apply_norm(x, p["final_norm"], cfg.norm, cfg.norm_eps)
    return unembed(p, cfg, h), aux, h


def mtp_logits(p: Params, cfg: ModelConfig, hidden, tokens):
    """DeepSeek's multi-token-prediction head: predict token t+2 from the
    trunk's hidden at t combined with the embedding of token t+1."""
    mtp = p["mtp"]
    B, S = tokens.shape
    nxt = torch.cat([tokens[:, 1:], tokens[:, -1:]], dim=1)
    he = apply_norm(_embed(p, nxt), mtp["norm_e"], cfg.norm, cfg.norm_eps)
    hh = apply_norm(hidden, mtp["norm_h"], cfg.norm, cfg.norm_eps)
    x = torch.cat([hh, he], dim=-1) @ mtp["proj"]
    x, _ = BLK.block_forward(mtp["block"], cfg, BLK.block_kinds(cfg)[-1][0],
                             x, _positions(B, S, x.device),
                             A.MaskSpec("causal"))
    x = apply_norm(x, p["final_norm"], cfg.norm, cfg.norm_eps)
    return unembed(p, cfg, x)


# ===================================================================== caches
def init_cache(cfg: ModelConfig, B: int, S_max: int, device=None):
    """Zero cache on ``device`` (the card when None), bf16: a ``KVCache``
    ``[n_layers, B, S_max, n_kv, hd]``, or for MLA an ``MLACache`` of
    ``[n_layers, B, S_max, kv_lora]`` and ``[n_layers, B, S_max, rope]``."""
    _ported_family(cfg)
    if cfg.attention == "mla":
        return MLA.init_mla_cache(cfg, B, S_max, cfg.n_layers, device=device)
    return A.init_kv_cache(cfg, B, S_max, cfg.n_layers, device=device)


def _layer_cache(cache, i: int):
    """Row ``i`` of a stacked cache (``KVCache`` or ``MLACache``): views."""
    return type(cache)(*(t[i] for t in cache))


# ===================================================================== decode
def decode_step(p: Params, cfg: ModelConfig, tokens, pos, cache):
    """One new token for every sequence. tokens [B] int32, pos [B] int32.
    Returns (logits [B, V], cache). Each layer's new k/v row is written
    into ``cache`` in place, and the same cache comes back."""
    _ported_family(cfg)
    x = _embed(p, tokens)[:, None, :]          # [B,1,d]
    off = 0
    for i, (kind, n) in enumerate(BLK.block_kinds(cfg)):
        for j in range(n):
            x, _ = BLK.block_decode(layer_params(p[f"seg{i}"], j), cfg,
                                    kind, x, pos, _layer_cache(cache, off + j))
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
    _ported_family(cfg)
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
            for t, ct in zip(_layer_cache(cache, off + j), c):
                t.copy_(ct)
        off += n
    h = apply_norm(x[:, -1:], p["final_norm"], cfg.norm, cfg.norm_eps)
    return unembed(p, cfg, h)[:, 0], cache
