"""Model assembly: init / forward / prefill / decode — the port's
counterpart of ``repro.models.lm``, for the decoder-only dense and MoE
families (GQA or MLA attention; DeepSeek's MTP head), the vlm family
(PaliGemma: image patches projected and prepended to the text under a
prefix-LM mask) and the enc-dec family (whisper: an encoder over stub
frame embeddings with learned positions, :func:`encode`, and a decoder
with cross attention), the ssm family (falcon-mamba: a stack of mamba1
layers) and the hybrid family (zamba2: groups of mamba2 layers, each group
followed by the one shared attention+MLP block with its occurrence's LoRA,
then a tail of mamba2 layers).

Parameters are a dict of tensors keyed and shaped as the reference's
pytree: per-segment stacks ``p["seg0"][...]`` of shape ``[n_layers, ...]``
(hybrid: ``mamba_grp`` ``[n_groups, period - 1, ...]``, ``mamba_tail``,
``shared``, ``lora`` ``[n_groups, ...]``).
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
``KVCache`` of ``[n_layers, ...]`` stacks, an ``MLACache`` for MLA, or for
enc-dec the reference's dict ``{"self": KVCache, "cross_k", "cross_v"}``
(the cross attention's bf16 k and v of every layer over the encoder's
frames), for ssm a ``MambaState`` of ``[n_layers, ...]`` stacks, for
hybrid the reference's dict ``{"grp": MambaState [n_groups, period - 1,
...], "attn": KVCache [n_groups, ...], "tail": MambaState}``; each layer
writes its rows in place.
"""
from __future__ import annotations

import functools
from typing import Dict

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from . import attention as A
from . import blocks as BLK
from . import mamba as M
from . import mla as MLA
from ..parallel.dtensor import embed_lookup, fsdp_gather
from ..parallel.sharding import placed_cache
from .config import ModelConfig
from .layers import (NOSHARD, Params, apply_norm, dense_init, embed_init,
                     mlp_apply, norm_params)

__all__ = ["init_params", "param_shapes", "unembed", "forward", "encode",
           "mtp_logits", "init_cache", "cache_shapes", "decode_step",
           "prefill", "layer_params", "MetaGenerator", "NOSHARD"]


class MetaGenerator(torch.Generator):
    """A generator whose ``device`` is ``meta``: :func:`init_params` then
    allocates nothing and draws nothing."""

    @property
    def device(self):
        return torch.device("meta")


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


def _stack_layers(make, n: int) -> Params:
    """``n`` layers from ``make()``, stacked ``[n, ...]``, layer by layer:
    no second full copy."""
    seg = None
    for j in range(n):
        layer = make()
        if seg is None:
            seg = _alloc_stacks(layer, n)
        _copy_layer(seg, layer, j)
    return seg


def _split_lead(tree, n: int, m: int):
    """Every leaf ``[n * m, ...]`` viewed as ``[n, m, ...]``."""
    return {k: _split_lead(v, n, m) if isinstance(v, dict)
            else v.view((n, m) + tuple(v.shape[1:])) for k, v in tree.items()}


def _hybrid_plan(cfg: ModelConfig):
    """zamba2's layout: (groups = shared-block occurrences, mamba layers a
    group, mamba layers in the tail)."""
    n_sh = cfg.hybrid_pattern().count("a")
    return n_sh, cfg.shared_attn_period - 1, \
        cfg.n_layers - n_sh * cfg.shared_attn_period


def _hybrid_params(p: Params, cfg: ModelConfig, gen) -> Params:
    n_grp, grp_m, n_tail = _hybrid_plan(cfg)
    mamba = lambda: BLK.block_params(gen, cfg, "mamba2")
    p["mamba_grp"] = _split_lead(_stack_layers(mamba, n_grp * grp_m),
                                 n_grp, grp_m)
    if n_tail:
        p["mamba_tail"] = _stack_layers(mamba, n_tail)
    p["shared"] = BLK.shared_block_params(gen, cfg)
    if cfg.shared_lora_rank:
        p["lora"] = _stack_layers(lambda: BLK.shared_lora_params(gen, cfg),
                                  n_grp)
    return p


# ===================================================================== init
def init_params(cfg: ModelConfig, gen: torch.Generator) -> Params:
    """Random parameters drawn from ``gen``, on ``gen``'s device; the same
    keys, shapes and dtypes as the reference's ``init_params`` (the numbers
    differ: another generator)."""
    d, dtype = cfg.d_model, cfg.dtype
    p: Params = {"embed": embed_init(gen, cfg.vocab, d, dtype),
                 "final_norm": norm_params(gen, d, cfg.norm, dtype)}
    if not cfg.tie_embeddings:
        p["lm_head"] = dense_init(gen, d, cfg.vocab, dtype=dtype)
    if cfg.family == "hybrid":
        return _hybrid_params(p, cfg, gen)
    if cfg.family == "encdec":
        p["enc"] = {
            "proj": dense_init(gen, cfg.frontend_dim, d, dtype=dtype),
            "pos": dense_init(gen, cfg.enc_seq, d, dtype=dtype) * 0.02,
            "blocks": _stack_layers(lambda: BLK.enc_block_params(gen, cfg),
                                    cfg.n_enc_layers),
            "ln_f": norm_params(gen, d, cfg.norm, dtype)}
        p["dec_pos"] = dense_init(gen, cfg.enc_seq, d, dtype=dtype) * 0.02
        p["dec_blocks"] = _stack_layers(
            lambda: BLK.dec_block_params(gen, cfg), cfg.n_layers)
        return p
    if cfg.family == "vlm":
        p["proj"] = dense_init(gen, cfg.frontend_dim, d, dtype=dtype)
    for i, (kind, n) in enumerate(BLK.block_kinds(cfg)):
        p[f"seg{i}"] = _stack_layers(
            lambda kind=kind: BLK.block_params(gen, cfg, kind), n)
    if cfg.mtp:
        d = cfg.d_model
        p["mtp"] = {
            "proj": dense_init(gen, 2 * d, d, dtype=dtype),
            "norm_h": norm_params(gen, d, cfg.norm, dtype),
            "norm_e": norm_params(gen, d, cfg.norm, dtype),
            "block": BLK.block_params(gen, cfg, BLK.block_kinds(cfg)[-1][0]),
        }
    return p


def param_shapes(cfg: ModelConfig) -> Params:
    """:func:`init_params`'s keys, shapes and dtypes on the meta device,
    nothing allocated (the reference's ``jax.eval_shape`` of
    ``init_params``), deepseek-v3-671b's too."""
    return init_params(cfg, MetaGenerator())


def unembed(p: Params, cfg: ModelConfig, x, shard=NOSHARD):
    if cfg.tie_embeddings:
        return shard(x @ fsdp_gather(p["embed"]).T, "bsv")
    return shard(x @ fsdp_gather(p["lm_head"]), "bsv")


def _lookup(table, idx):
    """``table[idx]``: rows of an embedding table (for a DTensor table on
    each rank's shard, ``parallel.dtensor.embed_lookup``)."""
    return embed_lookup(table, idx)


def _embed(p: Params, tokens):
    return _lookup(p["embed"], tokens)


def _positions(B: int, S: int, device):
    return torch.arange(S, dtype=torch.int32, device=device).expand(B, S)


def _with_patches(p: Params, cfg: ModelConfig, batch: Dict, x,
                  shard=NOSHARD):
    """vlm: the image patches [B, n_patches, frontend_dim] projected and
    prepended to the text embeddings x. Returns (x, the prefix-LM mask's
    bidirectional prefix: n_patches for vlm, else 0)."""
    if cfg.family != "vlm":
        return x, 0
    xp = shard(batch["patches"].to(x.dtype) @ p["proj"], "bsd")
    return torch.cat([xp, x], dim=1), cfg.n_patches


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


def forward(p: Params, cfg: ModelConfig, batch: Dict, shard=NOSHARD):
    """-> (logits [B,S,V], aux_loss (float32 scalar, the sum over the MoE
    layers), hidden [B,S,d]). For vlm, S counts the image patches first;
    enc-dec takes ``batch["frames"]`` through :func:`encode`. ``shard``
    (``parallel.sharding.shard``) places the activations where the
    reference's does (the embeddings and every block's outputs ``"bsd"``,
    the logits ``"bsv"``) and reaches the MoE dispatches; on plain tensors
    it is the identity."""
    if cfg.family == "encdec":
        return _forward_encdec(p, cfg, batch, shard)
    tokens = batch["tokens"]
    B = tokens.shape[0]
    x, prefix_len = _with_patches(p, cfg, batch,
                                  shard(_embed(p, tokens), "bsd"), shard)
    S = x.shape[1]
    positions = _positions(B, S, x.device)
    mask = A.MaskSpec("causal", cfg.window, prefix_len)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if cfg.family == "hybrid":
        x = _hybrid_forward(p, cfg, x, positions, mask, shard)
    else:
        for i, (kind, n) in enumerate(BLK.block_kinds(cfg)):
            for pl in _unbind_layers(p[f"seg{i}"], n):
                def body(h, pl=pl, kind=kind):
                    return BLK.block_forward(fsdp_gather(pl), cfg, kind, h,
                                             positions, mask, shard)
                x, a = _maybe_remat(body, cfg)(x)
                aux = aux + a
    h = apply_norm(x, p["final_norm"], cfg.norm, cfg.norm_eps)
    return unembed(p, cfg, h, shard), aux, h


def _mamba_stack(seg: Params, n: int, cfg: ModelConfig, x, positions, mask,
                 shard=NOSHARD):
    """``n`` stacked mamba2 layers, each under ``_maybe_remat``."""
    for pl in _unbind_layers(seg, n):
        x, _ = _maybe_remat(lambda h, pl=pl: BLK.block_forward(
            fsdp_gather(pl), cfg, "mamba2", h, positions, mask, shard),
            cfg)(x)
    return x


def _hybrid_forward(p: Params, cfg: ModelConfig, x, positions, mask,
                    shard=NOSHARD):
    """zamba2: each group's mamba layers (under ``_maybe_remat``), then the
    shared block with the group's LoRA (not rematerialized, as in the
    reference), then the tail."""
    n_grp, grp_m, n_tail = _hybrid_plan(cfg)
    loras = (_unbind_layers(p["lora"], n_grp) if "lora" in p
             else [None] * n_grp)
    for mg, lg in zip(_unbind_layers(p["mamba_grp"], n_grp), loras):
        x = _mamba_stack(mg, grp_m, cfg, x, positions, mask, shard)
        x = BLK.shared_block_forward(fsdp_gather(p["shared"]),
                                     fsdp_gather(lg), cfg, x, positions,
                                     mask, shard)
    if n_tail:
        x = _mamba_stack(p["mamba_tail"], n_tail, cfg, x, positions, mask,
                         shard)
    return x


def _norm(x, w, cfg: ModelConfig):
    return apply_norm(x, w, cfg.norm, cfg.norm_eps)


def _enc_layer(pl: Params, cfg: ModelConfig, h, shard=NOSHARD):
    """One encoder layer: self attention over every frame (no mask, no
    rotary: the positions were added to the input), then the MLP."""
    h = h + shard(A.attn_forward(pl["attn"], cfg, _norm(h, pl["ln1"], cfg),
                                 None, None), "bsd")
    return h + shard(mlp_apply(pl["mlp"], _norm(h, pl["ln2"], cfg), cfg.mlp),
                     "bsd")


def _dec_rest(pl: Params, cfg: ModelConfig, h, kv, shard=NOSHARD):
    """A decoder layer after its self attention: cross attention over the
    encoder's (k, v), then the MLP."""
    h = h + shard(A.cross_attn_forward(pl["cross"], cfg,
                                       _norm(h, pl["lnx"], cfg), kv), "bsd")
    return h + shard(mlp_apply(pl["mlp"], _norm(h, pl["ln2"], cfg), cfg.mlp),
                     "bsd")


def encode(p: Params, cfg: ModelConfig, frames, shard=NOSHARD):
    """Whisper's encoder over stub frame embeddings [B, T, frontend_dim]:
    projected, the learned positions added, the encoder layers, the final
    norm -> [B, T, d]."""
    e = p["enc"]
    T = frames.shape[1]
    x = shard(frames.to(cfg.dtype) @ e["proj"], "bsd") + e["pos"][:T]
    for pl in _unbind_layers(e["blocks"], cfg.n_enc_layers):
        x = _maybe_remat(lambda h, pl=pl: _enc_layer(fsdp_gather(pl), cfg, h,
                                                     shard), cfg)(x)
    return _norm(x, e["ln_f"], cfg)


def _forward_encdec(p: Params, cfg: ModelConfig, batch: Dict, shard=NOSHARD):
    enc_out = encode(p, cfg, batch["frames"], shard)
    tokens = batch["tokens"]
    S = tokens.shape[1]
    x = shard(_embed(p, tokens), "bsd") + p["dec_pos"][:S]

    def body(h, pl):
        g = _norm(h, pl["ln1"], cfg)
        h = h + shard(A.attn_forward(pl["attn"], cfg, g, None, A.CAUSAL),
                      "bsd")
        return _dec_rest(pl, cfg, h, A.cross_kv(pl["cross"], enc_out), shard)
    for pl in _unbind_layers(p["dec_blocks"], cfg.n_layers):
        x = _maybe_remat(lambda h, pl=pl: body(h, fsdp_gather(pl)), cfg)(x)
    h = _norm(x, p["final_norm"], cfg)
    return (unembed(p, cfg, h, shard),
            torch.zeros((), dtype=torch.float32, device=x.device), h)


def mtp_logits(p: Params, cfg: ModelConfig, hidden, tokens, shard=NOSHARD):
    """DeepSeek's multi-token-prediction head: predict token t+2 from the
    trunk's hidden at t combined with the embedding of token t+1."""
    mtp = p["mtp"]
    B, S = tokens.shape
    nxt = torch.cat([tokens[:, 1:], tokens[:, -1:]], dim=1)
    he = apply_norm(_embed(p, nxt), mtp["norm_e"], cfg.norm, cfg.norm_eps)
    hh = apply_norm(hidden, mtp["norm_h"], cfg.norm, cfg.norm_eps)
    x = shard(torch.cat([hh, he], dim=-1) @ fsdp_gather(mtp["proj"]), "bsd")
    x, _ = BLK.block_forward(fsdp_gather(mtp["block"]), cfg,
                             BLK.block_kinds(cfg)[-1][0],
                             x, _positions(B, S, x.device),
                             A.MaskSpec("causal"), shard)
    x = apply_norm(x, p["final_norm"], cfg.norm, cfg.norm_eps)
    return unembed(p, cfg, x, shard)


# ===================================================================== caches
def _encdec_cache(cfg: ModelConfig, B: int, S_max: int, T: int, device):
    shape = (cfg.n_layers, B, T, cfg.n_kv_heads, cfg.hd)
    dev = torch.device("cuda" if device is None else device)
    return {"self": A.init_kv_cache(cfg, B, S_max, cfg.n_layers,
                                    device=device),
            "cross_k": torch.zeros(shape, dtype=torch.bfloat16, device=dev),
            "cross_v": torch.zeros(shape, dtype=torch.bfloat16, device=dev)}


def init_cache(cfg: ModelConfig, B: int, S_max: int, device=None):
    """Zero cache on ``device`` (the card when None), bf16: a ``KVCache``
    ``[n_layers, B, S_max, n_kv, hd]``, for MLA an ``MLACache`` of
    ``[n_layers, B, S_max, kv_lora]`` and ``[n_layers, B, S_max, rope]``,
    for enc-dec ``{"self": KVCache, "cross_k", "cross_v"}`` with the cross
    rows ``[n_layers, B, enc_seq, n_kv, hd]``; for ssm a ``MambaState`` of
    ``[n_layers, B, ...]`` (conv window bf16, ssm state float32), for
    hybrid ``{"grp": MambaState [n_groups, period - 1, B, ...], "attn":
    KVCache [n_groups, ...], "tail": MambaState [n_tail, B, ...]}``. The
    mamba2 states keep the reference's ``init_mamba_state`` shape ``[nh,
    hp, ds]``, not forward's ``[nh, ds, hp]`` (ROADMAP queue 3)."""
    if cfg.family == "hybrid":
        n_grp, grp_m, n_tail = _hybrid_plan(cfg)
        grp = M.init_mamba_state(cfg, B, n_grp * grp_m, device=device)
        cache = {"grp": M.MambaState(*(t.view((n_grp, grp_m) + t.shape[1:])
                                       for t in grp)),
                 "attn": A.init_kv_cache(cfg, B, S_max, n_grp, device=device)}
        if n_tail:
            cache["tail"] = M.init_mamba_state(cfg, B, n_tail, device=device)
        return cache
    if cfg.family == "ssm":
        return M.init_mamba_state(cfg, B, cfg.n_layers, device=device)
    if cfg.family == "encdec":
        return _encdec_cache(cfg, B, S_max, cfg.enc_seq, device)
    if cfg.attention == "mla":
        return MLA.init_mla_cache(cfg, B, S_max, cfg.n_layers, device=device)
    return A.init_kv_cache(cfg, B, S_max, cfg.n_layers, device=device)


def cache_shapes(cfg: ModelConfig, B: int, S_max: int):
    """:func:`init_cache`'s structure, shapes and dtypes on the meta
    device."""
    return init_cache(cfg, B, S_max, device="meta")


def _layer_cache(cache, *i):
    """Row ``i`` of a stacked cache (``KVCache``, ``MLACache`` or
    ``MambaState``; ``i`` one index a stacked dim): views."""
    return type(cache)(*(t[i] for t in cache))


def _stack_states(states):
    """Per-layer states (named tuples of tensors) -> one ``[n, ...]``
    stack a field."""
    return type(states[0])(*(torch.stack(f) for f in zip(*states)))


# ===================================================================== decode
def decode_step(p: Params, cfg: ModelConfig, tokens, pos, cache,
                shard=NOSHARD):
    """One new token for every sequence. tokens [B] int32, pos [B] int32
    (for vlm counting the image patches). Returns (logits [B, V], cache).
    Each layer's new k/v row is written into ``cache`` in place, and the
    same cache comes back. ``shard`` places the logits (``"bsv"``) and
    reaches the MoE dispatches, as the reference's does."""
    x = _embed(p, tokens)[:, None, :]          # [B,1,d]
    if cfg.family == "encdec":
        x = x + _lookup(p["dec_pos"], pos)[:, None]
        for j in range(cfg.n_layers):
            pl = layer_params(p["dec_blocks"], j)
            y, _ = A.attn_decode(pl["attn"], cfg, _norm(x, pl["ln1"], cfg),
                                 pos, _layer_cache(cache["self"], j))
            x = _dec_rest(pl, cfg, x + y, (cache["cross_k"][j],
                                           cache["cross_v"][j]))
        h = _norm(x, p["final_norm"], cfg)
        return unembed(p, cfg, h, shard)[:, 0], cache
    if cfg.family == "hybrid":
        x = _hybrid_decode(p, cfg, x, pos, cache)
        h = _norm(x, p["final_norm"], cfg)
        return unembed(p, cfg, h, shard)[:, 0], cache
    off = 0
    for i, (kind, n) in enumerate(BLK.block_kinds(cfg)):
        for j in range(n):
            x, _ = BLK.block_decode(layer_params(p[f"seg{i}"], j), cfg,
                                    kind, x, pos, _layer_cache(cache, off + j),
                                    shard)
        off += n
    h = apply_norm(x, p["final_norm"], cfg.norm, cfg.norm_eps)
    return unembed(p, cfg, h, shard)[:, 0], cache


def _hybrid_decode(p: Params, cfg: ModelConfig, x, pos, cache):
    """zamba2's decode step: every layer's rows of ``cache`` (the mamba
    states, the occurrences' k/v) written in place."""
    n_grp, grp_m, n_tail = _hybrid_plan(cfg)
    for g in range(n_grp):
        mg = layer_params(p["mamba_grp"], g)
        for j in range(grp_m):
            x, _ = BLK.block_decode(layer_params(mg, j), cfg, "mamba2", x,
                                    pos, _layer_cache(cache["grp"], g, j))
        lg = layer_params(p["lora"], g) if "lora" in p else None
        x, _ = BLK.shared_block_decode(p["shared"], lg, cfg, x, pos,
                                       _layer_cache(cache["attn"], g))
    for j in range(n_tail):
        x, _ = BLK.block_decode(layer_params(p["mamba_tail"], j), cfg,
                                "mamba2", x, pos,
                                _layer_cache(cache["tail"], j))
    return x


# ===================================================================== prefill
def prefill(p: Params, cfg: ModelConfig, batch: Dict, S_max: int,
            shard=NOSHARD):
    """Process a full prompt; returns (last-token logits [B,V], cache).

    Only the final position's logits are computed (serving practice — the
    full [B,S,V] tensor never materializes). Each layer's cache goes
    straight into its row of the ``[n_layers, ...]`` cache. vlm prepends
    the projected ``batch["patches"]`` (S_max must hold them); enc-dec
    runs the encoder over ``batch["frames"]`` first. ssm and hybrid stack
    the mamba layers' final states as the reference does (the conv window
    in the activations' dtype, mamba2's ssm ``[nh, ds, hp]``). ``shard``
    places the activations as in :func:`forward`.
    """
    if cfg.family == "encdec":
        return _prefill_encdec(p, cfg, batch, S_max, shard)
    if cfg.family in ("ssm", "hybrid"):
        return _prefill_mamba(p, cfg, batch, S_max, shard)
    tokens = batch["tokens"]
    B = tokens.shape[0]
    x, prefix_len = _with_patches(p, cfg, batch,
                                  shard(_embed(p, tokens), "bsd"), shard)
    S = x.shape[1]
    positions = _positions(B, S, x.device)
    mask = A.MaskSpec("causal", cfg.window, prefix_len)
    cache = placed_cache(lambda dev: init_cache(cfg, B, S_max, device=dev),
                         x)
    off = 0
    for i, (kind, n) in enumerate(BLK.block_kinds(cfg)):
        for j in range(n):
            x, c = BLK.block_prefill(layer_params(p[f"seg{i}"], j), cfg,
                                     kind, x, positions, mask, S_max, shard)
            for t, ct in zip(_layer_cache(cache, off + j), c):
                t.copy_(ct)
        off += n
    h = apply_norm(x[:, -1:], p["final_norm"], cfg.norm, cfg.norm_eps)
    return unembed(p, cfg, h, shard)[:, 0], cache


def _prefill_encdec(p: Params, cfg: ModelConfig, batch: Dict, S_max: int,
                    shard=NOSHARD):
    """Enc-dec prefill: the encoder, then each decoder layer with its self
    attention's cache and its cross attention's k and v (over the
    encoder's T frames, rounded to bf16) written into its rows."""
    tokens = batch["tokens"]
    B, S = tokens.shape
    enc_out = encode(p, cfg, batch["frames"], shard)
    x = shard(_embed(p, tokens), "bsd") + p["dec_pos"][:S]
    mask = A.MaskSpec("causal", cfg.window, 0)
    cache = placed_cache(lambda dev: _encdec_cache(
        cfg, B, S_max, enc_out.shape[1], dev), x)
    for j in range(cfg.n_layers):
        pl = layer_params(p["dec_blocks"], j)
        y, c = A.attn_prefill(pl["attn"], cfg, _norm(x, pl["ln1"], cfg),
                              None, mask, S_max)
        for t, ct in zip(_layer_cache(cache["self"], j), c):
            t.copy_(ct)
        kv = A.cross_kv(pl["cross"], enc_out)
        cache["cross_k"][j].copy_(kv[0])
        cache["cross_v"][j].copy_(kv[1])
        x = _dec_rest(pl, cfg, x + shard(y, "bsd"), kv, shard)
    h = _norm(x[:, -1:], p["final_norm"], cfg)
    return unembed(p, cfg, h, shard)[:, 0], cache


def _prefill_mamba(p: Params, cfg: ModelConfig, batch: Dict, S_max: int,
                   shard=NOSHARD):
    """The ssm and hybrid prefill (the reference's ssm branch and
    ``_hybrid_prefill``)."""
    tokens = batch["tokens"]
    B, S = tokens.shape
    x = shard(_embed(p, tokens), "bsd")
    positions = _positions(B, S, x.device)
    mask = A.MaskSpec("causal", cfg.window, 0)

    def mamba(seg, n, x):
        states = []
        for j in range(n):
            x, st = BLK.block_prefill(layer_params(seg, j), cfg,
                                      f"mamba{cfg.ssm_version}", x, positions,
                                      mask, S_max, shard)
            states.append(st)
        return x, _stack_states(states)

    if cfg.family == "ssm":
        x, cache = mamba(p["seg0"], cfg.n_layers, x)
    else:
        n_grp, grp_m, n_tail = _hybrid_plan(cfg)
        attn = placed_cache(lambda dev: A.init_kv_cache(
            cfg, B, S_max, n_grp, device=dev), x)
        grp = []
        for g in range(n_grp):
            x, st = mamba(layer_params(p["mamba_grp"], g), grp_m, x)
            grp.append(st)
            lg = layer_params(p["lora"], g) if "lora" in p else None
            x, kv = BLK.shared_block_prefill(p["shared"], lg, cfg, x,
                                             positions, mask, S_max, shard)
            for t, ct in zip(_layer_cache(attn, g), kv):
                t.copy_(ct)
        cache = {"grp": _stack_states(grp), "attn": attn}
        if n_tail:
            x, cache["tail"] = mamba(p["mamba_tail"], n_tail, x)
    h = _norm(x[:, -1:], p["final_norm"], cfg)
    return unembed(p, cfg, h, shard)[:, 0], cache
