"""Mixture-of-Experts layer with three dispatch implementations — the
port's counterpart of ``repro.models.moe``.

``gshard``: capacity-bounded one-hot dispatch and combine einsums.
``scatter``: slots from a segmented-rank sort, a token gather by index, the
expert einsums, then a scatter-add combine. ``mixed``: the gather dispatch
and the one-hot combine einsum. All three see the same slot assignment,
so they agree wherever nothing rounds differently.

Routers: softmax top-k with the Switch load-balance aux loss, or sigmoid
scores with a bias-corrected top-k and weights renormalised (DeepSeek-V3's
aux-loss-free balancing; ``router_bias`` is a buffer, outside the
gradient).

Two places differ from the reference on purpose, both for determinism:

* top-k: ``jax.lax.top_k`` puts the lower expert first on ties; ``torch.
  topk`` promises no order, so :func:`_topk` takes a stable descending
  sort.
* dropped slots: the reference scatters every slot past capacity onto
  ``(E-1, C-1)``, duplicates included, and which write lands is up to the
  backend; where the last expert itself overflows, XLA on the CPU lets a
  drop overwrite that expert's real slot ``C-1``. :func:`_slot_assignment`
  scatters the drops into a spare column ``C`` (each writes the same
  sentinel) and cuts it off, so every real slot keeps its token. Every
  kept slot then holds a token routed to its expert, which makes the
  reference's guard against collisions (in ``moe_scatter`` and
  ``moe_mixed``) unnecessary: all three dispatches share one
  :func:`_slot_weights`.

The ``shard=`` hook (``parallel.sharding.shard``) constrains the slots,
the expert batches, the one-hot masks and the output where the
reference's does; outside a mesh and for a plain tensor it is the
identity.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from .config import ModelConfig
from .layers import NOSHARD, Params, _trunc_normal, dense_init

__all__ = ["moe_params", "capacity", "moe_scatter", "moe_mixed",
           "moe_gshard", "gather_dispatch", "shared_expert", "MOE_IMPLS",
           "moe_apply"]


def moe_params(gen, cfg: ModelConfig, dtype=None) -> Params:
    dtype = dtype or cfg.dtype
    d, E, fe = cfg.d_model, cfg.n_experts, cfg.d_ff_expert
    glu = cfg.mlp in ("swiglu", "geglu")
    # stacked expert weights, scaled by the fan-in of their products
    p = {"router": dense_init(gen, d, E, dtype=torch.float32),
         "wi": _trunc_normal(gen, (E, d, fe), d ** -0.5, dtype),
         "wo": _trunc_normal(gen, (E, fe, d), fe ** -0.5, dtype)}
    if glu:
        p["wg"] = _trunc_normal(gen, (E, d, fe), d ** -0.5, dtype)
    if cfg.router == "sigmoid":          # a buffer, not trained
        p["router_bias"] = torch.zeros((E,), dtype=torch.float32,
                                       device=gen.device)
    if cfg.n_shared_experts:
        fs = fe * cfg.n_shared_experts
        p["shared"] = {"wi": dense_init(gen, d, fs, dtype=dtype),
                       "wo": dense_init(gen, fs, d, dtype=dtype)}
        if glu:
            p["shared"]["wg"] = dense_init(gen, d, fs, dtype=dtype)
    return p


def _topk(sel, k: int):
    """Indices of the ``k`` largest of the last dim, lower index first on
    ties (``jax.lax.top_k``'s order)."""
    return torch.sort(sel, dim=-1, descending=True, stable=True).indices[
        ..., :k]


def _route(p: Params, cfg: ModelConfig, x):
    """-> (topk_idx [B,S,k] int32, topk_w [B,S,k] in x's dtype, aux_loss
    float32 scalar)."""
    logits = x.float() @ p["router"]                      # [B,S,E]
    E, k = cfg.n_experts, cfg.top_k
    if cfg.router == "sigmoid":
        scores = torch.sigmoid(logits)
        idx = _topk(scores + p["router_bias"].detach(), k)
        w = torch.gather(scores, -1, idx)
        w = w / torch.clamp(w.sum(-1, keepdim=True), min=1e-9)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    else:
        probs = torch.softmax(logits, dim=-1)
        idx = _topk(probs, k)
        w = torch.gather(probs, -1, idx)
        w = w / torch.clamp(w.sum(-1, keepdim=True), min=1e-9)
        # Switch aux: E * sum_e(frac_tokens_e * mean_prob_e)
        frac = F.one_hot(idx[..., 0], E).float().mean(dim=(0, 1))
        aux = E * torch.sum(frac * probs.mean(dim=(0, 1)))
    return idx.to(torch.int32), w.to(x.dtype), aux


def _expert_ffn(p: Params, cfg: ModelConfig, xb):
    """xb [B,E,C,d] -> [B,E,C,d] through each expert's FFN."""
    if cfg.mlp in ("swiglu", "geglu"):
        g = torch.einsum("becd,edf->becf", xb, p["wg"])
        act = F.silu(g) if cfg.mlp == "swiglu" else F.gelu(
            g, approximate="tanh")
        h = act * torch.einsum("becd,edf->becf", xb, p["wi"])
    else:
        h = torch.square(F.relu(torch.einsum("becd,edf->becf", xb, p["wi"])))
    return torch.einsum("becf,efd->becd", h, p["wo"])


def _slot_assignment(idx, E: int, C: int):
    """-> (slot_token [B,E,C] int32 in [0, S], slot_ksel [B,E,C] int32):
    the token in each expert's slot (S for an empty slot) and which of the
    token's k choices put it there.

    The routed slots of a row, flattened (token, choice) in order, are
    sorted by expert id (stable), ranked within each expert's run, and
    slots ranked below C kept. A dropped slot goes to the spare column C,
    which is cut off, so no drop can land on a kept slot."""
    B, S, k = idx.shape
    dev = idx.device
    n = S * k
    e_flat = idx.reshape(B, n).long()
    order = torch.sort(e_flat, dim=-1, stable=True).indices
    se = torch.gather(e_flat, 1, order)
    pos = torch.arange(n, device=dev).expand(B, n)
    is_head = torch.ones_like(se, dtype=torch.bool)
    is_head[:, 1:] = se[:, 1:] != se[:, :-1]
    rank = pos - torch.cummax(torch.where(is_head, pos, 0), dim=1).values
    st = torch.div(order, k, rounding_mode="floor")   # token of the slot
    sk = order - st * k                               # which of its k choices
    keep = rank < C
    rs = torch.where(keep, rank, C)
    bi = torch.arange(B, device=dev)[:, None].expand(B, n)
    slot_token = torch.full((B, E, C + 1), S, dtype=torch.int32, device=dev)
    slot_ksel = torch.zeros((B, E, C + 1), dtype=torch.int32, device=dev)
    slot_token[bi, se, rs] = torch.where(keep, st, S).to(torch.int32)
    slot_ksel[bi, se, rs] = torch.where(keep, sk, 0).to(torch.int32)
    return slot_token[..., :C].contiguous(), slot_ksel[..., :C].contiguous()


def capacity(cfg: ModelConfig, S: int) -> int:
    c = int(S * cfg.top_k / max(cfg.n_experts, 1) * cfg.capacity_factor)
    return max(8, -(-c // 8) * 8)


def _slot_weights(idx, w, slot_token, slot_ksel):
    """The router weight of each slot [B,E,C] (0 for an empty slot). Every
    kept slot holds a token that routed to its expert (the drops went to
    the spare column), so no check against scatter collisions is needed."""
    S = idx.shape[1]
    valid = slot_token < S
    t_safe = torch.clamp(slot_token, max=S - 1).long()
    bi = torch.arange(idx.shape[0], device=idx.device)[:, None, None]
    return torch.where(valid, w[bi, t_safe, slot_ksel.long()],
                       torch.zeros((), dtype=w.dtype, device=w.device))


def _pad_token(x):
    """x [B,S,d] with a zero row S appended: what an empty slot reads."""
    return F.pad(x, (0, 0, 0, 1))


def gather_dispatch(xpad, slot_token):
    """xb[b,e,c,:] = xpad[b, slot_token[b,e,c], :]. The reference's
    ``jax.custom_vjp`` only swaps the VJP's scatter-add for an equal
    one-hot einsum (a GSPMD concern); autograd of this plain gather gives
    the scatter-add itself."""
    B = xpad.shape[0]
    bi = torch.arange(B, device=xpad.device)[:, None, None]
    return xpad[bi, slot_token.long()]


def _onehot_tokens(slot_token, S: int, dtype):
    """[B,S,E,C]: 1 where slot (e, c) holds token s."""
    s = torch.arange(S, dtype=slot_token.dtype, device=slot_token.device)
    return (slot_token[:, None] == s[None, :, None, None]).to(dtype)


def moe_scatter(p: Params, cfg: ModelConfig, x, shard=NOSHARD):
    """Gather dispatch, scatter-add combine. x [B,S,d] -> (y [B,S,d],
    aux)."""
    B, S, d = x.shape
    C = capacity(cfg, S)
    idx, w, aux = _route(p, cfg, x)
    slot_token, slot_ksel = _slot_assignment(idx, cfg.n_experts, C)
    slot_token = shard(slot_token, "bec")
    w_slot = _slot_weights(idx, w, slot_token, slot_ksel)
    xb = shard(gather_dispatch(_pad_token(x), slot_token), "becd")
    h = shard(_expert_ffn(p, cfg, xb), "becd") * w_slot[..., None].to(x.dtype)
    bi = torch.arange(B, device=x.device)[:, None, None].expand_as(slot_token)
    y = torch.zeros((B, S + 1, d), dtype=x.dtype, device=x.device)
    y = y.index_put((bi, slot_token.long()), h, accumulate=True)  # combine
    return shard(y[:, :S], "bsd"), aux


def moe_mixed(p: Params, cfg: ModelConfig, x, shard=NOSHARD):
    """Gather dispatch, one-hot combine einsum."""
    B, S, d = x.shape
    C = capacity(cfg, S)
    idx, w, aux = _route(p, cfg, x)
    slot_token, slot_ksel = _slot_assignment(idx, cfg.n_experts, C)
    slot_token = shard(slot_token, "bec")
    w_slot = _slot_weights(idx, w, slot_token, slot_ksel)
    xb = shard(gather_dispatch(_pad_token(x), slot_token), "becd")
    h = shard(_expert_ffn(p, cfg, xb), "becd")
    D = shard(_onehot_tokens(slot_token, S, x.dtype)
              * w_slot[:, None].to(x.dtype), "bsec")
    return shard(torch.einsum("bsec,becd->bsd", D, h), "bsd"), aux


def moe_gshard(p: Params, cfg: ModelConfig, x, shard=NOSHARD):
    """One-hot dispatch and combine einsums (capacity-bounded). The router
    weights apply on the combine only."""
    B, S, d = x.shape
    C = capacity(cfg, S)
    idx, w, aux = _route(p, cfg, x)
    slot_token, slot_ksel = _slot_assignment(idx, cfg.n_experts, C)
    w_slot = _slot_weights(idx, w, slot_token, slot_ksel)
    D0 = shard(_onehot_tokens(slot_token, S, x.dtype), "bsec")
    Dw = shard(D0 * w_slot[:, None].to(x.dtype), "bsec")
    xb = shard(torch.einsum("bsec,bsd->becd", D0, x), "becd")  # dispatch
    h = shard(_expert_ffn(p, cfg, xb), "becd")
    y = torch.einsum("bsec,becd->bsd", Dw, h)              # combine
    return shard(y, "bsd"), aux


def shared_expert(p: Params, cfg: ModelConfig, x):
    if "shared" not in p:
        return torch.zeros_like(x)
    sp = p["shared"]
    if cfg.mlp in ("swiglu", "geglu"):
        g = x @ sp["wg"]
        act = F.silu(g) if cfg.mlp == "swiglu" else F.gelu(
            g, approximate="tanh")
        h = act * (x @ sp["wi"])
    else:
        h = torch.square(F.relu(x @ sp["wi"]))
    return h @ sp["wo"]


MOE_IMPLS = {"scatter": moe_scatter, "gshard": moe_gshard,
             "mixed": moe_mixed}


def moe_apply(p: Params, cfg: ModelConfig, x, shard=NOSHARD
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    y, aux = MOE_IMPLS[cfg.moe_impl](p, cfg, x, shard)
    return y + shared_expert(p, cfg, x), aux
