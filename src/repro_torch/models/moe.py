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
from torch.distributed.tensor import DTensor

from ..parallel.dtensor import batch_placements, local_call, rowwise
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
    if isinstance(x, DTensor):
        return _route_rows(p, cfg, x)
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


def _route_rows(p: Params, cfg: ModelConfig, x):
    """:func:`_route` of a DTensor x on each rank's batch rows (the router
    replicated, its gradient summed over the batch's mesh dims). The
    Switch aux loss takes its token means as the mean of the rows'."""
    E = cfg.n_experts
    names = ["router"] + (["router_bias"] if "router_bias" in p else [])

    def rows(x, *w):
        q = dict(zip(names, w))
        idx, wt, _ = _route(q, cfg, x)
        if cfg.router == "sigmoid":
            z = torch.zeros((x.shape[0], E), dtype=torch.float32,
                            device=x.device)
            return idx, wt, z, z
        probs = torch.softmax(x.float() @ q["router"], dim=-1)
        frac = F.one_hot(idx[..., 0].long(), E).float().mean(dim=1)
        return idx, wt, frac, probs.mean(dim=1)

    idx, wt, frac, pm = rowwise(rows, x, *(p[n] for n in names),
                                whole=tuple(range(1, 1 + len(names))))
    if cfg.router == "sigmoid":
        return idx, wt, torch.zeros((), dtype=torch.float32,
                                    device=x.device)
    return idx, wt, E * torch.sum(frac.mean(0) * pm.mean(0))


def _expert_ffn(p: Params, cfg: ModelConfig, xb):
    """xb [B,E,C,d] -> [B,E,C,d] through each expert's FFN; for DTensors
    on each rank's batch rows and experts (:func:`_expert_ffn_local`)."""
    if isinstance(xb, DTensor):
        return _expert_ffn_local(p, cfg, xb)
    if cfg.mlp in ("swiglu", "geglu"):
        g = torch.einsum("becd,edf->becf", xb, p["wg"])
        act = F.silu(g) if cfg.mlp == "swiglu" else F.gelu(
            g, approximate="tanh")
        h = act * torch.einsum("becd,edf->becf", xb, p["wi"])
    else:
        h = torch.square(F.relu(torch.einsum("becd,edf->becf", xb, p["wi"])))
    return torch.einsum("becf,efd->becd", h, p["wo"])


def _expert_ffn_local(p: Params, cfg: ModelConfig, xb):
    """:func:`_expert_ffn` on each rank's shard: xb's batch rows over the
    batch's mesh dims and, where the expert count divides it, its experts
    over every other mesh dim that shards the expert weights (expert
    parallelism); the weights' other shards (FSDP's) are gathered and
    their gradients summed over the batch's mesh dims."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    names = [n for n in ("wi", "wg", "wo") if n in p]
    E = xb.shape[1]
    mesh = xb.device_mesh
    bpl = batch_placements(xb)
    x_pl, w_pl, g_pl = [], [], []
    for md, bp in enumerate(bpl):
        ep = any(isinstance(p[n].placements[md], Shard)
                 and p[n].placements[md].dim == 0 for n in names)
        if not bp.is_replicate():
            x_pl.append(Shard(0))
            w_pl.append(Replicate())
            g_pl.append(Partial())
        elif ep and E % mesh.size(md) == 0:
            x_pl.append(Shard(1))
            w_pl.append(Shard(0))
            g_pl.append(Shard(0))
        else:
            x_pl.append(Replicate())
            w_pl.append(Replicate())
            g_pl.append(Replicate())
    return local_call(
        lambda xb, *w: _expert_ffn(dict(zip(names, w)), cfg, xb),
        (xb, *(p[n] for n in names)), [x_pl] + [w_pl] * len(names), x_pl,
        [x_pl] + [g_pl] * len(names))


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


def _slots(cfg: ModelConfig, idx, w, C: int):
    """(slot_token, slot_ksel, w_slot) of :func:`_slot_assignment` and
    :func:`_slot_weights`, a batch row at a time (``rowwise``: on each
    rank's rows of a DTensor)."""
    def rows(idx, w):
        st, sk = _slot_assignment(idx, cfg.n_experts, C)
        return st, sk, _slot_weights(idx, w, st, sk)
    return rowwise(rows, idx, w)


def _combine(h, slot_token, S: int):
    """The scatter-add combine: y[b, slot_token[b,e,c]] += h[b,e,c] over
    every slot, row S (the empty slots') cut off -> [B,S,d]."""
    B, d = h.shape[0], h.shape[-1]
    bi = torch.arange(B, device=h.device)[:, None, None].expand_as(slot_token)
    y = torch.zeros((B, S + 1, d), dtype=h.dtype, device=h.device)
    return y.index_put((bi, slot_token.long()), h, accumulate=True)[:, :S]


def moe_scatter(p: Params, cfg: ModelConfig, x, shard=NOSHARD):
    """Gather dispatch, scatter-add combine. x [B,S,d] -> (y [B,S,d],
    aux)."""
    B, S, d = x.shape
    C = capacity(cfg, S)
    idx, w, aux = _route(p, cfg, x)
    slot_token, slot_ksel, w_slot = _slots(cfg, idx, w, C)
    slot_token = shard(slot_token, "bec")
    xb = shard(rowwise(lambda x, st: gather_dispatch(_pad_token(x), st),
                       x, slot_token), "becd")
    h = shard(_expert_ffn(p, cfg, xb), "becd") * w_slot[..., None].to(x.dtype)
    y = rowwise(lambda h, st: _combine(h, st, S), h, slot_token)
    return shard(y, "bsd"), aux


def _combine_onehot(D, h):
    """einsum("bsec,becd->bsd", D, h). On DTensors as one batched product
    over the (e, c) slots, e major: DTensor's own einsum merges the
    contracted dims c-major, which splits an expert-sharded e across the
    shards."""
    if not isinstance(D, DTensor):
        return torch.einsum("bsec,becd->bsd", D, h)
    B, S, E, C = D.shape
    return torch.bmm(D.reshape(B, S, E * C), h.reshape(B, E * C, h.shape[-1]))


def moe_mixed(p: Params, cfg: ModelConfig, x, shard=NOSHARD):
    """Gather dispatch, one-hot combine einsum."""
    B, S, d = x.shape
    C = capacity(cfg, S)
    idx, w, aux = _route(p, cfg, x)
    slot_token, slot_ksel, w_slot = _slots(cfg, idx, w, C)
    slot_token = shard(slot_token, "bec")
    xb = shard(rowwise(lambda x, st: gather_dispatch(_pad_token(x), st),
                       x, slot_token), "becd")
    h = shard(_expert_ffn(p, cfg, xb), "becd")
    D = shard(_onehot_tokens(slot_token, S, x.dtype)
              * w_slot[:, None].to(x.dtype), "bsec")
    return shard(_combine_onehot(D, h), "bsd"), aux


def moe_gshard(p: Params, cfg: ModelConfig, x, shard=NOSHARD):
    """One-hot dispatch and combine einsums (capacity-bounded). The router
    weights apply on the combine only."""
    B, S, d = x.shape
    C = capacity(cfg, S)
    idx, w, aux = _route(p, cfg, x)
    slot_token, slot_ksel, w_slot = _slots(cfg, idx, w, C)
    D0 = shard(_onehot_tokens(slot_token, S, x.dtype), "bsec")
    Dw = shard(D0 * w_slot[:, None].to(x.dtype), "bsec")
    xb = shard(torch.einsum("bsec,bsd->becd", D0, x), "becd")  # dispatch
    h = shard(_expert_ffn(p, cfg, xb), "becd")
    y = _combine_onehot(Dw, h)                              # combine
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
