"""Optimizers (hand-rolled, as the reference's): AdamW and Adafactor, with
global-norm clipping and a cosine schedule with warmup — the port's
counterpart of ``repro.train.optim``.

AdamW keeps float32 (m, v) and float32 master copies when params are bf16
(mixed precision). Adafactor keeps factored second moments only (row/col).
Parameters and states are nested dicts of tensors keyed as the
reference's pytrees; the step counter is an int32 scalar tensor, and the
schedule, the bias corrections and the clip scale are float32 tensors on
the parameters' device, so an update never waits on the host.

Updates write in place, under ``torch.no_grad()``: the parameters, the
state's tensors (the step counter too) and the gradients (scaled by the
clip). That is the counterpart of the reference's ``donate_argnums=0``
(``repro/launch/train.py``): the old state is not kept. The returned
params and state are the same dicts. ZeRO's ``zero_spec`` and
``opt_state_shardings`` come with the multi-card slice (ROADMAP).
"""
from __future__ import annotations

import dataclasses
import math

import torch

from .tree import tree_leaves, tree_map

__all__ = ["OptConfig", "schedule", "clip_by_global_norm", "adamw_init",
           "adamw_update", "adafactor_init", "adafactor_update", "opt_init",
           "opt_update"]


@dataclasses.dataclass(frozen=True)
class OptConfig:
    kind: str = "adamw"          # adamw | adafactor
    lr: float = 3e-4
    warmup: int = 100
    total_steps: int = 10_000
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    min_lr_frac: float = 0.1


def schedule(cfg: OptConfig, step):
    """Learning rate at ``step`` (an int or an integer tensor), float32."""
    s = torch.as_tensor(step).float()
    warm = torch.clamp(s / max(cfg.warmup, 1), max=1.0)
    t = torch.clamp((s - cfg.warmup) / max(cfg.total_steps - cfg.warmup, 1),
                    0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * t))
    frac = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * cos
    return cfg.lr * warm * frac


@torch.no_grad()
def clip_by_global_norm(grads, max_norm: float):
    """Scale ``grads`` in place to a global norm of at most ``max_norm``
    (each leaf through float32, rounded back to its dtype). Returns
    (grads, the norm before clipping)."""
    gn = torch.sqrt(sum(torch.sum(torch.square(g.float()))
                        for g in tree_leaves(grads)))
    scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-9), max=1.0)

    def one(g):
        if g.dtype == torch.float32:
            return g.mul_(scale)
        return g.copy_(g.float() * scale)
    return tree_map(one, grads), gn


def _step_device(params):
    return tree_leaves(params)[0].device


# ------------------------------------------------------------------- adamw
def adamw_init(params):
    f32 = lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    return {"m": tree_map(f32, params), "v": tree_map(f32, params),
            "master": tree_map(
                lambda p: p.detach().to(torch.float32, copy=True), params),
            "step": torch.zeros((), dtype=torch.int32,
                                device=_step_device(params))}


@torch.no_grad()
def adamw_update(cfg: OptConfig, params, grads, state):
    state["step"] += 1
    step = state["step"]
    lr = schedule(cfg, step)
    grads, gnorm = clip_by_global_norm(grads, cfg.clip_norm)
    b1, b2 = cfg.b1, cfg.b2
    bc1 = 1 - torch.pow(b1, step.float())
    bc2 = 1 - torch.pow(b2, step.float())

    def upd(p, g, m, v, master):
        g = g.float()
        m.mul_(b1).add_(g * (1 - b1))
        v.mul_(b2).add_(g * (1 - b2) * g)
        u = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
        if p.ndim >= 2:   # decoupled decay on matrices only
            u.add_(cfg.weight_decay * master)
        master.sub_(u.mul_(lr))
        p.copy_(master)

    tree_map(upd, params, grads, state["m"], state["v"], state["master"])
    return params, state, {"grad_norm": gnorm, "lr": lr}


# --------------------------------------------------------------- adafactor
def adafactor_init(params):
    def rows(p):
        shape = p.shape[:-1] if p.ndim >= 2 else p.shape
        return torch.zeros(shape, dtype=torch.float32, device=p.device)

    def cols(p):
        shape = p.shape[:-2] + p.shape[-1:] if p.ndim >= 2 else (1,)
        return torch.zeros(shape, dtype=torch.float32, device=p.device)

    return {"vr": tree_map(rows, params), "vc": tree_map(cols, params),
            "step": torch.zeros((), dtype=torch.int32,
                                device=_step_device(params))}


@torch.no_grad()
def adafactor_update(cfg: OptConfig, params, grads, state):
    state["step"] += 1
    step = state["step"]
    lr = schedule(cfg, step)
    grads, gnorm = clip_by_global_norm(grads, cfg.clip_norm)
    beta = 1.0 - torch.pow(step.float(), -0.8)

    def upd(p, g, vr, vc):
        g = g.float()
        g2 = g * g + 1e-30
        if p.ndim >= 2:
            vr.mul_(beta).add_((1 - beta) * g2.mean(-1))
            vc.mul_(beta).add_((1 - beta) * g2.mean(-2))
            denom = (vr[..., None] * vc[..., None, :]
                     / torch.clamp(vr.mean(-1)[..., None, None], min=1e-30))
            u = g * torch.rsqrt(denom + 1e-30)
        else:
            vr.mul_(beta).add_((1 - beta) * g2)
            u = g * torch.rsqrt(vr + 1e-30)
        # update clipping (Adafactor d=1.0)
        rms_u = torch.sqrt(torch.mean(u * u) + 1e-30)
        u = u / torch.clamp(rms_u, min=1.0)
        pf = p.float()
        if p.ndim >= 2:
            pf = pf * (1 - lr * cfg.weight_decay)
        p.copy_(pf - lr * u)

    tree_map(upd, params, grads, state["vr"], state["vc"])
    return params, state, {"grad_norm": gnorm, "lr": lr}


# ------------------------------------------------------------------ facade
def opt_init(cfg: OptConfig, params):
    return adamw_init(params) if cfg.kind == "adamw" else adafactor_init(params)


def opt_update(cfg: OptConfig, params, grads, state):
    if cfg.kind == "adamw":
        return adamw_update(cfg, params, grads, state)
    return adafactor_update(cfg, params, grads, state)
