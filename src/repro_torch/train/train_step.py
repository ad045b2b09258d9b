"""Train step: loss and gradients, microbatch accumulation and the
optimizer update — the port's counterpart of ``repro.train.train_step``.

Microbatches run one after another, their gradients summed in a float32
accumulator and divided by ``n_micro`` (the reference's ``lax.scan``); the
metrics are the last microbatch's. Optional int8 compression with error
feedback (``parallel.compression``) sits between accumulation and the
update, its float32 error kept in ``state["error_fb"]``.

``shard=`` (``parallel.sharding.shard``, under a ``ShardCtx``) is handed
to ``lm.forward``, which places the activations with it as the reference
does; without it the step runs with the identity. On DTensor state
(placed by ``param_shardings`` and ``opt_state_shardings``) the step runs
sharded; the accumulators take the parameters' placements. The update
writes the state in place (``train.optim``), as the reference donates
it.
"""
from __future__ import annotations

import torch

from ..models import lm
from ..models.config import ModelConfig
from ..parallel import compression as C
from . import optim as O
from .losses import loss_fn
from .tree import tree_leaves, tree_map

__all__ = ["init_state", "state_template", "make_train_step",
           "make_eval_step"]


def init_state(cfg: ModelConfig, opt_cfg: O.OptConfig,
               gen: torch.Generator):
    """Params from ``lm.init_params(cfg, gen)`` (on ``gen``'s device) and
    their optimizer state."""
    params = lm.init_params(cfg, gen)
    return {"params": params, "opt": O.opt_init(opt_cfg, params)}


def state_template(cfg: ModelConfig, opt_cfg: O.OptConfig):
    """:func:`init_state`'s keys, shapes and dtypes on the meta device
    (the reference's ``jax.eval_shape``): a template for
    ``checkpoint.restore``."""
    return init_state(cfg, opt_cfg, lm.MetaGenerator())


def _grads_of(params, cfg: ModelConfig, batch, shard=lm.NOSHARD):
    """(grads in each param's dtype, metrics) of ``loss_fn`` at
    ``params``; the params themselves stay out of autograd."""
    leaves = tree_map(lambda p: p.detach().requires_grad_(), params)
    with torch.enable_grad():
        loss, metrics = loss_fn(leaves, cfg, batch, shard)
        flat = tree_leaves(leaves)
        gs = torch.autograd.grad(loss, flat, allow_unused=True)
    by_id = {id(t): torch.zeros_like(t) if g is None else g
             for t, g in zip(flat, gs)}
    grads = tree_map(lambda t: by_id[id(t)], leaves)
    return grads, {k: v.detach() for k, v in metrics.items()}


def make_train_step(cfg: ModelConfig, opt_cfg: O.OptConfig, shard=None,
                    n_micro: int = 1, compress: bool = False):
    """Returns f(state, batch) -> (state', metrics); ``batch`` holds
    tensors on the state's device, batch first."""
    if shard is None:
        shard = lm.NOSHARD

    def step(state, batch):
        params = state["params"]
        if n_micro == 1:
            grads, metrics = _grads_of(params, cfg, batch, shard)
        else:
            grads = tree_map(lambda p: torch.zeros_like(
                p, dtype=torch.float32), params)
            for i in range(n_micro):
                mb = {k: v.reshape((n_micro, v.shape[0] // n_micro)
                                   + tuple(v.shape[1:]))[i]
                      for k, v in batch.items()}
                g, metrics = _grads_of(params, cfg, mb, shard)
                tree_map(lambda a, b: a.add_(b), grads, g)
                del g
            tree_map(lambda g: g.div_(n_micro), grads)
        if compress:
            eb = state.get("error_fb")
            if eb is None:
                eb = tree_map(lambda g: torch.zeros(
                    g.shape, dtype=torch.float32, device=g.device), grads)
            grads, eb = C.compress_grads_ef(grads, eb)
            state = dict(state, error_fb=eb)
        new_params, new_opt, om = O.opt_update(opt_cfg, params, grads,
                                               state["opt"])
        metrics = dict(metrics, **om)
        return dict(state, params=new_params, opt=new_opt), metrics

    return step


def make_eval_step(cfg: ModelConfig, shard=None):
    if shard is None:
        shard = lm.NOSHARD

    def step(params, batch):
        with torch.no_grad():
            _, metrics = loss_fn(params, cfg, batch, shard)
        return metrics
    return step
