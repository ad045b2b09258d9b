"""Shared layer primitives: inits, norms, MLPs, rotary embeddings — the
port's counterpart of ``repro.models.layers``.

Parameters are plain nested dicts of tensors keyed as the reference's
pytree. Inits draw from an explicit ``torch.Generator`` (the reference's
``jax.random`` keys); the generator's device is the parameters' device.
Compute runs in the parameters' dtype with float32 norm and rotary math,
step for step as the reference does.
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

Params = Dict[str, object]

__all__ = ["Params", "NOSHARD", "dense_init", "embed_init", "rms_norm",
           "layer_norm", "norm_params", "apply_norm", "mlp_params",
           "mlp_apply", "rope_freqs", "rope_apply", "softmax_xent"]


def NOSHARD(x, kind: str):
    """The activation-placement hook outside a mesh: the identity
    (``parallel.sharding.shard`` places within one)."""
    return x


def _trunc_normal(gen: torch.Generator, shape, std: float, dtype):
    """Standard normal truncated to [-2, 2], drawn in float32, times
    ``std``, cast to ``dtype`` (``jax.random.truncated_normal(key, -2, 2)``
    in the reference)."""
    t = torch.empty(shape, dtype=torch.float32, device=gen.device)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return t.mul_(std).to(dtype)


def dense_init(gen: torch.Generator, d_in: int, *dims, dtype,
               scale: float = 1.0):
    """Truncated-normal fan-in init, shape [d_in, *dims]."""
    return _trunc_normal(gen, (d_in,) + dims, scale / (d_in ** 0.5), dtype)


def embed_init(gen: torch.Generator, vocab: int, d: int, dtype):
    return _trunc_normal(gen, (vocab, d), 0.02, dtype)


# ------------------------------------------------------------------ norms
def rms_norm(x, w, eps: float):
    h = x.float()
    h = h * torch.rsqrt(torch.mean(h * h, dim=-1, keepdim=True) + eps)
    return (h * (1.0 + w.float())).to(x.dtype)


def layer_norm(x, w, b, eps: float):
    h = x.float()
    mu = torch.mean(h, dim=-1, keepdim=True)
    var = torch.mean(torch.square(h - mu), dim=-1, keepdim=True)
    h = (h - mu) * torch.rsqrt(var + eps)
    return (h * w.float() + b.float()).to(x.dtype)


def norm_params(gen, d: int, kind: str, dtype) -> Params:
    dev = gen.device
    if kind == "rms":
        return {"w": torch.zeros((d,), dtype=dtype, device=dev)}
    return {"w": torch.ones((d,), dtype=dtype, device=dev),
            "b": torch.zeros((d,), dtype=dtype, device=dev)}


def apply_norm(x, p: Params, kind: str, eps: float):
    if kind == "rms":
        return rms_norm(x, p["w"], eps)
    return layer_norm(x, p["w"], p["b"], eps)


# ------------------------------------------------------------------ MLPs
def mlp_params(gen, d: int, ff: int, kind: str, dtype) -> Params:
    if kind in ("swiglu", "geglu"):
        return {"wi": dense_init(gen, d, ff, dtype=dtype),
                "wg": dense_init(gen, d, ff, dtype=dtype),
                "wo": dense_init(gen, ff, d, dtype=dtype)}
    return {"wi": dense_init(gen, d, ff, dtype=dtype),
            "wo": dense_init(gen, ff, d, dtype=dtype)}


def mlp_apply(p: Params, x, kind: str):
    if kind == "swiglu":
        h = F.silu(x @ p["wg"]) * (x @ p["wi"])
    elif kind == "geglu":
        h = F.gelu(x @ p["wg"], approximate="tanh") * (x @ p["wi"])
    elif kind == "relu2":   # nemotron squared-ReLU
        h = torch.square(F.relu(x @ p["wi"]))
    else:                   # gelu (whisper)
        h = F.gelu(x @ p["wi"], approximate="tanh")
    return h @ p["wo"]


# ------------------------------------------------------------------ rotary
def rope_freqs(positions, head_dim: int, theta: float):
    """positions [...,] -> (sin, cos) each [..., head_dim/2] float32."""
    half = head_dim // 2
    inv = 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32,
                                        device=positions.device) / half))
    ang = positions.float()[..., None] * inv
    return torch.sin(ang), torch.cos(ang)


def rope_apply(x, sin, cos):
    """x [..., S, n, head_dim]; sin/cos [..., S, head_dim/2] (broadcast on n)."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    sin = sin[..., None, :]
    cos = cos[..., None, :]
    x1f, x2f = x1.float(), x2.float()
    return torch.cat([x1f * cos - x2f * sin,
                      x2f * cos + x1f * sin], dim=-1).to(x.dtype)


# ------------------------------------------------------------------ loss
def _vocab_sharded(t) -> bool:
    from torch.distributed.tensor import DTensor, Shard
    return isinstance(t, DTensor) and any(
        isinstance(p, Shard) and p.dim == t.ndim - 1 for p in t.placements)


def _xent_vocab_parallel(logits, labels):
    """Mean cross entropy of vocab-sharded DTensor logits [..., V]
    (Megatron's vocab-parallel form), on each rank's shard: the max over
    the vocab (an all-reduce of the shards' maxima), each shard's sum of
    exponentials and the label's logit on the shard that holds it (0 on
    the others), the last two summed over the vocab's mesh dims. Batch
    shards stay; any other placement of the logits is replicated."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    from ..parallel.dtensor import partial_sum, shard_index, strides
    mesh = logits.device_mesh
    nd = logits.ndim
    vocab = [isinstance(p, Shard) and p.dim == nd - 1
             for p in logits.placements]
    pl = [p if isinstance(p, Shard) and p.dim in (0, nd - 1) else Replicate()
          for p in logits.placements]
    row_pl = [Shard(0) if isinstance(p, Shard) and p.dim == 0
              else Replicate() for p in pl]
    sum_pl = [Partial() if v else p for v, p in zip(vocab, row_pl)]
    shape = logits.shape[:-1]
    local = logits.redistribute(mesh, pl).to_local().float()
    m = DTensor.from_local(
        local.detach().amax(-1), mesh,
        [Partial("max") if v else p for v, p in zip(vocab, row_pl)],
        run_check=False, shape=shape, stride=strides(shape))
    m = m.redistribute(mesh, row_pl)
    se = partial_sum(torch.exp(local - m.to_local()[..., None]).sum(-1),
                     mesh, sum_pl, shape)
    vl = local.shape[-1]
    lab = labels.redistribute(mesh, row_pl).to_local().long() \
        - shard_index(mesh, vocab) * vl
    ok = (lab >= 0) & (lab < vl)
    got = torch.gather(local, -1, lab.clamp(0, vl - 1)[..., None])[..., 0]
    got = partial_sum(torch.where(ok, got, 0.0), mesh, sum_pl, shape)
    return torch.mean(m + torch.log(se) - got)


def softmax_xent(logits, labels, mask=None):
    """Cross entropy with a float32 logsumexp.

    logits [..., V] (any float dtype), labels int [...]. Returns the mean
    loss (over ``mask``'s true entries when given). Logits that are a
    ``DTensor`` with the vocab sharded (``shard(.., "bsv")``) take the
    vocab-parallel form (:func:`_xent_vocab_parallel`): DTensor cannot
    gather a label across vocab shards.
    """
    if mask is None and _vocab_sharded(logits):
        return _xent_vocab_parallel(logits, labels)
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
    lab = torch.gather(lf, -1, labels[..., None].long())[..., 0]
    nll = lse - lab
    if mask is not None:
        m = mask.float()
        return torch.sum(nll * m) / torch.clamp(torch.sum(m), min=1.0)
    return torch.mean(nll)
