"""Sharding rules: logical activation kinds and name-based parameter specs
— the port's counterpart of ``repro.parallel.sharding``.

Model code calls ``shard(x, kind)`` where the reference does; outside a
:class:`ShardCtx`, and for a plain tensor, that is the identity (the
reference's constraint on a one-device mesh places nothing either). For a
``DTensor`` it redistributes to the rule's placements. Parameter specs
are functions of a tree path, a shape and the mesh's axis sizes, with the
reference's divisibility checks: a dim shards over an axis only where
the axis size divides it, else it stays replicated.

Axes: batch-like dims shard over ("pod", "data") [present axes only],
tensor dims over "model" (Megatron TP / EP / vocab-parallel), optional
FSDP adds "data" on a weight dim.

A spec is a :class:`PartitionSpec`: a tuple of entries, each ``None``, an
axis name or a tuple of names, kept exactly as the rules build them (JAX
0.9's ``PartitionSpec`` normalises ``("data",)`` to ``"data"`` and
``()`` to ``None``; this one does not). :func:`to_placements` turns a spec
into a ``DeviceMesh``'s placements: a mesh dim that an entry names gives
``Shard(that entry's tensor dim)``, one that no entry names
``Replicate()``. A tuple entry shards major to minor in the mesh's order,
as JAX does, which is DTensor's order for several mesh dims on one
tensor dim.
"""
from __future__ import annotations

import re
import threading
from typing import Optional, Tuple

import torch
import torch.utils._pytree as pytree

from ..launch.mesh import mesh_axes
from .dtensor import strides

__all__ = ["PartitionSpec", "P", "NamedSharding", "batch_axes", "axis_size",
           "ShardCtx", "shard", "param_spec", "add_fsdp", "param_shardings",
           "batch_shardings", "cache_spec", "cache_shardings",
           "to_placements", "spec_names", "place", "placed_cache"]

_CTX = threading.local()


class PartitionSpec(tuple):
    """``jax.sharding.PartitionSpec``'s counterpart: one entry a tensor
    dim (trailing dims not listed are replicated)."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return "P" + super().__repr__()


P = PartitionSpec


def spec_names(entry) -> Tuple[str, ...]:
    """The axis names of one spec entry (``None`` names none)."""
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def to_placements(spec: PartitionSpec, mesh) -> tuple:
    """``DeviceMesh`` placements of ``spec`` over ``mesh``'s dims (any
    mesh of ``launch.mesh`` or a ``DeviceMesh``). Raises where a mesh dim
    is named twice, or where a tuple entry lists its axes out of the
    mesh's order (DTensor shards them major to minor in mesh order)."""
    from torch.distributed.tensor import Replicate, Shard
    names = list(mesh_axes(mesh))
    out = [Replicate()] * len(names)
    seen = set()
    for dim, e in enumerate(spec):
        axes = spec_names(e)
        pos = [names.index(a) for a in axes]
        if pos != sorted(pos):
            raise ValueError(f"spec entry {e!r} is not in the mesh's order "
                             f"{tuple(names)}")
        for a, i in zip(axes, pos):
            if a in seen:
                raise ValueError(f"mesh axis {a!r} named twice in {spec!r}")
            seen.add(a)
            out[i] = Shard(dim)
    return tuple(out)


class NamedSharding:
    """A spec on a mesh (``jax.sharding.NamedSharding``'s counterpart):
    ``.spec`` and the ``DeviceMesh`` placements it gives,
    ``.placements``."""

    __slots__ = ("mesh", "spec")

    def __init__(self, mesh, spec: PartitionSpec):
        self.mesh = mesh
        self.spec = spec

    @property
    def placements(self) -> tuple:
        return to_placements(self.spec, self.mesh)

    def __repr__(self):
        return f"NamedSharding({mesh_axes(self.mesh)}, {self.spec!r})"


def batch_axes(mesh) -> Tuple[str, ...]:
    axes = mesh_axes(mesh)
    return tuple(a for a in ("pod", "data") if a in axes)


def axis_size(mesh, *names: str) -> int:
    axes = mesh_axes(mesh)
    s = 1
    for n in names:
        if n in axes:
            s *= axes[n]
    return s


class ShardCtx:
    """Context manager installing activation-constraint rules for a
    mesh."""

    def __init__(self, mesh, fsdp: bool = False):
        self.mesh = mesh
        self.fsdp = fsdp
        ba = batch_axes(mesh)
        self.rules = {
            "bsd": P(ba, None, None),
            "bsv": P(ba, None, "model"),
            "becd": P(ba, "model", None, None),
            "bsec": P(ba, None, "model", None),
            "bec": P(ba, "model", None),
            "bhst": P(ba, "model", None, None),
        }

    def __enter__(self):
        _CTX.ctx = self
        return self

    def __exit__(self, *a):
        _CTX.ctx = None


def shard(x, kind: str):
    """``x`` placed by the active context's rule for ``kind``: a DTensor
    redistributed over its own mesh; anything else (a plain tensor, no
    context, an unknown kind) as it is."""
    ctx: Optional[ShardCtx] = getattr(_CTX, "ctx", None)
    if ctx is None:
        return x
    spec = ctx.rules.get(kind)
    if spec is None:
        return x
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x
    return x.redistribute(x.device_mesh, to_placements(spec, x.device_mesh))


# ------------------------------------------------------------------- params
def _div(n: int, k: int) -> bool:
    return k > 0 and n % k == 0


def _path_str(path) -> str:
    """``/``-joined keys of a ``torch.utils._pytree`` key path: dict keys
    (``MappingKey.key``), named-tuple fields (``GetAttrKey.name``) and
    sequence indices (``SequenceKey.idx``), as the reference joins JAX's."""
    out = []
    for p in path:
        if hasattr(p, "key"):
            out.append(str(p.key))
        elif hasattr(p, "name"):
            out.append(str(p.name))
        elif hasattr(p, "idx"):
            out.append(str(p.idx))
    return "/".join(out)


def param_spec(path: str, shape: Tuple[int, ...], mesh,
               fsdp: bool = False, hd_shard: bool = False) -> P:
    """Name+shape-based parameter partition spec.

    Layer-stacked params carry 1-2 leading stack dims which are never
    sharded; the rules match on the *trailing* dims. ``hd_shard``: when
    the head count doesn't divide the model axis, shard the head_dim
    instead (decode-specialised: replicated QKV/O weights dominate decode
    HBM traffic).
    """
    tp = axis_size(mesh, "model")
    nd = len(shape)

    def spec_tail(*tail):
        return P(*([None] * (nd - len(tail)) + list(tail)))

    # ---- embeddings / heads: vocab-parallel (replicate if not divisible)
    if re.search(r"(^|/)embed$", path) or re.search(r"lm_head$", path):
        if path.endswith("lm_head"):          # [d, V]
            return spec_tail(None, "model" if _div(shape[-1], tp) else None)
        return spec_tail("model" if _div(shape[-2], tp) else None, None)
    # ---- MoE experts: EP over model, [E, d, f] / [E, f, d]
    if re.search(r"moe/(wi|wg|wo)$", path) or re.search(r"/mtp/.*moe/(wi|wg|wo)$", path):
        if _div(shape[-3] if nd >= 3 else 0, tp):
            return spec_tail("model", None, None)
        return spec_tail(None, None, None)
    if re.search(r"moe/router(_bias)?$", path):
        return P(*([None] * nd))
    # ---- attention projections [d, H, hd] / [H, hd, d] (+ biases [H, hd])
    if re.search(r"(attn|cross|self)/w[qkv]$", path):
        H, hd = shape[-2], shape[-1]
        if _div(H, tp):
            return spec_tail(None, "model", None)
        if hd_shard and _div(hd, tp):
            return spec_tail(None, None, "model")
        return spec_tail(None, None, None)
    if re.search(r"(attn|cross|self)/b[qkv]$", path):
        H, hd = shape[-2], shape[-1]
        if _div(H, tp):
            return spec_tail("model", None)
        if hd_shard and _div(hd, tp):
            return spec_tail(None, "model")
        return spec_tail(None, None)
    if re.search(r"(attn|cross|self)/wo$", path):
        H, hd = shape[-3], shape[-2]          # [.., H, hd, d] uniformly
        if _div(H, tp):
            return spec_tail("model", None, None)
        if hd_shard and _div(hd, tp):
            return spec_tail(None, "model", None)
        return spec_tail(None, None, None)
    # ---- MLA
    if re.search(r"attn/wuq$", path) or re.search(r"attn/wukv$", path):
        H = shape[-2]
        return spec_tail(None, "model" if _div(H, tp) else None, None)
    if re.search(r"attn/(wdq|wdkv|wkr)$", path):
        return spec_tail(None, None)
    # ---- dense MLP [d, f] / [f, d]
    if re.search(r"mlp/(wi|wg)$", path) or re.search(r"shared/(wi|wg)$", path):
        return spec_tail(None, "model" if _div(shape[-1], tp) else None)
    if re.search(r"mlp/wo$", path) or re.search(r"shared/wo$", path):
        return spec_tail("model" if _div(shape[-2], tp) else None, None)
    # ---- mamba
    if re.search(r"mixer/in_proj$", path):
        return spec_tail(None, "model" if _div(shape[-1], tp) else None)
    if re.search(r"mixer/out_proj$", path):
        return spec_tail("model" if _div(shape[-2], tp) else None, None)
    if re.search(r"mixer/(x_proj|dt_w)$", path):
        return spec_tail("model" if _div(shape[-2], tp) else None, None)
    if re.search(r"mixer/(conv_w|conv_b|dt_b|A_log|D|norm_w)$", path):
        return P(*([None] * nd))
    # ---- projectors / positions / norms / everything else: replicated
    return P(*([None] * nd))


def _validate(spec: P, shape, mesh) -> P:
    """Drop any spec entry whose axis size doesn't divide the dim (the
    reference's pjit input shardings require exact divisibility)."""
    entries = list(spec) + [None] * (len(shape) - len(spec))
    out = []
    for e, n in zip(entries, shape):
        if e is None:
            out.append(None)
            continue
        k = axis_size(mesh, *spec_names(e))
        out.append(e if (k and n % k == 0) else None)
    return P(*out)


def add_fsdp(spec: P, shape, mesh, axis: str = "data") -> P:
    """ZeRO-3/FSDP: additionally shard one free dim over the data axis.
    Stack dims (dim 0 of rank>=3 stacked params) are skipped so per-layer
    slicing stays trivial; the biggest free divisible dim wins."""
    axes = mesh_axes(mesh)
    if axis not in axes:
        return spec
    k = axes[axis]
    if k <= 1:
        return spec
    entries = list(spec) + [None] * (len(shape) - len(spec))
    cands = sorted(range(len(shape)), key=lambda i: -shape[i])
    for i in cands:
        if i == 0 and len(shape) >= 3:
            continue
        if entries[i] is None and shape[i] % k == 0 and shape[i] >= k:
            entries[i] = axis
            return P(*entries)
    return P(*entries)


def param_shardings(params, mesh, fsdp: bool = False,
                    hd_shard: bool = False):
    """Tree of :class:`NamedSharding` matching ``params`` (works on the
    meta tree of ``lm.param_shapes``)."""
    def one(path, leaf):
        shape = tuple(leaf.shape)
        spec = param_spec(_path_str(path), shape, mesh, fsdp,
                          hd_shard=hd_shard)
        spec = _validate(spec, shape, mesh)
        if fsdp:
            spec = add_fsdp(spec, shape, mesh)
        return NamedSharding(mesh, spec)
    return pytree.tree_map_with_path(one, params)


def batch_shardings(batch, mesh):
    ba = batch_axes(mesh)

    def one(leaf):
        shape = tuple(leaf.shape)
        spec = P(*([ba] + [None] * (len(shape) - 1)))
        return NamedSharding(mesh, _validate(spec, shape, mesh))
    return pytree.tree_map(one, batch)


# --------------------------------------------------------------- kv caches
def cache_spec(path: str, shape: Tuple[int, ...], mesh) -> P:
    """Decode-cache specs: batch over ("pod", "data"); kv-heads over
    "model" when divisible, else the *sequence* dim shards over "model"
    (flash-decoding-style partial softmax)."""
    tp = axis_size(mesh, "model")
    ba = batch_axes(mesh)
    nd = len(shape)
    dpp = axis_size(mesh, *ba)
    # identify [.., B, S, kv, hd] attention caches by rank+name
    if re.search(r"(^|/)(k|v)$", path) and nd >= 4:
        B, S, KV = shape[-4], shape[-3], shape[-2]
        lead = [None] * (nd - 4)
        bspec = ba if _div(B, dpp) else None
        if _div(KV, tp):
            return P(*lead, bspec, None, "model", None)
        return P(*lead, bspec, "model" if _div(S, tp) else None, None, None)
    if re.search(r"(ckv|krope)$", path) and nd >= 3:   # MLA latent [L,B,S,r]
        B, S = shape[-3], shape[-2]
        lead = [None] * (nd - 3)
        bspec = ba if _div(B, dpp) else None
        return P(*lead, bspec, "model" if _div(S, tp) else None, None)
    if re.search(r"(conv|ssm)$", path) and nd >= 3:    # mamba states
        B = shape[-3] if nd >= 3 else 0
        # [.., B, C, K] conv / [.., B, d, s] or [.., B, nh, hp, s] ssm
        lead = [None] * (nd - 3)
        bspec = ba if _div(B, dpp) else None
        c = shape[-2]
        return P(*lead, bspec, "model" if _div(c, tp) else None, None)
    if re.search(r"cross_[kv]$", path) and nd >= 4:
        B, S, KV = shape[-4], shape[-3], shape[-2]
        lead = [None] * (nd - 4)
        bspec = ba if _div(B, dpp) else None
        if _div(KV, tp):
            return P(*lead, bspec, None, "model", None)
        return P(*lead, bspec, "model" if _div(S, tp) else None, None, None)
    return P(*([None] * nd))


def place(meta, sharding: NamedSharding, dmesh, device, zero: bool = False):
    """A DTensor of ``meta``'s global shape and dtype placed by
    ``sharding`` on the ``DeviceMesh`` ``dmesh``, its local shard a new
    tensor on ``device`` (uninitialised, or zeros with ``zero``; a fake
    one under ``FakeTensorMode``). The specs' sharded dims divide."""
    from torch.distributed.tensor import DTensor, Shard
    pl = sharding.placements
    shape = tuple(meta.shape)
    local = list(shape)
    for md, p in enumerate(pl):
        if isinstance(p, Shard):
            local[p.dim] //= dmesh.size(md)
    new = torch.zeros if zero else torch.empty
    return DTensor.from_local(new(local, dtype=meta.dtype, device=device),
                              dmesh, pl, run_check=False,
                              shape=torch.Size(shape), stride=strides(shape))


def placed_cache(make, like):
    """``make(device)``'s zero cache; where ``like`` is a DTensor, placed
    by :func:`cache_shardings` on its mesh (each rank holds its shard)."""
    from torch.distributed.tensor import DTensor
    if not isinstance(like, DTensor):
        return make(like.device)
    dmesh = like.device_mesh
    meta = make("meta")
    sh = cache_shardings(meta, dmesh)
    return pytree.tree_map(
        lambda m, s: place(m, s, dmesh, like.device, zero=True), meta, sh,
        is_leaf=lambda t: isinstance(t, NamedSharding))


def cache_shardings(cache, mesh):
    def one(path, leaf):
        shape = tuple(leaf.shape)
        spec = cache_spec(_path_str(path), shape, mesh)
        return NamedSharding(mesh, _validate(spec, shape, mesh))
    return pytree.tree_map_with_path(one, cache)
