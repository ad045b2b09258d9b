"""Running the model on DTensors: the pieces DTensor's own sharding
rules do not cover, each a plain-tensor identity or a no-op outside a
DTensor (so every single-card result stays bit for bit).

- Views: :func:`fit_split` before a view splits a sharded dim unevenly,
  :func:`heads_in` / :func:`heads_out` for the attention projections
  (never flattening a shard of head_dim under the heads), and
  :class:`Reshard`, a dispatch mode that replicates a shard a view would
  merge under another dim (a strided shard no product takes).
- Per-shard computation (:func:`local_call`, :func:`rowwise`): work that
  is independent across batch rows or channels (MoE slot bookkeeping,
  the mamba scans, attention) runs on each rank's shard;
  :func:`partial_sum` and :func:`embed_lookup` / the vocab-parallel loss
  sum per-rank terms over the vocab's shards.
- FSDP (:func:`fsdp_gather`): a layer's weights gathered before use, the
  gradient reduce-scattered back.
- Caches: :func:`write_rows` (a decode step's row on the rank holding
  it), :func:`pad` (a cache padded on each rank's shard).
"""
from __future__ import annotations

import math

import torch
import torch.utils._pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode

__all__ = ["fit_split", "heads_in", "heads_out", "strides", "shard_index",
           "partial_sum", "embed_lookup", "local_call", "batch_placements",
           "rowwise", "Reshard", "fsdp_gather", "pad", "write_rows"]


def fit_split(x, dim: int, n: int):
    """``x`` ready to have its dim ``dim`` split into ``n`` leading parts
    (a view ``[..., n, m, ...]``): a DTensor with that dim sharded over a
    mesh dim whose size does not divide ``n`` is replicated over that mesh
    dim (DTensor cannot unflatten an uneven shard); anything else as it
    is."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    if not isinstance(x, DTensor):
        return x
    dim %= x.ndim
    mesh = x.device_mesh
    pl = [Replicate() if isinstance(p, Shard) and p.dim == dim
          and n % mesh.size(i) else p for i, p in enumerate(x.placements)]
    if pl == list(x.placements):
        return x
    return _Replaced.apply(x, tuple(pl))


def _sharded_dims(x):
    """{tensor dim: [mesh dims sharding it]} of a DTensor; {} for a plain
    tensor."""
    from torch.distributed.tensor import Shard
    out = {}
    for md, p in enumerate(getattr(x, "placements", ())):
        if isinstance(p, Shard):
            out.setdefault(p.dim, []).append(md)
    return out


def _gather_dims(x, dims):
    """``x`` with its shards of tensor dims ``dims`` replicated (FSDP's
    gather of a weight before its use; the gradient goes back onto the
    shards)."""
    from torch.distributed.tensor import Replicate, Shard
    pl = [Replicate() if isinstance(p, Shard) and p.dim in dims else p
          for p in x.placements]
    if pl == list(x.placements):
        return x
    return x.redistribute(x.device_mesh, pl)


def heads_in(x, w):
    """``x [..., d] @ w [d, n, h] -> [..., n, h]`` (the einsum
    ``bsd,dnh->bsnh``). For a DTensor weight, never flattening a shard of
    h under n (a strided shard no product takes): with h sharded and n
    not, the product runs over ``[d, h, n]`` and the result is permuted
    back; with both sharded, h's shards are gathered first."""
    d, n, h = w.shape
    sh = _sharded_dims(w)
    if 2 in sh and 1 not in sh:
        y = x @ w.permute(0, 2, 1).reshape(d, h * n)
        y = fit_split(y, -1, h).reshape(*x.shape[:-1], h, n)
        return y.transpose(-1, -2)
    if 2 in sh:
        w = _gather_dims(w, (2,))
    y = fit_split(x @ w.reshape(d, n * h), -1, n)
    return y.reshape(*x.shape[:-1], n, h)


def heads_out(flat, wo):
    """``flat [B, S, n*h] @ wo [n, h, d] -> [B, S, d]``; for a DTensor
    weight, as :func:`heads_in` keeps h's shards (over ``[h, n, d]``)."""
    n, h, d = wo.shape
    B, S = flat.shape[:2]
    sh = _sharded_dims(wo)
    x = fit_split(flat, -1, n).reshape(B, S, n, h)
    if 1 in sh and 0 not in sh:
        return x.transpose(-1, -2).reshape(B, S, h * n) \
            @ wo.permute(1, 0, 2).reshape(h * n, d)
    if 1 in sh:
        wo = _gather_dims(wo, (1,))
    return x.reshape(B, S, n * h) @ wo.reshape(n * h, d)


class _Replaced(torch.autograd.Function):
    """``x.redistribute(placements)`` whose gradient keeps those
    placements too (``redistribute``'s own backward would take it back to
    x's, where the split's gradient cannot be viewed either)."""

    @staticmethod
    def forward(ctx, x, placements):
        ctx.placements = placements
        return x.redistribute(x.device_mesh, placements)

    @staticmethod
    def backward(ctx, g):
        return g.redistribute(g.device_mesh, ctx.placements), None


def strides(shape) -> tuple:
    """The contiguous strides of ``shape``."""
    out, acc = [], 1
    for n in reversed(tuple(shape)):
        out.append(acc)
        acc *= max(n, 1)
    return tuple(reversed(out))


def shard_index(mesh, dims) -> int:
    """Which shard of a tensor dim this rank holds, where ``dims[md]``
    says whether mesh dim ``md`` shards it (major to minor in the mesh's
    order, as DTensor shards)."""
    i = 0
    for md, on in enumerate(dims):
        if on:
            i = i * mesh.size(md) + mesh.get_local_rank(md)
    return i


class _PartialSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, local, mesh, placements, shape):
        from torch.distributed.tensor import DTensor, Partial, Replicate
        ctx.grad_pl = [Replicate() if isinstance(p, Partial) else p
                       for p in placements]
        return DTensor.from_local(local, mesh, placements, run_check=False,
                                  shape=torch.Size(shape),
                                  stride=strides(shape))

    @staticmethod
    def backward(ctx, g):
        return g.redistribute(g.device_mesh, ctx.grad_pl).to_local(), \
            None, None, None


def partial_sum(local, mesh, placements, shape):
    """Each rank's ``local`` term as one DTensor of global ``shape`` whose
    value is their sum over the mesh dims ``placements`` marks
    ``Partial()``; its gradient reaches every rank's term whole
    (``DTensor.from_local``'s own backward would split it)."""
    return _PartialSum.apply(local, mesh, list(placements), tuple(shape))


def embed_lookup(table, tokens):
    """``table[tokens]`` for a DTensor table [V, d] whose vocab may be
    sharded: each rank looks its tokens up in its vocab shard (rows it
    does not hold are 0) and the rows are summed over the vocab's mesh
    dims (DTensor would gather the whole table). The table's other shards
    (FSDP's) are gathered first; the tokens keep their batch shards. A
    plain table is indexed as it is."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    if not isinstance(table, DTensor):
        return table[tokens.long()]
    mesh = table.device_mesh
    vocab = [isinstance(p, Shard) and p.dim == 0 for p in table.placements]
    tok_pl = [Shard(0) if not v and isinstance(p, Shard) and p.dim == 0
              else Replicate() for v, p in zip(vocab, tokens.placements)]
    # over the tokens' batch shards each rank's table gradient is a term
    # of the whole (its own tokens' rows)
    grad_pl = [Shard(0) if v else Partial() if t.is_shard() else Replicate()
               for v, t in zip(vocab, tok_pl)]
    tab = table.redistribute(mesh, [Shard(0) if v else Replicate()
                                    for v in vocab]
                             ).to_local(grad_placements=grad_pl)
    vl = tab.shape[0]
    idx = tokens.redistribute(mesh, tok_pl).to_local().long() \
        - shard_index(mesh, vocab) * vl
    ok = (idx >= 0) & (idx < vl)
    rows = torch.where(ok[..., None], tab[idx.clamp(0, vl - 1)], 0.0)
    out_pl = [Partial() if v else p for v, p in zip(vocab, tok_pl)]
    return partial_sum(rows.to(tab.dtype), mesh, out_pl,
                       tuple(tokens.shape) + (table.shape[1],))


def local_call(fn, args, in_pl, out_pl, grad_pl=None):
    """``fn`` on each rank's shards (``torch``'s ``local_map``, kept here
    so the port holds one version of it): DTensor ``args[i]`` is placed
    as ``in_pl[i]`` (one placement a mesh dim; ``None`` leaves a plain
    argument alone) and handed over local, its gradient taken as
    ``grad_pl[i]`` (``Partial()`` where each rank's gradient is a term of
    the whole, as a replicated weight's over the batch's mesh dims); the
    tensors ``fn`` returns are wrapped as DTensors placed ``out_pl``
    (one list for every output, or one list an output), global shapes
    from their local ones."""
    from torch.distributed.tensor import DTensor, Shard
    mesh = next(a.device_mesh for a in args if isinstance(a, DTensor))
    grad_pl = grad_pl or in_pl
    local = []
    for a, pl, gpl in zip(args, in_pl, grad_pl):
        if isinstance(a, DTensor):
            a = a.redistribute(mesh, pl).to_local(grad_placements=gpl)
        local.append(a)
    out = fn(*local)

    per_out = bool(out_pl) and isinstance(out_pl[0], (list, tuple))

    def wrap(t, pl):
        if not isinstance(t, torch.Tensor):
            return t
        t = t.contiguous()          # the DTensor's strides are contiguous
        shape = list(t.shape)
        for md, p in enumerate(pl):
            if isinstance(p, Shard):
                shape[p.dim] *= mesh.size(md)
        return DTensor.from_local(t, mesh, pl, run_check=False,
                                  shape=torch.Size(shape),
                                  stride=strides(shape))
    if isinstance(out, tuple):
        return tuple(wrap(t, out_pl[i] if per_out else out_pl)
                     for i, t in enumerate(out))
    return wrap(out, out_pl[0] if per_out else out_pl)


def batch_placements(x):
    """``x``'s batch shards (``Shard(0)``), every other mesh dim
    replicated."""
    from torch.distributed.tensor import Replicate, Shard
    return [Shard(0) if isinstance(p, Shard) and p.dim == 0 else Replicate()
            for p in x.placements]


def rowwise(fn, *args, whole=()):
    """``fn(*args)`` where ``fn`` treats each batch row (dim 0) on its own:
    with DTensor arguments, on each rank's rows (:func:`local_call`; the
    batch-shaped arguments placed as the first one's batch shards; those
    at the indices ``whole`` (weights) replicated, their gradient summed
    over the batch's mesh dims), the tensors it returns placed by those
    rows. For bookkeeping DTensor has no rules for (sorts and scatters by
    index); autograd runs through it."""
    from torch.distributed.tensor import DTensor, Partial, Replicate
    first = next((a for i, a in enumerate(args)
                  if isinstance(a, DTensor) and i not in whole), None)
    if first is None:
        return fn(*args)
    pl = batch_placements(first)
    rep = [Replicate()] * len(pl)
    wgrad = [Partial() if not p.is_replicate() else Replicate() for p in pl]
    in_pl = [rep if i in whole else pl for i in range(len(args))]
    grad_pl = [wgrad if i in whole else pl for i in range(len(args))]
    return local_call(fn, args, in_pl, pl, grad_pl)


_VIEWS = ("view", "_unsafe_view", "reshape")


def _merged_minor_dims(in_shape, out_shape) -> set:
    """The dims of ``in_shape`` that a view to ``out_shape`` merges under
    a dim before them (a shard of such a dim becomes a strided shard), and
    the size-1 dims it merges with another (DTensor drops a shard of
    those)."""
    out, i, j = set(), 0, 0
    n, m = len(in_shape), len(out_shape)
    while i < n and j < m:
        gi, gj = [i], [j]
        pi, pj = in_shape[i], out_shape[j]
        while pi != pj:
            if pi < pj:
                i += 1
                gi.append(i)
                pi *= in_shape[i]
            else:
                j += 1
                gj.append(j)
                pj *= out_shape[j]
        big = [d for d in gi if in_shape[d] != 1]
        out.update(big[1:])
        if len(gi) > 1:
            out.update(d for d in gi if in_shape[d] == 1)
        i, j = i + 1, j + 1
    return out


def _no_strided_view(func, args):
    """``args`` with the view's input replicated over the mesh dims that
    shard a dim the view would merge under another (DTensor makes a
    strided shard of it, which no product takes and, under fake tensors,
    no redistribution undoes)."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    x = args[0]
    if not isinstance(x, DTensor) or len(args) < 2:
        return args
    shape = args[1]
    if -1 in shape:
        known = math.prod(d for d in shape if d != -1)
        shape = [x.numel() // known if d == -1 else d for d in shape]
    merged = _merged_minor_dims(list(x.shape), list(shape))
    pl = [Replicate() if isinstance(p, Shard) and p.dim in merged else p
          for p in x.placements]
    if pl == list(x.placements):
        return args
    return (x.redistribute(x.device_mesh, pl),) + tuple(args[1:])


class Reshard(TorchDispatchMode):
    """Where a view would merge a sharded dim under another (DTensor makes
    that a strided shard, which no product takes and, under fake tensors,
    no redistribution undoes), replicate that shard first: what an SPMD
    partitioner does by inserting a reshard. ``counts`` holds, per view
    op, how many times it did (``"view:merge"``). Every other op runs as
    DTensor places it; one it cannot place raises (a dry run's cell
    records that as its error, the op named)."""

    def __init__(self):
        super().__init__()
        self.counts = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        name = func._schema.name.split("::")[-1]
        if name in _VIEWS and any(issubclass(t, DTensor) for t in types):
            new = _no_strided_view(func, args)
            if new is not args:
                key = f"{name}:merge"
                self.counts[key] = self.counts.get(key, 0) + 1
                args = new
        return func(*args, **(kwargs or {}))


def fsdp_gather(tree):
    """Every DTensor of ``tree`` (a layer's weights) with its shards over
    the batch's mesh dims (``"pod"``, ``"data"``: FSDP's) gathered, as
    FSDP gathers a layer's weights before running it; the gradient
    reduce-scatters back onto those shards. Plain tensors and other
    shards as they are. (Left to itself, DTensor may instead gather the
    activations over those dims, the whole global batch.)"""
    from torch.distributed.tensor import DTensor, Replicate

    def one(t):
        if not isinstance(t, DTensor):
            return t
        names = t.device_mesh.mesh_dim_names or ()
        pl = [Replicate() if names[md] in ("pod", "data") else p
              for md, p in enumerate(t.placements)]
        if pl == list(t.placements):
            return t
        return t.redistribute(t.device_mesh, pl)
    return pytree.tree_map(one, tree)


def pad(x, widths):
    """``F.pad(x, widths)`` (zeros; ``widths`` from the last dim back).
    For a DTensor, on each rank's shard: the padded dims' shards are
    replicated first, the others kept (DTensor's own pad redistributes
    through paths some releases cannot take)."""
    import torch.nn.functional as F
    from torch.distributed.tensor import DTensor, Replicate, Shard
    if not isinstance(x, DTensor):
        return F.pad(x, widths)
    dims = {x.ndim - 1 - i // 2 for i, w in enumerate(widths) if w}
    pl = [Replicate() if isinstance(p, Shard) and p.dim in dims
          else p for p in x.placements]
    return local_call(lambda t: F.pad(t, widths), (x,), [pl], pl)


def write_rows(cache, pos, rows) -> None:
    """``cache[b, pos[b]] = rows[b]`` for every sequence b, in place:
    cache [B, S_max, ...], pos [B], rows [B, ...] in the cache's dtype.
    For a DTensor cache (batch, sequence and trailing dims sharded, as
    :func:`cache_spec` places them) each rank writes its shard: the rows
    of its sequences whose position falls in its slice of S_max (DTensor
    cannot index_put across shards)."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    if not isinstance(cache, DTensor):
        bidx = torch.arange(cache.shape[0], device=cache.device)
        cache.index_put_((bidx, pos.long()), rows)
        return
    mesh = cache.device_mesh
    row_pl = []
    pos_pl = []
    seq = []
    for md, p in enumerate(cache.placements):
        if isinstance(p, Shard) and p.dim == 1:
            seq.append(md)
            row_pl.append(Replicate())
            pos_pl.append(Replicate())
        elif isinstance(p, Shard):
            row_pl.append(Shard(p.dim - 1 if p.dim > 1 else 0))
            pos_pl.append(Shard(0) if p.dim == 0 else Replicate())
        else:
            row_pl.append(Replicate())
            pos_pl.append(Replicate())
    c = cache.to_local()
    r = rows.redistribute(mesh, row_pl).to_local() \
        if isinstance(rows, DTensor) else rows
    p = pos.redistribute(mesh, pos_pl).to_local() \
        if isinstance(pos, DTensor) else pos
    s_local = c.shape[1]
    offset = 0
    for md in seq:
        offset = offset * mesh.size(md) + mesh.get_local_rank(md)
    p = p.long() - offset * s_local
    inside = (p >= 0) & (p < s_local)
    p = p.clamp(0, s_local - 1)
    bidx = torch.arange(c.shape[0], device=c.device)
    keep = inside.reshape((-1,) + (1,) * (r.ndim - 1))
    c.index_put_((bidx, p), torch.where(keep, r, c[bidx, p]))
