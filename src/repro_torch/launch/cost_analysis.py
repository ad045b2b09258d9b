"""Per-device cost of a traced step: FLOPs, HBM traffic, collectives,
live bytes, and the roofline made of them — the port's counterpart of
``repro.launch.hlo_analysis``.

The reference parses the optimized HLO of a compiled SPMD program. The
port has no compiler between the model and the card, so
:class:`CostCounter` (a ``TorchDispatchMode``) watches the aten ops of one
eager call instead, on DTensors of fake tensors (a dry run) or on real
tensors (a step on the card), and aggregates

  flops       — ``mm``/``bmm``/``addmm``/``baddbmm``/``convolution`` (and
                its backward) at 2 x MACs, and K5's forward by its FLOP
                formula (``kernels.flash_attention.ops.flop_count``);
                elementwise excluded, as in the reference
  traffic     — Σ (operand + result bytes) of every op that moves data,
                on the local shards: an unfused upper bound, as the
                reference's is (views move nothing; a slice counts its
                own bytes, not its base's)
  collectives — per kind: count, payload bytes (the result's), ring-model
                wire bytes, as ``hlo_analysis`` computes them
  live bytes  — the peak of the storages the call allocates (fake
                storages too), beside the bytes of its arguments

Per device, for a DTensor op: a dispatch mode sees the global op (its
shapes are the global shapes), so its FLOPs are divided by the sizes of
the mesh dims over which its output is ``Shard`` or ``Partial``: the work
a ``Replicate`` mesh dim repeats on every rank is counted whole. Its
traffic is the bytes of its operands' and results' local shards. Ops on
plain tensors (outside a DTensor, or the shards an op such as K5's runs
on) count as they are. The collectives a DTensor op issues run inside its
dispatch, on local shards, and are seen by a second mode pushed for that
op, which counts collectives only (DTensor also runs ops on global fake
tensors there to propagate shapes; those are not work).

Hardware constants are the H100 SXM datasheet's, not measurements:
989.4 TFLOP/s dense bf16, 3.35 TB/s HBM3. For the wire, one per-device
number: 50 GB/s, a GPU's 400 Gb/s NDR InfiniBand link, since a 16-wide
mesh axis spans two 8-GPU NVLink nodes (NVLink 4's 450 GB/s a direction
inside a node is not modelled).
"""
from __future__ import annotations

import sys
import weakref
from typing import Dict, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

__all__ = ["PEAK_FLOPS", "HBM_BW", "NET_BW", "CostCounter",
           "roofline", "count_ops", "flops_of", "COLLECTIVES"]

PEAK_FLOPS = 989.4e12       # H100 SXM, dense bf16 (datasheet)
HBM_BW = 3.35e12            # H100 SXM, HBM3 (datasheet)
NET_BW = 50e9               # 400 Gb/s NDR InfiniBand a GPU

COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")

_aten = torch.ops.aten
# ops that move no bytes: metadata, aliases, uninitialised allocations
_NO_TRAFFIC = {"detach", "alias", "lift_fresh", "empty", "empty_like",
               "empty_strided", "new_empty", "new_empty_strided",
               "_unsafe_view", "set_", "resize_"}
_FUNCOL = {"all_reduce": "all-reduce", "all_reduce_": "all-reduce",
           "all_gather_into_tensor": "all-gather",
           "all_gather_into_tensor_out": "all-gather",
           "reduce_scatter_tensor": "reduce-scatter",
           "all_to_all_single": "all-to-all"}
_SKIP_FRAMES = ("cost_analysis.py", "sharding.py", "dtensor.py", "/torch/")


def _flop_ops():
    # the K5 op registers when its module is imported
    from ..kernels.flash_attention import ops as _k5   # noqa: F401
    return {_aten.mm, _aten.bmm, _aten.addmm, _aten.baddbmm,
            _aten.convolution, _aten._convolution,
            _aten.convolution_backward, torch.ops.repro_torch.flash_fwd}


def _dtensor_cls():
    from torch.distributed.tensor import DTensor
    return DTensor


def _local(t):
    """The tensor whose bytes a device holds: a DTensor's local shard."""
    return getattr(t, "_local_tensor", t)


def _nbytes(t) -> int:
    t = _local(t)
    return t.numel() * t.element_size()


def _group_size(func, args, kwargs) -> int:
    """The size of the process group a collective runs over (its
    ``group_size`` argument, else its group resolved by name); raises
    where neither names one, since the ring factor (g - 1) / g needs it."""
    from torch.distributed.distributed_c10d import _resolve_process_group
    names = [a.name for a in func._schema.arguments]
    vals = dict(zip(names, args))
    vals.update(kwargs)
    if "group_size" in vals:
        return int(vals["group_size"])
    gname = vals.get("group_name") or vals.get("tag")
    try:
        return _resolve_process_group(gname).size()
    except (KeyError, RuntimeError, ValueError) as e:
        raise RuntimeError(f"{func}: cannot resolve the process group "
                           f"{gname!r} of a collective ({e})") from e


def _wire(kind: str, nb: float, g: int) -> float:
    ring = (g - 1) / g
    if kind == "all-reduce":
        return 2 * ring * nb
    if kind in ("all-gather", "reduce-scatter", "all-to-all"):
        return ring * nb
    return nb


def _tag(op: str) -> str:
    """``op@module.function`` of the innermost frame of the port's model
    code that issued the op; in a backward, ``op@<autograd node>``."""
    node = torch._C._current_autograd_node()
    if node is not None:
        return f"{op}@{node.name()}"
    f = sys._getframe(3)
    while f is not None:
        fn = f.f_code.co_filename
        if "repro_torch" in fn and not any(s in fn for s in _SKIP_FRAMES):
            mod = fn.rsplit("/", 1)[-1][:-3]
            return f"{op}@{mod}.{f.f_code.co_name}"
        f = f.f_back
    return f"{op}@backward"


class _Collectives(TorchDispatchMode):
    """Pushed while one DTensor op dispatches: counts the collectives it
    issues on local shards (and their results' live bytes), lets every
    other op through uncounted."""

    def __init__(self, owner: "CostCounter"):
        super().__init__()
        self.owner = owner

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(t is self.owner._dt for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        self.owner._collective(func, args, kwargs, out)
        return out


class CostCounter(TorchDispatchMode):
    """Counts one call's per-device FLOPs, traffic, collectives and live
    bytes (see the module's docstring). Use as a context manager around
    the call; ``args`` (any tree of tensors or DTensors) are the call's
    arguments: their bytes are the ``argument`` bytes and their storages
    are never counted as allocated.

    ``analysis()`` gives the dict ``hlo_analysis.analyze_hlo`` gives
    (``flops``, ``traffic_bytes``, ``collectives``, ``top_traffic``,
    ``top_flops``); ``memory()`` the reference's ``memory_analysis``
    fields; ``op_counts`` every op's count by name.
    """

    def __init__(self, args=None, tag_ops: bool = True):
        super().__init__()
        self._dt = _dtensor_cls()
        self._flops_ops = _flop_ops()
        self.tag_ops = tag_ops
        self.flops = 0.0
        self.traffic = 0.0
        self.colls: Dict[str, Dict[str, float]] = {}
        self.by_tag: Dict[str, list] = {}
        self.op_counts: Dict[str, int] = {}
        self.coll_by_tag: Dict[str, list] = {}
        self._arg_keys = set()
        self.arg_bytes = 0
        self._live: Dict[int, int] = {}
        self._live_tag: Dict[int, str] = {}
        self._snap_at = 0
        self.peak_by_tag = []
        self.live_bytes = 0
        self.peak_bytes = 0
        self._placed = _Collectives(self)
        if args is not None:
            self.add_args(args)

    # ------------------------------------------------------------ state
    def add_args(self, tree) -> None:
        for t in tree_flatten(tree)[0]:
            if isinstance(t, torch.Tensor):
                key = self._key(t)
                if key not in self._arg_keys:
                    self._arg_keys.add(key)
                    self.arg_bytes += _local(t).untyped_storage().nbytes()

    @staticmethod
    def _key(t) -> int:
        return _local(t).untyped_storage()._cdata

    def _alloc(self, t, inputs) -> None:
        t = _local(t)
        if not isinstance(t, torch.Tensor) or t.device.type == "meta":
            return
        st = t.untyped_storage()
        key = st._cdata
        if key in self._live or key in self._arg_keys or key in inputs:
            return
        nb = st.nbytes()
        self._live[key] = nb
        if self.tag_ops:
            self._live_tag[key] = _tag("alloc")
        self.live_bytes += nb
        if self.live_bytes > self.peak_bytes:
            self.peak_bytes = self.live_bytes
            if self.tag_ops and self.live_bytes > 1.01 * self._snap_at:
                self._snap_at = self.live_bytes
                by = {}
                for k, b in self._live.items():
                    t = self._live_tag.get(k, "?")
                    by[t] = by.get(t, 0) + b
                self.peak_by_tag = sorted(by.items(), key=lambda kv: -kv[1])
        weakref.finalize(st, self._free, key)

    def _free(self, key: int) -> None:
        nb = self._live.pop(key, 0)
        self._live_tag.pop(key, None)
        self.live_bytes -= nb

    # --------------------------------------------------------- dispatch
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(t is self._dt for t in types):
            with self._placed:
                out = func(*args, **kwargs)
        else:
            out = func(*args, **kwargs)
            if func.namespace in ("_c10d_functional", "c10d_functional"):
                self._collective(func, args, kwargs, out)
                return out
        self._account(func, args, kwargs, out)
        return out

    def _collective(self, func, args, kwargs, out) -> None:
        name = func._schema.name.split("::")[-1]
        kind = _FUNCOL.get(name)
        if kind is None:
            return
        g = _group_size(func, args, kwargs)
        nb = float(_nbytes(out))
        d = self.colls.setdefault(
            kind, {"count": 0.0, "bytes": 0.0, "wire_bytes": 0.0})
        d["count"] += 1
        d["bytes"] += nb
        d["wire_bytes"] += _wire(kind, nb, g)
        if self.tag_ops:
            t = self.coll_by_tag.setdefault(_tag(kind), [0.0, 0.0])
            t[0] += 1
            t[1] += nb
        self._alloc(out, ())

    def _split(self, out) -> int:
        """The ranks one DTensor op's work is divided among: the product
        of the mesh dims where its output is Shard or Partial."""
        if not isinstance(out, self._dt):
            return 1
        mesh = out.device_mesh
        n = 1
        for i, p in enumerate(out.placements):
            if not p.is_replicate():
                n *= mesh.size(i)
        return n

    def _account(self, func, args, kwargs, out) -> None:
        name = func._schema.name.split("::")[-1]
        self.op_counts[name] = self.op_counts.get(name, 0) + 1
        flat_out = [t for t in tree_flatten(out)[0]
                    if isinstance(t, torch.Tensor)
                    and _local(t).device.type != "meta"]
        flat_in = [t for t in tree_flatten((args, kwargs))[0]
                   if isinstance(t, torch.Tensor)]
        fl = 0.0
        packet = func._overloadpacket
        if packet in self._flops_ops:
            fl = float(flop_registry[packet](*args, **kwargs, out_val=out))
            if flat_out:
                fl /= self._split(flat_out[0])
        tr = 0.0
        if flat_out and not (func.is_view or name in _NO_TRAFFIC
                or name.startswith(("sym_", "_local_scalar"))):
            tr = float(sum(_nbytes(t) for t in flat_in)
                       + sum(_nbytes(t) for t in flat_out))
            if name.endswith("_") and flat_in and flat_out:
                tr -= _nbytes(flat_out[0])      # in place: written once
        self.flops += fl
        self.traffic += tr
        if self.tag_ops and (fl or tr):
            t = self.by_tag.setdefault(_tag(name), [0.0, 0.0])
            t[0] += tr
            t[1] += fl
        if not func.is_view:
            keys = {self._key(t) for t in flat_in}
            for t in flat_out:
                self._alloc(t, keys)

    # ---------------------------------------------------------- results
    def analysis(self, top: int = 20) -> Dict:
        top_t = sorted(self.by_tag.items(), key=lambda kv: -kv[1][0])[:top]
        top_f = sorted(self.by_tag.items(), key=lambda kv: -kv[1][1])[:top]
        top_c = sorted(self.coll_by_tag.items(),
                       key=lambda kv: -kv[1][1])[:top]
        return {"flops": self.flops, "traffic_bytes": self.traffic,
                "collectives": {k: dict(v) for k, v in self.colls.items()},
                "top_traffic": [(k, v[0]) for k, v in top_t],
                "top_flops": [(k, v[1]) for k, v in top_f],
                "top_collectives": [(k, int(v[0]), v[1]) for k, v in top_c],
                "peak_by_tag": self.peak_by_tag[:top]}

    def memory(self, result=None) -> Dict[str, int]:
        """``argument_size_in_bytes`` (the arguments' storages a device
        holds), ``output_size_in_bytes`` (the result's tensors that are
        not arguments), ``temp_size_in_bytes`` (the peak of what the call
        allocated, its outputs included) and ``alias_size_in_bytes`` (the
        result's tensors that are arguments, written in place)."""
        out_b = alias_b = 0
        seen = set()
        for t in tree_flatten(result)[0]:
            if not isinstance(t, torch.Tensor):
                continue
            key = self._key(t)
            if key in seen:
                continue
            seen.add(key)
            nb = _local(t).untyped_storage().nbytes()
            if key in self._arg_keys:
                alias_b += nb
            else:
                out_b += nb
        return {"argument_size_in_bytes": int(self.arg_bytes),
                "output_size_in_bytes": int(out_b),
                "temp_size_in_bytes": int(self.peak_bytes),
                "alias_size_in_bytes": int(alias_b)}


# ------------------------------------------------------------------ roofline
def roofline(flops_pd: float, bytes_pd: float, coll_wire_pd: float,
             model_flops_global: float, n_chips: int,
             peak_flops: float = PEAK_FLOPS, hbm_bw: float = HBM_BW,
             net_bw: float = NET_BW) -> Dict[str, float]:
    """The reference's roofline terms (``hlo_analysis.roofline``), at the
    H100's datasheet rates unless others are given."""
    compute_s = flops_pd / peak_flops
    memory_s = bytes_pd / hbm_bw
    coll_s = coll_wire_pd / net_bw
    dominant = max(("compute", compute_s), ("memory", memory_s),
                   ("collective", coll_s), key=lambda t: t[1])[0]
    step_s = max(compute_s, memory_s, coll_s)
    flops_global = flops_pd * n_chips
    return {
        "compute_s": compute_s,
        "memory_s": memory_s,
        "collective_s": coll_s,
        "dominant": dominant,
        "bound_step_s": step_s,
        "model_flops": model_flops_global,
        "hlo_flops_global": flops_global,
        "useful_flop_ratio": (model_flops_global / flops_global
                              if flops_global else 0.0),
        "mfu_bound": (model_flops_global / (n_chips * peak_flops) / step_s
                      if step_s else 0.0),
    }


def count_ops(counter: CostCounter, names: Tuple[str, ...],
              ) -> Dict[str, int]:
    """The twin of ``hlo_analysis.count_hlo_ops``: how many times each
    named op ran (aten names, e.g. ``"mm"``; a collective kind of
    :data:`COLLECTIVES`, e.g. ``"collective-permute"``, reads the
    collectives' counts)."""
    out = {}
    for n in names:
        if n in COLLECTIVES:
            out[n] = int(counter.colls.get(n, {}).get("count", 0))
        else:
            out[n] = int(counter.op_counts.get(n, 0))
    return out


def flops_of(fn, *args, **kwargs) -> Tuple[float, object]:
    """(the counted FLOPs of ``fn(*args, **kwargs)``, its result) without
    tags or live bytes: the counter the card's step and the dry run share."""
    with CostCounter(tag_ops=False) as c:
        out = fn(*args, **kwargs)
    return c.flops, out

