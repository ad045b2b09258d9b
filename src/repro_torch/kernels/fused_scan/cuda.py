"""Bind the fused range-scan CUDA kernel (``csrc/fused_scan.cu``, sm_90a)
with ``ctypes``; ``kernels/nvcc.py`` builds it at first use. Nothing here
runs at import time."""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ..nvcc import CSRC, attributes, check, load

__all__ = ["launch", "kernel_attributes", "SOURCE"]

SOURCE = CSRC / "fused_scan.cu"
_FN: Optional[ctypes._CFuncPtr] = None


def _fn():
    global _FN
    if _FN is None:
        fn = load(SOURCE).fbt_fused_scan
        fn.argtypes = [ctypes.c_void_p] * 20 + [ctypes.c_int] * 9 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


def launch(arrays, qb: torch.Tensor, ql: torch.Tensor, *, max_items: int,
           collect_stats: bool):
    """Launch the kernel on the current stream of the queries' device.

    ``arrays`` is the tree's ``TreeArrays`` on the same device. Returns
    ``(out_kid [B, max_items], out_val [B, max_items], emitted [B],
    rearranged [B])``, all int32; ``rearranged`` is all-zero (and not
    computed) unless ``collect_stats``. Raises on any tensor the kernel does
    not take and on a failed launch.
    """
    s = arrays.stacked
    dev = qb.device
    if dev.type != "cuda":
        raise ValueError("fused_scan.launch takes CUDA tensors")
    if qb.dim() != 2:
        raise ValueError(f"fused_scan: qb must be [B, L], got "
                         f"{tuple(qb.shape)}")
    if max_items < 1:
        raise ValueError(f"fused_scan: max_items must be >= 1, got "
                         f"{max_items}")
    B, L = qb.shape
    NL, C, fs, ns = s.features.shape
    KC = arrays.key_bytes.shape[0]
    LC = arrays.leaf_high.shape[0]
    if ns not in (64, 128):
        raise ValueError(f"fused_scan: the kernel is built for ns in "
                         f"(64, 128), got ns={ns}")
    if L > 256:
        raise ValueError(f"fused_scan: key width {L} > 256 bytes")
    i32, u8, b8 = torch.int32, torch.uint8, torch.bool
    for name, t, dt, shape in (
            ("qb", qb, u8, (B, L)), ("ql", ql, i32, (B,)),
            ("knum", s.knum, i32, (NL, C)), ("plen", s.plen, i32, (NL, C)),
            ("prefix", s.prefix, u8, (NL, C, L)),
            ("features", s.features, u8, (NL, C, fs, ns)),
            ("children", s.children, i32, (NL, C, ns)),
            ("anchors", s.anchors, i32, (NL, C, ns)),
            ("key_bytes", arrays.key_bytes, u8, (KC, L)),
            ("key_lens", arrays.key_lens, i32, (KC,)),
            ("leaf_high", arrays.leaf_high, i32, (LC,)),
            ("leaf_next", arrays.leaf_next, i32, (LC,)),
            ("leaf_keyid", arrays.leaf_keyid, i32, (LC, ns)),
            ("leaf_val", arrays.leaf_val, i32, (LC, ns)),
            ("leaf_occ", arrays.leaf_occ, b8, (LC, ns)),
            ("leaf_ordered", arrays.leaf_ordered, b8, (LC,))):
        check("fused_scan", name, t, dt, shape, dev)

    out_kid = torch.empty((B, max_items), dtype=i32, device=dev)
    out_val = torch.empty((B, max_items), dtype=i32, device=dev)
    emitted = torch.empty((B,), dtype=i32, device=dev)
    rearranged = (torch.empty if collect_stats else torch.zeros)(
        (B,), dtype=i32, device=dev)
    if B == 0:
        return out_kid, out_val, emitted, rearranged
    fn = _fn()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        ptr = lambda t: t.data_ptr()
        err = fn(
            ptr(qb), ptr(ql), ptr(s.knum), ptr(s.plen), ptr(s.prefix),
            ptr(s.features), ptr(s.children), ptr(s.anchors),
            ptr(arrays.key_bytes), ptr(arrays.key_lens),
            ptr(arrays.leaf_high), ptr(arrays.leaf_next),
            ptr(arrays.leaf_keyid), ptr(arrays.leaf_val),
            ptr(arrays.leaf_occ), ptr(arrays.leaf_ordered),
            ptr(out_kid), ptr(out_val), ptr(emitted), ptr(rearranged),
            B, L, NL, C, fs, ns, LC, max_items, int(collect_stats), stream)
    if err != 0:
        raise RuntimeError(f"fused_scan: kernel launch failed with CUDA "
                           f"error {err}")
    return out_kid, out_val, emitted, rearranged


def kernel_attributes(ns: int, L: int, stats: bool) -> dict:
    """What the instantiation a launch at ``ns``, key width ``L`` and
    ``stats`` takes asks of the current card: registers and local memory
    (spills) a thread, static and dynamic shared memory and threads a
    block, and the blocks that fit on one SM."""
    return attributes(load(SOURCE).fbt_fused_scan_attrs, "fused_scan",
                      ns, L, int(stats))
