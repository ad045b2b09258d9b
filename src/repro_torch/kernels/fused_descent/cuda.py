"""Bind the fused whole-descent CUDA kernel (``csrc/fused_descent.cu``,
sm_90a) with ``ctypes``; ``kernels/nvcc.py`` builds it at first use.
Nothing here runs at import time."""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ..nvcc import CSRC, check, load

__all__ = ["launch", "SOURCE"]

SOURCE = CSRC / "fused_descent.cu"
_FN: Optional[ctypes._CFuncPtr] = None


def _fn():
    global _FN
    if _FN is None:
        fn = load(SOURCE).fbt_fused_descent
        fn.argtypes = [ctypes.c_void_p] * 22 + [ctypes.c_int] * 10 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


def launch(arrays, qb: torch.Tensor, ql: torch.Tensor, *, sibling_check: bool,
           with_probe: bool, collect_stats: bool):
    """Launch the kernel on the current stream of the queries' device.

    ``arrays`` is the tree's ``TreeArrays`` on the same device. Returns
    ``(leaf [B], path [B, NL], found [B] bool, slot [B], val [B],
    stats [6, B])``, all int32 but ``found``; the rows of ``stats`` are
    feat_rounds, suffix_bs, key_compares, lines_touched, sibling_hops and
    tag_candidates, and are unwritten unless ``collect_stats``. Raises on
    any tensor the kernel does not take and on a failed launch.
    """
    s = arrays.stacked
    dev = qb.device
    if dev.type != "cuda":
        raise ValueError("fused_descent.launch takes CUDA tensors")
    if qb.dim() != 2:
        raise ValueError(f"fused_descent: qb must be [B, L], got "
                         f"{tuple(qb.shape)}")
    B, L = qb.shape
    NL, C, fs, ns = s.features.shape
    KC = arrays.key_bytes.shape[0]
    LC = arrays.leaf_high.shape[0]
    if ns not in (64, 128):
        raise ValueError(f"fused_descent: the kernel is built for ns in "
                         f"(64, 128), got ns={ns}")
    if L > 256:
        raise ValueError(f"fused_descent: key width {L} > 256 bytes")
    i32, u8 = torch.int32, torch.uint8
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
            ("leaf_tags", arrays.leaf_tags, u8, (LC, ns)),
            ("leaf_occ", arrays.leaf_occ, torch.bool, (LC, ns)),
            ("leaf_keyid", arrays.leaf_keyid, i32, (LC, ns)),
            ("leaf_val", arrays.leaf_val, i32, (LC, ns))):
        check("fused_descent", name, t, dt, shape, dev)

    leaf = torch.empty((B,), dtype=i32, device=dev)
    path = torch.empty((B, NL), dtype=i32, device=dev)
    found = torch.empty((B,), dtype=torch.bool, device=dev)
    slot = torch.empty((B,), dtype=i32, device=dev)
    val = torch.empty((B,), dtype=i32, device=dev)
    stats = torch.empty((6, B), dtype=i32, device=dev)
    if B == 0:
        return leaf, path, found, slot, val, stats
    fn = _fn()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        ptr = lambda t: t.data_ptr()
        err = fn(
            ptr(qb), ptr(ql), ptr(s.knum), ptr(s.plen), ptr(s.prefix),
            ptr(s.features), ptr(s.children), ptr(s.anchors),
            ptr(arrays.key_bytes), ptr(arrays.key_lens),
            ptr(arrays.leaf_high), ptr(arrays.leaf_next),
            ptr(arrays.leaf_tags), ptr(arrays.leaf_occ),
            ptr(arrays.leaf_keyid), ptr(arrays.leaf_val),
            ptr(leaf), ptr(path), ptr(found), ptr(slot), ptr(val), ptr(stats),
            B, L, NL, C, fs, ns, LC, int(collect_stats), int(sibling_check),
            int(with_probe), stream)
    if err != 0:
        raise RuntimeError(f"fused_descent: kernel launch failed with CUDA "
                           f"error {err}")
    return leaf, path, found, slot, val, stats
