"""Build and bind the fused whole-descent CUDA kernel
(``csrc/fused_descent.cu``, sm_90a).

The source is compiled with ``nvcc`` into a shared library with a plain C
interface under ``build/kernels/`` of the checkout, at first use, and loaded
with ``ctypes``. The library's name carries a hash of the sources and
flags, so an edited source is rebuilt and a stale library is never loaded.
Nothing here runs at import time: the CPU tests import this module on
machines with no ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Optional

import torch

__all__ = ["build", "launch", "BUILD_DIR", "SOURCE"]

_PKG = Path(__file__).resolve().parents[2]          # src/repro_torch
CSRC = _PKG / "csrc"
SOURCE = CSRC / "fused_descent.cu"
_HEADERS = (CSRC / "cmp.cuh", CSRC / "feature_rounds.cuh")
BUILD_DIR = _PKG.parents[1] / "build" / "kernels"   # <checkout>/build/kernels
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIB: Optional[ctypes.CDLL] = None
BUILD_LOG = ""   # nvcc's output of the build this process made, if any


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME:
        cand = os.path.join(CUDA_HOME, "bin", "nvcc")
        if os.path.exists(cand):
            return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("fused_descent: nvcc not found (set CUDA_HOME or "
                           "put nvcc on PATH) — cannot build the CUDA kernel")
    return found


def build() -> Path:
    """Compile the kernel library if this source has not been built yet;
    returns its path. Writes to a temporary name first, so processes that
    build at once never load a half-written file."""
    global BUILD_LOG
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in (SOURCE,) + _HEADERS:
        h.update(p.read_bytes())
    out = BUILD_DIR / f"libfbt_fused_descent_{h.hexdigest()[:16]}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", tmp, str(SOURCE)]
        res = subprocess.run(cmd, capture_output=True, text=True)
        BUILD_LOG = res.stdout + res.stderr
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed ({res.returncode}):\n{BUILD_LOG}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build()))
        fn = lib.fbt_fused_descent
        fn.argtypes = [ctypes.c_void_p] * 22 + [ctypes.c_int] * 10 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def _check(name: str, t: torch.Tensor, dtype: torch.dtype, shape: tuple,
           device: torch.device) -> None:
    if t.device != device:
        raise ValueError(f"fused_descent: {name} is on {t.device}, queries "
                         f"on {device}")
    if t.dtype != dtype:
        raise TypeError(f"fused_descent: {name} has dtype {t.dtype}, the "
                        f"kernel takes {dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"fused_descent: {name} has shape "
                         f"{tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"fused_descent: {name} must be contiguous")


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
        _check(name, t, dt, shape, dev)

    leaf = torch.empty((B,), dtype=i32, device=dev)
    path = torch.empty((B, NL), dtype=i32, device=dev)
    found = torch.empty((B,), dtype=torch.bool, device=dev)
    slot = torch.empty((B,), dtype=i32, device=dev)
    val = torch.empty((B,), dtype=i32, device=dev)
    stats = torch.empty((6, B), dtype=i32, device=dev)
    if B == 0:
        return leaf, path, found, slot, val, stats
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        ptr = lambda t: t.data_ptr()
        err = lib.fbt_fused_descent(
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
