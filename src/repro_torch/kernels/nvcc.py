"""Build the port's CUDA kernels (``csrc/*.cu``, sm_90a) with ``nvcc``, load
them with ``ctypes``, and check the tensors a binding hands to a kernel.

Each source is compiled into its own shared library with a plain C
interface under ``build/kernels/`` of the checkout, at first use. A
library's name carries a hash of the flags, the source and every header it
includes (followed through ``#include "..."``), so an edited source or
header is rebuilt and a stale library is never loaded. :func:`build` starts
one ``nvcc`` per missing library, all at once, and writes each to a
temporary name first, so processes that build at once never load a
half-written file. Nothing here runs at import time: the CPU tests import
this module on machines with no ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Dict, Iterable, List, Optional

import torch

__all__ = ["CSRC", "BUILD_DIR", "NVCC_FLAGS", "SOURCE_FLAGS", "BUILD_LOG",
           "sources", "library_path", "build", "load", "check", "attributes"]

_PKG = Path(__file__).resolve().parents[1]          # src/repro_torch
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parents[1] / "build" / "kernels"   # <checkout>/build/kernels
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# Flags a source's build takes beside NVCC_FLAGS: K1's 80 instantiations
# are compiled by as many jobs as the machine has cores, else its build
# alone takes ~80 s of a run's set-up.
SOURCE_FLAGS = {"fused_descent.cu": ("-split-compile=0",)}
BUILD_LOG: Dict[str, str] = {}   # source name -> nvcc output of a build made here

_INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.M)
_LIBS: Dict[Path, ctypes.CDLL] = {}


def sources() -> List[Path]:
    """Every kernel source of the port (one library each)."""
    return sorted(CSRC.glob("*.cu"))


def _deps(src: Path) -> List[Path]:
    """``src`` and every header it includes, directly or not."""
    seen, stack = set(), [src]
    while stack:
        p = stack.pop()
        if p not in seen:
            seen.add(p)
            stack += [p.parent / n for n in _INCLUDE.findall(p.read_text())]
    return sorted(seen)


def _flags(src: Path) -> tuple:
    return NVCC_FLAGS + SOURCE_FLAGS.get(src.name, ())


def library_path(src: Path) -> Path:
    h = hashlib.sha256(" ".join(_flags(src)).encode())
    for p in _deps(src):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"libfbt_{src.stem}_{h.hexdigest()[:16]}.so"


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME:
        cand = os.path.join(CUDA_HOME, "bin", "nvcc")
        if os.path.exists(cand):
            return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on "
                           "PATH) — cannot build the port's CUDA kernels")
    return found


def build(srcs: Optional[Iterable[Path]] = None) -> Dict[Path, Path]:
    """Compile every library of ``srcs`` (default: all sources) that is not
    built yet, one ``nvcc`` process per source, all started together.
    Returns ``{source: library path}``; raises if any build fails."""
    srcs = sources() if srcs is None else list(srcs)
    out = {s: library_path(s) for s in srcs}
    todo = [s for s in srcs if not out[s].exists()]
    if not todo:
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = []
    try:
        for s in todo:
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            cmd = [nvcc, *_flags(s), "-I", str(CSRC), "-o", tmp, str(s)]
            procs.append((s, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        failed = []
        for s, tmp, p in procs:
            BUILD_LOG[s.name] = p.communicate()[0]
            if p.returncode != 0:
                failed.append(f"{s.name} ({p.returncode}):\n"
                              f"{BUILD_LOG[s.name]}")
            else:
                os.replace(tmp, out[s])
        if failed:
            raise RuntimeError("nvcc failed: " + "\n".join(failed))
    finally:
        for _, tmp, p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            if os.path.exists(tmp):
                os.unlink(tmp)
    return out


def load(src: Path) -> ctypes.CDLL:
    """The library of ``src``, built first if needed; loaded once."""
    path = build([src])[src]
    if path not in _LIBS:
        _LIBS[path] = ctypes.CDLL(str(path))
    return _LIBS[path]


def check(kernel: str, name: str, t: torch.Tensor, dtype: torch.dtype,
          shape: tuple, device: torch.device) -> None:
    """Raise on a tensor the kernel does not take: another device, dtype or
    shape, or a layout that is not contiguous."""
    if t.device != device:
        raise ValueError(f"{kernel}: {name} is on {t.device}, queries on "
                         f"{device}")
    if t.dtype != dtype:
        raise TypeError(f"{kernel}: {name} has dtype {t.dtype}, the kernel "
                        f"takes {dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{kernel}: {name} has shape {tuple(t.shape)}, "
                         f"expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{kernel}: {name} must be contiguous")


ATTRS = ("registers", "local_bytes", "static_smem_bytes", "dynamic_smem_bytes",
         "blocks_per_sm", "threads")


def attributes(fn, kernel: str, *args: int) -> dict:
    """Call a tree kernel's ``fbt_*_attrs(args..., int out[6])`` entry
    (``csrc/attrs.cuh``) and name its six numbers (:data:`ATTRS`)."""
    out = (ctypes.c_int * len(ATTRS))()
    fn.argtypes = [ctypes.c_int] * len(args) + [ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    err = fn(*args, out)
    if err != 0:
        raise RuntimeError(f"{kernel}: attributes failed with CUDA error "
                           f"{err}")
    return dict(zip(ATTRS, out))
