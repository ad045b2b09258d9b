"""Bind the flash-attention forward CUDA kernel (``csrc/flash_attention.cu``,
sm_90a) with ``ctypes``; ``kernels/nvcc.py`` builds it at first use.
Nothing here runs at import time.

:func:`check_inputs` and :func:`tma_refusal` hold everything :func:`launch`
checks but the device, so they run on CPU tensors too."""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from ..nvcc import CSRC, load

__all__ = ["launch", "check_inputs", "tma_refusal", "kernel_attributes",
           "SOURCE", "HEAD_DIM_QK_MAX", "HEAD_DIM_V_MAX"]

SOURCE = CSRC / "flash_attention.cu"
# the widest heads the kernel takes: q/k and v up to 256 (PaliGemma's); the
# bf16 body is built for (64, 64), (128, 128), (192, 128) (MLA's 128 + 64
# rotary q/k, v 128) and (256, 256)
HEAD_DIM_QK_MAX = 256
HEAD_DIM_V_MAX = 256
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_FN: Optional[ctypes._CFuncPtr] = None


def _fn():
    global _FN
    if _FN is None:
        fn = load(SOURCE).fbt_flash_attention
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 8
                       + [ctypes.c_longlong] * 12 + [ctypes.c_int] * 4
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


def tma_refusal(t: torch.Tensor) -> Optional[str]:
    """Why the bf16 kernel's TMA loads cannot read the 4-D view ``t``
    ``[batch, heads, rows, dim]`` (None when they can): its base must be
    16-byte aligned, its head dim a multiple of 8 (whole 16-byte units) and
    the stride of each other dim of extent above 1 a multiple of 8 elements
    (16 bytes). A dim of extent 1 is never stepped along, so its stride does
    not matter."""
    if t.data_ptr() % 16:
        return f"base address {t.data_ptr():#x} is not 16-byte aligned"
    if t.shape[-1] % 8:
        return f"head dim {t.shape[-1]} is not a multiple of 8"
    bad = [(n, s) for n, s in zip(t.shape[:-1], t.stride()[:-1])
           if n > 1 and s % 8]
    if bad:
        return (f"strides {[s for _, s in bad]} (elements) are not "
                f"multiples of 16 bytes")
    return None


def check_inputs(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                 n_rep: int, kv_len: int) -> None:
    """Raise on q, k, v the kernel does not take, wherever they lie: the
    shapes, dtypes, devices (one for all three), layouts and ``kv_len`` of
    :func:`launch`. bf16 views TMA cannot describe (:func:`tma_refusal`)
    raise ``ValueError``."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_attention: q, k, v must be 4-D "
                         "[B, heads, rows, dim] views")
    B, H, S, hd = q.shape
    Bk, Hk, T, hdk = k.shape
    hv = v.shape[-1]
    if (Bk, hdk) != (B, hd) or tuple(v.shape[:3]) != (B, Hk, T):
        raise ValueError(f"flash_attention: shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)} disagree")
    if n_rep < 1 or Hk * n_rep != H:
        raise ValueError(f"flash_attention: {H} query heads are not "
                         f"{Hk} kv heads x n_rep={n_rep}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"flash_attention: {name} is on {t.device}, "
                             f"q on {q.device}")
        if t.dtype != q.dtype:
            raise TypeError(f"flash_attention: {name} has dtype {t.dtype}, "
                            f"q has {q.dtype}")
        if t.stride(-1) != 1:
            raise ValueError(f"flash_attention: {name}'s last dim must be "
                             f"contiguous")
    if q.dtype not in _DTYPES:
        raise TypeError(f"flash_attention: the kernel takes float32 or "
                        f"bfloat16, got {q.dtype}")
    if hd > HEAD_DIM_QK_MAX or hv > HEAD_DIM_V_MAX:
        raise ValueError(f"flash_attention: head dims q/k {hd}, v {hv} above "
                         f"{HEAD_DIM_QK_MAX}, {HEAD_DIM_V_MAX}")
    if B * H > 65535:
        raise ValueError(f"flash_attention: B*H = {B * H} above 65535")
    if not 0 <= kv_len <= T:
        raise ValueError(f"flash_attention: kv_len {kv_len} outside "
                         f"[0, T={T}]")
    if q.dtype == torch.bfloat16 and q.numel() and k.numel():
        for name, t in (("q", q), ("k", k), ("v", v)):
            why = tma_refusal(t)
            if why:
                raise ValueError(f"flash_attention: TMA cannot load {name}: "
                                 f"{why}")


def launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, n_rep: int,
           scale: float, kv_len: int, causal: bool, window: int,
           prefix_len: int) -> Tuple[torch.Tensor, bool]:
    """Launch the kernel on the current stream of ``q``'s device.

    ``q [B, H, S, hd]``, ``k [B, Hk, T, hd]`` and ``v [B, Hk, T, hv]`` are
    views with any strides TMA can describe and a contiguous last dim (the
    caller's ``[B, S, H, d]`` tensors permuted, so nothing is copied),
    float32 or bfloat16, on one card; ``H = Hk * n_rep`` and query head
    ``h`` reads kv head ``h // n_rep``; keys at or past ``kv_len`` are
    masked. Returns ``(out, launched)``: ``out [B, S, H, hv]`` (contiguous,
    q's dtype) and whether the kernel ran (not for an empty ``out``, nor for
    ``T == 0``, where ``out`` is zeroed here). Raises on any tensor the
    kernel does not take (:func:`check_inputs`) and on a failed launch.
    """
    dev = q.device
    if dev.type != "cuda":
        raise ValueError("flash_attention.launch takes CUDA tensors")
    check_inputs(q, k, v, n_rep=n_rep, kv_len=kv_len)
    B, H, S, _ = q.shape
    T, hv = k.shape[2], v.shape[-1]
    out = torch.empty((B, S, H, hv), dtype=q.dtype, device=dev)
    if S == 0 or B * H == 0:
        return out, False
    if T == 0:
        return out.zero_(), False
    o = out.permute(0, 2, 1, 3)
    fn = _fn()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                 _DTYPES[q.dtype], B, H, n_rep, S, T, q.shape[-1], hv,
                 *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                 *o.stride()[:3], kv_len, int(causal), int(window),
                 int(prefix_len), float(scale), stream)
    if err != 0:
        raise RuntimeError(f"flash_attention: kernel launch failed with "
                           f"CUDA error {err}")
    return out, True


def kernel_attributes(head_dim: int, v_head_dim: int) -> dict:
    """What the bf16 build for q/k head dim ``head_dim`` and v head dim
    ``v_head_dim`` asks of the current card: its
    registers a thread as compiled (before ``setmaxnreg`` moves them from
    the producer warpgroup to the consumers), static and dynamic shared
    memory in bytes, and the blocks that fit on one SM."""
    fn = load(SOURCE).fbt_flash_attention_attrs
    fn.argtypes = [ctypes.c_int] * 2 + [ctypes.POINTER(ctypes.c_int)] * 4
    fn.restype = ctypes.c_int
    vals = [ctypes.c_int() for _ in range(4)]
    err = fn(head_dim, v_head_dim, *[ctypes.byref(x) for x in vals])
    if err != 0:
        raise RuntimeError(f"flash_attention: attributes failed with CUDA "
                           f"error {err}")
    return dict(zip(("registers", "static_smem_bytes", "dynamic_smem_bytes",
                     "blocks_per_sm"), (x.value for x in vals)))
