"""Step-atomic, async checkpointing — the port's counterpart of
``repro.train.checkpoint``, in its layout, so either package restores the
other's checkpoints.

Layout:  <dir>/step_<N>/  shards.npz  manifest.json   (+ a ``.tmp`` dir
until the atomic rename). The npz keys are the state's tree paths
(``params/seg0/attn/wq``, ``opt/m/embed``, ``opt/step``); bf16 tensors are
stored as float32 (npz has no bf16), as the reference stores them. The
manifest records shapes and dtypes. Keep-k GC; an async writer thread
keeps the train loop running during serialization: the host copy is made
on the caller's thread first, so the in-place optimizer updates of the
next steps cannot reach what is written.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ..core.fbtree import resolve_target
from .tree import tree_paths

__all__ = ["save", "latest_step", "restore"]


def _array(t) -> np.ndarray:
    """A host copy of ``t`` in its own storage (``.cpu()`` of a CPU tensor
    would share the tensor's); bf16 as float32, since npz has no bf16."""
    t = torch.as_tensor(t).detach()
    dtype = torch.float32 if t.dtype == torch.bfloat16 else t.dtype
    return t.to("cpu", dtype, copy=True).numpy()


def _flatten(tree) -> Dict[str, np.ndarray]:
    return {k: _array(v) for k, v in tree_paths(tree)}


def save(ckpt_dir: str, step: int, state, meta: Optional[Dict] = None,
         keep: int = 3, async_: bool = False) -> threading.Thread:
    """Write the checkpoint of ``step``. Returns the writer thread (joined
    unless ``async_``)."""
    flat = _flatten(state)   # host copy on the caller's thread

    def _write():
        final = os.path.join(ckpt_dir, f"step_{step:08d}")
        tmp = final + ".tmp"
        os.makedirs(tmp, exist_ok=True)
        np.savez(os.path.join(tmp, "shards.npz"), **flat)
        manifest = {
            "step": step,
            "time": time.time(),
            "tensors": {k: {"shape": list(v.shape), "dtype": str(v.dtype)}
                        for k, v in flat.items()},
            "meta": meta or {},
        }
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f, indent=1)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        _gc(ckpt_dir, keep)

    t = threading.Thread(target=_write, daemon=True)
    t.start()
    if not async_:
        t.join()
    return t


def _gc(ckpt_dir: str, keep: int):
    steps = sorted(d for d in os.listdir(ckpt_dir) if d.startswith("step_")
                   and not d.endswith(".tmp"))
    for d in steps[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, d), ignore_errors=True)


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(ckpt_dir)
             if d.startswith("step_") and not d.endswith(".tmp")]
    return max(steps) if steps else None


def restore(ckpt_dir: str, template, step: Optional[int] = None,
            device=None) -> Tuple[Any, int]:
    """Restore into the structure of ``template`` (nested dicts of tensors,
    e.g. ``train_step.state_template``'s on the meta device): each tensor
    in its template's dtype, on ``device`` — by default the template's
    device, or the card for a meta template."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        json.load(f)
    with np.load(os.path.join(d, "shards.npz")) as data:
        loaded = {}
        for key, leaf in tree_paths(template):
            if key not in data:
                raise KeyError(f"checkpoint missing tensor {key}")
            arr = data[key]
            if tuple(arr.shape) != tuple(leaf.shape):
                raise ValueError(f"{key}: checkpoint shape {arr.shape} != "
                                 f"{tuple(leaf.shape)}")
            dev = (torch.device(device) if device is not None else
                   leaf.device if leaf.device.type != "meta" else
                   resolve_target(None))
            loaded[key] = torch.from_numpy(np.array(arr)).to(
                device=dev, dtype=leaf.dtype)
    return _unflatten(template, loaded), step


def _unflatten(template, loaded: Dict, prefix: str = ""):
    if isinstance(template, dict):
        return {k: _unflatten(v, loaded, f"{prefix}/{k}" if prefix else str(k))
                for k, v in template.items()}
    if isinstance(template, (tuple, list)):
        return type(template)(
            _unflatten(v, loaded, f"{prefix}/{i}" if prefix else str(i))
            for i, v in enumerate(template))
    return loaded[prefix]
