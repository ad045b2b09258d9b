"""Architecture registry: ``get_config(<id>)`` resolves here (a copy of
``repro.configs``; the shape sets of ``configs/common.py`` come with the
training slice)."""
from __future__ import annotations

import dataclasses
import importlib
from typing import Dict

from ..models.config import ModelConfig

# arch id -> module name
_MODULES: Dict[str, str] = {
    "paligemma-3b": "paligemma_3b",
    "qwen2.5-14b": "qwen2_5_14b",
    "nemotron-4-15b": "nemotron_4_15b",
    "qwen3-14b": "qwen3_14b",
    "yi-9b": "yi_9b",
    "llama4-scout-17b-a16e": "llama4_scout_17b_a16e",
    "deepseek-v3-671b": "deepseek_v3_671b",
    "whisper-medium": "whisper_medium",
    "falcon-mamba-7b": "falcon_mamba_7b",
    "zamba2-7b": "zamba2_7b",
}

ARCH_IDS = tuple(_MODULES)


def get_config(arch: str, smoke: bool = False, **overrides) -> ModelConfig:
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {list(_MODULES)}")
    mod = importlib.import_module(f"{__name__}.{_MODULES[arch]}")
    cfg = mod.SMOKE if smoke else mod.CONFIG
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    return cfg


__all__ = ["ARCH_IDS", "ModelConfig", "get_config"]
