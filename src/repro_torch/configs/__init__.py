"""Architecture registry: ``get_config(name)`` / ``--arch <id>``."""
from __future__ import annotations

import importlib

ARCHS = (
    "minitron_8b",
    "gemma2_9b",
    "glm4_9b",
    "granite_34b",
    "qwen3_moe_235b_a22b",
    "moonshot_v1_16b_a3b",
    "whisper_tiny",
    "qwen2_vl_7b",
    "mamba2_130m",
    "zamba2_7b",
)

_ALIASES = {a.replace("_", "-"): a for a in ARCHS}


def get_config(name: str):
    key = _ALIASES.get(name, name.replace("-", "_"))
    if key not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_ALIASES)}")
    mod = importlib.import_module(f"repro_torch.configs.{key}")
    return mod.CONFIG


def get_smoke_config(name: str):
    key = _ALIASES.get(name, name.replace("-", "_"))
    mod = importlib.import_module(f"repro_torch.configs.{key}")
    return mod.SMOKE
