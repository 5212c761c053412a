"""Config registry: one module per assigned architecture (`--arch <id>`).

Pure-Python copy of `repro.configs`; the arch files are data."""
from __future__ import annotations

import importlib

from .base import ArchConfig, ShapeConfig, SHAPES  # noqa: F401

ARCHS = (
    "nemotron-4-340b",
    "qwen1.5-32b",
    "llama3.2-3b",
    "gemma3-4b",
    "phi-3-vision-4.2b",
    "phi3.5-moe-42b-a6.6b",
    "deepseek-moe-16b",
    "whisper-tiny",
    "xlstm-125m",
    "recurrentgemma-9b",
)

_MOD = {a: a.replace("-", "_").replace(".", "_") for a in ARCHS}


def get_config(name: str) -> ArchConfig:
    if name not in _MOD:
        raise KeyError(f"unknown arch {name!r}; have {list(ARCHS)}")
    mod = importlib.import_module(f"repro_torch.configs.{_MOD[name]}")
    return mod.CONFIG


def all_configs() -> dict[str, ArchConfig]:
    return {a: get_config(a) for a in ARCHS}
