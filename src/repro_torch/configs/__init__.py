"""Assigned-architecture configs (``--arch <id>``): port of
``src/repro/configs``.

Each module defines ``CONFIG`` (the exact published dims) and
``smoke_config()`` (a reduced same-family config for CPU tests), with the
reference's field values, for every arch of ``ARCH_IDS``.
"""
from __future__ import annotations

import importlib
from typing import Tuple

from ..models.layers import ModelConfig

ARCH_IDS: Tuple[str, ...] = (
    "qwen3-4b", "yi-6b", "granite-3-2b", "llama3.2-3b",
    "moonshot-v1-16b-a3b", "qwen3-moe-30b-a3b", "falcon-mamba-7b",
    "qwen2-vl-72b", "whisper-base", "jamba-v0.1-52b",
)


def _module(arch_id: str):
    if arch_id not in ARCH_IDS:
        raise ValueError(f"unknown arch {arch_id!r}")
    name = arch_id.replace("-", "_").replace(".", "_")
    return importlib.import_module(f"{__name__}.{name}")


def get_config(arch_id: str) -> ModelConfig:
    return _module(arch_id).CONFIG


def get_smoke_config(arch_id: str) -> ModelConfig:
    return _module(arch_id).smoke_config()
