"""Assigned-architecture configs (``--arch <id>``): port of
``src/repro/configs``.

Each ported module defines ``CONFIG`` (the exact published dims) and
``smoke_config()`` (a reduced same-family config for CPU tests), with the
reference's field values.  The dense archs, falcon-mamba-7b (the ssm
family), the two MoE archs and jamba-v0.1-52b (the hybrid family) are
ported; the others raise ``NotImplementedError`` naming the ROADMAP item
that ports them.
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
# the archs the port runs (and ``launch/serve.py --arch`` accepts)
PORTED_ARCH_IDS: Tuple[str, ...] = ARCH_IDS[:7] + ("jamba-v0.1-52b",)

_NOT_PORTED = {
    "qwen2-vl-72b": "ROADMAP queue 1 item 11, vlm/M-RoPE",
    "whisper-base": "ROADMAP queue 1 item 11, encdec",
}


def _module(arch_id: str):
    if arch_id in _NOT_PORTED:
        raise NotImplementedError(f"arch {arch_id!r} is not ported yet "
                                  f"({_NOT_PORTED[arch_id]})")
    if arch_id not in ARCH_IDS:
        raise ValueError(f"unknown arch {arch_id!r}")
    name = arch_id.replace("-", "_").replace(".", "_")
    return importlib.import_module(f"{__name__}.{name}")


def get_config(arch_id: str) -> ModelConfig:
    return _module(arch_id).CONFIG


def get_smoke_config(arch_id: str) -> ModelConfig:
    return _module(arch_id).smoke_config()
