"""Assigned-architecture configs (``--arch <id>``): port of
``src/repro/configs``.

Each module defines ``CONFIG`` (the exact published dims) and
``smoke_config()`` (a reduced same-family config for CPU tests), with the
reference's field values, for every arch of ``ARCH_IDS``.  ``SHAPES`` is
the shared shape grid of the dry run (``launch/dryrun.py``);
``shape_applies`` encodes the long_500k skip per family.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Dict, List, Tuple

from ..models.layers import ModelConfig

ARCH_IDS: Tuple[str, ...] = (
    "qwen3-4b", "yi-6b", "granite-3-2b", "llama3.2-3b",
    "moonshot-v1-16b-a3b", "qwen3-moe-30b-a3b", "falcon-mamba-7b",
    "qwen2-vl-72b", "whisper-base", "jamba-v0.1-52b",
)


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}

# long_500k needs sub-quadratic attention: only SSM/hybrid run it
LONG_OK_FAMILIES = ("ssm", "hybrid")


def _module(arch_id: str):
    if arch_id not in ARCH_IDS:
        raise ValueError(f"unknown arch {arch_id!r}")
    name = arch_id.replace("-", "_").replace(".", "_")
    return importlib.import_module(f"{__name__}.{name}")


def get_config(arch_id: str) -> ModelConfig:
    return _module(arch_id).CONFIG


def get_smoke_config(arch_id: str) -> ModelConfig:
    return _module(arch_id).smoke_config()


def shape_applies(cfg: ModelConfig, shape: str) -> Tuple[bool, str]:
    """(applies?, reason-if-not)."""
    if shape == "long_500k" and cfg.family not in LONG_OK_FAMILIES:
        return False, ("524k dense attention is the quadratic case the "
                       "assignment says to skip (full-attention family)")
    return True, ""


def all_cells() -> List[Tuple[str, str]]:
    """The 40 (arch, shape) cells; skipped cells still appear (marked N/A
    downstream via shape_applies)."""
    return [(a, s) for a in ARCH_IDS for s in SHAPES]
