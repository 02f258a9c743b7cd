"""Atomic checkpoints in the reference's layout: port of
``src/repro/checkpoint``."""
from . import ckpt
from .ckpt import latest_step, restore, save

__all__ = ["ckpt", "save", "restore", "latest_step"]
