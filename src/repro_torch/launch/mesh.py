"""The production meshes: port of ``src/repro/launch/mesh.py``.

``make_mesh``, ``mesh_chips`` and the ambient mesh (``use_mesh`` /
``current_mesh``, the counterpart of ``jax.set_mesh`` /
``jax.sharding.get_abstract_mesh``) live in ``sharding/mesh.py``, where
the models and the engine read them, and are re-exported here.  The
caller sets up the default process group first (``torchrun``'s
environment, a spawn with ``init_method="file://..."``, or the dry run's
fake group) and tears it down.
"""
from __future__ import annotations

from typing import Optional

from ..sharding.mesh import (axis_sizes, current_mesh, make_mesh,  # noqa: F401
                             mesh_chips, use_mesh)

# multi_pod -> (shape, axes): 16 x 16 = 256 chips, or 2 pods of them
PRODUCTION = {False: ((16, 16), ("data", "model")),
              True: ((2, 16, 16), ("pod", "data", "model"))}


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: Optional[str] = None):
    """16 x 16 = 256 chips as ``("data", "model")``; with ``multi_pod``
    2 x 16 x 16 as ``("pod", "data", "model")``."""
    return make_mesh(*PRODUCTION[multi_pod], device_type)
