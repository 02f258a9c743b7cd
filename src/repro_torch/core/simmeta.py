"""``SimMeta`` — the typed, frozen, hashable static description of one
simulation program (DESIGN.md §6).

Port of ``src/repro/core/simmeta.py`` (a copy).

Everything the engine needs as a *Python* value (tensor shapes, scalar
physics constants, which feature switches are on) lives here; everything
else is data inside ``EngineConsts``/``SimState``.
"""
from __future__ import annotations

import dataclasses

from .energy import EnergyParams


@dataclasses.dataclass(frozen=True)
class SimMeta:
    """Static shape + scalar parameters shared by every lane of a run.

    The four feature switches keep the reference's fields; the port's
    engine runs only with all of them off (``make_consts`` refuses a setup
    that would turn one on).
    """

    n_nodes: int
    n_links: int
    n_hosts: int
    n_switches: int
    n_vms: int
    intra_bw: float
    energy: EnergyParams
    max_steps: int
    # some failure schedule has a finite instant (DESIGN.md §7)
    has_failures: bool = False
    # some control-plane config is non-identity (DESIGN.md §10)
    has_ctrl: bool = False
    # per-switch flow-table width; 0 when the control plane is off
    ctrl_slots: int = 0
    # some degradation schedule has a live window (DESIGN.md §13)
    has_degradation: bool = False
    # speculative-execution clone slots per job (DESIGN.md §13)
    spec_slots: int = 0
