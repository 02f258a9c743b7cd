"""Policy plug-points (paper Fig. 8) as a declarative field registry
(DESIGN.md §6).

Port of ``src/repro/core/policies.py``; the policy arrays are torch int32.

The Java tool exposes abstract policy classes; we expose integer policy ids
so one batch of lanes can mix policies per lane.  Every policy axis is
declared ONCE here as a ``PolicyField`` (name → dtype/default/engine-branch
table); everything else derives from the registry:

* ``PolicyConfig`` (the typed per-replica config) reads it at call time —
  one stable class, never a stale rebuilt binding,
* ``as_policy_arrays`` packs any config/mapping into the engine's policy
  dict, filling registered defaults.

Adding a policy axis = one ``register_policy_field`` call plus the engine
branch that reads it.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping, Optional, Tuple

import torch

# routing (paper §5.2)
from .routing import ROUTE_LEGACY, ROUTE_SDN  # noqa: F401  (re-export)
# traffic (paper Eq. 3 + beyond-paper)
from .fairshare import TRAFFIC_FAIRSHARE, TRAFFIC_WATERFILL  # noqa: F401

# MapReduce task placement (ApplicationMaster)
PLACE_LEAST_USED = 0   # paper use-case: "VM least-used first"
PLACE_ROUND_ROBIN = 1
PLACE_RANDOM = 2

# job selection (ResourceManager / ApplicationMaster queue)
JOBSEL_FCFS = 0        # paper use-case
JOBSEL_SJF = 1         # shortest (total MI) job first
JOBSEL_PRIORITY = 2    # user-supplied priority value

# recovery after a host failure (DESIGN.md §7)
RECOVERY_RESTART = 0   # YARN re-execution: lost task progress is redone
RECOVERY_RESUME = 1    # beyond-paper checkpointing: progress survives

# flow-rule installation mode (DESIGN.md §10); only meaningful when a
# control-plane config is active (SimMeta.has_ctrl)
INSTALL_REACTIVE = 0   # packet-in: rules install when a packet activates
INSTALL_PROACTIVE = 1  # pre-install a job's rules at admission (overlapped)

# dynamic VM placement under the controller (DESIGN.md §10, S-CORE)
MIG_STATIC = 0         # VMs stay where the cluster spec put them
MIG_CONGESTION = 1     # re-home a VM when its aggregate link cost exceeds
                       # CtrlPlaneConfig.mig_threshold

# YARN speculative execution (DESIGN.md §13); only meaningful when clone
# slots are provisioned (SimMeta.spec_slots > 0)
SPEC_OFF = 0           # stragglers run to completion unassisted
SPEC_ON = 1            # clone the slowest straggler, first finish wins


@dataclasses.dataclass(frozen=True)
class PolicyField:
    """One policy axis: its engine key, dtype, default and branch table."""

    name: str
    default: int
    dtype: Any = torch.int32
    choices: Optional[Mapping[str, int]] = None  # branch name -> enum value
    doc: str = ""

    def choice_name(self, value: int) -> str:
        """Human label for an enum value (falls back to the number)."""
        for k, v in (self.choices or {}).items():
            if v == int(value):
                return k
        return str(int(value))


_REGISTRY: Dict[str, PolicyField] = {}


def register_policy_field(name: str, default: int, dtype: Any = torch.int32,
                          choices: Optional[Mapping[str, int]] = None,
                          doc: str = "") -> PolicyField:
    """Declare a policy axis.  ``PolicyConfig`` reads the registry at call
    time, so the new axis is immediately a constructor keyword with its
    registered default — existing instances and import-time bindings stay
    valid."""
    if name in _REGISTRY:
        raise ValueError(f"policy field {name!r} already registered")
    field = PolicyField(name, default, dtype, choices, doc)
    _REGISTRY[name] = field
    return field


def policy_fields() -> Tuple[PolicyField, ...]:
    return tuple(_REGISTRY.values())


def policy_field_names() -> Tuple[str, ...]:
    return tuple(_REGISTRY)


def policy_defaults() -> Dict[str, int]:
    return {f.name: f.default for f in _REGISTRY.values()}


def as_policy_arrays(policy=None, **overrides) -> Dict[str, torch.Tensor]:
    """The engine's policy dict from any spelling of a policy.

    ``policy`` may be a ``PolicyConfig``, any mapping (possibly partial —
    registered defaults fill the gaps), an object with ``as_arrays()``, or
    ``None``.  Values may be scalars or per-lane arrays; each becomes a CPU
    tensor of the field's registered dtype.
    """
    if hasattr(policy, "as_arrays") and not isinstance(policy, Mapping):
        src: Mapping[str, Any] = policy.as_arrays()
    elif policy is None:
        src = {}
    elif isinstance(policy, Mapping):
        src = policy
    else:
        raise TypeError(f"cannot interpret {type(policy).__name__} "
                        "as a policy")
    merged = {**src, **overrides}
    unknown = set(merged) - set(_REGISTRY)
    if unknown:
        raise KeyError(f"unregistered policy field(s): {sorted(unknown)}; "
                       f"known: {list(_REGISTRY)}")
    return {f.name: torch.as_tensor(merged.get(f.name, f.default),
                                    dtype=f.dtype)
            for f in _REGISTRY.values()}


class PolicyConfig:
    """One replica's policy selection — every field may also be a per-lane
    array.  Fields are the registered policy axes (DESIGN.md §6), read from
    the registry at call time: one ``register_policy_field`` call makes a
    new axis a constructor keyword everywhere, with no stale class bindings.
    """

    def __init__(self, **fields):
        unknown = set(fields) - set(_REGISTRY)
        if unknown:
            raise TypeError(
                f"unregistered policy field(s): {sorted(unknown)}; "
                f"known: {list(_REGISTRY)}")
        for f in _REGISTRY.values():
            setattr(self, f.name, fields.get(f.name, f.default))

    def as_arrays(self) -> Dict[str, torch.Tensor]:
        """Engine policy dict — derived from the registry, field by field.
        Instances created before a late registration fall back to the new
        field's default."""
        return {f.name: torch.as_tensor(getattr(self, f.name, f.default),
                                        dtype=f.dtype)
                for f in _REGISTRY.values()}

    def replace(self, **fields) -> "PolicyConfig":
        """A copy with the given registered fields replaced."""
        cur = {f.name: getattr(self, f.name, f.default)
               for f in _REGISTRY.values()}
        cur.update(fields)
        return PolicyConfig(**cur)

    def __repr__(self) -> str:
        body = ", ".join(f"{f.name}={getattr(self, f.name, f.default)!r}"
                         for f in _REGISTRY.values())
        return f"PolicyConfig({body})"

    def __eq__(self, other) -> bool:
        if not isinstance(other, PolicyConfig):
            return NotImplemented
        return all(getattr(self, f.name, f.default)
                   == getattr(other, f.name, f.default)
                   for f in _REGISTRY.values())


# ---------------------------------------------------------------------------
# the registered policy axes (the ONE declaration site)
# ---------------------------------------------------------------------------

register_policy_field(
    "routing", ROUTE_SDN,
    choices={"legacy": ROUTE_LEGACY, "sdn": ROUTE_SDN},
    doc="route choice among equal-hop candidates (paper §5.2)")
register_policy_field(
    "traffic", TRAFFIC_FAIRSHARE,
    choices={"fairshare": TRAFFIC_FAIRSHARE, "waterfill": TRAFFIC_WATERFILL},
    doc="channel bandwidth sharing (paper Eq. 3 / beyond-paper max-min)")
register_policy_field(
    "placement", PLACE_LEAST_USED,
    choices={"least-used": PLACE_LEAST_USED, "round-robin": PLACE_ROUND_ROBIN,
             "random": PLACE_RANDOM},
    doc="MapReduce task placement (ApplicationMaster)")
register_policy_field(
    "job_selection", JOBSEL_FCFS,
    choices={"fcfs": JOBSEL_FCFS, "sjf": JOBSEL_SJF,
             "priority": JOBSEL_PRIORITY},
    doc="admission order (ResourceManager queue)")
register_policy_field(
    "job_concurrency", 1_000_000,  # paper use-case: effectively unlimited
    doc="max jobs admitted concurrently (ApplicationMaster width)")
register_policy_field(
    "recovery", RECOVERY_RESTART,
    choices={"restart": RECOVERY_RESTART, "resume": RECOVERY_RESUME},
    doc="host-failure recovery: YARN re-execution vs checkpoint resume "
        "(DESIGN.md §7)")
register_policy_field(
    "install_mode", INSTALL_REACTIVE,
    choices={"reactive": INSTALL_REACTIVE, "proactive": INSTALL_PROACTIVE},
    doc="flow-rule installation: packet-in reactive vs pre-install at job "
        "admission (DESIGN.md §10; inert unless SimMeta.has_ctrl)")
register_policy_field(
    "migration", MIG_STATIC,
    choices={"static": MIG_STATIC, "congestion": MIG_CONGESTION},
    doc="dynamic VM placement: migrate-on-congestion re-homing "
        "(DESIGN.md §10; inert unless SimMeta.has_ctrl)")
register_policy_field(
    "speculation", SPEC_OFF,
    choices={"off": SPEC_OFF, "on": SPEC_ON},
    doc="YARN speculative execution: clone the slowest straggler task "
        "into a pre-allocated per-job slot, first finish wins "
        "(DESIGN.md §13; inert unless SimMeta.spec_slots > 0)")
register_policy_field(
    "seed", 0,
    doc="per-replica hash seed (random placement / legacy route pins)")
