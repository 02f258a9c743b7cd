"""``repro_torch.api`` — the experiment front door (port of ``src/repro/api``:
``Experiment``, ``Results``, the runner cache, the fleet engine and the
streaming ring).

    from repro_torch.api import Experiment, PolicyConfig
"""
from ..core.policies import (PolicyConfig, PolicyField, as_policy_arrays,
                             policy_defaults, policy_field_names,
                             policy_fields, register_policy_field)
from ..core.simmeta import SimMeta
from . import runners
from .experiment import Experiment, consts_build_count, consts_cache_clear
from .fleet import CohortSchedule, FleetStats, StepPredictor, run_fleet
from .results import Results
from .runners import get_runner
from .stream import StreamResults, StreamStats, run_stream

__all__ = [
    "Experiment", "Results", "SimMeta",
    "PolicyConfig", "PolicyField", "as_policy_arrays", "policy_defaults",
    "policy_field_names", "policy_fields", "register_policy_field",
    "runners", "get_runner",
    "consts_build_count", "consts_cache_clear",
    "run_fleet", "FleetStats", "StepPredictor", "CohortSchedule",
    "run_stream", "StreamResults", "StreamStats",
]
