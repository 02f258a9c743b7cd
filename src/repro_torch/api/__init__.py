"""``repro_torch.api`` — the experiment front door (port of ``src/repro/api``:
``Experiment``, ``Results`` and the runner cache).

    from repro_torch.api import Experiment, PolicyConfig

The reference's fleet (``run_fleet``, ``FleetStats``, ``StepPredictor``,
``CohortSchedule``) and streaming (``run_stream``, ``StreamResults``,
``StreamStats``) exports come with ROADMAP queue 1 items 8 and 9.
"""
from ..core.policies import (PolicyConfig, PolicyField, as_policy_arrays,
                             policy_defaults, policy_field_names,
                             policy_fields, register_policy_field)
from ..core.simmeta import SimMeta
from . import runners
from .experiment import Experiment, consts_build_count, consts_cache_clear
from .results import Results
from .runners import get_runner

__all__ = [
    "Experiment", "Results", "SimMeta",
    "PolicyConfig", "PolicyField", "as_policy_arrays", "policy_defaults",
    "policy_field_names", "policy_fields", "register_policy_field",
    "runners", "get_runner",
    "consts_build_count", "consts_cache_clear",
]
