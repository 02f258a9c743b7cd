"""``repro_torch.api`` — the experiment front door (port of
``src/repro/api``: ``Experiment`` and ``Results`` for one scenario).

    from repro_torch.api import Experiment, PolicyConfig
"""
from ..core.policies import (PolicyConfig, PolicyField, as_policy_arrays,
                             policy_defaults, policy_field_names,
                             policy_fields, register_policy_field)
from ..core.simmeta import SimMeta
from .experiment import Experiment
from .results import Results

__all__ = [
    "Experiment", "Results", "SimMeta",
    "PolicyConfig", "PolicyField", "as_policy_arrays", "policy_defaults",
    "policy_field_names", "policy_fields", "register_policy_field",
]
