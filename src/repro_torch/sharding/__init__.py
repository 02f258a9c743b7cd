"""``repro_torch.sharding``: the reference's sharding rules as spec trees,
their placement as DTensors, and the hints the models call (port of
``src/repro/sharding``)."""
from .rules import (P, activation_spec, batch_specs, cache_specs_tree,
                    data_axes, distribute, fsdp_params, opt_state_specs,
                    param_specs, placements, replicate_hint)

__all__ = ["P", "param_specs", "batch_specs", "activation_spec",
           "cache_specs_tree", "data_axes", "opt_state_specs", "placements",
           "distribute", "fsdp_params", "replicate_hint"]
