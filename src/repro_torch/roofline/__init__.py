"""``repro_torch.roofline`` — the collective-schedule advisor, the
hardware constants, and the roofline terms of one step (port of
``src/repro/roofline``'s ``advisor.py``, ``hw.py`` and ``terms.py``).

``counting.py`` stands in for the compiled XLA artifact the reference's
terms read: it counts one eager run on fake tensors (FLOPs, bytes, peak
live bytes, ops).  The reference's ``hlo.py`` reads the collectives of a
sharded XLA program; it goes with the mesh-bound tooling (ROADMAP queue 1
item 12b).
"""
from .advisor import Advice, advise_allreduce, analytic_time
from .counting import Counts, count
from .hw import H100, V5E, HwSpec
from .terms import (RooflineReport, analyze_raw, count_active_params,
                    count_params, model_flops, model_flops_cell,
                    peak_memory, raw_counts)

__all__ = ["Advice", "advise_allreduce", "analytic_time", "Counts", "count",
           "H100", "V5E", "HwSpec", "RooflineReport", "analyze_raw",
           "raw_counts", "peak_memory", "count_active_params",
           "count_params", "model_flops", "model_flops_cell"]
