"""``repro_torch.roofline`` — the collective-schedule advisor, the
hardware constants, and the roofline terms of one step (port of
``src/repro/roofline``'s ``advisor.py``, ``hw.py`` and ``terms.py``).

``counting.py`` stands in for the compiled XLA artifact the reference's
terms read: it counts one eager run on fake tensors (FLOPs, bytes, peak
live bytes, ops).  ``collectives.py`` stands in for the reference's
``hlo.py``: it records the functional collectives a run dispatches and
gives their wire bytes.
"""
from .advisor import Advice, advise_allreduce, analytic_time
from .collectives import (CollectiveRecord, CollectiveStats,
                          collective_stats, record_collectives)
from .counting import Counts, count
from .hw import H100, V5E, HwSpec
from .terms import (RooflineReport, analyze_raw, count_active_params,
                    count_params, model_flops, model_flops_cell,
                    peak_memory, raw_counts)

__all__ = ["Advice", "advise_allreduce", "analytic_time", "Counts", "count",
           "CollectiveRecord", "CollectiveStats", "collective_stats",
           "record_collectives",
           "H100", "V5E", "HwSpec", "RooflineReport", "analyze_raw",
           "raw_counts", "peak_memory", "count_active_params",
           "count_params", "model_flops", "model_flops_cell"]
