"""``repro_torch.roofline`` — the collective-schedule advisor and the
hardware constants it reads (port of ``src/repro/roofline``'s
``advisor.py`` and ``hw.py``).

The reference's ``hlo.py`` and ``terms.py`` read a compiled XLA program
(its HLO text and cost analysis); they are not ported here and go with
the mesh-bound tooling (ROADMAP queue 1 item 12).
"""
from .advisor import Advice, advise_allreduce, analytic_time
from .hw import V5E, HwSpec

__all__ = ["Advice", "advise_allreduce", "analytic_time", "V5E", "HwSpec"]
