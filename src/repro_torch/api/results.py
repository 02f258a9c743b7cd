"""``Results`` — the result surface of an ``Experiment`` run (DESIGN.md §6).

Port of ``src/repro/api/results.py`` for one scenario: the final states
are the ``[P, ...]`` lanes of one run, and every report keeps the
reference's ``[S, P, ...]`` layout with ``S = 1``.  Pad jobs are masked to
NaN via ``consts.job_valid`` before aggregating.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List

import numpy as np

from ..core.engine import EngineConsts, SimState
from ..core.report import energy_report, job_report_arrays
from ..core.simmeta import SimMeta


def _finite_mean(a: np.ndarray) -> float:
    """Mean over finite entries; NaN when none (e.g. a stalled replica)."""
    a = a[np.isfinite(a)]
    return float(a.mean()) if a.size else float("nan")


@dataclasses.dataclass
class Results:
    """Final states of an ``Experiment`` run.

    ``states`` leaves are ``[P, ...]`` (one lane per policy, on the run's
    device); ``consts`` are the scenario's, shared by every lane.
    """

    states: SimState
    consts: EngineConsts
    meta: SimMeta
    scenario_names: List[str]  # [1]
    policy_names: List[str]    # [P]
    _jr: dict = dataclasses.field(default=None, repr=False, compare=False)
    _er: dict = dataclasses.field(default=None, repr=False, compare=False)

    def state(self, scenario: int = 0, policy: int = 0) -> SimState:
        """The unbatched final SimState of one (scenario, policy) cell."""
        if scenario != 0:
            raise IndexError("a repro_torch Results holds one scenario")
        return SimState(*(leaf[policy] for leaf in self.states))

    def job_report(self) -> Dict[str, np.ndarray]:
        """Per-job metrics (paper Eqs. 6–9), every array ``[1, P, N_J]``."""
        if self._jr is None:
            c = self.consts
            rep = job_report_arrays(c.pkt_job, c.pkt_phase, c.task_job,
                                    c.task_kind, c.job_release, self.states)
            valid = c.job_valid.cpu().numpy()[None, None, :]
            self._jr = {k: np.where(valid, v.cpu().numpy()[None], np.nan)
                        for k, v in rep.items()}
        return self._jr

    def energy_report(self) -> Dict[str, np.ndarray]:
        """Energy + makespan, every array ``[1, P]``."""
        if self._er is None:
            self._er = {k: v.cpu().numpy()[None]
                        for k, v in energy_report(self.states).items()}
        return self._er

    def summary(self, scenario: int = 0, policy: int = 0
                ) -> Dict[str, np.ndarray]:
        """One cell's full report as numpy."""
        jr = {k: v[scenario, policy] for k, v in self.job_report().items()}
        er = {k: v[scenario, policy] for k, v in self.energy_report().items()}
        s = self.state(scenario, policy)
        return {**jr, **er,
                "stalled": s.stalled.cpu().numpy(),
                "steps": s.steps.cpu().numpy()}

    def rows(self) -> List[Dict[str, Any]]:
        """Per-cell scalar summary, the reference's row keys and values."""
        jr = self.job_report()
        er = self.energy_report()
        st = {k: getattr(self.states, k).cpu().numpy()[None] for k in (
            "stalled", "steps", "ctrl_installs", "ctrl_evictions",
            "ctrl_reinstalls", "ctrl_queue_wait", "spec_launches",
            "spec_wins", "spec_wasted", "degraded_time", "ctrl_failovers",
            "ctrl_failover_park")}
        migrations = self.states.vm_migrations.cpu().numpy()[None].sum(-1)
        out = []
        for si, sn in enumerate(self.scenario_names):
            for pi, pn in enumerate(self.policy_names):
                out.append({
                    "scenario": sn,
                    "policy": pn,
                    "mean_completion_s": _finite_mean(
                        jr["completion_measured"][si, pi]),
                    "mean_transmission_s": _finite_mean(
                        jr["transmission_time"][si, pi]),
                    "energy_kwh": float(er["total_energy_j"][si, pi]) / 3.6e6,
                    "makespan_s": float(er["makespan_s"][si, pi]),
                    "stalled": bool(st["stalled"][si, pi]),
                    "steps": int(st["steps"][si, pi]),
                    "task_reexecs": int(np.nansum(
                        jr["task_reexecs"][si, pi])),
                    "pkt_reroutes": int(np.nansum(
                        jr["pkt_reroutes"][si, pi])),
                    "downtime_s": float(np.nansum(
                        jr["downtime_s"][si, pi])),
                    "install_wait_s": float(np.nansum(
                        jr["install_wait_s"][si, pi])),
                    "rule_installs": int(st["ctrl_installs"][si, pi]),
                    "rule_evictions": int(st["ctrl_evictions"][si, pi]),
                    "rule_reinstalls": int(st["ctrl_reinstalls"][si, pi]),
                    "ctrl_queue_wait_s": float(st["ctrl_queue_wait"][si, pi]),
                    "vm_migrations": int(migrations[si, pi]),
                    "spec_launches": int(st["spec_launches"][si, pi]),
                    "spec_wins": int(st["spec_wins"][si, pi]),
                    "wasted_spec_work_s": float(st["spec_wasted"][si, pi]),
                    "degraded_time_s": float(st["degraded_time"][si, pi]),
                    "failover_count": int(st["ctrl_failovers"][si, pi]),
                    "failover_park_s": float(
                        st["ctrl_failover_park"][si, pi]),
                })
        return out
