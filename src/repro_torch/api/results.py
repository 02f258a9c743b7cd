"""``Results`` — one result surface for every experiment shape
(DESIGN.md §6).

Port of ``src/repro/api/results.py``: states are held as a ``[S, P, ...]``
grid (S scenarios × P policies, both possibly 1) and every accessor masks
pad jobs via ``consts.job_valid`` before aggregating, so a padded
heterogeneous batch and a single run read identically.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List

import numpy as np

from ..core.engine import EngineConsts, SimState
from ..core.report import energy_report, job_report_consts
from ..core.simmeta import SimMeta
from ..scenarios.sweep import slice_packed


def _finite_mean(a: np.ndarray) -> float:
    """Mean over finite entries; NaN when none (e.g. a stalled replica)."""
    a = a[np.isfinite(a)]
    return float(a.mean()) if a.size else float("nan")


@dataclasses.dataclass
class Results:
    """Final states of an ``Experiment`` run.

    ``states`` leaves are ``[S, P, ...]`` (on the run's device);
    ``consts`` leaves keep the scenario axis only (``[S, ...]``) — policy
    replicas share them.
    """

    states: SimState           # leaves [S, P, ...]
    consts: EngineConsts       # leaves [S, ...]
    meta: SimMeta
    scenario_names: List[str]  # [S]
    policy_names: List[str]    # [P]
    _jr: dict = dataclasses.field(default=None, repr=False, compare=False)
    _er: dict = dataclasses.field(default=None, repr=False, compare=False)

    @property
    def n_scenarios(self) -> int:
        return len(self.scenario_names)

    @property
    def n_policies(self) -> int:
        return len(self.policy_names)

    def __len__(self) -> int:
        return self.n_scenarios * self.n_policies

    def state(self, scenario: int = 0, policy: int = 0) -> SimState:
        """The unbatched final SimState of one (scenario, policy) cell."""
        return SimState(*(leaf[scenario, policy] for leaf in self.states))

    def job_report(self) -> Dict[str, np.ndarray]:
        """Per-job metrics (paper Eqs. 6–9), every array ``[S, P, N_J]``.

        Pad jobs of a packed heterogeneous batch are NaN — aggregate with
        nan-aware reductions and the numbers match the unpadded runs."""
        if self._jr is None:
            c = self.consts
            per = [job_report_consts(
                slice_packed(c, si),
                SimState(*(leaf[si] for leaf in self.states)))
                for si in range(self.n_scenarios)]
            valid = c.job_valid.cpu().numpy()[:, None, :]   # [S, 1, N_J]
            self._jr = {k: np.where(valid, np.stack(
                [rep[k].cpu().numpy() for rep in per]), np.nan)
                for k in per[0]}
        return self._jr

    def energy_report(self) -> Dict[str, np.ndarray]:
        """Energy + makespan, every array ``[S, P]``."""
        if self._er is None:
            self._er = {k: v.cpu().numpy()
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
        """Per-cell scalar summary, scenario-major, the reference's row
        keys and values: valid-job completion/transmission means, energy,
        makespan, stall flag, the recovery totals (re-executed tasks,
        rerouted packets, summed downtime; zero without a failure
        schedule) and the control-plane and chaos totals (zero: those
        features are not ported yet)."""
        jr = self.job_report()
        er = self.energy_report()
        st = {k: getattr(self.states, k).cpu().numpy() for k in (
            "stalled", "steps", "ctrl_installs", "ctrl_evictions",
            "ctrl_reinstalls", "ctrl_queue_wait", "spec_launches",
            "spec_wins", "spec_wasted", "degraded_time", "ctrl_failovers",
            "ctrl_failover_park")}
        migrations = self.states.vm_migrations.cpu().numpy().sum(-1)
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
