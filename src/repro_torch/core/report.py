"""Result extraction (paper §4 'performance results', Eqs. 6-9).

Port of ``src/repro/core/report.py``.  Pure functions over a final
``SimState`` whose leaves may carry leading lane axes (``[..., N]``);
every per-job array comes out ``[..., N_J]``.  ``repro_torch.api.Results``
wraps these with pad-job masking — prefer it in new code.

The energy totals sum per-device energies; the summation order is not the
reference's, so they agree with it to float32 rounding, not bit for bit.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from .engine import SimState
from .mapreduce import (DONE, KIND_MAP, KIND_REDUCE, PHASE_IN, PHASE_OUT,
                        PHASE_SHUFFLE, SimSetup)


def _seg_max(values: torch.Tensor, seg: torch.Tensor, mask: torch.Tensor,
             n: int) -> torch.Tensor:
    """Masked per-segment max over the last axis; NaN for empty segments."""
    v = torch.where(mask, values, -torch.inf)
    out = torch.full((*v.shape[:-1], n), -torch.inf, dtype=v.dtype,
                     device=v.device)
    out = out.scatter_reduce(-1, seg.clamp(min=0).long().expand_as(v), v,
                             "amax")
    return torch.where(torch.isinf(out), torch.nan, out)


def _seg_sum(values: torch.Tensor, seg: torch.Tensor, n: int
             ) -> torch.Tensor:
    """Per-segment sum over the last axis of the entries with ``seg >= 0``."""
    v = torch.where(seg >= 0, values, torch.zeros_like(values))
    out = torch.zeros((*v.shape[:-1], n), dtype=v.dtype, device=v.device)
    return out.scatter_add(-1, seg.clamp(min=0).long().expand_as(v), v)


def job_report(setup: SimSetup, s: SimState) -> Dict[str, torch.Tensor]:
    """Per-job metrics from a setup's own arrays (on the state's device)."""
    dev = s.time.device
    return job_report_arrays(
        *(torch.as_tensor(a, device=dev) for a in (
            setup.pkt_job, setup.pkt_phase, setup.task_job,
            setup.task_kind, setup.job_release)), s)


def job_report_consts(consts, s: SimState) -> Dict[str, torch.Tensor]:
    """The same metrics from one scenario's ``EngineConsts`` (e.g. a slice
    of a packed sweep, whose job/packet tensors are padded).  Pad jobs
    come out NaN; mask with ``consts.job_valid`` before aggregating."""
    return job_report_arrays(consts.pkt_job, consts.pkt_phase,
                             consts.task_job, consts.task_kind,
                             consts.job_release, s)


def job_report_arrays(pkt_job, pkt_phase, task_job, task_kind, job_release,
                      s: SimState) -> Dict[str, torch.Tensor]:
    n_j = job_release.shape[0]
    pdur = s.pkt_finish - s.pkt_start
    pdone = s.pkt_state == DONE
    t1 = _seg_max(pdur, pkt_job, pdone & (pkt_phase == PHASE_IN), n_j)
    t2 = _seg_max(pdur, pkt_job, pdone & (pkt_phase == PHASE_SHUFFLE), n_j)
    t3 = _seg_max(pdur, pkt_job, pdone & (pkt_phase == PHASE_OUT), n_j)
    j_tr = t1 + t2 + t3                                   # Eq. 6

    tdur = s.task_finish - s.task_start
    tdone = s.task_state == DONE
    j_mp = _seg_max(tdur, task_job, tdone & (task_kind == KIND_MAP), n_j)
    j_rd = _seg_max(tdur, task_job, tdone & (task_kind == KIND_REDUCE), n_j)

    return {
        "transmission_time": j_tr,
        "t_storage_to_map": t1,
        "t_shuffle": t2,
        "t_reduce_to_storage": t3,
        "map_exec_time": j_mp,                            # Eq. 7
        "reduce_exec_time": j_rd,                         # Eq. 8
        "completion_eq9": j_tr + j_mp + j_rd,             # Eq. 9
        "completion_measured": s.job_done_t - job_release,
        "queue_delay": s.job_admit_t - job_release,
        "done_time": s.job_done_t,
        "task_reexecs": _seg_sum(s.task_restarts, task_job, n_j),
        "pkt_reroutes": _seg_sum(s.pkt_reroutes, pkt_job, n_j),
        "downtime_s": s.job_downtime,
        "install_wait_s": _seg_sum(s.pkt_install_wait, pkt_job, n_j),
    }


def energy_report(s: SimState) -> Dict[str, torch.Tensor]:
    host = s.host_energy.sum(-1)
    switch = s.switch_energy.sum(-1)
    return {
        "host_energy_j": host,
        "switch_energy_j": switch,
        "total_energy_j": host + switch,
        "makespan_s": s.time,
    }


def summarize(setup: SimSetup, s: SimState) -> Dict[str, np.ndarray]:
    """Host-side convenience: full report as numpy."""
    rep = {**job_report(setup, s), **energy_report(s)}
    rep["stalled"] = s.stalled
    rep["steps"] = s.steps
    # torchcheck: disable=item-call: the report to numpy, after the run
    return {k: v.cpu().numpy() for k, v in rep.items()}
