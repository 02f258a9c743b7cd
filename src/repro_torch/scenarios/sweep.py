"""Pack heterogeneous scenarios into one padded batch (DESIGN.md §5).

Port of ``src/repro/scenarios/sweep.py``.  Different topologies produce
different-shaped ``SimSetup`` tensors (node, link, VM, job, task, packet
counts all vary).  ``pack_setups`` pads every scenario to the batch maxima
and RENUMBERS nodes into a common layout

    hosts [0, H) | switches [H, H+SW) | storage [H+SW, H+SW+ST)

(H/SW/ST = padded maxima) so the engine's static host/switch tensor slices
hold for every replica.  Pad slots are inert by construction:

  * pad links have bw=0 and appear on no route,
  * pad jobs/tasks/packets carry valid=False (→ VOID at init),
  * pad VM slots are excluded from placement via ``EngineConsts.n_vms``,
  * pad hosts/switches idle at 0 W (the energy model zeroes idle devices),
  * pad hosts and links never fail (``inf`` instants).

The same renumbering, pad values and ``SimMeta`` merge as the reference,
so each packed scenario runs as its own single run on its unpadded
prefix.  The runner (``repro_torch.api.runners``, kind "grid") runs one
engine loop per scenario over ``slice_packed(consts, si)``.

Caveat (the reference's): renumbering is outcome-invariant for MapReduce
setups, but a ``core.flows`` setup addresses nodes directly via
NODE_OFFSET ids, and under ``ROUTE_LEGACY`` those ids feed the flow hash,
so exact times can differ from a single run.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Sequence, Tuple

import numpy as np
import torch

from ..core.ctrlplane import no_ctrl
from ..core.engine import (EngineConsts, NODE_OFFSET, SimState,
                           UNREACHABLE_HOPS, default_max_steps,
                           job_n_tasks_np, job_valid_mask, refuse_unported,
                           task_rank_in_job_np)
from ..core.failures import no_degradation, no_failures
from ..core.mapreduce import SimSetup
from ..core.policies import as_policy_arrays, policy_field_names
from ..core.report import energy_report, job_report_consts
from ..core.simmeta import SimMeta
from ..device import resolve


def _pad1(a: np.ndarray, n: int, fill) -> np.ndarray:
    out = np.full((n,) + a.shape[1:], fill, dtype=a.dtype)
    out[: a.shape[0]] = a
    return out


def _pack_one(setup: SimSetup, dims: Dict[str, int]) -> Dict[str, np.ndarray]:
    """One scenario's EngineConsts fields, padded + renumbered to ``dims``."""
    topo = setup.cluster.topo
    rt = setup.route_table
    sched = setup.failures or no_failures(topo.n_hosts, topo.n_links)
    deg = setup.degradation or no_degradation(topo.n_hosts, topo.n_links)
    cfg = setup.ctrl or no_ctrl()
    H, SW = dims["n_hosts"], dims["n_switches"]
    Nn, L, K, HP = (dims["n_nodes"], dims["n_links"], dims["k_max"],
                    dims["max_hops"])
    n_h, n_sw = topo.n_hosts, topo.n_switches

    def node_map(ids):
        ids = np.asarray(ids, np.int64)
        return np.where(
            ids < n_h, ids,
            np.where(ids < n_h + n_sw, ids - n_h + H,
                     ids - (n_h + n_sw) + H + SW)).astype(np.int32)

    def task_ref_map(a):
        # -1 = SAN, >= NODE_OFFSET = direct node id (needs renumbering),
        # otherwise a task index (unchanged: tasks pad by appending).
        a = np.asarray(a, np.int64)
        return np.where(a >= NODE_OFFSET,
                        NODE_OFFSET + node_map(a - NODE_OFFSET),
                        a).astype(np.int32)

    # routes: scatter each (src, dst) pair into the renumbered pair index
    m_ids = node_map(np.arange(topo.n_nodes))
    new_pair = (m_ids[:, None].astype(np.int64) * Nn
                + m_ids[None, :]).reshape(-1)
    routes = np.full((Nn * Nn, K, HP), -1, np.int32)
    routes[new_pair, : rt.k_max, : rt.max_hops] = rt.routes
    n_cand = np.zeros((Nn * Nn,), np.int32)
    n_cand[new_pair] = rt.n_cand
    # candidate-0 hop counts at the padded pair layout: pad pairs are
    # unreachable, the padded diagonal stays 0
    pair_hops = np.full((Nn * Nn,), UNREACHABLE_HOPS, np.int32)
    pair_hops[new_pair] = np.where(rt.n_cand > 0, rt.route_len[:, 0],
                                   UNREACHABLE_HOPS).astype(np.int32)
    diag = np.arange(Nn, dtype=np.int64)
    pair_hops[diag * Nn + diag] = 0

    # failure schedule: pad hosts/links never fail; the breakpoint tensor
    # is rebuilt from the PADDED windows (``FailureSchedule.instants``'s
    # layout at the padded dims)
    sched_pad = {
        "host_fail_t": _pad1(np.asarray(sched.host_fail_t, np.float32),
                             H, np.inf),
        "host_recover_t": _pad1(np.asarray(sched.host_recover_t, np.float32),
                                H, np.inf),
        "link_fail_t": _pad1(np.asarray(sched.link_fail_t, np.float32),
                             L, np.inf),
        "link_recover_t": _pad1(np.asarray(sched.link_recover_t, np.float32),
                                L, np.inf),
    }

    # degradation schedule: pad devices never degrade (slow_t=inf,
    # factor=1.0); inert windows masked to inf, like the unpacked path
    deg_pad = {
        "host_slow_t": _pad1(np.asarray(deg.host_slow_t, np.float32),
                             H, np.inf),
        "host_restore_t": _pad1(np.asarray(deg.host_restore_t, np.float32),
                                H, np.inf),
        "host_deg_factor": _pad1(np.asarray(deg.host_factor, np.float32),
                                 H, 1.0),
        "link_slow_t": _pad1(np.asarray(deg.link_slow_t, np.float32),
                             L, np.inf),
        "link_restore_t": _pad1(np.asarray(deg.link_restore_t, np.float32),
                                L, np.inf),
        "link_deg_factor": _pad1(np.asarray(deg.link_factor, np.float32),
                                 L, 1.0),
    }
    lh = (np.isfinite(deg_pad["host_slow_t"])
          & (deg_pad["host_deg_factor"] != 1.0))
    ll = (np.isfinite(deg_pad["link_slow_t"])
          & (deg_pad["link_deg_factor"] != 1.0))
    deg_breaks = np.concatenate([
        np.where(lh, deg_pad["host_slow_t"], np.inf),
        np.where(lh, deg_pad["host_restore_t"], np.inf),
        np.where(ll, deg_pad["link_slow_t"], np.inf),
        np.where(ll, deg_pad["link_restore_t"], np.inf),
    ]).astype(np.float32)

    cl = setup.cluster
    return {
        "routes": routes,
        "n_cand": n_cand,
        "link_bw": _pad1(np.asarray(topo.link_bw, np.float32), L, 0.0),
        "link_src": _pad1(node_map(topo.link_src), L, 0),
        "link_dst": _pad1(node_map(topo.link_dst), L, 0),
        "vm_host": _pad1(np.asarray(cl.vm_host, np.int32), dims["n_vms"], 0),
        "vm_total_mips": _pad1(np.asarray(cl.vm_total_mips, np.float32),
                               dims["n_vms"], 0.0),
        "vm_core_mips": _pad1(np.asarray(cl.vm_core_mips, np.float32),
                              dims["n_vms"], 0.0),
        # pad hosts get 1 MIPS (not 0) so utilization never divides 0/0;
        # they run no tasks, so util=0 -> 0 W.
        "host_total_mips": _pad1(np.asarray(cl.host_total_mips, np.float32),
                                 H, 1.0),
        "job_release": _pad1(np.asarray(setup.job_release, np.float32),
                             dims["n_jobs"], 0.0),
        "job_total_mi": _pad1(np.asarray(setup.job_total_mi, np.float32),
                              dims["n_jobs"], 0.0),
        "job_priority": _pad1(np.asarray(setup.job_priority, np.float32),
                              dims["n_jobs"], 0.0),
        "job_n_out": _pad1(np.asarray(setup.job_n_out, np.int32),
                           dims["n_jobs"], 0),
        "job_valid": _pad1(np.asarray(job_valid_mask(setup.job_n_out)),
                           dims["n_jobs"], False),
        "task_job": _pad1(np.asarray(setup.task_job, np.int32),
                          dims["n_tasks"], -1),
        "task_kind": _pad1(np.asarray(setup.task_kind, np.int8),
                           dims["n_tasks"], 0),
        "task_mi": _pad1(np.asarray(setup.task_mi, np.float32),
                         dims["n_tasks"], 0.0),
        "task_need": _pad1(np.asarray(setup.task_need, np.int32),
                           dims["n_tasks"], 0),
        "task_valid": _pad1(np.asarray(setup.task_valid), dims["n_tasks"],
                            False),
        "task_rank_in_job": task_rank_in_job_np(
            _pad1(np.asarray(setup.task_job, np.int32), dims["n_tasks"], -1)),
        "job_n_tasks": job_n_tasks_np(setup.task_job, setup.task_valid,
                                      dims["n_jobs"]),
        "pkt_job": _pad1(np.asarray(setup.pkt_job, np.int32),
                         dims["n_packets"], -1),
        "pkt_phase": _pad1(np.asarray(setup.pkt_phase, np.int8),
                           dims["n_packets"], 0),
        "pkt_bits": _pad1(np.asarray(setup.pkt_bits, np.float32),
                          dims["n_packets"], 0.0),
        "pkt_gate_task": _pad1(np.asarray(setup.pkt_gate_task, np.int32),
                               dims["n_packets"], -1),
        "pkt_feeds_task": _pad1(np.asarray(setup.pkt_feeds_task, np.int32),
                                dims["n_packets"], -1),
        "pkt_src_task": _pad1(task_ref_map(setup.pkt_src_task),
                              dims["n_packets"], -1),
        "pkt_dst_task": _pad1(task_ref_map(setup.pkt_dst_task),
                              dims["n_packets"], -1),
        "pkt_valid": _pad1(np.asarray(setup.pkt_valid), dims["n_packets"],
                           False),
        "n_hosts": np.int32(n_h),
        "n_switches": np.int32(n_sw),
        "storage_node": node_map(cl.storage_node)[()],
        "n_vms": np.int32(cl.vm_host.shape[0]),
        **sched_pad,
        "fail_breaks": np.concatenate([
            sched_pad["host_fail_t"], sched_pad["host_recover_t"],
            sched_pad["link_fail_t"], sched_pad["link_recover_t"]]),
        **deg_pad,
        "deg_breaks": deg_breaks,
        # control plane: identity scalars when the replica carries no
        # config
        "ctrl_on": np.bool_(cfg.any_ctrl),
        "ctrl_latency": np.float32(cfg.install_latency),
        "ctrl_rate": np.float32(cfg.ctrl_rate),
        "mig_threshold": np.float32(cfg.mig_threshold),
        "mig_cost": np.float32(cfg.mig_cost),
        "mig_cooldown": np.float32(cfg.mig_cooldown),
        "mig_limit": np.int32(cfg.mig_limit),
        "pair_hops": pair_hops,
        "ctrl_fail_t": np.float32(cfg.ctrl_fail_t),
        "ctrl_recover_t": np.float32(cfg.ctrl_recover_t),
        "ctrl_failover_delay": np.float32(cfg.failover_delay),
        "ctrl_backup_rate": np.float32(cfg.backup_rate),
        "ctrl_backup_latency": np.float32(cfg.backup_latency),
    }


def pack_setups(setups: Sequence[SimSetup], device=None
                ) -> Tuple[EngineConsts, SimMeta]:
    """Pad + stack setups into batched EngineConsts (leading dim =
    scenario) on ``device`` (``None`` = CUDA) and the shared static
    ``SimMeta``.  Refuses, as ``make_consts`` does, a setup with a live
    control-plane config, a live degradation schedule or speculation
    slots."""
    assert len(setups) >= 1
    dev = resolve(device)
    for s in setups:
        refuse_unported(s)
        if s.failures is not None:
            topo = s.cluster.topo
            s.failures.validate(topo.n_hosts, topo.n_links)
    intra = {s.cluster.intra_bw for s in setups}
    energy = {s.cluster.energy for s in setups}
    assert len(intra) == 1, "scenarios must share intra_bw (engine scalar)"
    assert len(energy) == 1, "scenarios must share EnergyParams"

    dims = {
        "n_hosts": max(s.cluster.topo.n_hosts for s in setups),
        "n_switches": max(s.cluster.topo.n_switches for s in setups),
        "n_storage": max(s.cluster.topo.n_storage for s in setups),
        "n_links": max(s.cluster.topo.n_links for s in setups),
        "k_max": max(s.route_table.k_max for s in setups),
        "max_hops": max(s.route_table.max_hops for s in setups),
        "n_jobs": max(s.n_jobs for s in setups),
        "n_tasks": max(s.n_tasks for s in setups),
        "n_packets": max(s.n_packets for s in setups),
        "n_vms": max(int(s.cluster.vm_host.shape[0]) for s in setups),
    }
    dims["n_nodes"] = dims["n_hosts"] + dims["n_switches"] + dims["n_storage"]

    packed = [_pack_one(s, dims) for s in setups]
    consts = EngineConsts(**{
        f: torch.as_tensor(np.stack([p[f] for p in packed]), device=dev)
        for f in EngineConsts._fields})
    meta = SimMeta(
        n_nodes=dims["n_nodes"],
        n_links=dims["n_links"],
        n_hosts=dims["n_hosts"],
        n_switches=dims["n_switches"],
        n_vms=dims["n_vms"],
        intra_bw=next(iter(intra)),
        energy=next(iter(energy)),
        max_steps=max(default_max_steps(s) for s in setups),
        has_failures=any(s.failures is not None and s.failures.any_failures
                         for s in setups),
    )
    return consts, meta


def slice_packed(consts: EngineConsts, si: int) -> EngineConsts:
    """Scenario ``si``'s unbatched ``EngineConsts`` view of a packed batch.

    A plain leading-axis slice: every leaf keeps the PADDED dims, so the
    packed ``SimMeta`` stays valid for the slice and states computed from
    it stack back into the packed ``[S, P, ...]`` grid bit-exactly."""
    return EngineConsts(*(a[si] for a in consts))


# ---------------------------------------------------------------------------
# scenario × policy grid
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class SweepResult:
    """Final states of a scenario×policy grid plus labels, replica-major
    ordering ``r = scenario_index * n_policies + policy_index``.  ``consts``
    stays un-replicated ([S] leading dim) — replica r's consts are
    ``consts[r // n_policies]``."""

    states: Any                # SimState, every leaf [S*P, ...]
    consts: EngineConsts       # packed consts, every leaf [S, ...]
    meta: SimMeta
    scenario_names: List[str]  # [S*P]
    policy_names: List[str]    # [S*P]
    n_policies: int

    def rows(self) -> List[Dict[str, Any]]:
        """Per-replica summary: completion/transmission means over VALID
        jobs, energy, makespan, stall flag."""
        P = self.n_policies
        S = len(self.scenario_names) // P
        grid = SimState(*(a.reshape((S, P) + a.shape[1:])
                          for a in self.states))
        rep = [{k: v.cpu().numpy() for k, v in job_report_consts(
            slice_packed(self.consts, si),
            SimState(*(a[si] for a in grid))).items()} for si in range(S)]
        en = {k: v.cpu().numpy() for k, v in energy_report(grid).items()}
        valid = self.consts.job_valid.cpu().numpy()  # [S, N_J]
        stalled = self.states.stalled.cpu().numpy()

        def finite_mean(a):
            # stalled replicas leave NaN for every valid job
            a = a[np.isfinite(a)]
            return float(a.mean()) if a.size else float("nan")

        out = []
        for r in range(len(self.scenario_names)):
            si, pi = divmod(r, P)
            v = valid[si]
            out.append({
                "scenario": self.scenario_names[r],
                "policy": self.policy_names[r],
                "mean_completion_s": finite_mean(
                    rep[si]["completion_measured"][pi][v]),
                "mean_transmission_s": finite_mean(
                    rep[si]["transmission_time"][pi][v]),
                "energy_kwh": float(en["total_energy_j"][si, pi]) / 3.6e6,
                "makespan_s": float(en["makespan_s"][si, pi]),
                "stalled": bool(stalled[r]),
            })
        return out


def policy_arrays(policies: Sequence[Any]) -> Dict[str, torch.Tensor]:
    """Registry-ordered ``[P]`` int32 CPU tensors from a list of
    PolicyConfig (or partial mappings — registered defaults fill the
    gaps)."""
    stacked = [as_policy_arrays(p) for p in policies]
    return {name: torch.stack([s[name] for s in stacked])
            for name in policy_field_names()}


def sweep_grid(scenarios: Sequence[Tuple[str, SimSetup]],
               policies: Sequence[Tuple[str, Any]],
               device=None) -> SweepResult:
    """Every (scenario, policy) combination through
    ``repro_torch.api.Experiment``, adapted to the flat replica-major
    ``SweepResult`` shape (the reference's spelling)."""
    from ..api import Experiment
    res = Experiment(list(scenarios), list(policies), device=device).run()
    S, P = res.n_scenarios, res.n_policies
    states = SimState(*(a.reshape((S * P,) + a.shape[2:])
                        for a in res.states))
    # label from the caller's own name lists, not res.*_names — Experiment
    # de-duplicates repeated names (#n suffix)
    scenario_names = [n for n, _ in scenarios]
    policy_names = [pn for pn, _ in policies]
    return SweepResult(
        states=states, consts=res.consts, meta=res.meta,
        scenario_names=[n for n in scenario_names for _ in range(P)],
        policy_names=[pn for _ in scenario_names for pn in policy_names],
        n_policies=P,
    )
