"""The discrete-event engine: one Python loop of whole-tensor steps.

Port of ``src/repro/core/engine.py`` (its main path).  Between events every
rate (channel bandwidth, VM MIPS share, power draw) is piecewise constant,
so the next event time is an analytic ``min`` over fixed-shape state
tensors (paper Eq. 4 generalized to packet finishes, task finishes and job
releases).  One loop iteration = one event:

  admission -> placement -> task activation -> packet activation (routed)
  -> rates -> dt = earliest horizon -> energy += power*dt -> advance
  -> completions

Lanes.  Every ``SimState`` leaf carries a leading lane axis ``[W, ...]``:
W policies on one scenario run as W lanes of one loop, the counterpart of
the reference's vmapped policy batch; a serial run is W = 1.  A finished
lane is frozen (its state no longer changes), as ``lax.cond`` under vmap
does in the reference, and the loop ends when every lane has finished.
``EngineConsts`` is shared by all lanes and has no lane axis.

Exactness.  The state, step for step, equals the reference's:

* order decides only the SDN route pick (each pick reads the channels
  admitted before it) and least-used placement (each pick reads the load
  bump before it); both stay sequential scans over the ready / admitted
  set in ascending index order, run to the largest count over lanes with
  the lanes past their own count masked;
* every other update is an integer scatter-add, exact in any order;
* per-host MIPS sums add each host's active-task rates in ascending task
  order, as the reference's compacted loop does;
* sorts are stable and argmin/argmax take the first index on ties.

Float leaves then match the reference bit for bit on the CPU; on CUDA the
water-fill's float scatter-adds are atomics (see ``fairshare``).

Scope.  Only the main path is ported: ``SimMeta.has_failures``,
``has_degradation`` and ``has_ctrl`` all False and ``spec_slots == 0``;
``make_consts`` refuses any other setup.  Left out of this module, with
the ROADMAP item that brings each:

* ``_apply_failures`` and the failure terms of ``_step`` — queue 1 item 5;
* ``_ctrl_request``, ``_ctrl_tbl``, ``_with_ctrl_tbl``, ``_activate_ctrl``,
  ``_preinstall``, ``_maybe_migrate`` — queue 1 item 6;
* ``_effective_link_bw`` / ``_effective_host_mips`` / ``_host_deg_factor``
  under degradation, ``_speculate`` — queue 1 item 7;
* ``tree_select``, ``init_fleet_carry``, ``make_fleet_chunk`` — queue 1
  item 8;
* ``simulate``, ``simulate_batch``, ``simulate_scenarios`` (deprecated
  shims in the reference) — use ``repro_torch.api.Experiment``.
"""
from __future__ import annotations

from functools import partial
from typing import Dict, NamedTuple

import numpy as np
import torch

from ..device import resolve
from . import fairshare
from .ctrlplane import no_ctrl
from .energy import host_power, switch_power
from .failures import no_degradation, no_failures
from .fp import fma32
from .mapreduce import ACTIVE, DONE, SimSetup, VOID, WAITING
from .policies import (JOBSEL_PRIORITY, JOBSEL_SJF, PLACE_RANDOM,
                       PLACE_ROUND_ROBIN)
from .routing import (ROUTE_SDN, flow_hash_u32, legacy_route_choice,
                      sdn_route_choice)
from .simmeta import SimMeta

I32 = torch.int32
F32 = torch.float32
_IMAX = torch.iinfo(I32).max


def job_valid_mask(job_n_out):
    """A job slot is live iff it expects output packets."""
    return job_n_out > 0


def task_rank_in_job_np(task_job) -> np.ndarray:
    """Host-side: position of each task among the tasks sharing its job id,
    in task-index order (pad tasks form their own ``-1`` group)."""
    tj = np.asarray(task_job, np.int64)
    order = np.argsort(tj, kind="stable")
    g = tj[order]
    n = g.shape[0]
    starts = np.r_[0, np.flatnonzero(g[1:] != g[:-1]) + 1]
    sizes = np.diff(np.r_[starts, n])
    out = np.empty(n, np.int32)
    out[order] = (np.arange(n) - np.repeat(starts, sizes)).astype(np.int32)
    return out


def job_n_tasks_np(task_job, task_valid, n_jobs: int) -> np.ndarray:
    """Host-side: valid-task count per job."""
    tj = np.asarray(task_job, np.int64)
    tv = np.asarray(task_valid, bool)
    return np.bincount(tj[tv & (tj >= 0)],
                       minlength=n_jobs).astype(np.int32)[:n_jobs]


class EngineConsts(NamedTuple):
    """Static (lane-shared) tensors, baked from SimSetup.  Field names,
    order, dtypes and shapes are the reference's."""

    # routing
    routes: torch.Tensor      # [n_nodes^2, K, H]
    n_cand: torch.Tensor      # [n_nodes^2]
    link_bw: torch.Tensor     # [n_links]
    link_src: torch.Tensor
    link_dst: torch.Tensor
    # cluster
    vm_host: torch.Tensor
    vm_total_mips: torch.Tensor
    vm_core_mips: torch.Tensor
    host_total_mips: torch.Tensor
    # jobs / tasks / packets (see mapreduce.py)
    job_release: torch.Tensor
    job_total_mi: torch.Tensor
    job_priority: torch.Tensor
    job_n_out: torch.Tensor
    job_valid: torch.Tensor
    task_job: torch.Tensor
    task_kind: torch.Tensor
    task_mi: torch.Tensor
    task_need: torch.Tensor
    task_valid: torch.Tensor
    task_rank_in_job: torch.Tensor  # int32 [n_tasks]
    job_n_tasks: torch.Tensor       # int32 [n_jobs]
    pkt_job: torch.Tensor
    pkt_phase: torch.Tensor
    pkt_bits: torch.Tensor
    pkt_gate_task: torch.Tensor
    pkt_feeds_task: torch.Tensor
    pkt_src_task: torch.Tensor
    pkt_dst_task: torch.Tensor
    pkt_valid: torch.Tensor
    # scalars
    n_hosts: torch.Tensor
    n_switches: torch.Tensor
    storage_node: torch.Tensor
    n_vms: torch.Tensor
    # failure schedule (inert on the ported path: all inf)
    host_fail_t: torch.Tensor
    host_recover_t: torch.Tensor
    link_fail_t: torch.Tensor
    link_recover_t: torch.Tensor
    fail_breaks: torch.Tensor
    # gray-failure degradation schedule (inert: inf windows, factor 1)
    host_slow_t: torch.Tensor
    host_restore_t: torch.Tensor
    host_deg_factor: torch.Tensor
    link_slow_t: torch.Tensor
    link_restore_t: torch.Tensor
    link_deg_factor: torch.Tensor
    deg_breaks: torch.Tensor
    # control plane (the identity config's values)
    ctrl_on: torch.Tensor
    ctrl_latency: torch.Tensor
    ctrl_rate: torch.Tensor
    mig_threshold: torch.Tensor
    mig_cost: torch.Tensor
    mig_cooldown: torch.Tensor
    mig_limit: torch.Tensor
    pair_hops: torch.Tensor      # i32 [n_nodes^2]
    ctrl_fail_t: torch.Tensor
    ctrl_recover_t: torch.Tensor
    ctrl_failover_delay: torch.Tensor
    ctrl_backup_rate: torch.Tensor
    ctrl_backup_latency: torch.Tensor


class SimState(NamedTuple):
    """The loop carry: the reference's fields, each with a leading lane
    axis.  The failure, control-plane and speculation fields ride along
    inert, initialised as the reference does."""

    time: torch.Tensor
    steps: torch.Tensor
    stalled: torch.Tensor
    place_counter: torch.Tensor
    # jobs
    job_admitted: torch.Tensor
    job_admit_t: torch.Tensor
    job_out_done: torch.Tensor
    job_done_t: torch.Tensor
    # tasks
    task_state: torch.Tensor
    task_rem: torch.Tensor
    task_got: torch.Tensor
    task_vm: torch.Tensor
    task_start: torch.Tensor
    task_finish: torch.Tensor
    # packets
    pkt_state: torch.Tensor
    pkt_rem: torch.Tensor
    pkt_pair: torch.Tensor
    pkt_cand: torch.Tensor
    pkt_start: torch.Tensor
    pkt_finish: torch.Tensor
    # vms / energy
    vm_load: torch.Tensor
    host_energy: torch.Tensor
    host_busy: torch.Tensor
    switch_energy: torch.Tensor
    # failure & recovery (inert)
    host_dead: torch.Tensor
    link_dead: torch.Tensor
    task_restarts: torch.Tensor
    pkt_reroutes: torch.Tensor
    job_downtime: torch.Tensor
    # control plane (inert)
    vm_host: torch.Tensor
    ftab_pair: torch.Tensor
    ftab_ready: torch.Tensor
    ftab_stamp: torch.Tensor
    ctrl_busy: torch.Tensor
    ctrl_stamp: torch.Tensor
    ctrl_installs: torch.Tensor
    ctrl_evictions: torch.Tensor
    ctrl_reinstalls: torch.Tensor
    ctrl_queue_wait: torch.Tensor
    pkt_ready_t: torch.Tensor
    pkt_install_wait: torch.Tensor
    vm_mig_until: torch.Tensor
    vm_migrations: torch.Tensor
    # gray failures, speculation & failover (inert)
    degraded_time: torch.Tensor
    spec_of: torch.Tensor
    spec_vm: torch.Tensor
    spec_rem: torch.Tensor
    spec_start: torch.Tensor
    task_cloned: torch.Tensor
    spec_launches: torch.Tensor
    spec_wins: torch.Tensor
    spec_wasted: torch.Tensor
    ctrl_failovers: torch.Tensor
    ctrl_failover_park: torch.Tensor


def default_max_steps(setup: SimSetup) -> int:
    """Step cap: the no-failure event bound (the only case the port runs)."""
    return 4 * (setup.n_packets + setup.n_tasks) + 4 * setup.n_jobs + 64


UNREACHABLE_HOPS = 1 << 20  # pair_hops sentinel: no candidate route


def pair_hops_np(route_len, n_cand, n_nodes: int) -> np.ndarray:
    """Host-side candidate-0 hop count per node pair: 0 on the diagonal,
    ``UNREACHABLE_HOPS`` where no route exists."""
    hops = np.where(np.asarray(n_cand) > 0,
                    np.asarray(route_len)[:, 0], UNREACHABLE_HOPS)
    hops = hops.astype(np.int32).copy()
    diag = np.arange(n_nodes, dtype=np.int64)
    hops[diag * n_nodes + diag] = 0
    return hops


def make_consts(setup: SimSetup, device=None) -> tuple[EngineConsts, SimMeta]:
    """Bake a setup into device tensors (``device=None`` = CUDA).

    Refuses a setup the ported path cannot run: a failure schedule with a
    finite instant, a live degradation window, a live control-plane config
    or speculation slots.  That is a refusal, not a fallback."""
    dev = resolve(device)
    rt, cl = setup.route_table, setup.cluster
    sched = setup.failures or no_failures(cl.topo.n_hosts, cl.topo.n_links)
    deg = setup.degradation or no_degradation(cl.topo.n_hosts,
                                              cl.topo.n_links)
    cfg = (setup.ctrl or no_ctrl()).validate()
    sched.validate(cl.topo.n_hosts, cl.topo.n_links)
    deg.validate(cl.topo.n_hosts, cl.topo.n_links)
    for live, what, item in (
            (sched.any_failures, "a failure schedule", "queue 1 item 5"),
            (cfg.any_ctrl, "a control-plane config", "queue 1 item 6"),
            (deg.any_degradation, "a degradation schedule",
             "queue 1 item 7"),
            (setup.spec_slots > 0, "speculation slots", "queue 1 item 7")):
        if live:
            raise NotImplementedError(
                f"repro_torch does not run {what} yet (ROADMAP {item})")

    def t(a, dtype=None):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)

    consts = EngineConsts(
        routes=t(rt.routes), n_cand=t(rt.n_cand),
        link_bw=t(cl.topo.link_bw), link_src=t(cl.topo.link_src),
        link_dst=t(cl.topo.link_dst),
        vm_host=t(cl.vm_host), vm_total_mips=t(cl.vm_total_mips),
        vm_core_mips=t(cl.vm_core_mips),
        host_total_mips=t(cl.host_total_mips),
        job_release=t(setup.job_release), job_total_mi=t(setup.job_total_mi),
        job_priority=t(setup.job_priority), job_n_out=t(setup.job_n_out),
        job_valid=t(job_valid_mask(setup.job_n_out)),
        task_job=t(setup.task_job), task_kind=t(setup.task_kind),
        task_mi=t(setup.task_mi), task_need=t(setup.task_need),
        task_valid=t(setup.task_valid),
        task_rank_in_job=t(task_rank_in_job_np(setup.task_job)),
        job_n_tasks=t(job_n_tasks_np(setup.task_job, setup.task_valid,
                                     setup.n_jobs)),
        pkt_job=t(setup.pkt_job), pkt_phase=t(setup.pkt_phase),
        pkt_bits=t(setup.pkt_bits), pkt_gate_task=t(setup.pkt_gate_task),
        pkt_feeds_task=t(setup.pkt_feeds_task),
        pkt_src_task=t(setup.pkt_src_task),
        pkt_dst_task=t(setup.pkt_dst_task), pkt_valid=t(setup.pkt_valid),
        n_hosts=t(cl.topo.n_hosts, I32), n_switches=t(cl.topo.n_switches, I32),
        storage_node=t(cl.storage_node, I32),
        n_vms=t(int(cl.vm_host.shape[0]), I32),
        host_fail_t=t(sched.host_fail_t, F32),
        host_recover_t=t(sched.host_recover_t, F32),
        link_fail_t=t(sched.link_fail_t, F32),
        link_recover_t=t(sched.link_recover_t, F32),
        fail_breaks=t(sched.instants(), F32),
        host_slow_t=t(deg.host_slow_t, F32),
        host_restore_t=t(deg.host_restore_t, F32),
        host_deg_factor=t(deg.host_factor, F32),
        link_slow_t=t(deg.link_slow_t, F32),
        link_restore_t=t(deg.link_restore_t, F32),
        link_deg_factor=t(deg.link_factor, F32),
        deg_breaks=t(deg.instants(), F32),
        ctrl_on=t(cfg.any_ctrl, torch.bool),
        ctrl_latency=t(cfg.install_latency, F32),
        ctrl_rate=t(cfg.ctrl_rate, F32),
        mig_threshold=t(cfg.mig_threshold, F32),
        mig_cost=t(cfg.mig_cost, F32),
        mig_cooldown=t(cfg.mig_cooldown, F32),
        mig_limit=t(cfg.mig_limit, I32),
        pair_hops=t(pair_hops_np(rt.route_len, rt.n_cand, cl.topo.n_nodes)),
        ctrl_fail_t=t(cfg.ctrl_fail_t, F32),
        ctrl_recover_t=t(cfg.ctrl_recover_t, F32),
        ctrl_failover_delay=t(cfg.failover_delay, F32),
        ctrl_backup_rate=t(cfg.backup_rate, F32),
        ctrl_backup_latency=t(cfg.backup_latency, F32),
    )
    meta = SimMeta(
        n_nodes=cl.topo.n_nodes, n_links=cl.topo.n_links,
        n_hosts=cl.topo.n_hosts, n_switches=cl.topo.n_switches,
        n_vms=int(cl.vm_host.shape[0]), intra_bw=cl.intra_bw,
        energy=cl.energy, max_steps=default_max_steps(setup))
    return consts, meta


def init_state_from_consts(c: EngineConsts, n_switches: int,
                           width: int = 1) -> SimState:
    """t=0 state of ``width`` lanes (every leaf ``[width, ...]``), as the
    reference's ``init_state_from_consts`` with ``ctrl_slots = spec_slots
    = 0``.  Pad job/task/packet slots start VOID/zero and stay inert."""
    n_j = c.job_release.shape[0]
    n_t = c.task_job.shape[0]
    n_p = c.pkt_job.shape[0]
    n_v = c.vm_host.shape[0]
    n_h = c.host_total_mips.shape[0]
    dev = c.link_bw.device

    def full(shape, value, dtype):
        return torch.full((width, *shape), value, dtype=dtype, device=dev)

    def lanes(a, dtype):
        return a.to(dtype).expand(width, *a.shape).clone()

    nan = float("nan")
    return SimState(
        time=full((), 0.0, F32), steps=full((), 0, I32),
        stalled=full((), False, torch.bool),
        place_counter=full((), 0, I32),
        job_admitted=full((n_j,), False, torch.bool),
        job_admit_t=full((n_j,), nan, F32),
        job_out_done=full((n_j,), 0, I32),
        job_done_t=full((n_j,), nan, F32),
        task_state=lanes(torch.where(c.task_valid, WAITING, VOID), I32),
        task_rem=lanes(c.task_mi, F32),
        task_got=full((n_t,), 0, I32),
        task_vm=full((n_t,), -1, I32),
        task_start=full((n_t,), nan, F32),
        task_finish=full((n_t,), nan, F32),
        pkt_state=lanes(torch.where(c.pkt_valid, WAITING, VOID), I32),
        pkt_rem=lanes(c.pkt_bits, F32),
        pkt_pair=full((n_p,), -1, I32),
        pkt_cand=full((n_p,), -1, I32),
        pkt_start=full((n_p,), nan, F32),
        pkt_finish=full((n_p,), nan, F32),
        vm_load=full((n_v,), 0, I32),
        host_energy=full((n_h,), 0.0, F32),
        host_busy=full((n_h,), 0.0, F32),
        switch_energy=full((n_switches,), 0.0, F32),
        host_dead=full((c.host_fail_t.shape[0],), False, torch.bool),
        link_dead=full((c.link_fail_t.shape[0],), False, torch.bool),
        task_restarts=full((n_t,), 0, I32),
        pkt_reroutes=full((n_p,), 0, I32),
        job_downtime=full((n_j,), 0.0, F32),
        vm_host=lanes(c.vm_host, I32),
        ftab_pair=full((n_switches, 0), -1, I32),
        ftab_ready=full((n_switches, 0), 0.0, F32),
        ftab_stamp=full((n_switches, 0), 0, I32),
        ctrl_busy=full((), 0.0, F32),
        ctrl_stamp=full((), 0, I32),
        ctrl_installs=full((), 0, I32),
        ctrl_evictions=full((), 0, I32),
        ctrl_reinstalls=full((), 0, I32),
        ctrl_queue_wait=full((), 0.0, F32),
        pkt_ready_t=full((n_p,), float("inf"), F32),
        pkt_install_wait=full((n_p,), 0.0, F32),
        vm_mig_until=full((n_v,), 0.0, F32),
        vm_migrations=full((n_v,), 0, I32),
        degraded_time=full((), 0.0, F32),
        spec_of=full((0,), -1, I32),
        spec_vm=full((0,), -1, I32),
        spec_rem=full((0,), 0.0, F32),
        spec_start=full((0,), 0.0, F32),
        task_cloned=full((n_t,), False, torch.bool),
        spec_launches=full((), 0, I32),
        spec_wins=full((), 0, I32),
        spec_wasted=full((), 0.0, F32),
        ctrl_failovers=full((), 0, I32),
        ctrl_failover_park=full((), 0.0, F32),
    )


# ---------------------------------------------------------------------------
# step phases (every state tensor [W, ...]; consts shared)
# ---------------------------------------------------------------------------


def _rows(w: int, device) -> torch.Tensor:
    """Lane index column ``[W, 1]`` for per-lane advanced indexing."""
    return torch.arange(w, device=device)[:, None]


def _place_batch(pol, ph, aux, s: SimState, mine, pos, vm_live,
                 n_live) -> SimState:
    """Place every task in ``mine [W, T]`` in the sequential placement order
    given by ``pos`` (each mine-task's 0-based position; garbage elsewhere).

    Round-robin and random placement need no load feedback: their picks
    are rank-plus-counter / hash arithmetic over the live-VM remap and one
    integer scatter-add.  Least-used must see each earlier placement's
    load bump, so it scans the tasks to place in position order (every
    placement id that is neither round-robin nor random takes the scan, as
    in the reference)."""
    w, n_t = mine.shape
    dev = mine.device
    counter0 = s.place_counter
    n_mine = mine.sum(1, dtype=I32)
    mod = n_live.clamp(min=1)
    vec_lane = (pol["placement"] == PLACE_ROUND_ROBIN) | (
        pol["placement"] == PLACE_RANDOM)
    vec_host = (ph["placement"] == PLACE_ROUND_ROBIN) | (
        ph["placement"] == PLACE_RANDOM)
    task_vm, vm_load = s.task_vm, s.vm_load

    if vec_host.any():
        # kth[k] = slot index of the k-th live VM (stable: live slots first
        # in ascending order, so a ``% mod`` pick never lands on a dead one)
        kth = torch.argsort((~vm_live).to(I32), stable=True)
        rr_pick = kth[(counter0[:, None].long() + pos) % mod]
        rnd_pick = kth[aux["task_hash"].long() % mod]
        pick = torch.where(pol["placement"][:, None] == PLACE_ROUND_ROBIN,
                           rr_pick, rnd_pick)
        vec = mine & vec_lane[:, None]
        task_vm = torch.where(vec, pick, task_vm).to(I32)
        vm_load = vm_load.scatter_add(1, torch.where(vec, pick, 0),
                                      vec.to(I32))

    if (~vec_host).any():
        scan = mine & ~vec_lane[:, None]
        n_scan = scan.sum(1)
        # task at each placement position (column n_t takes the rest)
        at_pos = torch.zeros((w, n_t + 1), dtype=torch.long, device=dev)
        at_pos.scatter_(1, torch.where(scan, pos, n_t),
                        torch.arange(n_t, device=dev).expand(w, n_t))
        rows = _rows(w, dev)[:, 0]
        for k in range(int(n_scan.max())):
            ok = k < n_scan
            t = at_pos[:, k]
            pick = torch.where(vm_live, vm_load, _IMAX).argmin(1)
            vm_load = vm_load.index_put((rows, pick), ok.to(I32),
                                        accumulate=True)
            cur = task_vm[rows, t]
            task_vm = task_vm.index_put((rows, t),
                                        torch.where(ok, pick.to(I32), cur))
    return s._replace(vm_load=vm_load, task_vm=task_vm,
                      place_counter=counter0 + n_mine)


def _admit_and_place(c: EngineConsts, meta, pol, ph, aux, s: SimState):
    """Admit released jobs (job-selection policy) while concurrency slots are
    free, then place each admitted job's tasks onto VMs.

    Admission is one stable sort of the released jobs by the policy key
    (ties by job index); the concurrency budget is a rank cutoff.  Returns
    ``(s, placed)``: ``placed [W]`` marks lanes whose placement changed."""
    w, n_j = s.job_admitted.shape
    dev = s.time.device
    vm_live = torch.arange(meta.n_vms, device=dev) < c.n_vms
    n_live = vm_live.sum(dtype=I32)

    released = (~s.job_admitted) & c.job_valid & (
        c.job_release <= s.time[:, None])
    running = (s.job_admitted & (s.job_out_done < c.job_n_out)
               & c.job_valid).sum(1, dtype=I32)
    slots = (pol["job_concurrency"] - running).clamp(min=0)
    sel = pol["job_selection"][:, None]
    key = torch.where(sel == JOBSEL_SJF, c.job_total_mi,
                      torch.where(sel == JOBSEL_PRIORITY, -c.job_priority,
                                  c.job_release))
    key = torch.where(released, key, torch.inf)
    ord_j = torch.argsort(key, dim=1, stable=True)
    rank = torch.empty_like(ord_j).scatter_(
        1, ord_j, torch.arange(n_j, device=dev).expand(w, n_j))
    admit_now = released & (rank < slots[:, None])
    placed = admit_now.any(1)

    if bool(placed.any()):
        job_of_task = c.task_job.clamp(min=0).long()
        mine = c.task_valid & admit_now[:, job_of_task]
        # placement position: admission-rank-major, task-index-minor
        cnt_by_rank = torch.where(torch.gather(admit_now, 1, ord_j),
                                  c.job_n_tasks[ord_j], 0)
        off_by_rank = cnt_by_rank.cumsum(1) - cnt_by_rank
        pos = torch.gather(off_by_rank, 1, rank[:, job_of_task]) \
            + c.task_rank_in_job
        s = _place_batch(pol, ph, aux, s, mine, pos, vm_live, n_live)
    s = s._replace(job_admitted=s.job_admitted | admit_now,
                   job_admit_t=torch.where(admit_now, s.time[:, None],
                                           s.job_admit_t))
    return s, placed


NODE_OFFSET = 1 << 20  # pkt_src/dst_task >= NODE_OFFSET encodes a direct
                       # node id (flow-level frontend, core.flows)


def _pkt_endpoints(c: EngineConsts, s: SimState):
    """Resolve src/dst node of every packet from current task placement.

    -1 -> SAN storage; >= NODE_OFFSET -> direct node id; else task id."""
    n_tasks = s.task_vm.shape[1]

    def node_of(task_idx):
        t = task_idx.clamp(0, n_tasks - 1).long()
        vm = s.task_vm[:, t].clamp(min=0).long()
        node = torch.where(task_idx < 0, c.storage_node, c.vm_host[vm])
        return torch.where(task_idx >= NODE_OFFSET, task_idx - NODE_OFFSET,
                           node).to(I32)
    return node_of(c.pkt_src_task), node_of(c.pkt_dst_task)


def _endpoint_cache(c: EngineConsts, meta, s: SimState):
    """Per-packet (src*n_nodes+dst) pair index and reachability from the
    current placement; refreshed only on steps whose placement changed.
    Unreachable pairs never activate, so the run reports a stall."""
    src_node, dst_node = _pkt_endpoints(c, s)
    pair = (src_node * meta.n_nodes + dst_node).to(I32)
    reachable = (c.n_cand[pair.long()] > 0) | (src_node == dst_node)
    return {"pair": pair, "reachable": reachable}


def _route_links(c: EngineConsts, s: SimState, mask) -> torch.Tensor:
    """[W, N_P, H] link ids of each packet's chosen route (-1 where masked)."""
    links = c.routes[s.pkt_pair.clamp(min=0).long(),
                     s.pkt_cand.clamp(min=0).long()]
    return torch.where(mask[..., None], links, -1)


def _sdn_scan(c: EngineConsts, ready, pair_all, link_bw, nc, cand):
    """The controller's sequential pass: ready SDN packets in ascending
    index order, each picking the max-bottleneck candidate against the
    channels admitted before it, then joining them."""
    w, n_p = ready.shape
    dev = ready.device
    rows = _rows(w, dev)[:, 0]
    idx = torch.arange(n_p, device=dev)
    order = torch.where(ready, idx, n_p).sort(dim=1).values
    n_ready = ready.sum(1)
    k_max, hops = c.routes.shape[1:]
    for k in range(int(n_ready.max())):
        ok = k < n_ready
        i = order[:, k].clamp(max=n_p - 1)
        pair = pair_all[rows, i].long()
        routes_k = c.routes[pair]                                # [W, K, H]
        pick = sdn_route_choice(routes_k, c.n_cand[pair], link_bw, nc)
        links = routes_k[rows, pick.long()]                      # [W, H]
        m = (links >= 0) & ok[:, None]
        nc = nc.scatter_add(1, torch.where(m, links, 0).long(), m.to(I32))
        cand = cand.index_put((rows, i), torch.where(ok, pick,
                                                     cand[rows, i]))
    return nc, cand


def _activate(c: EngineConsts, pol, ph, aux, cache, nc, s: SimState):
    """Task activation, then packet activation with route choice.

    Legacy lanes need no channel feedback: their hash picks are one gather
    and their channel bump one integer scatter-add (exact in any order).
    SDN lanes run the sequential controller scan.  Returns ``(s, links,
    p_active, nc)``: the post-activation route links, active mask and
    per-link channel counts feed rates and energy."""
    t_ready = ((s.task_state == WAITING) & (s.task_got >= c.task_need)
               & (s.task_vm >= 0))
    s = s._replace(
        task_state=torch.where(t_ready, ACTIVE, s.task_state),
        task_start=torch.where(t_ready, s.time[:, None], s.task_start))

    gate = c.pkt_gate_task
    gate_ok = (gate < 0) | (s.task_state[:, gate.clamp(min=0).long()]
                            == DONE)
    admitted = s.job_admitted[:, c.pkt_job.clamp(min=0).long()]
    p_ready = ((s.pkt_state == WAITING) & admitted & gate_ok & c.pkt_valid
               & cache["reachable"])

    if bool(p_ready.any()):
        pair_all = cache["pair"]
        w = p_ready.shape[0]
        cand = legacy_route_choice(c.n_cand[pair_all.long()],
                                   aux["pkt_hash"])
        is_sdn = pol["routing"] == ROUTE_SDN
        legacy = p_ready & ~is_sdn[:, None]
        if not (ph["routing"] == ROUTE_SDN).all():
            links = c.routes[pair_all.long(), cand.long()]       # [W, P, H]
            m = legacy[..., None] & (links >= 0)
            nc = nc.scatter_add(1, torch.where(m, links, 0).reshape(
                w, -1).long(), m.reshape(w, -1).to(I32))
        sdn = p_ready & is_sdn[:, None]
        if (ph["routing"] == ROUTE_SDN).any():
            nc, cand = _sdn_scan(c, sdn, pair_all, c.link_bw, nc, cand)
        s = s._replace(
            pkt_state=torch.where(p_ready, ACTIVE, s.pkt_state),
            pkt_pair=torch.where(p_ready, pair_all, s.pkt_pair),
            pkt_cand=torch.where(p_ready, cand, s.pkt_cand),
            pkt_start=torch.where(p_ready, s.time[:, None], s.pkt_start))

    p_active = s.pkt_state == ACTIVE
    return s, _route_links(c, s, p_active), p_active, nc


def _rates(c: EngineConsts, meta, ph, s: SimState, links, p_active, nc):
    """Piecewise-constant packet and task rates for this interval."""
    pkt_rate = fairshare.rates(ph["traffic"], links, p_active, c.link_bw,
                               meta.intra_bw, nc=nc)
    t_active = s.task_state == ACTIVE
    vm = s.task_vm.clamp(min=0).long()
    n_on_vm = torch.zeros_like(s.vm_load).scatter_add(1, vm,
                                                      t_active.to(I32))
    share = c.vm_total_mips[vm] / torch.gather(n_on_vm, 1, vm).clamp(
        min=1).to(F32)
    task_rate = torch.where(t_active,
                            torch.minimum(c.vm_core_mips[vm], share), 0.0)
    return pkt_rate, task_rate, t_active


def _mips_by_host(host_of_task, t_active, task_rate, n_hosts):
    """Per-host sum of active-task rates, each host's rates added in
    ascending task order from 0.0 — the reference's order, so the sums
    match bit for bit.  Trip k adds every host's k-th active task; the
    depth is the largest per-host active count."""
    w, n_t = t_active.shape
    dev = t_active.device
    tidx = torch.arange(n_t, device=dev)
    key = torch.where(t_active, host_of_task.long(), n_hosts) * n_t + tidx
    sorted_key, order = key.sort(1)
    host_sorted = sorted_key // n_t
    first = torch.searchsorted(sorted_key, host_sorted * n_t)
    k_sorted = tidx - first                 # rank among the host's tasks
    on_host = host_sorted < n_hosts
    rate_sorted = torch.gather(task_rate, 1, order)
    mips = torch.zeros((w, n_hosts), dtype=F32, device=dev)
    depth = int(torch.where(on_host, k_sorted, -1).max()) + 1
    for k in range(depth):
        sel = on_host & (k_sorted == k)     # at most one task per host
        add = torch.zeros((w, n_hosts + 1), dtype=F32, device=dev).scatter_(
            1, torch.where(sel, host_sorted, n_hosts),
            torch.where(sel, rate_sorted, 0.0))
        mips = mips + add[:, :n_hosts]
    return mips


def _finished(c: EngineConsts, meta, s: SimState) -> torch.Tensor:
    all_done = (~c.job_valid | (s.job_out_done >= c.job_n_out)).all(1)
    return all_done | s.stalled | (s.steps >= meta.max_steps)


def _make_aux(c: EngineConsts, pol) -> Dict[str, torch.Tensor]:
    """Loop-invariant tensors: the per-task placement hash and per-packet
    legacy flow hash of each lane's seed, and the completion tolerances."""
    n_t = c.task_job.shape[0]
    seed = pol["seed"][:, None]
    tidx = torch.arange(n_t, dtype=I32, device=seed.device)
    return {
        "task_hash": flow_hash_u32(tidx, c.task_job, seed),
        "pkt_hash": flow_hash_u32(c.pkt_src_task + 1, c.pkt_dst_task + 1,
                                  seed),
        "pkt_tol": fma32(c.pkt_bits, 1e-6, 1.0),
        "task_tol": fma32(c.task_mi, 1e-6, 1e-6),
    }


def _step(c: EngineConsts, meta, pol, ph, aux, s: SimState, cache, nc):
    s, placed = _admit_and_place(c, meta, pol, ph, aux, s)
    if bool(placed.any()):
        # placement changed -> the packet endpoint/pair cache is stale
        fresh = _endpoint_cache(c, meta, s)
        cache = {k: torch.where(placed[:, None], fresh[k], cache[k])
                 for k in cache}
    s, links, p_active, nc = _activate(c, pol, ph, aux, cache, nc, s)
    pkt_rate, task_rate, t_active = _rates(c, meta, ph, s, links, p_active,
                                           nc)

    # earliest horizon (Eq. 4 generalized)
    inf = torch.inf
    dt_p = torch.where(p_active & (pkt_rate > 0), s.pkt_rem / pkt_rate,
                       inf).amin(1)
    dt_t = torch.where(t_active & (task_rate > 0), s.task_rem / task_rate,
                       inf).amin(1)
    future = (~s.job_admitted) & c.job_valid & (
        c.job_release > s.time[:, None])
    dt_r = torch.where(future, c.job_release - s.time[:, None], inf).amin(1)
    dt = torch.minimum(torch.minimum(dt_p, dt_t), dt_r)
    stalled = torch.isinf(dt)
    dt = torch.where(stalled, 0.0, dt)
    dt_col = dt[:, None]

    # energy (power is constant over [t, t+dt))
    vm_safe = s.task_vm.clamp(min=0).long()
    n_h = c.host_total_mips.shape[0]
    mips_used = _mips_by_host(c.vm_host[vm_safe], t_active, task_rate, n_h)
    util = (mips_used / c.host_total_mips.clamp(min=1e-9)).clamp(0.0, 1.0)
    host_energy = fma32(host_power(util, meta.energy), dt_col, s.host_energy)
    host_busy = s.host_busy + torch.where(util > 0, dt_col, 0.0)
    live_link = (nc > 0).to(I32)
    ports = torch.zeros((nc.shape[0], meta.n_nodes), dtype=I32,
                        device=nc.device)
    ports.scatter_add_(1, c.link_src.long().expand_as(live_link), live_link)
    ports.scatter_add_(1, c.link_dst.long().expand_as(live_link), live_link)
    sw_ports = ports[:, meta.n_hosts:meta.n_hosts + meta.n_switches]
    switch_energy = fma32(switch_power(sw_ports, meta.energy), dt_col,
                          s.switch_energy)

    # advance
    time = s.time + dt
    pkt_rem = torch.where(p_active, fma32(-pkt_rate, dt_col, s.pkt_rem),
                          s.pkt_rem)
    task_rem = torch.where(t_active, fma32(-task_rate, dt_col, s.task_rem),
                           s.task_rem)
    p_done = p_active & (pkt_rem <= aux["pkt_tol"])
    t_done = t_active & (task_rem <= aux["task_tol"])
    time_col = time[:, None]

    # completions feed gates and release their channels: integer
    # scatter-adds, exact in any order
    w = nc.shape[0]
    m = p_done[..., None] & (links >= 0)
    nc_next = nc.scatter_add(1, torch.where(m, links, 0).reshape(w, -1)
                             .long(), -m.reshape(w, -1).to(I32))
    feeds = c.pkt_feeds_task
    task_got = s.task_got.scatter_add(
        1, feeds.clamp(min=0).long().expand_as(p_done),
        (p_done & (feeds >= 0)).to(I32))
    job_out_done = s.job_out_done.scatter_add(
        1, c.pkt_job.clamp(min=0).long().expand_as(p_done),
        (p_done & (feeds < 0)).to(I32))
    newly_job_done = (job_out_done >= c.job_n_out) & (
        s.job_out_done < c.job_n_out) & c.job_valid
    vm_load = s.vm_load - torch.zeros_like(s.vm_load).scatter_add(
        1, vm_safe, t_done.to(I32))

    s = s._replace(
        time=time, steps=s.steps + 1, stalled=stalled,
        job_out_done=job_out_done,
        job_done_t=torch.where(newly_job_done, time_col, s.job_done_t),
        task_state=torch.where(t_done, DONE, s.task_state),
        task_rem=task_rem, task_got=task_got,
        task_finish=torch.where(t_done, time_col, s.task_finish),
        pkt_state=torch.where(p_done, DONE, s.pkt_state), pkt_rem=pkt_rem,
        pkt_finish=torch.where(p_done, time_col, s.pkt_finish),
        vm_load=vm_load, host_energy=host_energy, host_busy=host_busy,
        switch_energy=switch_energy)
    return s, cache, nc_next


# ---------------------------------------------------------------------------
# public API
# ---------------------------------------------------------------------------


def lane_policies(pol, device=None) -> Dict[str, torch.Tensor]:
    """Policy dict with one int32 value per lane on ``device``: 0-d values
    (e.g. ``as_policy_arrays`` of one config) broadcast to the lane count
    of the per-lane values, or to one lane."""
    pol = {k: torch.as_tensor(v, dtype=I32) for k, v in pol.items()}
    width = max((v.numel() for v in pol.values() if v.dim()), default=1)
    return {k: v.reshape(-1).expand(width).to(device).contiguous()
            if v.dim() == 0 else v.to(device) for k, v in pol.items()}


def make_packed_simulator(meta: SimMeta):
    """Returns ``run(consts, pol, s0=None) -> SimState``.

    ``pol`` holds one int32 value per lane for every registered policy
    field (``[W]``, on the consts' device; ``lane_policies`` builds it).
    The result's leaves are ``[W, ...]``."""

    def run(consts: EngineConsts, pol: Dict[str, torch.Tensor],
            s0: SimState | None = None) -> SimState:
        width = pol["seed"].shape[0]
        ph = {k: v.cpu().numpy() for k, v in pol.items()}
        s = s0 if s0 is not None else init_state_from_consts(
            consts, meta.n_switches, width)
        aux = _make_aux(consts, pol)
        cache = _endpoint_cache(consts, meta, s)
        # nothing is active at t=0, so the carried channel counts start 0
        nc = torch.zeros((width, meta.n_links), dtype=I32,
                         device=consts.link_bw.device)
        done = _finished(consts, meta, s)
        while True:
            done_h = done.cpu()
            if bool(done_h.all()):
                return s
            s_next, cache, nc = _step(consts, meta, pol, ph, aux, s, cache,
                                      nc)
            if bool(done_h.any()):
                # frozen lanes keep their final state
                s = SimState(*(torch.where(
                    done.reshape(-1, *([1] * (b.dim() - 1))), a, b)
                    for a, b in zip(s, s_next)))
            else:
                s = s_next
            done = _finished(consts, meta, s)

    return run


def make_simulator(setup: SimSetup, device=None):
    """Returns ``run(pol) -> SimState`` over the setup's consts on
    ``device`` (``None`` = CUDA)."""
    consts, meta = make_consts(setup, device)
    return partial(make_packed_simulator(meta), consts)
