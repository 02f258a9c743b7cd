"""The discrete-event engine: one Python loop of whole-tensor steps.

Port of ``src/repro/core/engine.py``.  Between events every rate (channel
bandwidth, VM MIPS share, power draw) is piecewise constant, so the next
event time is an analytic ``min`` over fixed-shape state tensors (paper
Eq. 4 generalized to packet finishes, task finishes, job releases and
fail/recover instants).  One loop iteration = one event:

  failure/recovery transitions (only when a schedule has a finite
  instant) -> admission -> placement -> task activation -> packet
  activation (routed) -> rates -> dt = earliest horizon ->
  energy += power*dt -> advance -> completions

Lanes.  Every ``SimState`` leaf carries a leading lane axis ``[W, ...]``:
W policies on one scenario run as W lanes of one loop, the counterpart of
the reference's vmapped policy batch; a serial run is W = 1.  A finished
lane is frozen (its state no longer changes), as ``lax.cond`` under vmap
does in the reference, and the loop ends when every lane has finished.
``EngineConsts`` is shared by all lanes, except that the streaming ring's
job, task and packet leaves (``core.streaming.STREAM_FIELDS``) may carry a
leading ``[W]`` axis, each lane's ring holding its own jobs (the
reference's ``consts_axes``); every index read from those leaves goes
through ``_take``.

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

Failures (DESIGN.md §7).  With ``SimMeta.has_failures`` the step runs
``_apply_failures`` and the failure terms of admission, activation, rates,
the horizon, energy and downtime, each as the reference does; with it
False none of them is issued.  The one-shot revert transitions run only on
steps where some lane's dead masks grew; that flag travels to the host in
the same copy as the loop's finished flags, so failures add no host sync.

Control plane (DESIGN.md §10).  With ``SimMeta.has_ctrl`` the placement is
live (``s.vm_host``, re-homed by ``_maybe_migrate``), the proactive pass
``_preinstall`` pins routes at admission, and ``_activate_ctrl`` replaces
``_activate``: legacy lanes stay vectorised (they never consult the
controller), SDN lanes pop the ready and woken packets in ascending index
order through ``_ctrl_request`` (flow tables, FIFO controller, failover).
Chaos (DESIGN.md §13): ``SimMeta.has_degradation`` turns on the gray
windows (``_effective_link_bw``, ``_host_deg_factor``), ``spec_slots > 0``
turns on ``_speculate`` and the clone terms of rates, horizon, energy and
completions.  A switch that is off issues none of its ops: with all of
them off the step is the plain path.

Float sums over clone slots (``spec_wasted``, the clones' MIPS per host)
run in float64 and round once: equal to the reference's float32 sum in
any order while at most two terms are non-zero.

Loops.  ``_advance`` is the one loop body: the serial run
(``make_packed_simulator``) drives it to the end, the fleet's chunk
(``make_fleet_chunk``, DESIGN.md §9) for at most K events between the
host's retire/refill boundaries; ``init_fleet_carry`` and ``tree_select``
build and reset its carry.
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
from .mapreduce import ACTIVE, DONE, INSTALLING, SimSetup, VOID, WAITING
from .policies import (INSTALL_PROACTIVE, JOBSEL_PRIORITY, JOBSEL_SJF,
                       MIG_CONGESTION, PLACE_RANDOM, PLACE_ROUND_ROBIN,
                       RECOVERY_RESTART, SPEC_ON, as_policy_arrays)
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
    # failure schedule (DESIGN.md §7): outage window per host / link
    host_fail_t: torch.Tensor
    host_recover_t: torch.Tensor
    link_fail_t: torch.Tensor
    link_recover_t: torch.Tensor
    fail_breaks: torch.Tensor
    # gray-failure degradation schedule (DESIGN.md §13)
    host_slow_t: torch.Tensor
    host_restore_t: torch.Tensor
    host_deg_factor: torch.Tensor
    link_slow_t: torch.Tensor
    link_restore_t: torch.Tensor
    link_deg_factor: torch.Tensor
    deg_breaks: torch.Tensor
    # control plane (DESIGN.md §10): the identity values without a config
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
    axis.  A feature's fields pass through untouched while its ``SimMeta``
    switch is off."""

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
    # failure & recovery (DESIGN.md §7)
    host_dead: torch.Tensor
    link_dead: torch.Tensor
    task_restarts: torch.Tensor
    pkt_reroutes: torch.Tensor
    job_downtime: torch.Tensor
    # control plane (DESIGN.md §10): ftab_* [W, n_switches, ctrl_slots]
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
    # gray failures, speculation & failover (DESIGN.md §13): spec_*
    # [W, n_jobs * spec_slots]
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
    """Step cap: the no-failure event bound, plus one full re-execution
    budget per fail/recover instant, the degradation windows' breakpoints,
    one clone finish and cancellation per task, and the control plane's
    park + wake per packet and re-run per migration — each as the
    reference counts it.  Any of them quantizes the cap to the next power
    of two, as in the reference."""
    base = 4 * (setup.n_packets + setup.n_tasks) + 4 * setup.n_jobs + 64
    sched = setup.failures
    steps = base
    quantize = False
    if sched is not None and sched.any_failures:
        steps = base * (1 + sched.n_events) + 2 * sched.n_events
        quantize = True
    deg = setup.degradation
    if deg is not None and deg.any_degradation:
        steps = steps + 4 * deg.n_events + 8
        quantize = True
    if setup.spec_slots > 0:
        steps = steps + 2 * setup.n_tasks
        quantize = True
    cfg = setup.ctrl
    if cfg is not None and cfg.any_ctrl:
        steps = 2 * steps + cfg.mig_limit * (3 * setup.n_packets + 4)
        quantize = True
    if quantize:
        return 1 << (steps - 1).bit_length()
    return steps


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
    """Bake a setup into device tensors (``device=None`` = CUDA) and its
    ``SimMeta``, as the reference does."""
    dev = resolve(device)
    rt, cl = setup.route_table, setup.cluster
    sched = setup.failures or no_failures(cl.topo.n_hosts, cl.topo.n_links)
    deg = setup.degradation or no_degradation(cl.topo.n_hosts,
                                              cl.topo.n_links)
    cfg = (setup.ctrl or no_ctrl()).validate()
    sched.validate(cl.topo.n_hosts, cl.topo.n_links)
    deg.validate(cl.topo.n_hosts, cl.topo.n_links)

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
        energy=cl.energy, max_steps=default_max_steps(setup),
        has_failures=sched.any_failures, has_ctrl=cfg.any_ctrl,
        ctrl_slots=cfg.table_slots if cfg.any_ctrl else 0,
        has_degradation=deg.any_degradation, spec_slots=setup.spec_slots)
    return consts, meta


def init_state_from_consts(c: EngineConsts, n_switches: int,
                           ctrl_slots: int = 0, spec_slots: int = 0,
                           width: int = 1) -> SimState:
    """t=0 state of ``width`` lanes (every leaf ``[width, ...]``), as the
    reference's ``init_state_from_consts``: ``ctrl_slots`` is the flow
    tables' width (``ftab_*`` ``[W, n_switches, ctrl_slots]``),
    ``spec_slots`` the clone slots per job (``spec_*`` ``[W, n_jobs *
    spec_slots]``).  Pad job/task/packet slots start VOID/zero and stay
    inert.  A streamed leaf with a lane axis gives each lane its own."""
    n_j = c.job_release.shape[-1]
    n_s = n_j * spec_slots
    n_t = c.task_job.shape[-1]
    n_p = c.pkt_job.shape[-1]
    n_v = c.vm_host.shape[0]
    n_h = c.host_total_mips.shape[0]
    dev = c.link_bw.device

    def full(shape, value, dtype):
        return torch.full((width, *shape), value, dtype=dtype, device=dev)

    def lanes(a, dtype):
        return a.to(dtype).expand(width, a.shape[-1]).clone()

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
        ftab_pair=full((n_switches, ctrl_slots), -1, I32),
        ftab_ready=full((n_switches, ctrl_slots), 0.0, F32),
        ftab_stamp=full((n_switches, ctrl_slots), 0, I32),
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
        spec_of=full((n_s,), -1, I32),
        spec_vm=full((n_s,), -1, I32),
        spec_rem=full((n_s,), 0.0, F32),
        spec_start=full((n_s,), 0.0, F32),
        task_cloned=full((n_t,), False, torch.bool),
        spec_launches=full((), 0, I32),
        spec_wins=full((), 0, I32),
        spec_wasted=full((), 0.0, F32),
        ctrl_failovers=full((), 0, I32),
        ctrl_failover_park=full((), 0.0, F32),
    )


def init_state(setup: SimSetup, device=None) -> SimState:
    """The unbatched t=0 state of ``setup`` on ``device`` (``None`` =
    CUDA)."""
    consts, meta = make_consts(setup, device)
    return SimState(*(leaf[0] for leaf in init_state_from_consts(
        consts, meta.n_switches, meta.ctrl_slots, meta.spec_slots)))


# ---------------------------------------------------------------------------
# step phases (every state tensor [W, ...]; consts shared)
# ---------------------------------------------------------------------------


def _rows(w: int, device) -> torch.Tensor:
    """Lane index column ``[W, 1]`` for per-lane advanced indexing."""
    return torch.arange(w, device=device)[:, None]


def _take(x, idx) -> torch.Tensor:
    """``x`` at ``idx`` along its last axis, lane by lane: a shared ``[n]``
    leaf at per-lane ``idx [W, ...]``, or a per-lane ``[W, n]`` tensor at
    shared ``idx [k]`` (every lane alike) or per-lane ``idx [W, k]`` (a
    gather along each lane's row).  Indices read from a streamed consts
    leaf are per-lane when it carries the lane axis."""
    if x.dim() == 1:
        return x[idx]
    if idx.dim() == 1:
        return x[:, idx]
    return torch.gather(x, 1, idx)


def _vm_host(c: EngineConsts, meta, s: SimState) -> torch.Tensor:
    """Effective VM -> host placement: the live ``s.vm_host [W, V]`` when
    the control plane is on (migration re-homes VMs), else the static
    ``c.vm_host [V]``."""
    if meta.has_ctrl:
        return s.vm_host
    return c.vm_host


def _host_of_vm(c: EngineConsts, meta, s: SimState, vm) -> torch.Tensor:
    """Host of each VM id in ``vm [W, ...]`` (non-negative) under
    ``_vm_host``: a per-lane gather when placement is live."""
    if meta.has_ctrl:
        return torch.gather(s.vm_host, 1, vm.reshape(vm.shape[0], -1).long()
                            ).reshape(vm.shape)
    return c.vm_host[vm.long()]


def _effective_link_bw(c: EngineConsts, meta, s: SimState) -> torch.Tensor:
    """Per-link capacity with the gray windows applied (DESIGN.md §13) and
    dead links at 0 (DESIGN.md §7): ``[W, L]``, or ``c.link_bw [L]`` itself
    with neither.  SDN's picks read it; the legacy hash does not."""
    bw = c.link_bw
    if meta.has_degradation:
        t = s.time[:, None]
        slow = (c.link_slow_t <= t) & (t < c.link_restore_t)
        bw = torch.where(slow, c.link_bw * c.link_deg_factor, c.link_bw)
    if meta.has_failures:
        bw = torch.where(s.link_dead, 0.0, bw)
    return bw


def _host_deg_factor(c: EngineConsts, s: SimState) -> torch.Tensor:
    """Per-host MIPS multiplier ``[W, n_hosts]``: ``host_deg_factor`` inside
    ``[slow_t, restore_t)``, 1.0 outside."""
    t = s.time[:, None]
    slow = (c.host_slow_t <= t) & (t < c.host_restore_t)
    return torch.where(slow, c.host_deg_factor, 1.0)


def _effective_host_mips(c: EngineConsts, meta, s: SimState) -> torch.Tensor:
    """Per-host MIPS capacity with the gray windows applied: the energy
    utilisation's denominator (``c.host_total_mips`` without them)."""
    if meta.has_degradation:
        return c.host_total_mips * _host_deg_factor(c, s)
    return c.host_total_mips


def _sum32(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """float32 sum over ``dim`` added in float64 and rounded once: the
    reference's float32 sum in any order while at most two terms are
    non-zero (the clone-slot sums; see the module note)."""
    # torchcheck: disable=f64-literal: float64 sum rounded once: a recorded
    # divergence
    return x.to(torch.float64).sum(dim).to(F32)


def _place_batch(pol, ph, aux, s: SimState, mine, pos, vm_live,
                 n_live) -> SimState:
    """Place every task in ``mine [W, T]`` in the sequential placement order
    given by ``pos`` (each mine-task's 0-based position; garbage elsewhere).

    Round-robin and random placement need no load feedback: their picks
    are rank-plus-counter / hash arithmetic over the live-VM remap and one
    integer scatter-add.  Least-used must see each earlier placement's
    load bump, so it scans the tasks to place in position order (every
    placement id that is neither round-robin nor random takes the scan, as
    in the reference).

    ``vm_live``/``n_live`` are ``[V]``/``[]`` for every lane, or ``[W, V]``/
    ``[W]`` per lane when failures kill hosts."""
    w, n_t = mine.shape
    dev = mine.device
    counter0 = s.place_counter
    n_mine = mine.sum(1, dtype=I32)
    mod = n_live.clamp(min=1)
    if mod.dim():
        mod = mod[:, None]
    vec_lane = (pol["placement"] == PLACE_ROUND_ROBIN) | (
        pol["placement"] == PLACE_RANDOM)
    vec_host = (ph["placement"] == PLACE_ROUND_ROBIN) | (
        ph["placement"] == PLACE_RANDOM)
    task_vm, vm_load = s.task_vm, s.vm_load

    if vec_host.any():
        # kth[k] = slot index of the k-th live VM (stable: live slots first
        # in ascending order, so a ``% mod`` pick never lands on a dead one)
        kth = torch.argsort((~vm_live).to(I32), stable=True)
        rr_at = (counter0[:, None].long() + pos) % mod
        rnd_at = aux["task_hash"].long() % mod
        if kth.dim() == 1:
            rr_pick, rnd_pick = kth[rr_at], kth[rnd_at]
        else:
            rr_pick = torch.gather(kth, 1, rr_at)
            rnd_pick = torch.gather(kth, 1, rnd_at.expand_as(rr_at))
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
        # torchcheck: disable=tracer-cast: the placement scan's depth, read on
        # the host
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
    (ties by job index); the concurrency budget is a rank cutoff.

    With failures, placement only considers VMs on live hosts (the
    ResourceManager's heartbeat view), nothing is admitted while no host
    is live, and a second batch re-places the tasks a host failure
    unplaced (YARN re-execution).  Returns ``(s, placed, any_placed,
    admit_now)``: ``placed [W]`` marks lanes whose placement changed,
    ``any_placed`` is its host-side any, ``admit_now [W, J]`` the jobs
    admitted this step (the proactive pass pins their packets), ``None``
    when no lane admitted one."""
    w, n_j = s.job_admitted.shape
    dev = s.time.device
    vm_live = torch.arange(meta.n_vms, device=dev) < c.n_vms
    if meta.has_failures:
        host_of_vm = _vm_host(c, meta, s).clamp(
            0, c.host_fail_t.shape[0] - 1).long().expand(w, -1)
        vm_live = vm_live & ~torch.gather(s.host_dead, 1, host_of_vm)
        n_live = vm_live.sum(1, dtype=I32)
    else:
        n_live = vm_live.sum(dtype=I32)

    released = (~s.job_admitted) & c.job_valid & (
        c.job_release <= s.time[:, None])
    running = (s.job_admitted & (s.job_out_done < c.job_n_out)
               & c.job_valid).sum(1, dtype=I32)
    slots = (pol["job_concurrency"] - running).clamp(min=0)
    if meta.has_failures:
        # no live NodeManager, no admission: jobs wait for a recovery
        slots = torch.where(n_live > 0, slots, 0)
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
    if meta.has_failures:
        job_of_task = c.task_job.clamp(min=0).long()
        # tasks a host failure unplaced, of jobs admitted before this step
        # (this step's admissions place every task they admit, so the set
        # is the same before and after them); with no live VM they wait
        orphaned = (c.task_valid & (s.task_vm < 0)
                    & (s.task_state == WAITING)
                    & _take(s.job_admitted, job_of_task)
                    & (n_live > 0)[:, None])
        # torchcheck: disable=item-call: one read of the admission flags an
        # event
        any_admit, any_orphan = torch.stack(
            [placed.any(), orphaned.any()]).tolist()
        placed = placed | orphaned.any(1)
    else:
        # torchcheck: disable=tracer-cast: the admission flags, read on the
        # host
        any_admit, any_orphan = bool(placed.any()), False

    if any_admit:
        job_of_task = c.task_job.clamp(min=0).long()
        mine = c.task_valid & _take(admit_now, job_of_task)
        # placement position: admission-rank-major, task-index-minor
        cnt_by_rank = torch.where(torch.gather(admit_now, 1, ord_j),
                                  _take(c.job_n_tasks, ord_j), 0)
        off_by_rank = cnt_by_rank.cumsum(1) - cnt_by_rank
        pos = torch.gather(off_by_rank, 1, _take(rank, job_of_task)) \
            + c.task_rank_in_job
        s = _place_batch(pol, ph, aux, s, mine, pos, vm_live, n_live)
    s = s._replace(job_admitted=s.job_admitted | admit_now,
                   job_admit_t=torch.where(admit_now, s.time[:, None],
                                           s.job_admit_t))
    if any_orphan:
        # placement order: ascending task index after this step's admissions
        s = _place_batch(pol, ph, aux, s, orphaned,
                         orphaned.to(I32).cumsum(1) - 1, vm_live, n_live)
    return (s, placed, any_admit or any_orphan,
            admit_now if any_admit else None)


NODE_OFFSET = 1 << 20  # pkt_src/dst_task >= NODE_OFFSET encodes a direct
                       # node id (flow-level frontend, core.flows)


def _pkt_endpoints(c: EngineConsts, meta, s: SimState):
    """Resolve src/dst node of every packet from current task placement
    (the live placement under migration, ``_vm_host``).

    -1 -> SAN storage; >= NODE_OFFSET -> direct node id; else task id."""
    n_tasks = s.task_vm.shape[1]

    def node_of(task_idx):
        t = task_idx.clamp(0, n_tasks - 1).long()
        vm = _take(s.task_vm, t).clamp(min=0).long()
        node = torch.where(task_idx < 0, c.storage_node,
                           _host_of_vm(c, meta, s, vm))
        return torch.where(task_idx >= NODE_OFFSET, task_idx - NODE_OFFSET,
                           node).to(I32)
    return node_of(c.pkt_src_task), node_of(c.pkt_dst_task)


def _endpoint_cache(c: EngineConsts, meta, s: SimState):
    """Per-packet (src*n_nodes+dst) pair index and reachability from the
    current placement; refreshed only on steps whose placement changed.
    Unreachable pairs never activate, so the run reports a stall."""
    src_node, dst_node = _pkt_endpoints(c, meta, s)
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
    # torchcheck: disable=tracer-cast: the SDN scan's depth, read on the host
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


def _apply_failures(c: EngineConsts, meta, pol, s: SimState, nc, dead,
                    died):
    """Fire every fail/recover transition whose instant has been reached.

    ``dead`` holds the host and link dead masks ``[W, n]`` at ``s.time``
    (fail instants join the dt horizon, so the clock lands on each one);
    the delta against the previous masks drives the one-shot transitions,
    run only when ``died`` (host-side: some lane's masks grew this step):

      * WAITING/ACTIVE tasks on a newly-dead host revert to WAITING and
        unplace; under ``recovery=restart`` their progress is lost, under
        ``resume`` ``task_rem`` survives;
      * in-flight packets whose route crosses a newly-dead link revert to
        WAITING for re-routing (delivered bits survive);
      * in-flight packets whose src/dst host newly died revert too and,
        under ``restart``, retransmit from scratch.

    DONE work is never reverted; recovery instants need no transition.
    With the control plane on, a routed packet is also one parked
    INSTALLING or pre-pinned WAITING; a reverted one re-requests its rules
    later.  Returns ``(s, nc)`` with the reverted ACTIVE packets' channels
    released."""
    host_dead, link_dead = dead
    new_h = host_dead & ~s.host_dead
    new_l = link_dead & ~s.link_dead
    s = s._replace(host_dead=host_dead, link_dead=link_dead)
    if not died:
        return s, nc
    w = nc.shape[0]
    restart = (pol["recovery"] == RECOVERY_RESTART)[:, None]
    n_hosts_pad = c.host_fail_t.shape[0]
    # packets first: endpoints resolve against the activation-time
    # placement, before any task unplaces below
    src_node, dst_node = _pkt_endpoints(c, meta, s)
    p_active = s.pkt_state == ACTIVE
    routed = p_active
    if meta.has_ctrl:
        routed = (p_active | (s.pkt_state == INSTALLING)
                  | ((s.pkt_state == WAITING) & (s.pkt_cand >= 0)))
    links = _route_links(c, s, routed)                          # [W, P, H]
    on_route = torch.gather(new_l, 1, links.clamp(min=0).reshape(w, -1)
                            .long()).reshape(links.shape)
    route_hit = routed & ((links >= 0) & on_route).any(-1)

    def endpoint_died(node):
        return (node < c.n_hosts) & torch.gather(
            new_h, 1, node.clamp(0, n_hosts_pad - 1).long())

    ep_hit = routed & (endpoint_died(src_node) | endpoint_died(dst_node))
    hit_p = route_hit | ep_hit
    # the reverted ACTIVE packets release their channels: an integer
    # scatter-add, exact in any order
    hit_drop = hit_p & p_active if meta.has_ctrl else hit_p
    m = hit_drop[..., None] & (links >= 0)
    nc = nc.scatter_add(1, torch.where(m, links, 0).reshape(w, -1).long(),
                        -m.reshape(w, -1).to(I32))

    # tasks on newly-dead hosts
    vm_safe = s.task_vm.clamp(min=0).long()
    task_host = _host_of_vm(c, meta, s, vm_safe).clamp(
        0, n_hosts_pad - 1).long()
    hit_t = (c.task_valid & (s.task_vm >= 0)
             & torch.gather(new_h, 1, task_host)
             & ((s.task_state == ACTIVE) | (s.task_state == WAITING)))
    vm_load = s.vm_load - torch.zeros_like(s.vm_load).scatter_add(
        1, vm_safe, hit_t.to(I32))
    s = s._replace(
        pkt_state=torch.where(hit_p, WAITING, s.pkt_state),
        pkt_rem=torch.where(ep_hit & restart, c.pkt_bits, s.pkt_rem),
        pkt_pair=torch.where(hit_p, -1, s.pkt_pair),
        pkt_cand=torch.where(hit_p, -1, s.pkt_cand),
        pkt_reroutes=s.pkt_reroutes + hit_p.to(I32),
        task_state=torch.where(hit_t, WAITING, s.task_state),
        task_rem=torch.where(hit_t & restart, c.task_mi, s.task_rem),
        task_start=torch.where(hit_t, torch.nan, s.task_start),
        task_vm=torch.where(hit_t, -1, s.task_vm),
        vm_load=vm_load,
        task_restarts=s.task_restarts + hit_t.to(I32))
    if meta.has_ctrl:
        s = s._replace(pkt_ready_t=torch.where(hit_p, torch.inf,
                                               s.pkt_ready_t))
    return s, nc


def _dead_masks(c: EngineConsts, s: SimState):
    """Host and link dead masks ``[W, n]`` at each lane's clock: a device
    is dead on ``[fail_t, recover_t)``."""
    t = s.time[:, None]
    return ((c.host_fail_t <= t) & (t < c.host_recover_t),
            (c.link_fail_t <= t) & (t < c.link_recover_t))


def _activate(c: EngineConsts, meta, pol, ph, aux, cache, nc, s: SimState):
    """Task activation, then packet activation with route choice.

    Legacy lanes need no channel feedback: their hash picks are one gather
    and their channel bump one integer scatter-add (exact in any order).
    SDN lanes run the sequential controller scan.  With failures a packet
    waits until both its endpoint tasks are placed, SDN reads dead links
    at bandwidth 0 and degraded links at their degraded bandwidth (the
    legacy hash is blind to both), and a re-activated
    packet keeps its first start.  Returns ``(s, links, p_active, nc,
    link_bw)``: the post-activation route links, active mask, per-link
    channel counts and effective link bandwidth feed rates and energy."""
    t_ready = ((s.task_state == WAITING) & (s.task_got >= c.task_need)
               & (s.task_vm >= 0))
    s = s._replace(
        task_state=torch.where(t_ready, ACTIVE, s.task_state),
        task_start=torch.where(t_ready, s.time[:, None], s.task_start))

    gate = c.pkt_gate_task
    gate_ok = (gate < 0) | (_take(s.task_state, gate.clamp(min=0).long())
                            == DONE)
    admitted = _take(s.job_admitted, c.pkt_job.clamp(min=0).long())
    p_ready = ((s.pkt_state == WAITING) & admitted & gate_ok & c.pkt_valid
               & cache["reachable"])
    if meta.has_failures:
        n_t = s.task_vm.shape[1]

        def ep_placed(ref):
            is_task = (ref >= 0) & (ref < NODE_OFFSET)
            return ~is_task | (_take(s.task_vm, ref.clamp(0, n_t - 1)
                                     .long()) >= 0)

        p_ready = (p_ready & ep_placed(c.pkt_src_task)
                   & ep_placed(c.pkt_dst_task))
    link_bw = _effective_link_bw(c, meta, s)

    # torchcheck: disable=tracer-cast: fast path: no packet ready, no
    # activation
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
            nc, cand = _sdn_scan(c, sdn, pair_all, link_bw, nc, cand)
        start = s.time[:, None]
        if meta.has_failures:
            # a reverted packet re-activates with its first start: its
            # measured duration includes the outage
            start = torch.where(torch.isnan(s.pkt_start), start,
                                s.pkt_start)
        s = s._replace(
            pkt_state=torch.where(p_ready, ACTIVE, s.pkt_state),
            pkt_pair=torch.where(p_ready, pair_all, s.pkt_pair),
            pkt_cand=torch.where(p_ready, cand, s.pkt_cand),
            pkt_start=torch.where(p_ready, start, s.pkt_start))

    p_active = s.pkt_state == ACTIVE
    return s, _route_links(c, s, p_active), p_active, nc, link_bw


def _ctrl_now(c: EngineConsts, t):
    """The controller that serves a request at the clock ``t [W]``: the
    failover window's ``(down, gap_end, rate, latency)``, the same for
    every request of a step.  Inside the primary's outage the backup's
    rate and latency apply, and requests in the first
    ``ctrl_failover_delay`` seconds park until ``gap_end``."""
    down = (t >= c.ctrl_fail_t) & (t < c.ctrl_recover_t)
    gap_end = torch.minimum(c.ctrl_fail_t + c.ctrl_failover_delay,
                            c.ctrl_recover_t)
    return (down, gap_end, torch.where(down, c.ctrl_backup_rate, c.ctrl_rate),
            torch.where(down, c.ctrl_backup_latency, c.ctrl_latency))


def _ctrl_request(c: EngineConsts, meta, link_sw, pair, links, active_req,
                  pre_routed, t, now, tbl):
    """One flow's rule lookup and install request per lane against the
    flow-table / controller carry (DESIGN.md §10): ``link_sw [L]`` each
    link's source switch (-1 for none), ``pair [W]``, ``links [W, H]``
    (its route), ``active_req [W]`` gates every mutation, ``pre_routed
    [W]`` marks churn (its misses count as reinstalls too), ``t [W]`` the
    clock, ``now`` its ``_ctrl_now``.

    ``tbl`` is ``_ctrl_tbl``'s tuple; returns ``(ready [W], tbl')``,
    ``ready`` the instant every rule on the route is usable.  As the
    reference: each miss takes one controller service slot FIFO behind
    ``ctrl_busy`` plus the flow-mod latency; a hit still waits for an
    entry that is itself mid-install; a missing rule lands in its switch's
    first empty slot, else the least-recently stamped (ties to the lowest
    slot), and displacing a live entry counts an eviction; with
    ``ctrl_slots == 0`` every install counts evicted at once.

    A route is a simple path, so it visits each switch at most once: the
    cells a request writes are distinct, and the reference's one-hot
    ``[H, SW, T]`` writes become one scatter of H cells per lane and
    table (exact: no two writes meet), into the flat tables' spare last
    cell where masked off."""
    (fpair, fready, fstamp, busy, stamp, installs, evicts, reinst,
     qwait, park) = tbl
    down, gap_end, rate, lat = now
    T = meta.ctrl_slots
    w = links.shape[0]
    # switch hops sit at node ids [n_hosts, n_hosts + n_switches): the
    # padded offsets in a packed grid, as the energy port count
    sw = link_sw[links.clamp(min=0).long()]                     # [W, H]
    is_sw = (links >= 0) & (sw >= 0)
    sw = sw.clamp(min=0)
    if T > 0:
        cells = sw[..., None] * T + torch.arange(T, device=sw.device)
        flat = cells.reshape(w, -1)                             # [W, H*T]
        row_pair = torch.gather(fpair, 1, flat).reshape(cells.shape)
        hitmask = (row_pair == pair[:, None, None]) & is_sw[..., None]
        hit = hitmask.any(-1)
        hit_ready = torch.where(hitmask.reshape(w, -1),
                                torch.gather(fready, 1, flat),
                                -torch.inf).amax(1)
    else:
        hit = torch.zeros_like(is_sw)
        hit_ready = torch.full_like(t, -torch.inf)
    miss = is_sw & ~hit
    m = miss.sum(1, dtype=I32)
    begin = torch.maximum(t, busy)
    begin2 = torch.where(down, torch.maximum(begin, gap_end), begin)
    svc = m.to(F32) / rate                                      # inf rate: 0
    done_svc = begin2 + svc
    ready = torch.maximum(torch.maximum(
        torch.where(m > 0, done_svc + lat, -torch.inf), hit_ready), t)
    do_install = active_req & (m > 0)
    busy = torch.where(do_install, done_svc, busy)
    qwait = qwait + torch.where(do_install, begin - t, 0.0)
    park = park + torch.where(do_install, begin2 - begin, 0.0)
    installs = installs + torch.where(active_req, m, 0)
    reinst = reinst + torch.where(active_req & pre_routed, m, 0)
    if T > 0:
        new_stamp = stamp + 1
        # LRU victim per hop: empty slots (key -1) first, then the oldest
        # stamp, ties to the lowest slot (argmin takes the first)
        key = torch.where(row_pair < 0, -1, torch.gather(
            fstamp, 1, flat).reshape(cells.shape))
        slot = key.argmin(-1, keepdim=True)                     # [W, H, 1]
        displaced = torch.gather(row_pair, 2, slot)[..., 0] >= 0
        evicts = evicts + torch.where(
            do_install, (miss & displaced).sum(1, dtype=I32), 0)
        spare = fpair.shape[1] - 1
        write = torch.where(miss & do_install[:, None],
                            torch.gather(cells, 2, slot)[..., 0], spare)
        touch = torch.where(hitmask & (hit & active_req[:, None])[..., None],
                            cells, spare).reshape(w, -1)
        fpair = fpair.scatter(1, write, pair[:, None].expand(write.shape))
        fready = fready.scatter(1, write, ready[:, None].expand(write.shape))
        both = torch.cat([write, touch], 1)
        fstamp = fstamp.scatter(1, both, new_stamp[:, None].expand(both.shape))
        stamp = torch.where(active_req, new_stamp, stamp)
    else:
        evicts = evicts + torch.where(do_install, m, 0)
    return ready, (fpair, fready, fstamp, busy, stamp, installs, evicts,
                   reinst, qwait, park)


def _ctrl_tbl(s: SimState):
    """The controller carry of ``s``: its flow tables flattened to ``[W,
    n_switches * ctrl_slots + 1]`` (the last cell takes masked-off
    writes), then the controller's scalars and counters."""
    w = s.ftab_pair.shape[0]

    def flat(tab):
        return torch.cat([tab.reshape(w, -1), tab.new_zeros((w, 1))], 1)

    return (flat(s.ftab_pair), flat(s.ftab_ready), flat(s.ftab_stamp),
            s.ctrl_busy, s.ctrl_stamp, s.ctrl_installs, s.ctrl_evictions,
            s.ctrl_reinstalls, s.ctrl_queue_wait, s.ctrl_failover_park)


def _with_ctrl_tbl(s: SimState, tbl) -> SimState:
    (fpair, fready, fstamp, busy, stamp, installs, evicts, reinst,
     qwait, park) = tbl
    shape = s.ftab_pair.shape
    return s._replace(
        ftab_pair=fpair[:, :-1].reshape(shape),
        ftab_ready=fready[:, :-1].reshape(shape),
        ftab_stamp=fstamp[:, :-1].reshape(shape),
        ctrl_busy=busy, ctrl_stamp=stamp, ctrl_installs=installs,
        ctrl_evictions=evicts, ctrl_reinstalls=reinst,
        ctrl_queue_wait=qwait, ctrl_failover_park=park)


def _bump(nc, links, mask):
    """``nc [W, L]`` plus one channel on every link of ``links [W, H]``
    where ``mask [W]``: an integer scatter-add, exact in any order."""
    m = (links >= 0) & mask[:, None]
    return nc.scatter_add(1, torch.where(m, links, 0).long(), m.to(I32))


def _pop_order(mask):
    """``(order [W, P], count [W])``: each lane's set packets in ascending
    index order (``P`` past the count), and how many there are."""
    n_p = mask.shape[1]
    idx = torch.arange(n_p, device=mask.device)
    return torch.where(mask, idx, n_p).sort(dim=1).values, mask.sum(1)


def _scatter_seq(a, order, ok, value):
    """``a [W, P]`` with ``value [W, K]`` written at the packets ``order
    [W, K]`` (distinct per lane) where ``ok [W, K]``."""
    w, n_p = a.shape
    padded = torch.cat([a, a.new_zeros((w, 1))], 1)
    padded = padded.scatter(1, torch.where(ok, order, n_p), value)
    return padded[:, :n_p]


def _activate_ctrl(c: EngineConsts, meta, pol, ph, aux, cache, nc,
                   s: SimState):
    """Packet activation with the controller in the loop (DESIGN.md §10);
    replaces ``_activate`` when ``meta.has_ctrl`` and the lanes' config is
    live (an identity-config scenario of a mixed grid runs ``_activate``:
    with ``ctrl_on`` false its lanes bypass the controller and nothing is
    ever parked, pre-pinned or migrated).

    The reference pops the union of the newly ready packets and the WAKE
    set (INSTALLING packets whose ``pkt_ready_t`` has come) in ascending
    packet index.  Legacy lanes never consult the controller and never
    park: their ready packets activate at once on the hash pick, one
    vectorised gather and integer scatter-add.  SDN lanes scan their pops
    in order; per popped packet:

      * a woken packet activates on its stored route;
      * otherwise its route is the proactive pin if it has one, else the
        live bottleneck pick, and it requests its missing rules via
        ``_ctrl_request``: ``ready <= t`` activates in the same trip, else
        it parks INSTALLING with ``pkt_ready_t = ready`` (a dt breakpoint)
        and accrues ``pkt_install_wait``.

    Only activating packets bump the channel counts, which later picks
    read.  A packet is popped at most once a step and reads only its own
    pre-step fields, so the scan carries just the channel counts and the
    table; each packet's updates are written after it, in one scatter a
    field.  On a step where no SDN packet is newly ready, every pop is a
    woken packet: none picks or requests, their bumps commute, and they
    activate at once with the legacy lanes' packets.  Returns what
    ``_activate`` returns."""
    t_ready = ((s.task_state == WAITING) & (s.task_got >= c.task_need)
               & (s.task_vm >= 0))
    s = s._replace(
        task_state=torch.where(t_ready, ACTIVE, s.task_state),
        task_start=torch.where(t_ready, s.time[:, None], s.task_start))

    gate = c.pkt_gate_task
    gate_ok = (gate < 0) | (_take(s.task_state, gate.clamp(min=0).long())
                            == DONE)
    admitted = _take(s.job_admitted, c.pkt_job.clamp(min=0).long())
    p_ready = ((s.pkt_state == WAITING) & admitted & gate_ok & c.pkt_valid
               & cache["reachable"])
    if meta.has_failures:
        n_t = s.task_vm.shape[1]

        def ep_placed(ref):
            is_task = (ref >= 0) & (ref < NODE_OFFSET)
            return ~is_task | (_take(s.task_vm, ref.clamp(0, n_t - 1)
                                     .long()) >= 0)

        p_ready = (p_ready & ep_placed(c.pkt_src_task)
                   & ep_placed(c.pkt_dst_task))
    link_bw = _effective_link_bw(c, meta, s)
    t_col = s.time[:, None]
    p_wake = (s.pkt_state == INSTALLING) & (s.pkt_ready_t <= t_col)
    is_sdn = (pol["routing"] == ROUTE_SDN)[:, None]
    pair_all = cache["pair"]
    # packets that activate at once, without a scan: the legacy lanes'
    at_once = p_ready & ~is_sdn
    fresh = p_ready & is_sdn
    pop = fresh | (p_wake & is_sdn)
    order, n_pop = _pop_order(pop)
    # torchcheck: disable=item-call: one read of the controller's request
    # sizes
    k_max, any_at_once, any_fresh = (int(v) for v in torch.stack(
        [n_pop.max(), at_once.any().long(), fresh.any().long()]).tolist())
    if not any_fresh:
        # only woken packets pop: none picks or requests, so their
        # channel bumps commute and they activate at once too
        at_once = at_once | (p_wake & is_sdn)
        any_at_once, k_max = any_at_once or k_max, 0
    # a packet reverted by a failure or a migration keeps its first start
    start_now = torch.where(torch.isnan(s.pkt_start), t_col, s.pkt_start)
    w, n_p = pop.shape

    if any_at_once:
        # a woken packet keeps its stored route (``pkt_cand >= 0``), a
        # legacy one takes its hash pick
        woke = s.pkt_cand >= 0
        pair = torch.where(woke, s.pkt_pair, pair_all)
        cand = torch.where(woke, s.pkt_cand, legacy_route_choice(
            c.n_cand[pair_all.long()], aux["pkt_hash"]))
        links = c.routes[pair.long(), cand.long()]               # [W, P, H]
        m = at_once[..., None] & (links >= 0)
        nc = nc.scatter_add(1, torch.where(m, links, 0).reshape(
            w, -1).long(), m.reshape(w, -1).to(I32))
        s = s._replace(
            pkt_state=torch.where(at_once, ACTIVE, s.pkt_state),
            pkt_pair=torch.where(at_once, pair, s.pkt_pair),
            pkt_cand=torch.where(at_once, cand, s.pkt_cand),
            pkt_start=torch.where(at_once, start_now, s.pkt_start),
            pkt_ready_t=torch.where(at_once, torch.inf, s.pkt_ready_t))

    if k_max:
        rows = _rows(w, nc.device)[:, 0]
        seq = order[:, :k_max]
        ok = torch.arange(k_max, device=nc.device) < n_pop[:, None]
        at = seq.clamp(max=n_p - 1)
        woken = torch.gather(p_wake, 1, at)
        cand0 = torch.gather(s.pkt_cand, 1, at)
        pre = cand0 >= 0
        pair = torch.where(pre, torch.gather(s.pkt_pair, 1, at),
                           torch.gather(pair_all, 1, at))
        needs = ok & ~woken & c.ctrl_on
        churn = pre & ~woken
        t = s.time
        now = _ctrl_now(c, t)
        tbl = _ctrl_tbl(s)
        cands, readys, acts = [], [], []
        for k in range(k_max):
            pk = pair[:, k].long()
            routes_k = c.routes[pk]                              # [W, K, H]
            pick = sdn_route_choice(routes_k, c.n_cand[pk], link_bw, nc)
            cand = torch.where(pre[:, k], cand0[:, k], pick)
            links = routes_k[rows, cand.long()]                  # [W, H]
            ready, tbl = _ctrl_request(c, meta, aux["link_sw"], pair[:, k],
                                       links, needs[:, k], churn[:, k], t,
                                       now, tbl)
            act = ok[:, k] & (~needs[:, k] | (ready <= t))
            nc = _bump(nc, links, act)
            cands.append(cand)
            readys.append(ready)
            acts.append(act)
        cand = torch.stack(cands, 1)
        ready = torch.stack(readys, 1)
        act = torch.stack(acts, 1)
        parked = ok & ~act
        wait = torch.where(parked, (ready - t_col).clamp(min=0.0), 0.0)
        s = _with_ctrl_tbl(s._replace(
            pkt_state=_scatter_seq(s.pkt_state, seq, ok, torch.where(
                act, ACTIVE, INSTALLING).to(I32)),
            pkt_pair=_scatter_seq(s.pkt_pair, seq, ok, pair),
            pkt_cand=_scatter_seq(s.pkt_cand, seq, ok, cand),
            pkt_start=_scatter_seq(s.pkt_start, seq, ok,
                                   torch.gather(start_now, 1, at)),
            pkt_ready_t=_scatter_seq(s.pkt_ready_t, seq, ok, torch.where(
                act, torch.inf, ready)),
            pkt_install_wait=_scatter_seq(
                s.pkt_install_wait, seq, ok,
                torch.gather(s.pkt_install_wait, 1, at) + wait)), tbl)

    p_active = s.pkt_state == ACTIVE
    return s, _route_links(c, s, p_active), p_active, nc, link_bw


def _preinstall(c: EngineConsts, meta, pol, aux, cache, nc, s: SimState,
                admit_now) -> SimState:
    """Proactive rule installation at admission (DESIGN.md §10), on SDN
    lanes with ``install_mode=proactive``: the newly admitted jobs'
    unrouted packets in ascending index order each take the bottleneck
    pick against a scratch channel view (the live counts plus each earlier
    pin), request their rules (advancing the controller queue) and pin
    ``pkt_pair``/``pkt_cand``.  They stay WAITING; by first use their
    rules are usually cached.  A packet reads only its own pre-pass
    fields, so the pins are written after the scan."""
    lane = ((pol["install_mode"] == INSTALL_PROACTIVE)
            & (pol["routing"] == ROUTE_SDN))[:, None]
    mask = (c.pkt_valid & _take(admit_now, c.pkt_job.clamp(min=0).long())
            & (s.pkt_cand < 0) & cache["reachable"] & c.ctrl_on & lane)
    order, n = _pop_order(mask)
    # torchcheck: disable=tracer-cast: the pre-install pass's depth, read on
    # the host
    k_max = int(n.max())
    if not k_max:
        return s
    w, n_p = mask.shape
    rows = _rows(w, nc.device)[:, 0]
    seq = order[:, :k_max]
    ok = torch.arange(k_max, device=nc.device) < n[:, None]
    pair = torch.gather(cache["pair"], 1, seq.clamp(max=n_p - 1))
    link_bw = _effective_link_bw(c, meta, s)
    no_churn = torch.zeros_like(ok[:, 0])
    now = _ctrl_now(c, s.time)
    tbl, snc, cands = _ctrl_tbl(s), nc, []
    for k in range(k_max):
        pk = pair[:, k].long()
        routes_k = c.routes[pk]
        cand = sdn_route_choice(routes_k, c.n_cand[pk], link_bw, snc)
        links = routes_k[rows, cand.long()]
        _, tbl = _ctrl_request(c, meta, aux["link_sw"], pair[:, k], links,
                               ok[:, k], no_churn, s.time, now, tbl)
        snc = _bump(snc, links, ok[:, k])
        cands.append(cand)
    return _with_ctrl_tbl(s._replace(
        pkt_pair=_scatter_seq(s.pkt_pair, seq, ok, pair),
        pkt_cand=_scatter_seq(s.pkt_cand, seq, ok,
                              torch.stack(cands, 1))), tbl)


def _maybe_migrate(c: EngineConsts, meta, pol, s: SimState, nc):
    """Migrate-on-congestion (DESIGN.md §10), on lanes with
    ``migration=congestion``: at most one VM a step re-homes when its
    route-hop cost over ACTIVE packets (``pair_hops`` of each packet whose
    src or dst task runs on it) exceeds ``mig_threshold``.  The costliest
    eligible VM (over threshold, out of cooldown, ``mig_limit`` not spent)
    moves to the live host minimising the estimated cost of its packets
    with its end re-homed, if that strictly improves on its own host.  The
    move takes one controller slot and pauses the VM until
    ``vm_mig_until``; every routed packet of the VM reverts to WAITING
    (the ACTIVE ones release their channels: an integer scatter-add).
    Two host syncs skip the rest on the steps where no VM is eligible
    (all of them once ``mig_limit`` is spent) or none moves.

    The estimate per host is the reference's sum over the VM's packets of
    ``pair_hops[new_src, new_dst]``: grouped by the packet's other end it
    is two small integer products, ``counts @ hops``, exact in float64
    (hop sums are integers far below 2**53) and rounded to float32 once,
    as the reference's float32 sum of integers is while below 2**24.
    Returns ``(s, nc, migrated [W])``, ``migrated`` ``None`` when no lane
    migrated."""
    w, n_t = s.task_vm.shape
    n_v = s.vm_host.shape[1]
    n_nodes = meta.n_nodes
    dev = nc.device
    t = s.time

    def ep_vm(ref):
        is_task = (ref >= 0) & (ref < NODE_OFFSET)
        vm = _take(s.task_vm, ref.clamp(0, n_t - 1).long())
        return torch.where(is_task, vm, -1)                     # [W, P]

    src_vm, dst_vm = ep_vm(c.pkt_src_task), ep_vm(c.pkt_dst_task)
    p_active = s.pkt_state == ACTIVE
    cost_p = torch.where(p_active, c.pair_hops[s.pkt_pair.clamp(
        min=0).long()], 0).to(torch.int64)

    def by_vm(vm):
        return torch.zeros((w, n_v + 1), dtype=torch.int64, device=dev
                           ).scatter_add(1, torch.where(vm >= 0, vm, n_v)
                                         .long(), cost_p)[:, :n_v].to(F32)

    cost = by_vm(src_vm) + by_vm(dst_vm)                        # [W, V]
    viota = torch.arange(n_v, device=dev)
    lane = ((pol["migration"] == MIG_CONGESTION)
            & (s.vm_migrations.sum(1) < c.mig_limit))
    elig = ((viota < c.n_vms) & (cost > c.mig_threshold)
            & (t[:, None] >= s.vm_mig_until + c.mig_cooldown)
            & lane[:, None])
    # torchcheck: disable=tracer-cast: fast path: no VM eligible, no migration
    if not bool(elig.any()):
        return s, nc, None
    v = torch.where(elig, cost, -1.0).argmax(1)                 # [W]

    src_node, dst_node = _pkt_endpoints(c, meta, s)
    mine_s = p_active & (src_vm == v[:, None])
    mine_d = p_active & (dst_vm == v[:, None])

    def counts(mask, node):
        # torchcheck: disable=f64-literal: exact integer counts in float64 for
        # the product
        return torch.zeros((w, n_nodes + 1), dtype=torch.float64,
                           device=dev).scatter_add(
            1, torch.where(mask, node, n_nodes).long(),
            mask.to(torch.float64))[:, :n_nodes]

    n_h = c.host_fail_t.shape[0]
    # torchcheck: disable=f64-literal: exact integer counts in float64 for the
    # product
    hops = c.pair_hops.reshape(n_nodes, n_nodes).to(torch.float64)
    # a packet with both ends on v moves both: pair (h, h), 0 hops
    est = (counts(mine_s & ~mine_d, dst_node) @ hops[:n_h].T
           + counts(mine_d & ~mine_s, src_node) @ hops[:, :n_h]).to(F32)
    host_live = torch.arange(n_h, device=dev) < c.n_hosts
    if meta.has_failures:
        host_live = host_live & ~s.host_dead
    cur_host = s.vm_host[torch.arange(w, device=dev), v].clamp(0, n_h - 1)
    h_best = torch.where(host_live, est, torch.inf).argmin(-1)
    rows = torch.arange(w, device=dev)
    do = (elig.any(1) & (est[rows, h_best] < est[rows, cur_host.long()])
          & (h_best != cur_host))
    # torchcheck: disable=tracer-cast: fast path: no better host, no migration
    if not bool(do.any()):
        return s, nc, None

    vm_oh = (viota == v[:, None]) & do[:, None]
    routed = (p_active | (s.pkt_state == INSTALLING)
              | ((s.pkt_state == WAITING) & (s.pkt_cand >= 0)))
    hit_p = (routed & ((src_vm == v[:, None]) | (dst_vm == v[:, None]))
             & do[:, None])
    links = _route_links(c, s, hit_p & p_active)                # [W, P, H]
    m = links >= 0
    nc = nc.scatter_add(1, torch.where(m, links, 0).reshape(w, -1).long(),
                        -m.reshape(w, -1).to(I32))
    s = s._replace(
        vm_host=torch.where(vm_oh, h_best[:, None].to(I32), s.vm_host),
        vm_mig_until=torch.where(vm_oh, t[:, None] + c.mig_cost,
                                 s.vm_mig_until),
        vm_migrations=s.vm_migrations + vm_oh.to(I32),
        ctrl_busy=torch.where(do, torch.maximum(t, s.ctrl_busy)
                              + 1.0 / c.ctrl_rate, s.ctrl_busy),
        pkt_state=torch.where(hit_p, WAITING, s.pkt_state),
        pkt_pair=torch.where(hit_p, -1, s.pkt_pair),
        pkt_cand=torch.where(hit_p, -1, s.pkt_cand),
        pkt_ready_t=torch.where(hit_p, torch.inf, s.pkt_ready_t),
        pkt_reroutes=s.pkt_reroutes + hit_p.to(I32))
    return s, nc, do


def _speculate(c: EngineConsts, meta, pol, s: SimState) -> SimState:
    """YARN speculative execution (DESIGN.md §13) on lanes with
    ``speculation=on``; called when ``meta.spec_slots > 0``.

    * Cleanup: a clone whose original left ACTIVE (or whose host died) is
      cancelled; its elapsed seconds join ``spec_wasted``, its VM frees.
    * Launch, at most one a step: among ACTIVE tasks whose observed rate
      ``(mi - rem) / elapsed`` is below half their job's live median, the
      slowest uncloned one with a free slot in its job's block gets a
      clone on the least-loaded live VM off its host, preferring hosts
      outside every current degradation window.  The clone restarts from
      zero work.

    The median's witness per job is the task of rank ``n // 2`` among the
    job's eligible tasks ordered by (rate, index).  The reference counts
    ranks pairwise (``[n_t, n_t]``); two stable sorts give the same order,
    so the same witness and the same float, without arithmetic."""
    w, n_t = s.task_state.shape
    S = s.spec_of.shape[1]
    n_j = s.job_admitted.shape[1]
    n_hp = c.host_fail_t.shape[0]
    dev = s.time.device
    t = s.time[:, None]
    on = (pol["speculation"] == SPEC_ON)[:, None]
    n_v = s.vm_load.shape[1]
    vm_host = _vm_host(c, meta, s).clamp(0, n_hp - 1).long().expand(w, n_v)

    # cleanup
    orig = s.spec_of.clamp(min=0).long()
    live = s.spec_of >= 0
    cancel = live & (torch.gather(s.task_state, 1, orig) != ACTIVE)
    if meta.has_failures:
        clone_host = torch.gather(vm_host, 1, s.spec_vm.clamp(min=0).long())
        cancel = cancel | (live & torch.gather(s.host_dead, 1, clone_host))
    cancel = cancel & on
    spec_wasted = s.spec_wasted + _sum32(
        torch.where(cancel, t - s.spec_start, 0.0))
    vm_load = s.vm_load - torch.zeros_like(s.vm_load).scatter_add(
        1, s.spec_vm.clamp(min=0).long(), cancel.to(I32))
    spec_of = torch.where(cancel, -1, s.spec_of)

    # stragglers against the per-job live median of observed rates
    elapsed = t - s.task_start
    el_ok = (s.task_state == ACTIVE) & c.task_valid & (elapsed > 1e-9)
    rate = torch.where(el_ok, (c.task_mi - s.task_rem)
                       / elapsed.clamp(min=1e-9), 0.0)
    job = c.task_job.clamp(min=0).long()
    jkey = torch.where(el_ok, job, n_j)
    by_rate = torch.argsort(torch.where(el_ok, rate, torch.inf), dim=1,
                            stable=True)
    order = torch.gather(by_rate, 1, torch.argsort(
        torch.gather(jkey, 1, by_rate), dim=1, stable=True))
    cnt = torch.zeros((w, n_j + 1), dtype=torch.int64, device=dev
                      ).scatter_add(1, jkey, torch.ones_like(jkey))[:, :n_j]
    med_at = (cnt.cumsum(1) - cnt + cnt // 2).clamp(max=n_t - 1)
    med = torch.where(cnt > 0, torch.gather(
        rate, 1, torch.gather(order, 1, med_at)), 0.0)          # [W, J]
    free = spec_of < 0
    job_free = free.reshape(w, n_j, meta.spec_slots).any(2)
    straggler = (el_ok & ~s.task_cloned
                 & (2.0 * rate < torch.gather(med, 1, job.expand(w, n_t)))
                 & torch.gather(job_free, 1, job.expand(w, n_t)) & on)

    # launch the slowest straggler on the least-loaded eligible VM
    vm_live = (torch.arange(n_v, device=dev) < c.n_vms).expand(w, n_v)
    if meta.has_failures:
        vm_live = vm_live & ~torch.gather(s.host_dead, 1, vm_host)
    launch = straggler.any(1) & vm_live.any(1)
    rows = torch.arange(w, device=dev)
    slow = torch.where(straggler, rate, torch.inf).argmin(1)   # [W]
    siota = torch.arange(S, device=dev)
    slot = torch.where(free & (siota // meta.spec_slots
                               == _take(job, slow[:, None])),
                       siota, S).amin(1).clamp(max=S - 1)
    host_w = vm_host[rows, s.task_vm[rows, slow].clamp(min=0).long()]
    off_host = vm_live & (vm_host != host_w[:, None])
    use = torch.where(off_host.any(1, keepdim=True), off_host, vm_live)
    if meta.has_degradation:
        undeg = use & (torch.gather(_host_deg_factor(c, s), 1, vm_host)
                       >= 1.0)
        use = torch.where(undeg.any(1, keepdim=True), undeg, use)
    pick = torch.where(use, vm_load, _IMAX).argmin(1)
    oh = (siota == slot[:, None]) & launch[:, None]
    return s._replace(
        spec_of=torch.where(oh, slow[:, None].to(I32), spec_of),
        spec_vm=torch.where(oh, pick[:, None].to(I32), s.spec_vm),
        spec_rem=torch.where(oh, _take(c.task_mi, slow[:, None]),
                             s.spec_rem),
        spec_start=torch.where(oh, t, s.spec_start),
        task_cloned=s.task_cloned | ((torch.arange(n_t, device=dev)
                                      == slow[:, None]) & launch[:, None]),
        vm_load=vm_load + ((torch.arange(n_v, device=dev) == pick[:, None])
                           & launch[:, None]).to(I32),
        spec_launches=s.spec_launches + launch.to(I32),
        spec_wasted=spec_wasted)


def _rates(c: EngineConsts, meta, ph, s: SimState, links, p_active, nc,
           link_bw):
    """Piecewise-constant packet and task rates for this interval, and the
    clones' rates (``None`` without clone slots): a clone shares its VM
    like a task, gray windows scale a host's rates, a dead host's and a
    migrating VM's are 0."""
    pkt_rate = fairshare.rates(ph["traffic"], links, p_active, link_bw,
                               meta.intra_bw, nc=nc)
    t_active = s.task_state == ACTIVE
    vm = s.task_vm.clamp(min=0).long()
    n_on_vm = torch.zeros_like(s.vm_load).scatter_add(1, vm,
                                                      t_active.to(I32))
    if meta.spec_slots > 0:
        s_active = s.spec_of >= 0
        svm = s.spec_vm.clamp(min=0).long()
        n_on_vm = n_on_vm.scatter_add(1, svm, s_active.to(I32))
    share = c.vm_total_mips[vm] / torch.gather(n_on_vm, 1, vm).clamp(
        min=1).to(F32)
    task_rate = torch.where(t_active,
                            torch.minimum(c.vm_core_mips[vm], share), 0.0)
    n_hp = c.host_fail_t.shape[0]
    if meta.has_failures or meta.has_degradation:
        host = _host_of_vm(c, meta, s, vm).clamp(0, n_hp - 1).long()
    if meta.has_degradation:
        hfac = _host_deg_factor(c, s)
        task_rate = task_rate * torch.gather(hfac, 1, host)
    if meta.has_failures:
        # a task stranded on a dead host executes nothing
        task_rate = torch.where(torch.gather(s.host_dead, 1, host), 0.0,
                                task_rate)
    t_col = s.time[:, None]
    if meta.has_ctrl:
        # a migrating VM executes nothing until the move completes
        task_rate = torch.where(torch.gather(s.vm_mig_until, 1, vm)
                                > t_col, 0.0, task_rate)
    spec_rate = None
    if meta.spec_slots > 0:
        share_s = c.vm_total_mips[svm] / torch.gather(n_on_vm, 1, svm).clamp(
            min=1).to(F32)
        spec_rate = torch.where(
            s_active, torch.minimum(c.vm_core_mips[svm], share_s), 0.0)
        clone_host = _host_of_vm(c, meta, s, svm).clamp(0, n_hp - 1).long()
        if meta.has_degradation:
            spec_rate = spec_rate * torch.gather(hfac, 1, clone_host)
        if meta.has_failures:
            spec_rate = torch.where(torch.gather(s.host_dead, 1, clone_host),
                                    0.0, spec_rate)
        if meta.has_ctrl:
            spec_rate = torch.where(torch.gather(s.vm_mig_until, 1, svm)
                                    > t_col, 0.0, spec_rate)
    return pkt_rate, task_rate, t_active, spec_rate


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
    # torchcheck: disable=tracer-cast: the per-host sum's depth, read on the
    # host
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


def _make_aux(c: EngineConsts, meta, pol, ph) -> Dict[str, torch.Tensor]:
    """Loop-invariant values: the per-task placement hash and per-packet
    legacy flow hash of each lane's seed, the completion tolerances, and
    the host-side switches of the control plane's optional passes (read
    once a run): ``ctrl_on`` (this scenario's config is live), ``mig_on``
    (some lane migrates under a finite threshold; cleared once the lanes'
    budget is spent), ``pre_on`` (some lane installs proactively) and
    ``spec_on`` (some lane speculates); with the control plane, the
    failover edges (primary down, election gap over, primary back) and
    each link's source switch (``-1`` for a host or storage node)."""
    n_t = c.task_job.shape[-1]
    seed = pol["seed"][:, None]
    tidx = torch.arange(n_t, dtype=I32, device=seed.device)
    # torchcheck: disable=tracer-cast: host policy arrays, once a run
    aux = {
        "task_hash": flow_hash_u32(tidx, c.task_job, seed),
        "pkt_hash": flow_hash_u32(c.pkt_src_task + 1, c.pkt_dst_task + 1,
                                  seed),
        "pkt_tol": fma32(c.pkt_bits, 1e-6, 1.0),
        "task_tol": fma32(c.task_mi, 1e-6, 1e-6),
        "ctrl_on": False, "mig_on": False, "pre_on": False,
        "spec_on": bool(meta.spec_slots > 0
                        and (ph["speculation"] == SPEC_ON).any()),
    }
    if meta.has_ctrl:
        # torchcheck: disable=item-call: the controller's switches, once a run
        ctrl_on, mig_finite = torch.stack(
            [c.ctrl_on, torch.isfinite(c.mig_threshold)]).tolist()
        sdn = ph["routing"] == ROUTE_SDN
        src = c.link_src.long()
        # torchcheck: disable=tracer-cast: host values, once a run
        aux.update(
            failover_edges=torch.stack([c.ctrl_fail_t, torch.minimum(
                c.ctrl_fail_t + c.ctrl_failover_delay, c.ctrl_recover_t),
                c.ctrl_recover_t]),
            link_sw=torch.where((src >= meta.n_hosts) & (
                src < meta.n_hosts + meta.n_switches), src - meta.n_hosts,
                -1),
            ctrl_on=bool(ctrl_on),
            mig_on=bool(mig_finite
                        and (ph["migration"] == MIG_CONGESTION).any()),
            pre_on=bool(ctrl_on and (
                sdn & (ph["install_mode"] == INSTALL_PROACTIVE)).any()))
    return aux


def _step(c: EngineConsts, meta, pol, ph, aux, s: SimState, cache, nc,
          fail=None):
    """One event.  ``fail`` is ``(dead masks, died)`` from the loop when
    ``meta.has_failures`` (``_dead_masks`` and its host-side delta)."""
    if meta.has_failures:
        s, nc = _apply_failures(c, meta, pol, s, nc, *fail)
    s, placed, any_placed, admit_now = _admit_and_place(c, meta, pol, ph,
                                                        aux, s)
    if aux["mig_on"]:
        # migrate before the cache refresh, so re-homed endpoints resolve
        # against the new placement this very step
        s, nc, migrated = _maybe_migrate(c, meta, pol, s, nc)
        if migrated is not None:
            placed, any_placed = placed | migrated, True
            # once every migrating lane has spent ``mig_limit``, no VM
            # can become eligible again: the pass stops for the run
            # torchcheck: disable=tracer-cast: ends the migration pass for the
            # run
            aux["mig_on"] = bool(((pol["migration"] == MIG_CONGESTION) & (
                s.vm_migrations.sum(1) < c.mig_limit)).any())
    if any_placed:
        # placement changed -> the packet endpoint/pair cache is stale
        fresh = _endpoint_cache(c, meta, s)
        cache = {k: torch.where(placed[:, None], fresh[k], cache[k])
                 for k in cache}
    if aux["ctrl_on"]:
        if aux["pre_on"] and admit_now is not None:
            s = _preinstall(c, meta, pol, aux, cache, nc, s, admit_now)
        s, links, p_active, nc, link_bw = _activate_ctrl(
            c, meta, pol, ph, aux, cache, nc, s)
    else:
        s, links, p_active, nc, link_bw = _activate(c, meta, pol, ph, aux,
                                                    cache, nc, s)
    if aux["spec_on"]:
        # after activation (just-activated tasks are seen), before rates
        # (a launched clone shares its VM from this interval)
        s = _speculate(c, meta, pol, s)
    pkt_rate, task_rate, t_active, spec_rate = _rates(
        c, meta, ph, s, links, p_active, nc, link_bw)

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
    t_col = s.time[:, None]

    def until(instants, live=None):
        # the earliest of ``instants`` after the clock, as a step length
        later = instants > t_col
        return torch.where(later if live is None else live & later,
                           instants - t_col, inf).amin(-1)

    if meta.has_failures:
        # fail/recover instants are rate breakpoints like job releases
        dt = torch.minimum(dt, until(c.fail_breaks))
    if meta.has_degradation:
        dt = torch.minimum(dt, until(c.deg_breaks))
    if meta.has_ctrl:
        # install wakes, migration resumes and the three failover edges
        # (primary down, election gap over, primary back)
        dt = torch.minimum(dt, torch.minimum(torch.minimum(
            until(s.pkt_ready_t, s.pkt_state == INSTALLING),
            until(s.vm_mig_until)), until(aux["failover_edges"])))
    if meta.spec_slots > 0:
        # clone finishes join the min like task finishes
        dt = torch.minimum(dt, torch.where(
            (s.spec_of >= 0) & (spec_rate > 0), s.spec_rem / spec_rate,
            inf).amin(1))
    stalled = torch.isinf(dt)
    dt = torch.where(stalled, 0.0, dt)
    dt_col = dt[:, None]

    # energy (power is constant over [t, t+dt))
    vm_safe = s.task_vm.clamp(min=0).long()
    n_h = c.host_total_mips.shape[0]
    mips_used = _mips_by_host(_host_of_vm(c, meta, s, vm_safe), t_active,
                              task_rate, n_h)
    if meta.spec_slots > 0:
        # clones burn host cycles like tasks
        clone_host = _host_of_vm(c, meta, s, s.spec_vm.clamp(min=0))
        on_host = (s.spec_of >= 0)[:, :, None] & (
            clone_host[:, :, None] == torch.arange(n_h, device=dt.device))
        mips_used = mips_used + _sum32(torch.where(
            on_host, spec_rate[:, :, None], 0.0), 1)
    # utilisation against the current (possibly degraded) capacity
    util = (mips_used / _effective_host_mips(c, meta, s).clamp(min=1e-9)
            ).clamp(0.0, 1.0)
    if meta.has_failures:
        util = torch.where(s.host_dead, 0.0, util)      # dead hosts draw 0 W
    host_energy = fma32(host_power(util, meta.energy), dt_col, s.host_energy)
    host_busy = s.host_busy + torch.where(util > 0, dt_col, 0.0)
    live_link = (nc > 0).to(I32)
    if meta.has_failures:
        live_link = torch.where(s.link_dead, 0, live_link)  # port is down
    ports = torch.zeros((nc.shape[0], meta.n_nodes), dtype=I32,
                        device=nc.device)
    ports.scatter_add_(1, c.link_src.long().expand_as(live_link), live_link)
    ports.scatter_add_(1, c.link_dst.long().expand_as(live_link), live_link)
    sw_ports = ports[:, meta.n_hosts:meta.n_hosts + meta.n_switches]
    switch_energy = fma32(switch_power(sw_ports, meta.energy), dt_col,
                          s.switch_energy)

    job_downtime = s.job_downtime
    if meta.has_failures:
        # per-job downtime: admitted, not done, and nothing of the job
        # moves over [t, t+dt)
        n_j = s.job_downtime.shape[1]
        prog_t = (t_active & (task_rate > 0) & c.task_valid).to(I32)
        prog_p = (p_active & (pkt_rate > 0) & c.pkt_valid).to(I32)
        prog = torch.zeros((prog_t.shape[0], n_j), dtype=I32,
                           device=dt.device)
        prog.scatter_add_(1, c.task_job.clamp(min=0).long().expand_as(
            prog_t), prog_t)
        prog.scatter_add_(1, c.pkt_job.clamp(min=0).long().expand_as(
            prog_p), prog_p)
        job_live = (s.job_admitted & (s.job_out_done < c.job_n_out)
                    & c.job_valid)
        job_downtime = job_downtime + torch.where(job_live & (prog == 0),
                                                  dt_col, 0.0)
    degraded_time = s.degraded_time
    if meta.has_degradation:
        # wall-clock seconds with any live gray window open
        t_col = s.time[:, None]
        any_deg = (((c.host_slow_t <= t_col) & (t_col < c.host_restore_t)
                    & (c.host_deg_factor != 1.0)).any(1)
                   | ((c.link_slow_t <= t_col) & (t_col < c.link_restore_t)
                      & (c.link_deg_factor != 1.0)).any(1))
        degraded_time = degraded_time + torch.where(any_deg, dt, 0.0)

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
    task_state = torch.where(t_done, DONE, s.task_state)
    task_finish = torch.where(t_done, time_col, s.task_finish)

    ctrl_failovers = s.ctrl_failovers
    if meta.has_ctrl:
        # the primary's outage starts once, when the clock crosses it
        ctrl_failovers = ctrl_failovers + (
            (s.time <= c.ctrl_fail_t) & (time > c.ctrl_fail_t)).to(I32)

    spec = {}
    if meta.spec_slots > 0:
        # clone completions: the first finish wins, a tie goes to the
        # original
        s_orig = s.spec_of.clamp(min=0).long()
        s_live = s.spec_of >= 0
        spec_rem = torch.where(s_live, fma32(-spec_rate, dt_col, s.spec_rem),
                               s.spec_rem)
        clone_done = s_live & (spec_rem <= _take(aux["task_tol"], s_orig))
        win = clone_done & ~torch.gather(t_done, 1, s_orig)
        win_t = torch.zeros(t_done.shape, dtype=I32, device=dt.device
                            ).scatter_add(1, s_orig, win.to(I32)) > 0
        task_state = torch.where(win_t, DONE, task_state)
        task_finish = torch.where(win_t, time_col, task_finish)
        task_rem = torch.where(win_t, 0.0, task_rem)
        # the losing copy frees its container: the original's VM on a
        # win, the clone's on every clone finish
        vm_load = vm_load - torch.zeros_like(vm_load).scatter_add(
            1, vm_safe, win_t.to(I32)) - torch.zeros_like(
            vm_load).scatter_add(1, s.spec_vm.clamp(min=0).long(),
                                 clone_done.to(I32))
        # wasted seconds: the original's run on a win, the clone's on a
        # photo-finish loss
        waste = torch.where(win, time_col - torch.gather(s.task_start, 1,
                                                         s_orig),
                            time_col - s.spec_start)
        spec = dict(
            spec_of=torch.where(clone_done, -1, s.spec_of),
            spec_rem=spec_rem,
            spec_wins=s.spec_wins + win.sum(1, dtype=I32),
            spec_wasted=s.spec_wasted + _sum32(
                torch.where(clone_done, waste, 0.0)))

    s = s._replace(
        time=time, steps=s.steps + 1, stalled=stalled,
        job_out_done=job_out_done,
        job_done_t=torch.where(newly_job_done, time_col, s.job_done_t),
        task_state=task_state, task_rem=task_rem, task_got=task_got,
        task_finish=task_finish,
        pkt_state=torch.where(p_done, DONE, s.pkt_state), pkt_rem=pkt_rem,
        pkt_finish=torch.where(p_done, time_col, s.pkt_finish),
        vm_load=vm_load, host_energy=host_energy, host_busy=host_busy,
        switch_energy=switch_energy, job_downtime=job_downtime,
        degraded_time=degraded_time, ctrl_failovers=ctrl_failovers, **spec)
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


def _carry(consts: EngineConsts, meta, s: SimState):
    """The loop carry ``(s, cache, nc, done)`` of a state with nothing
    active: its endpoint cache, zero channel counts, its finished flags."""
    nc = torch.zeros((s.time.shape[0], meta.n_links), dtype=I32,
                     device=s.time.device)
    return s, _endpoint_cache(consts, meta, s), nc, _finished(consts, meta, s)


def _advance(consts: EngineConsts, meta, pol, ph, aux, carry,
             max_events: int | None = None):
    """The loop body of every run: ``carry = (s, cache, nc, done)`` advanced
    an event at a time while some lane is not done, for at most
    ``max_events`` events (``None``: to the end).

    Each event steps every lane, the finished ones too (the reference's
    fleet chunk steps its whole cohort): a finished lane's state is frozen,
    while the stepped endpoint cache and channel counts are kept, and a
    finished lane's steps leave its ready sets empty.  ``done`` is sticky:
    a lane it marks (a pad lane of a fleet cohort, say) stays frozen even
    where ``_finished`` does not hold.  The loop reads the finished flags
    on the host before each event; with failures the dead masks' delta
    rides in the same copy."""
    s, cache, nc, done = carry
    width = done.shape[0]
    fail = None
    n = 0
    while max_events is None or n < max_events:
        if meta.has_failures:
            dead = _dead_masks(consts, s)
            died = ((dead[0] & ~s.host_dead).any(1)
                    | (dead[1] & ~s.link_dead).any(1)) & ~done
            # torchcheck: disable=item-call: the loop's done check: one read
            # an event
            flags = torch.cat([done, died]).cpu()
            done_h = flags[:width]
            # torchcheck: disable=tracer-cast: reads the host copy of the
            # flags
            fail = (dead, bool(flags[width:].any()))
        else:
            # torchcheck: disable=item-call: the loop's done check: one read
            # an event
            done_h = done.cpu()
        # torchcheck: disable=tracer-cast: host copy of the flags
        if bool(done_h.all()):
            break
        s_next, cache, nc = _step(consts, meta, pol, ph, aux, s, cache, nc,
                                  fail)
        # torchcheck: disable=tracer-cast: host copy of the flags
        if bool(done_h.any()):
            # frozen lanes keep their final state (a leaf the step
            # passed through is the same tensor)
            s = SimState(*(b if a is b else torch.where(
                done.reshape(-1, *([1] * (b.dim() - 1))), a, b)
                for a, b in zip(s, s_next)))
            done = done | _finished(consts, meta, s)
        else:
            s = s_next
            done = _finished(consts, meta, s)
        n += 1
    return s, cache, nc, done


def make_packed_simulator(meta: SimMeta):
    """Returns ``run(consts, pol, s0=None) -> SimState``.

    ``pol`` holds one int32 value per lane for every registered policy
    field (``[W]``, on the consts' device; ``lane_policies`` builds it).
    The result's leaves are ``[W, ...]``."""

    def run(consts: EngineConsts, pol: Dict[str, torch.Tensor],
            s0: SimState | None = None) -> SimState:
        width = pol["seed"].shape[0]
        # torchcheck: disable=item-call: the policies on the host, once a run
        ph = {k: v.cpu().numpy() for k, v in pol.items()}
        s = s0 if s0 is not None else init_state_from_consts(
            consts, meta.n_switches, meta.ctrl_slots, meta.spec_slots, width)
        aux = _make_aux(consts, meta, pol, ph)
        return _advance(consts, meta, pol, ph, aux,
                        _carry(consts, meta, s))[0]

    return run


# --- fleet chunk stepper (DESIGN.md §9) ------------------------------------


def tree_select(done, old, new):
    """Per-lane select over a carry (tensors, dicts and tuples of them):
    where ``done [W]`` holds, ``old``'s leaf, else ``new``'s.  The fleet
    resets refilled lanes with it (``tree_select(refill, carry0, carry)``)."""
    if isinstance(new, torch.Tensor):
        return torch.where(done.reshape(-1, *([1] * (new.dim() - 1))),
                           old, new)
    if isinstance(new, dict):
        return {k: tree_select(done, old[k], new[k]) for k in new}
    leaves = (tree_select(done, a, b) for a, b in zip(old, new))
    return type(new)(*leaves) if hasattr(new, "_fields") else tuple(leaves)


def init_fleet_carry(consts: EngineConsts, meta, width: int):
    """The t=0 carry of a ``width``-lane cohort: ``(SimState, endpoint
    cache, channel counts, done)``, every leaf with a leading lane axis.
    Lanes start identical; their policies differ."""
    return _carry(consts, meta, init_state_from_consts(
        consts, meta.n_switches, meta.ctrl_slots, meta.spec_slots, width))


def make_fleet_chunk(meta, static_pol=None, chunk_steps: int = 32,
                     lane_fields=()):
    """The fleet's K-step cohort stepper (DESIGN.md §9): ``chunk(consts,
    pol, carry) -> carry`` advances every live lane of ``carry``
    (``init_fleet_carry``'s layout) by up to ``chunk_steps`` events and
    returns early once every lane is done.

    ``pol`` holds the lane-varying policy fields as host ``[W]`` int arrays;
    ``static_pol`` the branch-selecting fields (routing, traffic,
    placement) as ints shared by the cohort, so ``_step``'s host dispatch
    issues one branch.  ``lane_fields`` names the consts leaves that carry
    a leading ``[W]`` axis (the streaming ring's, ``core.streaming``), the
    counterpart of the reference's ``consts_axes``.  The lanes' seed
    hashes, tolerances and the control plane's switches are rebuilt from
    the consts and policies of each call, so a lane refilled with a new
    policy or new jobs between calls reads its own."""
    static_pol = dict(static_pol or {})
    lane_fields = tuple(lane_fields)

    def chunk(consts: EngineConsts, pol, carry):
        width = carry[3].shape[0]
        for f in lane_fields:
            if getattr(consts, f).shape[0] != width:
                raise ValueError(f"consts.{f} has no [{width}] lane axis")
        ph = {k: np.asarray(v, np.int32) for k, v in pol.items()}
        ph.update({k: np.full(width, v, np.int32)
                   for k, v in static_pol.items()})
        names = list(ph)
        rows = torch.from_numpy(np.stack([ph[k] for k in names])).to(
            consts.link_bw.device)
        pol_dev = dict(zip(names, rows))
        aux = _make_aux(consts, meta, pol_dev, ph)
        return _advance(consts, meta, pol_dev, ph, aux, carry, chunk_steps)

    return chunk


def make_simulator(setup: SimSetup, device=None):
    """Returns ``run(pol) -> SimState`` over the setup's consts on
    ``device`` (``None`` = CUDA)."""
    consts, meta = make_consts(setup, device)
    return partial(make_packed_simulator(meta), consts)


def simulate(setup: SimSetup, policy=None, device=None) -> SimState:
    """One replica through the cached runner: the unbatched final state
    (policy: a ``PolicyConfig``, a mapping of scalars, or ``None`` for the
    defaults; ``device=None`` = CUDA).  ``repro_torch.api.Experiment`` is
    the front door; this is the reference's spelling."""
    from ..api import runners  # local import: api sits above core
    consts, meta = make_consts(setup, device)
    return runners.get_runner(meta, "single")(consts,
                                              as_policy_arrays(policy))


def simulate_batch(setup: SimSetup, pols, device=None) -> SimState:
    """A policy sweep as lanes of one loop: every value of ``pols`` has a
    leading replica dim (missing registered fields broadcast their
    default); leaves come out ``[P, ...]``."""
    from ..api import runners
    consts, meta = make_consts(setup, device)
    return runners.get_runner(meta, "policy_batch")(
        consts, lane_policies(as_policy_arrays(pols)))


def simulate_scenarios(consts: EngineConsts, meta,
                       pols: Dict[str, torch.Tensor]) -> SimState:
    """Zipped batch over packed consts: every consts leaf and every policy
    value shares one leading replica dim R, and replica i runs consts[i]
    under pols[i] (on the consts' device).  Build consts with
    ``scenarios.sweep.pack_setups``; for the scenario × policy cross
    product use ``repro_torch.api.Experiment``."""
    from ..api import runners
    return runners.get_runner(meta, "zipped")(consts, pols)
