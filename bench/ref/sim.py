"""The simulator's semantics, one policy lane at a time, and its report.

The model (paper §3-§5).  A MapReduce job of ``nm`` mappers and ``nr``
reducers runs five phases: T1, the SAN sends each mapper its input
(``input / nm``, Eq. 1); P1, each mapper computes; T2, each mapper sends
each reducer its share of the shuffle (``shuffle / (nm nr)``, Eq. 2);
P2, each reducer computes once all its shuffle has arrived; T3, each
reducer writes its output back to the SAN, and the job is done when all
of it has landed.  Every transfer is sent as ``split`` packets.  Tasks
are numbered job by job, mappers then reducers; packets job by job, T1
(mapper by mapper), T2 (mapper-major, reducer-minor), T3.

Between events every rate is constant, so the clock jumps to the earliest
packet finish, task finish or job release.  One event, in this order:

1. admission: released jobs, ordered by the job-selection key (FCFS: the
   release instant; SJF: the job's total MI; ties by job number), while
   fewer than ``job_concurrency`` admitted jobs are unfinished;
2. placement of each admitted job's tasks, admission order first, then
   task number: least-used takes the VM with the fewest placed unfinished
   tasks (lowest number on ties), round-robin the next VM of a running
   counter, random the VM of a hash of the task (below); each placement
   counts on its VM until the task finishes;
3. a placed task whose inputs have all arrived starts; a packet of an
   admitted job whose source task has finished (T1: at once) starts,
   taking a candidate route of its endpoints' pair: legacy routing the
   candidate of a hash of its flow, SDN routing, packet by packet in
   packet order, the candidate whose narrowest link (its bandwidth over
   one more than the packets crossing it) is widest, lowest number on
   ties;
4. rates: a packet's by the traffic policy, Eq. 3 (each link's bandwidth
   over the packets crossing it, the narrowest along the route) or
   max-min water-filling; a packet between two VMs of one host moves at
   the host's memory bus; a task's is its VM's MIPS over the VM's running
   tasks, at most one core's;
5. power over the interval (paper Fig. 13): a host running anything
   draws ``idle + u (peak - idle)`` at utilisation ``u`` (its tasks' MIPS
   over its own), a switch with a busy link draws ``static + ports x
   port`` (each busy link counts at both ends);
6. the clock advances; a packet or task within its tolerance of done is
   done (packets: ``bits x 1e-6 + 1`` bits, tasks ``MI x 1e-6 + 1e-6``),
   and what finished feeds the tasks and jobs waiting on it.

A lane ends when every job is done, when no event is left (stalled), or at
``4 (packets + tasks) + 4 jobs + 64`` events.

Precision is the configuration's, float32: every float is a float32 and
every ``a x b + c`` update (remaining work, energy, power, tolerances) is
rounded once, as a fused multiply-add does.  The hash is a 32-bit integer
mix (multiply-xorshift) of two numbers and the lane's seed.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np

from .fabric import FABRICS, Fabric, Routes, candidate_routes

F32 = np.float32
WAITING, ACTIVE, DONE = 0, 1, 2
MAP, REDUCE = 0, 1
T1, T2, T3 = 0, 1, 2

CHOICES = {
    "routing": {"legacy": 0, "sdn": 1},
    "traffic": {"fairshare": 0, "waterfill": 1},
    "placement": {"least-used": 0, "round-robin": 1, "random": 2},
    "job_selection": {"fcfs": 0, "sjf": 1},
}


def bfloat16(x):
    """``x`` rounded to bfloat16 (nearest, ties to even) and back to
    float32: the control's inputs."""
    a = np.asarray(x, F32)
    u = a.view(np.uint32).astype(np.uint64)
    u = ((u + 0x7FFF + ((u >> 16) & 1)) >> 16) << 16
    out = u.astype(np.uint32).view(F32)
    return out if a.ndim else float(out)


def fma(a, b, c) -> np.ndarray:
    """float32 ``a * b + c`` rounded once."""
    return (np.asarray(a, np.float64) * np.asarray(b, np.float64)
            + np.asarray(c, np.float64)).astype(F32)


def mix32(a, b, seed) -> np.ndarray:
    """The 32-bit hash of ``(a, b, seed)``, masked to 31 bits."""
    m = np.uint64(0xFFFFFFFF)
    a, b, s = (np.asarray(v, np.int64).astype(np.uint64) & m
               for v in (a, b, seed))
    x = ((a * np.uint64(0x9E3779B1)) & m) ^ ((b * np.uint64(0x85EBCA77)) & m) \
        ^ ((s * np.uint64(0xC2B2AE3D)) & m)
    x = ((x ^ (x >> np.uint64(15))) * np.uint64(0x2C1B3C6D)) & m
    x = ((x ^ (x >> np.uint64(12))) * np.uint64(0x297A2D39)) & m
    x = x ^ (x >> np.uint64(15))
    return (x & np.uint64(0x7FFFFFFF)).astype(np.int64)


@dataclasses.dataclass
class World:
    """What every lane of one experiment shares: the fabric, its routes,
    the cluster, and the jobs lowered to tasks and packets."""

    fabric: Fabric
    routes: Routes
    vm_host: np.ndarray          # [V]
    vm_mips: np.ndarray          # f32 [V], all cores
    vm_core_mips: np.ndarray     # f32 [V]
    host_mips: np.ndarray        # f32 [H]
    intra_bw: np.float32
    energy: Dict[str, float]
    release: np.ndarray          # f32 [J]
    total_mi: np.ndarray         # f32 [J]
    n_out: np.ndarray            # [J] T3 packets of each job
    task_job: np.ndarray         # [T]
    task_kind: np.ndarray
    task_mi: np.ndarray          # f32
    task_need: np.ndarray        # packets a task waits for
    pkt_job: np.ndarray          # [P]
    pkt_phase: np.ndarray
    pkt_bits: np.ndarray         # f32
    pkt_src: np.ndarray          # task, or -1: the SAN
    pkt_dst: np.ndarray
    pkt_gate: np.ndarray         # the task that has to finish first, or -1
    pkt_feeds: np.ndarray        # the task it feeds, or -1: job output

    @property
    def max_steps(self) -> int:
        return 4 * (len(self.pkt_job) + len(self.task_job)) \
            + 4 * len(self.release) + 64


def build_fabric(config: dict, lower: bool = False):
    """The configuration's fabric and candidate routes (bandwidths in
    bfloat16 with ``lower``)."""
    fab = FABRICS[config["topology"]["kind"]]()
    if lower:
        fab = dataclasses.replace(fab, link_bw=bfloat16(fab.link_bw))
    return fab, candidate_routes(fab, config["routing"]["k_max"])


def build_world(config: dict, jobs: List[dict], fabric=None,
                lower: bool = False) -> World:
    """The configuration with ``jobs`` (plain dicts, in submission
    order); with ``lower`` every float input is stored in bfloat16."""
    rnd = bfloat16 if lower else (lambda x: x)
    fab, routes = fabric or build_fabric(config, lower)
    cl = config["cluster"]
    n_vms = fab.n_hosts * cl["vms_per_host"]
    split = config["routing"]["split"]
    tj, tk, tmi, tneed = [], [], [], []
    pj, pph, pbits, psrc, pdst, pgate, pfeeds = ([] for _ in range(7))

    def pkts(j, phase, bits, src, dst, gate, feeds):
        for _ in range(split):
            pj.append(j); pph.append(phase); pbits.append(bits)  # noqa: E702
            psrc.append(src); pdst.append(dst)                    # noqa: E702
            pgate.append(gate); pfeeds.append(feeds)              # noqa: E702

    jobs = [{k: (rnd(float(v)) if isinstance(v, float) else v)
             for k, v in job.items()} for job in jobs]
    for j, job in enumerate(jobs):
        nm, nr = job["n_map"], job["n_reduce"]
        maps = list(range(len(tj), len(tj) + nm))
        reds = list(range(len(tj) + nm, len(tj) + nm + nr))
        for t in maps + reds:
            kind = MAP if t in maps else REDUCE
            tj.append(j); tk.append(kind)                         # noqa: E702
            tmi.append(job["map_mi"] if kind == MAP else job["reduce_mi"])
            tneed.append(split if kind == MAP else nm * split)
        for m in maps:
            pkts(j, T1, job["input_gbits"] * 1e9 / (nm * split), -1, m, -1, m)
        for m in maps:
            for r in reds:
                pkts(j, T2, job["shuffle_gbits"] * 1e9 / (nm * nr * split),
                     m, r, m, r)
        for r in reds:
            pkts(j, T3, job["output_gbits"] * 1e9 / (nr * split), r, -1, r,
                 -1)
    i32 = lambda v: np.asarray(v, np.int64)   # noqa: E731
    return World(
        fabric=fab, routes=routes,
        vm_host=np.arange(n_vms) % fab.n_hosts,
        vm_mips=np.full(n_vms, rnd(cl["vm_cores"] * cl["vm_core_mips"]), F32),
        vm_core_mips=np.full(n_vms, rnd(cl["vm_core_mips"]), F32),
        host_mips=np.full(fab.n_hosts, rnd(cl["host_mips"]), F32),
        intra_bw=F32(config["intra_host_bps"]), energy=config["energy"],
        release=np.asarray([j["submit_time"] for j in jobs], F32),
        total_mi=np.asarray([j["n_map"] * j["map_mi"]
                             + j["n_reduce"] * j["reduce_mi"] for j in jobs],
                            F32),
        n_out=i32([j["n_reduce"] * split for j in jobs]),
        task_job=i32(tj), task_kind=i32(tk), task_mi=np.asarray(tmi, F32),
        task_need=i32(tneed), pkt_job=i32(pj), pkt_phase=i32(pph),
        pkt_bits=np.asarray(pbits, F32), pkt_src=i32(psrc),
        pkt_dst=i32(pdst), pkt_gate=i32(pgate), pkt_feeds=i32(pfeeds))


def policy(lane: dict) -> Dict[str, int]:
    """A lane's fields as numbers (choice names resolved)."""
    return {k: (CHOICES[k][v] if isinstance(v, str) else int(v))
            for k, v in lane.items()}


def _links(w: World, pair, cand) -> np.ndarray:
    """``[n, max_hops]`` link numbers of each packet's route, -1 pads."""
    return w.routes.routes[pair, cand]


def _crossing(links: np.ndarray, n_links: int) -> np.ndarray:
    """Packets crossing each link."""
    return np.bincount(links[links >= 0], minlength=n_links)


def eq3_rates(w: World, links: np.ndarray) -> np.ndarray:
    """Paper Eq. 3 for the active packets' routes ``links``."""
    bw = w.fabric.link_bw
    share = bw / np.maximum(_crossing(links, len(bw)), 1).astype(F32)
    per_hop = np.where(links >= 0, share[np.maximum(links, 0)], F32(np.inf))
    bot = per_hop.min(1, initial=F32(np.inf))
    return np.where(np.isinf(bot), w.intra_bw, bot).astype(F32)


def waterfill_rates(w: World, links: np.ndarray) -> np.ndarray:
    """Max-min fair rates by progressive filling, ``min(links, 32)``
    rounds: each round raises every unfrozen packet to the lowest fill
    level (a link's capacity left by the frozen packets over its unfrozen
    ones, the least along the route) and freezes those within 1e-6 of it;
    any left unfrozen take their own fill level at the end."""
    bw = w.fabric.link_bw
    n_links = len(bw)
    n = links.shape[0]
    valid = links >= 0
    safe = np.maximum(links, 0)
    inf = F32(np.inf)

    def level(alloc, frozen, live):
        used = np.zeros(n_links, F32)
        contrib = np.where(valid & frozen[:, None], alloc[:, None], F32(0))
        np.add.at(used, safe.ravel(), contrib.ravel())
        resid = np.maximum(bw - used, F32(0))
        n_live = np.bincount(safe[valid & live[:, None]], minlength=n_links)
        share = np.where(n_live > 0,
                         resid / np.maximum(n_live, 1).astype(F32), inf)
        return np.where(valid, share[safe], inf).min(1, initial=inf)

    alloc = np.zeros(n, F32)
    frozen = np.zeros(n, bool)
    for _ in range(min(n_links, 32)):
        live = ~frozen
        lv = level(alloc, frozen, live)
        glob = lv[live].min(initial=inf)
        glob = F32(0) if np.isinf(glob) else glob
        hit = live & (lv <= F32(glob * F32(1 + 1e-6)))
        alloc = np.where(hit, glob, alloc).astype(F32)
        frozen |= hit
    live = ~frozen
    alloc = np.where(live, level(alloc, frozen, live), alloc).astype(F32)
    return np.where(~valid.any(1), w.intra_bw, alloc).astype(F32)


def run_lane(w: World, pol: Dict[str, int]) -> Dict[str, np.ndarray]:
    """One lane of ``w`` under ``pol`` from t = 0 to its end: its final
    state (see the module note)."""
    with np.errstate(divide="ignore", invalid="ignore"):
        return _lane(w, pol)


def _lane(w: World, pol: Dict[str, int]) -> Dict[str, np.ndarray]:
    fab, rt = w.fabric, w.routes
    n_nodes = fab.n_nodes
    n_j, n_t, n_p = len(w.release), len(w.task_job), len(w.pkt_job)
    n_vms = len(w.vm_host)
    e = w.energy
    seed = pol["seed"]
    task_hash = mix32(np.arange(n_t), w.task_job, seed)
    pkt_hash = mix32(w.pkt_src + 1, w.pkt_dst + 1, seed)
    pkt_tol = fma(w.pkt_bits, F32(1e-6), F32(1.0))
    task_tol = fma(w.task_mi, F32(1e-6), F32(1e-6))
    nan = F32(np.nan)

    t = F32(0.0)
    steps, stalled, counter = 0, False, 0
    admitted = np.zeros(n_j, bool)
    admit_t = np.full(n_j, nan, F32)
    out_done = np.zeros(n_j, np.int64)
    done_t = np.full(n_j, nan, F32)
    t_state = np.full(n_t, WAITING)
    t_rem = w.task_mi.copy()
    t_got = np.zeros(n_t, np.int64)
    t_vm = np.full(n_t, -1)
    t_start = np.full(n_t, nan, F32)
    t_finish = np.full(n_t, nan, F32)
    p_state = np.full(n_p, WAITING)
    p_rem = w.pkt_bits.copy()
    p_pair = np.full(n_p, -1)
    p_cand = np.full(n_p, -1)
    p_start = np.full(n_p, nan, F32)
    p_finish = np.full(n_p, nan, F32)
    vm_load = np.zeros(n_vms, np.int64)
    host_e = np.zeros(fab.n_hosts, F32)
    host_busy = np.zeros(fab.n_hosts, F32)
    sw_e = np.zeros(fab.n_switches, F32)

    def node(task):
        vm = np.maximum(t_vm[np.maximum(task, 0)], 0)
        return np.where(task < 0, fab.storage, w.vm_host[vm])

    while not ((out_done >= w.n_out).all() or stalled
               or steps >= w.max_steps):
        # 1-2: admission and placement
        running = int((admitted & (out_done < w.n_out)).sum())
        free = max(pol["job_concurrency"] - running, 0)
        rel = np.flatnonzero(~admitted & (w.release <= t))
        key = w.total_mi if pol["job_selection"] == 1 else w.release
        for j in rel[np.argsort(key[rel], kind="stable")][:free]:
            for ti in np.flatnonzero(w.task_job == j):
                if pol["placement"] == 1:
                    vm = counter % n_vms
                elif pol["placement"] == 2:
                    vm = int(task_hash[ti]) % n_vms
                else:
                    vm = int(np.argmin(vm_load))
                t_vm[ti] = vm
                vm_load[vm] += 1
                counter += 1
            admitted[j] = True
            admit_t[j] = t
        # 3: starts
        go = (t_state == WAITING) & (t_got >= w.task_need) & (t_vm >= 0)
        t_state[go] = ACTIVE
        t_start[go] = t
        pair = node(w.pkt_src) * n_nodes + node(w.pkt_dst)
        gate_ok = (w.pkt_gate < 0) | (t_state[np.maximum(w.pkt_gate, 0)]
                                      == DONE)
        reach = (rt.n_cand[pair] > 0) | (node(w.pkt_src) == node(w.pkt_dst))
        ready = np.flatnonzero((p_state == WAITING) & admitted[w.pkt_job]
                               & gate_ok & reach)
        if len(ready):
            nk = rt.n_cand[pair]
            if pol["routing"] == 0:
                cand = np.where(nk > 0, pkt_hash % np.maximum(nk, 1), 0)
                p_cand[ready] = cand[ready]
            else:
                act = p_state == ACTIVE
                nc = _crossing(_links(w, p_pair[act], p_cand[act]),
                               len(fab.link_bw))
                for p in ready:
                    r = rt.routes[pair[p]]                      # [K, H]
                    hop = np.where(r >= 0, fab.link_bw[np.maximum(r, 0)]
                                   / (nc[np.maximum(r, 0)].astype(F32)
                                      + F32(1)), F32(np.inf))
                    bot = np.where(np.arange(rt.k_max) < nk[p],
                                   hop.min(1), -np.inf)
                    k = int(np.argmax(bot))
                    p_cand[p] = k
                    ln = r[k]
                    nc[ln[ln >= 0]] += 1
            p_state[ready] = ACTIVE
            p_pair[ready] = pair[ready]
            p_start[ready] = t
        # 4: rates
        pa = np.flatnonzero(p_state == ACTIVE)
        links = _links(w, p_pair[pa], p_cand[pa])
        p_rate = (waterfill_rates(w, links) if pol["traffic"] == 1
                  else eq3_rates(w, links)) if len(pa) else np.zeros(0, F32)
        ta = np.flatnonzero(t_state == ACTIVE)
        on_vm = np.bincount(t_vm[ta], minlength=n_vms)
        vm = t_vm[ta]
        t_rate = np.minimum(w.vm_core_mips[vm], w.vm_mips[vm] / np.maximum(
            on_vm[vm], 1).astype(F32)).astype(F32)
        # the next event
        inf = F32(np.inf)
        dt = min((p_rem[pa] / p_rate)[p_rate > 0].min(initial=inf),
                 (t_rem[ta] / t_rate)[t_rate > 0].min(initial=inf),
                 (w.release - t)[~admitted & (w.release > t)].min(
                     initial=inf))
        stalled = bool(np.isinf(dt))
        dt = F32(0.0) if stalled else F32(dt)
        # 5: energy over [t, t + dt)
        mips = np.zeros(fab.n_hosts, F32)
        np.add.at(mips, w.vm_host[vm], t_rate)
        util = np.clip(mips / np.maximum(w.host_mips, F32(1e-9)), F32(0),
                       F32(1))
        power = np.where(util > 0, fma(util, e["host_peak_w"]
                                       - e["host_idle_w"], e["host_idle_w"]),
                         F32(0))
        host_e = fma(power, dt, host_e)
        host_busy = np.where(util > 0, host_busy + dt, host_busy).astype(F32)
        busy = _crossing(links, len(fab.link_bw)) > 0
        ports = np.bincount(fab.link_src[busy], minlength=n_nodes) \
            + np.bincount(fab.link_dst[busy], minlength=n_nodes)
        sw = ports[fab.n_hosts:fab.n_hosts + fab.n_switches]
        sw_power = np.where(sw > 0, fma(sw.astype(F32), e["switch_port_w"],
                                        e["switch_static_w"]), F32(0))
        sw_e = fma(sw_power, dt, sw_e)
        # 6: advance and complete
        t = F32(t + dt)
        p_rem[pa] = fma(-p_rate, dt, p_rem[pa])
        t_rem[ta] = fma(-t_rate, dt, t_rem[ta])
        pd = pa[p_rem[pa] <= pkt_tol[pa]]
        td = ta[t_rem[ta] <= task_tol[ta]]
        feeds = w.pkt_feeds[pd]
        np.add.at(t_got, feeds[feeds >= 0], 1)
        before = out_done.copy()
        np.add.at(out_done, w.pkt_job[pd[feeds < 0]], 1)
        done_t[(out_done >= w.n_out) & (before < w.n_out)] = t
        np.add.at(vm_load, t_vm[td], -1)
        t_state[td] = DONE
        t_finish[td] = t
        p_state[pd] = DONE
        p_finish[pd] = t
        steps += 1

    return dict(
        time=t, steps=steps, stalled=stalled, place_counter=counter,
        job_admitted=admitted, job_admit_t=admit_t, job_out_done=out_done,
        job_done_t=done_t, task_state=t_state, task_rem=t_rem, task_got=t_got,
        task_vm=t_vm, task_start=t_start, task_finish=t_finish,
        pkt_state=p_state, pkt_rem=p_rem, pkt_pair=p_pair, pkt_cand=p_cand,
        pkt_start=p_start, pkt_finish=p_finish, vm_load=vm_load,
        host_energy=host_e, host_busy=host_busy, switch_energy=sw_e)


def _seg_max(values, seg, mask, n) -> np.ndarray:
    """The largest of ``values`` in each segment under ``mask``; NaN for
    an empty one."""
    out = np.full(n, -np.inf, F32)
    np.maximum.at(out, seg[mask], values[mask])
    return np.where(np.isinf(out), np.nan, out).astype(F32)


def report(w: World, s: Dict[str, np.ndarray]):
    """``(jobs, energy)``: the per-job report (paper Eqs. 6-9) and the
    energy report of one lane's final state."""
    n_j = len(w.release)
    pdur = (s["pkt_finish"] - s["pkt_start"]).astype(F32)
    pdone = s["pkt_state"] == DONE
    t1, t2, t3 = (_seg_max(pdur, w.pkt_job, pdone & (w.pkt_phase == ph), n_j)
                  for ph in (T1, T2, T3))
    tdur = (s["task_finish"] - s["task_start"]).astype(F32)
    tdone = s["task_state"] == DONE
    mp = _seg_max(tdur, w.task_job, tdone & (w.task_kind == MAP), n_j)
    rd = _seg_max(tdur, w.task_job, tdone & (w.task_kind == REDUCE), n_j)
    tr = (t1 + t2 + t3).astype(F32)                        # Eq. 6
    zero = np.zeros(n_j)
    jobs = {
        "transmission_time": tr, "t_storage_to_map": t1, "t_shuffle": t2,
        "t_reduce_to_storage": t3,
        "map_exec_time": mp, "reduce_exec_time": rd,       # Eqs. 7-8
        "completion_eq9": (tr + mp + rd).astype(F32),      # Eq. 9
        "completion_measured": s["job_done_t"] - w.release,
        "queue_delay": s["job_admit_t"] - w.release,
        "done_time": s["job_done_t"],
        # no failures, no control plane: nothing re-runs, reroutes, stops
        # or waits for a flow rule
        "task_reexecs": zero, "pkt_reroutes": zero, "downtime_s": zero,
        "install_wait_s": zero,
    }
    host = s["host_energy"].sum(dtype=F32)
    switch = s["switch_energy"].sum(dtype=F32)
    energy = {"host_energy_j": host, "switch_energy_j": switch,
              "total_energy_j": F32(host + switch), "makespan_s": s["time"]}
    return jobs, energy
