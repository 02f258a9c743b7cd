"""Fleet execution engine: chunked early-exit cohorts over the policy grid
(DESIGN.md §9).

Port of ``src/repro/api/fleet.py``.  The grid drains through fixed-width
cohorts of lanes advanced by K-event chunks (``engine.make_fleet_chunk``).
Between chunks the host retires finished lanes, keeps their final state,
and refills the lane from the pending queue, so no sim runs more than
``K - 1`` wasted events past its own finish.  A calibrated step-count
predictor (``StepPredictor``) orders the queue by expected trajectory
length, so a cohort wave holds similar-length sims and the chunk's early
exit fires.  Lanes are grouped by their STATIC policy signature (routing,
traffic, placement) first: the cohort's ``_step`` dispatch then issues one
branch of each.

``run_fleet(devices=n)`` spreads each cohort's lanes over n ranks of a
``torch.distributed`` group, as the reference spreads them with
``shard_map`` over a 1-D ``"fleet"`` mesh (``_LaneSplit``): each rank
advances its own block of lanes on its own device with the same chunk
program, with no collective inside a chunk (the early exit is
rank-local); after each chunk the done flags are all-gathered so that
every rank's ``CohortSchedule`` takes the same decisions, and at a
retire the retired lanes' rows, so that every rank returns the whole
grid.

Results are bit-identical to ``Experiment.run``: the chunk runs the SAME
loop body (``engine._advance``) and freezes each lane at the first state
where ``_finished`` holds, exactly the state the serial loop stops at
(tests/test_torch_fleet.py).
"""
from __future__ import annotations

import dataclasses
import math
from typing import (Any, Callable, Dict, Hashable, List, Optional, Sequence,
                    Tuple)

import numpy as np
import torch

from ..core.engine import (EngineConsts, SimState, init_fleet_carry,
                           make_fleet_chunk, tree_select)
from ..core.simmeta import SimMeta
from ..scenarios.sweep import slice_packed
from . import runners
from .results import Results

# the branch-selecting policy axes: uniform per cohort, so the engine's
# host dispatch issues one branch
STATIC_FIELDS = ("routing", "traffic", "placement")


class StepPredictor:
    """Cheap step-count predictor with online calibration (DESIGN.md §9).

    Admission order only needs RELATIVE lengths, so the model is minimal: a
    size prior ``alpha * (n_tasks + n_packets)`` refined by an EWMA over
    observed final step counts keyed at two granularities, the (scenario,
    static-sig) group and the individual grid member.  Within a fresh group
    every member shares the group estimate (ordering is a no-op); on
    repeated fleets member-level observations take over and
    length-divergent sims sort into the same cohort wave.
    """

    def __init__(self, alpha: float = 3.0, ewma: float = 0.4):
        self.alpha = alpha
        self.ewma = ewma
        self._obs: Dict[Hashable, float] = {}

    def predict(self, member_key: Hashable, group_key: Hashable,
                n_tasks: int, n_packets: int) -> float:
        prior = self.alpha * (n_tasks + n_packets)
        return self._obs.get(member_key,
                             self._obs.get(group_key, prior))

    def observe(self, key: Hashable, steps: float) -> None:
        cur = self._obs.get(key)
        self._obs[key] = (steps if cur is None
                          else (1 - self.ewma) * cur + self.ewma * steps)

    def clear(self) -> None:
        self._obs.clear()


# process-wide: calibration persists across fleets in one process
_PREDICTOR = StepPredictor()


class CohortSchedule:
    """Host-side retire/refill bookkeeping for one cohort of ``width``
    lanes draining ``members`` (already in admission order).

    Lanes hold a member id or ``None`` (a PAD lane: starts, and stays,
    done, so the chunk freezes it for free).  ``step(done)`` is called at
    every chunk boundary with the device's done flags; it retires finished
    lanes and refills them from the queue, returning what the driver must
    do on the device: extract the retired lanes' states BEFORE applying the
    refill mask (a refill overwrites the lane with the t=0 state).
    """

    def __init__(self, members: Sequence[Any], width: int):
        self.width = width
        self.queue: List[Any] = list(members)
        self.lane: List[Any] = [
            self.queue.pop(0) if self.queue else None for _ in range(width)]
        self.retired: List[Tuple[int, Any]] = []

    def pad_mask(self) -> np.ndarray:
        """[W] bool: lanes with no member (their done flag is forced at
        t=0)."""
        return np.array([m is None for m in self.lane])

    @property
    def active(self) -> bool:
        return any(m is not None for m in self.lane)

    def step(self, done: np.ndarray) -> Tuple[List[Tuple[int, Any]],
                                              np.ndarray]:
        """-> (retire, refill_mask) for one chunk boundary.

        ``retire`` lists ``(lane, member)`` pairs whose final state must be
        extracted now; ``refill_mask`` marks lanes reassigned to the next
        queued member (reset them to the t=0 carry).  A finished lane with
        an empty queue becomes a pad lane.
        """
        retire: List[Tuple[int, Any]] = []
        refill = np.zeros(self.width, bool)
        for i in range(self.width):
            if done[i] and self.lane[i] is not None:
                retire.append((i, self.lane[i]))
                if self.queue:
                    self.lane[i] = self.queue.pop(0)
                    refill[i] = True
                else:
                    self.lane[i] = None
        self.retired.extend(retire)
        return retire, refill


@dataclasses.dataclass
class FleetStats:
    """What the fleet actually did: surfaced for benchmarks and tests."""

    sims: int = 0        # grid cells drained
    cohorts: int = 0     # (scenario × static-sig) groups
    chunks: int = 0      # K-step chunk invocations
    refills: int = 0     # lanes recycled mid-cohort
    devices: int = 1     # ranks the lanes ran on (1 = no group)
    width: int = 0       # lanes per cohort (after the round-up to devices)


def _chunk_program(meta: SimMeta, sig: Tuple[int, ...], chunk_steps: int,
                   width: int) -> Callable:
    """The cached K-event chunk of one static signature."""
    def build():
        runners.note_build()
        return make_fleet_chunk(meta, dict(zip(STATIC_FIELDS, sig)),
                                chunk_steps)
    return runners.get_cached_program(
        ("fleet", meta, sig, chunk_steps, width), build)


def _refill_program(meta: SimMeta, width: int) -> Callable:
    """The cached refill: ``(mask, carry0, carry) -> carry`` with the
    refilled lanes reset to the t=0 carry."""
    return runners.get_cached_program(("fleet-refill", meta, width),
                                      lambda: tree_select)


def _init_program(meta: SimMeta, width: int) -> Callable:
    """The cached cohort initializer: ``consts -> t=0 carry``."""
    return runners.get_cached_program(
        ("fleet-init", meta, width),
        lambda: lambda c: init_fleet_carry(c, meta, width))


def _lane_policies(pol_np: Dict[str, np.ndarray], sched: CohortSchedule,
                   lanes: slice = slice(None)) -> Dict[str, np.ndarray]:
    """The lane-varying policy rows of the cohort's ``lanes`` (static
    fields excluded); a pad lane takes member 0's."""
    out = {}
    for k, col in pol_np.items():
        if k in STATIC_FIELDS:
            continue
        rows = [col[m] if m is not None else col[0]
                for m in sched.lane[lanes]]
        out[k] = np.stack(rows) if rows else col[:0]
    return out


def _group_by_signature(pol_np: Dict[str, np.ndarray], n: int
                        ) -> Dict[Tuple[int, ...], List[int]]:
    """The policy axis grouped by static signature, in first-seen order."""
    groups: Dict[Tuple[int, ...], List[int]] = {}
    for p in range(n):
        sig = tuple(int(pol_np[f][p]) for f in STATIC_FIELDS)
        groups.setdefault(sig, []).append(p)
    return groups


class _LaneSplit:
    """A cohort's ``width`` lanes over the ``n`` first ranks of the default
    group: rank r < n holds lanes ``[r * w, (r + 1) * w)``, ``w = width /
    n``; a rank past ``n`` holds none.  Every rank takes part in the
    gathers, so every rank sees every lane's done flag and retired row.

    The gathers move host data (the flags and rows the schedule reads on
    the host anyway) as CPU tensors over a 1-D ``"fleet"`` mesh of the
    whole group: the group needs a CPU backend (gloo, or
    ``"cpu:gloo,cuda:nccl"``), whatever device the lanes run on.  They are
    functional all-gathers (``roofline/collectives.py`` records them).
    Without a group (``mesh`` None) nothing is gathered."""

    def __init__(self, n: int, rank: int, width: int, mesh):
        self.n, self.mesh = n, mesh
        self.per = width // n
        lo = min(rank, n) * self.per
        self.lanes = slice(lo, lo + (self.per if rank < n else 0))

    def _gather(self, t: torch.Tensor) -> torch.Tensor:
        import torch.distributed._functional_collectives as funcol
        f = getattr(funcol, "all_gather_single", None) or \
            funcol.all_gather_tensor
        return f(t.contiguous(), 0, self.mesh).wait()

    def done(self, local: torch.Tensor) -> np.ndarray:
        """The [width] done flags from this rank's block."""
        # torchcheck: disable=item-call: the done flags at a chunk boundary
        local = local.cpu()
        if self.mesh is None:
            return local.numpy()
        block = torch.zeros(self.per, dtype=torch.uint8)
        block[:local.shape[0]] = local.to(torch.uint8)
        return self._gather(block)[:self.n * self.per].numpy().astype(bool)

    def rows(self, state: SimState, lanes: List[int]) -> List[torch.Tensor]:
        """Every leaf's rows at ``lanes`` (cohort lane numbers), in that
        order; across ranks, each rank's rows travel as the bytes of one
        padded [k, row bytes] block."""
        if self.mesh is None:
            idx = torch.tensor(lanes, device=state.time.device)
            return [h[idx] for h in state]
        owner = [l // self.per for l in lanes]
        k = max(owner.count(r) for r in range(self.n))
        mine = torch.tensor([l - self.lanes.start for l in lanes
                             if self.lanes.start <= l < self.lanes.stop],
                            dtype=torch.long)
        # torchcheck: disable=item-call: the retired rows, at a retire
        parts = [h[mine.to(h.device)].cpu()
                 .reshape(len(mine), math.prod(h.shape[1:]))
                 .view(torch.uint8) for h in state]
        width = sum(p.shape[1] for p in parts)
        block = torch.zeros((k, width), dtype=torch.uint8)
        block[:len(mine)] = torch.cat(parts, dim=1)
        got = self._gather(block)
        seen = {r: 0 for r in range(self.n)}
        pick = []
        for r in owner:
            pick.append(r * k + seen[r])
            seen[r] += 1
        got = got[torch.tensor(pick, dtype=torch.long)]
        out, at = [], 0
        for h in state:
            n = math.prod(h.shape[1:]) * h.element_size()
            out.append(got[:, at:at + n].clone().view(h.dtype)
                       .reshape((len(lanes),) + tuple(h.shape[1:]))
                       .to(h.device))
            at += n
        return out


def _fleet_devices(devices: Optional[int]) -> Tuple[int, int, int]:
    """(n, world, rank): ``devices`` capped at the default group's world
    size (``None``: the world size; 1 and rank 0 without a group)."""
    import torch.distributed as dist
    grouped = dist.is_available() and dist.is_initialized()
    world = dist.get_world_size() if grouped else 1
    rank = dist.get_rank() if grouped else 0
    n = world if devices is None else max(1, min(devices, world))
    return n, world, rank


def run_fleet(exp, width: int = 32, chunk_steps: int = 32,
              devices: Optional[int] = None, return_stats: bool = False,
              predictor: Optional[StepPredictor] = None):
    """Drain an ``Experiment``'s scenario × policy grid through the fleet
    engine (DESIGN.md §9) and assemble the same ``Results`` grid ``[S, P,
    ...]`` ``Experiment.run`` returns, bit for bit.

    ``width`` lanes per cohort, rounded up to a multiple of the ranks;
    ``chunk_steps`` events per chunk (K); ``devices`` ranks of the default
    process group to spread the lanes over (``None``: all of them; capped
    at the world size; 1 without a group).  With ``devices`` below the
    world size the first ``devices`` ranks hold the lanes and the others
    hold none but join every gather; every rank returns the whole
    ``Results``.  ``return_stats`` also returns a ``FleetStats``."""
    predictor = predictor or _PREDICTOR
    n_dev, world, rank = _fleet_devices(devices)
    mesh = None
    if world > 1:
        from ..sharding.mesh import make_mesh
        mesh = make_mesh((world,), ("fleet",), "cpu")
    S, P = len(exp.scenarios), len(exp.policies)
    consts, meta = exp.build()
    # torchcheck: disable=item-call: the policies on the host, once a fleet
    pol_np = {k: v.cpu().numpy() for k, v in exp.policy_arrays().items()}
    groups = _group_by_signature(pol_np, P)

    stats = FleetStats(sims=S * P, devices=n_dev)
    # the [S, P, ...] state grid, allocated at the first retire and
    # written in place, one row gather per leaf a boundary
    out: Optional[List[torch.Tensor]] = None

    for si in range(S):
        consts_s = consts if S == 1 else slice_packed(consts, si)
        # torchcheck: disable=item-call: cohort sizes, once a scenario
        n_tasks, n_pkts = (int(v) for v in torch.stack(
            [consts_s.task_valid.sum(), consts_s.pkt_valid.sum()]).tolist())
        sname = exp.scenario_names[si]

        for sig, members in groups.items():
            gkey = (sname, sig)
            order = sorted(members, key=lambda p: predictor.predict(
                (sname, sig, exp.policy_names[p]), gkey, n_tasks, n_pkts))
            W = min(width, len(order))
            W = n_dev * -(-W // n_dev)
            sched = CohortSchedule(order, W)
            split = _LaneSplit(n_dev, rank, W, mesh)
            stats.cohorts += 1
            stats.width = max(stats.width, W)
            Wl = split.lanes.stop - split.lanes.start

            chunk = _chunk_program(meta, sig, chunk_steps, Wl)
            carry0 = _init_program(meta, Wl)(consts_s)
            pad = torch.from_numpy(sched.pad_mask()[split.lanes]).to(
                carry0[3].device)
            carry = (*carry0[:3], carry0[3] | pad)

            # hard backstop: every member can run at most max_steps events
            max_chunks = ((len(order) + W)
                          * (meta.max_steps // chunk_steps + 2))
            chunks = 0
            pol_lane = _lane_policies(pol_np, sched, split.lanes)
            while sched.active:
                if Wl:
                    carry = chunk(consts_s, pol_lane, carry)
                chunks += 1
                stats.chunks += 1
                if chunks > max_chunks:
                    raise RuntimeError(
                        f"fleet cohort {gkey} exceeded {max_chunks} chunks "
                        "without draining — engine not making progress")
                retire, refill = sched.step(split.done(carry[3]))
                if retire:
                    rows = split.rows(carry[0], [l for l, _ in retire])
                    if out is None:
                        out = [torch.empty((S, P) + a.shape[1:],
                                           dtype=a.dtype, device=a.device)
                               for a in carry[0]]
                    mems = torch.tensor([m for _, m in retire],
                                        device=out[0].device)
                    for o, r in zip(out, rows):
                        o[si, mems] = r
                    # torchcheck: disable=item-call: retired lanes' steps at a
                    # chunk boundary
                    steps = rows[SimState._fields.index("steps")].tolist()
                    for (_, member), n in zip(retire, map(float, steps)):
                        predictor.observe(
                            (sname, sig, exp.policy_names[member]), n)
                        predictor.observe(gkey, n)
                if refill.any():
                    # torchcheck: disable=tracer-cast: numpy on the host
                    stats.refills += int(refill.sum())
                    mask = torch.from_numpy(refill[split.lanes]).to(
                        carry[3].device)
                    # refilled lanes go back to the t=0 carry, done flag
                    # included: a sim finished at t=0 stays frozen and
                    # retires with its t=0 state, as the serial run does
                    carry = _refill_program(meta, Wl)(mask, carry0, carry)
                    pol_lane = _lane_policies(pol_np, sched, split.lanes)

    states = SimState(*out)
    if S == 1:   # Results keeps a scenario axis on consts
        consts = EngineConsts(*(a[None] for a in consts))
    res = Results(states=states, consts=consts, meta=meta,
                  scenario_names=exp.scenario_names,
                  policy_names=exp.policy_names)
    return (res, stats) if return_stats else res
