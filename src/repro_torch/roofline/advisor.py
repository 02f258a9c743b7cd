"""The "SDN controller for the pod": the paper's DES applied to collective
scheduling.  Port of ``src/repro/roofline/advisor.py``.

The pod's interconnect is a 2-D torus; candidate all-reduce schedules are
rendered as round-structured flow sets (``core.flows``) and ranked by
simulated completion time under the paper's fair-share channel model.
Analytic ring formulas stand in for meshes larger than ``des_max_chips``.
The DES runs on ``device`` (``None`` = CUDA): the route table's
hop-distance step and the event loop.
"""
from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

from ..core import PolicyConfig, simulate
from ..core.flows import Flow, flows_setup
from ..core.topology import Topology, torus_2d
from .hw import V5E, HwSpec

GBIT = 1e9


# ---------------------------------------------------------------------------
# schedule renderers: bytes -> rounds of neighbour flows on a torus
# ---------------------------------------------------------------------------


def ring_allreduce_flows(n: int, gbits: float, *, ring: Sequence[int],
                         bidirectional: bool = False) -> List[Flow]:
    """Ring all-reduce of ``gbits`` per chip over ``ring`` (node-id order):
    2(n-1) rounds of gbits/n neighbour transfers; ``bidirectional`` splits
    each transfer across both ring directions."""
    flows: List[Flow] = []
    chunk = gbits / n
    dirs = ((1, chunk / 2), (-1, chunk / 2)) if bidirectional \
        else ((1, chunk),)
    for r in range(2 * (n - 1)):
        for i in range(n):
            for d, c in dirs:
                flows.append(Flow(ring[i], ring[(i + d) % n], c, round=r))
    return flows


def torus_2d_allreduce_flows(nx: int, ny: int, gbits: float
                             ) -> List[Flow]:
    """Dimension-ordered all-reduce: every x ring all-reduces the full
    payload, then every y ring the x-reduced shard (gbits / nx)."""
    flows: List[Flow] = []
    idx = lambda x, y: x * ny + y
    for r in range(2 * (nx - 1)):
        for y in range(ny):
            for x in range(nx):
                flows.append(Flow(idx(x, y), idx((x + 1) % nx, y),
                                  gbits / nx, round=r))
    rbase = 2 * (nx - 1)
    for r in range(2 * (ny - 1)):
        for x in range(nx):
            for y in range(ny):
                flows.append(Flow(idx(x, y), idx(x, (y + 1) % ny),
                                  gbits / (nx * ny), round=rbase + r))
    return flows


# ---------------------------------------------------------------------------
# predictions
# ---------------------------------------------------------------------------


def analytic_time(schedule: str, n_chips: int, bytes_per_chip: float,
                  hw: HwSpec = V5E, mesh_shape: Tuple[int, int] = None
                  ) -> float:
    b = bytes_per_chip
    if schedule == "ring":
        return 2 * (n_chips - 1) / n_chips * b / hw.ici_link_bw
    if schedule == "ring-bidir":
        return (n_chips - 1) / n_chips * b / hw.ici_link_bw
    if schedule == "torus2d":
        nx, ny = mesh_shape
        tx = 2 * (nx - 1) / nx * b / hw.ici_link_bw
        ty = 2 * (ny - 1) / (nx * ny) * b / hw.ici_link_bw
        return tx + ty
    raise ValueError(schedule)


def simulate_schedule(flows: List[Flow], topo: Topology, *,
                      device=None) -> float:
    """DES completion time (seconds) of a rendered schedule; the topology
    carries the links' bandwidth."""
    setup = flows_setup(topo, flows, device=device)
    state = simulate(setup, PolicyConfig(), device=device)
    return float(state.time)


@dataclasses.dataclass
class Advice:
    schedule: str
    predicted_s: float
    source: str   # "des" | "analytic"


def advise_allreduce(bytes_per_chip: float, mesh_shape: Tuple[int, int],
                     hw: HwSpec = V5E, *, des_max_chips: int = 64,
                     device=None) -> List[Advice]:
    """Rank candidate all-reduce schedules for one pod, fastest first."""
    nx, ny = mesh_shape
    n = nx * ny
    gbits = bytes_per_chip * 8 / GBIT
    out: List[Advice] = []
    if n <= des_max_chips:
        topo = torus_2d(nx, ny, bw=hw.ici_link_bw * 8)
        ring = [x * ny + (y if x % 2 == 0 else ny - 1 - y)
                for x in range(nx) for y in range(ny)]  # boustrophedon
        for name, fl in [
            ("ring", ring_allreduce_flows(n, gbits, ring=ring)),
            ("ring-bidir", ring_allreduce_flows(n, gbits, ring=ring,
                                                bidirectional=True)),
            ("torus2d", torus_2d_allreduce_flows(nx, ny, gbits)),
        ]:
            out.append(Advice(name, simulate_schedule(
                fl, topo, device=device), "des"))
    else:
        for name in ("ring", "ring-bidir", "torus2d"):
            out.append(Advice(name, analytic_time(
                name, n, bytes_per_chip, hw, mesh_shape), "analytic"))
    return sorted(out, key=lambda a: a.predicted_s)
