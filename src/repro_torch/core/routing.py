"""SDN routing: offline candidate routes, online per-packet route choice.

Port of ``src/repro/core/routing.py``.  The paper's SDN controller runs
Dijkstra per packet: shortest hop count first, then (SDN mode) maximum
bottleneck bandwidth among the equal-hop routes; legacy mode picks one
equal-hop route statically at random per src/dst flow.  As in the
reference (DESIGN.md §2):

  1. *Offline* (setup): hop distances by tropical (min-plus) matrix
     squaring, then enumeration of up to K equal-hop candidate routes per
     node pair from the shortest-path DAG (host-side DFS).  On a CUDA
     device the squaring runs in the hand-written min-plus kernel
     (``kernels/tropical_apsp``) — the on-device use the reference's
     docstring names for its Pallas kernel; on the CPU it is the
     reference's numpy loop.  Both give the same distances exactly.
  2. *Online* (inside the event loop): route choice is a gather +
     masked-min + argmax over the K candidates against the live per-link
     channel counts.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..device import resolve
from ..kernels.tropical_apsp import apsp
from .topology import Topology

# ---------------------------------------------------------------------------
# offline: hop distances + candidate enumeration
# ---------------------------------------------------------------------------


def min_plus_square_np(d: np.ndarray) -> np.ndarray:
    """One tropical-semiring squaring step: d'[i,j] = min_k d[i,k] + d[k,j]."""
    return np.min(d[:, :, None] + d[None, :, :], axis=1)


def hop_distances_np(hop: np.ndarray) -> np.ndarray:
    """All-pairs hop distances by repeated min-plus squaring (O(log diam))."""
    d = hop.astype(np.float64)
    n = d.shape[0]
    steps = max(1, int(np.ceil(np.log2(max(2, n)))))
    for _ in range(steps):
        nd = min_plus_square_np(d)
        if np.array_equal(nd, d):
            break
        d = nd
    return d


def hop_distances(hop: np.ndarray, device=None) -> np.ndarray:
    """All-pairs hop distances as float64 numpy: the numpy loop on the CPU,
    one launch of the min-plus kernel (``apsp``) on CUDA.  Hop counts are
    small integers, exact in float32, so both paths agree bit for bit, and
    both stop squaring once the distances settle."""
    dev = resolve(device)
    if dev.type == "cpu":
        return hop_distances_np(hop)
    dist = apsp(torch.as_tensor(hop, dtype=torch.float32, device=dev))
    return dist.cpu().numpy().astype(np.float64)


@dataclasses.dataclass(frozen=True)
class RouteTable:
    """Padded candidate-route tensors for all node pairs.

    routes[p, k, h]  : link index of hop h of candidate k for pair p (-1 pad)
    n_cand[p]        : number of valid candidates for pair p (0 if unreachable
                       or src == dst)
    route_len[p, k]  : hops of candidate k
    max_hops, k_max  : static pad sizes
    truncated        : True if some pair had more equal-hop routes than k_max
    """

    routes: np.ndarray  # int32 [n_pairs, k_max, max_hops]
    n_cand: np.ndarray  # int32 [n_pairs]
    route_len: np.ndarray  # int32 [n_pairs, k_max]
    max_hops: int
    k_max: int
    n_nodes: int
    truncated: bool

    def pair(self, src: int, dst: int) -> int:
        return src * self.n_nodes + dst


def build_route_table(topo: Topology, k_max: int = 8,
                      max_hops: int | None = None,
                      device=None) -> RouteTable:
    """Enumerate ALL equal-hop shortest routes (up to k_max) per node pair.

    An edge (u, v) lies on a shortest src->dst path iff
        dist(src, u) + 1 + dist(v, dst) == dist(src, dst)
    so the shortest-path DAG is read straight off the distance matrix and
    enumerated by DFS on the host.  ``device`` (``None`` = CUDA) runs the
    distance step.
    """
    n = topo.n_nodes
    dist = hop_distances(topo.hop_matrix(), device)
    # adjacency list of directed links
    out_links: list[list[tuple[int, int]]] = [[] for _ in range(n)]
    for idx, (s, d) in enumerate(zip(topo.link_src, topo.link_dst)):
        out_links[int(s)].append((int(d), idx))

    finite = dist[np.isfinite(dist)]
    diam = int(finite.max()) if finite.size else 0
    mh = max_hops if max_hops is not None else max(1, diam)

    routes = np.full((n * n, k_max, mh), -1, dtype=np.int32)
    n_cand = np.zeros((n * n,), dtype=np.int32)
    route_len = np.zeros((n * n, k_max), dtype=np.int32)
    truncated = False

    for src in range(n):
        for dst in range(n):
            if src == dst or not np.isfinite(dist[src, dst]):
                continue
            target = dist[src, dst]
            found: list[list[int]] = []
            stack: list[tuple[int, list[int]]] = [(src, [])]
            while stack and len(found) < k_max + 1:
                node, path = stack.pop()
                if node == dst:
                    found.append(path)
                    continue
                for (nxt, lidx) in out_links[node]:
                    if dist[src, node] + 1 + dist[nxt, dst] == target:
                        stack.append((nxt, path + [lidx]))
            if len(found) > k_max:
                truncated = True
                found = found[:k_max]
            p = src * n + dst
            n_cand[p] = len(found)
            for k, f in enumerate(found):
                route_len[p, k] = len(f)
                routes[p, k, : len(f)] = f
    return RouteTable(routes=routes, n_cand=n_cand, route_len=route_len,
                      max_hops=mh, k_max=k_max, n_nodes=n, truncated=truncated)


# ---------------------------------------------------------------------------
# online: per-packet route choice (inside the event loop)
# ---------------------------------------------------------------------------

ROUTE_LEGACY = 0  # static equal-hop pick per (src,dst) flow  (paper §5.2)
ROUTE_SDN = 1     # per-packet max-bottleneck-bandwidth pick  (paper §5.2)


def candidate_bottleneck_bw(routes_k: torch.Tensor, n_cand: torch.Tensor,
                            link_bw: torch.Tensor,
                            ch_count: torch.Tensor) -> torch.Tensor:
    """Available bottleneck bandwidth of each candidate if one more channel
    joins.

    routes_k : int [..., k_max, max_hops] link ids (-1 pad), one pair per
               leading index
    n_cand   : int [...]
    link_bw  : f32 [n_links] or [..., n_links] (effective capacity: the
               engine zeroes dead links, so a candidate crossing an outage
               scores 0 and loses the argmax to any live route)
    ch_count : int [..., n_links] live channel counts
    returns  : f32 [..., k_max]  (-inf for invalid candidates)
    """
    lead = routes_k.shape[:-2]
    k_max, hops = routes_k.shape[-2:]
    valid_hop = routes_k >= 0
    safe = routes_k.clamp(min=0).long()
    flat = safe.reshape(*lead, k_max * hops)
    ch = torch.gather(ch_count, -1, flat)
    bw = link_bw[safe] if link_bw.dim() == 1 else torch.gather(
        link_bw, -1, flat).reshape(safe.shape)
    hop_bw = bw / (ch.reshape(safe.shape).to(link_bw.dtype) + 1.0)
    hop_bw = torch.where(valid_hop, hop_bw, torch.inf)
    bot = hop_bw.amin(-1)
    k_ids = torch.arange(k_max, device=routes_k.device)
    return torch.where(k_ids < n_cand[..., None], bot, -torch.inf)


def sdn_route_choice(routes_k: torch.Tensor, n_cand: torch.Tensor,
                     link_bw: torch.Tensor,
                     ch_count: torch.Tensor) -> torch.Tensor:
    """SDN pick: argmax of current bottleneck availability (Dijkstra
    objective #2), first index on ties.  Depends on the live channel
    counts, so the engine evaluates it inside the ready-set scan."""
    bw = candidate_bottleneck_bw(routes_k, n_cand, link_bw, ch_count)
    return bw.argmax(-1).to(torch.int32)


def legacy_route_choice(n_cand: torch.Tensor,
                        flow_hash: torch.Tensor) -> torch.Tensor:
    """Legacy pick: deterministic hash of the flow id over the equal-hop
    set — fixed for the whole flow regardless of load."""
    return torch.where(n_cand > 0, flow_hash % n_cand.clamp(min=1),
                       0).to(torch.int32)


_M32 = 0xFFFFFFFF


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2**32 for int64 ``x`` in [0, 2**32) and a 32-bit
    constant, without overflowing int64: split ``x`` into 16-bit halves."""
    lo = (x & 0xFFFF) * c
    hi = ((x >> 16) * c) & 0xFFFF
    return (lo + (hi << 16)) & _M32


def flow_hash_u32(a: torch.Tensor, b: torch.Tensor,
                  seed: torch.Tensor) -> torch.Tensor:
    """Counter-based integer hash (the legacy 'random' route pick and the
    random placement), equal to the reference's uint32 arithmetic: every
    product and shift-xor is taken mod 2**32 in int64."""
    a, b, seed = (torch.as_tensor(v).to(torch.int64) & _M32
                  for v in (a, b, seed))
    x = _mul32(a, 0x9E3779B1) ^ _mul32(b, 0x85EBCA77) \
        ^ _mul32(seed, 0xC2B2AE3D)
    x = _mul32(x ^ (x >> 15), 0x2C1B3C6D)
    x = _mul32(x ^ (x >> 12), 0x297A2D39)
    x = x ^ (x >> 15)
    return (x & 0x7FFFFFFF).to(torch.int32)
