"""The fabric and its candidate routes.

A fabric is ``n_hosts`` hosts (nodes ``0 ..``), then ``n_switches``
switches, then the storage node (the SAN), joined by full-duplex cables.
Each cable ``(a, b, bw)`` is two directed links, ``a -> b`` then
``b -> a``, numbered in the order the cables are listed; a link's number
is its identity in a route and decides ties between routes.

Candidate routes of a node pair are all of its shortest routes (fewest
links), ordered by their link numbers read as a sequence, largest first,
and cut to the first ``k_max``.  (That is the order in which a
depth-first search finds them when it leaves a node by its
highest-numbered link first.)
"""
from __future__ import annotations

import collections
import dataclasses
from typing import List, Tuple

import numpy as np

GBPS = 1e9


@dataclasses.dataclass(frozen=True)
class Fabric:
    n_hosts: int
    n_switches: int
    link_src: np.ndarray      # int32 [L]
    link_dst: np.ndarray      # int32 [L]
    link_bw: np.ndarray       # float32 [L], bits/s

    @property
    def n_nodes(self) -> int:
        return self.n_hosts + self.n_switches + 1

    @property
    def storage(self) -> int:
        return self.n_hosts + self.n_switches


def _cables(cables: List[Tuple[int, int, float]], n_hosts: int,
            n_switches: int) -> Fabric:
    src, dst, bw = [], [], []
    for a, b, w in cables:
        src += [a, b]
        dst += [b, a]
        bw += [w, w]
    return Fabric(n_hosts, n_switches, np.asarray(src, np.int32),
                  np.asarray(dst, np.int32), np.asarray(bw, np.float32))


def paper_fat_tree() -> Fabric:
    """Fig. 9 (paper §5.1): 16 hosts, 4 core, 8 aggregation and 8 edge
    switches and a SAN.  The SAN hangs off core switch 1 at 4 Gbps; core
    switches 1-2 reach the odd-numbered aggregation switches (0, 2, 4, 6
    here) and core switches 3-4 the others, each by two parallel 1 Gbps
    cables; each pod's two aggregation switches reach both its edge
    switches; each edge switch serves two hosts; every other cable is
    1 Gbps."""
    core = lambda i: 16 + i           # noqa: E731
    agg = lambda i: 20 + i            # noqa: E731
    edge = lambda i: 28 + i           # noqa: E731
    san = 36
    cables = [(san, core(0), 4 * GBPS)]
    for a in range(8):
        for c in ((0, 1) if a % 2 == 0 else (2, 3)):
            cables += [(core(c), agg(a), GBPS)] * 2
    for p in range(4):
        for a in (2 * p, 2 * p + 1):
            for e in (2 * p, 2 * p + 1):
                cables.append((agg(a), edge(e), GBPS))
    for e in range(8):
        for h in (2 * e, 2 * e + 1):
            cables.append((edge(e), h, GBPS))
    return _cables(cables, 16, 20)


FABRICS = {"paper_fat_tree": paper_fat_tree}


def hop_counts(f: Fabric) -> np.ndarray:
    """``[n, n]`` fewest links from each node to each node (``inf``: no
    route), by a breadth-first search from every node."""
    n = f.n_nodes
    out = collections.defaultdict(list)
    for s, d in zip(f.link_src.tolist(), f.link_dst.tolist()):
        out[s].append(d)
    dist = np.full((n, n), np.inf)
    for s in range(n):
        dist[s, s] = 0
        frontier = [s]
        while frontier:
            nxt = []
            for u in frontier:
                for v in out[u]:
                    if dist[s, v] == np.inf:
                        dist[s, v] = dist[s, u] + 1
                        nxt.append(v)
            frontier = nxt
    return dist


@dataclasses.dataclass(frozen=True)
class Routes:
    routes: np.ndarray        # int32 [n*n, k_max, max_hops], -1 pads
    n_cand: np.ndarray        # int32 [n*n]
    route_len: np.ndarray     # int32 [n*n, k_max]
    max_hops: int
    k_max: int
    n_nodes: int
    truncated: bool


def candidate_routes(f: Fabric, k_max: int) -> Routes:
    """Every pair's candidates (see the module note); a pair of one node,
    or with no route, has none.  ``max_hops`` is the fabric's diameter."""
    n = f.n_nodes
    dist = hop_counts(f)
    out = collections.defaultdict(list)
    for i, (s, d) in enumerate(zip(f.link_src.tolist(), f.link_dst.tolist())):
        out[s].append((i, d))
    finite = dist[np.isfinite(dist)]
    max_hops = max(1, int(finite.max()))
    routes = np.full((n * n, k_max, max_hops), -1, np.int32)
    n_cand = np.zeros(n * n, np.int32)
    route_len = np.zeros((n * n, k_max), np.int32)
    truncated = False

    def shortest(u, dst):
        """Every shortest route from ``u`` to ``dst`` as link tuples."""
        if u == dst:
            return [()]
        return [(i,) + rest for i, v in out[u]
                if dist[v, dst] == dist[u, dst] - 1
                for rest in shortest(v, dst)]

    for s in range(n):
        for d in range(n):
            if s == d or not np.isfinite(dist[s, d]):
                continue
            found = sorted(shortest(s, d), reverse=True)
            truncated |= len(found) > k_max
            found = found[:k_max]
            p = s * n + d
            n_cand[p] = len(found)
            for k, r in enumerate(found):
                route_len[p, k] = len(r)
                routes[p, k, :len(r)] = r
    return Routes(routes, n_cand, route_len, max_hops, k_max, n, truncated)
