"""Network topology as fixed-shape tensors.

Port of ``src/repro/core/topology.py``: a verbatim numpy copy (the port
imports nothing of ``repro``).

The paper models a cloud data center as hosts + switches + a SAN connected by
bidirectional links (Fig. 9).  We represent a topology as:

  * ``n_nodes`` nodes (hosts first, then switches, then storage nodes),
  * ``n_links`` *directed* link slots (each undirected cable = 2 directed links),
  * ``link_src/link_dst``  int32[n_links] endpoints,
  * ``link_bw``            f32[n_links] capacity (bits/s),
  * ``adj_hop``            f32[n_nodes, n_nodes] 1/inf adjacency (tropical weights).

Directed links let us model full-duplex cables exactly as CloudSimSDN does
(a SAN->mapper flow and a reducer->SAN flow never share capacity).

Builders are host-side (numpy) — topology construction is setup, not sim.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np

INF = np.float32(np.inf)


@dataclasses.dataclass(frozen=True)
class Topology:
    """Immutable tensor description of a data-center network."""

    n_hosts: int
    n_switches: int
    n_storage: int
    link_src: np.ndarray  # int32[n_links]
    link_dst: np.ndarray  # int32[n_links]
    link_bw: np.ndarray  # f32[n_links] bits/sec
    names: Tuple[str, ...] = ()

    @property
    def n_nodes(self) -> int:
        return self.n_hosts + self.n_switches + self.n_storage

    @property
    def n_links(self) -> int:
        return int(self.link_src.shape[0])

    def host(self, i: int) -> int:
        return i

    def switch(self, i: int) -> int:
        return self.n_hosts + i

    def storage(self, i: int = 0) -> int:
        return self.n_hosts + self.n_switches + i

    # derived tensors ------------------------------------------------------
    def hop_matrix(self) -> np.ndarray:
        """Tropical-semiring adjacency: 1 hop per link, inf where unconnected."""
        n = self.n_nodes
        m = np.full((n, n), INF, dtype=np.float32)
        np.fill_diagonal(m, 0.0)
        m[self.link_src, self.link_dst] = 1.0
        return m

    def link_index(self) -> Dict[Tuple[int, int], int]:
        return {
            (int(s), int(d)): i
            for i, (s, d) in enumerate(zip(self.link_src, self.link_dst))
        }

    def cable_pairs(self) -> List[Tuple[int, int]]:
        """Directed-link id pairs forming one full-duplex cable.

        ``_build`` emits the two directions of every undirected edge
        adjacently, so pairs are ``(2i, 2i+1)`` when that layout holds
        (verified here); failure generators cut cables, not directions
        (DESIGN.md §7).  A hand-built topology without the layout gets
        reverse-lookup pairing instead."""
        pairs: List[Tuple[int, int]] = []
        n = self.n_links
        adjacent = (n % 2 == 0 and all(
            self.link_src[2 * i] == self.link_dst[2 * i + 1]
            and self.link_dst[2 * i] == self.link_src[2 * i + 1]
            for i in range(n // 2)))
        if adjacent:
            return [(2 * i, 2 * i + 1) for i in range(n // 2)]
        idx = self.link_index()
        seen = set()
        for i, (s, d) in enumerate(zip(self.link_src, self.link_dst)):
            if i in seen:
                continue
            j = idx.get((int(d), int(s)), i)
            seen.update((i, j))
            pairs.append((i, j))
        return pairs

    def links_touching(self, node: int) -> List[int]:
        """Directed link ids with ``node`` as an endpoint (both directions
        — what a NIC/port failure at that node takes down)."""
        return [i for i, (s, d) in enumerate(zip(self.link_src,
                                                 self.link_dst))
                if node in (int(s), int(d))]


def _build(edges: List[Tuple[int, int, float]], n_hosts: int, n_switches: int,
           n_storage: int, names: Tuple[str, ...] = ()) -> Topology:
    """Expand undirected (u, v, bw) edges into directed link tensors."""
    src, dst, bw = [], [], []
    for u, v, b in edges:
        src += [u, v]
        dst += [v, u]
        bw += [b, b]
    return Topology(
        n_hosts=n_hosts,
        n_switches=n_switches,
        n_storage=n_storage,
        link_src=np.asarray(src, np.int32),
        link_dst=np.asarray(dst, np.int32),
        link_bw=np.asarray(bw, np.float32),
        names=names,
    )


GBPS = 1e9  # bits per second


def paper_fat_tree(core_bw: float = 1 * GBPS,
                   agg_bw: float = 1 * GBPS,
                   edge_bw: float = 1 * GBPS,
                   san_bw: float = 4 * GBPS,
                   core_parallel: int = 2) -> Topology:
    """The paper's Fig. 9 three-tier topology.

    4 core switches (2 pairs), 8 aggregation, 8 edge, 16 hosts, 1 SAN.
    - SAN connects to core switch 0 ("core1") at 4 Gbps.
    - §5.1: "the first pair of core switches (L1) is connected to four odd
      switches of the child layer (L2) by TWO links, configured with a
      bandwidth of 1 Gbps each, and vice versa to the others" — every
      core<->agg attachment is ``core_parallel`` PARALLEL 1 Gbps cables.
      Parallel cables are distinct equal-hop routes ("same number of links
      but different bandwidths", §5.3) — this is exactly the diversity the
      paper's SDN controller exploits, including on SAN->mapper paths.
    - Core pair A serves agg {0,2,4,6}, pair B serves agg {1,3,5,7}.
    - Each aggregation switch feeds 2 edge switches, each edge feeds 2 hosts.
    """
    n_hosts, n_sw, n_storage = 16, 4 + 8 + 8, 1
    H = lambda i: i
    CORE = lambda i: 16 + i
    AGG = lambda i: 16 + 4 + i
    EDGE = lambda i: 16 + 4 + 8 + i
    SAN = 16 + 20

    edges: List[Tuple[int, int, float]] = []
    # SAN -> core1
    edges.append((SAN, CORE(0), san_bw))
    # core pairs to aggregation: pair {0,1} <-> even agg, pair {2,3} <-> odd agg
    for a in range(8):
        pair = (0, 1) if a % 2 == 0 else (2, 3)
        for c in pair:
            for _ in range(core_parallel):
                edges.append((CORE(c), AGG(a), core_bw))
    # aggregation a serves edges 2a, 2a+1?  8 agg, 8 edge: group agg in pairs
    # per pod: pod p has agg {2p, 2p+1} and edge {2p, 2p+1}, full bipartite.
    for p in range(4):
        for a in (2 * p, 2 * p + 1):
            for e in (2 * p, 2 * p + 1):
                edges.append((AGG(a), EDGE(e), agg_bw))
    # each edge switch -> 2 hosts
    for e in range(8):
        for h in (2 * e, 2 * e + 1):
            edges.append((EDGE(e), H(h), edge_bw))

    names = tuple(
        [f"host{i}" for i in range(16)]
        + [f"core{i}" for i in range(4)]
        + [f"agg{i}" for i in range(8)]
        + [f"edge{i}" for i in range(8)]
        + ["san0"]
    )
    return _build(edges, n_hosts, n_sw, n_storage, names)


def fat_tree(k: int, bw: float = GBPS, san_bw: float | None = None) -> Topology:
    """Generic k-ary fat-tree (k even): (k/2)^2 core, k pods of k/2+k/2 switches,
    (k^3)/4 hosts, plus one SAN on core switch 0."""
    assert k % 2 == 0
    half = k // 2
    n_hosts = k * half * half
    n_core = half * half
    n_agg = k * half
    n_edge = k * half
    n_sw = n_core + n_agg + n_edge
    H = lambda i: i
    CORE = lambda i: n_hosts + i
    AGG = lambda p, i: n_hosts + n_core + p * half + i
    EDGE = lambda p, i: n_hosts + n_core + n_agg + p * half + i
    SAN = n_hosts + n_sw

    edges: List[Tuple[int, int, float]] = []
    edges.append((SAN, CORE(0), san_bw if san_bw is not None else 4 * bw))
    for p in range(k):
        for a in range(half):
            # agg (p,a) connects to core group a*half .. a*half+half-1
            for c in range(half):
                edges.append((AGG(p, a), CORE(a * half + c), bw))
            for e in range(half):
                edges.append((AGG(p, a), EDGE(p, e), bw))
        for e in range(half):
            for h in range(half):
                edges.append((EDGE(p, e), H(p * half * half + e * half + h), bw))
    return _build(edges, n_hosts, n_sw, 1)


def leaf_spine(n_spine: int = 4, n_leaf: int = 4, hosts_per_leaf: int = 4,
               host_bw: float = GBPS, fabric_bw: float = GBPS,
               san_bw: float | None = None) -> Topology:
    """Two-tier leaf-spine (Clos) fabric.

    Every leaf connects to every spine (``fabric_bw``), every host hangs off
    one leaf (``host_bw``), and the SAN attaches to spine 0.  Any inter-leaf
    host pair therefore has exactly ``n_spine`` equal-hop routes — the route
    diversity the SDN controller load-balances over (DESIGN.md §5).
    """
    assert n_spine >= 1 and n_leaf >= 1 and hosts_per_leaf >= 1
    n_hosts = n_leaf * hosts_per_leaf
    n_sw = n_spine + n_leaf
    H = lambda i: i
    SPINE = lambda i: n_hosts + i
    LEAF = lambda i: n_hosts + n_spine + i
    SAN = n_hosts + n_sw

    edges: List[Tuple[int, int, float]] = []
    edges.append((SAN, SPINE(0), san_bw if san_bw is not None else 4 * fabric_bw))
    for l in range(n_leaf):
        for s in range(n_spine):
            edges.append((LEAF(l), SPINE(s), fabric_bw))
        for h in range(hosts_per_leaf):
            edges.append((LEAF(l), H(l * hosts_per_leaf + h), host_bw))

    names = tuple(
        [f"host{i}" for i in range(n_hosts)]
        + [f"spine{i}" for i in range(n_spine)]
        + [f"leaf{i}" for i in range(n_leaf)]
        + ["san0"]
    )
    return _build(edges, n_hosts, n_sw, 1, names)


def canonical_tree(depth: int = 2, fanout: int = 2, hosts_per_edge: int = 2,
                   bw: float = GBPS, root_bw_mult: float = 1.0,
                   san_bw: float | None = None) -> Topology:
    """Canonical (single-rooted) switch tree, the classic data-center baseline.

    ``depth`` switch levels: level 0 is one root, level d has ``fanout**d``
    switches; the ``fanout**(depth-1)`` bottom switches are edge switches with
    ``hosts_per_edge`` hosts each.  The SAN attaches to the root.  Every node
    pair has exactly ONE route (no path diversity) — the degenerate case
    against which fat-tree/leaf-spine SDN gains are measured.  Links touching
    the root carry ``bw * root_bw_mult`` to model thicker trunks.
    """
    assert depth >= 1 and fanout >= 1 and hosts_per_edge >= 1
    level_size = [fanout ** d for d in range(depth)]
    n_sw = sum(level_size)
    n_edge = level_size[-1]
    n_hosts = n_edge * hosts_per_edge
    level_base = [n_hosts + sum(level_size[:d]) for d in range(depth)]
    SW = lambda d, i: level_base[d] + i
    SAN = n_hosts + n_sw

    edges: List[Tuple[int, int, float]] = []
    edges.append((SAN, SW(0, 0), san_bw if san_bw is not None else 4 * bw))
    for d in range(1, depth):
        level_bw = bw * (root_bw_mult if d == 1 else 1.0)
        for i in range(level_size[d]):
            edges.append((SW(d - 1, i // fanout), SW(d, i), level_bw))
    edge_bw = bw * (root_bw_mult if depth == 1 else 1.0)
    for e in range(n_edge):
        for h in range(hosts_per_edge):
            edges.append((SW(depth - 1, e), e * hosts_per_edge + h, edge_bw))

    names = tuple(
        [f"host{i}" for i in range(n_hosts)]
        + [f"sw{d}_{i}" for d in range(depth) for i in range(level_size[d])]
        + ["san0"]
    )
    return _build(edges, n_hosts, n_sw, 1, names)


def torus_2d(nx: int, ny: int, bw: float = GBPS) -> Topology:
    """2-D torus of `hosts` (TPU-pod ICI abstraction for the roofline advisor).

    Every node is a host (chip); links are the ±x/±y ICI cables.
    """
    n = nx * ny
    idx = lambda x, y: (x % nx) * ny + (y % ny)
    edges: List[Tuple[int, int, float]] = []
    for x in range(nx):
        for y in range(ny):
            if nx > 1 and (nx > 2 or x == 0):  # avoid double edge when nx==2
                edges.append((idx(x, y), idx(x + 1, y), bw))
            if ny > 1 and (ny > 2 or y == 0):
                edges.append((idx(x, y), idx(x, y + 1), bw))
    return _build(edges, n, 0, 0)


def torus_3d(nx: int, ny: int, nz: int, bw: float = GBPS) -> Topology:
    n = nx * ny * nz
    idx = lambda x, y, z: ((x % nx) * ny + (y % ny)) * nz + (z % nz)
    edges: List[Tuple[int, int, float]] = []
    for x in range(nx):
        for y in range(ny):
            for z in range(nz):
                if nx > 1 and (nx > 2 or x == 0):
                    edges.append((idx(x, y, z), idx(x + 1, y, z), bw))
                if ny > 1 and (ny > 2 or y == 0):
                    edges.append((idx(x, y, z), idx(x, y + 1, z), bw))
                if nz > 1 and (nz > 2 or z == 0):
                    edges.append((idx(x, y, z), idx(x, y, z + 1), bw))
    return _build(edges, n, 0, 0)
