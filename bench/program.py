"""The system under test: the port, ``repro_torch``, set up from the
configuration and the generator's plain numbers as a user sets it up:
the fabric by its builder, the cluster, the route table (the APSP kernel
on CUDA, then the host DFS), the jobs as ``JobSpec`` rows and the lanes
as policy fields, into one ``Experiment``."""
from __future__ import annotations

import dataclasses
from typing import List

import torch


class Program:
    """The port on ``device``."""

    def __init__(self, device):
        from repro_torch import api
        from repro_torch.core import energy, mapreduce, policies, routing
        from repro_torch.core import topology
        from repro_torch.scenarios import registry
        self.device = torch.device(device)
        self.api, self.energy, self.mapreduce = api, energy, mapreduce
        self.policies_mod, self.routing = policies, routing
        self.topology_mod, self.registry = topology, registry

    def topology(self, config: dict):
        spec = dict(config["topology"])
        return getattr(self.topology_mod, spec.pop("kind"))(**spec)

    def cluster(self, config: dict, topo):
        cl = self.registry.make_cluster(
            topo, **config["cluster"],
            energy=self.energy.EnergyParams(**config["energy"]))
        return dataclasses.replace(cl, intra_bw=config["intra_host_bps"])

    def route_table(self, config: dict, topo):
        return self.routing.build_route_table(
            topo, k_max=config["routing"]["k_max"], device=self.device)

    def setup(self, config: dict, jobs: List[dict], cluster, route_table):
        specs = [self.mapreduce.JobSpec(**job) for job in jobs]
        return self.mapreduce.build_setup(
            specs, cluster, route_table=route_table,
            k_max=config["routing"]["k_max"],
            split=config["routing"]["split"], device=self.device)

    def policies(self, lanes: List[dict]) -> List[dict]:
        """Each lane as ``{field: int}``, choice names resolved by the
        port's policy registry."""
        fields = {f.name: f for f in self.policies_mod.policy_fields()}
        return [{k: (fields[k].choices[v] if isinstance(v, str) else int(v))
                 for k, v in lane.items()} for lane in lanes]

    def experiment(self, setup, lanes: List[dict]):
        return self.api.Experiment(setup, self.policies(lanes),
                                   device=self.device)
