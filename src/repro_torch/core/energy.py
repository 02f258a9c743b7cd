"""Energy model (paper Fig. 13).

Port of ``src/repro/core/energy.py``: the same piecewise-constant power
model on torch tensors.

Hosts: linear-utilization model P = P_idle + u * (P_peak - P_idle) while any
task runs on the host, 0 W otherwise ("idle-mode ... is activated" — §5.3).
Switches: P = P_static + n_active_ports * P_port while any channel crosses the
switch, 0 W otherwise.  Power is piecewise constant between events, so energy
is an exact power*dt accumulation inside the event loop.

The paper does not publish its constants; defaults follow the CloudSimSDN
lineage (HP ProLiant-class hosts, commodity ToR switches).  The validated
quantity is the *relative* SDN-vs-legacy saving.

Both power laws are a float32 multiply-add, rounded once as the
reference's compiled code does (``fp.fma32``).
"""
from __future__ import annotations

import dataclasses

import torch

from .fp import fma32


@dataclasses.dataclass(frozen=True)
class EnergyParams:
    host_idle_w: float = 150.0
    host_peak_w: float = 250.0
    switch_static_w: float = 100.0
    switch_port_w: float = 10.0


def host_power(util: torch.Tensor, p: EnergyParams) -> torch.Tensor:
    """util in [0,1] per host; 0 W when fully idle."""
    busy = util > 0
    pw = fma32(util, p.host_peak_w - p.host_idle_w, p.host_idle_w)
    return torch.where(busy, pw, 0.0)


def switch_power(active_ports: torch.Tensor, p: EnergyParams) -> torch.Tensor:
    """active_ports: int per switch (directed links with >=1 channel)."""
    busy = active_ports > 0
    pw = fma32(active_ports.to(torch.float32), p.switch_port_w,
               p.switch_static_w)
    return torch.where(busy, pw, 0.0)
