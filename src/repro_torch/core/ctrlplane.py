"""SDN control-plane model: flow-rule install latency, controller service
capacity, flow-table caching and migrate-on-congestion (DESIGN.md §10).

Port of ``src/repro/core/ctrlplane.py`` (numpy copy); the port's engine
runs every config, the identity (``no_ctrl``) as the plain program.

The paper's controller is an instant oracle — routing decisions are free,
flow rules appear with zero latency, capacity is infinite — which
systematically flatters SDN in the legacy-vs-SDN comparisons (Figs.
11-13).  Real controller evaluations (the OMNeT++/INET SDN study,
arXiv:1609.04554) show rule-install latency and flow-table churn dominate
SDN behavior under load.  ``CtrlPlaneConfig`` makes both first-class
simulated resources, using the exact structural pattern of
``FailureSchedule`` (DESIGN.md §7): plain host-side scalars that lower to
breakpoint instants joining the engine's analytic ``dt`` min — no event
heap, and the identity config traces the EXACT pre-control-plane program
(``SimMeta.has_ctrl`` mirrors ``has_failures``).

Only ``routing=sdn`` packets talk to the controller; the legacy
static-hash path needs no flow-mod round trip.  That asymmetry is the
point: under high install latency or tiny flow tables, legacy routing can
BEAT SDN on makespan (``benchmarks/ctrl_sweep.py``).
"""
from __future__ import annotations

import dataclasses

import numpy as np

INF = float(np.inf)


@dataclasses.dataclass(frozen=True)
class CtrlPlaneConfig:
    """Control-plane resource parameters (DESIGN.md §10).

    The all-default instance is the IDENTITY config — zero install
    latency, infinite controller rate, no flow-table bound, migration
    disabled — and is treated exactly like an absent config
    (``any_ctrl`` False, ``SimMeta.has_ctrl`` False).
    """

    # flow-rule installation (reactive path): every missing rule on an
    # activating SDN packet's route costs one controller service slot plus
    # this propagation latency before the packet may transmit
    install_latency: float = 0.0   # s per flow-mod batch
    ctrl_rate: float = INF         # rule installs per second (inf = free)
    # per-switch flow-table capacity (LRU-evicted); 0 = no caching when a
    # finite latency/rate is set — every activation re-installs its rules
    table_slots: int = 0
    # migrate-on-congestion dynamic placement (S-CORE direction): a VM
    # whose aggregate route-hop cost over active packets exceeds the
    # threshold re-homes to the cost-minimizing live host
    mig_threshold: float = INF     # inf = migration can never trigger
    mig_cost: float = 0.0          # s of compute pause per migration
    mig_cooldown: float = 0.0      # s after a migration before the next
    mig_limit: int = 8             # total migrations per run (step bound)
    # controller failover (DESIGN.md §13): the PRIMARY controller is down
    # on [ctrl_fail_t, ctrl_recover_t).  SDN rule requests arriving inside
    # the first ``failover_delay`` seconds of the outage PARK until the
    # backup finishes taking over (leader election + state sync); after
    # that the backup serves with its own rate/latency until the primary
    # recovers.  ``inf`` fail_t = failover can never happen (the default
    # config is unchanged).  Legacy routing never consults the controller,
    # so it rides through the outage untouched — the Kreutz et al.
    # availability asymmetry in one knob.
    ctrl_fail_t: float = INF       # s: primary outage start (inf = never)
    ctrl_recover_t: float = INF    # s: primary back (inf = down for good)
    failover_delay: float = 0.0    # s: leader-election gap, requests park
    backup_rate: float = INF       # backup rule installs per second
    backup_latency: float = 0.0    # backup flow-mod latency (s)

    @property
    def any_ctrl(self) -> bool:
        """True iff this config changes anything: some control-plane
        resource is finite.  False (the identity) keeps
        ``SimMeta.has_ctrl`` off, so the engine traces the exact
        pre-control-plane program — same contract as
        ``FailureSchedule.any_failures``."""
        return bool(self.install_latency > 0.0
                    or np.isfinite(self.ctrl_rate)
                    or self.table_slots > 0
                    or np.isfinite(self.mig_threshold)
                    or np.isfinite(self.ctrl_fail_t))

    def validate(self) -> "CtrlPlaneConfig":
        checks = (
            (self.install_latency >= 0.0, "install_latency must be >= 0"),
            (self.ctrl_rate > 0.0, "ctrl_rate must be > 0 (inf = free)"),
            (self.table_slots >= 0, "table_slots must be >= 0"),
            (self.mig_threshold > 0.0, "mig_threshold must be > 0"),
            (self.mig_cost >= 0.0, "mig_cost must be >= 0"),
            (self.mig_cooldown >= 0.0, "mig_cooldown must be >= 0"),
            (self.mig_limit >= 0, "mig_limit must be >= 0"),
            (self.ctrl_fail_t >= 0.0, "ctrl_fail_t must be >= 0"),
            (not np.isfinite(self.ctrl_fail_t)
             or self.ctrl_recover_t > self.ctrl_fail_t,
             "ctrl_recover_t must be > ctrl_fail_t (zero/negative-length "
             "controller outage window)"),
            (np.isfinite(self.ctrl_fail_t)
             or not np.isfinite(self.ctrl_recover_t),
             "finite ctrl_recover_t without a finite ctrl_fail_t"),
            (self.failover_delay >= 0.0, "failover_delay must be >= 0"),
            (self.backup_rate > 0.0, "backup_rate must be > 0"),
            (self.backup_latency >= 0.0, "backup_latency must be >= 0"),
        )
        for ok, msg in checks:
            if not ok:
                raise ValueError(msg)
        return self


def no_ctrl() -> CtrlPlaneConfig:
    """The identity config: an instant, infinite-capacity controller."""
    return CtrlPlaneConfig()
