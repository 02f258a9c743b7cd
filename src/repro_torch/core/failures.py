"""Failure & recovery schedules (DESIGN.md §7).

The paper's YARN model detects host loss through the NodeManager→
ResourceManager heartbeat (§3.1.2) and re-executes the lost tasks; related
SDN work (Tiloca et al., Kreutz et al.) makes link-failure handling the
discriminating test of a controller.  Both are modeled here WITHOUT an
event heap: a failure schedule is four piecewise-constant breakpoint
tensors — ``host_fail_t``/``host_recover_t`` per host and
``link_fail_t``/``link_recover_t`` per directed link — that join the
engine's analytic ``dt`` horizon min exactly like packet finishes and job
releases do.  ``inf`` means "never": the all-``inf`` schedule is the
no-failure engine, bit-identical to a run without any schedule.

A device is DEAD on ``[fail_t, recover_t)`` (one outage per device per
run; chain runs for multi-outage studies).  Dead hosts draw 0 W and lose
their WAITING/ACTIVE tasks to re-placement; dead links carry 0 bandwidth
and kick their in-flight packets back to WAITING for re-routing.

Port of ``src/repro/core/failures.py`` (a numpy copy).  The engine runs
live outage schedules; a live ``DegradationSchedule`` is refused until
ROADMAP queue 1 item 7, which also brings ``host_slowdown`` and
``link_brownout``.  Seeded trace generators live in
``repro_torch.scenarios.failures``.
"""
from __future__ import annotations

import dataclasses

import numpy as np

INF = np.float32(np.inf)


@dataclasses.dataclass(frozen=True)
class FailureSchedule:
    """Deterministic outage windows for every host and directed link.

    All four arrays are float32; ``inf`` = the event never happens.  A
    finite ``recover_t`` with an ``inf`` ``fail_t`` is meaningless and
    rejected by ``validate``.
    """

    host_fail_t: np.ndarray     # f32 [n_hosts]
    host_recover_t: np.ndarray  # f32 [n_hosts]
    link_fail_t: np.ndarray     # f32 [n_links]
    link_recover_t: np.ndarray  # f32 [n_links]

    @property
    def any_failures(self) -> bool:
        return bool(np.isfinite(self.host_fail_t).any()
                    or np.isfinite(self.link_fail_t).any())

    @property
    def n_events(self) -> int:
        """Count of finite fail/recover instants (drives the engine's
        ``max_steps`` safety cap)."""
        return int(sum(np.isfinite(a).sum() for a in (
            self.host_fail_t, self.host_recover_t,
            self.link_fail_t, self.link_recover_t)))

    def instants(self) -> np.ndarray:
        """All fail/recover instants as ONE f32 tensor (``inf`` = never),
        shape ``[2*n_hosts + 2*n_links]`` — fixed by the topology, not by
        the outage count, so schedules differing only in how many outages
        they carry keep identical tensor shapes (and therefore share jit
        caches).  The engine mins over this single tensor per step instead
        of over the four device tensors separately (DESIGN.md §8)."""
        return np.concatenate([self.host_fail_t, self.host_recover_t,
                               self.link_fail_t, self.link_recover_t]
                              ).astype(np.float32)

    def validate(self, n_hosts: int, n_links: int) -> "FailureSchedule":
        assert self.host_fail_t.shape == (n_hosts,), \
            f"host_fail_t shape {self.host_fail_t.shape} != ({n_hosts},)"
        assert self.host_recover_t.shape == (n_hosts,)
        assert self.link_fail_t.shape == (n_links,), \
            f"link_fail_t shape {self.link_fail_t.shape} != ({n_links},)"
        assert self.link_recover_t.shape == (n_links,)
        for kind, fail, rec in (
                ("host", self.host_fail_t, self.host_recover_t),
                ("link", self.link_fail_t, self.link_recover_t)):
            # a finite window must have positive length: ``rec == fail``
            # would be a zero-length outage whose fail AND recover land on
            # the same dt breakpoint (the transition delta never fires),
            # and ``rec < fail`` is a recovery before the failure — both
            # silently passed the old ``rec >= fail`` check for the
            # degenerate equal case and are rejected loudly now
            bad = np.isfinite(fail) & (rec <= fail)
            if np.any(bad):
                ids = np.flatnonzero(bad)
                raise ValueError(
                    f"{kind} outage window(s) {ids.tolist()} have "
                    f"recover_t <= fail_t (zero/negative length): "
                    f"fail_t={fail[ids].tolist()} "
                    f"recover_t={rec[ids].tolist()}")
            assert not np.any(np.isfinite(rec) & ~np.isfinite(fail)), \
                "finite recover_t without a finite fail_t"
        return self


def no_failures(n_hosts: int, n_links: int) -> FailureSchedule:
    """The identity schedule: nothing ever fails (all-``inf``)."""
    return FailureSchedule(
        host_fail_t=np.full(n_hosts, INF, np.float32),
        host_recover_t=np.full(n_hosts, INF, np.float32),
        link_fail_t=np.full(n_links, INF, np.float32),
        link_recover_t=np.full(n_links, INF, np.float32),
    )


def host_crash(n_hosts: int, n_links: int, host: int, at: float,
               recover_at: float = np.inf) -> FailureSchedule:
    """One host dies at ``at`` (permanently unless ``recover_at``)."""
    s = no_failures(n_hosts, n_links)
    s.host_fail_t[host] = at
    s.host_recover_t[host] = recover_at
    return s.validate(n_hosts, n_links)


def link_cut(n_hosts: int, n_links: int, links, at: float,
             recover_at: float = np.inf) -> FailureSchedule:
    """Cut the given directed link ids at ``at`` (a full-duplex cable is
    two directed links — pass both ids to sever the cable)."""
    s = no_failures(n_hosts, n_links)
    for li in np.atleast_1d(links):
        s.link_fail_t[li] = at
        s.link_recover_t[li] = recover_at
    return s.validate(n_hosts, n_links)


@dataclasses.dataclass(frozen=True)
class DegradationSchedule:
    """Gray-failure windows (DESIGN.md §13): piecewise-constant rate
    MULTIPLIERS instead of binary outages.

    A host executes at ``host_factor`` x MIPS on ``[host_slow_t,
    host_restore_t)`` (the straggler model: a slow disk or an
    oversubscribed NodeManager throttles every task on the host), a
    directed link carries ``link_factor`` x bandwidth on its window (an
    oversubscribed NIC / flapping optic).  Outside the window — and
    whenever ``slow_t`` is ``inf`` or ``factor`` is exactly 1.0 — the
    device runs at full rate.  The window instants join the engine's
    analytic ``dt`` min exactly like the ``FailureSchedule`` breakpoints
    (same §7 pattern), so degraded rates stay piecewise constant between
    events and no event heap is needed.

    Unlike an outage, degradation never reverts work: tasks and packets
    keep their placement and routes and simply progress slower — that is
    what makes it GRAY.  Factors > 1 (a burst-boost window) are allowed.
    """

    host_slow_t: np.ndarray     # f32 [n_hosts]: window start (inf = never)
    host_restore_t: np.ndarray  # f32 [n_hosts]: window end
    host_factor: np.ndarray     # f32 [n_hosts]: MIPS multiplier in-window
    link_slow_t: np.ndarray     # f32 [n_links]
    link_restore_t: np.ndarray  # f32 [n_links]
    link_factor: np.ndarray     # f32 [n_links]: bandwidth multiplier

    @property
    def _live_host(self) -> np.ndarray:
        return np.isfinite(self.host_slow_t) & (self.host_factor != 1.0)

    @property
    def _live_link(self) -> np.ndarray:
        return np.isfinite(self.link_slow_t) & (self.link_factor != 1.0)

    @property
    def any_degradation(self) -> bool:
        """True iff some window can change a rate.  An all-``factor=1.0``
        (or all-``inf``) schedule is the identity: ``SimMeta``'s
        ``has_degradation`` stays False and the engine traces EXACTLY the
        pre-degradation program — same contract as ``any_failures``."""
        return bool(self._live_host.any() or self._live_link.any())

    def instants(self) -> np.ndarray:
        """All LIVE slow/restore instants as ONE f32 tensor (``inf`` =
        never), shape ``[2*n_hosts + 2*n_links]`` — fixed by the topology
        like ``FailureSchedule.instants``.  Inert windows (``factor ==
        1.0``) are masked to ``inf`` so a mixed packed sweep never pays
        extra event steps for an identity lane."""
        lh, ll = self._live_host, self._live_link
        return np.concatenate([
            np.where(lh, self.host_slow_t, INF),
            np.where(lh, self.host_restore_t, INF),
            np.where(ll, self.link_slow_t, INF),
            np.where(ll, self.link_restore_t, INF),
        ]).astype(np.float32)

    def validate(self, n_hosts: int, n_links: int) -> "DegradationSchedule":
        assert self.host_slow_t.shape == (n_hosts,), \
            f"host_slow_t shape {self.host_slow_t.shape} != ({n_hosts},)"
        assert self.host_restore_t.shape == (n_hosts,)
        assert self.host_factor.shape == (n_hosts,)
        assert self.link_slow_t.shape == (n_links,), \
            f"link_slow_t shape {self.link_slow_t.shape} != ({n_links},)"
        assert self.link_restore_t.shape == (n_links,)
        assert self.link_factor.shape == (n_links,)
        for kind, slow, restore, factor in (
                ("host", self.host_slow_t, self.host_restore_t,
                 self.host_factor),
                ("link", self.link_slow_t, self.link_restore_t,
                 self.link_factor)):
            bad = np.isfinite(slow) & (restore <= slow)
            if np.any(bad):
                ids = np.flatnonzero(bad)
                raise ValueError(
                    f"{kind} degradation window(s) {ids.tolist()} have "
                    f"restore_t <= slow_t (zero/negative length)")
            if np.any(~(factor > 0.0) | ~np.isfinite(factor)):
                raise ValueError(
                    f"{kind}_factor must be finite and > 0 (a zero rate "
                    f"is an outage — use FailureSchedule)")
            assert not np.any(np.isfinite(restore) & ~np.isfinite(slow)), \
                "finite restore_t without a finite slow_t"
        return self


def no_degradation(n_hosts: int, n_links: int) -> DegradationSchedule:
    """The identity schedule: every device at factor 1.0 forever."""
    return DegradationSchedule(
        host_slow_t=np.full(n_hosts, INF, np.float32),
        host_restore_t=np.full(n_hosts, INF, np.float32),
        host_factor=np.ones(n_hosts, np.float32),
        link_slow_t=np.full(n_links, INF, np.float32),
        link_restore_t=np.full(n_links, INF, np.float32),
        link_factor=np.ones(n_links, np.float32),
    )
