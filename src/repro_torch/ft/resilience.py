"""Fault tolerance: failure injection, checkpoint and restart, straggler
detection: the host-side loop around the train step.  Port of
``src/repro/ft/resilience.py`` (``FailurePlan``, ``NodeFailure`` and the
numpy ``StragglerMonitor`` copied as they are).

``FailurePlan`` injects deterministic faults so that the recovery path can
be tested: a crash loses the in-memory state and the driver restarts from
the latest checkpoint.  The port's train step updates the model and the
optimizer state in place, so a restart copies the checkpoint into them
(``ckpt.restore``), and a caller that runs the driver twice from one
starting state passes it a copy each time.

A step of ``TrainDriver.run`` waits for the device once: its metrics come
to the host in one transfer.  A checkpoint's save copies every tensor to
the host besides.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..checkpoint import ckpt


@dataclasses.dataclass
class FailurePlan:
    """Deterministic fault injection: fail step -> kind."""
    at_steps: Dict[int, str] = dataclasses.field(default_factory=dict)
    # kinds: "crash" (lose state, restart from ckpt),
    #        "straggle:<seconds>" (one slow step on one host)

    def check(self, step: int) -> Optional[str]:
        return self.at_steps.get(step)


class NodeFailure(RuntimeError):
    pass


@dataclasses.dataclass
class StragglerMonitor:
    n_hosts: int
    factor: float = 2.0
    patience: int = 3
    ewma: float = 0.5
    _est: Optional[np.ndarray] = None
    _strikes: Optional[np.ndarray] = None

    def observe(self, durations: Sequence[float]) -> List[int]:
        d = np.asarray(durations, np.float64)
        if self._est is None:
            self._est = d.copy()
            self._strikes = np.zeros(self.n_hosts, np.int32)
        self._est = self.ewma * d + (1 - self.ewma) * self._est
        med = np.median(self._est)
        slow = self._est > self.factor * med
        self._strikes = np.where(slow, self._strikes + 1, 0)
        return [int(i) for i in np.nonzero(
            self._strikes >= self.patience)[0]]


def host_metrics(metrics: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """A step's metrics (tensors on one device) as Python floats, read to
    the host in one transfer."""
    vals = torch.stack([v.to(torch.float64).reshape(())
                        for v in metrics.values()]).tolist()
    return dict(zip(metrics, vals))


@dataclasses.dataclass
class TrainDriver:
    """Checkpointed, fault-tolerant training loop around a step fn.

    step_fn(params, opt_state, batch) -> (params, opt_state, metrics)
    batch_fn(step) -> batch   (pure; restart safe)
    """
    step_fn: Callable
    batch_fn: Callable[[int], Any]
    ckpt_dir: str
    ckpt_every: int = 50
    failure_plan: FailurePlan = dataclasses.field(default_factory=FailurePlan)
    keep_metrics: bool = True

    def run(self, params, opt_state, n_steps: int,
            start_step: int = 0) -> Tuple[Any, Any, Dict[str, Any]]:
        step = start_step
        history: List[Dict] = []
        restarts = 0
        # resume if a checkpoint exists
        latest = ckpt.latest_step(self.ckpt_dir)
        if latest is not None and latest > step:
            (params, opt_state), extra = ckpt.restore(
                self.ckpt_dir, (params, opt_state))
            step = int(extra.get("next_step", latest))
        while step < n_steps:
            fault = self.failure_plan.check(step)
            if fault == "crash":
                # lose in-memory state; restart from latest checkpoint
                self.failure_plan.at_steps.pop(step)
                restarts += 1
                latest = ckpt.latest_step(self.ckpt_dir)
                if latest is None:
                    raise NodeFailure(
                        f"crash at step {step} with no checkpoint")
                (params, opt_state), extra = ckpt.restore(
                    self.ckpt_dir, (params, opt_state))
                step = int(extra.get("next_step", latest))
                continue
            t0 = time.perf_counter()
            if fault and fault.startswith("straggle:"):
                time.sleep(float(fault.split(":")[1]))
                self.failure_plan.at_steps.pop(step)
            batch = self.batch_fn(step)
            params, opt_state, metrics = self.step_fn(params, opt_state,
                                                      batch)
            if self.keep_metrics:
                met = host_metrics(metrics)
                history.append({"step": step,
                                "dt": time.perf_counter() - t0, **met})
            step += 1
            if step % self.ckpt_every == 0 or step == n_steps:
                ckpt.save(self.ckpt_dir, step, (params, opt_state),
                          extra={"next_step": step})
        return params, opt_state, {"history": history,
                                   "restarts": restarts,
                                   "final_step": step}
