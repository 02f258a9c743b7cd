"""The one generator of the benchmark's inputs, from a configuration and a
traffic file: the job mix and the policy lanes, as plain numbers that the
program (``program.Program``) and the reference (``ref.sim``) each lower
themselves.

The work is fixed by the files and the seed only orders it: every
experiment runs the configuration's job multiset in an order drawn from
``(seed, experiment index)``, so seeds differ in the order of the same
work, not in its amount.
"""
from __future__ import annotations

import itertools
from typing import Dict, List

import numpy as np


def experiment_rng(seed: int, k: int) -> np.random.Generator:
    """The generator of experiment ``k`` of a run with ``seed`` (any whole
    number, also past 32 bits)."""
    return np.random.default_rng([int(seed), int(k)])


def job_multiset(config: dict) -> List[dict]:
    """The configuration's jobs, before ordering (``submit_time`` 0)."""
    mix = config["jobs"]
    if mix["kind"] == "table":
        return [dict(row["job"], submit_time=0.0, priority=0.0)
                for row in mix["rows"] for _ in range(row["count"])]
    raise ValueError(f"unknown job mix {mix['kind']!r}")


def job_order(config: dict, seed: int, k: int) -> List[dict]:
    """Experiment ``k``'s jobs: the multiset in an order drawn from
    ``(seed, k)``, submitted ``interval_s`` apart."""
    jobs = job_multiset(config)
    perm = experiment_rng(seed, k).permutation(len(jobs))
    dt = config["jobs"]["interval_s"]
    return [dict(jobs[j], submit_time=i * dt) for i, j in enumerate(perm)]


def lanes(traffic: dict) -> List[Dict[str, object]]:
    """The policy lanes: the product of ``axes`` (in the file's order, the
    last varying fastest) for each policy seed, seed-major, with
    ``fixed`` fields on every lane.  Values are choice names or ints."""
    spec = traffic["lanes"]
    names = list(spec["axes"])
    combos = list(itertools.product(*(spec["axes"][n] for n in names)))
    return [dict(zip(names, c), **spec.get("fixed", {}), seed=s)
            for s in range(spec.get("seeds", 1)) for c in combos]
