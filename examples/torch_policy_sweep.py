"""Beyond-paper capability demo on the PyTorch port: a batched policy sweep
— hundreds of (routing x traffic x placement x job-selection x seed)
scenarios as the lanes of ONE ``repro_torch.api.Experiment`` (DESIGN.md
§6), as ``examples/policy_sweep.py`` does on the JAX package.  The Java
original runs one scenario per JVM invocation.

  PYTHONPATH=src python examples/torch_policy_sweep.py --width 64
  PYTHONPATH=src python examples/torch_policy_sweep.py --device cpu

Runs on CUDA unless ``--device cpu``; sims/s is taken after a device sync.
"""
import argparse
import itertools
import time

import numpy as np
import torch

from repro_torch.api import Experiment, PolicyConfig
from repro_torch.core import (JOBSEL_FCFS, JOBSEL_SJF, PLACE_LEAST_USED,
                              PLACE_RANDOM, ROUTE_LEGACY, ROUTE_SDN,
                              TRAFFIC_FAIRSHARE, TRAFFIC_WATERFILL,
                              paper_setup)
from repro_torch.device import resolve


def lanes(width: int) -> list:
    """The 16 (routing, traffic, placement, job-selection) combos, each
    with seeds 0, 1, ..., ``width`` lanes in all."""
    combos = list(itertools.product(
        (ROUTE_SDN, ROUTE_LEGACY),
        (TRAFFIC_FAIRSHARE, TRAFFIC_WATERFILL),
        (PLACE_LEAST_USED, PLACE_RANDOM),
        (JOBSEL_FCFS, JOBSEL_SJF)))
    reps = max(1, width // len(combos))
    return [c + (s,) for s in range(reps) for c in combos][:width]


def sweep(width: int, device) -> dict:
    """Every lane of ``lanes(width)`` on ``paper_setup(seed=0, split=2)``
    in one run; each lane's mean completion and energy, read to the host
    once after the run, and the run's seconds."""
    setup = paper_setup(seed=0, split=2, device=device)
    rows = lanes(width)
    pols = [PolicyConfig(routing=r, traffic=t, placement=p, job_selection=j,
                         job_concurrency=2, seed=s)
            for r, t, p, j, s in rows]
    exp = Experiment(scenarios=setup, policies=pols, device=device)

    t0 = time.time()
    res = exp.run()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.time() - t0
    rep = res.job_report()
    en = res.energy_report()
    return {"rows": rows, "seconds": dt,
            "mean_ct": np.nanmean(rep["completion_measured"][0], axis=1),
            "energy_j": en["total_energy_j"][0]}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--width", type=int, default=32)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    out = sweep(args.width, resolve(args.device))
    rows, dt, mean_ct = out["rows"], out["seconds"], out["mean_ct"]
    print(f"{len(rows)} simulations in {dt:.1f}s "
          f"({len(rows) / dt:.1f} sims/s, one tensor program)")
    names = {ROUTE_SDN: "sdn", ROUTE_LEGACY: "legacy"}
    tn = {TRAFFIC_FAIRSHARE: "eq3", TRAFFIC_WATERFILL: "waterfill"}
    pn = {PLACE_LEAST_USED: "least-used", PLACE_RANDOM: "random"}
    jn = {JOBSEL_FCFS: "fcfs", JOBSEL_SJF: "sjf"}
    print(f"{'routing':8} {'traffic':10} {'placement':11} {'jobsel':5} "
          f"{'mean-ct(s)':>10} {'energy(kWh)':>11}")
    best = np.argsort(mean_ct)
    for i in best[:8]:
        r = rows[i]
        print(f"{names[r[0]]:8} {tn[r[1]]:10} {pn[r[2]]:11} {jn[r[3]]:5} "
              f"{mean_ct[i]:10.1f} "
              f"{float(out['energy_j'][i]) / 3.6e6:11.2f}")
    out["sims_per_s"] = len(rows) / dt
    return out


if __name__ == "__main__":
    main()
