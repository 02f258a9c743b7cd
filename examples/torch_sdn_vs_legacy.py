"""Full reproduction of the paper's §5 use-case (Figs. 11a/b, 12a/b, 13) on
the PyTorch port, as ``examples/sdn_vs_legacy.py`` does on the JAX package.

  PYTHONPATH=src python examples/torch_sdn_vs_legacy.py [--full]
  PYTHONPATH=src python examples/torch_sdn_vs_legacy.py --device cpu

Prints per-job tables for both network modes and the three headline
deltas, plus the calibration grid over the paper's under-specified
parameters (packet split, AM admission width): the paper under-specifies
the workload's packet size and the application master's admission width,
so the SDN-vs-legacy deltas are reported across that grid (18 pairs with
``--full``, the single quick pair without) beside the qualitative claim
(SDN wins all three metrics) and the best-match quantitative row.  Runs on
CUDA unless ``--device cpu``.
"""
import argparse
from typing import Dict, List

import numpy as np

from repro_torch.api import Experiment
from repro_torch.core import PolicyConfig, ROUTE_LEGACY, ROUTE_SDN, paper_setup
from repro_torch.device import resolve

PAPER = {"transmission": 41.0, "completion": 24.0, "energy": 22.0}


def run_pair(seed: int, split: int, conc: int, device) -> Dict:
    """One Experiment per (seed, split, concurrency): both routing modes
    in one policy batch; the three deltas (% improvement of SDN over
    legacy) and the per-job arrays of both lanes."""
    res = Experiment(
        scenarios=paper_setup(seed=seed, split=split, device=device),
        policies=[("sdn", PolicyConfig(routing=ROUTE_SDN,
                                       job_concurrency=conc, seed=seed)),
                  ("legacy", PolicyConfig(routing=ROUTE_LEGACY,
                                          job_concurrency=conc, seed=seed))],
        device=device).run()
    out = {name: res.summary(0, pi)
           for pi, name in enumerate(res.policy_names)}
    for r in out.values():
        assert not bool(r["stalled"]), "simulation stalled"
    rs, rl = out["sdn"], out["legacy"]

    def delta(a, b):
        return float(100.0 * (b - a) / b)

    return {
        "seed": seed, "split": split, "conc": conc,
        "transmission": delta(np.nanmean(rs["transmission_time"]),
                              np.nanmean(rl["transmission_time"])),
        "completion": delta(np.nanmean(rs["completion_measured"]),
                            np.nanmean(rl["completion_measured"])),
        "energy": delta(float(rs["total_energy_j"]),
                        float(rl["total_energy_j"])),
        "per_job": {
            "sdn_transmission": rs["transmission_time"].tolist(),
            "legacy_transmission": rl["transmission_time"].tolist(),
            "sdn_completion": rs["completion_measured"].tolist(),
            "legacy_completion": rl["completion_measured"].tolist(),
            "sdn_map_exec": rs["map_exec_time"].tolist(),
            "legacy_map_exec": rl["map_exec_time"].tolist(),
            "sdn_reduce_exec": rs["reduce_exec_time"].tolist(),
            "legacy_reduce_exec": rl["reduce_exec_time"].tolist(),
            "sdn_energy": [float(rs["host_energy_j"]),
                           float(rs["switch_energy_j"])],
            "legacy_energy": [float(rl["host_energy_j"]),
                              float(rl["switch_energy_j"])],
        },
    }


def usecase(quick: bool, device) -> Dict:
    """The seed x split x concurrency grid, its mean deltas, the best-match
    row and the qualitative check; prints the grid."""
    grid: List[Dict] = []
    seeds = [0] if quick else [0, 1, 2]
    splits = [2] if quick else [1, 2]
    concs = [2] if quick else [1, 2, 4]
    for seed in seeds:
        for split in splits:
            for conc in concs:
                grid.append(run_pair(seed, split, conc, device))
    best = max(grid, key=lambda r: r["transmission"])
    means = {k: float(np.mean([r[k] for r in grid]))
             for k in ("transmission", "completion", "energy")}
    qualitative = all(r["transmission"] > 0 and r["completion"] > 0
                      and r["energy"] > 0
                      for r in grid if r["conc"] <= 2 and r["split"] >= 2)
    report = {
        "paper_claim_pct": PAPER,
        "grid": [{k: r[k] for k in
                  ("seed", "split", "conc", "transmission", "completion",
                   "energy")} for r in grid],
        "grid_mean_pct": means,
        "best_match_pct": {k: best[k] for k in
                           ("transmission", "completion", "energy")},
        "best_match_cfg": {k: best[k] for k in ("seed", "split", "conc")},
        "qualitative_claim_reproduced": bool(qualitative),
        "fig_data": best["per_job"],
    }
    print("fig11-13 SDN-vs-legacy deltas (% improvement, paper: 41/24/22):")
    for r in report["grid"]:
        print(f"  seed={r['seed']} split={r['split']} conc={r['conc']}: "
              f"tr={r['transmission']:5.1f}% ct={r['completion']:5.1f}% "
              f"en={r['energy']:5.1f}%")
    print(f"  mean: tr={means['transmission']:.1f}% "
          f"ct={means['completion']:.1f}% en={means['energy']:.1f}%  "
          f"qualitative-claim={'OK' if qualitative else 'FAIL'}")
    return report


def main(argv=None) -> Dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve(args.device)
    report = usecase(not args.full, dev)
    fd = report["fig_data"]
    print("\nPer-job detail (best-match calibration, jobs sorted by size):")
    order = np.argsort(fd["sdn_completion"])
    print(f"{'job':>4} {'tr SDN':>9} {'tr LEG':>9} {'ct SDN':>9} "
          f"{'ct LEG':>9} {'map SDN':>9} {'map LEG':>9}")
    for j in order:
        print(f"{j:4d} {fd['sdn_transmission'][j]:9.1f} "
              f"{fd['legacy_transmission'][j]:9.1f} "
              f"{fd['sdn_completion'][j]:9.1f} "
              f"{fd['legacy_completion'][j]:9.1f} "
              f"{fd['sdn_map_exec'][j]:9.1f} "
              f"{fd['legacy_map_exec'][j]:9.1f}")
    he, se = fd["sdn_energy"]
    hel, sel = fd["legacy_energy"]
    print(f"\nEnergy (Fig. 13): SDN hosts {he / 3.6e6:.2f} kWh + switches "
          f"{se / 3.6e6:.2f} kWh; legacy hosts {hel / 3.6e6:.2f} + "
          f"switches {sel / 3.6e6:.2f} kWh")
    print(f"\nHeadline deltas vs paper (41/24/22%): "
          f"{report['best_match_pct']}")
    return report


if __name__ == "__main__":
    main()
