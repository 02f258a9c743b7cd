"""Tour of the scenario library on the PyTorch port: build each registered
scenario, print its fabric shape and route diversity, then race SDN vs
legacy routing on every topology in one packed
``repro_torch.api.Experiment`` (DESIGN.md §5, §6), as
``examples/scenario_zoo.py`` does on the JAX package.

  PYTHONPATH=src python examples/torch_scenario_zoo.py            # all fabrics
  PYTHONPATH=src python examples/torch_scenario_zoo.py fat-tree leaf-spine
  PYTHONPATH=src python examples/torch_scenario_zoo.py --device cpu fat-tree

Runs on CUDA unless ``--device cpu``.  The packed grid runs one loop a
scenario (``repro_torch.api.runners``).
"""
import argparse

import numpy as np

from repro_torch.api import Experiment
from repro_torch.core import PolicyConfig, ROUTE_LEGACY, ROUTE_SDN
from repro_torch.device import resolve
from repro_torch.scenarios import get_scenario, list_scenarios


def diversity(names, device) -> list:
    """Build each scenario on ``device``; print its fabric and the min,
    max and mean number of candidate routes over its ordered host pairs.
    -> [(name, setup, {"min", "max", "mean"})]."""
    out = []
    for name in names:
        sc = get_scenario(name)
        setup = sc.build(device)
        topo = setup.cluster.topo
        nc = np.asarray(setup.route_table.n_cand).reshape(topo.n_nodes,
                                                          topo.n_nodes)
        host_pairs = nc[: topo.n_hosts, : topo.n_hosts]
        off_diag = host_pairs[~np.eye(topo.n_hosts, dtype=bool)]
        div = {"min": int(off_diag.min()), "max": int(off_diag.max()),
               "mean": float(off_diag.mean())}
        print(f"{sc.name:22} {topo.n_hosts:3d} hosts {topo.n_switches:3d} "
              f"switches {topo.n_links:4d} links   host-pair route "
              f"diversity: min {div['min']}  max {div['max']}  "
              f"mean {div['mean']:.1f}   [{sc.description}]")
        out.append((sc.name, setup, div))
    return out


def race(scens, device) -> list:
    """SDN vs legacy on every (name, setup) in one packed experiment; the
    rows, scenario-major, sdn then legacy."""
    return Experiment(
        scenarios=scens,
        policies=[("sdn", PolicyConfig(routing=ROUTE_SDN, job_concurrency=2)),
                  ("legacy", PolicyConfig(routing=ROUTE_LEGACY,
                                          job_concurrency=2))],
        device=device).run().rows()


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("names", nargs="*", help="registry names (default: all)")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve(args.device)
    built = diversity(args.names or list_scenarios(), dev)
    rows = race([(name, setup) for name, setup, _ in built], dev)
    print()
    for sdn, leg in zip(rows[::2], rows[1::2]):
        gain = (leg["mean_completion_s"] - sdn["mean_completion_s"]) \
            / leg["mean_completion_s"] * 100
        print(f"{sdn['scenario']:22} completion sdn "
              f"{sdn['mean_completion_s']:7.1f}s legacy "
              f"{leg['mean_completion_s']:7.1f}s   sdn gain {gain:+5.1f}%")
    print("\nscenario zoo OK")
    return {"diversity": {name: div for name, _, div in built},
            "rows": rows}


if __name__ == "__main__":
    main()
