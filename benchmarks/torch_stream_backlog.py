"""Does a stream keep up?  ``leaf-spine-stream``'s two-class arrival mix
through a fabric at several arrival rates on the PyTorch port, under
``benchmarks/stream_sweep.py``'s two lanes (SDN and legacy at
``job_concurrency=4``), each rate's horizon set for the same expected
number of arrivals.  Per rate and lane it prints the retired jobs/s of
simulated time, the p50/p99 sojourn and the mean sojourn over each
quarter of the trace in arrival order: a mean that keeps growing quarter
by quarter is a backlog that grows without bound.

    PYTHONPATH=src python benchmarks/torch_stream_backlog.py \\
        --rates 0.4 0.035 0.03 --device cpu
"""
from __future__ import annotations

import argparse

import numpy as np


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scenario", default="leaf-spine-xl")
    ap.add_argument("--rates", nargs="+", type=float,
                    default=[0.4, 0.035, 0.03])
    ap.add_argument("--arrivals", type=int, default=240,
                    help="expected arrivals a rate (horizon = arrivals / "
                         "rate)")
    ap.add_argument("--slots", type=int, default=32)
    ap.add_argument("--chunk-steps", type=int, default=128)
    ap.add_argument("--device", default=None,
                    help="torch device (default: CUDA)")
    args = ap.parse_args(argv)

    from repro_torch.api import Experiment, PolicyConfig
    from repro_torch.core import ROUTE_LEGACY, ROUTE_SDN
    from repro_torch.scenarios.registry import stream_arrivals
    pols = [("sdn", PolicyConfig(routing=ROUTE_SDN, job_concurrency=4)),
            ("legacy", PolicyConfig(routing=ROUTE_LEGACY,
                                    job_concurrency=4))]
    exp = Experiment(args.scenario, pols, device=args.device)
    for rate in args.rates:
        horizon = args.arrivals / rate
        res = exp.run_stream(stream_arrivals(rate=rate, seed=0), horizon,
                             warmup=0.1 * horizon, slots=args.slots,
                             chunk_steps=args.chunk_steps)
        for pi, name in enumerate(res.policy_names):
            j, sm = res.jobs[pi], res.summary(pi)
            soj = j["sojourn"][np.argsort(j["seq"])]
            quarters = [float(q.mean()) for q in np.array_split(soj, 4)]
            print(f"rate {rate} horizon {horizon:.1f} s {name}: "
                  f"{res.stats.trace_len} arrivals, "
                  f"{sm['throughput_jobs_s']:.5f} jobs/s retired, p50/p99 "
                  f"sojourn {sm['p50_sojourn_s']:.2f}/"
                  f"{sm['p99_sojourn_s']:.2f} s, mean sojourn by quarter "
                  f"{[round(q, 1) for q in quarters]} s")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
