#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each printed with its wall time:

1. the card: name and power limit (``nvidia-smi``), torch and CUDA versions;
2. the build of every hand-written kernel with ``nvcc`` for sm_90a;
3. each kernel against its plain PyTorch version on the card, at ragged and
   square shapes (bitwise), and ``apsp`` against the numpy hop distances on
   every topology of the ported scenarios (exactly); kernel and plain times
   at the main path's shape, as device time from a profiler trace and per
   call through the wrapper by CUDA events;
4. the paper's use case (paper-fabric, SDN vs legacy, job_concurrency=2)
   on CUDA: SDN ahead on transmission, completion and energy, and the final
   states equal to the same run on the CPU; how far a water-fill run's
   floats land from the CPU's is printed (its float sums are atomics);
5. the main path at full size: ``leaf-spine-xl`` under the profile policy
   (SDN, least-used, job_concurrency=4) through ``Experiment(...).run()``
   on CUDA, with every kernel's launch count reset just before and read
   just after; it must reach 1202 steps unstalled and equal the CPU run.
   ``paper-fabric`` and ``leaf-spine`` run under the same policy too; each
   of the three prints its steps/s and, from a profiler trace of a second
   run, the device's busy time and idle share.

Then one JSON line with every kernel's numbers, the card's name and power
limit, and last the line ``{"ok": true, "device": {...}}``.  Any failure
raises and exits non-zero; without a CUDA device, or without the
repository's ``src/`` beside this file, it exits non-zero and prints no
result.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

# H100 SXM peaks (NVIDIA data sheet): HBM bandwidth and float32 outside the
# tensor cores — min-plus has no tensor-core form
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_OPS_PER_S = 67e12

# float tolerance between the CUDA and CPU runs of the engine (int and bool
# leaves and the step count must be equal)
RTOL = 1e-6

PROFILE_STEPS = {"paper-fabric": 21, "leaf-spine": 45, "leaf-spine-xl": 1202}


class SmokeFailure(AssertionError):
    pass


def check(cond, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def phase(name: str):
    """Context manager printing a phase's wall time when it ends."""
    class _P:
        def __enter__(self):
            self.t0 = time.perf_counter()
            print(f"== {name}", flush=True)
            return self

        def __exit__(self, *exc):
            if exc[0] is None:
                print(f"== {name}: ok in "
                      f"{time.perf_counter() - self.t0:.3f} s", flush=True)
            return False
    return _P()


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    return out[0].strip()


def cuda_ms(fn, warmup: int = 5, repeats: int = 15, inner: int = 20):
    """Median per-call milliseconds of ``fn`` by CUDA events over
    ``repeats`` samples of ``inner`` back-to-back calls."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    samples = []
    for _ in range(repeats):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(inner):
            fn()
        b.record()
        b.synchronize()
        samples.append(a.elapsed_time(b) / inner)
    return statistics.median(samples)


def device_ms(fn, calls: int = 1):
    """Summed device time (ms) of every kernel ``calls`` runs of ``fn``
    launch, per run, from a ``torch.profiler`` trace of the card; ``None``
    when the trace holds no device time.  ``fn`` must be warm already."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    total_us = sum(e.self_device_time_total for e in prof.key_averages())
    return total_us / 1e3 / calls if total_us > 0 else None


def states_match(gpu, cpu, label: str) -> None:
    """Int/bool leaves equal, float leaves within RTOL (NaN == NaN)."""
    import torch
    for name, a, b in zip(gpu._fields, gpu, cpu):
        a = a.cpu()
        check(a.shape == b.shape and a.dtype == b.dtype,
              f"{label}: SimState.{name} shape/dtype differ")
        if a.dtype.is_floating_point:
            ok = torch.allclose(a, b, rtol=RTOL, atol=0.0, equal_nan=True)
        else:
            ok = torch.equal(a, b)
        check(ok, f"{label}: SimState.{name} differs between CUDA and CPU")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import numpy as np

    from repro_torch.api import Experiment, PolicyConfig
    from repro_torch.core import ROUTE_LEGACY, ROUTE_SDN, TRAFFIC_WATERFILL
    from repro_torch.core.routing import hop_distances_np
    from repro_torch.kernels.tropical_apsp import (apsp, minplus_matmul,
                                                   minplus_matmul_ref)
    from repro_torch.kernels.tropical_apsp import kernel as minplus_kernel
    from repro_torch.scenarios import get_scenario

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = gpu_line()
    kind = torch.cuda.get_device_name(0)

    with phase("1 card"):
        print(f"card: {card}")
        print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
              f"python {sys.version.split()[0]}")

    with phase("2 kernel build (nvcc, sm_90a)"):
        t0 = time.perf_counter()
        minplus_kernel.build()
        build_s = time.perf_counter() - t0
        print(f"minplus: built and loaded in {build_s:.3f} s")

    scenarios = ("paper-fabric", "leaf-spine", "fat-tree", "canonical-tree",
                 "leaf-spine-xl")
    with phase("3 kernels against their plain versions"):
        rng = np.random.RandomState(0)
        max_err = 0.0
        shapes = [(24, 24, 24), (37, 37, 37), (153, 153, 153),
                  (257, 257, 257), (1024, 1024, 1024), (1, 5, 3),
                  (100, 37, 153), (257, 1024, 24), (33, 65, 31)]
        for m, k, n in shapes:
            x = rng.uniform(0, 10, (m, k)).astype(np.float32)
            y = rng.uniform(0, 10, (k, n)).astype(np.float32)
            x[rng.rand(m, k) < 0.1] = np.inf
            y[rng.rand(k, n) < 0.1] = np.inf
            xd, yd = torch.from_numpy(x).to(dev), torch.from_numpy(y).to(dev)
            got = minplus_matmul(xd, yd)
            torch.cuda.synchronize()
            want = minplus_matmul_ref(xd, yd)
            check(torch.equal(got, want),
                  f"minplus {m}x{k}x{n}: kernel != plain version")
            fin = torch.isfinite(want)
            if bool(fin.any()):
                max_err = max(max_err, float((got[fin] - want[fin]).abs()
                                             .max()))
            print(f"minplus {m}x{k}x{n}: bitwise equal")
        for name in scenarios:
            topo = get_scenario(name).topology()
            hop = topo.hop_matrix()
            got = apsp(torch.from_numpy(hop).to(dev)).cpu().numpy()
            check(np.array_equal(got.astype(np.float64),
                                 hop_distances_np(hop)),
                  f"apsp on {name}: != numpy hop distances")
            print(f"apsp on {name} (n={hop.shape[0]}): equal to numpy")
        # times at the main path's shape: the route table of leaf-spine-xl
        # (an operand of the third squaring: hop distances up to 4)
        xl_hop = get_scenario("leaf-spine-xl").topology().hop_matrix()
        n = xl_hop.shape[0]
        d = apsp(torch.from_numpy(xl_hop).to(dev), steps=2)
        kernel_call_ms = cuda_ms(lambda: minplus_matmul(d, d))
        plain_call_ms = cuda_ms(lambda: minplus_matmul_ref(d, d))
        kernel_ms = device_ms(lambda: minplus_matmul(d, d), calls=50)
        plain_ms = device_ms(lambda: minplus_matmul_ref(d, d), calls=50)
        bytes_moved = 4 * (n * n + n * n + n * n)
        ops = 2 * n * n * n
        bound_bytes_ms = bytes_moved / PEAK_BYTES_PER_S * 1e3
        bound_ops_ms = ops / PEAK_F32_OPS_PER_S * 1e3
        print(f"minplus {n}x{n}x{n}: device time per call: kernel "
              f"{kernel_ms} ms, plain {plain_ms} ms; per call through the "
              f"wrapper (CUDA events, back to back): kernel "
              f"{kernel_call_ms:.6f} ms, plain {plain_call_ms:.6f} ms; "
              f"bound {max(bound_bytes_ms, bound_ops_ms):.6f} ms")

    with phase("4 paper use case on CUDA (SDN vs legacy)"):
        pols = [("sdn", PolicyConfig(routing=ROUTE_SDN, job_concurrency=2)),
                ("legacy", PolicyConfig(routing=ROUTE_LEGACY,
                                        job_concurrency=2))]
        res = Experiment("paper-fabric", pols, device="cuda").run()
        ref = Experiment("paper-fabric", pols, device="cpu").run()
        states_match(res.states, ref.states, "paper-fabric")
        jr, er = res.job_report(), res.energy_report()
        sdn = {k: np.nanmean(jr[k][0, 0]) for k in
               ("transmission_time", "completion_measured")}
        leg = {k: np.nanmean(jr[k][0, 1]) for k in
               ("transmission_time", "completion_measured")}
        for k in sdn:
            check(sdn[k] < leg[k], f"paper-fabric: SDN not ahead on {k}")
            print(f"{k}: sdn {sdn[k]:.6f} s < legacy {leg[k]:.6f} s")
        check(er["total_energy_j"][0, 0] < er["total_energy_j"][0, 1],
              "paper-fabric: SDN not ahead on energy")
        print(f"energy: sdn {er['total_energy_j'][0, 0]:.3f} J < legacy "
              f"{er['total_energy_j'][0, 1]:.3f} J")
        for r in res.rows():
            check(not r["stalled"], f"paper-fabric/{r['policy']} stalled")
        # water-fill adds floats with atomics on CUDA: report how far its
        # lanes land from the CPU run (measured, not a check)
        wf = [("wf", PolicyConfig(traffic=TRAFFIC_WATERFILL,
                                  job_concurrency=2))]
        gw = Experiment("paper-fabric", wf, device="cuda").run().states
        cw = Experiment("paper-fabric", wf, device="cpu").run().states
        ints_equal = all(torch.equal(a.cpu(), b) for a, b in zip(gw, cw)
                         if not b.dtype.is_floating_point)
        rel = max(float(((a.cpu() - b).abs() / b.abs().clamp(min=1e-30))
                         .nan_to_num(0.0).max()) if b.numel() else 0.0
                  for a, b in zip(gw, cw) if b.dtype.is_floating_point)
        print(f"water-fill lanes, CUDA vs CPU: ints equal {ints_equal}, "
              f"max float rel diff {rel}")

    profile = [("profile", PolicyConfig(job_concurrency=4))]
    with phase("5 main path at full size on CUDA"):
        rates, idle = {}, {}
        for name in PROFILE_STEPS:
            main_path = name == "leaf-spine-xl"
            if main_path:
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                minplus_kernel.reset_launch_count()
            t_main = time.perf_counter()
            exp = Experiment(name, profile, device="cuda")
            t0 = time.perf_counter()
            res = exp.run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            if main_path:
                main_s = time.perf_counter() - t_main
                launches = minplus_kernel.launch_count()
                peak = torch.cuda.max_memory_allocated()
            steps = int(res.states.steps[0])
            check(not bool(res.states.stalled[0]), f"{name} stalled")
            check(steps == PROFILE_STEPS[name],
                  f"{name}: {steps} steps, expected {PROFILE_STEPS[name]}")
            rates[name] = steps / wall
            print(f"{name}: {steps} steps in {wall:.3f} s of engine run = "
                  f"{steps / wall:.1f} steps/s on CUDA")
            # device busy time of a second run from a profiler trace; the
            # idle share is against the unprofiled run's wall time
            busy = device_ms(exp.run)
            idle[name] = None if busy is None else 1 - busy / 1e3 / wall
            print(f"{name}: device busy {busy} ms of {wall * 1e3:.3f} "
                  f"ms wall, idle share {idle[name]}")
            cpu = Experiment(name, profile, device="cpu").run()
            states_match(res.states, cpu.states, name)
            print(f"{name}: final state equals the CPU run")
        check(launches > 0, "the main path launched no minplus kernel")
        print(f"leaf-spine-xl main path: {main_s:.3f} s from Experiment() "
              f"to the final state, minplus launches {launches}, peak "
              f"device memory {peak / 2**20:.1f} MiB")

    print(json.dumps({"kernels": [{
        "name": "minplus_f32",
        "route": "cuda",
        "source": "src/repro_torch/csrc/tropical_apsp.cu",
        "replaces": "src/repro/kernels/tropical_apsp/kernel.py:28",
        "shape": [n, n, n],
        "launches": launches,
        "max_abs_err": max_err,
        "ms": kernel_ms if kernel_ms is not None else kernel_call_ms,
        "plain_ms": plain_ms if plain_ms is not None else plain_call_ms,
        "call_ms": kernel_call_ms,
        "plain_call_ms": plain_call_ms,
        "bound_ms": max(bound_bytes_ms, bound_ops_ms),
        "bound_by": ("bytes" if bound_bytes_ms > bound_ops_ms
                     else "operations"),
        "library_ms": None,
        "build_s": build_s,
    }], "steps_per_s": rates, "device_idle_share": idle}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
