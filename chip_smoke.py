#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each printed with its wall time:

1. the card: name and power limit (``nvidia-smi``), torch and CUDA versions;
2. the build of every hand-written kernel with ``nvcc`` for sm_90a;
3. the min-plus kernel against its plain PyTorch version on the card: one
   product at ragged, tile-edge and square shapes at every tile (bitwise);
   the one-launch APSP (``apsp``) against the numpy hop distances on every
   topology of the ported scenarios (exactly), with the launches and
   squarings each call ran (1 launch of 3 squarings on leaf-spine-xl); the
   tile chosen, each entry's registers, shared memory and blocks an SM;
   kernel and plain times of one product and of xl's APSP beside the bound
   (pairs x 2 instructions a pair over the CUDA cores' issue rate, for the
   squarings the distances need: ceil(log2 diameter), without the one
   that confirms them);
3b. the same kernel at fat_tree(32) (n = 9473, a k = 32 fat tree from
   ``repro_torch.core.topology``): the APSP bitwise against the plain
   squarings on the card at the count the kernel ran (4), one product
   bitwise against the plain second squaring, and the times of the
   product and of the APSP beside their bounds;
4. the paper's use case (paper-fabric, SDN vs legacy, job_concurrency=2)
   on CUDA: SDN ahead on transmission, completion and energy, and the final
   states equal to the same run on the CPU; how far a water-fill run's
   floats land from the CPU's is printed (its float sums are atomics);
5. the main path at full size: ``leaf-spine-xl`` under the profile policy
   (SDN, least-used, job_concurrency=4) through ``Experiment(...).run()``
   on CUDA, with every kernel's launch count reset just before and read
   just after; it must reach 1202 steps unstalled and equal the CPU run,
   and its route table must take exactly one min-plus launch of 3
   squarings.
   ``paper-fabric`` and ``leaf-spine`` run under the same policy too; each
   of the three prints its steps/s and, from a profiler trace of its
   first 200 steps run again (the whole run on the two small fabrics),
   the device's busy time and idle share;
6. the flash-attention kernel against its plain version on the card: its
   kernels' registers, shared memory and blocks an SM, and the count of
   tensor-core instructions (HGMMA, HMMA) in the bf16 kernel's SASS, which
   must not be zero; the reference's six sweep shapes (2e-5 in float32 with
   TF32 off, 2e-2 in bf16), the serving path's shapes (qwen3-4b heads, q
   [1,S,32,128], k/v [1,S,8,128], bf16, causal) at S = 32, 1000 (ragged)
   and 2048, a causal case with q_offset > 0, and the bf16 kernel's tile
   edges (every Dh, GQA groups 1, 4 and 8, Sq < Skv with q_offset > 0,
   non-causal); at S = 32 and S = 2048 the kernel's,
   the plain version's and ``scaled_dot_product_attention``'s times (the
   yardstick, never called by the port) beside the bound, as the device
   time of one call (``fenced_ms`` less the reading of an empty call) and
   per call by CUDA events over back-to-back calls;
7. the LM serving path at full width: qwen3-4b's published config (36
   layers, d_model 2560, 4.41 B parameters, random bf16 weights from a
   seeded generator on the card) through ``repro_torch.launch.serve``
   with the reference launcher's traffic (16 requests, prompts of 4-31
   tokens, 4 slots, max_len 256, max_new 16) and the flash kernel's launch
   count reset just before and read just after: 16 answers of 17 tokens
   and 36 x 16 = 576 launches; then one 2048-token prompt through
   ``lm_prefill`` with the kernel and with the plain attention, whose
   last-position logits must agree; tok/s, prefill time and peak device
   memory; the device time of one decode tick from a CUDA graph of it
   replayed between two events, beside its kernels' summed time from a
   profiler trace;
8. the Mamba serving path at full width: the scan kernels' registers,
   shared memory and blocks an SM; both selective-scan entry points
   against their plain versions on the card (rtol 1e-4, atol 1e-5, the
   reference's own) at the reference's sweep shapes, across the borders
   of the fused kernel's tiles of 16 steps (S = 1, 15, 16, 17, 2049; B = 1
   and 4; D = 8190) and at falcon-mamba-7b's shapes (the serving bucket
   [1,32,8192,16], a decode tick [4,1,8192,16] from a nonzero state, the
   2048-token prefill, and the Pallas-contract entry at [1,2048,8192,16]),
   with their device times (``fenced_ms`` less the floor; the plain
   versions as a CUDA graph) beside the bound; then, with phase
   7's model freed, falcon-mamba-7b's published config (64 layers,
   d_model 4096, d_inner 8192, N 16, 7.27 B parameters, random bf16
   weights from a seeded generator on the card) through
   ``repro_torch.launch.serve`` with the same traffic as phase 7 and every
   kernel's launch count reset just before and read just after: 16 answers
   of 17 tokens and 64 x (16 prefills + 64 ticks) = 5120 scan launches;
   tok/s, the decode tick through Python and as a CUDA graph; a 2048-token
   prefill through the kernel against the chunked scan, whose
   last-position logits must agree, and the same prompt walked layer by
   layer to show where their spread comes from (``mamba_depth_witness``);
   and peak device memory;
9. failures and the packed grid on CUDA: (a) ``paper-fabric-failures``
   and ``leaf-spine-failures`` under {SDN, legacy} × {restart, resume},
   each equal to its CPU run, with tasks re-executed and packets rerouted;
   (b) the four-scenario heterogeneous grid (paper-fabric, leaf-spine,
   fat-tree, canonical-tree × SDN, legacy) equal to the CPU grid, each
   scenario's cells equal to its own single run on CUDA on the unpadded
   prefix, the pad slots inert; (c) the slice's path at full size:
   ``leaf-spine-xl`` at its registered size under the profile policy, SDN
   and legacy lanes, crossed with three outage traces (none, and two seeds
   of 5e-5 host and link failures a second with a 120 s repair), with
   every kernel's launch count reset just before and read just after: one
   ``apsp_f32`` launch for the whole grid, the trace without outages equal
   to phase 5's healthy run, the seed-0 trace equal to its CPU run,
   re-executions and reroutes on both failing traces, no lane stalled;
   steps, steps/s and wall time of each trace's loop, the time from
   ``Experiment()`` to the final state, the device's idle share (a
   profiler trace of the seed-0 loop's first 200 steps run again), peak
   device memory and the SDN-against-legacy rows;
10. the control plane and chaos on CUDA: (a) ``paper-fabric-ctrl`` and
   ``leaf-spine-ctrl`` under {SDN reactive, SDN proactive, legacy} (and
   SDN with migration=congestion on ``leaf-spine-ctrl``),
   ``paper-fabric-chaos`` and ``leaf-spine-chaos`` under {SDN, legacy} ×
   speculation {off, on}, each at its registered size and equal to its
   CPU run, the flow tables' conservation law (``occupied == installs -
   evictions``, nothing left INSTALLING) on the CUDA states, and
   ``paper-fabric-chaos``'s failover counters; (b) ``leaf-spine-xl``'s
   fabric and Zipf mix cut to ``XL_CTRL_JOBS`` of its 128 jobs, with
   ``leaf-spine-ctrl``'s controller (0.02 s
   install latency, 1000 rules/s, 8 slots, migration threshold 12, cost
   0.5 s, cooldown 5 s) under SDN reactive, SDN proactive, legacy and SDN
   with migration, as four lanes of one loop; (c) ``leaf-spine-xl`` under
   ``leaf-spine-chaos``'s gray host slowdowns (``random_degradation(topo,
   host_rate=2e-3, mean_factor=0.3, mttr=400, horizon=2000, seed=1)``)
   with 2 clone slots a job under {SDN, legacy} × speculation {off, on}.
   Each of (b) and (c), with every kernel's launch count reset just before
   and read just after (one ``apsp_f32`` launch each), is equal to its CPU
   run and prints its steps and steps/s, the time from ``Experiment()`` to
   the final state, the device's idle share over its first 200 steps run
   again under the profiler, the host syncs a step over the same window
   (``torch.cuda.set_sync_debug_mode``) and the device operations a step
   it issues (from a profiler trace), peak device memory, and per lane
   the makespan, installs, evictions, reinstalls, queue wait and
   migrations (and, for (c), clone launches and wins, wasted clone work
   and degraded time).  The CPU runs that phase 10 is held against start
   with the script in two worker processes and overlap phases 2-9;
11. the fleet engine and the streaming ring on CUDA, each sub-phase with
   every kernel's launch count reset just before and read just after and
   the scenario built anew (one ``apsp_f32`` launch each): (a)
   ``benchmarks/fleet_sweep.py``'s 512-cell grid (paper-fabric × {legacy,
   SDN} × {least-used, round-robin} × 32 seeds × host-failure rates {0,
   0.02, 0.05, 0.10}) through ``run_fleet(width=32, chunk_steps=32)``,
   every cell equal to ``run()`` of the same grid on CUDA and to the CPU
   run, with the ``FleetStats`` and both paths' wall time and sims/s; (b)
   ``leaf-spine-xl`` under SDN × {least-used, round-robin}
   (``tests/test_fleet.py``'s slow case) through ``run_fleet(width=2,
   chunk_steps=64)`` equal to ``run()``, with
   chunks, refills and steps/s; (c) a finite trace that fits the ring on
   ``leaf-spine``: ``run_stream`` equal to ``run()`` on the same
   ``ring_setup`` under three policies; (d) ``leaf-spine-stream``'s
   two-class Poisson mix streamed through ``leaf-spine-xl``'s fabric
   (``STREAM_RATE``, ``STREAM_HORIZON``, 32 slots, chunks of 128 events)
   under SDN and legacy, and a second SDN lane at ``job_concurrency=8``
   in the SDN lane's cohort, equal to its CPU run (job rows,
   ``StreamStats``), the streaming ledger held, at least 4 × slots
   refills a lane, the two-lane cohort's rings seen to hold different
   jobs; trace length, loads, refills, chunks, loop steps and steps/s,
   wall jobs/s, each policy's steady-state summary, the idle share, host
   syncs and device ops a step over a window (the same stream through
   ``run_stream`` on its arrivals below ``PROFILE_STREAM_HORIZON``, ~250
   events), and peak device memory.
   Its CPU runs join phase 10's worker pool at the start;
12. the roofline advisor and the data twin on CUDA: ``advise_allreduce``
   at 1e6 and 100e6 bytes a chip on a 4x4 and an 8x8 torus (64 chips, the
   advisor's ``des_max_chips``), each ranking and DES time equal to the
   CPU run's (rtol 1e-6) and within 1 % of ``analytic_time``, exactly one
   ``apsp_f32`` launch for each schedule's ``flows_setup``, and each
   schedule's loop steps and steps/s; then one ``pipeline_jobs`` ingest job
   (``INGEST``) through the engine on ``leaf-spine-xl``'s fabric under SDN
   and legacy, equal to its CPU run, with one ``apsp_f32`` launch: a check
   of the data twin on the card, not a measured workload (its shape has no
   published source).  Its CPU runs join the worker pool at the start;
13. the MoE family at full width: qwen3-moe-30b-a3b's published config (48
   layers, d_model 2048, 32 heads over 4 kv heads, 128 experts top-8 of
   d_ff 768; 30.53 B parameters, random bf16 weights from a seeded
   generator on the card) through ``repro_torch.launch.serve`` with phase
   7's traffic and every kernel's launch count reset just before and read
   just after: 16 answers of 17 tokens, 48 x 16 = 768 flash launches, no
   min-plus or scan launch; tok/s, the tick through Python and as a CUDA
   graph, the host syncs of a tick without an admission (exactly one, its
   argmax copy); the 2048-token prefill through the kernel against the
   plain attention within ``LOGIT_TOL``, with the share of (token,
   choice) pairs whose expert differs at each layer, and
   ``moe_depth_witness`` walking the prompt layer by layer; peak device
   memory;
14. the hybrid family at full width: jamba-v0.1-52b's published widths
   with the depth cut to 2 of its 4 periods (16 layers: 14 Mamba, 2
   attention, 8 MoE of 16 experts top-2; 26.05 B parameters) through the
   launcher with the same traffic: 16 answers of 17 tokens, 2 x 16 = 32
   flash and 14 x (16 prefills + 64 ticks) = 1120 fused-scan launches;
   the same measurements as phase 13, the long prefill through both
   kernels against the chunked attention and the chunked scan.

Then one JSON line with every kernel's numbers and design, the card's
name and power limit, and last the line ``{"ok": true, "device":
{...}}``.  Any failure raises and exits non-zero; without a CUDA device, or without the
repository's ``src/`` beside this file, it exits non-zero and prints no
result.
"""
from __future__ import annotations

import concurrent.futures
import dataclasses
import gc
import json
import math
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

# H100 SXM peaks (NVIDIA data sheet): HBM bandwidth, float32 outside the
# tensor cores (min-plus has no tensor-core form) and dense bf16 on the
# tensor cores (attention's two products have one); exp on the
# special-function units: 16 results a clock on each of 132 SMs at the
# 1.98 GHz boost clock (CUDA programming guide's throughput table, cc 9.0)
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_OPS_PER_S = 67e12
# min-plus: an (add, min) pair is two float32 instructions (FADD and
# FMNMX; no instruction fuses them), against the CUDA cores' issue rate of
# 128 lanes a clock on each of 132 SMs at the 1.98 GHz boost clock (the
# 67 TFLOP/s above counts each FMA lane as two operations)
INSTR_PER_S = 128 * 132 * 1.98e9
MINPLUS_INSTR_PER_PAIR = 2
PEAK_BF16_OPS_PER_S = 989e12
PEAK_SFU_PER_S = 132 * 16 * 1.98e9

# float tolerance between the CUDA and CPU runs of the engine (int and bool
# leaves and the step count must be equal)
RTOL = 1e-6

PROFILE_STEPS = {"paper-fabric": 21, "leaf-spine": 45, "leaf-spine-xl": 1202}

# phase 9: the failure-rate axis of benchmarks/failure_sweep.py at one
# rate, over leaf-spine-xl's expected makespan (~3540 s)
XL_FAILURES = (("r0", dict(host_rate=0.0, link_rate=0.0)),
               ("r5e-5/s0", dict(host_rate=5e-5, link_rate=5e-5, mttr=120.0,
                                 horizon=3500.0, seed=0)),
               ("r5e-5/s1", dict(host_rate=5e-5, link_rate=5e-5, mttr=120.0,
                                 horizon=3500.0, seed=1)))
GRID_SCENARIOS = ("paper-fabric", "leaf-spine", "fat-tree", "canonical-tree")
# the idle share's profiler window: the first steps of a loop run again
# (a trace's processing grows with its events: with the whole 1886-step
# loop profiled, phase 9 took 445 s beside an H100 80GB HBM3)
PROFILE_WINDOW_STEPS = 200

# phase 10: the control-plane and chaos entries and their policy grids
# (``phase10_policies``); (b) and (c) run leaf-spine-xl
PHASE10_GRIDS = {"paper-fabric-ctrl": "ctrl", "leaf-spine-ctrl": "ctrl+mig",
                 "paper-fabric-chaos": "chaos",
                 "leaf-spine-chaos": "chaos"}
PHASE10_XL = {"xl-ctrl": "ctrl+mig", "xl-chaos": "chaos"}
# 10(b)'s jobs: at xl's 128 the SDN lane's loop ran 28970 steps (321 s, the
# script's longest loop); 32 cut it to 7456 and pay for phases 12-14
XL_CTRL_JOBS = 32

# the worker processes of phase 10's and phase 11's CPU runs (stopped on
# exit)
CPU_POOL: list = []

# phase 11: benchmarks/fleet_sweep.py's grid (build_grid(512)), and the
# stream at scale.  leaf-spine-stream's mix at 0.4 jobs/s (8x its 0.05
# for xl's 8x the hosts) outruns the SDN lane, which retires ~0.046
# jobs/s at job_concurrency=4 (benchmarks/torch_stream_backlog.py: its
# mean sojourn grows 548 -> 3932 s over the trace); 0.03 jobs/s is ~65 %
# of that.  The horizon gives 164 arrivals: 132 refills a lane, above 4
# x 32 slots (8000 s, 240 arrivals, put the script over 1000 s of phases
# on a slow host)
FLEET_FAIL_RATES = (0.0, 0.02, 0.05, 0.10)
FLEET_SEEDS = 32
STREAM_RATE = 0.03
STREAM_HORIZON = 6000.0
STREAM_SLOTS = 32
STREAM_CHUNK = 128
# 11(d)'s idle-share window: the same stream, in the full trace's ring
# geometry, on the arrivals below this time (20 of them, 249 loop steps)
PROFILE_STREAM_HORIZON = 800.0
PHASE11_CPU = ("fleet-grid", "xl-stream")

# flash attention against its plain version: the reference's tolerances
# (tests/test_kernels.py), float32 with TF32 off and bf16
FA_TOL = {"float32": 2e-5, "bfloat16": 2e-2}

# the serving run: the reference launcher's defaults (src/repro/launch/serve.py)
SERVE_ARGV = ["--arch", "qwen3-4b", "--requests", "16", "--slots", "4",
              "--max-len", "256", "--max-new", "16"]
LONG_PROMPT = 2048
# the long prefill's last-position logits, kernel against plain attention,
# as a share of the largest |logit|: the two attentions round differently
# in bf16 (the kernel rounds the unnormalised P to bf16 before P V and
# divides by the float32 sum after, the plain version rounds the normalised
# weights), and 36 bf16 layers carry that on
LOGIT_TOL = 0.05

# phase 8: falcon-mamba-7b with the reference launcher's traffic (64 decode
# ticks: 16 requests of 16 steps over 4 slots, refilled four at a time)
MAMBA_ARGV = ["--arch", "falcon-mamba-7b", "--requests", "16", "--slots",
              "4", "--max-len", "256", "--max-new", "16"]
MAMBA_PARAMS = 7_272_665_088
MAMBA_TICKS = 64
# the selective scan against its plain versions: the reference's tolerance
# for its kernel against its oracle (tests/test_kernels.py); the sums run
# in other orders (a sequential loop against a Hillis-Steele scan)
SCAN_TOL = dict(rtol=1e-4, atol=1e-5)
# the 2048-token prefill's last-position logits, kernel against chunked
# scan, as a share of the largest |logit|: the two scans differ only in
# float32 summation order, but each block's output is rounded to bf16, so
# a rare one-ulp flip carries through 64 bf16 layers, as phase 7's does
MAMBA_LOGIT_TOL = 0.05

# phase 12: benchmarks/advisor_validation.py's sizes on a 4x4 torus and on
# 8x8 (64 chips, the advisor's des_max_chips: a v5e-64 slice), each DES
# time within 1 % of the analytic ring formulas (that script's limit)
ADVISOR_MESHES = ((4, 4), (8, 8))
ADVISOR_BYTES = (1e6, 100e6)
ADVISOR_TOL = 0.01
# the data twin, held against its CPU run only (no published ingest
# workload gives its shape, so it is timed as no metric): one map task a
# host of leaf-spine-xl's 128, each reading a 2 Gbit shard, shuffled to 32
# reducers that assemble the batches
INGEST = dict(n_shards=128, shard_gbits=2.0, n_reducers=32)
PHASE12_CPU = ("advisor", "ingest")

# phases 13 and 14: the MoE and hybrid families with phase 7's traffic; a
# tick without an admission waits for the device once, for its argmax
MOE_ARGV = ["--arch", "qwen3-moe-30b-a3b", "--requests", "16", "--slots",
            "4", "--max-len", "256", "--max-new", "16"]
MOE_PARAMS = 30_532_122_624
# jamba-v0.1-52b at full width, depth cut to 2 of its 4 periods (16
# layers: 14 Mamba, 2 attention, 8 MoE; 52.17 GB of weights): the whole
# model takes 103.27 GB, and 3 periods (77.72 GB) leave no room for the
# long prefill on an 80 GB card
JAMBA_LAYERS = 16
JAMBA_ARGV = ["--arch", "jamba-v0.1-52b", "--layers", str(JAMBA_LAYERS),
              "--requests", "16", "--slots", "4", "--max-len", "256",
              "--max-new", "16"]
JAMBA_PARAMS = 26_053_595_136


DESIGN = {
    "minplus": "one tile routine: BM x BN output tiles (16-128, the largest "
               "that gives every SM a tile), TM x TN register micro-tiles "
               "(2-8) fed by 16-byte shared-memory loads, k-slabs of 16 "
               "staged by cp.async two in flight; the APSP in one "
               "cooperative persistent launch, ping-pong buffers, a grid "
               "barrier between squarings, stopping when a squaring "
               "changes nothing",
    "flash": "bf16: wgmma for S = Q K^T (smem x smem) and O += P V (P in "
             "registers, V MN-major in smem), TMA-fed K/V ring of 2 stages "
             "on mbarriers, 2 consumer warpgroups x 64 rows + 1 producer "
             "warp, heavy causal q-tiles first; float32: scalar FMAs",
    "scan": "fused: 1-4 threads a channel with its N states in registers, "
            "dt/x/B/C tiles of 16 steps staged in smem by cp.async, one "
            "pass over the sequence; Pallas contract: one thread per "
            "(channel, state)",
}


def sass_counts(lib_path: str, kernel_substr: str) -> dict:
    """HGMMA (wgmma) and HMMA (mma.sync) instructions in the SASS of the
    functions of a built library whose name holds ``kernel_substr``, from
    ``cuobjdump -sass``."""
    from repro_torch.kernels import _build
    tool = os.path.join(os.path.dirname(_build.nvcc()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", lib_path], capture_output=True,
                          text=True, timeout=120, check=True).stdout
    counts = {"HGMMA": 0, "HMMA": 0}
    for func in sass.split("Function : ")[1:]:
        if kernel_substr in func.splitlines()[0]:
            for line in func.splitlines():
                for op in counts:
                    if f" {op}." in line or f" {op} " in line:
                        counts[op] += 1
    return counts


class SmokeFailure(AssertionError):
    pass


def check(cond, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


# each phase's wall time, by the phase's number
PHASE_S: dict = {}


def phase(name: str):
    """Context manager printing a phase's wall time when it ends (and
    keeping it in ``PHASE_S``)."""
    class _P:
        def __enter__(self):
            self.t0 = time.perf_counter()
            print(f"== {name}", flush=True)
            return self

        def __exit__(self, *exc):
            if exc[0] is None:
                secs = time.perf_counter() - self.t0
                PHASE_S[name.split()[0]] = secs
                print(f"== {name}: ok in {secs:.3f} s", flush=True)
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


def device_ms(fn, calls: int = 1, name: str | None = None):
    """Summed device time (ms) of every kernel ``calls`` runs of ``fn``
    launch (only those whose name holds ``name``, if given), per run, from
    a ``torch.profiler`` trace of the card; ``None`` when the trace holds
    no device time.  ``fn`` must be warm already.
    After phase 5's long traces the sums for one flash launch came out
    short (0.56 ms for a 2.2 ms kernel) while a fresh process's trace
    agreed with CUDA events, so the flash kernel's own time comes from
    ``fenced_ms`` and the decode tick's from ``graph_ms``."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    total_us = sum(e.self_device_time_total for e in prof.key_averages()
                   if name is None or name in e.key)
    return total_us / 1e3 / calls if total_us > 0 else None


def device_profile(fn):
    """``(busy ms, device ops)`` of one run of ``fn`` from one
    ``torch.profiler`` trace of the card: the summed device time of its
    kernels, copies and fills (``None`` when the trace holds none), and
    how many it issued.  One trace for both: processing a trace of ~180k
    device ops takes tens of seconds."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if e.self_device_time_total > 0]
    busy_us = sum(e.self_device_time_total for e in events)
    return (busy_us / 1e3 if busy_us > 0 else None,
            sum(e.count for e in events))


def fenced_ms(fn, samples: int = 10):
    """Median device time (ms) of one call of ``fn``, host gaps excluded:
    a spin kernel (``torch.cuda._sleep``) holds the stream for three times
    the host's enqueue time of one call, so the whole call is queued behind
    it before the first of the two CUDA events around the call is reached.
    ``fn`` must be warm and must not wait for the device.  Only for a call
    of a few launches: thousands of launches fill the queue of pending
    launches behind the spin kernel and the host's issue time leaks in.
    The reading carries the floor of the events themselves, which
    ``fenced_ms(lambda: None)`` measures."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    host_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    torch.cuda._sleep(1_000_000)
    b.record()
    b.synchronize()
    cycles_per_ms = 1e6 / a.elapsed_time(b)
    spin = int(max(3 * host_ms, 0.5) * cycles_per_ms)
    out = []
    for _ in range(samples):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(spin)
        a.record()
        fn()
        b.record()
        b.synchronize()
        out.append(a.elapsed_time(b))
    return statistics.median(out)


def graph_ms(fn, samples: int = 5):
    """Device time (ms) of one call of ``fn`` with no host in it: ``fn``
    is captured once in a CUDA graph, and the graph, one launch on the
    host, is timed by ``fenced_ms``.  Also returns the per-call time of
    back-to-back replays.  ``fn`` must be warm, and capturable: no host
    sync and no copy from the host."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    graph.replay()
    torch.cuda.synchronize()
    one = fenced_ms(graph.replay, samples=samples)
    back_to_back = cuda_ms(graph.replay, warmup=1, repeats=samples, inner=5)
    del graph
    torch.cuda.synchronize()
    return one, back_to_back


def attention_work(b, sq, skv, h, kv, dh, causal, q_offset, itemsize):
    """(bytes, operations) attention must move and do on these inputs:
    q, k, v read once and o written once; 4 * Dh operations (two products)
    for every (query, key) pair the mask keeps."""
    if causal:
        pairs = sum(max(0, min(skv, i + q_offset + 1)) for i in range(sq))
    else:
        pairs = sq * skv
    nbytes = itemsize * dh * b * (2 * sq * h + 2 * skv * kv)
    return nbytes, 4 * b * h * dh * pairs


def scan_work(b, s, d, n, fused: bool):
    """(bytes, float32 operations, exps) of one selective scan: each input
    read once and each output written once; per (t, d, n) the FMA of the
    recurrence (2), h * c and its share of the N-lane sum (2), and for the
    fused entry dt * A, (dt * x) * B (2 more) and one exp, plus dt * x per
    (t, d)."""
    if fused:
        nbytes = 4 * (3 * b * s * d + 2 * b * s * n + d * n + 2 * b * d * n)
        return nbytes, 6 * b * s * d * n + b * s * d, b * s * d * n
    return 4 * (2 * b * s * d * n + b * s * n + b * s * d), \
        4 * b * s * d * n, 0


def minplus_bound(n, squarings, apsp=False):
    """(bound ms, "bytes" or "operations") of ``squarings`` n^3 float32
    min-plus products: the larger of the bytes (one product: two operands
    in, one out; an APSP: the matrix in, the distances out) over HBM
    bandwidth and the instructions over the CUDA cores' issue rate."""
    nbytes = 4 * n * n * (2 if apsp else 3)
    by_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    by_ops = squarings * n ** 3 * MINPLUS_INSTR_PER_PAIR / INSTR_PER_S * 1e3
    return max(by_bytes, by_ops), ("bytes" if by_bytes >= by_ops
                                   else "operations")


def squarings_needed(dist) -> int:
    """Squarings an APSP of these hop distances needs: after s squarings
    every path of up to 2^s edges is found, so ceil(log2 diameter).  The
    kernel runs one more, which changes nothing and stops it."""
    diameter = float(dist[dist.isfinite()].max())
    return math.ceil(math.log2(diameter)) if diameter > 1 else 0


def counted(kern, fn):
    """(fn's result, the launches of each of ``kern``'s entries that fn
    made): the counts read just before and just after the call."""
    before = kern.launch_counts()
    out = fn()
    after = kern.launch_counts()
    return out, {k: after[k] - before[k] for k in after
                 if after[k] != before[k]}


def max_abs_err(got, want) -> float:
    """Largest |got - want| (tensors) where ``want`` is finite; 0.0 if no
    entry is."""
    fin = want.isfinite()
    if not bool(fin.any()):
        return 0.0
    return float((got[fin] - want[fin]).abs().max())


def bound(nbytes, ops, exps=0):
    """(bound ms, "bytes" or "operations"): the larger of the bytes over
    HBM bandwidth and the operations over their peak rate."""
    by_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    by_ops = max(ops / PEAK_F32_OPS_PER_S, exps / PEAK_SFU_PER_S) * 1e3
    return max(by_bytes, by_ops), ("bytes" if by_bytes >= by_ops
                                   else "operations")


def serve_run(serve_launch, argv, kernels, label):
    """The launcher at full width with every kernel's launch count reset
    just before (the caller reads them just after): 16 answers of 17
    tokens, each in the vocabulary.  Returns (run, seconds from the
    launcher's start, peak device bytes)."""
    import torch
    for kern in kernels:
        kern.reset_launch_count()
    t_main = time.perf_counter()
    served = serve_launch.run(argv)
    main_s = time.perf_counter() - t_main
    peak = torch.cuda.max_memory_allocated()
    loop = served.loop
    print(f"[serve] {len(served.results)} requests, {served.tokens} "
          f"tokens, {served.tokens / served.seconds:.1f} tok/s "
          f"({loop.slots} slots)")
    check(sorted(r.rid for r in served.results) == list(range(16)),
          f"{label}: answers do not match the requests")
    for r in served.results:
        check(len(r.tokens) == 17 and r.decode_steps == 16,
              f"{label}: request {r.rid} has {len(r.tokens)} tokens")
        check(all(0 <= t < loop.api.cfg.vocab for t in r.tokens),
              f"{label}: request {r.rid} has a token out of the vocab")
    return served, main_s, peak


def time_tick(loop) -> dict:
    """One decode step of every slot: per tick through Python (CUDA
    events, back to back), its device time as a CUDA graph and per replay
    back to back, and its kernels' summed time from a profiler trace."""
    import torch
    api, params = loop.api, loop.params
    step_tokens = torch.zeros((loop.slots, 1), dtype=torch.int32,
                              device=loop.device)
    tick = lambda: api.decode_step(params, step_tokens, loop.cache)
    t = {"tick_ms": cuda_ms(tick, warmup=2, repeats=5, inner=5)}
    t["tick_graph_ms"], t["tick_graph_call_ms"] = graph_ms(tick)
    t["tick_kernels_ms"] = device_ms(tick)
    print(f"decode tick ({loop.slots} slots): {t['tick_ms']:.6f} ms per "
          f"tick; as a CUDA graph: device time {t['tick_graph_ms']} ms, "
          f"{t['tick_graph_call_ms']:.6f} ms per replay back to back; its "
          f"kernels' summed time (profiler) {t['tick_kernels_ms']} ms")
    return t


def long_prefill(loop, plain: str, tol: float) -> dict:
    """One LONG_PROMPT-token prompt through the prefill with the kernel
    and with the ``plain`` backend, in turns; their last-position logits
    must agree within ``tol`` of the largest |logit|."""
    import numpy as np
    import torch
    api, params, dev = loop.api, loop.params, loop.device
    prompt = np.random.RandomState(0).randint(1, api.cfg.vocab, LONG_PROMPT)
    batch = {"tokens": torch.from_numpy(prompt[None]).to(dev)}
    logits, prefill_ms = {}, {}
    for backend in ("kernel", plain, "kernel", plain):
        cache = api.init_cache(1, 2 * LONG_PROMPT, device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out, cache = api.prefill(params, batch, cache, backend=backend)
        torch.cuda.synchronize()
        prefill_ms.setdefault(backend, []).append(
            (time.perf_counter() - t0) * 1e3)
        logits[backend] = out[0, -1].float()
        del cache
    a, b = logits["kernel"], logits[plain]
    check(bool(torch.isfinite(a).all()), "long prefill: logits not finite")
    diff = float((a - b).abs().max())
    scale = float(b.abs().max())
    cos = float(torch.nn.functional.cosine_similarity(a, b, dim=0))
    print(f"prefill of {LONG_PROMPT} tokens: kernel {prefill_ms['kernel']} "
          f"ms, {plain} {prefill_ms[plain]} ms (host clock, synchronised); "
          f"last-position logits: max |kernel - {plain}| {diff} of max "
          f"|logit| {scale}, cosine {cos}, same argmax "
          f"{int(a.argmax()) == int(b.argmax())}")
    check(diff <= tol * scale,
          f"long prefill: logits differ by {diff} > {tol} x {scale}")
    return {"prefill_ms": prefill_ms, "long_logits_max_abs_diff": diff,
            "long_logits_max_abs": scale}


def mamba_depth_witness(loop) -> dict:
    """Where the Mamba long prefill's logit spread comes from.  The same
    LONG_PROMPT-token prompt walks the layers in three residual streams:
    through the kernel, through the chunked scan (chunks of 128, the plain
    version ``long_prefill`` holds the kernel against) and through the
    chunked scan in chunks of 64 (the plain version in another summation
    order).  At every layer the kernel also runs on the chunked stream's
    own input, and its scan's end state must agree with the chunked
    scan's within SCAN_TOL (one layer's scan alone, same activations).
    Prints each stream's largest difference from the chunked stream, as a
    share of its largest |value|, at depths 1, 2, 4, ... and in the
    last-position logits."""
    import functools
    from unittest import mock

    import numpy as np
    import torch
    from repro_torch.models import layers, ssm
    params, cfg, dev = loop.params, loop.api.cfg, loop.device
    prompt = np.random.RandomState(0).randint(1, cfg.vocab, LONG_PROMPT)
    h0 = torch.zeros((1, cfg.d_inner, cfg.ssm_state), dtype=torch.float32,
                     device=dev)
    chunk_64 = functools.partial(ssm.fused_scan_ref, chunk=64)

    def mix(layer, x, backend):
        return ssm.mamba_mix(layer.mamba, layers.rmsnorm(layer.ln, x), cfg,
                             h0, backend=backend)

    def spread(a, b):
        return float((a.float() - b.float()).abs().max()
                     / b.float().abs().max())

    depth, state_err, flips = {}, [], []
    with torch.no_grad():  # the parameters require grad
        x = layers.embed(params.embed, torch.from_numpy(prompt[None]).to(dev))
        xs = {"kernel": x, "chunked": x, "chunked_64": x}
        for i, layer in enumerate(params.layers, start=1):
            y_c, st_c = mix(layer, xs["chunked"], "chunked")
            y_k, st_k = mix(layer, xs["chunked"], "kernel")
            err = float((st_k["h"] - st_c["h"]).abs().max())
            check(torch.allclose(st_k["h"], st_c["h"], **SCAN_TOL),
                  f"depth witness: layer {i}'s kernel scan state differs "
                  f"from the chunked scan's by {err} on the same input")
            state_err.append(err)
            flips.append(float((y_k != y_c).float().mean()))
            with mock.patch.object(ssm, "fused_scan_ref", chunk_64):
                y_64 = mix(layer, xs["chunked_64"], "chunked")[0]
            xs = {"kernel": xs["kernel"]
                  + mix(layer, xs["kernel"], "kernel")[0],
                  "chunked": xs["chunked"] + y_c,
                  "chunked_64": xs["chunked_64"] + y_64}
            if i & (i - 1) == 0 or i == len(params.layers):
                depth[i] = {k: spread(xs[k], xs["chunked"])
                            for k in ("kernel", "chunked_64")}
        logits = {k: layers.unembed(
                      params.unembed, params.embed,
                      layers.rmsnorm(params.final_norm, v[:, -1:]),
                      cfg)[0, -1].float()
                  for k, v in xs.items()}
    out = {"scan_state_max_abs_err": max(state_err),
           "block_output_flip_share": max(flips),
           "residual_spread_by_depth": depth,
           "logit_spread": {k: spread(logits[k], logits["chunked"])
                            for k in ("kernel", "chunked_64")}}
    print(f"depth witness ({LONG_PROMPT} tokens): on the same input the "
          f"kernel's scan end state is within {out['scan_state_max_abs_err']}"
          f" of the chunked scan's at all {len(state_err)} layers, and at "
          f"most {out['block_output_flip_share']} of a block's bf16 outputs "
          f"differ; residual stream against the chunked stream, as a share "
          f"of its max |x|, by depth: {depth}; last-position logits: "
          f"{out['logit_spread']}")
    return out


def states_match(gpu, cpu, label: str) -> None:
    """Int/bool leaves equal, float leaves within RTOL (NaN == NaN)."""
    import torch
    for name, a, b in zip(gpu._fields, gpu, cpu):
        a, b = a.cpu(), b.cpu()
        check(a.shape == b.shape and a.dtype == b.dtype,
              f"{label}: SimState.{name} shape/dtype differ")
        if a.dtype.is_floating_point:
            ok = torch.allclose(a, b, rtol=RTOL, atol=0.0, equal_nan=True)
        else:
            ok = torch.equal(a, b)
        check(ok, f"{label}: SimState.{name} differs between CUDA and CPU")


def cell_matches_single(packed, single, meta, topo, label: str) -> None:
    """One cell of a packed grid against the same scenario's own single
    run: every leaf equal on its unpadded prefix (node pairs mapped back
    to the scenario's numbering), and the pad slots inert: pad tasks and
    packets VOID with no VM, route or time, pad hosts and switches at 0 J.
    """
    import torch
    from repro_torch.core.mapreduce import VOID
    hosts, switches, nodes = meta.n_hosts, meta.n_switches, meta.n_nodes

    def own_ids(ids):
        return torch.where(ids < hosts, ids, torch.where(
            ids < hosts + switches, ids - hosts + topo.n_hosts,
            ids - hosts - switches + topo.n_hosts + topo.n_switches))

    for name, a, b in zip(single._fields, packed, single):
        a = a.cpu()
        if name == "pkt_pair":
            a = torch.where(a >= 0, own_ids(a // nodes) * topo.n_nodes
                            + own_ids(a % nodes), -1).to(a.dtype)
        prefix = a[tuple(slice(0, n) for n in b.shape)]
        check(torch.equal(prefix.nan_to_num(-7.0), b.cpu().nan_to_num(-7.0)),
              f"{label}: SimState.{name} differs from the single run")
    n_t, n_p = single.task_state.shape[0], single.pkt_state.shape[0]
    for name, n, void in (("task_state", n_t, VOID), ("pkt_state", n_p, VOID),
                          ("task_vm", n_t, -1), ("pkt_pair", n_p, -1)):
        check(bool((getattr(packed, name)[n:] == void).all()),
              f"{label}: a pad slot of {name} moved")
    check(bool(packed.task_start[n_t:].isnan().all())
          and bool(packed.pkt_finish[n_p:].isnan().all()),
          f"{label}: a pad slot has a time")
    check(not bool(packed.host_energy[topo.n_hosts:].any())
          and not bool(packed.switch_energy[topo.n_switches:].any()),
          f"{label}: a pad host or switch drew energy")


def phase10_policies(kind: str):
    """Phase 10's named policies for a registry entry or an xl cell:
    {SDN reactive, SDN proactive, legacy} (and SDN with migration on a
    cell whose controller arms it), or {SDN, legacy} × speculation {off,
    on}; job_concurrency 2 on the registry entries, as
    tests/test_torch_ctrlplane.py and tests/test_torch_chaos.py run them,
    and 4, the profile policy's, on xl."""
    from repro_torch.api import PolicyConfig
    from repro_torch.core import (INSTALL_PROACTIVE, MIG_CONGESTION,
                                  ROUTE_LEGACY, ROUTE_SDN, SPEC_OFF, SPEC_ON)
    grid = {**PHASE10_GRIDS, **PHASE10_XL}[kind]
    if grid == "chaos":
        lanes = [(f"{r}{'-spec' if sp == SPEC_ON else ''}",
                  dict(routing=rv, speculation=sp))
                 for r, rv in (("sdn", ROUTE_SDN), ("legacy", ROUTE_LEGACY))
                 for sp in (SPEC_OFF, SPEC_ON)]
    else:
        lanes = [("sdn", dict(routing=ROUTE_SDN)),
                 ("sdn-proactive", dict(routing=ROUTE_SDN,
                                        install_mode=INSTALL_PROACTIVE)),
                 ("legacy", dict(routing=ROUTE_LEGACY))]
        if grid == "ctrl+mig":
            lanes.append(("sdn-migrate", dict(routing=ROUTE_SDN,
                                              migration=MIG_CONGESTION)))
    conc = 4 if kind in PHASE10_XL else 2
    return [(n, PolicyConfig(job_concurrency=conc, **k)) for n, k in lanes]


def phase10_scenario(kind: str):
    """Phase 10's scenario: a registry name, or leaf-spine-xl with
    leaf-spine-ctrl's own controller and ``XL_CTRL_JOBS`` jobs
    (``xl-ctrl``) or at its registered size with leaf-spine-chaos's own
    gray host slowdowns and 2 clone slots a job (``xl-chaos``)."""
    if kind in PHASE10_GRIDS:
        return kind
    from repro_torch.scenarios import get_scenario
    from repro_torch.scenarios.failures import random_degradation
    if kind == "xl-ctrl":
        return dataclasses.replace(
            get_scenario("leaf-spine-xl", n_jobs=XL_CTRL_JOBS),
            ctrl=get_scenario("leaf-spine-ctrl").ctrl)
    xl = get_scenario("leaf-spine-xl")
    return dataclasses.replace(xl, spec_slots=2, degradation=(
        lambda topo: random_degradation(topo, host_rate=2e-3,
                                        mean_factor=0.3, mttr=400.0,
                                        horizon=2000.0, seed=1)))


def cpu_reference(kind: str):
    """Phase 10's run of ``kind`` on the CPU, in a worker process started
    with the script: the final states ``[1, P, ...]`` and the seconds."""
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import torch
    torch.set_num_threads(2)
    from repro_torch.api import Experiment
    t0 = time.perf_counter()
    res = Experiment(phase10_scenario(kind), phase10_policies(kind),
                     device="cpu").run()
    return res.states, time.perf_counter() - t0


def count_syncs(fn) -> int:
    """Host syncs the CUDA runtime reports while ``fn`` runs
    (``torch.cuda.set_sync_debug_mode``: a warning for each copy to the
    host and each blocking call)."""
    import warnings
    import torch
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            fn()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    return sum("synchroniz" in str(w.message) for w in caught)


def ctrl_conserved(states, label: str) -> None:
    """The flow tables' conservation law on every lane, ``occupied ==
    installs - evictions``, and no packet left parked INSTALLING."""
    import torch
    from repro_torch.core.mapreduce import INSTALLING
    occupied = (states.ftab_pair >= 0).sum((-2, -1), dtype=torch.int32)
    check(torch.equal(occupied, states.ctrl_installs - states.ctrl_evictions),
          f"{label}: flow tables hold {occupied.tolist()} rules, installs "
          f"less evictions are "
          f"{(states.ctrl_installs - states.ctrl_evictions).tolist()}")
    check(not bool((states.pkt_state == INSTALLING).any()),
          f"{label}: a packet is left INSTALLING")


def fleet_grid(device):
    """Phase 11(a): ``benchmarks/fleet_sweep.py``'s ``build_grid(512)`` on
    the port: paper-fabric × {legacy, SDN} × {least-used, round-robin} ×
    32 seeds (P = 128) × host-failure rates (S = 4)."""
    from repro_torch.api import Experiment
    from repro_torch.scenarios.failures import failure_injector
    pols = [(f"{rn}/{pn}/s{s}", dict(routing=r, placement=p, seed=s))
            for rn, r in (("legacy", 0), ("sdn", 1))
            for pn, p in (("least-used", 0), ("round-robin", 1))
            for s in range(FLEET_SEEDS)]
    fails = [(f"host{int(rate * 100)}pct",
              failure_injector(host_rate=rate, mttr=20.0, horizon=500.0))
             for rate in FLEET_FAIL_RATES]
    return Experiment("paper-fabric", pols, failures=fails, device=device)


def stream_policies():
    """``benchmarks/stream_sweep.py``'s two lanes, and a third in the SDN
    lane's cohort (the same routing, traffic and placement) at
    ``job_concurrency=8``: it retires and refills its ring slots at other
    times, so the cohort's streamed consts carry a lane axis of width 2."""
    from repro_torch.api import PolicyConfig
    from repro_torch.core import ROUTE_LEGACY, ROUTE_SDN
    return [("sdn", PolicyConfig(routing=ROUTE_SDN, job_concurrency=4)),
            ("legacy", PolicyConfig(routing=ROUTE_LEGACY,
                                    job_concurrency=4)),
            ("sdn-c8", PolicyConfig(routing=ROUTE_SDN, job_concurrency=8))]


def xl_stream(device):
    """Phase 11(d): ``leaf-spine-stream``'s arrival mix through
    ``leaf-spine-xl``'s fabric; the experiment and a run of the stream to
    ``horizon`` (by default the phase's, in its own ring geometry)."""
    from repro_torch.api import Experiment
    from repro_torch.scenarios.registry import stream_arrivals
    exp = Experiment("leaf-spine-xl", stream_policies(), device=device)

    def run(horizon=STREAM_HORIZON, spec=None):
        return exp.run_stream(
            stream_arrivals(rate=STREAM_RATE, seed=0), horizon,
            warmup=0.1 * horizon, slots=STREAM_SLOTS,
            chunk_steps=STREAM_CHUNK, spec=spec)
    return exp, run


def cpu_reference11(kind: str):
    """Phase 11's run of ``kind`` on the CPU, in a worker process started
    with the script: the grid's states, or the stream's stats and job
    rows, and the seconds."""
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import torch
    torch.set_num_threads(2)
    t0 = time.perf_counter()
    if kind == "fleet-grid":
        out = fleet_grid("cpu").run().states
    else:
        res = xl_stream("cpu")[1]()
        out = (vars(res.stats), res.jobs)
    return out, time.perf_counter() - t0


class LaneSpread:
    """Counts the ring generations ``run_stream`` uploads while it is
    entered, and those in which a cohort's first and last lanes held
    different jobs: a cohort of two or more lanes whose rings diverged,
    so its streamed consts' lane axis carried different rows."""

    def __enter__(self):
        from repro_torch.api import stream
        from repro_torch.core.streaming import STREAM_FIELDS
        self.uploads = self.diverged = 0
        self._stream, self._upload = stream, stream._upload

        def counted(consts0, host, dev):
            self.uploads += 1
            self.diverged += any(bool((host[f][0] != host[f][-1]).any())
                                 for f in STREAM_FIELDS)
            return self._upload(consts0, host, dev)
        stream._upload = counted
        return self

    def __exit__(self, *exc):
        self._stream._upload = self._upload
        return False


class StepCounter:
    """Counts the engine's events (``_step`` calls) while it is entered:
    a run's loop steps over every lane group, chunk and refill."""

    def __enter__(self):
        from repro_torch.core import engine
        self.n, self._engine, self._step = 0, engine, engine._step

        def counted(*args, **kw):
            self.n += 1
            return self._step(*args, **kw)
        engine._step = counted
        return self

    def __exit__(self, *exc):
        self._engine._step = self._step
        return False


def stream_ledger(res, label: str) -> None:
    """``tests/invariants.py::check_stream`` on a ``StreamResults``: every
    arrival loads and retires exactly once a lane, the refill count
    balances, job stamps are ordered and boundary clocks and cumulative
    energy never go backwards.  A job is released at its arrival instant
    rounded to the engine's float32 clock, so admission is held against
    that (the float32 spacing passes the 1e-4 slack above 2048 s)."""
    import numpy as np
    st, tol = res.stats, 1e-4
    check(st.loads == st.retired == st.trace_len * st.lanes,
          f"{label}: loads {st.loads}, retired {st.retired}, trace "
          f"{st.trace_len} x {st.lanes} lanes")
    check(st.refills == st.loads - min(st.slots, st.trace_len) * st.lanes,
          f"{label}: refill ledger broken")
    for pi in range(res.n_policies):
        j, smp = res.jobs[pi], res.samples[pi]
        check(np.array_equal(np.sort(j["seq"]), np.arange(st.trace_len)),
              f"{label}/{pi}: arrivals not retired exactly once")
        check(bool(np.all(np.isfinite(j["t_done"]))
                   and np.all(j["t_admit"] >= j["t_arr"].astype(np.float32)
                              - tol)
                   and np.all(j["t_done"] >= j["t_admit"] - tol)),
              f"{label}/{pi}: job stamps out of order")
        check(bool(np.all(np.diff(smp[:, 0]) >= -tol)
                   and np.all(np.diff(smp[:, 1:], axis=0) >= -1e-3)),
              f"{label}/{pi}: boundary samples went backwards")


def phase11(kernels, cpu_jobs) -> dict:
    """Phase 11: the fleet engine and the streaming ring on CUDA; returns
    the report."""
    import numpy as np
    import torch
    from repro_torch.api import Experiment, PolicyConfig, consts_cache_clear
    from repro_torch.core import (ROUTE_LEGACY, ROUTE_SDN, TRAFFIC_WATERFILL,
                                  PLACE_ROUND_ROBIN)
    from repro_torch.core.streaming import RingSpec, ring_setup
    from repro_torch.scenarios import get_scenario
    from repro_torch.scenarios.arrivals import TraceArrivals
    from repro_torch.scenarios.registry import stream_arrivals
    minplus_kernel = kernels[0]
    report = {}

    def start():
        consts_cache_clear()      # build the scenario's route table anew
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for kern in kernels:
            kern.reset_launch_count()

    def launches(label):
        mp = minplus_kernel.launch_counts()
        other = sum(k.launch_count() for k in kernels[1:])
        check(mp == {"minplus_f32": 0, "apsp_f32": 1},
              f"{label}: min-plus launches {mp}, expected one apsp_f32")
        check(other == 0, f"{label} launched flash or the scan")
        return mp["apsp_f32"]

    # (a) the 512-cell fleet grid
    start()
    exp = fleet_grid("cuda")
    with StepCounter() as steps:
        t0 = time.perf_counter()
        fleet, fst = exp.run_fleet(width=32, chunk_steps=32,
                                   return_stats=True)
        torch.cuda.synchronize()
        fleet_s = time.perf_counter() - t0
    apsp_a = launches("fleet grid")
    t0 = time.perf_counter()
    serial = exp.run()
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    check(fleet.states.time.device.type == "cuda",
          "the fleet did not run on CUDA")
    sims = len(fleet)
    check(sims == fst.sims == 512, f"the grid has {sims} cells")
    states_match(fleet.states, serial.states, "fleet grid against run()")
    cpu_states, cpu_s = cpu_jobs["fleet-grid"].get()
    states_match(fleet.states, cpu_states, "fleet grid against the CPU")
    report["fleet_grid"] = {
        "stats": vars(fst), "fleet_s": fleet_s, "run_s": run_s,
        "fleet_sims_per_s": sims / fleet_s, "run_sims_per_s": sims / run_s,
        "fleet_loop_steps": steps.n, "apsp_launches": apsp_a,
        "cpu_run_s": cpu_s,
        "max_lane_steps": int(fleet.states.steps.max())}
    print(f"fleet grid {fleet.n_scenarios} x {fleet.n_policies}: {fst}; "
          f"run_fleet {fleet_s:.3f} s = {sims / fleet_s:.1f} sims/s "
          f"({steps.n} loop steps), run() {run_s:.3f} s = "
          f"{sims / run_s:.1f} sims/s; every cell equal to run() on CUDA "
          f"and to the CPU run ({cpu_s:.1f} s in a worker); apsp_f32 "
          f"launches {apsp_a}")

    # (b) leaf-spine-xl through the fleet: tests/test_fleet.py's slow case,
    # SDN x {least-used, round-robin}.  The legacy lanes' 7108 more loop
    # steps put the script over 1000 s of phases on a slow host; they go
    # before phase 10(b)'s lanes because each static signature is a cohort
    # of its own, a loop run after the others, while 10(b)'s four lanes
    # share one loop, whose step costs about what a one-lane step does.
    # Legacy routing still runs the fleet chunk on xl's fabric in (d)
    pols = [(f"sdn/{pn}", PolicyConfig(routing=ROUTE_SDN, placement=p))
            for pn, p in (("least-used", 0), ("round-robin", 1))]
    start()
    exp = Experiment("leaf-spine-xl", pols, device="cuda")
    with StepCounter() as steps:
        t0 = time.perf_counter()
        fleet, fst = exp.run_fleet(width=2, chunk_steps=64,
                                   return_stats=True)
        torch.cuda.synchronize()
        fleet_s = time.perf_counter() - t0
    apsp_b = launches("xl fleet")
    serial = exp.run()
    states_match(fleet.states, serial.states, "xl fleet against run()")
    report["xl_fleet"] = {
        "stats": vars(fst), "fleet_s": fleet_s, "loop_steps": steps.n,
        "steps_per_s": steps.n / fleet_s, "apsp_launches": apsp_b,
        "lane_steps": fleet.states.steps[0].tolist()}
    print(f"xl fleet {fleet.policy_names}: chunks {fst.chunks}, refills "
          f"{fst.refills}, cohorts {fst.cohorts}, lane steps "
          f"{report['xl_fleet']['lane_steps']}, {steps.n} loop steps in "
          f"{fleet_s:.3f} s = {steps.n / fleet_s:.1f} steps/s; equal to "
          f"run(); apsp_f32 launches {apsp_b}")

    # (c) a finite trace that fits the ring: run_stream == run() on its
    # ring_setup
    start()
    setup = get_scenario("leaf-spine", n_jobs=3).build("cuda")
    apsp_c = launches("leaf-spine ring")
    arrivals = TraceArrivals(jobs=tuple(setup.jobs))
    jobs = [a.job for a in arrivals.events(1e9)]
    cpols = [("sdn", PolicyConfig(routing=ROUTE_SDN, job_concurrency=2)),
             ("legacy", PolicyConfig(routing=ROUTE_LEGACY, job_concurrency=2,
                                     placement=PLACE_ROUND_ROBIN)),
             ("wfill", PolicyConfig(routing=ROUTE_SDN,
                                    traffic=TRAFFIC_WATERFILL, seed=1))]
    res = Experiment(("leaf-spine", setup), cpols, device="cuda").run_stream(
        arrivals, 1e9, slots=len(jobs), return_states=True)
    check(res.stats.refills == 0, "the finite trace refilled")
    rs = ring_setup(jobs, setup.cluster, RingSpec.for_jobs(
        jobs, slots=len(jobs)), route_table=setup.route_table)
    ref = Experiment(("ring", rs), cpols, device="cuda").run()
    for pi, (pname, _) in enumerate(cpols):
        states_match(res.final_states[pi], ref.state(0, pi),
                     f"finite trace {pname}")
    report["finite_trace"] = {"jobs": len(jobs), "apsp_launches": apsp_c}
    print(f"finite trace of {len(jobs)} jobs on leaf-spine: run_stream "
          f"equals run() on its ring_setup under {[n for n, _ in cpols]}")

    # (d) the stream at scale
    start()
    with StepCounter() as steps, LaneSpread() as spread:
        t0 = time.perf_counter()
        exp, stream = xl_stream("cuda")
        res = stream()
        torch.cuda.synchronize()
        stream_s = time.perf_counter() - t0
    apsp_d = launches("xl stream")
    peak = torch.cuda.max_memory_allocated()
    st = res.stats
    stream_ledger(res, "xl stream")
    check(st.refills >= 4 * st.slots * st.lanes,
          f"xl stream: {st.refills} refills, fewer than 4 x {st.slots} "
          f"slots a lane")
    check(st.cohorts < st.lanes and spread.diverged > 0,
          f"xl stream: no cohort of two lanes held different jobs "
          f"({st.cohorts} cohorts of {st.lanes} lanes)")
    cpu_out, cpu_s = cpu_jobs["xl-stream"].get()
    check(vars(st) == cpu_out[0], f"xl stream: stats {vars(st)} differ "
                                  f"from the CPU's {cpu_out[0]}")
    for pi in range(res.n_policies):
        got, want = res.jobs[pi], cpu_out[1][pi]
        check(np.array_equal(got["seq"], want["seq"])
              and np.array_equal(got["cls"], want["cls"]),
              f"xl stream {pi}: job rows differ from the CPU run")
        for k in ("t_arr", "t_admit", "t_done"):
            check(np.allclose(got[k], want[k], rtol=RTOL, atol=0.0),
                  f"xl stream {pi}: {k} differs from the CPU run")
    # the idle share's window: the same stream through run_stream again, in
    # the full trace's ring geometry, on its arrivals below
    # PROFILE_STREAM_HORIZON: unprofiled, under the profiler, counting syncs
    wspec = RingSpec.for_jobs([a.job for a in stream_arrivals(
        rate=STREAM_RATE, seed=0).events(STREAM_HORIZON)],
        slots=STREAM_SLOTS)

    def window():
        return stream(PROFILE_STREAM_HORIZON, wspec)
    check(window().meta == res.meta, "xl stream: the window's ring differs")
    torch.cuda.synchronize()
    with StepCounter() as wsteps:
        t0 = time.perf_counter()
        window()
        torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
    busy, ops = device_profile(window)
    idle_share = None if busy is None else 1 - busy / 1e3 / window_s
    syncs = count_syncs(window)
    summaries = {res.policy_names[pi]: res.summary(pi)
                 for pi in range(res.n_policies)}
    report["xl_stream"] = {
        "rate": STREAM_RATE, "horizon": STREAM_HORIZON, "stats": vars(st),
        "stream_s": stream_s, "loop_steps": steps.n,
        "steps_per_s": steps.n / stream_s,
        "jobs_per_s": st.retired / stream_s, "peak_mib": peak / 2**20,
        "apsp_launches": apsp_d, "cpu_run_s": cpu_s,
        "ring_uploads": spread.uploads,
        "diverged_uploads": spread.diverged,
        "profile_window": {"horizon": PROFILE_STREAM_HORIZON,
                           "steps": wsteps.n, "wall_s": window_s,
                           "busy_ms": busy, "idle_share": idle_share,
                           "host_syncs": syncs,
                           "syncs_per_step": syncs / wsteps.n,
                           "device_ops": ops,
                           "ops_per_step": ops / wsteps.n},
        "summary": summaries}
    print(f"xl stream at {STREAM_RATE} jobs/s to {STREAM_HORIZON} s: trace "
          f"{st.trace_len}, loads {st.loads}, refills {st.refills}, chunks "
          f"{st.chunks}, {steps.n} loop steps in {stream_s:.3f} s = "
          f"{steps.n / stream_s:.1f} steps/s, {st.retired / stream_s:.2f} "
          f"jobs/s of wall; peak device memory {peak / 2**20:.1f} MiB; "
          f"apsp_f32 launches {apsp_d}; {spread.diverged} of "
          f"{spread.uploads} ring generations held different jobs in one "
          f"cohort's lanes; window to {PROFILE_STREAM_HORIZON} s, "
          f"{wsteps.n} events: "
          f"{window_s * 1e3:.3f} ms, device busy {busy} ms, idle share "
          f"{idle_share}, {syncs} host syncs ({syncs / wsteps.n:.2f} a "
          f"step), {ops} device ops ({ops / wsteps.n:.1f} a step); ledger "
          f"held; equal to its CPU run ({cpu_s:.1f} s in a worker)")
    for name, sm in summaries.items():
        print(f"  {name}: p50 sojourn {sm['p50_sojourn_s']} s, p99 "
              f"{sm['p99_sojourn_s']} s, SLO attainment "
              f"{ {c: v['attainment'] for c, v in sm['classes'].items()} }, "
              f"energy {sm['energy_j']} J, {sm['jobs_done']} jobs after "
              f"warmup")
    return report



def cpu_reference12(kind: str):
    """Phase 12's run of ``kind`` on the CPU, in a worker process started
    with the script: the advice of every mesh and size, or the ingest
    job's final states, and the seconds."""
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import torch
    torch.set_num_threads(2)
    from repro_torch.roofline import advise_allreduce
    t0 = time.perf_counter()
    if kind == "advisor":
        out = {(mesh, nbytes): [(a.schedule, a.predicted_s, a.source)
                                for a in advise_allreduce(nbytes, mesh,
                                                          device="cpu")]
               for mesh in ADVISOR_MESHES for nbytes in ADVISOR_BYTES}
    else:
        out = ingest_experiment("cpu").run().states
    return out, time.perf_counter() - t0


def ingest_experiment(device):
    """Phase 12's data twin: ``pipeline_jobs(**INGEST)`` as the workload of
    leaf-spine-xl's fabric and cluster, under SDN and legacy routing at
    the profile policy's job concurrency."""
    from repro_torch.api import Experiment, PolicyConfig
    from repro_torch.core import ROUTE_LEGACY, ROUTE_SDN
    from repro_torch.data import pipeline_jobs
    from repro_torch.scenarios import get_scenario
    xl = dataclasses.replace(get_scenario("leaf-spine-xl"),
                             workload=lambda: pipeline_jobs(**INGEST))
    return Experiment(xl, [("sdn", PolicyConfig(routing=ROUTE_SDN,
                                                job_concurrency=4)),
                           ("legacy", PolicyConfig(routing=ROUTE_LEGACY,
                                                   job_concurrency=4))],
                      device=device)


def phase12(kernels, cpu_jobs) -> dict:
    """Phase 12: the advisor and the data twin on CUDA; returns the
    report."""
    from unittest import mock

    import torch
    from repro_torch.api import consts_cache_clear
    from repro_torch.roofline import V5E, advise_allreduce, analytic_time
    from repro_torch.roofline import advisor
    minplus_kernel = kernels[0]
    cpu_advice, cpu_s = cpu_jobs["advisor"].get()
    loops, setups = [], []
    real_setup, real_simulate = advisor.flows_setup, advisor.simulate

    def setup(*args, **kw):
        out, made = counted(minplus_kernel, lambda: real_setup(*args, **kw))
        setups.append(made)
        return out

    def simulate(*args, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state = real_simulate(*args, **kw)
        steps = int(state.steps)
        loops.append((steps, time.perf_counter() - t0))
        return state

    report = {"advisor": {}, "advisor_cpu_s": cpu_s}
    with mock.patch.object(advisor, "flows_setup", setup), \
            mock.patch.object(advisor, "simulate", simulate):
        for mesh in ADVISOR_MESHES:
            n = mesh[0] * mesh[1]
            for nbytes in ADVISOR_BYTES:
                for kern in kernels:
                    kern.reset_launch_count()
                loops.clear()
                setups.clear()
                t0 = time.perf_counter()
                got = advise_allreduce(nbytes, mesh, device="cuda")
                wall = time.perf_counter() - t0
                label = f"advise {mesh[0]}x{mesh[1]} {nbytes:g} B"
                want = cpu_advice[(mesh, nbytes)]
                check([(a.schedule, a.source) for a in got]
                      == [(w[0], w[2]) for w in want],
                      f"{label}: ranking {[a.schedule for a in got]} != the "
                      f"CPU run's {[w[0] for w in want]}")
                check(len(setups) == 3 and all(
                    m == {"apsp_f32": 1} for m in setups),
                    f"{label}: min-plus launches per flows_setup {setups}, "
                    f"expected one apsp_f32 each")
                check(kernels[1].launch_count() == 0
                      and kernels[2].launch_count() == 0,
                      f"{label}: launched flash or the scan")
                rows = []
                by_schedule = dict(zip(("ring", "ring-bidir", "torus2d"),
                                       loops))
                for a, w in zip(got, want):
                    an = analytic_time(a.schedule, n, nbytes, V5E, mesh)
                    err = abs(a.predicted_s - an) / an
                    check(math.isclose(a.predicted_s, w[1], rel_tol=RTOL),
                          f"{label} {a.schedule}: {a.predicted_s} s on CUDA,"
                          f" {w[1]} s on the CPU")
                    check(err <= ADVISOR_TOL, f"{label} {a.schedule}: DES "
                          f"{a.predicted_s} s is {err:.4%} off analytic {an}")
                    steps, secs = by_schedule[a.schedule]
                    rows.append({"schedule": a.schedule,
                                 "des_s": a.predicted_s, "analytic_s": an,
                                 "err": err, "steps": steps,
                                 "loop_s": secs, "steps_per_s": steps / secs})
                report["advisor"][label] = {"rows": rows, "wall_s": wall}
                print(f"{label}: ranking " + ", ".join(
                    f"{r['schedule']} {r['des_s']:.9g} s (analytic "
                    f"{r['analytic_s']:.9g}, {r['err']:.4%}; {r['steps']} "
                    f"steps in {r['loop_s']:.3f} s = {r['steps_per_s']:.1f} "
                    f"steps/s)" for r in rows) + f"; {wall:.3f} s in all, "
                    f"equal to the CPU run; one apsp_f32 launch a setup")
    print(f"the advisor's CPU runs: {cpu_s:.1f} s in a worker")

    # the data twin: one ingest job through the engine on xl's fabric
    consts_cache_clear()
    for kern in kernels:
        kern.reset_launch_count()
    exp = ingest_experiment("cuda")
    with StepCounter() as steps:
        res = exp.run()
    mp = minplus_kernel.launch_counts()
    check(mp == {"minplus_f32": 0, "apsp_f32": 1},
          f"ingest: min-plus launches {mp}, expected one apsp_f32")
    check(not bool(res.states.stalled.any()), "ingest: a lane stalled")
    want, _ = cpu_jobs["ingest"].get()
    states_match(res.states, want, "ingest")
    _, setup = exp.scenarios[0]
    jobs = {"n_shards": INGEST["n_shards"],
            "n_reducers": INGEST["n_reducers"],
            "shard_gbits": INGEST["shard_gbits"],
            "tasks": int(setup.task_valid.sum()),
            "packets": int(setup.pkt_valid.sum())}
    report["ingest"] = {**jobs, "loop_steps": steps.n, "apsp_launches": 1}
    print(f"ingest check on leaf-spine-xl ({jobs['n_shards']} shards of "
          f"{jobs['shard_gbits']} Gbit, {jobs['n_reducers']} reducers: "
          f"{jobs['tasks']} tasks, {jobs['packets']} packets): {steps.n} "
          f"loop steps, SDN and legacy equal to the CPU run; apsp_f32 "
          f"launches 1")
    return report


def tick_syncs(loop) -> int:
    """Host syncs of one serving tick that admits nothing: every slot is
    filled first, then one tick is counted (``count_syncs``)."""
    import numpy as np
    from repro_torch.serve import Request
    for r in range(len(loop.free)):
        loop.submit(Request(rid=10_000 + r, max_new=4,
                            prompt=np.arange(1, 9, dtype=np.int32)))
    loop._admit()
    check(not loop.free and not loop.queue, "tick_syncs: a slot is free")
    return count_syncs(loop.tick)


class RouteRecorder:
    """The experts ``moe.route`` chose ([T, k]) and the pairs it kept
    ([T, k] bool), in call order, while it is entered."""

    def __enter__(self):
        from repro_torch.models import moe
        self.experts, self.keep = [], []
        self._moe, self._route = moe, moe.route

        def recorded(*args, **kw):
            out = self._route(*args, **kw)
            self.experts.append(out[1])
            self.keep.append(out[2].reshape(out[1].shape))
            return out
        moe.route = recorded
        return self

    def __exit__(self, *exc):
        self._moe.route = self._route
        return False


def moe_depth_witness(loop, plain: str) -> dict:
    """Where a MoE model's long-prefill logit spread comes from.  The
    plain backend's residual stream walks the layers with the
    LONG_PROMPT-token prompt; at each layer the mixer (attention, or a
    Mamba block from a zero state) runs on that same input through the
    kernel and through the plain version, and the feed-forward runs on
    each result.  Per layer: the mixer's spread (the largest difference as
    a share of the plain output's largest |value|), which must be within
    the attention tolerance; for a MoE layer the share of (token, choice)
    pairs whose expert differs, and the layer output's spread over all
    tokens and over the tokens routed alike (the same experts, and the
    same pairs kept: one pair that changes expert can move another
    token's pair past its expert's capacity)."""
    import numpy as np
    import torch
    from repro_torch.models import attention as attn_mod
    from repro_torch.models import layers, ssm, transformer
    params, cfg, dev = loop.params, loop.api.cfg, loop.device
    prompt = np.random.RandomState(0).randint(1, cfg.vocab, LONG_PROMPT)

    def mixer(layer, h, backend):
        if hasattr(layer, "attn"):
            q, k, v = layers.qkv_project(layer.attn, h, cfg)
            q, k = transformer._rope(cfg, q, k, 0)
            return layers.out_project(layer.attn, attn_mod.attention(
                q, k, v, causal=True, backend=backend))
        h0 = torch.zeros((1, cfg.d_inner, cfg.ssm_state),
                         dtype=torch.float32, device=dev)
        return ssm.mamba_mix(layer.mamba, h, cfg, h0, backend=backend)[0]

    def spread(a, b):
        return float((a.float() - b.float()).abs().max()
                     / b.float().abs().max()) if a.numel() else 0.0

    rows = []
    with torch.no_grad(), RouteRecorder() as rec:
        x = layers.embed(params.embed, torch.from_numpy(prompt[None]).to(dev))
        for i, layer in enumerate(params.layers):
            h = layers.rmsnorm(layer.ln1, x)
            y = {b: mixer(layer, h, b) for b in ("kernel", plain)}
            row = {"layer": i,
                   "mixer": "attn" if hasattr(layer, "attn") else "mamba",
                   "mixer_spread": spread(y["kernel"], y[plain])}
            check(row["mixer_spread"] <= FA_TOL["bfloat16"],
                  f"depth witness: layer {i}'s {row['mixer']} through the "
                  f"kernel is {row['mixer_spread']} off the plain version "
                  f"on the same input")
            rec.experts.clear()
            rec.keep.clear()
            out = {}
            for b in ("kernel", plain):
                mid = x + y[b]
                out[b] = mid + transformer.ffn(
                    layer, layers.rmsnorm(layer.ln2, mid), cfg)[0]
            row["out_spread"] = spread(out["kernel"], out[plain])
            if rec.experts:
                ek, ep = rec.experts
                same = (ek == ep).all(-1) & (rec.keep[0]
                                             == rec.keep[1]).all(-1)
                row["flip_share"] = float((ek != ep).float().mean())
                row["routed_alike"] = float(same.float().mean())
                row["out_spread_same_experts"] = spread(
                    out["kernel"][0, same], out[plain][0, same])
            rows.append(row)
            x = out[plain]
    moe_rows = [r for r in rows if "flip_share" in r]
    out = {"layers": rows,
           "max_mixer_spread": max(r["mixer_spread"] for r in rows),
           "max_flip_share": max(r["flip_share"] for r in moe_rows),
           "max_out_spread": max(r["out_spread"] for r in rows),
           "max_out_spread_same_experts": max(
               r["out_spread_same_experts"] for r in moe_rows)}
    print(f"depth witness ({LONG_PROMPT} tokens, {len(rows)} layers, each "
          f"on the {plain} stream's input): mixer spread at most "
          f"{out['max_mixer_spread']}; experts differ on at most "
          f"{out['max_flip_share']} of a layer's (token, choice) pairs; "
          f"layer output spread at most {out['max_out_spread']} over all "
          f"tokens, {out['max_out_spread_same_experts']} over the tokens "
          f"routed alike; by layer (mixer spread; flips, share of tokens "
          f"routed alike, output spread all/alike): " + "; ".join(
              f"{r['layer']} {r['mixer']} {r['mixer_spread']:.3g}"
              + (f" {r['flip_share']:.3g} {r['routed_alike']:.3g} "
                 f"{r['out_spread']:.3g}/{r['out_spread_same_experts']:.3g}"
                 if "flip_share" in r else "") for r in rows))
    return out


def moe_serve(serve_launch, kernels, argv, label, want_params, want,
              plain) -> dict:
    """Phases 13 and 14: a MoE model at full width through the launcher
    with every kernel's launch count reset just before and read just after
    (``want``: the flash and fused-scan launches the path must make); its
    tick through Python and as a graph; the host syncs of a tick without
    an admission (exactly one); the depth witness, then the long prefill
    through the kernels against the ``plain`` backend, with the share of
    (token, choice) pairs whose expert differs at each MoE layer; peak
    device memory."""
    import torch
    minplus_kernel, fa_kernel, scan_kernel = kernels
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    served, main_s, serve_peak = serve_run(serve_launch, argv, kernels, label)
    made = {"flash": fa_kernel.launch_count(),
            "scan_fused": scan_kernel.launch_counts()[
                "selective_scan_fused_f32"],
            "scan_pallas": scan_kernel.launch_counts()["selective_scan_f32"],
            "minplus": minplus_kernel.launch_count()}
    check(made == {"flash": want["flash"], "scan_fused": want["scan"],
                   "scan_pallas": 0, "minplus": 0},
          f"{label}: launches {made}, expected {want} (and no min-plus)")
    loop = served.loop
    cfg = loop.api.cfg
    n_params = sum(p.numel() for p in loop.params.parameters())
    check(n_params == want_params,
          f"{label}: {n_params} parameters, expected {want_params}")
    report = {"arch": cfg.name, "n_layers": cfg.n_layers,
              "params": n_params, "launches": made,
              "tok_s": served.tokens / served.seconds,
              "seconds": served.seconds, "tokens": served.tokens,
              "launcher_s": main_s, "peak_gib": serve_peak / 2**30}
    print(f"{cfg.name} ({cfg.n_layers} layers, {n_params} parameters, "
          f"{cfg.dtype}): {main_s:.3f} s from the launcher's start to the "
          f"last token ({served.seconds:.3f} s serving), "
          f"{report['tok_s']:.1f} tok/s, launches {made}, peak device "
          f"memory {serve_peak / 2**30:.3f} GiB")
    report.update(time_tick(loop))
    report["tick_syncs"] = tick_syncs(loop)
    print(f"host syncs of a tick without an admission: "
          f"{report['tick_syncs']}")
    check(report["tick_syncs"] == 1, f"{label}: a tick without an admission"
          f" waited for the device {report['tick_syncs']} times, not once")
    report["depth_witness"] = moe_depth_witness(loop, plain)
    with RouteRecorder() as rec:
        report.update(long_prefill(loop, plain, LOGIT_TOL))
    runs = len(rec.experts) // 4     # MoE layers; kernel, plain, kernel, plain
    first = [rec.experts[i * runs:(i + 1) * runs] for i in range(4)]
    report["flip_share_by_layer"] = [
        float((a != b).float().mean()) for a, b in zip(first[0], first[1])]
    report["kernel_routing_repeats"] = all(
        torch.equal(a, b) for a, b in zip(first[0], first[2]))
    print(f"long prefill: share of (token, choice) pairs whose expert "
          f"differs, kernel against {plain}, by MoE layer: "
          f"{[round(f, 6) for f in report['flip_share_by_layer']]}; the two "
          f"kernel runs routed alike: {report['kernel_routing_repeats']}")
    report["phase_peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    print(f"peak device memory over the phase: "
          f"{report['phase_peak_gib']:.3f} GiB")
    del loop, served
    return report


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import multiprocessing
    import numpy as np

    from repro_torch.api import (Experiment, PolicyConfig,
                                 consts_cache_clear, runners)
    from repro_torch.core import ROUTE_LEGACY, ROUTE_SDN, TRAFFIC_WATERFILL
    from repro_torch.core.routing import hop_distances_np
    from repro_torch.core.topology import fat_tree
    from repro_torch.kernels.tropical_apsp import (apsp, apsp_early_stop_ref,
                                                   apsp_ref, minplus_matmul,
                                                   minplus_matmul_ref)
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     naive_attention)
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.kernels.selective_scan import (fused_scan_ref,
                                                    selective_scan,
                                                    selective_scan_fused,
                                                    selective_scan_ref)
    from repro_torch.kernels.selective_scan import kernel as scan_kernel
    from repro_torch.kernels.tropical_apsp import kernel as minplus_kernel
    from repro_torch.kernels import _build
    from repro_torch.launch import serve as serve_launch
    from repro_torch.models import layers as lm_layers
    from repro_torch.scenarios import get_scenario
    from repro_torch.scenarios.failures import failure_injector
    from repro_torch.scenarios.sweep import slice_packed

    # phase 10's CPU runs, which its CUDA runs are held against, start
    # now in two worker processes and overlap phases 2-9 (the xl
    # controller cell's CPU run alone takes minutes)
    CPU_POOL.append(multiprocessing.get_context("spawn").Pool(2))
    cpu_jobs = {kind: CPU_POOL[0].apply_async(cpu_reference, (kind,))
                for kind in (*PHASE10_XL, *PHASE10_GRIDS)}
    cpu_jobs.update({kind: CPU_POOL[0].apply_async(cpu_reference11, (kind,))
                     for kind in PHASE11_CPU})
    cpu_jobs.update({kind: CPU_POOL[0].apply_async(cpu_reference12, (kind,))
                     for kind in PHASE12_CPU})

    kernels = (minplus_kernel, fa_kernel, scan_kernel)
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
        def timed_build(kern):
            t0 = time.perf_counter()
            kern.build()
            return time.perf_counter() - t0
        with concurrent.futures.ThreadPoolExecutor(3) as pool:
            builds = {name: pool.submit(timed_build, kern) for name, kern in
                      (("minplus", minplus_kernel), ("flash", fa_kernel),
                       ("scan", scan_kernel))}
            build_s = builds["minplus"].result()
            fa_build_s = builds["flash"].result()
            scan_build_s = builds["scan"].result()
        print(f"minplus: built and loaded in {build_s:.3f} s")
        print(f"flash attention: built and loaded in {fa_build_s:.3f} s")
        print(f"selective scan: built and loaded in {scan_build_s:.3f} s "
              f"(the three nvcc runs at once)")

    scenarios = ("paper-fabric", "leaf-spine", "fat-tree", "canonical-tree",
                 "leaf-spine-xl")
    with phase("3 min-plus against its plain versions"):
        rng = np.random.RandomState(0)
        max_err = 0.0
        shapes = [(24, 24, 24), (37, 37, 37), (153, 153, 153),
                  (257, 257, 257), (1024, 1024, 1024), (1, 5, 3),
                  (100, 37, 153), (257, 1024, 24), (33, 65, 31),
                  (16, 16, 16), (17, 17, 17), (128, 300, 129), (129, 1, 127)]
        for m, k, n in shapes:
            x = rng.uniform(0, 10, (m, k)).astype(np.float32)
            y = rng.uniform(0, 10, (k, n)).astype(np.float32)
            x[rng.rand(m, k) < 0.1] = np.inf
            y[rng.rand(k, n) < 0.1] = np.inf
            xd, yd = torch.from_numpy(x).to(dev), torch.from_numpy(y).to(dev)
            want = minplus_matmul_ref(xd, yd)
            for tile in (None,) + minplus_kernel.TILES:
                got = minplus_kernel.minplus_f32(xd, yd, tile=tile)
                torch.cuda.synchronize()
                check(torch.equal(got, want),
                      f"minplus {m}x{k}x{n} tile {tile}: kernel != plain")
                max_err = max(max_err, max_abs_err(got, want))
            print(f"minplus {m}x{k}x{n}: bitwise equal at every tile "
                  f"(default {minplus_kernel.tile_for(m, n)})")
        squarings, apsp_err = {}, 0.0
        for name in scenarios:
            hop = get_scenario(name).topology().hop_matrix()
            want = torch.from_numpy(hop_distances_np(hop).astype(np.float32))
            hd = torch.from_numpy(hop).to(dev)
            got, made = counted(minplus_kernel, lambda: apsp(hd))
            ran = int(minplus_kernel.last_squarings())
            got = got.cpu()
            check(torch.equal(got, want),
                  f"apsp on {name}: != numpy hop distances")
            apsp_err = max(apsp_err, max_abs_err(got, want))
            check(made == {"apsp_f32": 1},
                  f"apsp on {name}: launches {made}, expected one apsp_f32")
            _, want_ran = apsp_early_stop_ref(hd)
            check(ran == want_ran, f"apsp on {name}: {ran} squarings, the "
                  f"plain loop runs {want_ran}")
            squarings[name] = ran
            print(f"apsp on {name} (n={hop.shape[0]}): equal to numpy in "
                  f"launches {made} of {ran} squarings")
        check(squarings["leaf-spine-xl"] == 3,
              f"leaf-spine-xl: {squarings['leaf-spine-xl']} squarings, "
              f"expected 3")
        floor_ms = fenced_ms(lambda: None)
        # times at the main path's shape: the route table of leaf-spine-xl
        xl_hop = torch.from_numpy(
            get_scenario("leaf-spine-xl").topology().hop_matrix()).to(dev)
        n = xl_hop.shape[0]
        tile = minplus_kernel.tile_for(n)
        mp_info = {f"{entry}/{t}": minplus_kernel.kernel_info(entry, t)
                   for entry in minplus_kernel.ENTRIES
                   for t in minplus_kernel.TILES}
        for key, occ in mp_info.items():
            print(f"minplus {key}: {occ['registers']} registers a thread, "
                  f"{occ['static_smem']} bytes of shared memory, "
                  f"{occ['blocks_per_sm']} blocks of {occ['threads']} "
                  f"threads an SM")
        xl_grid = minplus_kernel.persistent_grid("apsp_f32", tile, n, dev)
        print(f"tile at n = {n}: {tile} x {tile}, "
              f"{math.ceil(n / tile) ** 2} tiles; the APSP's persistent "
              f"grid: {xl_grid} blocks")
        d = apsp(xl_hop, steps=1)  # an operand of the second squaring
        kernel_call_ms = cuda_ms(lambda: minplus_matmul(d, d))
        plain_call_ms = cuda_ms(lambda: minplus_matmul_ref(d, d))
        kernel_ms = device_ms(lambda: minplus_matmul(d, d), calls=50)
        plain_ms = device_ms(lambda: minplus_matmul_ref(d, d), calls=50)
        kernel_fenced_ms = fenced_ms(lambda: minplus_matmul(d, d)) - floor_ms
        mp_bound = minplus_bound(n, 1)
        print(f"minplus {n}x{n}x{n} (tile {tile}): device time per call: "
              f"kernel {kernel_ms} ms (profiler), {kernel_fenced_ms} ms "
              f"(fenced less floor {floor_ms}), plain {plain_ms} ms; per "
              f"call through the wrapper (CUDA events, back to back): kernel"
              f" {kernel_call_ms:.6f} ms, plain {plain_call_ms:.6f} ms; "
              f"bound {mp_bound[0]:.6f} ms by {mp_bound[1]}")
        xl_got, xl_made = counted(minplus_kernel, lambda: apsp(xl_hop))
        xl_ran = int(minplus_kernel.last_squarings())
        xl_need = squarings_needed(xl_got)
        check(xl_ran == xl_need + 1, f"leaf-spine-xl: {xl_ran} squarings "
              f"for a need of {xl_need}, expected one more")
        xl_apsp = {"launches_per_call": xl_made, "squarings": xl_ran,
                   "squarings_needed": xl_need,
                   "max_abs_err": max_abs_err(xl_got,
                                              apsp_ref(xl_hop, steps=3)),
                   "call_ms": cuda_ms(lambda: apsp(xl_hop)),
                   "ms": fenced_ms(lambda: apsp(xl_hop)) - floor_ms,
                   "kernel_ms": device_ms(lambda: apsp(xl_hop), calls=20,
                                          name="apsp_kernel"),
                   "plain_ms": device_ms(lambda: apsp_ref(xl_hop, steps=3),
                                         calls=5),
                   "plain_call_ms": cuda_ms(
                       lambda: apsp_ref(xl_hop, steps=3), warmup=1,
                       repeats=5, inner=2)}
        xl_apsp["bound_ms"], xl_apsp["bound_by"] = minplus_bound(
            n, xl_need, apsp=True)
        # the squaring that confirms the distances: a cost of the design,
        # beside the bound and not in it
        xl_apsp["bound_as_run_ms"] = minplus_bound(n, xl_ran, apsp=True)[0]
        print(f"apsp on leaf-spine-xl (n = {n}, launches {xl_made}, "
              f"{xl_ran} squarings, {xl_need} needed): device time per "
              f"call {xl_apsp['ms']} ms (fenced less floor; the kernel "
              f"alone {xl_apsp['kernel_ms']} ms in a profiler trace), "
              f"{xl_apsp['call_ms']:.6f} ms through the wrapper back to "
              f"back; plain (3 squarings) {xl_apsp['plain_ms']} ms; bound "
              f"{xl_apsp['bound_ms']:.6f} ms by {xl_apsp['bound_by']} "
              f"({xl_apsp['bound_as_run_ms']:.6f} ms with the confirming "
              f"squaring)")

    with phase("3b min-plus at fat_tree(32) (n = 9473)"):
        ft_hop = torch.from_numpy(fat_tree(32).hop_matrix()).to(dev)
        nf = ft_hop.shape[0]
        ft_tile = minplus_kernel.tile_for(nf)
        ft = {"shape": [nf, nf], "tile": ft_tile,
              "grid": minplus_kernel.persistent_grid("apsp_f32", ft_tile, nf,
                                                     dev),
              "kernel_info": {e: minplus_kernel.kernel_info(e, ft_tile)
                              for e in minplus_kernel.ENTRIES}}
        got, ft_made = counted(minplus_kernel, lambda: apsp(ft_hop))
        ft_ran = int(minplus_kernel.last_squarings())
        ft_need = squarings_needed(got)
        check(ft_made == {"apsp_f32": 1}, f"fat_tree(32): launches "
              f"{ft_made}, expected one apsp_f32")
        check(ft_ran == 4 and ft_need == 3, f"fat_tree(32): {ft_ran} "
              f"squarings for a need of {ft_need}, expected 4 for 3")
        # the plain squarings one by one (apsp_ref's loop), kept to hold
        # the kernel's product against the second
        t0 = time.perf_counter()
        seq = [ft_hop]
        for _ in range(ft_ran):
            seq.append(minplus_matmul_ref(seq[-1], seq[-1]))
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
        want = seq[-1]
        check(torch.equal(got, want),
              "fat_tree(32): the kernel's distances != the plain version's")
        check(bool(torch.isfinite(want).all()) and float(want.max()) == 6,
              "fat_tree(32): not connected with diameter 6")
        ft_err = max_abs_err(got, want)
        print(f"fat_tree(32) (n = {nf}, tile {ft_tile}, grid {ft['grid']}): "
              f"apsp bitwise equal to the plain apsp_ref at {ft_ran} "
              f"squarings ({plain_s:.3f} s on the card), diameter 6")
        del got
        d = seq[1]
        prod, prod_made = counted(minplus_kernel,
                                  lambda: minplus_matmul(d, d))
        check(prod_made == {"minplus_f32": 1} and torch.equal(prod, seq[2]),
              f"fat_tree(32): the kernel's product != the plain version's "
              f"(launches {prod_made})")
        prod_err = max_abs_err(prod, seq[2])
        print(f"fat_tree(32): one product {nf}^3 bitwise equal to the "
              f"plain version's second squaring")
        del prod, seq[2:]
        fns = {"product": lambda: minplus_matmul(d, d),
               "apsp": lambda: apsp(ft_hop)}
        times = {key: [] for key in fns}
        for key in list(fns) + list(fns)[::-1]:
            times[key].append(cuda_ms(fns[key], warmup=1, repeats=2,
                                      inner=1))
        for key, fn in fns.items():
            _, made = counted(minplus_kernel, fn)
            need = 1 if key == "product" else ft_need
            bound_ms, bound_by = minplus_bound(nf, need,
                                               apsp=key == "apsp")
            ft[key] = {"ms": min(times[key]), "ms_all": times[key],
                       "products_needed": need, "bound_ms": bound_ms,
                       "bound_by": bound_by, "launches_per_call": made,
                       "share_of_bound": bound_ms / min(times[key])}
            print(f"fat_tree(32) {key}: {times[key]} ms (CUDA events, in "
                  f"turns), launches {made} a call, bound {bound_ms:.3f} "
                  f"ms by {bound_by} for {need} products: "
                  f"{ft[key]['share_of_bound']:.3f} of it")
        ft["product"]["max_abs_err"] = prod_err
        ft["apsp"]["squarings"] = ft_ran
        ft["apsp"]["bound_as_run_ms"] = minplus_bound(nf, ft_ran,
                                                      apsp=True)[0]
        ft["plain_s"] = plain_s
        del d, seq, ft_hop, want, fns
        gc.collect()
        torch.cuda.empty_cache()

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
                for kern in kernels:
                    kern.reset_launch_count()
            t_main = time.perf_counter()
            exp = Experiment(name, profile, device="cuda")
            t0 = time.perf_counter()
            res = exp.run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            if main_path:
                main_s = time.perf_counter() - t_main
                launches = minplus_kernel.launch_count()
                mp_launches = minplus_kernel.launch_counts()
                main_squarings = int(minplus_kernel.last_squarings())
                xl_fa_launches = fa_kernel.launch_count()
                xl_scan_launches = scan_kernel.launch_count()
                peak = torch.cuda.max_memory_allocated()
            steps = int(res.states.steps[0, 0])
            check(not bool(res.states.stalled[0, 0]), f"{name} stalled")
            check(steps == PROFILE_STEPS[name],
                  f"{name}: {steps} steps, expected {PROFILE_STEPS[name]}")
            rates[name] = steps / wall
            print(f"{name}: {steps} steps in {wall:.3f} s of engine run = "
                  f"{steps / wall:.1f} steps/s on CUDA")
            # device busy time over the first PROFILE_WINDOW_STEPS steps
            # (the whole run on the two small fabrics) run again under the
            # profiler, against the same window run unprofiled just before
            consts, meta = exp.build()
            loop = runners.get_runner(dataclasses.replace(
                meta, max_steps=PROFILE_WINDOW_STEPS), "policy_batch")
            window = lambda: loop(consts, exp.policy_arrays())  # noqa: E731
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            window_steps = int(window().steps.max())
            window_s = time.perf_counter() - t0
            busy = device_ms(window)
            idle[name] = None if busy is None else 1 - busy / 1e3 / window_s
            print(f"{name}: first {window_steps} steps: device busy {busy} "
                  f"ms of {window_s * 1e3:.3f} ms wall, idle share "
                  f"{idle[name]}")
            cpu = Experiment(name, profile, device="cpu").run()
            states_match(res.states, cpu.states, name)
            print(f"{name}: final state equals the CPU run")
            if main_path:
                healthy_xl = res.state(0, 0)
        check(mp_launches == {"minplus_f32": 0, "apsp_f32": 1}
              and main_squarings == 3,
              f"leaf-spine-xl's route table took min-plus launches "
              f"{mp_launches} of {main_squarings} squarings, expected one "
              f"apsp_f32 of 3")
        check(xl_fa_launches == 0, "the simulator launched flash attention")
        check(xl_scan_launches == 0, "the simulator launched the scan")
        print(f"leaf-spine-xl main path: {main_s:.3f} s from Experiment() "
              f"to the final state, minplus launches {launches} "
              f"({main_squarings} squarings), peak "
              f"device memory {peak / 2**20:.1f} MiB")

    with phase("6 flash attention against its plain version"):
        fa_occ = {str(dt).split(".")[-1]: fa_kernel.kernel_info(dt, 128)
                  for dt in (torch.bfloat16, torch.float32)}
        for name, occ in fa_occ.items():
            print(f"flash {name} kernel at Dh = 128: {occ['registers']} "
                  f"registers a thread, {occ['static_smem']} + "
                  f"{occ['dynamic_smem']} bytes of shared memory (static + "
                  f"dynamic), {occ['blocks_per_sm']} blocks of "
                  f"{occ['threads']} threads an SM")
        fa_sass = sass_counts(str(_build.library_path("flash_attention")),
                              "flash_fwd_tc_kernel")
        print(f"flash bf16 kernel SASS: {fa_sass['HGMMA']} HGMMA (wgmma), "
              f"{fa_sass['HMMA']} HMMA (mma.sync)")
        check(fa_sass["HGMMA"] + fa_sass["HMMA"] > 0,
              "the bf16 flash kernel has no tensor-core instruction")
        gen = torch.Generator(device="cpu").manual_seed(0)
        fa_shapes = [  # b, sq, skv, h, kv, dh, causal, q_offset, dtype
            # the reference's sweep (tests/test_kernels.py)
            (2, 64, 64, 4, 2, 32, True, 0, torch.float32),
            (1, 100, 100, 4, 4, 16, True, 0, torch.float32),
            (2, 1, 40, 4, 2, 16, False, 0, torch.float32),
            (1, 128, 256, 8, 2, 64, True, 128, torch.float32),
            (2, 64, 64, 4, 1, 128, True, 0, torch.bfloat16),
            (1, 48, 48, 2, 2, 64, False, 0, torch.bfloat16),
            # the serving path: qwen3-4b's heads, causal, q_offset 0
            (1, 32, 32, 32, 8, 128, True, 0, torch.bfloat16),
            (1, 1000, 1000, 32, 8, 128, True, 0, torch.bfloat16),
            (1, LONG_PROMPT, LONG_PROMPT, 32, 8, 128, True, 0,
             torch.bfloat16),
            # a chunk of queries after 1000 cached positions; float32 too
            (1, 500, 1500, 32, 8, 128, True, 1000, torch.bfloat16),
            (1, 1000, 1000, 32, 8, 128, True, 0, torch.float32),
            # the tensor-core kernel's tile edges (128 query rows, 64 keys
            # a tile): every Dh, GQA groups 1, 4 and 8, q_offset > 0 with
            # Sq < Skv, non-causal
            (1, 1, 1, 8, 8, 16, True, 0, torch.bfloat16),
            (1, 63, 63, 8, 2, 32, True, 0, torch.bfloat16),
            (1, 64, 129, 8, 1, 64, True, 65, torch.bfloat16),
            (2, 65, 127, 8, 2, 128, False, 0, torch.bfloat16),
            (1, 127, 1000, 8, 8, 128, True, 873, torch.bfloat16),
            (1, 129, 64, 8, 1, 16, False, 0, torch.bfloat16),
            (1, 1000, 1000, 8, 2, 64, True, 0, torch.bfloat16),
        ]
        fa_err = {}
        fa_inputs = {}
        for b, sq, skv, h, kv, dh, causal, off, dt in fa_shapes:
            q = torch.randn(b, sq, h, dh, generator=gen).to(dt).to(dev)
            k = torch.randn(b, skv, kv, dh, generator=gen).to(dt).to(dev)
            v = torch.randn(b, skv, kv, dh, generator=gen).to(dt).to(dev)
            got = flash_attention(q, k, v, causal=causal, q_offset=off)
            torch.cuda.synchronize()
            want = naive_attention(q, k, v, causal=causal, q_offset=off)
            tol = FA_TOL[str(dt).split(".")[-1]]
            err = float((got.float() - want.float()).abs().max())
            label = (f"flash {dt} b={b} sq={sq} skv={skv} h={h} kv={kv} "
                     f"dh={dh} causal={causal} q_offset={off}")
            check(bool(torch.isfinite(got).all()), f"{label}: not finite")
            check(torch.allclose(got.float(), want.float(), rtol=tol,
                                 atol=tol),
                  f"{label}: max |kernel - plain| {err} > {tol}")
            print(f"{label}: max abs err {err} (tol {tol})")
            if dt == torch.bfloat16 and sq == skv and h == 32 and causal:
                fa_err[sq] = err
                if sq in (32, LONG_PROMPT):
                    fa_inputs[sq] = (q, k, v)
        fa_times = {}
        floor_ms = fenced_ms(lambda: None)
        print(f"fenced_ms of an empty call (the events' floor, taken off "
              f"every fenced time below): {floor_ms} ms")
        for s_len, (q, k, v) in sorted(fa_inputs.items()):
            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
            fns = {
                "kernel": lambda: flash_attention(q, k, v, causal=True),
                "plain": lambda: naive_attention(q, k, v, causal=True),
                "sdpa": lambda: torch.nn.functional
                .scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                              enable_gqa=True),
            }
            t = {}
            for name, fn in fns.items():
                t[f"{name}_call_ms"] = cuda_ms(fn)
                t[f"{name}_fenced_ms"] = fenced_ms(fn)
                t[f"{name}_ms"] = t[f"{name}_fenced_ms"] - floor_ms
            nbytes, ops = attention_work(1, s_len, s_len, 32, 8, 128, True,
                                         0, 2)
            t["bound_bytes_ms"] = nbytes / PEAK_BYTES_PER_S * 1e3
            t["bound_ops_ms"] = ops / PEAK_BF16_OPS_PER_S * 1e3
            t["bound_ms"] = max(t["bound_bytes_ms"], t["bound_ops_ms"])
            t["bytes"], t["operations"] = nbytes, ops
            fa_times[s_len] = t
            print(f"flash S={s_len}: device time per call: kernel "
                  f"{t['kernel_ms']} ms, plain {t['plain_ms']} ms, sdpa "
                  f"{t['sdpa_ms']} ms; per call through the wrapper (CUDA "
                  f"events, back to back): kernel {t['kernel_call_ms']:.6f}"
                  f" ms, plain {t['plain_call_ms']:.6f} ms, sdpa "
                  f"{t['sdpa_call_ms']:.6f} ms; bound {t['bound_ms']:.6f} "
                  f"ms ({nbytes} bytes, {ops} operations)")

    with phase("7 LM serving at full width on CUDA (qwen3-4b)"):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        served, serve_main_s, serve_peak = serve_run(
            serve_launch, SERVE_ARGV, kernels, "serve")
        fa_launches = fa_kernel.launch_count()
        check(minplus_kernel.launch_count() == 0
              and scan_kernel.launch_count() == 0,
              "qwen3-4b's serving path launched min-plus or the scan")
        loop = served.loop
        cfg = loop.api.cfg
        n_params = sum(p.numel() for p in loop.params.parameters())
        check(fa_launches == cfg.n_layers * 16,
              f"serve: {fa_launches} flash launches, expected "
              f"{cfg.n_layers} layers x 16 prefills")
        serve = {"arch": "qwen3-4b",
                 "tok_s": served.tokens / served.seconds,
                 "seconds": served.seconds, "tokens": served.tokens,
                 "launcher_s": serve_main_s, "peak_gib": serve_peak / 2**30}
        print(f"qwen3-4b ({n_params} parameters, {cfg.dtype}): "
              f"{serve_main_s:.3f} s from the launcher's start to the last "
              f"token ({served.seconds:.3f} s serving), "
              f"{serve['tok_s']:.1f} tok/s, flash launches {fa_launches}, "
              f"peak device memory {serve_peak / 2**30:.3f} GiB")

        # where a serving tick goes, and the float32 unembedding inside it
        # against a bf16 product
        serve.update(time_tick(loop))
        params = loop.params
        xh = torch.randn(loop.slots, 1, cfg.d_model, generator=gen).to(
            cfg.dtype).to(dev)
        serve["unembed_f32_ms"] = cuda_ms(lambda: lm_layers.unembed(
            params.unembed, params.embed, xh, cfg))
        serve["unembed_bf16_ms"] = cuda_ms(lambda: xh @ params.unembed.w)
        print(f"float32 unembedding {serve['unembed_f32_ms']:.6f} ms per "
              f"call (a bf16 product would take "
              f"{serve['unembed_bf16_ms']:.6f} ms)")

        # one long prompt: the kernel against the plain attention
        serve.update(long_prefill(loop, "naive", LOGIT_TOL))
        serve["long_prefill_peak_gib"] = \
            torch.cuda.max_memory_allocated() / 2**30
        print(f"peak device memory over phase 7: "
              f"{serve['long_prefill_peak_gib']:.3f} GiB")
        del loop, served, params

    with phase("8 Mamba serving at full width on CUDA (falcon-mamba-7b)"):
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        gen = torch.Generator(device="cpu").manual_seed(1)

        def fused_inputs(bsz, s, d_in, n_st, h0_scale):
            """dt = softplus(U(-7, -2)), x, B, C ~ N(0, 1), A = -[1..N]
            (falcon-mamba's init), h0 ~ N(0, h0_scale^2)."""
            dt = torch.nn.functional.softplus(
                torch.rand(bsz, s, d_in, generator=gen) * 5 - 7)
            x = torch.randn(bsz, s, d_in, generator=gen)
            bmat = torch.randn(bsz, s, n_st, generator=gen)
            cmat = torch.randn(bsz, s, n_st, generator=gen)
            a_neg = -torch.arange(1, n_st + 1,
                                  dtype=torch.float32).repeat(d_in, 1)
            h0 = torch.randn(bsz, d_in, n_st, generator=gen) * h0_scale
            return [t.to(dev) for t in (dt, x, bmat, cmat, a_neg, h0)]

        def hold(label, got, want):
            torch.cuda.synchronize()
            check(bool(torch.isfinite(got).all()), f"{label}: not finite")
            err = float((got - want).abs().max())
            scale = float(want.abs().max())
            check(torch.allclose(got, want, **SCAN_TOL),
                  f"{label}: kernel and plain differ beyond {SCAN_TOL} "
                  f"(max abs err {err})")
            print(f"{label}: max abs err {err} at max |plain| {scale} "
                  f"(rtol {SCAN_TOL['rtol']}, atol {SCAN_TOL['atol']})")
            return err

        scan_occ = {name: scan_kernel.kernel_info(name, 16)
                    for name in scan_kernel.KERNELS}
        for name, occ in scan_occ.items():
            print(f"scan kernel {name} at N = 16: {occ['registers']} "
                  f"registers a thread, {occ['static_smem']} + "
                  f"{occ['dynamic_smem']} bytes of shared memory (static + "
                  f"dynamic), {occ['blocks_per_sm']} blocks of "
                  f"{occ['threads']} threads an SM")

        scan_err = {}
        for bsz, s_len, d_in, n_st in [(2, 16, 8, 4), (1, 100, 32, 16),
                               (2, 64, 300, 16), (1, 33, 24, 8)]:
            # the reference's sweep (tests/test_kernels.py), both entries
            a = (torch.rand(bsz, s_len, d_in, n_st, generator=gen) * 0.499
                 + 0.5).to(dev)
            bb = (torch.randn(bsz, s_len, d_in, n_st, generator=gen)
                  * 0.1).to(dev)
            c = torch.randn(bsz, s_len, n_st, generator=gen).to(dev)
            shape = [bsz, s_len, d_in, n_st]
            hold(f"selective_scan_f32 {shape}",
                 selective_scan(a, bb, c), selective_scan_ref(a, bb, c))
            args = fused_inputs(*shape, 0.5)
            y, h_last = selective_scan_fused(*args)
            want_y, want_h = fused_scan_ref(*args)
            hold(f"selective_scan_fused_f32 {shape} y", y, want_y)
            hold(f"selective_scan_fused_f32 {shape} h_last", h_last, want_h)
        # the fused kernel across the borders of its tiles of 16 steps
        for bsz in (1, 4):
            for s_len in (1, 15, 16, 17, 2049):
                args = fused_inputs(bsz, s_len, 8190, 16, 0.5)
                y, h_last = selective_scan_fused(*args)
                want_y, want_h = fused_scan_ref(*args)
                label = f"selective_scan_fused_f32 {[bsz, s_len, 8190, 16]}"
                hold(f"{label} y", y, want_y)
                hold(f"{label} h_last", h_last, want_h)
                del y, h_last, want_y, want_h, args
        # falcon-mamba-7b's shapes: the serving bucket, a decode tick from a
        # nonzero state and the long prefill
        scan_shapes = {"serve_bucket": (1, 32, 8192, 16, 0.0),
                       "decode_tick": (4, 1, 8192, 16, 0.5),
                       "long_prefill": (1, LONG_PROMPT, 8192, 16, 0.0)}
        scan_args = {}
        for key, (*shape, h0_scale) in scan_shapes.items():
            args = fused_inputs(*shape, h0_scale)
            y, h_last = selective_scan_fused(*args)
            want_y, want_h = fused_scan_ref(*args)
            label = f"selective_scan_fused_f32 {key} {shape}"
            scan_err[key] = max(hold(f"{label} y", y, want_y),
                                hold(f"{label} h_last", h_last, want_h))
            scan_args[key] = args
            del y, h_last, want_y, want_h
        # the Pallas contract at the long prefill's shape: a and b
        # materialised from the same inputs, 1.07 GB each
        dt, x, bmat, cmat, a_neg, _ = scan_args["long_prefill"]
        long_a = torch.exp(dt[..., None] * a_neg).contiguous()
        long_b = ((dt * x)[..., None] * bmat[:, :, None, :]).contiguous()
        scan_err["pallas_long"] = hold(
            f"selective_scan_f32 {list(long_a.shape)}",
            selective_scan(long_a, long_b, cmat),
            selective_scan_ref(long_a, long_b, cmat))

        # times: the kernel by fenced_ms less the floor (one launch); the
        # plain versions, hundreds to thousands of launches, as the device
        # time of a CUDA graph of one call less the floor
        def time_scan(kern_fn, plain_fn, work):
            t = {"ms": fenced_ms(kern_fn) - floor_ms,
                 "call_ms": cuda_ms(kern_fn),
                 "plain_ms": graph_ms(plain_fn)[0] - floor_ms,
                 "plain_call_ms": cuda_ms(plain_fn, warmup=1, repeats=3,
                                          inner=2)}
            t["bytes"], t["operations"], t["exps"] = work
            t["bound_ms"], t["bound_by"] = bound(*work)
            return t

        scan_times = {}
        for key, args in scan_args.items():
            bsz, s_len, d_in, n_st, _ = scan_shapes[key]
            scan_times[key] = time_scan(
                lambda args=args: selective_scan_fused(*args),
                lambda args=args: fused_scan_ref(*args),
                scan_work(bsz, s_len, d_in, n_st, fused=True))
        scan_times["pallas_long"] = time_scan(
            lambda: selective_scan(long_a, long_b, cmat),
            lambda: selective_scan_ref(long_a, long_b, cmat),
            scan_work(1, LONG_PROMPT, 8192, 16, fused=False))
        for key, t in scan_times.items():
            print(f"scan {key}: device time per call: kernel {t['ms']} ms, "
                  f"plain {t['plain_ms']} ms (CUDA graph); per call through "
                  f"the wrapper (CUDA events, back to back): kernel "
                  f"{t['call_ms']:.6f} ms, plain {t['plain_call_ms']:.6f} "
                  f"ms; bound {t['bound_ms']:.6f} ms by {t['bound_by']} "
                  f"({t['bytes']} bytes, {t['operations']} float32 "
                  f"operations, {t['exps']} exps)")
        del scan_args, long_a, long_b, dt, x, bmat, cmat, a_neg
        gc.collect()
        torch.cuda.empty_cache()

        # falcon-mamba-7b through the launcher
        served, mamba_main_s, mamba_serve_peak = serve_run(
            serve_launch, MAMBA_ARGV, kernels, "mamba serve")
        mamba_launches = scan_kernel.launch_counts()
        check(minplus_kernel.launch_count() == 0
              and fa_kernel.launch_count() == 0,
              "the Mamba serving path launched min-plus or flash attention")
        loop = served.loop
        cfg = loop.api.cfg
        n_params = sum(p.numel() for p in loop.params.parameters())
        check(n_params == MAMBA_PARAMS,
              f"falcon-mamba-7b has {n_params} parameters, expected "
              f"{MAMBA_PARAMS}")
        want_launches = cfg.n_layers * (16 + MAMBA_TICKS)
        check(mamba_launches["selective_scan_fused_f32"] == want_launches
              and mamba_launches["selective_scan_f32"] == 0,
              f"mamba serve: scan launches {mamba_launches}, expected "
              f"{cfg.n_layers} layers x (16 prefills + {MAMBA_TICKS} ticks)"
              f" = {want_launches} of the fused entry")
        serve_ssm = {"arch": "falcon-mamba-7b",
                     "tok_s": served.tokens / served.seconds,
                     "seconds": served.seconds, "tokens": served.tokens,
                     "launcher_s": mamba_main_s,
                     "peak_gib": mamba_serve_peak / 2**30}
        print(f"falcon-mamba-7b ({n_params} parameters, {cfg.dtype}): "
              f"{mamba_main_s:.3f} s from the launcher's start to the last "
              f"token ({served.seconds:.3f} s serving), "
              f"{serve_ssm['tok_s']:.1f} tok/s, scan launches "
              f"{mamba_launches}, peak device memory "
              f"{mamba_serve_peak / 2**30:.3f} GiB")
        serve_ssm.update(time_tick(loop))
        # one long prompt: the kernel against the chunked scan
        serve_ssm.update(long_prefill(loop, "chunked", MAMBA_LOGIT_TOL))
        serve_ssm["depth_witness"] = mamba_depth_witness(loop)
        serve_ssm["phase_peak_gib"] = \
            torch.cuda.max_memory_allocated() / 2**30
        print(f"peak device memory over phase 8: "
              f"{serve_ssm['phase_peak_gib']:.3f} GiB")
        del loop, served

    gc.collect()
    torch.cuda.empty_cache()
    failures_report = {}
    with phase("9 failures and the packed grid on CUDA"):
        t_phase9 = time.perf_counter()
        # (a) the two failure scenarios, CUDA against the CPU
        fpols = [(f"{r}/{rec}", PolicyConfig(routing=rv, recovery=recv,
                                             job_concurrency=2))
                 for r, rv in (("sdn", ROUTE_SDN), ("legacy", ROUTE_LEGACY))
                 for rec, recv in (("restart", 0), ("resume", 1))]
        reverts = {"task_reexecs": 0, "pkt_reroutes": 0}
        for name in ("paper-fabric-failures", "leaf-spine-failures"):
            res = Experiment(name, fpols, device="cuda").run()
            cpu = Experiment(name, fpols, device="cpu").run()
            check(res.meta.has_failures, f"{name}: no live failure schedule")
            states_match(res.states, cpu.states, name)
            rows = res.rows()
            for k in reverts:
                reverts[k] += sum(r[k] for r in rows)
            print(f"{name}: equal to the CPU run; steps "
                  f"{res.states.steps[0].tolist()}, re-executions "
                  f"{[r['task_reexecs'] for r in rows]}, reroutes "
                  f"{[r['pkt_reroutes'] for r in rows]} ({res.policy_names})")
        check(reverts["task_reexecs"] > 0 and reverts["pkt_reroutes"] > 0,
              f"the failure scenarios reverted nothing: {reverts}")

        # (b) the heterogeneous grid: CUDA against the CPU grid, each
        # scenario against its own single run, the pad slots inert
        gpols = [("sdn", PolicyConfig(routing=ROUTE_SDN)),
                 ("legacy", PolicyConfig(routing=ROUTE_LEGACY))]
        grid = Experiment(list(GRID_SCENARIOS), gpols, device="cuda").run()
        cgrid = Experiment(list(GRID_SCENARIOS), gpols, device="cpu").run()
        check(grid.states.time.device.type == "cuda"
              and grid.consts.routes.device.type == "cuda",
              "the grid did not run on CUDA")
        states_match(grid.states, cgrid.states, "grid")
        for si, name in enumerate(GRID_SCENARIOS):
            exp = Experiment(name, gpols, device="cuda")
            single = exp.run()
            topo = exp.scenarios[0][1].cluster.topo
            for pi in range(len(gpols)):
                cell_matches_single(grid.state(si, pi), single.state(0, pi),
                                    grid.meta, topo, f"grid {name}/{pi}")
        print(f"grid {list(GRID_SCENARIOS)} x {grid.policy_names}: equal to "
              f"the CPU grid and, cell by cell, to each scenario's own run "
              f"on its unpadded prefix; pad slots inert; steps "
              f"{grid.states.steps.tolist()}")

        # (c) the slice's path at full size: leaf-spine-xl x 3 outage traces
        xl_pols = [("sdn", PolicyConfig(job_concurrency=4)),
                   ("legacy", PolicyConfig(routing=ROUTE_LEGACY,
                                           job_concurrency=4))]
        traces = [(n, failure_injector(**kw)) for n, kw in XL_FAILURES]
        consts_cache_clear()      # phase 5 built xl: build its table anew
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for kern in kernels:
            kern.reset_launch_count()
        t_main = time.perf_counter()
        exp = Experiment("leaf-spine-xl", xl_pols, failures=traces,
                         device="cuda")
        res = exp.run()
        torch.cuda.synchronize()
        xl_main_s = time.perf_counter() - t_main
        xl_launches = minplus_kernel.launch_counts()
        xl_squarings = int(minplus_kernel.last_squarings())
        xl_other = fa_kernel.launch_count() + scan_kernel.launch_count()
        xl_peak = torch.cuda.max_memory_allocated()
        loop_s = list(runners.get_runner(res.meta, "grid").seconds)
        check(xl_launches == {"minplus_f32": 0, "apsp_f32": 1}
              and xl_squarings == 3,
              f"the xl grid took min-plus launches {xl_launches} of "
              f"{xl_squarings} squarings, expected one apsp_f32 of 3")
        check(xl_other == 0, "the xl grid launched flash or the scan")
        check(res.states.time.device.type == "cuda",
              "the xl grid did not run on CUDA")
        r0 = res.state(0, 0)
        states_match(r0, healthy_xl, "xl r0 against the healthy run")
        r0_bitwise = all(torch.equal(a.nan_to_num(-7.0), b.nan_to_num(-7.0))
                         for a, b in zip(r0, healthy_xl))
        check(int(r0.steps) == PROFILE_STEPS["leaf-spine-xl"],
              f"xl r0: {int(r0.steps)} steps")
        print(f"xl r0 SDN lane equals phase 5's healthy run "
              f"({int(r0.steps)} steps): bitwise {r0_bitwise}")
        cpu_s0 = Experiment("leaf-spine-xl", xl_pols, device="cpu",
                            failures=[traces[1]]).run()
        states_match(type(res.states)(*(a[1:2] for a in res.states)),
                     cpu_s0.states,
                     "xl r5e-5/s0 against its CPU run")
        rows = res.rows()
        for row in rows:
            stalled_ok = not row["stalled"] or (
                row["scenario"].endswith("s0") and bool(
                    cpu_s0.states.stalled[0, res.policy_names.index(
                        row["policy"])]))
            check(stalled_ok, f"xl {row['scenario']}/{row['policy']} "
                              f"stalled")
        for si in (1, 2):
            got = [r for r in rows if r["scenario"] == res.scenario_names[si]]
            check(sum(r["task_reexecs"] for r in got) > 0
                  and sum(r["pkt_reroutes"] for r in got) > 0,
                  f"xl {res.scenario_names[si]}: nothing reverted")
        # the device's busy time over the first PROFILE_WINDOW_STEPS steps
        # of the seed-0 loop, under the profiler, against the same window
        # run unprofiled just before
        consts, meta = exp.build()
        loop = runners.get_runner(dataclasses.replace(
            meta, max_steps=PROFILE_WINDOW_STEPS), "policy_batch")
        window = lambda: loop(slice_packed(consts, 1),  # noqa: E731
                              exp.policy_arrays())
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        window_steps = int(window().steps.max())
        window_s = time.perf_counter() - t0
        busy = device_ms(window)
        idle_s0 = None if busy is None else 1 - busy / 1e3 / window_s
        replicas = {}
        for si, name in enumerate(res.scenario_names):
            steps = int(res.states.steps[si].max())
            replicas[name.split("/", 1)[1]] = {
                "loop_steps": steps, "loop_s": loop_s[si],
                "steps_per_s": steps / loop_s[si],
                "lane_steps": res.states.steps[si].tolist(),
                "rows": {r["policy"]: {k: r[k] for k in (
                    "makespan_s", "downtime_s", "task_reexecs",
                    "pkt_reroutes", "stalled")}
                    for r in rows if r["scenario"] == name}}
        for name, rep9 in replicas.items():
            print(f"xl {name}: {rep9['loop_steps']} loop steps (lanes "
                  f"{rep9['lane_steps']}) in {rep9['loop_s']:.3f} s = "
                  f"{rep9['steps_per_s']:.1f} steps/s on CUDA")
            for pol, row in rep9["rows"].items():
                print(f"  {pol}: makespan {row['makespan_s']} s, downtime "
                      f"{row['downtime_s']} s, re-executions "
                      f"{row['task_reexecs']}, reroutes "
                      f"{row['pkt_reroutes']}")
        print(f"xl grid: {xl_main_s:.3f} s from Experiment() to the final "
              f"state, min-plus launches {xl_launches} ({xl_squarings} "
              f"squarings), peak device memory {xl_peak / 2**20:.1f} MiB; "
              f"seed-0 loop's first {window_steps} steps: device busy "
              f"{busy} ms of {window_s * 1e3:.3f} ms, idle share "
              f"{idle_s0}; the seed-0 trace equals its CPU run")
        failures_report = {
            "small": reverts, "grid_steps": grid.states.steps.tolist(),
            "xl": {"main_s": xl_main_s, "apsp_launches": xl_launches,
                   "squarings": xl_squarings, "peak_mib": xl_peak / 2**20,
                   "r0_bitwise_healthy": r0_bitwise,
                   "idle_share_s0": idle_s0, "busy_ms_s0": busy,
                   "profile_window": {"steps": window_steps,
                                      "wall_s": window_s},
                   "replicas": replicas},
            "phase_s": time.perf_counter() - t_phase9}

    gc.collect()
    torch.cuda.empty_cache()
    with phase("10 the control plane and chaos on CUDA"):
        t_phase10 = time.perf_counter()
        # (a) the four entries at their registered size, CUDA against the
        # CPU, the tables' conservation law on the CUDA states
        small = {}
        for name in PHASE10_GRIDS:
            pols = phase10_policies(name)
            res = Experiment(name, pols, device="cuda").run()
            cpu_states, cpu_s = cpu_jobs[name].get()
            check(res.states.time.device.type == "cuda",
                  f"{name} did not run on CUDA")
            states_match(res.states, cpu_states, name)
            ctrl_conserved(res.states, name)
            rows = res.rows()
            check(not any(r["stalled"] for r in rows), f"{name} stalled")
            small[name] = {r["policy"]: {k: r[k] for k in (
                "makespan_s", "rule_installs", "rule_evictions",
                "vm_migrations", "spec_launches", "spec_wins",
                "failover_count", "failover_park_s")} for r in rows}
            small[name]["steps"] = res.states.steps[0].tolist()
            print(f"{name}: equal to the CPU run, tables conserved; steps "
                  f"{small[name]['steps']} ({res.policy_names}), makespan "
                  f"{[round(r['makespan_s'], 3) for r in rows]} s, installs "
                  f"{[r['rule_installs'] for r in rows]}, migrations "
                  f"{[r['vm_migrations'] for r in rows]}, clones "
                  f"{[r['spec_launches'] for r in rows]}")
            if name == "paper-fabric-chaos":
                print(f"paper-fabric-chaos: ctrl_failovers "
                      f"{res.states.ctrl_failovers[0].tolist()}, "
                      f"ctrl_failover_park "
                      f"{res.states.ctrl_failover_park[0].tolist()} s")
        check(small["leaf-spine-ctrl"]["sdn-migrate"]["vm_migrations"] > 0,
              "leaf-spine-ctrl migrated no VM")

        # (b), (c): leaf-spine-xl (32 jobs in (b)) under a priced
        # controller, and under gray host slowdowns with speculation
        xl_cells = {}
        for xl in PHASE10_XL:
            pols = phase10_policies(xl)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            for kern in kernels:
                kern.reset_launch_count()
            t_main = time.perf_counter()
            exp = Experiment(phase10_scenario(xl), pols, device="cuda")
            consts, meta = exp.build()
            t0 = time.perf_counter()
            res = exp.run()
            torch.cuda.synchronize()
            loop_s = time.perf_counter() - t0
            main_s = time.perf_counter() - t_main
            mp = minplus_kernel.launch_counts()
            sq = int(minplus_kernel.last_squarings())
            other = fa_kernel.launch_count() + scan_kernel.launch_count()
            peak = torch.cuda.max_memory_allocated()
            check(mp == {"minplus_f32": 0, "apsp_f32": 1} and sq == 3,
                  f"{xl}: min-plus launches {mp} of {sq} squarings, "
                  f"expected one apsp_f32 of 3")
            check(other == 0, f"{xl} launched flash or the scan")
            check(res.states.time.device.type == "cuda",
                  f"{xl} did not run on CUDA")
            ctrl_conserved(res.states, xl)
            rows = res.rows()
            check(not any(r["stalled"] for r in rows), f"{xl} stalled")
            steps = int(res.states.steps.max())
            # the first PROFILE_WINDOW_STEPS steps again: unprofiled, under
            # the profiler (the device's busy time), and counting syncs
            loop = runners.get_runner(dataclasses.replace(
                meta, max_steps=PROFILE_WINDOW_STEPS), "policy_batch")
            window = lambda: loop(consts, exp.policy_arrays())  # noqa: E731
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            window_steps = int(window().steps.max())
            window_s = time.perf_counter() - t0
            busy, ops = device_profile(window)
            idle_share = None if busy is None else 1 - busy / 1e3 / window_s
            syncs = count_syncs(window)
            cpu_states, cpu_s = cpu_jobs[xl].get()
            states_match(res.states, cpu_states,
                         f"{xl} against its CPU run")
            keys = ("makespan_s", "rule_installs", "rule_evictions",
                    "rule_reinstalls", "ctrl_queue_wait_s", "install_wait_s",
                    "vm_migrations") + (
                ("spec_launches", "spec_wins", "wasted_spec_work_s",
                 "degraded_time_s") if xl == "xl-chaos" else ())
            xl_cells[xl] = {
                "loop_steps": steps,
                "lane_steps": res.states.steps[0].tolist(),
                "loop_s": loop_s, "steps_per_s": steps / loop_s,
                "main_s": main_s, "apsp_launches": mp, "squarings": sq,
                "peak_mib": peak / 2**20, "cpu_run_s": cpu_s,
                "profile_window": {"steps": window_steps, "wall_s": window_s,
                                   "busy_ms": busy,
                                   "idle_share": idle_share,
                                   "host_syncs": syncs,
                                   "syncs_per_step": syncs / window_steps,
                                   "device_ops": ops,
                                   "ops_per_step": ops / window_steps},
                "rows": {r["policy"]: {k: r[k] for k in keys}
                         for r in rows}}
            cell = xl_cells[xl]
            print(f"{xl}: {steps} loop steps (lanes {cell['lane_steps']}) "
                  f"in {loop_s:.3f} s = {cell['steps_per_s']:.1f} steps/s on "
                  f"CUDA; {main_s:.3f} s from Experiment() to the final "
                  f"state; min-plus launches {mp} ({sq} squarings); peak "
                  f"device memory {cell['peak_mib']:.1f} MiB; first "
                  f"{window_steps} steps: {window_s * 1e3:.3f} ms, device "
                  f"busy {busy} ms, idle share {idle_share}, {syncs} host "
                  f"syncs ({syncs / window_steps:.2f} a step), {ops} device "
                  f"ops ({ops / window_steps:.1f} a step); equal to its "
                  f"CPU run ({cpu_s:.1f} s in a worker)")
            for pol, row in cell["rows"].items():
                print(f"  {pol}: " + ", ".join(f"{k} {v}"
                                                for k, v in row.items()))
        ctrl_report = {"small": small, "xl": xl_cells,
                       "phase_s": time.perf_counter() - t_phase10}

    gc.collect()
    torch.cuda.empty_cache()
    with phase("11 the fleet engine and the streaming ring on CUDA"):
        t_phase11 = time.perf_counter()
        fleet_report = phase11(kernels, cpu_jobs)
        fleet_report["phase_s"] = time.perf_counter() - t_phase11

    gc.collect()
    torch.cuda.empty_cache()
    with phase("12 the advisor and the data twin on CUDA"):
        advisor_report = phase12(kernels, cpu_jobs)

    with phase("13 MoE serving at full width on CUDA (qwen3-moe-30b-a3b)"):
        # flash: 48 layers x 16 prefills
        serve_moe = moe_serve(serve_launch, kernels, MOE_ARGV, "moe serve",
                              MOE_PARAMS, {"flash": 48 * 16, "scan": 0},
                              "naive")

    with phase("14 hybrid serving at full width on CUDA (jamba-v0.1-52b, "
               f"{JAMBA_LAYERS} of 32 layers)"):
        # flash: 2 attention layers x 16 prefills; the fused scan: 14
        # Mamba layers x (16 prefills + 64 ticks)
        serve_hybrid = moe_serve(
            serve_launch, kernels, JAMBA_ARGV, "jamba serve", JAMBA_PARAMS,
            {"flash": 2 * 16, "scan": 14 * (16 + MAMBA_TICKS)}, "chunked")
    print(f"sum of phases: {sum(PHASE_S.values()):.3f} s "
          f"({', '.join(f'{k} {v:.1f}' for k, v in PHASE_S.items())})")

    t_fa = fa_times[LONG_PROMPT]
    print(json.dumps({"kernels": [{
        "name": "minplus_f32",
        "route": "cuda",
        "source": "src/repro_torch/csrc/tropical_apsp.cu",
        "replaces": "src/repro/kernels/tropical_apsp/kernel.py:28",
        "shape": [n, n, n],
        "tile": tile,
        "launches": launches,
        "max_abs_err": max_err,
        "ms": kernel_ms,
        "fenced_ms": kernel_fenced_ms,
        "plain_ms": plain_ms,
        "call_ms": kernel_call_ms,
        "plain_call_ms": plain_call_ms,
        "bound_ms": mp_bound[0],
        "bound_by": mp_bound[1],
        "library_ms": None,
        "build_s": build_s,
        "design": DESIGN["minplus"],
        "kernel_info": mp_info,
        "apsp": {"entry": "apsp_f32",
                 "replaces": "src/repro/kernels/tropical_apsp/ops.py:22",
                 "shape": [n, n],
                 "launches": mp_launches["apsp_f32"],
                 "main_path_squarings": main_squarings,
                 "library_ms": None, "grid": xl_grid,
                 "scenarios_max_abs_err": apsp_err,
                 "ctrl_chaos_launches": {k: v["apsp_launches"]
                                         for k, v in xl_cells.items()},
                 "fleet_stream_launches": {
                     k: v["apsp_launches"] for k, v in fleet_report.items()
                     if isinstance(v, dict)},
                 **xl_apsp},
        "fat_tree_32": {"entry": "apsp_f32", "squarings": ft_ran,
                        "squarings_needed": ft_need,
                        "launches": ft_made["apsp_f32"],
                        "max_abs_err": ft_err, "library_ms": None,
                        **{k: ft["apsp"][k] for k in (
                            "ms", "bound_ms", "bound_by")},
                        **ft},
    }, {
        "name": "flash_attention",
        "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention/kernel.py:25",
        "shape": {"q": [1, LONG_PROMPT, 32, 128],
                  "kv": [1, LONG_PROMPT, 8, 128], "dtype": "bfloat16",
                  "causal": True},
        "launches": fa_launches,
        "launches_by_path": {"qwen3-4b": fa_launches,
                             "qwen3-moe-30b-a3b":
                                 serve_moe["launches"]["flash"],
                             "jamba-v0.1-52b":
                                 serve_hybrid["launches"]["flash"]},
        "max_abs_err": fa_err[LONG_PROMPT],
        "ms": t_fa["kernel_ms"],
        "plain_ms": t_fa["plain_ms"],
        "call_ms": t_fa["kernel_call_ms"],
        "plain_call_ms": t_fa["plain_call_ms"],
        "bound_ms": t_fa["bound_ms"],
        "bound_by": ("bytes" if t_fa["bound_bytes_ms"] > t_fa["bound_ops_ms"]
                     else "operations"),
        "library_ms": t_fa["sdpa_ms"],
        "library_call_ms": t_fa["sdpa_call_ms"],
        "fenced_floor_ms": floor_ms,
        "build_s": fa_build_s,
        "serve_bucket": {"S": 32, "max_abs_err": fa_err[32],
                         **fa_times[32]},
        "design": DESIGN["flash"],
        "occupancy": fa_occ,
        "sass": fa_sass,
    }, {
        "name": "selective_scan",
        "route": "cuda",
        "source": "src/repro_torch/csrc/selective_scan.cu",
        "replaces": "src/repro/kernels/selective_scan/kernel.py:25",
        "shape": {"dt_x": [1, LONG_PROMPT, 8192], "n": 16,
                  "entry": "selective_scan_fused_f32"},
        "launches": sum(mamba_launches.values()),
        "launches_by_path": {"falcon-mamba-7b": sum(mamba_launches.values()),
                             "jamba-v0.1-52b":
                                 serve_hybrid["launches"]["scan_fused"]},
        "max_abs_err": scan_err["long_prefill"],
        "ms": scan_times["long_prefill"]["ms"],
        "plain_ms": scan_times["long_prefill"]["plain_ms"],
        "call_ms": scan_times["long_prefill"]["call_ms"],
        "plain_call_ms": scan_times["long_prefill"]["plain_call_ms"],
        "bound_ms": scan_times["long_prefill"]["bound_ms"],
        "bound_by": scan_times["long_prefill"]["bound_by"],
        "library_ms": None,
        "build_s": scan_build_s,
        "fused": {"entry": "selective_scan_fused_f32",
                  "replaces": "src/repro/models/ssm.py:110",
                  "launches": mamba_launches["selective_scan_fused_f32"],
                  **{key: {"max_abs_err": scan_err[key],
                           **scan_times[key]}
                     for key in ("long_prefill", "serve_bucket",
                                 "decode_tick")}},
        "pallas_contract": {
            "entry": "selective_scan_f32",
            "replaces": "src/repro/kernels/selective_scan/kernel.py:49",
            "shape": [1, LONG_PROMPT, 8192, 16],
            "launches": mamba_launches["selective_scan_f32"],
            "max_abs_err": scan_err["pallas_long"], "library_ms": None,
            **scan_times["pallas_long"]},
        "design": DESIGN["scan"],
        "occupancy": scan_occ,
    }], "steps_per_s": rates, "device_idle_share": idle,
        "failures": failures_report, "ctrl_chaos": ctrl_report,
        "fleet_stream": fleet_report, "advisor": advisor_report,
        "serve": serve, "serve_ssm": serve_ssm, "serve_moe": serve_moe,
        "serve_hybrid": serve_hybrid, "phase_s": PHASE_S}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        code = main()
    finally:
        for pool in CPU_POOL:      # stop phase 10's CPU workers
            pool.terminate()
            pool.join()
    sys.exit(code)
