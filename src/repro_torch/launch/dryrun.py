"""Dry run of every (arch x shape) cell on one H100, on fake tensors.

Port of ``src/repro/launch/dryrun.py``.  For each cell this builds the
step a real run calls (``train.make_train_step`` with AdamW, the prefill,
or one decode step), with parameters (``models.registry.param_specs``, the
counterpart of ``jax.eval_shape(init)``), optimizer state, batch and cache
made under ``FakeTensorMode`` (shapes and dtypes, no data), runs it once
under ``roofline.counting.count`` and records FLOPs, bytes, peak live
bytes and ops for the roofline table of one H100 (``roofline.hw.H100``).
A cell ``fits`` when its predicted peak is at most the card's 80 GB.

No device is touched: the fake tensors live on the CPU device and no
kernel runs, so the CUDA default of the port's entry points does not
apply here and the dry run runs on any machine.  The reference sets
``XLA_FLAGS`` for 512 host devices and runs decode without FSDP; one
device has neither.

Depth: XLA counts a ``lax.scan`` body once, so the reference unrolls its
layer scans (``repro.util.unrolled_counting``) and extrapolates from
depth 1 and 2.  Eager runs every layer, so no switch is needed:
``lower_cell(extrapolate=True)`` counts depth 1, depth 2 and the full
depth, records outside + L x per_layer beside the full count, and checks
that FLOPs, bytes and ops agree exactly.

``--fit-only`` (``lower_cell(fit_only=True)``) answers only whether a
cell fits: each count stops once more than the card's bytes are live, so
a cell whose parameters alone exceed 80 GB is decided before its step
runs; such a record has ``complete: false``, a ``peak_gib`` that is a
lower bound, and no depth identity.

Usage:
  python -m repro_torch.launch.dryrun --arch qwen3-4b --shape train_4k
  python -m repro_torch.launch.dryrun --all --out experiments/dryrun_torch
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
import traceback
from typing import Any, Dict, Optional, Tuple

from torch._subclasses.fake_tensor import FakeTensorMode

from ..configs import ARCH_IDS, SHAPES, ShapeSpec, get_config, shape_applies
from ..models import get_model
from ..models.registry import (cache_specs, decode_input_specs,
                               param_specs, prefill_input_specs,
                               train_input_specs)
from ..roofline.counting import Counts, count
from ..roofline.hw import H100
from ..roofline.terms import (analyze_raw, count_active_params, count_params,
                              model_flops_cell, raw_counts)
from ..train import AdamWConfig, make_train_step
from ..train import init as opt_init

MESH = "1xH100"
# the counts the depth identity holds exactly (the peak is a maximum, not
# a sum over layers)
LINEAR = ("flops", "bytes", "ops")


def depth_units(cfg) -> int:
    if cfg.family == "hybrid":
        return cfg.n_layers // cfg.attn_every
    return cfg.n_layers


def with_units(cfg, u: int):
    if cfg.family == "hybrid":
        return dataclasses.replace(cfg, n_layers=u * cfg.attn_every)
    if cfg.family == "audio":
        return dataclasses.replace(cfg, n_layers=u, n_enc_layers=u)
    return dataclasses.replace(cfg, n_layers=u)


def lower_one(cfg, shape: ShapeSpec, *, backend: str, remat: bool,
              microbatch: int, stop_bytes: float = float("inf"),
              cache_len: int = 0) -> Tuple[Counts, Any]:
    """Count one step function for one cfg/shape on fake tensors:
    ``(Counts, the model's parameters)``; past ``stop_bytes`` live the
    count stops (``counting.count``).  A prefill's or decode's cache holds
    ``cache_len`` positions (0: the shape's ``seq_len``)."""
    api = get_model(cfg)
    b, s = shape.global_batch, shape.seq_len
    max_len = cache_len or s
    with FakeTensorMode():
        params = param_specs(cfg)
        if shape.kind == "train":
            ocfg = AdamWConfig()
            opt = opt_init(ocfg, params)
            batch = train_input_specs(cfg, b, s)
            step = make_train_step(api, ocfg, backend=backend, remat=remat,
                                   microbatch=microbatch)
            counts, _ = count(step, params, opt, batch,
                              stop_bytes=stop_bytes)
        elif shape.kind == "prefill":
            batch = prefill_input_specs(cfg, b, s)
            cache = cache_specs(cfg, b, max_len)
            counts, _ = count(
                lambda p, bt, c: api.prefill(p, bt, c, backend=backend),
                params, batch, cache, stop_bytes=stop_bytes)
        else:  # decode
            cache = cache_specs(cfg, b, max_len)
            extra = decode_input_specs(cfg, b)
            if cfg.family == "vlm":
                def decode(p, e, c):
                    return api.decode_step(p, None, c, batch_extra=e)
            else:
                def decode(p, e, c):
                    return api.decode_step(p, e["tokens"], c)
            counts, _ = count(decode, params, extra, cache,
                              stop_bytes=stop_bytes)
    return counts, params


def lower_cell(arch: str, shape_name: str, *, backend: str = "chunked",
               remat: bool = True, microbatch: int = 0,
               extrapolate: bool = True, fit_only: bool = False,
               cfg_override=None, shape_override: Optional[ShapeSpec] = None,
               cache_len: int = 0) -> Tuple[Counts, Dict[str, Any]]:
    """Count the full cell (and, with ``extrapolate``, depth 1 and 2 for
    the depth identity): ``(Counts, info)``.  ``fit_only`` stops each
    count past the card's bytes (see the module docstring).
    ``shape_override`` replaces ``SHAPES[shape_name]`` (a cut shape keeps
    the name it is reported under); ``cache_len`` sizes a prefill's or
    decode's cache (0: the shape's ``seq_len``)."""
    cfg = cfg_override or get_config(arch)
    shape = shape_override or SHAPES[shape_name]
    ok, why = shape_applies(cfg, shape_name)
    if not ok:
        raise ValueError(f"N/A cell: {why}")
    kw = dict(backend=backend, remat=remat, microbatch=microbatch,
              stop_bytes=H100.hbm_bytes if fit_only else float("inf"),
              cache_len=cache_len)

    t0 = time.time()
    counts, params = lower_one(cfg, shape, **kw)
    t_count = time.time() - t0
    full = {k: getattr(counts, k) for k in LINEAR}

    units = depth_units(cfg)
    depth = None
    if extrapolate and units > 2 and counts.complete:
        c1, _ = lower_one(with_units(cfg, 1), shape, **kw)
        c2, _ = lower_one(with_units(cfg, 2), shape, **kw)
        per = {k: getattr(c2, k) - getattr(c1, k) for k in LINEAR}
        outside = {k: getattr(c1, k) - per[k] for k in LINEAR}
        extrap = {k: outside[k] + per[k] * units for k in LINEAR}
        depth = {"units": units, "per_unit": per, "outside": outside,
                 "extrapolated": extrap, "full": full,
                 "equal": extrap == full}
        if not depth["equal"]:
            raise AssertionError(f"{arch} {shape_name}: outside + "
                                 f"{units} x per_unit {extrap} != the full "
                                 f"count {full}")

    params_n = count_params(params)
    active_n = count_active_params(params, cfg)
    mf = model_flops_cell(cfg, shape, active_n)
    rc = raw_counts(counts)
    rep = analyze_raw(flops=rc["flops"], byts=rc["bytes"],
                      wire=rc["wire_bytes"], counts=rc["counts"],
                      arch=arch, shape=shape_name, mesh_name=MESH, chips=1,
                      model_flops=mf, peak_bytes=counts.peak_bytes, hw=H100)
    info = {
        "arch": arch, "shape": shape_name, "mesh": MESH, "chips": 1,
        "batch": shape.global_batch, "seq_len": shape.seq_len,
        "kind": shape.kind, "params": params_n, "active_params": active_n,
        "t_count_s": round(t_count, 2),
        "depth_extrapolated": depth is not None, "depth": depth,
        "backend": backend, "remat": remat, "microbatch": microbatch,
        "complete": counts.complete, "counts": counts.as_dict(),
        "peak_gib": counts.peak_bytes / 2**30,
        "fits": counts.peak_bytes <= H100.hbm_bytes,
        "hw": H100.name,
        "roofline": rep.row(),
        "step_bound_s": rep.step_time_s,
    }
    return counts, info


def run_cell(arch: str, shape_name: str, **kw) -> Dict[str, Any]:
    """One cell's JSON record: ``status`` ``ok`` (with ``lower_cell``'s
    info), ``n/a`` (with the reason) or ``fail`` (with the traceback)."""
    cfg = kw.get("cfg_override") or get_config(arch)
    ok, why = shape_applies(cfg, shape_name)
    if not ok:
        return {"arch": arch, "shape": shape_name, "mesh": MESH,
                "status": "n/a", "reason": why}
    try:
        _, info = lower_cell(arch, shape_name, **kw)
        info["status"] = "ok"
        return info
    except Exception:  # noqa: BLE001 — report into the table
        return {"arch": arch, "shape": shape_name, "mesh": MESH,
                "status": "fail", "error": traceback.format_exc()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS)
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="experiments/dryrun_torch")
    ap.add_argument("--backend", default="chunked")
    ap.add_argument("--remat", type=int, default=1)
    ap.add_argument("--microbatch", type=int, default=0)
    ap.add_argument("--no-extrapolate", action="store_true")
    ap.add_argument("--fit-only", action="store_true")
    ap.add_argument("--skip-existing", action="store_true")
    args = ap.parse_args(argv)
    if not args.all and not (args.arch and args.shape):
        ap.error("give --arch and --shape, or --all")

    cells = ([(a, s) for a in ARCH_IDS for s in SHAPES] if args.all
             else [(args.arch, args.shape)])
    os.makedirs(args.out, exist_ok=True)
    failures = 0
    t_all = time.time()
    for arch, shape in cells:
        tag = f"{arch}_{shape}_{MESH}"
        path = os.path.join(args.out, tag + ".json")
        if args.skip_existing and os.path.exists(path):
            with open(path) as f:
                if json.load(f).get("status") in ("ok", "n/a"):
                    print(f"[skip] {tag}", flush=True)
                    continue
        rec = run_cell(arch, shape, backend=args.backend,
                       remat=bool(args.remat), microbatch=args.microbatch,
                       extrapolate=not args.no_extrapolate,
                       fit_only=args.fit_only)
        with open(path, "w") as f:
            json.dump(rec, f, indent=1, default=str)
        if rec["status"] == "n/a":
            print(f"[n/a ] {tag}: {rec['reason']}", flush=True)
        elif rec["status"] == "fail":
            failures += 1
            last = rec["error"].strip().splitlines()[-1]
            print(f"[FAIL] {tag}: {last}", flush=True)
        else:
            r = rec["roofline"]
            print(f"[ok  ] {tag}: count={rec['t_count_s']}s "
                  f"dom={r['dominant']} c/m={r['compute_s']:.4f}/"
                  f"{r['memory_s']:.4f}s useful={r['useful_ratio']:.3f} "
                  f"mfu={r['mfu_bound']:.3f} peak={rec['peak_gib']:.2f}GiB "
                  f"fits={rec['fits']}", flush=True)
    print(f"dry-run done in {time.time() - t_all:.1f}s, {failures} failures")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
