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
``XLA_FLAGS`` for 512 host devices; one device needs no mesh, and the
decode's ``fsdp=False`` changes nothing there.

Over a mesh (``lower_cell(multi_pod=False)``: 16 x 16 ``("data",
"model")``, 256 chips; ``True``: 2 x 16 x 16 with ``"pod"``, 512) the
count is rank 0's, under a fake process group of ``mesh_chips`` ranks in
this one process (``fake_mesh``): the parameters are DTensors placed by
``sharding.param_specs``, the moments by ``opt_state_specs`` (ZeRO over
the data axes; ``train/zero.py`` is the update), the batch by
``batch_specs``, a prefill's or decode's cache by ``cache_specs_tree``
over the global batch (each rank holds its shard: the batch over the
data axes, the last dim over ``"model"``), and the step runs on
rank-local tensors under ``use_mesh(mesh, global_batch=)``.  The
functional collectives it dispatches give the wire bytes
(``roofline/collectives.py``); ``collective_s`` divides them by
``hw.H100_SCALEOUT_BW``.  Layouts, the reference's as its dry run and
models select them, which the port runs in every cell (``_layout``;
each record names it as both its ``layout`` and its
``reference_layout``):

* decode: Megatron tensor parallelism (``fsdp=False``, as the
  reference's ``lower_one`` sets it): the weights stay sharded, the
  decode tokens lie as the cache's batch (over the data axes), and only
  activation-sized tensors move (``sharding/tp.py``);
* a prefill of the dense, moe or vlm family whose batch leaves
  ``"model"`` idle: the sequence over ``"model"`` (the reference's
  ``activation_hint`` in its ``lm_prefill``), weights gathered at use;
* any other prefill (the ssm, hybrid and audio families, whose
  reference prefills constrain no activation, or a batch over
  ``"model"`` too): FSDP, with the batch over ``batch_specs``' axes;
* train: where the batch leaves ``"model"`` idle and the sequence
  divides it (``train_4k`` on 2 x 16 x 16), the sequence over it in
  every family (the reference's ``activation_hint`` in each train
  forward; whisper's encoder only where ``enc_seq`` divides it too, so
  not its 1500 frames over 16); otherwise FSDP with the batch over
  ``batch_specs``' axes;
* a MoE layer runs expert parallelism where the global batch divides the
  whole mesh (the reference's ``moe_ep.ep_applicable``; a train record
  says ``+ep``), and the dense path with the expert banks gathered
  otherwise, the sequence split included (2 x 16 x 16's batch of 256
  does not divide its 512 chips).

Under ``remat`` each layer's forward runs again in the backward pass, and
so do its collectives: the FSDP weight gathers and, under the sequence
split, the K/V gathers along S and the Mamba blocks' two gathers; the
count includes them (wire bytes a rank: forward, recompute and the
reduce-scatters of the backward).  A Mamba block under the split also
runs its chunk's scan twice (once from zero for the chunk's map, once
from the state the previous ranks hand it); the count holds both, in
bytes and ops (a scan is no product, so no FLOPs).

Depth: XLA counts a ``lax.scan`` body once, so the reference unrolls its
layer scans (``repro.util.unrolled_counting``) and extrapolates from
depth 1 and 2.  Eager runs every layer, so no switch is needed:
``lower_cell(extrapolate=True)`` counts depth 1, depth 2 and the full
depth, records outside + L x per_layer beside the full count, and checks
that FLOPs, bytes and ops agree exactly, and over a mesh the wire bytes
too (a train cell on a mesh: the FLOPs and the wire bytes, see
``MESH_TRAIN_EXACT``).  A train cell's ZeRO update is counted at each
depth but not extrapolated: the reference's ``opt_state_specs`` puts a
moment's data-axis shard on the layer stack's dim when the depth divides
the data axes, so a shallow count may all-reduce a gradient that the
full depth reduce-scatters (falcon-mamba-7b's [L, 8192] leaves on
2 x 16 x 16); its wire bytes at full depth are added to the
extrapolated forward and backward's.

``--fit-only`` (``lower_cell(fit_only=True)``) answers only whether a
cell fits: each count stops once more than the card's bytes are live, so
a cell whose parameters alone exceed 80 GB is decided before its step
runs; such a record has ``complete: false``, a ``peak_gib`` that is a
lower bound, and no depth identity.

Usage:
  python -m repro_torch.launch.dryrun --arch qwen3-4b --shape train_4k
  python -m repro_torch.launch.dryrun --all --out experiments/dryrun_torch
  python -m repro_torch.launch.dryrun --all --multi-pod off   # 16 x 16
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import json
import math
import os
import sys
import time
import traceback
from typing import Any, Dict, Iterator, List, Optional, Tuple

from torch._subclasses.fake_tensor import FakeTensorMode

from ..configs import ARCH_IDS, SHAPES, ShapeSpec, get_config, shape_applies
from ..models import get_model
from ..models.registry import (cache_specs, decode_input_specs,
                               param_specs, prefill_input_specs,
                               train_input_specs)
from ..roofline.collectives import record_collectives
from ..roofline.counting import Counts, count
from ..roofline.hw import H100, H100_SCALEOUT_BW
from ..roofline.terms import (analyze_raw, count_active_params, count_params,
                              model_flops_cell, raw_counts)
from ..sharding import rules
from ..train import AdamWConfig, make_train_step, zero
from ..train import init as opt_init
from ..train import update as opt_update
from .mesh import PRODUCTION, axis_sizes, make_mesh, mesh_chips, use_mesh

MESH = "1xH100"
# the counts the depth identity holds exactly (the peak is a maximum, not
# a sum over layers)
LINEAR = ("flops", "bytes", "ops")
# over a mesh the wire bytes too.  A train cell on a mesh holds exactly
# on the FLOPs and the wire bytes only: ZeRO puts a moment's data-axis
# shard on its first dim that divides, the layer stack's at some depths
# and the next dim's at others, and a reduce-scatter on another dim
# dispatches other copies (the same wire bytes, other local bytes and ops)
MESH_LINEAR = LINEAR + ("wire_bytes",)
MESH_TRAIN_EXACT = ("flops", "wire_bytes")


@contextlib.contextmanager
def fake_mesh(shape, axes) -> Iterator:
    """A fake process group of ``prod(shape)`` ranks in this process, as
    rank 0, and its ``DeviceMesh`` on the CPU, ambient inside the block;
    the group is destroyed on exit.  Its collectives move nothing and
    return fake tensors of the right shapes."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=math.prod(shape))
    try:
        mesh = make_mesh(shape, axes, "cpu")
        with use_mesh(mesh):
            yield mesh
    finally:
        dist.destroy_process_group()


# the families whose prefill is ``transformer.lm_prefill``, the one that
# splits the sequence
SP_FAMILIES = ("dense", "moe", "vlm")


def _local(tree: Any, mesh, specs: Any = None) -> Any:
    """A global tree (dicts of tensors) as this rank's shards, placed by
    ``specs`` (by default ``batch_specs``' layout)."""
    specs = rules.batch_specs(tree, mesh) if specs is None else specs
    if isinstance(tree, dict):
        return {k: _local(v, mesh, specs[k]) for k, v in tree.items()}
    return tree[rules.local_slices(tree.shape, specs, mesh)].clone()


def _recorded(fn, records: Optional[List[Any]]):
    """``fn``, its collectives appended to ``records`` (when a list)."""
    if records is None:
        return fn

    def run(*args):
        with record_collectives() as recs:
            try:
                return fn(*args)
            finally:
                records.extend(recs)
    return run


def _layout(cfg, shape: ShapeSpec, mesh) -> str:
    """The layout of a mesh cell, the reference's as its dry run and
    models select it and the port's (the module docstring lists them)."""
    def over(axes) -> str:
        axes = axes if isinstance(axes, tuple) else (axes,)
        return "+".join(a for a in axes if a) or "none"

    axes = rules.batch_axes(shape.global_batch, mesh)
    split = ("model" not in axes
             and shape.seq_len % axis_sizes(mesh)["model"] == 0)
    if shape.kind == "decode":
        return (f"tp (fsdp=False), batch over "
                f"{over(rules.cache_rows(shape.global_batch, mesh))}")
    if split and (shape.kind == "train" or cfg.family in SP_FAMILIES):
        return f"sp, batch over {over(axes)}, sequence over model"
    if shape.kind == "prefill":
        return f"fsdp, batch over {over(axes)}"
    # expert parallelism where the global batch divides the whole mesh
    # (moe_ep.ep_applicable's rule, the reference's)
    ep = "+ep" if cfg.is_moe_arch and "model" in axes else ""
    return f"fsdp{ep}, batch over {over(axes)}"


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
              cache_len: int = 0, mesh=None,
              records: Optional[List[Any]] = None,
              update_records: Optional[List[Any]] = None
              ) -> Tuple[Counts, Any]:
    """Count one step function for one cfg/shape on fake tensors:
    ``(Counts, the model's parameters)``; past ``stop_bytes`` live the
    count stops (``counting.count``).  A prefill's or decode's cache holds
    ``cache_len`` positions (0: the shape's ``seq_len``).  With ``mesh`` (a
    ``DeviceMesh`` over a group set up by the caller, e.g. ``fake_mesh``)
    the count is this rank's (see the module docstring); the collectives
    it dispatched are appended to ``records``, and a train step's ZeRO
    update's to ``update_records`` too."""
    if shape.kind == "decode":
        # the reference's lower_one: decode runs Megatron TP (outside a
        # mesh the flag changes nothing)
        cfg = dataclasses.replace(cfg, fsdp=False)
    api = get_model(cfg)
    b, s = shape.global_batch, shape.seq_len
    max_len = cache_len or s
    ctx = use_mesh(mesh, global_batch=b) if mesh is not None else \
        contextlib.nullcontext()
    with FakeTensorMode(), ctx:
        params = param_specs(cfg)
        if mesh is not None:
            pspecs = rules.param_specs(params, mesh)
            rules.distribute(params, pspecs, mesh)
        if shape.kind == "train":
            ocfg = AdamWConfig()
            batch = train_input_specs(cfg, b, s)
            if mesh is None:
                opt = opt_init(ocfg, params)
                update = opt_update
            else:
                opt = zero.moments(ocfg, params,
                                   rules.opt_state_specs(params, mesh), mesh)
                batch = _local(batch, mesh)
                update = _recorded(functools.partial(
                    zero.update, pspecs=pspecs, mesh=mesh), update_records)
            step = make_train_step(api, ocfg, backend=backend, remat=remat,
                                   microbatch=microbatch, update=update)
            counts, _ = count(_recorded(step, records), params, opt, batch,
                              stop_bytes=stop_bytes)
        elif shape.kind == "prefill":
            batch = prefill_input_specs(cfg, b, s)
            cache = cache_specs(cfg, b, max_len)
            if mesh is not None:
                batch = _local(batch, mesh)
                cache = _local(cache, mesh,
                               rules.cache_specs_tree(cache, mesh))
            counts, _ = count(_recorded(
                lambda p, bt, c: api.prefill(p, bt, c, backend=backend),
                records), params, batch, cache, stop_bytes=stop_bytes)
        else:  # decode
            extra = decode_input_specs(cfg, b)
            cache = cache_specs(cfg, b, max_len)
            if mesh is not None:
                rows = rules.cache_rows(b, mesh)
                extra = _local(extra, mesh, {
                    k: rules.P(rows, *(None,) * (v.ndim - 1))
                    for k, v in extra.items()})
                cache = _local(cache, mesh,
                               rules.cache_specs_tree(cache, mesh))
            if cfg.family == "vlm":
                def decode(p, e, c):
                    return api.decode_step(p, None, c, batch_extra=e)
            else:
                def decode(p, e, c):
                    return api.decode_step(p, e["tokens"], c)
            counts, _ = count(_recorded(decode, records), params, extra,
                              cache, stop_bytes=stop_bytes)
    return counts, params


def lower_cell(arch: str, shape_name: str, *, backend: str = "chunked",
               remat: bool = True, microbatch: int = 0,
               extrapolate: bool = True, fit_only: bool = False,
               cfg_override=None, shape_override: Optional[ShapeSpec] = None,
               cache_len: int = 0, multi_pod: Optional[bool] = None,
               mesh=None) -> Tuple[Counts, Dict[str, Any]]:
    """Count the full cell (and, with ``extrapolate``, depth 1 and 2 for
    the depth identity): ``(Counts, info)``.  ``fit_only`` stops each
    count past the card's bytes (see the module docstring).
    ``shape_override`` replaces ``SHAPES[shape_name]`` (a cut shape keeps
    the name it is reported under); ``cache_len`` sizes a prefill's or
    decode's cache (0: the shape's ``seq_len``).  ``multi_pod`` ``None``
    counts one H100; ``False`` rank 0 of the 16 x 16 mesh, ``True`` of
    2 x 16 x 16, each under its own fake group; ``mesh`` instead counts on
    a ``DeviceMesh`` whose group the caller set up."""
    cfg = cfg_override or get_config(arch)
    shape = shape_override or SHAPES[shape_name]
    ok, why = shape_applies(cfg, shape_name)
    if not ok:
        raise ValueError(f"N/A cell: {why}")
    if mesh is None and multi_pod is not None:
        with fake_mesh(*PRODUCTION[multi_pod]) as m:
            return lower_cell(arch, shape_name, backend=backend, remat=remat,
                              microbatch=microbatch, extrapolate=extrapolate,
                              fit_only=fit_only, cfg_override=cfg_override,
                              shape_override=shape_override,
                              cache_len=cache_len, multi_pod=multi_pod,
                              mesh=m)
    kw = dict(backend=backend, remat=remat, microbatch=microbatch,
              stop_bytes=H100.hbm_bytes if fit_only else float("inf"),
              cache_len=cache_len, mesh=mesh)
    chips = mesh_chips(mesh) if mesh is not None else 1
    name = (mesh_name(multi_pod) if multi_pod is not None
            else "x".join(map(str, mesh.shape)) if mesh is not None
            else MESH)
    linear = MESH_LINEAR if mesh is not None else LINEAR

    def wire(c: Counts, recs) -> float:
        return raw_counts(c, recs, num_partitions=chips)["wire_bytes"]

    def counted(c: Counts, recs, urecs=()) -> Dict[str, float]:
        """The counts, the wire bytes less those of ``urecs``."""
        return {"flops": c.flops, "bytes": c.bytes, "ops": c.ops,
                "wire_bytes": wire(c, recs) - wire(c, urecs)}

    def one(cfg_) -> Tuple[Counts, Any, list, list]:
        recs: list = []
        urecs: list = []
        c, p = lower_one(cfg_, shape, records=recs, update_records=urecs,
                         **kw)
        return c, p, recs, urecs

    t0 = time.time()
    counts, params, recs, urecs = one(cfg)
    t_count = time.time() - t0
    full = {k: counted(counts, recs)[k] for k in linear}

    units = depth_units(cfg)
    depth = None
    if extrapolate and units > 2 and counts.complete:
        c1, _, recs1, urecs1 = one(with_units(cfg, 1))
        c2, _, recs2, urecs2 = one(with_units(cfg, 2))
        r1, r2 = counted(c1, recs1, urecs1), counted(c2, recs2, urecs2)
        per = {k: r2[k] - r1[k] for k in linear}
        outside = {k: r1[k] - per[k] for k in linear}
        extrap = {k: outside[k] + per[k] * units for k in linear}
        # the ZeRO update's wire bytes, counted at each depth and added
        # at the full depth's (the module docstring)
        update_wire = {"1": wire(c1, urecs1), "2": wire(c2, urecs2),
                       "full": wire(counts, urecs)}
        if "wire_bytes" in extrap:
            extrap["wire_bytes"] += update_wire["full"]
        exact = MESH_TRAIN_EXACT if mesh is not None and \
            shape.kind == "train" else linear
        depth = {"units": units, "per_unit": per, "outside": outside,
                 "extrapolated": extrap, "full": full,
                 "update_wire_bytes": update_wire,
                 "equal": all(extrap[k] == full[k] for k in exact),
                 "equal_keys": [k for k in linear if extrap[k] == full[k]]}
        if not depth["equal"]:
            raise AssertionError(f"{arch} {shape_name}: outside + "
                                 f"{units} x per_unit {extrap} != the full "
                                 f"count {full}")

    params_n = count_params(params)
    active_n = count_active_params(params, cfg)
    mf = model_flops_cell(cfg, shape, active_n)
    rc = raw_counts(counts, recs, num_partitions=chips)
    rep = analyze_raw(flops=rc["flops"], byts=rc["bytes"],
                      wire=rc["wire_bytes"], counts=rc["counts"],
                      arch=arch, shape=shape_name, mesh_name=name,
                      chips=chips, model_flops=mf,
                      peak_bytes=counts.peak_bytes, hw=H100,
                      link_bw=H100_SCALEOUT_BW if mesh is not None else None)
    info = {
        "arch": arch, "shape": shape_name, "mesh": name, "chips": chips,
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
    if mesh is not None:
        info["layout"] = info["reference_layout"] = _layout(cfg, shape,
                                                            mesh)
        info["wire_bytes"] = rc["wire_bytes"]
        info["collective_bw"] = H100_SCALEOUT_BW
    return counts, info


def mesh_name(multi_pod: bool) -> str:
    return "2x16x16" if multi_pod else "16x16"


def run_cell(arch: str, shape_name: str, **kw) -> Dict[str, Any]:
    """One cell's JSON record: ``status`` ``ok`` (with ``lower_cell``'s
    info), ``n/a`` (with the reason) or ``fail`` (with the traceback)."""
    cfg = kw.get("cfg_override") or get_config(arch)
    mp = kw.get("multi_pod")
    name = MESH if mp is None else mesh_name(mp)
    ok, why = shape_applies(cfg, shape_name)
    if not ok:
        return {"arch": arch, "shape": shape_name, "mesh": name,
                "status": "n/a", "reason": why}
    try:
        _, info = lower_cell(arch, shape_name, **kw)
        info["status"] = "ok"
        return info
    except Exception:  # noqa: BLE001 — report into the table
        return {"arch": arch, "shape": shape_name, "mesh": name,
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
    ap.add_argument("--multi-pod", choices=["off", "on", "both"],
                    help="count rank 0 of the 16x16 mesh (off), of "
                         "2x16x16 (on) or of both; one H100 without it")
    args = ap.parse_args(argv)
    if not args.all and not (args.arch and args.shape):
        ap.error("give --arch and --shape, or --all")

    cells = ([(a, s) for a in ARCH_IDS for s in SHAPES] if args.all
             else [(args.arch, args.shape)])
    pods = {None: [None], "off": [False], "on": [True],
            "both": [False, True]}[args.multi_pod]
    os.makedirs(args.out, exist_ok=True)
    failures = 0
    t_all = time.time()
    for (arch, shape), mp in ((c, mp) for c in cells for mp in pods):
        tag = f"{arch}_{shape}_{MESH if mp is None else mesh_name(mp)}"
        path = os.path.join(args.out, tag + ".json")
        if args.skip_existing and os.path.exists(path):
            with open(path) as f:
                if json.load(f).get("status") in ("ok", "n/a"):
                    print(f"[skip] {tag}", flush=True)
                    continue
        rec = run_cell(arch, shape, backend=args.backend,
                       remat=bool(args.remat), microbatch=args.microbatch,
                       extrapolate=not args.no_extrapolate,
                       fit_only=args.fit_only, multi_pod=mp)
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
                  f"dom={r['dominant']} c/m/coll={r['compute_s']:.4f}/"
                  f"{r['memory_s']:.4f}/{r['collective_s']:.4f}s "
                  f"useful={r['useful_ratio']:.3f} "
                  f"mfu={r['mfu_bound']:.3f} peak={rec['peak_gib']:.2f}GiB "
                  f"fits={rec['fits']}", flush=True)
    print(f"dry-run done in {time.time() - t_all:.1f}s, {failures} failures")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
