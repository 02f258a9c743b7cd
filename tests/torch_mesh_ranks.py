"""Rank programs of the port's multi-process tests, and their launcher.

``spawn(program, world, workdir)`` starts ``world`` processes of this file
(``python torch_mesh_ranks.py <program> <rank> <world> <workdir>``); each
joins a gloo group through a file store in ``workdir`` (no port to
collide between parallel test workers), runs ``PROGRAMS[program]`` and
destroys the group on the way out.  Inputs come from ``workdir`` and
results go back there (``<program>_<rank>.npz``).  The module imports
neither jax nor the JAX package, so a rank starts in about a second.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import traceback

import numpy as np

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src")


def spawn(program: str, world: int, workdir: str, timeout: float = 300
          ) -> list:
    """Run ``program`` on ``world`` ranks; returns each rank's npz (as a
    dict of arrays), rank order.  Raises with a rank's stderr if one
    fails."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.abspath(SRC)
    env.setdefault("OMP_NUM_THREADS", "1")
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), program, str(r),
         str(world), workdir], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout))
    finally:
        for p in procs:
            p.kill()
    failed = [f"rank {r} exited {p.returncode}:\n{err[-3000:]}"
              for r, (p, (_, err)) in enumerate(zip(procs, outs))
              if p.returncode != 0]
    if failed:
        raise RuntimeError(f"{program}: " + "\n".join(failed))
    res = []
    for r in range(world):
        with np.load(os.path.join(workdir, f"{program}_{r}.npz")) as z:
            res.append(dict(z))
    return res


# ---------------------------------------------------------------------------
# programs
# ---------------------------------------------------------------------------


def moe_ep(rank: int, world: int, workdir: str) -> dict:
    """Every case of ``moe_in.npz`` (weights, x and the config's capacity
    factor, dtype and experts) through ``moe_apply`` on a (2, 4) ("data", "model")
    mesh, this rank's rows of x: its output rows, and the gradients of
    sum(out^2) + aux / world (the global loss's share of this rank) as
    local shards (the expert banks') or local partials (the router's)."""
    import dataclasses

    import torch

    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.mesh import make_mesh, use_mesh
    from repro_torch.models.moe import MoE, moe_apply
    from repro_torch.models.moe_ep import ep_applicable
    from repro_torch.roofline.collectives import record_collectives
    from repro_torch.sharding.rules import P, local_slices, to_dtensor

    mesh = make_mesh((2, 4), ("data", "model"), "cpu")
    out = {}
    with np.load(os.path.join(workdir, "moe_in.npz")) as z:
        cases = json.loads(str(z["cases"]))
        arrays = dict(z)
    for name, (cf, dtype, experts) in cases.items():
        dt = getattr(torch, dtype)
        cfg = dataclasses.replace(get_smoke_config("qwen3-moe-30b-a3b"),
                                  capacity_factor=cf, dtype=dt,
                                  n_experts=experts)
        p = MoE(cfg, "cpu")
        for w, spec in (("router", P(None, None)),
                        ("wi", P("model", None, None)),
                        ("wg", P("model", None, None)),
                        ("wo", P("model", None, None))):
            full = torch.from_numpy(arrays[f"{name}/{w}"]).to(
                getattr(p, w).dtype)
            setattr(p, w, torch.nn.Parameter(to_dtensor(full, spec, mesh)))
        x = torch.from_numpy(arrays[f"{name}/x"]).to(dt)
        x = x[local_slices(x.shape, P(("data", "model"), None, None),
                           mesh)].clone()
        with use_mesh(mesh, global_batch=x.shape[0] * world), \
                record_collectives() as recs:
            assert ep_applicable(cfg)
            y, aux = moe_apply(p, x, cfg)
            loss = torch.sum(y.float() ** 2) + aux / world
            loss.backward()
        out[f"{name}/out"] = y.float().detach().numpy()
        out[f"{name}/aux"] = aux.detach().numpy()
        out[f"{name}/kinds"] = np.array(sorted({r.kind for r in recs}))
        for w in ("router", "wi", "wg", "wo"):
            out[f"{name}/grad_{w}"] = \
                getattr(p, w).grad.to_local().float().numpy()
    out["coord"] = np.array(mesh.get_coordinate())
    return out


def fleet_ckpt(rank: int, world: int, workdir: str) -> dict:
    """The fleet spread over ``world`` ranks on paper-fabric, and
    ``restore(shardings=)`` of the two checkpoints in ``workdir`` onto a
    (1, world) mesh, each saved again from the mesh."""
    import torch

    from repro_torch.api import Experiment, run_fleet
    from repro_torch.checkpoint import ckpt
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import get_model
    from repro_torch.sharding import rules
    from repro_torch.train import AdamWConfig
    from repro_torch.train import init as opt_init

    with open(os.path.join(workdir, "fleet.json")) as f:
        args = json.load(f)
    exp = Experiment("paper-fabric", args["policies"], seeds=args["seeds"],
                     device="cpu")
    serial = exp.run()
    out = {f"serial/{k}": v.numpy() for k, v in
           zip(serial.states._fields, serial.states)}
    for tag, (width, devices) in args["runs"].items():
        res, st = run_fleet(exp, width=width, chunk_steps=16,
                            devices=devices, return_stats=True)
        for k, v in zip(res.states._fields, res.states):
            out[f"{tag}/{k}"] = v.numpy()
        out[f"{tag}/stats"] = np.array([st.sims, st.cohorts, st.chunks,
                                        st.refills, st.devices, st.width])

    mesh = make_mesh((1, world), ("data", "model"), "cpu")
    cfg = get_smoke_config("qwen3-4b")
    for tag in ("port", "ref"):
        model = get_model(cfg).init(0, device="cpu")
        ostate = opt_init(AdamWConfig(), model)
        pspecs = rules.param_specs(model, mesh)
        mspecs = rules.opt_state_specs(model, mesh)
        sh = (rules.named(mesh, pspecs),
              ostate._replace(step=None, mu=rules.named(mesh, mspecs),
                              nu=rules.named(mesh, mspecs),
                              err={k: None for k in ostate.err}))
        (model, ostate), _ = ckpt.restore(os.path.join(workdir, tag),
                                          (model, ostate), shardings=sh)
        with np.load(os.path.join(workdir, tag, "step_00000001",
                                  "arrays.npz")) as z:
            saved = dict(z)
        checked = 0
        leaves = {f"0/{k}": (leaf.params, leaf.stacked, pspecs[k])
                  for k, leaf in rules_leaf_map(model).items()}
        leaves.update({f"1/.mu/{k}": ((v,), False, mspecs[k])
                       for k, v in ostate.mu.items()})
        for key, (ts, stacked, spec) in leaves.items():
            arr = saved[key]
            rows = arr if stacked else (arr,)
            spec = rules.row_spec(spec, stacked)
            for t, row in zip(ts, rows):
                local = t.detach().to_local().float().numpy()
                want = row[rules.local_slices(row.shape, spec, mesh)]
                assert np.array_equal(local, want), (tag, key)
                full = t.detach().full_tensor().float().numpy()
                assert np.array_equal(full, row), \
                    (tag, key)
                checked += 1
        assert int(ostate.step) == 1
        out[f"ckpt_{tag}_checked"] = np.array(checked)
        # and back to disk from the mesh (every rank gathers, rank 0
        # writes)
        ckpt.save(os.path.join(workdir, f"{tag}_from_mesh"), 1,
                  (model, ostate))
    # a tree of plain tensors under the group: each rank writes its own,
    # with no barrier
    plain = plain_tree(rank)
    d = os.path.join(workdir, "plain", f"rank{rank}")
    path = ckpt.save(d, 2, plain)
    back = {k: torch.zeros_like(v) for k, v in plain.items()}
    ckpt.restore(d, back)
    out["plain_path"] = np.array(path)
    out["plain_equal"] = np.array(all(torch.equal(back[k], v)
                                      for k, v in plain.items()))
    torch.distributed.barrier()
    return out


def plain_tree(rank: int) -> dict:
    """Rank ``rank``'s own tree of plain tensors."""
    import torch
    return {"w": torch.arange(6, dtype=torch.float32).reshape(2, 3) + rank,
            "n": torch.tensor([rank, 7], dtype=torch.int32)}


def zero_step(rank: int, world: int, workdir: str) -> dict:
    """One AdamW train step of qwen3-4b's smoke model in float32 on a
    (2, 4) ("data", "model") mesh, the dry run's layout run for real:
    parameters restored as DTensors from ``workdir/init``, ZeRO moments,
    this rank's row of the batch in ``step_in.npz`` (its global batch of
    8 named to ``use_mesh``); the updated model is saved from the mesh to
    ``workdir/after``."""
    import dataclasses
    import functools

    import torch

    from repro_torch.checkpoint import ckpt
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.mesh import make_mesh, use_mesh
    from repro_torch.models import get_model
    from repro_torch.roofline.collectives import record_collectives
    from repro_torch.sharding import rules
    from repro_torch.train import AdamWConfig, make_train_step, zero

    mesh = make_mesh((2, 4), ("data", "model"), "cpu")
    cfg = dataclasses.replace(get_smoke_config("qwen3-4b"),
                              dtype=torch.float32)
    api = get_model(cfg)
    model = api.init(0, device="cpu")
    pspecs = rules.param_specs(model, mesh)
    model, _ = ckpt.restore(os.path.join(workdir, "init"), model,
                            shardings=rules.named(mesh, pspecs))
    ocfg = AdamWConfig()
    opt = zero.moments(ocfg, model, rules.opt_state_specs(model, mesh), mesh)
    with np.load(os.path.join(workdir, "step_in.npz")) as z:
        batch = {k: torch.from_numpy(v) for k, v in z.items()}
    spec = rules.P(("data", "model"), None)
    batch = {k: v[rules.local_slices(v.shape, spec, mesh)].clone()
             for k, v in batch.items()}
    step = make_train_step(api, ocfg, update=functools.partial(
        zero.update, pspecs=pspecs, mesh=mesh))
    with use_mesh(mesh, global_batch=8), record_collectives() as recs:
        model, opt, met = step(model, opt, batch)
    ckpt.save(os.path.join(workdir, "after"), 1, model)
    return {"loss": met["loss"].numpy(), "grad_norm": met["grad_norm"].numpy(),
            "kinds": np.array(sorted({r.kind for r in recs}))}


def _tree_local(tree, specs, mesh):
    """A global tree of tensors (nested dicts) as this rank's shards."""
    from repro_torch.sharding import rules
    if isinstance(tree, dict):
        return {k: _tree_local(v, specs[k], mesh) for k, v in tree.items()}
    return tree[rules.local_slices(tree.shape, specs, mesh)].clone()


def _flat(tree, prefix=""):
    """{"a/b": leaf} of nested dicts."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


def layouts(rank: int, world: int, workdir: str) -> dict:
    """The serving layouts on a (2, 4) ("data", "model") mesh, for every
    arch of ``layouts.json``: its weights restored from ``workdir/<arch>``
    as DTensors placed by ``param_specs``, the batch of ``layouts_in.npz``
    placed by ``batch_specs`` (its 2 rows over "data"), the cache by
    ``cache_specs_tree``; the prefill under ``use_mesh(mesh,
    global_batch=2)`` (the sequence over "model" in the transformer
    families, FSDP in the others), then the decode ticks with
    ``fsdp=False`` (tensor parallel), each fed its greedy tokens (the vlm
    family the embeddings of ``layouts_in.npz``).  Returns every logits,
    the tokens, the cache shard after the last tick, and the collectives
    of the first tick by kind with each one's output bytes."""
    import dataclasses

    import torch

    from repro_torch.checkpoint import ckpt
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.mesh import make_mesh, use_mesh
    from repro_torch.models import get_model
    from repro_torch.roofline.collectives import record_collectives
    from repro_torch.sharding import rules, tp

    mesh = make_mesh((2, 4), ("data", "model"), "cpu")
    with open(os.path.join(workdir, "layouts.json")) as f:
        spec = json.load(f)
    with np.load(os.path.join(workdir, "layouts_in.npz")) as z:
        arrays = {k: torch.from_numpy(v) for k, v in z.items()}
    out = {"coord": np.array(mesh.get_coordinate())}
    for arch in spec["archs"]:
        cfg = dataclasses.replace(get_smoke_config(arch), dtype=torch.float32,
                                  capacity_factor=spec["capacity_factor"])
        api = get_model(cfg)
        model = api.init(0, device="cpu")
        model, _ = ckpt.restore(os.path.join(workdir, arch), model,
                                shardings=rules.named(
                                    mesh, rules.param_specs(model, mesh)))
        batch = {k.split("/")[-1]: v for k, v in arrays.items()
                 if k.startswith(arch + "/prefill/")}
        b = next(iter(batch.values())).shape[0]
        batch = _tree_local(batch, rules.batch_specs(batch, mesh), mesh)
        cache = api.init_cache(b, spec["max_len"], device="cpu")
        cache = _tree_local(cache, rules.cache_specs_tree(cache, mesh), mesh)
        gathers = []
        gather_seq = tp.gather_seq
        tp.gather_seq = lambda t: gathers.append(t.shape) or gather_seq(t)
        try:
            with use_mesh(mesh, global_batch=b):
                logits, cache = api.prefill(model, batch, cache,
                                            backend="chunked")
        finally:
            tp.gather_seq = gather_seq
        out[f"{arch}/seq_gathers"] = np.array(gathers).reshape(-1, 4)
        out[f"{arch}/logits0"] = logits.numpy()
        tp_api = get_model(dataclasses.replace(cfg, fsdp=False))
        rows = rules.local_slices((b,), rules.P(rules.cache_rows(b, mesh)),
                                  mesh)[0]
        tokens = logits.argmax(-1).to(torch.int32)
        for t in range(spec["ticks"]):
            out[f"{arch}/tokens{t}"] = tokens.numpy()
            with use_mesh(mesh), record_collectives() as recs:
                if cfg.family == "vlm":
                    extra = {k: arrays[f"{arch}/tick{t}/{k}"][rows]
                             for k in ("embeds", "pos3")}
                    logits, cache = tp_api.decode_step(model, None, cache,
                                                       batch_extra=extra)
                else:
                    logits, cache = tp_api.decode_step(model, tokens, cache)
            out[f"{arch}/logits{t + 1}"] = logits.numpy()
            tokens = logits.argmax(-1).to(torch.int32)
            if t == 0:
                for kind in sorted({r.kind for r in recs}):
                    out[f"{arch}/wire/{kind}"] = np.array(
                        [r.bytes for r in recs if r.kind == kind])
        for k, v in _flat(cache).items():
            out[f"{arch}/cache/{k}"] = v.numpy()
    return out


def sp_train(rank: int, world: int, workdir: str) -> dict:
    """One float32 AdamW step of each case of ``sp_train.json`` on a (2, 4)
    ("data", "model") mesh: its smoke config's weights restored from
    ``workdir/<arch>`` as DTensors, ZeRO moments, the batch of
    ``sp_train_in.npz`` placed by ``batch_specs`` under ``use_mesh(mesh,
    global_batch=B)`` (a B that leaves "model" idle splits the sequence
    when S divides 4), in ``microbatch``'s number of microbatches.  Every
    rank returns its metrics, the shape of its (first) logits and its
    collectives' kinds; rank 0 also each parameter's whole
    gradient (the mean over the ranks, as ``zero.update`` takes it) and
    its value after the step.  Then the first MoE layer of
    ``moe_layer``'s arch on this rank's positions of ``moe_layer/x``
    under the split, at each of its capacity factors: its output and aux
    loss."""
    import dataclasses

    import torch
    from torch.distributed.tensor import DTensor, Partial, Shard

    from repro_torch.checkpoint import ckpt
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.mesh import make_mesh, use_mesh
    from repro_torch.models import get_model
    from repro_torch.roofline.collectives import record_collectives
    from repro_torch.sharding import rules
    from repro_torch.train import AdamWConfig, make_train_step, zero

    mesh = make_mesh((2, 4), ("data", "model"), "cpu")
    with open(os.path.join(workdir, "sp_train.json")) as f:
        spec = json.load(f)
    with np.load(os.path.join(workdir, "sp_train_in.npz")) as z:
        arrays = {k: torch.from_numpy(v) for k, v in z.items()}
    out = {}
    for case, arch in spec["cases"].items():
        cfg = dataclasses.replace(get_smoke_config(arch), dtype=torch.float32,
                                  capacity_factor=spec["capacity_factor"])
        api = get_model(cfg)
        model = api.init(0, device="cpu")
        pspecs = rules.param_specs(model, mesh)
        model, _ = ckpt.restore(os.path.join(workdir, arch), model,
                                shardings=rules.named(mesh, pspecs))
        ocfg = AdamWConfig(**spec["opt"])
        opt = zero.moments(ocfg, model, rules.opt_state_specs(model, mesh),
                           mesh)
        batch = {k.split("/")[-1]: v for k, v in arrays.items()
                 if k.startswith(case + "/")}
        b = batch["labels"].shape[0]
        batch = _tree_local(batch, rules.batch_specs(batch, mesh), mesh)
        grads, shapes = {}, []

        def update(c, g, state, params):
            grads.update(g)
            return zero.update(c, g, state, params, pspecs=pspecs,
                               mesh=mesh)

        def apply(*a, **kw):
            res = api.apply(*a, **kw)
            shapes.append(tuple(res["logits"].shape))
            return res
        step = make_train_step(dataclasses.replace(api, apply=apply), ocfg,
                               update=update,
                               microbatch=spec["microbatch"].get(case, 0))
        with use_mesh(mesh, global_batch=b), record_collectives() as recs:
            model, opt, met = step(model, opt, batch)
        for k, v in met.items():
            out[f"{case}/met/{k}"] = v.numpy()
        out[f"{case}/logits_shape"] = np.array(shapes[0])
        out[f"{case}/kinds"] = np.array(sorted({r.kind for r in recs}))
        for name, p in model.named_parameters():
            g = grads[name]
            g = DTensor.from_local(
                g.to_local(), mesh,
                [pl if isinstance(pl, Shard) else Partial()
                 for pl in g.placements], run_check=False, shape=g.shape,
                stride=g.stride()).full_tensor() / world
            w = p.detach().full_tensor()
            if rank == 0:
                out[f"{case}/grad/{name}"] = g.numpy()
                out[f"{case}/param/{name}"] = w.numpy()
    # the first MoE layer of spec["moe_layer"]["arch"] under the split, at
    # each capacity factor: this rank's output and aux on its positions
    # of its row of moe_layer/x
    from repro_torch.models.moe import moe_apply
    arch = spec["moe_layer"]["arch"]
    x = arrays["moe_layer/x"]
    d_row, r = mesh.get_coordinate()
    n = x.shape[1] // mesh.shape[1]
    x = x[d_row:d_row + 1, r * n:(r + 1) * n]
    for cf in spec["moe_layer"]["capacity_factors"]:
        cfg = dataclasses.replace(get_smoke_config(arch), dtype=torch.float32,
                                  capacity_factor=cf)
        model = get_model(cfg).init(0, device="cpu")
        model, _ = ckpt.restore(os.path.join(workdir, arch), model,
                                shardings=rules.named(
                                    mesh, rules.param_specs(model, mesh)))
        with torch.no_grad(), use_mesh(mesh, global_batch=2):
            y, aux = moe_apply(model.layers[0].moe, x, cfg)
        out[f"moe_layer/{cf}/out"] = y.numpy()
        out[f"moe_layer/{cf}/aux"] = aux.numpy()
    out["coord"] = np.array(mesh.get_coordinate())
    return out


def rules_leaf_map(model):
    from repro_torch.models.weights import leaf_map
    return leaf_map(model, model.cfg)


PROGRAMS = {"moe_ep": moe_ep, "fleet_ckpt": fleet_ckpt,
            "zero_step": zero_step, "layouts": layouts,
            "sp_train": sp_train}


def main(argv) -> int:
    program, rank, world, workdir = argv[0], int(argv[1]), int(argv[2]), \
        argv[3]
    import torch.distributed as dist
    dist.init_process_group(
        "gloo", init_method=f"file://{os.path.join(workdir, 'store')}",
        rank=rank, world_size=world)
    try:
        out = PROGRAMS[program](rank, world, workdir)
        np.savez(os.path.join(workdir, f"{program}_{rank}.npz"), **out)
    except BaseException:
        traceback.print_exc()
        return 1
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
