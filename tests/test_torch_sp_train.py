"""Sequence-parallel training (the reference's ``activation_hint`` in every
family's train forward) and the mesh loss's global token count, held
against the port's one-device step and the reference's.

One spawn of 8 gloo ranks on a (2, 4) ("data", "model") mesh
(``torch_mesh_ranks.sp_train``) takes one float32 AdamW step of each
case, with the reference's ``init`` weights carried across by
``params_from_jax`` and placed by ``param_specs``, ZeRO moments
(``train/zero.py``) and the batch placed by ``batch_specs`` under
``use_mesh(mesh, global_batch=B)``:

* the six families' smoke configs (qwen3-4b, qwen3-moe-30b-a3b and
  jamba-v0.1-52b at capacity factor 8, so that no path drops a token,
  falcon-mamba-7b, whisper-base, whose 16 frames split too, and
  qwen2-vl-72b on embeddings with ``pos3``) at B = 2, S = 64: the batch
  leaves "model" idle, so each rank trains on 16 positions of its row;
  row 0's last 24 labels are ``PAD_ID``, so the ranks hold uneven
  counts;
* qwen3-4b with a whole padded row besides: sequence split (B = 2,
  S = 64), FSDP over both axes (B = 8, S = 16), FSDP with replicas on
  "model" (B = 2, S = 30, which does not divide 4), and two microbatches
  of the sequence split (B = 4 over "data", S = 64: each microbatch's
  global batch of 2 leaves "model" idle), whose one-device step takes
  the rows in the mesh's grouping (``train/step.py``: microbatch i holds
  the i-th row of each rank's two).

Each against the port's one-device step on the same weights and batch:
every rank's loss, ce, z, aux and grad norm within rtol 1e-5 (1e-4 for
the Mamba families, whose scans sum in another order; the split also
composes the scan's chunks from exp(a * sum dt) where one device
multiplies step by step), ``tokens`` exact (the global count, on every
rank); each parameter's gradient within 1e-5 of its largest |g| (1e-4
Mamba), and its update held through the gradients
(``test_grads_and_update_equal_one_device`` says how: AdamW's first step
moves every element by about lr, but tracks a gradient near its eps as
closely as that gradient's rounding).
qwen3-4b and falcon-mamba-7b also against the reference's jitted
one-device loss and ``jax.value_and_grad`` (grads rtol and atol 1e-5 of
the leaf's largest, 1e-4 for the Mamba model), which run meanwhile in
this process.
"""
import concurrent.futures
import dataclasses
import json
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as ref_smoke
from repro.models import get_model as ref_get_model
from repro.train.loss import lm_loss as ref_lm_loss
from repro_torch.checkpoint import ckpt
from repro_torch.configs import get_smoke_config
from repro_torch.models import get_model
from repro_torch.models.weights import _flatten, leaf_map, params_from_jax
from repro_torch.train import AdamWConfig, make_train_step, optim
from repro_torch.train.loss import PAD_ID
from torch_mesh_ranks import spawn

ARCHS = ("qwen3-4b", "qwen3-moe-30b-a3b", "falcon-mamba-7b",
         "jamba-v0.1-52b", "whisper-base", "qwen2-vl-72b")
MAMBA = ("falcon-mamba-7b", "jamba-v0.1-52b")
CF = 8.0
OPT = dict(total_steps=50, warmup_steps=2)
M = 4                                   # the "model" axis
# case -> (arch, B, S, a whole padded row)
CASES = {**{a: (a, 2, 64, False) for a in ARCHS},
         "pad_sp": ("qwen3-4b", 2, 64, True),
         "pad_fsdp": ("qwen3-4b", 8, 16, True),
         "pad_replicas": ("qwen3-4b", 2, 30, True),
         "pad_microbatch": ("qwen3-4b", 4, 64, True)}
MICROBATCH = {"pad_microbatch": 2}
D = 2                                   # the "data" axis
SPLIT = [c for c, (_, b, s, _) in CASES.items()
         if b // MICROBATCH.get(c, 1) == 2 and s % M == 0]
REFERENCE = ("qwen3-4b", "falcon-mamba-7b")
# the MoE layer alone under the split, where no capacity binds and where
# it does
MOE = "qwen3-moe-30b-a3b"
MOE_CFS = (8.0, 0.25)


def _moe_x():
    return np.random.default_rng(99).standard_normal(
        (2, 64, get_smoke_config(MOE).d_model)).astype(np.float32)


def _tol(case):
    return 1e-4 if CASES[case][0] in MAMBA else 1e-5


def _batch(case):
    """The case's batch, numpy, from a seed: row 0's last 3/8 of the
    labels padded, and with a padded row the last row's too."""
    arch, b, s, row = CASES[case]
    cfg = get_smoke_config(arch)
    rng = np.random.default_rng(list(CASES).index(case))
    labels = rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)
    labels[0, s - 3 * s // 8:] = PAD_ID
    if row:
        labels[-1] = PAD_ID
    batch = {"labels": labels}
    if cfg.family == "vlm":
        t = np.arange(s)
        pos3 = np.stack([t, t // 4, t % 4 + t // 8], -1).astype(np.int32)
        batch["pos3"] = np.ascontiguousarray(np.broadcast_to(pos3, (b, s, 3)))
        batch["embeds"] = rng.standard_normal((b, s, cfg.d_model)).astype(
            np.float32)
    else:
        batch["tokens"] = rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)
    if cfg.family == "audio":
        batch["enc_embeds"] = rng.standard_normal(
            (b, cfg.enc_seq, cfg.d_model)).astype(np.float32)
    return batch


def _grouped(case, batch):
    """``batch``'s rows in the order that gives one device's microbatches
    the mesh's: microbatch i holds the i-th part of every "data" rank's
    rows."""
    b, mb = CASES[case][1], MICROBATCH.get(case, 1)
    n = b // D // mb
    rows = [d * b // D + i * n + j
            for i in range(mb) for d in range(D) for j in range(n)]
    return {k: v[rows] for k, v in batch.items()}


def _ref_cfg(arch):
    return dataclasses.replace(ref_smoke(arch), dtype=jnp.float32,
                               capacity_factor=CF)


def _cfg(arch):
    return dataclasses.replace(get_smoke_config(arch), dtype=torch.float32,
                               capacity_factor=CF)


def _weights(arch):
    params = jax.jit(ref_get_model(_ref_cfg(arch)).init)(
        jax.random.PRNGKey(ARCHS.index(arch)))
    return jax.tree_util.tree_map(np.asarray, params)


def _reference(case, weights):
    """The reference's jitted one-device loss and grads (flattened by the
    reference's leaf keys)."""
    arch = CASES[case][0]
    api = ref_get_model(_ref_cfg(arch))
    batch = {k: jnp.asarray(v) for k, v in _batch(case).items()}

    def loss(params, batch):
        out = api.apply(params, {k: v for k, v in batch.items()
                                 if k != "labels"}, backend="chunked")
        return ref_lm_loss(out["logits"], batch["labels"],
                           aux_loss=out.get("aux_loss", 0.0))
    (val, met), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        jax.tree_util.tree_map(jnp.asarray, weights), batch)
    return (float(val), jax.tree_util.tree_map(np.asarray, met),
            _flatten(jax.tree_util.tree_map(np.asarray, grads), sep="/"))


def _one_device(case, weights):
    """The port's one-device step: (metrics, grads by name, parameters
    before and after by name)."""
    arch = CASES[case][0]
    cfg = _cfg(arch)
    api = get_model(cfg)
    model = params_from_jax(weights, cfg, device="cpu")
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    grads = {}

    def update(c, g, state, params):
        grads.update({n: v.clone() for n, v in g.items()})
        return optim.update(c, g, state, params)
    step = make_train_step(api, AdamWConfig(**OPT), update=update,
                           microbatch=MICROBATCH.get(case, 0))
    model, _, met = step(model, optim.init(AdamWConfig(**OPT), model),
                         {k: torch.from_numpy(v)
                          for k, v in _grouped(case, _batch(case)).items()})
    after = {n: p.detach().clone() for n, p in model.named_parameters()}
    return {k: v.numpy() for k, v in met.items()}, grads, before, after


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The 8 ranks, and meanwhile the reference's and the port's
    one-device runs."""
    d = str(tmp_path_factory.mktemp("sp_train"))
    weights = {a: _weights(a) for a in ARCHS}
    for arch in ARCHS:
        ckpt.save(os.path.join(d, arch), 0,
                  params_from_jax(weights[arch], _cfg(arch), device="cpu"))
    arrays = {f"{c}/{k}": v for c in CASES for k, v in _batch(c).items()}
    arrays["moe_layer/x"] = _moe_x()
    np.savez(os.path.join(d, "sp_train_in.npz"), **arrays)
    with open(os.path.join(d, "sp_train.json"), "w") as f:
        json.dump({"cases": {c: v[0] for c, v in CASES.items()},
                   "microbatch": MICROBATCH,
                   "capacity_factor": CF, "opt": OPT,
                   "moe_layer": {"arch": MOE, "capacity_factors":
                                 MOE_CFS}}, f)
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(spawn, "sp_train", 8, d)
        ref = {a: _reference(a, weights[a]) for a in REFERENCE}
        one = {c: _one_device(c, weights[CASES[c][0]]) for c in CASES}
        return types.SimpleNamespace(weights=weights, ref=ref, one=one,
                                     ranks=ranks.result())


def test_the_padding_is_uneven_across_the_ranks():
    """The premise of the global count: each case's ranks hold different
    numbers of unmasked labels (the split's ranks 16 positions of a row,
    FSDP's a row, the replicas' a row each), so a mean of the ranks'
    means is not the batch's mean."""
    for case, (_, b, s, _) in CASES.items():
        labels = _batch(case)["labels"]
        if case in SPLIT:
            pieces = labels.reshape(b * M, s // M)
        else:
            pieces = labels
        counts = (pieces != PAD_ID).sum(-1)
        assert len(set(counts.tolist())) > 1, case
        assert 0 in counts.tolist() or case in ARCHS, case


@pytest.mark.parametrize("case", list(CASES))
def test_each_rank_trains_on_its_piece(run, case):
    """Under the split each rank's logits hold 16 positions of its row
    (of a microbatch's row); FSDP's a whole row.  The MoE families take the dense path there, as
    the reference's GSPMD does (its expert parallelism needs the global
    batch to divide the mesh): no all-to-all."""
    arch, b, s, _ = CASES[case]
    vocab = get_smoke_config(arch).vocab
    want = (1, s // M if case in SPLIT else s, vocab)
    for r in run.ranks:
        assert tuple(r[f"{case}/logits_shape"]) == want, case
        kinds = set(r[f"{case}/kinds"])
        assert {"all-gather", "reduce-scatter", "all-reduce"} <= kinds, kinds
        assert "all-to-all" not in kinds or b == 8, kinds


@pytest.mark.parametrize("case", list(CASES))
def test_every_rank_reports_the_global_metrics(run, case):
    """loss, ce, z, aux and the grad norm within rtol 1e-5 (Mamba 1e-4)
    of the one-device step's on every rank, the global token count
    exactly."""
    want = run.one[case][0]
    for r in run.ranks:
        assert int(r[f"{case}/met/tokens"]) == int(want["tokens"]), case
        for k in ("loss", "ce", "z", "aux", "grad_norm"):
            np.testing.assert_allclose(float(r[f"{case}/met/{k}"]),
                                       float(want[k]), rtol=_tol(case),
                                       atol=1e-12, err_msg=f"{case} {k}")


@pytest.mark.parametrize("case", list(CASES))
def test_grads_and_update_equal_one_device(run, case):
    """Each parameter's gradient (the ranks' mean) within 1e-5 of its
    largest |g| (Mamba 1e-4) of the one-device step's.  Its update: the
    mesh's new value equals one device's ``optim.update`` applied to the
    mesh's own gradients within 1e-5 of the largest update and one
    float32 ulp of the parameter (ZeRO's update is the same arithmetic on
    pieces, but its clip scale comes from a norm summed in another order,
    so p + update may round the other way), and the one-device step's update
    within 1e-3 of the largest update wherever the one-device gradient
    is above 1e-6: AdamW's update g / (|g| + 1e-8) is about lr for every
    larger gradient, but tracks a gradient at rounding level (~1e-8 in
    leaves whose largest |g| is ~1e-2) as closely as its rounding."""
    arch = CASES[case][0]
    _, grads, before, after = run.one[case]
    r0 = run.ranks[0]
    cfg = _cfg(arch)
    model = params_from_jax(run.weights[arch], cfg, device="cpu")
    optim.update(AdamWConfig(**OPT),
                 {n: torch.from_numpy(r0[f"{case}/grad/{n}"])
                  for n in before}, optim.init(AdamWConfig(**OPT), model),
                 model)
    mesh_update = dict(model.named_parameters())
    for name, p0 in before.items():
        g, want = r0[f"{case}/grad/{name}"], grads[name].numpy()
        assert np.max(np.abs(g - want)) <= \
            _tol(case) * np.max(np.abs(want)) + 1e-30, (case, name)
        got = r0[f"{case}/param/{name}"] - p0.numpy()
        upd = (after[name] - p0).numpy()
        largest = np.max(np.abs(upd))
        own = (mesh_update[name].detach() - p0).numpy()
        ulp = np.spacing(np.abs(r0[f"{case}/param/{name}"]))
        assert np.all(np.abs(got - own) <= 1e-5 * largest + ulp), \
            (case, name)
        big = np.abs(want) > 1e-6
        assert np.max(np.abs(got - upd)[big], initial=0) <= \
            1e-3 * largest, (case, name)


@pytest.mark.parametrize("arch", REFERENCE)
def test_split_step_equals_the_reference(run, arch):
    """The sequence-split step against the reference's jitted one-device
    loss and grads: rtol and atol 1e-5 of the leaf's largest |g| (1e-4
    for falcon-mamba-7b); the loss, ce and z within the same rtol."""
    val, met, want_g = run.ref[arch]
    tol = _tol(arch)
    for r in run.ranks:
        np.testing.assert_allclose(float(r[f"{arch}/met/loss"]), val,
                                   rtol=tol)
        for k in ("ce", "z"):
            np.testing.assert_allclose(float(r[f"{arch}/met/{k}"]),
                                       float(met[k]), rtol=tol)
        assert int(r[f"{arch}/met/tokens"]) == int(met["tokens"])
    cfg = _cfg(arch)
    model = get_model(cfg).init(0, device="cpu")
    r0 = run.ranks[0]
    for key, leaf in leaf_map(model, cfg).items():
        rows = [r0[f"{arch}/grad/{n}"] for n in leaf.names]
        g = np.stack(rows) if leaf.stacked else rows[0]
        w = want_g[key]
        np.testing.assert_allclose(g, w, rtol=tol,
                                   atol=tol * float(np.abs(w).max()),
                                   err_msg=key)


@pytest.mark.parametrize("cf", MOE_CFS)
def test_moe_layer_routes_each_ranks_tokens(run, cf):
    """The first MoE layer under the split (the dense path, its expert
    banks gathered): each rank routes its own 16 positions at a capacity
    from their count, so its output equals the port's one-device
    ``moe_apply`` on those positions alone (rtol 1e-6 of the largest),
    and its aux loss is the global batch's: the reference's ``moe_apply``
    on the whole x (rtol 1e-5; the aux does not depend on the capacity).
    At capacity factor 8 nothing is dropped and the ranks' outputs are the
    reference's on the whole x (1e-5 of the largest); at 0.25 the
    reference takes one capacity from all 128 tokens (16 slots an expert
    for 32 pairs on average) where a rank takes its own from its 16 (the
    floor of 8 slots for 4 pairs), so they drop different pairs, and the
    outputs differ by more than 1e-2 of the largest: the divergence
    ROADMAP queue 3 records."""
    from repro.models.moe import moe_apply as ref_moe_apply
    from repro_torch.models.moe import moe_apply
    x = _moe_x()
    rcfg = dataclasses.replace(_ref_cfg(MOE), capacity_factor=cf)
    ref_p = {k: jnp.asarray(v[0]) for k, v in
             run.weights[MOE]["layers"]["moe"].items()}
    want, want_aux = ref_moe_apply(ref_p, jnp.asarray(x), rcfg)
    want = np.asarray(want)
    cfg = dataclasses.replace(_cfg(MOE), capacity_factor=cf)
    one = params_from_jax(run.weights[MOE], cfg, device="cpu").layers[0].moe
    n = x.shape[1] // M
    got = np.zeros_like(want)
    for r in run.ranks:
        row, j = r["coord"]
        xr = x[row:row + 1, j * n:(j + 1) * n]
        y = r[f"moe_layer/{cf}/out"]
        with torch.no_grad():
            alone = moe_apply(one, torch.from_numpy(xr), cfg)[0].numpy()
        assert np.max(np.abs(y - alone)) <= 1e-6 * np.max(np.abs(alone))
        np.testing.assert_allclose(float(r[f"moe_layer/{cf}/aux"]),
                                   float(want_aux), rtol=1e-5)
        got[row, j * n:(j + 1) * n] = y[0]
    err = np.max(np.abs(got - want)) / np.max(np.abs(want))
    if cf == 8.0:
        assert err <= 1e-5, err
    else:
        assert err > 1e-2, err
