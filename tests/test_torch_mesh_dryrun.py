"""The port's dry run over a mesh (``repro_torch.launch.dryrun``), in a
subprocess under a fake process group (its group is process-global, and
the test process must not keep one).

The counterpart of tests/test_dryrun_mini.py's
``test_mini_dryrun_all_families``: a fake group of 8 on a (2, 4) ("data",
"model") mesh, the six families at ``train_4k`` cut to seq 64 and batch 8,
and qwen3-4b's decode at seq 64 and batch 8: 7 results, each with FLOPs
and wire bytes; the train cells all-gather their weights and
reduce-scatter their gradients, the MoE cell runs its all-to-alls, the
decode (tensor parallel) all-gathers and all-reduces activations; the
depth identity holds exactly on the FLOPs and the wire bytes of a train
cell, and on every count of a tensor-parallel decode cell and of a
sequence-parallel prefill cell.  Each family's prefill at seq 64 (batch
8, over both axes, and batch 2, which leaves "model" idle) and decode
at seq 64 and batch 8 carry the reference's layout.  The train cells of
the sequence split, ZeRO's sharded layer stack and the MoE train labels
run in a subprocess of their own, ``tests/test_torch_mesh_dryrun_train.py``
(under ``--dist loadfile`` the two files load two workers).  On the 16 x 16
production mesh at published configs: whisper-base's decode, and the two
decode_32k cells the FSDP stand-in did not fit on 80 GB (moonshot and
qwen2-vl-72b), which fit tensor parallel.

The step the dry run counts also runs for real on 8 spawned gloo ranks
(``torch_mesh_ranks.zero_step``): qwen3-4b's smoke model in float32,
weights all-gathered at use, ZeRO moments, one row of the batch a rank;
its updated parameters, loss and gradient norm against one AdamW step of
the same model and batch on one device.
"""
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.checkpoint import ckpt
from repro_torch.configs import get_smoke_config
from repro_torch.models import get_model
from repro_torch.train import AdamWConfig, make_train_step
from repro_torch.train import init as opt_init
from torch_mesh_ranks import spawn

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src")

SCRIPT = r"""
import dataclasses, json
from repro_torch.configs import SHAPES, get_smoke_config
from repro_torch.launch import dryrun
from repro_torch.roofline.collectives import collective_stats

results, kinds = {}, {}
with dryrun.fake_mesh((2, 4), ("data", "model")) as mesh:
    shape = dataclasses.replace(SHAPES["train_4k"], seq_len=64,
                                global_batch=8)
    ARCHS = ("qwen3-4b", "qwen3-moe-30b-a3b", "falcon-mamba-7b",
             "jamba-v0.1-52b", "whisper-base", "qwen2-vl-72b")
    cells = [(a, "train_4k", shape) for a in ARCHS]
    cells.append(("qwen3-4b", "decode_32k", dataclasses.replace(
        SHAPES["decode_32k"], seq_len=64, global_batch=8)))
    for arch, name, sh in cells:
        recs = []
        c, _ = dryrun.lower_one(get_smoke_config(arch), sh, backend="chunked",
                                remat=True, microbatch=0, mesh=mesh,
                                records=recs)
        st = collective_stats(recs, num_partitions=8)
        key = arch if name == "train_4k" else arch + "-decode"
        results[key] = {"flops": c.flops, "wire": st.wire_bytes}
        kinds[key] = sorted(st.counts)
    _, depth = dryrun.lower_cell(
        "qwen3-4b", "train_4k", mesh=mesh, shape_override=shape,
        cfg_override=dryrun.with_units(get_smoke_config("qwen3-4b"), 4))
    _, depth_decode = dryrun.lower_cell(
        "qwen3-4b", "decode_32k", mesh=mesh, shape_override=cells[-1][2],
        cfg_override=dryrun.with_units(get_smoke_config("qwen3-4b"), 4))
    serving = {}
    for name, b in (("prefill_32k", 8), ("prefill_32k", 2),
                    ("decode_32k", 8)):
        sh = dataclasses.replace(SHAPES[name], seq_len=64, global_batch=b)
        for arch in ARCHS:
            _, info = dryrun.lower_cell(
                arch, name, mesh=mesh, shape_override=sh,
                cfg_override=get_smoke_config(arch), extrapolate=False)
            serving[f"{arch}/{name}/{b}"] = {
                k: info[k] for k in ("layout", "reference_layout", "fits",
                                     "wire_bytes")}
            serving[f"{arch}/{name}/{b}"]["kinds"] = sorted(
                info["roofline"]["collectives"])
    _, depth_sp = dryrun.lower_cell(
        "qwen3-4b", "prefill_32k", mesh=mesh,
        shape_override=dataclasses.replace(SHAPES["prefill_32k"], seq_len=64,
                                           global_batch=2),
        cfg_override=dryrun.with_units(get_smoke_config("qwen3-4b"), 4))
prod = {arch: dryrun.lower_cell(arch, "decode_32k", multi_pod=False,
                                extrapolate=False)[1]
        for arch in ("whisper-base", "moonshot-v1-16b-a3b", "qwen2-vl-72b")}
print("RESULT " + json.dumps({"results": results, "kinds": kinds,
                              "depth": depth, "depth_decode": depth_decode,
                              "depth_sp": depth_sp, "serving": serving,
                              "prod": prod},
                             default=str))
"""


@pytest.fixture(scope="module")
def run():
    env = dict(os.environ, PYTHONPATH=os.path.abspath(SRC))
    out = subprocess.run([sys.executable, "-c", SCRIPT], env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    line = [ln for ln in out.stdout.splitlines()
            if ln.startswith("RESULT ")][0]
    return json.loads(line[len("RESULT "):])


def test_mini_mesh_dryrun_all_families(run):
    results = run["results"]
    assert len(results) == 7
    for arch, r in results.items():
        assert r["flops"] > 0 and r["wire"] > 0, arch


def test_collective_kinds(run):
    for arch, k in run["kinds"].items():
        if not arch.endswith("-decode"):
            assert {"all-gather", "reduce-scatter"} <= set(k), arch
    assert "all-to-all" in run["kinds"]["qwen3-moe-30b-a3b"]
    assert "all-to-all" in run["kinds"]["jamba-v0.1-52b"]
    assert run["kinds"]["qwen3-4b-decode"] == ["all-gather", "all-reduce"]


def test_depth_identity_exact_on_the_wire(run):
    info = run["depth"]
    d = info["depth"]
    assert info["mesh"] == "2x4" and info["chips"] == 8
    assert d["equal"] and d["units"] == 4
    for k in ("flops", "wire_bytes"):
        assert d["extrapolated"][k] == d["full"][k] and \
            d["per_unit"][k] > 0, k
    assert d["full"]["wire_bytes"] == info["wire_bytes"]
    assert info["roofline"]["collective_s"] > 0


def _depth_exact(info, layout):
    d = info["depth"]
    assert info["mesh"] == "2x4" and d["equal"] and d["units"] == 4
    assert info["layout"] == info["reference_layout"] == layout
    for k in ("flops", "bytes", "ops", "wire_bytes"):
        assert d["extrapolated"][k] == d["full"][k] and \
            d["per_unit"][k] > 0, k
    assert sorted(d["equal_keys"]) == ["bytes", "flops", "ops",
                                       "wire_bytes"]


def test_depth_identity_exact_on_every_count_of_a_decode_cell(run):
    """Off the train cells ZeRO shards no moment, so the bytes and the
    ops extrapolate exactly too, and ``lower_cell`` holds them to it: in
    a tensor-parallel decode cell (qwen3-4b at 4 layers, seq 64)."""
    _depth_exact(run["depth_decode"], "tp (fsdp=False), batch over data")


def test_depth_identity_exact_on_every_count_of_a_prefill_cell(run):
    """The same in a sequence-parallel prefill cell (qwen3-4b at 4
    layers, seq 64; its batch of 2 leaves "model" idle)."""
    _depth_exact(run["depth_sp"], "sp, batch over data, sequence over model")


def test_serving_cells_carry_the_reference_layout(run):
    """Every prefill and decode cell of the six families at seq 64 runs
    the reference's layout: decode tensor parallel (all-gathers and
    all-reduces of activations; the Mamba families also reshard their
    state by all-to-alls), a batch of 2 prefilled with the sequence over
    "model" in the dense, moe and vlm families and FSDP in the others, a
    batch of 8 (over both axes) FSDP, its K/V resharded into the cache's
    layout by all-to-alls."""
    serving = run["serving"]
    assert len(serving) == 18
    for key, cell in serving.items():
        arch, name, b = key.split("/")
        assert cell["layout"] == cell["reference_layout"], key
        assert cell["fits"] and cell["wire_bytes"] > 0, key
        if name == "decode_32k":
            assert cell["layout"] == "tp (fsdp=False), batch over data"
            assert {"all-gather", "all-reduce"} <= set(cell["kinds"]), key
            assert ("all-to-all" in cell["kinds"]) == (
                arch in ("falcon-mamba-7b", "jamba-v0.1-52b")), key
        elif b == "8":
            assert cell["layout"] == "fsdp, batch over data+model", key
            assert "all-to-all" in cell["kinds"], key
        elif arch in ("qwen3-4b", "qwen3-moe-30b-a3b", "qwen2-vl-72b"):
            assert cell["layout"] == \
                "sp, batch over data, sequence over model", key
        else:
            assert cell["layout"] == "fsdp, batch over data", key


def test_production_mesh_cell(run):
    """whisper-base's decode_32k cell on 16 x 16 at its published config:
    the batch of 128 over "data" only, and "model" runs the reference's
    tensor parallelism."""
    info = run["prod"]["whisper-base"]
    assert info["mesh"] == "16x16" and info["chips"] == 256
    assert info["layout"] == info["reference_layout"] == \
        "tp (fsdp=False), batch over data"
    assert info["counts"]["flops"] > 0 and info["wire_bytes"] > 0
    assert info["fits"] and info["batch"] == 128


@pytest.mark.parametrize("arch", ["moonshot-v1-16b-a3b", "qwen2-vl-72b"])
def test_tensor_parallel_decode_fits_where_fsdp_did_not(run, arch):
    """The two decode_32k cells on 16 x 16 at their published configs
    whose FSDP stand-in peaked past 80 GB a chip (103.3 and 95.4 GiB)
    fit tensor parallel: the weights stay sharded and each rank holds
    its slice of the cache."""
    info = run["prod"][arch]
    assert info["layout"] == info["reference_layout"]
    assert info["fits"] and info["peak_gib"] < 80, info["peak_gib"]


def test_zero_step_on_eight_ranks_matches_one_device(tmp_path):
    """The mesh step against the one-device step: each parameter's update
    within 1e-3 of its largest one (read: 6.2e-4, float32 rounding of
    weights of ~1 moved by ~3e-6; the gradients are summed in another
    order), the loss (the global batch's on every rank) and the gradient
    norm within rtol 1e-5 (read: 2e-8 and 7e-8)."""
    d = str(tmp_path)
    cfg = dataclasses.replace(get_smoke_config("qwen3-4b"),
                              dtype=torch.float32)
    api = get_model(cfg)
    model = api.init(5, device="cpu")
    ckpt.save(os.path.join(d, "init"), 0, model)
    rng = np.random.default_rng(0)
    batch = {k: rng.integers(0, cfg.vocab, (8, 16)).astype(np.int32)
             for k in ("tokens", "labels")}
    np.savez(os.path.join(d, "step_in.npz"), **batch)
    ranks = spawn("zero_step", 8, d)

    ocfg = AdamWConfig()
    before = [p.detach().clone() for p in model.parameters()]
    step = make_train_step(api, ocfg)
    model, _, met = step(model, opt_init(ocfg, model),
                         {k: torch.from_numpy(v) for k, v in batch.items()})
    after = get_model(cfg).init(0, device="cpu")
    ckpt.restore(os.path.join(d, "after"), after, step=1)
    for (name, want), got, p0 in zip(model.named_parameters(),
                                     after.parameters(), before):
        want, got = want.detach() - p0, got.detach() - p0
        assert float(want.abs().max()) > 0, name
        assert float((got - want).abs().max()) <= \
            1e-3 * float(want.abs().max()), name
    loss = np.mean([float(r["loss"]) for r in ranks])
    assert loss == pytest.approx(float(met["loss"]), rel=1e-5)
    for r in ranks:
        assert float(r["grad_norm"]) == pytest.approx(
            float(met["grad_norm"]), rel=1e-5)
        assert {"all-gather", "reduce-scatter", "all-reduce"} <= \
            set(r["kinds"])
