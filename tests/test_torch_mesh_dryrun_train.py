"""The train cells of the port's dry run over a mesh
(``repro_torch.launch.dryrun``), in a subprocess under a fake process
group (its group is process-global, and the test process must not keep
one); ``tests/test_torch_mesh_dryrun.py`` holds the serving cells and the
rest.

Each family's train cell at batch 2 on a fake group of 8 on a (2, 4)
("data", "model") mesh, seq 64 (the sequence over "model", the MoE
families on the dense path), exact on the FLOPs and wire bytes at 4
units; the MoE train labels follow the global batch (batch 8 there, and
train_4k's on both production meshes); qwen3-4b's train cell runs in two
microbatches; falcon-mamba-7b's train cell at 8 layers on a (2, 4, 4)
("pod", "data", "model") mesh, where ZeRO shards its moments' layer stack
at the full depth only, is exact on the wire with the update counted at
full depth.
"""
import json
import os
import subprocess
import sys
import types

import pytest

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src")

SCRIPT = r"""
import dataclasses, json
from repro_torch.configs import SHAPES, get_smoke_config
from repro_torch.launch import dryrun

ARCHS = ("qwen3-4b", "qwen3-moe-30b-a3b", "falcon-mamba-7b",
         "jamba-v0.1-52b", "whisper-base", "qwen2-vl-72b")
shape = dataclasses.replace(SHAPES["train_4k"], seq_len=64, global_batch=8)
with dryrun.fake_mesh((2, 4), ("data", "model")) as mesh:
    train_sp = {}
    sh2 = dataclasses.replace(shape, global_batch=2)
    for arch in ARCHS:
        _, info = dryrun.lower_cell(
            arch, "train_4k", mesh=mesh, shape_override=sh2,
            cfg_override=dryrun.with_units(get_smoke_config(arch), 4))
        train_sp[arch] = {k: info[k] for k in ("layout", "reference_layout",
                                               "depth", "wire_bytes")}
        train_sp[arch]["kinds"] = sorted(info["roofline"]["collectives"])
    _, info = dryrun.lower_cell(
        "qwen3-moe-30b-a3b", "train_4k", mesh=mesh, shape_override=shape,
        cfg_override=get_smoke_config("qwen3-moe-30b-a3b"), extrapolate=False)
    train_sp["qwen3-moe-30b-a3b/8"] = {"layout": info["layout"]}
    _, info = dryrun.lower_cell(
        "qwen3-4b", "train_4k", mesh=mesh, microbatch=2,
        shape_override=dataclasses.replace(shape, global_batch=4),
        cfg_override=get_smoke_config("qwen3-4b"), extrapolate=False)
    train_sp["qwen3-4b/4/microbatch2"] = {
        k: info[k] for k in ("layout", "reference_layout", "microbatch")}
with dryrun.fake_mesh((2, 4, 4), ("pod", "data", "model")) as mesh:
    _, zero_stack = dryrun.lower_cell(
        "falcon-mamba-7b", "train_4k", mesh=mesh, shape_override=sh2,
        cfg_override=dryrun.with_units(get_smoke_config("falcon-mamba-7b"),
                                       8))
print("RESULT " + json.dumps({"train_sp": train_sp,
                              "zero_stack": zero_stack}, default=str))
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


@pytest.mark.parametrize("arch", ["qwen3-4b", "qwen3-moe-30b-a3b",
                                  "falcon-mamba-7b", "jamba-v0.1-52b",
                                  "whisper-base", "qwen2-vl-72b"])
def test_train_cells_split_the_sequence(run, arch):
    """Each family's train cell at batch 2 (which leaves "model" idle) and
    seq 64, at 4 units: the sequence over "model", the reference's
    layout; the depth identity exact on FLOPs and wire bytes
    (``MESH_TRAIN_EXACT``; ``lower_cell`` raises otherwise) with the K/V
    and Mamba gathers in every unit; weights gathered, gradients
    reduce-scattered, the loss's counts and sums all-reduced.  The MoE
    families run the dense path there, as the reference does (its expert
    parallelism needs the global batch to divide every chip): no
    all-to-all."""
    cell = run["train_sp"][arch]
    assert cell["layout"] == cell["reference_layout"] == \
        "sp, batch over data, sequence over model"
    d = cell["depth"]
    assert d["equal"] and d["units"] == 4
    for k in ("flops", "wire_bytes"):
        assert d["extrapolated"][k] == d["full"][k] and \
            d["per_unit"][k] > 0, k
    assert d["full"]["wire_bytes"] == cell["wire_bytes"]
    assert {"all-gather", "reduce-scatter", "all-reduce"} <= \
        set(cell["kinds"]), cell["kinds"]
    assert "all-to-all" not in cell["kinds"]


def test_microbatches_split_the_sequence(run):
    """qwen3-4b's train cell at batch 4 over "data" in two microbatches:
    each microbatch's global batch of 2 leaves "model" idle, so each runs
    the sequence split (``use_mesh`` anew for every microbatch)."""
    cell = run["train_sp"]["qwen3-4b/4/microbatch2"]
    assert cell["microbatch"] == 2
    assert cell["layout"] == cell["reference_layout"]


def test_depth_identity_where_zero_shards_the_layer_stack(run):
    """falcon-mamba-7b at 8 layers on a (2, 4, 4) ("pod", "data",
    "model") mesh: ZeRO shards the moments of its [L, Di] leaves on the
    stack dim over pod x data = 8 at 8 layers and on no dim at 1 and 2
    (Di over "model", N = 16 does not divide 8), as falcon-mamba-7b's
    64 layers on 2 x 16 x 16 do, so the update's wire bytes do not
    extrapolate; counted at the full depth beside the extrapolated
    forward and backward, the wire bytes are exact."""
    info = run["zero_stack"]
    d = info["depth"]
    assert info["mesh"] == "2x4x4" and d["units"] == 8 and d["equal"]
    u = d["update_wire_bytes"]
    assert u["full"] != u["1"] + (u["2"] - u["1"]) * 7, u
    for k in ("flops", "wire_bytes"):
        assert d["extrapolated"][k] == d["full"][k], k
    assert info["layout"] == info["reference_layout"] == \
        "sp, batch over pod, sequence over model"


def test_moe_train_layouts_follow_the_global_batch(run):
    """A MoE train cell runs expert parallelism where the global batch
    divides the whole mesh (batch 8 on the (2, 4) mesh, and train_4k's
    256 on 16 x 16) and the dense path where it does not (train_4k's 256
    on 2 x 16 x 16's 512 chips, sequence-split there), as the
    reference's ``moe_ep.ep_applicable`` reads it: the record's label
    says which, and ``ep_applicable`` under the same global batch
    agrees."""
    from repro_torch.configs import ARCH_IDS, SHAPES, get_config
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import PRODUCTION, use_mesh
    from repro_torch.models.moe_ep import ep_applicable
    assert run["train_sp"]["qwen3-moe-30b-a3b/8"]["layout"] == \
        "fsdp+ep, batch over data+model"
    for multi_pod, want in ((False, "fsdp{}, batch over data+model"),
                            (True, "sp, batch over pod+data, sequence "
                                   "over model")):
        shape, axes = PRODUCTION[multi_pod]
        mesh = types.SimpleNamespace(axis_names=axes, axis_sizes=shape)
        for arch in ARCH_IDS:
            cfg = get_config(arch)
            lay = dryrun._layout(cfg, SHAPES["train_4k"], mesh)
            with use_mesh(mesh, global_batch=256):
                ep = cfg.is_moe_arch and ep_applicable(cfg)
            assert lay == want.format("+ep" if ep else ""), (arch, lay)
            assert ep == (cfg.is_moe_arch and not multi_pod), arch
