"""The port's dry run (repro_torch.launch.dryrun) on fake tensors, on the
CPU: every family's train, prefill and decode cell at a tiny shape, the
counted FLOPs of a one-layer dense prefill against a hand count of its
products, the depth identity (outside + L x per layer equals the full
count exactly), a cell that cannot fit one H100, and a skipped cell with
the reference's reason."""
import dataclasses

import pytest

from repro import configs as ref_configs
from repro_torch.configs import SHAPES, ShapeSpec, get_smoke_config
from repro_torch.launch import dryrun

FAMILIES = {"dense": "qwen3-4b", "moe": "qwen3-moe-30b-a3b",
            "ssm": "falcon-mamba-7b", "hybrid": "jamba-v0.1-52b",
            "vlm": "qwen2-vl-72b", "audio": "whisper-base"}
CELL = {"train": "train_4k", "prefill": "prefill_32k", "decode": "decode_32k"}


@pytest.mark.parametrize("kind", sorted(CELL))
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_every_family_cell_counts(family, kind):
    arch = FAMILIES[family]
    cfg = get_smoke_config(arch)
    assert cfg.family == family
    rec = dryrun.run_cell(arch, CELL[kind], cfg_override=cfg,
                          shape_override=ShapeSpec("tiny", 16, 2, kind))
    assert rec["status"] == "ok", rec.get("error")
    c = rec["counts"]
    assert c["flops"] > 0 and c["bytes"] > 0 and c["ops"] > 0
    assert 0 < c["peak_bytes"] and rec["fits"] is True
    assert rec["mesh"] == "1xH100" and rec["chips"] == 1
    row = rec["roofline"]
    assert row["dominant"] in ("compute", "memory")
    assert row["collective_s"] == 0.0 and row["mfu_bound"] > 0


def test_dense_prefill_flops_equal_hand_count():
    """One layer of qwen3-4b's smoke config, a prefill of B x S tokens
    through the chunked attention (one KV block of 512, the prompt padded
    to it): the products are the q, k, v and output projections, the two
    attention products over the padded block, the three MLP products and
    the unembedding of the last position; 2 FLOPs a multiply-add."""
    cfg = dataclasses.replace(get_smoke_config("qwen3-4b"), n_layers=1)
    b, s = 2, 16
    d, h, kv, dh, f, v = (cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.d_head,
                          cfg.d_ff, cfg.vocab)
    block = 512
    hand = (2 * b * s * d * h * dh            # q
            + 2 * 2 * b * s * d * kv * dh     # k, v
            + 2 * b * h * s * block * dh      # q k^T over the padded block
            + 2 * b * h * s * block * dh      # p v
            + 2 * b * s * h * dh * d          # output projection
            + 3 * 2 * b * s * d * f           # gate, up, down
            + 2 * b * 1 * d * v)              # unembedding, last position
    counts, _ = dryrun.lower_one(cfg, ShapeSpec("tiny", s, b, "prefill"),
                                 backend="chunked", remat=True, microbatch=0)
    assert counts.flops == hand


# (arch, units, kind): the train step (remat, AdamW) on a dense stack,
# the prefill on the hybrid's periods
DEPTH = {"qwen3-4b": (4, "train"), "jamba-v0.1-52b": (3, "prefill")}


@pytest.mark.parametrize("arch", sorted(DEPTH))
def test_depth_identity_holds_exactly(arch):
    """Counted at depth 1, 2 and the full depth (L units): outside +
    L x per-unit equals the full count in FLOPs, bytes and ops."""
    units, kind = DEPTH[arch]
    cfg = dryrun.with_units(get_smoke_config(arch), units)
    _, info = dryrun.lower_cell(arch, CELL[kind], cfg_override=cfg,
                                shape_override=ShapeSpec("t", 16, 2, kind))
    d = info["depth"]
    assert info["depth_extrapolated"] and d["units"] == units
    assert d["equal"] and d["extrapolated"] == d["full"]
    assert all(d["per_unit"][k] > 0 for k in dryrun.LINEAR)
    assert d["full"]["flops"] == info["counts"]["flops"]


def test_vlm_train_cell_does_not_fit():
    """qwen2-vl-72b's train_4k cell at its published config: its 72.7 B
    bf16 parameters alone (145 GB) exceed the card's 80 GB, so the
    fit-only count stops before the step runs."""
    rec = dryrun.run_cell("qwen2-vl-72b", "train_4k", fit_only=True)
    assert rec["status"] == "ok", rec.get("error")
    assert rec["fits"] is False and rec["complete"] is False
    assert rec["peak_gib"] * 2**30 > 80e9 and 2 * rec["params"] > 80e9
    assert rec["batch"] == 256 and rec["seq_len"] == 4096


def test_fit_only_counts_in_full_when_the_cell_fits():
    cfg = get_smoke_config("qwen3-4b")
    shape = ShapeSpec("tiny", 16, 2, "train")
    full = dryrun.run_cell("qwen3-4b", "train_4k", cfg_override=cfg,
                           shape_override=shape)
    fit = dryrun.run_cell("qwen3-4b", "train_4k", cfg_override=cfg,
                          shape_override=shape, fit_only=True)
    assert fit["complete"] and fit["fits"]
    assert fit["counts"] == full["counts"]


def test_dense_long_cell_is_na_with_the_reference_reason():
    rec = dryrun.run_cell("qwen3-4b", "long_500k")
    _, why = ref_configs.shape_applies(ref_configs.get_config("qwen3-4b"),
                                       "long_500k")
    assert rec["status"] == "n/a" and rec["reason"] == why and why
    with pytest.raises(ValueError, match="N/A cell"):
        dryrun.lower_cell("qwen3-4b", "long_500k")
    assert SHAPES["long_500k"].seq_len == 524288


def test_main_writes_one_record_per_cell(tmp_path):
    assert dryrun.main(["--arch", "yi-6b", "--shape", "long_500k",
                        "--out", str(tmp_path)]) == 0
    assert [p.name for p in tmp_path.iterdir()] == \
        ["yi-6b_long_500k_1xH100.json"]
