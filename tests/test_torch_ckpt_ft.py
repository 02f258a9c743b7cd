"""The port's checkpoint, fault tolerance and training launcher
(repro_torch.checkpoint, repro_torch.ft, repro_torch.launch.train), and
the cases of tests/test_train_ckpt_ft.py on the port.

* Every case of the reference's file that its slice covers runs here on
  the port, with the reference's step counts and limits: qwen3-4b's smoke
  config (bf16), ``AdamWConfig(total_steps=50, warmup_steps=2)``, batches
  of 4 x 16 from ``TokenPipeline``.  The port's step updates its model
  and state in place, so a case that starts twice from one state starts
  from copies (``copy.deepcopy``).
* A checkpoint the reference writes of ``(params, opt_state)`` after two
  steps restores into the port, and the port's into the reference, each
  leaf bitwise, with the same keys, dtypes and shapes in both manifests
  (``0/...``, ``1/.step``, ``1/.mu/...``, ``1/.nu/...``, ``1/.err/...``):
  the dense and the hybrid smoke configs in bf16.
* The two launchers at ``--smoke --steps 6 --ckpt-every 2 --crash-at 3``
  on the CPU: each restarts once, each package restores the other's final
  checkpoint, and the first and last losses they print agree within the
  bf16 tolerance, rtol and atol 2e-2 (their weights are random from other
  generators: ``jax.random`` against ``torch.Generator``).
"""
import copy
import dataclasses
import json
import os
import re
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import ckpt as ref_ckpt
from repro.configs import get_smoke_config as ref_get_smoke_config
from repro.data import TokenPipeline as RefTokenPipeline
from repro.launch import train as ref_launch_train
from repro.models import get_model as ref_get_model
from repro.train import AdamWConfig as RefAdamWConfig
from repro.train import init as ref_opt_init
from repro.train import make_train_step as ref_make_train_step
from repro_torch.checkpoint import ckpt
from repro_torch.configs import get_smoke_config
from repro_torch.data import TokenPipeline
from repro_torch.ft import FailurePlan, StragglerMonitor, TrainDriver
from repro_torch.launch import train as launch_train
from repro_torch.models import get_model
from repro_torch.train import AdamWConfig, lr_schedule, make_train_step
from repro_torch.train import init as opt_init
from repro_torch.train.optim import compress_grads

BF16 = dict(rtol=2e-2, atol=2e-2)


def setup_train(arch="qwen3-4b", compress=False, microbatch=0, seed=0):
    cfg = get_smoke_config(arch)
    api = get_model(cfg)
    params = api.init(seed, device="cpu")
    ocfg = AdamWConfig(total_steps=50, warmup_steps=2, compress=compress)
    ostate = opt_init(ocfg, params)
    step = make_train_step(api, ocfg, microbatch=microbatch)
    pipe = TokenPipeline(vocab=cfg.vocab, batch=4, seq=16)
    batch_fn = lambda s: {k: torch.from_numpy(v)
                          for k, v in pipe.batch_at(s).items()}
    return api, params, ostate, step, batch_fn


def run_steps(step, params, ostate, batch_fn, n, start=0):
    losses = []
    for i in range(start, start + n):
        params, ostate, met = step(params, ostate, batch_fn(i))
        losses.append(float(met["loss"]))
    return params, ostate, losses


def _arrays(tree):
    """Every leaf of a checkpointable tree as numpy, by its key."""
    return ckpt._flatten(tree)


# ---------------------------------------------------------------------------
# the reference's cases on the port
# ---------------------------------------------------------------------------


def test_loss_decreases():
    """Overfit ONE fixed batch (the hash-random stream itself is
    unlearnable: its only signal is the uniform marginal)."""
    _, params, ostate, step, batch_fn = setup_train()
    fixed = batch_fn(0)
    _, _, losses = run_steps(step, params, ostate, lambda s: fixed, 8)
    assert losses[-1] < losses[0] - 0.1


def test_microbatch_equivalence():
    """grad accumulation over 2 microbatches == full batch (same data)."""
    _, params, ostate, step1, batch_fn = setup_train(microbatch=0)
    _, params2, ostate2, step2, _ = setup_train(microbatch=2)
    p1, _, l1 = run_steps(step1, params, ostate, batch_fn, 3)
    p2, _, l2 = run_steps(step2, params2, ostate2, batch_fn, 3)
    np.testing.assert_allclose(l1[-1], l2[-1], rtol=2e-2)


def test_compressed_training_converges():
    _, params, ostate, step, batch_fn = setup_train(compress=True)
    fixed = batch_fn(0)
    _, _, losses = run_steps(step, params, ostate, lambda s: fixed, 8)
    assert losses[-1] < losses[0] - 0.1


def test_error_feedback_reduces_bias():
    g = {"w": torch.from_numpy(
        np.random.RandomState(0).randn(64, 64).astype(np.float32))}
    e = {"w": torch.zeros((64, 64))}
    acc = torch.zeros((64, 64))
    acc_exact = torch.zeros((64, 64))
    for _ in range(50):
        gq, e = compress_grads(g, e)
        acc = acc + gq["w"]
        acc_exact = acc_exact + g["w"]
    # with error feedback the accumulated quantized stream tracks the
    # exact sum to within one quantization step
    err = float((acc - acc_exact).abs().max())
    scale = float(g["w"].abs().max()) / 127
    assert err <= 2 * scale * 1.01


def test_lr_schedule_shape():
    cfg = AdamWConfig(lr_peak=1e-3, lr_min=1e-5, warmup_steps=10,
                      total_steps=100)

    def lr(s):
        return float(lr_schedule(cfg, torch.tensor(s, dtype=torch.int32)))
    assert lr(0) == pytest.approx(0.0)
    assert lr(10) == pytest.approx(1e-3, rel=1e-3)
    assert lr(100) == pytest.approx(1e-5, rel=1e-2)


def test_checkpoint_roundtrip_exact():
    """Saved after two steps, restored into a model and state of another
    seed: every leaf equal, ``extra`` kept."""
    _, params, ostate, step, batch_fn = setup_train()
    params, ostate, _ = run_steps(step, params, ostate, batch_fn, 2)
    _, other, other_state, _, _ = setup_train(seed=1)
    with tempfile.TemporaryDirectory() as d:
        ckpt.save(d, 2, (params, ostate), extra={"next_step": 2})
        (p2, o2), extra = ckpt.restore(d, (other, other_state))
        assert extra["next_step"] == 2
        assert p2 is other
        want, got = _arrays((params, ostate)), _arrays((p2, o2))
        assert set(want) == set(got)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        for a, b in zip(params.parameters(), p2.parameters()):
            assert torch.equal(a, b)


def test_crash_restart_bit_identical():
    """Training WITH a crash+restore == training without (determinism)."""
    _, params, ostate, step, batch_fn = setup_train()
    start = copy.deepcopy((params, ostate))
    with tempfile.TemporaryDirectory() as d1:
        drv = TrainDriver(step_fn=step, batch_fn=batch_fn, ckpt_dir=d1,
                          ckpt_every=2)
        p_ref, _, info = drv.run(params, ostate, 6)
        assert info["restarts"] == 0
    with tempfile.TemporaryDirectory() as d2:
        drv = TrainDriver(step_fn=step, batch_fn=batch_fn, ckpt_dir=d2,
                          ckpt_every=2,
                          failure_plan=FailurePlan(at_steps={3: "crash"}))
        p_crash, _, info = drv.run(*start, 6)
        assert info["restarts"] == 1
        assert [h["step"] for h in info["history"]] == [0, 1, 2, 2, 3, 4, 5]
    for a, b in zip(p_ref.parameters(), p_crash.parameters()):
        assert torch.equal(a, b)


def test_atomic_save_never_corrupts():
    with tempfile.TemporaryDirectory() as d:
        tree = {"w": torch.ones((4,))}
        ckpt.save(d, 1, tree)
        # a .tmp dir left behind (simulated crash mid-save) is ignored
        os.makedirs(os.path.join(d, ".tmp-dead"), exist_ok=True)
        assert ckpt.latest_step(d) == 1


def test_straggler_monitor():
    mon = StragglerMonitor(n_hosts=4, factor=2.0, patience=2)
    assert mon.observe([1, 1, 1, 1]) == []
    assert mon.observe([1, 1, 5, 1]) == []       # one strike
    assert mon.observe([1, 1, 5, 1]) == [2]      # second strike -> flagged


def test_restore_refuses_shardings_and_a_foreign_shape(tmp_path):
    _, params, ostate, _, _ = setup_train()
    ckpt.save(str(tmp_path), 1, (params, ostate))
    with pytest.raises(ValueError, match="mesh"):
        ckpt.restore(str(tmp_path), (params, ostate), shardings=object())
    cfg = dataclasses.replace(get_smoke_config("qwen3-4b"), n_layers=3)
    deeper = get_model(cfg).init(0, device="cpu")
    with pytest.raises(ValueError, match=r"checkpoint \(2, "):
        ckpt.restore(str(tmp_path), (deeper, ostate))


# ---------------------------------------------------------------------------
# checkpoints across the two packages
# ---------------------------------------------------------------------------


def _ref_trained(arch, steps=2):
    """The reference's smoke model and state after ``steps`` jitted steps
    on TokenPipeline batches of 4 x 16."""
    cfg = ref_get_smoke_config(arch)
    api = ref_get_model(cfg)
    params = jax.jit(api.init)(jax.random.PRNGKey(0))
    ocfg = RefAdamWConfig(total_steps=50, warmup_steps=2)
    ostate = ref_opt_init(ocfg, params)
    step = jax.jit(ref_make_train_step(api, ocfg))
    pipe = RefTokenPipeline(vocab=cfg.vocab, batch=4, seq=16)
    for s in range(steps):
        params, ostate, _ = step(params, ostate,
                                 {k: jnp.asarray(v)
                                  for k, v in pipe.batch_at(s).items()})
    return params, ostate


def _manifest(d, step):
    with open(os.path.join(d, f"step_{step:08d}", "manifest.json")) as f:
        m = json.load(f)
    return {k: m[k] for k in ("keys", "dtypes", "shapes")}


@pytest.mark.parametrize("arch", ["qwen3-4b", "jamba-v0.1-52b"])
def test_checkpoints_cross_packages_bitwise(arch, tmp_path):
    ref_dir, port_dir = str(tmp_path / "ref"), str(tmp_path / "port")
    rparams, rstate = _ref_trained(arch)
    ref_ckpt.save(ref_dir, 2, (rparams, rstate), extra={"next_step": 2})
    want = dict(np.load(os.path.join(ref_dir, "step_00000002",
                                     "arrays.npz")))
    assert {"1/.step", "0/embed/tok", "1/.mu/embed/tok",
            "1/.nu/final_norm/scale", "1/.err/final_norm/scale"} <= set(want)

    # the reference's checkpoint into the port (another seed's model)
    api, params, ostate, step, batch_fn = setup_train(arch, seed=1)
    ckpt.restore(ref_dir, (params, ostate))
    got = _arrays((params, ostate))
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)

    # the port's checkpoint after two steps of its own into the reference
    params, ostate, _ = run_steps(step, params, ostate, batch_fn, 2)
    ckpt.save(port_dir, 2, (params, ostate), extra={"next_step": 2})
    assert _manifest(port_dir, 2) == _manifest(ref_dir, 2)
    (rp, rs), extra = ref_ckpt.restore(port_dir, (rparams, rstate))
    assert extra == {"next_step": 2}
    mine = _arrays((params, ostate))
    for k, v in ref_ckpt._flatten((rp, rs)).items():
        np.testing.assert_array_equal(v, mine[k], err_msg=k)


def _launch(main, argv, capsys):
    assert main(argv) == 0
    out = capsys.readouterr().out
    m = re.search(r"loss (\S+) -> (\S+), restarts=(\d+)", out)
    assert m, out
    return float(m[1]), float(m[2]), int(m[3])


def test_launchers_restore_each_others_checkpoints(tmp_path, capsys):
    argv = ["--smoke", "--steps", "6", "--ckpt-every", "2", "--crash-at",
            "3"]
    ref_dir, port_dir = str(tmp_path / "ref"), str(tmp_path / "port")
    ref_first, ref_last, ref_restarts = _launch(
        ref_launch_train.main, argv + ["--ckpt-dir", ref_dir], capsys)
    first, last, restarts = _launch(
        launch_train.main, argv + ["--ckpt-dir", port_dir, "--device",
                                   "cpu"], capsys)
    assert ref_restarts == restarts == 1
    np.testing.assert_allclose([first, last], [ref_first, ref_last], **BF16)
    assert ckpt.latest_step(port_dir) == ref_ckpt.latest_step(ref_dir) == 6

    # each package restores the other's final checkpoint
    _, params, ostate, _, _ = setup_train()
    _, extra = ckpt.restore(ref_dir, (params, ostate))
    assert extra == {"next_step": 6} and int(ostate.step) == 6
    got, want = _arrays((params, ostate)), dict(np.load(os.path.join(
        ref_dir, "step_00000006", "arrays.npz")))
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    rcfg = ref_get_smoke_config("qwen3-4b")
    rlike = ref_get_model(rcfg).init(jax.random.PRNGKey(1))
    rlike = (rlike, ref_opt_init(RefAdamWConfig(), rlike))
    (rp, rs), extra = ref_ckpt.restore(port_dir, rlike)
    assert extra == {"next_step": 6} and int(rs.step) == 6
    want = dict(np.load(os.path.join(port_dir, "step_00000006",
                                     "arrays.npz")))
    for k, v in ref_ckpt._flatten((rp, rs)).items():
        np.testing.assert_array_equal(v, want[k], err_msg=k)
