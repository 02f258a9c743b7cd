"""End-to-end training driver on the PyTorch port: ~100M-param LM, few
hundred steps, with checkpointing + fault tolerance + deterministic data,
as ``examples/train_lm.py`` does on the JAX package.

  PYTHONPATH=src python examples/torch_train_lm.py --preset small --steps 100
  PYTHONPATH=src python examples/torch_train_lm.py --preset 100m --steps 300
  PYTHONPATH=src python examples/torch_train_lm.py --preset tiny --device cpu

The 100m preset is the deliverable configuration (run it on the card);
``small`` (~13M) and ``tiny`` exercise the identical code path on the CPU.
Use --crash-at to demo restart.  Runs on CUDA unless ``--device cpu``.
Checkpoints go to ``build/train_lm_ckpt`` under the repo by default; a
directory that already holds one resumes from it.  The port's step
updates the model and the optimizer state in place and returns them.
"""
import argparse
import os
import time

import torch

from repro_torch.data import TokenPipeline
from repro_torch.device import resolve
from repro_torch.ft import FailurePlan, TrainDriver
from repro_torch.models import get_model
from repro_torch.models.layers import ModelConfig
from repro_torch.train import AdamWConfig, make_train_step
from repro_torch.train import init as opt_init

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PRESETS = {
    "tiny": ModelConfig(name="tiny-2m", n_layers=2, d_model=128, n_heads=4,
                        n_kv=2, d_head=32, d_ff=512, vocab=4096),
    "small": ModelConfig(name="small-13m", n_layers=6, d_model=384,
                         n_heads=6, n_kv=2, d_head=64, d_ff=1536,
                         vocab=8192),
    "100m": ModelConfig(name="lm-100m", n_layers=12, d_model=768,
                        n_heads=12, n_kv=4, d_head=64, d_ff=3072,
                        vocab=32768, qk_norm=True),
}


def train(cfg, steps: int, batch: int, seq: int, ckpt_dir: str,
          ckpt_every: int, crash_at: int, device) -> dict:
    """``TrainDriver`` over ``steps`` steps of ``TokenPipeline`` batches,
    weights from seed 0, a crash injected at ``crash_at`` (>= 0); -> the
    driver's info, the seconds and the parameter count."""
    api = get_model(cfg)
    params = api.init(0, device=device)
    n_params = sum(p.numel() for p in params.parameters())
    print(f"model {cfg.name}: {n_params / 1e6:.1f}M params, "
          f"batch {batch}x{seq}")

    ocfg = AdamWConfig(total_steps=steps, warmup_steps=steps // 20)
    opt = opt_init(ocfg, params)
    step = make_train_step(api, ocfg)
    pipe = TokenPipeline(vocab=cfg.vocab, batch=batch, seq=seq)

    plan = FailurePlan(at_steps={crash_at: "crash"} if crash_at >= 0 else {})
    drv = TrainDriver(
        step_fn=step,
        batch_fn=lambda s: {k: torch.from_numpy(v).to(device)
                            for k, v in pipe.batch_at(s).items()},
        ckpt_dir=ckpt_dir, ckpt_every=ckpt_every, failure_plan=plan)
    t0 = time.time()
    params, opt, info = drv.run(params, opt, steps)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return {**info, "seconds": time.time() - t0, "n_params": n_params}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", choices=PRESETS, default="small")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--ckpt-dir",
                    default=os.path.join(ROOT, "build", "train_lm_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--crash-at", type=int, default=-1,
                    help="inject a crash at this step (restart demo)")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve(args.device)

    out = train(PRESETS[args.preset], args.steps, args.batch, args.seq,
                args.ckpt_dir, args.ckpt_every, args.crash_at, dev)
    hist, dt = out["history"], out["seconds"]
    tok_s = args.batch * args.seq * len(hist) / dt
    print(f"done: {len(hist)} steps in {dt:.0f}s ({tok_s:.0f} tok/s), "
          f"restarts={out['restarts']}")
    print(f"loss {hist[0]['loss']:.3f} -> {hist[-1]['loss']:.3f}")
    assert hist[-1]["loss"] < hist[0]["loss"], "loss did not improve"
    out["tok_per_s"] = tok_s
    return out


if __name__ == "__main__":
    main()
