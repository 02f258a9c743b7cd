"""Training launcher: port of ``src/repro/launch/train.py``, on CUDA unless
``--device cpu``.

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-4b \
      --steps 200 --batch 8 --seq 256 --smoke

One process on one device; ``--smoke`` takes the reduced config.  The
loop is the fault-tolerant ``TrainDriver``: deterministic data
(``TokenPipeline``), periodic atomic checkpoints in the reference's layout
(a checkpoint of either package loads in the other), crash restart
(``--crash-at``).  Weights are random from seed 0, drawn on the device.
The vlm and audio families train only with ``--smoke``, as in the
reference (their frontends are stubs); the audio family gets zero frame
embeddings.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..configs import ARCH_IDS, get_config, get_smoke_config
from ..data import TokenPipeline
from ..device import resolve
from ..ft import FailurePlan, TrainDriver
from ..models import get_model
from ..train import AdamWConfig, make_train_step
from ..train import init as opt_init


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, default="qwen3-4b")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--microbatch", type=int, default=0)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--ckpt-dir", default="experiments/ckpt")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--crash-at", type=int, default=-1)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    dev = resolve(args.device)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if cfg.family in ("vlm", "audio") and not args.smoke:
        raise SystemExit(f"{cfg.name}: the {cfg.family} family's frontend "
                         f"is a stub and trains only with --smoke, as in "
                         f"the reference")
    api = get_model(cfg)
    params = api.init(0, device=dev)
    n = sum(p.numel() for p in params.parameters())
    print(f"[train] arch={cfg.name} params={n / 1e6:.1f}M "
          f"batch={args.batch}x{args.seq} device={dev}")

    ocfg = AdamWConfig(lr_peak=args.lr, total_steps=args.steps,
                       warmup_steps=max(1, args.steps // 20),
                       compress=args.compress_grads)
    opt = opt_init(ocfg, params)
    step = make_train_step(api, ocfg, microbatch=args.microbatch)
    pipe = TokenPipeline(vocab=cfg.vocab, batch=args.batch, seq=args.seq)

    def upload(x: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(x)
        if dev.type == "cuda":      # pinned: the copy does not wait
            return t.pin_memory().to(dev, non_blocking=True)
        return t

    def batch_fn(s):
        b = pipe.batch_at(s)
        if cfg.family == "audio":
            b["enc_embeds"] = np.zeros(
                (args.batch, cfg.enc_seq, cfg.d_model), np.float32)
        return {k: upload(v) for k, v in b.items()}

    plan = FailurePlan(at_steps={args.crash_at: "crash"}
                       if args.crash_at >= 0 else {})
    drv = TrainDriver(step_fn=step, batch_fn=batch_fn,
                      ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
                      failure_plan=plan)
    t0 = time.time()
    params, opt, info = drv.run(params, opt, args.steps)
    hist = info["history"]
    if hist:
        print(f"[train] {len(hist)} steps in {time.time() - t0:.0f}s, "
              f"loss {hist[0]['loss']:.3f} -> {hist[-1]['loss']:.3f}, "
              f"restarts={info['restarts']}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
