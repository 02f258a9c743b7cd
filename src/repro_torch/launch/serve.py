"""Serving launcher (continuous batching): port of
``src/repro/launch/serve.py``, on CUDA unless ``--device cpu``.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-4b \
      --requests 16 --slots 4
  PYTHONPATH=src python -m repro_torch.launch.serve --arch falcon-mamba-7b
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-moe-30b-a3b
  PYTHONPATH=src python -m repro_torch.launch.serve --arch jamba-v0.1-52b \
      --layers 16

Weights are random (seed 0, drawn on the device); the traffic is the
reference's: prompts of 4-31 tokens from ``RandomState(0)``.  ``--backend``
(default ``kernel``: the hand-written CUDA kernel on the card, its plain
version on the CPU) means, for a dense or MoE arch, the prefill's attention
(``naive``, ``chunked`` or ``kernel``; the decode step attends over the
cache by its one-token path), for falcon-mamba-7b the selective scan of
the prefill and of the decode step (``kernel`` or ``chunked``), and for
jamba-v0.1-52b both: the attention layers' prefill and every Mamba
block's scan.  ``--layers`` cuts the depth at full width, for a model
whose weights do not fit one card (jamba-v0.1-52b's 32 layers take
103.27 GB in bf16; 16 layers, two of its four periods, take 52.17 GB).
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import List, Optional

import numpy as np
import torch

from ..configs import PORTED_ARCH_IDS, get_config, get_smoke_config
from ..device import resolve
from ..models import get_model
from ..models.attention import BACKENDS
from ..models.ssm import SCAN_BACKENDS
from ..serve import Request, Result, ServeLoop


@dataclasses.dataclass
class ServeRun:
    loop: ServeLoop
    results: List[Result]
    seconds: float              # loop.run() to its last token, synchronised

    @property
    def tokens(self) -> int:
        return sum(len(r.tokens) for r in self.results)


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=PORTED_ARCH_IDS, default="qwen3-4b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=256)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the depth to this many layers at full width, "
                    "so that the weights fit the card (a multiple of the "
                    "attention period for jamba-v0.1-52b)")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    ap.add_argument("--backend", choices=BACKENDS, default="kernel",
                    help="dense and MoE archs: the prefill's attention "
                    "(naive, chunked, kernel); falcon-mamba-7b: the "
                    "selective scan of prefill and decode (chunked, "
                    "kernel); jamba-v0.1-52b: both (chunked, kernel)")
    args = ap.parse_args(argv)
    if get_config(args.arch).family in ("ssm", "hybrid") \
            and args.backend not in SCAN_BACKENDS:
        ap.error(f"--backend {args.backend}: {args.arch} takes "
                 f"{', '.join(SCAN_BACKENDS)}")
    if args.layers is not None:
        cfg = (get_smoke_config if args.smoke else get_config)(args.arch)
        if args.layers < 1:
            ap.error(f"--layers {args.layers}: at least one layer")
        if cfg.family == "hybrid" and args.layers % cfg.attn_every:
            ap.error(f"--layers {args.layers}: {args.arch} keeps whole "
                     f"periods, a multiple of attn_every {cfg.attn_every}")
    return args


def run(argv=None) -> ServeRun:
    """Build the model and the loop, submit the requests, serve them all."""
    args = parse_args(argv)
    dev = resolve(args.device)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if args.layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    api = get_model(cfg)
    params = api.init(0, device=dev)
    loop = ServeLoop(api, params, slots=args.slots, max_len=args.max_len,
                     backend=args.backend, device=dev)
    rng = np.random.RandomState(0)
    for r in range(args.requests):
        loop.submit(Request(
            rid=r,
            prompt=rng.randint(1, cfg.vocab,
                               int(rng.randint(4, 32))).astype(np.int32),
            max_new=args.max_new))
    t0 = time.perf_counter()
    results = loop.run()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return ServeRun(loop, results, time.perf_counter() - t0)


def main(argv: Optional[list] = None) -> int:
    out = run(argv)
    print(f"[serve] {len(out.results)} requests, {out.tokens} tokens, "
          f"{out.tokens / out.seconds:.1f} tok/s ({out.loop.slots} slots)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
