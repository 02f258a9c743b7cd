"""Continuous-batching serving demo on the PyTorch port: batched requests
through ``ServeLoop``, as ``examples/serve_lm.py`` does on the JAX package.

  PYTHONPATH=src python examples/torch_serve_lm.py --requests 12 --slots 4
  PYTHONPATH=src python examples/torch_serve_lm.py --arch falcon-mamba-7b
  PYTHONPATH=src python examples/torch_serve_lm.py --device cpu

The arch's smoke config with weights from seed 0, drawn on the device.
Runs on CUDA unless ``--device cpu``: there a transformer's prefill runs
the flash-attention kernel and a Mamba model's prefill and decode run the
fused selective scan; on the CPU their plain versions.
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.device import resolve
from repro_torch.models import get_model
from repro_torch.serve import Request, ServeLoop


def requests(n: int, vocab: int, max_new: int) -> list:
    """``n`` requests of 4-23 random tokens from ``RandomState(0)``."""
    rng = np.random.RandomState(0)
    out = []
    for r in range(n):
        plen = int(rng.randint(4, 24))
        out.append(Request(rid=r,
                           prompt=rng.randint(1, vocab, plen)
                           .astype(np.int32),
                           max_new=max_new))
    return out


def serve(api, params, reqs, slots: int, device) -> tuple:
    """Every request through one ``ServeLoop`` (max_len 128); -> (results,
    seconds from the first tick to the last token, synchronised)."""
    loop = ServeLoop(api, params, slots=slots, max_len=128, device=device)
    for req in reqs:
        loop.submit(req)
    t0 = time.time()
    results = loop.run()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return results, time.time() - t0


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--arch", default="qwen3-4b")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve(args.device)

    cfg = get_smoke_config(args.arch)
    api = get_model(cfg)
    params = api.init(0, device=dev)
    results, dt = serve(api, params,
                        requests(args.requests, cfg.vocab, args.max_new),
                        args.slots, dev)
    tokens = sum(len(r.tokens) for r in results)
    print(f"served {len(results)} requests, {tokens} tokens in {dt:.1f}s "
          f"({tokens / dt:.1f} tok/s with {args.slots} slots)")
    for r in sorted(results, key=lambda x: x.rid)[:5]:
        print(f"  rid={r.rid} prefill={r.prefill_len} "
              f"decoded={r.decode_steps} first tokens {r.tokens[:6]}")
    assert len(results) == args.requests
    return {"results": results, "tokens": tokens, "seconds": dt,
            "tok_per_s": tokens / dt}


if __name__ == "__main__":
    main()
