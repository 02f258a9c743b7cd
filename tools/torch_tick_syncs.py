#!/usr/bin/env python3
"""Host syncs of one serving tick that admits nothing, on one GPU.

    python3 tools/torch_tick_syncs.py [--src DIR] [--arch ARCH ...]

Builds each arch at its published width through
``repro_torch.launch.serve`` (random weights, no requests), fills every
slot, and counts the host syncs the CUDA runtime reports during one
``ServeLoop.tick`` (``tick_syncs`` and ``count_syncs`` of
``chip_smoke.py``).  ``--src`` is the ``src`` directory whose
``repro_torch`` is imported (default: this checkout's), so that two trees
can be compared in one run.  Prints one JSON line an arch.
"""
import argparse
import gc
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=os.path.join(ROOT, "src"))
    ap.add_argument("--arch", nargs="+",
                    default=["qwen3-4b", "falcon-mamba-7b"])
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("torch_tick_syncs: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(args.src))
    sys.path.insert(1, ROOT)
    from chip_smoke import tick_syncs
    from repro_torch.launch import serve
    for arch in args.arch:
        served = serve.run(["--arch", arch, "--requests", "0"])
        syncs = tick_syncs(served.loop)
        print(json.dumps({"src": args.src, "arch": arch,
                          "syncs_tick_without_admission": syncs,
                          "gpu": torch.cuda.get_device_name(0)}),
              flush=True)
        del served
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
