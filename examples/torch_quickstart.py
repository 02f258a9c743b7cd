"""Quickstart on the PyTorch port: the paper's experiment through the
unified Experiment API (DESIGN.md §6) + a tiny LM train run, as
``examples/quickstart.py`` does on the JAX package.

  PYTHONPATH=src python examples/torch_quickstart.py                # CUDA
  PYTHONPATH=src python examples/torch_quickstart.py --device cpu

Runs on CUDA unless ``--device cpu``; without a card and without
``--device cpu`` it raises.  The port's train step updates the model and
the optimizer state in place and returns them, so the loop rebinds them
and keeps no older handle.
"""
import argparse

import numpy as np
import torch

from repro_torch.api import Experiment, PolicyConfig
from repro_torch.configs import get_smoke_config
from repro_torch.core import ROUTE_LEGACY, ROUTE_SDN
from repro_torch.data import TokenPipeline
from repro_torch.device import resolve
from repro_torch.models import get_model
from repro_torch.scenarios import get_scenario
from repro_torch.train import AdamWConfig, make_train_step
from repro_torch.train import init as opt_init

TRAIN_STEPS = 30


def simulate(device) -> dict:
    """1. SDN vs legacy on the paper's fat-tree (Tables 2-3): one
    declarative experiment over the 15-job mix; the rows and each lane's
    mean job transmission time."""
    res = Experiment(
        get_scenario("paper-fabric", n_each=5),
        [("SDN", PolicyConfig(routing=ROUTE_SDN, job_concurrency=2)),
         ("legacy", PolicyConfig(routing=ROUTE_LEGACY, job_concurrency=2))],
        device=device).run()
    jr = res.job_report()
    rows = res.rows()
    transmission = [float(np.nanmean(jr["transmission_time"][0, pi]))
                    for pi in range(res.n_policies)]
    for name, row, tr in zip(res.policy_names, rows, transmission):
        print(f"{name:7s} mean job transmission {tr:7.1f} s   "
              f"completion {row['mean_completion_s']:7.1f} s   "
              f"energy {row['energy_kwh']:6.2f} kWh")
    return {"rows": rows, "transmission": transmission}


def train(device, steps: int = TRAIN_STEPS, cfg=None, params=None) -> dict:
    """2. A small LM trained with the port's training stack: smoke
    qwen3-4b (weights from seed 0 unless ``params`` is given) on
    ``TokenPipeline(batch=8, seq=32)``, AdamW over ``TRAIN_STEPS`` steps
    with 3 of warmup; ``steps`` of them are run.  Returns each step's loss
    and lr."""
    cfg = cfg or get_smoke_config("qwen3-4b")
    api = get_model(cfg)
    if params is None:
        params = api.init(0, device=device)
    ocfg = AdamWConfig(total_steps=TRAIN_STEPS, warmup_steps=3)
    opt = opt_init(ocfg, params)
    step = make_train_step(api, ocfg)
    pipe = TokenPipeline(vocab=cfg.vocab, batch=8, seq=32)
    mets = []
    for i in range(steps):
        batch = {k: torch.from_numpy(v).to(device)
                 for k, v in pipe.batch_at(i).items()}
        params, opt, met = step(params, opt, batch)
        mets.append(torch.stack([met["loss"].float(), met["lr"].float()]))
        if i % 10 == 0 or i == steps - 1:
            print(f"step {i:3d}  loss {float(met['loss']):.3f}  "
                  f"lr {float(met['lr']):.2e}")
    loss, lr = torch.stack(mets).double().cpu().T.tolist()
    return {"loss": loss, "lr": lr}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve(args.device)
    out = {"simulate": simulate(dev), "train": train(dev)}
    print("quickstart OK")
    return out


if __name__ == "__main__":
    main()
