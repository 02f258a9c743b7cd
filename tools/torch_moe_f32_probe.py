#!/usr/bin/env python3
"""Where the float32 MoE layer's card output departs from the CPU's.

    python3 tools/torch_moe_f32_probe.py [--repeats N] [--mode MODE ...]

Builds the layer and the input of
``tests/test_torch_gpu.py::test_moe_apply_on_cuda_equals_cpu_without_a_sync``
(qwen3-moe-30b-a3b's smoke config in float32, weights from seed 0, x from
seed 1) and runs, on the card and on the CPU, each float op of
``models/moe.py``'s dense path alone on the same float32 inputs: the
router product, the three expert products (``_expert_product``) and the
SiLU gate ``silu(hg) * hi``.  Each result is held against the same op in
float64 on the CPU (the largest error as a share of the largest |value|,
beside the float32 rounding bound ``K * 2**-24``); the card's op is run
``--repeats`` times and compared bitwise with its first run; the whole
layer's largest |card - CPU| (what the test holds to 1e-5) is read each
time.  Each ``--mode`` runs in a fresh process: ``test`` sets only
``allow_tf32 = False``, as the test does; ``default`` sets nothing;
``high_then_off`` calls ``torch.set_float32_matmul_precision("high")``
first (a setting another test could leave behind) and then
``allow_tf32 = False``; ``tf32`` turns TF32 on (the size of its error).
The matmul precision settings each mode ends with are printed beside
the readings.  Prints one JSON line a mode.
"""
import argparse
import dataclasses
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODES = ("test", "default", "high_then_off", "tf32")


def _settings() -> dict:
    """The matmul precision switches, each read on its own: PyTorch 2.11
    raises on ``get_float32_matmul_precision()`` once the legacy and the
    new switches were both set, and that error is the reading then."""
    import torch
    reads = {
        "allow_tf32": lambda: torch.backends.cuda.matmul.allow_tf32,
        "float32_matmul_precision": torch.get_float32_matmul_precision,
        "fp16_reduced_reduction": lambda: torch.backends.cuda.matmul
        .allow_fp16_reduced_precision_reduction,
        "bf16_reduced_reduction": lambda: torch.backends.cuda.matmul
        .allow_bf16_reduced_precision_reduction}
    for name, mod in (("cuda.matmul", torch.backends.cuda.matmul),
                      ("cudnn", torch.backends.cudnn),
                      ("mkldnn.matmul", getattr(torch.backends.mkldnn,
                                                "matmul", None))):
        if mod is not None and hasattr(mod, "fp32_precision"):
            reads[f"{name}.fp32_precision"] = \
                lambda mod=mod: mod.fp32_precision
    out = {}
    for name, read in reads.items():
        try:
            out[name] = read()
        except RuntimeError as e:
            out[name] = f"RuntimeError: {str(e)[:80]}"
    return out


def _cpu_model() -> str:
    """The host CPU's model name (the CPU side's kernels follow it)."""
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("model name"):
                    return line.split(":", 1)[1].strip()
    except OSError:
        pass
    return "unknown"


def probe(mode: str, repeats: int) -> dict:
    import torch
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import moe
    from repro_torch.models.layers import silu
    if mode == "high_then_off":
        torch.set_float32_matmul_precision("high")
    if mode in ("test", "high_then_off"):
        torch.backends.cuda.matmul.allow_tf32 = False
    if mode == "tf32":
        torch.backends.cuda.matmul.allow_tf32 = True
    dev = torch.device("cuda")
    cfg = dataclasses.replace(get_smoke_config("qwen3-moe-30b-a3b"),
                              dtype=torch.float32)
    gen = torch.Generator(device="cpu").manual_seed(0)
    p = moe.fill_moe(moe.MoE(cfg, "cpu").requires_grad_(False), gen)
    pg = moe.MoE(cfg, "cpu").requires_grad_(False)
    pg.load_state_dict(p.state_dict())
    pg = pg.to(dev)
    x = torch.randn(4, 32, cfg.d_model,
                    generator=torch.Generator().manual_seed(1))
    xt = x.reshape(128, -1)
    t, k = xt.shape[0], cfg.top_k
    cap = moe._capacity(t, cfg)
    _, _, keep, slot, _ = moe.route(p, xt, cfg, cap)
    # the dispatch buffer of the CPU run: the expert products' input
    tok = torch.arange(t)[:, None].expand(t, k).reshape(-1)
    rows = torch.where(keep[:, None], xt[tok], 0)
    buf = torch.zeros((cfg.n_experts * cap, cfg.d_model)).index_add_(
        0, torch.where(keep, slot, cfg.n_experts * cap - 1), rows)
    buf = buf.reshape(cfg.n_experts, cap, cfg.d_model)
    hg = moe._expert_product(buf, p.wg)
    hi = moe._expert_product(buf, p.wi)
    h = silu(hg) * hi
    gate_fn = lambda a, b: silu(a) * b                   # noqa: E731
    # name: (the port's op, its float64 version, its float32 inputs)
    ops = {
        "router": (torch.matmul, torch.matmul, (xt, p.router)),
        "expert_wg": (moe._expert_product, torch.bmm, (buf, p.wg)),
        "expert_wi": (moe._expert_product, torch.bmm, (buf, p.wi)),
        "expert_wo": (moe._expert_product, torch.bmm, (h, p.wo)),
        "silu_gate": (gate_fn, gate_fn, (hg, hi)),
    }
    report = {"mode": mode, "settings": _settings(),
              "card": torch.cuda.get_device_name(0),
              "sms": torch.cuda.get_device_properties(0)
              .multi_processor_count,
              "cpu": _cpu_model(),
              "cpu_capability": torch.backends.cpu.get_cpu_capability(),
              "torch": torch.__version__, "cuda": torch.version.cuda,
              "ops": {}}
    for name, (fn, fn64, args) in ops.items():
        want = fn64(*(a.double() for a in args))
        scale = float(want.abs().max())
        cpu = fn(*args)
        cards = [fn(*(a.to(dev) for a in args)).cpu()
                 for _ in range(repeats)]
        # a product's K terms; the gate's sigmoid, sum, quotient and two
        # products
        kdim = args[0].shape[-1] if name != "silu_gate" else 5
        report["ops"][name] = {
            "card_err": float((cards[0].double() - want).abs().max())
            / scale,
            "cpu_err": float((cpu.double() - want).abs().max()) / scale,
            "card_vs_cpu": float((cards[0] - cpu).abs().max()),
            "f32_bound": kdim * 2.0 ** -24,
            "repeat_bitwise": all(torch.equal(c, cards[0]) for c in cards)}
    want_out = moe.moe_apply(p, x, cfg)[0]
    report["layer_card_vs_cpu"] = [
        float((moe.moe_apply(pg, x.to(dev), cfg)[0].cpu() - want_out)
              .abs().max()) for _ in range(repeats)]
    return report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--mode", nargs="+", default=list(MODES),
                    choices=MODES)
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("torch_moe_f32_probe: no CUDA device", file=sys.stderr)
        return 2
    if args.child:
        print(json.dumps(probe(args.mode[0], args.repeats)))
        return 0
    for mode in args.mode:       # each mode in a fresh process
        out = subprocess.run([sys.executable, os.path.abspath(__file__),
                              "--child", "--mode", mode, "--repeats",
                              str(args.repeats)], capture_output=True,
                             text=True, timeout=600)
        if out.returncode:
            print(out.stderr[-3000:], file=sys.stderr)
            return out.returncode
        print(out.stdout.strip().splitlines()[-1], flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
