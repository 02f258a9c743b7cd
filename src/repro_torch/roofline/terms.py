"""Three-term roofline of one step: port of ``src/repro/roofline/terms.py``.

  compute_s    = FLOPs_per_chip / peak_FLOP/s
  memory_s     = bytes_per_chip / HBM_bw
  collective_s = wire_bytes_per_chip / link_bw

The reference reads a compiled XLA program's ``cost_analysis()``; the port
reads ``counting.count``'s ``Counts`` of one eager run on fake tensors.
The two count different things: ``FlopCounterMode`` counts the products
(mm, bmm, sdpa, conv) and no element-wise work (the softmax's or the
scan's exps), which XLA counts; the bytes are each eager op's inputs and
outputs, where XLA counts what its fused kernels move.  So ``compute_s``
is a floor of the products alone and ``memory_s`` the traffic of an
unfused eager run.  The wire bytes are the ring formulas of
``collectives.py`` over the functional collectives recorded in the run
(none on one device).  ``collective_s`` divides them by ``link_bw``,
``hw.ici_link_bw`` unless the caller names another (the mesh dry run
passes ``hw.H100_SCALEOUT_BW``: see there).

MODEL_FLOPS uses 6·N·D (train) or 2·N·D (inference) with N = active
params, D = tokens, plus the attention context term: the ratio
MODEL_FLOPS / counted FLOPs exposes remat and dispatch overhead (about
3/4 with full remat, as the backward recomputes one forward).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch

from .collectives import collective_stats
from .counting import Counts
from .hw import H100, HwSpec


@dataclasses.dataclass
class RooflineReport:
    arch: str
    shape: str
    mesh: str
    chips: int
    flops_per_chip: float
    bytes_per_chip: float
    wire_bytes_per_chip: float
    compute_s: float
    memory_s: float
    collective_s: float
    model_flops_global: float
    peak_bytes_per_chip: float
    collectives: Dict[str, int]
    hw: HwSpec = H100

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def step_time_s(self) -> float:
        """No-overlap upper bound; roofline bound = max(terms)."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_flops_ratio(self) -> float:
        """MODEL_FLOPS / (counted FLOPs x chips)."""
        total = self.flops_per_chip * self.chips
        return self.model_flops_global / total if total else float("nan")

    @property
    def mfu(self) -> float:
        """Model-FLOPs utilization at the roofline bound, over ``hw``'s
        peak."""
        denom = self.step_time_s * self.chips
        if not denom:
            return float("nan")
        return self.model_flops_global / (denom * self.hw.peak_flops_bf16)

    def row(self) -> Dict[str, Any]:
        return {
            "arch": self.arch, "shape": self.shape, "mesh": self.mesh,
            "chips": self.chips,
            "compute_s": self.compute_s, "memory_s": self.memory_s,
            "collective_s": self.collective_s, "dominant": self.dominant,
            "model_flops": self.model_flops_global,
            "useful_ratio": self.useful_flops_ratio,
            "mfu_bound": self.mfu,
            "hbm_gib_per_chip": self.peak_bytes_per_chip / 2**30,
            "collectives": self.collectives,
        }


def raw_counts(counts: Counts, records=(), *, num_partitions: int = 1
               ) -> Dict[str, Any]:
    """(flops, bytes, wire_bytes, collective counts) of one counted call
    and the collectives it dispatched (``collectives.record_collectives``;
    none on one device)."""
    st = collective_stats(records, num_partitions=num_partitions)
    return {"flops": counts.flops, "bytes": counts.bytes,
            "wire_bytes": st.wire_bytes, "counts": st.counts}


def analyze_raw(*, flops: float, byts: float, wire: float,
                counts: Dict[str, int], arch: str, shape: str,
                mesh_name: str, chips: int, model_flops: float,
                peak_bytes: float = float("nan"),
                hw: HwSpec = H100,
                link_bw: Optional[float] = None) -> RooflineReport:
    return RooflineReport(
        arch=arch, shape=shape, mesh=mesh_name, chips=chips,
        flops_per_chip=flops, bytes_per_chip=byts,
        wire_bytes_per_chip=wire,
        compute_s=flops / hw.peak_flops_bf16,
        memory_s=byts / hw.hbm_bw,
        collective_s=wire / (link_bw or hw.ici_link_bw),
        model_flops_global=model_flops,
        peak_bytes_per_chip=peak_bytes,
        collectives=counts, hw=hw)


def peak_memory(counts: Counts) -> float:
    """The most bytes live at once during the counted call."""
    return counts.peak_bytes


def model_flops(cfg, n_params_active: float, tokens: int,
                train: bool) -> float:
    return (6.0 if train else 2.0) * n_params_active * tokens


def model_flops_cell(cfg, shape, n_params_active: float) -> float:
    """Useful FLOPs of one step: weight matmuls (6ND/2ND) + attention
    context term (4·H·Dh·S_kv per token per attention layer, x3 for the
    backward pass) — the latter dominates the 32k cells."""
    train = shape.kind == "train"
    b, s = shape.global_batch, shape.seq_len
    tokens = b * (s if shape.kind in ("train", "prefill") else 1)
    total = (6.0 if train else 2.0) * n_params_active * tokens

    if cfg.family == "ssm":
        n_attn = 0
    elif cfg.family == "hybrid":
        n_attn = cfg.n_layers // cfg.attn_every
    else:
        n_attn = cfg.n_layers
    hdh = cfg.n_heads * cfg.d_head
    mult = 3.0 if train else 1.0
    if shape.kind in ("train", "prefill"):
        s_kv = s / 2.0  # causal average
    else:
        s_kv = float(s)  # decode: full context per new token
    total += mult * n_attn * 4.0 * hdh * s_kv * tokens
    if cfg.family == "audio":
        enc_tokens = b * cfg.enc_seq
        total += mult * (cfg.n_enc_layers or cfg.n_layers) * 4.0 * hdh \
            * cfg.enc_seq * enc_tokens          # encoder self (bidir)
        total += mult * cfg.n_layers * 4.0 * hdh * cfg.enc_seq * tokens
    return total


def count_params(params: torch.nn.Module) -> int:
    return sum(p.numel() for p in params.parameters())


def count_active_params(params: torch.nn.Module, cfg) -> float:
    """Total minus the non-routed fraction of expert banks; a parameter
    is an expert bank's when its leaf in the reference's tree
    (``models/weights.py::leaf_map``) lies under ``moe`` and ends in
    ``wi``, ``wg`` or ``wo``."""
    from ..models.weights import leaf_map
    total = count_params(params)
    if not getattr(cfg, "is_moe_arch", False) or cfg.n_experts == 0:
        return float(total)
    expert = 0
    for key, leaf in leaf_map(params, cfg).items():
        names = key.split("/")
        if "moe" in names and names[-1] in ("wi", "wg", "wo"):
            expert += sum(p.numel() for p in leaf.params)
    return float(total - expert * (1.0 - cfg.top_k / cfg.n_experts))
