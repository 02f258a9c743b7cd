"""Mamba1 selective-state-space block (falcon-mamba's layer): port of
``src/repro/models/ssm.py``.

The recurrence runs through ``kernels/selective_scan`` with the
discretisation inside the scan (the reference's ``_fused_scan``
formulation), at prefill over the whole prompt and at decode as one step
from the cache's state.  ``backend`` picks the scan: ``"kernel"`` goes
through ``ops.selective_scan_fused`` (the CUDA kernel for CUDA tensors, its
plain version for CPU tensors); ``"chunked"`` runs the plain chunked
version wherever the tensors are (the oracle for the kernel on the card).

Rounding follows the reference op by op: the causal convolution is the sum
of K shifted products plus the bias (not ``F.conv1d``, which sums in
another order and runs in TF32 through cuDNN on the card), ``softplus`` is
``jax.nn.softplus``'s ``logaddexp(x, 0)`` (not ``F.softplus``, whose
threshold changes the function), and ``silu`` is ``layers.silu``.

Decode state per layer: ``h`` [B, Di, N] and ``conv`` [B, K-1, Di], both
float32: the last K-1 inputs of the convolution.

Tensor parallel (``cfg.fsdp`` False on a mesh, ``sharding/tp.py``): the
rank runs its run of Di.  ``in_x``/``in_z``/``dt_proj`` are
column-parallel and the convolution, the scan and the skip run on the
rank's channels; ``x_proj`` and ``out`` are row-parallel, each followed
by a float32 all-reduce.  The state keeps ``cache_specs_tree``'s stored
layout (``h`` with N over ``"model"``, ``conv`` with Di): the scan needs
the rank's channels with every N, so ``h`` is resharded by one
all-to-all in and one out a step (``tp.state_in``/``tp.state_out``).

Sequence parallel (a train forward whose global batch leaves ``"model"``
idle, ``tp.sequence_parallel``): the rank runs its S/m positions; the
convolution's left inputs and the scan's starting state come from the
previous ranks by two all-gathers a layer (``mamba_mix``).
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..device import resolve
from ..kernels.selective_scan import ops as scan_ops
from ..kernels.selective_scan.ref import fused_scan_ref
from ..sharding import tp
from ..sharding.rules import fsdp_params
from .layers import ModelConfig, _param, fill_normal, silu

SCAN_BACKENDS = ("kernel", "chunked")

State = Dict[str, torch.Tensor]


def dt_rank(cfg: ModelConfig) -> int:
    return max(1, -(-cfg.d_model // 16))


class Mamba(nn.Module):
    """Parameters of one block, named as the reference's dict: in_x, in_z
    [D, Di], conv_w [K, Di], conv_b [Di], x_proj [Di, R + 2N], out [Di, D]
    in the model's dtype; dt_proj [R, Di], dt_bias [Di], a_log [Di, N] and
    d_skip [Di] in float32."""

    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        d, di, n, r, dt = (cfg.d_model, cfg.d_inner, cfg.ssm_state,
                           dt_rank(cfg), cfg.dtype)
        f32 = torch.float32
        self.in_x = _param((d, di), dt, device)
        self.in_z = _param((d, di), dt, device)
        self.conv_w = _param((cfg.ssm_conv, di), dt, device)
        self.conv_b = _param((di,), dt, device)
        self.x_proj = _param((di, r + 2 * n), dt, device)
        self.dt_proj = _param((r, di), f32, device)
        self.dt_bias = _param((di,), f32, device)
        self.a_log = _param((di, n), f32, device)
        self.d_skip = _param((di,), f32, device)
        self.out = _param((di, d), dt, device)


def mamba_init(gen: torch.Generator, cfg: ModelConfig) -> Mamba:
    """A block with the reference's distributions, drawn on the
    generator's device (``fill_mamba``)."""
    return fill_mamba(Mamba(cfg, gen.device), gen, cfg)


@torch.no_grad()
def fill_mamba(p: Mamba, gen: torch.Generator, cfg: ModelConfig) -> Mamba:
    """Fill ``p`` in place: dense weights N(0, 1/d_in) (dt_proj N(0, 1/R)
    in float32), conv_w N(0, 0.01), conv_b 0, dt_bias the inverse softplus
    of exp(U(log 1e-3, log 1e-1)), a_log = log(1..N) per channel
    (S4D-real), d_skip 1."""
    r = dt_rank(cfg)
    for w in (p.in_x, p.in_z, p.x_proj, p.out):
        fill_normal(w, gen)
    fill_normal(p.conv_w, gen, 0.1)
    p.conv_b.zero_()
    fill_normal(p.dt_proj, gen, r ** -0.5)
    lo, hi = math.log(1e-3), math.log(1e-1)
    u = torch.rand(p.dt_bias.shape, generator=gen, device=p.dt_bias.device,
                   dtype=torch.float32) * (hi - lo) + lo
    p.dt_bias.copy_(torch.log(torch.exp(torch.exp(u)) - 1.0 + 1e-9))
    n = torch.arange(1, cfg.ssm_state + 1, dtype=torch.float32,
                     device=p.a_log.device)
    p.a_log.copy_(torch.log(n).expand(cfg.d_inner, -1))
    p.d_skip.fill_(1)
    return p


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: logaddexp(x, 0) = max(x, 0) + log1p(exp(-|x|)),
    x itself where x is NaN."""
    return torch.where(torch.isnan(x), x, torch.clamp_min(x, 0)
                       + torch.log1p(torch.exp(-x.abs())))


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 init_state: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Depthwise causal conv along S. x [B,S,Di]; w [K,Di]; init_state
    [B,K-1,Di] (zeros when None)."""
    k, s = w.shape[0], x.shape[1]
    if init_state is None:
        xp = F.pad(x, (0, 0, k - 1, 0))
    else:
        xp = torch.cat([init_state.to(x.dtype), x], dim=1)
    out = xp[:, 0:s] * w[0]
    for i in range(1, k):
        out = out + xp[:, i:i + s] * w[i]
    return out + b


def _ssm_params(p: Mamba, x: torch.Tensor, cfg: ModelConfig):
    """x [B,S,Di] (post-conv, post-silu) -> dt [B,S,Di], B and C [B,S,N],
    all float32."""
    n, r = cfg.ssm_state, dt_rank(cfg)
    proj = tp.row(x, p.x_proj)                                  # [B,S,R+2N]
    dt_in, bc = proj[..., :r], proj[..., r:]
    bmat, cmat = bc[..., :n], bc[..., n:]
    dt = softplus(dt_in.float() @ tp.local(p.dt_proj) + tp.local(p.dt_bias))
    return dt, bmat.float(), cmat.float()


def _scan(dt, bmat, cmat, xc, a_neg, h0, backend: str):
    args = (dt, xc.float(), bmat.contiguous(), cmat.contiguous(), a_neg, h0)
    if backend == "kernel":
        return scan_ops.selective_scan_fused(*args)
    if backend == "chunked":
        return fused_scan_ref(*args)
    raise ValueError(f"scan backend {backend!r}: the ssm family takes "
                     f"{SCAN_BACKENDS}")


def mamba_mix(p: Mamba, x: torch.Tensor, cfg: ModelConfig, h0: torch.Tensor,
              conv_state: Optional[torch.Tensor] = None, *,
              backend: str = "kernel", sp: bool = False
              ) -> Tuple[torch.Tensor, State]:
    """The block over x [B,S,D] from state (h0 [B,Di,N], conv_state
    [B,K-1,Di] or zeros when None) -> (y [B,S,D], the state after the last
    position: {"h", "conv"}, float32, new tensors).  On a mesh the
    block's weights are all-gathered at use (``fsdp_params``), or, with
    ``cfg.fsdp`` False, run tensor parallel on the rank's channels: the
    state then comes and goes in the cache's layout (the module
    docstring).

    With ``sp`` x holds this rank's positions under the sequence split,
    h0 is the state before position 0 of the whole sequence and the
    conv state is zero there (``conv_state`` None): the convolution
    takes its K-1 left inputs from the previous ranks (``tp.prev_rows``),
    and the scan starts from the previous ranks' chunks composed onto h0
    (``tp.prefix_state``): each
    rank first scans its chunk from zero, which maps a state h_in to
    exp(a_neg * sum_t dt_t) * h_in + H (H that scan's last state), then
    scans again from the state the prefix gives it, so the split runs
    the scan twice a layer.  The returned state is then the rank's own
    last position's."""
    p = fsdp_params(p, cfg)
    xi = tp.column(x, p.in_x)                                    # [B,S,Di]
    z = tp.column(x, p.in_z)
    di = xi.shape[-1]
    if sp:
        if conv_state is not None:
            raise ValueError("mamba_mix: the sequence split starts from a "
                             "zero conv state")
        conv_state = tp.prev_rows(xi, cfg.ssm_conv - 1)
    xc = silu(_causal_conv(xi, tp.local(p.conv_w), tp.local(p.conv_b),
                           conv_state))
    dt, bmat, cmat = _ssm_params(p, xc, cfg)
    h = tp.state_in(h0, di, cfg.ssm_state)
    a_neg = -torch.exp(tp.local(p.a_log))
    if sp:
        _, h_chunk = _scan(dt, bmat, cmat, xc, a_neg, torch.zeros_like(h),
                           backend)
        decay = torch.exp(dt.sum(dim=1)[..., None] * a_neg)     # [B,Di,N]
        h = tp.prefix_state(decay, h_chunk, h)
    y, h_last = _scan(dt, bmat, cmat, xc, a_neg, h, backend)
    y = y + xc.float() * tp.local(p.d_skip)
    y = (y * silu(z.float())).to(x.dtype)
    tail = xi if conv_state is None else torch.cat(
        [conv_state.to(xi.dtype), xi], dim=1)
    conv = tail[:, tail.shape[1] - (cfg.ssm_conv - 1):].float()
    return tp.row(y, p.out), {"h": tp.state_out(h_last, h0), "conv": conv}


def mamba_apply(p: Mamba, x: torch.Tensor, cfg: ModelConfig, *,
                backend: str = "kernel", sp: bool = False) -> torch.Tensor:
    """Full-sequence forward from a zero state. x [B,S,D] -> [B,S,D]
    (``sp``: this rank's positions of it, ``mamba_mix``)."""
    h0 = torch.zeros((x.shape[0], cfg.d_inner, cfg.ssm_state),
                     dtype=torch.float32, device=x.device)
    return mamba_mix(p, x, cfg, h0, backend=backend, sp=sp)[0]


# ---------------------------------------------------------------------------
# decode (stateful, O(1)/token)
# ---------------------------------------------------------------------------


def mamba_cache_init(cfg: ModelConfig, batch: int, device=None) -> State:
    dev = resolve(device)
    return {
        "h": torch.zeros((batch, cfg.d_inner, cfg.ssm_state),
                         dtype=torch.float32, device=dev),
        "conv": torch.zeros((batch, cfg.ssm_conv - 1, cfg.d_inner),
                            dtype=torch.float32, device=dev),
    }


def mamba_decode_step(p: Mamba, x: torch.Tensor, cache: State,
                      cfg: ModelConfig, *, backend: str = "kernel"
                      ) -> Tuple[torch.Tensor, State]:
    """x [B,1,D]; cache {"h", "conv"} -> (y [B,1,D], new cache).  The
    reference's one-step update (a_t, b_t, h, the contraction with C) is
    the fused scan at S = 1 from the cache's h: one kernel launch."""
    return mamba_mix(p, x, cfg, cache["h"], cache["conv"], backend=backend)
