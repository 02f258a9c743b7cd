"""AdamW with a cosine schedule, global-norm clipping and (beyond the
paper) error-feedback int8 gradient compression: port of
``src/repro/train/optim.py``.

The optimizer's unit is the reference's leaf (``models/weights.py::
leaf_map``), not the port's parameter: the reference stacks each layer
parameter over the layers ([L, ...]; the hybrid's period slots over the
periods), so its weight-decay rule (``ndim >= 2``) decays every stacked
per-layer norm scale and Mamba's ``dt_bias``, ``conv_b`` and ``d_skip``,
and spares only the unstacked 1-D leaves (``final_norm``, ``enc_norm``);
and its compression takes one int8 scale over the whole stacked leaf.
``mu``, ``nu`` and ``err`` are float32 tensors of the leaves' stacked
shapes, keyed by the leaf (``layers/attn/wq``); without compression
``err`` holds one float32 scalar zero a leaf, as the reference's does.
``update`` changes the parameters, ``mu``, ``nu`` and ``err`` in place.

Rounding follows the reference's jitted update on XLA's CPU backend, which
contracts float32 ``a * b + c`` into fused multiply-adds (``core/fp.py::
fma32``) and rewrites ``(a / b) / c`` as ``a / (b * c)``: the cosine is
``fma(k, 1 + cos, lr_min)``, the moments are
``fma(b1, m, (1 - b1) g)`` and ``fma(b2, v, ((1 - b2) g) g)``, the step is
``fma(-lr, fma(wd, p, u), p)`` with ``u = m / (b1c (sqrt(v / b2c) +
eps))``, and compression's ``g * clip + e`` and ``e' = gf - q s`` are
fused too.  The element-wise update runs over slices of at most
``_CHUNK`` elements, which bounds its float64 transients whatever the
parameter's size.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Iterable, List, Mapping, NamedTuple, Tuple

import torch

from ..core.fp import fma32
from ..models.weights import leaf_map

_CHUNK = 1 << 24


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr_peak: float = 3e-4
    lr_min: float = 3e-5
    warmup_steps: int = 100
    total_steps: int = 10_000
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    # int8 gradient compression with error feedback, applied to the
    # clipped grads before the moments
    compress: bool = False


class OptState(NamedTuple):
    step: torch.Tensor            # int32 scalar
    mu: Dict[str, torch.Tensor]   # leaf key -> float32 [leaf shape]
    nu: Dict[str, torch.Tensor]
    err: Dict[str, torch.Tensor]  # error-feedback residual (scalar zeros
                                  # without compression)


def lr_schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup to ``lr_peak``, then a cosine to ``lr_min`` at
    ``total_steps``: float32, from the int32 ``step``."""
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    t = torch.clamp((step - cfg.warmup_steps)
                    / max(cfg.total_steps - cfg.warmup_steps, 1), 0, 1)
    cos = fma32(0.5 * (cfg.lr_peak - cfg.lr_min), 1 + torch.cos(math.pi * t),
                cfg.lr_min)
    return warm * torch.where(step < cfg.warmup_steps,
                              torch.full_like(cos, cfg.lr_peak), cos)


def init(cfg: AdamWConfig, params: torch.nn.Module) -> OptState:
    """Zero moments (and residuals) of every leaf of ``params`` (a port
    model: ``params.cfg`` is its config), on its device."""
    leaves = leaf_map(params, params.cfg)
    dev = next(params.parameters()).device

    def zeros(shape):
        return torch.zeros(shape, dtype=torch.float32, device=dev)
    return OptState(
        step=torch.zeros((), dtype=torch.int32, device=dev),
        mu={k: zeros(leaf.shape) for k, leaf in leaves.items()},
        nu={k: zeros(leaf.shape) for k, leaf in leaves.items()},
        err={k: zeros(leaf.shape if cfg.compress else ())
             for k, leaf in leaves.items()})


def global_norm(tensors: Iterable[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of every element's square, in float32."""
    return torch.sqrt(sum(torch.sum(torch.square(t.float()))
                          for t in tensors))


def _quantize_int8(xs: List[torch.Tensor]
                   ) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """One leaf's float32 rows as int8 with one scale, max |x| / 127 over
    the whole leaf: (q a row, scale)."""
    amax = torch.stack([x.abs().amax() for x in xs]).amax()
    scale = torch.clamp_min(amax, 1e-12) / 127.0
    return [torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
            for x in xs], scale


def _compress_leaf(grads: List[torch.Tensor], errs: List[torch.Tensor],
                   scale=1.0) -> Tuple[List[torch.Tensor],
                                       List[torch.Tensor]]:
    """One leaf's rows: gf = g * scale + e, through ``_quantize_int8``;
    returns (deq(q(gf)), gf - deq) a row, both float32."""
    gfs = [fma32(g.float(), scale, e) for g, e in zip(grads, errs)]
    qs, s = _quantize_int8(gfs)
    qs = [q.float() for q in qs]
    return [q * s for q in qs], [fma32(-q, s, gf) for q, gf in zip(qs, gfs)]


def compress_grads(grads: Mapping[str, torch.Tensor],
                   err: Mapping[str, torch.Tensor]
                   ) -> Tuple[Dict[str, torch.Tensor],
                              Dict[str, torch.Tensor]]:
    """Int8 quantisation with error feedback, one scale a tensor:
    g' = deq(q(g + e)) in g's dtype, e' = (g + e) - g' in float32."""
    new_g, new_e = {}, {}
    for k, g in grads.items():
        (deq,), (e,) = _compress_leaf([g], [err[k]])
        new_g[k], new_e[k] = deq.to(g.dtype), e
    return new_g, new_e


def _adamw(cfg: AdamWConfig, p: torch.Tensor, g: torch.Tensor,
           m: torch.Tensor, v: torch.Tensor, lr, b1c, b2c, scale,
           decay: bool) -> None:
    """One parameter's (or one stacked leaf row's) update in place, over
    flat slices of at most ``_CHUNK`` elements.  ``scale`` (the clip
    factor) is None for grads already clipped and compressed."""
    pf, mf, vf, gf = p.view(-1), m.view(-1), v.view(-1), g.reshape(-1)
    for a in range(0, pf.numel(), _CHUNK):
        sl = slice(a, a + _CHUNK)
        gs = gf[sl].float()
        if scale is not None:
            gs = gs * scale
        m_new = fma32(cfg.b1, mf[sl], (1 - cfg.b1) * gs)
        v_new = fma32(cfg.b2, vf[sl], ((1 - cfg.b2) * gs) * gs)
        upd = m_new / (b1c * (torch.sqrt(v_new / b2c) + cfg.eps))
        p32 = pf[sl].float()
        if decay:
            upd = fma32(cfg.weight_decay, p32, upd)
        pf[sl].copy_(fma32(-lr, upd, p32))
        mf[sl].copy_(m_new)
        vf[sl].copy_(v_new)


@torch.no_grad()
def update(cfg: AdamWConfig, grads: Mapping[str, torch.Tensor],
           state: OptState, params: torch.nn.Module
           ) -> Tuple[torch.nn.Module, OptState, Dict[str, torch.Tensor]]:
    """One AdamW step of ``params`` from ``grads`` (keyed by the port's
    parameter names), in place; returns (params, the new state, {"grad_norm",
    "lr"}).  Nothing in it waits for the device."""
    leaves = leaf_map(params, params.cfg)
    rows = {k: [grads[n] for n in leaf.names] for k, leaf in leaves.items()}
    gnorm = global_norm(g for gs in rows.values() for g in gs)
    scale = torch.clamp(
        torch.full_like(gnorm, cfg.clip_norm)
        / torch.clamp_min(gnorm, 1e-12), max=1.0)
    if cfg.compress:
        for k, leaf in leaves.items():
            rows[k], errs = _compress_leaf(rows[k], leaf.rows(state.err[k]),
                                           scale)
            for e, new in zip(leaf.rows(state.err[k]), errs):
                e.copy_(new)
        scale = None

    step = state.step + 1
    lr = lr_schedule(cfg, step)
    sf = step.float()
    b1c = 1 - torch.full_like(sf, cfg.b1) ** sf
    b2c = 1 - torch.full_like(sf, cfg.b2) ** sf
    for k, leaf in leaves.items():
        for p, g, m, v in zip(leaf.params, rows[k], leaf.rows(state.mu[k]),
                              leaf.rows(state.nu[k])):
            _adamw(cfg, p, g, m, v, lr, b1c, b2c, scale,
                   decay=leaf.ndim >= 2)
    metrics = {"grad_norm": gnorm, "lr": lr}
    return params, OptState(step, state.mu, state.nu, state.err), metrics
