"""Every family's ``apply`` is differentiable and takes ``remat``; the ssm
and hybrid families default to the chunked backend, the reference's; the
CUDA kernels refuse autograd instead of cutting the graph.

Port-only checks on each family's smoke config in float32 (weights from
seed 0 on the CPU): every parameter gets a finite gradient through
``lm_loss``, the embedding's and the first layer's are non-zero (an
expert no token reaches may rightly get zeros: only the expert tensor as
a whole is checked), and ``remat=True`` (each layer under
``torch.utils.checkpoint``) gives the logits and gradients of
``remat=False`` bit for bit.
"""
import dataclasses
import inspect
from unittest import mock

import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.data import TokenPipeline
from repro_torch.kernels.flash_attention import kernel as fa_kernel
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.selective_scan import kernel as scan_kernel
from repro_torch.kernels.selective_scan import ops as scan_ops
from repro_torch.models import get_model, hybrid, mamba_lm
from repro_torch.train import lm_loss

FAMILIES = {"dense": "qwen3-4b", "moe": "qwen3-moe-30b-a3b",
            "ssm": "falcon-mamba-7b", "hybrid": "jamba-v0.1-52b",
            "vlm": "qwen2-vl-72b", "audio": "whisper-base"}


def _model(family):
    cfg = dataclasses.replace(get_smoke_config(FAMILIES[family]),
                              dtype=torch.float32)
    api = get_model(cfg)
    return api, api.init(0, device="cpu")


def _batch(cfg):
    b = {k: torch.from_numpy(v.copy()) for k, v in TokenPipeline(
        vocab=cfg.vocab, batch=2, seq=12).batch_at(3).items()}
    if cfg.family == "audio":
        b["enc_embeds"] = torch.from_numpy(np.random.RandomState(0)
                                           .standard_normal(
            (2, cfg.enc_seq, cfg.d_model)).astype(np.float32))
    return b


def _loss_and_grads(api, params, batch, remat):
    params.zero_grad(set_to_none=True)
    out = api.apply(params, {k: v for k, v in batch.items()
                             if k != "labels"}, remat=remat)
    loss, _ = lm_loss(out["logits"], batch["labels"],
                      aux_loss=out["aux_loss"])
    loss.backward()
    return out["logits"].detach(), {n: p.grad.clone()
                                    for n, p in params.named_parameters()}


def _first_layer(params):
    for stack in ("layers", "enc_layers", "dec_layers"):
        if hasattr(params, stack):
            yield from ((f"{stack}.0.{n}", p) for n, p in
                        getattr(params, stack)[0].named_parameters())


@pytest.mark.parametrize("family", list(FAMILIES))
def test_apply_carries_a_graph_to_every_parameter(family):
    api, params = _model(family)
    logits, grads = _loss_and_grads(api, params, _batch(api.cfg), True)
    assert logits.dtype == torch.float32
    assert set(grads) == {n for n, _ in params.named_parameters()}
    for name, g in grads.items():
        assert bool(g.isfinite().all()), name
    nonzero = [("embed.tok", params.embed.tok), *_first_layer(params)]
    assert len(nonzero) > 5
    for name, _ in nonzero:
        assert bool((grads[name] != 0).any()), name


@pytest.mark.parametrize("family", list(FAMILIES))
def test_remat_changes_no_bit(family):
    api, params = _model(family)
    batch = _batch(api.cfg)
    logits, grads = _loss_and_grads(api, params, batch, True)
    logits_nr, grads_nr = _loss_and_grads(api, params, batch, False)
    assert torch.equal(logits, logits_nr)
    for name in grads:
        assert torch.equal(grads[name], grads_nr[name]), name


@pytest.mark.parametrize("fn", [mamba_lm.ssm_lm_apply, hybrid.hybrid_apply])
def test_ssm_and_hybrid_apply_default_to_chunked(fn):
    """The default is the reference's ``"chunked"``: with the kernels'
    entries (the flash and the fused scan) made to fail, ``apply`` without
    a backend runs, and ``backend="kernel"`` reaches them."""
    family = "ssm" if fn is mamba_lm.ssm_lm_apply else "hybrid"
    assert inspect.signature(fn).parameters["backend"].default == "chunked"
    assert inspect.signature(fn).parameters["remat"].default is True
    api, params = _model(family)
    toks = {"tokens": _batch(api.cfg)["tokens"]}
    boom = mock.Mock(side_effect=AssertionError("kernel entry reached"))
    with mock.patch.object(scan_ops, "selective_scan_fused", boom), \
            mock.patch.object(fa_ops, "flash_attention", boom):
        api.apply(params, toks)
        with pytest.raises(AssertionError, match="kernel entry reached"):
            api.apply(params, toks, backend="kernel")


def _scan_inputs(requires_grad):
    b, s, d, n = 1, 4, 8, 4
    t = {"dt": (b, s, d), "x": (b, s, d), "bmat": (b, s, n),
         "cmat": (b, s, n), "a_neg": (d, n), "h0": (b, d, n)}
    out = {k: torch.rand(v) for k, v in t.items()}
    out["dt"].requires_grad_(requires_grad)
    return out


ENTRIES = {
    "flash_attention_fwd": lambda rg: fa_kernel.flash_attention_fwd(
        *(torch.rand(1, 4, 2, 16, requires_grad=rg and i == 0)
          for i in range(3))),
    "selective_scan_f32": lambda rg: scan_kernel.selective_scan_f32(
        torch.rand(1, 4, 8, 4, requires_grad=rg), torch.rand(1, 4, 8, 4),
        torch.rand(1, 4, 4)),
    "selective_scan_fused_f32": lambda rg:
        scan_kernel.selective_scan_fused_f32(**_scan_inputs(rg)),
}


@pytest.mark.parametrize("entry", list(ENTRIES))
def test_kernels_refuse_autograd_before_any_device_check(entry):
    """An input that requires grad under grad mode: the entry raises that
    the kernel has no backward, before it looks at the device (these are
    CPU tensors).  Under ``no_grad``, or with no input requiring grad, it
    gets to the device check."""
    call = ENTRIES[entry]
    with pytest.raises(RuntimeError, match=f"{entry}: .*no backward"):
        call(True)
    with torch.no_grad(), pytest.raises(ValueError, match="CUDA"):
        call(True)
    with pytest.raises(ValueError, match="CUDA"):
        call(False)


def test_plain_versions_stay_differentiable_on_the_cpu():
    """The public wrappers take the plain version for CPU tensors, which
    carries a graph."""
    q = torch.rand(1, 4, 2, 16, requires_grad=True)
    assert fa_ops.flash_attention(q, q, q).grad_fn is not None
    y, h = scan_ops.selective_scan_fused(**_scan_inputs(True))
    assert y.grad_fn is not None and h.grad_fn is not None


def test_remat_runs_again_under_the_callers_mesh():
    """``remat_call``'s run in the backward pass sees the ambient mesh of
    ``use_mesh`` even where autograd runs the backward in a thread of its
    own, as it does on the card: a context variable does not reach that
    thread, and the layer's weights would go ungathered (DTensors meeting
    tensors) there."""
    import threading

    from repro_torch.models.layers import remat_call
    from repro_torch.sharding.mesh import current_mesh, use_mesh
    seen = []

    def layer(x):
        seen.append(current_mesh())
        return x * x
    x = torch.ones(3, requires_grad=True)
    mesh = object()
    with use_mesh(mesh):
        y = remat_call(layer, x, remat=True)
    t = threading.Thread(target=lambda: y.sum().backward())
    t.start()
    t.join(timeout=30)
    assert not t.is_alive()
    assert seen == [mesh, mesh]
    assert torch.equal(x.grad, torch.full((3,), 2.0))
