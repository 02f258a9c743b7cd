"""The port's training path (repro_torch.train) against the reference's
(repro.train) on the CPU.

* ``lm_loss`` with pads and an aux loss: rtol 1e-6.  ``lr_schedule``
  over every step against the reference jitted (as its train step runs
  it): rtol 1e-6 with an atol of 1e-6 of ``lr_peak``: XLA's CPU cos is
  not PyTorch's and differs from it by an ulp at some angles, which the
  cosine's ``lr_min + k (1 + cos)`` carries to up to 2.6e-6 of lr where
  ``1 + cos`` nears 0 at the end of the schedule (3e-11 absolute).
* ``update`` alone on identical numpy grads, moments and params of the
  hybrid smoke model (stacked period slots, Mamba's 1-D stacked leaves,
  the float32 router, ``final_norm``), with and without compression, in
  the warmup (lr exact), in the cosine and with the clip active: rtol
  1e-6, with an atol of 1e-6 of the leaf's largest magnitude (a residual's:
  of its ``g clip + e``), for values that are differences of near-equal
  terms (a moment ``b1 m + (1 - b1) g`` where the two cancel, a residual
  ``gf - q s``, a parameter near zero), where an ulp of an input is a
  large share of the result: the cosine's lr (XLA's cos), the clip scale
  (the grad norm sums in another order, within rtol 1e-6), a product that
  XLA fuses into an FMA for some leaves and not others.
* One train step of each family's smoke config in float32 with the
  reference's weights (``params_from_jax``) against the reference's jitted
  ``make_train_step`` (loss and metrics) and its ``jax.value_and_grad``
  (grads, through the leaf map): ``TOL``.  After one AdamW step an update
  is about ``±lr`` for every element, so an element whose gradient is at
  rounding level can flip sign: the parameters after the step are held
  through the grads and ``update`` (the step's new parameters and state
  equal ``update`` applied to the step's own grads, bitwise), not with a
  blanket rtol.
"""
import copy
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as ref_get_smoke_config
from repro.models import get_model as ref_get_model
from repro.train import AdamWConfig as RefAdamWConfig
from repro.train import init as ref_opt_init
from repro.train import lr_schedule as ref_lr_schedule
from repro.train import make_train_step as ref_make_train_step
from repro.train import optim as ref_optim
from repro.train.loss import lm_loss as ref_lm_loss
from repro_torch.configs import get_smoke_config
from repro_torch.data import TokenPipeline
from repro_torch.models import get_model
from repro_torch.models.weights import (_flatten, _nest, leaf_map,
                                        params_from_jax, params_to_jax)
from repro_torch.train import (AdamWConfig, OptState, init, lm_loss,
                               lr_schedule, make_train_step, optim, update)

KEY = jax.random.PRNGKey(0)
EXACT = dict(rtol=1e-6, atol=0)
# one train step against the reference, in float32: the loss and the
# metrics; the grads, rtol 1e-5 with an atol of 1e-5 of their leaf's
# largest |g| (a gradient sums over the batch and the layers' products in
# other orders; the largest such spread read is 6.0e-6, jamba's)
TOL = {"metrics": dict(rtol=1e-6, atol=0), "grads": 1e-5}
FAMILIES = {"dense": "qwen3-4b", "moe": "qwen3-moe-30b-a3b",
            "ssm": "falcon-mamba-7b", "hybrid": "jamba-v0.1-52b",
            "vlm": "qwen2-vl-72b", "audio": "whisper-base"}


def _cfgs(arch):
    return (dataclasses.replace(ref_get_smoke_config(arch),
                                dtype=jnp.float32),
            dataclasses.replace(get_smoke_config(arch), dtype=torch.float32))


def _tree(x):
    return jax.tree_util.tree_map(np.asarray, x)


# ---------------------------------------------------------------------------
# loss and schedule
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("aux", [0.0, 0.37])
def test_lm_loss_equals_reference(aux):
    rng = np.random.RandomState(0)
    logits = (rng.standard_normal((3, 7, 50)) * 3).astype(np.float32)
    labels = rng.randint(0, 50, (3, 7)).astype(np.int32)
    labels[0, :2] = -1
    labels[2, 5] = -1
    want_total, want = jax.jit(
        lambda l, y, a: ref_lm_loss(l, y, aux_loss=a))(
            jnp.asarray(logits), jnp.asarray(labels), jnp.float32(aux))
    got_total, got = lm_loss(torch.from_numpy(logits),
                             torch.from_numpy(labels),
                             aux_loss=torch.tensor(aux))
    np.testing.assert_allclose(float(got_total), float(want_total), **EXACT)
    for k in ("ce", "z", "aux"):
        np.testing.assert_allclose(float(got[k]), float(want[k]), **EXACT,
                                   err_msg=k)
    assert int(got["tokens"]) == int(want["tokens"]) == 18
    # a float aux loss and an all-pad batch (denominator 1)
    total, met = lm_loss(torch.from_numpy(logits),
                         torch.full((3, 7), -1, dtype=torch.int32))
    assert float(total) == 0.0 and int(met["tokens"]) == 1


@pytest.mark.parametrize("cfg", [
    dict(total_steps=50, warmup_steps=2),
    dict(lr_peak=1e-3, lr_min=1e-5, warmup_steps=10, total_steps=100),
    dict(total_steps=12, warmup_steps=1),
    dict()])
def test_lr_schedule_equals_reference(cfg):
    rcfg, pcfg = RefAdamWConfig(**cfg), AdamWConfig(**cfg)
    steps = np.arange(0, pcfg.total_steps + 3, dtype=np.int32)
    want = np.asarray(jax.jit(jax.vmap(
        lambda s: ref_lr_schedule(rcfg, s)))(jnp.asarray(steps)))
    got = lr_schedule(pcfg, torch.from_numpy(steps))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6,
                               atol=1e-6 * pcfg.lr_peak)


# ---------------------------------------------------------------------------
# update alone
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _hybrid_tree():
    rcfg, _ = _cfgs("jamba-v0.1-52b")
    return _tree(jax.jit(ref_get_model(rcfg).init)(KEY))


@functools.lru_cache(maxsize=None)
def _ref_update(compress):
    """The reference's update jitted once a compression setting (the step
    is an argument)."""
    cfg = RefAdamWConfig(total_steps=50, warmup_steps=2, compress=compress)
    return jax.jit(lambda g, s, p: ref_optim.update(cfg, g, s, p))


def _hybrid_state(seed, grad_scale, compress, step):
    """The hybrid smoke model (the reference's weights, float32) and
    random numpy grads, moments and residuals per reference leaf; a
    stacked leaf's first row has grads 100x smaller than its others."""
    rcfg, pcfg = _cfgs("jamba-v0.1-52b")
    tree = _hybrid_tree()
    leaves = leaf_map(params_from_jax(tree, pcfg, device="cpu"), pcfg)
    rng = np.random.RandomState(seed)
    grads, mu, nu, err = {}, {}, {}, {}
    for k, leaf in leaves.items():
        g = rng.standard_normal(leaf.shape).astype(np.float32)
        g *= np.float32(10.0 ** rng.uniform(-3, 0) * grad_scale)
        if leaf.stacked:
            g[0] *= np.float32(0.01)
        grads[k] = g
        mu[k] = (rng.standard_normal(leaf.shape) * 1e-3).astype(np.float32)
        nu[k] = (np.abs(rng.standard_normal(leaf.shape)) * 1e-5
                 ).astype(np.float32)
        err[k] = ((rng.standard_normal(leaf.shape) * 1e-4).astype(np.float32)
                  if compress else np.zeros((), np.float32))
    return tree, pcfg, grads, OptState(
        torch.tensor(step, dtype=torch.int32),
        *({k: torch.from_numpy(v.copy()) for k, v in d.items()}
          for d in (mu, nu, err)))


def _port_grads(model, cfg, grads):
    """Numpy grads by reference leaf as the port's grads by parameter."""
    out = {}
    for k, leaf in leaf_map(model, cfg).items():
        out.update(zip(leaf.names, leaf.rows(torch.from_numpy(grads[k]))))
    return out


@pytest.mark.parametrize("compress", [False, True])
@pytest.mark.parametrize("phase,step,grad_scale",
                         [("warmup", 0, 0.003), ("cosine", 4, 0.003),
                          ("clipped", 4, 1.0)])
def test_update_equals_reference(compress, phase, step, grad_scale):
    tree, pcfg, grads, state = _hybrid_state(0, grad_scale, compress, step)
    err0 = {k: v.numpy().copy() for k, v in state.err.items()}
    kw = dict(total_steps=50, warmup_steps=2, compress=compress)
    ref_state = ref_optim.OptState(
        jnp.int32(step), *(jax.tree_util.tree_map(
            jnp.asarray, _nest({k: v.numpy() for k, v in d.items()}))
            for d in (state.mu, state.nu, state.err)))
    want_p, want_s, want_m = _ref_update(compress)(
            jax.tree_util.tree_map(jnp.asarray, _nest(grads)), ref_state,
            jax.tree_util.tree_map(jnp.asarray, tree))
    model = params_from_jax(tree, pcfg, device="cpu")
    _, got_s, got_m = update(AdamWConfig(**kw),
                             _port_grads(model, pcfg, grads), state, model)

    assert int(got_s.step) == step + 1
    np.testing.assert_allclose(float(got_m["grad_norm"]),
                               float(want_m["grad_norm"]), **EXACT)
    assert (float(want_m["grad_norm"]) > 1.0) == (phase == "clipped")
    np.testing.assert_allclose(float(got_m["lr"]), float(want_m["lr"]),
                               **EXACT)
    got_p = _flatten(params_to_jax(model, pcfg), sep="/")
    for name, got, want in (
            ("param", got_p, _flatten(_tree(want_p), sep="/")),
            ("mu", got_s.mu, _flatten(_tree(want_s.mu), sep="/")),
            ("nu", got_s.nu, _flatten(_tree(want_s.nu), sep="/")),
            ("err", got_s.err, _flatten(_tree(want_s.err), sep="/"))):
        assert set(got) == set(want)
        for k in want:
            # a residual gf - q s is held to the scale of gf = g clip + e
            scale = (np.abs(grads[k]).max() + np.abs(err0[k]).max()
                     if name == "err" else np.abs(want[k]).max())
            np.testing.assert_allclose(np.asarray(got[k]), want[k],
                                       rtol=1e-6, atol=1e-6 * float(scale),
                                       err_msg=f"{name} {k}")


def test_update_decays_stacked_norms_but_not_final_norm():
    """With zero grads and moments the step is ``-lr wd p`` on every leaf
    the reference decays (stacked rank >= 2: each layer's norm scales,
    Mamba's dt_bias, conv_b and d_skip) and nothing on ``final_norm``."""
    tree, pcfg, grads, state = _hybrid_state(1, 0.0, False, 0)
    for d in (state.mu, state.nu):
        for v in d.values():
            v.zero_()
    model = params_from_jax(tree, pcfg, device="cpu")
    update(AdamWConfig(total_steps=50, warmup_steps=2),
           _port_grads(model, pcfg, grads), state, model)
    after = _flatten(params_to_jax(model, pcfg), sep="/")
    before = _flatten(tree, sep="/")
    for k in ("period/0/ln1/scale", "period/1/ln2/scale",
              "period/0/mamba/dt_bias", "period/0/mamba/d_skip",
              "embed/tok"):
        assert not np.array_equal(after[k], before[k]), k
    np.testing.assert_array_equal(after["final_norm/scale"],
                                  before["final_norm/scale"])
    assert model.layers[0].ln1.scale.ndim == 1    # decayed all the same


def test_compression_takes_one_scale_per_reference_leaf():
    """Two layers of one stacked leaf, one with grads 100x smaller: their
    int8 step is the leaf's max |g| / 127, so the small layer's residual
    reaches half of that step, far past half of its own."""
    big = torch.randn(64, 32, generator=torch.Generator().manual_seed(0))
    small = big * 0.01
    zero = torch.zeros_like(big)
    deq, err = optim._compress_leaf([small, big], [zero, zero])
    step = float(big.abs().max()) / 127
    assert float(err[0].abs().max()) > 0.25 * step
    assert float(err[0].abs().max()) <= 0.5 * step * (1 + 1e-6)
    assert float(small.abs().max()) / 127 < 0.01 * step * 1.01
    torch.testing.assert_close(deq[0] + err[0], small, rtol=0, atol=1e-7)


# ---------------------------------------------------------------------------
# one train step of every family against the reference
# ---------------------------------------------------------------------------


def _batch(cfg, rng):
    """A TokenPipeline batch (4 x 16) with two labels masked; the vlm
    family's embeddings and M-RoPE positions, the audio family's frames."""
    b = {k: v.copy() for k, v in  # tokens and labels share a buffer
         TokenPipeline(vocab=cfg.vocab, batch=4, seq=16).batch_at(0).items()}
    b["labels"][0, :2] = -1
    if cfg.family == "vlm":
        b["embeds"] = rng.standard_normal((4, 16, cfg.d_model)).astype(
            np.float32)
        b["pos3"] = rng.randint(0, 16, (4, 16, 3)).astype(np.int32)
        del b["tokens"]
    if cfg.family == "audio":
        b["enc_embeds"] = rng.standard_normal(
            (4, cfg.enc_seq, cfg.d_model)).astype(np.float32)
    return b


@pytest.mark.parametrize("family", list(FAMILIES))
def test_train_step_equals_reference(family):
    rcfg, pcfg = _cfgs(FAMILIES[family])
    rapi, papi = ref_get_model(rcfg), get_model(pcfg)
    rparams = jax.jit(rapi.init)(KEY)
    batch = _batch(pcfg, np.random.RandomState(1))
    rbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    ocfg = dict(total_steps=50, warmup_steps=2)

    def ref_loss(params, batch):
        out = rapi.apply(params, {k: v for k, v in batch.items()
                                  if k != "labels"}, backend="chunked")
        return ref_lm_loss(out["logits"], batch["labels"],
                           aux_loss=out.get("aux_loss", 0.0))
    _, want_g = jax.jit(jax.value_and_grad(ref_loss, has_aux=True))(
        rparams, rbatch)
    _, _, want = jax.jit(ref_make_train_step(rapi, RefAdamWConfig(**ocfg)))(
        rparams, ref_opt_init(RefAdamWConfig(**ocfg), rparams), rbatch)

    params = params_from_jax(_tree(rparams), pcfg, device="cpu")
    opt = init(AdamWConfig(**ocfg), params)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    step = make_train_step(papi, AdamWConfig(**ocfg))
    # the step's own grads, read by a first backward pass with its
    # arguments (the CPU runs it again to the same bits)
    p0, o0 = copy.deepcopy(params), copy.deepcopy(opt)
    loss, _ = lm_loss(**_loss_args(papi, p0, tbatch))
    loss.backward()
    grads = {n: torch.zeros_like(p) if p.grad is None else p.grad
             for n, p in p0.named_parameters()}  # vlm: embed is unused
    params, opt, got = step(params, opt, tbatch)

    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]),
                                   **TOL["metrics"], err_msg=k)
    want_g = _flatten(_tree(want_g), sep="/")
    for key, leaf in leaf_map(p0, pcfg).items():
        g = np.stack([grads[n].numpy() for n in leaf.names]) \
            if leaf.stacked else grads[leaf.names[0]].numpy()
        w = want_g[key]
        assert np.isfinite(g).all(), key
        np.testing.assert_allclose(
            g, w, rtol=TOL["grads"],
            atol=TOL["grads"] * float(np.abs(w).max()), err_msg=key)
    # the step is update() of its grads: the same parameters and state
    update(AdamWConfig(**ocfg), grads, o0, p0)
    for (name, a), b in zip(params.named_parameters(), p0.parameters()):
        assert torch.equal(a, b), name
    for d_got, d_want in ((opt.mu, o0.mu), (opt.nu, o0.nu)):
        for k in d_want:
            assert torch.equal(d_got[k], d_want[k]), k


def _loss_args(api, params, batch):
    out = api.apply(params, {k: v for k, v in batch.items()
                             if k != "labels"})
    return dict(logits=out["logits"], labels=batch["labels"],
                aux_loss=out["aux_loss"])
