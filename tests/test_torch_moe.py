"""The port's MoE layer and moe family (repro_torch.models.moe, the moe
layers of repro_torch.models.transformer) against the reference's
(repro.models.moe, repro.models.transformer) on both MoE smoke configs,
with the reference's weights carried across by ``params_from_jax``.

Tolerances: the routing (expert, keep, slot) and the capacity exactly;
float32 outputs at 1e-5 (the expert products sum in other orders), the
aux loss at rtol 1e-6; bf16 at 2e-2 against the reference run op by op
(``jax.disable_jit``), as the dense family's bf16 tests are held.  The
combine's order of addition is held bit for bit against XLA's
scatter-add.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.configs import get_smoke_config as ref_get_smoke_config
from repro.models import get_model as ref_get_model
from repro.models import moe as ref_moe
from repro.serve import Request as RefRequest
from repro.serve import ServeLoop as RefServeLoop
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.launch import serve as launch_serve
from repro_torch.models import get_model, moe
from repro_torch.models.weights import _flatten, params_from_jax, to_torch
from repro_torch.serve import Request, ServeLoop

MOE_ARCHS = ("qwen3-moe-30b-a3b", "moonshot-v1-16b-a3b")
F32 = dict(rtol=1e-5, atol=1e-5)
BF16 = dict(rtol=2e-2, atol=2e-2)
KEY = jax.random.PRNGKey(0)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _cfgs(arch, dtype):
    ref, port = ref_get_smoke_config(arch), get_smoke_config(arch)
    if dtype == "float32":
        ref = dataclasses.replace(ref, dtype=jnp.float32)
        port = dataclasses.replace(port, dtype=torch.float32)
    return ref, port


def _layer(arch, dtype, seed=0):
    """(reference cfg, its MoE params, port cfg, the port's MoE holding
    the same numbers)."""
    rcfg, pcfg = _cfgs(arch, dtype)
    rp = ref_moe.moe_init(jax.random.PRNGKey(seed), rcfg)
    p = moe.MoE(pcfg, "cpu").requires_grad_(False)
    p.load_state_dict({k: to_torch(v) for k, v in _flatten(
        jax.tree_util.tree_map(np.asarray, rp)).items()})
    return rcfg, rp, pcfg, p


def _x(seed, shape, dtype):
    x = np.random.RandomState(seed).standard_normal(shape).astype(np.float32)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    return jnp.asarray(x).astype(jdt), torch.from_numpy(x).to(tdt)


def _ref_routing(p, x, cfg):
    """The reference's routing, spelled as ``moe_apply`` spells it
    (src/repro/models/moe.py:62-87): (expert [T,k], keep, slot)."""
    t = x.shape[0] * x.shape[1]
    e, k = cfg.n_experts, cfg.top_k
    cap = ref_moe._capacity(t, cfg)
    probs = jax.nn.softmax(x.reshape(t, -1).astype(jnp.float32)
                           @ p["router"], axis=-1)
    _, expert = jax.lax.top_k(probs, k)
    flat_e = expert.reshape(-1)
    counts = jnp.zeros((e,), jnp.int32).at[flat_e].add(1)
    offsets = jnp.concatenate([jnp.zeros((1,), jnp.int32),
                               jnp.cumsum(counts)[:-1]])
    order = jnp.argsort(flat_e, stable=True)
    rank_sorted = jnp.arange(t * k, dtype=jnp.int32) - offsets[flat_e[order]]
    rank = jnp.zeros((t * k,), jnp.int32).at[order].set(rank_sorted)
    keep = rank < cap
    slot = flat_e * cap + jnp.where(keep, rank, 0)
    return np.asarray(expert), np.asarray(keep), np.asarray(slot)


def _hold_routing(rp, jx, rcfg, p, tx, pcfg):
    """The port's routing equals the reference's; returns keep."""
    t = tx.shape[0] * tx.shape[1]
    cap = moe._capacity(t, pcfg)
    want_e, want_keep, want_slot = _ref_routing(rp, jx, rcfg)
    _, expert, keep, slot, _ = moe.route(p, tx.reshape(t, -1), pcfg, cap)
    np.testing.assert_array_equal(expert.numpy(), want_e)
    np.testing.assert_array_equal(keep.numpy(), want_keep)
    np.testing.assert_array_equal(slot.numpy(), want_slot)
    return want_keep


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_apply_f32_routing_output_aux(arch):
    rcfg, rp, pcfg, p = _layer(arch, "float32")
    jx, tx = _x(1, (2, 12, pcfg.d_model), "float32")
    _hold_routing(rp, jx, rcfg, p, tx, pcfg)
    want, want_aux = jax.jit(ref_moe.moe_apply, static_argnums=2)(
        rp, jx, rcfg)
    got, aux = moe.moe_apply(p, tx, pcfg)
    assert got.dtype == torch.float32 and aux.dtype == torch.float32
    np.testing.assert_allclose(_np(got), _np(want), **F32)
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-6)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_apply_bf16(arch):
    rcfg, rp, pcfg, p = _layer(arch, "bfloat16")
    jx, tx = _x(2, (2, 12, pcfg.d_model), "bfloat16")
    with jax.disable_jit():
        want, want_aux = ref_moe.moe_apply(rp, jx, rcfg)
    got, aux = moe.moe_apply(p, tx, pcfg)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(got), _np(want), **BF16)
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-6)


def test_biased_router_drops_as_the_reference():
    """Every token's first choice is expert 0, so 24 tokens overflow its
    capacity of 8: the keep masks are equal and pairs are dropped."""
    rcfg, rp, pcfg, p = _layer("qwen3-moe-30b-a3b", "float32")
    router = np.array(rp["router"])
    router[:, 0] = 1.0
    rp = {**rp, "router": jnp.asarray(router)}
    p.router.data = torch.from_numpy(router)
    x = np.abs(np.random.RandomState(3).standard_normal(
        (2, 12, pcfg.d_model))).astype(np.float32)
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    keep = _hold_routing(rp, jx, rcfg, p, tx, pcfg)
    assert moe._capacity(24, pcfg) == 8
    assert (~keep).sum() > 0
    want, want_aux = ref_moe.moe_apply(rp, jx, rcfg)
    got, aux = moe.moe_apply(p, tx, pcfg)
    np.testing.assert_allclose(_np(got), _np(want), **F32)
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-6)


def test_topk_ties_go_to_the_lower_expert():
    """A zero router gives every expert the same probability: the top k
    are experts 0..k-1 for every token, as ``jax.lax.top_k`` orders ties,
    and the overflow drops the same pairs."""
    rcfg, rp, pcfg, p = _layer("moonshot-v1-16b-a3b", "float32")
    rp = {**rp, "router": jnp.zeros_like(rp["router"])}
    p.router.data.zero_()
    jx, tx = _x(4, (1, 16, pcfg.d_model), "float32")
    keep = _hold_routing(rp, jx, rcfg, p, tx, pcfg)
    _, expert, *_ = moe.route(p, tx.reshape(16, -1), pcfg, 8)
    assert (expert.numpy() == np.arange(pcfg.top_k)).all()
    assert keep.sum() == 2 * 8
    want, _ = ref_moe.moe_apply(rp, jx, rcfg)
    got, _ = moe.moe_apply(p, tx, pcfg)
    np.testing.assert_allclose(_np(got), _np(want), **F32)


def test_combine_adds_in_xla_scatter_order():
    """The combine is bitwise XLA's scatter-add of the k weighted rows into
    their token, jitted and op by op."""
    rng = np.random.RandomState(5)
    t, k, d = 64, 6, 32
    rows = (rng.standard_normal((t * k, d))
            * rng.uniform(1e-3, 1e3, (t * k, 1))).astype(np.float32)
    tok_idx = jnp.repeat(jnp.arange(t), k)

    def scatter(r):
        return jnp.zeros((t, d), jnp.float32).at[tok_idx].add(r)

    got = moe.combine(torch.from_numpy(rows), k).numpy()
    np.testing.assert_array_equal(got, np.asarray(jax.jit(scatter)(rows)))
    with jax.disable_jit():
        np.testing.assert_array_equal(got, np.asarray(scatter(rows)))


@pytest.mark.parametrize("arch,tokens,cap", [
    ("qwen3-moe-30b-a3b", 4, 8), ("qwen3-moe-30b-a3b", 32, 8),
    ("qwen3-moe-30b-a3b", 2048, 168), ("jamba-v0.1-52b", 4, 8),
    ("jamba-v0.1-52b", 32, 8), ("jamba-v0.1-52b", 2048, 328),
    ("moonshot-v1-16b-a3b", 2048, 248)])
def test_capacity_at_full_width(arch, tokens, cap):
    """The capacity at a decode tick of 4 slots, the serving bucket and
    the 2048-token prefill, equal to the reference's."""
    assert moe._capacity(tokens, get_config(arch)) == cap \
        == ref_moe._capacity(tokens, ref_get_config(arch))


def test_fill_moe_scales():
    """Experts N(0, 1/d_in) per [d_in, d_out] matrix (not 1/E), the router
    N(0, 1/D) in float32."""
    cfg = dataclasses.replace(get_smoke_config("qwen3-moe-30b-a3b"),
                              d_model=256, d_ff_expert=64, n_experts=4)
    p = moe.fill_moe(moe.MoE(cfg, "cpu").requires_grad_(False),
                     torch.Generator().manual_seed(0))
    assert p.router.dtype == torch.float32 and p.wi.dtype == torch.bfloat16
    for w, d_in in ((p.router, 256), (p.wi, 256), (p.wg, 256), (p.wo, 64)):
        std = float(w.float().std())
        assert abs(std * d_in ** 0.5 - 1) < 0.05, (tuple(w.shape), std)


# ---------------------------------------------------------------------------
# the moe family end to end
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module", params=[(a, d) for a in MOE_ARCHS
                                        for d in ("float32", "bfloat16")],
                ids=lambda p: f"{p[0]}-{p[1]}")
def pair(request):
    arch, dtype = request.param
    rcfg, pcfg = _cfgs(arch, dtype)
    rapi, papi = ref_get_model(rcfg), get_model(pcfg)
    rparams = rapi.init(KEY)
    pparams = params_from_jax(jax.tree_util.tree_map(np.asarray, rparams),
                              pcfg, device="cpu")
    return dtype, rapi, rparams, papi, pparams


def _check(got, want, dtype, label):
    np.testing.assert_allclose(_np(got), _np(want),
                               **(F32 if dtype == "float32" else BF16),
                               err_msg=label)


def _reference(dtype, fn):
    """The reference jitted in float32, op by op in bf16."""
    if dtype == "float32":
        return fn()
    with jax.disable_jit():
        return fn()


def test_layers_hold_moe_in_place_of_mlp(pair):
    _, rapi, rparams, _, pparams = pair
    assert set(rparams["layers"]) == {"ln1", "attn", "ln2", "moe"}
    for layer in pparams.layers:
        assert hasattr(layer, "moe") and not hasattr(layer, "mlp")


def test_lm_apply(pair):
    dtype, rapi, rparams, papi, pparams = pair
    toks = np.random.RandomState(6).randint(0, rapi.cfg.vocab, (2, 12)) \
        .astype(np.int32)
    want = _reference(dtype, lambda: rapi.apply(
        rparams, {"tokens": jnp.asarray(toks)}, remat=False))
    with torch.no_grad():
        got = papi.apply(pparams, {"tokens": torch.from_numpy(toks)})
    for key in ("logits", "hidden"):
        _check(got[key], want[key], dtype, key)
    np.testing.assert_allclose(float(got["aux_loss"]),
                               float(want["aux_loss"]), rtol=1e-6)
    assert float(got["aux_loss"]) > 0


def test_prefill_and_decode(pair):
    """A prefill at each attention backend, then two decode steps, with the
    KV cache and the lengths compared after each."""
    dtype, rapi, rparams, papi, pparams = pair
    b, s, smax = 2, 12, 32
    toks = np.random.RandomState(7).randint(0, rapi.cfg.vocab, (b, s)) \
        .astype(np.int32)
    for backend, ref_backend in (("kernel", "naive"), ("chunked", "chunked")):
        want, rcache = _reference(dtype, lambda: rapi.prefill(
            rparams, {"tokens": jnp.asarray(toks)}, rapi.init_cache(b, smax),
            backend=ref_backend))
        cache = papi.init_cache(b, smax, device="cpu")
        got, cache = papi.prefill(pparams, {"tokens": torch.from_numpy(toks)},
                                  cache, backend=backend)
        _check(got, want, dtype, f"{backend} prefill logits")
        for name in ("k", "v"):
            _check(cache[name], rcache[name], dtype, f"{backend} {name}")
        np.testing.assert_array_equal(cache["len"].numpy(), rcache["len"])
    for step, tok in enumerate((7, 11)):
        t = np.full((b, 1), tok, np.int32)
        want, rcache = _reference(dtype, lambda: rapi.decode_step(
            rparams, jnp.asarray(t), rcache))
        got, cache = papi.decode_step(pparams, torch.from_numpy(t), cache)
        _check(got, want, dtype, f"decode step {step} logits")
        for name in ("k", "v"):
            _check(cache[name], rcache[name], dtype, f"step {step} {name}")
        np.testing.assert_array_equal(cache["len"].numpy(), rcache["len"])


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_serve_loop_tokens_equal_reference(arch):
    """Greedy tokens of the serving loop in float32, the reference's
    loop's settings of tests/test_flows_serve.py (3 prompts of 8 tokens,
    2 slots, max_len 64, bucket 32, max_new 5): pad tokens and an idle
    slot take expert capacity in both."""
    rcfg, pcfg = _cfgs(arch, "float32")
    rapi, papi = ref_get_model(rcfg), get_model(pcfg)
    rparams = rapi.init(KEY)
    pparams = params_from_jax(jax.tree_util.tree_map(np.asarray, rparams),
                              pcfg, device="cpu")
    rng = np.random.RandomState(1)
    prompts = [rng.randint(1, pcfg.vocab, 8).astype(np.int32)
               for _ in range(3)]
    ref_loop = RefServeLoop(rapi, rparams, slots=2, max_len=64, bucket=32)
    loop = ServeLoop(papi, pparams, slots=2, max_len=64, bucket=32,
                     device="cpu")
    results = []
    for lp, req in ((ref_loop, RefRequest), (loop, Request)):
        for i, pr in enumerate(prompts):
            lp.submit(req(rid=i, prompt=pr, max_new=5))
        results.append({r.rid: r.tokens for r in lp.run()})
    assert results[0] == results[1]
    assert sorted(results[1]) == [0, 1, 2]


def test_launcher_serves_the_moe_smoke_config(capsys):
    out = launch_serve.run(["--arch", "qwen3-moe-30b-a3b", "--smoke",
                            "--requests", "3", "--max-new", "2",
                            "--device", "cpu"])
    assert sorted(r.rid for r in out.results) == [0, 1, 2]
    assert all(len(r.tokens) == 3 for r in out.results)
    assert launch_serve.main(["--arch", "moonshot-v1-16b-a3b", "--smoke",
                              "--requests", "2", "--max-new", "1",
                              "--device", "cpu"]) == 0
    assert "2 requests" in capsys.readouterr().out
