"""The port's hybrid (Jamba) LM (repro_torch.models.hybrid) against the
reference's (repro.models.hybrid) on jamba's smoke config (4 layers, an
attention layer every 2, MoE on every second layer), with the
reference's weights carried across by ``params_from_jax``.

Tolerances: in float32, rtol/atol 1e-4 against the jitted reference, the
Mamba LM's (the scans and the expert products sum in other orders); in
bf16, 2e-2 against the reference run op by op (``jax.disable_jit``) only:
the reference's own jitted and op-by-op runs of ``hybrid_apply`` differ
beyond 2e-2 on 3.8 % of the smoke model's logits (up to 0.35), where the
dense and Mamba families' two runs agree within it.  Greedy tokens are
equal.

An op-by-op run compiles each primitive at each new shape (~20 s for the
smoke model's first), so the bf16 cases run shorter prompts, one length
for the forward pass and the prefill.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as ref_get_smoke_config
from repro.models import get_model as ref_get_model
from repro.models import ssm as ref_ssm
from repro.serve import Request as RefRequest
from repro.serve import ServeLoop as RefServeLoop
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.launch import serve as launch_serve
from repro_torch.models import get_model, hybrid, ssm
from repro_torch.models.weights import _flatten, params_from_jax
from repro_torch.serve import Request, ServeLoop

ARCH = "jamba-v0.1-52b"
F32 = dict(rtol=1e-4, atol=1e-4)
BF16 = dict(rtol=2e-2, atol=2e-2)
KEY = jax.random.PRNGKey(0)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _tokens(seed, b, s, vocab):
    return np.random.RandomState(seed).randint(0, vocab, (b, s)).astype(
        np.int32)


@functools.lru_cache(maxsize=None)
def _models(dtype):
    """The reference's model and weights (its init jitted: the weights are
    carried across, so their draw need not be the eager one) and the
    port's model holding the same numbers, once a dtype."""
    rcfg, pcfg = ref_get_smoke_config(ARCH), get_smoke_config(ARCH)
    if dtype == "float32":
        rcfg = dataclasses.replace(rcfg, dtype=jnp.float32)
        pcfg = dataclasses.replace(pcfg, dtype=torch.float32)
    rapi, papi = ref_get_model(rcfg), get_model(pcfg)
    rparams = jax.jit(rapi.init)(KEY)
    pparams = params_from_jax(jax.tree_util.tree_map(np.asarray, rparams),
                              pcfg, device="cpu")
    return rapi, rparams, papi, pparams


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def pair(request):
    return (request.param,) + _models(request.param)


@pytest.fixture(scope="module")
def jamba_f32():
    return _models("float32")


def _check(got, want, dtype, label=""):
    np.testing.assert_allclose(_np(got), _np(want),
                               **(F32 if dtype == "float32" else BF16),
                               err_msg=label)


def _reference(dtype, fn):
    """The reference jitted in float32, op by op in bf16."""
    if dtype == "float32":
        return fn()
    with jax.disable_jit():
        return fn()


def _snapshot(cache):
    return {k: v.clone() for k, v in _flatten(cache).items()}


# ---------------------------------------------------------------------------
# structure and weights
# ---------------------------------------------------------------------------


def test_layer_order_and_kinds(jamba_f32):
    """Slot i of period p is layer p * attn_every + i: attention last in
    each period, MoE where ``moe_layer`` says, with the same numbers as
    the reference's stacked slot."""
    rapi, rparams, papi, pparams = jamba_f32
    cfg = papi.cfg
    assert len(rparams["period"]) == cfg.attn_every
    for li, layer in enumerate(pparams.layers):
        p, i = divmod(li, cfg.attn_every)
        slot = rparams["period"][i]
        assert hasattr(layer, "attn") == ("attn" in slot)
        assert hasattr(layer, "mamba") == ("mamba" in slot)
        assert hasattr(layer, "moe") == ("moe" in slot) == cfg.moe_layer(li)
        mixer = "attn" if "attn" in slot else "mamba"
        np.testing.assert_array_equal(
            getattr(layer, mixer).state_dict()["wo" if mixer == "attn"
                                               else "out"].numpy(),
            np.asarray(slot[mixer]["wo" if mixer == "attn" else "out"][p]))
    full = get_config(ARCH)
    kinds = [("attn" if hybrid._is_attn(full, li) else "mamba",
              full.moe_layer(li)) for li in range(16)]
    assert sum(k == "attn" for k, _ in kinds) == 2
    assert sum(m for _, m in kinds) == 8


def test_init_matches_the_reference_tree():
    """Names, shapes and dtypes of ``init(seed, device="cpu")`` equal the
    reference's tree carried across, and the cache's leaves equal the
    reference's cache's."""
    rapi, _, papi, carried = _models("bfloat16")
    want = carried.state_dict()
    model = papi.init(0, device="cpu")
    got = model.state_dict()
    assert {k: (tuple(v.shape), v.dtype) for k, v in got.items()} == \
        {k: (tuple(v.shape), v.dtype) for k, v in want.items()}
    wo = model.layers[1].moe.state_dict()["wo"]      # detached
    assert abs(float(wo.float().std()) * 128 ** 0.5 - 1) < 0.05
    rcache = _flatten(rapi.init_cache(3, 40))
    pcache = _flatten(papi.init_cache(3, 40, device="cpu"))
    assert {k: tuple(v.shape) for k, v in pcache.items()} == \
        {k: tuple(v.shape) for k, v in rcache.items()}
    assert {k: str(v.dtype).split(".")[-1] for k, v in pcache.items()} == \
        {k: str(v.dtype) for k, v in rcache.items()}


def test_params_from_jax_refuses_a_wrong_period_count(jamba_f32):
    rapi, rparams, papi, _ = jamba_f32
    tree = jax.tree_util.tree_map(np.asarray, rparams)
    cut = dataclasses.replace(papi.cfg, n_layers=2)
    with pytest.raises(ValueError, match="periods"):
        params_from_jax(tree, cut, device="cpu")


def test_mamba_mix_equals_the_reference_prefill_spelling(jamba_f32):
    """The reference's prefill spells the Mamba block inline with
    ``_fused_scan(..., 128)`` (src/repro/models/hybrid.py:180-195): that
    spelling is bitwise the reference's ``mamba_apply`` (which the port's
    ``mamba_mix`` is held against in tests/test_torch_ssm.py), its conv
    tail the last K-1 inputs; the port's block is within 1e-4 of both."""
    rapi, rparams, papi, pparams = jamba_f32
    rcfg, cfg = rapi.cfg, papi.cfg
    p = jax.tree_util.tree_map(lambda a: a[0], rparams["period"][0]["mamba"])
    x = np.random.RandomState(8).standard_normal((2, 150, 64)).astype(
        np.float32)
    h = jnp.asarray(x)

    def inline(h):
        xi = h @ p["in_x"]
        z = h @ p["in_z"]
        xc = jax.nn.silu(ref_ssm._causal_conv(xi, p["conv_w"], p["conv_b"]))
        dt, bmat, cmat = ref_ssm._ssm_params(p, xc, rcfg)
        h0 = jnp.zeros((h.shape[0], rcfg.d_inner, rcfg.ssm_state),
                       jnp.float32)
        y, h_last = ref_ssm._fused_scan(dt, bmat, cmat, xc,
                                        -jnp.exp(p["a_log"]), h0, 128)
        y = y + xc.astype(jnp.float32) * p["d_skip"]
        y = (y * jax.nn.silu(z.astype(jnp.float32))).astype(h.dtype)
        return y @ p["out"], h_last, xi[:, h.shape[1] - 3:, :]

    y, h_last, conv = jax.jit(inline)(h)
    np.testing.assert_array_equal(
        np.asarray(y), np.asarray(jax.jit(
            lambda h: ref_ssm.mamba_apply(p, h, rcfg))(h)))
    block = pparams.layers[0].mamba
    h0 = torch.zeros((2, cfg.d_inner, cfg.ssm_state))
    for backend in ssm.SCAN_BACKENDS:
        got, state = ssm.mamba_mix(block, torch.from_numpy(x), cfg, h0,
                                   backend=backend)
        np.testing.assert_allclose(_np(got), _np(y), **F32)
        np.testing.assert_allclose(_np(state["h"]), _np(h_last), **F32)
        np.testing.assert_allclose(_np(state["conv"]), _np(conv), **F32)


# ---------------------------------------------------------------------------
# the whole model
# ---------------------------------------------------------------------------


# the reference's attention backend for each port backend: on the CPU the
# port's "kernel" runs the flash kernel's plain version, the reference's
# naive attention (the oracle of its Pallas kernel)
REF_BACKEND = {"kernel": "naive", "chunked": "chunked"}
# prompt lengths of the forward pass and of the prefill
SEQ = {"float32": (40, 37), "bfloat16": (24, 24)}


@pytest.mark.parametrize("backend", ["kernel", "chunked"])
def test_hybrid_apply(pair, backend):
    dtype, rapi, rparams, papi, pparams = pair
    toks = _tokens(5, 2, SEQ[dtype][0], rapi.cfg.vocab)
    want = _reference(dtype, lambda: rapi.apply(
        rparams, {"tokens": jnp.asarray(toks)}, remat=False,
        backend=REF_BACKEND[backend]))
    got = papi.apply(pparams, {"tokens": torch.from_numpy(toks)},
                     backend=backend)
    assert got["logits"].dtype == torch.float32
    _check(got["hidden"], want["hidden"], dtype, "hidden")
    _check(got["logits"], want["logits"], dtype, "logits")
    np.testing.assert_allclose(float(got["aux_loss"]),
                               float(want["aux_loss"]),
                               rtol=1e-6 if dtype == "float32" else 2e-2)
    assert float(got["aux_loss"]) > 0


@pytest.mark.parametrize("backend", ["kernel", "chunked"])
def test_prefill_and_three_decode_steps(pair, backend):
    """Prefill a 37-token prompt (24 in bf16), then three decode steps:
    logits and every cache leaf (k, v, each Mamba slot's h and conv, len)
    after each."""
    dtype, rapi, rparams, papi, pparams = pair
    b = 2
    toks = _tokens(3, b, SEQ[dtype][1], rapi.cfg.vocab)
    steps = _tokens(4, b, 3, rapi.cfg.vocab)

    def reference():
        cache = rapi.init_cache(b, 64)
        out, cache = rapi.prefill(rparams, {"tokens": jnp.asarray(toks)},
                                  cache, backend=REF_BACKEND[backend])
        outs = [(out, _flatten(cache))]
        for t in range(3):
            out, cache = rapi.decode_step(rparams,
                                          jnp.asarray(steps[:, t:t + 1]),
                                          cache)
            outs.append((out, _flatten(cache)))
        return outs

    want = _reference(dtype, reference)
    cache = papi.init_cache(b, 64, device="cpu")
    out, cache = papi.prefill(pparams, {"tokens": torch.from_numpy(toks)},
                              cache, backend=backend)
    got = [(out.clone(), _snapshot(cache))]
    for t in range(3):
        out, cache = papi.decode_step(
            pparams, torch.from_numpy(steps[:, t:t + 1]), cache,
            backend=backend)
        got.append((out.clone(), _snapshot(cache)))
    for i, ((g, gc), (w, wc)) in enumerate(zip(got, want)):
        _check(g, w, dtype, f"logits {i}")
        assert set(gc) == set(wc) == {
            "k", "v", "len", "ssm.slot0.h", "ssm.slot0.conv"}
        for name in set(gc) - {"len"}:
            assert tuple(gc[name].shape) == wc[name].shape
            _check(gc[name], wc[name], dtype, f"{name} {i}")
        np.testing.assert_array_equal(gc["len"].numpy(),
                                      np.asarray(wc["len"]))


def test_backends_agree_and_others_raise(jamba_f32):
    _, _, papi, pparams = jamba_f32
    toks = {"tokens": torch.from_numpy(_tokens(6, 1, 140, papi.cfg.vocab))}
    got = {be: papi.apply(pparams, toks, backend=be)["logits"]
           for be in ssm.SCAN_BACKENDS}
    torch.testing.assert_close(got["kernel"], got["chunked"], **F32)
    with pytest.raises(ValueError, match="hybrid family"):
        papi.apply(pparams, toks, backend="naive")


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("backend", ["kernel", "chunked"])
def test_serve_loop_tokens_equal_reference(jamba_f32, backend):
    """Float32, 4 requests of 5-40 tokens over 2 slots (buckets 32 and 64),
    refilled while the other slot decodes: the same greedy tokens and the
    same final cache, leaf by leaf, as the reference's loop."""
    rapi, rparams, papi, pparams = jamba_f32
    rng = np.random.RandomState(7)
    prompts = [rng.randint(1, rapi.cfg.vocab, n).astype(np.int32)
               for n in (5, 40, 12, 20)]
    max_news = [4, 6, 3, 5]
    ref = RefServeLoop(rapi, rparams, slots=2, max_len=96, bucket=32)
    loop = ServeLoop(papi, pparams, slots=2, max_len=96, bucket=32,
                     backend=backend, device="cpu")
    out = []
    for lp, req in ((ref, RefRequest), (loop, Request)):
        for i, (pr, mn) in enumerate(zip(prompts, max_news)):
            lp.submit(req(rid=i, prompt=pr, max_new=mn))
        out.append({r.rid: r for r in lp.run()})
    want, got = out
    assert sorted(got) == sorted(want) == [0, 1, 2, 3]
    for rid in want:
        assert got[rid].tokens == want[rid].tokens, rid
        assert len(got[rid].tokens) == max_news[rid] + 1
        assert got[rid].prefill_len == want[rid].prefill_len
    rcache, pcache = _flatten(ref.cache), _flatten(loop.cache)
    assert set(rcache) == set(pcache)
    for name in pcache:
        np.testing.assert_allclose(_np(pcache[name]), _np(rcache[name]),
                                   **F32, err_msg=name)


def test_admit_splices_the_nested_cache():
    """The slot's rows of every leaf of the nested cache equal a one-row
    prefill's; the other slots stay zero."""
    cfg = dataclasses.replace(get_smoke_config(ARCH), dtype=torch.float32)
    api = get_model(cfg)
    params = api.init(0, device="cpu")
    loop = ServeLoop(api, params, slots=3, max_len=40, bucket=32,
                     device="cpu")
    prompt = np.arange(1, 8, dtype=np.int32)
    loop.submit(Request(rid=0, prompt=prompt, max_new=2))
    loop._admit()
    (slot,) = loop.active
    padded = np.zeros((1, 32), np.int32)
    padded[0, -7:] = prompt
    row = api.prefill(params, {"tokens": torch.from_numpy(padded)},
                      api.init_cache(1, 40, device="cpu"))[1]
    full, row = _flatten(loop.cache), _flatten(row)
    assert set(full) == set(row)
    others = [s for s in range(3) if s != slot]
    for name, leaf in full.items():
        if leaf.dim() >= 2:
            torch.testing.assert_close(leaf[:, slot:slot + 1], row[name],
                                       rtol=0, atol=0)
            assert float(leaf[:, others].abs().max()) == 0.0, name
            assert float(leaf[:, slot].abs().max()) > 0, name
        else:
            assert int(leaf[slot]) == int(row[name][0]) == 32


def test_launcher_serves_jamba_cut_in_depth(capsys):
    """``--layers`` cuts the depth at full width; the launcher refuses a
    depth that is not whole periods (and no depth at all), and an
    attention-only backend."""
    assert launch_serve.main(["--arch", ARCH, "--smoke", "--layers", "2",
                              "--requests", "3", "--max-new", "2",
                              "--device", "cpu"]) == 0
    assert capsys.readouterr().out.startswith("[serve] 3 requests, 9 tokens")
    for argv in (["--smoke", "--layers", "3"], ["--layers", "12"],
                 ["--layers", "0"], ["--backend", "naive"]):
        with pytest.raises(SystemExit):
            launch_serve.parse_args(["--arch", ARCH] + argv)
    assert "attn_every 2" in capsys.readouterr().err
    assert launch_serve.parse_args(["--arch", ARCH, "--layers", "16"]
                                   ).layers == 16
