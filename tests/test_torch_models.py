"""The port's dense LM (repro_torch.models, repro_torch.configs) against the
reference's (repro.models, repro.configs) with shared weights.

The reference's params are made by ``jax.random`` and carried across with
``params_from_jax``; token inputs come from numpy with a seed.  Tolerances:
in float32, rtol/atol 1e-5 (only summation orders and ulp-level
transcendentals differ); in bf16, 2e-2, as tests/test_models.py holds the
reference against itself (bf16 rounds at other places in the two
frameworks: matmul outputs, SiLU, the cast of attention weights).
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
from repro.models import layers as ref_layers
from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.models import get_model, layers
from repro_torch.models.transformer import _scatter_kv, lm_init_cache
from repro_torch.models.weights import (_MODELS, _flatten, params_from_jax,
                                       to_torch)

F32 = dict(rtol=1e-5, atol=1e-5)
BF16 = dict(rtol=2e-2, atol=2e-2)
KEY = jax.random.PRNGKey(0)
DENSE_ARCH_IDS = tuple(a for a in ARCH_IDS
                       if get_config(a).family == "dense")


def _cfgs(arch, dtype):
    ref = ref_get_smoke_config(arch)
    port = get_smoke_config(arch)
    if dtype == "float32":
        ref = dataclasses.replace(ref, dtype=jnp.float32)
        port = dataclasses.replace(port, dtype=torch.float32)
    return ref, port


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _load(module, tree):
    module.load_state_dict({k: to_torch(v) for k, v in
                            _flatten(jax.tree_util.tree_map(np.asarray,
                                                            tree)).items()})
    return module


def _tokens(seed, b, s, vocab):
    return np.random.RandomState(seed).randint(0, vocab, (b, s)).astype(
        np.int32)


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_configs_equal_reference(arch):
    """The port's fields equal the reference's; every field the port does
    not carry stays at the reference's default in these configs."""
    fields = [f.name for f in dataclasses.fields(layers.ModelConfig)]
    ref_default = ref_layers.ModelConfig()
    for ref, port in ((ref_get_config(arch), get_config(arch)),
                      (ref_get_smoke_config(arch), get_smoke_config(arch))):
        a, b = dataclasses.asdict(ref), dataclasses.asdict(port)
        assert a.pop("dtype") == jnp.bfloat16
        assert b.pop("dtype") == torch.bfloat16
        assert {f: a[f] for f in fields if f != "dtype"} == b
        assert {f: v for f, v in a.items() if f not in fields} == \
            {f: getattr(ref_default, f) for f in a if f not in fields}


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_every_arch_builds(arch):
    """``get_model`` builds every arch: the published config's model (on
    the meta device, no allocation) has the reference's parameter count
    (``eval_shape`` of its init), and the smoke config's initialises and
    gets its cache on the CPU."""
    cfg = get_config(arch)
    sds = jax.eval_shape(ref_get_model(ref_get_config(arch)).init, KEY)
    want = sum(int(np.prod(l.shape)) for l in jax.tree_util.tree_leaves(sds))
    model = _MODELS[cfg.family](cfg, "meta")
    assert sum(p.numel() for p in model.parameters()) == want
    api = get_model(get_smoke_config(arch))
    params = api.init(0, device="cpu")
    assert all(bool(p.isfinite().all()) for p in params.parameters())
    cache = _flatten(api.init_cache(2, 8, device="cpu"))
    assert cache["len"].tolist() == [0, 0]


def test_moe_family_raises():
    """The moe family is ported; a moe config without experts is refused."""
    cfg = dataclasses.replace(get_smoke_config("qwen3-4b"), family="moe")
    with pytest.raises(ValueError, match="needs experts"):
        get_model(cfg)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_and_rope(dtype):
    rng = np.random.RandomState(0)
    x = rng.standard_normal((2, 7, 3, 16)).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, (16,)).astype(np.float32)
    jx = jnp.asarray(x).astype(ref_layers.ModelConfig(dtype=jnp.bfloat16)
                               .dtype if dtype == "bfloat16" else jnp.float32)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    norm = layers.RMSNorm(16, tx.dtype, "cpu")
    norm.scale.data = torch.from_numpy(scale).to(tx.dtype)
    want = ref_layers.rmsnorm_apply(
        {"scale": jnp.asarray(scale).astype(jx.dtype)}, jx)
    tol = F32 if dtype == "float32" else BF16
    np.testing.assert_allclose(_np(layers.rmsnorm(norm, tx)), _np(want),
                               **tol)
    pos = rng.randint(0, 300, (2, 7)).astype(np.int32)
    want = ref_layers.apply_rope(jx, jnp.asarray(pos), 1e6)
    got = layers.apply_rope(tx, torch.from_numpy(pos), 1e6)
    np.testing.assert_allclose(_np(got), _np(want), **tol)
    np.testing.assert_allclose(layers.rope_freqs(16, 5e5).numpy(),
                               np.asarray(ref_layers.rope_freqs(16, 5e5)),
                               rtol=1e-6)


@pytest.mark.parametrize("qk_norm", [False, True])
def test_qkv_out_project(qk_norm):
    rcfg = ref_layers.ModelConfig(d_model=32, n_heads=4, n_kv=2, d_head=8,
                                  qk_norm=qk_norm, dtype=jnp.float32)
    pcfg = layers.ModelConfig(d_model=32, n_heads=4, n_kv=2, d_head=8,
                              qk_norm=qk_norm, dtype=torch.float32)
    p = ref_layers.attn_init(KEY, rcfg)
    if qk_norm:   # non-trivial norm scales
        p["q_norm"]["scale"] = jnp.linspace(0.5, 1.5, 8)
        p["k_norm"]["scale"] = jnp.linspace(1.5, 0.5, 8)
    mod = _load(layers.Attention(pcfg, "cpu"), p)
    x = np.random.RandomState(1).standard_normal((2, 5, 32)).astype(
        np.float32)
    want = ref_layers.qkv_project(p, jnp.asarray(x), rcfg)
    got = layers.qkv_project(mod, torch.from_numpy(x), pcfg)
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), _np(w), **F32)
    o = np.random.RandomState(2).standard_normal((2, 5, 4, 8)).astype(
        np.float32)
    np.testing.assert_allclose(
        _np(layers.out_project(mod, torch.from_numpy(o))),
        _np(ref_layers.out_project(p, jnp.asarray(o))), **F32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mlp(dtype):
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    rcfg = ref_layers.ModelConfig(d_model=32, d_ff=64, dtype=jdt)
    pcfg = layers.ModelConfig(d_model=32, d_ff=64, dtype=getattr(torch, dtype))
    p = ref_layers.mlp_init(KEY, rcfg)
    mod = _load(layers.MLP(pcfg, "cpu"), p)
    x = np.random.RandomState(3).standard_normal((2, 5, 32)).astype(
        np.float32)
    want = ref_layers.mlp_apply(p, jnp.asarray(x).astype(jdt))
    got = layers.mlp(mod, torch.from_numpy(x).to(pcfg.dtype))
    np.testing.assert_allclose(_np(got), _np(want),
                               **(F32 if dtype == "float32" else BF16))


@pytest.mark.parametrize("tied", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_embed_unembed(tied, dtype):
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    rcfg = ref_layers.ModelConfig(d_model=32, vocab=50, tie_embeddings=tied,
                                  dtype=jdt)
    pcfg = layers.ModelConfig(d_model=32, vocab=50, tie_embeddings=tied,
                              dtype=getattr(torch, dtype))
    k1, k2 = jax.random.split(KEY)
    pe = ref_layers.embed_init(k1, rcfg)
    pu = ref_layers.unembed_init(k2, rcfg)
    emb = _load(layers.Embed(pcfg, "cpu"), pe)
    unemb = _load(layers.Unembed(pcfg, "cpu"), pu)
    toks = _tokens(4, 2, 6, 50)
    want_x = ref_layers.embed_apply(pe, jnp.asarray(toks))
    got_x = layers.embed(emb, torch.from_numpy(toks))
    np.testing.assert_array_equal(_np(got_x), _np(want_x))
    want = ref_layers.unembed_apply(pu, pe, want_x, rcfg)
    got = layers.unembed(unemb, emb, got_x, pcfg)
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    # bf16 x bf16 products are exact in float32: only the order differs
    np.testing.assert_allclose(_np(got), _np(want), **F32)


# ---------------------------------------------------------------------------
# whole model: forward, prefill (each backend), decode
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module", params=[(a, d) for a in DENSE_ARCH_IDS
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


def _tol(dtype):
    return F32 if dtype == "float32" else BF16


def _reference(fn):
    """The reference's outputs as it runs (jitted: ``lax.scan`` compiles the
    layer body) and op by op (``jax.disable_jit``).  In bf16 the two differ
    by an ulp or more on most hidden-state elements: XLA's fusion keeps some
    intermediates in float32 that the op-by-op run rounds to bf16."""
    jitted = fn()
    with jax.disable_jit():
        eager = fn()
    return jitted, eager


def _check(got, jitted, eager, dtype, logits, label=""):
    """float32: everything against the jitted reference at 1e-5.  bf16: the
    float32 logits against both runs at 2e-2; bf16 intermediates (hidden
    state, KV cache) against the op-by-op run at 2e-2, since the port
    rounds as the reference's ops round (bit for bit on three of the four
    archs' hidden states) and the jitted run does not."""
    if dtype == "float32" or logits:
        np.testing.assert_allclose(_np(got), _np(jitted), **_tol(dtype),
                                   err_msg=f"{label} vs jitted reference")
    np.testing.assert_allclose(_np(got), _np(eager), **_tol(dtype),
                               err_msg=f"{label} vs op-by-op reference")


def test_lm_apply(pair):
    dtype, rapi, rparams, papi, pparams = pair
    toks = _tokens(5, 2, 12, rapi.cfg.vocab)
    jitted, eager = _reference(lambda: rapi.apply(
        rparams, {"tokens": jnp.asarray(toks)}, remat=False))
    with torch.no_grad():
        got = papi.apply(pparams, {"tokens": torch.from_numpy(toks)})
    for key in ("logits", "hidden"):
        _check(got[key], jitted[key], eager[key], dtype, key == "logits",
               key)


# the reference's counterpart of each port backend: on the CPU the port's
# "kernel" runs the kernel's plain version, the reference's naive attention
# (the oracle of its Pallas kernel); in float32 it is also held against the
# Pallas kernel itself (interpret mode)
REF_BACKEND = {"naive": "naive", "chunked": "chunked", "kernel": "naive"}


def test_prefill_each_backend_and_decode(pair):
    dtype, rapi, rparams, papi, pparams = pair
    b, s, smax = 2, 12, 32
    toks = _tokens(6, b, s, rapi.cfg.vocab)

    def prefill(backend):
        return lambda: rapi.prefill(rparams, {"tokens": jnp.asarray(toks)},
                                    rapi.init_cache(b, smax),
                                    backend=backend)
    for backend in ("naive", "chunked", "kernel"):
        (want_j, cache_j), (want_e, cache_e) = _reference(
            prefill(REF_BACKEND[backend]))
        pcache = papi.init_cache(b, smax, device="cpu")
        got, pcache = papi.prefill(pparams,
                                   {"tokens": torch.from_numpy(toks)},
                                   pcache, backend=backend)
        _check(got, want_j, want_e, dtype, True, f"{backend} logits")
        np.testing.assert_array_equal(pcache["len"].numpy(),
                                      np.asarray(cache_j["len"]))
        for name in ("k", "v"):
            _check(pcache[name], cache_j[name], cache_e[name], dtype, False,
                   f"{backend} cache {name}")
        if backend == "kernel" and dtype == "float32":
            want_p, cache_p = prefill("pallas")()
            np.testing.assert_allclose(_np(got), _np(want_p), **F32)
            np.testing.assert_allclose(_np(pcache["k"]),
                                       _np(cache_p["k"]), **F32)
    # two decode steps from the last prefill's cache
    for step, tok in enumerate((7, 11)):
        t = np.full((b, 1), tok, np.int32)
        want_j, cache_j = rapi.decode_step(rparams, jnp.asarray(t), cache_j)
        with jax.disable_jit():
            want_e, cache_e = rapi.decode_step(rparams, jnp.asarray(t),
                                               cache_e)
        got, pcache = papi.decode_step(pparams, torch.from_numpy(t), pcache)
        _check(got, want_j, want_e, dtype, True, f"decode step {step}")
        for name in ("k", "v"):
            _check(pcache[name], cache_j[name], cache_e[name], dtype, False,
                   f"decode step {step} cache {name}")
        np.testing.assert_array_equal(pcache["len"].numpy(),
                                      np.asarray(cache_j["len"]))


def test_prefill_decode_match_full_forward():
    """The port against itself, as tests/test_models.py holds the
    reference: prefill's last logits and one decode step equal the full
    forward over the same tokens (float32, 1e-5)."""
    _, pcfg = _cfgs("qwen3-4b", "float32")
    api = get_model(pcfg)
    params = api.init(0, device="cpu")
    toks = torch.from_numpy(_tokens(7, 2, 13, pcfg.vocab)).long()
    with torch.no_grad():
        full = api.apply(params, {"tokens": toks})["logits"]
    cache = api.init_cache(2, 32, device="cpu")
    lp, cache = api.prefill(params, {"tokens": toks[:, :12]}, cache)
    with torch.no_grad():
        part = api.apply(params, {"tokens": toks[:, :12]})["logits"]
    torch.testing.assert_close(lp[:, 0], part[:, -1], **F32)
    ld, _ = api.decode_step(params, toks[:, 12:], cache)
    torch.testing.assert_close(ld[:, 0], full[:, -1], **F32)


# ---------------------------------------------------------------------------
# weights and the cache write
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["qwen3-4b", "granite-3-2b"])
def test_bf16_weights_cross_exactly(arch):
    rcfg, pcfg = _cfgs(arch, "bfloat16")
    tree = jax.tree_util.tree_map(np.asarray, ref_get_model(rcfg).init(KEY))
    model = params_from_jax(tree, pcfg, device="cpu")
    state = model.state_dict()
    flat = _flatten(tree)
    for name, arr in flat.items():
        assert arr.dtype.name == "bfloat16"
        if name.startswith("layers."):
            rest = name[len("layers."):]
            got = np.stack([state[f"layers.{i}.{rest}"].view(torch.int16)
                            .numpy() for i in range(pcfg.n_layers)])
        else:
            got = state[name].view(torch.int16).numpy()
        np.testing.assert_array_equal(got, arr.view(np.int16), err_msg=name)
    assert len(state) == sum(pcfg.n_layers if n.startswith("layers.") else 1
                             for n in flat)


def test_params_from_jax_refuses_a_foreign_tree():
    rcfg, pcfg = _cfgs("qwen3-4b", "float32")
    tree = jax.tree_util.tree_map(np.asarray, ref_get_model(rcfg).init(KEY))
    tree["unembed"]["extra"] = np.zeros(3, np.float32)
    with pytest.raises(ValueError, match="unexpected"):
        params_from_jax(tree, pcfg, device="cpu")


def test_scatter_kv_drops_out_of_range_rows():
    """pos >= Smax writes nothing (the reference's scatter drops it); the
    rows in range are written."""
    rng = np.random.RandomState(8)
    cache = rng.standard_normal((3, 5, 2, 4)).astype(np.float32)
    new = rng.standard_normal((3, 1, 2, 4)).astype(np.float32)
    pos = np.array([2, 5, 9], np.int32)
    b = np.arange(3)[:, None]
    want = jnp.asarray(cache).at[b, pos.reshape(3, 1)].set(jnp.asarray(new))
    got = torch.from_numpy(cache.copy())
    _scatter_kv(got, torch.from_numpy(new), torch.from_numpy(pos))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy()[1:], cache[1:] * 0 +
                                  np.asarray(want)[1:])
    np.testing.assert_array_equal(got.numpy()[2], cache[2])


def test_init_defaults_to_cuda():
    api = get_model(get_smoke_config("qwen3-4b"))
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        api.init(0)
    with pytest.raises(RuntimeError, match="CUDA"):
        lm_init_cache(api.cfg, 1, 8)
