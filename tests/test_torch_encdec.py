"""The port's encoder-decoder (repro_torch.models.encdec, the audio family)
against the reference's (repro.models.encdec) on whisper's smoke config (2
encoder and 2 decoder layers, 16 frames), with the reference's weights
carried across by ``params_from_jax``.

Tolerances: in float32, rtol/atol 1e-5 against the jitted reference (the
dense LM's: only summation orders and ulp-level transcendentals differ);
in bf16, 2e-2 against the reference run op by op (``jax.disable_jit``), as
the other families' bf16 cases are held.  Greedy tokens are equal.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as ref_get_smoke_config
from repro.launch import serve as ref_launch_serve
from repro.models import encdec as ref_encdec
from repro.models import get_model as ref_get_model
from repro_torch.configs import get_smoke_config
from repro_torch.launch import serve as launch_serve
from repro_torch.models import encdec, get_model
from repro_torch.models.weights import _flatten, params_from_jax

ARCH = "whisper-base"
F32 = dict(rtol=1e-5, atol=1e-5)
BF16 = dict(rtol=2e-2, atol=2e-2)
KEY = jax.random.PRNGKey(0)
# the reference's attention backend for each port backend: on the CPU the
# port's "kernel" runs the flash kernel's plain version, the reference's
# naive attention (the oracle of its Pallas kernel)
REF_BACKEND = {"kernel": "naive", "chunked": "chunked"}
CACHE_LEAVES = {"k", "v", "enc_k", "enc_v", "len"}


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _tokens(seed, b, s, vocab):
    return np.random.RandomState(seed).randint(0, vocab, (b, s)).astype(
        np.int32)


def _frames(seed, b, cfg):
    """enc_embeds [B, enc_seq, D] float32 from a seed."""
    return np.random.RandomState(seed).standard_normal(
        (b, cfg.enc_seq, cfg.d_model)).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _models(dtype):
    """The reference's model and weights and the port's model holding the
    same numbers, once a dtype."""
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
def whisper_f32():
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


def _batch(frames, toks, to):
    return {"enc_embeds": to(frames), "tokens": to(toks)}


# ---------------------------------------------------------------------------
# structure and weights
# ---------------------------------------------------------------------------


def test_init_matches_the_reference_tree():
    """Names, shapes and dtypes of ``init(seed, device="cpu")`` equal the
    reference's tree carried across (``enc_layers`` and ``dec_layers``
    split by layer), and the cache's leaves equal the reference's cache's."""
    rapi, rparams, papi, carried = _models("bfloat16")
    want = carried.state_dict()
    model = papi.init(0, device="cpu")
    got = model.state_dict()
    assert {k: (tuple(v.shape), v.dtype) for k, v in got.items()} == \
        {k: (tuple(v.shape), v.dtype) for k, v in want.items()}
    assert len(model.enc_layers) == len(model.dec_layers) == 2
    np.testing.assert_array_equal(
        carried.dec_layers[1].cross_attn.wk.view(torch.int16).numpy(),
        np.asarray(rparams["dec_layers"]["cross_attn"]["wk"][1]).view(
            np.int16))
    rcache = _flatten(rapi.init_cache(3, 40))
    pcache = _flatten(papi.init_cache(3, 40, device="cpu"))
    assert set(pcache) == CACHE_LEAVES
    assert {k: tuple(v.shape) for k, v in pcache.items()} == \
        {k: tuple(v.shape) for k, v in rcache.items()}
    assert {k: str(v.dtype).split(".")[-1] for k, v in pcache.items()} == \
        {k: str(v.dtype) for k, v in rcache.items()}


def test_params_from_jax_splits_the_encoder_by_its_own_depth():
    """``n_enc_layers`` differs from ``n_layers``: each stack is split by
    its own depth, and a tree of another encoder depth is refused."""
    rcfg = dataclasses.replace(ref_get_smoke_config(ARCH), n_enc_layers=3,
                               dtype=jnp.float32)
    pcfg = dataclasses.replace(get_smoke_config(ARCH), n_enc_layers=3,
                               dtype=torch.float32)
    tree = jax.tree_util.tree_map(np.asarray,
                                  jax.jit(ref_get_model(rcfg).init)(KEY))
    model = params_from_jax(tree, pcfg, device="cpu")
    assert (len(model.enc_layers), len(model.dec_layers)) == (3, 2)
    with pytest.raises(ValueError, match="2 layers"):
        params_from_jax(tree, dataclasses.replace(pcfg, n_enc_layers=2),
                        device="cpu")


# ---------------------------------------------------------------------------
# the whole model
# ---------------------------------------------------------------------------


def test_encode(pair):
    dtype, rapi, rparams, papi, pparams = pair
    frames = _frames(1, 2, papi.cfg)
    want = _reference(dtype, lambda: ref_encdec.encode(
        rparams, jnp.asarray(frames), rapi.cfg, backend="naive",
        remat=False))
    got = encdec.encode(pparams, torch.from_numpy(frames), papi.cfg,
                        backend="kernel")
    assert got.dtype == papi.cfg.dtype and got.shape == want.shape
    _check(got, want, dtype, "encoder output")


# bf16 on the card's path only: each op-by-op reference run compiles its
# primitives anew, and float32 holds the chunked backend
CASES = [("float32", "kernel"), ("float32", "chunked"), ("bfloat16", "kernel")]


@pytest.mark.parametrize("dtype,backend", CASES)
def test_encdec_apply(dtype, backend):
    rapi, rparams, papi, pparams = _models(dtype)
    frames = _frames(2, 2, papi.cfg)
    toks = _tokens(3, 2, 11, papi.cfg.vocab)
    want = _reference(dtype, lambda: rapi.apply(
        rparams, _batch(frames, toks, jnp.asarray), remat=False,
        backend=REF_BACKEND[backend]))
    got = papi.apply(pparams, _batch(frames, toks, torch.from_numpy),
                     backend=backend)
    assert got["logits"].dtype == torch.float32
    assert got["logits"].shape == (2, 11, papi.cfg.vocab)
    _check(got["hidden"], want["hidden"], dtype, "hidden")
    _check(got["logits"], want["logits"], dtype, "logits")
    assert float(got["aux_loss"]) == float(want["aux_loss"]) == 0.0


@pytest.mark.parametrize("dtype,backend", CASES)
def test_prefill_and_three_decode_steps(dtype, backend):
    """Prefill 16 frames and a 4-token prompt, then three greedy decode
    steps: logits, greedy tokens and every cache leaf (k, v, enc_k, enc_v,
    len) after each."""
    rapi, rparams, papi, pparams = _models(dtype)
    b = 2
    frames = _frames(4, b, papi.cfg)
    toks = _tokens(5, b, 4, papi.cfg.vocab)

    def reference():
        cache = rapi.init_cache(b, 12)
        out, cache = rapi.prefill(rparams, _batch(frames, toks, jnp.asarray),
                                  cache, backend=REF_BACKEND[backend])
        outs = [(out, _flatten(cache))]
        for _ in range(3):
            nxt = jnp.argmax(out[:, -1], axis=-1)[:, None].astype(jnp.int32)
            out, cache = rapi.decode_step(rparams, nxt, cache)
            outs.append((out, _flatten(cache)))
        return outs

    want = _reference(dtype, reference)
    cache = papi.init_cache(b, 12, device="cpu")
    out, cache = papi.prefill(pparams, _batch(frames, toks, torch.from_numpy),
                              cache, backend=backend)
    got = [(out.clone(), {k: v.clone() for k, v in cache.items()})]
    for _ in range(3):
        nxt = torch.argmax(out[:, -1], dim=-1)[:, None].to(torch.int32)
        out, cache = papi.decode_step(pparams, nxt, cache, backend=backend)
        got.append((out.clone(), {k: v.clone() for k, v in cache.items()}))
    for i, ((g, gc), (w, wc)) in enumerate(zip(got, want)):
        _check(g, w, dtype, f"logits {i}")
        np.testing.assert_array_equal(_np(g).argmax(-1), _np(w).argmax(-1))
        assert set(gc) == set(wc) == CACHE_LEAVES
        for name in CACHE_LEAVES - {"len"}:
            assert tuple(gc[name].shape) == wc[name].shape
            _check(gc[name], wc[name], dtype, f"{name} {i}")
        np.testing.assert_array_equal(gc["len"].numpy(),
                                      np.asarray(wc["len"]))
        assert gc["len"].tolist() == [4 + i] * b


def test_prefill_and_decode_equal_the_full_forward(whisper_f32):
    """The prefill's logits equal the full forward's last position, and a
    decode step after it equals the full forward over S + 1 tokens (the
    reference's own check, tests/test_models.py)."""
    _, _, papi, pparams = whisper_f32
    frames = _frames(6, 2, papi.cfg)
    toks = _tokens(7, 2, 12, papi.cfg.vocab)
    nxt = np.full((2, 1), 7, np.int32)
    full = papi.apply(pparams, _batch(frames, toks, torch.from_numpy))
    full2 = papi.apply(pparams, _batch(
        frames, np.concatenate([toks, nxt], 1), torch.from_numpy))
    cache = papi.init_cache(2, 32, device="cpu")
    out, cache = papi.prefill(pparams, _batch(frames, toks, torch.from_numpy),
                              cache)
    torch.testing.assert_close(out[:, 0], full["logits"][:, -1], **F32)
    out, cache = papi.decode_step(pparams, torch.from_numpy(nxt), cache)
    torch.testing.assert_close(out[:, 0], full2["logits"][:, -1], **F32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_backend_on_cpu_is_the_plain_version(dtype):
    """On CPU tensors ``backend="kernel"`` runs the flash kernel's plain
    version: the encoder, the forward pass and the prefill (cache leaves
    included) equal the naive backend's bit for bit."""
    cfg = dataclasses.replace(get_smoke_config(ARCH), dtype=dtype)
    api = get_model(cfg)
    params = api.init(3, device="cpu")
    batch = _batch(_frames(8, 2, cfg), _tokens(9, 2, 5, cfg.vocab),
                   torch.from_numpy)
    out = {}
    for be in ("kernel", "naive"):
        cache = api.init_cache(2, 8, device="cpu")
        out[be] = (encdec.encode(params, batch["enc_embeds"], cfg,
                                 backend=be),
                   api.apply(params, batch, backend=be)["logits"],
                   *api.prefill(params, batch, cache, backend=be))
    for a, b in zip(out["kernel"][:3], out["naive"][:3]):
        assert torch.equal(a, b)
    for name in CACHE_LEAVES:
        assert torch.equal(out["kernel"][3][name], out["naive"][3][name])


def test_prefill_refuses_what_does_not_fit(whisper_f32):
    _, _, papi, pparams = whisper_f32
    frames = _frames(10, 1, papi.cfg)
    cache = papi.init_cache(1, 4, device="cpu")
    with pytest.raises(ValueError, match="does not fit"):
        papi.prefill(pparams, _batch(frames, _tokens(1, 1, 5, 256),
                                     torch.from_numpy), cache)
    with pytest.raises(ValueError, match="encoder frames"):
        papi.prefill(pparams, _batch(frames[:, :8], _tokens(1, 1, 3, 256),
                                     torch.from_numpy), cache)


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------


def test_launcher_refuses_whisper_where_the_reference_fails_later(capsys):
    """The port's launcher refuses the audio family before it builds
    anything (its loop feeds token prompts only); the reference's builds
    the model and the loop and fails at its first admission, when its
    prefill looks for ``enc_embeds``."""
    with pytest.raises(SystemExit):
        launch_serve.parse_args(["--arch", ARCH, "--smoke"])
    assert "enc_embeds" in capsys.readouterr().err
    with pytest.raises(KeyError, match="enc_embeds"):
        ref_launch_serve.main(["--arch", ARCH, "--smoke", "--requests", "1",
                               "--slots", "1", "--max-len", "32"])
