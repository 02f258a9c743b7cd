"""The port's vision-language path (M-RoPE in repro_torch.models.layers,
the ``embeds``/``pos3`` inputs of repro_torch.models.transformer, the vlm
family) against the reference's on qwen2-vl's smoke config (2 layers, GQA
group 2, Dh 16), with the reference's weights carried across by
``params_from_jax``.

Positions follow Qwen2-VL's M-RoPE layout (``vl_pos3``): text at t = h = w
= i, then a grid of merged patches at t = n, h = n + row, w = n + col,
then text again from the image's largest position + 1, so the three axes
differ.

Tolerances: in float32, rtol/atol 1e-5 against the jitted reference (the
dense LM's); in bf16, 2e-2 against the reference run op by op
(``jax.disable_jit``).  ``apply_mrope`` alone: XLA's jitted CPU cos/sin
differ from torch's by up to 2.6e-6 at these positions (8.5e-5 at
Qwen2-VL's 2048-position layout, Dh 128), op by op by up to 4.8e-7; in
bf16 the rotated values agree within one bf16 ulp (rtol 2^-7).  Greedy
tokens are equal.
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
from repro.models import layers as ref_layers
from repro.serve import Request as RefRequest
from repro.serve import ServeLoop as RefServeLoop
from repro_torch.configs import get_smoke_config
from repro_torch.launch import serve as launch_serve
from repro_torch.models import get_model, layers
from repro_torch.models.weights import params_from_jax
from repro_torch.serve import Request, ServeLoop

ARCH = "qwen2-vl-72b"
F32 = dict(rtol=1e-5, atol=1e-5)
BF16 = dict(rtol=2e-2, atol=2e-2)
KEY = jax.random.PRNGKey(0)
REF_BACKEND = {"kernel": "naive", "chunked": "chunked"}
# the smoke layout: 4 text positions, a 3 x 5 patch grid, 6 text positions
LAYOUT = (4, 3, 5, 6)
SEQ = 4 + 3 * 5 + 6


def vl_pos3(n_text, grid_h, grid_w, n_after, b):
    """[B, S, 3] int32 (t, h, w) M-RoPE positions of text, an image of
    grid_h x grid_w merged patches, text."""
    rows, cols = np.meshgrid(np.arange(grid_h), np.arange(grid_w),
                             indexing="ij")
    image = np.stack([np.full(grid_h * grid_w, n_text),
                      n_text + rows.ravel(), n_text + cols.ravel()], -1)
    after = image.max() + 1 + np.arange(n_after)
    pos = np.concatenate([np.repeat(np.arange(n_text)[:, None], 3, 1),
                          image, np.repeat(after[:, None], 3, 1)])
    return np.ascontiguousarray(np.broadcast_to(
        pos, (b,) + pos.shape)).astype(np.int32)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _embeds(seed, b, s, d):
    return np.random.RandomState(seed).standard_normal((b, s, d)).astype(
        np.float32)


@functools.lru_cache(maxsize=None)
def _models(dtype):
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
def vlm_f32():
    return _models("float32")


def _check(got, want, dtype, label=""):
    np.testing.assert_allclose(_np(got), _np(want),
                               **(F32 if dtype == "float32" else BF16),
                               err_msg=label)


def _reference(dtype, fn):
    if dtype == "float32":
        return fn()
    with jax.disable_jit():
        return fn()


# ---------------------------------------------------------------------------
# M-RoPE
# ---------------------------------------------------------------------------


def test_vl_pos3_axes_differ():
    pos = vl_pos3(*LAYOUT, 1)[0]
    assert pos.shape == (SEQ, 3)
    assert (pos[:4] == np.arange(4)[:, None]).all()
    assert pos[4].tolist() == [4, 4, 4] and pos[18].tolist() == [4, 6, 8]
    assert pos[19].tolist() == [9, 9, 9] and pos[-1].tolist() == [14] * 3
    assert len({tuple(p) for p in pos}) == SEQ


@pytest.mark.parametrize("dh", [16, 128])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_mrope_equals_reference(dtype, dh):
    pos3 = vl_pos3(*LAYOUT, 2)
    x = np.random.RandomState(dh).standard_normal(
        (2, SEQ, 3, dh)).astype(np.float32)
    jdt, tdt = ((jnp.float32, torch.float32) if dtype == "float32"
                else (jnp.bfloat16, torch.bfloat16))
    want = jax.jit(lambda x, p: ref_layers.apply_mrope(x, p, 1e6))(
        jnp.asarray(x).astype(jdt), jnp.asarray(pos3))
    got = layers.apply_mrope(torch.from_numpy(x).to(tdt),
                             torch.from_numpy(pos3), 1e6)
    assert got.dtype == tdt
    tol = F32 if dtype == "float32" else dict(rtol=2 ** -7, atol=0)
    np.testing.assert_allclose(_np(got), _np(want), **tol)


def test_apply_mrope_at_qwen2_vl_layout_op_by_op():
    """Qwen2-VL's 2048-position layout (64 text, a 32 x 56 grid, 192
    text) at Dh 128 in float32, against the reference run op by op."""
    pos3 = vl_pos3(64, 32, 56, 192, 1)
    x = np.random.RandomState(1).standard_normal(
        (1, 2048, 2, 128)).astype(np.float32)
    with jax.disable_jit():
        want = ref_layers.apply_mrope(jnp.asarray(x), jnp.asarray(pos3), 1e6)
    got = layers.apply_mrope(torch.from_numpy(x), torch.from_numpy(pos3), 1e6)
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-6, atol=1e-6)


def test_mrope_with_equal_axes_is_rope():
    """t = h = w = i rotates as plain RoPE at i, bit for bit."""
    x = torch.from_numpy(np.random.RandomState(2).standard_normal(
        (2, 9, 2, 32)).astype(np.float32))
    pos = torch.arange(9)[None].expand(2, 9)
    pos3 = pos[..., None].expand(2, 9, 3)
    assert torch.equal(layers.apply_mrope(x, pos3, 1e6),
                       layers.apply_rope(x, pos, 1e6))


# ---------------------------------------------------------------------------
# the model on embeds and pos3
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("backend", ["kernel", "chunked"])
def test_lm_apply_with_embeds_and_pos3(pair, backend):
    dtype, rapi, rparams, papi, pparams = pair
    emb, pos3 = _embeds(3, 2, SEQ, papi.cfg.d_model), vl_pos3(*LAYOUT, 2)
    want = _reference(dtype, lambda: rapi.apply(
        rparams, {"embeds": jnp.asarray(emb), "pos3": jnp.asarray(pos3)},
        remat=False, backend=REF_BACKEND[backend]))
    got = papi.apply(pparams, {"embeds": torch.from_numpy(emb),
                               "pos3": torch.from_numpy(pos3)},
                     backend=backend)
    _check(got["hidden"], want["hidden"], dtype, "hidden")
    _check(got["logits"], want["logits"], dtype, "logits")


def test_prefill_and_decode_with_batch_extra(pair):
    """Prefill the text-image-text embeds, then three decode steps with
    ``batch_extra`` embeds and pos3 that continue the text (tokens None):
    logits and every cache leaf after each."""
    dtype, rapi, rparams, papi, pparams = pair
    b, d = 2, papi.cfg.d_model
    emb, pos3 = _embeds(4, b, SEQ, d), vl_pos3(*LAYOUT, b)
    step_emb = _embeds(5, b, 3, d)
    step_pos = pos3[:, -1:] + 1 + np.arange(3)[None, :, None]

    def extra(t, to):
        return {"embeds": to(step_emb[:, t:t + 1]),
                "pos3": to(np.ascontiguousarray(step_pos[:, t:t + 1]))}

    def reference():
        cache = rapi.init_cache(b, 32)
        out, cache = rapi.prefill(rparams, {"embeds": jnp.asarray(emb),
                                            "pos3": jnp.asarray(pos3)},
                                  cache, backend="naive")
        outs = [(out, dict(cache))]
        for t in range(3):
            out, cache = rapi.decode_step(rparams, None, cache,
                                          batch_extra=extra(t, jnp.asarray))
            outs.append((out, dict(cache)))
        return outs

    want = _reference(dtype, reference)
    cache = papi.init_cache(b, 32, device="cpu")
    out, cache = papi.prefill(pparams, {"embeds": torch.from_numpy(emb),
                                        "pos3": torch.from_numpy(pos3)},
                              cache, backend="kernel")
    got = [(out.clone(), {k: v.clone() for k, v in cache.items()})]
    for t in range(3):
        out, cache = papi.decode_step(pparams, None, cache,
                                      batch_extra=extra(t, torch.from_numpy))
        got.append((out.clone(), {k: v.clone() for k, v in cache.items()}))
    for i, ((g, gc), (w, wc)) in enumerate(zip(got, want)):
        _check(g, w, dtype, f"logits {i}")
        assert set(gc) == set(wc) == {"k", "v", "len"}
        _check(gc["k"], wc["k"], dtype, f"k {i}")
        _check(gc["v"], wc["v"], dtype, f"v {i}")
        assert gc["len"].tolist() == np.asarray(wc["len"]).tolist() \
            == [SEQ + i] * b


def test_decode_equals_the_full_forward_over_concatenated_embeds(vlm_f32):
    """A decode step on embeds and pos3 after a prefill equals the full
    forward over the S + 1 concatenated embeds, the port's and the
    reference's (the comparison tests/test_models.py skips for vlm)."""
    rapi, rparams, papi, pparams = vlm_f32
    b = 2
    emb = _embeds(6, b, SEQ + 1, papi.cfg.d_model)
    pos3 = vl_pos3(*LAYOUT, b)
    pos3 = np.concatenate([pos3, pos3[:, -1:] + 1], 1)
    full = {"embeds": torch.from_numpy(emb), "pos3": torch.from_numpy(pos3)}
    want = papi.apply(pparams, full)["logits"][:, -1]
    ref = rapi.apply(rparams, {"embeds": jnp.asarray(emb),
                               "pos3": jnp.asarray(pos3)},
                     remat=False)["logits"][:, -1]
    cache = papi.init_cache(b, 32, device="cpu")
    out, cache = papi.prefill(pparams, {k: v[:, :SEQ] for k, v in
                                        full.items()}, cache)
    torch.testing.assert_close(
        out[:, 0], papi.apply(pparams, {k: v[:, :SEQ] for k, v in
                                        full.items()})["logits"][:, -1],
        **F32)
    out, cache = papi.decode_step(pparams, None, cache, batch_extra={
        k: v[:, SEQ:] for k, v in full.items()})
    torch.testing.assert_close(out[:, 0], want, **F32)
    np.testing.assert_allclose(_np(out[:, 0]), _np(ref), **F32)


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------


def test_serve_loop_tokens_equal_reference(vlm_f32):
    """Float32, token prompts (plain RoPE: the loop feeds no pos3), 3
    requests over 2 slots: the same greedy tokens as the JAX loop."""
    rapi, rparams, papi, pparams = vlm_f32
    rng = np.random.RandomState(1)
    prompts = [rng.randint(1, rapi.cfg.vocab, n).astype(np.int32)
               for n in (8, 20, 5)]
    out = []
    for loop, req in ((RefServeLoop(rapi, rparams, slots=2, max_len=64,
                                    bucket=32), RefRequest),
                      (ServeLoop(papi, pparams, slots=2, max_len=64,
                                 bucket=32, device="cpu"), Request)):
        for i, pr in enumerate(prompts):
            loop.submit(req(rid=i, prompt=pr, max_new=5))
        out.append({r.rid: r.tokens for r in loop.run()})
    want, got = out
    assert sorted(got) == [0, 1, 2] and got == want


def test_launcher_serves_qwen2_vl_cut_in_depth(capsys):
    assert launch_serve.main(["--arch", ARCH, "--smoke", "--layers", "1",
                              "--requests", "3", "--max-new", "2",
                              "--device", "cpu"]) == 0
    assert capsys.readouterr().out.startswith("[serve] 3 requests, 9 tokens")
    assert launch_serve.parse_args(["--arch", ARCH, "--layers", "20"]
                                   ).layers == 20
