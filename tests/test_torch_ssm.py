"""The port's Mamba LM (repro_torch.models.ssm, .mamba_lm) against the
reference's (repro.models.ssm, .mamba_lm) on falcon-mamba's smoke config,
with the reference's weights carried across by ``params_from_jax``.

Tolerances: in float32, rtol/atol 1e-4 — the scans sum in other orders
(JAX's associative scan, the port's Hillis-Steele scan) and float32
matmul accumulation differs, which two layers carry to ~1e-5 on the
logits; in bf16, 2e-2, the reference's own bf16 tolerance
(tests/test_models.py), with bf16 intermediates held against the
reference run op by op (``jax.disable_jit``; XLA's fusion keeps some bf16
intermediates in float32) and the float32 logits against both runs.
"""
import dataclasses

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
from repro_torch.configs import get_smoke_config
from repro_torch.launch import serve as launch_serve
from repro_torch.models import get_model, ssm
from repro_torch.models.mamba_lm import ssm_lm_init_cache
from repro_torch.models.weights import _flatten, params_from_jax
from repro_torch.serve import Request, ServeLoop

ARCH = "falcon-mamba-7b"
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


def _models(dtype):
    rcfg, pcfg = ref_get_smoke_config(ARCH), get_smoke_config(ARCH)
    if dtype == "float32":
        rcfg = dataclasses.replace(rcfg, dtype=jnp.float32)
        pcfg = dataclasses.replace(pcfg, dtype=torch.float32)
    rapi, papi = ref_get_model(rcfg), get_model(pcfg)
    rparams = rapi.init(KEY)
    pparams = params_from_jax(jax.tree_util.tree_map(np.asarray, rparams),
                              pcfg, device="cpu")
    return rapi, rparams, papi, pparams


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def pair(request):
    return (request.param,) + _models(request.param)


@pytest.fixture(scope="module")
def mamba_f32():
    return _models("float32")


def _reference(fn):
    """The reference run jitted (as it runs) and op by op."""
    jitted = fn()
    with jax.disable_jit():
        eager = fn()
    return jitted, eager


def _check(got, jitted, eager, dtype, logits, label=""):
    """float32: against the jitted reference at 1e-4.  bf16: the float32
    logits against both runs, bf16 or float32 state computed from bf16
    intermediates against the op-by-op run, at 2e-2."""
    tol = F32 if dtype == "float32" else BF16
    if dtype == "float32" or logits:
        np.testing.assert_allclose(_np(got), _np(jitted), **tol,
                                   err_msg=f"{label} vs jitted reference")
    np.testing.assert_allclose(_np(got), _np(eager), **tol,
                               err_msg=f"{label} vs op-by-op reference")


# ---------------------------------------------------------------------------
# the block and the whole model
# ---------------------------------------------------------------------------


def test_mamba_apply(mamba_f32):
    rapi, rparams, papi, pparams = mamba_f32
    x = np.random.RandomState(0).standard_normal((2, 150, 64)).astype(
        np.float32)
    p0 = jax.tree_util.tree_map(lambda a: a[0], rparams["layers"]["mamba"])
    want = ref_ssm.mamba_apply(p0, jnp.asarray(x), rapi.cfg)
    got = ssm.mamba_apply(pparams.layers[0].mamba, torch.from_numpy(x),
                          papi.cfg)
    np.testing.assert_allclose(_np(got), _np(want), **F32)


@pytest.mark.parametrize("backend", ["kernel", "chunked"])
def test_mamba_decode_step(mamba_f32, backend):
    """One decode step of a block from a nonzero state: y and the new
    (h, conv)."""
    rapi, rparams, papi, pparams = mamba_f32
    cfg = papi.cfg
    rng = np.random.RandomState(1)
    x = rng.standard_normal((3, 1, 64)).astype(np.float32)
    h = (rng.standard_normal((3, cfg.d_inner, cfg.ssm_state)) * 0.5).astype(
        np.float32)
    conv = rng.standard_normal((3, cfg.ssm_conv - 1, cfg.d_inner)).astype(
        np.float32)
    p0 = jax.tree_util.tree_map(lambda a: a[0], rparams["layers"]["mamba"])
    want_y, want = ref_ssm.mamba_decode_step(
        p0, jnp.asarray(x), {"h": jnp.asarray(h), "conv": jnp.asarray(conv)},
        rapi.cfg)
    got_y, got = ssm.mamba_decode_step(
        pparams.layers[0].mamba, torch.from_numpy(x),
        {"h": torch.from_numpy(h), "conv": torch.from_numpy(conv)}, cfg,
        backend=backend)
    np.testing.assert_allclose(_np(got_y), _np(want_y), **F32)
    for name in ("h", "conv"):
        np.testing.assert_allclose(_np(got[name]), _np(want[name]), **F32,
                                   err_msg=name)


def test_ssm_lm_apply(pair):
    dtype, rapi, rparams, papi, pparams = pair
    toks = _tokens(2, 2, 40, rapi.cfg.vocab)
    jitted, eager = _reference(
        lambda: rapi.apply(rparams, {"tokens": jnp.asarray(toks)}))
    got = papi.apply(pparams, {"tokens": torch.from_numpy(toks)},
                     backend="kernel")
    assert got["logits"].dtype == torch.float32
    assert got["hidden"].dtype == papi.cfg.dtype
    assert float(got["aux_loss"]) == 0.0
    _check(got["hidden"], jitted["hidden"], eager["hidden"], dtype, False,
           "hidden")
    _check(got["logits"], jitted["logits"], eager["logits"], dtype, True,
           "logits")


def test_prefill_and_three_decode_steps(pair):
    """Prefill a 37-token prompt (the state of every layer), then three
    decode steps: logits and every cache leaf after each."""
    dtype, rapi, rparams, papi, pparams = pair
    b = 2
    toks = _tokens(3, b, 37, rapi.cfg.vocab)
    steps = _tokens(4, b, 3, rapi.cfg.vocab)

    def reference():
        cache = rapi.init_cache(b, 64)
        out, cache = rapi.prefill(rparams, {"tokens": jnp.asarray(toks)},
                                  cache)
        outs = [(out, cache)]
        for t in range(3):
            out, cache = rapi.decode_step(rparams,
                                          jnp.asarray(steps[:, t:t + 1]),
                                          cache)
            outs.append((out, cache))
        return outs

    jitted, eager = _reference(reference)
    cache = papi.init_cache(b, 64, device="cpu")
    out, cache = papi.prefill(pparams, {"tokens": torch.from_numpy(toks)},
                              cache)
    got = [(out.clone(), {k: v.clone() for k, v in cache.items()})]
    for t in range(3):
        out, cache = papi.decode_step(
            pparams, torch.from_numpy(steps[:, t:t + 1]), cache)
        got.append((out.clone(), {k: v.clone() for k, v in cache.items()}))
    for i, ((g, gc), (j, jc), (e, ec)) in enumerate(zip(got, jitted, eager)):
        assert g.shape == (b, 1, rapi.cfg.vocab)
        _check(g, j, e, dtype, True, f"logits {i}")
        for name in ("h", "conv"):
            assert gc[name].dtype == torch.float32
            assert tuple(gc[name].shape) == jc[name].shape
            _check(gc[name], jc[name], ec[name], dtype, False,
                   f"{name} {i}")
        np.testing.assert_array_equal(gc["len"].numpy(),
                                      np.asarray(jc["len"]))


def test_prefill_writes_the_cache_in_place(mamba_f32):
    _, _, papi, pparams = mamba_f32
    cache = papi.init_cache(1, 0, device="cpu")
    h, conv = cache["h"], cache["conv"]
    toks = torch.from_numpy(_tokens(5, 1, 9, papi.cfg.vocab))
    _, out = papi.prefill(pparams, {"tokens": toks}, cache)
    assert out["h"] is h and out["conv"] is conv
    assert float(h.abs().max()) > 0 and float(conv.abs().max()) > 0
    _, out = papi.decode_step(pparams, toks[:, :1], out)
    assert out["h"] is h and int(out["len"][0]) == 10


def test_scan_backends_agree_and_others_raise(mamba_f32):
    _, _, papi, pparams = mamba_f32
    toks = {"tokens": torch.from_numpy(_tokens(6, 1, 140, papi.cfg.vocab))}
    got = {be: papi.apply(pparams, toks, backend=be)["logits"]
           for be in ssm.SCAN_BACKENDS}
    torch.testing.assert_close(got["kernel"], got["chunked"], rtol=0, atol=0)
    with pytest.raises(ValueError, match="ssm family"):
        papi.apply(pparams, toks, backend="naive")


# ---------------------------------------------------------------------------
# weights and init
# ---------------------------------------------------------------------------


def test_bf16_weights_cross_exactly():
    rapi, rparams, papi, pparams = _models("bfloat16")
    state = pparams.state_dict()
    flat = _flatten(jax.tree_util.tree_map(np.asarray, rparams))
    for name, arr in flat.items():
        if name.startswith("layers."):
            rest = name[len("layers."):]
            got = np.stack([state[f"layers.{i}.{rest}"].numpy()
                            if arr.dtype == np.float32 else
                            state[f"layers.{i}.{rest}"].view(torch.int16)
                            .numpy() for i in range(papi.cfg.n_layers)])
        else:
            got = state[name].view(torch.int16).numpy()
        want = arr if arr.dtype == np.float32 else arr.view(np.int16)
        np.testing.assert_array_equal(got, want, err_msg=name)
    assert len(state) == sum(papi.cfg.n_layers if n.startswith("layers.")
                             else 1 for n in flat)


def test_params_from_jax_refuses_a_wrong_dtype():
    rapi, rparams, _, _ = _models("float32")
    tree = jax.tree_util.tree_map(np.asarray, rparams)
    tree["layers"]["mamba"]["dt_proj"] = tree["layers"]["mamba"][
        "dt_proj"].astype(np.float16)
    with pytest.raises((ValueError, TypeError)):
        params_from_jax(tree, get_smoke_config(ARCH), device="cpu")


def test_init_matches_the_reference_tree():
    """Names, shapes and dtypes of ``init(seed, device="cpu")`` equal the
    reference's param tree (layers unstacked); the draws follow the
    reference's distributions."""
    rcfg, pcfg = ref_get_smoke_config(ARCH), get_smoke_config(ARCH)
    tree = jax.eval_shape(ref_get_model(rcfg).init, KEY)
    want = {}
    for name, leaf in _flatten(jax.tree_util.tree_map(lambda a: a, tree)
                               ).items():
        dt = {"bfloat16": torch.bfloat16, "float32": torch.float32}[
            str(leaf.dtype)]
        if name.startswith("layers."):
            for i in range(pcfg.n_layers):
                want[f"layers.{i}.{name[7:]}"] = (tuple(leaf.shape[1:]), dt)
        else:
            want[name] = (tuple(leaf.shape), dt)
    model = get_model(pcfg).init(0, device="cpu")
    got = {k: (tuple(v.shape), v.dtype) for k, v in
           model.state_dict().items()}
    assert got == want
    m = model.layers[1].mamba.state_dict()      # detached tensors
    n = np.arange(1, pcfg.ssm_state + 1, dtype=np.float32)
    np.testing.assert_array_equal(m["a_log"].numpy(),
                                  np.log(np.tile(n, (pcfg.d_inner, 1))))
    dt = torch.nn.functional.softplus(m["dt_bias"])
    assert 0.9e-3 <= float(dt.min()) and float(dt.max()) <= 0.11
    assert torch.equal(m["d_skip"], torch.ones_like(m["d_skip"]))
    assert float(m["conv_b"].abs().max()) == 0.0
    assert 0.05 < float(m["conv_w"].float().std()) < 0.2
    assert abs(float(m["in_x"].float().std()) - 64 ** -0.5) < 0.02
    block = ssm.mamba_init(torch.Generator().manual_seed(1), pcfg)
    assert {k: (tuple(v.shape), v.dtype) for k, v in
            block.state_dict().items()} == \
        {k[len("layers.1.mamba."):]: v for k, v in got.items()
         if k.startswith("layers.1.mamba.")}


def test_init_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    api = get_model(get_smoke_config(ARCH))
    with pytest.raises(RuntimeError, match="CUDA"):
        api.init(0)
    with pytest.raises(RuntimeError, match="CUDA"):
        ssm_lm_init_cache(api.cfg, 1)


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------


def _serve(loop, req_cls, prompts, max_news):
    for i, (pr, mn) in enumerate(zip(prompts, max_news)):
        loop.submit(req_cls(rid=i, prompt=pr, max_new=mn))
    return {r.rid: r for r in loop.run()}


@pytest.mark.parametrize("backend", ["kernel", "chunked"])
def test_serve_loop_tokens_equal_reference(mamba_f32, backend):
    """Float32, 4 requests of 5-40 tokens over 2 slots (buckets 32 and 64),
    so slots are refilled while the other decodes: the same greedy tokens
    and the same final state as the reference's loop."""
    rapi, rparams, papi, pparams = mamba_f32
    rng = np.random.RandomState(7)
    prompts = [rng.randint(1, rapi.cfg.vocab, n).astype(np.int32)
               for n in (5, 40, 12, 20)]
    max_news = [4, 6, 3, 5]
    ref = RefServeLoop(rapi, rparams, slots=2, max_len=64, bucket=32)
    want = _serve(ref, RefRequest, prompts, max_news)
    loop = ServeLoop(papi, pparams, slots=2, max_len=64, bucket=32,
                     backend=backend, device="cpu")
    got = _serve(loop, Request, prompts, max_news)
    assert sorted(got) == sorted(want) == [0, 1, 2, 3]
    for rid in want:
        assert got[rid].tokens == want[rid].tokens, rid
        assert len(got[rid].tokens) == max_news[rid] + 1
        assert got[rid].prefill_len == want[rid].prefill_len
        assert got[rid].decode_steps == want[rid].decode_steps
    for name in ("h", "conv"):
        np.testing.assert_allclose(_np(loop.cache[name]),
                                   _np(ref.cache[name]), **F32)
    np.testing.assert_array_equal(loop.cache["len"].numpy(),
                                  np.asarray(ref.cache["len"]))


@pytest.mark.parametrize("arch", ["qwen3-4b", ARCH])
def test_admit_splices_every_cache_tensor_of_either_family(arch):
    """One ``_admit`` for both families: the slot's rows of every cache
    tensor equal a one-row prefill's, and the other slot stays zero."""
    cfg = dataclasses.replace(get_smoke_config(arch), dtype=torch.float32)
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
    row = api.init_cache(1, 40, device="cpu")
    _, row = api.prefill(params, {"tokens": torch.from_numpy(padded)}, row,
                         backend="kernel")
    assert set(loop.cache) == set(row)
    for name, full in loop.cache.items():
        if full.dim() >= 2:
            torch.testing.assert_close(full[:, slot:slot + 1], row[name],
                                       rtol=0, atol=0)
            others = [s for s in range(3) if s != slot]
            assert float(full[:, others].abs().max()) == 0.0, name
        else:
            assert int(full[slot]) == int(row[name][0]) == 32
            assert int(full.sum()) == 32


def test_launcher_main_on_cpu(capsys):
    assert launch_serve.main(["--arch", ARCH, "--smoke", "--device",
                              "cpu"]) == 0
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith("[serve] 16 requests, 272 tokens, ")


def test_launcher_refuses_an_attention_backend():
    with pytest.raises(SystemExit):
        launch_serve.parse_args(["--arch", ARCH, "--backend", "naive"])
