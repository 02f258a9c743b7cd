"""The port's continuous-batching loop (repro_torch.serve) and launcher
(repro_torch.launch.serve) against the reference's (repro.serve), with the
reference's weights carried across.  Float32 throughout, so that greedy
tokens can be required equal: logits agree to about 1e-6 there, far below
the gaps between the top two logits of these runs."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as ref_get_smoke_config
from repro.models import get_model as ref_get_model
from repro.serve import Request as RefRequest
from repro.serve import ServeLoop as RefServeLoop
from repro_torch.configs import get_smoke_config
from repro_torch.launch import serve as launch_serve
from repro_torch.models import get_model
from repro_torch.models.weights import params_from_jax
from repro_torch.serve import Request, ServeLoop


@pytest.fixture(scope="module")
def qwen_f32():
    rcfg = dataclasses.replace(ref_get_smoke_config("qwen3-4b"),
                               dtype=jnp.float32)
    pcfg = dataclasses.replace(get_smoke_config("qwen3-4b"),
                               dtype=torch.float32)
    rapi, papi = ref_get_model(rcfg), get_model(pcfg)
    rparams = rapi.init(jax.random.PRNGKey(0))
    pparams = params_from_jax(jax.tree_util.tree_map(np.asarray, rparams),
                              pcfg, device="cpu")
    return rapi, rparams, papi, pparams


def _serve(loop, req_cls, prompts, max_news):
    for i, (pr, mn) in enumerate(zip(prompts, max_news)):
        loop.submit(req_cls(rid=i, prompt=pr, max_new=mn))
    return {r.rid: r for r in loop.run()}


@pytest.mark.parametrize("backend", ["kernel", "naive", "chunked"])
def test_serve_loop_tokens_equal_reference(qwen_f32, backend):
    """tests/test_flows_serve.py's settings: seed 1, 3 prompts of 8 tokens,
    2 slots, max_len 64, bucket 32, max_new 5."""
    rapi, rparams, papi, pparams = qwen_f32
    rng = np.random.RandomState(1)
    prompts = [rng.randint(1, rapi.cfg.vocab, 8).astype(np.int32)
               for _ in range(3)]
    want = _serve(RefServeLoop(rapi, rparams, slots=2, max_len=64,
                               bucket=32), RefRequest, prompts, [5] * 3)
    loop = ServeLoop(papi, pparams, slots=2, max_len=64, bucket=32,
                     backend=backend, device="cpu")
    got = _serve(loop, Request, prompts, [5] * 3)
    assert sorted(got) == sorted(want) == [0, 1, 2]
    for rid in want:
        assert got[rid].tokens == want[rid].tokens, rid
        assert len(got[rid].tokens) == 6
        assert got[rid].prefill_len == want[rid].prefill_len == 32
        assert got[rid].decode_steps == want[rid].decode_steps == 5


def test_idle_slot_past_max_len_drops_writes(qwen_f32):
    """An idle slot keeps decoding and its length passes max_len; so does
    a long request's.  Writes at or past max_len must be dropped, as the
    reference's scatter drops them: same tokens, same final cache."""
    rapi, rparams, papi, pparams = qwen_f32
    rng = np.random.RandomState(2)
    prompts = [rng.randint(1, rapi.cfg.vocab, n).astype(np.int32)
               for n in (5, 30, 12)]
    max_news = [2, 14, 3]
    ref = RefServeLoop(rapi, rparams, slots=2, max_len=40, bucket=32)
    want = _serve(ref, RefRequest, prompts, max_news)
    loop = ServeLoop(papi, pparams, slots=2, max_len=40, bucket=32,
                     device="cpu")
    got = _serve(loop, Request, prompts, max_news)
    for rid in want:
        assert got[rid].tokens == want[rid].tokens, rid
    lens = loop.cache["len"].numpy()
    np.testing.assert_array_equal(lens, np.asarray(ref.cache["len"]))
    assert lens.max() > 40          # some slot did write past max_len
    for name in ("k", "v"):
        np.testing.assert_allclose(loop.cache[name].numpy(),
                                   np.asarray(ref.cache[name]),
                                   rtol=1e-5, atol=1e-5)


def test_launcher_main_on_cpu(capsys):
    assert launch_serve.main(["--smoke", "--device", "cpu", "--requests",
                              "3", "--max-new", "4"]) == 0
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith("[serve] 3 requests, 15 tokens, ")
    assert line.endswith("tok/s (4 slots)")


def test_launcher_run_answers_every_request():
    out = launch_serve.run(["--smoke", "--device", "cpu", "--requests", "5",
                            "--slots", "2", "--max-new", "3", "--backend",
                            "chunked"])
    assert sorted(r.rid for r in out.results) == list(range(5))
    assert all(len(r.tokens) == 4 for r in out.results)
    assert out.tokens == 20 and out.seconds > 0


def test_loop_defaults_to_cuda(qwen_f32):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    _, _, papi, pparams = qwen_f32
    with pytest.raises(RuntimeError, match="CUDA"):
        ServeLoop(papi, pparams)
    with pytest.raises(RuntimeError, match="CUDA"):
        launch_serve.main(["--smoke"])



def test_run_accepts_until_empty(qwen_f32):
    """``run(True)`` is the reference's positional spelling of
    ``run(until_empty=True)``: it answers what ``run()`` answers (it must
    not be read as ``max_ticks``)."""
    _, _, papi, pparams = qwen_f32
    rng = np.random.RandomState(3)
    prompts = [rng.randint(1, papi.cfg.vocab, 6).astype(np.int32)
               for _ in range(3)]
    out = {}
    for args in ((), (True,)):
        loop = ServeLoop(papi, pparams, slots=2, max_len=64, bucket=32,
                         device="cpu")
        for i, pr in enumerate(prompts):
            loop.submit(Request(rid=i, prompt=pr, max_new=4))
        out[args] = {r.rid: r.tokens for r in loop.run(*args)}
    assert sorted(out[()]) == [0, 1, 2]
    assert out[(True,)] == out[()]
