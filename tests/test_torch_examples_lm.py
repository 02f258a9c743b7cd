"""The port's LM entry scripts (``examples/torch_serve_lm.py``,
``torch_train_lm.py`` and ``torch_quickstart.py``'s training part) on the
CPU, with the reference's weights carried across by
``models/weights.py::params_from_jax`` and the reference driven through
``repro`` directly (never through ``examples/*.py``):

* serve_lm at 4 requests in float32: the greedy tokens of the reference's
  ``ServeLoop`` (logits agree to about 1e-6 in float32, far below the gaps
  between the top two logits), for a transformer and a Mamba model;
* quickstart's training at 3 steps in float32 against the reference's
  jitted step: the first loss at rtol 1e-6 (``tests/test_torch_train.py``'s
  limit for one step), the later ones at ``LATER_LOSS_RTOL``;
* train_lm's ``tiny`` preset at 4 steps with a crash at step 2 and a
  checkpoint every 2: one restart, and every step's metrics bitwise those
  of the same run without the crash.

Both scripts import nothing of jax, ``repro`` or ``benchmarks``, and
without ``--device`` they run on CUDA, so here they raise.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as ref_get_smoke_config
from repro.data import TokenPipeline as RefTokenPipeline
from repro.models import get_model as ref_get_model
from repro.serve import Request as RefRequest
from repro.serve import ServeLoop as RefServeLoop
from repro.train import AdamWConfig as RefAdamWConfig
from repro.train import init as ref_opt_init
from repro.train import make_train_step as ref_make_train_step
from repro_torch.configs import get_smoke_config
from repro_torch.models import get_model
from repro_torch.models.weights import params_from_jax

import torch_examples

CPU = torch.device("cpu")
LM_SCRIPTS = ("torch_serve_lm", "torch_train_lm")
# the losses after the first step: the first AdamW steps move every
# element by about ±lr whatever its gradient's size, so an element whose
# gradient is at rounding level (the two packages sum the batch and the
# layers' products in other orders, within 1e-5 of a leaf's largest |g|:
# tests/test_torch_train.py) can step the other way, which moves the loss
# only by that gradient times 2 lr.  Read on this CPU: 8.6e-8 on the
# first loss, 0 on the two later ones; a wrong step (a lost moment, a
# wrong lr) moves the loss by more than 1e-4
LATER_LOSS_RTOL = 1e-5


@pytest.fixture(autouse=True)
def one_thread():
    """The port's CPU ops on one thread: under the suite's parallel
    workers, each PyTorch process's default of a thread a core
    oversubscribes the CPU, and its many small ops then wait on each
    other (six concurrent 16-lane policy sweeps at 8 threads each did not
    finish in 200 s on an 8-core CPU, against ~7 s each at one thread)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(arch):
    return (dataclasses.replace(ref_get_smoke_config(arch),
                                dtype=jnp.float32),
            dataclasses.replace(get_smoke_config(arch), dtype=torch.float32))


def _weights(arch):
    rcfg, pcfg = _cfgs(arch)
    rapi, papi = ref_get_model(rcfg), get_model(pcfg)
    rparams = rapi.init(jax.random.PRNGKey(0))
    pparams = params_from_jax(jax.tree_util.tree_map(np.asarray, rparams),
                              pcfg, device="cpu")
    return rapi, rparams, papi, pparams


@pytest.mark.parametrize("name", LM_SCRIPTS)
def test_script_imports_no_jax_repro_or_benchmarks(name):
    roots = torch_examples.imported_roots(name)
    assert not roots & {"jax", "jaxlib", "repro", "benchmarks"}, roots
    assert "repro_torch" in roots


@pytest.mark.parametrize("name", LM_SCRIPTS)
@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
def test_script_defaults_to_cuda_and_raises_without_a_card(name):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        torch_examples.load(name).main([])


@pytest.mark.parametrize("arch", ["qwen3-4b", "falcon-mamba-7b"])
def test_serve_lm_tokens_equal_reference(arch):
    sl = torch_examples.load("torch_serve_lm")
    rapi, rparams, papi, pparams = _weights(arch)
    reqs = sl.requests(4, papi.cfg.vocab, 16)
    got, _ = sl.serve(papi, pparams, reqs, 4, CPU)
    ref = RefServeLoop(rapi, rparams, slots=4, max_len=128)
    for r in reqs:
        ref.submit(RefRequest(rid=r.rid, prompt=r.prompt, max_new=r.max_new))
    want = {r.rid: r for r in ref.run()}
    got = {r.rid: r for r in got}
    assert sorted(got) == sorted(want) == [0, 1, 2, 3]
    for rid, w in want.items():
        assert got[rid].tokens == w.tokens, rid
        assert len(w.tokens) == 17
        assert got[rid].prefill_len == w.prefill_len
        assert got[rid].decode_steps == w.decode_steps


def test_quickstart_training_equals_reference():
    qs = torch_examples.load("torch_quickstart")
    rapi, rparams, papi, pparams = _weights("qwen3-4b")
    got = qs.train(CPU, steps=3, cfg=papi.cfg, params=pparams)

    ocfg = RefAdamWConfig(total_steps=qs.TRAIN_STEPS, warmup_steps=3)
    opt = ref_opt_init(ocfg, rparams)
    step = jax.jit(ref_make_train_step(rapi, ocfg))
    pipe = RefTokenPipeline(vocab=rapi.cfg.vocab, batch=8, seq=32)
    want = {"loss": [], "lr": []}
    for i in range(3):
        batch = {k: jnp.asarray(v) for k, v in pipe.batch_at(i).items()}
        rparams, opt, met = step(rparams, opt, batch)
        for k in want:
            want[k].append(float(met[k]))
    np.testing.assert_allclose(got["loss"][0], want["loss"][0], rtol=1e-6)
    np.testing.assert_allclose(got["loss"][1:], want["loss"][1:],
                               rtol=LATER_LOSS_RTOL)
    np.testing.assert_allclose(got["lr"], want["lr"], rtol=1e-6)


def test_train_lm_crash_restart_is_bitwise(tmp_path):
    tl = torch_examples.load("torch_train_lm")
    cfg = tl.PRESETS["tiny"]
    runs = {}
    for crash_at in (2, -1):
        runs[crash_at] = tl.train(cfg, 4, 8, 256,
                                  str(tmp_path / f"crash{crash_at}"), 2,
                                  crash_at, CPU)
    crashed, clean = runs[2], runs[-1]
    assert crashed["restarts"] == 1 and clean["restarts"] == 0
    assert crashed["final_step"] == clean["final_step"] == 4
    assert [h["step"] for h in crashed["history"]] == [0, 1, 2, 3]
    for a, b in zip(crashed["history"], clean["history"]):
        assert a.keys() == b.keys()
        for k in a:
            if k != "dt":
                assert a[k] == b[k], (a["step"], k)
        assert np.isfinite(a["loss"])
