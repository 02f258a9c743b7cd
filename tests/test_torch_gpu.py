"""The port on a CUDA device: the min-plus kernel bitwise against its plain
version, ``apsp`` against the numpy hop distances, a CUDA engine run
against the CPU run, the flash-attention kernel against its plain version
and a CUDA serving loop through the kernel against the same loop through
the plain attention.  Every test is marked ``gpu`` and skips without a
card; this file imports neither jax nor ``repro``, so it also runs where
only PyTorch is installed:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py
"""
import numpy as np
import pytest
import torch

import dataclasses

from repro_torch.api import Experiment, PolicyConfig
from repro_torch.configs import get_smoke_config
from repro_torch.core import ROUTE_LEGACY, ROUTE_SDN
from repro_torch.core.routing import hop_distances_np
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.flash_attention import kernel as fa_kernel
from repro_torch.kernels.flash_attention import naive_attention
from repro_torch.kernels.tropical_apsp import (apsp, kernel, minplus_matmul,
                                               minplus_matmul_ref)
from repro_torch.models import get_model
from repro_torch.scenarios import get_scenario
from repro_torch.serve import Request, ServeLoop

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("m,k,n", [(37, 37, 37), (153, 153, 153),
                                   (100, 37, 257), (1, 3, 2)])
def test_kernel_bitwise_equal_to_plain(cuda, m, k, n):
    rng = np.random.RandomState(m + k + n)
    x = rng.uniform(0, 10, (m, k)).astype(np.float32)
    y = rng.uniform(0, 10, (k, n)).astype(np.float32)
    x[rng.rand(m, k) < 0.1] = np.inf
    xd, yd = torch.from_numpy(x).to(cuda), torch.from_numpy(y).to(cuda)
    before = kernel.launch_count()
    got = minplus_matmul(xd, yd)
    torch.cuda.synchronize()
    assert kernel.launch_count() == before + 1
    assert torch.equal(got, minplus_matmul_ref(xd, yd))


@pytest.mark.parametrize("name", ["paper-fabric", "leaf-spine-xl"])
def test_apsp_on_card_equals_numpy(cuda, name):
    hop = get_scenario(name).topology().hop_matrix()
    got = apsp(torch.from_numpy(hop).to(cuda)).cpu().numpy()
    np.testing.assert_array_equal(got.astype(np.float64),
                                  hop_distances_np(hop))


def test_cuda_run_equals_cpu_run(cuda):
    pols = [PolicyConfig(routing=r, placement=p)
            for r in (ROUTE_SDN, ROUTE_LEGACY) for p in (0, 1, 2)]
    gpu = Experiment("leaf-spine", pols, device=cuda).run()
    cpu = Experiment("leaf-spine", pols, device="cpu").run()
    for name, a, b in zip(gpu.states._fields, gpu.states, cpu.states):
        a = a.cpu()
        assert a.dtype == b.dtype and a.shape == b.shape, name
        if a.dtype.is_floating_point:
            assert torch.allclose(a, b, rtol=1e-6, atol=0.0,
                                  equal_nan=True), name
        else:
            assert torch.equal(a, b), name


# b, sq, skv, h, kv, dh, causal, q_offset: a sweep shape, qwen3-4b's
# serving bucket, and a ragged chunk after cached positions
FA_SHAPES = [(2, 64, 64, 4, 2, 32, True, 0), (1, 32, 32, 32, 8, 128, True, 0),
             (1, 70, 200, 8, 2, 64, True, 130)]
FA_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,sq,skv,h,kv,dh,causal,off", FA_SHAPES)
def test_flash_kernel_against_plain(cuda, b, sq, skv, h, kv, dh, causal,
                                    off, dtype):
    """2e-5 in float32 (TF32 off), 2e-2 in bf16: the reference's own
    tolerances for its Pallas kernel against the naive attention."""
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cpu").manual_seed(sq + skv)
    q = torch.randn(b, sq, h, dh, generator=gen).to(dtype).to(cuda)
    k = torch.randn(b, skv, kv, dh, generator=gen).to(dtype).to(cuda)
    v = torch.randn(b, skv, kv, dh, generator=gen).to(dtype).to(cuda)
    before = fa_kernel.launch_count()
    got = flash_attention(q, k, v, causal=causal, q_offset=off)
    torch.cuda.synchronize()
    assert fa_kernel.launch_count() == before + 1
    assert got.dtype == dtype and got.shape == q.shape
    want = naive_attention(q, k, v, causal=causal, q_offset=off)
    torch.testing.assert_close(got.float(), want.float(), rtol=FA_TOL[dtype],
                               atol=FA_TOL[dtype])


def test_flash_kernel_refuses_other_head_dims(cuda):
    q = torch.zeros(1, 8, 2, 48, device=cuda)
    with pytest.raises(ValueError, match="Dh"):
        flash_attention(q, q, q)


def test_serve_loop_kernel_equals_plain_on_card(cuda):
    """Smoke qwen3-4b in float32 on the card: the loop whose prefill runs
    the kernel gives the same greedy tokens as the loop on the plain
    attention, and the kernel ran once per layer per prefill."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(get_smoke_config("qwen3-4b"),
                              dtype=torch.float32)
    api = get_model(cfg)
    params = api.init(0, device=cuda)
    rng = np.random.RandomState(1)
    prompts = [rng.randint(1, cfg.vocab, n).astype(np.int32)
               for n in (8, 20, 33)]
    tokens = {}
    for backend in ("kernel", "naive"):
        loop = ServeLoop(api, params, slots=2, max_len=96, bucket=32,
                         backend=backend, device=cuda)
        for i, pr in enumerate(prompts):
            loop.submit(Request(rid=i, prompt=pr, max_new=6))
        before = fa_kernel.launch_count()
        tokens[backend] = {r.rid: r.tokens for r in loop.run()}
        launched = fa_kernel.launch_count() - before
        assert launched == (cfg.n_layers * 3 if backend == "kernel" else 0)
    assert tokens["kernel"] == tokens["naive"]
    assert all(len(t) == 7 for t in tokens["kernel"].values())
