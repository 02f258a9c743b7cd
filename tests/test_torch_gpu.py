"""The port on a CUDA device: the min-plus kernel bitwise against its plain
version, ``apsp`` against the numpy hop distances, and a CUDA engine run
against the CPU run.  Every test is marked ``gpu`` and skips without a
card; this file imports neither jax nor ``repro``, so it also runs where
only PyTorch is installed:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py
"""
import numpy as np
import pytest
import torch

from repro_torch.api import Experiment, PolicyConfig
from repro_torch.core import ROUTE_LEGACY, ROUTE_SDN
from repro_torch.core.routing import hop_distances_np
from repro_torch.kernels.tropical_apsp import (apsp, kernel, minplus_matmul,
                                               minplus_matmul_ref)
from repro_torch.scenarios import get_scenario

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
