"""Port's min-plus product and APSP (repro_torch.kernels.tropical_apsp)
against the reference's Pallas kernel (interpret mode), its jnp oracle and
the numpy hop distances.  CPU tensors take the plain PyTorch version; the
CUDA kernel itself is checked on the card (tests/test_torch_gpu.py and
chip_smoke.py)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.routing import hop_distances_np
from repro.kernels.tropical_apsp.kernel import minplus_matmul as ref_minplus
from repro.kernels.tropical_apsp.ref import apsp_ref as ref_apsp_ref
from repro.kernels.tropical_apsp.ref import minplus_matmul_ref as ref_oracle
from repro.scenarios import get_scenario as ref_get_scenario
from repro_torch.kernels.tropical_apsp import (apsp, apsp_ref, kernel,
                                               minplus_matmul,
                                               minplus_matmul_ref)

SLICE_SCENARIOS = ("paper-fabric", "leaf-spine", "fat-tree",
                   "canonical-tree", "leaf-spine-xl")


@pytest.mark.parametrize("m,k,n,block", [
    (8, 8, 8, 8), (32, 16, 24, 16), (100, 64, 50, 32), (130, 130, 130, 64)])
def test_minplus_matmul_vs_reference(m, k, n, block):
    rng = np.random.RandomState(m * 7 + n)
    x = rng.uniform(0, 10, (m, k)).astype(np.float32)
    y = rng.uniform(0, 10, (k, n)).astype(np.float32)
    x[rng.rand(m, k) < 0.05] = np.inf
    kernel.reset_launch_count()
    got = minplus_matmul(torch.from_numpy(x), torch.from_numpy(y)).numpy()
    oracle = np.asarray(ref_oracle(jnp.asarray(x), jnp.asarray(y)))
    pallas = np.asarray(ref_minplus(jnp.asarray(x), jnp.asarray(y), bm=block,
                                    bn=block, bk=block, interpret=True))
    np.testing.assert_array_equal(got, oracle)
    # the Pallas kernel starts at BIG = 3.4e38 where this port starts at inf
    big = pallas >= 1e30
    np.testing.assert_array_equal(got[~big], pallas[~big])
    assert np.all(np.isinf(got[big]))
    assert kernel.launch_count() == 0


def test_minplus_chunked_equals_unchunked(monkeypatch):
    from repro_torch.kernels.tropical_apsp import ref as ref_mod
    rng = np.random.RandomState(3)
    x = torch.from_numpy(rng.uniform(0, 5, (40, 70)).astype(np.float32))
    y = torch.from_numpy(rng.uniform(0, 5, (70, 30)).astype(np.float32))
    whole = minplus_matmul_ref(x, y)
    monkeypatch.setattr(ref_mod, "_CHUNK_ELEMS", 40 * 30 * 3)
    assert torch.equal(minplus_matmul_ref(x, y), whole)


@pytest.mark.parametrize("n,density", [(17, 0.2), (64, 0.1), (90, 0.05)])
def test_apsp_vs_reference(n, density):
    rng = np.random.RandomState(n)
    adj = np.full((n, n), np.inf, np.float32)
    np.fill_diagonal(adj, 0)
    mask = rng.rand(n, n) < density
    adj[mask] = rng.uniform(0.1, 5.0, mask.sum()).astype(np.float32)
    np.fill_diagonal(adj, 0)
    got = apsp(torch.from_numpy(adj)).numpy()
    want = np.asarray(ref_apsp_ref(jnp.asarray(adj)))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(apsp_ref(torch.from_numpy(adj)).numpy(),
                                  want)


@pytest.mark.parametrize("name", SLICE_SCENARIOS)
def test_apsp_equals_numpy_hop_distances(name):
    hop = ref_get_scenario(name).topology().hop_matrix()
    got = apsp(torch.from_numpy(hop)).numpy().astype(np.float64)
    np.testing.assert_array_equal(got, hop_distances_np(hop))


def test_kernel_refuses_cpu_tensors():
    x = torch.zeros(4, 4)
    with pytest.raises(ValueError, match="CUDA"):
        kernel.minplus_f32(x, x)


def test_cuda_without_a_card_raises():
    from repro_torch.core.routing import hop_distances
    from repro_torch.device import resolve
    hop = ref_get_scenario("leaf-spine").topology().hop_matrix()
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve("cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        hop_distances(hop)          # device=None means CUDA

