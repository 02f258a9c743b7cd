"""Port's min-plus product and APSP (repro_torch.kernels.tropical_apsp)
against the reference's Pallas kernel (interpret mode), its jnp oracle and
the numpy hop distances, at every number of squarings; the property the
one-launch APSP's early stop rests on; the hop distances of the route
table; the host's tile choice.  CPU tensors take the plain PyTorch
version; the CUDA kernel itself is checked on the card
(tests/test_torch_gpu.py and chip_smoke.py)."""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.routing import hop_distances_np
from repro.core.routing import min_plus_square_np as ref_min_plus_square_np
from repro.kernels.tropical_apsp.kernel import minplus_matmul as ref_minplus
from repro.kernels.tropical_apsp.ops import apsp as ref_apsp
from repro.kernels.tropical_apsp.ref import apsp_ref as ref_apsp_ref
from repro.kernels.tropical_apsp.ref import minplus_matmul_ref as ref_oracle
from repro.scenarios import get_scenario as ref_get_scenario
from repro_torch.core.topology import fat_tree
from repro_torch.kernels.tropical_apsp import (apsp, apsp_early_stop_ref,
                                               apsp_ref, kernel,
                                               minplus_matmul,
                                               minplus_matmul_ref)
from repro_torch.kernels.tropical_apsp.ref import apsp_steps

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


@pytest.mark.parametrize("entry,dtype", [("apsp_f32", torch.float32),
                                         ("apsp_f32", torch.float64)])
def test_apsp_entries_refuse_cpu_tensors(entry, dtype):
    with pytest.raises(ValueError, match="CUDA"):
        getattr(kernel, entry)(torch.zeros(4, 4, dtype=dtype))
    assert kernel.launch_count() == 0


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



def _random_graph(n, density, seed):
    rng = np.random.RandomState(seed)
    adj = np.full((n, n), np.inf, np.float32)
    mask = rng.rand(n, n) < density
    adj[mask] = rng.uniform(0.1, 5.0, mask.sum()).astype(np.float32)
    np.fill_diagonal(adj, 0)
    return adj


def _slice_graphs():
    graphs = {f"random-{n}": _random_graph(n, dens, n)
              for n, dens in ((17, 0.2), (64, 0.1), (90, 0.05))}
    graphs.update({name: ref_get_scenario(name).topology().hop_matrix()
                   for name in SLICE_SCENARIOS})
    return graphs


SLICE_GRAPHS = _slice_graphs()


@pytest.mark.parametrize("name", sorted(SLICE_GRAPHS))
def test_apsp_vs_reference_ops_at_every_steps(name):
    """ops.apsp on the CPU against the reference's ops.apsp (its Pallas
    kernel in interpret mode) for every number of squarings up to one past
    the default; the early-stopping loop of the one-launch kernel gives the
    same distances at each."""
    adj = SLICE_GRAPHS[name]
    for steps in range(1, apsp_steps(adj.shape[0]) + 2):
        got = apsp(torch.from_numpy(adj), steps=steps).numpy()
        want = np.asarray(ref_apsp(jnp.asarray(adj), steps=steps,
                                   interpret=True))
        # the Pallas kernel starts at BIG = 3.4e38 where this port starts
        # at inf
        big = want >= 1e30
        np.testing.assert_array_equal(got[~big], want[~big])
        assert np.all(np.isinf(got[big]))
        early, ran = apsp_early_stop_ref(torch.from_numpy(adj), steps)
        np.testing.assert_array_equal(early.numpy(), got)
        assert 1 <= ran <= steps


@pytest.mark.parametrize("name", sorted(SLICE_GRAPHS))
def test_settled_matrix_squares_to_itself(name):
    """The early stop's premise: once a squaring changes nothing, every
    later one changes no bit either."""
    adj = torch.from_numpy(SLICE_GRAPHS[name])
    # float sums round, so a weighted graph may take a squaring or two
    # past ceil(log2 n) to stop changing
    budget = apsp_steps(adj.shape[0]) + 4
    d, ran = apsp_early_stop_ref(adj, budget)
    assert ran < budget                        # it did settle
    again = minplus_matmul_ref(d, d)
    assert torch.equal(again.view(torch.int32), d.view(torch.int32))
    assert torch.equal(apsp_ref(d, steps=3).view(torch.int32),
                       d.view(torch.int32))


@pytest.mark.parametrize("name", SLICE_SCENARIOS)
def test_early_stop_matches_reference_host_loop(name):
    """The one-launch kernel's stopping rule on each scenario's hop matrix
    is the reference's host loop (``hop_distances_np`` stops at the first
    squaring that changes nothing): the same distances after the same
    number of squarings."""
    hop = ref_get_scenario(name).topology().hop_matrix()
    d, ran_np = hop.astype(np.float64), 0
    for _ in range(apsp_steps(hop.shape[0])):
        nd = ref_min_plus_square_np(d)
        ran_np += 1
        if np.array_equal(nd, d):
            break
        d = nd
    got, ran = apsp_early_stop_ref(torch.from_numpy(hop))
    assert ran == ran_np
    np.testing.assert_array_equal(got.numpy().astype(np.float64), d)


def test_unreachable_pairs_stay_inf():
    """Two components: pairs across them stay +inf at every number of
    squarings (inf + inf is inf, never NaN), as in the numpy distances."""
    hop = np.full((6, 6), np.inf, np.float32)
    for a, b in ((0, 1), (1, 2), (3, 4), (4, 5)):
        hop[a, b] = hop[b, a] = 1
    np.fill_diagonal(hop, 0)
    want = hop_distances_np(hop)
    for steps in range(1, apsp_steps(6) + 2):
        got = apsp(torch.from_numpy(hop), steps=steps).numpy()
        assert not np.isnan(got).any()
        assert np.isinf(got[:3, 3:]).all() and np.isinf(got[3:, :3]).all()
    np.testing.assert_array_equal(got.astype(np.float64), want)


@pytest.mark.parametrize("name,topo,want", [
    ("leaf-spine-xl", None, 3), ("paper-fabric", None, 4),
    ("fat_tree(4)", fat_tree(4), 4), ("fat_tree(8)", fat_tree(8), 4)])
def test_early_stop_squarings(name, topo, want):
    """Squarings the one-launch APSP runs: those that reach the diameter
    plus one that confirms it (leaf-spine-xl: diameter 4, fat trees: 6)."""
    topo = topo or ref_get_scenario(name).topology()
    hop = torch.from_numpy(topo.hop_matrix())
    d, ran = apsp_early_stop_ref(hop)
    assert ran == want
    assert torch.equal(d, apsp_ref(hop))


@pytest.mark.parametrize("n,tile,blocks", [
    (1, 16, 1), (15, 16, 1), (16, 16, 1), (17, 16, 4), (153, 16, 100),
    (1345, 64, 484), (9473, 128, 5625)])
def test_tile_choice(n, tile, blocks):
    """The largest tile whose grid has a tile for each of the H100's 132
    SMs: 16 x 16 at the main path's n = 153 (100 blocks, not 25)."""
    assert kernel.tile_for(n) == tile
    assert math.ceil(n / tile) ** 2 == blocks
    bigger = [t for t in kernel.TILES if t > tile]
    assert all(math.ceil(n / t) ** 2 < kernel.H100_SMS for t in bigger)
