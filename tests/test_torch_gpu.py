"""The port on a CUDA device: the min-plus kernel bitwise against its plain
version at every tile (one product, and the one-launch APSP at every
number of squarings, with the squarings it ran), ``apsp`` against the
numpy hop distances, a refused over-sized grid, CUDA engine runs
(healthy, with failures, the packed four-scenario grid, the control
plane and the chaos stack, a fleet with refills and a refilling stream)
against the CPU runs, the flash-attention kernel against its plain version,
a CUDA serving loop through the kernel against the same loop through the
plain attention, and both selective-scan entry points against their plain
versions with a Mamba serving loop through the kernel against the chunked
scan; the bf16 flash kernel at its tile edges and on strided views, the
fused scan across its tile borders, and each kernel's occupancy; the MoE
layer on the card equal to the CPU with no host sync, MoE and hybrid
serving loops through the kernels against the plain versions, the
advisor's DES and an ingest job on CUDA against the CPU; the op budget on
the card against the CPU ledger, and its host syncs.  Every
test is marked ``gpu`` and skips without a card; this file imports
neither jax nor ``repro``, so it also runs where only PyTorch is
installed:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py
"""
import numpy as np
import pytest
import torch

import dataclasses
from unittest import mock

from repro_torch.api import Experiment, PolicyConfig
from repro_torch.configs import get_smoke_config
from repro_torch.core import (INSTALL_PROACTIVE, MIG_CONGESTION,
                              ROUTE_LEGACY, ROUTE_SDN)
from repro_torch.core.mapreduce import INSTALLING
from repro_torch.core.routing import hop_distances, hop_distances_np
from repro_torch.core.topology import fat_tree
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.flash_attention import kernel as fa_kernel
from repro_torch.kernels.flash_attention import naive_attention
from repro_torch.kernels.selective_scan import (fused_scan_ref,
                                                selective_scan,
                                                selective_scan_fused,
                                                selective_scan_ref)
from repro_torch.kernels.selective_scan import kernel as scan_kernel
from repro_torch.kernels.tropical_apsp import (apsp, apsp_ref, kernel,
                                               minplus_matmul,
                                               minplus_matmul_ref)
from repro_torch.kernels.tropical_apsp.ref import apsp_steps
from repro_torch.data import pipeline_jobs
from repro_torch.models import get_model, moe
from repro_torch.roofline import advise_allreduce
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


def _squarings(adj, max_steps):
    """D_0 .. D_max of repeated squaring by the plain product, and the
    first s whose squaring changed nothing (None if none did)."""
    seq = [adj]
    settled = None
    for s in range(max_steps):
        seq.append(minplus_matmul_ref(seq[-1], seq[-1]))
        if settled is None and torch.equal(seq[-1].view(torch.int32),
                                           seq[-2].view(torch.int32)):
            settled = s
    return seq, settled


def _graphs(n, hops, cuda):
    """A sparse random graph and a directed chain (diameter n - 1, so every
    squaring up to the default changes something), with weights in
    (0.1, 5), or with 1..5 hops when ``hops``."""
    rng = np.random.RandomState(n)
    out = []
    for chain in (False, True):
        if chain:
            mask = np.zeros((n, n), bool)
            mask[np.arange(n - 1), np.arange(1, n)] = True
        else:
            mask = rng.rand(n, n) < min(1.0, 3.0 / n)
        adj = np.full((n, n), np.inf, np.float32)
        adj[mask] = (rng.randint(1, 6, mask.sum()) if hops
                     else rng.uniform(0.1, 5.0, mask.sum()))
        np.fill_diagonal(adj, 0)
        out.append(torch.from_numpy(adj).to(cuda))
    return out


@pytest.mark.parametrize("hops", [False, True])
@pytest.mark.parametrize("n", [1, 2, 15, 16, 17, 31, 33, 127, 129, 153, 257,
                               1345])
def test_apsp_kernel_bitwise_equal_to_plain_at_every_steps(cuda, n, hops):
    """apsp_f32 at every tile and every number of squarings up to one past
    the default, on float weights and on integer hop counts: the plain
    version's distances bit for bit, the squarings it ran (the first that
    changed nothing, or all), one launch each."""
    for adj in _graphs(n, hops, cuda):
        max_steps = apsp_steps(n) + 1
        seq, settled = _squarings(adj, max_steps)
        for steps in range(1, max_steps + 1):
            want_ran = steps if settled is None else min(steps, settled + 1)
            for tile in kernel.TILES:
                before = kernel.launch_count()
                got = kernel.apsp_f32(adj, steps, tile=tile)
                torch.cuda.synchronize()
                assert kernel.launch_count() == before + 1
                assert got.dtype == torch.float32 and got.shape == adj.shape
                assert torch.equal(got, seq[steps]), (steps, tile)
                assert int(kernel.last_squarings()) == want_ran, (steps,
                                                                 tile)


@pytest.mark.parametrize("name,want", [("leaf-spine-xl", 3),
                                       ("fat_tree(16)", 4)])
def test_apsp_squarings_on_fabrics(cuda, name, want):
    """The one-launch APSP stops after the squaring that confirms the
    diameter (4 on leaf-spine-xl, 6 on fat trees): 3 and 4 squarings,
    with the distances of the full count, also when allowed more."""
    topo = (fat_tree(16) if name == "fat_tree(16)"
            else get_scenario(name).topology())
    hop = torch.from_numpy(topo.hop_matrix()).to(cuda)
    want_d = apsp_ref(hop, steps=want)
    got = kernel.apsp_f32(hop)
    assert int(kernel.last_squarings()) == want
    assert torch.equal(got, want_d)
    got = apsp(hop, steps=want + 3)
    assert int(kernel.last_squarings()) == want
    assert torch.equal(got, want_d)


def test_route_table_distances_take_one_launch(cuda):
    hop = get_scenario("leaf-spine-xl").topology().hop_matrix()
    kernel.reset_launch_count()
    got = hop_distances(hop, device=cuda)
    assert kernel.launch_counts() == {"minplus_f32": 0, "apsp_f32": 1}
    np.testing.assert_array_equal(got, hop_distances_np(hop))


@pytest.mark.parametrize("tile", [16, 32, 64, 128])
@pytest.mark.parametrize("m,k,n", [(1, 1, 1), (16, 16, 16), (17, 33, 15),
                                   (128, 128, 128), (129, 17, 257),
                                   (100, 300, 7), (300, 5, 300)])
def test_minplus_kernel_at_tile_edges(cuda, m, k, n, tile):
    rng = np.random.RandomState(m * k + n)
    x = rng.uniform(0, 10, (m, k)).astype(np.float32)
    y = rng.uniform(0, 10, (k, n)).astype(np.float32)
    x[rng.rand(m, k) < 0.1] = np.inf
    y[rng.rand(k, n) < 0.1] = np.inf
    xd, yd = torch.from_numpy(x).to(cuda), torch.from_numpy(y).to(cuda)
    got = kernel.minplus_f32(xd, yd, tile=tile)
    torch.cuda.synchronize()
    assert torch.equal(got, minplus_matmul_ref(xd, yd))


@pytest.mark.parametrize("tile", [16, 128])
def test_apsp_kernel_refuses_an_oversized_grid(cuda, tile):
    """A persistent grid larger than the card holds at once is refused by
    the cooperative launch and raises; nothing is counted, and the card
    stays usable."""
    n = 4000
    adj = torch.zeros(n, n, device=cuda)
    cap = kernel.persistent_grid("apsp_f32", tile, n, cuda)
    assert cap == (kernel.kernel_info("apsp_f32", tile)["blocks_per_sm"]
                   * torch.cuda.get_device_properties(cuda)
                   .multi_processor_count)
    before = kernel.launch_count()
    with pytest.raises(RuntimeError, match="launch failed"):
        kernel.apsp_f32(adj, steps=1, tile=tile, grid=cap + 1)
    assert kernel.launch_count() == before
    torch.cuda.synchronize()
    assert torch.equal(kernel.apsp_f32(adj, steps=1, tile=tile, grid=cap),
                       adj)


def test_minplus_kernel_info_is_reported(cuda):
    for entry in kernel.ENTRIES:
        for tile in kernel.TILES:
            info = kernel.kernel_info(entry, tile)
            assert info["registers"] > 0 and info["blocks_per_sm"] >= 1
            assert info["threads"] == (64 if tile == 16 else 256)


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


@pytest.mark.parametrize("scenarios", [
    "paper-fabric-failures", "leaf-spine-failures",
    ["paper-fabric", "leaf-spine", "fat-tree", "canonical-tree"]],
    ids=["paper-fabric-failures", "leaf-spine-failures", "grid"])
def test_failures_and_grid_on_cuda_equal_cpu(cuda, scenarios):
    """The failure path (restart and resume) and the packed heterogeneous
    grid on the card against the same runs on the CPU."""
    pols = [PolicyConfig(routing=r, recovery=rec, job_concurrency=2)
            for r in (ROUTE_SDN, ROUTE_LEGACY) for rec in (0, 1)]
    gpu = Experiment(scenarios, pols, device=cuda).run()
    cpu = Experiment(scenarios, pols, device="cpu").run()
    assert gpu.states.time.device.type == "cuda"
    for name, a, b in zip(gpu.states._fields, gpu.states, cpu.states):
        a = a.cpu()
        assert a.dtype == b.dtype and a.shape == b.shape, name
        if a.dtype.is_floating_point:
            assert torch.allclose(a, b, rtol=1e-6, atol=0.0,
                                  equal_nan=True), name
        else:
            assert torch.equal(a, b), name


def _close(gpu, cpu, label):
    """Int/bool leaves equal, float leaves within rtol 1e-6."""
    for field, a, b in zip(gpu._fields, gpu, cpu):
        a, b = a.cpu(), b.cpu()
        assert a.dtype == b.dtype and a.shape == b.shape, f"{label} {field}"
        if a.dtype.is_floating_point:
            assert torch.allclose(a, b, rtol=1e-6, atol=0.0,
                                  equal_nan=True), f"{label} {field}"
        else:
            assert torch.equal(a, b), f"{label} {field}"


def test_fleet_and_stream_on_cuda_equal_cpu(cuda):
    """A small fleet that retires and refills lanes under outages, and a
    stream that recycles its ring under a controller, on the card against
    the same runs on the CPU: states within rtol 1e-6, the stream's job
    ledger, its sequence and class columns exactly.  The stream's SDN
    cohort is two lanes wide (admission widths 2 and 4), and its lanes'
    rings are seen to hold different jobs in one generation."""
    from repro_torch.api import stream
    from repro_torch.core.streaming import STREAM_FIELDS
    from repro_torch.scenarios.registry import stream_arrivals
    pols = [PolicyConfig(routing=r, seed=sd, job_concurrency=2)
            for r in (ROUTE_SDN, ROUTE_LEGACY) for sd in range(3)]
    runs = {dev: Experiment("paper-fabric-failures", pols,
                            device=dev).run_fleet(width=2, chunk_steps=8,
                                                  return_stats=True)
            for dev in (cuda, "cpu")}
    (gpu, gst), (cpu, cst) = runs[cuda], runs["cpu"]
    assert gpu.states.time.device.type == "cuda" and gst.refills > 0
    assert vars(gst) == vars(cst)
    _close(gpu.states, cpu.states, "fleet")
    spols = [pols[0], pols[3],
             PolicyConfig(routing=ROUTE_SDN, seed=1, job_concurrency=4)]
    upload, diverged = stream._upload, []

    def spy(consts0, host, dev):
        diverged.append(any(bool((host[f][0] != host[f][-1]).any())
                            for f in STREAM_FIELDS))
        return upload(consts0, host, dev)
    with mock.patch.object(stream, "_upload", spy):
        streams = {dev: Experiment("paper-fabric-ctrl", spols,
                                   device=dev).run_stream(
            stream_arrivals(rate=0.1, seed=2), 150.0, slots=3,
            chunk_steps=24, return_states=True) for dev in (cuda, "cpu")}
    g, c = streams[cuda], streams["cpu"]
    assert g.stats.refills > 0 and vars(g.stats) == vars(c.stats)
    assert g.stats.cohorts == 2 and any(diverged)
    for pi in range(3):
        for k in ("seq", "cls"):
            assert np.array_equal(g.jobs[pi][k], c.jobs[pi][k]), k
        for k in ("t_arr", "t_admit", "t_done"):
            np.testing.assert_allclose(g.jobs[pi][k], c.jobs[pi][k],
                                       rtol=1e-6, atol=0.0)
        _close(g.final_states[pi], c.final_states[pi], f"stream {pi}")


@pytest.mark.parametrize("name,pols", [
    ("leaf-spine-ctrl",
     [dict(routing=ROUTE_SDN),
      dict(routing=ROUTE_SDN, install_mode=INSTALL_PROACTIVE),
      dict(routing=ROUTE_LEGACY),
      dict(routing=ROUTE_SDN, migration=MIG_CONGESTION)]),
    ("paper-fabric-chaos",
     [dict(routing=r, speculation=sp) for r in (ROUTE_SDN, ROUTE_LEGACY)
      for sp in (0, 1)])], ids=["leaf-spine-ctrl", "paper-fabric-chaos"])
def test_ctrl_and_chaos_on_cuda_equal_cpu(cuda, name, pols):
    """The control plane (reactive, proactive, legacy, migration) and the
    chaos stack (outages, gray windows, failover, speculation) on the card
    against the same runs on the CPU; the flow tables conserve their
    installs and nothing is left parked."""
    pols = [PolicyConfig(job_concurrency=2, **k) for k in pols]
    gpu = Experiment(name, pols, device=cuda).run()
    cpu = Experiment(name, pols, device="cpu").run()
    assert gpu.states.time.device.type == "cuda" and gpu.meta.has_ctrl
    for field, a, b in zip(gpu.states._fields, gpu.states, cpu.states):
        a = a.cpu()
        assert a.dtype == b.dtype and a.shape == b.shape, field
        if a.dtype.is_floating_point:
            assert torch.allclose(a, b, rtol=1e-6, atol=0.0,
                                  equal_nan=True), field
        else:
            assert torch.equal(a, b), field
    st = gpu.states
    occupied = (st.ftab_pair >= 0).sum((-2, -1), dtype=torch.int32)
    assert torch.equal(occupied, st.ctrl_installs - st.ctrl_evictions)
    assert not bool((st.pkt_state == INSTALLING).any())


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


def _bf16_qkv(cuda, seed, b, sq, skv, h, kv, dh):
    gen = torch.Generator(device="cpu").manual_seed(seed)
    return [torch.randn(b, s, n, dh, generator=gen).bfloat16().to(cuda)
            for s, n in ((sq, h), (skv, kv), (skv, kv))]


def _hold_flash(q, k, v, causal, off):
    before = fa_kernel.launch_count()
    got = flash_attention(q, k, v, causal=causal, q_offset=off)
    torch.cuda.synchronize()
    assert fa_kernel.launch_count() == before + 1
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    want = naive_attention(q, k, v, causal=causal, q_offset=off)
    torch.testing.assert_close(got.float(), want.float(), rtol=2e-2,
                               atol=2e-2)


# the tensor-core kernel's tile edges (128 query rows, 64 keys a tile), on
# every Dh, with GQA groups of 1, 4 and 8 in turn
@pytest.mark.parametrize("dh", [16, 32, 64, 128])
@pytest.mark.parametrize("s", [1, 63, 64, 65, 127, 129, 1000])
def test_flash_bf16_tile_edges(cuda, s, dh):
    group = (1, 4, 8)[(s + dh // 16) % 3]
    _hold_flash(*_bf16_qkv(cuda, s + dh, 1, s, s, 8, 8 // group, dh),
                True, 0)


# b, sq, skv, causal, q_offset: queries after cached positions (Sq < Skv),
# and non-causal ragged shapes either way
@pytest.mark.parametrize("b,sq,skv,causal,off", [
    (1, 1, 129, True, 128), (2, 63, 1000, True, 937), (1, 65, 129, True, 64),
    (1, 100, 1000, True, 500), (2, 64, 1000, False, 0),
    (1, 129, 63, False, 0), (1, 1, 65, False, 0)])
def test_flash_bf16_offsets_and_noncausal(cuda, b, sq, skv, causal, off):
    _hold_flash(*_bf16_qkv(cuda, sq + skv, b, sq, skv, 8, 2, 128), causal,
                off)


# whisper-base's two new shapes: the encoder's non-causal self-attention
# over 1500 frames, and the cross-attention of a 4-token prompt over them
@pytest.mark.parametrize("sq", [1500, 4])
def test_flash_bf16_at_whisper_shapes(cuda, sq):
    _hold_flash(*_bf16_qkv(cuda, sq, 8, sq, 1500, 8, 8, 64), False, 0)


def test_flash_bf16_takes_an_aligned_view_and_refuses_a_misaligned_one(cuda):
    """q, k, v cut from one fused [B, S, H + 2 KV, Dh] buffer: strided,
    16-byte aligned, taken by TMA.  A view one element off a 16-byte
    boundary raises before any launch."""
    gen = torch.Generator(device="cpu").manual_seed(5)
    buf = torch.randn(2, 100, 48, 128, generator=gen).bfloat16().to(cuda)
    q, k, v = buf[:, :, :32], buf[:, :, 32:40], buf[:, :, 40:48]
    assert not q.is_contiguous()
    _hold_flash(q, k, v, True, 0)
    wide = torch.randn(1, 100, 32, 136, generator=gen).bfloat16().to(cuda)
    kv = wide[:, :, :8, 8:136]
    before = fa_kernel.launch_count()
    with pytest.raises(ValueError, match="16-byte"):
        flash_attention(wide[..., 1:129], kv, kv)
    assert fa_kernel.launch_count() == before


def test_kernel_occupancy_is_reported(cuda):
    for dh in fa_kernel.HEAD_DIMS:
        for dtype in (torch.bfloat16, torch.float32):
            info = fa_kernel.kernel_info(dtype, dh)
            assert info["registers"] > 0 and info["blocks_per_sm"] >= 1
    for name in scan_kernel.KERNELS:
        info = scan_kernel.kernel_info(name, 16)
        assert info["registers"] > 0 and info["blocks_per_sm"] >= 1


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


# the selective scan against its plain versions: rtol 1e-4, atol 1e-5, the
# reference's own tolerance for its kernel (the sums run in other orders)
SCAN_TOL = dict(rtol=1e-4, atol=1e-5)


def _scan_inputs(cuda, seed, b, s, d, n, h0_scale=0.0):
    """dt = softplus(U(-7, -2)), A = -[1..N]; a, b of the Pallas contract
    materialised from them."""
    gen = torch.Generator(device="cpu").manual_seed(seed)
    dt = torch.nn.functional.softplus(torch.rand(b, s, d, generator=gen) * 5
                                      - 7)
    x = torch.randn(b, s, d, generator=gen)
    bmat = torch.randn(b, s, n, generator=gen)
    cmat = torch.randn(b, s, n, generator=gen)
    a_neg = -torch.arange(1, n + 1, dtype=torch.float32).repeat(d, 1)
    h0 = torch.randn(b, d, n, generator=gen) * h0_scale
    return [t.to(cuda) for t in (dt, x, bmat, cmat, a_neg, h0)]


@pytest.mark.parametrize("b,s,d,n", [(2, 16, 8, 4), (1, 100, 32, 16),
                                     (2, 64, 300, 16), (1, 33, 24, 8),
                                     (1, 300, 1000, 16)])
def test_scan_kernel_against_plain(cuda, b, s, d, n):
    dt, x, bmat, cmat, a_neg, _ = _scan_inputs(cuda, s + d, b, s, d, n)
    a = torch.exp(dt[..., None] * a_neg).contiguous()
    bb = ((dt * x)[..., None] * bmat[:, :, None, :]).contiguous()
    before = scan_kernel.launch_count()
    got = selective_scan(a, bb, cmat)
    torch.cuda.synchronize()
    assert scan_kernel.launch_count() == before + 1
    assert got.shape == (b, s, d) and got.dtype == torch.float32
    torch.testing.assert_close(got, selective_scan_ref(a, bb, cmat),
                               **SCAN_TOL)


@pytest.mark.parametrize("b,s,d,n,h0_scale", [
    (4, 1, 8192, 16, 0.5), (1, 32, 8192, 16, 0.0), (2, 200, 300, 4, 1.0),
    (1, 1000, 1000, 16, 0.0), (3, 130, 77, 8, 0.3)])
def test_fused_scan_kernel_against_plain(cuda, b, s, d, n, h0_scale):
    args = _scan_inputs(cuda, s + d, b, s, d, n, h0_scale)
    before = scan_kernel.launch_count()
    y, h_last = selective_scan_fused(*args)
    torch.cuda.synchronize()
    assert scan_kernel.launch_count() == before + 1
    want_y, want_h = fused_scan_ref(*args)
    torch.testing.assert_close(y, want_y, **SCAN_TOL)
    torch.testing.assert_close(h_last, want_h, **SCAN_TOL)


# the fused kernel across the borders of its shared-memory tiles of 16
# steps, at every N, from a nonzero state, at a ragged D
@pytest.mark.parametrize("n", [1, 2, 4, 8, 16, 32])
@pytest.mark.parametrize("b", [1, 4])
@pytest.mark.parametrize("s", [1, 15, 16, 17, 2049])
def test_fused_scan_kernel_across_tile_borders(cuda, s, b, n):
    args = _scan_inputs(cuda, s + n, b, s, 8190, n, 0.5)
    before = scan_kernel.launch_count()
    y, h_last = scan_kernel.selective_scan_fused_f32(*args)
    torch.cuda.synchronize()
    assert scan_kernel.launch_count() == before + 1
    want_y, want_h = fused_scan_ref(*args)
    torch.testing.assert_close(y, want_y, **SCAN_TOL)
    torch.testing.assert_close(h_last, want_h, **SCAN_TOL)


def test_scan_kernel_refuses_other_state_sizes(cuda):
    args = _scan_inputs(cuda, 0, 1, 4, 8, 12)
    with pytest.raises(ValueError, match="N in"):
        selective_scan_fused(*args)
    a = torch.zeros(1, 4, 8, 3, device=cuda)
    with pytest.raises(ValueError, match="N in"):
        selective_scan(a, a, torch.zeros(1, 4, 3, device=cuda))
    with pytest.raises(TypeError, match="float32"):
        selective_scan_fused(*(t.double() for t in
                               _scan_inputs(cuda, 0, 1, 4, 8, 4)))


def test_mamba_serve_loop_kernel_equals_chunked_on_card(cuda):
    """Smoke falcon-mamba in float32 on the card: the loop whose scans run
    the kernel gives the same greedy tokens as the loop on the chunked
    scan, and the kernel ran once per layer per prefill and per tick."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(get_smoke_config("falcon-mamba-7b"),
                              dtype=torch.float32)
    api = get_model(cfg)
    params = api.init(0, device=cuda)
    rng = np.random.RandomState(1)
    prompts = [rng.randint(1, cfg.vocab, n).astype(np.int32)
               for n in (8, 20, 33)]
    tokens = {}
    for backend in ("kernel", "chunked"):
        loop = ServeLoop(api, params, slots=2, max_len=96, bucket=32,
                         backend=backend, device=cuda)
        for i, pr in enumerate(prompts):
            loop.submit(Request(rid=i, prompt=pr, max_new=6))
        before = scan_kernel.launch_count()
        ticks = 0
        out = []
        while loop.queue or loop.active:
            out.extend(loop.tick())
            ticks += 1
        tokens[backend] = {r.rid: r.tokens for r in out}
        launched = scan_kernel.launch_count() - before
        assert launched == (cfg.n_layers * (3 + ticks)
                            if backend == "kernel" else 0)
    assert tokens["kernel"] == tokens["chunked"]
    assert all(len(t) == 7 for t in tokens["kernel"].values())


def _moe_layer(device, dtype, seed=0):
    cfg = dataclasses.replace(get_smoke_config("qwen3-moe-30b-a3b"),
                              dtype=dtype)
    gen = torch.Generator(device="cpu").manual_seed(seed)
    p = moe.fill_moe(moe.MoE(cfg, "cpu").requires_grad_(False), gen)
    return cfg, p.to(device)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_moe_apply_on_cuda_equals_cpu_without_a_sync(cuda, dtype):
    """The routing on the card equals the CPU's (float32 router, TF32
    off), the output agrees (float32 accumulation on both), and the layer
    issues no host sync (the capacity is static in the shapes)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg, p_cpu = _moe_layer("cpu", dtype)
    p_gpu = _moe_layer(cuda, dtype)[1]
    x = torch.randn(4, 32, cfg.d_model,
                    generator=torch.Generator().manual_seed(1)).to(dtype)
    want, want_aux = moe.moe_apply(p_cpu, x, cfg)
    xg = x.to(cuda)
    moe.moe_apply(p_gpu, xg, cfg)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got, aux = moe.moe_apply(p_gpu, xg, cfg)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    cap = moe._capacity(128, cfg)
    for a, b in zip(moe.route(p_gpu, xg.reshape(128, -1), cfg, cap)[1:4],
                    moe.route(p_cpu, x.reshape(128, -1), cfg, cap)[1:4]):
        assert torch.equal(a.cpu(), b)
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got.cpu().float(), want.float(), rtol=tol,
                               atol=tol)
    torch.testing.assert_close(aux.cpu(), want_aux, rtol=1e-6, atol=0)


def _moe_f32_probe():
    """``tools/torch_moe_f32_probe.py`` as a module."""
    import importlib.util
    import pathlib
    path = pathlib.Path(__file__).resolve().parents[1] / "tools" / \
        "torch_moe_f32_probe.py"
    spec = importlib.util.spec_from_file_location("torch_moe_f32_probe",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_moe_float32_ops_round_as_float32_on_card(cuda):
    """The float32 layer of the test above, op by op
    (``tools/torch_moe_f32_probe.py``), with TF32 off as that test sets
    it: the router product, the three expert products and the SiLU gate
    on the card each within float32 rounding of float64 (K 2**-24 of the
    largest value) and the same bits on every repeat; the whole layer
    within 1e-6 of the CPU's and the same bits on every repeat; and the
    CPU side (the test's ``want``) within the same rounding.  A setting
    left by another test in the session would show here too: the matmul
    precision switches read IEEE on the card and no reduced precision on
    the CPU's oneDNN."""
    torch.backends.cuda.matmul.allow_tf32 = False
    rep = _moe_f32_probe().probe("default", 3)
    st = rep["settings"]
    assert st["cuda.matmul.fp32_precision"] == "ieee", st
    assert st.get("mkldnn.matmul.fp32_precision", "none") in (
        "none", "ieee"), st
    for name, op in rep["ops"].items():
        assert op["repeat_bitwise"], name
        assert op["card_err"] <= op["f32_bound"], (name, op)
        assert op["cpu_err"] <= op["f32_bound"], (name, op)
    assert max(rep["layer_card_vs_cpu"]) <= 1e-6, rep["layer_card_vs_cpu"]
    assert len(set(rep["layer_card_vs_cpu"])) == 1, rep["layer_card_vs_cpu"]


def _loop_tokens(api, params, cuda, backend, prompts):
    loop = ServeLoop(api, params, slots=2, max_len=96, bucket=32,
                     backend=backend, device=cuda)
    for i, pr in enumerate(prompts):
        loop.submit(Request(rid=i, prompt=pr, max_new=6))
    out, ticks = [], 0
    while loop.queue or loop.active:
        out.extend(loop.tick())
        ticks += 1
    return {r.rid: r.tokens for r in out}, ticks


@pytest.mark.parametrize("arch,plain", [("qwen3-moe-30b-a3b", "naive"),
                                        ("jamba-v0.1-52b", "chunked")])
def test_moe_and_hybrid_serve_loops_kernel_equal_plain_on_card(cuda, arch,
                                                                plain):
    """Smoke MoE and hybrid models in float32 on the card: the loop
    through the kernels gives the greedy tokens of the loop through the
    plain versions; flash runs once per attention layer per prefill, the
    fused scan once per Mamba layer per prefill and per tick."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(get_smoke_config(arch), dtype=torch.float32)
    api = get_model(cfg)
    params = api.init(0, device=cuda)
    rng = np.random.RandomState(1)
    prompts = [rng.randint(1, cfg.vocab, n).astype(np.int32)
               for n in (8, 20, 33)]
    n_attn = (cfg.n_layers // cfg.attn_every if cfg.attn_every
              else cfg.n_layers)
    tokens = {}
    for backend in ("kernel", plain):
        fa0, sc0 = fa_kernel.launch_count(), scan_kernel.launch_count()
        tokens[backend], ticks = _loop_tokens(api, params, cuda, backend,
                                              prompts)
        fa = fa_kernel.launch_count() - fa0
        sc = scan_kernel.launch_count() - sc0
        kernel = backend == "kernel"
        assert fa == (n_attn * 3 if kernel else 0)
        assert sc == ((cfg.n_layers - n_attn) * (3 + ticks) if kernel
                      else 0)
    assert tokens["kernel"] == tokens[plain]
    assert all(len(t) == 7 for t in tokens["kernel"].values())


def _smoke_batches(cfg, b, s):
    """The prefill's batch and three decode steps' arguments of a smoke
    config: frames and tokens (audio), or embeddings with M-RoPE positions
    of text, a 2 x 3 patch grid and text (vlm); numpy from a seed."""
    rng = np.random.RandomState(3)
    if cfg.family == "audio":
        prefill = {"enc_embeds": rng.standard_normal(
                       (b, cfg.enc_seq, cfg.d_model)).astype(np.float32),
                   "tokens": rng.randint(0, cfg.vocab, (b, s)).astype(
                       np.int32)}
        return prefill, [({"tokens": rng.randint(0, cfg.vocab, (b, 1)).astype(
            np.int32)}) for _ in range(3)]
    image = [(3, 3 + r, 3 + c) for r in range(2) for c in range(3)]
    pos = [(i, i, i) for i in range(3)] + image + \
        [(6 + i, 6 + i, 6 + i) for i in range(s - 9 + 3)]
    pos3 = np.tile(np.array(pos, np.int32)[None], (b, 1, 1))
    emb = rng.standard_normal((b, s + 3, cfg.d_model)).astype(np.float32)
    prefill = {"embeds": emb[:, :s], "pos3": pos3[:, :s]}
    return prefill, [{"batch_extra": {
        "embeds": emb[:, s + t:s + t + 1],
        "pos3": np.ascontiguousarray(pos3[:, s + t:s + t + 1])}}
        for t in range(3)]


@pytest.mark.parametrize("arch", ["whisper-base", "qwen2-vl-72b"])
def test_encdec_and_vlm_on_cuda_equal_cpu(cuda, arch):
    """Smoke whisper and qwen2-vl models in float32: a prefill through the
    flash kernel and three decode steps on the card (tokens; embeddings
    and M-RoPE positions through ``batch_extra``) equal the same on the
    CPU, logits and every cache leaf; flash runs once per attention of
    the prefill (3 a decoder layer for whisper) and never in decode."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(get_smoke_config(arch), dtype=torch.float32)
    api = get_model(cfg)
    cpu_params = api.init(0, device="cpu")
    params = api.init(0, device="cpu").to(cuda)
    prefill, steps = _smoke_batches(cfg, 2, 12)
    out = {}
    for dev, p in ((cuda, params), ("cpu", cpu_params)):
        to = lambda d: {k: torch.from_numpy(v).to(dev) for k, v in d.items()}
        fa0 = fa_kernel.launch_count()
        cache = api.init_cache(2, 20, device=dev)
        logits, cache = api.prefill(p, to(prefill), cache, backend="kernel")
        runs = [(logits.cpu(), {k: v.cpu().clone()
                                for k, v in cache.items()})]
        fa1 = fa_kernel.launch_count()
        for st in steps:
            if "tokens" in st:
                logits, cache = api.decode_step(p, to(st)["tokens"], cache)
            else:
                logits, cache = api.decode_step(
                    p, None, cache, batch_extra=to(st["batch_extra"]))
            runs.append((logits.cpu(), {k: v.cpu().clone() for k, v in
                                        cache.items()}))
        launches = (fa1 - fa0, fa_kernel.launch_count() - fa1)
        out[str(dev)] = runs
        assert launches == ((cfg.n_layers * (3 if arch == "whisper-base"
                                             else 1), 0)
                            if dev == cuda else (0, 0))
    for (g, gc), (w, wc) in zip(out[str(cuda)], out["cpu"]):
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-4)
        assert set(gc) == set(wc)
        for name in gc:
            torch.testing.assert_close(gc[name], wc[name], rtol=1e-4,
                                       atol=1e-4, msg=name)


@pytest.mark.parametrize("mesh", [(2, 2), (4, 4)])
def test_advisor_on_cuda_equals_cpu(cuda, mesh):
    """The DES ranking on the card equals the CPU's, one APSP launch for
    each schedule's route table."""
    before = kernel.launch_counts()["apsp_f32"]
    got = advise_allreduce(100e6, mesh, device=cuda)
    assert kernel.launch_counts()["apsp_f32"] - before == 3
    want = advise_allreduce(100e6, mesh, device="cpu")
    assert [(a.schedule, a.source) for a in got] == \
        [(a.schedule, a.source) for a in want]
    for a, b in zip(got, want):
        assert a.predicted_s == pytest.approx(b.predicted_s, rel=1e-6)


def test_ingest_job_on_cuda_equals_cpu(cuda):
    from repro_torch.core.mapreduce import build_setup
    from repro_torch.scenarios.registry import make_cluster
    topo = get_scenario("leaf-spine").topology()
    jobs = pipeline_jobs(n_shards=16, shard_gbits=2.0, n_reducers=4)
    states = [Experiment(build_setup(jobs, make_cluster(topo), k_max=8,
                                     device=dev),
                         [PolicyConfig(routing=r) for r in (1, 0)],
                         device=dev).run().states for dev in (cuda, "cpu")]
    for name, a, b in zip(states[0]._fields, *states):
        a = a.cpu()
        if a.is_floating_point():
            torch.testing.assert_close(a, b, rtol=1e-6, atol=0,
                                       equal_nan=True, msg=name)
        else:
            assert torch.equal(a, b), name


# ---------------------------------------------------------------------------
# training (the plain backends; the kernels refuse autograd)
# ---------------------------------------------------------------------------


def _train_setup(dev, dtype=None, seed=0):
    import copy
    from repro_torch.data import TokenPipeline
    from repro_torch.train import AdamWConfig, make_train_step
    from repro_torch.train import init as opt_init
    cfg = get_smoke_config("qwen3-4b")
    if dtype is not None:
        cfg = dataclasses.replace(cfg, dtype=dtype)
    api = get_model(cfg)
    params = api.init(seed, device="cpu").to(dev)
    ocfg = AdamWConfig(total_steps=50, warmup_steps=2)
    pipe = TokenPipeline(vocab=cfg.vocab, batch=4, seq=16)

    def batch_fn(s):
        return {k: torch.from_numpy(v).to(dev)
                for k, v in pipe.batch_at(s).items()}
    return (api, params, opt_init(ocfg, params),
            make_train_step(api, ocfg), batch_fn, ocfg, copy.deepcopy)


def test_train_step_on_cuda_is_bitwise_reproducible(cuda):
    """Two steps from copies of one state on one batch: the same bits in
    every parameter, moment and metric."""
    _, params, opt, step, batch_fn, _, copy = _train_setup(cuda)
    runs = []
    for _ in range(2):
        p, o = copy(params), copy(opt)
        for s in range(2):
            p, o, met = step(p, o, batch_fn(s))
        runs.append((p, o, met))
    (p1, o1, m1), (p2, o2, m2) = runs
    for a, b in zip(p1.parameters(), p2.parameters()):
        assert torch.equal(a, b)
    for k in o1.mu:
        assert torch.equal(o1.mu[k], o2.mu[k]) and \
            torch.equal(o1.nu[k], o2.nu[k]), k
    for k in m1:
        assert torch.equal(m1[k], m2[k]), k


def test_train_driver_crash_on_cuda_is_bitwise(cuda, tmp_path):
    from repro_torch.ft import FailurePlan, TrainDriver
    _, params, opt, step, batch_fn, _, copy = _train_setup(cuda)
    start = copy((params, opt))
    out = []
    for name, crashes in (("plain", {}), ("crash", {3: "crash"})):
        drv = TrainDriver(step_fn=step, batch_fn=batch_fn,
                          ckpt_dir=str(tmp_path / name), ckpt_every=2,
                          failure_plan=FailurePlan(at_steps=dict(crashes)))
        p, _, info = drv.run(*copy(start), 6)
        assert info["restarts"] == len(crashes)
        out.append(p)
    for a, b in zip(*(p.parameters() for p in out)):
        assert a.device.type == "cuda" and torch.equal(a, b)


def test_train_step_on_cuda_matches_cpu(cuda):
    """One float32 step on the card against the CPU's: the metrics within
    rtol 1e-5 (the loss's sums run in other orders); the grads within
    2e-5 of their leaf's largest |g|; and ``update`` of one set of grads on
    the card against the CPU, rtol 1e-6 with an atol of 1e-6 of the leaf's
    largest magnitude (the grad norm sums in another order)."""
    from repro_torch.models.weights import leaf_map
    from repro_torch.train import lm_loss, update
    runs = {}
    for dev in (cuda, torch.device("cpu")):
        api, params, opt, step, batch_fn, ocfg, copy = _train_setup(
            dev, torch.float32)
        batch = batch_fn(0)
        p0 = copy(params)
        out = api.apply(p0, {"tokens": batch["tokens"]})
        lm_loss(out["logits"], batch["labels"],
                aux_loss=out["aux_loss"])[0].backward()
        grads = {n: p.grad.cpu() for n, p in p0.named_parameters()}
        _, _, met = step(params, opt, batch)
        runs[dev.type] = (api, grads, met, ocfg, copy)
    for k, v in runs["cpu"][2].items():
        torch.testing.assert_close(runs["cuda"][2][k].cpu(), v, rtol=1e-5,
                                   atol=0, msg=k)
    for n, g in runs["cpu"][1].items():
        torch.testing.assert_close(runs["cuda"][1][n], g, rtol=2e-5,
                                   atol=2e-5 * float(g.abs().max()), msg=n)
    api, grads, _, ocfg, copy = runs["cpu"]
    _, params, opt, _, _, _, _ = _train_setup("cpu", torch.float32)
    on = {}
    for dev in (cuda, torch.device("cpu")):
        p, o = copy(params).to(dev), copy(opt)
        o = type(o)(o.step.to(dev), *({k: v.to(dev) for k, v in d.items()}
                                      for d in (o.mu, o.nu, o.err)))
        update(ocfg, {n: g.to(dev) for n, g in grads.items()}, o, p)
        on[dev.type] = (p, o)
    for key, leaf in leaf_map(on["cpu"][0], api.cfg).items():
        for name, a in zip(leaf.names, leaf.params):
            a, b = a.detach(), on["cuda"][0].get_parameter(name).detach()
            torch.testing.assert_close(b.cpu(), a, rtol=1e-6,
                                       atol=1e-6 * float(a.abs().max()),
                                       msg=name)


def test_kernels_refuse_autograd_on_cuda(cuda):
    """On the card the kernels' outputs would have no ``grad_fn``: each
    entry raises under autograd, and ``apply(backend="kernel")`` with
    weights that require grad raises instead of cutting the graph."""
    q = torch.rand(1, 8, 4, 16, device=cuda, requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        fa_kernel.flash_attention_fwd(q, q.detach(), q.detach())
    with pytest.raises(RuntimeError, match="no backward"):
        scan_kernel.selective_scan_f32(
            torch.rand(1, 4, 8, 4, device=cuda, requires_grad=True),
            torch.rand(1, 4, 8, 4, device=cuda),
            torch.rand(1, 4, 4, device=cuda))
    a = torch.rand(8, 4, device=cuda, requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        scan_kernel.selective_scan_fused_f32(
            *(torch.rand(sh, device=cuda) for sh in
              ((1, 4, 8), (1, 4, 8), (1, 4, 4), (1, 4, 4))), a,
            torch.zeros(1, 8, 4, device=cuda))
    for arch in ("qwen3-4b", "falcon-mamba-7b"):
        api = get_model(get_smoke_config(arch))
        params = api.init(0, device=cuda)
        toks = torch.zeros(1, 8, dtype=torch.int32, device=cuda)
        with pytest.raises(RuntimeError, match="no backward"):
            api.apply(params, {"tokens": toks}, backend="kernel")
        with torch.no_grad():
            api.apply(params, {"tokens": toks}, backend="kernel")


def test_op_budget_on_cuda_equals_cpu_ledger(cuda):
    """paper-fabric's serial loop, fleet chunk (first static signature)
    and stream refill on the card, 32 events each: every aten op count
    equals the committed CPU ledger (host reads and host copies left
    out), and the loop dispatches one host copy of its done flags an
    event, which a CPU run does not."""
    from repro_torch.analysis import (analyze, device_diff, iter_traces,
                                      load_ledger, static_sigs)
    from pathlib import Path
    ledger = load_ledger(Path(__file__).resolve().parent.parent
                         / "experiments" / "TORCH_OP_BUDGET.json")
    traces = list(iter_traces(["paper-fabric"], static_sigs()[:1],
                              device="cuda"))
    findings, rows = analyze(traces)
    assert {f.key for f in findings} <= set(ledger["allowlist"])
    assert device_diff(rows, ledger) == []
    serial = rows["paper-fabric/serial"]
    assert serial["host_copies"] >= serial["events"]
    assert ledger["programs"]["paper-fabric/serial"]["host_copies"] == 0


def test_dispatched_host_syncs_equal_cuda_sync_count(cuda):
    """The ops after which the host waits (``OpRecord.host_sync``) are the
    syncs CUDA's sync debug mode reports, on paper-fabric's serial loop."""
    import warnings
    from repro_torch.analysis.op_walk import OpRecorder
    from repro_torch.analysis.programs import scenario_consts, trace_serial
    scenario_consts("paper-fabric", "cuda")
    rec = OpRecorder()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            with rec:
                trace_serial("paper-fabric", "cuda")
    finally:
        torch.cuda.set_sync_debug_mode(0)
    reported = sum("synchroniz" in str(w.message) for w in caught)
    assert reported == sum(op.host_sync for op in rec.ops) > 0
