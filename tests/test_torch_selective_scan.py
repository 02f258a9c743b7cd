"""The port's selective scan (repro_torch.kernels.selective_scan) against
the reference's: the Pallas kernel in interpret mode and its sequential
oracle ``selective_scan_ref`` for the kernel's own contract, and the
model's chunked ``_fused_scan`` (src/repro/models/ssm.py) for the fused
entry point the Mamba path runs.  Inputs are made with numpy from a seed
and handed to both packages.

Tolerance: rtol 1e-4, atol 1e-5, the reference's own for its kernel
against its oracle (tests/test_kernels.py).  The scans sum in other orders
(a sequential loop, JAX's associative scan, the port's Hillis-Steele
scan): against a float64 recurrence each stays within ~3e-7 of max|y|,
but entries near zero differ by far more in relative terms, so a relative
tolerance alone would not hold.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.selective_scan.ops import selective_scan as pallas_scan
from repro.kernels.selective_scan.ref import selective_scan_ref as jax_ref
from repro.models.ssm import _fused_scan
from repro_torch.kernels.selective_scan import (fused_scan_ref, kernel,
                                                selective_scan,
                                                selective_scan_fused,
                                                selective_scan_ref)

TOL = dict(rtol=1e-4, atol=1e-5)


def _pallas_inputs(seed, b, s, d, n):
    rng = np.random.RandomState(seed)
    a = rng.uniform(0.5, 0.999, (b, s, d, n)).astype(np.float32)
    bb = (rng.standard_normal((b, s, d, n)) * 0.1).astype(np.float32)
    c = rng.standard_normal((b, s, n)).astype(np.float32)
    return a, bb, c


def _fused_inputs(seed, b, s, d, n, h0_scale):
    """Realistic Mamba inputs: dt = softplus(U(-7, -2)), A = -[1..N]."""
    rng = np.random.RandomState(seed)
    dt = np.log1p(np.exp(rng.uniform(-7, -2, (b, s, d)))).astype(np.float32)
    x = rng.standard_normal((b, s, d)).astype(np.float32)
    bmat = rng.standard_normal((b, s, n)).astype(np.float32)
    cmat = rng.standard_normal((b, s, n)).astype(np.float32)
    a_neg = -np.tile(np.arange(1, n + 1, dtype=np.float32), (d, 1))
    h0 = (rng.standard_normal((b, d, n)) * h0_scale).astype(np.float32)
    return dt, x, bmat, cmat, a_neg, h0


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


# the reference's sweep shapes (tests/test_kernels.py): ragged S and D,
# N in {4, 8, 16}, with the Pallas kernel's chunk and bd
@pytest.mark.parametrize("b,s,d,n,chunk,bd", [
    (2, 16, 8, 4, 8, 8), (1, 100, 32, 16, 32, 16), (2, 64, 300, 16, 16, 64),
    (1, 33, 24, 8, 16, 24),
])
def test_selective_scan_against_pallas_and_ref(b, s, d, n, chunk, bd):
    a, bb, c = _pallas_inputs(s + d, b, s, d, n)
    got = selective_scan(*_t(a, bb, c))
    assert got.dtype == torch.float32 and got.shape == (b, s, d)
    pallas = pallas_scan(jnp.asarray(a), jnp.asarray(bb), jnp.asarray(c),
                         chunk=chunk, bd=bd, interpret=True)
    ref = jax_ref(jnp.asarray(a), jnp.asarray(bb), jnp.asarray(c))
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas), **TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


# S below, at and across chunks of 128 (ragged last chunk), the decode
# step (S = 1), zero and nonzero h0
@pytest.mark.parametrize("b,s,d,n,h0_scale", [
    (2, 1, 16, 8, 0.5), (1, 40, 24, 4, 0.0), (2, 128, 16, 16, 0.0),
    (1, 200, 48, 16, 0.5), (2, 300, 40, 4, 1.0),
])
def test_fused_scan_against_reference(b, s, d, n, h0_scale):
    arrays = _fused_inputs(s + d, b, s, d, n, h0_scale)
    dt, x, bmat, cmat, a_neg, h0 = arrays
    y, h_last = selective_scan_fused(*_t(*arrays))
    assert y.shape == (b, s, d) and h_last.shape == (b, d, n)
    want_y, want_h = _fused_scan(*(jnp.asarray(v) for v in
                                   (dt, bmat, cmat, x, a_neg, h0)), 128)
    np.testing.assert_allclose(y.numpy(), np.asarray(want_y), **TOL)
    np.testing.assert_allclose(h_last.numpy(), np.asarray(want_h), **TOL)


def test_fused_scan_equals_the_materialised_recurrence():
    """The two entry points compute one recurrence: the fused scan from
    h0 = 0 against the sequential scan of a_t = exp(dt A), b_t = dt x B."""
    dt, x, bmat, cmat, a_neg, h0 = _t(*_fused_inputs(3, 2, 150, 20, 8, 0.0))
    y, _ = fused_scan_ref(dt, x, bmat, cmat, a_neg, h0)
    a = torch.exp(dt[..., None] * a_neg)
    b = (dt * x)[..., None] * bmat[:, :, None, :]
    torch.testing.assert_close(y, selective_scan_ref(a, b, cmat), **TOL)


# the plain fused scan's own chunk borders against the reference's chunked
# scan cut the same way: S in {1, chunk - 1, chunk, chunk + 1} and several
# chunks with a ragged last one, from a nonzero h0
@pytest.mark.parametrize("b,s,d,n,chunk", [
    (2, 1, 12, 16, 16), (1, 15, 10, 16, 16), (2, 16, 10, 8, 16),
    (1, 17, 10, 4, 16), (2, 100, 9, 32, 16), (1, 257, 6, 16, 64),
])
def test_fused_scan_chunk_borders_against_reference(b, s, d, n, chunk):
    arrays = _fused_inputs(7 * s + d, b, s, d, n, 0.5)
    dt, x, bmat, cmat, a_neg, h0 = arrays
    y, h_last = fused_scan_ref(*_t(*arrays), chunk=chunk)
    assert y.shape == (b, s, d) and h_last.shape == (b, d, n)
    want_y, want_h = _fused_scan(*(jnp.asarray(v) for v in
                                   (dt, bmat, cmat, x, a_neg, h0)), chunk)
    np.testing.assert_allclose(y.numpy(), np.asarray(want_y), **TOL)
    np.testing.assert_allclose(h_last.numpy(), np.asarray(want_h), **TOL)


def test_fused_scan_one_step_is_the_decode_update():
    """At S = 1 (a decode tick) the scan is one step from the cached state:
    h = exp(dt A) h0 + dt x B and y = sum_n h C, in float64 here."""
    dt, x, bmat, cmat, a_neg, h0 = _t(*_fused_inputs(9, 4, 1, 24, 16, 1.0))
    y, h_last = fused_scan_ref(dt, x, bmat, cmat, a_neg, h0)
    d64 = [t.double() for t in (dt, x, bmat, cmat, a_neg, h0)]
    dt, x, bmat, cmat, a_neg, h0 = d64
    want_h = (torch.exp(dt[:, 0, :, None] * a_neg) * h0
              + (dt * x)[:, 0, :, None] * bmat[:, 0, None, :])
    want_y = torch.sum(want_h * cmat[:, 0, None, :], dim=-1)[:, None]
    torch.testing.assert_close(h_last, want_h.float(), **TOL)
    torch.testing.assert_close(y, want_y.float(), **TOL)


def test_fused_scan_chunk_size_does_not_change_the_result():
    arrays = _t(*_fused_inputs(4, 1, 70, 12, 4, 0.3))
    y8, h8 = fused_scan_ref(*arrays, chunk=8)
    y128, h128 = fused_scan_ref(*arrays)
    torch.testing.assert_close(y8, y128, **TOL)
    torch.testing.assert_close(h8, h128, **TOL)


def test_cpu_tensors_take_the_plain_version():
    a, bb, c = _t(*_pallas_inputs(0, 1, 20, 8, 4))
    fused = _t(*_fused_inputs(0, 1, 20, 8, 4, 0.1))
    before = kernel.launch_count()
    torch.testing.assert_close(selective_scan(a, bb, c),
                               selective_scan_ref(a, bb, c), rtol=0, atol=0)
    got = selective_scan_fused(*fused)
    want = fused_scan_ref(*fused)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    assert kernel.launch_count() == before


def test_other_devices_go_to_the_kernel_and_never_the_plain_version():
    """A tensor off the CPU is the kernel's, which refuses anything but
    CUDA: no fallback to the plain version."""
    a = torch.zeros(1, 4, 8, 4, device="meta")
    c = torch.zeros(1, 4, 4, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        selective_scan(a, a, c)
    d3 = torch.zeros(1, 4, 8, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        selective_scan_fused(d3, d3, c, c, torch.zeros(8, 4, device="meta"),
                             torch.zeros(1, 8, 4, device="meta"))


@pytest.mark.parametrize("n", [3, 12, 64])
def test_kernel_refuses_other_state_sizes(n):
    a = torch.zeros(1, 4, 8, n)
    with pytest.raises(ValueError, match="N in"):
        kernel.selective_scan_f32(a, a, torch.zeros(1, 4, n))
    d3 = torch.zeros(1, 4, 8)
    with pytest.raises(ValueError, match="N in"):
        kernel.selective_scan_fused_f32(d3, d3, torch.zeros(1, 4, n),
                                        torch.zeros(1, 4, n),
                                        torch.zeros(8, n),
                                        torch.zeros(1, 8, n))
