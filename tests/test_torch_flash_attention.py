"""The port's attention (repro_torch.kernels.flash_attention and
repro_torch.models.attention) against the reference's Pallas flash kernel
(interpret mode) and its jnp backends.  CPU tensors take the plain PyTorch
version; the CUDA kernel itself is checked on the card
(tests/test_torch_gpu.py and chip_smoke.py).

Inputs come from numpy with a seed; bf16 inputs are rounded from the same
float32 numbers in both packages, so both see the same bits.  Tolerances
are the reference's own (tests/test_kernels.py): 2e-5 in float32, where
only the summation order differs, and 2e-2 in bf16, where the two packages
round the attention weights and the output to bf16 at different points.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ops import flash_attention as ref_flash
from repro.models.attention import chunked_attention as ref_chunked
from repro.models.attention import decode_attention as ref_decode
from repro.models.attention import naive_attention as ref_naive
from repro_torch.kernels.flash_attention import flash_attention, kernel
from repro_torch.models.attention import (attention, chunked_attention,
                                          decode_attention, naive_attention)

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}

# the reference's sweep (tests/test_kernels.py::test_flash_attention_sweep)
SWEEP = [
    (2, 64, 64, 4, 2, 32, True, "float32"),
    (1, 100, 100, 4, 4, 16, True, "float32"),
    (2, 1, 40, 4, 2, 16, False, "float32"),
    (1, 128, 256, 8, 2, 64, True, "float32"),
    (2, 64, 64, 4, 1, 128, True, "bfloat16"),
    (1, 48, 48, 2, 2, 64, False, "bfloat16"),
]


def _qkv(seed, b, sq, skv, h, kv, dh, dtype):
    rng = np.random.RandomState(seed)
    arrs = [rng.standard_normal(s).astype(np.float32)
            for s in ((b, sq, h, dh), (b, skv, kv, dh), (b, skv, kv, dh))]
    jx = [jnp.asarray(a).astype(JDT[dtype]) for a in arrs]
    tx = [torch.from_numpy(a).to(TDT[dtype]) for a in arrs]
    return jx, tx


def _close(got: torch.Tensor, want, dtype, label=""):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=TOL[dtype], atol=TOL[dtype],
                               err_msg=label)


@pytest.mark.parametrize("b,sq,skv,h,kv,dh,causal,dtype", SWEEP)
def test_sweep_against_pallas_and_naive(b, sq, skv, h, kv, dh, causal,
                                        dtype):
    (jq, jk, jv), (q, k, v) = _qkv(b * 100 + sq + dh, b, sq, skv, h, kv, dh,
                                   dtype)
    off = skv - sq if causal else 0
    pallas = ref_flash(jq, jk, jv, causal=causal, q_offset=off, bq=32,
                       bk=32, interpret=True)
    naive = ref_naive(jq, jk, jv, causal=causal, q_offset=off)
    kernel.reset_launch_count()
    got = flash_attention(q, k, v, causal=causal, q_offset=off)
    assert kernel.launch_count() == 0      # CPU tensors: the plain version
    assert got.dtype == q.dtype and got.shape == q.shape
    for name, port in (("ops", got),
                       ("naive", naive_attention(q, k, v, causal=causal,
                                                 q_offset=off)),
                       ("chunked", chunked_attention(q, k, v, causal=causal,
                                                     q_offset=off,
                                                     block_k=32))):
        _close(port, pallas, dtype, f"{name} vs pallas")
        _close(port, naive, dtype, f"{name} vs naive")


@pytest.mark.parametrize("h,kv", [(4, 4), (4, 2), (6, 2), (4, 1)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gqa_groups(h, kv, dtype):
    """GQA groups 1, 2, 3 and 4, every backend against the reference."""
    (jq, jk, jv), (q, k, v) = _qkv(h * 10 + kv, 2, 40, 40, h, kv, 32, dtype)
    want = ref_naive(jq, jk, jv, causal=True)
    for backend in ("naive", "chunked", "kernel"):
        got = attention(q, k, v, causal=True, backend=backend, block_k=16)
        _close(got, want, dtype, backend)


@pytest.mark.parametrize("sq,skv,off,causal", [
    (20, 50, 30, True), (33, 70, 5, True), (64, 40, 0, False),
    (17, 17, 3, True)])
def test_ragged_and_offset(sq, skv, off, causal):
    """Ragged Sq != Skv and q_offset > 0 (the causal diagonal shifted)."""
    (jq, jk, jv), (q, k, v) = _qkv(sq + skv, 1, sq, skv, 4, 2, 16, "float32")
    want = ref_flash(jq, jk, jv, causal=causal, q_offset=off, bq=16, bk=16,
                     interpret=True)
    want_chunked = ref_chunked(jq, jk, jv, causal=causal, q_offset=off,
                               block_k=16)
    for backend in ("naive", "chunked", "kernel"):
        got = attention(q, k, v, causal=causal, q_offset=off,
                        backend=backend, block_k=16)
        _close(got, want, "float32", backend)
        _close(got, want_chunked, "float32", backend)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_attention_per_row_len(dtype):
    rng = np.random.RandomState(5)
    b, smax, h, kv, dh = 3, 24, 4, 2, 16
    q = rng.standard_normal((b, 1, h, dh)).astype(np.float32)
    kc = rng.standard_normal((b, smax, kv, dh)).astype(np.float32)
    vc = rng.standard_normal((b, smax, kv, dh)).astype(np.float32)
    lens = np.array([1, 9, 24], np.int32)
    want = ref_decode(*(jnp.asarray(a).astype(JDT[dtype])
                        for a in (q, kc, vc)), jnp.asarray(lens))
    got = decode_attention(*(torch.from_numpy(a).to(TDT[dtype])
                             for a in (q, kc, vc)), torch.from_numpy(lens))
    _close(got, want, dtype)


def test_kernel_binding_refuses_cpu_tensors():
    q = torch.zeros(1, 4, 2, 16)
    k = torch.zeros(1, 4, 1, 16)
    with pytest.raises(ValueError, match="CUDA"):
        kernel.flash_attention_fwd(q, k, k)


def test_unknown_backend_raises():
    q = torch.zeros(1, 4, 2, 16)
    with pytest.raises(ValueError, match="backend"):
        attention(q, q, q, backend="pallas")
