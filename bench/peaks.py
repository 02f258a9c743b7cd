"""The table of peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, at the
full 700 W power limit) and the work of the kernels the benchmark reads
a roofline share of."""
from __future__ import annotations

import math

HBM_BYTES_PER_S = 3.35e12
# the CUDA cores' issue rate: 128 float32 lanes a clock on each of 132 SMs
# at the 1.98 GHz boost clock (the data sheet's 67 TFLOP/s of float32
# counts each fused multiply-add lane as two operations)
F32_INSTR_PER_S = 128 * 132 * 1.98e9
# a min-plus (add, min) pair is two instructions: FADD and FMNMX, which
# no instruction fuses, and there is no tensor-core form
MINPLUS_INSTR_PER_PAIR = 2


def squarings_needed(max_hops: int) -> int:
    """Squarings an APSP of hop distances needs: after s squarings every
    path of up to 2^s edges is found, so ceil(log2 diameter).  The kernel
    runs one more, which changes nothing and stops it; that one is not
    counted."""
    return math.ceil(math.log2(max_hops)) if max_hops > 1 else 0


def apsp_bound_s(n: int, max_hops: int) -> float:
    """The least time an APSP of an ``n``-node fabric of diameter
    ``max_hops`` can take on the card: the larger of its bytes (the
    matrix in once, the distances out once, float32) over HBM bandwidth
    and its instructions (n^3 pairs a needed squaring) over the issue
    rate."""
    by_bytes = 2 * 4 * n * n / HBM_BYTES_PER_S
    by_instr = (squarings_needed(max_hops) * n ** 3 * MINPLUS_INSTR_PER_PAIR
                / F32_INSTR_PER_S)
    return max(by_bytes, by_instr)
